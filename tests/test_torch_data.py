"""Client data: the counter-based per-client batches, Dirichlet labels and
the streaming data path.

A client's batch is a pure function of (data seed, client, task state),
so any subset of clients draws again bit for bit, and a run that streams
its clients' batches (``cache_data=False``, or above the cache limit)
equals the cached run bit for bit: sync (full, ``cell_chunk`` blocks and
cohort), async and two-tier.  Dirichlet(0.05) labels concentrate each
client on a few classes, as the reference's test asserts
(``tests/test_fleet_topology.py``); the IID draw does not depend on the
Dirichlet code.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.fleet import engine as TENG
from repro_torch.fleet import scheduler as TSCHED
from repro_torch.fleet import task as TTASK

from test_torch_engine import UNIFORM, _configs

SEED = 1234567890123456789


def _labels(task, n=16):
    state = task.build(torch.Generator().manual_seed(0), torch.float64,
                       "cpu", num_clients=n)
    return task.client_batch(state, SEED, torch.arange(n))["y"].numpy()


def test_dirichlet_skews_labels_against_iid():
    iid = TTASK.SyntheticMLPTask(local_batch=64)
    skew = TTASK.SyntheticMLPTask(local_batch=64, dirichlet_alpha=0.05)
    counts = {name: np.stack([np.bincount(row, minlength=4)
                              for row in _labels(task)])
              for name, task in (("iid", iid), ("skew", skew))}
    # per-client max-class share: Dirichlet(0.05) concentrates hard
    assert counts["skew"].max(axis=1).mean() \
        > counts["iid"].max(axis=1).mean() + 10
    # IID labels are uniform over the classes
    share = counts["iid"].sum(axis=0) / counts["iid"].sum()
    np.testing.assert_allclose(share, 0.25, atol=0.05)


def test_iid_draw_is_independent_of_the_dirichlet_code():
    """``dirichlet_alpha=None``: no label table, and the task constants and
    the clients' noise are those of a Dirichlet task (its table is drawn
    after them; only the labels change)."""
    gen = lambda: torch.Generator().manual_seed(3)
    iid = TTASK.SyntheticMLPTask()
    skew = TTASK.SyntheticMLPTask(dirichlet_alpha=0.3)
    s_iid = iid.build(gen(), torch.float64, "cpu", num_clients=10)
    s_skew = skew.build(gen(), torch.float64, "cpu", num_clients=10)
    assert "label_cdf" not in s_iid and s_skew["label_cdf"].shape == (10, 4)
    for k in s_iid:
        assert torch.equal(s_iid[k], s_skew[k])
    idx = torch.arange(10)
    a = iid.client_batch(s_iid, SEED, idx)
    b = skew.client_batch(s_skew, SEED, idx)
    t = s_iid["templates"]
    # the same noise (x - t[y] recovers it up to the rounding of the sum)
    torch.testing.assert_close(a["x"] - t[a["y"]], b["x"] - t[b["y"]],
                               rtol=0.0, atol=1e-14)
    # the run-level default: None is the IID task
    _, tcfg = _configs({}, (2, 4), rounds=2)
    cfg = dataclasses.replace(tcfg, task=None, dirichlet_alpha=None)
    assert TENG.resolve_task(cfg).dirichlet_alpha is None
    iid_run = TENG.run_fleet(cfg, device="cpu").losses
    explicit = TTASK.SyntheticMLPTask(
        feature_dim=cfg.feature_dim, hidden=tuple(cfg.hidden),
        num_classes=cfg.num_classes, local_batch=cfg.local_batch,
        data_noise=cfg.data_noise, test_samples=cfg.test_samples,
        prune_block=cfg.prune_block)
    np.testing.assert_array_equal(
        iid_run, TENG.run_fleet(dataclasses.replace(cfg, task=explicit),
                                device="cpu").losses)
    # and setting alpha does reach the run's labels
    skew_run = TENG.run_fleet(dataclasses.replace(cfg, dirichlet_alpha=0.3),
                              device="cpu").losses
    assert not np.array_equal(iid_run, skew_run)


def test_dirichlet_conflict_and_invalid_alpha_raise():
    _, tcfg = _configs({}, (2, 4))
    with pytest.raises(ValueError, match="dirichlet_alpha"):
        TENG.resolve_task(dataclasses.replace(tcfg, dirichlet_alpha=0.2))
    assert TENG.resolve_task(dataclasses.replace(
        tcfg, task=None, dirichlet_alpha=0.2)).dirichlet_alpha == 0.2
    with pytest.raises(ValueError, match="dirichlet_alpha"):
        TTASK.SyntheticMLPTask(dirichlet_alpha=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("alpha", [None, 0.3])
def test_any_subset_of_clients_draws_again_bitwise(dtype, alpha):
    task = TTASK.SyntheticMLPTask(feature_dim=33, local_batch=5,
                                  dirichlet_alpha=alpha)
    n = 300
    state = task.build(torch.Generator().manual_seed(1), dtype, "cpu",
                       num_clients=n)
    full = task.client_batch(state, SEED, torch.arange(n))
    rng = np.random.default_rng(0)
    for size in (1, 7, 128):
        idx = torch.as_tensor(rng.choice(n, size, replace=False))
        part = task.client_batch(state, SEED, idx)
        assert torch.equal(part["x"], full["x"][idx])
        assert torch.equal(part["y"], full["y"][idx])
    assert full["x"].dtype == dtype and full["y"].dtype == torch.int64
    assert 0 <= int(full["y"].min()) and int(full["y"].max()) < 4
    z = (full["x"] - state["templates"][full["y"]]) / task.data_noise
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02
    other = task.client_batch(state, SEED + 1, torch.arange(n))
    assert not torch.equal(other["x"], full["x"])


STREAM_CASES = {
    "sync": ("sync", {}, dict(cell_chunk=2)),
    "sync_cohort": ("sync", UNIFORM, {}),
    "sync_reference": ("sync", {}, dict(kernel="reference")),
    "async": ("async", {}, {}),
    "two_tier_sync": ("sync", UNIFORM, dict(cloud_period=2)),
    "two_tier_async": ("async", {}, dict(cloud_period=2)),
    "dirichlet": ("sync", {}, dict(dirichlet_alpha=0.3)),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streaming_equals_caching_bitwise(case):
    mode, schedule, extra = STREAM_CASES[case]
    _, tcfg = _configs(schedule, (3, 5), extra, rounds=3)
    if "dirichlet_alpha" in extra:
        tcfg = dataclasses.replace(tcfg, task=None, feature_dim=32,
                                   hidden=(12, 6), num_classes=5,
                                   dirichlet_alpha=extra["dirichlet_alpha"])
    tcfg = dataclasses.replace(tcfg, async_config=TSCHED.AsyncConfig(
        buffer_size=6, max_staleness=3))
    runs = {}
    for cache in (True, False):
        sim = TENG.build_simulation(
            dataclasses.replace(tcfg, cache_data=cache), mode, device="cpu")
        assert (sim.data.cached is None) == (not cache)
        runs[cache] = sim.finalize(*sim.simulate(sim.params))
    a, b = runs[True], runs[False]
    for f in ("losses", "accuracy", "latencies", "wall_clock", "mean_prune",
              "participants"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for name, layer in a.params.items():
        for leaf, v in layer.items():
            np.testing.assert_array_equal(b.params[name][leaf], v)


def test_automatic_choice_streams_above_the_cache_limit(monkeypatch):
    _, tcfg = _configs({}, (3, 5), rounds=2)
    cached = TENG.build_simulation(tcfg, device="cpu")
    assert cached.data.cached is not None
    monkeypatch.setattr(TENG, "_CACHE_LIMIT_BYTES", 1024)
    streamed = TENG.build_simulation(tcfg, device="cpu")
    assert streamed.data.cached is None
    forced = TENG.build_simulation(dataclasses.replace(tcfg, cache_data=True),
                                   device="cpu")
    assert forced.data.cached is not None
    a = cached.finalize(*cached.simulate(cached.params))
    b = streamed.finalize(*streamed.simulate(streamed.params))
    np.testing.assert_array_equal(a.losses, b.losses)


def test_counter_words_stay_in_32_bits():
    """The hash keeps every word (and so every product of a word and a
    31-bit constant) in [0, 2^32), for any 63-bit seed and client id."""
    clients = torch.tensor([0, 1, 2**31 - 1, 2**32 - 1], dtype=torch.int64)
    for seed in (0, 1, 2**63 - 1, SEED):
        w = TTASK.client_words(seed, 2, clients, 50)
        assert w.dtype == torch.int64 and int(w.min()) >= 0
        assert int(w.max()) < 2**32
        assert len(torch.unique(w)) > 190
