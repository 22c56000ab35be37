"""The host reference path: the port's ``federated/`` and ``data/``
against the JAX package.

* ``run`` (the paper's §V experiment) against
  ``repro.federated.system.run`` under ``jax.enable_x64(True)``, for every
  scheme and both mask kinds, at 2 rounds: the reference's initial params
  and its per-round packet uniforms (its ``jax.random.split`` chain,
  rebuilt here) are injected through ``weights.run_start_from_numpy``;
  the channel, data and partitions are numpy on both sides.  Losses,
  latencies, costs, pruning and PER rates, accuracy, the bound and the
  final params at 1e-5 relative.
* ``run_fleet_reference`` against the reference's on injected fleet
  draws (``test_torch_engine``'s helpers), float64: plain, partial
  participation with a binding round deadline, and hex cells at
  ``fp_rtol = 0``, at 1e-5; two-tier is refused.
* ``client.local_gradient`` / ``make_masks``, ``server.global_round``,
  ``make_dataset`` and both partitions (bitwise), ``RoundTracker``,
  ``to_fleet_config`` and ``run_any``'s dispatch.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import convergence as JCONV
from repro.data import synthetic as JSYN
from repro.federated import client as JCLIENT
from repro.federated import server as JSERVER
from repro.federated import system as JSYS
from repro.models import mlp as JMLP
from repro_torch import weights
from repro_torch.core import convergence as TCONV
from repro_torch.data import synthetic as TSYN
from repro_torch.federated import client as TCLIENT
from repro_torch.federated import server as TSERVER
from repro_torch.federated import system as TSYS
from repro_torch.fleet import engine as TENG
from repro_torch.models import mlp as TMLP

from test_torch_engine import HEX, _configs, _reference

RTOL = 1e-5
F64 = dict(device="cpu", dtype=torch.float64)


def _fl_configs(**kw):
    return JSYS.FLConfig(**kw), TSYS.FLConfig(**kw)


def _reference_run(cfg):
    """The reference's run and the draws it made: initial params from
    PRNGKey(seed), then each round's uniforms from the split chain."""
    with jax.enable_x64(True):
        res = JSYS.run(cfg)
        rng = jax.random.PRNGKey(cfg.seed)
        data = JSYN.make_dataset(seed=cfg.seed)
        params = JMLP.init_mlp_classifier(rng, data.dim, cfg.hidden,
                                          data.num_classes)
        uniforms = []
        for _ in range(cfg.rounds):
            rng, step_key = jax.random.split(rng)
            uniforms.append(np.asarray(jax.random.uniform(
                step_key, (cfg.num_clients,))))
        params = jax.tree.map(np.asarray, params)
    return res, params, np.stack(uniforms)


def _close(a, b, what, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=RTOL,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("scheme", ["proposed", "gba", "fpr:0.3", "fpr",
                                    "exhaustive", "ideal"])
def test_run_matches_reference(scheme, structured):
    jcfg, tcfg = _fl_configs(rounds=2, scheme=scheme, structured=structured,
                             lr=0.05)
    ref, params, uniforms = _reference_run(jcfg)
    got = TSYS.run(tcfg, start=weights.run_start_from_numpy(
        params, uniforms, torch.float64, "cpu"), **F64)
    for f in ("losses", "latencies", "total_costs", "prune_rates",
              "per_rates"):
        _close(getattr(got, f), getattr(ref, f), f)
    assert [r for r, _ in got.accuracy] == [r for r, _ in ref.accuracy]
    _close([a for _, a in got.accuracy], [a for _, a in ref.accuracy],
           "accuracy")
    assert math.isclose(got.bound_final, ref.bound_final, rel_tol=RTOL)
    for name, layer in ref.params.items():
        for leaf, v in layer.items():
            _close(got.params[name][leaf], v, f"{name}/{leaf}", atol=1e-10)


def test_run_repeats_and_its_default_draws_train():
    cfg = TSYS.FLConfig(rounds=3, lr=0.05, hidden=(16,))
    a = TSYS.run(cfg, device="cpu")
    b = TSYS.run(cfg, device="cpu")
    assert a.losses == b.losses and a.total_costs == b.total_costs
    assert np.isfinite(a.losses).all()
    assert a.prune_rates.shape == a.per_rates.shape == (3, 5)


def test_run_refuses_a_start_of_the_wrong_shape():
    cfg = TSYS.FLConfig(rounds=3)
    start = TSYS.RunStart(TMLP.init_mlp_classifier(
        torch.Generator().manual_seed(0), 784, (60,), 10),
        torch.zeros(2, 5))
    with pytest.raises(ValueError, match="uniforms"):
        TSYS.run(cfg, device="cpu", start=start)
    with pytest.raises(ValueError, match="unknown scheme"):
        TSYS.run(TSYS.FLConfig(rounds=1, scheme="greedy"), device="cpu")


# ---------------------------------------------------------------------------
# run_fleet_reference
# ---------------------------------------------------------------------------

FLEET = {
    "plain": ({}, (2, 4), {}),
    "partial_deadline": (dict(participation="uniform",
                              participants_per_cell=3,
                              round_deadline_s=0.6), (3, 5), {}),
    "hex_fp_rtol0": ({}, (3, 4), dict(geometry=HEX, fp_rtol=0.0)),
}


def _injected(ref):
    dt, cpu = torch.float64, "cpu"
    draws = TENG.InjectedDraws(
        weights.population_from_numpy(ref["pop"], dt, cpu),
        [weights.round_draws_from_numpy(*d[:5], dtype=dt, device=cpu, **d[5])
         for d in ref["draws"]])
    start = weights.start_from_numpy(ref["params"], ref["state"], ref["data"],
                                     dtype=dt, device=cpu)
    return draws, start


@pytest.mark.parametrize("case", sorted(FLEET))
def test_run_fleet_reference_matches_reference(case):
    jcfg, tcfg = _configs(*FLEET[case])
    ref = _reference(jcfg)
    with jax.enable_x64(True):
        jr = JSYS.run_fleet_reference(jcfg)
    draws, start = _injected(ref)
    res = TSYS.run_fleet_reference(tcfg, draws=draws, start=start, **F64)
    for f in ("losses", "latencies", "deadlines", "mean_prune", "mean_per",
              "bandwidth_util", "learning_cost"):
        _close(getattr(res, f), getattr(jr, f), f)
    np.testing.assert_array_equal(res.participants, jr.participants)
    _close(res.accuracy, jr.accuracy, "accuracy")
    for name, layer in jr.params.items():
        for leaf, v in layer.items():
            _close(res.params[name][leaf], v, f"{name}/{leaf}", atol=1e-10)
    assert math.isclose(res.bound_final, jr.bound_final, rel_tol=RTOL)


def test_run_fleet_reference_emits_and_carries_telemetry():
    from repro_torch.fleet import telemetry as TTEL
    _, tcfg = _configs({}, (2, 4), dict(rounds=2))
    sink = TTEL.MemorySink()
    res = TSYS.run_fleet_reference(
        dataclasses.replace(tcfg, telemetry=TTEL.TelemetryConfig()),
        sink=sink, device="cpu")
    assert res.telemetry["per_hist"].shape == (2, 2, 16)
    np.testing.assert_array_equal(res.telemetry["solver_iters"], 0)
    assert sink.records[0]["path"] == "reference" and len(sink.records) == 3


def test_run_fleet_reference_rejects_two_tier():
    _, tcfg = _configs({}, (2, 4), dict(cloud_period=2))
    with pytest.raises(NotImplementedError, match="two-tier"):
        TSYS.run_fleet_reference(tcfg, device="cpu")


# ---------------------------------------------------------------------------
# run_any and to_fleet_config
# ---------------------------------------------------------------------------

def test_to_fleet_config_matches_reference():
    jcfg, tcfg = _fl_configs(num_clients=6, samples=(20, 30, 40, 20, 30, 40),
                             rounds=4)
    jf, tf = JSYS.to_fleet_config(jcfg, 2), TSYS.to_fleet_config(tcfg, 2)
    assert dataclasses.asdict(tf.topology) == dataclasses.asdict(jf.topology)
    for f in ("weight", "rounds", "lr", "seed"):
        assert getattr(tf, f) == getattr(jf, f)
    with pytest.raises(ValueError, match="divisible"):
        TSYS.to_fleet_config(tcfg, 4)


def test_run_any_dispatch():
    cfg = TSYS.FLConfig(num_clients=8, samples=(20,) * 8, rounds=2,
                        hidden=(16,))
    small = TSYS.run_any(cfg, fleet_threshold=8, device="cpu")
    assert isinstance(small, TSYS.FLResult)
    assert small.losses == TSYS.run(cfg, device="cpu").losses
    fleet = TSYS.run_any(cfg, fleet_threshold=4, num_cells=2, device="cpu")
    assert isinstance(fleet, TENG.FleetResult)
    np.testing.assert_array_equal(fleet.losses, TENG.run_fleet(
        TSYS.to_fleet_config(cfg, 2), device="cpu").losses)
    baseline = TSYS.run_any(dataclasses.replace(cfg, scheme="gba"),
                            fleet_threshold=4, device="cpu")
    assert isinstance(baseline, TSYS.FLResult)
    task = TENG.resolve_task(TENG.FleetConfig())
    tasked = TSYS.run_any(dataclasses.replace(cfg, task=task),
                          fleet_threshold=8, device="cpu")
    assert isinstance(tasked, TENG.FleetResult)
    np.testing.assert_array_equal(tasked.losses, TSYS.run_fleet_reference(
        TSYS.to_fleet_config(dataclasses.replace(cfg, task=task)),
        device="cpu").losses)


# ---------------------------------------------------------------------------
# clients, server, data, tracker
# ---------------------------------------------------------------------------

def _mlp_numpy(seed=0, sizes=(20, 24, 10, 3)):
    rng = np.random.default_rng(seed)
    return {f"layer{i}": {"w": rng.normal(size=(a, b)),
                          "b": rng.normal(size=b) * 0.1}
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("rho", [0.0, 0.4, 0.8])
def test_make_masks_and_local_gradient_match_reference(structured, rho):
    params = _mlp_numpy()
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(6, 20)), rng.integers(0, 3, 6)
    with jax.enable_x64(True):
        jp = jax.tree.map(jnp.asarray, params)
        jm = JCLIENT.make_masks(jp, rho, structured=structured, block=8)
        jl, jg = JCLIENT.local_gradient(
            lambda p: JMLP.classifier_loss(p, jnp.asarray(x), jnp.asarray(y)),
            jp, jm)
    tp = weights.tree_from_numpy(params, torch.float64, "cpu")
    tm = TCLIENT.make_masks(tp, rho, structured=structured, block=8)
    tl, tg = TCLIENT.local_gradient(
        lambda p: TMLP.classifier_loss(p, torch.as_tensor(x),
                                       torch.as_tensor(y)), tp, tm)
    for name in params:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(tm[name][leaf].numpy(),
                                          np.asarray(jm[name][leaf]))
            _close(tg[name][leaf].numpy(), jg[name][leaf], f"{name}/{leaf}")
    _close(float(tl), float(jl), "loss")


def test_global_round_matches_reference():
    params = _mlp_numpy(2)
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(5, 20)), rng.integers(0, 3, 5))
               for _ in range(4)]
    k = np.array([30.0, 40.0, 50.0, 20.0])
    per = np.array([0.1, 0.6, 0.3, 0.9])
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        u = np.asarray(jax.random.uniform(key, per.shape))
        jp = jax.tree.map(jnp.asarray, params)
        fns = [lambda p, b=b: JCLIENT.local_gradient(
            lambda q: JMLP.classifier_loss(q, jnp.asarray(b[0]),
                                           jnp.asarray(b[1])),
            p, JCLIENT.make_masks(p, 0.3)) for b in batches]
        jnew, jarr, jloss = JSERVER.global_round(
            jp, fns, jnp.asarray(k), jnp.asarray(per), key, lr=0.1)
    tp = weights.tree_from_numpy(params, torch.float64, "cpu")
    fns = [lambda p, b=b: TCLIENT.local_gradient(
        lambda q: TMLP.classifier_loss(q, torch.as_tensor(b[0]),
                                       torch.as_tensor(b[1])),
        p, TCLIENT.make_masks(p, 0.3)) for b in batches]
    tnew, tarr, tloss = TSERVER.global_round(
        tp, fns, torch.as_tensor(k), torch.as_tensor(per),
        torch.as_tensor(np.array(u)), lr=0.1)
    np.testing.assert_array_equal(tarr.numpy(), np.asarray(jarr))
    _close(float(tloss), float(jloss), "loss")
    for name in params:
        for leaf in ("w", "b"):
            _close(tnew[name][leaf].numpy(), jnew[name][leaf],
                   f"{name}/{leaf}")


@pytest.mark.parametrize("seed", [0, 7])
def test_dataset_and_partitions_are_bitwise_the_reference(seed):
    kw = dict(num_train=400, num_test=60, seed=seed)
    j, t = JSYN.make_dataset(**kw), TSYN.make_dataset(**kw)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert getattr(t, f).dtype == getattr(j, f).dtype
    assert t.num_classes == j.num_classes and t.dim == j.dim == 784
    ks = [30, 40, 50, 30, 40]
    for a, b in zip(TSYN.partition_iid(ks, t, seed=seed),
                    JSYN.partition_iid(ks, j, seed=seed)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TSYN.partition_dirichlet(ks, t, alpha=0.3, seed=seed),
                    JSYN.partition_dirichlet(ks, j, alpha=0.3, seed=seed)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TSYN.partition_iid([300, 200], t)


def test_round_tracker_matches_reference():
    rng = np.random.default_rng(0)
    jt, tt = JCONV.RoundTracker(4), TCONV.RoundTracker(4)
    np.testing.assert_array_equal(tt.avg_per, jt.avg_per)
    for _ in range(3):
        per, prune = rng.uniform(size=4), rng.uniform(size=4)
        jt.record(per, prune)
        tt.record(per, prune)
    assert tt.rounds == jt.rounds == 3
    np.testing.assert_array_equal(tt.avg_per, jt.avg_per)
    np.testing.assert_array_equal(tt.avg_prune, jt.avg_prune)
    k = np.array([30.0, 40.0, 50.0, 20.0])
    jb = JCONV.ConvergenceBound(JCONV.SmoothnessParams(), k)
    tb = TCONV.ConvergenceBound(TCONV.SmoothnessParams(), k)
    assert tb.gamma(per, prune, 50) == jb.gamma(per, prune, 50)
    assert tb.learning_cost(per, prune) == jb.learning_cost(per, prune)
