"""Telemetry and the host reference path on the card against the CPU
(``gpu``).

JAX-free, so it runs on the card's machine.  The telemetry histogram is
bitwise equal on the card and the CPU and on a rerun (integer counts;
the weighted form's one-hot product at 1e-6); a fleet round with
telemetry leaves the card's losses and params bitwise as without it;
the §V ``run`` (the 784-60-20-10 DNN, magnitude and block-16 masks) and
``run_fleet_reference`` (a ragged 32 -> 12 -> 6 -> 5 MLP) from the same
numpy start on the card and on the CPU agree at 1e-4 relative, the card
runs launching one tile-norm ranking a round where masks are block
masks.
"""

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.federated import system as TSYS
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import task as TTASK
from repro_torch.fleet import telemetry as TTEL
from repro_torch.fleet import topology as TTOPO
from repro_torch.kernels import block_norms as TBN
from repro_torch.kernels import fleet_fused as TFF

TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
def test_histogram_card_matches_cpu(weighted):
    _card()
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 0.6, (100, 1000)).astype(np.float32)
    x[0, :4] = [np.nan, np.inf, -np.inf, 1.0]
    w = rng.uniform(size=x.shape).astype(np.float32) if weighted else None

    def hist(dev):
        return TTEL.histogram(
            torch.as_tensor(x, device=dev), 0.0, 1.0, 16,
            None if w is None else torch.as_tensor(w, device=dev)).cpu()

    cpu, card, again = hist("cpu"), hist("cuda"), hist("cuda")
    assert torch.equal(card, again)
    if weighted:
        assert _rel(card, cpu) < 1e-6
    else:
        assert torch.equal(card, cpu)
        assert torch.all(card.sum(-1) == 1000)


def _tiny_fleet(**kw):
    return TENG.FleetConfig(
        task=TTASK.SyntheticMLPTask(feature_dim=32, hidden=(12, 6),
                                    num_classes=5, prune_block=8),
        topology=TTOPO.FleetTopology(3, 4), rounds=3, kernel="fused",
        lr=0.05, **kw)


@pytest.mark.gpu
def test_telemetry_on_card_leaves_the_round_bitwise():
    _card()
    off = TENG.run_fleet(_tiny_fleet())
    on = TENG.run_fleet(_tiny_fleet(telemetry=TTEL.TelemetryConfig()))
    np.testing.assert_array_equal(off.losses, on.losses)
    for k, layer in off.params.items():
        for n, v in layer.items():
            np.testing.assert_array_equal(v, on.params[k][n])
    assert np.all(on.telemetry["per_hist"].sum(-1) == 4)


@pytest.mark.gpu
@pytest.mark.parametrize("structured", [False, True])
def test_run_card_matches_cpu(structured):
    _card()
    rng = np.random.default_rng(1)
    sizes = (784, 60, 20, 10)
    params = {f"layer{i}": {"w": rng.normal(size=(a, b)) * np.sqrt(2.0 / a),
                            "b": np.zeros(b)}
              for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    uniforms = rng.uniform(size=(2, 5))
    cfg = TSYS.FLConfig(rounds=2, hidden=(60, 20), structured=structured)
    TBN.tile_norms.launches = 0
    out = {dev: TSYS.run(cfg, device=dev, start=weights.run_start_from_numpy(
        params, uniforms, device=dev)) for dev in ("cpu", "cuda")}
    assert TBN.tile_norms.launches == (2 if structured else 0)
    assert _rel(out["cuda"].losses, out["cpu"].losses) < TOL
    for k, layer in out["cpu"].params.items():
        for n, v in layer.items():
            assert _rel(out["cuda"].params[k][n], v) < TOL
    assert out["cuda"].total_costs == out["cpu"].total_costs


@pytest.mark.gpu
def test_run_fleet_reference_card_matches_cpu():
    _card()
    cfg = _tiny_fleet()
    src = TENG.GeneratorDraws(cfg.seed, "cpu")
    pop = src.population(cfg.topology, cfg.wireless.tx_power_ue_w,
                         torch.float32)
    draws = [src.round(r, pop) for r in range(cfg.rounds)]
    task = TENG.resolve_task(cfg)
    g = torch.Generator().manual_seed(3)
    params = task.init_params(g, torch.float32, "cpu")
    state = task.build(g, torch.float32, "cpu",
                       num_clients=cfg.topology.num_clients)

    def on(dev, tree):
        return weights.tree_from_numpy(weights.to_numpy(tree), device=dev)

    out = {}
    TFF.fused_fleet_grads.launches = 0
    for dev in ("cpu", "cuda"):
        inj = TENG.InjectedDraws(
            weights.population_from_numpy(
                {f: getattr(pop, f).numpy()
                 for f in TTOPO.POPULATION_ARRAYS}, device=dev),
            [weights.round_draws_from_numpy(
                *(getattr(d, f).numpy() for f in ("h_up", "h_down",
                                                  "u_strag", "u_arr")),
                device=dev) for d in draws])
        out[dev] = TSYS.run_fleet_reference(
            cfg, device=dev, draws=inj,
            start=TENG.SimStart(on(dev, params), on(dev, state)))
    assert TFF.fused_fleet_grads.launches == cfg.rounds
    a, b = out["cuda"], out["cpu"]
    assert _rel(a.losses, b.losses) < TOL
    assert _rel(a.deadlines, b.deadlines) < TOL
    for k, layer in b.params.items():
        for n, v in layer.items():
            assert _rel(a.params[k][n], v) < TOL
