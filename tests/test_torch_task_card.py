"""The generic gradient path's tasks on the card against the CPU (``gpu``).

JAX-free, so it runs on the card's machine.  A small fleet from the same
numpy population and draws, and the same numpy params and task state, runs
on the CPU (plain versions) and on the card (the tile-norm kernel, autograd
on plain torch) in float32, at 1e-4 relative: a ``LinearRegressionTask``
fleet (2 cells x 4 clients, 3 rounds, sync and async) and a
``TransformerTask`` fleet at the smoke width (2 cells x 3 clients, 2
rounds).  The card's run launches one tile-norm ranking a round and never
the MLP's fused kernel; ``masked_scan_grads`` repeats bit for bit on the
card at a given block size, batched or client by client.
"""

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.core import pruning as TPR
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import scheduler as TSCHED
from repro_torch.fleet import task as TTASK
from repro_torch.fleet import topology as TTOPO
from repro_torch.kernels import block_norms as TBN
from repro_torch.kernels import fleet_fused as TFF



@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def numpy_fleet(cells, per_cell, draws, seed=17):
    """Population and per-round draws of a small fleet, made with numpy."""
    rng = np.random.default_rng(seed)
    shape = (cells, per_cell)
    dist = rng.uniform(50, 500, shape)
    pathloss = 10.0 ** (-(128.1 + 37.6 * np.log10(dist / 1000.0)) / 10.0)
    pop = dict(dist_m=dist, pathloss=pathloss,
               cpu_hz=rng.uniform(2e9, 8e9, shape),
               num_samples=rng.integers(16, 65, shape).astype(np.float64),
               tx_power=np.full(shape, 10 ** 2.3 * 1e-3),
               max_prune=np.full(shape, 0.7))
    rounds = [(pathloss * rng.exponential(size=shape),
               pathloss * rng.exponential(size=shape),
               rng.uniform(size=shape), rng.uniform(size=shape), None)
              for _ in range(draws)]
    return pop, rounds


def _task_start(task, seed=3):
    """The task's params and state drawn on the CPU, as numpy (both
    devices start from these)."""
    gen = torch.Generator().manual_seed(seed)
    state = task.build(gen, torch.float32, "cpu")
    params = task.init_params(gen, torch.float32, "cpu")
    return weights.to_numpy(params), weights.to_numpy(state)


def _card_vs_cpu(cfg, mode="sync"):
    c, i = cfg.topology.num_cells, cfg.topology.clients_per_cell
    pop, rounds = numpy_fleet(c, i, cfg.rounds + 1)
    params, state = _task_start(cfg.task)
    res = {}
    for dev in ("cpu", "cuda"):
        src = TENG.InjectedDraws(
            weights.population_from_numpy(pop, device=dev),
            [weights.round_draws_from_numpy(*d, device=dev) for d in rounds])
        start = weights.start_from_numpy(params, state, device=dev)
        fused, norms = TFF.fused_fleet_grads.launches, TBN.tile_norms.launches
        res[dev] = TENG.run_fleet(cfg, mode, device=dev, draws=src,
                                  start=start)
    launched = (TFF.fused_fleet_grads.launches - fused,
                TBN.tile_norms.launches - norms)
    a, b = res["cuda"], res["cpu"]
    for f in ("losses", "accuracy", "latencies", "mean_prune"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(a.participants, b.participants)
    for x, y in zip(TPR.flatten(a.params), TPR.flatten(b.params)):
        np.testing.assert_allclose(x, y, rtol=1e-4,
                                   atol=1e-4 * (np.abs(y).max() + 1e-6))
    return a, launched


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_linreg_rounds_card_match_cpu(card, mode):
    cfg = TENG.FleetConfig(
        task=TTASK.LinearRegressionTask(noise=0.05),
        topology=TTOPO.FleetTopology(2, 4), kernel="fused", rounds=3,
        lr=0.1, async_config=TSCHED.AsyncConfig(buffer_size=4,
                                                max_staleness=3))
    res, launched = _card_vs_cpu(cfg, mode)
    assert launched[0] == 0
    if mode == "sync":
        assert launched[1] == cfg.rounds
        assert res.losses[-1] < res.losses[0]
    else:
        assert launched[1] > 0


@pytest.mark.gpu
def test_transformer_rounds_card_match_cpu(card):
    cfg = TENG.FleetConfig(task=TTASK.TransformerTask(),
                           topology=TTOPO.FleetTopology(2, 3),
                           kernel="fused", rounds=2, lr=0.5)
    res, launched = _card_vs_cpu(cfg)
    assert launched == (0, cfg.rounds)
    assert np.all(np.isfinite(res.losses))


def _set_block(monkeypatch, params, clients):
    """Size ``masked_scan_grads``' blocks to ``clients`` clients."""
    nbytes = sum(leaf.numel() * leaf.element_size()
                 for leaf in TPR.flatten(params))
    monkeypatch.setattr(TFF, "_SCAN_BLOCK_BYTES", clients * 4 * nbytes)


@pytest.mark.gpu
@pytest.mark.parametrize("alone", [False, True])
def test_masked_scan_grads_card_reruns_bitwise(card, monkeypatch, alone):
    """On the card the weighted sum repeats bit for bit at a given block
    size, batched (vmap) or client by client (autograd, the path of a
    model too large for two clients a block), and agrees with the CPU's
    within 1e-4; two block sizes agree within 1e-5."""
    task = TTASK.TransformerTask()
    params = task.init_params(torch.Generator(device="cuda").manual_seed(0))
    state = task.build(torch.Generator(device="cuda").manual_seed(1),
                       torch.float32, "cuda")
    batch = task.client_batch(state, 0, torch.arange(5, device="cuda"))
    keeps = TPR.block_keep(task.kernel_prepare(params),
                           torch.linspace(0.0, 0.6, 5, device="cuda"))
    w = torch.linspace(0.5, 1.5, 5, device="cuda")
    grid = task.tile_grid(params)

    def run(block, dev="cuda"):
        _set_block(monkeypatch, params, 1 if alone else block)
        move = lambda t: t.to(dev)
        return TFF.masked_scan_grads(
            task.loss, TPR.tree_map(move, params),
            TPR.tree_map(move, batch), [None if k is None else move(k)
                                        for k in keeps], move(w), grid)

    paths = TPR._flatten_prunable(params)[0]
    for block in (5, 2):
        (g1, l1), (g2, l2) = run(block), run(block)
        assert torch.equal(l1, l2)
        moved = [i for i, (a, b) in enumerate(zip(TPR.flatten(g1),
                                                  TPR.flatten(g2)))
                 if not torch.equal(a, b)]
        assert not moved, [tuple(paths[i].shape) for i in moved]
    (g0, l0), (gc, lc) = run(5), run(5, "cpu")
    for (g, l), rtol in (((g2, l2), 1e-5), ((gc, lc), 1e-4)):
        np.testing.assert_allclose(l.cpu().numpy(), l0.cpu().numpy(),
                                   rtol=rtol)
        for a, b in zip(TPR.flatten(g), TPR.flatten(g0)):
            b = b.cpu().numpy()
            np.testing.assert_allclose(a.cpu().numpy(), b, rtol=rtol,
                                       atol=rtol * np.abs(b).max())
