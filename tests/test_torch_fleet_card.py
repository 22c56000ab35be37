"""The fleet engine's new paths on the card against the CPU (``gpu``).

JAX-free, so it runs on the card's machine: a small fleet (the ragged
32 -> 12 -> 6 -> 5 MLP, block 8) from the same numpy population, draws
(Gumbel scores included), params, task state and batches, run on the CPU
(plain versions) and on the card (kernels) in float32, at 1e-4 relative:
the reference kernel with block masks, the cohort path under uniform and
weighted schedules with ``control_chunk``, and async events (fused and
reference); then hex cells (population and draws made on the CPU by the
default draw source, carried across as numpy), two-tier sync and async,
Dirichlet labels and streamed client data (both drawn on each device from
the same numpy task state).  The launches the card run makes are
counted: the fused paths launch the fused kernel and the tile norms, the
reference path with block masks and the two-tier async event the tile
norms.
"""

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import scheduler as TSCHED
from repro_torch.fleet import solver as TSOL
from repro_torch.fleet import task as TTASK
from repro_torch.fleet import topology as TTOPO
from repro_torch.kernels import block_norms as TBN
from repro_torch.kernels import fleet_fused as TFF

SIZES = (32, 12, 6, 5)
UNIFORM = dict(participation="uniform", participants_per_cell=2)
# (mode, schedule, topology, FleetConfig overrides)
PATHS = {
    "reference_block": ("sync", {}, (2, 4),
                        dict(kernel="reference", mask_kind="block")),
    "reference_magnitude": ("sync", {}, (2, 4), dict(kernel="reference")),
    "uniform_cohort_chunked": ("sync", UNIFORM, (3, 5),
                               dict(control_chunk=2, cell_chunk=2)),
    "weighted_cohort": ("sync", dict(participation="weighted",
                                     participants_per_cell=3), (2, 6), {}),
    "async_fused": ("async", dict(straggler_prob=0.2), (2, 6), {}),
    "async_reference": ("async", {}, (2, 6), dict(kernel="reference")),
}


def numpy_fleet(cells, per_cell, draws, seed=11):
    """Population, draws, params, task state and batches, made with
    numpy (both devices start from these)."""
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
               rng.uniform(size=shape), rng.uniform(size=shape),
               rng.gumbel(size=shape)) for _ in range(draws)]
    params = {f"layer{l}": {"w": rng.normal(size=(a, b)) * np.sqrt(2.0 / a),
                            "b": np.zeros(b)}
              for l, (a, b) in enumerate(zip(SIZES[:-1], SIZES[1:]))}
    templates = rng.normal(size=(SIZES[-1], SIZES[0]))
    y_test = rng.integers(0, SIZES[-1], 64)
    state = dict(templates=templates, y_test=y_test,
                 x_test=templates[y_test] + 0.5 * rng.normal(
                     size=(64, SIZES[0])))
    y = rng.integers(0, SIZES[-1], (cells * per_cell, 8))
    batches = dict(y=y, x=templates[y] + 0.5 * rng.normal(
        size=(cells * per_cell, 8, SIZES[0])))
    return pop, rounds, params, state, batches


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(PATHS))
def test_fleet_path_card_matches_cpu(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mode, schedule, (c, i), extra = PATHS[path]
    cfg = TENG.FleetConfig(
        task=TTASK.SyntheticMLPTask(feature_dim=SIZES[0], hidden=SIZES[1:-1],
                                    num_classes=SIZES[-1], test_samples=64,
                                    prune_block=8),
        topology=TTOPO.FleetTopology(c, i),
        schedule=TSCHED.ScheduleConfig(**schedule),
        async_config=TSCHED.AsyncConfig(buffer_size=6, max_staleness=3),
        **dict(dict(kernel="fused", rounds=3, lr=0.05), **extra))
    pop, rounds, params, state, batches = numpy_fleet(c, i, cfg.rounds + 1)
    res = {}
    for dev in ("cpu", "cuda"):
        src = TENG.InjectedDraws(
            weights.population_from_numpy(pop, device=dev),
            [weights.round_draws_from_numpy(*d, device=dev) for d in rounds])
        start = weights.start_from_numpy(params, state, batches, device=dev)
        fused, norms = TFF.fused_fleet_grads.launches, TBN.tile_norms.launches
        res[dev] = TENG.run_fleet(cfg, mode, device=dev, draws=src,
                                  start=start)
    # the card's run: (fused kernel, tile norms) launches
    launched = (TFF.fused_fleet_grads.launches - fused,
                TBN.tile_norms.launches - norms)
    if cfg.kernel == "fused" and mode == "async":
        # one ranking and one fused call per populated ring slot
        assert launched[0] > 0 and launched[0] == launched[1]
    elif cfg.kernel == "fused":
        # one ranking a round, one fused call per chunk of cells
        chunks = -(-c // cfg.cell_chunk) if 0 < cfg.cell_chunk < c else 1
        assert launched == (cfg.rounds * chunks, cfg.rounds)
    elif cfg.mask_kind == "block":
        assert launched[0] == 0 and launched[1] > 0
    else:
        assert launched == (0, 0)
    a, b = res["cuda"], res["cpu"]
    for f in ("losses", "latencies", "wall_clock", "mean_prune"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-4,
                                   err_msg=f)
    np.testing.assert_array_equal(a.participants, b.participants)
    for name, layer in b.params.items():
        for leaf, v in layer.items():
            scale = float(np.abs(v).max()) + 1e-6
            np.testing.assert_allclose(a.params[name][leaf], v, rtol=1e-4,
                                       atol=1e-4 * scale)


@pytest.mark.gpu
def test_reference_block_equals_fused_on_gpu():
    """One round of 2 cells x 8 clients from the same draws: the reference
    kernel with block masks equals the fused kernel on the card at 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pop, rounds, params, state, batches = numpy_fleet(2, 8, 1)
    out = {}
    for kernel in ("fused", "reference"):
        cfg = TENG.FleetConfig(
            task=TTASK.SyntheticMLPTask(feature_dim=SIZES[0],
                                        hidden=SIZES[1:-1],
                                        num_classes=SIZES[-1],
                                        test_samples=64, prune_block=8),
            topology=TTOPO.FleetTopology(2, 8), kernel=kernel,
            mask_kind="block", rounds=1, lr=0.05)
        src = TENG.InjectedDraws(
            weights.population_from_numpy(pop, device="cuda"),
            [weights.round_draws_from_numpy(*d, device="cuda")
             for d in rounds])
        start = weights.start_from_numpy(params, state, batches,
                                         device="cuda")
        out[kernel] = TENG.run_fleet(cfg, device="cuda", draws=src,
                                     start=start)
    np.testing.assert_allclose(out["reference"].losses, out["fused"].losses,
                               rtol=1e-4)
    for name, layer in out["fused"].params.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(out["reference"].params[name][leaf],
                                       v, rtol=1e-4, atol=1e-6)


# (mode, schedule, topology, FleetConfig overrides) of the paths whose
# batches, population or draws do not come from ``numpy_fleet`` alone
HEX = TTOPO.HexInterference(reuse=1, max_neighbors=2, mobility_m=25.0)
NEW_PATHS = {
    "hex": ("sync", {}, (3, 4), dict(geometry=HEX, solver=TSOL.SolverConfig(
        fp_rtol=0.0))),
    "two_tier_sync": ("sync", {}, (3, 4), dict(cloud_period=2)),
    "two_tier_async": ("async", dict(straggler_prob=0.2), (3, 4),
                       dict(cloud_period=2)),
    "dirichlet": ("sync", {}, (3, 4), {}),
    "streaming": ("sync", {}, (3, 4), dict(cache_data=False, cell_chunk=2)),
}


def to_numpy(tree):
    """A population or round draws (NamedTuples of tensors) as dicts of
    numpy arrays, None kept."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.numpy()
    return {k: to_numpy(v) for k, v in tree._asdict().items()}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(NEW_PATHS))
def test_new_fleet_path_card_matches_cpu(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mode, schedule, (c, i), extra = NEW_PATHS[path]
    cfg = TENG.FleetConfig(
        task=TTASK.SyntheticMLPTask(
            feature_dim=SIZES[0], hidden=SIZES[1:-1], num_classes=SIZES[-1],
            test_samples=64, prune_block=8,
            dirichlet_alpha=0.3 if path == "dirichlet" else None),
        topology=TTOPO.FleetTopology(c, i),
        schedule=TSCHED.ScheduleConfig(**schedule),
        async_config=TSCHED.AsyncConfig(buffer_size=8, max_staleness=3),
        **dict(dict(kernel="fused", rounds=3, lr=0.05), **extra))
    pop, rounds, params, state, batches = numpy_fleet(c, i, cfg.rounds + 1)
    rounds = [dict(zip(("h_up", "h_down", "u_strag", "u_arr", "gumbel"), d))
              for d in rounds]
    if path == "hex":
        src = TENG.GeneratorDraws(5, "cpu", geometry=HEX)
        hex_pop = src.population(cfg.topology, 0.2, torch.float32)
        pop = to_numpy(hex_pop)
        rounds = [to_numpy(src.round(r, hex_pop))
                  for r in range(cfg.rounds + 1)]
    if path == "dirichlet":
        gam = np.random.default_rng(3).gamma(0.3, size=(c * i, SIZES[-1]))
        state["label_cdf"] = np.cumsum(gam / gam.sum(-1, keepdims=True), -1)
    if path in ("dirichlet", "streaming"):
        batches = None       # drawn on each device from the task state
    res = {}
    for dev in ("cpu", "cuda"):
        src = TENG.InjectedDraws(
            weights.population_from_numpy(pop, device=dev),
            [weights.round_draws_from_numpy(**d, device=dev) for d in rounds])
        start = weights.start_from_numpy(params, state, batches, device=dev)
        fused, norms = TFF.fused_fleet_grads.launches, TBN.tile_norms.launches
        res[dev] = TENG.run_fleet(cfg, mode, device=dev, draws=src,
                                  start=start)
    launched = (TFF.fused_fleet_grads.launches - fused,
                TBN.tile_norms.launches - norms)
    if path == "two_tier_sync":      # a ranking and a fused call per cell
        assert launched == (cfg.rounds * c, cfg.rounds * c)
    elif path == "two_tier_async":   # per-client block masks: rankings only
        assert launched[0] == 0 and launched[1] > 0
    else:
        chunks = -(-c // cfg.cell_chunk) if 0 < cfg.cell_chunk < c else 1
        assert launched == (cfg.rounds * chunks, cfg.rounds)
    a, b = res["cuda"], res["cpu"]
    for f in ("losses", "latencies", "wall_clock", "mean_prune"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-4,
                                   err_msg=f)
    np.testing.assert_array_equal(a.participants, b.participants)
    for name, layer in b.params.items():
        for leaf, v in layer.items():
            scale = float(np.abs(v).max()) + 1e-6
            np.testing.assert_allclose(a.params[name][leaf], v, rtol=1e-4,
                                       atol=1e-4 * scale)
