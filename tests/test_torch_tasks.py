"""The generic gradient path and ``LinearRegressionTask``: the port
against the JAX package.

``masked_scan_grads`` (the generic tasks' fused path) takes the same
params, client batches, tile keeps and weights as the reference's
``lax.scan`` of the same name, on the CPU in float64 (the reference under
``jax.enable_x64(True)``), and must agree at 1e-10; against the port's own
oracle (``masked_client_grads`` then ``weighted_sum``) at 1e-6; and its
block size must change no bit.  Then twins of the linreg tests of
``tests/test_fleet_task.py`` and ``tests/test_fleet_topology.py`` (the
exact closed-form contraction, convergence, ``run_any``'s two paths,
``run_fleet_reference`` with partial participation, a deadline and
interference), a linreg fleet run against the JAX engine from injected
draws (1e-5), and the port's own properties: streamed batches equal
cached bit for bit, and the task's model size reaching the wireless
model.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import pruning as JPR
from repro.fleet import engine as JENG
from repro.fleet import scheduler as JSCHED
from repro.fleet import task as JTASK
from repro.fleet import topology as JTOPO
from repro.kernels import fleet_fused as JFF
from repro_torch import weights
from repro_torch.core import pruning as TPR
from repro_torch.federated import system as TSYS
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import scheduler as TSCHED
from repro_torch.fleet import solver as TSOL
from repro_torch.fleet import task as TTASK
from repro_torch.fleet import topology as TTOPO
from repro_torch.kernels import fleet_fused as TFF

from test_torch_engine import _port, _reference

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-5


def _tiny(clients=8, cells=1, **kw):
    return TENG.FleetConfig(
        topology=TTOPO.FleetTopology(num_cells=cells,
                                     clients_per_cell=clients), **kw)


# ---------------------------------------------------------------------------
# masked_scan_grads against the reference's scan and the vmap oracle
# ---------------------------------------------------------------------------

def _mlp_inputs(clients=7, seed=0):
    """A two-layer MLP's params, per-client batches, rates and weights, as
    numpy float64 (ragged leaves on block 4: 10 x 6 and 6 x 3)."""
    rng = np.random.default_rng(seed)
    params = {"layer0": {"w": rng.normal(size=(10, 6)),
                         "b": rng.normal(size=6)},
              "layer1": {"w": rng.normal(size=(6, 3)),
                         "b": rng.normal(size=3)}}
    batch = {"x": rng.normal(size=(clients, 5, 10)),
             "y": rng.integers(0, 3, (clients, 5))}
    rho = rng.uniform(0.0, 0.8, clients)
    rho[0] = 0.0
    w = rng.uniform(0.2, 2.0, clients)
    w[2] = 0.0
    return params, batch, rho, w


def _mlp_loss_j(p, b):
    from repro.models import mlp
    return mlp.classifier_loss(p, b["x"], b["y"])


def _mlp_loss_t(p, b):
    from repro_torch.models import mlp
    return mlp.classifier_loss(p, b["x"], b["y"])


@pytest.mark.parametrize("block", [4, (4, 2), [(5, 2), None, (3, 3), None]])
def test_masked_scan_grads_matches_reference(block):
    """Same params, batches, keeps and weights: the port's blocked scan
    equals the reference's lax.scan at 1e-10 (float64), losses too."""
    params, batch, rho, w = _mlp_inputs()
    with jax.enable_x64(True):
        jp = jax.tree.map(jnp.asarray, params)
        keeps = JPR.block_keep(JPR.block_norm_state(jp, block),
                               jnp.asarray(rho))
        jg, jl = JFF.masked_scan_grads(_mlp_loss_j, jp,
                                       jax.tree.map(jnp.asarray, batch),
                                       keeps, jnp.asarray(w), block)
        keeps = [None if k is None else np.asarray(k) for k in keeps]
    tp = weights.tree_from_numpy(params, torch.float64, "cpu")
    tkeeps = [None if k is None else torch.tensor(k) for k in keeps]
    tg, tl = TFF.masked_scan_grads(
        _mlp_loss_t, tp, weights.tree_from_numpy(batch, torch.float64, "cpu"),
        tkeeps, torch.as_tensor(w), block)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-10)
    for a, b in zip(TPR.flatten(tg), jax.tree.leaves(jg)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_masked_scan_grads_matches_vmap_oracle():
    """The port's own oracle: per-client masks, vmap autodiff, re-mask,
    weighted sum (``masked_client_grads`` + ``weighted_sum``), 1e-6."""
    params, batch, rho, w = _mlp_inputs(clients=9, seed=1)
    tp = weights.tree_from_numpy(params, torch.float64, "cpu")
    tb = weights.tree_from_numpy(batch, torch.float64, "cpu")
    rho_t, w_t = torch.as_tensor(rho), torch.as_tensor(w)
    state = TPR.block_norm_state(tp, 4)
    got, losses = TFF.masked_scan_grads(_mlp_loss_t, tp, tb,
                                        TPR.block_keep(state, rho_t), w_t, 4)
    masks = TPR.masks_from_state(tp, state, rho_t, 4)
    ref_losses, grads = TFF.masked_client_grads(_mlp_loss_t, tp, masks, tb)
    want = TFF.weighted_sum(w_t, grads)
    np.testing.assert_allclose(losses.numpy(), ref_losses.numpy(), rtol=1e-6)
    for a, b in zip(TPR.flatten(got), TPR.flatten(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-12)


def _set_block(monkeypatch, params, clients):
    """Size ``masked_scan_grads``' blocks to ``clients`` clients."""
    nbytes = sum(leaf.numel() * leaf.element_size()
                 for leaf in TPR.flatten(params))
    monkeypatch.setattr(TFF, "_SCAN_BLOCK_BYTES", clients * 4 * nbytes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_size_changes_no_bit(monkeypatch, dtype):
    params, batch, rho, w = _mlp_inputs(clients=11, seed=2)
    tp = weights.tree_from_numpy(params, dtype, "cpu")
    tb = weights.tree_from_numpy(batch, dtype, "cpu")
    keeps = TPR.block_keep(TPR.block_norm_state(tp, 4),
                           torch.as_tensor(rho, dtype=dtype))
    w_t = torch.as_tensor(w, dtype=dtype)
    runs = []
    for b in (2, 3, 11, 40):
        _set_block(monkeypatch, tp, b)
        assert TFF.scan_block(tp, 11) == min(b, 11)
        runs.append(TFF.masked_scan_grads(_mlp_loss_t, tp, tb, keeps, w_t,
                                          4))
    for g, losses in runs[1:]:
        assert torch.equal(losses, runs[0][1])
        for a, b in zip(TPR.flatten(g), TPR.flatten(runs[0][0])):
            assert torch.equal(a, b)


def test_accumulator_dtype_promotes_weights_and_leaves():
    """float32 params with float64 weights accumulate in float64 (the
    reference's promote_types(weights, float32) with each leaf)."""
    params, batch, rho, w = _mlp_inputs(clients=3)
    tp = weights.tree_from_numpy(params, torch.float32, "cpu")
    tb = weights.tree_from_numpy(batch, torch.float32, "cpu")
    keeps = TPR.block_keep(TPR.block_norm_state(tp, 4),
                           torch.as_tensor(rho, dtype=torch.float32))
    for wd, want in ((torch.float32, torch.float32),
                     (torch.float64, torch.float64)):
        g, _ = TFF.masked_scan_grads(_mlp_loss_t, tp, tb, keeps,
                                     torch.as_tensor(w, dtype=wd), 4)
        assert {leaf.dtype for leaf in TPR.flatten(g)} == {want}


def test_scan_block_sizes_from_param_bytes():
    small = {"w": torch.zeros(8, 2)}
    assert TFF.scan_block(small, 10_000) == 10_000
    big = {"w": torch.empty((140_000_000,), device="meta")}   # ~560 MB
    assert TFF.scan_block(big, 32) == 1
    assert TFF.scan_block(small, 0) == 1


def test_large_model_goes_client_by_client(monkeypatch):
    """A model too large for two clients a block takes plain autograd
    client by client: within 1e-12 of the batched path (float64), and the
    same bits on a rerun."""
    params, batch, rho, w = _mlp_inputs(clients=5, seed=3)
    tp = weights.tree_from_numpy(params, torch.float64, "cpu")
    tb = weights.tree_from_numpy(batch, torch.float64, "cpu")
    keeps = TPR.block_keep(TPR.block_norm_state(tp, 4), torch.as_tensor(rho))
    w_t = torch.as_tensor(w)
    batched = TFF.masked_scan_grads(_mlp_loss_t, tp, tb, keeps, w_t, 4)
    _set_block(monkeypatch, tp, 1)
    runs = [TFF.masked_scan_grads(_mlp_loss_t, tp, tb, keeps, w_t, 4)
            for _ in range(2)]
    for g, losses in runs:
        assert torch.equal(losses, runs[0][1])
        np.testing.assert_allclose(losses.numpy(), batched[1].numpy(),
                                   rtol=1e-12)
        for a, b, c in zip(TPR.flatten(g), TPR.flatten(runs[0][0]),
                           TPR.flatten(batched[0])):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-12,
                                       atol=1e-14)


# ---------------------------------------------------------------------------
# The task registry and LinearRegressionTask
# ---------------------------------------------------------------------------

def test_make_task_registry():
    assert isinstance(TTASK.make_task("mlp"), TTASK.SyntheticMLPTask)
    assert isinstance(TTASK.make_task("transformer"), TTASK.TransformerTask)
    assert isinstance(TTASK.make_task("linreg"), TTASK.LinearRegressionTask)
    assert sorted(TTASK.TASKS) == sorted(JTASK.TASKS)
    with pytest.raises(ValueError, match="unknown task"):
        TTASK.make_task("resnet")


def _linreg_numpy(clients=6, seed=0):
    """The reference's linreg task state, params and client batches
    (x64), as numpy."""
    with jax.enable_x64(True):
        task = JTASK.LinearRegressionTask(noise=0.0)
        kt, ke, ki, kd = jax.random.split(jax.random.PRNGKey(seed), 4)
        state = task.build(kt, ke)
        params = task.init_params(ki)
        batch = jax.vmap(lambda i: task.client_batch(state, kd, i))(
            jnp.arange(clients))
        to_np = lambda t: jax.tree.map(np.asarray, t)
        return to_np(state), to_np(params), to_np(batch)


def _gd_theta(task, params, batch, lr, steps):
    """``steps`` full-batch GD steps on the mean client loss; theta stacks
    W over b."""
    def mean_loss(p):
        return torch.mean(torch.func.vmap(lambda b: task.loss(p, b))(batch))

    p = params
    for _ in range(steps):
        g = torch.func.grad(mean_loss)(p)
        p = TPR.tree_map(lambda q, gi: q - lr * gi, p, g)
    return torch.cat([p["linear"]["w"], p["linear"]["b"][None, :]], dim=0)


def test_linreg_gd_contracts_at_exact_closed_form_rate():
    """theta_{t+1} - theta* = (I - lr H)(theta_t - theta*) exactly: 25 GD
    steps land on the matrix-power prediction at float64 precision, on the
    port's own draws; on the reference's data the port's GD equals the
    reference's at 1e-10."""
    task = TTASK.LinearRegressionTask(noise=0.0)
    gen = torch.Generator().manual_seed(0)
    state = task.build(gen, torch.float64, "cpu")
    params = task.init_params(gen, torch.float64, "cpu")
    batch = task.client_batch(state, 5, torch.arange(6))
    x = batch["x"].reshape(-1, task.feature_dim)
    y = batch["y"].reshape(-1, task.targets)
    a = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype)], dim=-1)
    h = a.T @ a / a.shape[0]
    w_star, b_star = task.optimum(x, y)
    theta_star = torch.cat([w_star, b_star[None, :]], dim=0)
    lr, steps = 0.05, 25
    theta0 = torch.cat([params["linear"]["w"],
                        params["linear"]["b"][None, :]], dim=0)
    theta_t = _gd_theta(task, params, batch, lr, steps)
    m = torch.eye(h.shape[0], dtype=h.dtype) - lr * h
    expect = theta_star + torch.linalg.matrix_power(m, steps) \
        @ (theta0 - theta_star)
    np.testing.assert_allclose(theta_t.numpy(), expect.numpy(), rtol=1e-9,
                               atol=1e-11)
    # noise-free data: the optimum is the generating parameters
    np.testing.assert_allclose(w_star.numpy(), state["w_true"].numpy(),
                               rtol=1e-8, atol=1e-9)

    jstate, jparams, jbatch = _linreg_numpy()
    with jax.enable_x64(True):
        jtask = JTASK.LinearRegressionTask(noise=0.0)

        def mean_loss(p):
            return jnp.mean(jax.vmap(lambda b: jtask.loss(p, b))(
                jax.tree.map(jnp.asarray, jbatch)))

        p = jax.tree.map(jnp.asarray, jparams)
        for _ in range(steps):
            g = jax.grad(mean_loss)(p)
            p = jax.tree.map(lambda q, gi: q - lr * gi, p, g)
        want = np.concatenate([np.asarray(p["linear"]["w"]),
                               np.asarray(p["linear"]["b"])[None]], 0)
        jw, jb = jtask.optimum(
            jnp.asarray(jbatch["x"].reshape(-1, task.feature_dim)),
            jnp.asarray(jbatch["y"].reshape(-1, task.targets)))
    got = _gd_theta(task, weights.tree_from_numpy(jparams, torch.float64,
                                                  "cpu"),
                    weights.tree_from_numpy(jbatch, torch.float64, "cpu"),
                    lr, steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    tw, tb = task.optimum(
        torch.tensor(jbatch["x"].reshape(-1, task.feature_dim)),
        torch.tensor(jbatch["y"].reshape(-1, task.targets)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-10,
                               atol=1e-12)


def test_linreg_loss_and_r2_match_reference():
    jstate, jparams, jbatch = _linreg_numpy(clients=3, seed=4)
    with jax.enable_x64(True):
        jtask = JTASK.LinearRegressionTask()
        jp = jax.tree.map(jnp.asarray, jparams)
        jl = jtask.loss(jp, jax.tree.map(lambda a: jnp.asarray(a[1]), jbatch))
        jr2 = jtask.eval_metrics(jax.tree.map(jnp.asarray, jstate),
                                 jp)["accuracy"]
    task = TTASK.LinearRegressionTask()
    tp = weights.tree_from_numpy(jparams, torch.float64, "cpu")
    tl = task.loss(tp, weights.tree_from_numpy(
        {k: v[1] for k, v in jbatch.items()}, torch.float64, "cpu"))
    tr2 = task.eval_metrics(weights.tree_from_numpy(jstate, torch.float64,
                                                    "cpu"), tp)["accuracy"]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-10)
    np.testing.assert_allclose(float(tr2), float(jr2), rtol=1e-10)


def test_linreg_engine_converges_toward_optimum():
    res = TENG.run_fleet(_tiny(rounds=10, task=TTASK.LinearRegressionTask(),
                               lr=0.1), device="cpu")
    assert np.all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]
    assert res.accuracy[-1] > res.accuracy[0]      # R^2 rises


@pytest.mark.parametrize("kernel", ["fused", "reference"])
def test_linreg_streamed_batches_equal_cached_bitwise(kernel):
    """A client's batch is a pure function of (seed, client, state): the
    streamed run draws the cached run's bits, over cell chunks too."""
    cfg = _tiny(clients=6, cells=3, rounds=3, lr=0.1, kernel=kernel,
                task=TTASK.LinearRegressionTask(noise=0.1), cell_chunk=2)
    task = cfg.task
    gen = torch.Generator().manual_seed(3)
    state = task.build(gen, torch.float32, "cpu")
    whole = task.client_batch(state, 11, torch.arange(18))
    for idx in (torch.arange(5, 11), torch.tensor([17, 0, 4])):
        part = task.client_batch(state, 11, idx)
        for k in whole:
            assert torch.equal(part[k], whole[k][idx])
    runs = [TENG.run_fleet(dataclasses.replace(cfg, cache_data=c),
                           device="cpu") for c in (True, False)]
    np.testing.assert_array_equal(runs[0].losses, runs[1].losses)
    for a, b in zip(TPR.flatten(runs[0].params), TPR.flatten(runs[1].params)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The wireless model prices the task's model
# ---------------------------------------------------------------------------

def test_model_bits_reach_the_wireless_model():
    """A task with ``model_bits`` replaces the configured D_M (the
    transformer: every leaf's bits); linreg and the MLP keep Table I's."""
    tr = TTASK.TransformerTask()
    sim = TENG.build_simulation(_tiny(rounds=1, task=tr), device="cpu")
    bits = 32.0 * sum(leaf.numel() for leaf in TPR.flatten(sim.params))
    assert sim.cfg.wireless.model_bits == bits == tr.model_bits(sim.params)
    base = TENG.FleetConfig().wireless.model_bits
    for task in (TTASK.LinearRegressionTask(), None):
        sim = TENG.build_simulation(_tiny(rounds=1, task=task), device="cpu")
        assert sim.cfg.wireless.model_bits == base


# ---------------------------------------------------------------------------
# Cross-path equivalence: the host reference path against the fleet path
# ---------------------------------------------------------------------------

def test_run_any_fleet_path_matches_5ue_path():
    """run_any's two sides on one LinearRegressionTask, float64: the host
    solver's run_fleet_reference and the fleet engine at 1e-5."""
    cfg = TSYS.FLConfig(num_clients=5, rounds=6,
                        task=TTASK.LinearRegressionTask(), lr=0.05)
    host = TSYS.run_any(cfg, fleet_threshold=64, **F64)
    fleet = TSYS.run_any(cfg, fleet_threshold=0, **F64)
    assert host.mode == fleet.mode == "sync"
    for f in ("losses", "accuracy", "latencies", "mean_prune"):
        np.testing.assert_allclose(getattr(host, f), getattr(fleet, f),
                                   rtol=1e-5, atol=1e-8, err_msg=f)
    for a, b in zip(TPR.flatten(host.params), TPR.flatten(fleet.params)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


def test_run_fleet_reference_supports_partial_participation():
    cfg = _tiny(rounds=2, task=TTASK.LinearRegressionTask(),
                schedule=TSCHED.ScheduleConfig(participation="uniform",
                                               participants_per_cell=4))
    res = TSYS.run_fleet_reference(cfg, device="cpu")
    assert np.all(np.isfinite(res.losses))
    assert np.all(res.participants <= 4 * cfg.topology.num_cells)


def test_run_fleet_reference_partial_participation_and_deadline():
    """The host solver's mask and cap: both paths agree at 1e-5 (float64)
    with partial participation and a round deadline."""
    cfg = _tiny(cells=3, clients=5, rounds=4, lr=0.05,
                task=TTASK.LinearRegressionTask(),
                schedule=TSCHED.ScheduleConfig(participation="uniform",
                                               participants_per_cell=3,
                                               round_deadline_s=2.0))
    fleet = TENG.run_fleet(cfg, **F64)
    host = TSYS.run_fleet_reference(cfg, **F64)
    np.testing.assert_allclose(host.losses, fleet.losses, rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(host.mean_prune, fleet.mean_prune, rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(host.latencies, fleet.latencies, rtol=1e-5)


def test_run_fleet_reference_interference_fixed_point():
    """Interference on (hex reuse 1): the host fixed point reproduces the
    fleet path at 1e-5 (fp_rtol = 0 pins both to the same iterations)."""
    cfg = _tiny(cells=3, clients=5, rounds=3, lr=0.05,
                task=TTASK.LinearRegressionTask(),
                geometry=TTOPO.HexInterference(reuse=1),
                solver=TSOL.SolverConfig(fp_iters=4, fp_rtol=0.0))
    fleet = TENG.run_fleet(cfg, **F64)
    host = TSYS.run_fleet_reference(cfg, **F64)
    np.testing.assert_allclose(host.losses, fleet.losses, rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(host.mean_per, fleet.mean_per, rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(host.latencies, fleet.latencies, rtol=1e-5)


def test_run_fleet_reference_rejects_two_tier():
    with pytest.raises(NotImplementedError, match="two-tier"):
        TSYS.run_fleet_reference(_tiny(rounds=2, cloud_period=2,
                                       task=TTASK.LinearRegressionTask()),
                                 device="cpu")


# ---------------------------------------------------------------------------
# A linreg fleet against the JAX engine, from injected draws
# ---------------------------------------------------------------------------

LINREG_CASES = {
    "sync_fused": ("sync", {}, dict(kernel="fused")),
    "sync_reference_block": ("sync", {}, dict(kernel="reference",
                                              mask_kind="block")),
    "sync_uniform_cohort": ("sync", dict(participation="uniform",
                                         participants_per_cell=3),
                            dict(kernel="fused")),
    "async_fused": ("async", dict(straggler_prob=0.25),
                    dict(kernel="fused")),
}


def _linreg_configs(mode, schedule, extra):
    common = dict(rounds=4, lr=0.1, **extra)
    kw = dict(noise=0.05, local_batch=6)
    jcfg = JENG.FleetConfig(task=JTASK.LinearRegressionTask(**kw),
                            topology=JTOPO.FleetTopology(2, 6),
                            schedule=JSCHED.ScheduleConfig(**schedule),
                            **common)
    tcfg = TENG.FleetConfig(task=TTASK.LinearRegressionTask(**kw),
                            topology=TTOPO.FleetTopology(2, 6),
                            schedule=TSCHED.ScheduleConfig(**schedule),
                            **common)
    if mode == "async":
        akw = dict(buffer_size=6, max_staleness=3)
        jcfg = dataclasses.replace(jcfg,
                                   async_config=JSCHED.AsyncConfig(**akw))
        tcfg = dataclasses.replace(tcfg,
                                   async_config=TSCHED.AsyncConfig(**akw))
    return jcfg, tcfg


@pytest.mark.parametrize("case", sorted(LINREG_CASES))
def test_linreg_fleet_matches_reference(case):
    mode, schedule, extra = LINREG_CASES[case]
    jcfg, tcfg = _linreg_configs(mode, schedule, extra)
    ref = _reference(jcfg, mode=mode)
    assert ref["data"] is not None        # linreg batches are cached
    sim = _port(tcfg, ref, mode=mode)
    res = sim.finalize(*sim.simulate(sim.params))
    jr = ref["result"]
    for f in ("losses", "accuracy", "latencies", "deadlines", "mean_prune",
              "mean_per", "bandwidth_util", "wall_clock"):
        np.testing.assert_allclose(getattr(res, f), getattr(jr, f),
                                   rtol=RTOL, atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(res.participants, jr.participants)
    for a, b in zip(TPR.flatten(res.params), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=1e-10)
    assert res.accuracy[-1] > res.accuracy[0]
