"""The block-sparse linear's ``"gather"`` and ``"cond"`` impls, and the
serving model against the port's own dense decode.

Twins of ``tests/test_serve.py``'s linear tests for the two impls: numpy
inputs from a seed through the reference's ``make_linear`` /
``apply_linear`` and the port's at 1e-5 (both compute in float32), and
against the port's masked dense oracle at the reference's 2e-5, at every
rho with ragged tile edges; all pruned and all dense; bias and leading
dims; gradients against the dense impl's and ``jax.grad``'s.  The gather
plan (kept tiles sorted stably by output column) equals the reference's.
Then ``SparseModel`` with ``"gather"``, ``"cond"`` and ``"kernel"``
against the port's ``decode_step`` on ``bundle.masked_params()`` at 1e-4
(a tiny llama, and granite-3-2b's and qwen2-7b's smoke widths), and
``"gather"`` against the reference's ``SparseModel``.  A ``gpu`` test
holds ``"gather"`` on the card against ``"kernel"`` and across reruns.
"""

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.configs import base as TCB
from repro_torch.configs import get_config as t_get_config
from repro_torch.fleet.task import TransformerTask as TTask
from repro_torch.models import model as TM
from repro_torch.serve import SparseModel as TSparse
from repro_torch.serve import make_bundle as t_make_bundle
from repro_torch.serve import sparse as TS

try:  # the card's machine has no JAX: only the gpu test runs there
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ArchConfig, BlockSpec, StageSpec
    from repro.fleet.task import TransformerTask as JTask
    from repro.serve import SparseModel as JSparse
    from repro.serve import make_bundle as j_make_bundle
    from repro.serve import sparse as JS
except ImportError:
    JS = None
needs_jax = pytest.mark.skipif(JS is None, reason="needs the JAX reference")

HOST_IMPLS = ("gather", "cond")
REF_TOL = dict(rtol=1e-5, atol=1e-5)
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(name="tiny-serve", family="dense", source="test", d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64)


def _ragged_case(rho, seed=3):
    """w (50, 70) on (16, 32) tiles (both edges ragged), x (5, 50) and a
    keep dropping about ``rho`` of the tiles."""
    rng = np.random.default_rng(seed)
    kdim, n, bk, bn = 50, 70, 16, 32
    tk, tn = -(-kdim // bk), -(-n // bn)
    w = rng.normal(size=(kdim, n)).astype(np.float32)
    x = rng.normal(size=(5, kdim)).astype(np.float32)
    keep = (rng.uniform(size=(tk, tn)) >= rho).astype(np.float32)
    return w, x, keep, (bk, bn)


def _t_linear(w, keep, blocks, impl, bias=None):
    return TS.make_linear(torch.as_tensor(w), torch.as_tensor(keep), blocks,
                          impl=impl,
                          bias=None if bias is None else torch.as_tensor(bias))


@needs_jax
@pytest.mark.parametrize("impl", HOST_IMPLS)
@pytest.mark.parametrize("rho", [0.0, 0.5, 0.9, 1.0])
def test_linear_impls_match_reference_and_oracle(impl, rho):
    w, x, keep, blocks = _ragged_case(rho)
    plan, arrays = _t_linear(w, keep, blocks, impl)
    got = TS.apply_linear(plan, arrays, torch.as_tensor(x))
    jplan, jarrays = JS.make_linear(jnp.asarray(w), keep, blocks, impl=impl)
    want = JS.apply_linear(jplan, jarrays, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF_TOL)
    dplan, darrays = _t_linear(w, keep, blocks, "dense")
    np.testing.assert_allclose(
        got.numpy(), TS.apply_linear(dplan, darrays,
                                     torch.as_tensor(x)).numpy(),
        rtol=2e-5, atol=2e-5)


@needs_jax
@pytest.mark.parametrize("rho", [0.0, 0.5, 0.9])
def test_gather_plan_matches_reference(rho):
    w, _, keep, blocks = _ragged_case(rho, seed=7)
    plan, arrays = _t_linear(w, keep, blocks, "gather")
    jplan, jarrays = JS.make_linear(jnp.asarray(w), keep, blocks,
                                    impl="gather")
    t = plan["t"]
    assert t == jplan["t"]
    if t:
        np.testing.assert_array_equal(arrays["kk"].numpy(), jplan["kk"])
        np.testing.assert_array_equal(arrays["wt"].numpy(),
                                      np.asarray(jarrays["wt"]))
        # each output column lists its tiles in stack order, padded with T:
        # read back, the lists give the reference's column of each tile
        cols = arrays["cols"].numpy()
        nn = np.full(t, -1)
        for j in range(plan["tn"]):
            mine = cols[j][cols[j] < t]
            np.testing.assert_array_equal(mine, np.arange(mine.size)
                                          + (nn >= 0).sum())
            nn[mine] = j
        np.testing.assert_array_equal(nn, jplan["nn"])


@pytest.mark.parametrize("impl", HOST_IMPLS)
def test_linear_all_pruned_and_all_dense(impl):
    w = torch.ones((32, 48))
    x = torch.ones((3, 32))
    plan, arrays = TS.make_linear(w, torch.zeros((2, 3)), (16, 16), impl=impl)
    assert torch.equal(TS.apply_linear(plan, arrays, x), torch.zeros(3, 48))
    plan, arrays = TS.make_linear(w, torch.ones((2, 3)), (16, 16), impl=impl)
    torch.testing.assert_close(TS.apply_linear(plan, arrays, x),
                               torch.full((3, 48), 32.0), rtol=1e-6, atol=0)


@needs_jax
@pytest.mark.parametrize("impl", HOST_IMPLS)
def test_linear_bias_and_lead_dims(impl):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    keep = np.array([[1, 0, 1], [1, 1, 0]], np.float32)
    plan, arrays = _t_linear(w, keep, (16, 16), impl, bias=b)
    got = TS.apply_linear(plan, arrays, torch.as_tensor(x))
    assert got.shape == (2, 3, 48)
    jplan, jarrays = JS.make_linear(jnp.asarray(w), keep, (16, 16),
                                    impl=impl, bias=jnp.asarray(b))
    want = JS.apply_linear(jplan, jarrays, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF_TOL)


@needs_jax
@pytest.mark.parametrize("impl", HOST_IMPLS)
def test_linear_impls_differentiable(impl):
    """Gradients in x against the dense impl's (the reference's 2e-4 /
    2e-5) and against ``jax.grad`` of the reference's same impl (1e-5)."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(32, 32)).astype(np.float32)
    keep = (rng.uniform(size=(2, 2)) > 0.5).astype(np.float32)
    x = rng.normal(size=(4, 32)).astype(np.float32)

    def t_grad(impl_):
        plan, arrays = _t_linear(w, keep, (16, 16), impl_)
        return torch.func.grad(lambda xx: torch.sum(
            TS.apply_linear(plan, arrays, xx) ** 2))(torch.as_tensor(x))

    g = t_grad(impl)
    np.testing.assert_allclose(g.numpy(), t_grad("dense").numpy(), rtol=2e-4,
                               atol=2e-5)
    jplan, jarrays = JS.make_linear(jnp.asarray(w), keep, (16, 16), impl=impl)
    g_j = jax.grad(lambda xx: jnp.sum(JS.apply_linear(jplan, jarrays, xx)
                                      ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **REF_TOL)


def test_gather_reruns_bitwise_and_rejects_unknown_impls():
    w, x, keep, blocks = _ragged_case(0.5, seed=11)
    plan, arrays = _t_linear(w, keep, blocks, "gather")
    a = TS.apply_linear(plan, arrays, torch.as_tensor(x))
    assert torch.equal(a, TS.apply_linear(plan, arrays, torch.as_tensor(x)))
    assert TS.IMPLS == ("gather", "cond", "kernel", "dense")
    with pytest.raises(ValueError, match="impl must be one of"):
        _t_linear(w, keep, blocks, "pallas")


# ---------------------------------------------------------------------------
# SparseModel against the port's own dense decode
# ---------------------------------------------------------------------------

def _tiny():
    return TCB.ArchConfig(**TINY, stages=(
        TCB.StageSpec(2, (TCB.BlockSpec("attn", "mlp"),)),))


ARCHS = {"tiny": _tiny,
         "granite-3-2b": lambda: t_get_config("granite-3-2b").smoke_variant(),
         "qwen2-7b": lambda: t_get_config("qwen2-7b").smoke_variant()}


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("impl", ["gather", "cond", "kernel"])
@pytest.mark.parametrize("rho", [0.0, 0.75, 1.0])
def test_sparse_model_matches_dense_decode_on_masked_params(arch, impl, rho):
    cfg = ARCHS[arch]()
    task = TTask(arch=cfg, target_tiles=4)
    params = task.init_params(torch.Generator().manual_seed(0))
    if cfg.qkv_bias:  # the init's biases are 0: give them values
        g = torch.Generator().manual_seed(1)
        for n in ("wq", "wk", "wv"):
            b = params["stages"][0]["b0"]["attn"][n]["b"]
            b.copy_(torch.randn(b.shape, generator=g))
    bundle = t_make_bundle(task, params, rho)
    masked = bundle.masked_params()
    model = TSparse(cfg, bundle, impl=impl, device="cpu")
    b, t = 3, 6
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, t)))
    cache = TM.init_cache(cfg, b, 16, device="cpu")
    caches = model.init_caches(b, 16)
    for i in range(t):
        ld, cache = TM.decode_step(cfg, masked, toks[:, i:i + 1], cache)
        ls, caches = model.decode_step(model.arrays, toks[:, i:i + 1],
                                       caches, torch.full((b,), i))
        np.testing.assert_allclose(ls.numpy(), ld.numpy(), **SERVE_TOL)


@needs_jax
@pytest.mark.parametrize("rho", [0.0, 0.75])
def test_sparse_model_gather_matches_reference(rho):
    arch = ArchConfig(**TINY, stages=(StageSpec(2, (BlockSpec("attn",
                                                              "mlp"),)),))
    task = JTask(arch=arch, target_tiles=4)
    jb = j_make_bundle(task, task.init_params(jax.random.PRNGKey(0)), rho)
    jm = JSparse(arch, jb, impl="gather", attn_impl="xla")
    tm = TSparse(_tiny(), weights.bundle_from_numpy(jb, device="cpu"),
                 impl="gather", device="cpu")
    toks = np.random.default_rng(2).integers(0, 64, (2, 4))
    jc, tc = jm.init_caches(2, 8), tm.init_caches(2, 8)
    for i in range(4):
        lj, jc = jm.decode_step(jm.arrays, jnp.asarray(toks[:, i:i + 1]), jc,
                                jnp.full((2,), i, jnp.int32))
        lt, tc = tm.decode_step(tm.arrays, torch.as_tensor(toks[:, i:i + 1]),
                                tc, torch.full((2,), i))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **SERVE_TOL)


@needs_jax
@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_sparse_model_qkv_bias_matches_reference(impl):
    """qwen2-7b's smoke width (qkv bias, untied unembedding) with nonzero
    biases at rho = 0: no tile is dropped, so the port's bias masking is
    the identity and its SparseModel agrees with the reference's (which
    serves biases unmasked) over 4 decode steps."""
    jarch = j_get_config("qwen2-7b").smoke_variant()
    task = JTask(arch=jarch, target_tiles=4)
    params = jax.tree.map(np.asarray, task.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    attn = params["stages"][0]["b0"]["attn"]
    for n in ("wq", "wk", "wv"):
        attn[n]["b"] = rng.normal(size=attn[n]["b"].shape).astype(np.float32)
    jb = j_make_bundle(task, jax.tree.map(jnp.asarray, params), 0.0)
    jm = JSparse(jarch, jb, impl="dense", attn_impl="xla")
    tm = TSparse(t_get_config("qwen2-7b").smoke_variant(),
                 weights.bundle_from_numpy(jb, device="cpu"), impl=impl,
                 device="cpu")
    assert "b" in tm.arrays["layers"][0]["wq"]
    toks = np.random.default_rng(6).integers(0, jarch.vocab_size, (2, 4))
    jc, tc = jm.init_caches(2, 8), tm.init_caches(2, 8)
    for i in range(4):
        lj, jc = jm.decode_step(jm.arrays, jnp.asarray(toks[:, i:i + 1]), jc,
                                jnp.full((2,), i, jnp.int32))
        lt, tc = tm.decode_step(tm.arrays, torch.as_tensor(toks[:, i:i + 1]),
                                tc, torch.full((2,), i))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **SERVE_TOL)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_gather_card_matches_kernel_on_gpu():
    """One bundle on the card served by ``"gather"`` and by ``"kernel"``:
    decode logits within 1e-4 over 6 steps, gather rerun bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = t_get_config("qwen2-7b").smoke_variant()
    task = TTask(arch=cfg, target_tiles=4)
    params = task.init_params(torch.Generator(device="cuda").manual_seed(0))
    bundle = t_make_bundle(task, params, 0.5)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 6)), device="cuda")
    out = {}
    for impl in ("gather", "kernel", "gather"):
        model = TSparse(cfg, bundle, impl=impl)
        caches = model.init_caches(4, 8)
        steps = []
        for i in range(6):
            lg, caches = model.decode_step(model.arrays, toks[:, i:i + 1],
                                           caches,
                                           torch.full((4,), i, device="cuda"))
            steps.append(lg)
        run = torch.stack(steps, 1)
        if impl in out:
            assert torch.equal(run, out[impl])
        out[impl] = run
    np.testing.assert_allclose(out["gather"].cpu().numpy(),
                               out["kernel"].cpu().numpy(), **SERVE_TOL)
