"""The transformer's training half: the port against the JAX package.

Numpy inputs from a seed go through the reference's function and the
port's on the CPU: ``TokenStream`` (bitwise), the layers (``dense``,
``embed``, ``unembed``, ``mlp``), attention (``attend``,
``causal_window_mask``, ``flash_attention`` with GQA, windows and ragged
chunks, ``gqa_forward`` on both of its branches), ``apply_block``,
``forward``, ``loss_fn`` (its mask path, and its chunked branch with the
threshold patched low on both sides) and its gradient against
``jax.grad``.  The model computes in float32 on both sides (the smoke
config's compute dtype), so these hold at 1e-5.

Then ``TransformerTask`` in the fleet engine: the generic fused path
against the reference kernel with block masks (float64 weights, 1e-5),
async events, the task's model size in the wireless model, Dirichlet
pool draws, a whole fleet run against the JAX engine from injected draws
(IID, and Dirichlet with the reference's client batches injected), and
``export_from_result`` against the reference's bundle.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.data import tokens as JTOK
from repro.fleet import engine as JENG
from repro.fleet import task as JTASK
from repro.fleet import topology as JTOPO
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import export_from_result as j_export_from_result
from repro_torch import weights
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import pruning as TPR
from repro_torch.data import tokens as TTOK
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import scheduler as TSCHED
from repro_torch.fleet import task as TTASK
from repro_torch.fleet import topology as TTOPO
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import export_from_result as t_export_from_result
from repro_torch.serve import load_pruned as t_load

from test_torch_engine import _draws, population_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
RTOL = 1e-5


def _t(a, dtype=torch.float32):
    return weights.tensor(a, dtype, "cpu")


def _j_cfg():
    cfg = j_get_config("smollm-135m").smoke_variant()
    return cfg.replace(vocab_size=min(cfg.vocab_size, 256))


def _t_cfg():
    cfg = t_get_config("smollm-135m").smoke_variant()
    return cfg.replace(vocab_size=min(cfg.vocab_size, 256))


@pytest.fixture(scope="module")
def model_pair():
    """The default TransformerTask's model (smollm-135m's smoke reduction,
    vocab 256): the reference's params as numpy, and the port's copy."""
    params = jax.tree.map(np.asarray,
                          JM.init_params(_j_cfg(), jax.random.PRNGKey(0)))
    return params, weights.tree_from_numpy(params, torch.float32, "cpu")


def _tokens(b=2, s=16, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


# ---------------------------------------------------------------------------
# Configs and token streams
# ---------------------------------------------------------------------------

def test_smoke_variant_and_attn_spec_match_reference():
    j, t = _j_cfg(), _t_cfg()
    for f in ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "param_dtype", "compute_dtype", "local_window",
              "long_context_window"):
        assert getattr(t, f) == getattr(j, f), f
    assert [(s.repeats, [(b.kind, b.ffn) for b in s.blocks])
            for s in t.stages] == [(s.repeats, [(b.kind, b.ffn)
                                                for b in s.blocks])
                                   for s in j.stages]
    for kind, over in (("attn", None), ("attn", 64), ("local_attn", None)):
        ja, ta = j.attn_spec(kind, over), t.attn_spec(kind, over)
        assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
        assert ta.scale == ja.scale
    assert t.replace(param_dtype="bfloat16").cdtype == torch.float32
    # cross attention: non-causal, unwindowed, no RoPE
    assert dataclasses.asdict(t.attn_spec("cross_attn")) == \
        dataclasses.asdict(j.attn_spec("cross_attn"))


@pytest.mark.parametrize("vocab,seed", [(256, 0), (49152, 7), (97, 12345)])
def test_token_stream_bitwise(vocab, seed):
    j, t = JTOK.TokenStream(vocab, seed=seed), TTOK.TokenStream(vocab,
                                                                seed=seed)
    np.testing.assert_array_equal(t.succ, j.succ)
    for shape in ((8, 16), (3, 5)):
        a, b = t.sample(*shape), j.sample(*shape)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TTOK.batches(vocab, 4, 6, 3, seed),
                    JTOK.batches(vocab, 4, 6, 3, seed)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
def test_dense_matches_reference(bias):
    rng = np.random.default_rng(1)
    p = {"w": rng.normal(size=(12, 7)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(size=7).astype(np.float32)
    x = rng.normal(size=(2, 3, 12)).astype(np.float32)
    got = TL.dense(weights.tree_from_numpy(p, device="cpu"), _t(x))
    want = JL.dense(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_and_unembed_match_reference():
    rng = np.random.default_rng(2)
    p = {"embedding": rng.normal(size=(40, 8)).astype(np.float32)}
    toks = rng.integers(0, 40, (3, 5))
    tp = weights.tree_from_numpy(p, device="cpu")
    got = TL.embed(tp, _t(toks), torch.float32)
    want = JL.embed(jax.tree.map(jnp.asarray, p), jnp.asarray(toks),
                    jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    got = TL.unembed(tp, _t(x))
    want = JL.unembed(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("relu", True)])
def test_mlp_matches_reference(act, gated):
    params = jax.tree.map(np.asarray, JL.init_mlp(
        jax.random.PRNGKey(3), 16, 24, jnp.float32, gated=gated))
    x = np.random.default_rng(3).normal(size=(2, 4, 16)).astype(np.float32)
    got = TL.mlp(weights.tree_from_numpy(params, device="cpu"), _t(x), act)
    want = JL.mlp(jax.tree.map(jnp.asarray, params), jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _qkv(b, s, h, hkv, hd, vd=None, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, vd or hd)).astype(np.float32))


@pytest.mark.parametrize("s,t,offset,window", [(5, 5, 0, None), (4, 9, 5, 3),
                                               (6, 6, 0, 2)])
def test_causal_window_mask_matches_reference(s, t, offset, window):
    np.testing.assert_array_equal(
        TA.causal_window_mask(s, t, offset, window).numpy(),
        np.asarray(JA.causal_window_mask(s, t, offset, window)))


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("masked", [False, True])
def test_attend_matches_reference(h, hkv, masked):
    q, k, v = _qkv(2, 12, h, hkv, 8, seed=h + hkv)
    mask = JA.causal_window_mask(12, 12, 0, 5) if masked else None
    want = JA.attend(*map(jnp.asarray, (q, k, v)), mask, 8 ** -0.5)
    got = TA.attend(_t(q), _t(k), _t(v),
                    None if mask is None else torch.tensor(
                        np.asarray(mask)), 8 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("h,hkv,window", [(4, 4, None), (8, 2, None),
                                          (8, 1, None), (4, 2, 32),
                                          (4, 2, 128)])
def test_flash_matches_reference_and_attend(h, hkv, window):
    """GQA and windowed cases of the reference's flash tests: the port's
    flash against the reference's flash and against its own attend."""
    b, s, hd = 2, 256, 32
    q, k, v = _qkv(b, s, h, hkv, hd, seed=h * 10 + hkv)
    scale = hd ** -0.5
    want = JA.flash_attention(*map(jnp.asarray, (q, k, v)), scale,
                              causal=True, window=window, q_chunk=64,
                              kv_chunk=64)
    got = TA.flash_attention(_t(q), _t(k), _t(v), scale, causal=True,
                             window=window, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = TA.attend(_t(q), _t(k), _t(v),
                      TA.causal_window_mask(s, s, 0, window), scale)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("q_chunk,kv_chunk", [(64, 64), (32, 40), (7, 5)])
def test_flash_ragged_chunks(q_chunk, kv_chunk):
    """Chunk sizes that do not divide S: the query chunk halves until it
    does, the keys pad to a chunk multiple (masked); asymmetric v dims."""
    b, s, h, hd = 1, 96, 2, 16
    q, k, v = _qkv(b, s, h, h, hd, vd=12, seed=3)
    scale = hd ** -0.5
    want = JA.flash_attention(*map(jnp.asarray, (q, k, v)), scale,
                              causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    got = TA.flash_attention(_t(q), _t(k), _t(v), scale, causal=True,
                             q_chunk=q_chunk, kv_chunk=kv_chunk)
    assert got.shape == (b, s, h, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = TA.attend(_t(q), _t(k), _t(v), TA.causal_window_mask(s, s, 0,
                                                                 None), scale)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_flash_is_differentiable_like_attend():
    q, k, v = (_t(a).requires_grad_() for a in _qkv(1, 24, 4, 2, 8, seed=5))
    mask = TA.causal_window_mask(24, 24, 0, 6)
    g1 = torch.autograd.grad(TA.flash_attention(q, k, v, 0.3, window=6,
                                                q_chunk=8, kv_chunk=8).sum(),
                             (q, k, v))
    g2 = torch.autograd.grad(TA.attend(q, k, v, mask, 0.3).sum(), (q, k, v))
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("threshold", [None, 8])
@pytest.mark.parametrize("window,qkv_bias", [(None, False), (6, True)])
def test_gqa_forward_matches_reference(monkeypatch, threshold, window,
                                       qkv_bias):
    """Both branches of gqa_forward (dense, and flash at or above
    FLASH_THRESHOLD, patched low on both sides)."""
    if threshold is not None:
        monkeypatch.setattr(JA, "FLASH_THRESHOLD", threshold)
        monkeypatch.setattr(TA, "FLASH_THRESHOLD", threshold)
    jspec = JA.AttnSpec(num_heads=4, num_kv_heads=2, head_dim=8,
                        qkv_bias=qkv_bias, window=window)
    tspec = TTASK.TransformerTask().config().attn_spec("attn").__class__(
        **dataclasses.asdict(jspec))
    p = jax.tree.map(np.asarray, JA.init_gqa(jax.random.PRNGKey(4), 24,
                                             jspec, jnp.float32))
    if qkv_bias:
        p["wq"]["b"] = np.random.default_rng(4).normal(size=32).astype(
            np.float32)
    x = np.random.default_rng(5).normal(size=(2, 16, 24)).astype(np.float32)
    want = JA.gqa_forward(jax.tree.map(jnp.asarray, p), jspec,
                          jnp.asarray(x))
    got = TA.gqa_forward(weights.tree_from_numpy(p, device="cpu"), tspec,
                         _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # keys and values from another source are no longer refused (their
    # parity: tests/test_torch_mla_cross.py)
    cross = TA.gqa_forward(weights.tree_from_numpy(p, device="cpu"), tspec,
                           _t(x), kv_x=_t(x))
    assert cross.shape == got.shape and bool(torch.isfinite(cross).all())


# ---------------------------------------------------------------------------
# Blocks, forward, loss and gradients
# ---------------------------------------------------------------------------

def test_apply_block_matches_reference(model_pair):
    jp, tp = model_pair
    jcfg, tcfg = _j_cfg(), _t_cfg()
    x = np.random.default_rng(6).normal(size=(2, 16, 128)).astype(np.float32)
    block_j = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["stages"][0]["b0"])
    block_t = TPR.tree_map(lambda a: a[0], tp["stages"][0]["b0"])
    spec = tcfg.stages[0].blocks[0]
    want, aux_j = JB.apply_block(jcfg, jcfg.stages[0].blocks[0], block_j,
                                 jnp.asarray(x), None, None)
    got, aux_t = TB.apply_block(tcfg, spec, block_t, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux_t) == float(aux_j) == 0.0
    # a kind the reference does not define raises, as the reference's does
    bad = dataclasses.replace(spec, kind="conv")
    for fn in (lambda: TB.apply_block(tcfg, bad, block_t, _t(x)),
               lambda: TB.init_block(tcfg, bad, None),
               lambda: TB.init_block_cache(tcfg, bad, 1, 4, None, "cpu")):
        with pytest.raises(ValueError, match="unknown block kind"):
            fn()
    with pytest.raises(ValueError):
        JB.apply_block(jcfg, bad, block_j, jnp.asarray(x), None, None)


def test_forward_and_param_count_match_reference(model_pair):
    jp, tp = model_pair
    toks = _tokens()
    want, _ = JM.forward(_j_cfg(), jax.tree.map(jnp.asarray, jp),
                         jnp.asarray(toks))
    got, aux = TM.forward(_t_cfg(), tp, _t(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert TM.param_count(tp) == JM.param_count(jp)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_fn_matches_reference(model_pair, masked):
    jp, tp = model_pair
    toks = _tokens(3, 12, seed=1)
    batch = {"tokens": toks}
    if masked:
        batch["mask"] = np.random.default_rng(2).uniform(size=(3, 12)) < 0.6
    jt, jaux = JM.loss_fn(_j_cfg(), jax.tree.map(jnp.asarray, jp),
                          jax.tree.map(jnp.asarray, batch))
    tt, taux = TM.loss_fn(_t_cfg(), tp, {k: torch.as_tensor(v) for k, v in
                                         batch.items()})
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-6)


def test_chunked_loss_matches_reference(model_pair, monkeypatch):
    """The streamed cross-entropy branch (threshold patched low on both
    sides, chunks of 4 of the 15 shifted positions: the reference halves
    them to 1, the port keeps 4, 4, 4 and 3), and _chunked_nll directly
    at several chunk sizes."""
    jp, tp = model_pair
    jcfg, tcfg = _j_cfg(), _t_cfg()
    toks = _tokens(2, 16, seed=3)
    dense = float(TM.loss_fn(tcfg, tp, {"tokens": _t(toks)})[0])
    for mod in (JM, TM):
        monkeypatch.setattr(mod, "_CHUNKED_LOSS_ELEMS", 100)
        monkeypatch.setattr(mod, "_LOSS_CHUNK", 4)
    jt, _ = JM.loss_fn(jcfg, jax.tree.map(jnp.asarray, jp),
                       {"tokens": jnp.asarray(toks)})
    tt, _ = TM.loss_fn(tcfg, tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    np.testing.assert_allclose(float(tt), dense, rtol=1e-6)
    x = np.random.default_rng(4).normal(size=(2, 16, 128)).astype(np.float32)
    tgt = _tokens(2, 16, seed=4)
    for chunk in (16, 4, 6):
        want = JM._chunked_nll(jcfg, jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(x), jnp.asarray(tgt), chunk)
        got = TM._chunked_nll(tcfg, tp, _t(x), _t(tgt), chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_loss_gradient_matches_jax_grad(model_pair):
    jp, tp = model_pair
    toks = _tokens(2, 16, seed=5)
    jg = jax.grad(lambda p: JM.loss_fn(_j_cfg(), p, {
        "tokens": jnp.asarray(toks)})[0])(jax.tree.map(jnp.asarray, jp))
    tg = torch.func.grad(lambda p: TM.loss_fn(_t_cfg(), p, {
        "tokens": _t(toks)})[0])(tp)
    for a, b in zip(TPR.flatten(tg), jax.tree.leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


# ---------------------------------------------------------------------------
# TransformerTask in the fleet engine
# ---------------------------------------------------------------------------

def _tiny(clients=6, cells=1, **kw):
    return TENG.FleetConfig(
        topology=TTOPO.FleetTopology(num_cells=cells,
                                     clients_per_cell=clients), **kw)


def test_task_fields_and_defaults_match_reference():
    j, t = JTASK.TransformerTask(), TTASK.TransformerTask()
    for f in ("arch_name", "seq_len", "local_batch", "eval_batch",
              "pool_clients", "block", "target_tiles", "dirichlet_alpha",
              "name"):
        assert getattr(t, f) == getattr(j, f), f
    assert not t.cache_batches
    assert TTASK.TransformerTask(dirichlet_alpha=0.3).cache_batches
    params = t.init_params(torch.Generator().manual_seed(0))
    assert {leaf.dtype for leaf in TPR.flatten(params)} == {torch.float32}
    grid = t.tile_grid(params)
    assert len({g for g in grid if g is not None}) >= 2
    assert TTASK.TransformerTask(block=16).tile_grid(params) == 16


def test_fused_matches_reference_kernel_with_block_masks():
    """The generic fused path (tile ranking once a round, blocked scan)
    equals the reference kernel with block masks (per-client masks, vmap)
    at 1e-5 in a float64 run (the model computes in float32)."""
    kw = dict(rounds=4, task=TTASK.TransformerTask(), lr=0.5)
    ref = TENG.run_fleet(_tiny(kernel="reference", mask_kind="block", **kw),
                         device="cpu", dtype=torch.float64)
    fused = TENG.run_fleet(_tiny(kernel="fused", **kw), device="cpu",
                           dtype=torch.float64)
    for f in ("losses", "accuracy", "mean_prune"):
        np.testing.assert_allclose(getattr(fused, f), getattr(ref, f),
                                   rtol=1e-5, atol=1e-8, err_msg=f)
    for a, b in zip(TPR.flatten(fused.params), TPR.flatten(ref.params)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    assert np.all(np.isfinite(fused.losses))
    assert fused.losses[-1] < fused.losses[0]


def test_async_runs():
    res = TENG.run_fleet(_tiny(rounds=3, task=TTASK.TransformerTask(),
                               lr=0.5, kernel="fused",
                               async_config=TSCHED.AsyncConfig(
                                   buffer_size=3, max_staleness=4)),
                         mode="async", device="cpu")
    assert np.all(np.isfinite(res.losses))
    assert res.mode == "async"


def test_model_bits_override_reaches_wireless():
    """The task's physical size replaces Table I's model_bits (the JAX
    engine does the same); the MLP default keeps the constant."""
    cfg = _tiny(rounds=1, task=TTASK.TransformerTask())
    sim = TENG.build_simulation(cfg, device="cpu")
    mb = sim.task.model_bits(sim.params)
    assert mb == 32.0 * TM.param_count(sim.params) > 0
    assert sim.cfg.wireless.model_bits == mb
    jcfg2, jtask, _, jparams, *_ = JENG._build_common(JENG.FleetConfig(
        topology=JTOPO.FleetTopology(1, 6), task=JTASK.TransformerTask()))
    assert jcfg2.wireless.model_bits == mb
    plain = TENG.build_simulation(_tiny(rounds=1), device="cpu")
    assert plain.cfg.wireless.model_bits == cfg.wireless.model_bits


def test_dirichlet_token_pool_skew():
    """Fixed local datasets (the same draw each time), clients differ,
    rows concentrate under a small alpha, any subset draws the same
    bits; a Dirichlet fleet runs with cached and streamed data alike."""
    task = TTASK.TransformerTask(dirichlet_alpha=0.05, local_batch=4)
    gen = torch.Generator().manual_seed(0)
    state = task.build(gen, torch.float32, "cpu", num_clients=12)
    assert state["row_cdf"].shape == (12, task.pool_clients)
    all_ = task.client_batch(state, 9, torch.arange(12))["tokens"]
    assert all_.shape == (12, 4, task.seq_len)
    again = task.client_batch(state, 9, torch.tensor([3, 0]))["tokens"]
    assert torch.equal(again, all_[[3, 0]])
    assert not torch.equal(all_[0], all_[1])
    pool = state["pool"].reshape(-1, task.seq_len)
    rows = [{int(torch.nonzero((pool == r).all(-1))[0])
             // task.local_batch for r in all_[c]} for c in range(12)]
    assert np.mean([len(r) for r in rows]) < 3.0      # a few sources each
    assert task.cache_batches and not TTASK.TransformerTask().cache_batches
    cfg = _tiny(rounds=2, task=task, kernel="fused", lr=0.5)
    runs = [TENG.run_fleet(dataclasses.replace(cfg, cache_data=c),
                           device="cpu") for c in (True, False)]
    np.testing.assert_array_equal(runs[0].losses, runs[1].losses)


def _reference_run(jcfg):
    """The JAX engine's run under x64 and what the port needs to repeat
    it: population, round draws, params, task state, cached batches."""
    with jax.enable_x64(True):
        cfg2, task, state, params, pop, k_data, keys = \
            JENG._build_common(jcfg)
        _, data = JENG._make_batch_fn(task, state, cfg2, k_data)
        sim = JENG.build_simulation(jcfg)
        result = sim.finalize(*sim.simulate(sim.params, sim.round_keys))
        draws = [_draws(k, pop, False) for k in keys[:jcfg.rounds]]
        to_np = lambda t: jax.tree.map(np.asarray, t)
        return dict(result=result, draws=draws, pop=population_numpy(pop),
                    params=to_np(params), state=to_np(state),
                    data=to_np(data))


def _port_run(tcfg, ref):
    dt = torch.float64
    draws = TENG.InjectedDraws(
        weights.population_from_numpy(ref["pop"], dt, "cpu"),
        [weights.round_draws_from_numpy(*d[:5], dtype=dt, device="cpu")
         for d in ref["draws"]])
    start = weights.start_from_numpy(ref["params"], ref["state"],
                                     ref["data"], dtype=dt, device="cpu",
                                     params_dtype=torch.float32)
    sim = TENG.build_simulation(tcfg, device="cpu", dtype=dt, draws=draws,
                                start=start)
    return sim, sim.finalize(*sim.simulate(sim.params))


@pytest.mark.parametrize("kernel,alpha", [("fused", None),
                                          ("reference", None),
                                          ("fused", 0.3)])
def test_fleet_run_matches_reference(kernel, alpha):
    """A TransformerTask fleet (1 x 6 clients, 3 rounds) from the JAX
    engine's draws, params (float32) and task state (its token pool; for
    Dirichlet, its cached client batches) in a float64 run: losses,
    accuracy, latencies, rates and params at 1e-5, the wireless model
    pricing the same model."""
    kw = dict(rounds=3, lr=0.5, kernel=kernel, mask_kind="block")
    jcfg = JENG.FleetConfig(task=JTASK.TransformerTask(dirichlet_alpha=alpha),
                            topology=JTOPO.FleetTopology(1, 6), **kw)
    tcfg = _tiny(task=TTASK.TransformerTask(dirichlet_alpha=alpha), **kw)
    ref = _reference_run(jcfg)
    assert (ref["data"] is None) == (alpha is None)
    sim, res = _port_run(tcfg, ref)
    jr = ref["result"]
    assert sim.cfg.wireless.model_bits == 32.0 * TM.param_count(sim.params)
    for f in ("losses", "accuracy", "latencies", "deadlines", "mean_prune",
              "mean_per", "bandwidth_util"):
        np.testing.assert_allclose(getattr(res, f), getattr(jr, f),
                                   rtol=RTOL, atol=1e-8, err_msg=f)
    np.testing.assert_array_equal(res.participants, jr.participants)
    for a, b in zip(TPR.flatten(res.params), jax.tree.leaves(jr.params)):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=1e-7)


# ---------------------------------------------------------------------------
# The bridge to serving
# ---------------------------------------------------------------------------

def test_export_from_fleet_result(tmp_path):
    """A FleetResult-shaped record exports at its final mean rate (or the
    given one) with the reference's keeps, and loads back."""
    class FakeResult:
        pass

    task_j, task_t = JTASK.TransformerTask(), TTASK.TransformerTask()
    res = FakeResult()
    res.params = jax.tree.map(np.asarray,
                              task_j.init_params(jax.random.PRNGKey(0)))
    res.mean_prune = np.array([0.1, 0.3, 0.6])
    path = os.path.join(tmp_path, "fleet.npz")
    bundle = t_export_from_result(path, task_t, res, device="cpu")
    assert bundle.rho == pytest.approx(0.6)
    loaded = t_load(path, task_t, device="cpu")
    assert loaded.rho == pytest.approx(0.6)
    want = j_export_from_result(os.path.join(tmp_path, "ref.npz"), task_j,
                                res)
    for a, b in zip(loaded.keeps, want.keeps):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(TPR.flatten(loaded.params), TPR.flatten(res.params)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert t_export_from_result(path, task_t, res, rho=0.25,
                                device="cpu").rho == 0.25
