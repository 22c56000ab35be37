"""MLA and cross attention (``models/attention.py``): the port against the
JAX package.

Numpy inputs from a seed go through the reference's function and the
port's on the CPU.  Both sides compute the norms, RoPE and the attention
scores in float32 whatever the params' dtype, so a float64 run holds at
1e-6 and a float32 run at 1e-5.  MLA: ``mla_forward`` on its dense and
flash routes (the threshold patched low on both sides), with and without
a window; ``mla_decode`` (the absorbed form) on full, rolling, windowed
and overrun caches, its output and its latent cache writes.  Cross
attention: ``gqa_forward(kv_x=...)`` on both routes, ``cross_memory`` and
``cross_decode``.  Then the twins of ``tests/test_attention.py``'s
flash-against-dense tests for MLA and cross attention, at their own
5e-4, and the ragged-key flash case at 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as JA
from repro_torch import weights
from repro_torch.configs import base as TCB
from repro_torch.core import pruning as TPR
from repro_torch.models import attention as TA

F32 = dict(rtol=1e-5, atol=1e-5)
CAST = dict(rtol=1e-6, atol=1e-6)
FLASH_TOL = dict(rtol=5e-4, atol=5e-4)   # tests/test_attention.py's
D = 32
MLA = dict(num_heads=4, q_lora_rank=24, kv_lora_rank=16, nope_dim=8,
           rope_dim=8, v_head_dim=12)


def _t(a, dtype=torch.float32):
    return weights.tensor(a, dtype, "cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _mla_params(spec, seed, np_dt=np.float32):
    p = jax.tree.map(np.asarray, JA.init_mla(jax.random.PRNGKey(seed), D,
                                             spec, jnp.float32))
    rng = np.random.default_rng(seed)   # norm scales other than ones
    for n in ("q_norm", "kv_norm"):
        p[n]["scale"] = 1.0 + 0.3 * rng.normal(size=p[n]["scale"].shape)
    return jax.tree.map(lambda a: np.asarray(a, np_dt), p)


def _specs(**kw):
    return JA.MLASpec(**MLA, **kw), TCB.MLASpec(**MLA, **kw)


def test_mla_spec_and_init_match_reference():
    js, ts = _specs(window=6)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.scale == js.scale
    want = jax.tree_util.tree_leaves(jax.eval_shape(
        lambda k: JA.init_mla(k, D, js, jnp.bfloat16), jax.random.PRNGKey(0)))
    got = TPR.flatten(TA.init_mla(torch.Generator().manual_seed(0), D, ts,
                                  torch.bfloat16))
    assert [tuple(a.shape) for a in got] == [a.shape for a in want]
    assert all(a.dtype == torch.bfloat16 for a in got)


@pytest.mark.parametrize("threshold", [None, 8])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mla_forward_matches_reference(monkeypatch, threshold, window, dtype):
    """The dense route and the flash route (threshold 8 on both sides, so
    S = 16 goes through flash_attention)."""
    tol = F32 if dtype == torch.float32 else CAST
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    if threshold is not None:
        monkeypatch.setattr(JA, "FLASH_THRESHOLD", threshold)
        monkeypatch.setattr(TA, "FLASH_THRESHOLD", threshold)
    js, ts = _specs(window=window)
    p = _mla_params(js, 1, np_dt)
    x = np.random.default_rng(2).normal(size=(2, 16, D)).astype(np_dt)
    pos = np.stack([np.arange(16), np.arange(16) + 5])
    with jax.enable_x64(dtype == torch.float64):
        want = JA.mla_forward(_j(p), js, jnp.asarray(x))
        want_pos = JA.mla_forward(_j(p), js, jnp.asarray(x),
                                  jnp.asarray(pos, jnp.int32))
    tp = weights.tree_from_numpy(p, dtype, "cpu")
    got = TA.mla_forward(tp, ts, _t(x, dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    got = TA.mla_forward(tp, ts, _t(x, dtype), torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pos), **tol)


DECODE_CASES = [  # (what, window, cache_len, positions)
    ("full", None, 8, [0, 3, 7]),
    ("full, past its end", None, 6, [6, 9, 5]),
    ("rolling", 6, 6, [2, 6, 13]),
    ("windowed full cache", 4, 10, [1, 5, 9]),
]


@pytest.mark.parametrize("what,window,cache_len,positions", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mla_decode_matches_reference(what, window, cache_len, positions,
                                      dtype):
    """The absorbed decode against a random latent cache: the output and
    the written cache (one slot a row; the given cache untouched)."""
    tol = F32 if dtype == torch.float32 else CAST
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    js, ts = _specs(window=window)
    p = _mla_params(js, 3, np_dt)
    rng = np.random.default_rng(len(what) + cache_len)
    b = len(positions)
    cache = {"ckv": rng.normal(size=(b, cache_len, MLA["kv_lora_rank"])),
             "kpe": rng.normal(size=(b, cache_len, MLA["rope_dim"]))}
    cache = jax.tree.map(lambda a: a.astype(np_dt), cache)
    x = rng.normal(size=(b, 1, D)).astype(np_dt)
    pos = np.asarray(positions)
    with jax.enable_x64(dtype == torch.float64):
        y_j, c_j = JA.mla_decode(_j(p), js, jnp.asarray(x), _j(cache),
                                 jnp.asarray(pos, jnp.int32))
    tc = weights.tree_from_numpy(cache, dtype, "cpu")
    y_t, c_t = TA.mla_decode(weights.tree_from_numpy(p, dtype, "cpu"), ts,
                             _t(x, dtype), tc, torch.as_tensor(pos))
    assert y_t.dtype == dtype
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **tol)
    for n in ("ckv", "kpe"):
        np.testing.assert_allclose(c_t[n].numpy(), np.asarray(c_j[n]), **tol)
        assert int((c_t[n] != tc[n]).any(-1).sum()) == b
        np.testing.assert_array_equal(tc[n].numpy(), cache[n])


def test_mla_decode_sequence_matches_forward():
    """Teacher-forced absorbed decode from an empty cache reproduces the
    expanded forward (two float orders: 1e-5 in float32)."""
    js, ts = _specs()
    tp = weights.tree_from_numpy(_mla_params(js, 4), device="cpu")
    x = _t(np.random.default_rng(5).normal(size=(2, 10, D)))
    cache = TA.init_mla_cache(ts, 2, 10, torch.float32, "cpu")
    steps = []
    for t in range(10):
        y, cache = TA.mla_decode(tp, ts, x[:, t:t + 1], cache,
                                 torch.full((2,), t))
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                               TA.mla_forward(tp, ts, x).numpy(), **F32)


# ---------------------------------------------------------------------------
# Cross attention
# ---------------------------------------------------------------------------

def _cross(h=4, hkv=2, hd=8, bias=False, seed=6, np_dt=np.float32):
    spec = dict(num_heads=h, num_kv_heads=hkv, head_dim=hd, qkv_bias=bias,
                causal=False, use_rope=False)
    js, ts = JA.AttnSpec(**spec), TCB.AttnSpec(**spec)
    p = jax.tree.map(np.asarray, JA.init_gqa(jax.random.PRNGKey(seed), D, js,
                                             jnp.float32))
    if bias:
        rng = np.random.default_rng(seed)
        for n in ("wq", "wk", "wv"):
            p[n]["b"] = rng.normal(size=p[n]["w"].shape[1])
    return js, ts, jax.tree.map(lambda a: np.asarray(a, np_dt), p)


@pytest.mark.parametrize("threshold", [None, 16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gqa_forward_cross_matches_reference(monkeypatch, threshold, bias,
                                             dtype):
    """S = 12 queries against T = 30 memory rows: dense, and through flash
    with the threshold at 16 on both sides (12 * 30 >= 16^2; a ragged key
    chunk)."""
    tol = F32 if dtype == torch.float32 else CAST
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    if threshold is not None:
        monkeypatch.setattr(JA, "FLASH_THRESHOLD", threshold)
        monkeypatch.setattr(TA, "FLASH_THRESHOLD", threshold)
    js, ts, p = _cross(bias=bias, np_dt=np_dt)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, D)).astype(np_dt)
    mem = rng.normal(size=(2, 30, D)).astype(np_dt)
    with jax.enable_x64(dtype == torch.float64):
        want = JA.gqa_forward(_j(p), js, jnp.asarray(x),
                              kv_x=jnp.asarray(mem))
        want_self = JA.gqa_forward(_j(p), js, jnp.asarray(x))
    tp = weights.tree_from_numpy(p, dtype, "cpu")
    got = TA.gqa_forward(tp, ts, _t(x, dtype), kv_x=_t(mem, dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # no memory: unmasked attention over x itself (the cross spec)
    np.testing.assert_allclose(TA.gqa_forward(tp, ts, _t(x, dtype)).numpy(),
                               np.asarray(want_self), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cross_memory_and_decode_match_reference(dtype):
    """``cross_memory`` (a product: 1e-10 in float64) and
    ``cross_decode`` against it (float32 attention: 1e-6 in float64); the
    decode equals the forward's row for that token."""
    f64 = dtype == torch.float64
    np_dt = np.float64 if f64 else np.float32
    js, ts, p = _cross(bias=True, seed=8, np_dt=np_dt)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 1, D)).astype(np_dt)
    mem = rng.normal(size=(3, 20, D)).astype(np_dt)
    with jax.enable_x64(f64):
        jk, jv = JA.cross_memory(_j(p), js, jnp.asarray(mem))
        want = JA.cross_decode(_j(p), js, jnp.asarray(x), jk, jv)
    tp = weights.tree_from_numpy(p, dtype, "cpu")
    tk, tv = TA.cross_memory(tp, ts, _t(mem, dtype))
    prod = dict(rtol=1e-10, atol=1e-10) if f64 else F32
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **prod)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **prod)
    got = TA.cross_decode(tp, ts, _t(x, dtype), tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(CAST if f64 else F32))
    full = TA.gqa_forward(tp, ts, _t(x, dtype), kv_x=_t(mem, dtype))
    np.testing.assert_allclose(got.numpy(), full.numpy(),
                               **(CAST if f64 else F32))


# ---------------------------------------------------------------------------
# Twins of tests/test_attention.py
# ---------------------------------------------------------------------------

def test_mla_forward_flash_matches_dense(monkeypatch):
    """The reference test's case (4 heads, ranks 32 / 16, 24 + 8 query
    dims, S = 64, flash forced at 32) on the port, at its 5e-4; the
    reference's params carried across."""
    js = JA.MLASpec(num_heads=4, q_lora_rank=32, kv_lora_rank=16,
                    nope_dim=24, rope_dim=8, v_head_dim=16)
    ts = TCB.MLASpec(**dataclasses.asdict(js))
    p = weights.tree_from_numpy(jax.tree.map(np.asarray, JA.init_mla(
        jax.random.PRNGKey(0), 64, js, jnp.float32)), device="cpu")
    x = _t(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (1, 64, 64))) * 0.1)
    monkeypatch.setattr(TA, "FLASH_THRESHOLD", 32)
    out_flash = TA.mla_forward(p, ts, x)
    monkeypatch.setattr(TA, "FLASH_THRESHOLD", 10**9)
    out_dense = TA.mla_forward(p, ts, x)
    np.testing.assert_allclose(out_flash.numpy(), out_dense.numpy(),
                               **FLASH_TOL)


def test_flash_cross_attention_ragged_kv():
    """Flash with causal=False, T != S and a ragged T (94 keys in chunks
    of 32) equals dense ``attend``: the whisper path."""
    b, s, t, h, hd = 1, 128, 94, 4, 16
    rng = np.random.default_rng(11)
    q, k, v = (_t(rng.normal(size=(b, n, h, hd))) for n in (s, t, t))
    scale = hd ** -0.5
    flash = TA.flash_attention(q, k, v, scale, causal=False, q_chunk=32,
                               kv_chunk=32)
    dense = TA.attend(q, k, v, None, scale)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), **F32)


def test_gqa_forward_cross_flash_matches_dense(monkeypatch):
    """Cross attention routes through flash above the size threshold
    (256 x 100 >= 64^2) and equals the dense path, at 5e-4."""
    spec = JA.AttnSpec(num_heads=4, num_kv_heads=4, head_dim=16,
                       causal=False, use_rope=False)
    tspec = TCB.AttnSpec(**dataclasses.asdict(spec))
    p = weights.tree_from_numpy(jax.tree.map(np.asarray, JA.init_gqa(
        jax.random.PRNGKey(0), 64, spec, jnp.float32)), device="cpu")
    x = _t(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (1, 256, 64))) * 0.1)
    mem = _t(np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                          (1, 100, 64))) * 0.1)
    monkeypatch.setattr(TA, "FLASH_THRESHOLD", 64)
    out_flash = TA.gqa_forward(p, tspec, x, kv_x=mem)
    monkeypatch.setattr(TA, "FLASH_THRESHOLD", 10**9)
    out_dense = TA.gqa_forward(p, tspec, x, kv_x=mem)
    np.testing.assert_allclose(out_flash.numpy(), out_dense.numpy(),
                               **FLASH_TOL)
