"""The model's dense decode (``init_cache``, ``decode_step``) and the dense
configs: the port against the JAX package.

Numpy inputs from a seed go through the reference's function and the
port's on the CPU.  ``gqa_decode`` in float64 under ``jax.enable_x64``:
full caches, rolling caches, a windowed full cache, positions past a full
cache's end (its last slot overwritten), with and without qkv bias and
RoPE; the cache writes at 1e-10 (1e-6 through RoPE, which rotates in
float32 on both sides), the output at 1e-6 (both sides attend in
float32).  Then the twins of ``tests/test_decode_equivalence.py``: for every
config the port has, at its smoke width, teacher-forced decode against
the port's ``forward`` at 2e-3 and against the reference's
``decode_step`` at 1e-5, also started mid-sequence from the reference's
own cache; the rolling window against ``forward`` (equal before the
window binds, different after).  The dense configs field by field and at
full width on ``meta`` tensors.  A ``gpu`` test holds ``decode_step`` on
the card against the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.configs import base as TCB
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import pruning as TPR
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM

try:  # the card's machine has no JAX: only the gpu test runs there
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import attention as JA
    from repro.models import model as JM
except ImportError:
    JM = None
needs_jax = pytest.mark.skipif(JM is None, reason="needs the JAX reference")

PORTED = ("smollm-135m", "granite-3-2b", "qwen2-7b", "olmoe-1b-7b",
          "grok-1-314b")
DENSE_NEW = ("granite-3-2b", "qwen2-7b")
# the configs that once raised NotImplementedError, and a block kind of each
FORMERLY_REFUSED = {"xlstm-125m": "mlstm", "recurrentgemma-2b": "rglru",
                    "minicpm3-4b": "mla", "llama-3.2-vision-11b": "cross_attn",
                    "whisper-base": "cross_attn"}
B, T = 1, 12
FORWARD_TOL = dict(rtol=2e-3, atol=2e-3)
REF_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=torch.float32):
    return weights.tensor(a, dtype, "cpu")


# ---------------------------------------------------------------------------
# gqa_decode in float64
# ---------------------------------------------------------------------------

DECODE_CASES = [  # (what, window, cache_len, positions)
    ("full", None, 8, [0, 3, 7]),
    ("full, past its end", None, 6, [6, 9, 5]),
    ("rolling", 6, 6, [2, 6, 13]),
    ("rolling, wider window", 10, 6, [1, 8, 25]),
    ("windowed full cache", 4, 10, [1, 5, 9]),
]


@needs_jax
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("what,window,cache_len,positions", DECODE_CASES)
def test_gqa_decode_matches_reference_float64(what, window, cache_len,
                                              positions, bias, rope):
    """The cache writes at 1e-10 without RoPE, and at 1e-6 with it (both
    sides rotate in float32, whose sin and cos may differ in the last
    place); the output at 1e-6 (``attend`` scores and sums in float32 on
    both sides)."""
    tol = dict(rtol=1e-6, atol=1e-6) if rope else dict(rtol=1e-10,
                                                         atol=1e-10)
    h, hkv, hd, d = 4, 2, 8, 16
    rng = np.random.default_rng(len(what) + cache_len)
    p = {n: {"w": rng.normal(size=(d, o)) * d ** -0.5}
         for n, o in (("wq", h * hd), ("wk", hkv * hd), ("wv", hkv * hd))}
    p["wo"] = {"w": rng.normal(size=(h * hd, d)) * (h * hd) ** -0.5}
    if bias:
        for n in ("wq", "wk", "wv"):
            p[n]["b"] = rng.normal(size=p[n]["w"].shape[1])
    b = len(positions)
    cache = {"k": rng.normal(size=(b, cache_len, hkv, hd)),
             "v": rng.normal(size=(b, cache_len, hkv, hd))}
    x = rng.normal(size=(b, 1, d))
    pos = np.asarray(positions)
    kw = dict(rope_theta=10000.0, qkv_bias=bias, window=window,
              use_rope=rope)
    with jax.enable_x64(True):
        y_j, c_j = JA.gqa_decode(jax.tree.map(jnp.asarray, p),
                                 JA.AttnSpec(h, hkv, hd, **kw),
                                 jnp.asarray(x), jax.tree.map(jnp.asarray,
                                                              cache),
                                 jnp.asarray(pos, jnp.int32))
    tc = weights.tree_from_numpy(cache, torch.float64, "cpu")
    y_t, c_t = TA.gqa_decode(weights.tree_from_numpy(p, torch.float64, "cpu"),
                             TCB.AttnSpec(h, hkv, hd, **kw), _t(x, torch.float64),
                             tc, torch.as_tensor(pos))
    assert y_t.dtype == torch.float64
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6,
                               atol=1e-6)
    for n in ("k", "v"):
        np.testing.assert_allclose(c_t[n].numpy(), np.asarray(c_j[n]), **tol)
        # one slot a row written, the given cache untouched
        assert int((c_t[n] != tc[n]).any(-1).any(-1).sum()) == b
        np.testing.assert_array_equal(tc[n].numpy(), cache[n])


def test_full_cache_overwrites_its_last_slot():
    spec = TCB.AttnSpec(2, 1, 4)
    p = {n: {"w": torch.randn(8, o, generator=torch.Generator()
                              .manual_seed(i))}
         for i, (n, o) in enumerate((("wq", 8), ("wk", 4), ("wv", 4),
                                     ("wo", 8)))}
    cache = TA.init_gqa_cache(spec, 1, 3, torch.float32, "cpu")
    x = torch.ones(1, 1, 8)
    for pos in (3, 7):
        _, cache = TA.gqa_decode(p, spec, x * pos, cache, torch.tensor([pos]))
        assert torch.equal(cache["k"][0, :2], torch.zeros(2, 1, 4))
        assert not torch.equal(cache["k"][0, 2], torch.zeros(1, 4))
    last = cache["k"][0, 2].clone()
    _, again = TA.gqa_decode(p, spec, x * 7, cache, torch.tensor([7]))
    assert torch.equal(again["k"][0, 2], last)   # written, not accumulated


# ---------------------------------------------------------------------------
# The model's decode against forward and the reference
# ---------------------------------------------------------------------------

def _cfg_pair(name):
    jcfg, tcfg = j_get_config(name).smoke_variant(), \
        t_get_config(name).smoke_variant()
    if tcfg.moe is not None:
        # the reference test's pin: capacity routing of B*S train tokens and
        # B*1 decode tokens agrees only when nothing overflows
        jcfg = jcfg.replace(moe_capacity_factor=8.0)
        tcfg = tcfg.replace(moe_capacity_factor=8.0)
    return jcfg, tcfg


def _j_step(window=None):
    """The reference's decode_step, jitted per config (as its own test
    runs it)."""
    jitted = {}

    def step(cfg, params, token, cache):
        if cfg not in jitted:
            jitted[cfg] = jax.jit(lambda p, t, c: JM.decode_step(
                cfg, p, t, c, window=window))
        return jitted[cfg](params, token, cache)
    return step


def _decode(step, cfg, params, tokens, cache, start=0):
    outs = []
    for t in range(start, tokens.shape[1]):
        logits, cache = step(cfg, params, tokens[:, t:t + 1], cache)
        outs.append(np.asarray(logits))
    return np.stack(outs, axis=1), cache


@needs_jax
@pytest.mark.parametrize("name", PORTED)
def test_decode_matches_forward_and_reference(name):
    jcfg, tcfg = _cfg_pair(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    tp = weights.tree_from_numpy(npp, device="cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, T))
    full, _ = TM.forward(tcfg, tp, _t(toks))
    got, cache = _decode(TM.decode_step, tcfg, tp, _t(toks),
                         TM.init_cache(tcfg, B, T, device="cpu"))
    np.testing.assert_allclose(got, full.numpy(), **FORWARD_TOL)
    want, jcache = _decode(_j_step(), jcfg, jp, jnp.asarray(toks),
                           JM.init_cache(jcfg, B, T))
    np.testing.assert_allclose(got, want, **REF_TOL)
    assert cache["pos"].tolist() == [T]
    for a, b in zip(TPR.flatten(cache), jax.tree_util.tree_leaves(jcache)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **REF_TOL)


@needs_jax
@pytest.mark.parametrize("name", ["smollm-135m", "qwen2-7b", "olmoe-1b-7b"])
def test_decode_resumes_from_the_reference_cache(name):
    """The reference decodes the first half; its cache (``pos`` included)
    carried across as numpy, the port decodes the rest."""
    jcfg, tcfg = _cfg_pair(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tp = weights.tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, T))
    step = _j_step()
    want, _ = _decode(step, jcfg, jp, jnp.asarray(toks),
                      JM.init_cache(jcfg, 2, T))
    _, jcache = _decode(step, jcfg, jp, jnp.asarray(toks[:, :5]),
                        JM.init_cache(jcfg, 2, T))
    cache = weights.tree_from_numpy(jax.tree.map(np.asarray, jcache),
                                    device="cpu")
    assert cache["pos"].dtype == torch.int64 and cache["pos"].tolist() == [5, 5]
    got, _ = _decode(TM.decode_step, tcfg, tp, _t(toks), cache, start=5)
    np.testing.assert_allclose(got, want[:, 5:], **REF_TOL)


@needs_jax
@pytest.mark.parametrize("name", ["smollm-135m", "granite-3-2b"])
def test_windowed_decode_matches_ref_window(name):
    """The rolling cache of width w: equal to forward before the window
    binds, different at the end (the first token evicted), and equal to
    the reference's windowed decode throughout."""
    jcfg, tcfg = _cfg_pair(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = weights.tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    w, t_long = 8, 16
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, t_long))
    cache = TM.init_cache(tcfg, B, t_long, window=w, device="cpu")
    assert cache["stages"][0]["b0"]["k"].shape[2] == w
    windowed, _ = _decode(
        lambda c, p, t, k: TM.decode_step(c, p, t, k, window=w), tcfg, tp,
        _t(toks), cache)
    full, _ = TM.forward(tcfg, tp, _t(toks))
    full = full.numpy()
    np.testing.assert_allclose(windowed[:, :w - 1], full[:, :w - 1],
                               **FORWARD_TOL)
    assert not np.allclose(windowed[:, -1], full[:, -1], **FORWARD_TOL)
    want, _ = _decode(_j_step(window=w), jcfg, jp, jnp.asarray(toks),
                      JM.init_cache(jcfg, B, t_long, window=w))
    np.testing.assert_allclose(windowed, want, **REF_TOL)


@needs_jax
@pytest.mark.parametrize("window", [None, 4, 64])
def test_init_cache_matches_reference(window):
    jcfg, tcfg = _cfg_pair("olmoe-1b-7b")
    jc = JM.init_cache(jcfg, 3, 16, window=window)
    tc = TM.init_cache(tcfg, 3, 16, window=window, device="cpu")
    assert tc["pos"].tolist() == [0, 0, 0]
    j_leaves = jax.tree_util.tree_leaves(jc["stages"])
    t_leaves = TPR.flatten(tc["stages"])
    assert [tuple(a.shape) for a in t_leaves] == \
        [tuple(a.shape) for a in j_leaves]
    assert all(a.dtype == tcfg.cdtype and not a.any() for a in t_leaves)
    assert TM.init_cache(tcfg.replace(compute_dtype="bfloat16"), 1, 4,
                         device="cpu")["stages"][0]["b0"]["v"].dtype \
        == torch.bfloat16


def test_decode_step_leaves_its_cache_alone():
    cfg = t_get_config("granite-3-2b").smoke_variant()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    cache = TM.init_cache(cfg, 2, 4, device="cpu")
    tok = torch.tensor([[1], [2]])
    a, c1 = TM.decode_step(cfg, params, tok, cache)
    b, c2 = TM.decode_step(cfg, params, tok, cache)
    assert torch.equal(a, b) and cache["pos"].tolist() == [0, 0]
    assert not any(leaf.any() for leaf in TPR.flatten(cache["stages"]))
    assert c1["pos"].tolist() == [1, 1] and a.shape == (2, cfg.vocab_size)


def test_unported_pieces_name_their_roadmap_items():
    """What item 10 once refused now runs: every config loads and holds
    its block kind, an MLA block's latent cache is made, and
    ``fill_cross_caches`` fills a memory model's cross caches (only
    those)."""
    for name, kind in FORMERLY_REFUSED.items():
        cfg = t_get_config(name)
        assert kind in {b.kind for st in cfg.stages for b in st.blocks}
    cfg = t_get_config("minicpm3-4b").smoke_variant()
    cache = TB.init_block_cache(cfg, cfg.stages[0].blocks[0], 2, 4, None,
                                "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {"ckv": (2, 4, 32), "kpe": (2, 4, 16)}
    cfg = t_get_config("whisper-base").smoke_variant()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    cache = TM.init_cache(cfg, 2, 4, device="cpu")
    mem = torch.randn(2, cfg.num_memory_tokens, cfg.memory_dim_,
                      generator=torch.Generator().manual_seed(1))
    filled = TM.fill_cross_caches(cfg, params, cache, mem)
    assert filled["stages"][0]["b1"]["mk"].abs().sum() > 0
    assert torch.equal(filled["stages"][0]["b0"]["k"],
                       cache["stages"][0]["b0"]["k"])
    assert not cache["stages"][0]["b1"]["mk"].any()   # not written


# ---------------------------------------------------------------------------
# The dense configs
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("name", DENSE_NEW)
def test_dense_config_matches_reference(name):
    j, t = j_get_config(name), t_get_config(name)
    for f in ("name", "family", "source", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "head_dim_", "rope_theta",
              "qkv_bias", "norm", "act", "tie_embeddings", "local_window",
              "long_context_window", "param_dtype", "compute_dtype",
              "num_layers"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.moe is None and t.cdtype == torch.bfloat16
    for kind, over in (("attn", None), ("attn", 64), ("local_attn", None)):
        assert dataclasses.asdict(t.attn_spec(kind, over)) == \
            dataclasses.asdict(j.attn_spec(kind, over))
    js, ts = j.smoke_variant(), t.smoke_variant()
    for f in ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "param_dtype", "compute_dtype"):
        assert getattr(ts, f) == getattr(js, f), f


@needs_jax
@pytest.mark.parametrize("name,count", [("granite-3-2b", 2_533_531_648),
                                        ("qwen2-7b", 7_615_616_512)])
def test_dense_full_width_params_on_meta_match_reference(name, count):
    shapes = jax.eval_shape(lambda k: JM.init_params(j_get_config(name), k),
                            jax.random.PRNGKey(0))
    t_params = TM.init_params(t_get_config(name), None)
    j_leaves = jax.tree_util.tree_leaves(shapes)
    t_leaves = TPR.flatten(t_params)
    assert [tuple(a.shape) for a in t_leaves] == \
        [tuple(a.shape) for a in j_leaves]
    assert all(a.dtype == torch.bfloat16 for a in t_leaves)
    assert TM.param_count(t_params) == sum(a.size for a in j_leaves) == count


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", PORTED)
def test_decode_card_matches_cpu_on_gpu(name):
    """The same params (drawn on the CPU) on the card and the CPU: 8
    teacher-forced decode steps, logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = t_get_config(name).smoke_variant()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = TPR.tree_map(lambda a: a.to(dev), params)
        cache = TM.init_cache(cfg, 2, 8, device=dev)
        steps = []
        for t in range(8):
            lg, cache = TM.decode_step(cfg, p, toks[:, t:t + 1].to(dev),
                                       cache)
            steps.append(lg.cpu())
        out[dev] = torch.stack(steps, 1).numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)
