"""Every architecture of the registry: the port's configs and models
against the JAX package.

The configs: every name of the reference's ``ARCH_NAMES`` in its order,
each full config field for field (widths, heads, vocab, stages, the MoE
and MLA specs, the recurrent and memory fields, dtypes) and its smoke
variant; the twins of ``tests/test_arch_smoke.py``'s
``test_full_config_matches_assignment``, ``test_layer_counts`` and
``test_shape_support_matrix``; the five recurrent, MLA and memory models
at full width on ``meta`` tensors.

The models, at each config's smoke width from the reference's params
carried as numpy (float32 compute on both sides, so 1e-5): ``forward``
with its memory, ``loss_fn`` and its gradients against ``jax.grad``,
``fill_cross_caches`` and a 12-step ``decode_step`` (the caches too);
the twin of ``tests/test_decode_equivalence.py::test_decode_matches_forward``
over every name (the port's decode against its own forward at 2e-3); a
bfloat16 model's params carried with their own dtypes.  Then one
injected-draw fleet round of ``TransformerTask`` on four of the new
families in a float64 run against the JAX engine (the harness of
``tests/test_torch_transformer.py``).  ``gpu`` tests hold the five new
families' decode and forward on the card against the CPU, and the
card's decode against its forward.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.configs import ARCH_NAMES as T_ARCH_NAMES
from repro_torch.configs import INPUT_SHAPES as T_INPUT_SHAPES
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import pruning as TPR
from repro_torch.fleet import task as TTASK
from repro_torch.launch.steps import shape_supported
from repro_torch.models import model as TM

try:  # the card's machine has no JAX: only the gpu tests run there
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCH_NAMES, INPUT_SHAPES
    from repro.configs import get_config as j_get_config
    from repro.fleet import engine as JENG
    from repro.fleet import task as JTASK
    from repro.fleet import topology as JTOPO
    from repro.launch import steps as JST
    from repro.models import model as JM
except ImportError:
    JM, ARCH_NAMES = None, T_ARCH_NAMES
needs_jax = pytest.mark.skipif(JM is None, reason="needs the JAX reference")

NEW = ("xlstm-125m", "recurrentgemma-2b", "minicpm3-4b",
       "llama-3.2-vision-11b", "whisper-base")
B, T = 1, 12
TOL = dict(rtol=1e-5, atol=1e-5)
FORWARD_TOL = dict(rtol=2e-3, atol=2e-3)   # test_decode_equivalence.py's


def _t(a, dtype=torch.float32):
    return weights.tensor(a, dtype, "cpu")


def _smoke(get, name):
    cfg = get(name).smoke_variant()
    if cfg.moe is not None:
        # the reference test's pin: capacity routing of B*S train tokens and
        # B*1 decode tokens agrees only when nothing overflows
        cfg = cfg.replace(moe_capacity_factor=8.0)
    return cfg


def _inputs(cfg, seed=1):
    """Tokens (B, T) and, for a memory model, stub embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T))
    mem = (rng.normal(size=(B, cfg.num_memory_tokens, cfg.memory_dim_))
           .astype(np.float32) if cfg.num_memory_tokens else None)
    return toks, mem


# ---------------------------------------------------------------------------
# The configs
# ---------------------------------------------------------------------------

@needs_jax
def test_registry_matches_reference():
    assert T_ARCH_NAMES == ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in T_INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        t_get_config("gpt-5")


def _plain(v):
    """Specs (nested in tuples) as dicts and lists, comparable across the
    two packages' classes."""
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    return v


def _fields(cfg, names) -> dict:
    return {f: _plain(getattr(cfg, f)) for f in names}


@needs_jax
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_matches_reference_field_for_field(name):
    """Every field of the port's config (the reference's, ``remat``
    included) and the derived widths, full and smoke; the attention
    specs of every kind."""
    j, t = j_get_config(name), t_get_config(name)
    names = [f.name for f in dataclasses.fields(t)]
    assert set(names) == {f.name for f in dataclasses.fields(j)}
    derived = ["head_dim_", "num_layers", "rnn_width_", "memory_dim_"]
    for jc, tc in ((j, t), (j.smoke_variant(), t.smoke_variant())):
        assert _fields(tc, names + derived) == _fields(jc, names + derived)
        for kind, over in (("attn", None), ("attn", 64), ("local_attn", None),
                           ("cross_attn", None)):
            assert dataclasses.asdict(tc.attn_spec(kind, over)) == \
                dataclasses.asdict(jc.attn_spec(kind, over))
        if tc.mla is not None:
            for over in (None, 64):
                assert dataclasses.asdict(tc.mla_spec(over)) == \
                    dataclasses.asdict(jc.mla_spec(over))
                assert tc.mla_spec(over).scale == jc.mla_spec(over).scale
    assert t.cdtype == t.pdtype == torch.bfloat16


def test_full_config_matches_assignment():
    """The full config carries the assigned dimensions."""
    expect = {
        "xlstm-125m": (768, 4, 4, 50304),
        "recurrentgemma-2b": (2560, 10, 1, 256000),
        "llama-3.2-vision-11b": (4096, 32, 8, 128256),
        "smollm-135m": (576, 9, 3, 49152),
        "olmoe-1b-7b": (2048, 16, 16, 50304),
        "whisper-base": (512, 8, 8, 51865),
        "granite-3-2b": (2048, 32, 8, 49155),
        "grok-1-314b": (6144, 48, 8, 131072),
        "minicpm3-4b": (2560, 40, 40, 73448),
        "qwen2-7b": (3584, 28, 4, 152064),
    }
    assert tuple(expect) == T_ARCH_NAMES
    for name, dims in expect.items():
        full = t_get_config(name)
        assert (full.d_model, full.num_heads, full.num_kv_heads,
                full.vocab_size) == dims, name


def test_layer_counts():
    """whisper: 6 encoder + 6 decoder super-layers of self- and
    cross-attention sub-blocks, 6 + 6 * 2."""
    expect = {"xlstm-125m": 12, "recurrentgemma-2b": 26,
              "llama-3.2-vision-11b": 40, "smollm-135m": 30,
              "olmoe-1b-7b": 16, "whisper-base": 18,
              "granite-3-2b": 40, "grok-1-314b": 64, "minicpm3-4b": 62,
              "qwen2-7b": 28}
    for name, layers in expect.items():
        assert t_get_config(name).num_layers == layers, name


@needs_jax
def test_shape_support_matrix():
    """long_500k: native for ssm / hybrid, windowed for full-attention
    archs, skipped for whisper; the port's configs give the reference's
    matrix."""
    for name in T_ARCH_NAMES:
        cfg = t_get_config(name)
        for s, shape in T_INPUT_SHAPES.items():
            sup = shape_supported(cfg, shape)
            assert sup == JST.shape_supported(j_get_config(name),
                                              INPUT_SHAPES[s]), (name, s)
            assert sup == (name != "whisper-base" or s != "long_500k")


@needs_jax
@pytest.mark.parametrize("name", NEW)
def test_full_width_params_on_meta_match_reference(name):
    """The port's tree at full width (``meta`` tensors) has the
    reference's leaves in its flatten order, shapes and dtypes (RG-LRU's
    ``lam`` float32 in a bfloat16 model), and its parameter count."""
    shapes = jax.eval_shape(lambda k: JM.init_params(j_get_config(name), k),
                            jax.random.PRNGKey(0))
    t_params = TM.init_params(t_get_config(name), None)
    j_leaves = jax.tree_util.tree_leaves(shapes)
    t_leaves = TPR.flatten(t_params)
    assert [tuple(a.shape) for a in t_leaves] == \
        [tuple(a.shape) for a in j_leaves]
    assert [str(a.dtype).split(".")[-1] for a in t_leaves] == \
        [str(a.dtype) for a in j_leaves]
    assert TM.param_count(t_params) == sum(a.size for a in j_leaves)


# ---------------------------------------------------------------------------
# The models at smoke width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch(request):
    """(name, reference cfg, port cfg, params as numpy, port params)."""
    if JM is None:
        pytest.skip("needs the JAX reference")
    name = request.param
    jcfg, tcfg = _smoke(j_get_config, name), _smoke(t_get_config, name)
    npp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    return name, jcfg, tcfg, npp, weights.tree_from_numpy(npp, device="cpu")


def _j_mem(mem):
    return None if mem is None else jnp.asarray(mem)


def test_forward_matches_reference(arch):
    name, jcfg, tcfg, npp, tp = arch
    toks, mem = _inputs(tcfg)
    want, jaux = JM.forward(jcfg, jax.tree.map(jnp.asarray, npp),
                            jnp.asarray(toks), _j_mem(mem))
    got, aux = TM.forward(tcfg, tp, _t(toks), None if mem is None
                          else _t(mem))
    assert got.shape == (B, T, tcfg.vocab_size)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_loss_and_gradients_match_reference(arch):
    """``loss_fn`` with the batch's memory, and its gradient against
    ``jax.grad``: each leaf at 1e-5 relative and 1e-5 of its own largest
    gradient.  The mLSTM and sLSTM input-gate biases (``cell.w_i.b``)
    take 1e-5 of the tree's largest gradient instead: the normaliser
    divides a constant shift of the input gate out of the cell's output,
    so their true gradient is 0 and both sides hold rounding noise (below
    1e-6 of the largest, checked) with a sign neither side fixes."""
    name, jcfg, tcfg, npp, tp = arch
    toks, mem = _inputs(tcfg, seed=2)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": _t(toks)}
    if mem is not None:
        jb["memory"], tb["memory"] = jnp.asarray(mem), _t(mem)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb), has_aux=True)(
            jax.tree.map(jnp.asarray, npp))
    tg, (tl, tm) = torch.func.grad_and_value(
        lambda p: TM.loss_fn(tcfg, p, tb), has_aux=True)(tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    j_leaves = [np.asarray(b) for b in jax.tree_util.tree_leaves(jg)]
    t_leaves = TPR.flatten(tg)
    assert len(t_leaves) == len(j_leaves)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    noise = {f"['stages'][{si}]['b{bi}']['rec']['cell']['w_i']['b']"
             for si, stage in enumerate(tcfg.stages)
             for bi, spec in enumerate(stage.blocks)
             if spec.kind in ("mlstm", "slstm")}
    assert noise <= set(paths)
    scale = max(np.abs(b).max() for b in j_leaves)
    for path, a, b in zip(paths, t_leaves, j_leaves):
        floor = np.abs(b).max()
        if path in noise:
            assert floor < 1e-6 * scale, (path, floor, scale)
            floor = scale
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * floor, err_msg=path)
    if tcfg.encoder_layers:       # memory reaches the encoder
        assert float(tg["encoder"]["stage"]["b0"]["attn"]["wq"]["w"]
                     .abs().max()) > 0


def _j_decode(cfg, params, toks, cache):
    step = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = step(params, toks[:, t:t + 1], cache)
        outs.append(np.asarray(logits))
    return np.stack(outs, axis=1), cache


def _t_decode(cfg, params, toks, cache):
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = TM.decode_step(cfg, params, toks[:, t:t + 1], cache)
        outs.append(logits)
    return torch.stack(outs, dim=1), cache


def test_decode_and_cross_caches_match_reference(arch):
    """``init_cache``, ``fill_cross_caches`` and 12 ``decode_step``s:
    logits and every cache leaf against the reference's."""
    name, jcfg, tcfg, npp, tp = arch
    toks, mem = _inputs(tcfg, seed=3)
    jp = jax.tree.map(jnp.asarray, npp)
    jc = JM.init_cache(jcfg, B, T)
    tc = TM.init_cache(tcfg, B, T, device="cpu")
    if mem is not None:
        jc = JM.fill_cross_caches(jcfg, jp, jc, jnp.asarray(mem))
        filled = TM.fill_cross_caches(tcfg, tp, tc, _t(mem))
        assert not any(leaf.any() for leaf in TPR.flatten(tc["stages"]))
        tc = filled
    t_leaves = TPR.flatten(tc)
    j_leaves = jax.tree_util.tree_leaves(jc)
    assert [tuple(a.shape) for a in t_leaves] == \
        [tuple(a.shape) for a in j_leaves]
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    want, jc = _j_decode(jcfg, jp, jnp.asarray(toks), jc)
    got, tc = _t_decode(tcfg, tp, _t(toks), tc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tc["pos"].tolist() == [T]
    for a, b in zip(TPR.flatten(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("name", T_ARCH_NAMES)
def test_decode_matches_forward(name):
    """Teacher-forced ``decode_step`` (cross caches filled from the same
    memory) reproduces ``forward``: KV and latent caches, recurrent
    states, RoPE positions and cross-attention caches, at 2e-3."""
    cfg = _smoke(t_get_config, name)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    toks, mem = _inputs(cfg, seed=4)
    mem = None if mem is None else _t(mem)
    full, _ = TM.forward(cfg, params, _t(toks), mem)
    cache = TM.init_cache(cfg, B, T, device="cpu")
    if mem is not None:
        cache = TM.fill_cross_caches(cfg, params, cache, mem)
    got, _ = _t_decode(cfg, params, _t(toks), cache)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **FORWARD_TOL)


@needs_jax
@pytest.mark.parametrize("name", NEW)
def test_bfloat16_params_carry_their_own_dtypes(name):
    """A bfloat16 model (one repeat of each stage) carried by
    ``tree_from_numpy(dtype=None)``: bfloat16 weights, float32 ``lam``,
    the encoder subtree and ``memory_proj`` in the reference's dtypes and
    bits."""
    jcfg = j_get_config(name)
    small = jcfg.replace(stages=tuple(dataclasses.replace(s, repeats=1)
                                      for s in jcfg.stages),
                         d_model=64, num_heads=4, num_kv_heads=min(
                             jcfg.num_kv_heads, 4), head_dim=16, d_ff=128,
                         vocab_size=97, rnn_width=64,
                         encoder_layers=min(jcfg.encoder_layers, 1),
                         mla=None if jcfg.mla is None else dataclasses.replace(
                             jcfg.mla, num_heads=4, q_lora_rank=16,
                             kv_lora_rank=8, nope_dim=8, rope_dim=8,
                             v_head_dim=16))
    jp = jax.tree.map(np.asarray, JM.init_params(small,
                                                 jax.random.PRNGKey(1)))
    tp = weights.tree_from_numpy(jp, dtype=None, device="cpu")
    for a, b in zip(TPR.flatten(tp), jax.tree_util.tree_leaves(jp)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.to(torch.float32).numpy(),
                                      b.astype(np.float32))
    if name == "recurrentgemma-2b":
        assert tp["stages"][0]["b0"]["rec"]["rglru"]["lam"].dtype \
            == torch.float32
    if jcfg.num_memory_tokens:
        assert tp["memory_proj"]["w"].dtype == torch.bfloat16
    if jcfg.encoder_layers:
        assert tp["encoder"]["norm"]["scale"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# TransformerTask on the new families
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("name", ["xlstm-125m", "recurrentgemma-2b",
                                  "minicpm3-4b", "whisper-base"])
def test_fleet_round_matches_reference(name):
    """One round of a TransformerTask(arch_name=name) fleet (1 x 4
    clients, block masks on every >= 2-D leaf: the stacked (repeats, H,
    hd, hd) recurrence matrices, the (repeats, width, d) conv weights and
    the stacked vectors among them) from the JAX engine's draws, params
    and token pool, in a float64 run: losses, rates and params at 1e-5
    (the model computes in float32 on both sides)."""
    from test_torch_transformer import _port_run, _reference_run, _tiny
    kw = dict(rounds=1, lr=0.5, kernel="fused", mask_kind="block")
    jcfg = JENG.FleetConfig(task=JTASK.TransformerTask(arch_name=name),
                            topology=JTOPO.FleetTopology(1, 4), **kw)
    tcfg = _tiny(clients=4, task=TTASK.TransformerTask(arch_name=name), **kw)
    ref = _reference_run(jcfg)
    sim, res = _port_run(tcfg, ref)
    jr = ref["result"]
    for f in ("losses", "accuracy", "mean_prune", "latencies"):
        np.testing.assert_allclose(getattr(res, f), getattr(jr, f),
                                   rtol=1e-5, atol=1e-8, err_msg=f)
    for a, b in zip(TPR.flatten(res.params), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)
    assert np.all(np.isfinite(res.losses))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", NEW)
def test_new_families_card_match_cpu_on_gpu(name):
    """The same params (drawn on the CPU) on the card and the CPU: the
    forward with its memory and 12 teacher-forced decode steps within
    1e-4; on the card, decode against forward within 2e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _smoke(t_get_config, name)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    toks, mem = _inputs(cfg, seed=5)
    out = {}
    for dev in ("cpu", "cuda"):
        p = TPR.tree_map(lambda a: a.to(dev), params)
        tk = torch.as_tensor(toks, device=dev)
        m = None if mem is None else torch.as_tensor(mem, device=dev)
        full, _ = TM.forward(cfg, p, tk, m)
        cache = TM.init_cache(cfg, B, T, device=dev)
        if m is not None:
            cache = TM.fill_cross_caches(cfg, p, cache, m)
        dec, _ = _t_decode(cfg, p, tk, cache)
        out[dev] = (full.cpu().numpy(), dec.cpu().numpy())
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["cuda"][1], out["cuda"][0],
                               **FORWARD_TOL)
