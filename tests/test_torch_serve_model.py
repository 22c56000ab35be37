"""The port's serving model against the reference's.

Reference params come from the reference's ``TransformerTask(arch=
tiny_arch(), target_tiles=4)`` (as ``tests/test_serve.py`` builds them)
and are carried across as numpy.  Bitwise: tile keeps, head masks, the
bundle round-trip through the reference's ``.npz`` format.  Logits: the
port's ``SparseModel`` (``"kernel"`` and ``"dense"``) against the
reference's (``impl="pallas", attn_impl="pallas"`` in interpret mode, and
``impl="dense", attn_impl="xla"``) at 2e-4, as the reference holds its own
impls to each other.  Also the model-side pieces under them: configs,
pruning of stacked leaves, layers, the tile grid and checkpoints.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as TCK
from repro_torch import weights
from repro_torch.configs import base as TCB
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import pruning as TPR
from repro_torch.fleet.task import TransformerTask as TTask
from repro_torch.fleet.task import auto_tile_grid as t_auto_tile_grid
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import SparseModel as TSparse
from repro_torch.serve import export_pruned as t_export
from repro_torch.serve import load_pruned as t_load
from repro_torch.serve import make_bundle as t_make_bundle

try:  # the card's machine has no JAX: only the gpu tests run there
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ArchConfig, BlockSpec, StageSpec
    from repro.core import pruning as JPR
    from repro.fleet.task import TransformerTask as JTask
    from repro.models import layers as JL
    from repro.serve import SparseModel as JSparse
    from repro.serve import export_pruned as j_export
    from repro.serve import load_pruned as j_load
    from repro.serve import make_bundle as j_make_bundle
except ImportError:
    JTask = None
needs_jax = pytest.mark.skipif(JTask is None, reason="needs the JAX reference")

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(name="tiny-serve", family="dense", source="test", d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64)


def t_arch(**kw):
    return TCB.ArchConfig(**{**TINY, "stages": (
        TCB.StageSpec(2, (TCB.BlockSpec("attn", "mlp"),)),), **kw})


@pytest.fixture(scope="module")
def ref():
    """(reference arch, task, params) and their numpy params."""
    arch = ArchConfig(**TINY, stages=(StageSpec(2, (BlockSpec("attn",
                                                              "mlp"),)),))
    task = JTask(arch=arch, target_tiles=4)
    params = task.init_params(jax.random.PRNGKey(0))
    return arch, task, params, jax.tree_util.tree_map(np.asarray, params)


def _port(np_params):
    return weights.tree_from_numpy(np_params, device="cpu")


def _keeps_equal(a, b):
    assert len(a) == len(b)
    for ka, kb in zip(a, b):
        assert (ka is None) == (kb is None)
        if ka is not None:
            np.testing.assert_array_equal(np.asarray(ka), kb.cpu().numpy())


# ---------------------------------------------------------------------------
# Configs, layers, pruning
# ---------------------------------------------------------------------------

@needs_jax
def test_smollm_config_matches_reference():
    j, t = j_get_config("smollm-135m"), t_get_config("smollm-135m")
    for f in ("d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
              "head_dim_", "rope_theta", "norm", "act", "tie_embeddings",
              "param_dtype", "compute_dtype", "long_context_window",
              "num_layers"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.pdtype == torch.bfloat16 and t.cdtype == torch.bfloat16
    assert t.attn_spec("attn").head_dim == 64


def test_unported_config_names_its_roadmap_item():
    """The recurrent, MLA and memory configs load; serving them is refused
    as the reference refuses it (encoder / memory models first)."""
    for name, what in (("xlstm-125m", "block kind 'mlstm'"),
                       ("minicpm3-4b", "block kind 'mla'"),
                       ("whisper-base", "encoder/memory"),
                       ("llama-3.2-vision-11b", "encoder/memory")):
        with pytest.raises(NotImplementedError, match=what):
            TSparse(t_get_config(name), None, device="cpu")


@needs_jax
def test_param_shapes_and_tile_grid_match_reference():
    """Full-width smollm-135m: the port's tree (drawn on ``meta``) has the
    reference's leaves in the reference's flatten order, and the same
    per-leaf tile grid (no tile edge a power of two)."""
    cfg = j_get_config("smollm-135m")
    shapes = jax.eval_shape(JTask(arch=cfg).init_params,
                            jax.random.PRNGKey(0))
    j_leaves = jax.tree_util.tree_leaves(shapes)
    t_params = TTask(arch=t_get_config("smollm-135m")).init_params(None)
    t_leaves = TPR.flatten(t_params)
    assert [tuple(l.shape) for l in t_leaves] == \
        [tuple(l.shape) for l in j_leaves]
    j_paths = [jax.tree_util.keystr(p) for p, _ in
               jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert j_paths[:5] == ["['embed']['embedding']", "['final_norm']['scale']",
                           "['stages'][0]['b0']['attn']['wk']['w']",
                           "['stages'][0]['b0']['attn']['wo']['w']",
                           "['stages'][0]['b0']['attn']['wq']['w']"]
    from repro.fleet.task import auto_tile_grid as j_grid
    assert t_auto_tile_grid(t_params) == j_grid(shapes)
    grid = t_auto_tile_grid(t_params)
    assert grid[0] == (6144, 72) and grid[2] == (72, 24) \
        and grid[3] == (72, 72) and grid[8] == (192, 72)


def test_transformer_task_training_is_not_ported():
    """(The name is kept from when neither half was ported.)  The training
    half gives a finite loss and gradient on a pool batch, and the model's
    dense decode, teacher-forced over the batch's tokens, gives
    ``forward``'s logits (2e-3, the reference's decode-equivalence
    tolerance)."""
    task = TTask(arch=t_arch(), local_batch=2, seq_len=8)
    gen = torch.Generator().manual_seed(0)
    params = task.init_params(gen)
    state = task.build(gen, torch.float32, "cpu")
    batch = task.client_batch(state, 0, torch.tensor([3]))
    tokens = batch["tokens"][0]
    assert tokens.shape == (2, 8)
    g, loss = torch.func.grad_and_value(task.loss)(params, {"tokens": tokens})
    assert torch.isfinite(loss) and all(
        torch.isfinite(leaf).all() for leaf in TPR.flatten(g))
    cfg = task.config()
    full, _ = TM.forward(cfg, params, tokens)
    cache = TM.init_cache(cfg, 2, 8, device="cpu")
    for t in range(8):
        logits, cache = TM.decode_step(cfg, params, tokens[:, t:t + 1], cache)
        torch.testing.assert_close(logits, full[:, t], rtol=2e-3, atol=2e-3)


@needs_jax
def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    scale = rng.normal(size=(8,)).astype(np.float32)
    got = TL.rms_norm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x))
    want = JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    pos = np.arange(5)[None, :] + np.array([[0], [7]])
    got = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flatten_walks_lists_by_index_and_unflatten_inverts():
    tree = {"stages": [{"b0": {"attn": {"wq": 1, "wk": 2, "wv": 3, "wo": 4}}},
                       {"b0": {"x": 5}}], "embed": {"embedding": 0}}
    assert TPR.flatten(tree) == [0, 2, 4, 1, 3, 5]
    again = TPR.unflatten(tree, [10 * v for v in TPR.flatten(tree)])
    assert again["stages"][0]["b0"]["attn"]["wo"] == 40
    assert list(again["stages"][0]["b0"]["attn"]) == ["wq", "wk", "wv", "wo"]


@needs_jax
def test_stacked_leaf_norm_state_and_masks_match_reference(ref):
    _, task, params, npp = ref
    tp = _port(npp)
    grid = task.tile_grid(params)
    j_state = JPR.block_norm_state(params, grid)
    t_state = TPR.block_norm_state(tp, grid)
    for j, t in zip(j_state, t_state):
        assert (j is None) == (t is None)
        if j is not None:
            np.testing.assert_allclose(t.norms.numpy(), np.asarray(j.norms),
                                       rtol=1e-6)
            np.testing.assert_array_equal(t.cum_frac.numpy(),
                                          np.asarray(j.cum_frac))
    jb = j_make_bundle(task, params, 0.5)
    tb = t_make_bundle(TTask(arch=t_arch(), target_tiles=4), tp, 0.5)
    for j, t in zip(jax.tree_util.tree_leaves(jb.masked_params()),
                    TPR.flatten(tb.masked_params())):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# Bundles and SparseModel
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("rho", [0.0, 0.75, 1.0])
def test_bundle_keeps_and_head_masks_bitwise(ref, rho):
    arch, task, params, npp = ref
    jb = j_make_bundle(task, params, rho)
    tb = t_make_bundle(TTask(arch=t_arch(), target_tiles=4), _port(npp), rho)
    _keeps_equal(jb.keeps, tb.keeps)
    assert [tuple(g) if g else None for g in jb.grid] == tb.grid
    jm = JSparse(arch, jb, impl="dense")
    tm = TSparse(t_arch(), tb, impl="dense", device="cpu")
    for lj, lt in zip(jm.layers, tm.layers):
        assert lj["head_mask"].dtype == lt["head_mask"].dtype
        np.testing.assert_array_equal(lj["head_mask"], lt["head_mask"])


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _logits(model, toks, steps, tensor, full):
    """Decode logits of ``steps`` teacher-forced steps, then prefill."""
    b = toks.shape[0]
    caches = model.init_caches(b, 8)
    out = []
    for i in range(steps):
        lg, caches = model.decode_step(model.arrays, tensor(toks[:, i:i + 1]),
                                       caches, full(b, i))
        out.append(_np(lg))
    lp, _ = model.prefill(model.arrays, tensor(toks), 8)
    return out, _np(lp)


@needs_jax
@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("rho", [0.0, 0.75, 1.0])
def test_sparse_model_logits_match_reference(ref, impl, rho):
    arch, task, params, npp = ref
    jb = j_make_bundle(task, params, rho)
    jm = JSparse(arch, jb, impl="pallas", attn_impl="pallas") \
        if impl == "kernel" else JSparse(arch, jb, impl="dense",
                                         attn_impl="xla")
    tm = TSparse(t_arch(), weights.bundle_from_numpy(jb, device="cpu"),
                 impl=impl, device="cpu")
    toks = np.random.default_rng(1).integers(0, 64, (2, 3))
    jd, jp = _logits(jm, toks, 3, jnp.asarray,
                     lambda b, i: jnp.full((b,), i, jnp.int32))
    td, tp = _logits(tm, toks, 3, torch.as_tensor,
                     lambda b, i: torch.full((b,), i))
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(tp, jp, **TOL)


@needs_jax
def test_bundle_written_by_reference_loads_bitwise(ref, tmp_path):
    arch, task, params, _ = ref
    path = os.path.join(tmp_path, "bundle.npz")
    jb = j_export(path, task, params, 0.75)
    tb = t_load(path, TTask(arch=t_arch(), target_tiles=4), device="cpu")
    assert tb.rho == pytest.approx(0.75)
    for a, b in zip(jax.tree_util.tree_leaves(jb.params),
                    TPR.flatten(tb.params)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    _keeps_equal(jb.keeps, tb.keeps)
    assert [tuple(g) if g else None for g in jb.grid] == tb.grid


@needs_jax
def test_bundle_written_by_port_loads_in_reference(ref, tmp_path):
    arch, task, _, npp = ref
    path = os.path.join(tmp_path, "port.npz")
    tb = t_export(path, TTask(arch=t_arch(), target_tiles=4), _port(npp),
                  0.5)
    jb = j_load(path, task)
    for a, b in zip(jax.tree_util.tree_leaves(jb.params),
                    TPR.flatten(tb.params)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    _keeps_equal(jb.keeps, tb.keeps)


def test_bfloat16_params_round_trip_through_a_checkpoint(tmp_path):
    g = torch.Generator().manual_seed(0)
    params = TM.init_params(t_arch(param_dtype="bfloat16"), g)
    path = os.path.join(tmp_path, "bf16.npz")
    TCK.save(path, {"params": params})
    like = TM.init_params(t_arch(param_dtype="bfloat16"), None)
    back = TCK.restore(path, {"params": like})["params"]
    for a, b in zip(TPR.flatten(params), TPR.flatten(back)):
        assert b.dtype == torch.bfloat16
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sparse_model_defaults_to_the_card():
    task = TTask(arch=t_arch(), target_tiles=4)
    params = task.init_params(torch.Generator().manual_seed(0))
    bundle = t_make_bundle(task, params, 0.5)
    if torch.cuda.is_available():
        assert TSparse(t_arch(), bundle).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSparse(t_arch(), bundle)
    assert TSparse(t_arch(), bundle, device="cpu").device.type == "cpu"


def test_validation_rejects_non_llama():
    arch = t_arch(stages=(TCB.StageSpec(1, (TCB.BlockSpec("mlstm", "mlp"),)),))
    with pytest.raises(NotImplementedError):
        TSparse(arch, None, device="cpu")


def _with_attn(base_cls, **spec_kw):
    """A config class whose "attn" blocks carry ``spec_kw`` in their
    ``AttnSpec`` (what a windowed or rescaled attention would give)."""
    class Arch(base_cls):
        def attn_spec(self, kind, window_override=None):
            return dataclasses.replace(
                super().attn_spec(kind, window_override), **spec_kw)
    return Arch


@needs_jax
@pytest.mark.parametrize("spec_kw,what", [
    (dict(window=16), "windowed attention"),
    (dict(softmax_scale=0.5), "custom softmax scale")])
def test_validation_rejects_window_and_custom_scale(spec_kw, what):
    """The reference's two AttnSpec refusals, with its messages; the
    default scale spelled out is no refusal."""
    t_cfg = _with_attn(TCB.ArchConfig, **spec_kw)(**{**TINY, "stages": (
        TCB.StageSpec(1, (TCB.BlockSpec("attn", "mlp"),)),)})
    j_cfg = _with_attn(ArchConfig, **spec_kw)(**{**TINY, "stages": (
        StageSpec(1, (BlockSpec("attn", "mlp"),)),)})
    with pytest.raises(NotImplementedError, match=what):
        TSparse(t_cfg, None, device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        JSparse(j_cfg, None)
    same = _with_attn(TCB.ArchConfig, softmax_scale=8 ** -0.5)(
        **{**TINY, "stages": (TCB.StageSpec(1, (TCB.BlockSpec("attn",
                                                               "mlp"),)),)})
    task = TTask(arch=same, target_tiles=4)
    bundle = t_make_bundle(task, task.init_params(
        torch.Generator().manual_seed(0)), 0.5)
    assert TSparse(same, bundle, device="cpu").device.type == "cpu"


@pytest.mark.gpu
def test_sparse_model_card_matches_cpu_on_gpu():
    """The same bundle on the card (kernels) and the CPU (plain versions):
    decode and prefill logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    task = TTask(arch=t_arch(), target_tiles=4)
    params = task.init_params(torch.Generator().manual_seed(0))
    bundle = t_make_bundle(task, params, 0.5)
    toks = np.random.default_rng(1).integers(0, 64, (3, 5))
    as_numpy = types.SimpleNamespace(
        params=weights.to_numpy(bundle.params),
        keeps=[None if k is None else k.numpy() for k in bundle.keeps],
        grid=bundle.grid, rho=bundle.rho)
    out = {}
    for dev in ("cpu", "cuda"):
        model = TSparse(t_arch(), weights.bundle_from_numpy(as_numpy,
                                                            device=dev),
                        device=dev)
        out[dev] = _logits(model, toks, 5,
                           lambda a: torch.as_tensor(a, device=dev),
                           lambda n, i: torch.full((n,), i, device=dev))
    for a, b in zip(out["cuda"][0] + [out["cuda"][1]],
                    out["cpu"][0] + [out["cpu"][1]]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
