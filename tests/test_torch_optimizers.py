"""The port's optimizers (``repro_torch.optimizers``) against the JAX
package's (``repro.optimizers``).

The same params and the same sequence of 20 gradients (numpy, from a
seed) go through both packages' ``update``: float64 sgd and momentum
(the reference under ``jax.enable_x64``) at 1e-12; adam, whose state is
float32, at 1e-6; bfloat16 params with every optimizer, where param and
state dtypes must equal the reference's and values lie within one
bfloat16 ulp.  ``clip_by_global_norm`` on a three-leaf tree with one
bfloat16 leaf at 1e-6, its pass-through case bitwise; and the twin of
``tests/test_substrate.py::test_optimizer_minimizes_quadratic``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optimizers as JOPT
from repro_torch import optimizers as TOPT
from repro_torch import weights
from repro_torch.core import pruning

STEPS = 20
SHAPES = {"a": {"w": (4, 6)}, "b": [(3,), (2, 5)]}


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, fn) for v in shapes]
    return fn(shapes)


def _draws(seed=0):
    """Params and STEPS gradients, float64 numpy trees."""
    rng = np.random.default_rng(seed)
    params = _tree(SHAPES, lambda s: rng.normal(size=s))
    grads = [_tree(SHAPES, lambda s: rng.normal(size=s))
             for _ in range(STEPS)]
    return params, grads


def _j(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _t(tree, dtype):
    """A float64 numpy tree in ``dtype`` as the reference gets it: JAX
    without x64 takes float64 input as float32 first."""
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    return pruning.tree_map(lambda a: a.to(dtype),
                            weights.tree_from_numpy(tree, wide, "cpu"))


def _np(x):
    """A leaf of either package as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def _run(name, dtype_j, dtype_t, lr=0.05):
    params, grads = _draws()
    with jax.enable_x64(dtype_j == jnp.float64):
        jo = JOPT.REGISTRY[name]()
        jp = _j(params, dtype_j)
        js = jo.init(jp)
        for g in grads:
            jp, js = jo.update(jp, _j(g, dtype_j), js, lr)
        jp = jax.tree.map(np.asarray, jp)
        js = jax.tree.map(np.asarray, js)
    to = TOPT.REGISTRY[name]()
    tp = _t(params, dtype_t)
    ts = to.init(tp)
    for g in grads:
        tp, ts = to.update(tp, _t(g, dtype_t), ts, lr)
    return jp, js, tp, ts


def _rel(a_leaves, b_leaves):
    worst = 0.0
    for a, b in zip(a_leaves, b_leaves):
        a, b = _np(a), _np(b)
        worst = max(worst, float(np.max(np.abs(a - b)))
                    / max(float(np.max(np.abs(b))), 1e-300))
    return worst


@pytest.mark.parametrize("name,rtol", [("sgd", 1e-12), ("momentum", 1e-12)])
def test_float64_updates_match_reference(name, rtol):
    jp, js, tp, ts = _run(name, jnp.float64, torch.float64)
    assert _rel(pruning.flatten(tp), jax.tree_util.tree_leaves(jp)) <= rtol
    assert _rel(pruning.flatten(ts), jax.tree_util.tree_leaves(js)) <= rtol
    for leaf in pruning.flatten(tp) + pruning.flatten(ts):
        assert leaf.dtype == torch.float64


def test_adam_float32_matches_reference():
    jp, js, tp, ts = _run("adam", jnp.float32, torch.float32)
    assert _rel(pruning.flatten(tp), jax.tree_util.tree_leaves(jp)) <= 1e-6
    for key in ("m", "v"):
        assert _rel(pruning.flatten(ts[key]),
                    jax.tree_util.tree_leaves(js[key])) <= 1e-6
    assert ts["t"].dtype == torch.int32 and int(ts["t"]) == int(js["t"]) \
        == STEPS


def _bf16_ulp(x):
    """One bfloat16 ulp at each |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_bfloat16_params_keep_reference_dtypes(name):
    jp, js, tp, ts = _run(name, jnp.bfloat16, torch.bfloat16)
    for tree_t, tree_j in ((tp, jp), (ts, js)):
        tl, jl = pruning.flatten(tree_t), jax.tree_util.tree_leaves(tree_j)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert str(a.dtype).replace("torch.", "") == str(b.dtype)
            if a.dtype == torch.int32:
                assert int(a) == int(b)
                continue
            ref = _np(b)
            assert np.all(np.abs(_np(a) - ref) <= _bf16_ulp(ref)), name


def _clip_tree(scale):
    rng = np.random.default_rng(3)
    return {"a": (scale * rng.normal(size=(5, 7))).astype(np.float32),
            "b": (scale * rng.normal(size=(11,))).astype(np.float32),
            "c": [(scale * rng.normal(size=(3, 4))).astype(np.float32)]}


def _clip_pair(scale, max_norm):
    tree = _clip_tree(scale)
    jt = {"a": jnp.asarray(tree["a"], jnp.float32),
          "b": jnp.asarray(tree["b"], jnp.bfloat16),
          "c": [jnp.asarray(tree["c"][0], jnp.float32)]}
    tt = weights.tree_from_numpy(tree, torch.float32, "cpu")
    tt["b"] = tt["b"].to(torch.bfloat16)
    return (JOPT.clip_by_global_norm(jt, max_norm),
            TOPT.clip_by_global_norm(tt, max_norm), tt)


def test_clip_by_global_norm_matches_reference():
    jc, tc, _ = _clip_pair(1.0, 1.0)       # norm ~ 8.5: scaled
    for a, b in zip(pruning.flatten(tc), jax.tree_util.tree_leaves(jc)):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    assert _rel(pruning.flatten(tc), jax.tree_util.tree_leaves(jc)) <= 1e-6
    norm = np.sqrt(sum(float(np.sum(_np(g) ** 2))
                       for g in pruning.flatten(tc)))
    assert norm == pytest.approx(1.0, rel=1e-2)   # the bf16 leaf rounds


def test_clip_by_global_norm_pass_through_is_bitwise():
    _, tc, tt = _clip_pair(0.01, 10.0)     # norm ~ 0.085: untouched
    for a, b in zip(pruning.flatten(tc), pruning.flatten(tt)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizer_minimizes_quadratic(name):
    """Twin of tests/test_substrate.py::test_optimizer_minimizes_quadratic."""
    o = TOPT.REGISTRY[name]()
    params = {"x": torch.tensor([3.0, -2.0])}
    state = o.init(params)
    for _ in range(200):
        grads = pruning.tree_map(lambda p: 2 * p, params)   # d/dx x^2
        params, state = o.update(params, grads, state, 0.1)
    assert float(torch.max(torch.abs(params["x"]))) < 1e-2
