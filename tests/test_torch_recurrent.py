"""The recurrent mixers (``models/recurrent.py``): the port against the JAX
package.

Numpy inputs from a seed go through the reference's function and the
port's on the CPU.  In float64 (under ``jax.enable_x64``): the causal
conv and its step at 1e-10; the mLSTM and sLSTM cells at 1e-10 (the
sLSTM's recurrence matrices pass the reference's float32 cast on both
sides); the RG-LRU's recurrence, stepped in order, against the
reference's ``associative_scan`` on the same coefficients at 1e-10.  The
whole mixers and their steps cast their gates to float32 as the
reference does, so in a float64 run they hold at 1e-6 (RG-LRU: the
sigmoids of float32 pre-activations; m/sLSTM: the whole recurrence runs
in float32), and in float32 at 1e-5.  The states' initial values, and
the params' shapes and dtypes (RG-LRU's ``lam`` float32 in a bfloat16
block), equal the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import recurrent as JR
from repro_torch import weights
from repro_torch.core import pruning as TPR
from repro_torch.models import recurrent as TR

F64 = dict(rtol=1e-10, atol=1e-10)
CAST = dict(rtol=1e-6, atol=1e-6)      # float64 runs through float32 gates
F32 = dict(rtol=1e-5, atol=1e-5)
B, S, D, H = 2, 12, 16, 2


def _t(a, dtype=torch.float64):
    return weights.tensor(a, dtype, "cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _dense(rng, d_in, d_out, bias=True, scale=1.0):
    p = {"w": rng.normal(size=(d_in, d_out)) * scale * d_in ** -0.5}
    if bias:
        p["b"] = rng.normal(size=(d_out,)) * scale
    return p


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _tree_close(got, want, tol):
    for a, b in zip(TPR.flatten(got), jax.tree_util.tree_leaves(want)):
        _close(a.detach().numpy(), b, tol)


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 4])
def test_conv1d_and_step_match_reference_float64(width):
    rng = np.random.default_rng(width)
    p = {"w": rng.normal(size=(width, D)), "b": rng.normal(size=D)}
    x = rng.normal(size=(B, S, D))
    buf = rng.normal(size=(B, width - 1, D))
    with jax.enable_x64(True):
        want = JR.conv1d(_j(p), jnp.asarray(x))
        jstate = {"buf": jnp.asarray(buf)}
        jsteps = []
        for t in range(4):
            y, jstate = JR.conv1d_step(_j(p), jnp.asarray(x[:, t:t + 1]),
                                       jstate)
            jsteps.append(np.asarray(y))
    tp = weights.tree_from_numpy(p, torch.float64, "cpu")
    _close(TR.conv1d(tp, _t(x)), want, F64)
    state = {"buf": _t(buf)}
    for t in range(4):
        y, state = TR.conv1d_step(tp, _t(x[:, t:t + 1]), state)
        _close(y, jsteps[t], F64)
    _close(state["buf"], jstate["buf"], F64)
    assert TR.init_conv1d_state(3, D, width, torch.bfloat16)["buf"].shape \
        == (3, width - 1, D)


def test_conv1d_step_sequence_equals_conv1d():
    """From a zero buffer, the steps reproduce the full-sequence conv."""
    rng = np.random.default_rng(9)
    p = weights.tree_from_numpy({"w": rng.normal(size=(4, D)),
                                 "b": rng.normal(size=D)}, torch.float64,
                                "cpu")
    x = _t(rng.normal(size=(B, S, D)))
    state = TR.init_conv1d_state(B, D, 4, torch.float64)
    steps = []
    for t in range(S):
        y, state = TR.conv1d_step(p, x[:, t:t + 1], state)
        steps.append(y)
    _close(torch.cat(steps, 1), TR.conv1d(p, x), F64)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_params(seed, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    return {"lam": rng.normal(size=D) * 3.0,
            "w_r": _dense(rng, D, D, scale=gate_scale),
            "w_i": _dense(rng, D, D, scale=gate_scale)}


def test_rglru_recurrence_matches_associative_scan_float64():
    """The port's in-order recurrence against the reference's
    associative scan over the port's own coefficients (h0 folded into
    step 0 as the reference folds it)."""
    rng = np.random.default_rng(1)
    p = weights.tree_from_numpy(_rglru_params(1), torch.float64, "cpu")
    x = _t(rng.normal(size=(B, S, D)))
    h0 = rng.normal(size=(B, D))
    a, b = TR._rglru_coeffs(p, x)
    assert a.dtype == b.dtype == torch.float64
    b0 = b.numpy().copy()
    b0[:, 0] += a[:, 0].numpy() * h0
    with jax.enable_x64(True):
        _, want = jax.lax.associative_scan(
            lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]),
            (jnp.asarray(a.numpy()), jnp.asarray(b0)), axis=1)
    _close(TR.rglru(p, x, _t(h0)), want, F64)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("gate_scale", [1.0, 12.0])
def test_rglru_matches_reference_float64(with_h0, gate_scale):
    """Large gate pre-activations (scale 12) reach softplus and sigmoid
    far from 0; 1e-6 (the gates' float32 sigmoids)."""
    p = _rglru_params(2, gate_scale)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, D))
    h0 = rng.normal(size=(B, D)) if with_h0 else None
    with jax.enable_x64(True):
        want = JR.rglru(_j(p), jnp.asarray(x),
                        None if h0 is None else jnp.asarray(h0))
        assert want.dtype == jnp.float64
    tp = weights.tree_from_numpy(p, torch.float64, "cpu")
    got = TR.rglru(tp, _t(x), None if h0 is None else _t(h0))
    assert got.dtype == torch.float64
    _close(got, want, CAST)


def test_rglru_step_matches_reference_and_scan():
    p = _rglru_params(4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    pf = jax.tree.map(lambda a: a.astype(np.float32), p)
    jstate = JR.init_rglru_state(B, D)
    tp = weights.tree_from_numpy(pf, torch.float32, "cpu")
    state = TR.init_rglru_state(B, D)
    _tree_close(state, jstate, F64)
    steps = []
    for t in range(S):
        want, jstate = JR.rglru_step(_j(pf), jnp.asarray(x[:, t:t + 1]),
                                     jstate)
        got, state = TR.rglru_step(tp, _t(x[:, t:t + 1], torch.float32),
                                   state)
        _close(got, want, F32)
        _close(state["h"], jstate["h"], F32)
        steps.append(got)
    _close(torch.cat(steps, 1), TR.rglru(tp, _t(x, torch.float32)), F32)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_params(seed, d_in=D, hd=8, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    return {"wq": _dense(rng, d_in, H * hd, bias=False),
            "wk": _dense(rng, d_in, H * hd, bias=False),
            "wv": _dense(rng, d_in, H * hd, bias=False),
            "w_i": _dense(rng, d_in, H, scale=gate_scale),
            "w_f": _dense(rng, d_in, H, scale=gate_scale),
            "w_o": _dense(rng, d_in, H * hd)}


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_mlstm_cell_matches_reference_float64(scale):
    """One stabilised step from a random carry, large gate
    pre-activations included (scale 30: softplus far above torch's
    threshold)."""
    rng = np.random.default_rng(int(scale))
    hd = 8
    carry = (rng.normal(size=(B, H, hd, hd)), rng.normal(size=(B, H, hd)),
             rng.normal(size=(B, H)))
    inp = (rng.normal(size=(B, H, hd)), rng.normal(size=(B, H, hd)),
           rng.normal(size=(B, H, hd)), rng.normal(size=(B, H)) * scale,
           rng.normal(size=(B, H)) * scale)
    with jax.enable_x64(True):
        (jc, jn, jm), jh = JR._mlstm_cell(_j(carry), _j(inp))
    (c, n, m), h = TR._mlstm_cell(tuple(map(_t, carry)),
                                  tuple(map(_t, inp)))
    for got, want in ((c, jc), (n, jn), (m, jm), (h, jh)):
        assert got.dtype == torch.float64
        _close(got, want, F64)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, CAST),
                                       (torch.float32, F32)])
def test_mlstm_and_step_match_reference(dtype, tol):
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    p = jax.tree.map(lambda a: a.astype(np_dt), _mlstm_params(6,
                                                               gate_scale=4.0))
    x = np.random.default_rng(7).normal(size=(B, S, D)).astype(np_dt)
    with jax.enable_x64(dtype == torch.float64):
        want = JR.mlstm(_j(p), jnp.asarray(x))
        jstate = JR.init_mlstm_state(B, H, 8)
        jsteps = []
        for t in range(S):
            y, jstate = JR.mlstm_step(_j(p), jnp.asarray(x[:, t:t + 1]),
                                      jstate)
            jsteps.append(np.asarray(y))
        jstate = jax.tree.map(np.asarray, jstate)
    tp = weights.tree_from_numpy(p, dtype, "cpu")
    got = TR.mlstm(tp, _t(x, dtype))
    assert got.dtype == dtype
    _close(got, want, tol)
    state, steps = TR.init_mlstm_state(B, H, 8), []
    for t in range(S):
        y, state = TR.mlstm_step(tp, _t(x[:, t:t + 1], dtype), state)
        _close(y, jsteps[t], tol)
        steps.append(y)
    _tree_close(state, jstate, tol)
    _close(torch.cat(steps, 1), got, tol)      # the steps are the scan


def test_mlstm_with_a_state_matches_reference():
    """The full-sequence form started from a given (non-zero) state."""
    p = jax.tree.map(lambda a: a.astype(np.float32), _mlstm_params(8))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    state = {"C": rng.normal(size=(B, H, 8, 8)).astype(np.float32),
             "n": rng.normal(size=(B, H, 8)).astype(np.float32),
             "m": rng.normal(size=(B, H)).astype(np.float32)}
    want = JR.mlstm(_j(p), jnp.asarray(x), _j(state))
    got = TR.mlstm(weights.tree_from_numpy(p, device="cpu"),
                   _t(x, torch.float32),
                   weights.tree_from_numpy(state, device="cpu"))
    _close(got, want, F32)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_params(seed, hd=8, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    p = {n: _dense(rng, D, H * hd, scale=gate_scale)
         for n in ("w_z", "w_i", "w_f", "w_o")}
    for n in ("r_z", "r_i", "r_f", "r_o"):
        p[n] = rng.normal(size=(H, hd, hd)) * hd ** -0.5
    return p


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_slstm_cell_matches_reference_float64(scale):
    """One step from a random carry in float64; the recurrence matrices
    rounded to float32 on both sides."""
    rng = np.random.default_rng(10 + int(scale))
    p = _slstm_params(11)
    hd = 8
    carry = (rng.normal(size=(B, H, hd)),
             np.abs(rng.normal(size=(B, H, hd))) + 1e-3,
             rng.normal(size=(B, H, hd)), rng.normal(size=(B, H, hd)))
    inp = tuple(rng.normal(size=(B, H, hd)) * scale for _ in range(4))
    with jax.enable_x64(True):
        jcarry, jh = JR._slstm_cell(_j(p), _j(carry), _j(inp))
    tcarry, h = TR._slstm_cell(weights.tree_from_numpy(p, torch.float64,
                                                       "cpu"),
                               tuple(map(_t, carry)), tuple(map(_t, inp)))
    _close(h, jh, F64)
    for got, want in zip(tcarry, jcarry):
        assert got.dtype == torch.float64
        _close(got, want, F64)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, CAST),
                                       (torch.float32, F32)])
def test_slstm_and_step_match_reference(dtype, tol):
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    p = jax.tree.map(lambda a: a.astype(np_dt), _slstm_params(12,
                                                               gate_scale=3.0))
    x = np.random.default_rng(13).normal(size=(B, S, D)).astype(np_dt)
    with jax.enable_x64(dtype == torch.float64):
        want = JR.slstm(_j(p), jnp.asarray(x))
        jstate = JR.init_slstm_state(B, H, 8)
        jsteps = []
        for t in range(S):
            y, jstate = JR.slstm_step(_j(p), jnp.asarray(x[:, t:t + 1]),
                                      jstate)
            jsteps.append(np.asarray(y))
        jstate = jax.tree.map(np.asarray, jstate)
    tp = weights.tree_from_numpy(p, dtype, "cpu")
    got = TR.slstm(tp, _t(x, dtype))
    assert got.dtype == dtype
    _close(got, want, tol)
    state, steps = TR.init_slstm_state(B, H, 8), []
    for t in range(S):
        y, state = TR.slstm_step(tp, _t(x[:, t:t + 1], dtype), state)
        _close(y, jsteps[t], tol)
        steps.append(y)
    _tree_close(state, jstate, tol)
    _close(torch.cat(steps, 1), got, tol)      # the steps are the scan


def test_slstm_with_a_state_matches_reference():
    p = jax.tree.map(lambda a: a.astype(np.float32), _slstm_params(14))
    rng = np.random.default_rng(14)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    state = {k: rng.normal(size=(B, H, 8)).astype(np.float32)
             for k in ("c", "m", "h")}
    state["n"] = np.abs(state["c"]) + 0.5
    want = JR.slstm(_j(p), jnp.asarray(x), _j(state))
    got = TR.slstm(weights.tree_from_numpy(p, device="cpu"),
                   _t(x, torch.float32),
                   weights.tree_from_numpy(state, device="cpu"))
    _close(got, want, F32)


# ---------------------------------------------------------------------------
# Initial states and params
# ---------------------------------------------------------------------------

def test_initial_states_match_reference():
    for got, want in (
            (TR.init_rglru_state(3, 5), JR.init_rglru_state(3, 5)),
            (TR.init_mlstm_state(3, 2, 4), JR.init_mlstm_state(3, 2, 4)),
            (TR.init_slstm_state(3, 2, 4), JR.init_slstm_state(3, 2, 4))):
        g, w = TPR.flatten(got), jax.tree_util.tree_leaves(want)
        assert [tuple(a.shape) for a in g] == [a.shape for a in w]
        for a, b in zip(g, w):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_shapes_and_dtypes_match_reference(dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    for jfn, tfn in (
            (lambda k: JR.init_conv1d(k, 6, 4, jdt),
             lambda g: TR.init_conv1d(g, 6, 4, tdt)),
            (lambda k: JR.init_rglru(k, 6, jdt),
             lambda g: TR.init_rglru(g, 6, tdt)),
            (lambda k: JR.init_mlstm(k, 6, 2, 4, jdt),
             lambda g: TR.init_mlstm(g, 6, 2, 4, tdt)),
            (lambda k: JR.init_slstm(k, 6, 2, 3, jdt),
             lambda g: TR.init_slstm(g, 6, 2, 3, tdt))):
        want = jax.tree_util.tree_leaves(jax.eval_shape(
            jfn, jax.random.PRNGKey(0)))
        got = TPR.flatten(tfn(gen))
        assert [tuple(a.shape) for a in got] == [a.shape for a in want]
        assert [str(a.dtype).split(".")[-1] for a in got] == \
            [str(a.dtype) for a in want]
    lam = TR.init_rglru(torch.Generator().manual_seed(1), 1000, tdt)["lam"]
    a = torch.sigmoid(lam) ** 8.0        # the decay spans (0.9, 0.999)
    assert lam.dtype == torch.float32
    assert 0.9 <= float(a.min()) and float(a.max()) <= 0.999


def test_softplus_is_exact_above_torchs_threshold():
    x = torch.tensor([-50.0, 0.0, 19.0, 21.0, 40.0], dtype=torch.float64)
    with jax.enable_x64(True):
        want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(TR._softplus(x).numpy(), want, rtol=1e-15,
                               atol=0)
