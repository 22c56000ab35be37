"""The mLSTM and sLSTM scan ops (``kernels/mlstm_scan.py``,
``kernels/slstm_scan.py``) against the JAX package, on the CPU.

The reference's full-sequence mixers run their cell as one
``jax.lax.scan`` (``repro.models.recurrent.mlstm`` / ``slstm``); the
tests run that scan over the reference's own cell on numpy inputs from a
seed, take ``jax.grad`` of <dh, h> with respect to every input (q, k, v
and the gate pre-activations, or the sLSTM's pre-activations and its
recurrence matrices, and the initial state, given or the zero / floor
default), and hold the port's op and its autograd against them: float64
at 1e-10, float32 at 1e-5 (``tests/test_torch_recurrent.py``'s
tolerances; the sLSTM's R gradient in float64 at its 1e-6 for a float32
cast: the reference's cell casts R, so ``jax.grad`` rounds each step's
cotangent of R to float32).  Then ``torch.func.vmap(grad_and_value(...))`` through each
op against a loop over the vmapped dim (the sLSTM with its matrices
vmapped, as a fleet's clients carry their own, and shared), at 1e-10.
Last, one mixer at xlstm-125m's train_4k shape a chip runs (16 rows x
4,096 positions, full widths) traced under ``FakeTensorMode`` with
``launch.cost.CostMode``: a handful of ops forward and backward (the
stepped cell was ~25 a position), the ops' registered flops, and the
forward's saved per-position states counted at the peak.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import recurrent as JR
from repro_torch import weights
from repro_torch.kernels import mlstm_scan as MS
from repro_torch.kernels import slstm_scan as SS
from repro_torch.launch.cost import CostMode
from repro_torch.models import recurrent as TR

F64 = dict(rtol=1e-10, atol=1e-10)
F32 = dict(rtol=1e-5, atol=1e-5)
CAST = dict(rtol=1e-6, atol=1e-6)      # through a float32 cast
B, S, H, HD = 2, 10, 2, 8


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _t(a, dtype):
    return weights.tensor(a, dtype, "cpu")


def _dtype(name):
    return (torch.float64, np.float64) if name == "float64" else \
        (torch.float32, np.float32)


@functools.partial(jax.jit, static_argnums=0)
def _jax_with_vjp(fn, dh, *ins):
    """The reference's h and, by ``jax.vjp``, the gradient of <dh, h> with
    respect to every input (compiled once a function, dtype and shape)."""
    out, vjp = jax.vjp(fn, *ins)
    return out, vjp(dh.astype(out.dtype))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_inputs(rng, with_state, np_dt):
    r = lambda *s: rng.normal(size=s).astype(np_dt)
    ins = [r(B, S, H, HD), r(B, S, H, HD), r(B, S, H, HD),
           r(B, S, H) * 3.0, r(B, S, H) * 3.0 + 1.0]
    if with_state:
        ins += [r(B, H, HD, HD), r(B, H, HD), r(B, H)]
    else:
        ins += [np.zeros((B, H, HD, HD), np_dt), np.zeros((B, H, HD), np_dt),
                np.zeros((B, H), np_dt)]
    return ins


def _jax_mlstm(q, k, v, i_pre, f_pre, c0, n0, m0):
    """The reference's scan (``repro.models.recurrent.mlstm``, its gates
    given) over its own cell."""
    xs = tuple(jnp.moveaxis(t, 1, 0) for t in (q, k, v, i_pre, f_pre))
    _, hs = jax.lax.scan(JR._mlstm_cell, (c0, n0, m0), xs)
    return jnp.moveaxis(hs, 0, 1)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mlstm_scan_and_grads_match_reference(dtype, with_state):
    tdt, np_dt = _dtype(dtype)
    tol = F64 if dtype == "float64" else F32
    rng = np.random.default_rng(1 + with_state)
    ins = _mlstm_inputs(rng, with_state, np_dt)
    dh = rng.normal(size=(B, S, H, HD)).astype(np_dt)
    with jax.enable_x64(dtype == "float64"):
        want, wgrads = _jax_with_vjp(_jax_mlstm, dh, *ins)
    tins = [_t(a, tdt).requires_grad_() for a in ins]
    got = MS.mlstm_scan(*tins)
    assert got.dtype == tdt
    _close(got.detach(), want, tol)
    grads = torch.autograd.grad(got, tins, _t(dh, tdt))
    for g, w in zip(grads, wgrads):
        assert g.dtype == tdt
        _close(g, w, tol)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_inputs(rng, with_state, np_dt):
    r = lambda *s: rng.normal(size=s).astype(np_dt)
    x = r(B, S, H, 4, HD) * 2.0
    # the cell rounds R to float32: draw it there
    rec = (rng.normal(size=(H, 4, HD, HD)) * HD ** -0.5).astype(
        np.float32).astype(np_dt)
    if with_state:
        c0, m0, h0 = r(B, H, HD), r(B, H, HD), r(B, H, HD)
        n0 = np.abs(c0) + 0.5
    else:
        c0 = m0 = h0 = np.zeros((B, H, HD), np_dt)
        n0 = np.full((B, H, HD), 1e-6, np_dt)
    return [x, rec, c0, n0, m0, h0]


def _jax_slstm(x, rec, c0, n0, m0, h0):
    """The reference's scan (``repro.models.recurrent.slstm``, its
    pre-activations given) over its own cell."""
    p = dict(zip(SS.GATES, (rec[:, g] for g in range(4))))
    xs = tuple(jnp.moveaxis(x[:, :, :, g], 1, 0) for g in range(4))
    _, hs = jax.lax.scan(lambda cr, it: JR._slstm_cell(p, cr, it),
                         (c0, n0, m0, h0), xs)
    return jnp.moveaxis(hs, 0, 1)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_slstm_scan_and_grads_match_reference(dtype, with_state):
    tdt, np_dt = _dtype(dtype)
    tol = F64 if dtype == "float64" else F32
    rng = np.random.default_rng(3 + with_state)
    ins = _slstm_inputs(rng, with_state, np_dt)
    dh = rng.normal(size=(B, S, H, HD)).astype(np_dt)
    with jax.enable_x64(dtype == "float64"):
        want, wgrads = _jax_with_vjp(_jax_slstm, dh, *ins)
    tins = [_t(a, tdt).requires_grad_() for a in ins]
    got = SS.slstm_scan(*tins)
    assert got.dtype == tdt
    _close(got.detach(), want, tol)
    grads = torch.autograd.grad(got, tins, _t(dh, tdt))
    for i, (g, w) in enumerate(zip(grads, wgrads)):
        # R's: the reference's cell casts R to float32, so jax.grad rounds
        # each step's cotangent of R to float32 (the op's is exact)
        _close(g, w, CAST if i == 1 and dtype == "float64" else tol)


# ---------------------------------------------------------------------------
# torch.func: vmap of grad_and_value against a loop
# ---------------------------------------------------------------------------

def _vmap_vs_loop(fn, ins, in_dims, seed):
    rng = np.random.default_rng(seed)
    batched = [a for a, d in zip(ins, in_dims) if d is not None][0]
    dh = _t(rng.normal(size=(batched.shape[0], B, S, H, HD)), torch.float64)

    def loss(*a):
        return torch.sum(fn(*a[:-1]) * a[-1])

    argnums = tuple(range(len(ins)))
    grads, vals = torch.func.vmap(
        torch.func.grad_and_value(loss, argnums=argnums),
        in_dims=tuple(in_dims) + (0,))(*ins, dh)
    for c in range(dh.shape[0]):
        one = [a[c] if d is not None else a for a, d in zip(ins, in_dims)]
        want_g, want_v = torch.func.grad_and_value(loss, argnums=argnums)(
            *one, dh[c])
        _close(vals[c], want_v, F64)
        for g, w in zip(grads, want_g):
            _close(g[c], w, F64)


def test_mlstm_scan_under_vmap_of_grad_and_value():
    rng = np.random.default_rng(5)
    draws = [_mlstm_inputs(rng, True, np.float64) for _ in range(3)]
    ins = [_t(np.stack([d[i] for d in draws]), torch.float64)
           for i in range(8)]
    # the state unbatched, as a model's zero state is under vmap
    ins[5], ins[6], ins[7] = ins[5][0], ins[6][0], ins[7][0]
    _vmap_vs_loop(MS.mlstm_scan, ins, [0] * 5 + [None] * 3, 6)


@pytest.mark.parametrize("r_batched", [True, False])
def test_slstm_scan_under_vmap_of_grad_and_value(r_batched):
    rng = np.random.default_rng(7)
    draws = [_slstm_inputs(rng, True, np.float64) for _ in range(3)]
    ins = [_t(np.stack([d[i] for d in draws]), torch.float64)
           for i in range(6)]
    in_dims = [0] * 6
    if not r_batched:
        ins[1], in_dims[1] = ins[1][0], None
    _vmap_vs_loop(SS.slstm_scan, ins, in_dims, 8)


# ---------------------------------------------------------------------------
# The dry run's view: one mixer at the train_4k shape a chip runs
# ---------------------------------------------------------------------------

def _traced(kind: str, s: int):
    """One mixer of xlstm-125m at full width on (16, s), float32, forward
    and backward under FakeTensorMode and CostMode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    d_in, hd = (1536, 384) if kind == "mlstm" else (768, 192)
    with FakeTensorMode():
        gen = torch.Generator().manual_seed(0)
        init = TR.init_mlstm if kind == "mlstm" else TR.init_slstm
        p = init(gen, d_in, 4, hd, torch.float32)
        x = torch.empty((16, s, d_in)).requires_grad_()
        with CostMode() as counted:
            y = getattr(TR, kind)(p, x)
            (g,) = torch.autograd.grad(y.sum(), x)
    assert g.shape == x.shape
    return counted


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_traces_a_constant_number_of_ops(kind):
    """xlstm-125m's mLSTM (d_in 1,536, 4 heads of 384) or sLSTM (d_in
    768, 4 heads of 192) at the train_4k shape a chip runs, (16, 4096):
    the forward and backward trace as many ops as at 1,024 positions, and
    fewer than 500 (the stepped cell dispatched ~25 a position, ~100k);
    the flops hold the scan ops' registered formulas, and the peak the
    forward's saved per-position states."""
    b, s, heads, hd = 16, 4096, 4, (384 if kind == "mlstm" else 192)
    counted = _traced(kind, s)
    assert counted.cost.ops == _traced(kind, 1024).cost.ops
    assert counted.cost.ops < 500, counted.cost.ops
    if kind == "mlstm":
        per = (5 + 15) * hd * hd + (6 + 30) * hd
        # h, n_all, m_all, d_all; C every 32 positions
        saved = 4 * b * heads * (s * (2 * hd + 2) + s // 32 * hd * hd)
    else:
        per = (8 + 8) * hd * hd + (24 + 40) * hd
        saved = 4 * b * s * heads * hd * (4 + 4)     # h, c, n, m; pre
    scan = b * s * heads * per
    by = {k: c.flops for k, c in counted.by_scope.items()}
    assert counted.cost.flops >= scan, by
    assert counted.peak_bytes >= saved
