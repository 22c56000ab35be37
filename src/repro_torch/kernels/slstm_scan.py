"""The sLSTM's full-sequence scan (xLSTM's scalar memory with head-wise
recurrence), forward and backward, as custom ops.

Replaces no Pallas kernel: the reference runs the cell
(``repro/models/recurrent.py::_slstm_cell``) over time as one
``jax.lax.scan`` (``slstm``), which XLA compiles into one loop.  Stepped
from PyTorch the same cell is ~30 ops a position; here each direction is
one op, whatever the length.

The ops (namespace ``repro_torch``):
  slstm_scan(x, R, c0, n0, m0, h0) -> (h, c_all, n_all, m_all, pre)
  slstm_scan_bwd(dh, x, R, c0, n0, m0, h0, c_all, n_all, m_all, pre)
      -> (dx, dc0, dn0, dm0, dh0)
x, pre (B, S, H, 4, hd): the gates' input pre-activations (z, i, f, o)
and each position's full pre-activation (x plus h_{t-1} R); R (H, 4, hd,
hd), the four recurrence matrices; c0, n0, m0, h0 (B, H, hd); h, c_all,
n_all, m_all (B, S, H, hd).  dx is the gradient of every pre-activation;
R's gradient, sum over rows and positions of h_{t-1}^T dx, is a plain
product that ``slstm_scan``'s backward forms outside the op.  Each op has
a CPU impl (the plain version: the stepped cell, and autograd of it
recomputed under ``enable_grad``), a CUDA impl (``csrc/slstm_scan.cu``,
one launch each, the forward a thread-block cluster a (b, h) with R on
chip in its CTAs' shared memory and registers, counted in
``slstm_scan.launches`` and
``slstm_scan_bwd.launches``), a Meta impl, a batching rule and a flop
formula.  A vmapped dim folds into the batch rows, or, where R is vmapped
too (per-client weights), into the heads.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.mlstm_scan import (_LIB, _card_operands, fold_rows,
                                            softplus, unfold_rows)

__all__ = ["cluster_info", "slstm_cell", "slstm_scan", "slstm_scan_bwd",
           "slstm_scan_plain"]

MAX_HEAD_DIM = 256          # the backward's 4 hd threads a CTA
GATES = ("r_z", "r_i", "r_f", "r_o")

_LIB.define("slstm_scan(Tensor x, Tensor R, Tensor c0, Tensor n0, Tensor m0, "
            "Tensor h0) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define("slstm_scan_bwd(Tensor dh, Tensor x, Tensor R, Tensor c0, "
            "Tensor n0, Tensor m0, Tensor h0, Tensor c_all, Tensor n_all, "
            "Tensor m_all, Tensor pre) "
            "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")


def slstm_cell(p: dict, carry, inp):
    """carry: (c, n, m, h) each (B,H,hd); inp: pre-activations (B,H,hd) x4.
    The recurrence matrices are rounded to float32, then take h's dtype
    (JAX's promotion of a float32 operand)."""
    c, n, m, h = carry
    z_pre, i_pre, f_pre, o_pre = inp

    def rec(r, h_):
        return torch.einsum("bhk,hkv->bhv", h_, r.to(torch.float32)
                            .to(h_.dtype))

    z = torch.tanh(z_pre + rec(p["r_z"], h))
    i_t = i_pre + rec(p["r_i"], h)
    f_t = f_pre + rec(p["r_f"], h)
    o = torch.sigmoid(o_pre + rec(p["r_o"], h))
    log_f = -softplus(-f_t)
    m_new = torch.maximum(log_f + m, i_t)
    f_eff = torch.exp(log_f + m - m_new)
    i_eff = torch.exp(i_t - m_new)
    c_new = f_eff * c + i_eff * z
    n_new = torch.clamp_min(f_eff * n + i_eff, 1e-6)
    h_new = o * c_new / n_new
    return (c_new, n_new, m_new, h_new), h_new


def _stepped(x, R, c0, n0, m0, h0):
    """The cell stepped over time in order: h and each step's c, n, m."""
    p = dict(zip(GATES, R.unbind(1)))
    carry, out = (c0, n0, m0, h0), ([], [], [], [])
    for t in range(x.shape[1]):
        carry, _ = slstm_cell(p, carry, x[:, t].unbind(2))
        for acc, val in zip(out, (carry[3], carry[0], carry[1], carry[2])):
            acc.append(val)
    return [torch.stack(a, dim=1) for a in out]


def slstm_scan_plain(x, R, c0, n0, m0, h0) -> torch.Tensor:
    """The plain version: the reference's cell stepped over every position,
    its arithmetic step for step.  Returns h (B, S, H, hd)."""
    return _stepped(x, R, c0, n0, m0, h0)[0]


def _check(x, R, c0, n0, m0, h0) -> None:
    if x.ndim != 5 or x.shape[3] != 4:
        raise ValueError(f"slstm_scan: x {tuple(x.shape)} is not (B, S, H, "
                         f"4, hd)")
    b, _, h, _, hd = x.shape
    if tuple(R.shape) != (h, 4, hd, hd):
        raise ValueError(f"slstm_scan: R {tuple(R.shape)} != "
                         f"{(h, 4, hd, hd)}")
    for name, t in zip(("c0", "n0", "m0", "h0"), (c0, n0, m0, h0)):
        if tuple(t.shape) != (b, h, hd):
            raise ValueError(f"slstm_scan: {name} {tuple(t.shape)} != "
                             f"{(b, h, hd)}")


def _lib() -> ctypes.CDLL:
    lib = build.load("slstm_scan")
    if lib.slstm_scan_fwd.argtypes is None:
        if lib.slstm_scan_max_head_dim() != MAX_HEAD_DIM:
            raise RuntimeError(f"slstm_scan: the kernel takes head_dim <= "
                               f"{lib.slstm_scan_max_head_dim()}, not "
                               f"{MAX_HEAD_DIM}")
        lib.slstm_scan_fwd.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.slstm_scan_fwd.restype = ctypes.c_int
        lib.slstm_scan_bwd.argtypes = [ctypes.c_void_p] * 14 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.slstm_scan_bwd.restype = ctypes.c_int
        lib.slstm_scan_fwd_cluster.argtypes = [ctypes.c_int] \
            + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.slstm_scan_fwd_cluster.restype = ctypes.c_int
    return lib


def cluster_info(hd: int) -> dict:
    """The forward kernel's launch at head dim ``hd`` on the current card:
    CTAs a cluster (a (b, h) each), dynamic shared memory a CTA in bytes,
    and ``cudaOccupancyMaxActiveClusters``, the clusters the card runs at
    once."""
    lib = _lib()
    vals = [ctypes.c_int(0) for _ in range(3)]
    build.check(lib, lib.slstm_scan_fwd_cluster(
        hd, *map(ctypes.byref, vals)), "slstm_scan cluster query")
    return dict(zip(("cluster", "smem_bytes", "max_active_clusters"),
                    (v.value for v in vals)))


def _dims(x) -> tuple:
    b, s, h, _, hd = x.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"slstm_scan kernel: head_dim {hd} (max "
                         f"{MAX_HEAD_DIM})")
    return b, s, h, hd


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------

def _fwd_cpu(x, R, c0, n0, m0, h0):
    h, c_all, n_all, m_all = _stepped(x, R, c0, n0, m0, h0)
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    pre = x + torch.einsum("bshk,hgkv->bshgv", h_prev, R)
    return h, c_all, n_all, m_all, pre


def _fwd_cuda(x, R, c0, n0, m0, h0):
    ops = _card_operands("slstm_scan", x, R, c0, n0, m0, h0)
    b, s, hh, hd = _dims(x)
    state = torch.empty((b, s, hh, hd), dtype=torch.float32, device=x.device)
    out = (state, torch.empty_like(state), torch.empty_like(state),
           torch.empty_like(state), torch.empty_like(ops[0]))
    if state.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.slstm_scan_fwd(*map(build.ptr, ops + list(out)), b, s, hh, hd,
                              ctypes.c_void_p(stream))
    build.check(lib, code, "slstm_scan")
    slstm_scan.launches += 1
    return out


def _fwd_meta(x, R, c0, n0, m0, h0):
    state = x.new_empty(x.shape[:3] + x.shape[4:])
    return (state, torch.empty_like(state), torch.empty_like(state),
            torch.empty_like(state), torch.empty_like(x))


def _bwd_cpu(dh, x, R, c0, n0, m0, h0, c_all, n_all, m_all, pre):
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, c0, n0, m0, h0)]
        out = slstm_scan_plain(ins[0], R, *ins[1:])
        return torch.autograd.grad(out, ins, dh)


def _bwd_cuda(dh, x, R, c0, n0, m0, h0, c_all, n_all, m_all, pre):
    rt = R.transpose(-1, -2)
    ops = _card_operands("slstm_scan_bwd", dh, rt, c0, n0, m0, c_all, n_all,
                         m_all, pre)
    b, s, hh, hd = _dims(x)
    out = (torch.empty_like(ops[-1]),) + tuple(
        torch.empty_like(ops[2]) for _ in range(4))
    if ops[0].numel() == 0:
        return tuple(o.zero_() for o in out)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.slstm_scan_bwd(*map(build.ptr, ops + list(out)), b, s, hh, hd,
                              ctypes.c_void_p(stream))
    build.check(lib, code, "slstm_scan_bwd")
    slstm_scan_bwd.launches += 1
    return out


def _bwd_meta(dh, x, R, c0, n0, m0, h0, c_all, n_all, m_all, pre):
    return (torch.empty_like(x),) + tuple(torch.empty_like(t) for t in
                                          (c0, n0, m0, h0))


for _name, _impls in (("slstm_scan", (_fwd_cpu, _fwd_cuda, _fwd_meta)),
                      ("slstm_scan_bwd", (_bwd_cpu, _bwd_cuda, _bwd_meta))):
    for _key, _fn in zip(("CPU", "CUDA", "Meta"), _impls):
        _LIB.impl(_name, _fn, _key)


# ---------------------------------------------------------------------------
# Batching.  With R unbatched the vmapped dim folds into the batch rows;
# with R vmapped (each client's own weights) it folds into the heads:
# (V, B, S, H, ...) -> (B, S, V * H, ...), R (V, H, ...) -> (V * H, ...).
# ---------------------------------------------------------------------------

def _fold_heads(args, in_dims, size: int, r_at: int) -> list:
    out = []
    for i, (x, d) in enumerate(zip(args, in_dims)):
        x = x.expand((size,) + x.shape) if d is None else x.movedim(d, 0)
        if i == r_at:                      # (V, H, ...) -> (V H, ...)
            out.append(x.reshape((-1,) + x.shape[2:]))
        elif x.ndim == 4:                  # a state (V, B, H, hd)
            out.append(x.movedim(0, 1).reshape(
                (x.shape[1], -1) + x.shape[3:]))
        else:                              # (V, B, S, H, ...)
            out.append(x.movedim(0, 2).reshape(
                x.shape[1:3] + (-1,) + x.shape[4:]))
    return out


def _unfold_heads(outs, size: int) -> tuple:
    back, dims = [], []
    for o in outs:
        at = 1 if o.ndim == 3 else 2       # the heads' dim
        back.append(o.reshape(o.shape[:at] + (size, -1) + o.shape[at + 1:]))
        dims.append(at)
    return tuple(back), tuple(dims)


def _vmap_rule(op, r_at: int):
    def rule(info, in_dims, *args):
        if in_dims[r_at] is None:
            return unfold_rows(op(*fold_rows(args, in_dims,
                                             info.batch_size, r_at)),
                               info.batch_size)
        return _unfold_heads(op(*_fold_heads(args, in_dims, info.batch_size,
                                             r_at)), info.batch_size)
    return rule


torch.library.register_vmap("repro_torch::slstm_scan",
                            _vmap_rule(torch.ops.repro_torch.slstm_scan, 1))
torch.library.register_vmap("repro_torch::slstm_scan_bwd",
                            _vmap_rule(torch.ops.repro_torch.slstm_scan_bwd,
                                       2))


# ---------------------------------------------------------------------------
# Flops: the four products with R (8 hd^2 a position and head) and the
# cell; backward the products with R^T and the cell
# ---------------------------------------------------------------------------

@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _fwd_flops(x_shape, *args, out_shape=None, **kwargs) -> int:
    b, s, h, _, hd = x_shape
    return b * s * h * (8 * hd * hd + 24 * hd)


@register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
def _bwd_flops(dh_shape, *args, out_shape=None, **kwargs) -> int:
    b, s, h, hd = dh_shape
    return b * s * h * (8 * hd * hd + 40 * hd)


# ---------------------------------------------------------------------------
# The differentiable entry
# ---------------------------------------------------------------------------

class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(x, R, c0, n0, m0, h0):
        return torch.ops.repro_torch.slstm_scan(x, R, c0, n0, m0, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, dh, *_):
        x, R, c0, n0, m0, h0, h, c_all, n_all, m_all, pre = ctx.saved_tensors
        dx, dc0, dn0, dm0, dh0 = slstm_scan_bwd(dh, x, R, c0, n0, m0, h0,
                                                c_all, n_all, m_all, pre)
        h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
        d_r = torch.einsum("bshk,bshgv->hgkv", h_prev, dx)
        return dx, d_r, dc0, dn0, dm0, dh0

    @staticmethod
    def vmap(info, in_dims, *args):
        if in_dims[1] is None:
            return unfold_rows(_Scan.apply(*fold_rows(args, in_dims,
                                                      info.batch_size, 1)),
                               info.batch_size)
        return _unfold_heads(_Scan.apply(*_fold_heads(args, in_dims,
                                                      info.batch_size, 1)),
                             info.batch_size)


def slstm_scan(x, R, c0, n0, m0, h0) -> torch.Tensor:
    """h (B, S, H, hd) of the cell over every position from (c0, n0, m0,
    h0), differentiable in every input.  The operands are promoted to
    one dtype, as the stepped cell promotes them; the card's kernel takes
    float32."""
    ins = (x, R, c0, n0, m0, h0)
    _check(*ins)
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in ins])
    return _Scan.apply(*(t.to(dtype) for t in ins))[0]


slstm_scan.launches = 0


def slstm_scan_bwd(dh, x, R, c0, n0, m0, h0, c_all, n_all, m_all, pre):
    """The backward op on the forward's inputs and saved outputs: (dx,
    dc0, dn0, dm0, dh0), the gradients of <dh, h> but R's."""
    return torch.ops.repro_torch.slstm_scan_bwd(dh, x, R, c0, n0, m0, h0,
                                                c_all, n_all, m_all, pre)


slstm_scan_bwd.launches = 0
