"""The mLSTM's full-sequence scan (xLSTM's matrix memory), forward and
backward, as custom ops.

Replaces no Pallas kernel: the reference runs the cell
(``repro/models/recurrent.py::_mlstm_cell``) over time as one
``jax.lax.scan`` (``mlstm``), which XLA compiles into one loop.  Stepped
from PyTorch the same cell is ~25 ops a position; here the forward is one
op and the backward one more, whatever the length.

The ops (namespace ``repro_torch``):
  mlstm_scan(q, k, v, i_pre, f_pre, C0, n0, m0)
      -> (h, n_all, m_all, d_all, C_snap)
  mlstm_scan_bwd(dh, <the forward's inputs and outputs>)
      -> (dq, dk, dv, di, df, dC0, dn0, dm0)
q, k, v, h, n_all (B, S, H, hd); i_pre, f_pre, m_all, d_all (B, S, H);
C0 (B, H, hd, hd), n0 (B, H, hd), m0 (B, H).  ``n_all``, ``m_all`` and
``d_all`` are each position's n, m and n . q, and ``C_snap`` (B, H,
ceil(S / 32), hd, hd) the state C at the start of every 32 positions (C0
first): what the backward needs.  Each op has a CPU impl (the plain version: the
stepped cell, and autograd of it recomputed under ``enable_grad``), a CUDA
impl (``csrc/mlstm_scan.cu``: one launch forward, three backward, chunkwise
over the saved states, each op call counted once in ``mlstm_scan.launches``
and ``mlstm_scan_bwd.launches``), a Meta impl
(shapes, for ``FakeTensorMode``), a batching rule that folds a vmapped dim
into the batch rows, and a flop formula for ``launch.cost``.
``mlstm_scan`` is differentiable, also under ``torch.func`` transforms.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

__all__ = ["backward_launch_ms", "mlstm_cell", "mlstm_scan", "mlstm_scan_bwd",
           "mlstm_scan_plain", "softplus"]

MAX_HEAD_DIM = 384          # the kernel's 12 elements a lane
SNAP_EVERY = 32             # positions between saved C states (kChunk)

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("mlstm_scan(Tensor q, Tensor k, Tensor v, Tensor i_pre, "
            "Tensor f_pre, Tensor C0, Tensor n0, Tensor m0) "
            "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define("mlstm_scan_bwd(Tensor dh, Tensor q, Tensor k, Tensor v, "
            "Tensor i_pre, Tensor f_pre, Tensor C0, Tensor n0, Tensor m0, "
            "Tensor h, Tensor n_all, Tensor m_all, Tensor d_all, "
            "Tensor C_snap) "
            "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
            "Tensor)")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without ``F.softplus``'s switch to the identity above
    its threshold (``jax.nn.softplus`` is exact)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mlstm_cell(carry, inp):
    """One stabilised mLSTM step.  carry: (C, n, m); returns (carry, h)."""
    c_mat, n_vec, m = carry
    q, k, v, i_pre, f_pre = inp
    hd = q.shape[-1]
    log_f = -softplus(-f_pre)                 # log sigmoid(f~)
    m_new = torch.maximum(log_f + m, i_pre)
    f_eff = torch.exp(log_f + m - m_new)      # (B,H)
    i_eff = torch.exp(i_pre - m_new)
    k_scaled = k * (hd ** -0.5)
    c_new = f_eff[..., None, None] * c_mat \
        + i_eff[..., None, None] * (v[..., :, None] * k_scaled[..., None, :])
    n_new = f_eff[..., None] * n_vec + i_eff[..., None] * k_scaled
    num = torch.einsum("bhvk,bhk->bhv", c_new, q)
    den = torch.clamp_min(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q)),
                          1.0)
    return (c_new, n_new, m_new), num / den[..., None]


def _stepped(q, k, v, i_pre, f_pre, C0, n0, m0):
    """The cell stepped over time in order: h, each step's n and m, and C
    at the start of every ``SNAP_EVERY`` steps (B, H, chunks, hd, hd)."""
    carry, hs, ns, ms, snaps = (C0, n0, m0), [], [], [], [C0]
    for t in range(q.shape[1]):
        if t and t % SNAP_EVERY == 0:
            snaps.append(carry[0])
        carry, ht = mlstm_cell(carry, (q[:, t], k[:, t], v[:, t],
                                       i_pre[:, t], f_pre[:, t]))
        hs.append(ht)
        ns.append(carry[1])
        ms.append(carry[2])
    return [torch.stack(x, dim=1) for x in (hs, ns, ms)] \
        + [torch.stack(snaps, dim=2)]


def mlstm_scan_plain(q, k, v, i_pre, f_pre, C0, n0, m0) -> torch.Tensor:
    """The plain version: the reference's cell stepped over every position,
    its arithmetic step for step.  Returns h (B, S, H, hd)."""
    return _stepped(q, k, v, i_pre, f_pre, C0, n0, m0)[0]


# ---------------------------------------------------------------------------
# Checks and the kernel's binding
# ---------------------------------------------------------------------------

def _check(q, k, v, i_pre, f_pre, C0, n0, m0) -> None:
    if q.ndim != 4:
        raise ValueError(f"mlstm_scan: q {tuple(q.shape)} is not (B, S, H, "
                         f"hd)")
    b, s, h, hd = q.shape
    want = {"k": (b, s, h, hd), "v": (b, s, h, hd), "i_pre": (b, s, h),
            "f_pre": (b, s, h), "C0": (b, h, hd, hd), "n0": (b, h, hd),
            "m0": (b, h)}
    for name, t in zip(want, (k, v, i_pre, f_pre, C0, n0, m0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"mlstm_scan: {name} {tuple(t.shape)} != "
                             f"{want[name]}")


def _card_operands(what: str, *tensors) -> list:
    """The operands as contiguous float32 on one card, or raise."""
    if not build.on_card(what, *tensors):
        raise ValueError(f"{what}: the CUDA impl got CPU operands")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what} kernel takes float32, got {t.dtype}")
    return [t.contiguous() for t in tensors]


def _lib() -> ctypes.CDLL:
    lib = build.load("mlstm_scan")
    if lib.mlstm_scan_fwd.argtypes is None:
        if lib.mlstm_scan_chunk() != SNAP_EVERY:
            raise RuntimeError(f"mlstm_scan: the kernel saves C every "
                               f"{lib.mlstm_scan_chunk()} steps, not "
                               f"{SNAP_EVERY}")
        if lib.mlstm_scan_max_head_dim() != MAX_HEAD_DIM:
            raise RuntimeError(f"mlstm_scan: the kernel takes head_dim <= "
                               f"{lib.mlstm_scan_max_head_dim()}, not "
                               f"{MAX_HEAD_DIM}")
        lib.mlstm_scan_fwd.argtypes = [ctypes.c_void_p] * 13 \
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        lib.mlstm_scan_fwd.restype = ctypes.c_int
        lib.mlstm_scan_bwd.argtypes = [ctypes.c_void_p] * 23 \
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        lib.mlstm_scan_bwd.restype = ctypes.c_int
        lib.mlstm_scan_bwd_scratch.argtypes = [ctypes.c_int] * 4
        lib.mlstm_scan_bwd_scratch.restype = ctypes.c_longlong
        lib.mlstm_scan_bwd_time_launches.argtypes = [ctypes.c_int]
        lib.mlstm_scan_bwd_launch_ms.argtypes = [
            ctypes.POINTER(ctypes.c_float)]
    return lib


BWD_KERNELS = ("mlstm_bwd_chunk_kernel", "mlstm_bwd_carry_kernel",
               "mlstm_bwd_gate_kernel")


def backward_launch_ms(args, calls: int = 3) -> dict:
    """ms of each of the backward kernel's three launches (CUDA events
    recorded between them), the mean over ``calls`` calls of the op on
    ``args`` (its arguments on the card) after a warm one."""
    lib = _lib()
    op = torch.ops.repro_torch.mlstm_scan_bwd
    op(*args)
    ms, total = (ctypes.c_float * 3)(), [0.0, 0.0, 0.0]
    build.check(lib, lib.mlstm_scan_bwd_time_launches(1), "mlstm_scan_bwd")
    try:
        for _ in range(calls):
            op(*args)
            build.check(lib, lib.mlstm_scan_bwd_launch_ms(ms),
                        "mlstm_scan_bwd timing")
            total = [t + m for t, m in zip(total, ms)]
    finally:
        lib.mlstm_scan_bwd_time_launches(0)
    return {k: t / calls for k, t in zip(BWD_KERNELS, total)}


def _dims(q) -> tuple:
    b, s, h, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"mlstm_scan kernel: head_dim {hd} (max "
                         f"{MAX_HEAD_DIM})")
    if b * h > 65535:
        raise ValueError(f"mlstm_scan kernel: B * H = {b * h} (max 65535)")
    return b, s, h, hd


# ---------------------------------------------------------------------------
# The forward op
# ---------------------------------------------------------------------------

def _fwd_cpu(q, k, v, i_pre, f_pre, C0, n0, m0):
    h, n_all, m_all, snap = _stepped(q, k, v, i_pre, f_pre, C0, n0, m0)
    return h, n_all, m_all, torch.einsum("bshk,bshk->bsh", n_all, q), snap


def _fwd_cuda(q, k, v, i_pre, f_pre, C0, n0, m0):
    ops = _card_operands("mlstm_scan", q, k, v, i_pre, f_pre, C0, n0, m0)
    b, s, h, hd = _dims(q)
    out = (torch.empty_like(ops[0]), torch.empty_like(ops[0]),
           torch.empty_like(ops[3]), torch.empty_like(ops[3]),
           ops[5].new_empty(_snap_shape(q)))
    if out[0].numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.mlstm_scan_fwd(*map(build.ptr, ops + list(out)), b, s, h, hd,
                              hd ** -0.5, ctypes.c_void_p(stream))
    build.check(lib, code, "mlstm_scan")
    mlstm_scan.launches += 1
    return out


def _snap_shape(q) -> tuple:
    b, s, h, hd = q.shape
    return (b, h, -(-s // SNAP_EVERY), hd, hd)


def _fwd_meta(q, k, v, i_pre, f_pre, C0, n0, m0):
    return (torch.empty_like(q), torch.empty_like(q), torch.empty_like(i_pre),
            torch.empty_like(i_pre), C0.new_empty(_snap_shape(q)))


# ---------------------------------------------------------------------------
# The backward op
# ---------------------------------------------------------------------------

def _bwd_cpu(dh, q, k, v, i_pre, f_pre, C0, n0, m0, h, n_all, m_all, d_all,
             C_snap):
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in
               (q, k, v, i_pre, f_pre, C0, n0, m0)]
        out = mlstm_scan_plain(*ins)
        return torch.autograd.grad(out, ins, dh)


def _bwd_cuda(dh, q, k, v, i_pre, f_pre, C0, n0, m0, h, n_all, m_all, d_all,
              C_snap):
    ops = _card_operands("mlstm_scan_bwd", dh, q, k, v, i_pre, f_pre, C0,
                         n0, m0, h, n_all, m_all, d_all, C_snap)
    b, s, hh, hd = _dims(q)
    out = tuple(torch.empty_like(ops[i]) for i in (1, 2, 3, 4, 5, 6, 7, 8))
    if ops[0].numel() == 0:
        return tuple(o.zero_() for o in out)
    lib = _lib()
    # the chunks' scalars and the carry's per-tile parts: 6 + 3 ceil(hd /
    # 96) floats a position and head (4.8 MB at (4, 4096, 4) of 384)
    scratch = dh.new_empty((lib.mlstm_scan_bwd_scratch(b, s, hh, hd),))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.mlstm_scan_bwd(*map(build.ptr, ops + list(out) + [scratch]),
                              b, s, hh, hd, hd ** -0.5,
                              ctypes.c_void_p(stream))
    build.check(lib, code, "mlstm_scan_bwd")
    mlstm_scan_bwd.launches += 1
    return out


def _bwd_meta(dh, q, k, v, i_pre, f_pre, C0, n0, m0, h, n_all, m_all, d_all,
              C_snap):
    return tuple(torch.empty_like(t) for t in
                 (q, k, v, i_pre, f_pre, C0, n0, m0))


for _name, _impls in (("mlstm_scan", (_fwd_cpu, _fwd_cuda, _fwd_meta)),
                      ("mlstm_scan_bwd", (_bwd_cpu, _bwd_cuda, _bwd_meta))):
    for _key, _fn in zip(("CPU", "CUDA", "Meta"), _impls):
        _LIB.impl(_name, _fn, _key)


# ---------------------------------------------------------------------------
# Batching: a vmapped dim folds into the batch rows, which are independent
# ---------------------------------------------------------------------------

def fold_rows(args, in_dims, size: int, shared: int = -1) -> list:
    """Each tensor of ``args`` but ``args[shared]`` (an unbatched weight,
    left as it is) with its vmapped dim (``in_dims``; None: unbatched,
    expanded) moved in front of its batch rows and merged with them:
    (size * B, ...)."""
    out = []
    for i, (x, d) in enumerate(zip(args, in_dims)):
        if i == shared:
            out.append(x)
            continue
        x = x.expand((size,) + x.shape) if d is None else x.movedim(d, 0)
        out.append(x.reshape((size * x.shape[1],) + x.shape[2:]))
    return out


def unfold_rows(outs, size: int) -> tuple:
    """The inverse of ``fold_rows`` on each output, with its out_dims."""
    return (tuple(o.reshape((size, -1) + o.shape[1:]) for o in outs),
            (0,) * len(outs))


def _vmap_rule(op):
    def rule(info, in_dims, *args):
        return unfold_rows(op(*fold_rows(args, in_dims, info.batch_size)),
                           info.batch_size)
    return rule


torch.library.register_vmap("repro_torch::mlstm_scan",
                            _vmap_rule(torch.ops.repro_torch.mlstm_scan))
torch.library.register_vmap("repro_torch::mlstm_scan_bwd",
                            _vmap_rule(torch.ops.repro_torch.mlstm_scan_bwd))


# ---------------------------------------------------------------------------
# Flops (``launch.cost`` reads ``flop_registry``): what the kernels do, ~5
# hd^2 a position and head forward (C's update and C q), three such passes
# backward (dq, dv, dk)
# ---------------------------------------------------------------------------

@register_flop_formula(torch.ops.repro_torch.mlstm_scan)
def _fwd_flops(q_shape, *args, out_shape=None, **kwargs) -> int:
    b, s, h, hd = q_shape
    return b * s * h * (5 * hd * hd + 6 * hd)


@register_flop_formula(torch.ops.repro_torch.mlstm_scan_bwd)
def _bwd_flops(dh_shape, *args, out_shape=None, **kwargs) -> int:
    b, s, h, hd = dh_shape
    return b * s * h * (15 * hd * hd + 30 * hd)


# ---------------------------------------------------------------------------
# The differentiable entry
# ---------------------------------------------------------------------------

class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, i_pre, f_pre, C0, n0, m0):
        return torch.ops.repro_torch.mlstm_scan(q, k, v, i_pre, f_pre, C0,
                                                n0, m0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, dh, *_):
        return mlstm_scan_bwd(dh, *ctx.saved_tensors)

    @staticmethod
    def vmap(info, in_dims, *args):
        return unfold_rows(_Scan.apply(*fold_rows(args, in_dims,
                                                  info.batch_size)),
                           info.batch_size)


def mlstm_scan(q, k, v, i_pre, f_pre, C0, n0, m0) -> torch.Tensor:
    """h (B, S, H, hd) of the cell over every position from (C0, n0, m0),
    differentiable in every input.  The operands are promoted to one
    dtype, as the stepped cell promotes them; the card's kernel takes
    float32."""
    ins = (q, k, v, i_pre, f_pre, C0, n0, m0)
    _check(*ins)
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in ins])
    return _Scan.apply(*(t.to(dtype) for t in ins))[0]


mlstm_scan.launches = 0


def mlstm_scan_bwd(dh, *saved):
    """The backward op on the forward's inputs and outputs (``saved``):
    (dq, dk, dv, di, df, dC0, dn0, dm0), the gradients of <dh, h>."""
    return torch.ops.repro_torch.mlstm_scan_bwd(dh, *saved)


mlstm_scan_bwd.launches = 0
