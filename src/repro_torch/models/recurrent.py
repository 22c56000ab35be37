"""Recurrent sequence mixers (the port of ``repro.models.recurrent``):
RG-LRU (Griffin / RecurrentGemma), mLSTM and sLSTM (xLSTM), and the
causal depthwise conv they use.

The RG-LRU's linear recurrence runs, as in the reference, as an
associative scan of the combine ``(a_l a_r, a_r b_l + b_r)`` with ``h0``
folded into step 0 (``_linear_scan``: 2 log2(S) levels of whole-tensor
ops, not a step a position); it associates its products differently from
the reference's ``associative_scan`` (float32 1e-5, float64 1e-10).  The
(s/m)LSTM cells, ``lax.scan`` in the reference, run over the whole
sequence as one op each way (``kernels.mlstm_scan`` / ``kernels.
slstm_scan``): on the CPU the cell stepped in order, the reference's
arithmetic step for step, and its autograd; on the card a CUDA kernel a
direction.  Gates and states are float32 as in the reference, and mixed
operands promote as JAX promotes them.

State conventions (decode), the reference's:
  conv:   {"buf": (B, width-1, d)}         — last width-1 inputs
  rglru:  {"h": (B, d)}
  mlstm:  {"C": (B,H,hd,hd), "n": (B,H,hd), "m": (B,H)}
  slstm:  {"c": (B,H,hd), "n": (B,H,hd), "m": (B,H,hd), "h": (B,H,hd)}
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import mlstm_scan as MS
from repro_torch.kernels import slstm_scan as SS
from repro_torch.models import layers as L
from repro_torch.models import sharding as S

_SQRT_EPS = 1e-8
_RG_C = 8.0

# the cells and softplus live beside the scans' kernels
_softplus = MS.softplus
_mlstm_cell = MS.mlstm_cell
_slstm_cell = SS.slstm_cell


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Causal depthwise conv1d
# ---------------------------------------------------------------------------

def init_conv1d(generator, d: int, width: int, dtype) -> dict:
    w = L._normal(generator, (width, d)) * (width * d) ** -0.5
    return {"w": w.to(dtype),
            "b": torch.zeros((d,), dtype=dtype, device=L.device_of(generator))}


def conv1d(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, d)."""
    width, s = p["w"].shape[0], x.shape[1]
    pad = S.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:s, :] * p["w"][0].to(x.dtype)
    for i in range(1, width):
        out = out + pad[:, i:i + s, :] * p["w"][i].to(x.dtype)
    return out + p["b"].to(x.dtype)


def init_conv1d_state(batch: int, d: int, width: int, dtype,
                      device=None) -> dict:
    return {"buf": torch.zeros((batch, width - 1, d), dtype=dtype,
                               device=device)}


def conv1d_step(p: dict, x: torch.Tensor, state: dict
                ) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d)."""
    width = p["w"].shape[0]
    hist = torch.cat([state["buf"], x.to(state["buf"].dtype)], dim=1)
    out = hist[:, 0:1, :] * p["w"][0].to(x.dtype)
    for i in range(1, width):
        out = out + hist[:, i:i + 1, :] * p["w"][i].to(x.dtype)
    return out + p["b"].to(x.dtype), {"buf": hist[:, 1:, :]}


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def init_rglru(generator, d: int, dtype) -> dict:
    """``lam`` stays float32 whatever ``dtype``, as in the reference; it
    is drawn so that a = sigmoid(lam)^c spans slow and fast decay."""
    u = 0.9 + 0.099 * torch.rand((d,), generator=generator,
                                 device=L.device_of(generator))
    lam = torch.log(u ** (1.0 / 8.0) / (1.0 - u ** (1.0 / 8.0)))
    return {"lam": lam.to(torch.float32),
            "w_r": L.dense_bias_init(generator, d, d, dtype),
            "w_i": L.dense_bias_init(generator, d, d, dtype)}


def _rglru_coeffs(p: dict, x: torch.Tensor):
    r = torch.sigmoid(_f32(L.dense(p["w_r"], x)))
    i = torch.sigmoid(_f32(L.dense(p["w_i"], x)))
    log_a = -_RG_C * r * _softplus(p["lam"])          # (B,S,d) <= 0
    a = torch.exp(log_a)
    gated_x = i * _f32(x)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), _SQRT_EPS)) \
        * gated_x
    return a, b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, as a
    work-efficient associative scan: adjacent pairs combine into one step
    (``(a_0 a_1, a_1 b_0 + b_1)``), the half-length scan gives h at the
    odd positions, and one more step each gives the even ones.  An odd
    length is padded with the identity step (a = 1, b = 0)."""
    n = a.shape[1]
    if n == 1:
        return b
    if n % 2:
        a = F.pad(a, (0, 0, 0, 1), value=1.0)
        b = F.pad(b, (0, 0, 0, 1))
    a0, a1 = a.unflatten(1, (-1, 2)).unbind(2)
    b0, b1 = b.unflatten(1, (-1, 2)).unbind(2)
    odd = _linear_scan(a0 * a1, torch.addcmul(b1, a1, b0))
    # h at 2i: a_2i h_(2i-1) + b_2i, with h_(-1) = 0
    even = torch.addcmul(b0, a0, F.pad(odd[:, :-1], (0, 0, 1, 0)))
    h = torch.stack([even, odd], dim=2).flatten(1, 2)
    return h[:, :n] if n % 2 else h


def rglru(p: dict, x: torch.Tensor, h0: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Full-sequence RG-LRU, h_t = a_t h_{t-1} + b_t from ``h0`` (0 if
    None), as an associative scan (``_linear_scan``) on each rank's batch
    rows, split over the mesh dims that hold them whole.  x: (B,S,d)."""
    a, b = _rglru_coeffs(p, x)

    def scan(a, b, *h0):
        if h0:
            # fold the initial state into the first step: h_0 = a_0 h0 + b_0
            b = torch.cat([a[:, :1] * h0[0].to(b.dtype)[:, None] + b[:, :1],
                           b[:, 1:]], dim=1)
        return _linear_scan(a, b)

    return S.batch_local(scan, a, b, *(() if h0 is None else (h0,))
                         ).to(x.dtype)


def init_rglru_state(batch: int, d: int, device=None) -> dict:
    return {"h": _zeros((batch, d), device)}


def rglru_step(p: dict, x: torch.Tensor, state: dict
               ) -> tuple[torch.Tensor, dict]:
    """x: (B,1,d)."""
    a, b = _rglru_coeffs(p, x)
    h = a[:, 0] * state["h"] + b[:, 0]
    return h[:, None, :].to(x.dtype), {"h": h}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, exponential gating) — xLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator, d_in: int, num_heads: int, head_dim: int,
               dtype) -> dict:
    d_qkv = num_heads * head_dim
    return {
        "wq": L.dense_init(generator, d_in, d_qkv, dtype),
        "wk": L.dense_init(generator, d_in, d_qkv, dtype),
        "wv": L.dense_init(generator, d_in, d_qkv, dtype),
        "w_i": L.dense_bias_init(generator, d_in, num_heads, dtype),
        "w_f": L.dense_bias_init(generator, d_in, num_heads, dtype),
        "w_o": L.dense_bias_init(generator, d_in, d_qkv, dtype),
    }


def _mlstm_gates(p: dict, x: torch.Tensor):
    """Pre-activation gates (float32): i~, f~ (B,S,H); q,k,v (B,S,H,hd);
    the output gate o (B,S,H*hd)."""
    h = p["w_i"]["w"].shape[1]

    def heads(t):
        return _f32(S.split_heads(t, h))

    q = heads(L.dense(p["wq"], x))
    k = heads(L.dense(p["wk"], x))
    v = heads(L.dense(p["wv"], x))
    i_pre = _f32(L.dense(p["w_i"], x))
    f_pre = _f32(L.dense(p["w_f"], x))
    o = torch.sigmoid(_f32(L.dense(p["w_o"], x)))
    return q, k, v, i_pre, f_pre, o


def mlstm(p: dict, x: torch.Tensor, state: Optional[dict] = None
          ) -> torch.Tensor:
    """Full-sequence mLSTM, one scan op over every position (on each
    rank's batch rows, split over the mesh dims that hold them whole).
    x: (B,S,d_in)."""
    q, k, v, i_pre, f_pre, o = _mlstm_gates(p, x)
    b, s, h, hd = q.shape
    if state is None:
        state = init_mlstm_state(b, h, hd, x.device)
    hs = S.batch_local(MS.mlstm_scan, q, k, v, i_pre, f_pre, state["C"],
                       state["n"], state["m"])   # (B,S,H,hd)
    out = S.merge_heads(S.split_heads(o, h) * hs)
    return out.to(x.dtype)


def init_mlstm_state(batch: int, num_heads: int, head_dim: int,
                     device=None) -> dict:
    return {"C": _zeros((batch, num_heads, head_dim, head_dim), device),
            "n": _zeros((batch, num_heads, head_dim), device),
            "m": _zeros((batch, num_heads), device)}


def mlstm_step(p: dict, x: torch.Tensor, state: dict
               ) -> tuple[torch.Tensor, dict]:
    """x: (B,1,d_in)."""
    q, k, v, i_pre, f_pre, o = _mlstm_gates(p, x)
    carry = (state["C"], state["n"], state["m"])
    (c_new, n_new, m_new), h = _mlstm_cell(
        carry, (q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0]))
    out = S.merge_heads(S.split_heads(o[:, :1], q.shape[2]) * h[:, None])
    return out.to(x.dtype), {"C": c_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, exponential gating, head-wise recurrence) — xLSTM
# ---------------------------------------------------------------------------

def init_slstm(generator, d_in: int, num_heads: int, head_dim: int,
               dtype) -> dict:
    d_h = num_heads * head_dim
    p = {name: L.dense_bias_init(generator, d_in, d_h, dtype)
         for name in ("w_z", "w_i", "w_f", "w_o")}
    for name in ("r_z", "r_i", "r_f", "r_o"):
        p[name] = (L._normal(generator, (num_heads, head_dim, head_dim))
                   * head_dim ** -0.5).to(dtype)
    return p


def _slstm_pre(p: dict, x: torch.Tensor, num_heads: int):
    def heads(t):
        return _f32(S.split_heads(t, num_heads))
    return tuple(heads(L.dense(p[name], x))
                 for name in ("w_z", "w_i", "w_f", "w_o"))


def slstm(p: dict, x: torch.Tensor, state: Optional[dict] = None
          ) -> torch.Tensor:
    """Full-sequence sLSTM, one scan op over every position (on each
    rank's batch rows, split over the mesh dims that hold them whole; the
    recurrence matrices, rounded to float32 as the cell rounds them, are
    shared).  x: (B,S,d_in) -> (B,S,H*hd)."""
    num_heads = p["r_z"].shape[0]
    z, i, f, o = _slstm_pre(p, x, num_heads)
    b, s, h, hd = z.shape
    if state is None:
        state = init_slstm_state(b, h, hd, x.device)

    def scan(z, i, f, o, c, n, m, h, *rec):
        return SS.slstm_scan(torch.stack([z, i, f, o], dim=3),
                             torch.stack(rec, dim=1), c, n, m, h)

    hs = S.batch_local(scan, z, i, f, o, state["c"], state["n"], state["m"],
                       state["h"], shared=[_f32(p[name]) for name in SS.GATES])
    return S.merge_heads(hs).to(x.dtype)


def init_slstm_state(batch: int, num_heads: int, head_dim: int,
                     device=None) -> dict:
    """``n`` starts at 1e-6 (the cell's floor), the rest at 0."""
    shape = (batch, num_heads, head_dim)
    return {"c": _zeros(shape, device),
            "n": torch.full(shape, 1e-6, dtype=torch.float32, device=device),
            "m": _zeros(shape, device), "h": _zeros(shape, device)}


def slstm_step(p: dict, x: torch.Tensor, state: dict
               ) -> tuple[torch.Tensor, dict]:
    num_heads = p["r_z"].shape[0]
    z, i, f, o = _slstm_pre(p, x, num_heads)
    carry = (state["c"], state["n"], state["m"], state["h"])
    (c, n, m, h), out = _slstm_cell(p, carry,
                                    (z[:, 0], i[:, 0], f[:, 0], o[:, 0]))
    return S.merge_heads(out[:, None]).to(x.dtype), \
        {"c": c, "n": n, "m": m, "h": h}
