"""One-token GQA decode attention against a KV cache.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py::
decode_attention`` (``_kernel``): q (B, H, hd) against k / v
(B, S, Hkv, hd) with a per-row position ``pos`` (B,) — key ``kpos`` is
valid iff ``kpos <= pos`` and, with a ``window``, ``kpos > pos - window``
— and an optional ``head_mask`` (Hkv,) whose dead heads (<= 0) output
zeros; so does a row with no valid key (a window past the cache's end).
Returns (B, H, hd) float32.

On the card ``decode_attention`` launches ``csrc/decode_attention.cu``
(split-KV: chunks of 16 keys at absolute positions spread over the warps
of a cluster of up to 8 CTAs per (row, KV head), folded in an order set
by key positions and S alone, so a row's bits do not depend on the batch;
dead heads and rows with no valid key read nothing), counted in
``decode_attention.launches``; on the CPU it runs
``decode_attention_plain``, the reference's oracle
(``repro.kernels.ref.decode_attention``) in plain PyTorch.  The kernel
reads a float32 ``head_mask`` as it is, so a call launches nothing but
the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["decode_attention", "decode_attention_plain"]

MAX_HEAD_DIM = 128
MAX_GROUP = 8          # query heads per KV head (csrc kMaxG)


def decode_attention_plain(q, k, v, pos, window: Optional[int] = None,
                           head_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg,
                          k.to(torch.float32)) * hd ** -0.5
    kpos = torch.arange(s, device=q.device)[None, :]
    pos = pos.to(torch.int64)[:, None]
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    # a row with no valid key outputs zeros, as the kernel does
    probs = torch.where(valid.any(-1)[:, None, None, None],
                        torch.softmax(scores, dim=-1), 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.to(torch.float32))
    if head_mask is not None:
        out = out * (head_mask > 0).to(torch.float32)[None, :, None, None]
    return out.reshape(b, h, hd)


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, pos, window, head_mask) -> None:
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match the cache {tuple(k.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"decode_attention: pos {tuple(pos.shape)} != ({b},)")
    if head_mask is not None and tuple(head_mask.shape) != (k.shape[2],):
        raise ValueError(f"decode_attention: head_mask "
                         f"{tuple(head_mask.shape)} != ({k.shape[2]},)")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window {window} must be > 0")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, window: Optional[int] = None,
                     head_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(B, H, hd) float32 attention of one query token per row."""
    _check(q, k, v, pos, window, head_mask)
    operands = (q, k, v, pos) + (() if head_mask is None else (head_mask,))
    if not build.on_card("decode_attention", *operands):
        return decode_attention_plain(q, k, v, pos, window, head_mask)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"decode_attention kernel takes float32 {name}, "
                            f"got {t.dtype}")
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM or h // hkv > MAX_GROUP or s == 0:
        raise ValueError(f"decode_attention kernel: head_dim {hd} (max "
                         f"{MAX_HEAD_DIM}), group {h // hkv} (max "
                         f"{MAX_GROUP}), cache length {s}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    pos = pos.to(torch.int32).contiguous()
    hm = None if head_mask is None \
        else head_mask.to(torch.float32).contiguous()
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.decode_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(pos),
        None if hm is None else build.ptr(hm), build.ptr(out), b, s, h,
        hkv, hd, 0 if window is None else int(window), hd ** -0.5,
        ctypes.c_void_p(stream))
    build.check(lib, code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
