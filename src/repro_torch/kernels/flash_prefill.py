"""Full-sequence GQA flash attention (prefill).

Replaces the Pallas kernel ``repro/kernels/flash_prefill.py::
flash_prefill`` (``_kernel``): q (B, S, H, hd) against k / v
(B, T, Hkv, hd), query i at position i and key j at j; key j is valid for
query i iff ``j < t_valid``, ``j <= i`` when ``causal`` and
``j > i - window`` with a ``window``; dead KV heads of ``head_mask``
(Hkv,) (<= 0) output zeros, and so does a query with no valid key
(``t_valid = 0``).  Returns (B, S, H, hd) float32.

On the card ``flash_prefill`` launches ``csrc/flash_prefill.cu`` (one CTA
per 32 (query position, query head) rows of a KV head and batch row, a
warp per 4 rows, whole dead key blocks skipped, online softmax), counted
in ``flash_prefill.launches``; on the CPU it runs
``flash_prefill_plain``, the reference's oracle
(``repro.kernels.ref.prefill_attention``) in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["flash_prefill", "flash_prefill_plain"]

MAX_HEAD_DIM = 128


def flash_prefill_plain(q, k, v, causal: bool = True,
                        window: Optional[int] = None,
                        t_valid: Optional[int] = None,
                        head_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    t_valid = t if t_valid is None else t_valid
    qg = q.reshape(b, s, hkv, h // hkv, hd).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bskgt", qg,
                          k.to(torch.float32)) * hd ** -0.5
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    valid = kpos < t_valid
    if causal:
        valid = valid & (kpos <= qpos)
    if window is not None:
        valid = valid & (kpos > qpos - window)
    scores = torch.where(valid[None, :, None, None, :], scores, -1e30)
    # a query with no valid key (t_valid = 0) outputs zeros, as the kernel
    # does
    probs = torch.where(valid.any(-1)[None, :, None, None, None],
                        torch.softmax(scores, dim=-1), 0.0)
    out = torch.einsum("bskgt,btkd->bskgd", probs, v.to(torch.float32))
    if head_mask is not None:
        out = out * (head_mask > 0).to(torch.float32)[None, None, :, None,
                                                       None]
    return out.reshape(b, s, h, hd)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, window, t_valid, head_mask) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)}")
    if head_mask is not None and tuple(head_mask.shape) != (k.shape[2],):
        raise ValueError(f"flash_prefill: head_mask {tuple(head_mask.shape)}"
                         f" != ({k.shape[2]},)")
    if window is not None and window <= 0:
        raise ValueError(f"flash_prefill: window {window} must be > 0")
    if t_valid is not None and not 0 <= t_valid <= k.shape[1]:
        raise ValueError(f"flash_prefill: t_valid {t_valid} outside "
                         f"[0, {k.shape[1]}]")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  t_valid: Optional[int] = None,
                  head_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, H, hd) float32 attention of every query position."""
    _check(q, k, v, window, t_valid, head_mask)
    operands = (q, k, v) + (() if head_mask is None else (head_mask,))
    if not build.on_card("flash_prefill", *operands):
        return flash_prefill_plain(q, k, v, causal, window, t_valid,
                                   head_mask)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_prefill kernel takes float32 {name}, "
                            f"got {t.dtype}")
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_prefill kernel: head_dim {hd} (max "
                         f"{MAX_HEAD_DIM})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    hm = torch.ones((hkv,), dtype=torch.int32, device=q.device) \
        if head_mask is None else (head_mask > 0).to(torch.int32).contiguous()
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_prefill(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(hm),
        build.ptr(out), b, s, t, h, hkv, hd, int(causal),
        0 if window is None else int(window),
        t if t_valid is None else int(t_valid), hd ** -0.5,
        ctypes.c_void_p(stream))
    build.check(lib, code, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
