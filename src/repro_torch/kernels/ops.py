"""The kernels behind the reference's public signatures
(``repro.kernels.ops``): leading dims, head-mask conversion and dispatch.

Each call runs a kernel for tensors on the card and its plain version for
tensors on the CPU.  The reference's ``block_m`` / ``block_q`` /
``block_s`` (TPU tiling) and ``impl`` / ``interpret`` (how to run Pallas)
have no counterpart: the CUDA kernels pick their own tiles.  ``block_k``
and ``block_n`` of ``masked_matmul`` and ``tile_norms`` stay: they are the
mask granularity and the tile.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import block_norms as _bn
from repro_torch.kernels import block_sparse_matmul as _bsm
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_prefill as _fp

__all__ = ["masked_matmul", "tile_norms", "flash_decode", "flash_prefill"]


def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                  block_k: int = 128, block_n: int = 128,
                  transpose_rhs: bool = False) -> torch.Tensor:
    """y = x @ (w ⊙ blockmask); x (..., K), w (K, N), mask
    (ceil(K/bk), ceil(N/bn)) -> (..., N) float32.  With ``transpose_rhs``
    x is (..., N) and y = x @ (w ⊙ blockmask)ᵀ -> (..., K)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    fn = _bsm.block_sparse_matmul_t if transpose_rhs \
        else _bsm.block_sparse_matmul
    y = fn(x2, w, mask, block_k, block_n)
    return y.reshape(*lead, y.shape[-1])


def tile_norms(w: torch.Tensor, block_k: int = 128, block_n: int = 128
               ) -> torch.Tensor:
    """Per-tile squared L2 norms of w (K, N) zero-padded to the tile ->
    (ceil(K/bk), ceil(N/bn)) float32.  The kernel's ragged edge tiles sum
    their real elements, which is what the padding gives, so no padded
    copy is made; the reference's ``interpret`` has no counterpart."""
    if w.ndim != 2:
        raise ValueError(f"tile_norms takes (K, N), got {tuple(w.shape)}")
    return _bn.tile_norms(w, block_k, block_n)


def _head_mask(head_mask, device) -> Optional[torch.Tensor]:
    if head_mask is None or isinstance(head_mask, torch.Tensor):
        return head_mask
    return torch.as_tensor(np.asarray(head_mask, np.float32), device=device)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, window: Optional[int] = None,
                 head_mask=None) -> torch.Tensor:
    """One-token GQA decode: q (B, H, hd), k / v (B, S, Hkv, hd), pos (B,)
    -> (B, H, hd) float32.  ``head_mask`` (Hkv,), a tensor or an array,
    skips dead KV heads."""
    return _da.decode_attention(q, k, v, pos, window=window,
                                head_mask=_head_mask(head_mask, q.device))


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  head_mask=None) -> torch.Tensor:
    """Full-sequence GQA attention: q (B, S, H, hd), k / v (B, T, Hkv, hd)
    -> (B, S, H, hd) float32; ``head_mask`` as in ``flash_decode``."""
    return _fp.flash_prefill(q, k, v, causal=causal, window=window,
                             t_valid=k.shape[1],
                             head_mask=_head_mask(head_mask, q.device))
