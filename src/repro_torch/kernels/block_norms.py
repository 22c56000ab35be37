"""Per-tile squared L2 norms: the block-pruning ranking statistic.

Replaces the Pallas kernel ``repro/kernels/block_norms.py::block_norms``
(and its padding wrapper ``repro/kernels/ops.py::tile_norms``).  On the
card ``tile_norms`` launches ``csrc/block_norms.cu``: one CTA per tile,
a fixed-order shared-memory reduction, ragged edge tiles summed over
their real elements.  The fleet round calls it once per layer; at the
784-60-20-10 model that is 194 KB read across three launches, so launch
latency, not bytes or arithmetic, bounds it on an H100.

``tile_norms_plain`` is the same function in plain PyTorch (zero-pad,
reshape, sum); the wrapper takes it only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

__all__ = ["tile_norms", "tile_norms_plain"]


def tile_norms_plain(w: torch.Tensor, block_k: int, block_n: int
                     ) -> torch.Tensor:
    """(K, N) -> (ceil(K/bk), ceil(N/bn)) float32 squared tile norms."""
    k, n = w.shape
    wp = F.pad(w.to(torch.float32), (0, (-n) % block_n, 0, (-k) % block_k))
    kp, np_ = wp.shape
    t = wp.reshape(kp // block_k, block_k, np_ // block_n, block_n)
    return torch.sum(t ** 2, dim=(1, 3))


def _lib() -> ctypes.CDLL:
    lib = build.load("block_norms")
    if lib.tile_sqnorms.argtypes is None:
        lib.tile_sqnorms.argtypes = [ctypes.c_void_p, ctypes.c_void_p] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.tile_sqnorms.restype = ctypes.c_int
    return lib


def tile_norms(w: torch.Tensor, block_k: int, block_n: int) -> torch.Tensor:
    """Squared L2 norm of each (block_k x block_n) tile of a 2-D float32
    matrix.  CUDA tensor: the kernel (counted in ``tile_norms.launches``);
    CPU tensor: ``tile_norms_plain``."""
    if w.ndim != 2:
        raise ValueError(f"tile_norms takes a 2-D matrix, got {tuple(w.shape)}")
    if not w.is_cuda:
        return tile_norms_plain(w, block_k, block_n)
    if w.dtype != torch.float32:
        raise TypeError(f"tile_norms kernel takes float32, got {w.dtype}")
    k, n = w.shape
    w = w.contiguous()
    out = torch.empty(((k + block_k - 1) // block_k,
                       (n + block_n - 1) // block_n),
                      dtype=torch.float32, device=w.device)
    lib = _lib()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    code = lib.tile_sqnorms(build.ptr(w), build.ptr(out), k, n, block_k,
                            block_n, ctypes.c_void_p(stream))
    build.check(lib, code, "tile_sqnorms")
    tile_norms.launches += 1
    return out


tile_norms.launches = 0
