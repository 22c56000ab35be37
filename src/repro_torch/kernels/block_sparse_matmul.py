"""Block-sparse matmul over the pruning tile mask: forward and transposed.

Replaces the Pallas kernel ``repro/kernels/block_sparse_matmul.py::
block_sparse_matmul`` (``_kernel`` and, with ``transpose_rhs``,
``_kernel_t``):

* ``block_sparse_matmul(x, w, mask, bk, bn)``:  y = x @ (W ⊙ expand(M)),
  x (M, K), W (K, N) -> (M, N);
* ``block_sparse_matmul_t(x, w, mask, bk, bn)``: y = x @ (W ⊙ expand(M))ᵀ,
  x (M, N), the same W and mask -> (M, K) (the pruned layer's backward
  product; no path of the serving slice runs it).

``mask`` is (ceil(K/bk), ceil(N/bn)); a tile is kept where its entry,
truncated to an integer as the TPU kernel does, is not 0.  ``bk`` / ``bn``
are the mask granularity and may be any size: no dim has to be a multiple
of them, and nothing is padded.

On the card both launch ``csrc/block_sparse_matmul.cu`` (float32 on the
CUDA cores, dropped segments skipped with their loads, a row's result
bitwise independent of M), each counted in its own ``launches``; on the
CPU they run ``block_sparse_matmul_plain``.  ``launch_plan`` picks the
kernel's regime; ``segments`` cuts the contraction, from its length and
the mask tile alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["block_sparse_matmul", "block_sparse_matmul_t",
           "block_sparse_matmul_plain", "expand_mask", "segments",
           "segment_bounds", "launch_plan"]

# The kernel's geometry, mirrored from csrc/block_sparse_matmul.cu (the
# kernel refuses a plan that breaks its limits):
STRIP = 64                 # output columns of a CTA: csrc BN
ROW_BLOCKS = (32, 64)      # rows of a CTA for m <= 32 / else: csrc
                           # rows_of<2>(), rows_of<4>()
SEG_MAX = 96               # longest segment: csrc kStage
CLUSTER_MAX = 16           # most CTAs a split cluster: csrc kCluster
SPLIT_MAX_SEGMENTS = 32    # 8-CTA clusters x csrc kMaxSlots (4)
SEGMENTS = 8               # segments a contraction aims at (one a CTA)


def segments(c: int, bc: int) -> tuple[int, int, int]:
    """(nsub, seg_len, nseg) of a contraction of length ``c`` under mask
    tiles of ``bc`` along it: each tile row splits into ``nsub`` pieces of
    ``seg_len`` (the last may be shorter), enough for ``SEGMENTS`` in all
    and none longer than ``SEG_MAX``; ``nseg`` counts them, with empty
    ones past the end of a short last tile row.  A function of ``c`` and
    ``bc`` only, so every M sums in one order."""
    if c == 0:
        return 1, 1, 0
    span, rows = min(bc, c), -(-c // bc)
    nsub = min(span, max(-(-SEGMENTS // rows), -(-span // SEG_MAX)))
    seg_len = -(-span // nsub)
    nsub = -(-span // seg_len)
    return nsub, seg_len, rows * nsub


def segment_bounds(c: int, bc: int) -> list[tuple[int, int]]:
    """The non-empty segments [lo, hi) in the kernel's order."""
    nsub, seg_len, nseg = segments(c, bc)
    out = []
    for s in range(nseg):
        t, sub = divmod(s, nsub)
        lo = t * bc + sub * seg_len
        hi = min(lo + seg_len, (t + 1) * bc, c)
        if lo < hi:
            out.append((lo, hi))
    return out


class Plan(NamedTuple):
    nsub: int
    seg_len: int
    nseg: int
    cluster: int    # CTAs a split cluster, 0 for the walk
    ctas: int       # what the launch puts on the card


@functools.lru_cache(maxsize=None)
def launch_plan(m: int, c: int, no: int, bc: int, num_sms: int) -> Plan:
    """The kernel's regime for an (m, c) @ (c, no) product.  The walk puts
    a CTA on each 64-column strip and block of 32 rows (m <= 32) or 64;
    where that is fewer than two CTAs an SM, the split gives each tile a
    cluster of CTAs sharing its segments (16 where the card holds them
    all at once, else 8), folded through distributed shared memory.
    Either regime gives the same bits.  Memoised: a decode step asks for
    the same few plans 211 times."""
    nsub, seg_len, nseg = segments(c, bc)
    rows = ROW_BLOCKS[0] if m <= ROW_BLOCKS[0] else ROW_BLOCKS[1]
    tiles = -(-no // STRIP) * -(-m // rows)
    cluster = 0
    if 1 < nseg <= SPLIT_MAX_SEGMENTS and tiles < 2 * num_sms:
        cluster = min(nseg, CLUSTER_MAX if tiles * CLUSTER_MAX <= 2 * num_sms
                      else 8)
    return Plan(nsub, seg_len, nseg, cluster, tiles * max(cluster, 1))


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def expand_mask(mask: torch.Tensor, shape: tuple, block_k: int,
                block_n: int) -> torch.Tensor:
    """Tile mask -> boolean element mask of ``shape``'s last two dims
    (leading dims, as a stacked leaf's, carry through)."""
    kept = mask.to(torch.int32) != 0
    em = torch.repeat_interleave(torch.repeat_interleave(kept, block_k, -2),
                                 block_n, -1)
    return em[..., :shape[-2], :shape[-1]]


def block_sparse_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                              mask: torch.Tensor, block_k: int, block_n: int,
                              transpose_rhs: bool = False) -> torch.Tensor:
    """The same products in plain PyTorch, float32."""
    wm = torch.where(expand_mask(mask, w.shape, block_k, block_n),
                     w.to(torch.float32), 0.0)
    return x.to(torch.float32) @ (wm.T if transpose_rhs else wm)


def _lib() -> ctypes.CDLL:
    lib = build.load("block_sparse_matmul")
    for fn in (lib.bsmm_forward, lib.bsmm_transposed):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(what, x, w, mask, block_k, block_n, transpose_rhs) -> None:
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"{what}: x and w must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    k, n = w.shape
    if x.shape[1] != (n if transpose_rhs else k):
        raise ValueError(f"{what}: x {tuple(x.shape)} does not contract "
                         f"with w {tuple(w.shape)}")
    if block_k <= 0 or block_n <= 0:
        raise ValueError(f"{what}: blocks must be positive")
    grid = (-(-k // block_k), -(-n // block_n))
    if tuple(mask.shape) != grid:
        raise ValueError(f"{what}: mask {tuple(mask.shape)} != tile grid "
                         f"{grid} of w {tuple(w.shape)} at "
                         f"({block_k}, {block_n})")


def _run(counted, fn_name: str, x, w, mask, block_k, block_n,
         transpose_rhs, cluster=None):
    """Check, then the plain version on the CPU or the kernel on the card
    (adding one to ``counted.launches`` per launch).  ``cluster`` (tests
    only) overrides the plan's regime: 0 the walk, else the split's
    cluster size."""
    what = fn_name
    _check(what, x, w, mask, block_k, block_n, transpose_rhs)
    if not build.on_card(what, x, w, mask):
        return block_sparse_matmul_plain(x, w, mask, block_k, block_n,
                                         transpose_rhs)
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what} kernel takes float32 {name}, "
                            f"got {t.dtype}")
    x, w = x.contiguous(), w.contiguous()
    mask = mask.to(torch.int32).contiguous()
    k, n = w.shape
    y = torch.empty((x.shape[0], k if transpose_rhs else n),
                    dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    m = x.shape[0]
    c, no, bc = (n, k, block_n) if transpose_rhs else (k, n, block_k)
    plan = launch_plan(m, c, no, bc, _num_sms(x.device.index))
    code = getattr(lib, fn_name)(
        build.ptr(x), build.ptr(w), build.ptr(mask), build.ptr(y), m, k, n,
        block_k, block_n, plan.nsub, plan.seg_len,
        plan.cluster if cluster is None else cluster,
        ctypes.c_void_p(stream))
    build.check(lib, code, fn_name)
    counted.launches += 1
    return y


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                        block_k: int, block_n: int) -> torch.Tensor:
    """y = x @ (w ⊙ expand(mask)); x (M, K) -> (M, N) float32."""
    return _run(block_sparse_matmul, "bsmm_forward", x, w, mask, block_k,
                block_n, False)


def block_sparse_matmul_t(x: torch.Tensor, w: torch.Tensor,
                          mask: torch.Tensor, block_k: int, block_n: int
                          ) -> torch.Tensor:
    """y = x @ (w ⊙ expand(mask))ᵀ; x (M, N) -> (M, K) float32."""
    return _run(block_sparse_matmul_t, "bsmm_transposed", x, w, mask,
                block_k, block_n, True)


block_sparse_matmul.launches = 0
block_sparse_matmul_t.launches = 0
