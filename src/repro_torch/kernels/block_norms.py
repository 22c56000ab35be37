"""Per-tile squared L2 norms: the block-pruning ranking statistic.

Replaces the Pallas kernel ``repro/kernels/block_norms.py::block_norms``
(its padding wrapper ``repro/kernels/ops.py::tile_norms`` is
``kernels.ops.tile_norms``).  ``tile_norms_group`` takes every leaf of one
ranking, each 2-D or with leading dims (ranked slice by slice over its
last two dims), each with its own (bk, bn), in float32 or bfloat16 as it
lies.  On the card it makes one launch of ``csrc/block_norms.cu`` for up
to ``MAX_LEAVES`` leaves (a larger group takes more launches, each counted
in ``tile_norms.launches``): a warp sums each row segment of a tile
(``segments``, fixed by the tile's shape), and a tile's segments are
folded in ascending order, so a leaf's norms are bitwise the same alone
(``tile_norms``) and in any group.  The fleet's ranking (three layers,
194 KB) is then one launch, a transformer's (smollm-135m, 269 MB of
bfloat16) one launch bound by its bytes.

``tile_norms_plain`` is the same function in plain PyTorch (cast to
float32, zero-pad, reshape, sum; leading dims slice by slice) and
``tile_norms_group_plain`` loops over it; the wrappers take them only for
tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from array import array
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

__all__ = ["tile_norms", "tile_norms_group", "tile_norms_plain",
           "tile_norms_group_plain", "segments", "empty_launch"]

SEG_ELEMS = 16384  # elements a tile's row segment holds at most (a row at least)
MAX_LEAVES = 48    # leaves a launch (csrc kMaxLeaves)
_FIELDS = 15       # int64s of a leaf's host descriptor (csrc kDescFields)
_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc Leaf::bf16
# (device, stream) -> (tickets, partials): the kernel's workspace for tiles
# of several segments; the kernel leaves every ticket at zero again
_scratch: dict = {}


def tile_norms_plain(w: torch.Tensor, block_k: int, block_n: int
                     ) -> torch.Tensor:
    """lead + (K, N) -> lead + (ceil(K/bk), ceil(N/bn)) float32 squared tile
    norms, leading dims slice by slice."""
    if w.ndim > 2:
        k, n = w.shape[-2:]
        slices = w.reshape((-1, k, n))
        if slices.shape[0] == 0:
            return torch.zeros(tuple(w.shape[:-2]) + (-(-k // block_k),
                                                     -(-n // block_n)),
                               dtype=torch.float32, device=w.device)
        norms = torch.stack([tile_norms_plain(s, block_k, block_n)
                             for s in slices])
        return norms.reshape(tuple(w.shape[:-2]) + tuple(norms.shape[1:]))
    k, n = w.shape
    wp = F.pad(w.to(torch.float32), (0, (-n) % block_n, 0, (-k) % block_k))
    kp, np_ = wp.shape
    t = wp.reshape(kp // block_k, block_k, np_ // block_n, block_n)
    return torch.sum(t ** 2, dim=(1, 3))


def tile_norms_group_plain(leaves: Sequence[torch.Tensor],
                           blocks: Sequence[tuple[int, int]]
                           ) -> list[torch.Tensor]:
    """``tile_norms_plain`` of each leaf with its own block."""
    return [tile_norms_plain(w, bk, bn) for w, (bk, bn) in zip(leaves, blocks)]


def segments(block_k: int, block_n: int) -> tuple[int, int]:
    """(segments a tile, rows a segment) of a (block_k x block_n) tile: the
    fewest segments of at most ``SEG_ELEMS`` elements (a row at least), as
    even as whole rows allow.  Fixed by the tile's shape alone, so a
    tile's fold order does not depend on the tensor or the group."""
    nseg = -(-block_k // max(1, SEG_ELEMS // block_n))
    rows = -(-block_k // nseg)
    return -(-block_k // rows), rows


def _lib() -> ctypes.CDLL:
    lib = build.load("block_norms")
    if lib.tile_norms_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.tile_norms_launch.argtypes = [p, ctypes.c_int, p, p, p]
        lib.tile_norms_launch.restype = ctypes.c_int
        lib.empty_launch.argtypes = [p]
        lib.empty_launch.restype = ctypes.c_int
        lib.tile_norms_max_leaves.argtypes = []
        lib.tile_norms_max_leaves.restype = ctypes.c_int
        if lib.tile_norms_max_leaves() != MAX_LEAVES:
            raise RuntimeError("csrc kMaxLeaves differs from MAX_LEAVES")
    return lib


def _workspace(device, stream: int, tiles: int, items: int):
    """Zeroed tickets (an int a tile of the group) and partials (a float a
    work item of a launch) for one stream, grown as needed."""
    key = (device, stream)
    tickets, partials = _scratch.get(key, (None, None))
    if tickets is None or tickets.numel() < tiles:
        tickets = torch.zeros(tiles, dtype=torch.int32, device=device)
    if partials is None or partials.numel() < items:
        partials = torch.empty(items, dtype=torch.float32, device=device)
    _scratch[key] = (tickets, partials)
    return tickets, partials


def tile_norms_group(leaves: Sequence[torch.Tensor],
                     blocks: Sequence[tuple[int, int]]
                     ) -> list[torch.Tensor]:
    """Squared L2 norm of each (bk x bn) tile of every leaf over its last
    two dims, float32, shaped ``lead + (ceil(K/bk), ceil(N/bn))``; ragged
    edge tiles sum their real elements (what zero padding gives).  CUDA
    tensors: the kernel, float32 or bfloat16, one launch for up to
    ``MAX_LEAVES`` leaves; CPU tensors: ``tile_norms_group_plain``."""
    if len(leaves) != len(blocks):
        raise ValueError(f"{len(leaves)} leaves but {len(blocks)} blocks")
    for w, (bk, bn) in zip(leaves, blocks):
        if w.ndim < 2 or bk < 1 or bn < 1:
            raise ValueError(f"tile_norms takes (..., K, N) leaves and "
                             f"positive blocks, got {tuple(w.shape)} at "
                             f"({bk}, {bn})")
    if not leaves or not build.on_card("tile_norms", *leaves):
        return tile_norms_group_plain(leaves, blocks)
    # a host descriptor a leaf with tiles; `kept` holds any contiguous
    # copy until the launch is queued
    desc, items, outs, kept, total = array("q"), [], [], [], 0
    for w, (bk, bn) in zip(leaves, blocks):
        code = _CODES.get(w.dtype)
        if code is None:
            raise TypeError(f"tile_norms kernel takes float32 or bfloat16, "
                            f"got {w.dtype}")
        w = w.contiguous()
        *lead_shape, k, n = w.shape
        lead = math.prod(lead_shape)
        tk, tn = -(-k // bk), -(-n // bn)
        out = torch.empty((*lead_shape, tk, tn), dtype=torch.float32,
                          device=w.device)
        outs.append(out)
        tiles = lead * tk * tn
        if tiles:
            nseg, rows = segments(bk, bn)
            ptr = w.data_ptr()
            v = 16 // w.element_size()   # elements a 16-byte load
            desc.extend((ptr, k * n, out.data_ptr(), total, k, n, lead, bk,
                         bn, tk, tn, nseg, rows, code,
                         n % v == 0 and bn % v == 0 and ptr % 16 == 0))
            items.append(tiles * nseg)
            kept.append(w)
            total += tiles
    if items:
        _launch(desc, items, total, outs[0].device)
    return outs


def _stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as a raw handle (what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without
    making a ``Stream`` object: a few microseconds of host time a call)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(desc: array, items: list, tiles: int, device) -> None:
    """Launch the kernel on the current stream over the descriptors,
    ``MAX_LEAVES`` leaves a launch."""
    lib = _lib()
    stream = _stream(device.index)
    for at in range(0, len(items), MAX_LEAVES):
        chunk = desc[at * _FIELDS:(at + MAX_LEAVES) * _FIELDS]
        count = len(chunk) // _FIELDS
        tickets = partials = None
        if any(nseg > 1 for nseg in chunk[11::_FIELDS]):
            # some tile of several row segments
            tickets, partials = _workspace(device, stream, tiles,
                                           sum(items[at:at + count]))
        code = lib.tile_norms_launch(
            chunk.buffer_info()[0], count,
            None if partials is None else build.ptr(partials),
            None if tickets is None else build.ptr(tickets),
            ctypes.c_void_p(stream))
        build.check(lib, code, "tile_norms")
        tile_norms.launches += 1


def tile_norms(w: torch.Tensor, block_k: int, block_n: int) -> torch.Tensor:
    """Squared L2 norm of each (block_k x block_n) tile of ``w`` (2-D, or
    leading dims slice by slice): a group of one leaf, so the same bits as
    inside any group.  CUDA tensor: the kernel (counted in
    ``tile_norms.launches``); CPU tensor: ``tile_norms_plain``."""
    return tile_norms_group([w], [(block_k, block_n)])[0]


tile_norms.launches = 0


def empty_launch() -> None:
    """Launch a kernel that does nothing on the current stream: the
    yardstick of a launch's device time (the fleet ranking's floor)."""
    lib = _lib()
    stream = _stream(torch.cuda.current_device())
    build.check(lib, lib.empty_launch(ctypes.c_void_p(stream)),
                "empty_launch")
