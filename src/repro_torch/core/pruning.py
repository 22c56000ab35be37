"""Block-structured pruning: the ranking statistic and per-client keeps.

The port of the ranking half of ``repro.core.pruning``.  Every >= 2-D
weight matrix is cut into (bk, bn) tiles; a round ranks the tiles once by
squared L2 norm (``block_norm_state``) and every client's tile-keep
indicators are then one ``searchsorted`` against the shared cumulative
element mass (``block_keep``).  The threshold is an element-count-weighted
quantile, so ragged edge tiles count only their real elements.

The tile norms come from ``kernels.block_norms.tile_norms``: the CUDA
kernel for a tensor on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels import block_norms as _bn

__all__ = [
    "BlockNormState",
    "block_l2_norms",
    "block_norm_state",
    "block_thresholds",
    "block_keep",
    "flatten",
]

PyTree = Any
DEFAULT_BLOCK = 128


def _block_pair(block) -> tuple[int, int]:
    if isinstance(block, int):
        return (block, block)
    bk, bn = block
    return (int(bk), int(bn))


def flatten(tree: PyTree) -> list:
    """Leaves of nested dicts in ``jax.tree_util.tree_flatten`` order
    (keys sorted, so ``layer10`` precedes ``layer2``).  Per-leaf state
    lists align with this order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in flatten(tree[key])]
    return [tree]


def block_l2_norms(w: torch.Tensor, block=DEFAULT_BLOCK) -> torch.Tensor:
    """Squared L2 norm of each (bk x bn) tile of a 2-D matrix, in float32
    (ragged edge tiles sum their real elements only)."""
    bk, bn = _block_pair(block)
    return _bn.tile_norms(w.to(torch.float32), bk, bn)


def _tile_element_counts(m: int, n: int, block, device) -> torch.Tensor:
    """Number of real (unpadded) elements in each tile of an (m, n) matrix."""
    bk, bn = _block_pair(block)
    rows = torch.clamp_max(m - torch.arange(0, m, bk, device=device), bk)
    cols = torch.clamp_max(n - torch.arange(0, n, bn, device=device), bn)
    return rows[:, None] * cols[None, :]


class BlockNormState(NamedTuple):
    """Once-per-round ranking statistics for one prunable matrix."""

    norms: torch.Tensor         # (Tk, Tn) tile squared-L2 norms, float32
    sorted_norms: torch.Tensor  # (T,) the same norms, ascending
    cum_frac: torch.Tensor      # (T,) cumulative element mass of sorted tiles


def _matrix_state(w: torch.Tensor, block) -> BlockNormState:
    norms = block_l2_norms(w, block)
    counts = _tile_element_counts(w.shape[-2], w.shape[-1], block,
                                  w.device).reshape(-1).to(torch.float32)
    flat = norms.reshape(-1)
    order = torch.argsort(flat, stable=True)
    cum = torch.cumsum(counts[order], dim=0)
    return BlockNormState(norms=norms, sorted_norms=flat[order],
                          cum_frac=cum / cum[-1])


def block_norm_state(params: PyTree, block=DEFAULT_BLOCK
                     ) -> list[Optional[BlockNormState]]:
    """Per-leaf ranking state in ``flatten(params)`` order (``None`` for
    1-D leaves, which are never pruned).  ``block`` is an int or a
    ``(bk, bn)`` pair.  Only 2-D leaves are supported: stacked
    (batched-leading-dim) leaves belong to the transformer tasks, which
    this port does not carry yet."""
    out: list[Optional[BlockNormState]] = []
    for leaf in flatten(params):
        if leaf.ndim < 2:
            out.append(None)
        elif leaf.ndim == 2:
            out.append(_matrix_state(leaf, block))
        else:
            raise NotImplementedError(
                "block_norm_state on leaves with leading batch dims is not "
                "ported yet (ROADMAP.md Queue A, item 8: other tasks)")
    return out


def block_thresholds(state: BlockNormState, rate: torch.Tensor
                     ) -> torch.Tensor:
    """Smallest kept norm at pruning rate ``rate`` (any shape).  Tiles whose
    cumulative element mass is <= rate * total are dropped (right side)."""
    rate = torch.clamp(rate, 0.0, 1.0)
    dtype = torch.promote_types(rate.dtype, state.cum_frac.dtype)
    idx = torch.searchsorted(state.cum_frac.to(dtype),
                             rate.to(dtype).contiguous(), right=True)
    idx = torch.clamp(idx, 0, state.sorted_norms.numel() - 1)
    return state.sorted_norms[idx]


def block_keep(state: list[Optional[BlockNormState]], rates: torch.Tensor
               ) -> list[Optional[torch.Tensor]]:
    """Per-leaf float32 tile-keep indicators for a batch of pruning rates:
    shape ``rates.shape + norms.shape``, 1.0 where the tile survives
    (a rate <= 0 keeps everything)."""
    out: list[Optional[torch.Tensor]] = []
    for st in state:
        if st is None:
            out.append(None)
            continue
        thresh = block_thresholds(st, rates)
        ext = thresh.reshape(thresh.shape + (1,) * st.norms.ndim)
        keep = (st.norms >= ext) | (rates.reshape(ext.shape) <= 0.0)
        out.append(keep.to(torch.float32))
    return out
