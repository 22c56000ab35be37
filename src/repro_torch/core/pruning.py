"""Block-structured pruning: the ranking statistic and per-client keeps.

The port of ``repro.core.pruning``'s block ranking and keep masks.
Every >= 2-D weight matrix is cut into (bk, bn) tiles; a round ranks the
tiles once by squared L2 norm (``block_norm_state``) and every client's
tile-keep indicators are then one ``searchsorted`` against the shared
cumulative element mass (``block_keep``).  The threshold is an element-count-weighted
quantile, so ragged edge tiles count only their real elements.

Leaves with leading dims (a transformer stage's stacked layers) rank
tiles over the last two dims, batch-wise, exactly as the reference does.
``masks_from_keep`` / ``apply_masks`` turn keeps into the dense oracle's
masked params.  Per-leaf state lists follow ``flatten``'s order, which is
``jax.tree_util``'s: dict keys sorted, lists by index.

The tile norms come from ``kernels.block_norms.tile_norms_group``: for
tensors on the card one CUDA launch takes every prunable leaf of a
``block_norm_state`` call, in its own type; on the CPU the plain version.
"""

from __future__ import annotations

import numbers
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels import block_norms as _bn
from repro_torch.kernels import block_sparse_matmul as _bsm

__all__ = [
    "BlockNormState",
    "block_l2_norms",
    "block_norm_state",
    "block_thresholds",
    "block_keep",
    "flatten",
    "unflatten",
    "leaf_blocks",
    "masks_from_keep",
    "apply_masks",
]

PyTree = Any
DEFAULT_BLOCK = 128


def _block_pair(block) -> tuple[int, int]:
    if isinstance(block, numbers.Integral):
        return (int(block), int(block))
    bk, bn = block
    return (int(bk), int(bn))


def flatten(tree: PyTree) -> list:
    """Leaves in ``jax.tree_util.tree_flatten`` order: dict keys sorted (so
    ``layer10`` precedes ``layer2``), lists and tuples by index, ``None``
    an empty subtree.  Per-leaf state lists align with this order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in flatten(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in flatten(sub)]
    if tree is None:
        return []
    return [tree]


def unflatten(tree: PyTree, leaves: list) -> PyTree:
    """The structure of ``tree`` with its leaves replaced, in ``flatten``
    order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {key: build(node[key]) for key in sorted(node)}
            return {key: out[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        if node is None:
            return None
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _flatten_prunable(params: PyTree) -> tuple[list, list[bool]]:
    leaves = flatten(params)
    return leaves, [leaf.ndim >= 2 for leaf in leaves]


def leaf_blocks(flags: list, block) -> list[Optional[tuple[int, int]]]:
    """One ``(bk, bn)`` pair per flattened leaf (``None`` for unprunable
    leaves).  An int or pair broadcasts over every prunable leaf; a list
    aligns with the leaves and may mix ints, pairs and ``None`` (meaning
    ``DEFAULT_BLOCK``)."""
    if isinstance(block, list):
        if len(block) != len(flags):
            raise ValueError(
                f"per-leaf block list has {len(block)} entries for "
                f"{len(flags)} leaves")
        return [_block_pair(b if b is not None else DEFAULT_BLOCK)
                if f else None for f, b in zip(flags, block)]
    pair = _block_pair(block)
    return [pair if f else None for f in flags]


def block_l2_norms(w: torch.Tensor, block=DEFAULT_BLOCK) -> torch.Tensor:
    """Squared L2 norm of each (bk x bn) tile of a 2-D matrix, in float32
    (ragged edge tiles sum their real elements only)."""
    return _bn.tile_norms(w, *_block_pair(block))


def _tile_element_counts(m: int, n: int, block, device) -> torch.Tensor:
    """Number of real (unpadded) elements in each tile of an (m, n) matrix."""
    bk, bn = _block_pair(block)
    rows = torch.clamp_max(m - torch.arange(0, m, bk, device=device), bk)
    cols = torch.clamp_max(n - torch.arange(0, n, bn, device=device), bn)
    return rows[:, None] * cols[None, :]


class BlockNormState(NamedTuple):
    """Once-per-round ranking statistics for one prunable leaf."""

    norms: torch.Tensor         # lead + (Tk, Tn) tile squared-L2 norms, f32
    sorted_norms: torch.Tensor  # (T,) the same norms, ascending
    cum_frac: torch.Tensor      # (T,) cumulative element mass of sorted tiles


def _leaf_state(leaf: torch.Tensor, block, norms: torch.Tensor
                ) -> BlockNormState:
    counts = _tile_element_counts(leaf.shape[-2], leaf.shape[-1], block,
                                  leaf.device).expand(norms.shape)
    counts = counts.reshape(-1).to(torch.float32)
    flat = norms.reshape(-1)
    order = torch.argsort(flat, stable=True)
    cum = torch.cumsum(counts[order], dim=0)
    return BlockNormState(norms=norms, sorted_norms=flat[order],
                          cum_frac=cum / cum[-1])


def block_norm_state(params: PyTree, block=DEFAULT_BLOCK
                     ) -> list[Optional[BlockNormState]]:
    """Per-leaf ranking state in ``flatten(params)`` order (``None`` for
    1-D leaves, which are never pruned).  ``block`` is an int, a
    ``(bk, bn)`` pair or a per-leaf list (``leaf_blocks``).  A leaf with
    leading dims ranks all its tiles together, as the reference does.
    Every prunable leaf's tile norms come from one ``tile_norms_group``
    call (one launch on the card)."""
    leaves, flags = _flatten_prunable(params)
    blocks = leaf_blocks(flags, block)
    ranked = [i for i, f in enumerate(flags) if f]
    norms = _bn.tile_norms_group([leaves[i] for i in ranked],
                                 [blocks[i] for i in ranked])
    out: list[Optional[BlockNormState]] = [None] * len(leaves)
    for i, n in zip(ranked, norms):
        out[i] = _leaf_state(leaves[i], blocks[i], n)
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


def masks_from_keep(params: PyTree, keeps: list, block) -> PyTree:
    """Per-leaf tile keeps (``flatten`` order, ``None`` for unprunable
    leaves) -> element-level boolean masks shaped like ``params``."""
    leaves, flags = _flatten_prunable(params)
    masks = [_bsm.expand_mask(keep > 0, leaf.shape, *blk) if f
             else torch.ones(leaf.shape, dtype=torch.bool, device=leaf.device)
             for leaf, f, keep, blk in zip(leaves, flags, keeps,
                                           leaf_blocks(flags, block))]
    return unflatten(params, masks)


def apply_masks(params: PyTree, masks: PyTree) -> PyTree:
    """W * M: a boolean mask selects (zeros where dropped), a numeric mask
    multiplies."""
    def one(w, m):
        if m.dtype == torch.bool:
            return torch.where(m, w, torch.zeros((), dtype=w.dtype,
                                                 device=w.device))
        return w * m
    return unflatten(params, [one(w, m) for w, m in
                              zip(flatten(params), flatten(masks))])
