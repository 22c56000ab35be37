"""Pruning masks: unstructured magnitude masks and block-structured tile masks.

The port of ``repro.core.pruning``.  Only >= 2-D leaves are prunable;
masks are ``torch.bool`` trees shaped like the params.

* ``magnitude_masks`` — global unstructured magnitude pruning: keep
  ``|w| > q``, q the rho-quantile of every prunable magnitude, with the
  linear interpolation of ``jnp.quantile`` (sort, ``pos = q (n - 1)``,
  floor and ceiling, weighted sum), in that order.  ``torch.quantile``
  takes one q for every row and refuses inputs above 2^24 elements, so it
  is not used.
* ``block_masks`` — every >= 2-D weight matrix is cut into (bk, bn)
  tiles; a round ranks the tiles once by squared L2 norm
  (``block_norm_state``) and every client's tile-keep indicators are then
  one ``searchsorted`` against the shared cumulative element mass
  (``block_keep``, ``masks_from_state``).  The threshold is an
  element-count-weighted quantile, so ragged edge tiles count only their
  real elements.

Every mask builder takes a rate of any shape R (a batch of clients) and
returns masks shaped R + leaf shape, one per rate: the sort runs once for
the whole batch, which is what the reference's ``vmap`` over clients
sharing one model amounts to.

Leaves with leading dims (a transformer stage's stacked layers) rank
tiles over the last two dims, batch-wise, exactly as the reference does.
``masks_from_keep`` / ``apply_masks`` turn keeps into the dense oracle's
masked params.  Per-leaf state lists follow ``flatten``'s order, which is
``jax.tree_util``'s: dict keys sorted, lists by index.

The tile norms come from ``kernels.block_norms.tile_norms_group``: for
tensors on the card one CUDA launch takes every prunable leaf of a
``block_norm_state`` call, in its own type; on the CPU the plain version.

Params may be DTensors (a tensor-sharded model, ``federated.trainer``).
The grouped call then takes each leaf's local shard, still one launch a
ranking a rank, and the per-tile norms of a leaf are all-gathered over
its sharding group into its whole grid (a tile's segments fold in a
fixed order, so where every shard boundary falls on a tile boundary the
norms, and so the masks, are bitwise the unsharded ones).  A leaf whose
shard boundaries cut tiles is gathered whole for the ranking alone
(``block_norm_state.gathers`` counts them): partial norms of a tile from
two shards would fold in another order.  The ranking itself runs on the
whole grids, plain tensors, and each rank builds the masks of its own
shards, DTensors with their leaves' placements.  ``apply_masks``,
``achieved_rate`` (over global elements) and ``value_and_grad`` (grads
with the params' placements, the value whole) take DTensors too.
"""

from __future__ import annotations

import numbers
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.kernels import block_norms as _bn
from repro_torch.kernels import block_sparse_matmul as _bsm

__all__ = [
    "prunable",
    "ones_masks",
    "sorted_magnitudes",
    "magnitude_masks",
    "block_masks",
    "masks_from_state",
    "achieved_rate",
    "tree_map",
    "BlockNormState",
    "block_l2_norms",
    "block_norm_state",
    "block_thresholds",
    "block_keep",
    "flatten",
    "unflatten",
    "value_and_grad",
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
    ``layer10`` precedes ``layer2``), lists and tuples (named ones too) by
    index, ``None`` an empty subtree.  Per-leaf state lists align with
    this order."""
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
            subs = [build(sub) for sub in node]
            # a named tuple takes its fields as arguments
            return type(node)(*subs) if hasattr(node, "_fields") \
                else type(node)(subs)
        if node is None:
            return None
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` (and of ``rest``, which share its
    structure), in ``flatten`` order."""
    return unflatten(tree, [fn(*xs) for xs in
                            zip(flatten(tree), *(flatten(t) for t in rest))])


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value as a plain tensor; a plain tensor as is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def value_and_grad(fn, params: PyTree):
    """``jax.value_and_grad(fn, has_aux=True)(params)`` by autograd:
    ``fn(params) -> (scalar, aux)``; returns ``((scalar, aux), grads)``,
    detached, the grads shaped and typed like ``params`` (zeros where
    the scalar does not depend on a leaf).  A DTensor leaf's grad is
    redistributed to the leaf's placements; a DTensor value or aux comes
    back whole, as a plain tensor."""
    leaves = [p.detach().requires_grad_() for p in flatten(params)]
    with torch.enable_grad():
        value, aux = fn(unflatten(params, leaves))
    grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                materialize_grads=True)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(p, DTensor) and g.placements != p.placements
             else g for p, g in zip(leaves, grads)]
    return ((_whole(value.detach()),
             tree_map(lambda a: _whole(a.detach()), aux)),
            unflatten(params, grads))


def prunable(path: tuple, leaf: torch.Tensor) -> bool:
    """Only >= 2-D weight tensors are prunable; biases stay dense."""
    del path
    return leaf.ndim >= 2


def _flatten_prunable(params: PyTree) -> tuple[list, list[bool]]:
    leaves = flatten(params)
    return leaves, [prunable((), leaf) for leaf in leaves]


def ones_masks(params: PyTree) -> PyTree:
    """rho = 0 masks: everything kept."""
    return tree_map(lambda w: torch.ones_like(w, dtype=torch.bool), params)


def _rate(rate, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The pruning rate as a tensor on ``like``'s device, clipped to [0, 1];
    a Python number takes ``dtype`` (what the reference's weakly typed
    scalar becomes under x64)."""
    if not isinstance(rate, torch.Tensor):
        rate = torch.tensor(rate, dtype=dtype)
    return torch.clamp(rate.to(like.device), 0.0, 1.0)


def _batched(x: torch.Tensor, rate: torch.Tensor, trailing: int
             ) -> torch.Tensor:
    """``x`` of ``rate.shape`` widened with ``trailing`` unit dims."""
    return x.reshape(tuple(rate.shape) + (1,) * trailing)


def sorted_magnitudes(params: PyTree) -> torch.Tensor:
    """Every prunable ``|w|``, concatenated in ``flatten`` order and sorted
    ascending: the once-per-model half of ``magnitude_masks``.  A NaN
    anywhere makes every entry NaN, as ``jnp.quantile`` does."""
    leaves, flags = _flatten_prunable(params)
    mags = torch.cat([torch.abs(w).reshape(-1)
                      for w, f in zip(leaves, flags) if f])
    mags = torch.where(torch.isnan(mags).any(), torch.nan, mags)
    return torch.sort(mags).values


def magnitude_masks(params: PyTree, prune_rate,
                    mags: Optional[torch.Tensor] = None) -> PyTree:
    """Global unstructured magnitude pruning at ``prune_rate`` (any shape
    R): keep ``|w| > q``, q the rate-quantile of every prunable magnitude
    (``jnp.quantile``'s linear interpolation, computed in the rate's
    dtype).  At rho = 0 this still drops the smallest magnitude, as the
    reference does.  ``mags`` is ``sorted_magnitudes(params)`` where the
    caller already has it."""
    leaves, flags = _flatten_prunable(params)
    if mags is None:
        mags = sorted_magnitudes(params)
    q = _rate(prune_rate, mags, torch.float64)
    n = mags.numel()
    pos = q * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    low = torch.clamp(low, 0, n - 1).long()
    high = torch.clamp(high, 0, n - 1).long()
    thresh = (mags[low].to(q.dtype) * low_w
              + mags[high].to(q.dtype) * high_w).to(mags.dtype)
    masks = [torch.abs(w) > _batched(thresh, q, w.ndim) if f
             else torch.ones(tuple(q.shape) + tuple(w.shape),
                             dtype=torch.bool, device=w.device)
             for w, f in zip(leaves, flags)]
    return unflatten(params, masks)


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


def _contiguous_stride(shape: tuple) -> tuple:
    stride, step = [], 1
    for n in reversed(shape):
        stride.append(step)
        step *= n
    return tuple(reversed(stride))


def _local_box(x: DTensor) -> list[slice]:
    """The global index range of each dim that this rank's shard of ``x``
    holds.  A dim sharded over several mesh dims is chunked in mesh
    order, the first the slowest; every sharded dim must divide evenly."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    start, size = [0] * x.ndim, list(x.shape)
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard):
            n = mesh.size(m)
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not "
                                 f"divide over {n} ranks")
            size[p.dim] //= n
            start[p.dim] += coord[m] * size[p.dim]
        elif not p.is_replicate():
            raise ValueError(f"{p} is neither Shard nor Replicate")
    return [slice(a, a + n) for a, n in zip(start, size)]


def _from_local(like: DTensor, local: torch.Tensor, lead: tuple = ()
                ) -> DTensor:
    """``local``, this rank's shard of a tensor of shape ``lead +
    like.shape`` placed as ``like`` (its sharded dims shifted past
    ``lead``)."""
    shift = len(lead)
    places = [Shard(p.dim + shift) if isinstance(p, Shard) else p
              for p in like.placements]
    shape = tuple(lead) + tuple(like.shape)
    return DTensor.from_local(local, like.device_mesh, places, shape=shape,
                              stride=_contiguous_stride(shape))


def _tiles_whole(x: DTensor, blk: tuple[int, int]) -> bool:
    """Every shard boundary of ``x`` falls on a tile boundary."""
    box = _local_box(x)
    return all((box[d].stop - box[d].start) % b == 0 or
               box[d].stop - box[d].start == x.shape[d]
               for d, b in ((x.ndim - 2, blk[0]), (x.ndim - 1, blk[1])))


def _whole_norms(leaf: DTensor, local: torch.Tensor) -> torch.Tensor:
    """The whole tile-norm grid of a leaf from each rank's grid of its
    shard, all-gathered over the leaf's sharding group one mesh dim at a
    time, the last first (so a dim sharded over several nests in mesh
    order).  ``dist.all_gather`` and not DTensor's: gloo has no
    functional all-gather of CUDA tensors."""
    mesh, out = leaf.device_mesh, local
    for m in reversed(range(mesh.ndim)):
        p = leaf.placements[m]
        if isinstance(p, Shard):
            parts = [torch.empty_like(out) for _ in range(mesh.size(m))]
            dist.all_gather(parts, out.contiguous(), group=mesh.get_group(m))
            out = torch.cat(parts, dim=p.dim)
    return out


def _leaf_norms(params: PyTree, block):
    """(leaves, flags, blocks, per-leaf tile norms or ``None``): every
    prunable leaf's norms from one ``tile_norms_group`` call, a DTensor
    leaf's from its local shard (whole grids all-gathered) or, where its
    shard boundaries cut tiles, from the leaf gathered whole."""
    leaves, flags = _flatten_prunable(params)
    blocks = leaf_blocks(flags, block)
    ranked = [i for i, f in enumerate(flags) if f]
    inputs, shards = [], []
    for i in ranked:
        w = leaves[i]
        if isinstance(w, DTensor):
            shards.append(_tiles_whole(w, blocks[i]))
            if shards[-1]:
                w = w.to_local()
            else:
                w = w.full_tensor()
                block_norm_state.gathers += 1
        else:
            shards.append(False)
        inputs.append(w)
    got = _bn.tile_norms_group(inputs, [blocks[i] for i in ranked])
    norms: list = [None] * len(leaves)
    for i, n, shard in zip(ranked, got, shards):
        norms[i] = _whole_norms(leaves[i], n) if shard else n
    return leaves, flags, blocks, norms


def block_norm_state(params: PyTree, block=DEFAULT_BLOCK
                     ) -> list[Optional[BlockNormState]]:
    """Per-leaf ranking state in ``flatten(params)`` order (``None`` for
    1-D leaves, which are never pruned).  ``block`` is an int, a
    ``(bk, bn)`` pair or a per-leaf list (``leaf_blocks``).  A leaf with
    leading dims ranks all its tiles together, as the reference does.
    Every prunable leaf's tile norms come from one ``tile_norms_group``
    call (one launch on the card)."""
    leaves, _, blocks, norms = _leaf_norms(params, block)
    return [None if n is None else _leaf_state(w, blk, n)
            for w, blk, n in zip(leaves, blocks, norms)]


block_norm_state.gathers = 0


def block_thresholds(state: BlockNormState, rate: torch.Tensor
                     ) -> torch.Tensor:
    """Smallest kept norm at pruning rate ``rate`` (any shape).  Tiles whose
    cumulative element mass is <= rate * total are dropped (right side)."""
    rate = torch.clamp(rate, 0.0, 1.0)
    dtype = torch.promote_types(rate.dtype, state.cum_frac.dtype)
    idx = torch.searchsorted(state.cum_frac.to(dtype),
                             rate.to(dtype).contiguous(), right=True)
    idx = torch.clamp(idx, 0, state.sorted_norms.numel() - 1)
    # indexed by a 1-D tensor: a 0-d index is read on the host (item()),
    # which a traced step (the dry run's fake tensors) cannot do
    return state.sorted_norms[idx.reshape(-1)].reshape(idx.shape)


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


def _shard_mask(leaf: DTensor, f: bool, keep, blk, lead: tuple) -> DTensor:
    """This rank's shard of a DTensor leaf's mask, placed as the leaf:
    its slice of the whole tile keeps expanded (or, where shard
    boundaries cut tiles, its slice of the whole mask)."""
    box = _local_box(leaf)
    pre = (slice(None),) * len(lead)
    local_shape = tuple(lead) + tuple(b.stop - b.start for b in box)
    if not f:
        local = torch.ones(local_shape, dtype=torch.bool, device=leaf.device)
    elif _tiles_whole(leaf, blk):
        tiles = [slice(b.start // t, -(-b.stop // t))
                 for b, t in zip(box[-2:], blk)]
        local = _bsm.expand_mask(keep[pre + tuple(box[:-2]) + tuple(tiles)],
                                 local_shape, *blk)
    else:
        local = _bsm.expand_mask(keep, leaf.shape, *blk)[pre + tuple(box)]
    return _from_local(leaf, local, lead)


def _tile_masks(leaves, flags, blocks, keeps, lead: tuple = ()) -> list:
    """Tile keeps -> element masks; unprunable leaves all ones, with the
    rate batch's ``lead`` dims.  DTensor leaves get DTensor masks."""
    return [_shard_mask(leaf, f, keep, blk, lead)
            if isinstance(leaf, DTensor)
            else _bsm.expand_mask(keep, leaf.shape, *blk) if f
            else torch.ones(lead + tuple(leaf.shape), dtype=torch.bool,
                            device=leaf.device)
            for leaf, f, keep, blk in zip(leaves, flags, keeps, blocks)]


def masks_from_state(params: PyTree, state: list[Optional[BlockNormState]],
                     rate, block=DEFAULT_BLOCK) -> PyTree:
    """Element-level boolean masks at ``rate`` (any shape R: masks R +
    leaf shape, every leaf) from a
    ``block_norm_state`` built with the same ``block``; a rate <= 0 keeps
    everything."""
    leaves, flags = _flatten_prunable(params)
    cum = next(st.cum_frac for st in state if st is not None)
    rate = _rate(rate, cum, cum.dtype)
    keeps = []
    for st in state:
        if st is None:
            keeps.append(None)
            continue
        nd = st.norms.ndim
        keeps.append((st.norms >= _batched(block_thresholds(st, rate), rate,
                                           nd))
                     | _batched(rate <= 0.0, rate, nd))
    return unflatten(params, _tile_masks(leaves, flags,
                                         leaf_blocks(flags, block), keeps,
                                         tuple(rate.shape)))


def block_masks(params: PyTree, prune_rate, block=DEFAULT_BLOCK,
                scope: str = "leaf") -> PyTree:
    """Block-structured magnitude masks at ``prune_rate`` (any shape R).

    ``scope="leaf"`` ranks the tiles within each leaf (every matrix loses
    the same share); ``scope="global"`` ranks every leaf's tiles together.
    Either way the threshold is an element-count-weighted quantile of the
    tile norms, and rho = 0 keeps everything."""
    if scope == "leaf":
        return masks_from_state(params, block_norm_state(params, block),
                                prune_rate, block)
    if scope != "global":
        raise ValueError(f"scope must be 'leaf' or 'global', got {scope!r}")
    leaves, flags, blocks, norms = _leaf_norms(params, block)
    norms_cat = torch.cat([n.reshape(-1) for n in norms if n is not None])
    counts_cat = torch.cat([
        _tile_element_counts(w.shape[-2], w.shape[-1], blk, w.device)
        .expand(n.shape).reshape(-1)
        for w, blk, n in zip(leaves, blocks, norms) if n is not None]
    ).to(torch.float32)
    order = torch.argsort(norms_cat, stable=True)
    cum = torch.cumsum(counts_cat[order], dim=0)
    g_state = BlockNormState(norms=norms_cat, sorted_norms=norms_cat[order],
                             cum_frac=cum / cum[-1])
    rate = _rate(prune_rate, cum, cum.dtype)
    g_thresh = block_thresholds(g_state, rate)
    keeps = [None if n is None else
             (n >= _batched(g_thresh, rate, n.ndim))
             | _batched(rate <= 0.0, rate, n.ndim) for n in norms]
    return unflatten(params, _tile_masks(leaves, flags, blocks, keeps,
                                         tuple(rate.shape)))


def achieved_rate(params: PyTree, masks: PyTree) -> torch.Tensor:
    """Realized rho = pruned / total elements over the prunable leaves, in
    float32 (masks with leading rate dims give one rate each); DTensor
    masks count their global elements."""
    leaves, flags = _flatten_prunable(params)
    kept = sum(_whole(m.to(torch.float32).sum(dim=tuple(range(-w.ndim, 0))))
               for w, m, f in zip(leaves, flatten(masks), flags) if f)
    total = float(sum(w.numel() for w, f in zip(leaves, flags) if f))
    return 1.0 - kept / total


def masks_from_keep(params: PyTree, keeps: list, block) -> PyTree:
    """Per-leaf tile keeps (``flatten`` order, ``None`` for unprunable
    leaves) -> element-level boolean masks shaped like ``params``."""
    leaves, flags = _flatten_prunable(params)
    keeps = [None if k is None else k > 0 for k in keeps]
    return unflatten(params, _tile_masks(leaves, flags,
                                         leaf_blocks(flags, block), keeps))


def apply_masks(params: PyTree, masks: PyTree) -> PyTree:
    """W * M: a boolean mask selects (zeros where dropped), a numeric mask
    multiplies."""
    def one(w, m):
        if m.dtype == torch.bool:
            return torch.where(m, w, torch.zeros((), dtype=w.dtype,
                                                 device=w.device))
        return w * m
    return tree_map(one, params, masks)
