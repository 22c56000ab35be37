"""Pruned bundles: params plus the tile keeps the model is served with
(the port of ``repro.serve.export``).

The keeps come from the training code path itself (``pruning.
block_norm_state`` + ``block_keep`` over the task's tile grid), so the
masks applied at decode are those of the round that pruned.

On-disk format (``checkpoint.save`` .npz, the reference's):
    params/...        the parameter tree, unmasked
    keeps/k{i:04d}    float 0/1 tile keep for flattened leaf i (prunable
                      leaves only; shape = lead_dims + (Tk, Tn))
    meta/rho          scalar pruning rate the keeps were computed at
    meta/grid         (num_leaves, 2) int32 per-leaf (bk, bn); -1 rows
                      mark unprunable leaves
A bundle written by the reference's ``export_pruned`` loads here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core import pruning
from repro_torch.device import resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class PrunedBundle:
    """A serve-ready model: params + the tile keeps."""
    params: PyTree
    keeps: list                 # per-flat-leaf float tile keep or None
    grid: list                  # per-flat-leaf (bk, bn), None if unprunable
    rho: float

    def masks(self) -> PyTree:
        """Element-level masks (the dense oracle's view of the keeps)."""
        return pruning.masks_from_keep(self.params, self.keeps, self.grid)

    def masked_params(self) -> PyTree:
        return pruning.apply_masks(self.params, self.masks())


def _leaf_grid(params: PyTree, block) -> list:
    _, flags = pruning._flatten_prunable(params)
    return pruning.leaf_blocks(flags, block)


def make_bundle(task, params: PyTree, rho: float) -> PrunedBundle:
    """The tile keeps of ``params`` at rate ``rho`` on the task's tile grid,
    computed where the params lie (the card launches the tile-norm
    kernel)."""
    block = task.tile_grid(params)
    state = pruning.block_norm_state(params, block)
    device = pruning.flatten(params)[0].device
    keeps = pruning.block_keep(state, torch.tensor(rho, dtype=torch.float32,
                                                   device=device))
    return PrunedBundle(params=params, keeps=keeps,
                        grid=_leaf_grid(params, block), rho=float(rho))


def export_pruned(path: str, task, params: PyTree, rho: float
                  ) -> PrunedBundle:
    """Export ``params`` pruned at rate ``rho`` to ``path`` (.npz)."""
    bundle = make_bundle(task, params, rho)
    grid_arr = np.full((len(bundle.keeps), 2), -1, np.int32)
    keep_tree = {}
    for i, (keep, blk) in enumerate(zip(bundle.keeps, bundle.grid)):
        if keep is None:
            continue
        grid_arr[i] = blk
        keep_tree[f"k{i:04d}"] = keep.to(torch.float32)
    checkpoint.save(path, {
        "params": params,
        "keeps": keep_tree,
        "meta": {"rho": np.float32(rho), "grid": grid_arr},
    })
    return bundle


def export_from_result(path: str, task, result, rho: Optional[float] = None,
                       device=None) -> PrunedBundle:
    """Export a ``run_fleet`` result (its final params, host numpy) pruned
    at the final round's mean rate, unless ``rho`` is given.  The params
    go to ``device`` (the card unless ``"cpu"`` is passed), where the
    tiles are ranked."""
    if rho is None:
        rho = float(np.asarray(result.mean_prune)[-1])
    device = resolve_device(device)
    params = pruning.tree_map(
        lambda a: torch.as_tensor(np.array(a), device=device), result.params)
    return export_pruned(path, task, params, rho)


def load_pruned(path: str, task, device=None) -> PrunedBundle:
    """Load a bundle; parameter shapes and dtypes come from
    ``task.init_params`` on the ``meta`` device (nothing is drawn).
    Tensors go to ``device``: the card unless ``"cpu"`` is passed."""
    device = resolve_device(device)
    like = task.init_params(None)
    params = checkpoint.restore(path, {"params": like}, device)["params"]
    flat = checkpoint.restore_flat(path)
    grid_arr = np.asarray(flat["meta/grid"])
    keeps: list[Optional[torch.Tensor]] = []
    grid: list = []
    for i in range(len(pruning.flatten(params))):
        key = f"keeps/k{i:04d}"
        if key in flat:
            keeps.append(torch.as_tensor(np.array(flat[key]), device=device))
            grid.append((int(grid_arr[i, 0]), int(grid_arr[i, 1])))
        else:
            keeps.append(None)
            grid.append(None)
    return PrunedBundle(params=params, keeps=keeps, grid=grid,
                        rho=float(flat["meta/rho"]))
