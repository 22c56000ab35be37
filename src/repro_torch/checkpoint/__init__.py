"""Path-keyed ``.npz`` checkpoints in the reference's format
(``repro.checkpoint``): a file written by either package loads in both.

A leaf's key joins its path with ``"\\x1f"``; a dict entry contributes its
key and a list entry its index.  Leaves are numpy arrays; bfloat16 tensors
are written as float32 (numpy has no bfloat16), and a bfloat16 array
written by the reference (stored as 2-byte void records) reads back as
bfloat16.  ``restore`` casts every leaf to the dtype of the ``like`` tree.

Sharded params (DTensors, e.g. the mesh trainer's with
``tp_shard_params``) are written whole, as the reference writes a sharded
``jax.Array``, and restore into the ``like`` tree's placements.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core import pruning

PyTree = Any
_SEP = "\x1f"  # unit separator: never appears in sane key names


def _paths(tree: PyTree, prefix: tuple = ()) -> list[tuple]:
    """Leaf paths in ``pruning.flatten`` order."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in _paths(tree[key], prefix + (str(key),))]
    if isinstance(tree, (list, tuple)):
        return [p for i, sub in enumerate(tree)
                for p in _paths(sub, prefix + (str(i),))]
    if tree is None:
        return []
    return [prefix]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):    # a collective over the leaf's mesh
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bfloat16 bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(path: str, tree: PyTree) -> None:
    """Write ``tree`` to ``path``.  A tree with DTensor leaves is saved
    collectively: every rank of the default group calls ``save``, each
    leaf is gathered whole (``full_tensor``), rank 0 alone writes the file
    and every rank returns once it is written."""
    leaves = pruning.flatten(tree)
    flat = {_SEP.join(p): _to_numpy(leaf)
            for p, leaf in zip(_paths(tree), leaves)}
    sharded = any(isinstance(leaf, DTensor) for leaf in leaves)
    if not sharded or dist.get_rank() == 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **flat)
    if sharded:
        dist.barrier()


def restore_flat(path: str) -> dict[str, np.ndarray]:
    """Raw view of a checkpoint: ``{"a/b/c": array, ...}`` (keys joined
    with "/"), for readers whose keys live in the file."""
    with np.load(path) as data:
        return {k.replace(_SEP, "/"): v for k, v in dict(data).items()}


def restore(path: str, like: PyTree, device=None) -> PyTree:
    """Restore into the structure of ``like`` (a tree of tensors, possibly
    on ``meta``): shapes are checked, dtypes taken from ``like``, tensors
    placed on ``device`` (``None``: the CPU, where numpy data lands).  A
    DTensor leaf of ``like`` gives a DTensor on its mesh with its
    placements, each rank slicing its own shard from the whole array
    (no collective), on the device of its local shard."""
    with np.load(path) as data:
        flat = dict(data)
    leaves = []
    for p, leaf in zip(_paths(like), pruning.flatten(like)):
        key = _SEP.join(p)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key!r}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        if isinstance(leaf, DTensor):
            whole = _to_tensor(arr).to(device=leaf.to_local().device,
                                       dtype=leaf.dtype)
            leaves.append(distribute_tensor(whole, leaf.device_mesh,
                                            leaf.placements,
                                            src_data_rank=None))
        else:
            leaves.append(_to_tensor(arr).to(device=device,
                                             dtype=leaf.dtype))
    return pruning.unflatten(like, leaves)
