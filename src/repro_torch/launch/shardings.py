"""Sharding inference for the production mesh (the port of
``repro.launch.shardings``), with PyTorch's DTensor in place of GSPMD.

A spec is a tuple with one entry per tensor dim: ``None``, a mesh-dim
name, or a tuple of names (one tensor dim over several mesh dims, the
first the slowest): the entries of the reference's ``PartitionSpec``.
``placements(spec, mesh)`` turns a spec into DTensor placements, one per
mesh dim.

Parameters get 2-D "fsdp x tensor" sharding: of the last two dims, the
larger shards over "model" and the other over "data" (when divisible);
embeddings shard (vocab -> "model", d_model -> "data").  Activations,
batches and caches go through ``data_pspec``: the batch dim shards over
the client dims ("pod", "data"), then the largest remaining dim takes
"model" (KV-cache sequence or head dims), then leftover dims greedily.

The spec functions read a mesh only through its dim names and sizes: a
``DeviceMesh`` (``mesh_dim_names``, ``shape``) or any object with a
``shape`` mapping and ``axis_names``, so the specs of a 16 x 16 or
2 x 16 x 16 production mesh are computed without its ranks.
"""

from __future__ import annotations

import math
from typing import Any

from torch.distributed.tensor import Replicate, Shard

from repro_torch.core.pruning import flatten, unflatten

__all__ = ["mesh_axes", "client_axes", "param_pspec", "data_pspec",
           "leaves_like", "tree_map_with_path", "param_shardings", "serving_fsdp_needed",
           "cache_shardings", "batch_shardings", "replicated", "placements"]

PyTree = Any
Spec = tuple


def mesh_axes(mesh) -> dict[str, int]:
    """``{dim name: size}`` in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def client_axes(mesh) -> tuple[str, ...]:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def param_pspec(path: str, shape: tuple[int, ...], mesh,
                fsdp: bool = True) -> Spec:
    """fsdp=False (serving): weights shard over "model" only, no per-layer
    weight all-gathers; for params that fit a card without the data dim."""
    data = _axis_size(mesh, "data") if fsdp else 1
    model = _axis_size(mesh, "model")
    spec: list = [None] * len(shape)
    if "embedding" in path and len(shape) == 2:
        v, d = shape
        spec[0] = "model" if v % model == 0 else None
        spec[1] = "data" if (fsdp and d % data == 0 and data > 1) else None
        return tuple(spec)
    if len(shape) >= 4 and shape[1] % model == 0 and shape[1] >= model:
        # (layers, experts, d_in, d_ff): expert parallelism, experts over
        # "model", fsdp on the larger weight dim; the Megatron rule below
        # when the expert count does not divide the tensor dim (grok's 8)
        spec[1] = "model"
        a, b = shape[-2], shape[-1]
        big = -2 if a >= b else -1
        if fsdp and shape[big] % data == 0 and shape[big] >= 2 * data \
                and data > 1:
            spec[big] = "data"
        return tuple(spec)
    if len(shape) >= 2:
        a, b = shape[-2], shape[-1]
        # Megatron alignment: the larger of the last two dims (the ff or
        # expanded dim) over "model", so column- and row-parallel products
        # both keep the tensor dim on it; the other over "data" (fsdp).
        # Ties (square projections) keep (data, model).
        if a > b:
            if a % model == 0 and a >= 2 * model:
                spec[-2] = "model"
            if b % data == 0 and b >= 2 * data and data > 1:
                spec[-1] = "data"
        else:
            if a % data == 0 and a >= 2 * data and data > 1:
                spec[-2] = "data"
            if b % model == 0 and b >= 2 * model:
                spec[-1] = "model"
    return tuple(spec)


def data_pspec(shape: tuple[int, ...], mesh,
               batch_dim: int | None = 0) -> Spec:
    axes = mesh_axes(mesh)
    caxes = client_axes(mesh)
    csize = math.prod(axes[a] for a in caxes)
    model = axes.get("model", 1)
    spec: list = [None] * len(shape)
    used_client = False
    if batch_dim is not None and len(shape) > batch_dim:
        b = shape[batch_dim]
        if caxes and b % csize == 0 and b > 0 and b >= csize:
            spec[batch_dim] = caxes if len(caxes) > 1 else caxes[0]
            used_client = True
        elif "data" in axes and b % axes["data"] == 0 and b >= axes["data"]:
            spec[batch_dim] = "data"
            used_client = True
    # "model" to the largest remaining divisible dim
    order = sorted((d for d in range(len(shape)) if spec[d] is None),
                   key=lambda d: -shape[d])
    for d in order:
        if shape[d] % model == 0 and shape[d] >= 2 * model:
            spec[d] = "model"
            break
    # client dims unused (a batch of 1): the next largest dim takes them
    if not used_client and caxes:
        for d in order:
            if spec[d] is None and shape[d] % csize == 0 \
                    and shape[d] >= 2 * csize:
                spec[d] = caxes if len(caxes) > 1 else caxes[0]
                break
    return tuple(spec)


def leaves_like(tree: PyTree, like: PyTree) -> list:
    """The nodes of ``tree`` at the leaves of ``like``, in ``flatten``
    order: how a tree of specs (tuples, which ``flatten`` would walk
    into) lines up with the tensors they describe."""
    if isinstance(like, dict):
        return [x for key in sorted(like)
                for x in leaves_like(tree[key], like[key])]
    if isinstance(like, (list, tuple)):
        return [x for t, sub in zip(tree, like) for x in leaves_like(t, sub)]
    return [] if like is None else [tree]


def tree_map_with_path(fn, tree: PyTree) -> PyTree:
    """``fn(path, leaf)`` over the leaves of ``tree``, ``path`` the keys
    and indices from the root joined by "/" (the reference's
    ``_path_str`` of a ``jax.tree_util`` key path)."""
    paths: list[str] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], prefix + (str(key),))
        elif isinstance(node, (list, tuple)):
            for i, sub in enumerate(node):
                walk(sub, prefix + (str(i),))
        elif node is not None:
            paths.append("/".join(prefix))

    walk(tree, ())
    return unflatten(tree, [fn(p, leaf)
                            for p, leaf in zip(paths, flatten(tree))])


def param_shardings(params_shape: PyTree, mesh, fsdp: bool = True) -> PyTree:
    """The spec of every leaf of a params tree (tensors or ``meta``
    tensors)."""
    return tree_map_with_path(
        lambda path, leaf: param_pspec(path, tuple(leaf.shape), mesh,
                                       fsdp=fsdp), params_shape)


# per-card memory budget for serving-mode (tensor-only) weight residency
_SERVING_HBM_BUDGET = 12 * 2**30


def serving_fsdp_needed(params_shape: PyTree, mesh) -> bool:
    """True if tensor-only sharding would overflow the per-card budget
    (then serving keeps fsdp weight sharding and pays the all-gathers)."""
    total = sum(leaf.numel() * leaf.element_size()
                for leaf in flatten(params_shape))
    return total / max(_axis_size(mesh, "model"), 1) > _SERVING_HBM_BUDGET


def cache_shardings(cache_shape: PyTree, mesh) -> PyTree:
    """Specs of a decode-cache tree: stacked stage leaves (L, B, S, h, d)
    / (L, B, ...states) take batch dim 1; ``pos`` and leaves of rank 1 or
    less are replicated."""
    def one(path, leaf):
        if path == "pos" or leaf.ndim <= 1:
            return ()
        return data_pspec(tuple(leaf.shape), mesh, batch_dim=1)
    return tree_map_with_path(one, cache_shape)


def batch_shardings(batch_shape: PyTree, mesh) -> PyTree:
    return tree_map_with_path(
        lambda _, leaf: data_pspec(tuple(leaf.shape), mesh, batch_dim=0),
        batch_shape)


def replicated(tree: PyTree, mesh) -> PyTree:
    del mesh
    return tree_map_with_path(lambda _, leaf: (), tree)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): one
    per mesh dim, ``Shard(d)`` where that dim names tensor dim d, else
    ``Replicate()``.  A tuple entry shards its tensor dim over its mesh
    dims, which must come in mesh order: DTensor then chunks the first
    the slowest, the reference's row-major layout.  A name the mesh
    lacks, or a mesh dim named twice, raises."""
    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        for name in group:
            if name not in names:
                raise ValueError(f"spec {spec} names {name!r}, which mesh "
                                 f"dims {tuple(names)} lack")
            if out[names.index(name)] != Replicate():
                raise ValueError(f"spec {spec} names {name!r} twice")
            out[names.index(name)] = Shard(d)
        at = [names.index(name) for name in group]
        if at != sorted(at):
            raise ValueError(f"spec entry {group} is not in mesh order "
                             f"{tuple(names)}")
    return tuple(out)

