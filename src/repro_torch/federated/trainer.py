"""Distributed pruned-FL train step (the port of
``repro.federated.trainer``): the paper's technique over
``torch.distributed`` ranks.

Clients map onto the mesh's client dims (("data",) single-pod,
("pod", "data") multi-pod): each rank hosts the client at its coordinate
on those dims.  Per step, every client

  1. derives its own pruning mask from its rho_i (block-structured
     magnitude pruning, computed on the fly: one grouped tile-norm
     launch on the card),
  2. computes the masked gradient of the masked model on its local batch,
  3. contributes K_i C_i grad_i to one weighted all-reduce implementing
     the BS aggregation rule Eq. (5) (``aggregation.psum_aggregate``),

and the global SGD update (``optimizers.sgd``) replays identically on
every rank, matching FedSGD exactly: every client holds the full model
semantically.

Every rank receives the whole ``(n * b, ...)`` batch and the ``(n,)``
vectors and takes its own slice by its client coordinate, which is the
reference's ``in_specs=P(client_axes)``; the ranks of one client share
it.  With ``tp_shard_params`` and a "model" dim above 1 the weights
shard within a client over the mesh's other dims: placements from
``launch.shardings.param_shardings(..., fsdp=False)``, as the
reference's ``in_shardings``.  The step then works on DTensors over the
client's own ranks (the mesh without its client dims, what the
reference's hybrid ``shard_map`` leaves Auto): DTensor propagates the
activations' layouts as GSPMD does (no logical rules are installed), the
ranking launches the tile-norm kernel on local shards, and Eq. (5)
all-reduces each local shard over the client group, the ranks that hold
the same shard.  Plain tensors a rank makes inside the step (positions,
masks, RoPE tables) are the same on every rank of a client and count as
replicated (``implicit_replication``).  ``fl_input_specs`` gives the
step's abstract inputs and their specs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core import aggregation, pruning
from repro_torch.fleet.task import FleetTask, TransformerTask
from repro_torch.launch import shardings as SH
from repro_torch.optimizers import sgd

__all__ = ["num_clients", "client_index", "client_group",
           "make_task_train_step", "make_fl_train_step", "fl_input_specs"]

PyTree = Any


def _dims(mesh: DeviceMesh, axes) -> list[int]:
    return [mesh.mesh_dim_names.index(a) for a in axes]


def num_clients(mesh, client_axes: tuple[str, ...]) -> int:
    axes = SH.mesh_axes(mesh)
    return math.prod(axes[a] for a in client_axes)


def client_index(mesh: DeviceMesh, client_axes: tuple[str, ...]) -> int:
    """This rank's client: its coordinate on the client dims, row-major
    (the first dim the slowest, as ``P(client_axes)`` lays clients out)."""
    coord = mesh.get_coordinate()
    index = 0
    for d in _dims(mesh, client_axes):
        index = index * mesh.shape[d] + coord[d]
    return index


def client_group(mesh: DeviceMesh, client_axes: tuple[str, ...]):
    """The process group of this rank's fellow clients: the ranks that
    differ from it on the client dims only."""
    if len(client_axes) == 1:
        return mesh.get_group(client_axes[0])
    # DeviceMesh has no public group over several dims: flatten them
    return mesh[tuple(client_axes)]._flatten().get_group()


def make_task_train_step(task: FleetTask, mesh: DeviceMesh,
                         client_axes: tuple[str, ...] = ("data",),
                         lr: float = 1e-2, tp_shard_params: bool = True):
    """The distributed FL train step for any ``FleetTask``: masks from
    ``task.tile_grid``, the local objective ``task.loss``, the Eq.-(5)
    aggregation and the FedSGD update.  The returned function is
        (params, batch, rho, arrivals, k) -> (params, metrics)
      batch: task-batch tree, every leaf (num_clients * per_client_batch,
      ...); rho / arrivals / k: (num_clients,), host-computed by the
      trade-off optimizer and channel simulation;
      metrics: ``loss`` (the mean over clients) and ``achieved_rho``
      ((num_clients,)), the same on every rank.

    With ``tp_shard_params`` and a "model" dim above 1, ``params`` may be
    plain tensors (the whole model, the same on every rank) or the
    DTensors a step returns; the returned params are DTensors on
    ``mesh`` with the placements of ``param_shardings(params, mesh,
    fsdp=False)``.
    """
    client_axes = tuple(client_axes)
    names = mesh.mesh_dim_names
    n = num_clients(mesh, client_axes)
    me = client_index(mesh, client_axes)
    group = client_group(mesh, client_axes)
    update = sgd().update
    tp = tp_shard_params and "model" in names \
        and mesh.shape[names.index("model")] > 1
    if tp:
        inner_names = tuple(a for a in names if a not in client_axes)
        inner = mesh[inner_names]

    def placed(params):
        """(params as DTensors over this client's ranks, a function that
        puts such a tree back on ``mesh``)."""
        specs = SH.param_shardings(params, mesh, fsdp=False)
        full = [SH.placements(spec, mesh)
                for spec in SH.leaves_like(specs, params)]
        local = []
        for p, places in zip(pruning.flatten(params), full):
            # fsdp=False names no client dim: the params replicate there
            ours = tuple(pl for a, pl in zip(names, places)
                         if a in inner_names)
            if isinstance(p, DTensor):
                if p.device_mesh != mesh or tuple(p.placements) != places:
                    raise ValueError(f"a DTensor param placed "
                                     f"{p.placements} on "
                                     f"{p.device_mesh.mesh_dim_names}, "
                                     f"not {places} on {names}")
                p = DTensor.from_local(p.to_local(), inner, ours,
                                       shape=p.shape, stride=p.stride())
            else:
                p = distribute_tensor(p, inner, ours, src_data_rank=None)
            local.append(p)

        def back(tree):
            return pruning.unflatten(tree, [
                DTensor.from_local(p.to_local(), mesh, places,
                                   shape=p.shape, stride=p.stride())
                for p, places in zip(pruning.flatten(tree), full)])

        return pruning.unflatten(params, local), back

    def step(params, batch, rho, arrivals, k):
        def mine(leaf):
            b = leaf.shape[0] // n
            return leaf[me * b:(me + 1) * b]

        batch_i = pruning.tree_map(mine, batch)
        back = None
        if tp:
            params, back = placed(params)
        with implicit_replication() if tp else contextlib.nullcontext():
            with torch.no_grad():
                masks = pruning.block_masks(params, rho[me],
                                            block=task.tile_grid(params))
            (loss, _), grads = pruning.value_and_grad(
                lambda p: (task.loss(pruning.apply_masks(p, masks),
                                     batch_i), None), params)
            with torch.no_grad():
                grads = pruning.apply_masks(grads, masks)
                g = aggregation.psum_aggregate(grads, k[me], arrivals[me],
                                               group)
                new_params, _ = update(params, g, {}, lr)
                total = loss.clone()
                dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
                achieved = pruning.achieved_rate(params, masks).reshape(1)
                rates = [torch.empty_like(achieved) for _ in range(n)]
                dist.all_gather(rates, achieved, group=group)
        if back is not None:
            new_params = back(new_params)
        return new_params, {"loss": total / n,
                            "achieved_rho": torch.cat(rates)}

    return step


def make_fl_train_step(cfg, mesh: DeviceMesh,
                       client_axes: tuple[str, ...] = ("data",),
                       block: int = 128, lr: float = 1e-2,
                       tp_shard_params: bool = True):
    """The distributed FL train step for an ArchConfig model: ``cfg`` in
    a ``TransformerTask`` with a uniform ``block`` tile grid, through
    ``make_task_train_step``."""
    task = TransformerTask(arch=cfg, block=block)
    return make_task_train_step(task, mesh, client_axes=client_axes, lr=lr,
                                tp_shard_params=tp_shard_params)


def fl_input_specs(cfg, mesh, client_axes: tuple[str, ...],
                   per_client_batch: int, seq_len: int):
    """Abstract inputs and specs for the FL step: ``(batch, vec, specs)``,
    ``batch`` the tokens and ``vec`` a per-client vector as ``meta``
    tensors (int32 tokens, as the reference's), ``specs`` mirroring the
    step's (batch, rho, arrivals, k): every one over the client dims."""
    del cfg
    n = num_clients(mesh, client_axes)
    caxes = client_axes if len(client_axes) > 1 else client_axes[0]
    batch = {"tokens": torch.empty((n * per_client_batch, seq_len),
                                   dtype=torch.int32, device="meta")}
    vec = torch.empty((n,), dtype=torch.float32, device="meta")
    spec = (caxes,)
    return batch, vec, ({"tokens": spec}, spec, spec, spec)
