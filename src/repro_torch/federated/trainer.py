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
every rank.  Params are replicated across the client dims (the paper's
UEs hold the full model), matching FedSGD exactly.

Every rank receives the whole ``(n * b, ...)`` batch and the ``(n,)``
vectors and takes its own slice by its client coordinate, which is the
reference's ``in_specs=P(client_axes)``.  Sharding the weights over a
tensor dim (``tp_shard_params`` with a "model" dim above 1) and the
reference's ``fl_input_specs`` wait for the sharding slice (ROADMAP.md
Queue A, item 10).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import aggregation, pruning
from repro_torch.fleet.task import FleetTask, TransformerTask
from repro_torch.optimizers import sgd

__all__ = ["num_clients", "client_index", "client_group",
           "make_task_train_step", "make_fl_train_step"]

PyTree = Any


def _dims(mesh: DeviceMesh, axes) -> list[int]:
    return [mesh.mesh_dim_names.index(a) for a in axes]


def num_clients(mesh: DeviceMesh, client_axes: tuple[str, ...]) -> int:
    return math.prod(mesh.shape[d] for d in _dims(mesh, client_axes))


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
    """
    client_axes = tuple(client_axes)
    names = mesh.mesh_dim_names
    if tp_shard_params and "model" in names \
            and mesh.shape[names.index("model")] > 1:
        raise NotImplementedError(
            "tp_shard_params over a 'model' dim above 1 shards the weights "
            "within a client, which waits for the sharding slice "
            "(ROADMAP.md Queue A, item 10); pass tp_shard_params=False to "
            "replicate them")
    n = num_clients(mesh, client_axes)
    me = client_index(mesh, client_axes)
    group = client_group(mesh, client_axes)
    update = sgd().update

    def step(params, batch, rho, arrivals, k):
        def mine(leaf):
            b = leaf.shape[0] // n
            return leaf[me * b:(me + 1) * b]

        batch_i = pruning.tree_map(mine, batch)
        with torch.no_grad():
            masks = pruning.block_masks(params, rho[me],
                                        block=task.tile_grid(params))
        (loss, _), grads = pruning.value_and_grad(
            lambda p: (task.loss(pruning.apply_masks(p, masks), batch_i),
                       None), params)
        with torch.no_grad():
            grads = pruning.apply_masks(grads, masks)
            g = aggregation.psum_aggregate(grads, k[me], arrivals[me], group)
            new_params, _ = update(params, g, {}, lr)
            total = loss.clone()
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
            achieved = pruning.achieved_rate(params, masks).reshape(1)
            rates = [torch.empty_like(achieved) for _ in range(n)]
            dist.all_gather(rates, achieved, group=group)
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
