"""Device meshes over ``torch.distributed`` ranks (the port of
``repro.launch.mesh``): one rank a device, the mesh a
``torch.distributed.device_mesh.DeviceMesh`` with named dims.

A mesh needs a default process group spanning its ranks.  When none is
up, ``make_mesh`` starts one (NCCL on the card, gloo on the CPU): over
``env://`` when a launcher such as ``torchrun`` has set ``WORLD_SIZE``
(with ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), else a world of
one over an in-process ``HashStore``, which needs no launcher
environment and no network.  A caller may start the group itself first.
``local_device`` gives each rank its own card (``LOCAL_RANK``).
Ranks that share one card run over gloo (NCCL takes one rank a card):
``gloo_cuda_all_gather`` then routes DTensor's all-gathers through one
that gloo has for CUDA tensors.  Importing this module touches no
device and starts no group.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

__all__ = ["SINGLE_POD", "MULTI_POD", "local_device", "make_mesh",
           "make_production_mesh", "make_host_mesh", "make_fleet_mesh",
           "required_devices", "gloo_cuda_all_gather"]

SINGLE_POD = (16, 16)                     # 256 ranks
MULTI_POD = (2, 16, 16)                   # 2 pods = 512 ranks


def local_device(device=None) -> torch.device:
    """``device`` resolved (None: the card).  On the card under a launcher
    that sets ``LOCAL_RANK``, an unindexed ``cuda`` is this process's own
    card, made the current one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None \
            and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev


def _ensure_group(device) -> str:
    """The device type of ``device`` (None: the card), after starting the
    default group if none is up: the launcher's world over ``env://``
    when ``WORLD_SIZE`` is set, else a world of one."""
    dev = local_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    return dev.type


def _world_size(device=None) -> int:
    """Ranks of the default group (started by ``_ensure_group`` if none
    is up)."""
    _ensure_group(device)
    return dist.get_world_size()


def make_mesh(shape, axes, device=None) -> DeviceMesh:
    """``init_device_mesh`` over the default group's ranks with dims named
    ``axes``; ``device`` (None: the card) sets the mesh's device type."""
    device_type = _ensure_group(device)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def required_devices(multi_pod: bool) -> int:
    return math.prod(MULTI_POD if multi_pod else SINGLE_POD)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, have = required_devices(multi_pod), _world_size(device)
    if have < need:
        raise RuntimeError(
            f"the {'multi' if multi_pod else 'single'}-pod production mesh "
            f"{shape} needs {need} ranks, the default group has {have}")
    return make_mesh(shape, axes, device)


def make_host_mesh(data: int | None = None, model: int = 1,
                   device=None) -> DeviceMesh:
    """Small ("data", "model") mesh over every rank of the default group
    (tests, examples, the training command line)."""
    data = data or (_world_size(device) // model)
    return make_mesh((data, model), ("data", "model"), device)


def make_fleet_mesh(cells: int | None = None, data: int | None = None,
                    device=None) -> DeviceMesh:
    """Two-dim fleet mesh ("cells", "data").  With neither size given the
    ranks split as near-square as possible, cells taking the smaller
    factor (per-cell client counts usually exceed the cell count's
    parallel grain)."""
    n = _world_size(device)
    if cells is None and data is None:
        cells = 1
        for f in range(math.isqrt(n), 0, -1):
            if n % f == 0:
                cells = f
                break
        data = n // cells
    elif cells is None:
        cells = n // data
    elif data is None:
        data = n // cells
    return make_mesh((cells, data), ("cells", "data"), device)


def _process_group(group) -> dist.ProcessGroup:
    """The process group a functional collective's ``group`` names: a
    group, a 1-D mesh, (mesh, mesh dim) or a group name."""
    if isinstance(group, DeviceMesh):
        return group.get_group()
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    if isinstance(group, str):
        return dist.distributed_c10d._resolve_process_group(group)
    return group


def gloo_cuda_all_gather() -> None:
    """Route DTensor's all-gathers of CUDA tensors over a gloo group
    through ``dist.all_gather``, which gathers the same bytes.  Gloo's
    functional all-gather of CUDA tensors (``all_gather_into_tensor``
    of ``_c10d_functional``, what DTensor issues for Shard -> Replicate)
    crashes the process on an H100 under torch 2.11, while its
    all-reduce, reduce-scatter and all-to-all work.  Other backends and
    CPU tensors keep the functional collective.  Idempotent."""
    from torch.distributed import _functional_collectives as funcol
    for name in ("all_gather_single", "all_gather_tensor"):
        original = getattr(funcol, name, None)
        if original is None or getattr(original, "gloo_cuda", False):
            continue

        def gathered(self, gather_dim, group, tag="", _original=original):
            pg = _process_group(group)
            if not self.is_cuda or dist.get_backend(pg) != "gloo":
                return _original(self, gather_dim, group, tag)
            parts = [torch.empty_like(self)
                     for _ in range(dist.get_world_size(pg))]
            dist.all_gather(parts, self.contiguous(), group=pg)
            return torch.cat(parts, dim=gather_dim)

        gathered.gloo_cuda = True
        setattr(funcol, name, gathered)
