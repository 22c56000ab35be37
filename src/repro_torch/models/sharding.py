"""Logical-axis sharding constraints for model internals (the port of
``repro.models.sharding``), on PyTorch's DTensor.

The model code annotates activations with *logical* dim names ("batch",
"seq", "embed", "heads", ...); a caller installs a rule set mapping
logical names to mesh dims.  With no rules, no mesh, or on a tensor that
is not a DTensor, everything is a no-op, so the unsharded paths keep
their bits.  A constraint redistributes a DTensor to the placements of
its logical spec on the DTensor's own mesh (``launch.shardings
.placements``), as ``with_sharding_constraint`` pins a GSPMD layout.

The reference's manual-axis branch (constraints inside ``shard_map``,
which may only name its Auto axes) has no counterpart: a port step that
is manual over its client dims holds DTensors on the mesh of its other
dims (``federated.trainer``), so a constraint there already names only
those.
"""

from __future__ import annotations

import contextlib
import math
import threading

from torch.distributed.tensor import DTensor, Replicate

from repro_torch.launch.shardings import mesh_axes, placements

_state = threading.local()

# Default production rules.  The client dims ("batch") cover both the
# single-pod ("data",) and multi-pod ("pod", "data") meshes.
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",   # expert parallelism (when E divides the dim)
    "cache_seq": "data",
    # context parallelism: flash-attention query stripes over "model",
    # which engages the tensor dim for attention even when head counts
    # do not divide it (see attention.flash_attention)
    "q_stripes": "model",
}


def set_rules(rules: dict | None, mesh=None) -> None:
    _state.rules = rules
    _state.mesh = mesh


def get_rules() -> dict | None:
    return getattr(_state, "rules", None)


def get_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_rules(rules: dict | None, mesh=None):
    """Install logical-axis rules and the mesh they bind to (a
    ``DeviceMesh``, or any object ``launch.shardings.mesh_axes`` reads)
    for the block's thread."""
    prev, prev_mesh = get_rules(), get_mesh()
    set_rules(rules, mesh)
    try:
        yield
    finally:
        set_rules(prev, prev_mesh)


def _mesh_axes(axes: dict, names) -> tuple | None:
    """A logical rule filtered down to the dims present in the mesh."""
    if names is None:
        return None
    if isinstance(names, str):
        names = (names,)
    present = tuple(n for n in names if n in axes)
    return present or None


def axis_size(logical_name: str) -> int:
    """Product of the mesh-dim sizes a logical dim maps to (1 without
    rules or mesh): lets model code pick parallel-friendly factorings."""
    rules, mesh = get_rules(), get_mesh()
    if rules is None or mesh is None:
        return 1
    axes = mesh_axes(mesh)
    names = _mesh_axes(axes, rules.get(logical_name))
    return math.prod(axes[a] for a in names) if names else 1


def constrain(x, *logical_axes):
    """Redistribute the DTensor ``x`` to the placements its logical dims
    map to; a no-op without rules, without a mesh, or on a plain tensor.
    Dims that a rule's mesh dims do not evenly divide, or that are
    smaller than them, are dropped (uneven sharding costs more in padding
    than it saves); when nothing survives, ``x`` is left alone (an empty
    spec would force replication)."""
    rules = get_rules()
    if rules is None or get_mesh() is None or not isinstance(x, DTensor):
        return x
    axes = mesh_axes(x.device_mesh)
    spec = []
    for dim, name in enumerate(logical_axes):
        names = None if name is None else _mesh_axes(axes, rules.get(name))
        if names is not None:
            size = math.prod(axes[a] for a in names)
            if dim >= x.ndim or x.shape[dim] % size or x.shape[dim] < size:
                names = None
        spec.append(names if names is None or len(names) > 1 else names[0])
    if all(s is None for s in spec):
        return x
    return x.redistribute(x.device_mesh, placements(tuple(spec),
                                                    x.device_mesh))


def replicate(x):
    """A DTensor redistributed to ``Replicate`` over its whole mesh (what an
    op without a sharding rule for ``x``'s layout needs); a plain tensor
    as is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
