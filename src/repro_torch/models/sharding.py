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

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


def _view_groups(src: tuple, dst: tuple) -> list:
    """The (source dims, destination dims) runs a view of shape ``src``
    as ``dst`` maps onto each other, in order (a run's sizes multiply to
    the same product; trailing size-1 dims join the last run)."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        a, b = [i], [j]
        pa, pb = src[i], dst[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                pa *= src[i]
                a.append(i)
                i += 1
            else:
                pb *= dst[j]
                b.append(j)
                j += 1
        groups.append((a, b))
    if groups:
        groups[-1][0].extend(range(i, len(src)))
        groups[-1][1].extend(range(j, len(dst)))
    return groups


def _contiguous(x):
    """The DTensor ``x`` contiguous, its local shard too.  DTensor's copy
    of a strided ``Partial`` may shard a dim (the view then replicates
    it); a shard that an uneven split padded and DTensor narrowed back is
    strided under a contiguous DTensor, and a view of it fails on fake
    tensors (the dry run): the copy is the one a real view would make."""
    x = x.contiguous()
    if x.to_local().is_contiguous():
        return x
    return DTensor.from_local(x.to_local().contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def _viewable(x, shape: tuple):
    """The DTensor ``x`` with every shard that a view as ``shape`` would
    cut replicated: a shard survives on a dim the view keeps whole, or on
    the first dim of a split or merged run while the product of its mesh
    dims' sizes divides both that dim and the run's first destination
    dim (then every chunk boundary falls on a boundary of the view)."""
    x = _contiguous(x)
    src, sizes = tuple(x.shape), x.device_mesh.shape
    places = list(x.placements)
    for a, b in _view_groups(src, tuple(shape)):
        if len(a) == 1 and len(b) == 1:
            continue
        kept = 1
        for i, p in enumerate(places):
            if not isinstance(p, Shard) or p.dim not in a:
                continue
            k = kept * sizes[i]
            if type(p) is Shard and p.dim == a[0] and not src[a[0]] % k \
                    and not shape[b[0]] % k:
                kept = k
            else:
                places[i] = Replicate()
    if places == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, places)


class _View(torch.autograd.Function):
    """A DTensor view whose forward and backward each replicate the
    shards the view would cut (``_viewable``); the backward places the
    gradient as the input was placed."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape, ctx.placements = tuple(x.shape), tuple(x.placements)
        return _viewable(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        grad = _viewable(grad, ctx.shape).reshape(ctx.shape)
        # a Partial input's gradient is replicated
        places = tuple(Replicate() if p.is_partial() else p
                       for p in ctx.placements)
        if tuple(grad.placements) != places:
            grad = grad.redistribute(grad.device_mesh, places)
        return grad, None


def view(x, shape):
    """``x.reshape(shape)``.  On a DTensor, the shards the view would cut
    (9 heads over a 16-wide "model" dim, a sequence shard flattened under
    a batch shard) are replicated first, in the forward and in the
    backward: DTensor refuses such a view, and XLA's SPMD partitioner
    reshards it the same way.  The values do not change; a plain tensor
    is only reshaped."""
    shape = tuple(shape)
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _View.apply(x, shape)


def split_heads(x, n: int):
    """``x`` with its last dim viewed as ``(n, last // n)`` (a feature dim
    as heads x head dim), through ``view``."""
    return view(x, x.shape[:-1] + (n, x.shape[-1] // n))


def merge_heads(x):
    """``x`` (..., n, hd) with its last two dims viewed as one, the
    inverse of ``split_heads``, through ``view``."""
    return view(x, x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def matmul(x, w):
    """``x @ w``.  A DTensor ``x`` of more than two dims is flattened to
    rows through ``view`` first, so the shards the flatten would cut (a
    sequence shard under a batch shard, which DTensor's own flatten turns
    into a strided shard that fake tensors cannot propagate a product
    over) are replicated; the product is viewed back.  A plain ``x`` is
    multiplied as it is."""
    if not isinstance(x, DTensor) or x.ndim <= 2:
        return x @ w
    lead = tuple(x.shape[:-1])
    y = view(x, (math.prod(lead), x.shape[-1])) @ w
    return view(y, lead + (y.shape[-1],))


def unbind(x):
    """``torch.unbind(x)`` over dim 0 (a stage's stacked repeats).  A
    DTensor sharded there is replicated there first: DTensor unbinds no
    sharded dim, and XLA slices a sharded stack by gathering it too."""
    if isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim == 0 for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == 0 else p
            for p in x.placements])
    return torch.unbind(x)


def batch_local(fn, *tensors, shared=()):
    """``fn(*tensors, *shared)`` on each rank's rows of the batch (dim 0
    of every tensor of ``tensors``) when any is a DTensor: each is
    redistributed to the first DTensor's shards of dim 0 (its other mesh
    dims replicated; a plain tensor counts as replicated), each of
    ``shared`` to ``Replicate``, ``fn`` runs on the local tensors, and
    the tensor it returns (batch on dim 0) comes back as a DTensor with
    those placements.  ``fn`` must treat batch rows independently: a
    time loop (the recurrent mixers) then runs as plain ops on local
    shards, as it would in ``shard_map``, not as a DTensor op a step.
    Without DTensors, ``fn(*tensors, *shared)``."""
    first = next((t for t in tensors + tuple(shared)
                  if isinstance(t, DTensor)), None)
    if first is None:
        return fn(*tensors, *shared)
    mesh = first.device_mesh
    lead = next((t for t in tensors if isinstance(t, DTensor)), first)
    rows = [Shard(0) if type(p) is Shard and p.dim == 0 else Replicate()
            for p in lead.placements]
    whole = [Replicate()] * mesh.ndim

    # a shared tensor's grad from each rank's rows is a partial sum
    summed = [Partial() if r == Shard(0) else Replicate() for r in rows]

    def local(t, places, grads):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, whole, run_check=False)
        return t.redistribute(mesh, places).to_local(grad_placements=grads)

    out = fn(*[local(t, rows, rows) for t in tensors],
             *[local(t, whole, summed) for t in shared])
    shape = (tensors[0].shape[0],) + tuple(out.shape[1:])
    return DTensor.from_local(
        out, mesh, rows, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())
