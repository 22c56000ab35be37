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

Where DTensor's own propagation would gather what XLA keeps local, a
helper runs the code on local shards, as ``shard_map`` would:
``batch_local`` (a function of independent batch rows: the recurrent
time loops), ``stripes_local`` (flash attention's chunk loop on each
rank's rows and query stripes), ``attention_local`` (attention on each
rank's batch rows, kv heads or key slice, the key slices' softmax
combined across ranks), ``write_slots`` (a decode cache's new entries
written into each rank's own rows and slots) and ``vocab_nll`` (the
loss over a vocab-sharded unembedding).  ``matmul`` places a product's
operands so that it keeps the rows' and outputs' shards, and ``pad``
pads local shards.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
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


def _is_shard(p, dim: int) -> bool:
    return type(p) is Shard and p.dim == dim


def _placement(x, i: int):
    """``x``'s placement on mesh dim ``i`` (a plain tensor is
    replicated)."""
    return x.placements[i] if isinstance(x, DTensor) else Replicate()


def _by_role(roles: list, role_map: dict) -> list:
    """One placement a mesh dim: ``role_map`` of the dim's role, else
    ``Replicate``."""
    return [role_map.get(r, Replicate()) for r in roles]


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


def gathered(w, x):
    """The DTensor weight ``w`` replicated on every mesh dim that shards
    the rows (dim 0) of the DTensor ``x``: each rank's rows meet the whole
    weight there (the FSDP all-gather; the backward reduce-scatters the
    weight's grad back to its shards).  DTensor would otherwise pick a
    product over the weight's sharded input dim and move the rows (the
    whole batch's logits summed across ranks in the loss)."""
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return w
    places = [Replicate() if _is_shard(xp, 0) and isinstance(wp, Shard)
              else wp for xp, wp in zip(x.placements, w.placements)]
    if places == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, places)


def _features_whole(x, w):
    """The 2-D DTensor ``x`` with its features (dim 1) replicated on every
    mesh dim that shards ``w``'s output features: each rank then computes
    its slice of the outputs from whole rows (the gather before a
    column-parallel product).  DTensor would otherwise move the weight to
    a product over sharded features, every rank summing partial rows of
    all the outputs."""
    if not isinstance(w, DTensor):
        return x
    places = [Replicate() if _is_shard(xp, 1) and _is_shard(wp, 1) else xp
              for xp, wp in zip(x.placements, w.placements)]
    if places == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, places)


def matmul(x, w):
    """``x @ w``.  A DTensor ``x`` of more than two dims is flattened to
    rows through ``view`` first, so the shards the flatten would cut (a
    sequence shard under a batch shard, which DTensor's own flatten turns
    into a strided shard that fake tensors cannot propagate a product
    over) are replicated; the product is viewed back.  The operands are
    placed so that the product keeps the rows' and the outputs' shards: a
    DTensor weight is gathered over the mesh dims that shard the rows
    (``gathered``), and the rows' features over the mesh dims that shard
    the weight's outputs (``_features_whole``).  A product over sharded
    features (the weight's input dim sharded) is summed across them at
    once: a partial sum would meet a sharded bias or residual next, and
    how DTensor then moves them differs between torch versions (2.11
    asks a shard to become a partial sum, which it cannot).  A plain
    ``x`` is multiplied as it is."""
    if not isinstance(x, DTensor):
        return x @ w
    lead = tuple(x.shape[:-1])
    rows = x if x.ndim <= 2 else view(x, (math.prod(lead), x.shape[-1]))
    w = gathered(w, rows)
    y = _features_whole(rows, w) @ w
    if any(p.is_partial() for p in y.placements):
        y = y.redistribute(y.device_mesh, [
            Replicate() if p.is_partial() else p for p in y.placements])
    return y if x.ndim <= 2 else view(y, lead + (y.shape[-1],))


def pad(x, widths: tuple):
    """``F.pad(x, widths)``, zeros (``widths`` as ``F.pad`` takes them,
    the last dim's pair first).  On a DTensor each rank pads its local
    shard: the shards of a padded dim are replicated first, the rest
    stay, and nothing else moves.  DTensor's own pad is not used: torch
    2.11 fails to plan its redistribution."""
    if not isinstance(x, DTensor):
        return F.pad(x, widths)
    padded = {x.ndim - 1 - j for j in range(len(widths) // 2)
              if widths[2 * j] or widths[2 * j + 1]}
    places = [Replicate() if isinstance(p, Shard) and p.dim in padded
              else p for p in x.placements]
    if places != list(x.placements):
        x = x.redistribute(x.device_mesh, places)
    shape = list(x.shape)
    for j in range(len(widths) // 2):
        shape[x.ndim - 1 - j] += widths[2 * j] + widths[2 * j + 1]
    return _from_local(F.pad(x.to_local(), widths), x.device_mesh, places,
                       shape)


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
    of every tensor of ``tensors``) when any is a DTensor: the rows are
    split as the first DTensor's dim 0 is, and also over each mesh dim
    that holds them whole where a rank's rows divide evenly (a scan's
    work, which the reference's SPMD partitioner spreads over "model"
    too); each of ``tensors`` is redistributed to that split (a plain
    tensor counts as replicated), each of ``shared`` to ``Replicate``,
    ``fn`` runs on the local tensors, and the tensor it returns (batch
    on dim 0) comes back as a DTensor gathered to the first DTensor's
    shards of dim 0 (its other mesh dims replicated).  ``fn`` must treat
    batch rows independently: a time loop (the recurrent mixers) then
    runs as plain ops on local shards, as it would in ``shard_map``, not
    as a DTensor op a step.  Without DTensors, ``fn(*tensors,
    *shared)``."""
    first = next((t for t in tensors + tuple(shared)
                  if isinstance(t, DTensor)), None)
    if first is None:
        return fn(*tensors, *shared)
    mesh = first.device_mesh
    lead = next((t for t in tensors if isinstance(t, DTensor)), first)
    rows = [Shard(0) if type(p) is Shard and p.dim == 0 else Replicate()
            for p in lead.placements]
    work = list(rows)
    n = tensors[0].shape[0] // math.prod(
        mesh.size(i) for i, r in enumerate(rows) if r == Shard(0))
    for i, r in enumerate(rows):
        if r != Shard(0) and n % mesh.size(i) == 0:
            work[i] = Shard(0)
            n //= mesh.size(i)
    whole = [Replicate()] * mesh.ndim

    # a shared tensor's grad from each rank's rows is a partial sum
    summed = [Partial() if r == Shard(0) else Replicate() for r in work]

    def local(t, places, grads):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, whole, run_check=False)
        return t.redistribute(mesh, places).to_local(grad_placements=grads)

    out = fn(*[local(t, work, work) for t in tensors],
             *[local(t, whole, summed) for t in shared])
    out = _from_local(out, mesh, work,
                      (tensors[0].shape[0],) + tuple(out.shape[1:]))
    return out if work == rows else out.redistribute(mesh, rows)


def _first_mesh(*tensors):
    return next(t.device_mesh for t in tensors if isinstance(t, DTensor))


def _on_mesh(t, mesh):
    """``t`` as a DTensor on ``mesh`` (a plain tensor counts as
    replicated)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _to_local(t, mesh, places, grads=None):
    """The local shard of ``t`` redistributed to ``places``; its gradient
    comes back at ``grads`` (default ``places``)."""
    return _on_mesh(t, mesh).redistribute(mesh, places).to_local(
        grad_placements=grads or places)


def _from_local(t, mesh, places, shape):
    """The DTensor of global ``shape`` (contiguous) whose local shard is
    ``t``; no collective runs and nothing is allocated."""
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.append(n)
        n *= max(size, 1)
    return DTensor.from_local(t, mesh, places, run_check=False,
                              shape=tuple(shape), stride=tuple(stride[::-1]))


def attention_local(fn, queries, keys, mask=None, kv_heads: bool = True):
    """Attention on local shards, as ``shard_map`` runs it.  ``queries``
    are tensors of (B, S, H, ...), ``keys`` of (B, T, ...) with, when
    ``kv_heads``, their kv heads (H / G of them, query head h in group
    h // G) on dim 2; ``mask`` (bool) broadcasts to (B, S, H, T).  ``fn(
    *queries, *keys, mask)`` takes local tensors and returns ``(acc, m,
    l)``: the unnormalized weighted sum (B, S, H, vd) under
    ``exp(scores - m)``, the row maxima m and the row sums l (B, S, H).
    The result is ``acc / l``, (B, S, H, vd).

    At least one input is a DTensor.  Each mesh dim takes one role, in
    this order:
      * rows: the keys or queries are sharded on the batch there; every
        tensor keeps (or takes) its rank's batch rows;
      * keys: the keys are sharded on T there (a decode cache); each
        rank attends its key slice with the queries whole, and the
        slices' (acc, m, l) combine across the dim (a max and two sums
        of (B, S, H)-sized tensors);
      * heads: the kv-head count (without ``kv_heads``, the head count)
        divides the dim; queries and keys take their rank's heads, in
        matching groups;
      * otherwise the dim is replicated.
    The batch is never gathered, nor a key slice.  The result is a
    DTensor, its rows and heads sharded where they were computed."""
    mesh = next(t for t in (*queries, *keys, mask)
                if isinstance(t, DTensor)).device_mesh
    q0, k0 = queries[0], keys[0]
    b, s, h = q0.shape[:3]
    t = k0.shape[1]

    roles = []
    for i, n in enumerate(mesh.shape):
        kp, qp = _placement(k0, i), _placement(q0, i)
        if (_is_shard(kp, 0) or _is_shard(qp, 0)) and b % n == 0:
            roles.append("rows")
        elif _is_shard(kp, 1):
            roles.append("keys")
        elif h % n == 0 and (k0.shape[2] % n == 0 if kv_heads
                             else kp == Replicate()):
            roles.append("heads")
        else:
            roles.append(None)

    q_places = _by_role(roles, {"rows": Shard(0), "heads": Shard(2)})
    # a query whole on a key slice gets a partial grad there, and so does
    # a key whole on a head slice
    q_grads = _by_role(roles, {"rows": Shard(0), "heads": Shard(2),
                               "keys": Partial()})
    k_places = _by_role(roles, {
        "rows": Shard(0), "keys": Shard(1),
        "heads": Shard(2) if kv_heads else Replicate()})
    k_grads = _by_role(roles, {
        "rows": Shard(0), "keys": Shard(1),
        "heads": Shard(2) if kv_heads else Partial()})
    local_q = [_to_local(x, mesh, q_places, q_grads) for x in queries]
    local_k = [_to_local(x, mesh, k_places, k_grads) for x in keys]
    local_mask = None
    if mask is not None:
        full = {"rows": (0, b), "heads": (2, h), "keys": (3, t)}
        local_mask = _to_local(mask, mesh, [
            Shard(full[r][0]) if r in full
            and mask.shape[full[r][0]] == full[r][1] else Replicate()
            for r in roles])
    acc, m, l = fn(*local_q, *local_k, local_mask)
    if "keys" in roles:
        def combined(x, op):
            return _combine(x, op, mesh, roles, "keys", q_places,
                            (b, s, h) + tuple(x.shape[3:]))

        # the maxima only stabilize the exponentials: their gradient
        # cancels in acc / l
        m = m.detach()
        rescale = torch.exp(m - combined(m, "max"))
        acc = combined(acc * rescale[..., None], "sum")
        l = combined(l * rescale, "sum")
    return _from_local(acc / l[..., None], mesh, q_places,
                       (b, s, h, acc.shape[-1]))


def _combine(x, op, mesh, roles, role, places, shape):
    """The local ``x`` (of global ``shape`` at ``places``) reduced by
    ``op`` ("max" or "sum") across the mesh dims of ``role``, where each
    rank holds a partial value; differentiable."""
    partial = [Partial(op) if r == role else p
               for r, p in zip(roles, places)]
    return _from_local(x, mesh, partial, shape).redistribute(
        mesh, places).to_local()


def vocab_nll(logits, targets):
    """-log softmax(logits)[targets] of DTensor logits (B, S, V), float32,
    and integer ``targets`` (B, S): (B, S), its rows sharded as the
    logits' were.  Each rank takes its batch rows and, on the mesh dims
    that shard the vocab, its vocab slice: the slice's max, sum of
    exponentials and target logit combine across those dims (Megatron's
    vocab-parallel cross-entropy), so nothing vocab-wide is formed or
    gathered.  Other mesh dims are replicated."""
    mesh = _first_mesh(logits, targets)
    b, s, v = logits.shape
    roles = []
    for i, n in enumerate(mesh.shape):
        lp, tp = _placement(logits, i), _placement(targets, i)
        if (_is_shard(lp, 0) or _is_shard(tp, 0)) and b % n == 0:
            roles.append("rows")
        elif _is_shard(lp, 2):
            roles.append("vocab")
        else:
            roles.append(None)
    rows = _by_role(roles, {"rows": Shard(0)})
    x = _to_local(logits, mesh, _by_role(roles, {"rows": Shard(0),
                                                 "vocab": Shard(2)}))
    t = _to_local(targets, mesh, rows)
    # this rank's first vocab entry
    first = _to_local(torch.arange(v, device=x.device), mesh,
                      _by_role(roles, {"vocab": Shard(0)}))[0]
    t = t.to(torch.int64) - first
    inside = (t >= 0) & (t < x.shape[-1])
    picked = torch.gather(x, -1, torch.clamp(t, 0, x.shape[-1] - 1)[..., None]
                          )[..., 0]
    picked = torch.where(inside, picked, 0.0)
    m = torch.amax(x, dim=-1).detach()   # its gradient cancels
    sums = torch.sum(torch.exp(x - m[..., None]), dim=-1)
    if "vocab" in roles:
        def combined(y, op):
            return _combine(y, op, mesh, roles, "vocab", rows, (b, s))
        m_all = combined(m, "max")
        sums = combined(sums * torch.exp(m - m_all), "sum")
        m, picked = m_all, combined(picked, "sum")
    return _from_local(torch.log(sums) + m - picked, mesh, rows, (b, s))


def write_slots(cache, new, slot):
    """``cache`` (B, T, ...) with row r's ``new[r]`` (B, ...) written at
    slot ``slot[r]`` (B,), in the cache's dtype; the given cache is not
    written.  A DTensor cache keeps its placements: each rank writes the
    entries of its own rows that fall in its own slots into its local
    shard (the rest of its rows rewrite what they hold), so nothing of
    the cache moves.  A plain cache takes one ``index_put``."""
    new = new.to(cache.dtype)
    if not any(isinstance(x, DTensor) for x in (cache, new, slot)):
        rows = torch.arange(cache.shape[0], device=cache.device)
        return cache.index_put((rows, slot), new)
    mesh = _first_mesh(cache, new, slot)
    cache = _on_mesh(cache, mesh)
    local = cache.to_local()
    dev = local.device
    # the global index of each local row and of the first local slot
    rows_at = [Shard(0) if _is_shard(p, 0) else Replicate()
               for p in cache.placements]
    keys_at = [Shard(0) if _is_shard(p, 1) else Replicate()
               for p in cache.placements]
    row_ids = _to_local(torch.arange(cache.shape[0], device=dev), mesh,
                        rows_at)
    slot_ids = _to_local(torch.arange(cache.shape[1], device=dev), mesh,
                         keys_at)
    new_at = [Shard(0) if _is_shard(p, 0) else
              Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
              else Replicate() for p in cache.placements]
    new = _to_local(new, mesh, new_at)
    slot = _to_local(slot, mesh, [Replicate()] * mesh.ndim)[row_ids] \
        - slot_ids[0]
    inside = (slot >= 0) & (slot < local.shape[1])
    at = torch.clamp(slot, 0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=dev)
    inside = inside.reshape((-1,) + (1,) * (new.ndim - 1))
    local = local.index_put((rows, at), torch.where(inside, new,
                                                    local[rows, at]))
    return _from_local(local, mesh, list(cache.placements), cache.shape)


def stripes_local(fn, qc, kc, vc):
    """Flash attention's chunk loop on local shards.  ``qc`` (B, P, nq,
    qc, Hkv, G, hd) is chunked queries in P stripes, ``kc`` / ``vc`` (B,
    nk, kc, Hkv, d) chunked keys and values; ``fn(qc, kc, vc, stripes)``
    takes local tensors and the global index of each local stripe (P,)
    and returns the output (B, P, nq, qc, Hkv, G, vd).  Without DTensors,
    ``fn`` on the tensors themselves with stripes 0..P-1.  Otherwise each
    mesh dim keeps the batch rows (queries or keys sharded on B there) or
    the query stripes (queries sharded on P; the keys whole, their grads
    partial sums), or is replicated; the loop then runs as plain ops on
    local tensors, and the output comes back sharded as the queries
    were."""
    p = qc.shape[1]
    if not any(isinstance(t, DTensor) for t in (qc, kc, vc)):
        return fn(qc, kc, vc, torch.arange(p, device=qc.device))
    mesh = _first_mesh(qc, kc, vc)

    roles = []
    for i, n in enumerate(mesh.shape):
        qp, kp = _placement(qc, i), _placement(kc, i)
        if (_is_shard(qp, 0) or _is_shard(kp, 0)) and qc.shape[0] % n == 0:
            roles.append("rows")
        elif _is_shard(qp, 1) and p % n == 0:
            roles.append("stripes")
        else:
            roles.append(None)

    q_at = _by_role(roles, {"rows": Shard(0), "stripes": Shard(1)})
    k_at = _by_role(roles, {"rows": Shard(0)})
    k_grads = _by_role(roles, {"rows": Shard(0), "stripes": Partial()})
    stripes = _to_local(torch.arange(p, device=qc.device), mesh,
                        _by_role(roles, {"stripes": Shard(0)}))
    out = fn(_to_local(qc, mesh, q_at), _to_local(kc, mesh, k_at, k_grads),
             _to_local(vc, mesh, k_at, k_grads), stripes)
    return _from_local(out, mesh, q_at, tuple(qc.shape[:-1])
                       + (out.shape[-1],))
