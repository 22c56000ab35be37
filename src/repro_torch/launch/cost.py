"""A cost model of one traced step, per rank (the port's counterpart of
``repro.launch.hlo_cost``).

The reference reads the three roofline inputs from compiled, post-SPMD
HLO text.  The port has no compiler between the step and the device: a
step is an eager sequence of ATen ops, and the dry run traces it on one
process under ``FakeTensorMode`` (``launch.dryrun``), so every op the
step would launch on rank 0 of the mesh passes through a
``TorchDispatchMode``.  ``CostMode`` is that mode.  It sees DTensor ops
and the local ops DTensor decomposes them into; it counts **local ops
only** (an op with no DTensor argument), so no product is counted twice
(``FlopCounterMode`` counts a DTensor product once at the DTensor level
and once as the local op).  Ops dispatched from DTensor's sharding
propagation are skipped too: it runs an op on fake global tensors to
learn its output's shape.

  flops            — ``torch.utils.flop_counter``'s formulas (products,
                     convolutions, attention) on the local shapes; other
                     ops count none (the reference adds 1 a result
                     element for elementwise ops: minor next to the
                     products).
  hbm_bytes        — an eager program fuses nothing, so each local op
                     reads its tensor operands from HBM and writes its
                     results there: operand plus result bytes per op.
                     Views (``func.is_view``), ``empty`` allocations,
                     waits and ops without a tensor result charge
                     nothing.
  collective_bytes — per collective (the ``_c10d_functional`` ops that
                     DTensor issues and the ``c10d`` ops of
                     ``torch.distributed``'s calls), the bytes that
                     cross a rank's links under ring algorithms, with g
                     the size of the op's group:
                        all-reduce       2*R*(g-1)/g
                        all-gather         R*(g-1)/g   (R = result bytes)
                        reduce-scatter     R*(g-1)     (operand = R*g)
                        all-to-all         R*(g-1)/g
                        collective-permute R
  ops              — the local ops dispatched (views included): what a
                     step's trace, and its launches, grow with.
  memory           — arguments and outputs are their local shards'
                     bytes; the peak is the largest sum of live local
                     storages over the trace (each storage counted once
                     however many views share it; freed when the last
                     tensor the mode saw on it dies), plus the
                     arguments.  It misses the caching allocator's slack
                     and rounding, kernels' workspaces (cuBLAS, NCCL
                     buffers) and tensors made outside the mode.

What has no counterpart: ``hlo_cost.py`` exists because XLA's
``cost_analysis`` counts a ``while`` body once; the port's stage and
chunk loops are Python, so every repeat is traced and counted, and there
is no trip count to read (``known_trip_count``), no HLO computation or
fusion to parse (the HLO-slice cases), and no replica-group syntax (a
collective's group is a process group whose size torch gives).  On a
fake group over a "cpu" mesh, DTensor issues a Shard -> Shard
redistribution as an all-gather and a local chunk where NCCL would run
an all-to-all, so such moves count as all-gathers of the whole result.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["BIG_BYTES", "COLLECTIVES", "Cost", "CostMode", "ring_bytes",
           "tree_bytes"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op (overload packet name) -> its kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}

# the port's model code, whose functions name ``CostMode``'s scopes, and
# DTensor's sharding propagation, whose ops run on global shapes
_MODELS = "/repro_torch/models/"
_PROPAGATION = "/distributed/tensor/_sharding_prop.py"

# a local result at least this large is listed in ``big_tensors``
BIG_BYTES = 64 * 2 ** 20

# ops that allocate or wait, and move no bytes
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "detach", "lift_fresh"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_op_bytes: dict = dataclasses.field(default_factory=dict)
    ops: int = 0

    def add(self, other: "Cost") -> None:
        self.flops += other.flops
        self.ops += other.ops
        self.hbm_bytes += other.hbm_bytes
        self.collective_bytes += other.collective_bytes
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = self.collective_counts.get(k, 0) + v
        for k, v in other.collective_op_bytes.items():
            self.collective_op_bytes[k] = \
                self.collective_op_bytes.get(k, 0) + v


def ring_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Bytes that cross one rank's links for a collective of ``kind``
    whose result is ``result_bytes`` on a ring of ``group`` ranks."""
    g, r = group, float(result_bytes)
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * r * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return r * (g - 1) / g
    if kind == "reduce-scatter":
        return r * (g - 1)
    if kind == "collective-permute":
        return r
    raise ValueError(f"unknown collective {kind!r}")


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    return sum(_nbytes(_local(t)) for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _group_size(func, args, kwargs) -> int:
    """The size of a collective's group: the ``group_size`` argument, a
    process group argument, or the group its name resolves to."""
    schema_args = func._schema.arguments
    named = dict(zip((a.name for a in schema_args), args))
    named.update(kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    for value in named.values():
        if isinstance(value, dist.ProcessGroup):
            return value.size()
        if isinstance(value, torch.ScriptObject):
            # a c10d op's group arrives boxed
            return dist.ProcessGroup.unbox(value).size()
    name = named.get("group_name", named.get("group"))
    if isinstance(name, str):
        return dist.distributed_c10d._resolve_process_group(name).size()
    return dist.get_world_size()


class CostMode(TorchDispatchMode):
    """Counts the ``Cost`` of the local ops dispatched while it is active,
    with the collective counts and the live local bytes (``peak_bytes``).
    Each op's cost is also added under the innermost function of the
    port's model code on the Python stack when it ran (``by_scope``,
    "module.function", e.g. "attention.flash_attention": the models are
    functions, not ``nn.Module``s), and the local results of at least
    ``BIG_BYTES`` are counted by (bytes, op, shape, dtype, scope) in
    ``big_tensors``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.by_scope: dict[str, Cost] = {}
        self.big_tensors: dict[tuple, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, list] = {}       # storage key -> [bytes, refs]

    # -- bookkeeping -------------------------------------------------------

    @staticmethod
    def _caller() -> str | None:
        """The innermost model function on the stack ("module.function",
        or "(outside the model)"); None inside DTensor's sharding
        propagation."""
        scope = None
        frame = sys._getframe(2)
        while frame is not None:
            path = frame.f_code.co_filename
            if path.endswith(_PROPAGATION):
                return None
            if scope is None and _MODELS in path:
                module = path.rsplit("/", 1)[-1].removesuffix(".py")
                scope = f"{module}.{frame.f_code.co_name}"
            frame = frame.f_back
        return scope or "(outside the model)"

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [storage.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    # -- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor decompose the op: its local ops come back here
            return NotImplemented
        out = func(*args, **kwargs)
        scope = self._caller()
        if scope is None:
            return out
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        packet = func.overloadpacket
        name = packet.__name__
        cost = Cost(ops=1)
        kind = _KINDS.get(name)
        if kind is not None:
            # R: the result's bytes (an op that returns only its work
            # handle writes its first operand)
            r = sum(_nbytes(t) for t in (outs or ins[:1]))
            moved = ring_bytes(kind, r, _group_size(func, args, kwargs))
            cost.collective_bytes += moved
            cost.collective_counts[kind] = 1
            cost.collective_op_bytes[kind] = moved
        elif outs and not func.is_view and name not in _FREE:
            if packet in flop_registry:
                cost.flops = float(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            cost.hbm_bytes = float(sum(_nbytes(t) for t in ins)
                                   + sum(_nbytes(t) for t in outs))
        self.cost.add(cost)
        self.by_scope.setdefault(scope, Cost()).add(cost)
        for t in outs:
            self._track(t)
            if not func.is_view and _nbytes(t) >= BIG_BYTES:
                key = (_nbytes(t), name, tuple(t.shape), str(t.dtype), scope)
                self.big_tensors[key] = self.big_tensors.get(key, 0) + 1
        return out
