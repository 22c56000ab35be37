"""Packet-error-aware aggregation (the paper's Eq. (5)) and the FedBuff merge.

The port of the torch half of ``repro.core.aggregation``.  Synchronous
rule:

  g = sum_i K_i C_i grad_i / sum_i K_i C_i,   C_i ~ Bernoulli(1 - q_i);

buffered (FedBuff) rule of the fleet engine's async mode: each update
also carries its staleness tau_i, in server versions, and merges with

  w_i = K_i C_i s(tau_i) 1{tau_i <= tau_max},

``s`` the discount of ``staleness_scale``.  With tau = 0 everywhere the
buffered rule is Eq. (5).  Stacked per-client gradients are params-shaped
trees whose leaves lead with the client axis.

Random draws take their uniforms from the caller (``sample_arrivals``),
as the scheduler's do.  ``psum_aggregate`` is the collective form, one
client a rank, over a ``torch.distributed`` group (the mesh trainer's
client group, ``federated.trainer``).  The reference's ``xp=numpy`` lane
is these functions on CPU tensors; the host reference path
(``federated/``) runs them on the model's device.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.pruning import tree_map

__all__ = ["sample_arrivals", "aggregate", "staleness_scale",
           "buffered_weights", "buffered_aggregate", "psum_aggregate"]

PyTree = Any


def sample_arrivals(u: torch.Tensor, per: torch.Tensor) -> torch.Tensor:
    """Packet indicators C_i ~ Bernoulli(1 - q_i) from uniforms ``u``
    (float32, as the reference's)."""
    return (u >= per).to(torch.float32)


def _weighted_mean(client_grads: PyTree, w: torch.Tensor) -> PyTree:
    """sum_i w_i g_i / sum_i w_i per leaf; zeros where every weight is 0
    (the server skips the update)."""
    denom = torch.sum(w)
    safe = torch.where(denom > 0.0, denom, 1.0)

    def reduce(leaf):
        num = torch.sum(leaf * w.reshape((-1,) + (1,) * (leaf.ndim - 1)),
                        dim=0)
        return torch.where(denom > 0.0, num / safe, torch.zeros_like(num))

    return tree_map(reduce, client_grads)


def aggregate(client_grads: PyTree, num_samples: torch.Tensor,
              arrivals: torch.Tensor) -> PyTree:
    """Eq. (5) on stacked gradients (K_i taken in float32, as the
    reference does)."""
    return _weighted_mean(client_grads,
                          num_samples.to(torch.float32) * arrivals)


def staleness_scale(staleness, kind: str = "polynomial", alpha: float = 0.5,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """FedBuff discount s(tau) of an update ``staleness`` versions old, in
    ``dtype``: ``"none"`` (1), ``"polynomial"`` ((1 + tau)^-alpha) or
    ``"exponential"`` (exp(-alpha tau)); s(0) = 1 for each."""
    tau = torch.clamp_min(torch.as_tensor(staleness).to(dtype), 0.0)
    if kind == "none":
        return torch.ones_like(tau)
    if kind == "polynomial":
        return (1.0 + tau) ** (-alpha)
    if kind == "exponential":
        return torch.exp(-alpha * tau)
    raise ValueError(f"unknown staleness discount {kind!r}")


def buffered_weights(num_samples, arrivals, staleness, *,
                     kind: str = "polynomial", alpha: float = 0.5,
                     max_staleness: int = 20,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Merge weights w_i = K_i C_i s(tau_i) 1{tau_i <= tau_max}, in
    ``dtype``; an update older than ``max_staleness`` weighs 0."""
    k = torch.as_tensor(num_samples).to(dtype)
    s = staleness_scale(staleness, kind=kind, alpha=alpha, dtype=dtype)
    fresh = (torch.as_tensor(staleness) <= max_staleness).to(dtype)
    return k * torch.as_tensor(arrivals) * s * fresh


def buffered_aggregate(client_grads: PyTree, num_samples, arrivals,
                       staleness, *, kind: str = "polynomial",
                       alpha: float = 0.5, max_staleness: int = 20,
                       dtype: torch.dtype = torch.float32) -> PyTree:
    """The FedBuff merge on stacked gradients; at zero staleness it is
    ``aggregate``.  A buffer of zero total weight gives zero gradients."""
    return _weighted_mean(client_grads, buffered_weights(
        num_samples, arrivals, staleness, kind=kind, alpha=alpha,
        max_staleness=max_staleness, dtype=dtype))


def psum_aggregate(local_grad: PyTree, k_i: torch.Tensor, c_i: torch.Tensor,
                   group=None) -> PyTree:
    """Eq. (5) across ranks, one client a rank: every rank of ``group``
    (``None``: the default group) passes its client's gradient, K_i and
    C_i, and gets the aggregate.  One SUM all-reduce forms the
    denominator and one per leaf forms sum_i K_i C_i grad_i, on every
    group size (a group of one sums its own values, as the reference's
    ``psum`` over an axis of size 1 does).  A leaf times the weight takes
    JAX's promotion of the two dtypes (a bfloat16 gradient sums in
    float32).  Zeros where the total weight is 0.

    A DTensor leaf (a tensor-sharded model) is reduced shard by shard:
    every rank of ``group`` holds the same shard of its client's
    gradient, so the all-reduce of the local shards is the shard of the
    aggregate, which comes back with the leaf's placements."""
    w = k_i * c_i
    denom = w.clone()
    dist.all_reduce(denom, op=dist.ReduceOp.SUM, group=group)
    safe = torch.where(denom > 0.0, denom, 1.0)

    def reduce(leaf):
        if isinstance(leaf, DTensor):
            if any(p.is_partial() for p in leaf.placements):
                raise ValueError(f"psum_aggregate takes sharded or "
                                 f"replicated leaves, got {leaf.placements}")
            return DTensor.from_local(reduce(leaf.to_local()),
                                      leaf.device_mesh, leaf.placements,
                                      shape=leaf.shape, stride=leaf.stride())
        num = leaf.to(torch.promote_types(leaf.dtype, w.dtype)) * w
        dist.all_reduce(num, op=dist.ReduceOp.SUM, group=group)
        return torch.where(denom > 0.0, num / safe, torch.zeros_like(num))

    return tree_map(reduce, local_grad)
