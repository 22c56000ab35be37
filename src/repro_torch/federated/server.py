"""Server-side (BS) logic: broadcast, collect, packet-error-aware
aggregation and the global update (paper §II-B)."""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import aggregation, pruning

__all__ = ["global_round"]

PyTree = Any


def global_round(params: PyTree,
                 client_grad_fns: list[Callable[[PyTree],
                                                tuple[torch.Tensor, PyTree]]],
                 num_samples: torch.Tensor, per: torch.Tensor,
                 u: torch.Tensor, lr: float
                 ) -> tuple[PyTree, torch.Tensor, torch.Tensor]:
    """One synchronous FL round.

    ``client_grad_fns``: one callable per UE mapping the global params to
    (local loss, uploaded gradient); pruning happens inside
    (``client.py``).  ``u`` holds the round's uniforms, one per UE: the
    packet of UE i arrives when ``u_i >= per_i``
    (``aggregation.sample_arrivals``).  Returns (new params, arrivals C_i,
    mean local loss).
    """
    losses, grads = [], []
    for fn in client_grad_fns:
        loss, g = fn(params)
        losses.append(loss)
        grads.append(g)
    stacked = pruning.tree_map(lambda *xs: torch.stack(xs), *grads)
    arrivals = aggregation.sample_arrivals(u, per)
    g_global = aggregation.aggregate(stacked, num_samples, arrivals)
    new_params = pruning.tree_map(lambda p, g: p - lr * g.to(p.dtype),
                                  params, g_global)
    return new_params, arrivals, torch.mean(torch.stack(losses))
