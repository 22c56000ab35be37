"""Client-side logic: prune the broadcast model, run local FedSGD."""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import pruning

__all__ = ["local_gradient", "make_masks"]

PyTree = Any


def local_gradient(loss_fn: Callable[[PyTree], torch.Tensor], params: PyTree,
                   masks: PyTree) -> tuple[torch.Tensor, PyTree]:
    """One FedSGD step on the pruned model W~ = W * M.

    Returns (loss, masked gradient): the gradient of ``loss_fn`` at the
    pruned point (``torch.func.grad_and_value``), with the pruned
    coordinates zeroed, since a pruned weight is absent on the UE and
    cannot reach its uploaded gradient packet.
    """
    pruned = pruning.apply_masks(params, masks)
    grads, loss = torch.func.grad_and_value(loss_fn)(pruned)
    return loss, pruning.apply_masks(grads, masks)


def make_masks(params: PyTree, prune_rate, structured: bool = False,
               block: int = 128) -> PyTree:
    """Masks at pruning rate ``prune_rate`` (the paper's rho_i; any shape,
    one mask per rate): block-tile masks (one tile-norm ranking, one
    launch on the card) when ``structured``, else magnitude masks."""
    if structured:
        return pruning.block_masks(params, prune_rate, block=block)
    return pruning.magnitude_masks(params, prune_rate)
