"""FleetTask: what the fleet engine needs from a model + data + loss.

The port of ``repro.fleet.task`` for the synthetic MLP classifier
(``SyntheticMLPTask``, the fleet round's task) and the model side of
``TransformerTask`` (config, parameters and tile grid, which the serving
path needs; its training methods are not ported yet).  Randomness comes
from explicit ``torch.Generator``s handed in by the engine's draw source;
every
client's fixed local batch is drawn once, for the whole fleet, at build
time (the engine's data cache).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import pruning
from repro_torch.kernels import fleet_fused as FUSED
from repro_torch.models import mlp

PyTree = Any

__all__ = ["FleetTask", "SyntheticMLPTask", "TransformerTask",
           "auto_tile_grid"]

_ROADMAP_TASKS = "ROADMAP.md Queue A, item 8 (other tasks)"


def _auto_block(dim: int, target_tiles: int, min_block: int) -> int:
    """Tile edge giving ~``target_tiles`` tiles along a ``dim``-sized axis."""
    return max(min_block, -(-dim // target_tiles))


def auto_tile_grid(params: PyTree, target_tiles: int = 8,
                   min_block: int = 4) -> list:
    """Per-leaf ``(bk, bn)`` tile specs sized to each leaf's last two dims
    (about ``target_tiles`` tiles per axis), ``None`` for 1-D leaves, in
    ``pruning.flatten`` order."""
    return [(_auto_block(leaf.shape[-2], target_tiles, min_block),
             _auto_block(leaf.shape[-1], target_tiles, min_block))
            if leaf.ndim >= 2 else None
            for leaf in pruning.flatten(params)]


class FleetTask(abc.ABC):
    """Protocol every fleet-engine task implements."""

    name: str = "task"

    @abc.abstractmethod
    def build(self, generator: torch.Generator, dtype: torch.dtype,
              device) -> PyTree:
        """Materialize task constants (templates, test sets)."""

    @abc.abstractmethod
    def init_params(self, generator: torch.Generator, dtype: torch.dtype,
                    device) -> PyTree:
        """Initialize the dense global model."""

    @abc.abstractmethod
    def client_batch(self, state: PyTree, generator: torch.Generator,
                     num_clients: int) -> PyTree:
        """Every client's fixed local batch, leading dim ``num_clients``."""

    @abc.abstractmethod
    def loss(self, params: PyTree, batch: PyTree) -> torch.Tensor:
        """Scalar mean training loss of one client's batch."""

    @abc.abstractmethod
    def eval_metrics(self, state: PyTree, params: PyTree
                     ) -> dict[str, torch.Tensor]:
        """Evaluation metrics; must include ``"accuracy"``."""

    @abc.abstractmethod
    def tile_grid(self, params: PyTree):
        """Block spec for structured pruning (an int or a (bk, bn) pair)."""

    @abc.abstractmethod
    def kernel_prepare(self, params: PyTree):
        """Once-per-round ranking state for block masks."""

    @abc.abstractmethod
    def kernel_grads(self, params: PyTree, prep, batch: PyTree,
                     rho: torch.Tensor, weights: torch.Tensor
                     ) -> tuple[PyTree, torch.Tensor]:
        """Weighted Eq.-(5) gradient sum + per-client losses for a chunk."""


@dataclasses.dataclass(frozen=True)
class SyntheticMLPTask(FleetTask):
    """Per-class Gaussian-template classification on a small MLP (the
    engine's default task).  Same fields and defaults as the reference."""

    feature_dim: int = 32
    hidden: tuple[int, ...] = (16,)
    num_classes: int = 4
    local_batch: int = 8
    data_noise: float = 0.5
    test_samples: int = 512
    prune_block: int = 8
    dirichlet_alpha: Optional[float] = None

    name: str = "mlp"

    def __post_init__(self):
        if self.dirichlet_alpha is not None:
            raise NotImplementedError(
                "Dirichlet non-IID client data is not ported yet: "
                "ROADMAP.md Queue A, item 6c")

    def build(self, generator, dtype, device):
        templates = torch.randn((self.num_classes, self.feature_dim),
                                generator=generator, dtype=dtype,
                                device=device)
        y_test = torch.randint(0, self.num_classes, (self.test_samples,),
                               generator=generator, device=device)
        x_test = templates[y_test] + self.data_noise * torch.randn(
            (self.test_samples, self.feature_dim), generator=generator,
            dtype=dtype, device=device)
        return {"templates": templates, "x_test": x_test, "y_test": y_test}

    def init_params(self, generator, dtype, device):
        return mlp.init_mlp_classifier(generator, self.feature_dim,
                                       self.hidden, self.num_classes,
                                       dtype=dtype, device=device)

    def client_batch(self, state, generator, num_clients):
        templates = state["templates"]
        y = torch.randint(0, templates.shape[0],
                          (num_clients, self.local_batch),
                          generator=generator, device=templates.device)
        x = templates[y] + self.data_noise * torch.randn(
            (num_clients, self.local_batch, templates.shape[1]),
            generator=generator, dtype=templates.dtype,
            device=templates.device)
        return {"x": x, "y": y}

    def loss(self, params, batch):
        return mlp.classifier_loss(params, batch["x"], batch["y"])

    def eval_metrics(self, state, params):
        return {"accuracy": mlp.accuracy(params, state["x_test"],
                                         state["y_test"])}

    def tile_grid(self, params):
        return self.prune_block

    def kernel_prepare(self, params):
        # layer-ordered states for the layer-structured fused kernel
        return FUSED.layer_norm_states(params, self.prune_block)

    def kernel_grads(self, params, prep, batch, rho, weights):
        keeps = FUSED.layer_keeps(prep, rho)
        return FUSED.fused_fleet_grads(params, batch["x"], batch["y"], keeps,
                                       weights, self.prune_block)


@dataclasses.dataclass(frozen=True)
class TransformerTask(FleetTask):
    """Causal-LM task on an ``ArchConfig`` model: the model side only.

    ``config``, ``init_params`` and ``tile_grid`` are ported (the serving
    path prunes and serves this task's model); the training methods raise
    ``NotImplementedError``, and the reference's data fields (sequence
    length, batches, pool, Dirichlet skew) come with them.
    """

    arch: Any                           # the model's ArchConfig
    target_tiles: int = 8

    name: str = "transformer"

    def config(self):
        return self.arch

    def init_params(self, generator):
        """The model in the config's parameter dtype, drawn on the
        generator's device (``None``: ``meta`` tensors, shapes only)."""
        from repro_torch.models import model as M
        return M.init_params(self.arch, generator)

    def tile_grid(self, params):
        return auto_tile_grid(params, target_tiles=self.target_tiles)

    def _not_ported(self, *_args, **_kw):
        raise NotImplementedError(
            f"TransformerTask training is not ported yet: {_ROADMAP_TASKS}")

    build = client_batch = loss = eval_metrics = _not_ported
    kernel_prepare = kernel_grads = _not_ported
