"""FleetTask: what the fleet engine needs from a model + data + loss.

The port of ``repro.fleet.task`` for the synthetic MLP classifier
(``SyntheticMLPTask``, the fleet round's task) and the model side of
``TransformerTask`` (config, parameters and tile grid, which the serving
path needs; its training methods are not ported yet).  Task constants
come from explicit ``torch.Generator``s handed in by the engine.

Client data is counter-based: client i's fixed local batch is a pure
function of (data seed, i) and the task state, drawn by plain tensor ops
(integer mixing of seed, client and element into 32-bit words, then
Box-Muller normals and inverse-CDF labels), vectorized over any index
set.  So the engine can cache every batch once or draw any subset again,
and both give the same bits.  Every integer product stays below 2^63.
"""

from __future__ import annotations

import abc
import dataclasses
import math
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

    # Whether the engine's automatic data cache may hold every client's
    # batch (below its memory limit); False makes it draw them per use.
    cache_batches: bool = True

    @abc.abstractmethod
    def build(self, generator: torch.Generator, dtype: torch.dtype,
              device, num_clients: int = 0) -> PyTree:
        """Materialize task constants (templates, test sets, and any
        per-client constants of a ``num_clients`` fleet)."""

    @abc.abstractmethod
    def init_params(self, generator: torch.Generator, dtype: torch.dtype,
                    device) -> PyTree:
        """Initialize the dense global model."""

    @abc.abstractmethod
    def client_batch(self, state: PyTree, seed: int,
                     clients: torch.Tensor) -> PyTree:
        """The fixed local batches of the clients ``clients`` (int64 flat
        indices), leading dim ``len(clients)``: a pure function of
        (``seed``, client, ``state``)."""

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


_M32 = 0xFFFFFFFF
# stream ids of the counter-based draws (one per purpose)
_STREAM_NORMAL_R, _STREAM_NORMAL_T, _STREAM_LABEL = 1, 2, 3


def _mix32(x):
    """A 32-bit integer hash of ``x`` in [0, 2^32) (a Python int or an
    int64 tensor): xor-shifts and two multiplications by odd constants
    below 2^31, so no product reaches 2^63 and the CPU and the card agree
    bit for bit."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def client_words(seed: int, stream: int, clients: torch.Tensor,
                 count: int) -> torch.Tensor:
    """(len(clients), count) int64 words in [0, 2^32): word e of client c
    in ``stream`` is a hash of (seed, stream, c, e) alone."""
    key = _mix32(_mix32(seed & _M32) ^ ((seed >> 32) & _M32))
    key = _mix32(key ^ stream)
    c = _mix32((clients.to(torch.int64) & _M32) ^ key)
    e = torch.arange(count, dtype=torch.int64, device=clients.device)
    e = _mix32((e + _mix32(key ^ 0x5BD1E995)) & _M32)
    return _mix32(c[:, None] ^ e[None, :])


def _uniform(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """U(0, 1) from 32-bit words: the top 23 bits plus a half, exact in
    float32 and float64."""
    return ((words >> 9).to(dtype) + 0.5) * (2.0 ** -23)


def client_normals(seed: int, clients: torch.Tensor, count: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """(len(clients), count) standard normals by Box-Muller, pair j from
    words j of two streams."""
    pairs = -(-count // 2)
    u_r = _uniform(client_words(seed, _STREAM_NORMAL_R, clients, pairs), dtype)
    u_t = _uniform(client_words(seed, _STREAM_NORMAL_T, clients, pairs), dtype)
    r = torch.sqrt(-2.0 * torch.log(u_r))
    theta = (2.0 * math.pi) * u_t
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)],
                     dim=-1)[:, :count]


@dataclasses.dataclass(frozen=True)
class SyntheticMLPTask(FleetTask):
    """Per-class Gaussian-template classification on a small MLP (the
    engine's default task).  Same fields and defaults as the reference.

    ``dirichlet_alpha`` (None = IID labels) gives each client a fixed
    class distribution p_i ~ Dirichlet(alpha 1), drawn at ``build`` and
    kept as its cumulative table ``state["label_cdf"]`` (n, classes);
    the client's labels are inverse-CDF draws from it.
    """

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
        if self.dirichlet_alpha is not None and not self.dirichlet_alpha > 0:
            raise ValueError(f"dirichlet_alpha must be > 0, got "
                             f"{self.dirichlet_alpha}")

    def build(self, generator, dtype, device, num_clients=0):
        templates = torch.randn((self.num_classes, self.feature_dim),
                                generator=generator, dtype=dtype,
                                device=device)
        y_test = torch.randint(0, self.num_classes, (self.test_samples,),
                               generator=generator, device=device)
        x_test = templates[y_test] + self.data_noise * torch.randn(
            (self.test_samples, self.feature_dim), generator=generator,
            dtype=dtype, device=device)
        state = {"templates": templates, "x_test": x_test, "y_test": y_test}
        if self.dirichlet_alpha is not None and num_clients:
            # float64 gammas: a small alpha underflows float32 to 0
            gam = torch._standard_gamma(
                torch.full((num_clients, self.num_classes),
                           float(self.dirichlet_alpha), dtype=torch.float64,
                           device=device), generator=generator)
            p = gam / torch.sum(gam, dim=-1, keepdim=True)
            state["label_cdf"] = torch.cumsum(p, dim=-1).to(dtype)
        return state

    def init_params(self, generator, dtype, device):
        return mlp.init_mlp_classifier(generator, self.feature_dim,
                                       self.hidden, self.num_classes,
                                       dtype=dtype, device=device)

    def client_batch(self, state, seed, clients):
        templates = state["templates"]
        n, b = clients.shape[0], self.local_batch
        words = client_words(seed, _STREAM_LABEL, clients, b)
        if "label_cdf" in state:
            cdf = state["label_cdf"][clients]
            u = _uniform(words, cdf.dtype)
            y = torch.clamp_max(torch.searchsorted(cdf, u, right=True),
                                self.num_classes - 1)
        else:
            y = (words * self.num_classes) >> 32
        z = client_normals(seed, clients, b * self.feature_dim,
                           templates.dtype)
        x = templates[y] + self.data_noise * z.reshape(n, b,
                                                       self.feature_dim)
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
