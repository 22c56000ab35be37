"""FleetTask: what the fleet engine needs from a model + data + loss.

The port of ``repro.fleet.task``: the protocol with its generic fused
path (``kernel_prepare`` ranks the tiles once a round, ``kernel_grads``
streams clients through ``fleet_fused.masked_scan_grads``) and the three
tasks: the synthetic MLP classifier (``SyntheticMLPTask``, the fleet
round's default, with its own CUDA kernel), causal-LM rounds on a
llama-family model (``TransformerTask``) and least squares with a
closed-form optimum (``LinearRegressionTask``).  Task constants come from
explicit ``torch.Generator``s handed in by the engine.

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
import functools
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import pruning
from repro_torch.kernels import fleet_fused as FUSED
from repro_torch.models import mlp

PyTree = Any

__all__ = ["FleetTask", "SyntheticMLPTask", "TransformerTask",
           "LinearRegressionTask", "auto_tile_grid", "TASKS", "make_task"]


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

    def tile_grid(self, params: PyTree):
        """Block spec for structured pruning (``pruning.leaf_blocks``: an
        int, a (bk, bn) pair or a per-leaf list)."""
        return auto_tile_grid(params)

    def model_bits(self, params: PyTree) -> Optional[float]:
        """Physical model size D_M in bits, or None to keep the configured
        ``WirelessConfig.model_bits``."""
        return None

    def kernel_prepare(self, params: PyTree):
        """Once-per-round ranking state for block masks: every prunable
        leaf's tile norms (one ``tile_norms`` launch on the card), sorted
        once."""
        return pruning.block_norm_state(params, self.tile_grid(params))

    def client_task(self) -> "FleetTask":
        """The task as the fleet engine's clients train it (the engine's
        ``build_simulation`` takes it; the FL step trains ``self``).  The
        same loss values; a task may trade memory for time here."""
        return self

    def kernel_grads(self, params: PyTree, prep, batch: PyTree,
                     rho: torch.Tensor, weights: torch.Tensor
                     ) -> tuple[PyTree, torch.Tensor]:
        """Weighted Eq.-(5) gradient sum + per-client losses for a chunk
        of clients: one ``searchsorted`` a client for its tile keeps, then
        ``fleet_fused.masked_scan_grads`` (tasks with a kernel of their
        own override this)."""
        keeps = pruning.block_keep(prep, rho)
        return FUSED.masked_scan_grads(self.loss, params, batch, keeps,
                                       weights, self.tile_grid(params))


_M32 = 0xFFFFFFFF
# stream ids of the counter-based draws (one per purpose)
_STREAM_NORMAL_R, _STREAM_NORMAL_T, _STREAM_LABEL = 1, 2, 3
# the transformer's Dirichlet draws: pool rows and the sequence in a row
_STREAM_ROW, _STREAM_SEQ = 4, 5


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
            state["label_cdf"] = _dirichlet_cdf(
                generator, self.dirichlet_alpha, num_clients,
                self.num_classes, dtype, device)
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
            y = _inverse_cdf(state["label_cdf"][clients], words)
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


def _dirichlet_cdf(generator, alpha: float, rows: int, cols: int,
                   dtype, device) -> torch.Tensor:
    """(rows, cols) cumulative tables of p ~ Dirichlet(alpha 1), one a row
    (float64 gammas: a small alpha underflows float32 to 0)."""
    gam = torch._standard_gamma(
        torch.full((rows, cols), float(alpha), dtype=torch.float64,
                   device=device), generator=generator)
    p = gam / torch.sum(gam, dim=-1, keepdim=True)
    return torch.cumsum(p, dim=-1).to(dtype)


def _inverse_cdf(cdf: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Indices drawn from the rows of ``cdf`` by uniforms from ``words``."""
    u = _uniform(words, cdf.dtype)
    return torch.clamp_max(torch.searchsorted(cdf, u, right=True),
                           cdf.shape[-1] - 1)


@functools.lru_cache(maxsize=None)
def _default_arch(arch_name: str):
    """The smoke-size reduction of a registered arch, vocab at most 256
    (so the synthetic Zipf/Markov stream is learnable in a few rounds)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch_name).smoke_variant()
    return cfg.replace(vocab_size=min(cfg.vocab_size, 256))


@dataclasses.dataclass(frozen=True)
class TransformerTask(FleetTask):
    """Causal-LM rounds on an ``ArchConfig`` model (``models/model.py``).

    Local data is a pool of ``data/tokens.py`` token batches drawn on the
    host at ``build`` (from two seeds of the task generator) and moved to
    the device: client i owns pool row ``i % pool_clients``.  With
    ``dirichlet_alpha`` each client instead has a fixed distribution
    p_i ~ Dirichlet(alpha 1) over the pool rows (drawn at ``build`` for a
    ``num_clients`` fleet, kept as ``state["row_cdf"]``) and fills its
    batch with counter-based inverse-CDF row draws and uniform sequence
    picks within a row: a pure function of (seed, client, state).

    The model is ``arch`` or, when it is None, ``arch_name``'s smoke-size
    reduction (``_default_arch``); its params keep the config's parameter
    dtype whatever the run's dtype (the reference's do too).  ``config``
    is the model as given, its ``remat`` included, as the reference's:
    the FL step (``federated.trainer.make_fl_train_step``) trains it so.
    ``client_task`` is the one place that decides remat for the fleet
    engine's clients, which train without it: a client's batch
    (``local_batch`` x ``seq_len`` tokens) keeps small activations, which
    a recomputed forward would not save, and it would more than double a
    round (smollm-135m at full width, 32 clients of 2 x 16 tokens, on an
    H100: 10.3-11.4 s a round with ``"block"``, 4.1-4.5 s without).  The
    tile grid is ``block`` or ``auto_tile_grid(params, target_tiles)``,
    and the wireless model prices the real model (``model_bits``).
    """

    arch_name: str = "smollm-135m"
    arch: Optional[Any] = None          # an ArchConfig; overrides the name
    seq_len: int = 16
    local_batch: int = 2
    eval_batch: int = 8
    pool_clients: int = 32
    block: Optional[Any] = None         # scalar / pair / per-leaf spec
    target_tiles: int = 8
    dirichlet_alpha: Optional[float] = None

    name: str = "transformer"

    @property
    def cache_batches(self) -> bool:
        # the IID batch is a gather from the pool: a cache would only copy
        # it; the Dirichlet draws are what a cache saves
        return self.dirichlet_alpha is not None

    def config(self):
        return self.arch if self.arch is not None \
            else _default_arch(self.arch_name)

    def client_task(self) -> "TransformerTask":
        cfg = self.config()
        if cfg.remat == "none":
            return self
        return dataclasses.replace(self, arch=cfg.replace(remat="none"))

    def build(self, generator, dtype, device, num_clients=0):
        from repro_torch.data.tokens import TokenStream
        cfg = self.config()
        seeds = torch.randint(0, np.iinfo(np.int32).max, (2,),
                              generator=generator,
                              device=generator.device).tolist()
        pool = TokenStream(cfg.vocab_size, seed=seeds[0]).sample(
            self.pool_clients * self.local_batch, self.seq_len)
        eval_tokens = TokenStream(cfg.vocab_size, seed=seeds[1]).sample(
            self.eval_batch, self.seq_len)
        state = {
            "pool": torch.as_tensor(pool.astype(np.int64), device=device)
            .reshape(self.pool_clients, self.local_batch, self.seq_len),
            "eval_tokens": torch.as_tensor(eval_tokens.astype(np.int64),
                                           device=device),
        }
        if self.dirichlet_alpha is not None and num_clients:
            state["row_cdf"] = _dirichlet_cdf(
                generator, self.dirichlet_alpha, num_clients,
                self.pool_clients, dtype, device)
        return state

    def init_params(self, generator=None, dtype=None, device=None):
        """The model in the config's parameter dtype, drawn on the
        generator's device (``None``: ``meta`` tensors, shapes only).  The
        run's ``dtype`` and ``device`` are the protocol's; the generator
        already lies on the device."""
        from repro_torch.models import model as M
        del dtype, device
        return M.init_params(self.config(), generator)

    def client_batch(self, state, seed, clients):
        pool = state["pool"]
        if "row_cdf" not in state:
            return {"tokens": pool[clients % self.pool_clients]}
        b = self.local_batch
        rows = _inverse_cdf(state["row_cdf"][clients],
                            client_words(seed, _STREAM_ROW, clients, b))
        seq = (client_words(seed, _STREAM_SEQ, clients, b) * b) >> 32
        return {"tokens": pool[rows, seq]}

    def loss(self, params, batch):
        from repro_torch.models import model as M
        return M.loss_fn(self.config(), params, batch)[0]

    def eval_metrics(self, state, params):
        """Next-token accuracy on the eval tokens."""
        from repro_torch.models import model as M
        tokens = state["eval_tokens"]
        logits, _ = M.forward(self.config(), params, tokens)
        pred = torch.argmax(logits[:, :-1], dim=-1)
        return {"accuracy": torch.mean((pred == tokens[:, 1:])
                                       .to(torch.float32))}

    def tile_grid(self, params):
        if self.block is not None:
            return self.block
        return auto_tile_grid(params, target_tiles=self.target_tiles)

    def model_bits(self, params):
        return float(sum(leaf.numel() * leaf.element_size() * 8
                         for leaf in pruning.flatten(params)))


@dataclasses.dataclass(frozen=True)
class LinearRegressionTask(FleetTask):
    """Least squares y = x W* + b* (+ noise) on a linear model.

    The loss is quadratic, so full-cohort gradient descent contracts the
    parameter error linearly, (I - lr H) a step with H the design
    covariance, and ``optimum`` gives the closed-form target.  A client's
    batch is counter-based like ``SyntheticMLPTask``'s: x and the noise
    are Box-Muller normals of (seed, client), and y is summed feature by
    feature in a fixed order, so cached and streamed batches are equal
    bit for bit.
    """

    feature_dim: int = 8
    targets: int = 2
    local_batch: int = 8
    noise: float = 0.0
    test_samples: int = 64
    prune_block: int = 4

    name: str = "linreg"

    def build(self, generator, dtype, device, num_clients=0):
        def normal(*shape):
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=device)
        w_true = normal(self.feature_dim, self.targets)
        b_true = 0.1 * normal(self.targets)
        x_test = normal(self.test_samples, self.feature_dim)
        y_test = x_test @ w_true + b_true + self.noise * normal(
            self.test_samples, self.targets)
        return {"w_true": w_true, "b_true": b_true,
                "x_test": x_test, "y_test": y_test}

    def init_params(self, generator, dtype, device):
        w = torch.randn((self.feature_dim, self.targets), generator=generator,
                        dtype=dtype, device=device) \
            * (1.0 / self.feature_dim) ** 0.5
        return {"linear": {"w": w, "b": torch.zeros((self.targets,),
                                                    dtype=dtype,
                                                    device=device)}}

    def client_batch(self, state, seed, clients):
        w_true = state["w_true"]
        n, b, d, t = clients.shape[0], self.local_batch, self.feature_dim, \
            self.targets
        z = client_normals(seed, clients, b * (d + t), w_true.dtype)
        x = z[:, :b * d].reshape(n, b, d)
        y = x[..., 0:1] * w_true[0]
        for f in range(1, d):
            y = y + x[..., f:f + 1] * w_true[f]
        y = y + state["b_true"] + self.noise * z[:, b * d:].reshape(n, b, t)
        return {"x": x, "y": y}

    def loss(self, params, batch):
        pred = batch["x"] @ params["linear"]["w"] + params["linear"]["b"]
        return 0.5 * torch.mean(torch.sum((pred - batch["y"]) ** 2, dim=-1))

    def eval_metrics(self, state, params):
        """R^2 on the test set (the engine's "accuracy")."""
        y = state["y_test"]
        pred = state["x_test"] @ params["linear"]["w"] + params["linear"]["b"]
        sse = torch.sum((pred - y) ** 2)
        sst = torch.sum((y - torch.mean(y, dim=0)) ** 2)
        return {"accuracy": 1.0 - sse / torch.clamp_min(sst, 1e-12)}

    def tile_grid(self, params):
        return self.prune_block

    @staticmethod
    def optimum(x: torch.Tensor, y: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Closed-form least-squares (W*, b*) on stacked samples."""
        a = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype,
                                     device=x.device)], dim=-1)
        theta = torch.linalg.lstsq(a, y).solution
        return theta[:-1], theta[-1]


TASKS = {
    "mlp": SyntheticMLPTask,
    "transformer": TransformerTask,
    "linreg": LinearRegressionTask,
}


def make_task(name: str, **kw) -> FleetTask:
    """Build a registered task by name."""
    if name not in TASKS:
        raise ValueError(f"unknown task {name!r}; one of {sorted(TASKS)}")
    return TASKS[name](**kw)
