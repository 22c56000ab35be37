"""Step functions and abstract inputs for every (arch x input-shape)
combination (the port of ``repro.launch.steps``).

  train_4k     -> train_step(params, batch) -> (params, metrics)
  prefill_32k  -> prefill_step(params, batch) -> (last-token logits, aux)
  decode_32k   -> serve_step(params, token, cache) -> (logits, cache)
  long_500k    -> serve_step with the long-context window variant

As in the reference, the prefill step computes the full forward and the
last position's logits and writes no cache.  ``batch_specs`` and
``cache_specs`` give tensors on the ``meta`` device in place of the
reference's ``ShapeDtypeStruct``s: they allocate nothing, so they run at
full width.  ``input_specs`` pairs them with their specs on a mesh
(``launch.shardings``; a ``DeviceMesh`` or any object with its dim names
and sizes, a 16 x 16 production mesh included) and runs nothing: the
dry run (``launch.dryrun``) traces these steps sharded on a fake group.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.pruning import value_and_grad
from repro_torch.launch import shardings as SH
from repro_torch.models import model as M
from repro_torch.optimizers import sgd

__all__ = ["decode_window", "shape_supported", "make_train_step",
           "make_prefill_step", "make_serve_step", "batch_specs",
           "cache_specs", "input_specs"]


def decode_window(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    """Window override for serve steps: long_500k uses the rolling-buffer
    variant on full-attention archs; None for native sub-quadratic."""
    if shape.name == "long_500k":
        return cfg.long_context_window
    return None


def shape_supported(cfg: ArchConfig, shape: InputShape) -> bool:
    """long_500k runs natively on ssm / hybrid models and with the rolling
    window on full-attention ones; whisper (no window) skips it."""
    if shape.name != "long_500k":
        return True
    native = cfg.family in ("ssm", "hybrid")
    return native or cfg.long_context_window is not None


def make_train_step(cfg: ArchConfig, lr: float = 1e-2):
    """Plain SGD on ``models.model.loss_fn``: ``p - lr * g``."""
    update = sgd().update

    def train_step(params, batch):
        (_, metrics), grads = value_and_grad(
            lambda p: M.loss_fn(cfg, p, batch), params)
        with torch.no_grad():
            new_params, _ = update(params, grads, {}, lr)
        return new_params, metrics
    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            x, aux = M.hidden_states(cfg, params, batch["tokens"],
                                     batch.get("memory"))
            logits = M._unembed(cfg, params, x[:, -1:, :])
        return logits[:, 0, :], aux
    return prefill_step


def make_serve_step(cfg: ArchConfig, window: Optional[int]):
    def serve_step(params, token, cache):
        with torch.no_grad():
            return M.decode_step(cfg, params, token, cache, window=window)
    return serve_step


# ---------------------------------------------------------------------------
# Abstract inputs (``meta`` tensors: no allocation)
# ---------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    if cfg.num_memory_tokens:
        specs["memory"] = torch.empty(
            (b, cfg.num_memory_tokens, cfg.memory_dim_), dtype=cfg.cdtype,
            device="meta")
    return specs


def cache_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """The decode cache ``init_cache`` makes, on ``meta`` (its positions
    are int64, torch's index type, where the reference's are int32)."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                        window=decode_window(cfg, shape), device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    """The step of ``shape``'s mode, its abstract args (``meta`` trees)
    and the specs of its inputs and outputs on ``mesh`` (``None``: left
    to propagation).  Serving (prefill, decode) keeps tensor-only weight
    residency when it fits (``serving_fsdp_needed``); training keeps the
    2-D fsdp x tensor sharding."""
    params_shape = M.init_params(cfg, None)
    fsdp = shape.mode == "train" or SH.serving_fsdp_needed(params_shape,
                                                           mesh)
    p_spec = SH.param_shardings(params_shape, mesh, fsdp=fsdp)
    if shape.mode in ("train", "prefill"):
        batch = batch_specs(cfg, shape)
        train = shape.mode == "train"
        # loss_fn's metrics, each a scalar
        metrics = {k: torch.empty((), device="meta")
                   for k in ("loss", "moe_aux")}
        return {
            "step": make_train_step(cfg) if train else make_prefill_step(cfg),
            "args": (params_shape, batch),
            "in_specs": (p_spec, SH.batch_shardings(batch, mesh)),
            "out_specs": (p_spec, SH.replicated(metrics, mesh)) if train
            else None,
        }
    token = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                        device="meta")
    cache = cache_specs(cfg, shape)
    c_spec = SH.cache_shardings(cache, mesh)
    return {
        "step": make_serve_step(cfg, decode_window(cfg, shape)),
        "args": (params_shape, token, cache),
        "in_specs": (p_spec, SH.batch_shardings(token, mesh), c_spec),
        "out_specs": (None, c_spec),
    }
