"""Model parameters for the llama family (the port of
``repro.models.model.init_params``).

Stage params carry a leading ``repeats`` dim on every leaf, as in the
reference, whose layer stacks are scanned per stage.
"""

from __future__ import annotations

import torch

from repro_torch.core import pruning
from repro_torch.models import blocks as B
from repro_torch.models import layers as L


def _init_stage(cfg, stage, generator) -> dict:
    """Stacked params: every leaf gets leading dim ``stage.repeats``."""
    layers = [{f"b{i}": B.init_block(cfg, spec, generator)
               for i, spec in enumerate(stage.blocks)}
              for _ in range(stage.repeats)]
    stacked = [torch.stack(leaves) for leaves in
               zip(*(pruning.flatten(layer) for layer in layers))]
    return pruning.unflatten(layers[0], stacked)


def init_params(cfg, generator) -> dict:
    """``{"embed", "final_norm", "stages"[, "unembed"]}`` in
    ``cfg.param_dtype`` on the generator's device (``generator=None``:
    ``meta`` tensors, shapes only)."""
    params: dict = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model,
                              cfg.pdtype),
        "final_norm": L.norm_init(cfg.d_model, cfg.pdtype,
                                  bias=(cfg.norm == "ln"),
                                  device=L.device_of(generator)),
        "stages": [_init_stage(cfg, st, generator) for st in cfg.stages],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, cfg.pdtype)
    return params

