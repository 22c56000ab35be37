"""The llama-family decoder (the port of ``repro.models.model``): init,
the full-sequence forward, the causal-LM loss and the dense one-token
decode.

Stage params carry a leading ``repeats`` dim on every leaf, as in the
reference, whose layer stacks are scanned per stage; here the forward
and the decode loop over the repeats (one ``unbind`` a stage leaf, so the
backward stacks each leaf's per-layer gradients once).  Decode caches
stack the same way: ``{"pos": (B,), "stages": [...]}`` with a leading
``repeats`` dim on every stage leaf.  The dense decode is the serving
path's oracle: ``serve.model.SparseModel`` matches it on masked params.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import pruning
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

PyTree = Any

# (seq * vocab) threshold above which the loss streams over seq chunks
# instead of forming the whole (B, S, V) logits
_CHUNKED_LOSS_ELEMS = 64 * 1024 * 1024
_LOSS_CHUNK = 512


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

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


def param_count(params: PyTree) -> int:
    return sum(int(leaf.numel()) for leaf in pruning.flatten(params))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _unstack(tree) -> list:
    """A stage's stacked tree -> one tree per repeat."""
    leaves = [torch.unbind(leaf) for leaf in pruning.flatten(tree)]
    return [pruning.unflatten(tree, [lv[r] for lv in leaves])
            for r in range(len(leaves[0]))] if leaves else []


def _stage_forward(cfg, stage, stage_params, x, positions):
    """The stage's super-block applied once per repeat, in order."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in _unstack(stage_params):
        for i, spec in enumerate(stage.blocks):
            x, a = B.apply_block(cfg, spec, layer[f"b{i}"], x, None,
                                 positions)
            aux = aux + a
    return x, aux


def hidden_states(cfg, params, tokens: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual stream after the final norm (pre-unembedding), and the
    auxiliary loss; tokens: (B, S) integers."""
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens, cfg.cdtype)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stage, stage_params in zip(cfg.stages, params["stages"]):
        x, a = _stage_forward(cfg, stage, stage_params, x, positions)
        aux = aux + a
    return B.norm_apply(cfg, params["final_norm"], x), aux


def _unembed(cfg, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.dense(params["unembed"], x.to(torch.float32))


def forward(cfg, params, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V) float32, auxiliary loss)."""
    x, aux = hidden_states(cfg, params, tokens)
    return _unembed(cfg, params, x), aux


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].to(torch.int64))[..., 0]


def _chunked_nll(cfg, params, x: torch.Tensor, targets: torch.Tensor,
                 chunk: int = _LOSS_CHUNK) -> torch.Tensor:
    """Streaming cross-entropy: logits exist one (B, chunk, V) block at a
    time, summed chunk by chunk in order; the mean over every token."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(0, s, chunk):
        logits = _unembed(cfg, params, x[:, j:j + chunk])
        total = total + torch.sum(_nll(logits, targets[:, j:j + chunk]))
    return total / (b * s)


def loss_fn(cfg, params, batch: dict, aux_weight: float = 0.01
            ) -> tuple[torch.Tensor, dict]:
    """Causal LM loss (next token); batch = ``{"tokens"[, "mask"]}``.
    A (seq x vocab) product above ``_CHUNKED_LOSS_ELEMS`` without a mask
    streams the unembedding and the cross-entropy over sequence chunks."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    mask = batch.get("mask")
    if mask is None and (s - 1) * cfg.vocab_size > _CHUNKED_LOSS_ELEMS:
        x, aux = hidden_states(cfg, params, tokens)
        # positions 0..S-2 predict tokens 1..S-1
        loss = _chunked_nll(cfg, params, x[:, :-1], tokens[:, 1:])
    else:
        logits, aux = forward(cfg, params, tokens)
        nll = _nll(logits[:, :-1], tokens[:, 1:])
        if mask is not None:
            m = mask[:, 1:].to(torch.float32)
            loss = torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
        else:
            loss = torch.mean(nll)
    return loss + aux_weight * aux, {"loss": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, cache_len: int,
               window: Optional[int] = None, device=None) -> dict:
    """Zeroed decode cache on ``device`` (the card unless ``"cpu"``);
    every stage's leaves carry a leading repeats dim.  ``window`` enables
    the rolling-buffer long-context variant."""
    dev = resolve_device(device)
    cache: dict = {"pos": torch.zeros((batch,), dtype=torch.int64,
                                      device=dev), "stages": []}
    for stage in cfg.stages:
        one = {f"b{i}": B.init_block_cache(cfg, spec, batch, cache_len,
                                           window, dev)
               for i, spec in enumerate(stage.blocks)}
        cache["stages"].append(pruning.tree_map(
            lambda a: torch.zeros((stage.repeats,) + tuple(a.shape),
                                  dtype=a.dtype, device=dev), one))
    return cache


def fill_cross_caches(cfg, params, cache: dict, memory: torch.Tensor):
    raise NotImplementedError(f"fill_cross_caches is not ported yet: "
                              f"{A._ROADMAP_CROSS}")


def decode_step(cfg, params, token: torch.Tensor, cache: dict,
                window: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """One serving step; token: (B, 1) integers at positions
    ``cache["pos"]`` -> (logits (B, V) float32, the new cache).  The
    given cache is not written."""
    pos = cache["pos"]
    x = L.embed(params["embed"], token, cfg.cdtype)
    new_stages = []
    for stage, stage_params, stage_cache in zip(cfg.stages, params["stages"],
                                                cache["stages"]):
        layers = []
        for layer, lc in zip(_unstack(stage_params), _unstack(stage_cache)):
            new_c = {}
            for i, spec in enumerate(stage.blocks):
                x, new_c[f"b{i}"] = B.apply_block_decode(
                    cfg, spec, layer[f"b{i}"], x, lc[f"b{i}"], pos, window)
            layers.append(new_c)
        new_stages.append(pruning.unflatten(stage_cache, [
            torch.stack(leaves) for leaves in
            zip(*(pruning.flatten(c) for c in layers))]))
    x = B.norm_apply(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x)[:, 0, :], {"pos": pos + 1,
                                                "stages": new_stages}
