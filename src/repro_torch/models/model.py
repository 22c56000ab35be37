"""Model orchestration (the port of ``repro.models.model``): init, the
full-sequence forward, the causal-LM loss, the dense one-token decode
and the cross-attention caches, for every architecture an
``ArchConfig`` describes.

Stage params carry a leading ``repeats`` dim on every leaf, as in the
reference, whose layer stacks are scanned per stage; here the forward
and the decode loop over the repeats (one ``unbind`` a stage leaf, so the
backward stacks each leaf's per-layer gradients once).  Under
``cfg.remat == "block"`` each repeat of a super-block, and each encoder
layer, runs under ``layers.checkpoint`` (the reference's
``jax.checkpoint`` of its scan bodies): the backward keeps only the
residual stream between repeats and recomputes the rest.  The streamed
loss checkpoints each chunk whatever ``remat`` says, as the reference
does.  Decode caches
stack the same way: ``{"pos": (B,), "stages": [...]}`` with a leading
``repeats`` dim on every stage leaf.  The dense decode is the serving
path's oracle: ``serve.model.SparseModel`` matches it on masked params.

A model with ``num_memory_tokens`` takes stub frontend embeddings
(``memory``, (B, T, memory_dim)): ``memory_proj`` maps them to d_model
and, with ``encoder_layers``, a bidirectional encoder runs over them; its
cross-attention blocks attend to the result.  Without memory those
blocks attend over the tokens themselves, unmasked, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import BlockSpec, StageSpec
from repro_torch.core import pruning
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import sharding as S

PyTree = Any

# (seq * vocab) threshold above which the loss streams over seq chunks
# instead of forming the whole (B, S, V) logits
_CHUNKED_LOSS_ELEMS = 64 * 1024 * 1024
_LOSS_CHUNK = 512


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _stack(trees: list):
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading dim."""
    return pruning.unflatten(trees[0], [
        torch.stack(leaves) for leaves in
        zip(*(pruning.flatten(tree) for tree in trees))])


def _init_stage(cfg, stage, generator) -> dict:
    """Stacked params: every leaf gets leading dim ``stage.repeats``."""
    return _stack([{f"b{i}": B.init_block(cfg, spec, generator)
                    for i, spec in enumerate(stage.blocks)}
                   for _ in range(stage.repeats)])


def _encoder(cfg):
    """The encoder's config (no qkv bias) and its stage of bidirectional
    attention blocks with MLPs."""
    return (cfg.replace(qkv_bias=False),
            StageSpec(cfg.encoder_layers, (BlockSpec("attn", "mlp"),)))


def init_params(cfg, generator) -> dict:
    """``{"embed", "final_norm", "stages"[, "unembed"][, "memory_proj"]
    [, "encoder"]}`` in ``cfg.param_dtype`` on the generator's device
    (``generator=None``: ``meta`` tensors, shapes only)."""
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
    if cfg.num_memory_tokens > 0:
        params["memory_proj"] = L.dense_init(generator, cfg.memory_dim_,
                                             cfg.d_model, cfg.pdtype)
    if cfg.encoder_layers > 0:
        enc_cfg, enc_stage = _encoder(cfg)
        params["encoder"] = {
            "stage": _init_stage(enc_cfg, enc_stage, generator),
            "norm": L.norm_init(cfg.d_model, cfg.pdtype,
                                bias=(cfg.norm == "ln"),
                                device=L.device_of(generator)),
        }
    return params


def param_count(params: PyTree) -> int:
    return sum(int(leaf.numel()) for leaf in pruning.flatten(params))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _unstack(tree) -> list:
    """A stage's stacked tree -> one tree per repeat."""
    leaves = [S.unbind(leaf) for leaf in pruning.flatten(tree)]
    return [pruning.unflatten(tree, [lv[r] for lv in leaves])
            for r in range(len(leaves[0]))] if leaves else []


def _remat(cfg, body, *args):
    """``body(*args)``, checkpointed under ``cfg.remat == "block"``."""
    return L.checkpoint(body, *args) if cfg.remat == "block" \
        else body(*args)


def _stage_forward(cfg, stage, stage_params, x, memory, positions):
    """The stage's super-block applied once per repeat, in order."""

    def body(x, aux, layer):
        for i, spec in enumerate(stage.blocks):
            x, a = B.apply_block(cfg, spec, layer[f"b{i}"], x, memory,
                                 positions)
            aux = aux + a
        return S.constrain(x, "batch", "seq", "embed"), aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in _unstack(stage_params):
        x, aux = _remat(cfg, body, x, aux, layer)
    return x, aux


def _positions(s: int, device) -> torch.Tensor:
    """(1, S): every row's positions, broadcast over the batch (RoPE's
    angles are then computed once, not once a row)."""
    return torch.arange(s, device=device)[None]


def _encode_memory(cfg, params, memory_raw: Optional[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
    """Stub-frontend embeddings (B, T, memory_dim) -> model-space memory
    (B, T, d_model): ``memory_proj`` and, with ``encoder_layers``, the
    bidirectional encoder (RoPE at the memory positions) and its norm.
    None stays None."""
    if memory_raw is None:
        return None
    mem = L.dense(params["memory_proj"], memory_raw.to(cfg.cdtype))
    if cfg.encoder_layers > 0:
        enc_cfg, _ = _encoder(cfg)
        spec = dataclasses.replace(enc_cfg.attn_spec("attn"), causal=False)
        positions = _positions(mem.shape[1], mem.device)

        def body(mem, p):
            y = B.norm_apply(enc_cfg, p["norm_mix"], mem)
            mem = mem + A.gqa_forward(p["attn"], spec, y, positions)
            y = B.norm_apply(enc_cfg, p["norm_ffn"], mem)
            return mem + L.mlp(p["ffn"], y, enc_cfg.act)

        for layer in _unstack(params["encoder"]["stage"]):
            mem = _remat(cfg, body, mem, layer["b0"])
        mem = B.norm_apply(cfg, params["encoder"]["norm"], mem)
    return mem


def hidden_states(cfg, params, tokens: torch.Tensor,
                  memory: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual stream after the final norm (pre-unembedding), and the
    auxiliary loss; tokens: (B, S) integers, ``memory`` the stub
    frontend's embeddings (a model without memory tokens ignores it)."""
    x = S.constrain(L.embed(params["embed"], tokens, cfg.cdtype),
                    "batch", "seq", "embed")
    positions = _positions(tokens.shape[1], tokens.device)
    mem = _encode_memory(cfg, params, memory) if cfg.num_memory_tokens \
        else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stage, stage_params in zip(cfg.stages, params["stages"]):
        x, a = _stage_forward(cfg, stage, stage_params, x, mem, positions)
        aux = aux + a
    return B.norm_apply(cfg, params["final_norm"], x), aux


def _unembed(cfg, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.dense(params["unembed"], x.to(torch.float32))


def forward(cfg, params, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V) float32, auxiliary loss)."""
    x, aux = hidden_states(cfg, params, tokens, memory)
    return S.constrain(_unembed(cfg, params, x), "batch", "seq", "vocab"), aux


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[targets]; DTensor logits through
    ``sharding.vocab_nll`` (each rank's rows and vocab slice)."""
    if isinstance(logits, DTensor):
        return S.vocab_nll(logits, targets)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].to(torch.int64))[..., 0]


def _chunked_nll(cfg, params, x: torch.Tensor, targets: torch.Tensor,
                 chunk: int = _LOSS_CHUNK) -> torch.Tensor:
    """Streaming cross-entropy: logits exist one (B, chunk, V) block at a
    time, summed chunk by chunk in order; the mean over every token.  Each
    chunk is checkpointed, so the backward recomputes its logits too.  The
    last chunk is ragged where ``chunk`` does not divide S.  The reference
    halves its chunk until it divides S, so an odd S (train_4k's 4,095
    predictions) streams one position at a time there: the same mean,
    summed in another order, where the port takes 8 chunks."""
    b, s, _ = x.shape
    chunk = min(chunk, s)

    def body(xb, tb):
        return torch.sum(_nll(_unembed(cfg, params, xb), tb))

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(0, s, chunk):
        total = total + L.checkpoint(body, x[:, j:j + chunk],
                                     targets[:, j:j + chunk])
    return total / (b * s)


def loss_fn(cfg, params, batch: dict, aux_weight: float = 0.01
            ) -> tuple[torch.Tensor, dict]:
    """Causal LM loss (next token); batch = ``{"tokens"[, "memory"]
    [, "mask"]}``.
    A (seq x vocab) product above ``_CHUNKED_LOSS_ELEMS`` without a mask
    streams the unembedding and the cross-entropy over sequence chunks."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    mask = batch.get("mask")
    if mask is None and (s - 1) * cfg.vocab_size > _CHUNKED_LOSS_ELEMS:
        x, aux = hidden_states(cfg, params, tokens, batch.get("memory"))
        # positions 0..S-2 predict tokens 1..S-1
        loss = _chunked_nll(cfg, params, x[:, :-1], tokens[:, 1:])
    else:
        logits, aux = forward(cfg, params, tokens, batch.get("memory"))
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


def fill_cross_caches(cfg, params, cache: dict, memory: torch.Tensor
                      ) -> dict:
    """The cache with every cross-attention block's static K/V computed
    from the stub embeddings ``memory`` (B, T, memory_dim) through
    ``_encode_memory``; the given cache is not written."""
    mem = _encode_memory(cfg, params, memory)
    new_stages = []
    for stage, sp, sc in zip(cfg.stages, params["stages"], cache["stages"]):
        out = dict(sc)
        for i, spec in enumerate(stage.blocks):
            if spec.kind == "cross_attn":
                out[f"b{i}"] = _stack([
                    B.fill_cross_cache(cfg, spec, p, c, mem) for p, c in
                    zip(_unstack(sp[f"b{i}"]), _unstack(sc[f"b{i}"]))])
        new_stages.append(out)
    return {"pos": cache["pos"], "stages": new_stages}


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
        new_stages.append(_stack(layers))
    x = B.norm_apply(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x)[:, 0, :], {"pos": pos + 1,
                                                "stages": new_stages}
