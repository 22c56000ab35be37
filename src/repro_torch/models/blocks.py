"""Pre-norm residual blocks (the port of ``repro.models.blocks`` for the
llama family: a global or sliding-window attention mixer, then an MLP, a
mixture of experts or no ffn)::

    x = x + mixer(norm(x))
    x = x + ffn(norm(x))          # if the block has an ffn

Each block has an init, a full-sequence apply and a one-token decode
against its cache (``init_block_cache``: see ``models/attention.py`` for
the cache's layout).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

_ROADMAP_TAIL = "ROADMAP.md Queue A, item 10"


def _check_kinds(spec) -> None:
    if spec.kind not in ("attn", "local_attn"):
        raise NotImplementedError(
            f"block kind {spec.kind!r} is not ported yet: {_ROADMAP_TAIL}")
    if spec.ffn not in ("mlp", "moe", "none"):
        raise NotImplementedError(
            f"ffn kind {spec.ffn!r} is not ported yet: {_ROADMAP_TAIL}")


def _norm_init(cfg, generator) -> dict:
    return L.norm_init(cfg.d_model, cfg.pdtype, bias=(cfg.norm == "ln"),
                       device=L.device_of(generator))


def norm_apply(cfg, p, x):
    return L.rms_norm(p, x) if cfg.norm == "rms" else L.layer_norm(p, x)


def init_block(cfg, spec, generator) -> dict:
    """One sub-block's params: ``norm_mix``, ``attn`` and, for an MLP or
    MoE block, ``norm_ffn`` and ``ffn``."""
    _check_kinds(spec)
    p: dict = {"norm_mix": _norm_init(cfg, generator),
               "attn": A.init_gqa(generator, cfg.d_model,
                                  cfg.attn_spec(spec.kind), cfg.pdtype)}
    if spec.ffn == "mlp":
        p["norm_ffn"] = _norm_init(cfg, generator)
        p["ffn"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.pdtype,
                              gated=(cfg.act != "gelu"))
    elif spec.ffn == "moe":
        p["norm_ffn"] = _norm_init(cfg, generator)
        p["ffn"] = M.init_moe(generator, cfg.d_model, cfg.moe_spec(),
                              cfg.pdtype)
    return p


def _ffn(cfg, spec, p: dict, x: torch.Tensor
         ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's ffn residual: ``(x, aux)`` (``aux`` None without a
    MoE)."""
    if "ffn" not in p:
        return x, None
    y = norm_apply(cfg, p["norm_ffn"], x)
    if spec.ffn == "moe":
        h, aux = M.moe_ffn(p["ffn"], cfg.moe_spec(), y)
        return x + h, aux
    return x + L.mlp(p["ffn"], y, cfg.act), None


def apply_block(cfg, spec, p: dict, x: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block application; returns ``(x, aux)``, ``aux`` the
    MoE auxiliary loss (0 without a MoE).  ``memory`` (cross attention)
    is not ported."""
    _check_kinds(spec)
    del memory
    y = norm_apply(cfg, p["norm_mix"], x)
    x = x + A.gqa_forward(p["attn"], cfg.attn_spec(spec.kind), y, positions)
    x, aux = _ffn(cfg, spec, p, x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def init_block_cache(cfg, spec, batch: int, cache_len: int,
                     window: Optional[int], device=None) -> dict:
    """Zeroed decode cache for one sub-block in the compute dtype.
    ``window`` overrides the attention window (the long-context rolling
    variant); a windowed block's buffer is ``min(cache_len, window)``
    wide."""
    _check_kinds(spec)
    aspec = cfg.attn_spec(spec.kind, window_override=window)
    buf = cache_len if aspec.window is None else min(cache_len, aspec.window)
    return A.init_gqa_cache(aspec, batch, buf, cfg.cdtype, device)


def apply_block_decode(cfg, spec, p: dict, x: torch.Tensor, cache: dict,
                       pos: torch.Tensor, window: Optional[int]
                       ) -> tuple[torch.Tensor, dict]:
    """One-token block application; x: (B, 1, d), pos: (B,).  Returns
    ``(x, new cache)``; the MoE's auxiliary loss is dropped, as in the
    reference."""
    _check_kinds(spec)
    y = norm_apply(cfg, p["norm_mix"], x)
    h, new_cache = A.gqa_decode(
        p["attn"], cfg.attn_spec(spec.kind, window_override=window), y,
        cache, pos)
    x, _ = _ffn(cfg, spec, p, x + h)
    return x, new_cache
