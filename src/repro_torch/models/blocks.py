"""Pre-norm residual blocks (the port of ``repro.models.blocks`` for the
llama family: attention mixer + optional MLP)::

    x = x + mixer(norm(x))
    x = x + ffn(norm(x))          # if the block has an ffn
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L

_ROADMAP_TAIL = "ROADMAP.md Queue A, item 10"


def _check_kinds(spec) -> None:
    if spec.kind != "attn":
        raise NotImplementedError(
            f"block kind {spec.kind!r} is not ported yet: {_ROADMAP_TAIL}")
    if spec.ffn not in ("mlp", "none"):
        raise NotImplementedError(
            f"ffn kind {spec.ffn!r} is not ported yet: {_ROADMAP_TAIL}")


def _norm_init(cfg, generator) -> dict:
    return L.norm_init(cfg.d_model, cfg.pdtype, bias=(cfg.norm == "ln"),
                       device=L.device_of(generator))


def norm_apply(cfg, p, x):
    return L.rms_norm(p, x) if cfg.norm == "rms" else L.layer_norm(p, x)


def init_block(cfg, spec, generator) -> dict:
    """One sub-block's params: ``norm_mix``, ``attn`` and, for an MLP
    block, ``norm_ffn`` and ``ffn``."""
    _check_kinds(spec)
    p: dict = {"norm_mix": _norm_init(cfg, generator),
               "attn": A.init_gqa(generator, cfg.d_model,
                                  cfg.attn_spec(spec.kind), cfg.pdtype)}
    if spec.ffn == "mlp":
        p["norm_ffn"] = _norm_init(cfg, generator)
        p["ffn"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.pdtype,
                              gated=(cfg.act != "gelu"))
    return p


def apply_block(cfg, spec, p: dict, x: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block application; returns ``(x, aux)`` with the MoE
    auxiliary loss ``aux`` 0 (no MoE block is ported).  ``memory`` (cross
    attention) is not ported."""
    _check_kinds(spec)
    del memory
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    y = norm_apply(cfg, p["norm_mix"], x)
    x = x + A.gqa_forward(p["attn"], cfg.attn_spec(spec.kind), y, positions)
    if "ffn" in p:
        y = norm_apply(cfg, p["norm_ffn"], x)
        x = x + L.mlp(p["ffn"], y, cfg.act)
    return x, aux
