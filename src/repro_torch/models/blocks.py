"""Pre-norm residual blocks (the port of ``repro.models.blocks`` for the
llama family: attention mixer + optional MLP)::

    x = x + mixer(norm(x))
    x = x + ffn(norm(x))          # if the block has an ffn
"""

from __future__ import annotations

from repro_torch.models import attention as A
from repro_torch.models import layers as L

_ROADMAP_TAIL = "ROADMAP.md Queue A, item 10"


def _norm_init(cfg, generator) -> dict:
    return L.norm_init(cfg.d_model, cfg.pdtype, bias=(cfg.norm == "ln"),
                       device=L.device_of(generator))


def norm_apply(cfg, p, x):
    return L.rms_norm(p, x) if cfg.norm == "rms" else L.layer_norm(p, x)


def init_block(cfg, spec, generator) -> dict:
    """One sub-block's params: ``norm_mix``, ``attn`` and, for an MLP
    block, ``norm_ffn`` and ``ffn``."""
    if spec.kind != "attn":
        raise NotImplementedError(
            f"block kind {spec.kind!r} is not ported yet: {_ROADMAP_TAIL}")
    if spec.ffn not in ("mlp", "none"):
        raise NotImplementedError(
            f"ffn kind {spec.ffn!r} is not ported yet: {_ROADMAP_TAIL}")
    p: dict = {"norm_mix": _norm_init(cfg, generator),
               "attn": A.init_gqa(generator, cfg.d_model,
                                  cfg.attn_spec(spec.kind), cfg.pdtype)}
    if spec.ffn == "mlp":
        p["norm_ffn"] = _norm_init(cfg, generator)
        p["ffn"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.pdtype,
                              gated=(cfg.act != "gelu"))
    return p
