"""Pre-norm residual blocks (the port of ``repro.models.blocks``): a mixer
(global, sliding-window or cross attention, MLA, RG-LRU, mLSTM or sLSTM),
then an MLP, a mixture of experts or no ffn::

    x = x + mixer(norm(x))
    x = x + ffn(norm(x))          # if the block has an ffn

Each block has an init, a full-sequence apply and a one-token decode
against its cache (``init_block_cache``: see ``models/attention.py`` and
``models/recurrent.py`` for the caches' layouts).  A kind or ffn the
reference does not define raises ``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R

_GQA_KINDS = ("attn", "local_attn", "cross_attn")
# the reference's RG-LRU block calls jax.nn.gelu, whose default is the
# tanh approximation
_gelu = L.ACTS["gelu_tanh"]


def _norm_init(cfg, generator) -> dict:
    return L.norm_init(cfg.d_model, cfg.pdtype, bias=(cfg.norm == "ln"),
                       device=L.device_of(generator))


def norm_apply(cfg, p, x):
    return L.rms_norm(p, x) if cfg.norm == "rms" else L.layer_norm(p, x)


def _mlstm_dims(cfg) -> tuple[int, int]:
    """The mLSTM's inner width and head dim."""
    d_inner = int(cfg.d_model * cfg.mlstm_proj_factor)
    return d_inner, d_inner // cfg.num_heads


def init_block(cfg, spec, generator) -> dict:
    """One sub-block's params: ``norm_mix``, the mixer (``attn`` for the
    attention kinds, ``rec`` for the recurrent ones) and, for an MLP or
    MoE block, ``norm_ffn`` and ``ffn``."""
    p: dict = {"norm_mix": _norm_init(cfg, generator)}
    kind, dt = spec.kind, cfg.pdtype
    if kind in _GQA_KINDS:
        p["attn"] = A.init_gqa(generator, cfg.d_model, cfg.attn_spec(kind), dt)
    elif kind == "mla":
        p["attn"] = A.init_mla(generator, cfg.d_model, cfg.mla_spec(), dt)
    elif kind == "rglru":
        d_rnn = cfg.rnn_width_
        p["rec"] = {
            "w_gate": L.dense_init(generator, cfg.d_model, d_rnn, dt),
            "w_x": L.dense_init(generator, cfg.d_model, d_rnn, dt),
            "conv": R.init_conv1d(generator, d_rnn, cfg.conv_width, dt),
            "rglru": R.init_rglru(generator, d_rnn, dt),
            "w_out": L.dense_init(generator, d_rnn, cfg.d_model, dt),
        }
    elif kind == "mlstm":
        d_inner, hd = _mlstm_dims(cfg)
        p["rec"] = {
            "w_up": L.dense_init(generator, cfg.d_model, 2 * d_inner, dt),
            "conv": R.init_conv1d(generator, d_inner, cfg.conv_width, dt),
            "cell": R.init_mlstm(generator, d_inner, cfg.num_heads, hd, dt),
            "w_down": L.dense_init(generator, d_inner, cfg.d_model, dt),
        }
    elif kind == "slstm":
        hd = cfg.d_model // cfg.num_heads
        p["rec"] = {
            "cell": R.init_slstm(generator, cfg.d_model, cfg.num_heads, hd,
                                 dt),
            "w_out": L.dense_init(generator, cfg.d_model, cfg.d_model, dt),
        }
    else:
        raise ValueError(f"unknown block kind {kind!r}")

    if spec.ffn == "mlp":
        p["norm_ffn"] = _norm_init(cfg, generator)
        p["ffn"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, dt,
                              gated=(cfg.act != "gelu"))
    elif spec.ffn == "moe":
        p["norm_ffn"] = _norm_init(cfg, generator)
        p["ffn"] = M.init_moe(generator, cfg.d_model, cfg.moe_spec(), dt)
    elif spec.ffn != "none":
        raise ValueError(f"unknown ffn kind {spec.ffn!r}")
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


def _mix(cfg, spec, p: dict, y: torch.Tensor,
         memory: Optional[torch.Tensor],
         positions: Optional[torch.Tensor]) -> torch.Tensor:
    """The mixer over the whole sequence of the normed ``y``."""
    kind = spec.kind
    if kind in ("attn", "local_attn"):
        return A.gqa_forward(p["attn"], cfg.attn_spec(kind), y, positions)
    if kind == "cross_attn":
        return A.gqa_forward(p["attn"], cfg.attn_spec(kind), y, kv_x=memory)
    if kind == "mla":
        return A.mla_forward(p["attn"], cfg.mla_spec(), y, positions)
    r = p.get("rec")
    if kind == "rglru":
        gate = _gelu(L.dense(r["w_gate"], y))
        u = R.conv1d(r["conv"], L.dense(r["w_x"], y))
        return L.dense(r["w_out"], gate * R.rglru(r["rglru"], u))
    if kind == "mlstm":
        main, gate = torch.chunk(L.dense(r["w_up"], y), 2, dim=-1)
        main = R.conv1d(r["conv"], main)
        return L.dense(r["w_down"], R.mlstm(r["cell"], main) * F.silu(gate))
    if kind == "slstm":
        return L.dense(r["w_out"], R.slstm(r["cell"], y))
    raise ValueError(f"unknown block kind {kind!r}")


def apply_block(cfg, spec, p: dict, x: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block application; returns ``(x, aux)``, ``aux`` the
    MoE auxiliary loss (0 without a MoE).  ``memory`` (B, T, d) is a
    cross-attention block's keys' and values' source; with None the
    block attends over x itself, without a mask or RoPE (as the
    reference does)."""
    y = norm_apply(cfg, p["norm_mix"], x)
    x, aux = _ffn(cfg, spec, p, x + _mix(cfg, spec, p, y, memory, positions))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def init_block_cache(cfg, spec, batch: int, cache_len: int,
                     window: Optional[int], device=None) -> dict:
    """Zeroed decode cache for one sub-block in the compute dtype (the
    recurrent states in float32).  ``window`` overrides the attention
    window (the long-context rolling variant); a windowed block's buffer
    is ``min(cache_len, window)`` wide.  A cross-attention block's is its
    memory's K/V, ``num_memory_tokens`` long."""
    kind, dt = spec.kind, cfg.cdtype
    if kind in ("attn", "local_attn"):
        aspec = cfg.attn_spec(kind, window_override=window)
        buf = cache_len if aspec.window is None \
            else min(cache_len, aspec.window)
        return A.init_gqa_cache(aspec, batch, buf, dt, device)
    if kind == "cross_attn":
        aspec = cfg.attn_spec(kind)
        shape = (batch, cfg.num_memory_tokens, aspec.num_kv_heads,
                 aspec.head_dim)
        return {"mk": torch.zeros(shape, dtype=dt, device=device),
                "mv": torch.zeros(shape, dtype=dt, device=device)}
    if kind == "mla":
        mspec = cfg.mla_spec(window_override=window)
        buf = cache_len if mspec.window is None \
            else min(cache_len, mspec.window)
        return A.init_mla_cache(mspec, batch, buf, dt, device)
    if kind == "rglru":
        d_rnn = cfg.rnn_width_
        return {"conv": R.init_conv1d_state(batch, d_rnn, cfg.conv_width, dt,
                                            device),
                "rnn": R.init_rglru_state(batch, d_rnn, device)}
    if kind == "mlstm":
        d_inner, hd = _mlstm_dims(cfg)
        return {"conv": R.init_conv1d_state(batch, d_inner, cfg.conv_width,
                                            dt, device),
                "cell": R.init_mlstm_state(batch, cfg.num_heads, hd, device)}
    if kind == "slstm":
        return {"cell": R.init_slstm_state(batch, cfg.num_heads,
                                           cfg.d_model // cfg.num_heads,
                                           device)}
    raise ValueError(f"unknown block kind {kind!r}")


def _mix_decode(cfg, spec, p: dict, y: torch.Tensor, cache: dict,
                pos: torch.Tensor, window: Optional[int]
                ) -> tuple[torch.Tensor, dict]:
    """The mixer on one token of the normed ``y``: (h, new cache)."""
    kind = spec.kind
    if kind in ("attn", "local_attn"):
        return A.gqa_decode(p["attn"], cfg.attn_spec(
            kind, window_override=window), y, cache, pos)
    if kind == "cross_attn":
        return A.cross_decode(p["attn"], cfg.attn_spec(kind), y, cache["mk"],
                              cache["mv"]), cache
    if kind == "mla":
        return A.mla_decode(p["attn"], cfg.mla_spec(window_override=window),
                            y, cache, pos)
    r = p.get("rec")
    if kind == "rglru":
        gate = _gelu(L.dense(r["w_gate"], y))
        u, conv_st = R.conv1d_step(r["conv"], L.dense(r["w_x"], y),
                                   cache["conv"])
        hr, rnn_st = R.rglru_step(r["rglru"], u, cache["rnn"])
        return L.dense(r["w_out"], gate * hr), {"conv": conv_st,
                                                "rnn": rnn_st}
    if kind == "mlstm":
        main, gate = torch.chunk(L.dense(r["w_up"], y), 2, dim=-1)
        main, conv_st = R.conv1d_step(r["conv"], main, cache["conv"])
        hr, cell_st = R.mlstm_step(r["cell"], main, cache["cell"])
        return L.dense(r["w_down"], hr * F.silu(gate)), {"conv": conv_st,
                                                         "cell": cell_st}
    if kind == "slstm":
        hr, cell_st = R.slstm_step(r["cell"], y, cache["cell"])
        return L.dense(r["w_out"], hr), {"cell": cell_st}
    raise ValueError(f"unknown block kind {kind!r}")


def apply_block_decode(cfg, spec, p: dict, x: torch.Tensor, cache: dict,
                       pos: torch.Tensor, window: Optional[int]
                       ) -> tuple[torch.Tensor, dict]:
    """One-token block application; x: (B, 1, d), pos: (B,).  Returns
    ``(x, new cache)``; the MoE's auxiliary loss is dropped, as in the
    reference."""
    y = norm_apply(cfg, p["norm_mix"], x)
    h, new_cache = _mix_decode(cfg, spec, p, y, cache, pos, window)
    x, _ = _ffn(cfg, spec, p, x + h)
    return x, new_cache


def fill_cross_cache(cfg, spec, p: dict, cache: dict,
                     memory: torch.Tensor) -> dict:
    """A cross-attention block's static memory K/V, in its cache's
    dtype."""
    del spec
    mk, mv = A.cross_memory(p["attn"], cfg.attn_spec("cross_attn"), memory)
    return {"mk": mk.to(cache["mk"].dtype), "mv": mv.to(cache["mv"].dtype)}
