"""Grouped-query attention parameters (the port of the parts of
``repro.models.attention`` the serving path uses; ``AttnSpec`` lives in
``configs.base``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import AttnSpec
from repro_torch.models import layers as L


def init_gqa(generator, d_model: int, spec: AttnSpec, dtype) -> dict:
    make = L.dense_bias_init if spec.qkv_bias else L.dense_init
    return {
        "wq": make(generator, d_model, spec.num_heads * spec.head_dim, dtype),
        "wk": make(generator, d_model, spec.num_kv_heads * spec.head_dim,
                   dtype),
        "wv": make(generator, d_model, spec.num_kv_heads * spec.head_dim,
                   dtype),
        "wo": L.dense_init(generator, spec.num_heads * spec.head_dim,
                           d_model, dtype),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, x.shape[-1] // n))
