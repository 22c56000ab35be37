"""Architecture configuration schema (the port of ``repro.configs.base``).

An ``ArchConfig`` describes a model as a sequence of *stages*; each stage
repeats a super-block of sub-blocks ``repeats`` times, and the stage's
parameters carry a leading ``repeats`` dim on every leaf.  The parameter
dtype is a name (``"bfloat16"``), mapped to a torch dtype by ``pdtype``.

The port carries the fields of the llama-family decoders it serves
(global attention + MLP blocks); the reference's other block kinds, its
encoder / memory fields, compute dtype and smoke-size reduction come with
the slices that need them.  ``AttnSpec`` lives here too: the reference
keeps it in ``models/attention.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Global causal GQA with RoPE and the 1/sqrt(head_dim) softmax scale
    (the reference's window, scale and no-RoPE options are not ported)."""
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One sub-block of a super-block.

    kind: attn (the reference's other kinds are not ported)
    ffn:  mlp | none
    """
    kind: str
    ffn: str = "mlp"


@dataclasses.dataclass(frozen=True)
class StageSpec:
    repeats: int
    blocks: tuple[BlockSpec, ...]

    @property
    def num_layers(self) -> int:
        return self.repeats * len(self.blocks)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | ...
    source: str                       # citation (arXiv / hf model card)

    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    stages: tuple[StageSpec, ...]

    head_dim: Optional[int] = None    # default d_model // num_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    norm: str = "rms"                 # rms | ln
    act: str = "silu"
    tie_embeddings: bool = True

    param_dtype: str = "float32"      # storage; the serving path runs float32

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.stages)

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    def attn_spec(self, kind: str) -> AttnSpec:
        """The attention of a ``kind`` block: global causal GQA for
        ``"attn"``, the only kind ported."""
        if kind != "attn":
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet: ROADMAP.md "
                "Queue A, item 10")
        return AttnSpec(self.num_heads, self.num_kv_heads, self.head_dim_,
                        self.rope_theta, qkv_bias=self.qkv_bias)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
