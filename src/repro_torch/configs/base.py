"""Architecture configuration schema (the port of ``repro.configs.base``).

An ``ArchConfig`` describes a model as a sequence of *stages*; each stage
repeats a super-block of sub-blocks ``repeats`` times, and the stage's
parameters carry a leading ``repeats`` dim on every leaf.  The parameter
dtype is a name (``"bfloat16"``), mapped to a torch dtype by ``pdtype``.

The port carries every field of the reference's config: widths, the
parameter and compute dtypes, the rematerialization policy ``remat``
(``"block"``: each super-block's forward is recomputed in the backward,
``models.model``), the window fields, the MoE and MLA specs, the
recurrent widths, the stub modality frontend's encoder and memory
fields, and the smoke-size reduction.
``AttnSpec`` and ``MLASpec`` live here too: the reference keeps them in
``models/attention.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.moe import MoESpec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Grouped-query attention: causal or not, an optional sliding window
    (tokens), RoPE or none, and the softmax scale (1/sqrt(head_dim) unless
    ``softmax_scale`` is given)."""
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    causal: bool = True
    window: Optional[int] = None
    use_rope: bool = True
    softmax_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        return self.softmax_scale if self.softmax_scale is not None \
            else self.head_dim ** -0.5


@dataclasses.dataclass(frozen=True)
class MLASpec:
    """Multi-head latent attention (MiniCPM3 / DeepSeek-V2): queries and
    keys/values through low-rank latents, per-head ``nope_dim`` dims
    without RoPE beside ``rope_dim`` rotary dims (the keys' shared by every
    head), an optional sliding window."""
    num_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    nope_dim: int
    rope_dim: int
    v_head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None

    @property
    def scale(self) -> float:
        return (self.nope_dim + self.rope_dim) ** -0.5


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One sub-block of a super-block.

    kind: attn | local_attn | cross_attn | mla | mlstm | slstm | rglru
    ffn:  mlp | moe | none
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

    # the window of "local_attn" blocks, and the long-context decode
    # variant's rolling window (None: the arch has none)
    local_window: int = 2048
    long_context_window: Optional[int] = 8192

    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None

    # recurrent sizing
    rnn_width: Optional[int] = None   # RG-LRU width (default d_model)
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0    # mLSTM inner width / d_model

    # stub modality frontend (audio frames / vision patch embeddings)
    encoder_layers: int = 0           # whisper encoder depth
    num_memory_tokens: int = 0        # frames (1500) / image patches (1600)
    memory_dim: Optional[int] = None  # defaults to d_model

    param_dtype: str = "float32"      # storage; the serving path runs float32
    compute_dtype: str = "float32"    # activations of the forward and decode
    remat: str = "block"              # none | block: recompute super-blocks
    moe_capacity_factor: float = 1.25

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.stages) + self.encoder_layers

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def rnn_width_(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def memory_dim_(self) -> int:
        return self.memory_dim or self.d_model

    def attn_spec(self, kind: str, window_override: Optional[int] = None
                  ) -> AttnSpec:
        """The attention of a ``kind`` block: causal GQA, windowed by
        ``window_override`` or, for ``"local_attn"``, ``local_window``;
        ``"cross_attn"`` is non-causal, unwindowed and without RoPE."""
        if kind == "cross_attn":
            return AttnSpec(self.num_heads, self.num_kv_heads, self.head_dim_,
                            self.rope_theta, qkv_bias=self.qkv_bias,
                            causal=False, window=None, use_rope=False)
        window = window_override
        if window is None and kind == "local_attn":
            window = self.local_window
        return AttnSpec(self.num_heads, self.num_kv_heads, self.head_dim_,
                        self.rope_theta, qkv_bias=self.qkv_bias,
                        causal=True, window=window)

    def mla_spec(self, window_override: Optional[int] = None) -> MLASpec:
        """The MLA spec, windowed by ``window_override`` if given."""
        if self.mla is None:
            raise ValueError(f"{self.name} has no MLA spec")
        if window_override is None:
            return self.mla
        return dataclasses.replace(self.mla, window=window_override)

    def moe_spec(self) -> MoESpec:
        """The MoE spec with the config's capacity factor."""
        if self.moe is None:
            raise ValueError(f"{self.name} has no MoE spec")
        return dataclasses.replace(self.moe,
                                   capacity_factor=self.moe_capacity_factor)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke_variant(self) -> "ArchConfig":
        """The reference's reduced config for CPU runs: one repeat of the
        first two stages (sub-blocks deduplicated by (kind, ffn), at most
        three), d_model <= 128, <= 4 heads (a multiple of the KV heads),
        d_ff <= 256, vocab <= 512, <= 4 experts of top-k <= 2 and width
        <= 128, <= 2 encoder layers, <= 16 memory tokens, an RG-LRU at
        most d_model wide, MLA ranks 64 / 32 with 16 + 16 query dims,
        float32 parameters and compute, no rematerialization."""
        small_stages = []
        for st in self.stages[:2]:
            seen, blocks = set(), []
            for b in st.blocks:
                if (b.kind, b.ffn) not in seen:
                    seen.add((b.kind, b.ffn))
                    blocks.append(b)
            small_stages.append(StageSpec(1, tuple(blocks[:3])))
        d_model = min(self.d_model, 128)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        heads = (heads // kv) * kv if heads % kv else heads
        kw = dict(
            stages=tuple(small_stages), d_model=d_model, num_heads=heads,
            num_kv_heads=kv, head_dim=d_model // heads,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            encoder_layers=min(self.encoder_layers, 2),
            num_memory_tokens=min(self.num_memory_tokens, 16),
            rnn_width=min(self.rnn_width_, d_model),
            param_dtype="float32", compute_dtype="float32", remat="none")
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2), d_ff=min(self.moe.d_ff, 128))
        if self.mla is not None:
            kw["mla"] = dataclasses.replace(
                self.mla, num_heads=heads, q_lora_rank=64, kv_lora_rank=32,
                nope_dim=16, rope_dim=16, v_head_dim=d_model // heads)
        return self.replace(**kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                 # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
