"""whisper-base [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

6 encoder + 6 decoder layers, d_model=512, 8 heads, LayerNorm + GELU.
The mel-spectrogram + conv feature extractor is a STUB: input_specs()
provides 1500 precomputed frame embeddings. long_500k is skipped for this
arch (see DESIGN.md §4): a 524k-token decoder context has no audio
semantics and the decoder is full-attention by construction.
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, StageSpec

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    source="arXiv:2212.04356",
    d_model=512, num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=51865,
    stages=(StageSpec(6, (BlockSpec("attn", "none"),
                          BlockSpec("cross_attn", "mlp"))),),
    encoder_layers=6, num_memory_tokens=1500,
    rope_theta=10000.0, act="gelu", norm="ln",
    long_context_window=None,   # skip long_500k
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
