"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

40 decoder layers; every 5th layer is a cross-attention layer attending to
stub vision-patch embeddings (1600 tokens; the ViT+projector frontend is a
stub per the brief — input_specs() supplies patch embeddings directly).
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, StageSpec

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
    stages=(StageSpec(8, (BlockSpec("attn", "mlp"),
                          BlockSpec("attn", "mlp"),
                          BlockSpec("attn", "mlp"),
                          BlockSpec("attn", "mlp"),
                          BlockSpec("cross_attn", "mlp"))),),
    rope_theta=500000.0, act="silu", norm="rms",
    num_memory_tokens=1600,
    long_context_window=8192, tie_embeddings=False,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
