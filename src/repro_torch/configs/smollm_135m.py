"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import ArchConfig, BlockSpec, StageSpec

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    d_model=576, num_heads=9, num_kv_heads=3, d_ff=1536, vocab_size=49152,
    stages=(StageSpec(30, (BlockSpec("attn", "mlp"),)),),
    rope_theta=10000.0, act="silu", norm="rms",
    long_context_window=8192,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
