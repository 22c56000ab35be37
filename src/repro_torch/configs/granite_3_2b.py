"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import ArchConfig, BlockSpec, StageSpec

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    d_model=2048, num_heads=32, num_kv_heads=8, d_ff=8192, vocab_size=49155,
    stages=(StageSpec(40, (BlockSpec("attn", "mlp"),)),),
    rope_theta=10000.0, act="silu", norm="rms",
    long_context_window=8192,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
