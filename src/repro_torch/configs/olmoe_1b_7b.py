"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060]."""
from repro_torch.configs.base import ArchConfig, BlockSpec, StageSpec
from repro_torch.models.moe import MoESpec

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    source="arXiv:2409.02060",
    d_model=2048, num_heads=16, num_kv_heads=16, d_ff=1024, vocab_size=50304,
    stages=(StageSpec(16, (BlockSpec("attn", "moe"),)),),
    moe=MoESpec(num_experts=64, top_k=8, d_ff=1024),
    rope_theta=10000.0, act="silu", norm="rms",
    long_context_window=8192,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
