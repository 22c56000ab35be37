"""qwen2-7b [dense] — GQA, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig, BlockSpec, StageSpec

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    source="arXiv:2407.10671",
    d_model=3584, num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    stages=(StageSpec(28, (BlockSpec("attn", "mlp"),)),),
    rope_theta=1e6, qkv_bias=True, act="silu", norm="rms",
    long_context_window=8192, tie_embeddings=False,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
