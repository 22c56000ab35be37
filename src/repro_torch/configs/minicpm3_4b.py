"""minicpm3-4b [dense] — multi-head latent attention [hf:openbmb/MiniCPM3-4B].

MLA geometry follows the model card: 40 heads, q_lora_rank=768,
kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head_dim=64. num_kv_heads=40
in the assignment reflects MLA's per-head (non-grouped) values.
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, MLASpec, StageSpec

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    source="hf:openbmb/MiniCPM3-4B",
    d_model=2560, num_heads=40, num_kv_heads=40, d_ff=6400, vocab_size=73448,
    stages=(StageSpec(62, (BlockSpec("mla", "mlp"),)),),
    mla=MLASpec(num_heads=40, q_lora_rank=768, kv_lora_rank=256,
                nope_dim=64, rope_dim=32, v_head_dim=64),
    rope_theta=10000.0, act="silu", norm="rms",
    long_context_window=8192,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
