"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn per 2
recurrent blocks [arXiv:2402.19427].

26 layers = 8 x [rec, rec, local_attn] + 2 trailing rec.  Local attention
window 2048 (Griffin); MQA (kv=1) with head_dim 256.  Natively
sub-quadratic: long_500k runs the native local-attention/recurrent path.
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, StageSpec

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    source="arXiv:2402.19427",
    d_model=2560, num_heads=10, num_kv_heads=1, d_ff=7680, vocab_size=256000,
    head_dim=256,
    stages=(StageSpec(8, (BlockSpec("rglru", "mlp"),
                          BlockSpec("rglru", "mlp"),
                          BlockSpec("local_attn", "mlp"))),
            StageSpec(2, (BlockSpec("rglru", "mlp"),))),
    local_window=2048, rnn_width=2560, conv_width=4,
    rope_theta=10000.0, act="gelu_tanh", norm="rms",
    long_context_window=None,   # native sub-quadratic path
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
