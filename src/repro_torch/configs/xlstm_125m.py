"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks [arXiv:2405.04517].

12 layers = 6 x [mlstm, slstm]; blocks carry their own projections
(assigned d_ff=0 -> ffn="none").  O(1) recurrent state => native
long_500k support.
"""
from repro_torch.configs.base import ArchConfig, BlockSpec, StageSpec

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    source="arXiv:2405.04517",
    d_model=768, num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    stages=(StageSpec(6, (BlockSpec("mlstm", "none"),
                          BlockSpec("slstm", "none"))),),
    mlstm_proj_factor=2.0, conv_width=4,
    rope_theta=10000.0, act="gelu", norm="ln",
    long_context_window=None,   # native recurrent path
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
