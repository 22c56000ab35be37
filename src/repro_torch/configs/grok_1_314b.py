"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

315.7 B params (631 GB in bfloat16): more than four H100s hold (320
GB) even with its weights sharded over them (``launch.shardings``, the
FL step's ``tp_shard_params``), so its full width waits for the
production mesh; one card runs its smoke width."""
from repro_torch.configs.base import ArchConfig, BlockSpec, StageSpec
from repro_torch.models.moe import MoESpec

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    source="hf:xai-org/grok-1",
    d_model=6144, num_heads=48, num_kv_heads=8, d_ff=32768, vocab_size=131072,
    stages=(StageSpec(64, (BlockSpec("attn", "moe"),)),),
    moe=MoESpec(num_experts=8, top_k=2, d_ff=32768),
    rope_theta=10000.0, act="gelu", norm="rms",
    long_context_window=8192,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
