"""Roofline terms of a traced step (the port of ``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds, at one NVIDIA H100
SXM's data-sheet peaks (dense, at 700 W):

  compute    = flops_per_chip / PEAK_FLOPS            (989 TFLOP/s bf16)
  memory     = bytes_per_chip / HBM_BW                (3.35 TB/s)
  collective = collective_bytes_per_chip / LINK_BW    (450 GB/s NVLink,
                                                       each way)

The per-chip counts come from ``launch.cost`` over the step the dry run
traces (``launch.dryrun``), rank 0's local ops.  A 16-wide mesh dim
spans two hosts of eight cards, whose links between hosts are slower
than NVLink, so the collective term is a floor.  The compute term takes
the bfloat16 tensor-core peak for every product; the kernel bounds in
``PERF.md`` use 67 TFLOP/s (float32, no tensor cores) and the same
3.35 TB/s.

``collective_stats`` (the reference parses collectives out of HLO text)
has no counterpart here: ``launch.cost`` counts the collectives the
traced step issues.  ``raw_xla_flops`` / ``raw_xla_bytes`` (XLA's own
``cost_analysis``, which counts a loop body once) have no counterpart
either: they stay 0.0 and are kept so that a report the port saves
loads where a reference report does.
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.launch.shardings import tree_map_with_path
from repro_torch.core.pruning import flatten

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "RooflineReport",
           "attention_flops", "model_flops", "active_param_count",
           "save_report", "load_report"]

# --- NVIDIA H100 SXM constants (per card; data sheet, dense) ---------------
PEAK_FLOPS = 989e12          # bf16 tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, NVLink each way


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str                     # "16x16" | "2x16x16"
    chips: int
    flops_per_chip: float         # launch.cost over rank 0's local ops
    bytes_per_chip: float         # operand + result bytes a local op
    collective_bytes_per_chip: float   # link bytes (ring-algorithm model)
    peak_memory_per_chip: float   # live local bytes, arguments included
    argument_bytes: float
    output_bytes: float
    temp_bytes: float
    collectives: dict             # kind -> {count, bytes}
    model_flops: float            # 6ND (train) / 2ND (prefill/decode), global
    wall_s: float                 # trace wall time
    raw_xla_flops: float = 0.0    # no counterpart (XLA's cost_analysis)
    raw_xla_bytes: float = 0.0

    # -- derived ------------------------------------------------------------

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (traced flops x chips): the share of the step's
        compute that is model math (catches recomputation and
        redundancy, such as replicated attention)."""
        traced = self.flops_per_chip * self.chips
        return self.model_flops / traced if traced else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d

    def row(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:8s} "
                f"cmp={self.t_compute*1e3:9.3f}ms "
                f"mem={self.t_memory*1e3:9.3f}ms "
                f"col={self.t_collective*1e3:9.3f}ms "
                f"[{self.bottleneck:10s}] "
                f"useful={self.useful_flops_ratio:6.1%} "
                f"hbm={self.peak_memory_per_chip/2**30:7.2f}GiB")


def attention_flops(cfg, shape) -> float:
    """Analytic attention score+value FLOPs (the quadratic term that 6ND
    misses — dominant at 32k+ context).  Causal halving applied; sliding
    windows cap the key range; recurrent mixers count ~0 here (their
    state update is linear and covered by the param term)."""
    b, s = shape.global_batch, shape.seq_len
    h, hd = cfg.num_heads, cfg.head_dim_
    total = 0.0
    for stage in cfg.stages:
        for spec in stage.blocks:
            if spec.kind in ("attn", "local_attn", "mla"):
                window = None
                if spec.kind == "local_attn":
                    window = cfg.local_window
                if shape.name == "long_500k" and cfg.long_context_window:
                    window = min(window or 10**18, cfg.long_context_window)
                if spec.kind == "mla" and cfg.mla is not None:
                    qd = cfg.mla.nope_dim + cfg.mla.rope_dim
                    vd = cfg.mla.v_head_dim
                else:
                    qd = vd = hd
                keys = min(s, window) if window else s
                if shape.mode == "decode":
                    total += stage.repeats * 2.0 * b * h * (qd + vd) * keys
                else:
                    # causal: query i sees ~min(i, keys) keys; average s/2
                    # for full attention, ~keys for windowed
                    avg = keys / 2.0 if window is None else keys
                    total += stage.repeats * 2.0 * b * h * (qd + vd) * s * avg
            elif spec.kind == "cross_attn":
                mem = cfg.num_memory_tokens
                if shape.mode == "decode":
                    total += stage.repeats * 2.0 * b * h * 2 * hd * mem
                else:
                    total += stage.repeats * 2.0 * b * h * 2 * hd * s * mem
    return total


def model_flops(cfg, shape, active_params: int) -> float:
    """Global useful model FLOPs for one step.

    train: 6*N*D + 3*attn (fwd 2ND + bwd 4ND), D = batch*seq tokens
    prefill: 2*N*D + attn
    decode: 2*N*batch + attn (one token per sequence, full KV range)
    """
    attn = attention_flops(cfg, shape)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active_params * tokens + 3.0 * attn
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active_params * tokens + attn
    return 2.0 * active_params * shape.global_batch + attn


def active_param_count(cfg, params_shape) -> int:
    """Parameter count with MoE experts scaled to the activated top-k;
    ``params_shape`` a params tree of tensors or ``meta`` tensors
    (``models.model.init_params(cfg, None)``).

    Expert-stacked leaves are identified by shape: an ffn leaf whose
    leading (post-layer-stack) dims hold num_experts."""
    e = cfg.moe.num_experts if cfg.moe is not None else -1

    def count(path: str, leaf) -> int:
        n = leaf.numel()
        if cfg.moe is not None and "ffn" in path and "router" not in path \
                and e in tuple(leaf.shape)[:-1]:
            n = n * cfg.moe.top_k // e
        return n

    return sum(flatten(tree_map_with_path(count, params_shape)))


def save_report(report: RooflineReport, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report.as_dict(), f, indent=1)


def load_report(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
