#!/usr/bin/env python3
"""Where a fleet round's time goes on one NVIDIA card, path by path.

    python3 scripts/fleet_paths.py [--steps 4] [--paths full,cohort,...]

At chip_smoke's slice (10,000 clients in 100 x 100 cells, the
784-60-20-10 DNN, batch 8, block 8) the script builds each path, runs one
round or event to warm it, then ``--steps`` more, timing each on the
host clock as control (channel, schedule, Algorithm 1, draws) and apply
(ranking, gradients, merge, eval), each half ending in a synchronize.
One more step runs under torch.profiler: device busy time, device ops,
the fused kernel's and the tile norms' share, and the top device ops.
Paths (``--paths``, any of):

* ``full``: the sync round with ``kernel="fused"`` (chip_smoke phase 4);
* ``cohort``: 10 of 100 clients a cell, uniform, the cohort gather;
* ``cohort_chunk25``: the same with ``control_chunk=25`` (phase 7);
* ``async``: FedBuff events, buffer 2,500, max_staleness 20 (phase 8);
* ``reference``: ``kernel="reference"``, magnitude masks, 1,000-client
  chunks (phase 9);
* ``hex``: hex cells, reuse 3, 6 neighbours, 25 m mobility, handover
  (phase 10);
* ``two_tier`` / ``two_tier_async``: ``cloud_period=2`` on the sync round
  and on the async event (phase 11);
* ``stream``: 100,000 clients (100 x 1,000), streamed client data,
  ``cell_chunk=10`` (phase 12a);
* ``dirichlet``: Dirichlet(0.3) labels (phase 12b).

Every line names the card and its power limit.  It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PATHS = ("full", "cohort", "cohort_chunk25", "async", "reference", "hex",
         "two_tier", "two_tier_async", "stream", "dirichlet")


def config(path: str):
    import chip_smoke as CS
    from repro_torch.fleet import (AsyncConfig, HexInterference,
                                   ScheduleConfig, SyntheticMLPTask)
    cfg = CS.slice_config()
    cohort = ScheduleConfig(participation="uniform",
                            participants_per_cell=CS.COHORT_M)
    async_cfg = AsyncConfig(buffer_size=CS.ASYNC_BUFFER,
                            max_staleness=CS.ASYNC_STALENESS)
    if path == "stream":
        cfg = CS.slice_config(cells=CS.STREAM_CELLS,
                              per_cell=CS.STREAM_PER_CELL)
    change = {
        "full": {},
        "cohort": dict(schedule=cohort),
        "cohort_chunk25": dict(schedule=cohort,
                               control_chunk=CS.COHORT_CHUNK),
        "async": dict(async_config=async_cfg),
        "reference": dict(kernel="reference", mask_kind="magnitude",
                          cell_chunk=CS.REF_CELL_CHUNK),
        "hex": dict(geometry=HexInterference(reuse=3, max_neighbors=6,
                                             mobility_m=25.0)),
        "two_tier": dict(cloud_period=CS.TIER_PERIOD),
        "two_tier_async": dict(cloud_period=CS.TIER_PERIOD,
                               async_config=async_cfg),
        "stream": dict(cell_chunk=CS.STREAM_CHUNK),
        "dirichlet": dict(task=SyntheticMLPTask(
            **CS.DNN, dirichlet_alpha=CS.DIRICHLET_ALPHA)),
    }[path]
    return dataclasses.replace(cfg, **change), \
        "async" if "async" in path else "sync"


def profile_step(sim, carry, r: int):
    """One step under torch.profiler: (busy ms, device ops, fused kernel
    ms, tile norms ms, top ops)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as CS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.step(carry, r)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.key not in CS.ANNOTATIONS]
    ms = lambda es: sum(e.self_device_time_total for e in es) / 1e3
    fused = ms([e for e in ops if any(k in e.key for k in CS.FUSED_KERNELS)])
    norms = ms([e for e in ops if "tile_norms_kernel" in e.key])
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:5]
    return ms(ops), sum(e.count for e in ops), fused, norms, top


def run(path: str, steps: int, card: str) -> None:
    import torch
    import chip_smoke as CS
    from repro_torch.fleet import build_simulation
    cfg, mode = config(path)
    cfg = dataclasses.replace(cfg, rounds=steps + 1)
    sim = build_simulation(cfg, mode)
    carry = sim.init_carry(sim.params)
    controls, applies = [], []
    for r in range(steps + 1):
        t0 = time.perf_counter()
        ctl = sim.control(r)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        carry, _ = sim.apply(carry, ctl)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if r:  # the first step warms
            controls.append((t1 - t0) * 1e3)
            applies.append((t2 - t1) * 1e3)
    busy, n_ops, fused, norms, top = profile_step(sim, carry, steps + 1)
    med = statistics.median
    CS.log(f"{path:15s} control {med(controls):7.2f} ms (min "
           f"{min(controls):.2f}), apply {med(applies):7.2f} ms (min "
           f"{min(applies):.2f}) over {steps} warm {mode} steps; profiled "
           f"step: busy {busy:.3f} ms over {n_ops} device ops, fused kernel "
           f"{fused:.3f} ms, tile norms {norms:.4f} ms [{card}]")
    for e in top:
        CS.log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d}"
               f" {e.key[:80]}")


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fleet_paths: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    card = CS.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    CS.log(card)
    from repro_torch.kernels import build
    build.build()
    CS.warm_profiler()
    for path in args.paths.split(","):
        if path not in PATHS:
            raise SystemExit(f"unknown path {path!r}; choose from {PATHS}")
        run(path, args.steps, card)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
