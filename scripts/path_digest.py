#!/usr/bin/env python3
"""What two trees' main paths give, to compare them bit for bit on one
NVIDIA card.

    python3 scripts/path_digest.py [--src DIR]

``DIR`` (default: this repository's ``src``) holds the ``repro_torch``
package to run; an earlier commit's tree unpacked under ``_archive/``
gives its ``src``.  The script prints, on one line each: chip_smoke's
phase 4 (5 synchronous rounds, 100 x 100 clients, the 784-60-20-10 DNN,
``kernel="fused"``, seed 0), phase 7's cohort (10 of 100 a cell,
uniform, ``control_chunk`` 25) and phase 8's async events (buffer
2,500, max_staleness 20, 10 events) as their losses' float32 values in
hex and the final params' sha256, and phase 6's serving tokens (smollm-135m at full width from seed 2026,
bfloat16, pruned at rho = 0.5, 64 prompts of 32 tokens from
``RandomState(2026)``, 32 new tokens each on 32 slots of 128) as their
count and sha256.  Two trees agree bit for bit where both lines do.
The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("path_digest: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.fleet import (AsyncConfig, FleetConfig, FleetTopology,
                                   ScheduleConfig, SyntheticMLPTask,
                                   build_simulation)
    from repro_torch.fleet.task import TransformerTask
    from repro_torch.serve import (ServeConfig, ServeEngine, SparseModel,
                                   make_bundle)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card} | src {args.src}")
    cfg = FleetConfig(task=SyntheticMLPTask(
        feature_dim=784, hidden=(60, 20), num_classes=10, local_batch=8,
        prune_block=8), topology=FleetTopology(100, 100), kernel="fused",
        rounds=5)
    paths = (
        ("phase 4", "sync", cfg),
        ("phase 7", "sync", dataclasses.replace(
            cfg, control_chunk=25, schedule=ScheduleConfig(
                participation="uniform", participants_per_cell=10))),
        ("phase 8", "async", dataclasses.replace(
            cfg, rounds=10, async_config=AsyncConfig(
                buffer_size=2500, max_staleness=20))))
    for name, mode, path_cfg in paths:
        sim = build_simulation(path_cfg, mode)
        result = sim.finalize(*sim.simulate(sim.params))
        digest = hashlib.sha256()
        for layer, leaves in sorted(result.params.items()):
            for leaf, v in sorted(leaves.items()):
                digest.update(np.ascontiguousarray(v).tobytes())
        print(f"{name} losses "
              + " ".join(float(v).hex() for v in
                         result.losses.astype(np.float32))
              + f" params sha256 {digest.hexdigest()}")

    arch = get_config("smollm-135m")
    task = TransformerTask(arch=arch)
    params = task.init_params(torch.Generator(device="cuda").manual_seed(2026))
    model = SparseModel(arch, make_bundle(task, params, 0.5))
    prompts = np.random.RandomState(2026).randint(
        0, arch.vocab_size, (64, 32)).astype(np.int32)
    tokens = ServeEngine(model, ServeConfig(max_slots=32, page_len=128,
                                            max_new=32)).generate(prompts)
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    print(f"phase 6 tokens {tokens.size} sha256 "
          f"{hashlib.sha256(tokens.tobytes()).hexdigest()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
