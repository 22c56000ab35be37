#!/usr/bin/env python3
"""The two training paths of a ``TransformerTask`` on one NVIDIA card, for
one tree, so that two trees can be compared in one call.

    python3 scripts/remat_paths.py [--src DIR]

``DIR`` (default: this repository's ``src``) holds the ``repro_torch``
package to run; an earlier commit's tree unpacked under ``_archive/``
gives its ``src``.  After the card's name and power limit the script
prints, each with the ``remat`` its model trained at:

  fleet — chip_smoke's phase 15b: smollm-135m at full width in float32
          trained by the fleet engine, 4 x 8 clients of 2 x 16 tokens,
          ``kernel="fused"`` (the generic gradient path), 3 rounds: each
          round's wall (control and apply, synchronised), the losses and
          the peak device memory;
  FL    — phase 18c's FL step (``make_fl_train_step``) on a world of one
          rank: smollm-135m at full width in bfloat16 from seed 7, block
          16, rho 0.3, k 40, (8, 128) tokens, 5 steps: each step's wall,
          the losses and the peak device memory.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fleet(card: str) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fleet import FleetConfig, FleetTopology, build_simulation
    from repro_torch.fleet.task import TransformerTask
    task = TransformerTask(
        arch=get_config("smollm-135m").replace(param_dtype="float32",
                                               compute_dtype="float32"),
        seq_len=16, local_batch=2, pool_clients=32)
    cfg = FleetConfig(task=task, topology=FleetTopology(4, 8),
                      kernel="fused", rounds=3)
    torch.cuda.reset_peak_memory_stats()
    sim = build_simulation(cfg)
    carry = sim.init_carry(sim.params)
    torch.cuda.synchronize()
    walls, losses = [], []
    for r in range(cfg.rounds):
        t0 = time.perf_counter()
        ctl = sim.control(r)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        carry, m = sim.apply(carry, ctl)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        walls.append(f"{(t2 - t0) * 1e3:.2f} ({(t1 - t0) * 1e3:.2f} + "
                     f"{(t2 - t1) * 1e3:.2f})")
        losses.append(float(m["loss"]))
    print(f"fleet: clients' remat {sim.task.config().remat!r}; round walls "
          f"ms (control + apply) {walls}; losses {losses}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]",
          flush=True)


def fl_step(card: str) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import pruning
    from repro_torch.data.tokens import TokenStream
    from repro_torch.federated import trainer as FT
    from repro_torch.fleet.task import TransformerTask
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    cfg = get_config("smollm-135m")
    mesh = MESH.make_host_mesh(model=1, device=dev)
    step = FT.make_fl_train_step(cfg, mesh, ("data",), block=16, lr=1e-2)
    params = pruning.tree_map(lambda a: a.to(dev), M.init_params(
        cfg, torch.Generator().manual_seed(7)))
    stream = TokenStream(cfg.vocab_size, seed=7)
    vec = lambda x: torch.full((1,), x, dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for _ in range(5):
        batch = {"tokens": torch.as_tensor(stream.sample(8, 128),
                                           dtype=torch.int64, device=dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, m = step(params, batch, vec(0.3), vec(1.0), vec(40.0))
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 2))
        losses.append(float(m["loss"]))
    print(f"FL: remat {TransformerTask(arch=cfg).config().remat!r}; step "
          f"walls ms {walls}; losses {losses}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("remat_paths: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card} | src {args.src}", flush=True)
    fleet(card)
    fl_step(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
