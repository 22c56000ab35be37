"""Serving example: the full train -> export -> block-sparse decode path.

A small federated fleet trains a (reduced) assigned architecture with
per-round block pruning (Algorithm 1 every round), the result is
exported as a pruned bundle — final params plus the per-leaf tile masks
the fleet trained under — and the ``serve`` layer decodes it with a
continuous-batching engine whose matmuls skip the pruned tiles
(``impl="gather"``: weight memory and decode compute scale with the
kept fraction).  A dense decode of the same masked weights verifies the
tokens agree and provides the speedup denominator.

Serving supports the dense (llama-style) decoder family; encoder-decoder
and recurrent-memory architectures train fine but have no block-sparse
serve path yet.

  PYTHONPATH=src python -m repro_torch.examples.serve_pruned
  PYTHONPATH=src python -m repro_torch.examples.serve_pruned --arch smollm-360m \
      --rho 0.75 --batch 16 --steps 64
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.fleet import FleetConfig, FleetTopology, run_fleet
from repro_torch.fleet.task import TransformerTask
from repro_torch.serve import (ServeConfig, ServeEngine, SparseModel,
                               export_from_result, load_pruned)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m",
                    help="assigned architecture (reduced smoke variant)")
    ap.add_argument("--rounds", type=int, default=4,
                    help="federated rounds before export")
    ap.add_argument("--rho", type=float, default=None,
                    help="export pruning rate (default: the fleet's "
                         "final-round mean)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--out", default=None,
                    help="bundle path (default: a temp file)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1) train: a small fleet on the paper's coupled round loop
    task = TransformerTask(arch_name=args.arch, seq_len=16, local_batch=2)
    cfg = FleetConfig(
        topology=FleetTopology(num_cells=2, clients_per_cell=8),
        rounds=args.rounds, seed=args.seed, task=task)
    print(f"training {args.arch} (reduced): 16 clients x "
          f"{args.rounds} rounds ...")
    res = run_fleet(cfg, device=device)
    print(f"  final loss {res.losses[-1]:.4f}, fleet mean rho "
          f"{res.mean_prune[-1]:.3f}")

    # 2) export: final params + the trained tile masks
    path = args.out or os.path.join(tempfile.mkdtemp(), "bundle.npz")
    bundle = export_from_result(path, task, res, rho=args.rho, device=device)
    print(f"exported pruned bundle (rho={bundle.rho:.3f}) -> {path}")

    # 3) serve: block-sparse continuous batching vs the dense baseline
    arch = task.config()
    prompts = np.random.RandomState(args.seed).randint(
        0, arch.vocab_size,
        (args.batch, args.prompt_len)).astype(np.int32)
    page = args.prompt_len + args.steps
    toks, tok_s = {}, {}
    for impl in ("gather", "dense"):
        model = SparseModel(arch, load_pruned(path, task, device=device),
                            impl=impl, device=device)
        eng = ServeEngine(model, ServeConfig(max_slots=args.batch,
                                             page_len=page,
                                             max_new=args.steps))
        eng.generate(prompts)                        # warm-up
        t0 = time.time()
        toks[impl] = eng.generate(prompts)
        dt = time.time() - t0
        tok_s[impl] = args.batch * args.steps / dt
        print(f"  {impl:>6s}: {args.batch} x {args.steps} tokens in "
              f"{dt:.2f}s ({tok_s[impl]:.0f} tok/s)")
    if not np.array_equal(toks["gather"], toks["dense"]):
        raise SystemExit("block-sparse decode diverged from dense")
    print("block-sparse tokens == dense tokens")
    for i in range(min(args.batch, 2)):
        print(f"  seq{i}: {toks['gather'][i][:16].tolist()}...")
    return {"arch": args.arch, "final_loss": float(res.losses[-1]),
            "rho": float(bundle.rho), "path": path,
            "tokens": {k: v.tolist() for k, v in toks.items()},
            "tok_s": tok_s, "tokens_equal": True}


if __name__ == "__main__":
    main()
