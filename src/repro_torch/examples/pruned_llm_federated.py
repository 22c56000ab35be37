"""The paper's technique on a transformer: federated pruned training of a
(reduced) assigned architecture through the fleet engine's task protocol.

``TransformerTask`` plugs the causal-LM model into ``run_fleet``, so
every round couples the full stack exactly as a production deployment
would: channel draw -> Algorithm 1 (per-cell closed-form solve) ->
per-client block pruning masks -> masked local grads ->
packet-error-weighted aggregation -> SGD.  The clients train without
remat (``TransformerTask.client_task``).  Compare
``repro_torch.examples.serve_pruned``, which continues this path into
block-sparse serving.

  PYTHONPATH=src python -m repro_torch.examples.pruned_llm_federated --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.examples.pruned_llm_federated \
      --arch olmoe-1b-7b --rounds 20 --dirichlet 0.3
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.fleet import FleetConfig, FleetTopology, run_fleet
from repro_torch.fleet.task import TransformerTask


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m",
                    help="assigned architecture (reduced smoke variant)")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--cells", type=int, default=2)
    ap.add_argument("--clients-per-cell", type=int, default=8)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--batch-per-client", type=int, default=2)
    ap.add_argument("--dirichlet", type=float, default=None,
                    help="non-IID token-pool skew alpha (None = IID)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    task = TransformerTask(arch_name=args.arch, seq_len=args.seq,
                           local_batch=args.batch_per_client,
                           dirichlet_alpha=args.dirichlet)
    n = args.cells * args.clients_per_cell
    cfg = FleetConfig(
        topology=FleetTopology(num_cells=args.cells,
                               clients_per_cell=args.clients_per_cell),
        rounds=args.rounds, seed=args.seed, task=task)
    print(f"arch={args.arch} (reduced), clients={n} "
          f"({args.cells} cells x {args.clients_per_cell})")

    res = run_fleet(cfg, device=args.device)
    rows = []
    for rnd in range(0, args.rounds, max(1, args.rounds // 6)):
        rows.append({"round": rnd, "loss": float(res.losses[rnd]),
                     "rho": float(res.mean_prune[rnd]),
                     "arrived": int(res.participants[rnd]),
                     "deadline_ms": float(np.mean(res.deadlines[rnd]) * 1e3)})
        print(f"round {rnd:3d} loss={res.losses[rnd]:.4f} "
              f"rho={res.mean_prune[rnd]:.3f} "
              f"arrived={int(res.participants[rnd])}/{n} "
              f"deadline={np.mean(res.deadlines[rnd]) * 1e3:.0f}ms")
    print(f"done; final loss {res.losses[-1]:.4f}, "
          f"simulated wall-clock {res.wall_clock[-1]:.1f}s")
    if not np.all(np.isfinite(res.losses)):
        raise SystemExit(f"non-finite losses: {res.losses}")
    return {"arch": args.arch, "clients": n, "rows": rows,
            "losses": [float(x) for x in res.losses],
            "final_loss": float(res.losses[-1]),
            "simulated_wall_s": float(res.wall_clock[-1])}


if __name__ == "__main__":
    main()
