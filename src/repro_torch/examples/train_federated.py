"""End-to-end driver: the paper's full §V experiment — pruned wireless FL
with the proposed optimizer vs benchmarks, several hundred rounds.

  PYTHONPATH=src python -m repro_torch.examples.train_federated                # shallow net
  PYTHONPATH=src python -m repro_torch.examples.train_federated --dnn          # Fig. 6 model
  PYTHONPATH=src python -m repro_torch.examples.train_federated --scheme gba
  PYTHONPATH=src python -m repro_torch.examples.train_federated --rounds 400 --non-iid 0.5
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.federated import system
from repro_torch.models import mlp


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scheme", default="proposed",
                    choices=["proposed", "gba", "exhaustive", "ideal",
                             "fpr:0.0", "fpr:0.35", "fpr:0.7"])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--dnn", action="store_true",
                    help="60+20 hidden DNN (Fig. 6) instead of shallow net")
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--lambda", dest="weight", type=float, default=0.0004)
    ap.add_argument("--non-iid", type=float, default=None,
                    help="Dirichlet alpha for non-IID client data")
    ap.add_argument("--structured", action="store_true",
                    help="TPU block pruning instead of unstructured")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None, help="save final params here")
    ap.add_argument("--device", default=None,
                    help="torch device of the rounds (default: the card)")
    args = ap.parse_args(argv)

    cfg = system.FLConfig(
        rounds=args.rounds, scheme=args.scheme, lr=args.lr,
        hidden=mlp.DNN_HIDDEN if args.dnn else mlp.SHALLOW_HIDDEN,
        weight=args.weight, seed=args.seed,
        non_iid_alpha=args.non_iid, structured=args.structured,
        eval_every=max(args.rounds // 20, 1))
    res = system.run(cfg, progress=True, device=args.device)

    out = {"scheme": args.scheme, "rounds": args.rounds,
           "accuracy": float(res.accuracy[-1][1]),
           "loss": float(res.losses[-1]),
           "latency_ms": float(np.mean(res.latencies) * 1e3),
           "mean_rho": float(res.prune_rates.mean()),
           "mean_per": float(res.per_rates.mean()),
           "bound": float(res.bound_final)}
    print(f"\nscheme={args.scheme} rounds={args.rounds}")
    print(f"final accuracy : {out['accuracy']:.4f}")
    print(f"final loss     : {out['loss']:.4f}")
    print(f"mean latency   : {out['latency_ms']:.1f} ms/round")
    print(f"mean rho       : {out['mean_rho']:.3f}")
    print(f"mean PER       : {out['mean_per']:.4f}")
    print(f"Theorem-1 bound: {out['bound']:.3f}")

    if args.ckpt:
        from repro_torch import checkpoint
        checkpoint.save(args.ckpt, res.params)
        print(f"saved params to {args.ckpt}")
        out["ckpt"] = args.ckpt
    return out


if __name__ == "__main__":
    main()
