"""Training launcher (the port of ``repro.launch.train``).

Trains a reduced variant (``smoke_variant``) of the selected architecture
on the card (``--device cpu`` for the CPU), with plain data-parallel
steps (``make_host_step``: the optimizer after clipping at 1.0) or the
paper's pruned-FL step over the ranks of the default group (``--fl``,
``federated.trainer``; one rank, or one a client under ``torchrun``,
each on its own card).

``--production`` does not train: it traces the step for the 16x16 (or
2x16x16 with ``--multi-pod``) production mesh on a fake process group
and prints its roofline row, the dry run's path for one combo
(``launch.dryrun``, which starts its own fake group: run it as a
process of its own).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --fl --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --production
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import checkpoint, optimizers
from repro_torch.configs import get_config
from repro_torch.core import aggregation, pruning
from repro_torch.data import tokens
from repro_torch.federated import trainer as FT
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as M

__all__ = ["make_host_step", "main"]


def make_host_step(cfg, opt: optimizers.Optimizer, lr: float):
    """The plain training step: gradients of ``models.model.loss_fn``,
    clipped to global norm 1.0, then ``opt``.  ``step(params, opt_state,
    batch) -> (params, opt_state, metrics)``."""
    def step(p, st, batch):
        (_, metrics), grads = pruning.value_and_grad(
            lambda q: M.loss_fn(cfg, q, batch), p)
        with torch.no_grad():
            grads = optimizers.clip_by_global_norm(grads, 1.0)
            p, st = opt.update(p, grads, st, lr)
        return p, st, metrics
    return step


def _tokens(stream: tokens.TokenStream, batch: int, seq: int, device):
    return {"tokens": torch.as_tensor(stream.sample(batch, seq).astype(
        np.int64), device=device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--optimizer", default="adam",
                    choices=["sgd", "momentum", "adam"])
    ap.add_argument("--fl", action="store_true",
                    help="pruned-FL step (paper technique) instead of "
                         "plain data-parallel")
    ap.add_argument("--rho", type=float, default=0.3,
                    help="pruning rate for --fl")
    ap.add_argument("--production", action="store_true",
                    help="trace the step for the production mesh on a "
                         "fake group, no exec")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.production:
        from repro_torch.launch import dryrun
        return dryrun.main(["--arch", args.arch, "--shape", args.shape]
                           + (["--multi-pod"] if args.multi_pod else [])
                           + (["--fl"] if args.fl else []))

    device = MESH.local_device(args.device)
    cfg = get_config(args.arch).smoke_variant()
    params = pruning.tree_map(
        lambda a: a.to(device),
        M.init_params(cfg, torch.Generator().manual_seed(args.seed)))
    n_params = M.param_count(params)
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={args.arch} (reduced: {n_params/1e6:.2f}M params) "
          f"devices={devices}")

    stream = tokens.TokenStream(cfg.vocab_size, seed=args.seed)

    if args.fl:
        mesh = MESH.make_host_mesh(model=1, device=device)
        n = FT.num_clients(mesh, ("data",))
        step = FT.make_fl_train_step(cfg, mesh, client_axes=("data",),
                                     block=16, lr=args.lr)
        rho = torch.full((n,), args.rho, device=device)
        k_i = torch.full((n,), 40.0, device=device)
        per = torch.full((n,), 0.01)
        draws = torch.Generator().manual_seed(args.seed + 1)
        t0 = time.time()
        for s in range(args.steps):
            arrivals = aggregation.sample_arrivals(
                torch.rand((n,), generator=draws), per).to(device)
            batch = _tokens(stream, n * args.batch, args.seq, device)
            params, metrics = step(params, batch, rho, arrivals, k_i)
            if s % args.log_every == 0 or s == args.steps - 1:
                print(f"step {s:4d} loss={float(metrics['loss']):.4f} "
                      f"rho={float(metrics['achieved_rho'][0]):.3f}")
    else:
        opt = optimizers.REGISTRY[args.optimizer]()
        opt_state = opt.init(params)
        step = make_host_step(cfg, opt, args.lr)
        t0 = time.time()
        for s in range(args.steps):
            batch = _tokens(stream, args.batch, args.seq, device)
            params, opt_state, metrics = step(params, opt_state, batch)
            if s % args.log_every == 0 or s == args.steps - 1:
                print(f"step {s:4d} loss={float(metrics['loss']):.4f}")

    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps/max(dt,1e-9):.2f} steps/s)")
    if args.ckpt:
        checkpoint.save(args.ckpt, params)
        print(f"saved checkpoint to {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
