"""Quickstart: one round of the paper's pipeline, end to end.

  1. draw a wireless channel realization for 5 UEs,
  2. solve the communication-learning trade-off (Algorithm 1) for the
     pruning rates rho_i and bandwidth allocation B_i,
  3. run one pruned-FedSGD round with packet-error-aware aggregation,
  4. evaluate the Theorem-1 convergence bound for the realized rates.

Steps 1, 2 and 4 are host float64; step 3 runs on the card (``--device
cpu``: the CPU).  Its initial params and packet uniforms are drawn from
CPU generators seeded 0 and 1, so the card and the CPU start from the
same bits.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import aggregation, pruning, tradeoff, wireless
from repro_torch.core.convergence import ConvergenceBound, SmoothnessParams
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models import mlp

I = 5                                  # UEs (paper Table I)
SAMPLES = np.array([30, 40, 50, 30, 40], np.float64)
LR = 1e-3
BOUND_ROUNDS = 200


def solve_tradeoff():
    """Steps 1-2: the channel of 5 UEs (seed 0) and Algorithm 1's
    solution.  Returns (cfg, bound, h_up, solution)."""
    cfg = wireless.WirelessConfig()        # Table I defaults
    channel = wireless.Channel(I, seed=0)
    h_up, h_down = channel.sample_gains()
    bound = ConvergenceBound(SmoothnessParams(), SAMPLES)
    prob = tradeoff.TradeoffProblem(
        cfg=cfg, bound=bound, h_up=h_up, h_down=h_down,
        tx_power=np.full(I, cfg.tx_power_ue_w), cpu_hz=np.full(I, 5e9),
        num_samples=SAMPLES, max_prune=np.full(I, 0.7))
    return cfg, bound, h_up, tradeoff.solve_alternating(prob)


def initial_params(data: synthetic.SyntheticImageData, device) -> dict:
    """The shallow classifier drawn on the CPU from seed 0, then moved."""
    params = mlp.init_mlp_classifier(torch.Generator().manual_seed(0),
                                     data.dim, mlp.SHALLOW_HIDDEN,
                                     data.num_classes)
    return pruning.tree_map(lambda a: a.to(device), params)


def packet_uniforms(device) -> torch.Tensor:
    """The round's packet uniforms, drawn on the CPU from seed 1."""
    return torch.rand((I,), generator=torch.Generator().manual_seed(1)
                      ).to(device)


def fl_round(params: dict, data: synthetic.SyntheticImageData, parts,
             prune, per, u: torch.Tensor):
    """Step 3 on ``params``' device: each UE's magnitude-pruned gradient
    (pruned coordinates upload 0), the arrivals C_i = [u_i >= q_i], the
    Eq.-(5) aggregate and an SGD step.  Returns (new params, aggregated
    gradient, arrivals, local losses)."""
    device = pruning.flatten(params)[0].device
    grads, losses = [], []
    for i, idx in enumerate(parts):
        masks = pruning.magnitude_masks(params, float(prune[i]))
        pruned = pruning.apply_masks(params, masks)
        x = torch.as_tensor(data.x_train[idx], device=device)
        y = torch.as_tensor(data.y_train[idx].astype(np.int64),
                            device=device)
        (loss, _), g = pruning.value_and_grad(
            lambda p: (mlp.classifier_loss(p, x, y), None), pruned)
        losses.append(float(loss))
        grads.append(pruning.apply_masks(g, masks))

    stacked = pruning.tree_map(lambda *xs: torch.stack(xs), *grads)
    arrivals = aggregation.sample_arrivals(
        u, torch.as_tensor(per, dtype=torch.float32, device=device))
    g_global = aggregation.aggregate(
        stacked, torch.as_tensor(SAMPLES, dtype=torch.float32, device=device),
        arrivals)
    params = pruning.tree_map(lambda p, g: p - LR * g, params, g_global)
    return params, g_global, arrivals, losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device of the FedSGD round (default: the "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. wireless channel ------------------------------------------------
    # --- 2. trade-off optimization (Algorithm 1) ----------------------------
    cfg, bound, h_up, sol = solve_tradeoff()
    print("uplink gains:", np.array2string(h_up, precision=2))
    print(f"\nAlgorithm 1 converged in {sol.iterations} iterations")
    print("pruning rates rho*:", np.round(sol.prune, 3))
    print("bandwidth B* (MHz):", np.round(sol.bandwidth / 1e6, 3),
          f"(sum {sol.bandwidth.sum()/1e6:.2f} <= {cfg.bandwidth_hz/1e6:.0f})")
    print("packet error rates:", np.round(sol.per, 4))
    print(f"round deadline t~*: {sol.deadline*1e3:.1f} ms   "
          f"total cost: {sol.total_cost:.4f}")

    # --- 3. one pruned-FedSGD round -----------------------------------------
    data = synthetic.make_dataset(seed=0)
    parts = synthetic.partition_iid([int(k) for k in SAMPLES], data, seed=0)
    params = initial_params(data, device)
    params, _, arrivals, losses = fl_round(params, data, parts, sol.prune,
                                           sol.per, packet_uniforms(device))
    print("\npacket arrivals C_i:", arrivals.cpu().numpy().astype(int))
    print("mean local loss:", float(np.mean(losses)))

    # --- 4. Theorem-1 bound for the realized round --------------------------
    terms = {"bound": bound.bound(BOUND_ROUNDS, sol.per, sol.prune),
             "initial_term": bound.initial_term(BOUND_ROUNDS),
             "packet_error_term": bound.packet_error_term(sol.per),
             "pruning_term": bound.pruning_term(sol.prune)}
    print(f"\nTheorem 1 bound after S={BOUND_ROUNDS} rounds at these rates: "
          f"{terms['bound']:.3f}")
    print(f"  initial term : {terms['initial_term']:.4f}")
    print(f"  packet error : {terms['packet_error_term']:.4f}")
    print(f"  pruning      : {terms['pruning_term']:.4f}")
    return {"h_up": h_up.tolist(), "iterations": int(sol.iterations),
            "prune": sol.prune.tolist(), "bandwidth": sol.bandwidth.tolist(),
            "per": sol.per.tolist(), "deadline": float(sol.deadline),
            "total_cost": float(sol.total_cost),
            "arrivals": arrivals.cpu().numpy().astype(int).tolist(),
            "mean_loss": float(np.mean(losses)),
            **{k: float(v) for k, v in terms.items()}}


if __name__ == "__main__":
    main()
