"""Trade-off playground: sweep one wireless parameter and watch Algorithm 1
re-balance pruning vs bandwidth vs packet error (paper Figs. 2-4 in one
script).

  PYTHONPATH=src python -m repro_torch.examples.tradeoff_playground --sweep power
  PYTHONPATH=src python -m repro_torch.examples.tradeoff_playground --sweep modelsize
  PYTHONPATH=src python -m repro_torch.examples.tradeoff_playground --sweep lambda
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import tradeoff, wireless
from repro_torch.core.convergence import ConvergenceBound, SmoothnessParams
from repro_torch.device import resolve_device

I = 5
SAMPLES = np.array([30, 40, 50, 30, 40], np.float64)


def solve(cfg: wireless.WirelessConfig, lam: float, seed: int = 0):
    ch = wireless.Channel(I, seed=seed)
    h_up, h_down = ch.sample_gains()
    bound = ConvergenceBound(SmoothnessParams(), SAMPLES)
    prob = tradeoff.TradeoffProblem(
        cfg=cfg, bound=bound, h_up=h_up, h_down=h_down,
        tx_power=np.full(I, cfg.tx_power_ue_w), cpu_hz=np.full(I, 5e9),
        num_samples=SAMPLES, max_prune=np.full(I, 0.7), weight=lam)
    sol = tradeoff.solve_alternating(prob)
    return sol, prob


def sweep(name: str):
    """(the swept values, x -> (WirelessConfig, lambda)) of one sweep."""
    if name == "power":
        return [13, 18, 23, 28, 33], lambda x: (wireless.WirelessConfig(
            tx_power_ue_w=wireless.dbm_to_watt(x)), 0.0004)
    if name == "modelsize":
        return [0.4, 0.8, 1.6, 3.2, 6.4], lambda x: (
            wireless.WirelessConfig(model_bits=x * 1e6), 0.0004)
    return [1e-5, 1e-4, 4e-4, 1e-3, 4e-3, 1e-2], \
        lambda x: (wireless.WirelessConfig(), x)


def row(cfg: wireless.WirelessConfig, lam: float, seeds: int) -> dict:
    """One table row: the means over ``seeds`` channel draws."""
    cost, lat, rho, per, bw = [], [], [], [], []
    for s in range(seeds):
        sol, _ = solve(cfg, lam, seed=s)
        cost.append(sol.total_cost)
        lat.append(sol.deadline)
        rho.append(sol.prune.mean())
        per.append(sol.per.mean())
        bw.append(sol.bandwidth.sum())
    return {"cost": float(np.mean(cost)),
            "latency_ms": float(np.mean(lat) * 1e3),
            "mean_rho": float(np.mean(rho)), "mean_per": float(np.mean(per)),
            "sum_b_mhz": float(np.mean(bw) / 1e6)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sweep", default="power",
                    choices=["power", "modelsize", "lambda"])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card); Algorithm 1 "
                         "runs on the host in float64 on either")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    print(f"{'x':>10s} {'cost':>9s} {'latency_ms':>11s} {'mean_rho':>9s} "
          f"{'mean_PER':>9s} {'sumB_MHz':>9s}")
    xs, make = sweep(args.sweep)
    rows = []
    for x in xs:
        r = dict(x=x, **row(*make(x), args.seeds))
        rows.append(r)
        print(f"{x:>10g} {r['cost']:>9.4f} {r['latency_ms']:>11.1f} "
              f"{r['mean_rho']:>9.3f} {r['mean_per']:>9.4f} "
              f"{r['sum_b_mhz']:>9.2f}")
    return {"sweep": args.sweep, "seeds": args.seeds, "rows": rows}


if __name__ == "__main__":
    main()
