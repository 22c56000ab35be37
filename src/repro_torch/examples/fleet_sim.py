"""Fleet-scale wireless pruned-FL simulation CLI.

Runs the fleet engine (multi-cell channels, on-device closed-form
trade-off control, partial participation / stragglers / deadlines, sync
or FedBuff-style async aggregation) and prints a round-by-round and
final summary.

  PYTHONPATH=src python -m repro_torch.examples.fleet_sim
  PYTHONPATH=src python -m repro_torch.examples.fleet_sim --cells 100 \\
      --per-cell 100 --rounds 50 --participation weighted --participants 32
  PYTHONPATH=src python -m repro_torch.examples.fleet_sim --deadline 0.8 \\
      --stragglers 0.1
  PYTHONPATH=src python -m repro_torch.examples.fleet_sim --async \\
      --buffer 256 --max-staleness 20   # buffered aggregation, no barrier
  PYTHONPATH=src torchrun --nproc-per-node 4 -m \\
      repro_torch.examples.fleet_sim --mesh  # cells and clients over ranks
  PYTHONPATH=src python -m repro_torch.examples.fleet_sim --smoke  # CI-sized
  PYTHONPATH=src python -m repro_torch.examples.fleet_sim --task transformer \\
      --smoke --metrics-out metrics.json  # production-model rounds
  PYTHONPATH=src python -m repro_torch.examples.fleet_sim --geometry hex \\
      --reuse 1 --mobility 25     # hex cells, co-channel SINR, mobility
  PYTHONPATH=src python -m repro_torch.examples.fleet_sim --cloud-period 5 \\
      --dirichlet 0.3             # two-tier edge/cloud + non-IID clients
  PYTHONPATH=src python -m repro_torch.examples.fleet_sim --smoke \\
      --telemetry-out telemetry.jsonl --trace-out trace.json
      # per-round telemetry (histograms, drift, solver diagnostics) as
      # JSONL records + host phase spans as Chrome-trace JSON

Every run is on the card unless ``--device cpu`` is given.  ``--mesh``
puts the fleet on a ("cells", "data") mesh over every rank of the default
group (``launch.mesh.make_fleet_mesh``): under ``torchrun`` every rank
runs this module and rank 0 prints and writes the files; without it, a
world of one.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np

from repro_torch.fleet import (AsyncConfig, FleetConfig, FleetTopology,
                               HexInterference, ScheduleConfig, SpanRecorder,
                               TelemetryConfig, make_task, run_fleet,
                               sink_for_path)

# --smoke's sizes: (cells, clients a cell, rounds)
SMOKE_SIZES = {"transformer": (1, 8, 10), "hex": (4, 6, 3), "other": (2, 8, 3)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cells", type=int, default=16)
    ap.add_argument("--per-cell", type=int, default=64)
    ap.add_argument("--geometry", default="orthogonal",
                    choices=["orthogonal", "hex"],
                    help="cell geometry (fleet/topology.py): independent "
                         "annular cells (the paper's setting) or hex-grid "
                         "BSs with frequency reuse, co-channel SINR "
                         "coupling, mobility and handover")
    ap.add_argument("--reuse", type=int, default=1,
                    help="hex: frequency reuse factor (1 = every cell "
                         "co-channel; >= cells = zero interference)")
    ap.add_argument("--mobility", type=float, default=0.0,
                    help="hex: per-round client position jitter std (m)")
    ap.add_argument("--handover-policy", default="serve",
                    choices=["serve", "exclude"],
                    help="hex: handed-over clients keep serving via the "
                         "strongest co-channel BS, or sit the round out")
    ap.add_argument("--cloud-period", type=int, default=0,
                    help="two-tier hierarchical aggregation: per-cell edge "
                         "aggregate every round, backhaul-priced cloud "
                         "merge every N rounds/events (0 = single-tier)")
    ap.add_argument("--dirichlet", type=float, default=None, metavar="ALPHA",
                    help="non-IID clients: Dirichlet(alpha) label skew "
                         "(mlp) / token-pool skew (transformer); smaller "
                         "= more skewed")
    ap.add_argument("--task", default="mlp",
                    choices=["mlp", "transformer", "linreg"],
                    help="FleetTask driving the rounds (fleet/task.py): "
                         "the synthetic MLP (engine default), causal-LM "
                         "transformer rounds, or linear regression")
    ap.add_argument("--rounds", type=int, default=30,
                    help="sync rounds / async server aggregation events")
    ap.add_argument("--weight", type=float, default=0.0004,
                    help="lambda: latency vs learning trade-off")
    ap.add_argument("--participation", default="full",
                    choices=["full", "uniform", "weighted"])
    ap.add_argument("--participants", type=int, default=0,
                    help="clients scheduled per cell per round (0 = all)")
    ap.add_argument("--stragglers", type=float, default=0.0,
                    help="i.i.d. per-round client dropout probability")
    ap.add_argument("--deadline", type=float, default=math.inf,
                    help="hard round deadline in seconds (time-triggered FL)")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="FedBuff-style buffered aggregation (no barrier)")
    ap.add_argument("--buffer", type=int, default=64,
                    help="async: updates merged per server event (0 = all)")
    ap.add_argument("--max-staleness", type=int, default=20,
                    help="async: drop updates older than this many versions")
    ap.add_argument("--staleness-discount", default="polynomial",
                    choices=["none", "polynomial", "exponential"],
                    help="async: merge-weight discount schedule s(tau)")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="async: discount strength alpha")
    ap.add_argument("--cell-chunk", type=int, default=0,
                    help="cells per gradient-accumulation chunk (memory cap)")
    ap.add_argument("--kernel", default=None,
                    choices=["reference", "fused", "fused_xla",
                             "fused_pallas"],
                    help="client-gradient hot path: vmap+AD reference or "
                         "the block-sparse fused kernel "
                         "(kernels/fleet_fused.py).  Default: reference "
                         "for --task mlp, fused otherwise (non-MLP tasks "
                         "exercise per-layer tile grids there)")
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default: per-task)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the cell axis over the host mesh")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: 2 cells x 8 clients, 3 rounds "
                         "(--task transformer: 1 cell x 8, 10 rounds)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the run's trajectories as JSON (CI artifact)")
    ap.add_argument("--telemetry-out", default=None, metavar="PATH",
                    help="enable in-scan telemetry (FleetConfig.telemetry) "
                         "and emit per-round records through the file sink "
                         "(.csv -> CSV, else JSONL; fleet/telemetry.py)")
    ap.add_argument("--telemetry-bins", type=int, default=16,
                    help="histogram bins of the in-scan telemetry")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write build/run/finalize host phase spans as "
                         "Chrome-trace JSON (chrome://tracing / Perfetto)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def fleet_config(args) -> tuple[FleetConfig, str]:
    """The run's ``FleetConfig`` and its kernel, from the parsed flags
    (``--smoke`` already applied)."""
    kernel = args.kernel or ("reference" if args.task == "mlp" else "fused")
    lr = args.lr if args.lr is not None else \
        {"mlp": 1e-2, "transformer": 0.5, "linreg": 0.1}[args.task]
    if args.dirichlet is not None and args.task == "linreg":
        raise SystemExit("--dirichlet applies to --task mlp (label skew) "
                         "and transformer (token-pool skew); linreg has no "
                         "non-IID variant")
    if args.task == "mlp":
        task = None
    else:
        task_kw = {}
        if args.dirichlet is not None and args.task == "transformer":
            task_kw["dirichlet_alpha"] = args.dirichlet
        task = make_task(args.task, **task_kw)
    geometry = None if args.geometry == "orthogonal" else HexInterference(
        reuse=args.reuse, mobility_m=args.mobility)
    cfg = FleetConfig(
        topology=FleetTopology(num_cells=args.cells,
                               clients_per_cell=args.per_cell),
        geometry=geometry,
        schedule=ScheduleConfig(participation=args.participation,
                                participants_per_cell=args.participants,
                                straggler_prob=args.stragglers,
                                round_deadline_s=args.deadline,
                                handover_policy=args.handover_policy),
        async_config=AsyncConfig(buffer_size=args.buffer,
                                 max_staleness=args.max_staleness,
                                 staleness_discount=args.staleness_discount,
                                 staleness_alpha=args.staleness_alpha),
        weight=args.weight, rounds=args.rounds, seed=args.seed, lr=lr,
        cell_chunk=args.cell_chunk, kernel=kernel, task=task,
        cloud_period=args.cloud_period,
        dirichlet_alpha=(args.dirichlet if args.task == "mlp" else None),
        telemetry=(TelemetryConfig(bins=args.telemetry_bins)
                   if args.telemetry_out else None))
    return cfg, kernel


def smoke_checks(res, n: int) -> list[str]:
    """``--smoke``'s two assertions: the loss fell (finite throughout),
    and with telemetry every histogram's mass a round is the fleet.
    Raises ``SystemExit`` on a failure; returns the lines to print."""
    if not (np.all(np.isfinite(res.losses))
            and res.losses[-1] < res.losses[0]):
        raise SystemExit(
            f"smoke run did not learn: losses {res.losses[0]:.4f} -> "
            f"{res.losses[-1]:.4f}")
    if res.telemetry is None:
        return []
    # every telemetry histogram counts every client: per-round mass
    # must equal the fleet size exactly (fleet/telemetry.histogram)
    for name in ("per_hist", "rho_hist", "latency_hist"):
        mass = np.asarray(res.telemetry[name]).sum(axis=(-2, -1))
        if not np.allclose(mass, n):
            raise SystemExit(
                f"telemetry smoke: {name} mass {mass} != {n} clients")
    return [f"telemetry smoke OK: histogram mass == {n} clients/round"]


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if args.smoke:
        # the transformer smoke is the acceptance run: >= 10 rounds,
        # finite decreasing loss on per-layer tile grids; hex gets enough
        # cells for a real co-channel neighborhood
        size = args.task if args.task == "transformer" else \
            "hex" if args.geometry == "hex" else "other"
        args.cells, args.per_cell, args.rounds = SMOKE_SIZES[size]
    cfg, kernel = fleet_config(args)

    mesh, lead = None, True
    if args.mesh:
        import torch.distributed as dist
        from repro_torch.launch import mesh as MESH
        mesh = MESH.make_fleet_mesh(device=args.device)
        lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    mode = "async" if args.async_mode else "sync"
    n = cfg.topology.num_clients
    unit = "events" if mode == "async" else "rounds"
    geo_tag = "orthogonal" if cfg.geometry is None \
        else f"hex(reuse={args.reuse})"
    tier_tag = "single-tier" if args.cloud_period == 0 \
        else f"two-tier(cloud_period={args.cloud_period})"
    say(f"fleet: {args.cells} cells x {args.per_cell} clients = {n} UEs, "
        f"{args.rounds} {unit}, lambda={args.weight}, mode={mode}, "
        f"task={args.task}, kernel={kernel}, geometry={geo_tag}, "
        f"{tier_tag}")
    sink = sink_for_path(args.telemetry_out) \
        if args.telemetry_out and lead else None
    recorder = SpanRecorder() if args.trace_out else None
    t0 = time.time()
    res = run_fleet(cfg, mode=mode, progress=True, mesh=mesh,
                    device=args.device, sink=sink, recorder=recorder)
    wall = time.time() - t0
    if sink is not None:
        sink.close()
        say(f"wrote {args.telemetry_out}")
    if recorder is not None and lead:
        say(f"wrote {recorder.write(args.trace_out)}")

    # write metrics BEFORE the smoke assertion: a failing CI smoke must
    # still ship the trajectory that explains it
    doc = {
        "task": args.task, "kernel": kernel, "mode": mode,
        "clients": n, "rounds": args.rounds, "host_seconds": wall,
        "losses": [float(x) for x in res.losses],
        "accuracy": [float(x) for x in res.accuracy],
        "wall_clock_s": [float(x) for x in res.wall_clock],
        "mean_prune": [float(x) for x in res.mean_prune],
        "bound_final": float(res.bound_final),
    }
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump(doc, f, indent=1)
        say(f"wrote {args.metrics_out}")

    if args.smoke:
        for line in smoke_checks(res, n):
            say(line)

    summary = dict(doc, final_loss=float(res.losses[-1]),
                   final_accuracy=float(res.accuracy[-1]),
                   mean_latency_s=float(np.mean(res.latencies)),
                   mean_rho=float(np.mean(res.mean_prune)),
                   mean_per=float(np.mean(res.mean_per)),
                   mean_participants=float(np.mean(res.participants)),
                   bandwidth_util=float(np.mean(res.bandwidth_util)),
                   simulated_wall_s=float(res.wall_clock[-1]))
    say(f"\n{args.rounds} {unit} in {wall:.1f}s "
        f"({args.rounds / wall:.2f} {unit}/s incl. compile)")
    say(f"final loss {summary['final_loss']:.4f}  "
        f"accuracy {summary['final_accuracy']:.4f}")
    say(f"mean round latency {summary['mean_latency_s']:.3f}s  "
        f"mean rho {summary['mean_rho']:.3f}  "
        f"mean eff. PER {summary['mean_per']:.4f}")
    say(f"mean participants/round {summary['mean_participants']:.1f} / {n}")
    say(f"bandwidth utilization {summary['bandwidth_util']:.3f}")
    say(f"simulated wall-clock {summary['simulated_wall_s']:.1f}s")
    if mode == "async":
        summary["mean_staleness"] = float(np.mean(res.staleness))
        say(f"mean merge staleness {summary['mean_staleness']:.2f} versions")
    say(f"Theorem-1 bound on realized averages: {res.bound_final:.4f}")
    return summary


if __name__ == "__main__":
    main()
