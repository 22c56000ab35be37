#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero and prints no result line):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every CUDA kernel from src/repro_torch/kernels/csrc;
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the main path's shapes, with errors and warm CUDA-event times;
  4. main    — 5 synchronous fleet rounds: 10,000 clients (100 x 100 cells),
               the paper's 784-60-20-10 DNN, kernel="fused"; per-round
               metrics and wall time, launch counts (each > 0), and a second
               run that must give bitwise-identical losses;
  5. card vs CPU — a small fleet from the same numpy draws on the CPU (plain
               versions) and on the card (kernels), compared at 1e-4.
The line before the last is the kernels JSON; the last is the device JSON.
Peak rates for bounds: H100 SXM at 700 W, 67 TFLOP/s float32 without tensor
cores and 3.35 TB/s (the card's own limit is printed beside them).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
BLOCK = 8
SLICE_CELLS, SLICE_PER_CELL, SLICE_ROUNDS = 100, 100, 5
DNN = dict(feature_dim=784, hidden=(60, 20), num_classes=10, local_batch=8,
           prune_block=BLOCK)
TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``iters`` warm
    calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    diff = float((a - b).abs().max())
    return diff, diff / max(float(b.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# Phase 3: the kernels against their plain versions
# ---------------------------------------------------------------------------

def check_tile_norms(params, card: str) -> dict:
    import torch
    from repro_torch.kernels import block_norms as BN
    ws = [params[f"layer{i}"]["w"] for i in range(len(params))]
    worst = 0.0
    for w in ws:
        got = BN.tile_norms(w, BLOCK, BLOCK)
        ref = BN.tile_norms_plain(w, BLOCK, BLOCK)
        torch.cuda.synchronize()
        diff, rel = rel_err(got, ref)
        worst = max(worst, diff)
        log(f"  tile_norms {tuple(w.shape)}: max_abs_err={diff:.3e} "
            f"rel={rel:.3e} (tol {TOL})")
        if rel > TOL:
            raise AssertionError(f"tile_norms disagrees at {tuple(w.shape)}")
    # one round's worth: the three layers
    ms = cuda_ms(lambda: [BN.tile_norms(w, BLOCK, BLOCK) for w in ws], 50)
    plain_ms = cuda_ms(lambda: [BN.tile_norms_plain(w, BLOCK, BLOCK)
                                for w in ws], 50)
    n_in = sum(w.numel() for w in ws)
    n_out = sum(-(-w.shape[0] // BLOCK) * -(-w.shape[1] // BLOCK) for w in ws)
    t_bytes = (n_in + n_out) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_in / F32_FLOPS * 1e3
    log(f"  tile_norms x3 layers: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
        f"bound {max(t_bytes, t_ops):.6f} ms [{card}]")
    return dict(name="tile_norms", route="cuda",
                source="src/repro_torch/kernels/csrc/block_norms.cu",
                replaces="src/repro/kernels/block_norms.py:24",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def fused_bound_ms(params, x, keeps) -> tuple[float, str]:
    """Least time for the fused call on these inputs: kept-tile MACs of the
    forward, dW and (layers > 0) dA products at the float32 peak, against
    each input read once and each output written once at the HBM rate."""
    import torch
    c, batch, _ = x.shape
    macs = 0.0
    nbytes = x.numel() * 4 + c * batch * 8 + c * 4 * 2   # x, y, weights, losses
    for l, k in enumerate(keeps):
        kdim, ndim = params[f"layer{l}"]["w"].shape
        ks = torch.tensor([min(BLOCK, kdim - s) for s in range(0, kdim, BLOCK)],
                          device=k.device, dtype=torch.float64)
        ns = torch.tensor([min(BLOCK, ndim - s) for s in range(0, ndim, BLOCK)],
                          device=k.device, dtype=torch.float64)
        kept = float(torch.einsum("ctn,t,n->", k.double(), ks, ns))
        macs += kept * batch * (3 if l > 0 else 2)
        nbytes += k.numel() * 4 + 2 * (kdim * ndim + ndim) * 4
    t_ops = 2 * macs / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_fused(params, data, card: str) -> dict:
    import torch
    from repro_torch.kernels import fleet_fused as FF
    dev = data["x"].device
    c = data["x"].shape[0]
    g = torch.Generator(device=dev).manual_seed(1234)
    states = FF.layer_norm_states(params, BLOCK)
    w_mixed = torch.rand((c,), generator=g, device=dev) * 48 + 16
    rho_mixed = torch.rand((c,), generator=g, device=dev) * 0.7

    def case(name, rho, weights, n=c, kill=None):
        keeps = FF.layer_keeps(states, rho[:n])
        if kill is not None:
            for k in keeps:
                k[kill] = 0.0
        return name, (params, data["x"][:n], data["y"][:n], keeps,
                      weights[:n].contiguous(), BLOCK)

    w_zero = w_mixed.clone()
    w_zero[7] = 0.0
    cases = [case("rho=0", torch.zeros_like(rho_mixed), w_mixed),
             case("rho~U[0,0.7]", rho_mixed, w_mixed),
             case("one client prunes all", rho_mixed, w_mixed, kill=3),
             case("zero-weight client", rho_mixed, w_zero),
             case("C=1001 (not a tile multiple)", rho_mixed, w_mixed, n=1001)]
    worst = 0.0
    for name, args in cases:
        grads, losses = FF.fused_fleet_grads(*args)
        ref_g, ref_l = FF.fused_grads_plain(*args)
        torch.cuda.synchronize()
        errs = [rel_err(losses, ref_l)]
        errs += [rel_err(grads[k][leaf], ref_g[k][leaf])
                 for k in ref_g for leaf in ("w", "b")]
        diff = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        worst = max(worst, diff)
        log(f"  fused_fleet_grads [{name}]: max_abs_err={diff:.3e} "
            f"rel={rel:.3e} (tol {TOL})")
        if rel > TOL or not torch.isfinite(losses).all():
            raise AssertionError(f"fused kernel disagrees: {name}")
    args = cases[1][1]
    ms = cuda_ms(lambda: FF.fused_fleet_grads(*args), 10)
    plain_ms = cuda_ms(lambda: FF.fused_grads_plain(*args), 3, warmup=1)
    bound, bound_by = fused_bound_ms(params, args[1], args[3])
    log(f"  fused_fleet_grads (C={c}, rho~U[0,0.7]): {ms:.3f} ms kernel, "
        f"{plain_ms:.3f} ms plain, bound {bound:.4f} ms ({bound_by}) [{card}]")
    return dict(name="fleet_fused_grads", route="cuda",
                source="src/repro_torch/kernels/csrc/fleet_fused.cu",
                replaces="src/repro/kernels/fleet_fused.py:331",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=None)


# ---------------------------------------------------------------------------
# Phase 4: the main path; phase 5: card against CPU
# ---------------------------------------------------------------------------

def slice_config(rounds=SLICE_ROUNDS, cells=SLICE_CELLS, per_cell=SLICE_PER_CELL):
    from repro_torch.fleet import FleetConfig, FleetTopology, SyntheticMLPTask
    return FleetConfig(task=SyntheticMLPTask(**DNN),
                       topology=FleetTopology(num_cells=cells,
                                              clients_per_cell=per_cell),
                       kernel="fused", rounds=rounds)


def run_main_path(card: str) -> tuple[list, dict]:
    import torch
    from repro_torch.fleet import build_simulation
    from repro_torch.kernels import block_norms as BN
    from repro_torch.kernels import fleet_fused as FF

    cfg = slice_config()
    t0 = time.perf_counter()
    sim = build_simulation(cfg)
    torch.cuda.synchronize()
    log(f"  build (population, data {tuple(sim.data['x'].shape)} on the card): "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    FF.fused_fleet_grads.launches = 0
    BN.tile_norms.launches = 0
    carry = sim.init_carry(sim.params)
    history = []
    for r in range(cfg.rounds):
        t0 = time.perf_counter()
        ctl = sim.control(r)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        carry, m = sim.apply(carry, ctl)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        history.append(m)
        log(f"  round {r}: loss={float(m['loss']):.6f} "
            f"acc={float(m['accuracy']):.4f} "
            f"latency={float(m['round_latency']):.4f} s "
            f"mean_rho={float(m['mean_prune']):.4f} "
            f"participants={int(m['participants'])} "
            f"solver_iters={int(ctl.sol.iterations.max())} "
            f"wall={(t2 - t0) * 1e3:.2f} ms (control {(t1 - t0) * 1e3:.2f}, "
            f"apply {(t2 - t1) * 1e3:.2f}) [{card}]")
    counts = {"fleet_fused_grads": FF.fused_fleet_grads.launches,
              "tile_norms": BN.tile_norms.launches}
    log("  kernels " + json.dumps(counts))
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    losses = [float(m["loss"]) for m in history]
    if not all(abs(v) < float("inf") for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    result = sim.finalize(carry, {k: torch.stack([h[k] for h in history])
                                  for k in history[0]})
    log(f"  bound_final={result.bound_final:.6f} "
        f"final accuracy={result.accuracy[-1]:.4f}")

    profile_round(sim, carry, cfg.rounds - 1, card)

    again = build_simulation(cfg)
    _, m2 = again.simulate(again.params)
    losses2 = m2["loss"].cpu().tolist()
    if losses2 != losses:
        raise AssertionError(f"rerun losses differ: {losses} vs {losses2}")
    log("  rerun: losses bitwise identical")
    return losses, counts


def profile_round(sim, carry, r: int, card: str) -> None:
    """One more (warm) round under torch.profiler: device busy share of the
    round's wall time and the device time by kernel.  A measurement only:
    if the profiler records no device time it says "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(carry, r)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log("  profiled round: device time not measured (no CUDA events)")
        return
    log(f"  profiled round: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e.count for e in kernels)} device ops [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


def numpy_fleet(cells: int, per_cell: int, rounds: int, seed: int = 7):
    """Population, per-round draws, params, task state and client batches
    of a small fleet, made with numpy (both devices start from these)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shape = (cells, per_cell)
    dist = rng.uniform(50, 500, shape)
    pathloss = 10.0 ** (-(128.1 + 37.6 * np.log10(dist / 1000.0)) / 10.0)
    pop = dict(dist_m=dist, pathloss=pathloss,
               cpu_hz=rng.uniform(2e9, 8e9, shape),
               num_samples=rng.integers(16, 65, shape).astype(np.float64),
               tx_power=np.full(shape, 10 ** 2.3 * 1e-3),
               max_prune=np.full(shape, 0.7))
    draws = [(pathloss * rng.exponential(size=shape),
              pathloss * rng.exponential(size=shape),
              rng.uniform(size=shape), rng.uniform(size=shape))
             for _ in range(rounds)]
    sizes = (DNN["feature_dim"],) + DNN["hidden"] + (DNN["num_classes"],)
    params = {f"layer{i}": {"w": rng.normal(size=(a, b)) * np.sqrt(2.0 / a),
                            "b": np.zeros(b)}
              for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    templates = rng.normal(size=(DNN["num_classes"], DNN["feature_dim"]))
    y_test = rng.integers(0, DNN["num_classes"], 512)
    state = dict(templates=templates, y_test=y_test,
                 x_test=templates[y_test] + 0.5 * rng.normal(
                     size=(512, DNN["feature_dim"])))
    y = rng.integers(0, DNN["num_classes"], (cells * per_cell, 8))
    batches = dict(y=y, x=templates[y] + 0.5 * rng.normal(
        size=(cells * per_cell, 8, DNN["feature_dim"])))
    return pop, draws, params, state, batches


def card_vs_cpu(card: str) -> None:
    import numpy as np
    from repro_torch import weights
    from repro_torch.fleet import InjectedDraws, run_fleet

    cells, per_cell, rounds = 4, 8, 3
    pop, draws, params, state, batches = numpy_fleet(cells, per_cell, rounds)
    cfg = slice_config(rounds=rounds, cells=cells, per_cell=per_cell)
    results = {}
    for dev in ("cpu", "cuda"):
        src = InjectedDraws(weights.population_from_numpy(pop, device=dev),
                            [weights.round_draws_from_numpy(*d, device=dev)
                             for d in draws])
        start = weights.start_from_numpy(params, state, batches, device=dev)
        results[dev] = run_fleet(cfg, device=dev, draws=src, start=start)
    a, b = results["cuda"], results["cpu"]
    loss_rel = float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses)))
    par_rel = max(float(np.max(np.abs(a.params[k][n] - b.params[k][n]))
                        / max(float(np.max(np.abs(b.params[k][n]))), 1e-30))
                  for k in b.params for n in ("w", "b"))
    log(f"  {cells}x{per_cell} clients, {rounds} rounds: losses card "
        f"{a.losses.tolist()} cpu {b.losses.tolist()}")
    log(f"  loss rel err {loss_rel:.3e}, params rel err {par_rel:.3e} "
        f"(tol {TOL}) [{card}]")
    if loss_rel > TOL or par_rel > TOL:
        raise AssertionError("card and CPU runs disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    log("[1] device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device count {torch.cuda.device_count()}")

    log("[2] build")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    for name in build.SOURCES:
        build.load(name)
    log(f"  built {', '.join(build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[3] kernels against their plain versions")
    from repro_torch.fleet import build_simulation
    probe = build_simulation(slice_config(rounds=1))
    rows = [check_fused(probe.params, probe.data, card),
            check_tile_norms(probe.params, card)]
    del probe
    torch.cuda.empty_cache()

    log("[4] main path")
    _, counts = run_main_path(card)
    for row in rows:
        row["launches"] = counts[row["name"]]

    log("[5] whole path, card against CPU")
    card_vs_cpu(card)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report and exit non-zero
        traceback.print_exc()
        sys.exit(1)
