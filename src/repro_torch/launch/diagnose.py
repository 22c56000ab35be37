"""Dry-run profiler (the port of ``repro.launch.diagnose``): the cost of
one (arch x shape x mesh) combo by model function, its biggest local
tensors and its collectives, per chip.  The reference reads these off
the compiled HLO's computations; the port traces the step on a fake
group as the dry run does (``launch.dryrun``) and sorts what
``launch.cost.CostMode`` counted by the model function each op ran in
(the models are functions, not ``nn.Module``s).  It starts its own fake
group: run it as a process of its own.

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch smollm-135m --shape prefill_32k
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import cost as COST
from repro_torch.launch import dryrun as DR

__all__ = ["compile_combo", "breakdown", "main"]


def compile_combo(arch: str, shape_name: str, multi_pod: bool = False,
                  fl: bool = False, rules: dict | None = None):
    """Trace one combo's step (the reference compiles it): (the
    ``CostMode`` that counted it, by model function, the mesh, and the
    step's argument bytes a chip)."""
    spec, mesh, use = DR.combo(get_config(arch), INPUT_SHAPES[shape_name],
                               multi_pod, fl, rules)
    counted, arg_bytes, _ = DR.trace(spec, mesh, use)
    return counted, mesh, arg_bytes


def breakdown(counted: COST.CostMode, top: int = 15,
              arg_bytes: float = 0.0) -> None:
    """Print the totals (the peak as the dry run reports it: live bytes
    plus the arguments), the top model functions, the biggest local
    tensors and the collectives."""
    total = counted.cost
    print(f"\nTOTAL per chip: {total.flops/1e12:.2f} TF, "
          f"{total.hbm_bytes/1e9:.1f} GB HBM, "
          f"{total.collective_bytes/1e9:.2f} GB links, "
          f"peak {counted.peak_bytes/2**30:.2f} GiB live + "
          f"{arg_bytes/2**30:.2f} GiB arguments = "
          f"{(counted.peak_bytes + arg_bytes)/2**30:.2f} GiB, "
          f"{total.ops} local ops")
    print(f"\n-- top {top} model functions by HBM bytes "
          f"(summed over every call in the step) --")
    rows = sorted(((c.hbm_bytes, c.flops, c.collective_bytes, n)
                   for n, c in counted.by_scope.items()), reverse=True)[:top]
    print(f"{'function':40s} {'GB':>9s} {'GF':>10s} {'link GB':>9s}")
    for b, f, col, n in rows:
        print(f"{n[:40]:40s} {b/1e9:9.2f} {f/1e9:10.1f} {col/1e9:9.2f}")

    print("\n-- biggest single local tensors (>=64MB) --")
    big = sorted(counted.big_tensors.items(), reverse=True)[:top]
    for (bb, op, shp, dtype, scope), cnt in big:
        shape = "x".join(str(d) for d in shp)
        print(f"  {bb/2**20:8.0f}MB x{cnt:<4d} {op:22s} "
              f"{dtype.removeprefix('torch.')}[{shape}] in {scope}")

    print("\n-- collectives (per chip) --")
    for op, n in sorted(total.collective_counts.items()):
        print(f"  {op:20s} x{n:<8.0f} "
              f"{total.collective_op_bytes[op]/1e9:10.2f} GB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fl", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    counted, _mesh, arg_bytes = compile_combo(
        args.arch, args.shape, multi_pod=args.multi_pod, fl=args.fl)
    breakdown(counted, args.top, arg_bytes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
