#!/usr/bin/env python3
"""Fused pruned gradients: an earlier kernel source against the
repository's, on one NVIDIA card.

    python3 scripts/fused_compare.py --old OLD.cu [--variant kStages=2 ...]

``OLD.cu`` is a ``fleet_fused.cu`` of the first design, whose C entry
points are ``ff_masked_rows``, ``ff_loss``, ``ff_dw_partial`` and
``ff_reduce`` (for instance ``git archive 7a861cf
src/repro_torch/kernels/csrc/fleet_fused.cu``).  The script builds it
with nvcc into a temporary directory and runs it with that design's
launch sequence (every layer through ``masked_rows_kernel`` and
``dw_partial_kernel``, 128 row segments).  It builds the repository's
``csrc/fleet_fused.cu`` through ``repro_torch``'s build, and each
``--variant``: the repository's source with compile-time constants
replaced (``kStages=2``, ``kDwCTAs=3``), run through the same wrapper.  Each
is checked against ``fused_grads_plain`` (rel 1e-4) at chip_smoke's five
fused cases, then timed with torch.profiler (device time per call, split
by pass) at the slice (C = 10,000, 784-60-20-10, batch 8, block 8, rho ~
U[0, 0.7]) and at C = 1,001: old, new, new, old on the same inputs, then
the variants, beside the kept-tile bound, the two-pass floor and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

OLD_SEGMENTS = 128   # the first design's wrapper: dW row segments a layer


def compile_lib(src: str, tmp: str, tag: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    path = Path(tmp) / f"fleet_fused_{tag}.cu"
    path.write_text(src)
    out = Path(tmp) / f"libfleet_fused_{tag}.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(path)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def variant_source(src: str, spec: str) -> str:
    for item in filter(None, spec.split(",")):
        name, value = item.split("=")
        pat = re.compile(rf"\b{name} = \d+(?=;)")
        if len(pat.findall(src)) != 1:
            raise RuntimeError(f"no single constant {name} in the source")
        src = pat.sub(f"{name} = {int(value)}", src)
    return src


def old_call(lib: ctypes.CDLL, args, passes: list):
    """The first design's launch sequence (its wrapper's) on ``lib``;
    appends each launch's (kernel, pass) to ``passes`` when it is empty."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import fleet_fused as FF
    params, x, y, keeps, weights, block = args
    ws, bs = FF.layer_weights(params)
    nl = len(ws)
    c, batch, d = x.shape
    rows = c * batch
    dev = x.device
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr, null = build.ptr, ctypes.c_void_p(None)
    record = not passes

    def run(fn, kernel, label, *a):
        build.check(lib, fn(*a, stream), label)
        if record:
            passes.append((kernel, label))

    acts = [x.reshape(rows, d)]
    for l in range(nl):
        kdim, ndim = ws[l].shape
        z = torch.empty((rows, ndim), device=dev)
        run(lib.ff_masked_rows, "masked_rows_kernel", f"forward L{l}",
            ptr(acts[-1]), ptr(ws[l]), ptr(keeps[l]), ptr(bs[l]), null,
            ptr(z), rows, kdim, ndim, batch, block, int(l < nl - 1), 0)
        acts.append(z)
    dz = torch.empty((rows, ws[-1].shape[1]), device=dev)
    losses = torch.empty((c,), device=dev)
    y64 = y.reshape(-1).to(torch.int64).contiguous()
    run(lib.ff_loss, "loss_kernel", "loss", ptr(acts[-1]), ptr(y64), ptr(dz),
        ptr(losses), c, batch, ws[-1].shape[1])
    seg_rows = max(32, -(-rows // OLD_SEGMENTS))
    nseg = -(-rows // seg_rows)
    grads: list = [None] * nl
    for l in reversed(range(nl)):
        kdim, ndim = ws[l].shape
        partial = torch.empty((nseg, kdim + 1, ndim), device=dev)
        run(lib.ff_dw_partial, "dw_partial_kernel", f"dW L{l}", ptr(acts[l]),
            ptr(dz), ptr(weights), ptr(keeps[l]), ptr(partial), rows, kdim,
            ndim, batch, block, seg_rows, nseg)
        summed = torch.empty((kdim + 1, ndim), device=dev)
        run(lib.ff_reduce, "reduce_segments_kernel", f"reduce L{l}",
            ptr(partial), ptr(summed), nseg, (kdim + 1) * ndim)
        grads[l] = (summed[:kdim], summed[kdim])
        if l > 0:
            dz_prev = torch.empty((rows, kdim), device=dev)
            run(lib.ff_masked_rows, "masked_rows_kernel", f"backward L{l}",
                ptr(dz), ptr(ws[l]), ptr(keeps[l]), null, ptr(acts[l]),
                ptr(dz_prev), rows, ndim, kdim, batch, block, 0, 1)
            dz = dz_prev
    return FF.grads_tree(grads), losses


def bind_old(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ff_masked_rows.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.ff_loss.argtypes = [p] * 4 + [i] * 3 + [p]
    lib.ff_dw_partial.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.ff_reduce.argtypes = [p, p, i, ctypes.c_int64, p]
    for fn in (lib.ff_masked_rows, lib.ff_loss, lib.ff_dw_partial,
               lib.ff_reduce):
        fn.restype = ctypes.c_int


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.fleet import build_simulation
    from repro_torch.kernels import build
    from repro_torch.kernels import fleet_fused as FF

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="the first design's fleet_fused.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="constants of the tree's source to replace, e.g. "
                         "kStages=2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    probe = build_simulation(cs.slice_config(rounds=1))
    cases = cs.fused_cases(probe.params, probe.data.cached)
    tree_lib = build.load("fleet_fused")
    src = (build.CSRC / "fleet_fused.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        old = compile_lib(args.old.read_text(), tmp, "old")
        bind_old(old)
        variants = {spec: compile_lib(variant_source(src, spec), tmp, str(n))
                    for n, spec in enumerate(args.variant)}
        old_passes: list = []

        def run_old(a):
            return old_call(old, a, old_passes)

        def run_tree(a, lib=tree_lib):
            build._loaded["fleet_fused"] = lib   # FF._lib() binds it
            return FF.fused_fleet_grads(*a)

        runs = {"old": run_old, "new": run_tree}
        runs.update({f"variant {spec}": (lambda a, lib=lib: run_tree(a, lib))
                     for spec, lib in variants.items()})
        for name, fn in runs.items():
            worst = 0.0
            for _, a in cases:
                g, losses = fn(a)
                g_ref, l_ref = FF.fused_grads_plain(*a)
                torch.cuda.synchronize()
                rel = max([cs.rel_err(losses, l_ref)[1]]
                          + [cs.rel_err(g[k][n], g_ref[k][n])[1]
                             for k in g_ref for n in ("w", "b")])
                worst = max(worst, rel)
            print(f"{name}: max rel err {worst:.3e} over {len(cases)} cases "
                  f"(tol {cs.TOL})", flush=True)
            if worst > cs.TOL:
                raise AssertionError(f"{name} disagrees with the plain version")

        for case in (cases[1], cases[4]):
            a = case[1]
            c = a[1].shape[0]

            def timed(name):
                fn = runs[name]
                passes = old_passes if name == "old" else None
                return sum(cs.fused_split(lambda: fn(a), 20, card,
                                          passes).values())

            times = {"old": [], "new": []}
            for name in ("old", "new", "new", "old"):
                times[name].append(timed(name))
            extra = ", ".join(f"{name} {timed(name):.4f} ms"
                              for name in runs if name.startswith("variant"))
            bound, bound_by = cs.fused_bound_ms(probe.params, a[1], a[3])
            floor = max(cs.fused_floor_ms(probe.params, a[1], a[3]))
            print(f"C={c} ({case[0]}): old {times['old'][0]:.4f} / "
                  f"{times['old'][1]:.4f} ms, new {times['new'][0]:.4f} / "
                  f"{times['new'][1]:.4f} ms on the device"
                  f"{', ' + extra if extra else ''}; bound {bound:.4f} ms "
                  f"({bound_by}), two-pass floor {floor:.4f} ms [{card}]",
                  flush=True)
        build._loaded["fleet_fused"] = tree_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
