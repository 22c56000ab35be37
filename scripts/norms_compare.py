#!/usr/bin/env python3
"""Tile norms: an earlier kernel source against the repository's, on one
NVIDIA card, in both of the ranking's regimes.

    python3 scripts/norms_compare.py --old OLD.cu [--seg 2048,8192]
                                     [--variant kUnroll=8 ...]

``OLD.cu`` is a ``block_norms.cu`` of the first design, whose C entry
point is ``tile_sqnorms(w, out, K, N, bk, bn, stream)`` on one float32
matrix (for instance ``git archive 4e27ff9
src/repro_torch/kernels/csrc/block_norms.cu``).  The script builds it
with nvcc into a temporary directory and runs it as that design's ranking
did: every 2-D slice of every leaf cast to a float32 copy, one launch a
slice, the slices of a stacked leaf stacked.  The repository's kernel runs
through ``tile_norms_group`` (one launch a ranking).  Regimes: the fleet
round's three layers (784-60-20-10 at block 8, float32) and smollm-135m's
prunable leaves at full width (bfloat16, drawn from a seed, on
``auto_tile_grid``).  Each is checked against the plain version (rel
1e-4), then timed old, new, new, old: device time of the kernel's own
launches and of every device op of the ranking (torch.profiler), and a
call's CUDA-event time; beside the byte bound, an empty launch's device
time and the card's name and power limit.  ``--seg`` times the tree's
kernel at other row-segment sizes (``block_norms.SEG_ELEMS``), and each
``--variant`` the tree's source with compile-time constants replaced.
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


def compile_lib(src: str, tmp: str, tag: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    path = Path(tmp) / f"block_norms_{tag}.cu"
    path.write_text(src)
    out = Path(tmp) / f"libblock_norms_{tag}.so"
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


def old_ranking(lib: ctypes.CDLL, leaves, blocks) -> list:
    """The first design's ranking: a float32 copy and a launch a slice."""
    import torch
    from repro_torch.kernels import build
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    outs = []
    for w, (bk, bn) in zip(leaves, blocks):
        k, n = w.shape[-2:]
        norms = []
        for s in w.reshape((-1, k, n)):
            s = s.to(torch.float32).contiguous()
            out = torch.empty((-(-k // bk), -(-n // bn)), dtype=torch.float32,
                              device=w.device)
            build.check(lib, lib.tile_sqnorms(build.ptr(s), build.ptr(out), k,
                                              n, bk, bn, stream),
                        "tile_sqnorms")
            norms.append(out)
        outs.append(norms[0] if w.ndim == 2 else torch.stack(norms).reshape(
            tuple(w.shape[:-2]) + tuple(norms[0].shape)))
    return outs


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.fleet import build_simulation
    from repro_torch.kernels import block_norms as BN
    from repro_torch.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="the first design's block_norms.cu")
    ap.add_argument("--seg", default="",
                    help="comma-separated SEG_ELEMS values to time too")
    ap.add_argument("--variant", action="append", default=[],
                    help="constants of the tree's source to replace, e.g. "
                         "kUnroll=8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("norms_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    probe = build_simulation(cs.slice_config(rounds=1))
    ws = [probe.params[f"layer{i}"]["w"] for i in range(len(probe.params))]
    regimes = {"fleet": (ws, [(cs.BLOCK, cs.BLOCK)] * len(ws), 50),
               "smollm bundle": (*cs.smollm_ranking(), 10)}
    tree_lib = BN._lib()
    src = (build.CSRC / "block_norms.cu").read_text()
    floor = cs.device_ms(BN.empty_launch, 50, ("empty_kernel",))
    print(f"launch floor (an empty kernel): {floor:.5f} ms on the device "
          f"[{card}]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        old = compile_lib(args.old.read_text(), tmp, "old")
        old.tile_sqnorms.argtypes = [ctypes.c_void_p] * 2 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        old.tile_sqnorms.restype = ctypes.c_int
        variants = {spec: compile_lib(variant_source(src, spec), tmp, str(n))
                    for n, spec in enumerate(args.variant)}

        def run_tree(leaves, blocks, lib=tree_lib):
            build._loaded["block_norms"] = lib
            return BN.tile_norms_group(leaves, blocks)

        for what, (leaves, blocks, iters) in regimes.items():
            runs = {"old": (lambda: old_ranking(old, leaves, blocks),
                            "tile_sqnorms_kernel"),
                    "new": (lambda: run_tree(leaves, blocks),
                            "tile_norms_kernel")}
            runs.update({f"variant {spec}":
                         (lambda lib=lib: run_tree(leaves, blocks, lib),
                          "tile_norms_kernel")
                         for spec, lib in variants.items()})
            ref = BN.tile_norms_group_plain(leaves, blocks)
            for name, (fn, _) in runs.items():
                rel = max(cs.rel_err(g, r)[1] for g, r in zip(fn(), ref))
                print(f"{what}, {name}: max rel err {rel:.3e} (tol "
                      f"{cs.TOL})", flush=True)
                if rel > cs.TOL:
                    raise AssertionError(f"{name} disagrees with the plain "
                                         f"version")

            def timed(name):
                fn, kernel = runs[name]
                return (cs.device_ms(fn, iters, (kernel,)),
                        cs.device_ms(fn, iters), cs.cuda_ms(fn, iters))

            times = {"old": [], "new": []}
            for name in ("old", "new", "new", "old"):
                times[name].append(timed(name))
            nbytes = sum(w.numel() * w.element_size() for w in leaves) \
                + 4 * sum(r.numel() for r in ref)
            bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
            for name, ts in times.items():
                print(f"{what}: {name} kernel {ts[0][0]:.5f} / {ts[1][0]:.5f}"
                      f" ms, every device op {ts[0][1]:.5f} / {ts[1][1]:.5f}"
                      f" ms, call {ts[0][2]:.5f} / {ts[1][2]:.5f} ms; byte "
                      f"bound {bound:.6f} ms ({nbytes / 1e6:.2f} MB), launch "
                      f"floor {floor:.5f} ms [{card}]", flush=True)
            for name in runs:
                if name.startswith("variant"):
                    t = timed(name)
                    print(f"{what}: {name} kernel {t[0]:.5f} ms, call "
                          f"{t[2]:.5f} ms [{card}]", flush=True)
            seg0 = BN.SEG_ELEMS
            for seg in filter(None, args.seg.split(",")):
                BN.SEG_ELEMS = int(seg)
                t = timed("new")
                BN.SEG_ELEMS = seg0
                print(f"{what}: new at SEG_ELEMS={seg} kernel {t[0]:.5f} ms, "
                      f"call {t[2]:.5f} ms [{card}]", flush=True)
        build._loaded["block_norms"] = tree_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
