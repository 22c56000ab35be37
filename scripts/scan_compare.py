#!/usr/bin/env python3
"""The xLSTM scans: an earlier kernel source against the repository's, on
one NVIDIA card.

    python3 scripts/scan_compare.py --old OLD_DIR [--variant kCluster=4 ...]

``OLD_DIR`` holds an earlier ``mlstm_scan.cu`` and ``slstm_scan.cu``
(searched for under it, for instance the output of ``git archive 249e034
src/repro_torch/kernels/csrc/mlstm_scan.cu
src/repro_torch/kernels/csrc/slstm_scan.cu | tar -x -C OLD_DIR``): the
first design, whose sLSTM forward is one CTA per (b, h) reading R from L2
every step and whose mLSTM backward is two launches (the dq / dv / dk
passes, S steps each, then the gates) with a scratch of B H ceil(S / 32)
ceil(hd / 4) floats.  The script builds both with nvcc (the old mLSTM
source with a probe of its pass kernel's occupancy appended) and each
``--variant``: the repository's sLSTM source with compile-time constants
replaced (``kCluster=4``).  The old kernels and the variants run through
their C entry points, which have the repository's signatures; the
repository's through its ops.  It prints each build's ptxas lines, the
sLSTM forward's cluster (CTAs, shared memory a CTA, the clusters the card
holds at once), the old backward's blocks a multiprocessor, then checks
each against the plain version at (B, S) = (2, 256) at xlstm-125m's heads
(the sLSTM forward's h, the mLSTM backward's every gradient against
autograd of the stepped cell; within chip_smoke's TOL of max(1, |plain|),
reruns bitwise), and times old, new, new, old with CUDA events at (2, 256)
and at (4, 4096), the variants after, beside the bound and the card's name
and power limit.  Last, each version's device time by kernel at (4, 4096):
torch.profiler's, but the repository's mLSTM backward's by CUDA events
between its three launches (``mlstm_scan.backward_launch_ms``).
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

from scripts.fused_compare import variant_source  # noqa: E402

SHAPES = ((2, 256), (4, 4096))

# appended to the old mLSTM source: blocks of its pass kernel a
# multiprocessor at xlstm-125m's hd = 384 (12 elements a lane)
OCCUPANCY_PROBE = """
extern "C" int probe_pass_occupancy() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, mlstm_bwd_mat_kernel<12>, kThreads, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
"""


def compile_lib(src: str, tmp: str, tag: str) -> tuple:
    """(the loaded library, ptxas's register and spill lines)."""
    from repro_torch.kernels import build
    path = Path(tmp) / f"{tag}.cu"
    path.write_text(src)
    out = Path(tmp) / f"lib{tag}.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(path)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, ptxas_lines(proc.stdout + proc.stderr)


def ptxas_lines(text: str) -> list:
    keep, name = [], ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"\d([a-z][a-z0-9_]*_kernel)", line)
            name = found.group(1) if found else line.split("'")[1]
        elif "registers" in line or "spill" in line:
            keep.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return keep


def bind(lib: ctypes.CDLL, kind: str) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if kind == "slstm":
        lib.slstm_scan_fwd.argtypes = [p] * 11 + [i] * 4 + [p]
        lib.slstm_scan_fwd.restype = i
    else:
        lib.mlstm_scan_bwd.argtypes = [p] * 23 + [i] * 4 + [ctypes.c_float, p]
        lib.mlstm_scan_bwd.restype = i


def stream():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def slstm_fwd_c(lib):
    """The sLSTM forward through a library's C entry: (h, c, n, m, pre)."""
    import torch
    from repro_torch.kernels import build

    def run(x, R, c0, n0, m0, h0):
        b, s, h, _, hd = x.shape
        state = torch.empty((b, s, h, hd), device=x.device)
        out = [state] + [torch.empty_like(state) for _ in range(3)] \
            + [torch.empty_like(x)]
        build.check(lib, lib.slstm_scan_fwd(
            *map(build.ptr, [x, R, c0, n0, m0, h0] + out), b, s, h, hd,
            stream()), "slstm_scan_fwd")
        return tuple(out)
    return run


def mlstm_bwd_c(lib):
    """The first design's mLSTM backward through its C entry, its scratch
    B H ceil(S / 32) ceil(hd / 4) floats."""
    import torch
    from repro_torch.kernels import build

    def run(dh, q, k, v, ip, fp, C0, n0, m0, h, n_all, m_all, d_all, snap):
        b, s, hh, hd = q.shape
        ins = [dh, q, k, v, ip, fp, C0, n0, m0, h, n_all, m_all, d_all, snap]
        out = [torch.empty_like(t) for t in (q, k, v, ip, fp, C0, n0, m0)]
        part = torch.empty((b * hh * snap.shape[2] * (-(-hd // 4)),),
                           device=q.device)
        build.check(lib, lib.mlstm_scan_bwd(
            *map(build.ptr, ins + out + [part]), b, s, hh, hd, hd ** -0.5,
            stream()), "mlstm_scan_bwd")
        return tuple(out)
    return run


def kernel_split(fn, iters: int) -> dict:
    """Device ms a call by kernel (torch.profiler over ``iters`` warm
    calls); {} where the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.self_device_time_total > 0:
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "",
                          e.key).split("(")[0]
            out[name] = out.get(name, 0.0) + e.self_device_time_total \
                / 1e3 / iters
    return out


def max_rel(got, want) -> float:
    return max(float((a - w).abs().max()) / max(float(w.abs().max()), 1.0)
               for a, w in zip(got, want))


def main() -> int:
    import torch
    import chip_smoke as cs
    from torch.utils.flop_counter import flop_registry
    from repro_torch.kernels import build
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.kernels import slstm_scan as SS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="a directory holding the earlier mlstm_scan.cu and "
                         "slstm_scan.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="constants of the tree's sLSTM source to replace, "
                         "e.g. kCluster=4")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    old_src = {k: next(args.old.rglob(f"{k}_scan.cu")).read_text()
               for k in ("mlstm", "slstm")}

    logs = build.build(("mlstm_scan", "slstm_scan"))
    for name, text in logs.items():
        for line in ptxas_lines(text):
            print(f"new {name}: {line}", flush=True)
    tree_slstm = (build.CSRC / "slstm_scan.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        old_m, lines_m = compile_lib(old_src["mlstm"] + OCCUPANCY_PROBE, tmp,
                                     "old_mlstm")
        old_s, lines_s = compile_lib(old_src["slstm"], tmp, "old_slstm")
        for line in lines_m + lines_s:
            print(f"old: {line}", flush=True)
        bind(old_m, "mlstm")
        bind(old_s, "slstm")
        variants = {}
        for n, spec in enumerate(args.variant):
            lib, lines = compile_lib(variant_source(tree_slstm, spec), tmp,
                                     f"variant{n}")
            bind(lib, "slstm")
            SS._lib()                       # the tree's argtypes
            lib.slstm_scan_fwd_cluster.argtypes = \
                SS._lib().slstm_scan_fwd_cluster.argtypes
            variants[spec] = lib
            for line in lines:
                print(f"variant {spec}: {line}", flush=True)

        hd_s = cs.SCAN_HEADS["slstm"][1]
        info = SS.cluster_info(hd_s)
        print(f"new slstm_fwd_kernel at hd = {hd_s}: cluster {info['cluster']}"
              f" CTAs, {info['smem_bytes']} B shared memory a CTA, "
              f"cudaOccupancyMaxActiveClusters {info['max_active_clusters']}"
              f" [{card}]", flush=True)
        for spec, lib in variants.items():
            vals = [ctypes.c_int(0) for _ in range(3)]
            build.check(lib, lib.slstm_scan_fwd_cluster(
                hd_s, *map(ctypes.byref, vals)), "cluster query")
            print(f"variant {spec}: cluster {vals[0].value} CTAs, "
                  f"{vals[1].value} B a CTA, max active clusters "
                  f"{vals[2].value} [{card}]", flush=True)
        old_m.probe_pass_occupancy.restype = ctypes.c_int
        print(f"old mlstm_bwd_mat_kernel<12> (256 threads): "
              f"{old_m.probe_pass_occupancy()} blocks a multiprocessor "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor) [{card}]",
              flush=True)

        s_runs = {"old": slstm_fwd_c(old_s),
                  "new": torch.ops.repro_torch.slstm_scan}
        s_runs.update({f"variant {spec}": slstm_fwd_c(lib)
                       for spec, lib in variants.items()})
        m_runs = {"old": mlstm_bwd_c(old_m),
                  "new": torch.ops.repro_torch.mlstm_scan_bwd}

        # (2, 256): each against the plain version, zero and drawn states
        b, s = cs.SCAN_B, cs.SCAN_S
        for state in (False, True):
            ins = cs.scan_inputs("slstm", b, s, 41 + state, state)
            want = SS.slstm_scan_plain(*ins)
            for name, fn in s_runs.items():
                got = fn(*ins)
                same = all(torch.equal(x, y) for x, y in zip(got, fn(*ins)))
                rel = max_rel([got[0]], [want])
                print(f"slstm forward {name} (B={b}, S={s}, "
                      f"{'drawn' if state else 'zero'} states): h err / "
                      f"max(1, |plain|) {rel:.1e} (tol {cs.TOL}); rerun "
                      f"{'bitwise' if same else 'DIFFERENT'}", flush=True)
                if rel > cs.TOL or not same:
                    raise AssertionError(f"slstm {name} disagrees")
            ins = cs.scan_inputs("mlstm", b, s, 41 + state, state)
            saved = torch.ops.repro_torch.mlstm_scan(*ins)
            dh = torch.randn_like(saved[0])
            want = cs.scan_grads(MS.mlstm_scan_plain, ins, dh)[1:]
            for name, fn in m_runs.items():
                got = fn(dh, *ins, *saved)
                same = all(torch.equal(x, y)
                           for x, y in zip(got, fn(dh, *ins, *saved)))
                rel = max_rel(got, want)
                print(f"mlstm backward {name} (B={b}, S={s}, "
                      f"{'drawn' if state else 'zero'} states): grads err / "
                      f"max(1, |plain|) {rel:.1e} (tol {cs.TOL}); rerun "
                      f"{'bitwise' if same else 'DIFFERENT'}", flush=True)
                if rel > cs.TOL or not same:
                    raise AssertionError(f"mlstm {name} disagrees")

        for b, s in SHAPES:
            iters = 3 if s > 1024 else 10
            ins = cs.scan_inputs("slstm", b, s, 44, False)
            op = torch.ops.repro_torch.slstm_scan
            bound, by = cs.bound_ms(cs.scan_bytes("slstm", "fwd", ins),
                                    float(flop_registry[op](*ins,
                                                            out_val=None)))
            ref = s_runs["new"](*ins)
            for name, fn in s_runs.items():
                if name != "new":
                    rel = max_rel(fn(*ins), ref)
                    print(f"slstm forward {name} vs new (B={b}, S={s}): "
                          f"{rel:.1e}", flush=True)
            times = {n: [] for n in s_runs}
            for name in ("old", "new", "new", "old"):
                times[name].append(cs.cuda_ms(lambda: s_runs[name](*ins),
                                              iters))
            extra = "".join(f", {n} {cs.cuda_ms(lambda: fn(*ins), iters):.3f}"
                            f" ms" for n, fn in s_runs.items()
                            if n.startswith("variant"))
            print(f"slstm_scan forward (B={b}, S={s}): old "
                  f"{times['old'][0]:.3f} / {times['old'][1]:.3f} ms, new "
                  f"{times['new'][0]:.3f} / {times['new'][1]:.3f} ms{extra};"
                  f" bound {bound:.4f} ms ({by}) [{card}]", flush=True)
            if s > 1024:
                for name, fn in s_runs.items():
                    split = kernel_split(lambda: fn(*ins), iters)
                    print(f"slstm forward {name} by kernel (B={b}, S={s}): "
                          + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in split.items())
                          + f" [{card}]", flush=True)
            del ins, ref

            ins = cs.scan_inputs("mlstm", b, s, 44, False)
            saved = torch.ops.repro_torch.mlstm_scan(*ins)
            dh = torch.randn_like(saved[0])
            args_ = [dh, *ins, *saved]
            op = torch.ops.repro_torch.mlstm_scan_bwd
            bound, by = cs.bound_ms(cs.scan_bytes("mlstm", "bwd", ins),
                                    float(flop_registry[op](*args_,
                                                            out_val=None)))
            rel = max_rel(m_runs["old"](*args_), m_runs["new"](*args_))
            print(f"mlstm backward old vs new (B={b}, S={s}): {rel:.1e}",
                  flush=True)
            times = {n: [] for n in m_runs}
            for name in ("old", "new", "new", "old"):
                times[name].append(cs.cuda_ms(lambda: m_runs[name](*args_),
                                              iters))
            print(f"mlstm_scan_bwd (B={b}, S={s}): old "
                  f"{times['old'][0]:.3f} / {times['old'][1]:.3f} ms, new "
                  f"{times['new'][0]:.3f} / {times['new'][1]:.3f} ms; bound "
                  f"{bound:.4f} ms ({by}) [{card}]", flush=True)
            if s > 1024:
                for name, fn in m_runs.items():
                    split = (MS.backward_launch_ms(args_, iters)
                             if name == "new" else
                             kernel_split(lambda: fn(*args_), iters))
                    print(f"mlstm backward {name} by kernel (B={b}, S={s}): "
                          + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in split.items())
                          + f" [{card}]", flush=True)
            del ins, saved, dh, args_
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
