#!/usr/bin/env python3
"""Timeline of the block-sparse matmul's split regime on one NVIDIA card.

    python3 scripts/bsmm_trace.py

Builds a copy of ``csrc/block_sparse_matmul.cu`` into a temporary
directory with ``%globaltimer`` stamps added at each phase of a split CTA
(start, keep flags read, tiles loaded, partial computed, cluster barrier
reached and passed, fold done, end), runs smollm-135m's four decode
shapes (B = 32) at rho = 0.5, 0 and 1, and prints the median over five
launches of the spread of the CTAs' start times and of each phase's mean
length in SM clock cycles, beside the product's torch.profiler device
time.  The stamps are thread 0's; the copy in ``csrc`` is not changed.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PHASES = ("flags", "loads", "compute", "to barrier", "barrier", "fold")


def traced_source(src: str) -> str:
    """The kernel source with stamps at the phases of a split CTA: slot 0
    of a CTA's 8 gets %globaltimer at its start, slot 1 + k the SM's
    clock64 at stamp k."""
    def stamp(k):
        head = ("if (g_trace && threadIdx.x == 0) g_trace[(blockIdx.x * "
                "gridDim.z + blockIdx.z) * 8")
        if k == 0:
            return (f"{head}] = stamp_ns();\n{head} + 1] = clock64();\n")
        return f"{head} + {k + 1}] = clock64();\n"
    edits = [
        ("namespace {\n",
         "__device__ long long* g_trace;\n"
         "__device__ __forceinline__ long long stamp_ns() {\n"
         "  long long t;\n"
         "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\nnamespace {\n"),
        ("  const int tid = threadIdx.x,",
         stamp(0) + "  const int tid = threadIdx.x,"),
        ("    const bool live = lo < hi && publish(flag_of(s / a.nsub), 0);\n",
         "    const bool live = lo < hi && publish(flag_of(s / a.nsub), 0);\n"
         + stamp(1)),
        ("      __syncthreads();\n      compute(0, 0, hi - lo, p);\n",
         "      __syncthreads();\n" + stamp(2)
         + "      compute(0, 0, hi - lo, p);\n" + stamp(3)),
        ("  cluster.sync();\n  for (int l = tid;",
         stamp(4) + "  cluster.sync();\n" + stamp(5)
         + "  for (int l = tid;"),
        ("  }\n}\n\ntemplate <bool kTrans, int TM, bool kSplit>\nint launch_one",
         "  }\n" + stamp(6)
         + "}\n\ntemplate <bool kTrans, int TM, bool kSplit>\nint launch_one"),
        ("extern \"C\" {\n",
         "extern \"C\" {\nint set_trace(void* p) {\n"
         "  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n}\n"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"cannot place a stamp at {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import block_sparse_matmul as BSM
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("bsmm_trace: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="bsmm_trace_"))
    (tmp / "t.cu").write_text(traced_source(
        (build.CSRC / "block_sparse_matmul.cu").read_text()))
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(tmp / "t.so"),
                    str(tmp / "t.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(tmp / "t.so"))
    lib.set_trace.argtypes = [ctypes.c_void_p]
    lib.bsmm_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(1)
    trace = torch.zeros(8192 * 8, dtype=torch.int64, device="cuda")
    m = cs.SERVE_BATCH
    for lin, (kdim, ndim, bk, bn) in cs.SERVE_LINEARS.items():
        plan = BSM.launch_plan(m, kdim, ndim, bk, 132)
        if not plan.cluster:
            continue
        w = torch.randn(kdim, ndim, generator=g, device="cuda")
        x = torch.randn(m, kdim, generator=g, device="cuda")
        y = torch.empty(m, ndim, device="cuda")
        for rho in (0.5, 0.0, 1.0):
            keep = cs.random_keep(kdim, ndim, bk, bn, rho, g).int()

            def call(ptr):
                lib.set_trace(ctypes.c_void_p(ptr))
                code = lib.bsmm_forward(
                    x.data_ptr(), w.data_ptr(), keep.data_ptr(),
                    y.data_ptr(), m, kdim, ndim, bk, bn, plan.nsub,
                    plan.seg_len, plan.cluster, ctypes.c_void_p(
                        torch.cuda.current_stream().cuda_stream))
                if code:
                    raise RuntimeError(f"launch failed: {code}")
            ms = cs.device_ms(lambda: call(0), 30, ("bsmm_kernel",))
            rows = []
            for _ in range(5):
                trace.zero_()
                call(trace.data_ptr())
                torch.cuda.synchronize()
                t = trace.view(-1, 8)[:plan.ctas].cpu().double()
                row = [float(t[:, 0].max() - t[:, 0].min()) / 1e3]
                for k in range(1, 7):    # cycles from stamp k - 1 to k
                    a, b = t[:, k], t[:, k + 1]
                    hit = (a > 0) & (b > 0)
                    row.append(float((b - a)[hit].mean())
                               if hit.any() else float("nan"))
                rows.append(row)
            med = torch.tensor(rows).median(0).values.tolist()
            phases = " ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, med[1:]))
            print(f"{lin} rho={rho}: {ms * 1e3:.2f} us on the device; "
                  f"starts spread {med[0]:.2f} us; cycles: {phases} "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
