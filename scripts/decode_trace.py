#!/usr/bin/env python3
"""Timeline of the decode-attention kernel on one NVIDIA card.

    python3 scripts/decode_trace.py

Builds a copy of ``csrc/decode_attention.cu`` into a temporary directory
with stamps added by thread 0 of each CTA: ``%globaltimer`` at the CTA's
start and end, and the SM's clock64 at its start, once q and its warp's
first chunk have landed (the prologue's barrier), after warp 0's chunk
loop, at the barrier before the fold, and once the CTA's writes are done
(in a cluster: after the cluster barrier, or after CTA 0's fold).  Runs
smollm-135m's serving shape (B = 32, S = 128, pos < 63) and a long cache
(B = 32, S = 2048, pos uniform in [1024, 2047]) and prints, as medians
over five launches: the kernel's torch.profiler device time, the span
from the first CTA's start to the last CTA's end, the spread of the CTAs'
starts, and each phase's mean length in SM clock cycles.  The copy in
``csrc`` is not changed.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PHASES = ("prologue", "chunks", "to fold", "fold and writes")
SLOTS = 8


def traced_source(src: str) -> str:
    """The kernel source with stamps: slot 0 of a CTA's 8 gets
    %globaltimer at its start, slot 7 at its end, slots 1..5 clock64."""
    head = ("if (g_trace && threadIdx.x == 0) g_trace[(blockIdx.x * "
            "gridDim.y + blockIdx.y) * 8")

    def clock(k):
        return f"  {head} + {k}] = clock64();\n"

    end = clock(5) + f"  {head} + 7] = stamp_ns();\n"
    edits = [
        ("namespace {\n",
         "__device__ long long* g_trace;\n"
         "__device__ __forceinline__ long long stamp_ns() {\n"
         "  long long t;\n"
         "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\nnamespace {\n"),
        ("  if (nc > 1) cluster_arrive_relaxed();   // this CTA runs\n",
         f"  {head}] = stamp_ns();\n" + clock(1)
         + "  if (nc > 1) cluster_arrive_relaxed();   // this CTA runs\n"),
        ("  int s = 0;\n  for (int j = j0;", clock(2)
         + "  int s = 0;\n  for (int j = j0;"),
        ("  cp_async_wait<0>();\n\n", "  cp_async_wait<0>();\n" + clock(3)),
        ("  __syncthreads();\n\n  // the CTA's partial",
         "  __syncthreads();\n" + clock(4) + "\n  // the CTA's partial"),
        ("  if (nc == 1) return;\n", "  if (nc == 1) {\n" + end
         + "    return;\n  }\n"),
        ("  if (c != 0) return;\n", "  if (c != 0) {\n" + end
         + "    return;\n  }\n"),
        ("    a.out[qo + e] = A / fmaxf(L, 1e-30f);\n  }\n}\n",
         "    a.out[qo + e] = A / fmaxf(L, 1e-30f);\n  }\n" + end + "}\n"),
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
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA

    if not torch.cuda.is_available():
        print("decode_trace: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = Path(tmp) / "t.cu", Path(tmp) / "libt.so"
        cu.write_text(traced_source(
            (build.CSRC / "decode_attention.cu").read_text()))
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                        str(cu)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.set_trace.argtypes = [ctypes.c_void_p]
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        build._loaded["decode_attention"] = lib   # the wrapper's library

        g = torch.Generator(device="cuda").manual_seed(61)
        b, hkv, grp, hd = (cs.SERVE_BATCH, cs.SERVE_KV, cs.SERVE_GROUP,
                           cs.SERVE_HD)
        for what, s, lo, hi in [("serving shape (B=32, S=128, pos < 63)",
                                 128, 0, cs.SERVE_PROMPT + cs.SERVE_NEW - 1),
                                ("long cache (B=32, S=2048, pos in "
                                 "[1024, 2047])", 2048, 1024, 2048)]:
            q = torch.randn(b, hkv * grp, hd, generator=g, device="cuda")
            k = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
            v = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
            pos = torch.randint(lo, hi, (b,), generator=g, device="cuda",
                                dtype=torch.int32)
            lib.set_trace(None)
            ms = cs.device_ms(lambda: DA.decode_attention(q, k, v, pos), 50,
                              ("decode_kernel",))
            trace = torch.zeros(b * hkv * 8 * SLOTS, dtype=torch.int64,
                                device="cuda")
            lib.set_trace(ctypes.c_void_p(trace.data_ptr()))
            rows = []
            for _ in range(5):
                trace.zero_()
                DA.decode_attention(q, k, v, pos)
                torch.cuda.synchronize()
                t = trace.view(-1, SLOTS).cpu().double()
                t = t[t[:, 0] > 0]
                row = [float(t[:, 7].max() - t[:, 0].min()) / 1e3,
                       float(t[:, 0].max() - t[:, 0].min()) / 1e3]
                for k_ in range(1, 5):    # cycles from stamp k_ to k_ + 1
                    a, e = t[:, k_], t[:, k_ + 1]
                    hit = (a > 0) & (e > 0)
                    row.append(float((e - a)[hit].mean())
                               if hit.any() else float("nan"))
                rows.append(row)
            lib.set_trace(None)
            med = torch.tensor(rows).median(0).values.tolist()
            phases = ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES,
                                                              med[2:]))
            print(f"{what}: {ms * 1e3:.2f} us on the device; first start to "
                  f"last end {med[0]:.2f} us, starts spread {med[1]:.2f} us;"
                  f" {len(t)} CTAs; cycles: {phases} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
