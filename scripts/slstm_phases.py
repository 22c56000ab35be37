#!/usr/bin/env python3
"""Where a step of the sLSTM forward kernel goes, on one NVIDIA card.

    python3 scripts/slstm_phases.py [kRegK=48 ...]

Builds a copy of ``csrc/slstm_scan.cu`` (its compile-time constants
replaced by the ``NAME=VALUE`` arguments) with ``clock64()`` read around
the three phases of every step: the wait for the peers' h_{t-1} (the
mbarrier), the products with R up to the CTA barrier, and the cell with
its sends and global stores.  Runs it at chip_smoke's 17a shape (4, 4096)
at xlstm-125m's sLSTM heads (4 of 192), and prints the mean cycles a step
by phase for thread 0 of every CTA (warp 0: a cell thread that also forms
products), the product loop alone for warps 0 and 7, warp 7's wait, and
the uninstrumented kernel's ms, beside the card's name and power limit.
The counters are this script's: the repository's kernel has none.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from scripts.fused_compare import variant_source  # noqa: E402

# (text of the kernel, text with the counters); each must occur once
PROBES = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long probe[8];\n"),
    ("  for (int t = 0; t < a.S; ++t) {\n"
     "    const float* hcur = hbuf + (t & 1) * hpad;\n",
     "  long long c0 = clock64(), wait = 0, prod = 0, cell_ = 0, loop = 0;\n"
     "  for (int t = 0; t < a.S; ++t) {\n"
     "    const float* hcur = hbuf + (t & 1) * hpad;\n"),
    ("      if (tid == 0) mbar_expect(bar, 4 * hd);\n    }\n",
     "      if (tid == 0) mbar_expect(bar, 4 * hd);\n    }\n"
     "    const long long c1 = clock64();\n    wait += c1 - c0;\n"),
    ("    __syncthreads();\n    if (cell) {\n      float p[4];",
     "    loop += clock64() - c1;\n    __syncthreads();\n"
     "    const long long c2 = clock64();\n    prod += c2 - c1;\n"
     "    if (cell) {\n      float p[4];"),
    ("      a.m_all[o_] = m;\n    }\n  }\n",
     "      a.m_all[o_] = m;\n    }\n    c0 = clock64();\n    cell_ += c0 - c2;\n"
     "  }\n"
     "  if (tid == 0) {\n"
     "    atomicAdd(&probe[0], (unsigned long long)wait);\n"
     "    atomicAdd(&probe[1], (unsigned long long)prod);\n"
     "    atomicAdd(&probe[2], (unsigned long long)cell_);\n"
     "    atomicAdd(&probe[3], 1ull);\n"
     "    atomicAdd(&probe[4], (unsigned long long)loop);\n  }\n"
     "  if (tid == 224) {\n"
     "    atomicAdd(&probe[5], (unsigned long long)loop);\n"
     "    atomicAdd(&probe[6], (unsigned long long)wait);\n  }\n"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int probe_read(unsigned long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, probe, sizeof(probe));\n}\n"
     "int probe_zero() {\n  unsigned long long z[8] = {0};\n"
     "  return (int)cudaMemcpyToSymbol(probe, z, sizeof(z));\n}\n"),
]


def instrumented(src: str, specs: list) -> str:
    src = variant_source(src, ",".join(specs))
    for old, new in PROBES:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel no longer has {old[:40]!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("slstm_phases: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    src = instrumented((build.CSRC / "slstm_scan.cu").read_text(),
                       sys.argv[1:])
    ins = cs.scan_inputs("slstm", cs.XHOST_B, cs.XHOST_S, 44, False)
    b, s, h, _, hd = ins[0].shape
    state = torch.empty((b, s, h, hd), device="cuda")
    outs = [state] + [torch.empty_like(state) for _ in range(3)] \
        + [torch.empty_like(ins[0])]
    ptrs = [build.ptr(t) for t in list(ins) + outs]
    with tempfile.TemporaryDirectory() as tmp:
        path, lib_path = Path(tmp) / "probe.cu", Path(tmp) / "libprobe.so"
        path.write_text(src)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                        str(path)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.slstm_scan_fwd.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def run():
            code = lib.slstm_scan_fwd(*ptrs, b, s, h, hd, stream)
            if code:
                raise RuntimeError(f"slstm_scan_fwd: CUDA error {code}")

        run()
        torch.cuda.synchronize()
        lib.probe_zero()
        run()
        torch.cuda.synchronize()
        vals = (ctypes.c_ulonglong * 8)()
        lib.probe_read(vals)
    from repro_torch.kernels import slstm_scan as SS
    ms = cs.cuda_ms(lambda: SS.slstm_scan(*ins), 3)
    steps = vals[3] * s
    print(f"slstm_fwd_kernel {sys.argv[1:] or 'as built'} (B={b}, S={s}, "
          f"heads ({h}, {hd})), cycles a step, thread 0 of {vals[3]} CTAs: "
          f"wait {vals[0] / steps:.0f}, products to the CTA barrier "
          f"{vals[1] / steps:.0f}, cell, sends and stores "
          f"{vals[2] / steps:.0f}; the product loop alone: warp 0 "
          f"{vals[4] / steps:.0f}, warp 7 {vals[5] / steps:.0f} (its wait "
          f"{vals[6] / steps:.0f}); the tree's kernel {ms:.3f} ms [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
