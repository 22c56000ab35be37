#!/usr/bin/env python3
"""Decode attention: another kernel source against the repository's, on
one NVIDIA card.

    python3 scripts/decode_compare.py --old OLD.cu

``OLD.cu`` is a ``decode_attention.cu`` with the same C entry point, for
instance an earlier commit's (``git archive <commit>
src/repro_torch/kernels/csrc/decode_attention.cu``); the type of its head
mask, int32 or float32, is read from that entry point's signature.  The
script builds it with nvcc into a temporary directory, builds the
repository's ``csrc/decode_attention.cu`` through ``repro_torch``'s build,
checks both against ``decode_attention_plain`` (rel 1e-4), and prints
each one's torch.profiler device time per launch at smollm-135m's serving
shape (B = 32, S = 128, pos < 63) and at a long cache (B = 32, S = 2048,
pos uniform in [1024, 2047], ~75 MB of valid K/V), timed in turns old,
new, new, old on the same inputs, beside the byte bound and the card's
name and power limit.
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


def load_old(path: Path, tmp: str) -> tuple[ctypes.CDLL, object]:
    """The old source's library and the torch dtype of its head mask."""
    import torch
    from repro_torch.kernels import build
    src = path.read_text()
    sig = re.search(r"int decode_attention\(([^)]*)\)", src)
    if sig is None:
        raise RuntimeError(f"{path}: no decode_attention entry point")
    mask_t = torch.int32 if "int32_t* head_mask" in sig.group(1) \
        else torch.float32
    out = Path(tmp) / "libdecode_old.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(path)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.decode_attention.argtypes = [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    lib.decode_attention.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, mask_t


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="the decode_attention.cu to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    g = torch.Generator(device="cuda").manual_seed(41)
    b, hkv, grp, hd = cs.SERVE_BATCH, cs.SERVE_KV, cs.SERVE_GROUP, cs.SERVE_HD
    with tempfile.TemporaryDirectory() as tmp:
        old, mask_t = load_old(args.old, tmp)
        ones = torch.ones(hkv, dtype=mask_t, device="cuda")

        def run_old(q, k, v, pos):
            out = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream
            code = old.decode_attention(
                build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(pos),
                build.ptr(ones), build.ptr(out), b, k.shape[1], hkv * grp,
                hkv, hd, 0, hd ** -0.5, ctypes.c_void_p(stream))
            build.check(old, code, "old decode_attention")
            return out

        def run_new(q, k, v, pos):
            return DA.decode_attention(q, k, v, pos)

        for what, s, lo, hi in [("serving shape (B=32, S=128, pos < 63)",
                                 128, 0, cs.SERVE_PROMPT + cs.SERVE_NEW - 1),
                                ("long cache (B=32, S=2048, pos in "
                                 "[1024, 2047])", 2048, 1024, 2048)]:
            q = torch.randn(b, hkv * grp, hd, generator=g, device="cuda")
            k = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
            v = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
            pos = torch.randint(lo, hi, (b,), generator=g, device="cuda",
                                dtype=torch.int32)
            ref = DA.decode_attention_plain(q, k, v, pos)
            for name, fn in (("old", run_old), ("new", run_new)):
                rel = cs.rel_err(fn(q, k, v, pos), ref)[1]
                if rel > cs.TOL:
                    raise AssertionError(f"{name} disagrees: rel {rel:.2e}")
            times = {"old": [], "new": []}
            for name in ("old", "new", "new", "old"):
                fn = run_old if name == "old" else run_new
                times[name].append(cs.device_ms(
                    lambda: fn(q, k, v, pos), 100, ("decode_kernel",)))
            keys = float((pos + 1).sum()) * hkv
            nbytes = 4.0 * (2 * q.numel() + 2 * keys * hd) + 4.0 * b
            bound, bound_by = cs.bound_ms(nbytes, 4.0 * keys * grp * hd)
            print(f"{what}: old {times['old'][0]:.4f} / "
                  f"{times['old'][1]:.4f} ms, new {times['new'][0]:.4f} / "
                  f"{times['new'][1]:.4f} ms on the device, bound "
                  f"{bound:.6f} ms ({bound_by}, {nbytes / 1e6:.1f} MB) "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
