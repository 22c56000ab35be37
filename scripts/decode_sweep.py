#!/usr/bin/env python3
"""Decode attention's tuning constants, swept on one NVIDIA card.

    python3 scripts/decode_sweep.py [--variant kWarps=2,kSpan=256 ...]
                                    [--long B,S,HKV,G ...]

Builds copies of ``csrc/decode_attention.cu`` into a temporary directory,
each with some of its compile-time constants (``kWarps``, ``kSpan``)
replaced, all with one nvcc each at once; checks each
against ``decode_attention_plain`` (rel 1e-4) and prints its
torch.profiler device time per launch at smollm-135m's serving shape
(B = 32, S = 128, pos < 63, G = 3, hd = 64) and at long caches (pos
uniform in [S / 2, S - 1]; by default B = 32, S = 2048, Hkv = 3, G = 3),
on the same inputs for every variant, with the card's name and power
limit.  For each long cache it also prints SDPA's device time and that
of reading the whole of k and v once (``k.sum() + v.sum()``), as
yardsticks.  The source in ``csrc`` is not changed; the first variant is
it as it stands.
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

DEFAULT = ["kWarps=2", "kSpan=512", "kSpan=2048", "kWarps=2,kSpan=512"]


def variant_source(src: str, spec: str) -> str:
    for item in filter(None, spec.split(",")):
        name, value = item.split("=")
        pat = re.compile(rf"\b{name} = \d+(?=[,;])")
        if len(pat.findall(src)) != 1:
            raise RuntimeError(f"no single constant {name} in the source")
        src = pat.sub(f"{name} = {int(value)}", src)
    return src


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append",
                    help="constants to replace, e.g. kWarps=2,kSpan=256")
    ap.add_argument("--long", action="append",
                    help="a long cache B,S,HKV,G (hd = 64)")
    args = ap.parse_args()
    variants = [""] + (args.variant or DEFAULT)
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    src = (build.CSRC / "decode_attention.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, spec in enumerate(variants):
            cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"libv{i}.so"
            cu.write_text(variant_source(src, spec))
            procs.append((subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                so))
        libs = []
        for (proc, so), spec in zip(procs, variants):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {spec!r}:\n{out}")
            lib = ctypes.CDLL(str(so))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            libs.append(lib)

        g = torch.Generator(device="cuda").manual_seed(51)
        b, hkv, grp, hd = (cs.SERVE_BATCH, cs.SERVE_KV, cs.SERVE_GROUP,
                           cs.SERVE_HD)
        cases = [(b, 128, hkv, grp, 0, cs.SERVE_PROMPT + cs.SERVE_NEW - 1)]
        for spec in args.long or ["32,2048,3,3"]:
            lb, ls, lh, lg = map(int, spec.split(","))
            cases.append((lb, ls, lh, lg, ls // 2, ls))
        shapes = []
        for cb, s, ch, cg, lo, hi in cases:
            shapes.append((
                torch.randn(cb, ch * cg, hd, generator=g, device="cuda"),
                torch.randn(cb, s, ch, hd, generator=g, device="cuda"),
                torch.randn(cb, s, ch, hd, generator=g, device="cuda"),
                torch.randint(lo, hi, (cb,), generator=g, device="cuda",
                              dtype=torch.int32)))
        refs = [DA.decode_attention_plain(*x) for x in shapes]
        for (cb, s, ch, cg, _, _), (q, k, v, pos) in zip(cases[1:],
                                                          shapes[1:]):
            valid = (torch.arange(s, device="cuda")[None, :]
                     <= pos[:, None])[:, None, None, :]
            qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            lib = cs.device_ms(lambda: cs.sdpa(qs, ks, vs, valid), 20)
            read = cs.device_ms(lambda: k.sum() + v.sum(), 20)
            nbytes = 4.0 * 2 * float((pos + 1).sum()) * ch * hd
            print(f"long cache B={cb} S={s} Hkv={ch} G={cg}: "
                  f"{nbytes / 1e6:.1f} MB valid K/V, bound "
                  f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms; sdpa "
                  f"{lib:.4f} ms; k.sum() + v.sum() ({2 * k.numel() * 4 / 1e6:.0f}"
                  f" MB) {read:.4f} ms [{card}]", flush=True)
        for spec, lib in zip(variants, libs):
            build._loaded["decode_attention"] = lib   # the wrapper's library
            ms = []
            for x, ref in zip(shapes, refs):
                rel = cs.rel_err(DA.decode_attention(*x), ref)[1]
                if rel > cs.TOL:
                    raise AssertionError(f"{spec!r} disagrees: rel {rel:.2e}")
                ms.append(cs.device_ms(lambda: DA.decode_attention(*x), 100,
                                       ("decode_kernel",)))
            print(f"{spec or 'as in csrc':28s} serving {ms[0]:.4f} ms, "
                  f"long {', '.join(f'{t:.4f}' for t in ms[1:])} ms "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
