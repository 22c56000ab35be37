"""Block-sparse linear layers over the training tile-mask layout (the port
of ``repro.serve.sparse``).

A serve layer is defined to compute ``x @ (w ⊙ expand(keep))`` [+ bias]:
dense-masked equivalence is the contract, sparsity only changes the cost.
A layer is a static ``plan`` (python ints) and an ``arrays`` dict of
tensors.

  impl="kernel"   ``ops.masked_matmul``: the block-sparse matmul kernel on
                  the card, which skips dropped tiles and their loads (its
                  plain version on the CPU).  The counterpart of the
                  reference's ``"pallas"``, and the default.
  impl="dense"    masked dense matmul: the oracle.

The reference's ``"gather"`` and ``"cond"`` impls are not ported yet
(ROADMAP.md Queue A, item 9).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import block_sparse_matmul as _bsm
from repro_torch.kernels import ops

IMPLS = ("kernel", "dense")
_NOT_PORTED = ("gather", "cond")


def make_linear(w: torch.Tensor, keep, blocks: tuple[int, int],
                impl: str = "kernel", bias=None) -> tuple[dict, dict]:
    """Build (plan, arrays) for y = x @ (w ⊙ expand(keep)) [+ bias].

    w: (K, N); keep: (ceil(K/bk), ceil(N/bn)) 0/1, on w's device;
    blocks: (bk, bn).  ``keep=None`` means fully dense (unprunable layer).
    """
    if impl in _NOT_PORTED:
        raise NotImplementedError(
            f"impl {impl!r} is not ported yet: ROADMAP.md Queue A, item 9")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    k, n = w.shape
    bk, bn = blocks
    tk, tn = -(-k // bk), -(-n // bn)
    if keep is None:
        keep = torch.ones((tk, tn), dtype=torch.float32, device=w.device)
    if tuple(keep.shape) != (tk, tn):
        raise ValueError(f"keep shape {tuple(keep.shape)} != tile grid "
                         f"({tk}, {tn}) for w {tuple(w.shape)} blocks "
                         f"{tuple(blocks)}")
    wm = torch.where(_bsm.expand_mask(keep, (k, n), bk, bn),
                     w.to(torch.float32), 0.0).contiguous()
    plan = {"impl": impl, "k": k, "n": n, "bk": bk, "bn": bn,
            "tk": tk, "tn": tn}
    arrays: dict = {"w": wm}
    if impl == "kernel":
        arrays["keep"] = keep.to(torch.int32).contiguous()
    if bias is not None:
        arrays["b"] = bias.to(torch.float32)
    return plan, arrays


def apply_linear(plan: dict, arrays: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ (w ⊙ expand(keep)) [+ bias]; x: (..., K) -> (..., N), f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, plan["k"]).to(torch.float32)
    if plan["impl"] == "kernel":
        y = ops.masked_matmul(x2, arrays["w"], arrays["keep"],
                              block_k=plan["bk"], block_n=plan["bn"])
    else:
        y = x2 @ arrays["w"]
    if "b" in arrays:
        y = y + arrays["b"]
    return y.reshape(*lead, plan["n"])
