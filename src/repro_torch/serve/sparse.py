"""Block-sparse linear layers over the training tile-mask layout (the port
of ``repro.serve.sparse``).

A serve layer is defined to compute ``x @ (w ⊙ expand(keep))`` [+ bias]:
dense-masked equivalence is the contract, sparsity only changes the cost.
A layer is a static ``plan`` (python ints and numpy) and an ``arrays``
dict of tensors.

  impl="gather"   the kept tiles as a (T, bk, bn) stack sorted stably by
                  output column, one batched product, and each output
                  tile summed over its column's products (padded to the
                  widest column: a sum over a fixed axis, no atomics, so
                  reruns are bitwise equal on the card).
  impl="cond"     a host loop over the tiles that skips each dropped one:
                  the definition spelled out, for debugging, not speed.
  impl="kernel"   ``ops.masked_matmul``: the block-sparse matmul kernel on
                  the card, which skips dropped tiles and their loads (its
                  plain version on the CPU).  The counterpart of the
                  reference's ``"pallas"``, and the default.
  impl="dense"    masked dense matmul: the oracle.

Every impl is differentiable in x and in its arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import block_sparse_matmul as _bsm
from repro_torch.kernels import ops

IMPLS = ("gather", "cond", "kernel", "dense")


def make_linear(w: torch.Tensor, keep, blocks: tuple[int, int],
                impl: str = "kernel", bias=None) -> tuple[dict, dict]:
    """Build (plan, arrays) for y = x @ (w ⊙ expand(keep)) [+ bias].

    w: (K, N); keep: (ceil(K/bk), ceil(N/bn)) 0/1, on w's device;
    blocks: (bk, bn).  ``keep=None`` means fully dense (unprunable layer).
    """
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
    arrays: dict = {}
    if impl in ("gather", "cond"):
        keep_np = keep.detach().cpu().numpy() > 0
        wp = torch.nn.functional.pad(wm, (0, tn * bn - n, 0, tk * bk - k))
    if impl == "gather":
        kk, nn = np.nonzero(keep_np)
        order = np.argsort(nn, kind="stable")       # group tiles by out col
        kk, nn = kk[order], nn[order]
        plan["t"] = int(kk.size)
        if kk.size:
            tiles = wp.reshape(tk, bk, tn, bn).transpose(1, 2)
            arrays["wt"] = tiles[torch.as_tensor(kk, device=w.device),
                                 torch.as_tensor(nn, device=w.device)]
            arrays["kk"] = torch.as_tensor(kk, device=w.device)
            arrays["cols"] = torch.as_tensor(_column_lists(nn, tn),
                                             device=w.device)
    elif impl == "cond":
        plan["keep"] = keep_np
        arrays["w"] = wp
    elif impl == "kernel":
        arrays["w"] = wm
        arrays["keep"] = keep.to(torch.int32).contiguous()
    else:                                           # dense
        arrays["w"] = wm
    if bias is not None:
        arrays["b"] = bias.to(torch.float32)
    return plan, arrays


def _column_lists(nn: np.ndarray, tn: int) -> np.ndarray:
    """(tn, widest column) indices into the column-sorted tile stack: output
    column j's tiles in order, padded with T (a zero product)."""
    t = nn.size
    counts = np.bincount(nn, minlength=tn)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    lists = np.full((tn, max(int(counts.max()), 1)), t, np.int64)
    for j in range(tn):
        lists[j, :counts[j]] = np.arange(starts[j], starts[j] + counts[j])
    return lists


def _apply_gather(plan: dict, arrays: dict, x2: torch.Tensor
                  ) -> torch.Tensor:
    m = x2.shape[0]
    k, n, bk, bn = plan["k"], plan["n"], plan["bk"], plan["bn"]
    tk, tn = plan["tk"], plan["tn"]
    if plan["t"] == 0:
        return x2.new_zeros((m, n))
    xt = torch.nn.functional.pad(x2, (0, tk * bk - k)).reshape(m, tk, bk)
    xg = xt[:, arrays["kk"]]                                  # (M, T, bk)
    prod = torch.einsum("mtk,tkn->mtn", xg, arrays["wt"])     # (M, T, bn)
    prod = torch.cat([prod, prod.new_zeros((m, 1, bn))], dim=1)
    y = torch.sum(prod[:, arrays["cols"]], dim=2)             # (M, tn, bn)
    return y.reshape(m, tn * bn)[:, :n]


def _apply_cond(plan: dict, arrays: dict, x2: torch.Tensor) -> torch.Tensor:
    m = x2.shape[0]
    k, n, bk, bn = plan["k"], plan["n"], plan["bk"], plan["bn"]
    xp = torch.nn.functional.pad(x2, (0, plan["tk"] * bk - k))
    w, keep = arrays["w"], plan["keep"]
    cols = []
    for tj in range(plan["tn"]):
        acc = x2.new_zeros((m, bn))
        for ti in range(plan["tk"]):
            if keep[ti, tj]:
                acc = acc + xp[:, ti * bk:(ti + 1) * bk] \
                    @ w[ti * bk:(ti + 1) * bk, tj * bn:(tj + 1) * bn]
        cols.append(acc)
    return torch.cat(cols, dim=1)[:, :n]


def apply_linear(plan: dict, arrays: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ (w ⊙ expand(keep)) [+ bias]; x: (..., K) -> (..., N), f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, plan["k"]).to(torch.float32)
    impl = plan["impl"]
    if impl == "gather":
        y = _apply_gather(plan, arrays, x2)
    elif impl == "cond":
        y = _apply_cond(plan, arrays, x2)
    elif impl == "kernel":
        y = ops.masked_matmul(x2, arrays["w"], arrays["keep"],
                              block_k=plan["bk"], block_n=plan["bn"])
    else:
        y = x2 @ arrays["w"]
    if "b" in arrays:
        y = y + arrays["b"]
    return y.reshape(*lead, plan["n"])
