"""Mixture-of-Experts FFN with top-k routing and sort-based dispatch (the
port of ``repro.models.moe``).

* A fixed expert capacity C = ceil(tokens * top_k / E * capacity_factor)
  (at least top_k) keeps every shape static; a routed token past its
  expert's C is dropped (it adds nothing to the output), Switch / GShard
  semantics.
* Dispatch sorts the N*k (token, choice) entries stably by expert, so an
  entry's place in its expert's queue is its sorted index less the
  expert's start.  Expert slot (e, c) reads the token of the entry at
  sorted index start_e + c when c < count_e, else a zero row: a gather
  from the N token rows (entry t*k + j is token t's), which takes each
  entry at most once.
* Combine gathers each entry's expert output back through the inverse
  permutation (entry -> slot) and sums a token's k weighted outputs over a
  fixed axis.  The one scatter-add is the dispatch gather's backward,
  which sums each token's up to k slot gradients (an ``index_put`` with
  accumulate).  Forward and backward repeat bit for bit on every run
  (``chip_smoke.py`` 16e reruns a full-width MoE backward on the card).
* Expert weights are stacked (E, d_in, d_ff); the router is float32 in a
  bfloat16 model, as in the reference.

The auxiliary load-balance loss is Switch Transformer's:
  aux = E * sum_e (fraction_tokens_e * mean_router_prob_e).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models import sharding as S


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden width
    capacity_factor: float = 1.25
    gated: bool = True
    act: str = "silu"


def init_moe(generator, d_model: int, spec: MoESpec, dtype) -> dict:
    """``router`` (float32), and stacked experts ``w_in`` / ``w_gate``
    (E, d_model, d_ff) and ``w_out`` (E, d_ff, d_model) in ``dtype``."""
    e, f = spec.num_experts, spec.d_ff
    p = {
        "router": L.dense_init(generator, d_model, e, torch.float32),
        "w_in": (L._normal(generator, (e, d_model, f))
                 * d_model ** -0.5).to(dtype),
        "w_out": (L._normal(generator, (e, f, d_model)) * f ** -0.5).to(dtype),
    }
    if spec.gated:
        p["w_gate"] = (L._normal(generator, (e, d_model, f))
                       * d_model ** -0.5).to(dtype)
    return p


def expert_capacity(num_tokens: int, spec: MoESpec) -> int:
    cap = int(num_tokens * spec.top_k * spec.capacity_factor
              / spec.num_experts + 0.999)
    return max(cap, spec.top_k)


def moe_ffn(p: dict, spec: MoESpec, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss).  The router
    sees x rounded to float32 (promoted with the router's own dtype)."""
    b, s, d = x.shape
    n = b * s
    e, k = spec.num_experts, spec.top_k
    cap = expert_capacity(n, spec)
    # DTensor cannot gather rows by data-dependent indices over a sharded
    # token dim: a sharded x is replicated, so the dispatch is global, as
    # the reference's is; the experts' products keep their weights' shards
    xf = S.replicate(x).reshape(n, d)
    dev = x.device

    w_router = p["router"]["w"]
    rdt = torch.promote_types(torch.float32, w_router.dtype)
    logits = xf.to(torch.float32).to(rdt) @ w_router.to(rdt)     # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, k, dim=-1)                 # (N, k)
    top_w = top_w / torch.clamp_min(torch.sum(top_w, -1, keepdim=True),
                                    1e-9)

    # ---- load balance aux (Switch) ----
    flat_exp = top_ids.reshape(n * k)                 # entry t*k + j
    experts = torch.arange(e, device=dev)
    hits = flat_exp[:, None] == experts               # (N*k, E)
    frac_tokens = torch.sum(hits.to(torch.float32), 0) / (n * k)
    aux = e * torch.sum(frac_tokens * torch.mean(probs, 0))

    # ---- sort-based dispatch ----
    order = torch.argsort(flat_exp, stable=True)      # sorted -> entry
    counts = torch.sum(hits.to(torch.int64), 0)
    starts = torch.cumsum(counts, 0) - counts
    queue = torch.arange(n * k, device=dev) - starts[flat_exp[order]]
    inv = torch.argsort(order)                        # entry -> sorted
    pos = queue[inv]                                  # entry's queue place
    keep = pos < cap
    # slot (e, c) <- the token of entry order[start_e + c] while c <
    # count_e; else the zero row n
    c = torch.arange(cap, device=dev)
    at = torch.clamp_max(starts[:, None] + c, n * k - 1)
    src = torch.where(c < counts[:, None], order[at] // k, n)    # (E, C)
    xe = torch.cat([xf, xf.new_zeros((1, d))])[src]              # (E, C, d)
    # each rank keeps its experts' slots (the gather's result is whole)
    xe = S.constrain(xe, "experts", None, None)

    # ---- expert FFN ----
    act_fn = L.ACTS[spec.act]
    h = xe @ p["w_in"].to(x.dtype)
    if "w_gate" in p:
        h = act_fn(xe @ p["w_gate"].to(x.dtype)) * h
    else:
        h = act_fn(h)
    ye = h @ p["w_out"].to(x.dtype)                              # (E, C, d)

    # ---- combine: gather each entry's output, sum over k ----
    slot = torch.where(keep, flat_exp * cap + pos, e * cap)
    ye_rows = torch.cat([S.view(ye, (e * cap, d)), ye.new_zeros((1, d))])
    wk = (top_w.reshape(n * k) * keep).to(ye.dtype)
    routed = ye_rows[slot] * wk[:, None]
    y = torch.sum(routed.reshape(n, k, d), 1)
    return S.view(y, (b, s, d)).to(x.dtype), aux
