"""Attention (the port of ``repro.models.attention``): grouped-query
attention, global, sliding-window or cross, and multi-head latent
attention (MLA), each with its parameters, its full-sequence forward and
its one-token decode; ``AttnSpec`` and ``MLASpec`` live in
``configs.base``.

Cache layouts (the reference's), in the compute dtype:
  * GQA ``{"k", "v"}`` of (B, S, Hkv, hd), keys stored after RoPE;
  * MLA's latent cache ``{"ckv": (B, S, kv_rank), "kpe": (B, S,
    rope_dim)}``;
  * a cross-attention block's static memory K/V (``cross_memory``).
A full cache writes position p at slot ``min(p, S - 1)``; a rolling cache
(a window of at least S) writes it at ``p % S``.  The position of the
token being decoded, ``pos`` (B,), travels beside the cache.

The forward mirrors the reference's numerics: q, k and v are cast to
float32 for the scores and the weighted sum, a mask enters as an additive
``NEG_INF`` bias before the softmax, and the output is cast back to the
activations' dtype before ``wo``.  Sequences of ``FLASH_THRESHOLD`` tokens
or more take ``flash_attention``, the reference's online-softmax double
loop over chunks, here as plain torch with a recomputing backward
(``_Flash``; the port's CUDA ``flash_prefill`` is forward-only, so
training does not use it).  On DTensors the attention runs on each
rank's local shards (``sharding.attention_local``,
``sharding.stripes_local``) and a decode cache's new entries go into
each rank's own rows and slots (``sharding.write_slots``).  Every function
is functional, so ``torch.func`` transforms it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import AttnSpec, MLASpec
from repro_torch.models import layers as L
from repro_torch.models import sharding as S

NEG_INF = -1e30

# sequences at/above this length route through flash_attention
FLASH_THRESHOLD = 2048


def init_gqa(generator, d_model: int, spec: AttnSpec, dtype) -> dict:
    make = L.dense_bias_init if spec.qkv_bias else L.dense_init
    return {
        "wq": make(generator, d_model, spec.num_heads * spec.head_dim, dtype),
        "wk": make(generator, d_model, spec.num_kv_heads * spec.head_dim,
                   dtype),
        "wv": make(generator, d_model, spec.num_kv_heads * spec.head_dim,
                   dtype),
        "wo": L.dense_init(generator, spec.num_heads * spec.head_dim,
                           d_model, dtype),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return S.split_heads(x, n)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float
                ) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,T,Hkv,hd) -> scores (B,S,H,T), float32."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, hd)
    scores = torch.einsum("bskgd,btkd->bskgt", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    return scores.reshape(b, s, h, k.shape[1])


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, s, h, t = probs.shape
    hkv = v.shape[2]
    pg = probs.reshape(b, s, hkv, h // hkv, t)
    out = torch.einsum("bskgt,btkd->bskgd", pg, v.to(torch.float32))
    return out.reshape(b, s, h, v.shape[-1])


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, 0.0, NEG_INF)


def _gqa_partial(q, k, v, mask, scale: float):
    """``attend`` on local shards, unnormalized: (acc, m, l) as
    ``sharding.attention_local`` takes them."""
    scores = _gqa_scores(q, k, scale)
    if mask is not None:
        scores = scores + _mask_bias(mask)
    m = torch.amax(scores, dim=-1)
    p = torch.exp(scores - m[..., None])
    return _gqa_out(p, v), m, torch.sum(p, dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Masked GQA attention; ``mask`` broadcasts to (B,S,H,T).  DTensor
    inputs go through ``sharding.attention_local``: each rank attends its
    own batch rows and kv heads or key slice, as ``shard_map`` would
    (DTensor's own propagation cannot flatten the einsums' (batch, head)
    dims with the head dim sharded, and would gather the rest)."""
    if any(isinstance(x, DTensor) for x in (q, k, v, mask)):
        return S.attention_local(
            lambda q, k, v, mask: _gqa_partial(q, k, v, mask, scale),
            (q,), (k, v), mask)
    scores = _gqa_scores(q, k, scale)
    if mask is not None:
        scores = scores + _mask_bias(mask)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v)


def causal_window_mask(s: int, t: int, offset: int, window: Optional[int],
                       device=None) -> torch.Tensor:
    """(1, S, 1, T) mask: query i (absolute offset+i) sees key j iff
    j <= offset+i and (no window or j > offset+i-window)."""
    qpos = offset + torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m[None, :, None, :]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True,
                    window: Optional[int] = None, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """GQA attention as a double loop (query chunks x key chunks) with an
    online softmax: no (S x T) score tensor is formed.  q: (B,S,H,hd),
    k/v: (B,T,Hkv,hd); self-attention positions (query i at i, keys at
    0..T-1).  A chunk size that does not divide S is halved until it
    does; a ragged T is padded to a chunk multiple and the padding
    masked.  The backward (``_Flash``) keeps q, k, v, the output and the
    log-sum-exp of each query and recomputes each chunk pair's
    probabilities, as the reference's ``jax.checkpoint``s of its query
    body and key step do: the memory stays O(S).

    Context parallelism: the query sequence splits into P contiguous
    stripes, P = ``axis_size("q_stripes")`` (1 without sharding rules),
    constrained over the "q_stripes" logical dim, so the tensor dim does
    attention work even where head counts do not divide it.  Each step
    of the query loop advances every stripe one chunk; the keys and
    values are read by every stripe."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    g = h // hkv
    p_stripes = S.axis_size("q_stripes")
    if p_stripes > 1 and s % p_stripes == 0 and s >= 2 * p_stripes:
        q_chunk = min(q_chunk, s // p_stripes)   # chunks that fit P stripes
    else:
        p_stripes = 1
    stripe = s // p_stripes
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    while stripe % q_chunk:
        q_chunk //= 2
    t_valid = t
    if t % kv_chunk:
        pad = kv_chunk - t % kv_chunk
        k = S.pad(k, (0, 0, 0, 0, 0, pad))
        v = S.pad(v, (0, 0, 0, 0, 0, pad))
        t += pad
    nq, nk = stripe // q_chunk, t // kv_chunk
    # (B, P, nq, qc, Hkv, G, hd): the query loop runs over nq
    qc = S.view(q, (b, p_stripes, nq, q_chunk, hkv, g, hd)).to(torch.float32)
    kc = S.view(k, (b, nk, kv_chunk, hkv, hd)).to(torch.float32)
    vc = S.view(v, (b, nk, kv_chunk, hkv, vd)).to(torch.float32)
    qc = S.constrain(qc, "batch", "q_stripes", None, None, "kv", None, None)
    kc = S.constrain(kc, "batch", None, None, "kv", None)
    vc = S.constrain(vc, "batch", None, None, "kv", None)
    plan = _FlashPlan(scale, causal, window, q_chunk, kv_chunk, t_valid)
    out = S.stripes_local(
        lambda qc, kc, vc, stripes: _Flash.apply(qc, kc, vc,
                                                 stripes * stripe, plan)[0],
        qc, kc, vc)
    # (B, P, nq, qc, Hkv, G, vd) -> (B, S, H, vd)
    return S.view(out, (b, s, h, vd))


@dataclasses.dataclass(frozen=True)
class _FlashPlan:
    scale: float
    causal: bool
    window: Optional[int]
    q_chunk: int
    kv_chunk: int
    t_valid: int

    def scores(self, q_blk, k_blk, stripe_base, qi: int, kj: int
               ) -> torch.Tensor:
        """Chunk pair (qi, kj)'s scaled scores (B, P, qc, Hkv, G, kc) for
        stripes starting at ``stripe_base`` (P,), masked to ``NEG_INF``:
        padded keys, and keys the causal order or the window hides."""
        dev = q_blk.device
        p_stripes = q_blk.shape[1]
        qpos = stripe_base[:, None] + qi * self.q_chunk \
            + torch.arange(self.q_chunk, device=dev)
        kpos = kj * self.kv_chunk + torch.arange(self.kv_chunk, device=dev)
        valid = (kpos < self.t_valid)[None, None, :].expand(
            p_stripes, self.q_chunk, self.kv_chunk)
        if self.causal:
            valid = valid & (kpos[None, None, :] <= qpos[..., None])
        if self.window is not None:
            valid = valid & (kpos[None, None, :]
                             > qpos[..., None] - self.window)
        scores = torch.einsum("bpqkgd,btkd->bpqkgt", q_blk, k_blk) \
            * self.scale
        return torch.where(valid[None, :, :, None, None, :], scores,
                           NEG_INF)


class _Flash(torch.autograd.Function):
    """The chunked online softmax of ``flash_attention`` on the chunked
    float32 q (B, P, nq, qc, Hkv, G, hd), k and v (B, nk, kc, Hkv, d), the
    P stripes starting at positions ``stripe_base`` (P,).
    The backward is flash attention's: it keeps q, k, v, the output and
    each query's log-sum-exp, and recomputes each chunk pair's
    probabilities from them, so no (S x T) tensor lives at once (the
    reference's ``jax.checkpoint`` of its query body and key step gives
    the same recompute; nested non-reentrant checkpoints here would keep
    each region's inputs alive for an enclosing block checkpoint).  It
    runs on plain tensors (a sharded step's local shards,
    ``sharding.stripes_local``); ``torch.func`` transforms it (a
    generated vmap rule).  Returns (out, lse), the log-sum-exp not
    differentiable."""

    generate_vmap_rule = True

    @staticmethod
    def forward(qc, kc, vc, stripe_base, plan):
        pv = "bpqkgt,btkd->bpqkgd"
        outs, lses = [], []
        for qi in range(qc.shape[2]):
            q_blk = qc[:, :, qi]
            for kj in range(kc.shape[1]):
                scores = plan.scores(q_blk, kc[:, kj], stripe_base, qi, kj)
                m_blk = torch.amax(scores, dim=-1)
                if kj == 0:
                    # what a start from (NEG_INF, 0, 0) gives
                    m = m_blk
                    p = torch.exp(scores - m[..., None])
                    l = torch.sum(p, dim=-1)
                    acc = torch.einsum(pv, p, vc[:, kj])
                    continue
                m_new = torch.maximum(m, m_blk)
                p = torch.exp(scores - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + torch.sum(p, dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(pv, p, vc[:, kj])
                m = m_new
            l = torch.clamp_min(l, 1e-30)
            outs.append(acc / l[..., None])
            lses.append(m + torch.log(l))
        return torch.stack(outs, dim=2), torch.stack(lses, dim=2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        qc, kc, vc, stripe_base, ctx.plan = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(qc, kc, vc, stripe_base, *output)

    @staticmethod
    def backward(ctx, dout, _):
        qc, kc, vc, stripe_base, out, lse = ctx.saved_tensors
        plan = ctx.plan
        delta = torch.sum(dout * out, dim=-1)          # (B, P, nq, qc, ...)
        dq, dk, dv = [], [None] * kc.shape[1], [None] * kc.shape[1]
        for qi in range(qc.shape[2]):
            q_blk, do = qc[:, :, qi], dout[:, :, qi]
            dq_i = None
            for kj in range(kc.shape[1]):
                p = torch.exp(plan.scores(q_blk, kc[:, kj], stripe_base,
                                          qi, kj)
                              - lse[:, :, qi][..., None])
                dv_j = torch.einsum("bpqkgt,bpqkgd->btkd", p, do)
                dp = torch.einsum("bpqkgd,btkd->bpqkgt", do, vc[:, kj])
                ds = p * (dp - delta[:, :, qi][..., None]) * plan.scale
                dq_ij = torch.einsum("bpqkgt,btkd->bpqkgd", ds, kc[:, kj])
                dk_j = torch.einsum("bpqkgt,bpqkgd->btkd", ds, q_blk)
                dq_i = dq_ij if dq_i is None else dq_i + dq_ij
                dk[kj] = dk_j if dk[kj] is None else dk[kj] + dk_j
                dv[kj] = dv_j if dv[kj] is None else dv[kj] + dv_j
            dq.append(dq_i)
        return (torch.stack(dq, dim=2), torch.stack(dk, dim=1),
                torch.stack(dv, dim=1), None, None)


def gqa_forward(p: dict, spec: AttnSpec, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (training / prefill); x: (B, S, d).
    ``kv_x`` (B, T, d) is the keys' and values' source for cross attention
    (no RoPE, no mask); None: x itself.  Cross attention takes the flash
    path, non-causal, once S * T reaches ``FLASH_THRESHOLD ** 2``."""
    b, s, _ = x.shape
    src = x if kv_x is None else kv_x
    q = _split_heads(L.dense(p["wq"], x), spec.num_heads)
    k = _split_heads(L.dense(p["wk"], src), spec.num_kv_heads)
    v = _split_heads(L.dense(p["wv"], src), spec.num_kv_heads)
    q = S.constrain(q, "batch", "seq", "heads", None)
    k = S.constrain(k, "batch", "seq", "kv", None)
    v = S.constrain(v, "batch", "seq", "kv", None)
    if spec.use_rope and kv_x is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        q = L.apply_rope(q, positions, spec.rope_theta)
        k = L.apply_rope(k, positions, spec.rope_theta)
    if kv_x is None and s >= FLASH_THRESHOLD:
        out = flash_attention(q, k, v, spec.scale, causal=spec.causal,
                              window=spec.window)
    elif kv_x is not None and s * src.shape[1] >= FLASH_THRESHOLD ** 2:
        out = flash_attention(q, k, v, spec.scale, causal=False, window=None)
    else:
        mask = (causal_window_mask(s, s, 0, spec.window, x.device)
                if spec.causal and kv_x is None else None)
        out = attend(q, k, v, mask, spec.scale)
    return L.dense(p["wo"], S.merge_heads(out).to(x.dtype))


def init_gqa_cache(spec: AttnSpec, batch: int, cache_len: int, dtype,
                   device=None) -> dict:
    shape = (batch, cache_len, spec.num_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _slot(pos: torch.Tensor, cache_len: int, rolling: bool) -> torch.Tensor:
    """The cache slot of position ``pos``: ``pos % cache_len`` in a
    rolling cache, else ``min(pos, cache_len - 1)``."""
    return (pos % cache_len if rolling
            else torch.clamp_max(pos, cache_len - 1)).long()


def _valid_keys(pos: torch.Tensor, cache_len: int, rolling: bool,
                window: Optional[int]) -> torch.Tensor:
    """(B, T): the cache slots the token at ``pos`` attends to."""
    kpos = torch.arange(cache_len, device=pos.device)[None, :]
    if rolling:
        return kpos < torch.clamp_max(pos + 1, cache_len)[:, None]
    valid = kpos <= pos[:, None]
    if window is not None:
        valid = valid & (kpos > pos[:, None] - window)
    return valid


def gqa_decode(p: dict, spec: AttnSpec, x: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token decode; x: (B, 1, d), pos: (B,) the absolute position of
    x.  Returns ``(y (B, 1, d), new cache)``; the caller's cache is not
    written.  A full cache's last slot is overwritten once ``pos`` reaches
    its length (the reference's clamp); a rolling cache (``spec.window``
    at least its length) holds the last ``cache_len`` positions.  A
    DTensor cache is written and read on each rank's own rows and slots
    (``sharding.write_slots``, ``attend``) and keeps its placements."""
    cache_len = cache["k"].shape[1]
    q = _split_heads(L.dense(p["wq"], x), spec.num_heads)
    k = _split_heads(L.dense(p["wk"], x), spec.num_kv_heads)
    v = _split_heads(L.dense(p["wv"], x), spec.num_kv_heads)
    if spec.use_rope:
        q = L.apply_rope(q, pos[:, None], spec.rope_theta)
        k = L.apply_rope(k, pos[:, None], spec.rope_theta)

    rolling = spec.window is not None and cache_len <= spec.window
    slot = _slot(pos, cache_len, rolling)
    new_k = S.write_slots(cache["k"], k[:, 0], slot)
    new_v = S.write_slots(cache["v"], v[:, 0], slot)
    valid = _valid_keys(pos, cache_len, rolling, spec.window)
    out = attend(q, new_k, new_v, valid[:, None, None, :], spec.scale)
    y = L.dense(p["wo"], S.merge_heads(out).to(x.dtype))
    return y, {"k": new_k, "v": new_v}


def cross_decode(p: dict, spec: AttnSpec, x: torch.Tensor,
                 memory_k: torch.Tensor, memory_v: torch.Tensor
                 ) -> torch.Tensor:
    """One-token cross attention against the precomputed memory K/V
    (DTensor caches read on each rank's own rows, through ``attend``)."""
    q = _split_heads(L.dense(p["wq"], x), spec.num_heads)
    out = attend(q, memory_k, memory_v, None, spec.scale)
    return L.dense(p["wo"], S.merge_heads(out).to(x.dtype))


def cross_memory(p: dict, spec: AttnSpec, memory: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V (B, T, Hkv, hd) of encoder or vision memory."""
    k = _split_heads(L.dense(p["wk"], memory), spec.num_kv_heads)
    v = _split_heads(L.dense(p["wv"], memory), spec.num_kv_heads)
    return k, v


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

def init_mla(generator, d_model: int, spec: MLASpec, dtype) -> dict:
    h, qr, kvr = spec.num_heads, spec.q_lora_rank, spec.kv_lora_rank
    qd = spec.nope_dim + spec.rope_dim
    dev = L.device_of(generator)
    return {
        "wq_down": L.dense_init(generator, d_model, qr, dtype),
        "q_norm": L.norm_init(qr, dtype, device=dev),
        "wq_up": L.dense_init(generator, qr, h * qd, dtype),
        "wkv_down": L.dense_init(generator, d_model, kvr, dtype),
        "kv_norm": L.norm_init(kvr, dtype, device=dev),
        "wk_pe": L.dense_init(generator, d_model, spec.rope_dim, dtype),
        "wk_up": L.dense_init(generator, kvr, h * spec.nope_dim, dtype),
        "wv_up": L.dense_init(generator, kvr, h * spec.v_head_dim, dtype),
        "wo": L.dense_init(generator, h * spec.v_head_dim, d_model, dtype),
    }


def _mla_qkv(p: dict, spec: MLASpec, x: torch.Tensor,
             positions: torch.Tensor):
    """The shared projections: (q_nope, q_pe, ckv, k_pe)."""
    b, s, _ = x.shape
    q = L.dense(p["wq_up"], L.rms_norm(p["q_norm"], L.dense(p["wq_down"], x)))
    q = _split_heads(q, spec.num_heads)
    q_nope, q_pe = q[..., :spec.nope_dim], q[..., spec.nope_dim:]
    q_pe = L.apply_rope(q_pe, positions, spec.rope_theta)
    ckv = L.rms_norm(p["kv_norm"], L.dense(p["wkv_down"], x))   # (B,S,kvr)
    k_pe = L.dense(p["wk_pe"], x)[:, :, None, :]                # (B,S,1,rope)
    k_pe = L.apply_rope(k_pe, positions, spec.rope_theta)[:, :, 0, :]
    return q_nope, q_pe, ckv, k_pe


def mla_forward(p: dict, spec: MLASpec, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / prefill MLA in the expanded form (per-head keys and
    values); ``flash_attention`` at ``FLASH_THRESHOLD`` tokens or more."""
    b, s, _ = x.shape
    h = spec.num_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q_nope, q_pe, ckv, k_pe = _mla_qkv(p, spec, x, positions)
    k_nope = _split_heads(L.dense(p["wk_up"], ckv), h)
    v = _split_heads(L.dense(p["wv_up"], ckv), h)
    if s >= FLASH_THRESHOLD:
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(
            b, s, h, spec.rope_dim)], dim=-1)
        out = flash_attention(q_full, k_full, v, spec.scale, causal=True,
                              window=spec.window)
    else:
        f32 = torch.float32
        scores = (torch.einsum("bshd,bthd->bsht", q_nope.to(f32),
                               k_nope.to(f32))
                  + torch.einsum("bshd,btd->bsht", q_pe.to(f32),
                                 k_pe.to(f32))) * spec.scale
        mask = causal_window_mask(s, s, 0, spec.window, x.device)
        probs = torch.softmax(scores + _mask_bias(mask), dim=-1)
        out = torch.einsum("bsht,bthd->bshd", probs, v.to(f32))
    return L.dense(p["wo"], S.merge_heads(out).to(x.dtype))


def init_mla_cache(spec: MLASpec, batch: int, cache_len: int, dtype,
                   device=None) -> dict:
    return {"ckv": torch.zeros((batch, cache_len, spec.kv_lora_rank),
                               dtype=dtype, device=device),
            "kpe": torch.zeros((batch, cache_len, spec.rope_dim),
                               dtype=dtype, device=device)}


def mla_decode(p: dict, spec: MLASpec, x: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token MLA decode in the absorbed form: only the latent
    ``(ckv, kpe)`` cache is read; ``W_uk`` folds into the query and
    ``W_uv`` into the output, so a step costs O(S (kv_rank + rope_dim))
    a head.  Slots as in ``gqa_decode``; the given cache is not
    written.  A DTensor cache is written and read on each rank's own rows
    and slots (``sharding.write_slots``, ``sharding.attention_local``)
    and keeps its placements."""
    h = spec.num_heads
    f32 = torch.float32
    cache_len = cache["ckv"].shape[1]
    q_nope, q_pe, ckv_new, kpe_new = _mla_qkv(p, spec, x, pos[:, None])
    # absorb W_uk: q_lat[h, kvr] = q_nope[h, nope] @ W_uk[kvr, h*nope]^T
    wk = _split_heads(p["wk_up"]["w"], h)              # (kvr, h, nope)
    q_lat = torch.einsum("bshd,khd->bshk", q_nope.to(f32), wk.to(f32))

    rolling = spec.window is not None and cache_len <= spec.window
    slot = _slot(pos, cache_len, rolling)
    ckv = S.write_slots(cache["ckv"], ckv_new[:, 0], slot)
    kpe = S.write_slots(cache["kpe"], kpe_new[:, 0], slot)
    valid = _valid_keys(pos, cache_len, rolling, spec.window)

    def scores_of(q_lat, q_pe, ckv, kpe, mask):
        scores = (torch.einsum("bshk,btk->bsht", q_lat, ckv.to(f32))
                  + torch.einsum("bshd,btd->bsht", q_pe.to(f32),
                                 kpe.to(f32))) * spec.scale
        return scores + _mask_bias(mask)

    mask = valid[:, None, None, :]
    if any(isinstance(t, DTensor) for t in (q_lat, q_pe, ckv, kpe, mask)):
        def partial(q_lat, q_pe, ckv, kpe, mask):
            scores = scores_of(q_lat, q_pe, ckv, kpe, mask)
            m = torch.amax(scores, dim=-1)
            p = torch.exp(scores - m[..., None])
            return (torch.einsum("bsht,btk->bshk", p, ckv.to(f32)), m,
                    torch.sum(p, dim=-1))
        out_lat = S.attention_local(partial, (q_lat, q_pe), (ckv, kpe),
                                    mask, kv_heads=False)
    else:
        probs = torch.softmax(scores_of(q_lat, q_pe, ckv, kpe, mask), dim=-1)
        out_lat = torch.einsum("bsht,btk->bshk", probs, ckv.to(f32))
    # absorb W_uv: out[h, vd] = out_lat[h, kvr] @ W_uv[kvr, h*vd]
    wv = _split_heads(p["wv_up"]["w"], h)              # (kvr, h, vd)
    out = torch.einsum("bshk,khd->bshd", out_lat, wv.to(f32))
    y = L.dense(p["wo"], S.merge_heads(out).to(x.dtype))
    return y, {"ckv": ckv, "kpe": kpe}
