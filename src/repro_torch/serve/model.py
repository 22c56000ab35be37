"""Block-sparse transformer for serving pruned checkpoints (the port of
``repro.serve.model``).

Takes a ``PrunedBundle`` (params + tile keeps) and builds a decode /
prefill model whose every weight matrix, the tied unembedding included, is
a ``sparse.make_linear`` layer over the tile grid the keeps were computed
on.  The contract is dense-masked equivalence: outputs match the dense
model on ``bundle.masked_params()`` up to float reassociation, while the
kernels skip the dropped tiles.  Stacked qkv biases are 2-D, (repeats,
d), so pruning gives them tile keeps too: they are served masked, as the
dense oracle sees them (the reference serves them unmasked, which departs
from its own oracle once a bias tile is dropped).  Stacked norm scales
get keeps the same way and are served unmasked, as the reference serves
them: they equal the oracle's wherever no norm tile is dropped, which
holds unless the repeats do not divide into whole tiles (ROADMAP.md
Queue C).

Layers are unrolled at build time (the stacked ``repeats`` dim of the
training layout is sliced per layer).  A KV head whose ``wv`` columns are
all pruned (no qkv bias), or whose whole query group's ``wo`` rows are,
adds exactly zero to the residual: its ``head_mask`` entry is 0 and the
attention kernels skip it, cache reads included.

Scope: llama-family decoders (pre-norm attn + MLP blocks, global causal
GQA).  Everything computes in float32 on ``device``: the card unless
``"cpu"`` is passed, where every kernel runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pruning
from repro_torch.device import resolve_device
from repro_torch.kernels import block_sparse_matmul as _bsm
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.serve import sparse


def _validate(cfg) -> None:
    if cfg.encoder_layers or cfg.num_memory_tokens:
        raise NotImplementedError("serve: encoder/memory models unsupported")
    for stage in cfg.stages:
        for spec in stage.blocks:
            if spec.kind != "attn":
                raise NotImplementedError(
                    f"serve: block kind {spec.kind!r} unsupported "
                    "(llama-family attn blocks only)")
            if spec.ffn not in ("mlp", "none", None):
                raise NotImplementedError(
                    f"serve: ffn kind {spec.ffn!r} unsupported")
    aspec = cfg.attn_spec("attn")
    if aspec.window is not None:
        raise NotImplementedError("serve: windowed attention unsupported")
    if aspec.softmax_scale is not None \
            and aspec.softmax_scale != aspec.head_dim ** -0.5:
        raise NotImplementedError("serve: custom softmax scale unsupported")


def _tile_live(keep: np.ndarray, block: int, axis: int, span: int,
               count: int) -> np.ndarray:
    """Per-head liveness: head h is live iff any kept tile intersects its
    [h*span, (h+1)*span) slice of the given axis of the tile grid."""
    kp = np.asarray(keep) > 0
    live = np.zeros(count, bool)
    for h in range(count):
        lo, hi = h * span, (h + 1) * span
        t_lo, t_hi = lo // block, -(-hi // block)
        sub = kp[:, t_lo:t_hi] if axis == 1 else kp[t_lo:t_hi, :]
        live[h] = bool(sub.any())
    return live


class SparseModel:
    """Unrolled block-sparse decoder over a ``PrunedBundle``.

    Static structure (tile plans, head masks) lives in ``self.layers``;
    device tensors live in ``self.arrays``.
    """

    def __init__(self, cfg, bundle, impl: str = "kernel", device=None):
        _validate(cfg)
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)
        self.aspec = cfg.attn_spec("attn")
        params, keeps, grid = bundle.params, bundle.keeps, bundle.grid
        leaves = pruning.flatten(params)
        idx = pruning.unflatten(params, list(range(len(leaves))))
        keeps_np = [None if k is None else k.detach().cpu().numpy()
                    for k in keeps]
        dev = self.device

        def leaf(i, r=None):
            """Flat leaf ``i`` as float32 on the device, optionally sliced
            at stacked layer ``r``."""
            t = leaves[i] if r is None else leaves[i][r]
            return t.to(device=dev, dtype=torch.float32)

        def masked_bias(i, r):
            """A stacked bias leaf, (repeats, d), at layer ``r``, masked by
            its keeps: pruning ranks it as a (repeats, d) matrix, and the
            dense oracle sees it masked."""
            t = leaf(i)
            if keeps[i] is not None:
                t = torch.where(_bsm.expand_mask(keeps[i].to(dev), t.shape,
                                                 *grid[i]), t, 0.0)
            return t[r]

        def keep(i, r=None):
            k = keeps[i]
            if k is None:
                return None
            return (k if r is None else k[r]).to(dev)

        def lin(pnode, inode, r=None):
            i = inode["w"]
            w, blk = leaf(i, r), grid[i]
            bias = masked_bias(inode["b"], r) if "b" in pnode else None
            if blk is None:
                blk = (w.shape[0], w.shape[1])
            return sparse.make_linear(w, keep(i, r), blk, impl=impl,
                                      bias=bias)

        def norm(pnode, inode, r=None):
            return {key: leaf(inode[key], r) for key in pnode}

        arrays: dict = {"layers": []}
        self.layers: list[dict] = []
        sp = self.aspec
        hkv, hd = sp.num_kv_heads, sp.head_dim
        g = sp.num_heads // hkv
        for si, stage in enumerate(cfg.stages):
            for r in range(stage.repeats):
                for bi, _ in enumerate(stage.blocks):
                    pn = params["stages"][si][f"b{bi}"]
                    ix = idx["stages"][si][f"b{bi}"]
                    plan: dict = {"has_ffn": "ffn" in pn}
                    la: dict = {"norm_mix": norm(pn["norm_mix"],
                                                 ix["norm_mix"], r)}
                    for nm in ("wq", "wk", "wv", "wo"):
                        plan[nm], la[nm] = lin(pn["attn"][nm],
                                               ix["attn"][nm], r)
                    plan["head_mask"] = self._head_mask(
                        keeps_np, grid, ix["attn"], r, hkv, hd, g)
                    la["head_mask"] = torch.as_tensor(plan["head_mask"],
                                                      device=dev)
                    if plan["has_ffn"]:
                        la["norm_ffn"] = norm(pn["norm_ffn"],
                                              ix["norm_ffn"], r)
                        for nm in pn["ffn"]:
                            plan[nm], la[nm] = lin(pn["ffn"][nm],
                                                   ix["ffn"][nm], r)
                        plan["gated"] = "w_gate" in pn["ffn"]
                    self.layers.append(plan)
                    arrays["layers"].append(la)

        # embedding (masked: the dense oracle sees masked params
        # everywhere), final norm, unembedding
        ie = idx["embed"]["embedding"]
        e_leaf, e_keep, e_blk = leaf(ie), keep(ie), grid[ie]
        if e_keep is not None:
            e_leaf = torch.where(
                _bsm.expand_mask(e_keep, e_leaf.shape, *e_blk), e_leaf, 0.0)
        arrays["embed"] = e_leaf
        arrays["final_norm"] = norm(params["final_norm"], idx["final_norm"])
        if cfg.tie_embeddings:
            ub_keep = None if e_keep is None else e_keep.T
            ub_blk = (e_blk[1], e_blk[0]) if e_blk is not None \
                else (e_leaf.shape[1], e_leaf.shape[0])
            self.unembed, arrays["unembed"] = sparse.make_linear(
                e_leaf.T, ub_keep, ub_blk, impl=impl)
        else:
            self.unembed, arrays["unembed"] = lin(params["unembed"],
                                                  idx["unembed"])
        self.arrays = arrays

    # -- head liveness ----------------------------------------------------

    def _head_mask(self, keeps, grid, ix_attn, r, hkv, hd, g) -> np.ndarray:
        live = np.ones(hkv, bool)
        k_wo, b_wo = keeps[ix_attn["wo"]["w"]], grid[ix_attn["wo"]["w"]]
        if k_wo is not None:
            # wo rows of KV head h's query group: [h*g*hd, (h+1)*g*hd)
            live &= _tile_live(k_wo[r], b_wo[0], 0, g * hd, hkv)
        if not self.aspec.qkv_bias:
            k_wv, b_wv = keeps[ix_attn["wv"]["w"]], grid[ix_attn["wv"]["w"]]
            if k_wv is not None:
                live &= _tile_live(k_wv[r], b_wv[1], 1, hd, hkv)
        return live.astype(np.float32)

    # -- caches -----------------------------------------------------------

    def init_caches(self, batch: int, cache_len: int) -> list[dict]:
        shape = (batch, cache_len, self.aspec.num_kv_heads,
                 self.aspec.head_dim)
        return [{"k": torch.zeros(shape, device=self.device),
                 "v": torch.zeros(shape, device=self.device)}
                for _ in self.layers]

    # -- helpers ----------------------------------------------------------

    def _qkv(self, plan, la, y, positions):
        sp = self.aspec
        q = A._split_heads(sparse.apply_linear(plan["wq"], la["wq"], y),
                           sp.num_heads)
        k = A._split_heads(sparse.apply_linear(plan["wk"], la["wk"], y),
                           sp.num_kv_heads)
        v = A._split_heads(sparse.apply_linear(plan["wv"], la["wv"], y),
                           sp.num_kv_heads)
        q = L.apply_rope(q, positions, sp.rope_theta)
        k = L.apply_rope(k, positions, sp.rope_theta)
        return q, k, v

    def _ffn(self, plan, la, x):
        cfg = self.cfg
        y = B.norm_apply(cfg, la["norm_ffn"], x)
        h = sparse.apply_linear(plan["w_in"], la["w_in"], y)
        if plan["gated"]:
            h = L.ACTS[cfg.act](
                sparse.apply_linear(plan["w_gate"], la["w_gate"], y)) * h
        else:
            h = L.ACTS[cfg.act](h)
        return x + sparse.apply_linear(plan["w_out"], la["w_out"], h)

    # -- one-token decode -------------------------------------------------

    def decode_step(self, arrays, token: torch.Tensor, caches: list,
                    pos: torch.Tensor) -> tuple[torch.Tensor, list]:
        """token: (B, 1) int; pos: (B,) absolute position of ``token``.
        Returns (logits (B, V) f32, caches).  Writes each layer's new K/V
        into its cache in place, at slot ``min(pos, cache_len - 1)``."""
        cfg = self.cfg
        b = token.shape[0]
        pos = pos.to(torch.int32)
        rows = torch.arange(b, device=token.device)
        x = arrays["embed"][token]                          # (B, 1, d) f32
        for plan, la, cache in zip(self.layers, arrays["layers"], caches):
            y = B.norm_apply(cfg, la["norm_mix"], x)
            q, k, v = self._qkv(plan, la, y, pos[:, None])
            slot = torch.clamp_max(pos, cache["k"].shape[1] - 1).long()
            cache["k"][rows, slot] = k[:, 0]
            cache["v"][rows, slot] = v[:, 0]
            attn = ops.flash_decode(q[:, 0], cache["k"], cache["v"], pos,
                                    head_mask=la["head_mask"])
            x = x + sparse.apply_linear(plan["wo"], la["wo"],
                                        attn.reshape(b, 1, -1))
            if plan["has_ffn"]:
                x = self._ffn(plan, la, x)
        x = B.norm_apply(cfg, arrays["final_norm"], x)
        logits = sparse.apply_linear(self.unembed, arrays["unembed"], x)
        return logits[:, 0], caches

    # -- full-sequence prefill --------------------------------------------

    def prefill(self, arrays, tokens: torch.Tensor,
                cache_len: int) -> tuple[torch.Tensor, list]:
        """tokens: (B, P) int at positions 0..P-1.  Returns
        (logits (B, P, V) f32, caches filled at [0, P))."""
        cfg = self.cfg
        sp = self.aspec
        b, p = tokens.shape
        x = arrays["embed"][tokens]                         # (B, P, d) f32
        positions = torch.arange(p, device=tokens.device)[None, :]
        caches = []
        for plan, la in zip(self.layers, arrays["layers"]):
            y = B.norm_apply(cfg, la["norm_mix"], x)
            q, k, v = self._qkv(plan, la, y, positions)
            attn = ops.flash_prefill(q, k, v, causal=True,
                                     head_mask=la["head_mask"])
            x = x + sparse.apply_linear(plan["wo"], la["wo"],
                                        attn.reshape(b, p, -1))
            if plan["has_ffn"]:
                x = self._ffn(plan, la, x)
            shape = (b, cache_len, sp.num_kv_heads, sp.head_dim)
            ck = torch.zeros(shape, device=x.device)
            cv = torch.zeros(shape, device=x.device)
            ck[:, :p] = k
            cv[:, :p] = v
            caches.append({"k": ck, "v": cv})
        x = B.norm_apply(cfg, arrays["final_norm"], x)
        logits = sparse.apply_linear(self.unembed, arrays["unembed"], x)
        return logits, caches
