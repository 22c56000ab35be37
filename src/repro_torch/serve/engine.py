"""Continuous-batching serve engine over a ``SparseModel`` (the port of
``repro.serve.engine``).

B KV "pages" (slots) of fixed length, a request queue walked by a cursor,
greedy decode, and slot recycling the step a request emits its last token.
The loop's state — the cursor, each slot's request and position, the
outputs — is device tensors, and the step count is known up front, so the
host issues the steps without waiting on the device between tokens.

Slot recycling reuses KV pages *without clearing them*: a finished slot's
position resets to 0 and the validity rule of the decode kernel
(kpos <= pos) hides the stale tail.  Requests are fixed-shape (prompt
length P, G new tokens); row R of the padded buffers is a write dump for
parked slots.

``generate``          token-level continuous batching: prompts stream
                      through the decode path one token per step, so a
                      slot can be mid-prompt while its neighbour decodes.
``generate_prefilled`` wave mode: batch prefill (the flash-prefill kernel)
                      then decode steps — the prefill/decode split, same
                      outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_slots: int = 32          # concurrent KV pages (the serving batch)
    page_len: int = 128          # KV page length >= P + max_new - 1
    max_new: int = 32            # generated tokens per request


class ServeEngine:
    def __init__(self, model, config: ServeConfig = ServeConfig()):
        self.model = model
        self.config = config

    def _prompts(self, prompts) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=self.model.device)

    def _check(self, p: int, g: int) -> None:
        if p + g - 1 > self.config.page_len:
            raise ValueError(
                f"P + G - 1 = {p + g - 1} exceeds page_len "
                f"{self.config.page_len}")

    def generate(self, prompts, max_new: Optional[int] = None,
                 return_logits: bool = False):
        """Greedy-decode ``max_new`` tokens for each prompt row.

        prompts: (R, P) ints.  Returns tokens (R, G) int32 (numpy), or
        (tokens, logits (R, G, V) float32) with ``return_logits``.
        """
        model, cfg = self.model, self.config
        prompts = self._prompts(prompts)
        r, p = prompts.shape
        g = cfg.max_new if max_new is None else max_new
        self._check(p, g)
        dev = prompts.device
        b = cfg.max_slots
        steps_per = p + g - 1
        total = -(-r // b) * steps_per
        prompts_pad = torch.cat(
            [prompts, torch.zeros((1, p), dtype=torch.long, device=dev)])
        caches = model.init_caches(b, cfg.page_len)
        out = torch.zeros((r + 1, g), dtype=torch.long, device=dev)
        lout = torch.zeros((r + 1, g, model.cfg.vocab_size), device=dev) \
            if return_logits else None
        req = torch.arange(b, device=dev)
        tpos = torch.zeros((b,), dtype=torch.long, device=dev)
        last = torch.zeros((b,), dtype=torch.long, device=dev)
        nxt = torch.tensor(b, device=dev)
        for _ in range(total):
            row = torch.clamp_max(req, r)
            tok = torch.where(tpos < p,
                              prompts_pad[row, torch.clamp_max(tpos, p - 1)],
                              last)
            logits, caches = model.decode_step(model.arrays, tok[:, None],
                                               caches, tpos)
            nxt_tok = torch.argmax(logits, dim=-1)   # first max, as jnp
            gen_idx = tpos - (p - 1)
            emit = (gen_idx >= 0) & (req < r)
            erow = torch.where(emit, req, r)
            ecol = torch.clamp(gen_idx, 0, g - 1)
            out[erow, ecol] = nxt_tok
            if return_logits:
                lout[erow, ecol] = logits
            # recycle finished slots: next queued request, page pos -> 0
            # (stale KV hidden by kpos <= pos validity)
            finish = tpos >= steps_per - 1
            fin = finish.long()
            rank = torch.cumsum(fin, 0) - fin
            req = torch.where(finish, nxt + rank, req)
            nxt = nxt + fin.sum()
            tpos = torch.where(finish, 0, tpos + 1)
            last = torch.where(finish, 0, nxt_tok)
        tokens = out[:r].to(torch.int32).cpu().numpy()
        if return_logits:
            return tokens, lout[:r].cpu().numpy()
        return tokens

    def generate_prefilled(self, prompts, max_new: Optional[int] = None):
        """Wave mode: prefill a full batch, then decode steps; the last
        wave is padded with zero prompts."""
        model, cfg = self.model, self.config
        prompts = self._prompts(prompts)
        r, p = prompts.shape
        g = cfg.max_new if max_new is None else max_new
        self._check(p, g)
        b = cfg.max_slots
        pad = (-r) % b
        if pad:
            prompts = torch.cat([prompts, torch.zeros(
                (pad, p), dtype=torch.long, device=prompts.device)])
        waves = []
        for i in range(0, r + pad, b):
            logits0, caches = model.prefill(model.arrays, prompts[i:i + b],
                                            cfg.page_len)
            tok = torch.argmax(logits0[:, -1], dim=-1)
            toks = [tok]
            for j in range(g - 1):
                pos = torch.full((b,), p + j, dtype=torch.long,
                                 device=prompts.device)
                logits, caches = model.decode_step(model.arrays,
                                                   tok[:, None], caches, pos)
                tok = torch.argmax(logits, dim=-1)
                toks.append(tok)
            waves.append(torch.stack(toks, dim=1))
        return torch.cat(waves)[:r].to(torch.int32).cpu().numpy()
