"""Shared layers (the port of ``repro.models.layers``; params = nested dicts).

* every ``init_*`` draws from an explicit ``torch.Generator`` onto the
  generator's device and returns tensors in ``dtype``; ``generator=None``
  gives tensors on the ``meta`` device (shapes and dtypes only, what a
  loader needs to know what to read);
* weight matrices are stored (in_features, out_features): ``x @ w``;
* apply functions compute in the activations' dtype (the config's compute
  dtype), weights cast to it; norms, RoPE and the unembedding compute in
  float32, as the reference does.  They are functional (no in-place
  writes), so ``torch.func`` transforms them;
* ``checkpoint`` is the port's ``jax.checkpoint``: a function whose
  activations the backward recomputes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models import sharding as S


def device_of(generator: Optional[torch.Generator]):
    """Where an init draws: the generator's device, or ``meta``."""
    return generator.device if generator is not None else torch.device("meta")


def _normal(generator: Optional[torch.Generator], shape: tuple
            ) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=device_of(generator), dtype=torch.float32)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> dict:
    scale = (d_in ** -0.5) if scale is None else scale
    return {"w": (_normal(generator, (d_in, d_out)) * scale).to(dtype)}


def dense_bias_init(generator, d_in: int, d_out: int, dtype,
                    scale: float | None = None) -> dict:
    p = dense_init(generator, d_in, d_out, dtype, scale)
    p["b"] = torch.zeros((d_out,), dtype=dtype, device=device_of(generator))
    return p


def embed_init(generator, vocab: int, d_model: int, dtype) -> dict:
    return {"embedding": (_normal(generator, (vocab, d_model)) * 0.02
                          ).to(dtype)}


def norm_init(d: int, dtype, bias: bool = False, device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def init_mlp(generator, d_model: int, d_ff: int, dtype, gated: bool = True,
             bias: bool = False) -> dict:
    make = dense_bias_init if bias else dense_init
    p = {"w_in": make(generator, d_model, d_ff, dtype),
         "w_out": make(generator, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = make(generator, d_model, d_ff, dtype)
    return p


# ---------------------------------------------------------------------------
# Apply functions
# ---------------------------------------------------------------------------

def checkpoint(fn, *args):
    """``fn(*args)``, its activations dropped after the forward and
    recomputed in the backward (``torch.utils.checkpoint``, non-reentrant,
    on plain tensors and DTensors; the recompute runs through whatever
    dispatch mode is active then, so a traced step counts it).  Without
    grad mode, or inside a ``torch.func`` transform (which takes no
    saved-tensor hooks), ``fn(*args)``: the same values, the activations
    kept.  The recompute runs under the sharding rules and mesh the
    forward saw: they are thread-local, and autograd runs a CUDA
    backward on a device thread of its own, which holds none."""
    if not torch.is_grad_enabled() or \
            torch._C._functorch.peek_interpreter_stack() is not None:
        return fn(*args)
    rules, mesh = S.get_rules(), S.get_mesh()

    def under_rules(*a):
        with S.use_rules(rules, mesh):
            return fn(*a)
    return torch.utils.checkpoint.checkpoint(
        under_rules, *args, use_reentrant=False, preserve_rng_state=False)


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = S.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embed(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the embedding table (a gather; its gradient sums the rows'
    gradients per token) in ``dtype``.  From a vocab-sharded DTensor
    table each rank gathers the rows it holds, zeros elsewhere: a partial
    sum that is summed here, before an op that would not carry its mask.
    A table sharded on a mesh dim that shards the tokens' rows is gathered
    there first (``sharding.gathered``)."""
    out = F.embedding(tokens, S.gathered(p["embedding"], tokens))
    if isinstance(out, DTensor) and any(pl.is_partial()
                                        for pl in out.placements):
        out = out.redistribute(placements=[
            Replicate() if pl.is_partial() else pl for pl in out.placements])
    return out.to(dtype)


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ E^T, in float32."""
    return S.matmul(x.to(torch.float32), p["embedding"].to(torch.float32).T)


def _scale(v: torch.Tensor) -> torch.Tensor:
    """A norm's scale or bias vector in float32, replicated if a DTensor: a
    shard of it would shard the activations' features, and the products
    after the norm would then sum partial rows over the tensor dim."""
    return S.replicate(v).to(torch.float32)


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32.  The mean of squares is summed in float64 and
    rounded to float32, so a row's result does not depend on how many rows
    the reduction kernel is given (the serving engine's slot invariance
    rests on it); the reference sums in float32, within an ulp of this."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32.to(torch.float64) ** 2, dim=-1,
                     keepdim=True).to(torch.float32)
    y = x32 * torch.rsqrt(var + eps)
    return (y * _scale(p["scale"])).to(x.dtype)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * _scale(p["scale"])
    if "bias" in p:
        y = y + _scale(p["bias"])
    return y.to(x.dtype)


# jax.nn.gelu defaults to the tanh approximation; "gelu" follows it
ACTS = {"silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq).  Split-half rotation: the first and second halves of
    head_dim are the two coordinates of each rotated pair."""
    dim = x.shape[-1]
    freqs = rope_frequencies(dim, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``w_out(act(w_gate x) * w_in x)``, or ``w_out(act(w_in x))`` without
    a gate."""
    act_fn = ACTS[act]
    h = dense(p["w_in"], x)
    if "w_gate" in p:
        h = act_fn(dense(p["w_gate"], x)) * h
    else:
        h = act_fn(h)
    # the Megatron layout: hidden over the tensor dim, output back to the
    # residual layout
    h = S.constrain(h, "batch", "seq", "mlp")
    return S.constrain(dense(p["w_out"], h), "batch", "seq", "embed")
