"""Param-tree optimizers (the port of ``repro.optimizers``), plain
functions over the port's param trees (``core.pruning``'s ``tree_map``
and ``flatten`` order).

Each optimizer is a pair of functions:
    state = init(params)
    new_params, new_state = update(params, grads, state, lr)

The rounding order is the reference's.  A Python constant (``lr``,
``beta``) meets a tensor as JAX's weakly typed scalar does, in the
tensor's dtype (``_weak``: a bfloat16 param steps by bfloat16(lr)
times the update); ``sgd`` and ``momentum`` cast the gradient to the
param's (momentum's) dtype; ``adam`` keeps ``m`` and
``v`` in float32 whatever the params are, counts ``t`` in an int32
scalar, and steps ``p - lr * ((m / bc1) / (sqrt(v / bc2) + eps))`` cast
to the param's dtype.  ``torch.optim.Adam`` rounds in another order
(``lr / bc1``, ``sqrt(v) / sqrt(bc2) + eps``), so it is not used.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.pruning import flatten, tree_map

__all__ = ["Optimizer", "sgd", "momentum", "adam", "clip_by_global_norm",
           "REGISTRY"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, float], tuple[PyTree, PyTree]]
    name: str = "opt"


def _weak(c: float, x: torch.Tensor) -> torch.Tensor:
    """The constant ``c`` in ``x``'s dtype: how JAX takes a Python scalar
    against an array."""
    return torch.full((), c, dtype=x.dtype, device=x.device)


def sgd() -> Optimizer:
    def init(params):
        return {}

    def update(params, grads, state, lr):
        new = tree_map(lambda p, g: p - _weak(lr, p) * g.to(p.dtype),
                       params, grads)
        return new, state

    return Optimizer(init, update, "sgd")


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    def update(params, grads, state, lr):
        m = tree_map(lambda m_, g: _weak(beta, m_) * m_ + g.to(m_.dtype),
                     state["m"], grads)
        new = tree_map(lambda p, m_: p - _weak(lr, p) * m_.to(p.dtype),
                       params, m)
        return new, {"m": m}

    return Optimizer(init, update, "momentum")


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = flatten(params)[0].device
        return {"m": tree_map(f32, params), "v": tree_map(f32, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(params, grads, state, lr):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)

        def step(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            return p - _weak(lr, p) * upd.to(p.dtype)

        return tree_map(step, params, m, v), {"m": m, "v": v, "t": t}

    return Optimizer(init, update, "adam")


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """Scale every gradient by min(1, max_norm / ||g||), the norm over all
    leaves in float32 (per-leaf sums of squares added in ``flatten``
    order)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in flatten(grads)))
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


REGISTRY = {"sgd": sgd, "momentum": momentum, "adam": adam}
