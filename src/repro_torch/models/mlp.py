"""The paper's experiment models (§V): a shallow network (one hidden layer
of 60) and a DNN (hidden layers of 60 and 20), with cross-entropy loss.

Parameters keep the JAX package's layout, ``{"layer{i}": {"w": (in, out),
"b": (out,)}}``, so they compare one to one with the reference and feed
the fused kernel directly.  ``MLPClassifier`` wraps the same dict as an
``nn.Module`` for callers that want one.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["init_mlp_classifier", "mlp_logits", "classifier_loss",
           "accuracy", "MLPClassifier", "SHALLOW_HIDDEN", "DNN_HIDDEN"]

SHALLOW_HIDDEN = (60,)
DNN_HIDDEN = (60, 20)


def init_mlp_classifier(generator: torch.Generator, dim_in: int,
                        hidden: tuple[int, ...], num_classes: int, *,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> dict:
    """He-normal weights (std sqrt(2 / fan_in)) and zero biases, drawn
    from ``generator`` on ``device``."""
    sizes = (dim_in,) + tuple(hidden) + (num_classes,)
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((a, b), generator=generator, dtype=dtype,
                        device=device)
        params[f"layer{i}"] = {"w": w * (2.0 / a) ** 0.5,
                               "b": torch.zeros((b,), dtype=dtype,
                                                device=device)}
    return params


def mlp_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    h = x
    for i in range(n):
        p = params[f"layer{i}"]
        h = h @ p["w"] + p["b"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def classifier_loss(params: dict, x: torch.Tensor, y: torch.Tensor
                    ) -> torch.Tensor:
    logp = torch.log_softmax(mlp_logits(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, -1, y[..., None].long()))


def accuracy(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Float32 share of argmax hits (``torch.argmax`` returns the first
    maximum, as ``jnp.argmax`` does)."""
    pred = torch.argmax(mlp_logits(params, x), dim=-1)
    return torch.mean((pred == y).to(torch.float32))


class MLPClassifier(nn.Module):
    """``nn.Module`` view of a params dict in the JAX layout."""

    def __init__(self, params: dict):
        super().__init__()
        self.layers = nn.ModuleList()
        for i in range(len(params)):
            layer = nn.Module()
            layer.w = nn.Parameter(params[f"layer{i}"]["w"])
            layer.b = nn.Parameter(params[f"layer{i}"]["b"])
            self.layers.append(layer)

    def params(self) -> dict:
        return {f"layer{i}": {"w": m.w, "b": m.b}
                for i, m in enumerate(self.layers)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_logits(self.params(), x)
