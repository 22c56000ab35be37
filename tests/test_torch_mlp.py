"""The port's MLP classifier against ``repro.models.mlp`` (float64 under
``jax.enable_x64(True)``; 1e-10 relative: a few dense products, so only
float64 rounding separates the two)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.models import mlp as JMLP
from repro_torch.models import mlp as TMLP

SIZES = (32, 12, 6, 5)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {f"layer{i}": {"w": rng.normal(size=(a, b)), "b": rng.normal(size=b)}
            for i, (a, b) in enumerate(zip(SIZES[:-1], SIZES[1:]))}


def _data(seed=1, n=40):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, SIZES[0])), rng.integers(0, SIZES[-1], n)


def test_logits_loss_and_accuracy_match_reference():
    p, (x, y) = _params(), _data()
    with jax.enable_x64(True):
        jp = jax.tree.map(jnp.asarray, p)
        ref = [np.asarray(f(jp, jnp.asarray(x), jnp.asarray(y)))
               for f in (JMLP.classifier_loss, JMLP.accuracy)]
        ref_logits = np.asarray(JMLP.mlp_logits(jp, jnp.asarray(x)))
    tp = {k: {n: torch.as_tensor(v) for n, v in d.items()}
          for k, d in p.items()}
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    np.testing.assert_allclose(TMLP.mlp_logits(tp, tx).numpy(), ref_logits,
                               rtol=1e-10)
    np.testing.assert_allclose(TMLP.classifier_loss(tp, tx, ty).numpy(),
                               ref[0], rtol=1e-10)
    assert float(TMLP.accuracy(tp, tx, ty)) == float(ref[1])


def test_module_view_and_init_layout():
    g = torch.Generator().manual_seed(0)
    p = TMLP.init_mlp_classifier(g, 784, TMLP.DNN_HIDDEN, 10)
    assert [tuple(p[f"layer{i}"]["w"].shape) for i in range(3)] == \
        [(784, 60), (60, 20), (20, 10)]
    assert all(float(p[f"layer{i}"]["b"].abs().max()) == 0.0 for i in range(3))
    # He-normal: std sqrt(2 / 784) on the first layer
    assert abs(float(p["layer0"]["w"].std()) - (2 / 784) ** 0.5) < 2e-3
    model = TMLP.MLPClassifier(p)
    x = torch.randn(5, 784, generator=g)
    torch.testing.assert_close(model(x), TMLP.mlp_logits(p, x), rtol=0,
                               atol=0)
