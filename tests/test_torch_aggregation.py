"""The port's aggregation rules against ``repro.core.aggregation``.

``staleness_scale``, ``buffered_weights`` and ``buffered_aggregate`` at
every discount kind, ``aggregate`` (Eq. (5)) and ``sample_arrivals``, on
the same numpy inputs, float64 under ``jax.enable_x64(True)``, at 1e-12
relative (the same elementwise formulas; the sums over clients may
associate differently).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import aggregation as JAGG
from repro_torch.core import aggregation as TAGG

KINDS = ("none", "polynomial", "exponential")


def _inputs(seed=0, c=9):
    rng = np.random.default_rng(seed)
    grads = {"layer0": {"w": rng.normal(size=(c, 5, 3)),
                        "b": rng.normal(size=(c, 3))},
             "layer1": {"w": rng.normal(size=(c, 3, 2))}}
    k = rng.integers(16, 65, c).astype(np.float64)
    arrivals = (rng.uniform(size=c) > 0.3).astype(np.float64)
    tau = rng.integers(0, 6, c)
    return grads, k, arrivals, tau


def _t(tree):
    return {n: {l: torch.as_tensor(v) for l, v in d.items()}
            for n, d in tree.items()}


def _close(got, ref, rtol=1e-12):
    for name, layer in ref.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(got[name][leaf].numpy(),
                                       np.asarray(v), rtol=rtol, atol=1e-15)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("alpha", [0.5, 2.0])
def test_staleness_scale_matches_reference(kind, alpha):
    tau = np.array([-1, 0, 1, 2, 7, 40])
    with jax.enable_x64(True):
        ref = np.asarray(JAGG.staleness_scale(jnp.asarray(tau), kind=kind,
                                              alpha=alpha))
    got = TAGG.staleness_scale(torch.as_tensor(tau), kind=kind, alpha=alpha,
                               dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15)
    assert float(got[1]) == 1.0
    with pytest.raises(ValueError, match="discount"):
        TAGG.staleness_scale(torch.as_tensor(tau), kind="linear")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_staleness", [0, 3, 20])
def test_buffered_weights_and_aggregate_match_reference(kind, max_staleness):
    grads, k, arrivals, tau = _inputs(max_staleness)
    kw = dict(kind=kind, alpha=0.5, max_staleness=max_staleness)
    with jax.enable_x64(True):
        w_ref = JAGG.buffered_weights(jnp.asarray(k), jnp.asarray(arrivals),
                                      jnp.asarray(tau), **kw)
        g_ref = JAGG.buffered_aggregate(jax.tree.map(jnp.asarray, grads),
                                        jnp.asarray(k), jnp.asarray(arrivals),
                                        jnp.asarray(tau), **kw)
    t = (torch.as_tensor(k), torch.as_tensor(arrivals), torch.as_tensor(tau))
    w_got = TAGG.buffered_weights(*t, dtype=torch.float64, **kw)
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_ref), rtol=1e-15)
    _close(TAGG.buffered_aggregate(_t(grads), *t, dtype=torch.float64, **kw),
           g_ref)


def test_aggregate_matches_reference_and_zero_staleness_is_eq5():
    grads, k, arrivals, _ = _inputs(3)
    with jax.enable_x64(True):
        ref = JAGG.aggregate(jax.tree.map(jnp.asarray, grads), jnp.asarray(k),
                             jnp.asarray(arrivals))
    got = TAGG.aggregate(_t(grads), torch.as_tensor(k),
                         torch.as_tensor(arrivals))
    _close(got, ref)
    zero = torch.zeros(len(k), dtype=torch.int64)
    _close(TAGG.buffered_aggregate(_t(grads), torch.as_tensor(k),
                                   torch.as_tensor(arrivals), zero,
                                   dtype=torch.float64),
           jax.tree.map(np.asarray, ref))


def test_all_dropped_buffer_gives_zero_gradient():
    grads, k, _, tau = _inputs(4)
    got = TAGG.buffered_aggregate(_t(grads), torch.as_tensor(k),
                                  torch.zeros(len(k), dtype=torch.float64),
                                  torch.as_tensor(tau), dtype=torch.float64)
    for layer in got.values():
        for v in layer.values():
            assert bool((v == 0).all())


def test_sample_arrivals_matches_reference_on_its_uniforms():
    per = np.linspace(0.0, 1.0, 12).reshape(3, 4)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        ref = np.asarray(JAGG.sample_arrivals(key, jnp.asarray(per)))
        u = np.asarray(jax.random.uniform(key, per.shape))
    got = TAGG.sample_arrivals(torch.as_tensor(np.array(u)),
                               torch.as_tensor(per))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
