"""The port's mask builders against ``repro.core.pruning``.

``magnitude_masks``, ``block_masks`` (``scope="leaf"`` and ``"global"``),
``masks_from_state``, ``ones_masks``, ``prunable`` and ``achieved_rate``
on a ragged MLP (no dim a multiple of the block) and a stacked leaf, at
rho in {0, 1, a tile-mass boundary, values between}, in float64 under
``jax.enable_x64(True)`` and in float32.  Masks are 0/1 decisions and
must be equal exactly; ``achieved_rate`` at 1e-12.  A batch of rates
gives one mask per rate, equal to the reference's mask at that rate.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import pruning as JPR
from repro_torch.core import pruning as TPR

SIZES = (30, 13, 7, 5)
RATES = (0.0, 1.0, 0.05, 0.35, 0.5, 0.7, 0.999)


def _params(seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    p = {f"layer{i}": {"w": rng.normal(size=(a, b)).astype(dtype),
                       "b": rng.normal(size=(b,)).astype(dtype)}
         for i, (a, b) in enumerate(zip(SIZES[:-1], SIZES[1:]))}
    # a stacked leaf (two layers of one stage) ranks its tiles together
    p["stack"] = {"w": rng.normal(size=(2, 11, 9)).astype(dtype)}
    return p


def _torch(tree):
    return {k: {n: torch.as_tensor(v) for n, v in d.items()}
            for k, d in tree.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_masks_equal(got, ref, index=None):
    for name, layer in ref.items():
        for leaf, m in layer.items():
            g = got[name][leaf]
            if index is not None and g.ndim > np.ndim(m):
                g = g[index]
            assert g.dtype == torch.bool
            np.testing.assert_array_equal(g.numpy(), np.asarray(m),
                                          err_msg=f"{name}/{leaf}")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rate", RATES)
def test_magnitude_masks_match_reference(dtype, rate):
    p = _params(1, dtype)
    with jax.enable_x64(True):
        r = np.asarray(rate, dtype)
        ref = JPR.magnitude_masks(_jax(p), jnp.asarray(r))
        got = TPR.magnitude_masks(_torch(p), torch.as_tensor(r))
        _assert_masks_equal(got, ref)
        np.testing.assert_allclose(
            TPR.achieved_rate(_torch(p), got).numpy(),
            np.asarray(JPR.achieved_rate(_jax(p), ref)), rtol=1e-12)


def test_magnitude_masks_rho_zero_drops_the_smallest_magnitude():
    """``|w| > q`` at q = min |w|: the reference prunes one element at
    rho = 0, and so does the port."""
    p = _params(2)
    got = TPR.magnitude_masks(_torch(p), torch.tensor(0.0, dtype=torch.float64))
    dropped = sum(int((~m).sum()) for m in TPR.flatten(got))
    assert dropped == 1


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_magnitude_masks_batch_of_rates_matches_one_by_one(dtype):
    p = _params(3, dtype)
    rates = np.asarray(RATES, dtype)
    mags = TPR.sorted_magnitudes(_torch(p))
    got = TPR.magnitude_masks(_torch(p), torch.as_tensor(rates), mags=mags)
    kept = TPR.achieved_rate(_torch(p), got)
    assert kept.shape == (len(RATES),)
    with jax.enable_x64(True):
        for i, r in enumerate(rates):
            ref = JPR.magnitude_masks(_jax(p), jnp.asarray(r))
            _assert_masks_equal(got, ref, index=i)
            np.testing.assert_allclose(
                kept[i].numpy(), np.asarray(JPR.achieved_rate(_jax(p), ref)),
                rtol=1e-12)


@pytest.mark.parametrize("scope", ["leaf", "global"])
@pytest.mark.parametrize("block", [4, 8, (8, 4)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_block_masks_match_reference(scope, block, dtype):
    p = _params(4, dtype)
    with jax.enable_x64(True):
        state = JPR.block_norm_state(_jax(p), block)
        boundary = float(np.asarray(state[1].cum_frac)[2])
        rates = np.asarray(RATES + (boundary,), dtype)
        got = TPR.block_masks(_torch(p), torch.as_tensor(rates), block,
                              scope=scope)
        kept = TPR.achieved_rate(_torch(p), got)
        for i, r in enumerate(rates):
            ref = JPR.block_masks(_jax(p), jnp.asarray(r), block, scope=scope)
            _assert_masks_equal(got, ref, index=i)
            np.testing.assert_allclose(
                kept[i].numpy(), np.asarray(JPR.achieved_rate(_jax(p), ref)),
                rtol=1e-12)


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_masks_from_state_and_python_rates_match_reference(rate):
    p = _params(5, np.float32)
    with jax.enable_x64(True):
        ref = JPR.masks_from_state(_jax(p), JPR.block_norm_state(_jax(p), 8),
                                   rate, 8)
        got = TPR.masks_from_state(_torch(p),
                                   TPR.block_norm_state(_torch(p), 8), rate, 8)
        _assert_masks_equal(got, ref)
        _assert_masks_equal(TPR.block_masks(_torch(p), rate, 8),
                            JPR.block_masks(_jax(p), rate, 8))
        _assert_masks_equal(TPR.magnitude_masks(_torch(p), rate),
                            JPR.magnitude_masks(_jax(p), rate))


def test_ones_masks_prunable_and_unknown_scope():
    p = _params(6)
    ones = TPR.ones_masks(_torch(p))
    _assert_masks_equal(ones, JPR.ones_masks(_jax(p)))
    assert float(TPR.achieved_rate(_torch(p), ones)) == 0.0
    for leaf in TPR.flatten(_torch(p)):
        assert TPR.prunable((), leaf) == JPR.prunable((), jnp.asarray(
            leaf.numpy()))
    with pytest.raises(ValueError, match="scope"):
        TPR.block_masks(_torch(p), 0.5, 8, scope="row")


def test_apply_masks_zeroes_dropped_weights_per_rate():
    p = _torch(_params(7))
    masks = TPR.block_masks(p, torch.tensor([0.0, 0.6], dtype=torch.float64),
                            8)
    pruned = TPR.apply_masks(p, masks)
    w = pruned["layer0"]["w"]
    assert w.shape == (2, 30, 13)
    torch.testing.assert_close(w[0], p["layer0"]["w"], rtol=0, atol=0)
    assert int((w[1] == 0).sum()) == int((~masks["layer0"]["w"][1]).sum())
