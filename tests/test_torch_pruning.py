"""The port's block pruning and tile-norm kernel against the reference.

``block_norm_state`` / ``block_keep`` against ``repro.core.pruning`` on a
ragged MLP (no dim a multiple of the block), at rho in {0, an exact
cumulative-mass boundary, 0.7, 1}.  Keeps must be equal exactly (they
are 0/1 decisions); norms at 1e-6 relative (float32 sums of squares,
summed in a different order by XLA and torch).  Both sides run in
float32, the reference's default.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import pruning as TPR
from repro_torch.kernels import block_norms as TBN

try:  # the card's machine has no JAX: only the gpu tests run there
    import jax.numpy as jnp
    from repro.core import pruning as JPR
    from repro.kernels import ops as JOPS
except ImportError:
    JPR = None
needs_jax = pytest.mark.skipif(JPR is None, reason="needs the JAX reference")

SIZES = (30, 13, 7, 5)


def _params(seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return {f"layer{i}": {"w": rng.normal(size=(a, b)).astype(np.float32),
                          "b": rng.normal(size=(b,)).astype(np.float32)}
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}


def _torch(tree):
    return {k: {n: torch.as_tensor(v) for n, v in d.items()}
            for k, d in tree.items()}


def _jax(tree):
    return {k: {n: jnp.asarray(v) for n, v in d.items()}
            for k, d in tree.items()}


@needs_jax
@pytest.mark.parametrize("block", [4, 8, (8, 4)])
def test_block_norm_state_matches_reference(block):
    p = _params()
    ref = JPR.block_norm_state(_jax(p), block)
    got = TPR.block_norm_state(_torch(p), block)
    assert [s is None for s in got] == [s is None for s in ref]
    for g, r in zip(got, ref):
        if r is None:
            continue
        np.testing.assert_allclose(g.norms.numpy(), np.asarray(r.norms),
                                   rtol=1e-6)
        np.testing.assert_allclose(g.sorted_norms.numpy(),
                                   np.asarray(r.sorted_norms), rtol=1e-6)
        np.testing.assert_array_equal(g.cum_frac.numpy(),
                                      np.asarray(r.cum_frac))


def test_flatten_follows_sorted_key_order():
    """``layer10`` sorts before ``layer2``, as in jax.tree_util."""
    p = {f"layer{i}": {"w": np.zeros((2, 2)), "b": np.zeros(2)}
         for i in range(11)}
    order = [k for k in sorted(p) for _ in ("b", "w")]
    assert [id(x) for x in TPR.flatten(p)] == \
        [id(p[k][n]) for k, n in zip(order, ["b", "w"] * 11)]


@needs_jax
@pytest.mark.parametrize("block", [4, 8])
def test_block_keep_matches_reference_exactly(block):
    p = _params(1)
    ref_state = JPR.block_norm_state(_jax(p), block)
    boundary = float(np.asarray(ref_state[1].cum_frac)[3])
    rates = np.array([0.0, boundary, 0.7, 1.0, 0.35, 1e-9],
                     dtype=np.float32)
    ref = JPR.block_keep(ref_state, jnp.asarray(rates))
    got = TPR.block_keep(TPR.block_norm_state(_torch(p), block),
                         torch.as_tensor(rates))
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # rho = 0 keeps every tile; rho = 1 keeps only the top-norm tiles
    w_keep = got[1].numpy()
    assert w_keep[0].all() and w_keep[3].sum() < w_keep[2].sum()


@needs_jax
@pytest.mark.parametrize("shape,block", [((30, 13), (8, 8)),
                                         ((784, 60), (8, 8)),
                                         ((7, 5), (4, 2))])
def test_tile_norms_plain_matches_reference(shape, block):
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    got = TBN.tile_norms(torch.as_tensor(w), *block)
    # the reference's Pallas kernel, in interpret mode as its own tests run it
    ref = JOPS.tile_norms(jnp.asarray(w), *block, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_tile_norms_on_cpu_uses_plain_version_and_counts_nothing():
    before = TBN.tile_norms.launches
    w = torch.randn(20, 12)
    torch.testing.assert_close(TBN.tile_norms(w, 8, 8),
                               TBN.tile_norms_plain(w, 8, 8), rtol=0, atol=0)
    assert TBN.tile_norms.launches == before


@pytest.mark.gpu
def test_tile_norms_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(784, 60), (60, 20), (20, 10), (33, 17)]:
        w = torch.randn(shape, generator=g, device="cuda")
        before = TBN.tile_norms.launches
        got = TBN.tile_norms(w, 8, 8)
        torch.cuda.synchronize()
        assert TBN.tile_norms.launches == before + 1
        torch.testing.assert_close(got, TBN.tile_norms_plain(w, 8, 8),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError):
        TBN.tile_norms(w.double(), 8, 8)
