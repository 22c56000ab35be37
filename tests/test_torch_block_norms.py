"""The grouped tile-norm kernel and the ranking built on it.

CPU: the grouped plain version against the per-leaf one (bitwise), the
segment policy, ``ops.tile_norms`` against the reference's Pallas kernel
in interpret mode on ragged shapes (1e-5: tiles of up to 8,960 elements),
and ``block_norm_state`` on a narrow
2-layer stacked transformer tree (``auto_tile_grid``, ragged tiles, float32
and bfloat16) against the reference's: norms at 1e-6 relative (float32
sums of squares in another order), cumulative masses and keeps exactly.

``gpu``: the kernel against the plain version (ragged and unaligned
widths, leading dims, mixed blocks and dtypes, an empty leaf, groups past
one launch's table, smollm-135m at full width), at 1e-5 relative a tile
(1e-4 of the leaf's largest norm at full width); bitwise equal alone and
in any group, at any address, and on a rerun; one launch a
``block_norm_state`` call.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import base as TCB
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import pruning as TPR
from repro_torch.fleet.task import TransformerTask as TTask
from repro_torch.fleet.task import auto_tile_grid as t_auto_tile_grid
from repro_torch.kernels import block_norms as TBN
from repro_torch.kernels import fleet_fused as TFF
from repro_torch.kernels import ops as TOPS

try:  # the card's machine has no JAX: only the gpu tests run there
    import jax.numpy as jnp
    from repro.core import pruning as JPR
    from repro.kernels import ops as JOPS
except ImportError:
    JPR = None
needs_jax = pytest.mark.skipif(JPR is None, reason="needs the JAX reference")

# (shape, block, dtype): ragged and unaligned widths, leading dims, mixed
# blocks and dtypes, an empty leaf, a tile of several row segments
LEAVES = [((784, 60), (8, 8), torch.float32),
          ((60, 20), (8, 8), torch.float32),
          ((20, 10), (8, 8), torch.float32),       # 40-byte rows: scalar
          ((3, 37, 29), (8, 12), torch.bfloat16),
          ((2, 300, 9), (100, 3), torch.float32),
          ((0, 5), (4, 4), torch.float32),         # no tiles
          ((33, 17), (5, 7), torch.bfloat16),
          ((300, 70), (300, 70), torch.float32),   # 2 row segments a tile
          ((2, 520, 64), (520, 64), torch.bfloat16)]  # 3 segments, 16-byte


def _leaves(device="cpu", seed=0, specs=LEAVES):
    rng = np.random.default_rng(seed)
    out = [torch.as_tensor(rng.normal(size=s).astype(np.float32),
                           device=device).to(dt) for s, _, dt in specs]
    return out, [b for _, b, _ in specs]


def tiny_arch(dtype):
    """Two stacked layers, no width a multiple of its tile (target 4)."""
    return TCB.ArchConfig(
        name="tiny-norms", family="dense", source="test", d_model=30,
        num_heads=3, num_kv_heads=1, d_ff=46, vocab_size=70,
        stages=(TCB.StageSpec(2, (TCB.BlockSpec("attn", "mlp"),)),),
        param_dtype=dtype)


def _tree(dtype, seed=3):
    like = TTask(arch=tiny_arch(dtype)).init_params(None)
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=tuple(l.shape)).astype(np.float32)
            for l in TPR.flatten(like)]
    return like, arrs


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_group_plain_equals_per_leaf_plain_bitwise():
    leaves, blocks = _leaves()
    got = TBN.tile_norms_group_plain(leaves, blocks)
    assert len(got) == len(leaves)
    for w, (bk, bn), g in zip(leaves, blocks, got):
        assert torch.equal(g, TBN.tile_norms_plain(w, bk, bn))
        assert g.dtype == torch.float32
        assert g.shape == w.shape[:-2] + (-(-w.shape[-2] // bk),
                                          -(-w.shape[-1] // bn))


def test_group_on_cpu_runs_plain_and_counts_nothing():
    leaves, blocks = _leaves()
    before = TBN.tile_norms.launches
    for g, r in zip(TBN.tile_norms_group(leaves, blocks),
                    TBN.tile_norms_group_plain(leaves, blocks)):
        assert torch.equal(g, r)
    assert TBN.tile_norms.launches == before
    with pytest.raises(ValueError):
        TBN.tile_norms_group([torch.zeros(4)], [(2, 2)])


@pytest.mark.parametrize("block", [(8, 8), (72, 72), (6144, 72), (72, 192),
                                   (192, 72), (4, 72), (1, 9000), (130, 70)])
def test_segments_cover_the_tile_by_shape_alone(block):
    bk, bn = block
    nseg, rows = TBN.segments(bk, bn)
    cap = max(TBN.SEG_ELEMS, bn)
    assert (nseg - 1) * rows < bk <= nseg * rows
    assert rows == -(-bk // nseg) and rows * bn <= cap     # even, capped
    assert nseg == 1 or -(-bk // (nseg - 1)) * bn > cap    # the fewest


@needs_jax
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block", [((30, 13), (8, 8)),
                                         ((7, 5), (4, 2)),
                                         ((130, 70), (128, 128)),
                                         ((37, 29), (16, 12))])
def test_ops_tile_norms_matches_reference(shape, block, dtype):
    w = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    tw = torch.as_tensor(w).to(getattr(torch, dtype))
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    got = TOPS.tile_norms(tw, *block)
    # the reference pads and runs its Pallas kernel in interpret mode
    ref = JOPS.tile_norms(jw, *block, interpret=True)
    assert got.dtype == torch.float32
    # float32 sums of up to 8,960 squares a tile, in two orders
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    if block == (128, 128):   # the reference's defaults
        np.testing.assert_array_equal(TOPS.tile_norms(tw).numpy(),
                                      got.numpy())


@needs_jax
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_transformer_norm_state_and_keeps_match_reference(dtype):
    like, arrs = _tree(dtype)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tp = TPR.unflatten(like, [torch.as_tensor(a).to(tdt) for a in arrs])
    jp = TPR.unflatten(like, [jnp.asarray(a).astype(jdt) for a in arrs])
    grid = t_auto_tile_grid(tp, target_tiles=4)
    assert any(b is not None and (l.shape[-2] % b[0] or l.shape[-1] % b[1])
               for l, b in zip(TPR.flatten(tp), grid))   # ragged tiles
    assert any(l.ndim == 3 for l in TPR.flatten(tp))     # stacked leaves
    ref = JPR.block_norm_state(jp, grid)
    got = TPR.block_norm_state(tp, grid)
    assert [s is None for s in got] == [s is None for s in ref]
    for g, r in zip(got, ref):
        if r is None:
            continue
        assert tuple(g.norms.shape) == tuple(r.norms.shape)
        np.testing.assert_allclose(g.norms.numpy(), np.asarray(r.norms),
                                   rtol=1e-6)
        np.testing.assert_array_equal(g.cum_frac.numpy(),
                                      np.asarray(r.cum_frac))
    rates = np.array([0.0, 0.25, 0.5, 0.7, 1.0, 1e-9], dtype=np.float32)
    for g, r in zip(TPR.block_keep(got, torch.as_tensor(rates)),
                    JPR.block_keep(ref, jnp.asarray(rates))):
        if r is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# gpu
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _close(got, ref, rtol=1e-5):
    assert got.shape == ref.shape
    if ref.numel():
        rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max())
        assert rel <= rtol, rel


@pytest.mark.gpu
def test_group_kernel_matches_plain_on_gpu():
    _card()
    leaves, blocks = _leaves("cuda")
    before = TBN.tile_norms.launches
    got = TBN.tile_norms_group(leaves, blocks)
    torch.cuda.synchronize()
    assert TBN.tile_norms.launches == before + 1
    for g, r in zip(got, TBN.tile_norms_group_plain(leaves, blocks)):
        _close(g, r)
    for bad in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            TBN.tile_norms(leaves[0].to(bad), 8, 8)


@pytest.mark.gpu
def test_alone_grouped_rerun_and_address_bitwise_on_gpu():
    _card()
    leaves, blocks = _leaves("cuda", seed=1)
    grouped = TBN.tile_norms_group(leaves, blocks)
    again = TBN.tile_norms_group(leaves, blocks)
    shuffled = TBN.tile_norms_group(leaves[::-1], blocks[::-1])[::-1]
    for i, (w, (bk, bn)) in enumerate(zip(leaves, blocks)):
        alone = TBN.tile_norms(w, bk, bn)
        assert torch.equal(alone, grouped[i])
        assert torch.equal(again[i], grouped[i])
        assert torch.equal(shuffled[i], grouped[i])
        # the same values 4 bytes off a 16-byte boundary take the scalar path
        buf = torch.empty(w.numel() + 8, dtype=w.dtype, device="cuda")
        off = 4 // w.element_size()
        moved = buf[off:off + w.numel()].view(w.shape)
        moved.copy_(w)
        assert torch.equal(TBN.tile_norms(moved, bk, bn), grouped[i])


@pytest.mark.gpu
def test_groups_past_one_table_split_launches_on_gpu():
    _card()
    specs = [((9 + i % 7, 11 + i % 5), (4, 3 + i % 3),
              torch.bfloat16 if i % 2 else torch.float32)
             for i in range(TBN.MAX_LEAVES * 2 + 5)]
    leaves, blocks = _leaves("cuda", seed=2, specs=specs)
    before = TBN.tile_norms.launches
    got = TBN.tile_norms_group(leaves, blocks)
    torch.cuda.synchronize()
    assert TBN.tile_norms.launches == before + 3
    for w, (bk, bn), g in zip(leaves, blocks, got):
        assert torch.equal(g, TBN.tile_norms(w, bk, bn))
        _close(g, TBN.tile_norms_plain(w, bk, bn))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_launch_a_ranking_on_gpu(dtype):
    _card()
    like, arrs = _tree(dtype)
    tp = TPR.unflatten(like, [torch.as_tensor(a, device="cuda")
                              .to(getattr(torch, dtype)) for a in arrs])
    cp = TPR.unflatten(like, [l.cpu() for l in TPR.flatten(tp)])
    grid = t_auto_tile_grid(tp, target_tiles=4)
    before = TBN.tile_norms.launches
    got = TPR.block_norm_state(tp, grid)
    torch.cuda.synchronize()
    assert TBN.tile_norms.launches == before + 1
    for g, r in zip(got, TPR.block_norm_state(cp, grid)):
        if r is not None:
            _close(g.norms.cpu(), r.norms)
    mlp = {f"layer{i}": {"w": torch.randn(a, b, device="cuda"),
                         "b": torch.zeros(b, device="cuda")}
           for i, (a, b) in enumerate([(784, 60), (60, 20), (20, 10)])}
    before = TBN.tile_norms.launches
    states = TFF.layer_norm_states(mlp, 8)
    assert TBN.tile_norms.launches == before + 1
    assert [tuple(s.norms.shape) for s in states] == [(98, 8), (8, 3), (3, 2)]


@pytest.mark.gpu
def test_smollm_full_width_leaves_match_plain_on_gpu():
    _card()
    task = TTask(arch=t_get_config("smollm-135m"))
    params = task.init_params(torch.Generator(device="cuda").manual_seed(0))
    grid = task.tile_grid(params)
    pairs = [(l, b) for l, b in zip(TPR.flatten(params), grid)
             if b is not None]
    assert all(l.dtype == torch.bfloat16 for l, _ in pairs)
    got = TBN.tile_norms_group([l for l, _ in pairs], [b for _, b in pairs])
    for g, (leaf, (bk, bn)) in zip(got, pairs):
        ref = TBN.tile_norms_plain(leaf, bk, bn)
        err = float((g - ref).abs().max()) / float(ref.abs().max())
        assert err <= 1e-4, (tuple(leaf.shape), err)
        assert torch.equal(g, TBN.tile_norms(leaf, bk, bn))
