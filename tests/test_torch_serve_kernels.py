"""The serving kernels of the port against the reference.

The port's plain versions (what a wrapper runs on a CPU tensor) against
``repro.kernels.ops`` run through the Pallas kernels in interpret mode, as
``tests/test_serve.py`` runs them, and against the oracles of
``repro.kernels.ref``, at rtol = atol = 2e-5 (float32 sums in another
order).  Inputs come from a numpy seed.  The ``gpu`` tests hold each CUDA
kernel against its plain version on the card and check that the wrappers
refuse operands they cannot take.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import block_sparse_matmul as TBSM
from repro_torch.kernels import decode_attention as TDA
from repro_torch.kernels import flash_prefill as TFP
from repro_torch.kernels import ops as TOPS

try:  # the card's machine has no JAX: only the gpu tests run there
    import jax.numpy as jnp
    from repro.kernels import flash_prefill as JFP
    from repro.kernels import ops as JOPS
    from repro.kernels import ref as JREF
except ImportError:
    JOPS = None
needs_jax = pytest.mark.skipif(JOPS is None, reason="needs the JAX reference")

TOL = dict(rtol=2e-5, atol=2e-5)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _matmul_case(rho, transpose, lead=(5,), seed=3):
    """The ragged 50 x 70 / (16, 32) case of tests/test_serve.py."""
    rng = np.random.default_rng(seed)
    kdim, n, bk, bn = 50, 70, 16, 32
    tk, tn = -(-kdim // bk), -(-n // bn)
    w = rng.normal(size=(kdim, n)).astype(np.float32)
    x = rng.normal(size=lead + ((n if transpose else kdim),)
                   ).astype(np.float32)
    keep = (rng.uniform(size=(tk, tn)) >= rho).astype(np.float32)
    return x, w, keep, bk, bn


# ---------------------------------------------------------------------------
# Block-sparse matmul
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rho", [0.0, 0.5, 0.9, 1.0])
def test_masked_matmul_plain_matches_reference(rho, transpose):
    x, w, keep, bk, bn = _matmul_case(rho, transpose)
    got = TOPS.masked_matmul(torch.as_tensor(x), torch.as_tensor(w),
                             torch.as_tensor(keep), bk, bn,
                             transpose_rhs=transpose)
    pallas = JOPS.masked_matmul(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(keep), block_k=bk, block_n=bn,
                                transpose_rhs=transpose, interpret=True)
    _close(got, pallas)
    kp, np_ = keep.shape[0] * bk, keep.shape[1] * bn
    wp = np.pad(w, ((0, kp - w.shape[0]), (0, np_ - w.shape[1])))
    if transpose:
        xp = np.pad(x, ((0, 0), (0, np_ - x.shape[1])))
        want = JREF.block_sparse_matmul_t(xp, wp, keep, bk, bn)
        _close(got, np.asarray(want)[:, :w.shape[0]])
    else:
        xp = np.pad(x, ((0, 0), (0, kp - x.shape[1])))
        want = JREF.block_sparse_matmul(xp, wp, keep, bk, bn)
        _close(got, np.asarray(want)[:, :w.shape[1]])


@needs_jax
@pytest.mark.parametrize("transpose", [False, True])
def test_masked_matmul_leading_dims(transpose):
    x, w, keep, bk, bn = _matmul_case(0.5, transpose, lead=(2, 3))
    got = TOPS.masked_matmul(torch.as_tensor(x), torch.as_tensor(w),
                             torch.as_tensor(keep), bk, bn,
                             transpose_rhs=transpose)
    want = JOPS.masked_matmul(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(keep), block_k=bk, block_n=bn,
                              transpose_rhs=transpose, interpret=True)
    assert got.shape == want.shape
    _close(got, want)


def test_matmul_on_cpu_runs_plain_and_counts_nothing():
    x, w, keep, bk, bn = _matmul_case(0.5, False)
    before = (TBSM.block_sparse_matmul.launches,
              TBSM.block_sparse_matmul_t.launches)
    args = (torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(keep))
    torch.testing.assert_close(
        TBSM.block_sparse_matmul(*args, bk, bn),
        TBSM.block_sparse_matmul_plain(*args, bk, bn), rtol=0, atol=0)
    xt = torch.randn(5, 70)
    torch.testing.assert_close(
        TBSM.block_sparse_matmul_t(xt, *args[1:], bk, bn),
        TBSM.block_sparse_matmul_plain(xt, *args[1:], bk, bn, True),
        rtol=0, atol=0)
    assert (TBSM.block_sparse_matmul.launches,
            TBSM.block_sparse_matmul_t.launches) == before


@pytest.mark.parametrize("bad", ["mask_grid", "contraction", "ndim", "meta"])
def test_matmul_refuses_bad_operands(bad):
    x, w, keep = torch.randn(5, 50), torch.randn(50, 70), torch.ones(4, 3)
    if bad == "mask_grid":
        keep = torch.ones(3, 3)
    elif bad == "contraction":
        x = torch.randn(5, 49)
    elif bad == "ndim":
        x = x[None]
    else:
        x = x.to("meta")
    with pytest.raises(ValueError):
        TBSM.block_sparse_matmul(x, w, keep, 16, 32)


# the five distinct (K, N, bk, bn) of smollm-135m's serving linears and
# the ragged case above
SERVE_SHAPES = [(576, 576, 72, 72), (576, 192, 72, 24), (576, 1536, 72, 192),
                (1536, 576, 192, 72), (576, 49152, 72, 6144),
                (50, 70, 16, 32)]
ROWS = (1, 8, 32, 33, 64, 65, 1024)


@pytest.mark.parametrize("kdim,n,bk,bn", SERVE_SHAPES + [(0, 8, 4, 4),
                                                        (40, 8, 128, 4)])
@pytest.mark.parametrize("transpose", [False, True])
def test_matmul_segments_depend_on_contraction_only(kdim, n, bk, bn,
                                                    transpose):
    """The kernel's segments tile the contraction in order, never cross a
    mask-tile row, fit the kernel's stages, and are the same for every M
    and launch regime."""
    c, no, bc = (n, kdim, bn) if transpose else (kdim, n, bk)
    bounds = TBSM.segment_bounds(c, bc)
    flat = [i for lo, hi in bounds for i in range(lo, hi)]
    assert flat == list(range(c))
    for lo, hi in bounds:
        assert lo // bc == (hi - 1) // bc
        assert hi - lo <= TBSM.SEG_MAX
    plans = [TBSM.launch_plan(m, c, no, bc, 132) for m in ROWS]
    assert {(p.nsub, p.seg_len, p.nseg) for p in plans} \
        == {TBSM.segments(c, bc)}
    for p in plans:     # the kernel's limits: 16 CTAs, 4 segments each
        assert p.cluster <= min(16, p.nseg)
        assert not p.cluster or p.nseg <= 4 * p.cluster


def test_matmul_plan_spreads_the_decode_products():
    """At decode batch (M = 32) the narrow serving products split their
    segments over a cluster of CTAs a strip (8x to 16x the CTAs of one
    CTA a strip) and the unembedding walks 768 strips."""
    ctas = {(kdim, n): TBSM.launch_plan(32, kdim, n, bk, 132).ctas
            for kdim, n, bk, bn in SERVE_SHAPES[:5]}
    assert ctas == {(576, 576): 72, (576, 192): 24, (576, 1536): 192,
                    (1536, 576): 144, (576, 49152): 768}


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

def _decode_case(seed=5, b=3, h=6, hkv=3, hd=8, s=40):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    pos = np.array([0, 17, 39], np.int32)[:b]
    return q, k, v, pos


@needs_jax
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("mask", [None, [1, 0, 1], [0, 0, 0]])
def test_decode_plain_matches_reference(mask, window):
    q, k, v, pos = _decode_case()
    hm = None if mask is None else np.asarray(mask, np.float32)
    got = TOPS.flash_decode(torch.as_tensor(q), torch.as_tensor(k),
                            torch.as_tensor(v), torch.as_tensor(pos),
                            window=window, head_mask=hm)
    pallas = JOPS.flash_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(pos), block_s=16,
                               window=window, head_mask=hm, impl="pallas",
                               interpret=True)
    _close(got, pallas)
    _close(got, JREF.decode_attention(q, k, v, pos, window=window,
                                      head_mask=hm))


def test_decode_ignores_the_stale_tail_beyond_pos():
    """A recycled slot's old keys past ``pos`` change nothing."""
    q, k, v, pos = (torch.as_tensor(a) for a in _decode_case())
    k2, v2 = k.clone(), v.clone()
    for row, p in enumerate(pos.tolist()):
        k2[row, p + 1:] = 1e3
        v2[row, p + 1:] = -1e3
    torch.testing.assert_close(TOPS.flash_decode(q, k2, v2, pos),
                               TOPS.flash_decode(q, k, v, pos),
                               rtol=0, atol=0)


def test_decode_on_cpu_counts_nothing_and_checks_shapes():
    q, k, v, pos = (torch.as_tensor(a) for a in _decode_case())
    before = TDA.decode_attention.launches
    TDA.decode_attention(q, k, v, pos)
    assert TDA.decode_attention.launches == before
    with pytest.raises(ValueError):
        TDA.decode_attention(q, k, v, pos[:2])
    with pytest.raises(ValueError):
        TDA.decode_attention(q, k, v, pos, head_mask=torch.ones(2))
    with pytest.raises(ValueError):
        TDA.decode_attention(q[:, :5], k, v, pos)


# ---------------------------------------------------------------------------
# Flash prefill
# ---------------------------------------------------------------------------

def _prefill_case(seed=6, b=2, s=24, t=24, h=4, hkv=2, hd=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, hd)).astype(np.float32)
    return q, k, v


@needs_jax
@pytest.mark.parametrize("causal,window,mask", [
    (True, None, None), (True, None, [0, 1]), (False, None, [1, 0]),
    (True, 5, None), (False, 7, [1, 1])])
def test_prefill_plain_matches_reference(causal, window, mask):
    q, k, v = _prefill_case()
    hm = None if mask is None else np.asarray(mask, np.float32)
    got = TOPS.flash_prefill(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=causal,
                             window=window, head_mask=hm)
    pallas = JOPS.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                block_q=8, block_s=8, head_mask=hm,
                                impl="pallas", interpret=True)
    _close(got, pallas)
    _close(got, JREF.prefill_attention(q, k, v, causal=causal, window=window,
                                       head_mask=hm))


@needs_jax
@pytest.mark.parametrize("causal", [True, False])
def test_prefill_ragged_t_valid_matches_reference(causal):
    """Keys at and past ``t_valid`` are masked: against the Pallas kernel
    (block multiples, as its wrapper would pad) and the oracle."""
    q, k, v = _prefill_case(s=16, t=24)
    hm = np.asarray([1, 0], np.float32)
    got = TFP.flash_prefill(torch.as_tensor(q), torch.as_tensor(k),
                            torch.as_tensor(v), causal=causal, t_valid=19,
                            head_mask=torch.as_tensor(hm))
    pallas = JFP.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=8, block_s=8, causal=causal,
                               t_valid=19, head_mask=jnp.asarray(hm),
                               interpret=True)
    _close(got, pallas)
    _close(got, JREF.prefill_attention(q, k, v, causal=causal, t_valid=19,
                                       head_mask=hm))


def test_prefill_on_cpu_counts_nothing_and_checks_shapes():
    q, k, v = (torch.as_tensor(a) for a in _prefill_case())
    before = TFP.flash_prefill.launches
    TFP.flash_prefill(q, k, v)
    assert TFP.flash_prefill.launches == before
    with pytest.raises(ValueError):
        TFP.flash_prefill(q, k[:, :, :1], v)
    with pytest.raises(ValueError):
        TFP.flash_prefill(q, k, v, t_valid=25)


def _no_valid_key_case(kind):
    """Inputs where some query rows see no valid key: decode rows whose
    window lies past the cache's end, a prefill with ``t_valid = 0``."""
    if kind == "decode":
        q, k, v, _ = _decode_case(s=40)
        return dict(q=q, k=k, v=v, pos=np.array([5, 45, 60], np.int32),
                    window=5), [1, 2]
    q, k, v = _prefill_case(s=16, t=24)
    return dict(q=q, k=k, v=v, causal=False, t_valid=0), [0, 1]


def _port_attention(kind, case, device="cpu"):
    t = {n: torch.as_tensor(a, device=device) if isinstance(a, np.ndarray)
         else a for n, a in case.items()}
    if kind == "decode":
        return TDA.decode_attention(t["q"], t["k"], t["v"], t["pos"],
                                    window=t["window"])
    return TFP.flash_prefill(t["q"], t["k"], t["v"], causal=t["causal"],
                             t_valid=t["t_valid"])


@needs_jax
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_rows_without_a_valid_key_match_reference(kind):
    """Such a row outputs zeros, as the Pallas kernel (interpret mode) and
    the CUDA kernels do."""
    case, empty = _no_valid_key_case(kind)
    got = _port_attention(kind, case)
    j = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
         for n, a in case.items()}
    if kind == "decode":
        want = JOPS.flash_decode(j["q"], j["k"], j["v"], j["pos"], block_s=16,
                                 window=j["window"], impl="pallas",
                                 interpret=True)
    else:
        want = JFP.flash_prefill(j["q"], j["k"], j["v"], block_q=8, block_s=8,
                                 causal=False, t_valid=0, interpret=True)
    _close(got, want)
    assert float(got[empty].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
def test_matmul_kernels_match_plain_on_gpu():
    g = _card()
    for m, kdim, n, bk, bn in [(5, 50, 70, 16, 32), (32, 576, 192, 72, 24),
                               (1, 1536, 576, 192, 72),
                               (33, 576, 49152, 72, 6144)]:
        x = torch.randn(m, kdim, generator=g, device="cuda")
        xt = torch.randn(m, n, generator=g, device="cuda")
        w = torch.randn(kdim, n, generator=g, device="cuda")
        for rho in (0.0, 0.5, 1.0):
            keep = (torch.rand(-(-kdim // bk), -(-n // bn), generator=g,
                               device="cuda") >= rho).float()
            before = TBSM.block_sparse_matmul.launches
            y = TBSM.block_sparse_matmul(x, w, keep, bk, bn)
            yt = TBSM.block_sparse_matmul_t(xt, w, keep, bk, bn)
            torch.cuda.synchronize()
            assert TBSM.block_sparse_matmul.launches == before + 1
            assert _rel(y, TBSM.block_sparse_matmul_plain(
                x, w, keep, bk, bn)) <= 1e-4
            assert _rel(yt, TBSM.block_sparse_matmul_plain(
                xt, w, keep, bk, bn, True)) <= 1e-4
            if rho == 1.0:
                assert float(y.abs().max()) == 0.0
    # a row's result does not depend on M
    full = TBSM.block_sparse_matmul(x, w, keep.fill_(1.0), bk, bn)
    torch.testing.assert_close(TBSM.block_sparse_matmul(x[3:4], w, keep,
                                                        bk, bn),
                               full[3:4], rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kdim,n,bk,bn", SERVE_SHAPES)
def test_matmul_rows_bitwise_independent_of_m_on_gpu(kdim, n, bk, bn,
                                                     transpose):
    """Rows of M = 1 ... 1024 are bitwise the rows of the M = 1024
    product, at rho = 0.5 on an un-masked W, in every regime the kernel
    admits at each M: the walk, and the split at each cluster size the
    segment count allows (32- and 64-row tiles alike); the full product
    agrees with the plain version."""
    g = _card()
    fn = TBSM.block_sparse_matmul_t if transpose else TBSM.block_sparse_matmul
    name = "bsmm_transposed" if transpose else "bsmm_forward"
    w = torch.randn(kdim, n, generator=g, device="cuda")
    keep = (torch.rand(-(-kdim // bk), -(-n // bn), generator=g,
                       device="cuda") >= 0.5).float()
    x = torch.randn(max(ROWS), n if transpose else kdim, generator=g,
                    device="cuda")
    full = fn(x, w, keep, bk, bn)
    assert _rel(full, TBSM.block_sparse_matmul_plain(
        x, w, keep, bk, bn, transpose)) <= 1e-4
    c, bc = (n, bn) if transpose else (kdim, bk)
    nseg = TBSM.segments(c, bc)[2]
    # the kernel's split takes clusters of up to 16 CTAs, 4 segments each
    clusters = [0] + [cs for cs in (8, TBSM.CLUSTER_MAX)
                      if cs <= nseg <= 4 * cs]
    ran = set()
    for m in ROWS:
        for cs in clusters:
            got = TBSM._run(fn, name, x[:m], w, keep, bk, bn, transpose,
                            cluster=cs)
            assert torch.equal(got, full[:m]), (m, cs)
            ran.add(bool(cs))
    # both regimes ran wherever the kernel admits a split (every shape
    # but the transposed unembedding's 512-segment contraction)
    assert ran == ({False, True} if nseg <= 4 * TBSM.CLUSTER_MAX
                   else {False})


@pytest.mark.gpu
@pytest.mark.parametrize("transpose", [False, True])
def test_matmul_strip_straddling_kept_and_dropped_tiles_on_gpu(transpose):
    """Mask tiles of 40 columns (rows, transposed) cut the kernel's
    64-wide strips; W is not pre-masked, so the mask must mask."""
    g = _card()
    kdim, n, bk, bn = (200, 96, 40, 32) if transpose else (96, 200, 32, 40)
    fn = TBSM.block_sparse_matmul_t if transpose else TBSM.block_sparse_matmul
    w = torch.randn(kdim, n, generator=g, device="cuda")
    keep = torch.zeros(-(-kdim // bk), -(-n // bn), device="cuda")
    if transpose:
        keep[0::2, :] = 1.0      # output tiles 0, 2, 4 kept
        keep[1, 1] = 1.0         # output tile 1 live in one segment only
    else:
        keep[:, 0::2] = 1.0
        keep[1, 1] = 1.0
    for m in (3, 40, 100):
        x = torch.randn(m, n if transpose else kdim, generator=g,
                        device="cuda")
        y = fn(x, w, keep, bk, bn)
        assert _rel(y, TBSM.block_sparse_matmul_plain(
            x, w, keep, bk, bn, transpose)) <= 1e-4
        dense = x @ (w.T if transpose else w)
        assert _rel(y, dense) > 0.1          # the mask changed the result
        dropped = (keep.sum(1) if transpose else keep.sum(0)) == 0
        cols = torch.repeat_interleave(dropped, bk if transpose else bn)
        assert float(y[:, cols[:y.shape[1]]].abs().max()) == 0.0


@pytest.mark.gpu
def test_attention_kernels_match_plain_on_gpu():
    g = _card()
    for b, s, h, hkv, hd, window, hm in [(3, 40, 6, 3, 8, None, [1, 0, 1]),
                                         (32, 2048, 9, 3, 64, 100, None)]:
        q = torch.randn(b, h, hd, generator=g, device="cuda")
        k = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
        v = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
        pos = torch.randint(0, s, (b,), generator=g, device="cuda")
        pos[0] = 0
        hmt = None if hm is None else torch.tensor(hm, device="cuda",
                                                   dtype=torch.float32)
        got = TDA.decode_attention(q, k, v, pos, window, hmt)
        assert _rel(got, TDA.decode_attention_plain(q, k, v, pos, window,
                                                    hmt)) <= 1e-4
    for causal, window, t_valid, hm in [(True, None, None, [0, 1, 1]),
                                        (False, 7, 45, None)]:
        q = torch.randn(4, 50, 9, 64, generator=g, device="cuda")
        k = torch.randn(4, 50, 3, 64, generator=g, device="cuda")
        v = torch.randn(4, 50, 3, 64, generator=g, device="cuda")
        hmt = None if hm is None else torch.tensor(hm, device="cuda",
                                                   dtype=torch.float32)
        got = TFP.flash_prefill(q, k, v, causal, window, t_valid, hmt)
        assert _rel(got, TFP.flash_prefill_plain(q, k, v, causal, window,
                                                 t_valid, hmt)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("s", [40, 128, 2048])
@pytest.mark.parametrize("group,hd", [(3, 64), (4, 64), (7, 128), (1, 40)])
def test_decode_rows_bitwise_independent_of_batch_on_gpu(group, hd, s):
    """smollm-135m's (G = 3, hd = 64), granite-3-2b's (4, 64), qwen2-7b's
    (7, 128) and a head_dim that is no multiple of 32, at caches shorter
    than a chunk of keys' multiple (40), at the serving page (128) and long
    (2048, a cluster of CTAs a row): a row's output is bitwise the same in
    a batch of 32, of 8 and alone, and on a rerun, and within 1e-4 of the
    plain version; rows at pos = 0, pos >= S, windows (one past the
    cache's end: zeros) and a dead head."""
    g = _card()
    b, hkv = 32, 2
    q = torch.randn(b, hkv * group, hd, generator=g, device="cuda")
    k = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
    v = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
    pos = torch.randint(0, s, (b,), generator=g, device="cuda")
    pos[0], pos[1], pos[2], pos[3] = 0, s - 1, s + 3, s + 200
    dead = torch.tensor([0.0, 1.0], device="cuda")
    for window, hm in [(None, None), (None, dead), (s // 3 + 1, None),
                       (50, dead)]:
        full = TDA.decode_attention(q, k, v, pos, window, hm)
        assert _rel(full, TDA.decode_attention_plain(q, k, v, pos, window,
                                                     hm)) <= 1e-4
        assert torch.equal(full, TDA.decode_attention(q, k, v, pos, window,
                                                      hm))
        assert torch.equal(TDA.decode_attention(q[8:16], k[8:16], v[8:16],
                                                pos[8:16], window, hm),
                           full[8:16])
        for row in (0, 1, 2, 3, 17, 31):
            one = slice(row, row + 1)
            assert torch.equal(TDA.decode_attention(q[one], k[one], v[one],
                                                    pos[one], window, hm),
                               full[one]), (window, row)
        if hm is not None:
            assert float(full[:, :group].abs().max()) == 0.0
        if window == 50:   # row 3's window lies past the cache's end
            assert float(full[3].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("group,hd", [(4, 64), (7, 128), (1, 40)])
@pytest.mark.parametrize("causal,window,t_valid", [(True, None, 37),
                                                   (True, 9, 50),
                                                   (False, 13, 29)])
def test_prefill_groups_and_head_dims_match_plain_on_gpu(group, hd, causal,
                                                         window, t_valid):
    """granite-3-2b's (G = 4, hd = 64) and qwen2-7b's (G = 7, hd = 128)
    head layouts, and a head_dim that is no multiple of 32, with ragged
    t_valid, windows and a dead KV head; reruns bitwise identical."""
    g = _card()
    b, s, hkv = 3, 50, 2
    q = torch.randn(b, s, hkv * group, hd, generator=g, device="cuda")
    k = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
    v = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
    hm = torch.tensor([1.0, 0.0], device="cuda")
    got = TFP.flash_prefill(q, k, v, causal, window, t_valid, hm)
    want = TFP.flash_prefill_plain(q, k, v, causal, window, t_valid, hm)
    assert _rel(got, want) <= 1e-4
    assert float(got[:, :, group:].abs().max()) == 0.0
    assert torch.equal(got, TFP.flash_prefill(q, k, v, causal, window,
                                              t_valid, hm))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_rows_without_a_valid_key_match_plain_on_gpu(kind):
    _card()
    case, empty = _no_valid_key_case(kind)
    got = _port_attention(kind, case, "cuda").cpu()
    torch.testing.assert_close(got, _port_attention(kind, case), rtol=1e-4,
                               atol=1e-4)
    assert float(got[empty].abs().max()) == 0.0


@pytest.mark.gpu
def test_kernels_refuse_bad_operands_on_gpu():
    _card()
    w = torch.randn(50, 70, device="cuda")
    keep = torch.ones(4, 3, device="cuda")
    with pytest.raises(ValueError, match="operands on"):
        TBSM.block_sparse_matmul(torch.randn(5, 50), w, keep, 16, 32)
    with pytest.raises(TypeError):
        TBSM.block_sparse_matmul(torch.randn(5, 50, device="cuda").double(),
                                 w, keep, 16, 32)
    with pytest.raises(ValueError):
        TBSM.block_sparse_matmul(torch.randn(5, 50, device="cuda"), w,
                                 torch.ones(3, 3, device="cuda"), 16, 32)
    q = torch.randn(2, 4, 8, device="cuda")
    k = torch.randn(2, 16, 2, 8, device="cuda")
    with pytest.raises(ValueError, match="operands on"):
        TDA.decode_attention(q, k, k, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        TDA.decode_attention(torch.randn(2, 4, 256, device="cuda"),
                             torch.randn(2, 16, 2, 256, device="cuda"),
                             torch.randn(2, 16, 2, 256, device="cuda"),
                             torch.zeros(2, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError):
        TFP.flash_prefill(torch.randn(2, 16, 4, 256, device="cuda"),
                          torch.randn(2, 16, 2, 256, device="cuda"),
                          torch.randn(2, 16, 2, 256, device="cuda"))
    with pytest.raises(ValueError, match="operands on"):
        TFP.flash_prefill(q[:, None], k, k.cpu())
