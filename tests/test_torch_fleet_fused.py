"""The port's fused pruned-gradient op against the reference's kernels.

The plain version (what runs on the CPU) is held to
``repro.kernels.fleet_fused.fused_grads_xla`` in float64 at 1e-5 (both
run the same tile loop; float64 leaves only summation-order noise), and
in float32 to ``fused_grads_pallas(..., interpret=True)`` — the Pallas
kernel, run as the reference's own tests run it — at 1e-4 (float32
reductions in different orders over ~100 rows).  Dims 32->12->6->5 with
block 8 make every layer's edge tiles ragged; the batch has an
all-pruned client, zero-weight clients and a client count that is not a
multiple of the Pallas client tile (8).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import fleet_fused as TFF

try:  # the card's machine has no JAX: only the gpu tests run there
    import jax
    import jax.numpy as jnp
    from repro.kernels import fleet_fused as JFF
except ImportError:
    JFF = None
needs_jax = pytest.mark.skipif(JFF is None, reason="needs the JAX reference")

BLOCK = 8
SIZES = (32, 12, 6, 5)


def _problem(c=13, batch=8, seed=0, sizes=SIZES):
    """Numpy params, batch, rates and weights; client 1 keeps nothing."""
    rng = np.random.default_rng(seed)
    params = {f"layer{i}": {"w": rng.normal(size=(a, b)) * np.sqrt(2.0 / a),
                            "b": 0.1 * rng.normal(size=(b,))}
              for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    x = rng.normal(size=(c, batch, sizes[0]))
    y = rng.integers(0, sizes[-1], (c, batch))
    rho = np.concatenate([[0.0, 0.7], rng.uniform(0, 0.7, c - 2)])
    w = rng.uniform(0, 50, c)
    w[[0, c // 2]] = 0.0
    return params, x, y, rho, w


def _keeps_np(params, rho):
    """Reference keeps (float32), with client 1 pruned to nothing."""
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    keeps = JFF.layer_keeps(JFF.layer_norm_states(p, BLOCK),
                            jnp.asarray(rho, jnp.float32))
    keeps = [np.asarray(k).copy() for k in keeps]
    for k in keeps:
        k[1] = 0.0
    return keeps


def _torch_tree(tree, dtype):
    return {k: {n: torch.as_tensor(v, dtype=dtype) for n, v in d.items()}
            for k, d in tree.items()}


def _run_torch(params, x, y, keeps, w, dtype):
    return TFF.fused_fleet_grads(
        _torch_tree(params, dtype), torch.as_tensor(x, dtype=dtype),
        torch.as_tensor(y), [torch.as_tensor(k) for k in keeps],
        torch.as_tensor(w, dtype=dtype), BLOCK)


def _assert_grads_close(got, ref, rtol, atol):
    for name in ref:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got[name][leaf].numpy(),
                                       np.asarray(ref[name][leaf]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{name}/{leaf}")


@needs_jax
@pytest.mark.parametrize("sizes", [SIZES, (32, 12, 5)])
def test_plain_matches_fused_grads_xla_in_float64(sizes):
    params, x, y, rho, w = _problem(sizes=sizes)
    keeps = _keeps_np(params, rho)
    with jax.enable_x64(True):
        g_ref, l_ref = JFF.fused_grads_xla(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y),
            [jnp.asarray(k) for k in keeps], jnp.asarray(w), BLOCK)
        g_ref = jax.tree.map(np.asarray, g_ref)
        l_ref = np.asarray(l_ref)
    g, losses = _run_torch(params, x, y, keeps, w, torch.float64)
    assert losses.shape == (x.shape[0],)
    _assert_grads_close(g, g_ref, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(losses.numpy(), l_ref, rtol=1e-5)


@needs_jax
def test_plain_matches_pallas_interpret_in_float32():
    params, x, y, rho, w = _problem(c=11)
    keeps = _keeps_np(params, rho)
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    g_ref, l_ref = JFF.fused_grads_pallas(
        p32, jnp.asarray(x, jnp.float32), jnp.asarray(y),
        [jnp.asarray(k) for k in keeps], jnp.asarray(w, jnp.float32), BLOCK,
        interpret=True)
    g, losses = _run_torch(params, x, y, keeps, w, torch.float32)
    _assert_grads_close(g, jax.tree.map(np.asarray, g_ref), rtol=1e-4,
                        atol=1e-4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(l_ref), rtol=1e-4)


@needs_jax
def test_plain_matches_vmap_autodiff_oracle():
    """Against per-client autodiff on the masked model (the reference's
    oracle), at float64: keeps built from rho by the reference."""
    params, x, y, rho, w = _problem(c=9, seed=3)
    with jax.enable_x64(True):
        jp = jax.tree.map(jnp.asarray, params)
        g_ref, l_ref = JFF.reference_grads(jp, jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(rho), jnp.asarray(w),
                                           BLOCK)
        keeps = [np.array(k) for k in JFF.layer_keeps(
            JFF.layer_norm_states(jp, BLOCK), jnp.asarray(rho))]
        g_ref = jax.tree.map(np.asarray, g_ref)
    g, losses = _run_torch(params, x, y, keeps, w, torch.float64)
    _assert_grads_close(g, g_ref, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(losses.numpy(), np.asarray(l_ref), rtol=1e-5)


@needs_jax
def test_reference_grads_match_jax_vmap_oracle_in_float64():
    """The port's vmap oracle (``torch.func`` per-client autodiff under
    ``block_masks``) against the reference's, on the same inputs."""
    params, x, y, rho, w = _problem(c=9, seed=5)
    with jax.enable_x64(True):
        g_ref, l_ref = JFF.reference_grads(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(rho), jnp.asarray(w), BLOCK)
        g_ref = jax.tree.map(np.asarray, g_ref)
    g, losses = TFF.reference_grads(
        _torch_tree(params, torch.float64), torch.as_tensor(x),
        torch.as_tensor(y), torch.as_tensor(rho), torch.as_tensor(w), BLOCK)
    _assert_grads_close(g, g_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(losses.numpy(), np.asarray(l_ref), rtol=1e-9)


@needs_jax
def test_all_pruned_and_zero_weight_clients():
    params, x, y, rho, w = _problem()
    keeps = _keeps_np(params, rho)
    g, _ = _run_torch(params, x, y, keeps, w, torch.float64)
    # dropping the all-pruned client changes no weight gradient
    w1 = w.copy()
    w1[1] = 0.0
    g1, _ = _run_torch(params, x, y, keeps, w1, torch.float64)
    for name in g:
        torch.testing.assert_close(g[name]["w"], g1[name]["w"])
    # zero-weight clients contribute nothing at all
    keep_idx = np.flatnonzero(w > 0)
    g2, _ = _run_torch(params, x[keep_idx], y[keep_idx],
                       [k[keep_idx] for k in keeps], w[keep_idx],
                       torch.float64)
    for name in g:
        for leaf in ("w", "b"):
            torch.testing.assert_close(g[name][leaf], g2[name][leaf])


@needs_jax
def test_cpu_tensors_take_the_plain_version():
    params, x, y, rho, w = _problem(c=4)
    keeps = _keeps_np(params, rho)
    before = TFF.fused_fleet_grads.launches
    g, l = _run_torch(params, x, y, keeps, w, torch.float32)
    g2, l2 = TFF.fused_grads_plain(
        _torch_tree(params, torch.float32), torch.as_tensor(x).float(),
        torch.as_tensor(y), [torch.as_tensor(k) for k in keeps],
        torch.as_tensor(w).float(), BLOCK)
    assert TFF.fused_fleet_grads.launches == before
    torch.testing.assert_close(l, l2, rtol=0, atol=0)
    torch.testing.assert_close(g, g2, rtol=0, atol=0)


def _operands(c, dev):
    """Wrapper keyword arguments for ``_problem(c)`` on ``dev`` (float32;
    keeps from the port's own ``layer_keeps``)."""
    params, x, y, rho, w = _problem(c=c)
    tp = {k: {n: t.to(dev) for n, t in d.items()}
          for k, d in _torch_tree(params, torch.float32).items()}
    keeps = TFF.layer_keeps(TFF.layer_norm_states(tp, BLOCK),
                            torch.as_tensor(rho, dtype=torch.float32,
                                            device=dev))
    return dict(params=tp, x=torch.as_tensor(x, dtype=torch.float32,
                                             device=dev),
                y=torch.as_tensor(y, device=dev), keeps=keeps,
                weights=torch.as_tensor(w, dtype=torch.float32, device=dev),
                block=BLOCK)


_MISSHAPEN = {
    "keeps_tile_grid": lambda a: {
        **a, "keeps": [a["keeps"][0][:, :-1]] + a["keeps"][1:]},
    "keeps_clients": lambda a: {**a, "keeps": [k[:-1] for k in a["keeps"]]},
    "keeps_layers": lambda a: {**a, "keeps": a["keeps"][:-1]},
    "weights": lambda a: {**a, "weights": a["weights"][:-1]},
    "y": lambda a: {**a, "y": a["y"].reshape(-1)},
}


@pytest.mark.parametrize("case", sorted(_MISSHAPEN))
def test_misshapen_operands_raise(case):
    """Operands the kernel would read out of bounds are refused before any
    launch, on the CPU as on the card."""
    before = TFF.fused_fleet_grads.launches
    with pytest.raises(ValueError):
        TFF.fused_fleet_grads(**_MISSHAPEN[case](_operands(9, "cpu")))
    assert TFF.fused_fleet_grads.launches == before


@pytest.mark.parametrize("rows", [1, 31, 32, 1000, 8008, 80000, 10 ** 6])
def test_segments_cover_rows_in_fixed_order(rows):
    """The dW passes' row segments depend on the row count alone (never on
    the card), cover every row once, and are never shorter than a staged
    chunk unless one segment holds every row."""
    seg_rows, nseg = TFF.segments(rows)
    assert nseg * seg_rows >= rows > (nseg - 1) * seg_rows
    assert nseg <= TFF._SEGMENTS
    assert seg_rows >= TFF._ROWS_STAGED
    if rows == 80000:  # the slice: 7 x 150 input-layer dW CTAs
        assert (seg_rows, nseg) == (534, 150)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_MISSHAPEN) + ["y_on_cpu"])
def test_cuda_kernel_refuses_bad_operands_on_gpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _operands(9, "cuda")
    bad = ({**args, "y": args["y"].cpu()} if case == "y_on_cpu"
           else _MISSHAPEN[case](args))
    before = TFF.fused_fleet_grads.launches
    with pytest.raises(ValueError):
        TFF.fused_fleet_grads(**bad)
    assert TFF.fused_fleet_grads.launches == before
    TFF.fused_fleet_grads(**args)  # the context is still sound
    torch.cuda.synchronize()


def _on_grid(v, step, bound):
    return np.clip(np.round(v / step), -bound, bound) * step


def _card_args(c, batch, block, sizes=(784, 60, 20, 10)):
    """Wrapper arguments for ``_problem`` on the card (float32): client 1
    keeps nothing, clients 0 and c // 2 weigh nothing.

    x, the weights and biases of the layers that a ReLU follows are put on
    dyadic grids (x on quarters in [-1, 1], those weights on 1/64ths in
    [-1/8, 1/8]) on which every partial sum of their forward products is
    exact in float32, in any order.  Both sides then see the same ReLU
    gates: with 80,000 rows some pre-activations otherwise lie within
    float32 rounding of zero, and a gate that two summation orders set
    differently moves dW by a whole row's term."""
    params, x, y, rho, w = _problem(c=c, batch=batch, sizes=sizes)
    x = _on_grid(x, 0.25, 4)
    fan = 1
    for l in range(len(params) - 1):  # the layers a ReLU follows
        step = 2.0 ** -(2 + 6 * (l + 1))  # the grid of this layer's sums
        params[f"layer{l}"] = {
            "w": _on_grid(params[f"layer{l}"]["w"], 1 / 64, 8 // fan),
            "b": _on_grid(params[f"layer{l}"]["b"], step, 2 / step)}
        fan *= 2
    dev = "cuda"
    tp = {k: {n: t.to(dev) for n, t in d.items()}
          for k, d in _torch_tree(params, torch.float32).items()}
    keeps = TFF.layer_keeps(TFF.layer_norm_states(tp, block),
                            torch.as_tensor(rho, dtype=torch.float32,
                                            device=dev))
    for k in keeps:  # client 1 keeps nothing
        k[1] = 0.0
    return (tp, torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(y, device=dev), keeps,
            torch.as_tensor(w, dtype=torch.float32, device=dev), block)


def _assert_matches_plain(args):
    """One kernel call against the plain version run in float64 on the
    same inputs (1e-4: float32 sums of the backward in another order)."""
    before = TFF.fused_fleet_grads.launches
    g, losses = TFF.fused_fleet_grads(*args)
    torch.cuda.synchronize()
    assert TFF.fused_fleet_grads.launches == before + 1
    params, x, y, keeps, w, block = args
    g_ref, l_ref = TFF.fused_grads_plain(
        {k: {n: t.double() for n, t in d.items()} for k, d in params.items()},
        x.double(), y, [k.double() for k in keeps], w.double(), block)
    torch.testing.assert_close(losses, l_ref.float(), rtol=1e-4, atol=1e-5)
    for name in g:
        for leaf in ("w", "b"):
            ref = g_ref[name][leaf].float()
            scale = float(ref.abs().max()) + 1e-6
            torch.testing.assert_close(g[name][leaf], ref, rtol=1e-4,
                                       atol=1e-4 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [13, 1001, 10000])
@pytest.mark.parametrize("batch", [8, 5, 1])
@pytest.mark.parametrize("block", [4, 8, 16, 32])
def test_cuda_kernel_matches_plain_on_gpu(block, batch, c):
    """The CUDA kernel against the plain version on the card at the
    paper's 784-60-20-10 DNN: every pruning block; batches 5 and 1 put
    rows of several clients in one thread's 8-row group and in one staged
    chunk; C = 13 and 1001 are no multiple of any tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _card_args(c, batch, block)
    _assert_matches_plain(args)
    with pytest.raises(TypeError):
        TFF.fused_fleet_grads(args[0], args[1].double(), *args[2:])


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [(30, 14, 6, 5), (132, 68, 7)])
def test_cuda_kernel_unaligned_widths_match_plain_on_gpu(sizes):
    """Widths that are no multiple of 4 floats take the kernels' 4-byte
    copies (30, 14); 132 -> 68 spans two k blocks and two column blocks of
    the input layer's tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _assert_matches_plain(_card_args(37, 5, 4, sizes))
    _assert_matches_plain(_card_args(37, 8, 8, sizes))


@pytest.mark.gpu
@pytest.mark.parametrize("block, batch", [(8, 8), (4, 5)])
def test_cuda_kernel_repeats_bitwise_on_gpu(block, batch):
    """Two calls on the same inputs give bitwise-equal grads and losses:
    every sum has a fixed order (no float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _card_args(10000, batch, block)
    g1, l1 = TFF.fused_fleet_grads(*args)
    g2, l2 = TFF.fused_fleet_grads(*args)
    torch.cuda.synchronize()
    assert torch.equal(l1, l2)
    for name in g1:
        for leaf in ("w", "b"):
            assert torch.equal(g1[name][leaf], g2[name][leaf]), name


@pytest.mark.gpu
def test_reference_grads_match_fused_kernel_on_gpu():
    """The vmap oracle on the card (one tile-norm launch for its block
    masks) against the fused kernel at the paper's DNN, 1e-4 of scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import block_norms as TBN
    c, batch = 64, 8
    params, x, y, _, w, _ = _card_args(c, batch, BLOCK)
    rho = torch.as_tensor(_problem(c=c, batch=batch,
                                   sizes=(784, 60, 20, 10))[3],
                          dtype=torch.float32, device="cuda")
    before = TBN.tile_norms.launches
    g_ref, l_ref = TFF.reference_grads(params, x, y, rho, w, BLOCK)
    torch.cuda.synchronize()
    assert TBN.tile_norms.launches == before + 1
    keeps = TFF.layer_keeps(TFF.layer_norm_states(params, BLOCK), rho)
    g, losses = TFF.fused_fleet_grads(params, x, y, keeps, w, BLOCK)
    torch.testing.assert_close(losses, l_ref, rtol=1e-4, atol=1e-5)
    for name in g:
        for leaf in ("w", "b"):
            scale = float(g_ref[name][leaf].abs().max()) + 1e-6
            torch.testing.assert_close(g[name][leaf], g_ref[name][leaf],
                                       rtol=1e-4, atol=1e-4 * scale)
