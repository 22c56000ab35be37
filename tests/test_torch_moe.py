"""The MoE FFN (``models/moe.py``) and the MoE configs: the port against
the JAX package.

Numpy inputs from a seed go through the reference's function and the
port's on the CPU.  ``moe_ffn`` in float64 under ``jax.enable_x64``:
outputs, the auxiliary loss and the parameters' gradients at 1e-10, with
a capacity that overflows (tokens dropped) and one that does not, gated
and not; x's gradient passes the router's float32 cast on both sides, so
it holds at 1e-6 of its scale.  ``expert_capacity`` exactly.  Then the
MoE block, the forward with its auxiliary loss and the loss's gradient at
1e-5 (the smoke config computes in float32), the MoE configs field by
field and at full width on ``meta`` tensors, a bfloat16 model's params
carried across with their own dtypes, and an olmoe-1b-7b fleet against
the JAX engine.  A ``gpu`` test holds ``moe_ffn`` on the card against the
CPU and across reruns.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import pruning as TPR
from repro_torch.fleet import task as TTASK
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

try:  # the card's machine has no JAX: only the gpu test runs there
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.fleet import engine as JENG
    from repro.fleet import task as JTASK
    from repro.fleet import topology as JTOPO
    from repro.models import blocks as JB
    from repro.models import model as JM
    from repro.models import moe as JMOE
except ImportError:
    JMOE = None
needs_jax = pytest.mark.skipif(JMOE is None, reason="needs the JAX reference")

TOL = dict(rtol=1e-5, atol=1e-5)
MOE_NAMES = ("olmoe-1b-7b", "grok-1-314b")


def _moe_case(d, e, k, f, gated, seed, shape):
    """float64 params (router included) and x, as numpy."""
    rng = np.random.default_rng(seed)
    p = {"router": {"w": rng.normal(size=(d, e))},
         "w_in": rng.normal(size=(e, d, f)) * d ** -0.5,
         "w_out": rng.normal(size=(e, f, d)) * f ** -0.5}
    if gated:
        p["w_gate"] = rng.normal(size=(e, d, f)) * d ** -0.5
    return p, rng.normal(size=shape + (d,))


CASES = [  # (E, k, capacity factor, gated, act)
    (6, 2, 1.25, True, "silu"),
    (6, 2, 0.5, True, "silu"),        # overflow: tokens dropped
    (4, 1, 0.25, False, "gelu"),      # capacity at its floor of top_k
    (8, 3, 2.0, True, "relu"),
]


def _j_moe(p, spec, x):
    """The reference's output, aux and gradients in float64, eager (under
    ``jax.jit`` XLA rounds the float32 token fractions differently)."""
    with jax.enable_x64(True):
        pj = jax.tree.map(jnp.asarray, p)

        def loss(pp, xx):
            y, aux = JMOE.moe_ffn(pp, spec, xx)
            return jnp.sum(y ** 2) + aux

        y, aux = JMOE.moe_ffn(pj, spec, jnp.asarray(x))
        gp, gx = jax.grad(loss, argnums=(0, 1))(pj, jnp.asarray(x))
        return (np.asarray(y), float(aux), jax.tree.map(np.asarray, gp),
                np.asarray(gx))


@needs_jax
@pytest.mark.parametrize("e,k,cf,gated,act", CASES)
def test_moe_ffn_matches_reference_float64(e, k, cf, gated, act):
    d, f = 16, 12
    p, x = _moe_case(d, e, k, f, gated, seed=e + k, shape=(3, 5))
    jspec = JMOE.MoESpec(e, k, f, capacity_factor=cf, gated=gated, act=act)
    tspec = TMOE.MoESpec(e, k, f, capacity_factor=cf, gated=gated, act=act)
    y_j, aux_j, gp_j, gx_j = _j_moe(p, jspec, x)
    tp = weights.tree_from_numpy(p, torch.float64, "cpu")
    tx = torch.as_tensor(x)
    y_t, aux_t = TMOE.moe_ffn(tp, tspec, tx)
    assert y_t.dtype == torch.float64
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-10, atol=1e-10)
    assert float(aux_t) == pytest.approx(aux_j, rel=1e-10, abs=1e-12)

    def loss(pp, xx):
        y, aux = TMOE.moe_ffn(pp, tspec, xx)
        return torch.sum(y ** 2) + aux

    gp_t, gx_t = torch.func.grad(loss, argnums=(0, 1))(tp, tx)
    for a, b in zip(TPR.flatten(gp_t), TPR.flatten(gp_j)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gx_t.numpy(), gx_j, rtol=0,
                               atol=1e-6 * np.abs(gx_j).max())


@needs_jax
def test_overflow_drops_tokens_like_reference():
    """At capacity factor 0.25 most routed tokens are dropped: some
    output rows are exactly 0 on both sides, at the same tokens."""
    p, x = _moe_case(8, 4, 2, 8, True, seed=3, shape=(2, 12))
    jspec = JMOE.MoESpec(4, 2, 8, capacity_factor=0.25)
    tspec = TMOE.MoESpec(4, 2, 8, capacity_factor=0.25)
    assert TMOE.expert_capacity(24, tspec) == 3    # 12 of 48 entries kept
    y_j = _j_moe(p, jspec, x)[0]
    y_t, _ = TMOE.moe_ffn(weights.tree_from_numpy(p, torch.float64, "cpu"),
                          tspec, torch.as_tensor(x))
    dropped_t = np.all(y_t.numpy() == 0.0, axis=-1)
    assert dropped_t.sum() >= 12
    np.testing.assert_array_equal(dropped_t, np.all(y_j == 0.0, axis=-1))


@needs_jax
@pytest.mark.parametrize("tokens", [1, 7, 64, 1000])
@pytest.mark.parametrize("e,k,cf", [(64, 8, 1.25), (8, 2, 1.25),
                                    (4, 2, 8.0), (6, 2, 0.1)])
def test_expert_capacity_matches_reference(tokens, e, k, cf):
    assert TMOE.expert_capacity(tokens, TMOE.MoESpec(e, k, 16, cf)) == \
        JMOE.expert_capacity(tokens, JMOE.MoESpec(e, k, 16, cf))


def test_moe_ffn_repeats_bitwise_and_under_vmap():
    p, x = _moe_case(16, 6, 2, 12, True, seed=9, shape=(4, 3, 5))
    tp = weights.tree_from_numpy(p, torch.float32, "cpu")
    tx = torch.as_tensor(x, dtype=torch.float32)
    spec = TMOE.MoESpec(6, 2, 12, capacity_factor=0.75)
    a = TMOE.moe_ffn(tp, spec, tx[1])
    b = TMOE.moe_ffn(tp, spec, tx[1])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ys, auxes = torch.func.vmap(lambda xx: TMOE.moe_ffn(tp, spec, xx))(tx)
    assert torch.equal(ys[1], a[0]) and torch.equal(auxes[1], a[1])


def test_init_moe_shapes_and_dtypes():
    spec = TMOE.MoESpec(4, 2, 24)
    p = TMOE.init_moe(torch.Generator().manual_seed(0), 32, spec,
                      torch.bfloat16)
    assert p["router"]["w"].shape == (32, 4)
    assert p["router"]["w"].dtype == torch.float32
    assert p["w_in"].shape == p["w_gate"].shape == (4, 32, 24)
    assert p["w_out"].shape == (4, 24, 32)
    assert p["w_in"].dtype == torch.bfloat16
    assert "w_gate" not in TMOE.init_moe(None, 32, dataclasses.replace(
        spec, gated=False), torch.float32)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_config_matches_reference(name):
    j, t = j_get_config(name), t_get_config(name)
    for f in ("name", "family", "source", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "head_dim_", "rope_theta",
              "qkv_bias", "norm", "act", "tie_embeddings", "local_window",
              "long_context_window", "param_dtype", "compute_dtype",
              "moe_capacity_factor", "num_layers"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t.moe_spec()) == dataclasses.asdict(
        j.moe_spec())
    js, ts = j.smoke_variant(), t.smoke_variant()
    assert dataclasses.asdict(ts.moe) == dataclasses.asdict(js.moe)
    assert [(s.repeats, [(b.kind, b.ffn) for b in s.blocks])
            for s in ts.stages] == [(s.repeats, [(b.kind, b.ffn)
                                                 for b in s.blocks])
                                    for s in js.stages]


@needs_jax
@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_full_width_params_on_meta_match_reference(name):
    """The full-width tree on ``meta`` tensors: the reference's leaf shapes
    and dtypes (the float32 router among bfloat16 experts) in its flatten
    order, and its param count."""
    shapes = jax.eval_shape(lambda k: JM.init_params(j_get_config(name), k),
                            jax.random.PRNGKey(0))
    t_params = TM.init_params(t_get_config(name), None)
    j_leaves = jax.tree_util.tree_leaves(shapes)
    t_leaves = TPR.flatten(t_params)
    assert [tuple(a.shape) for a in t_leaves] == \
        [tuple(a.shape) for a in j_leaves]
    assert [str(a.dtype).replace("torch.", "") for a in t_leaves] == \
        [str(a.dtype) for a in j_leaves]
    assert TM.param_count(t_params) == sum(a.size for a in j_leaves)


def test_moe_spec_refuses_a_dense_config():
    with pytest.raises(ValueError, match="no MoE spec"):
        t_get_config("smollm-135m").moe_spec()


# ---------------------------------------------------------------------------
# The MoE block and model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmoe_pair():
    """olmoe-1b-7b's smoke reduction: the reference's params as numpy and
    the port's copy."""
    cfg = j_get_config("olmoe-1b-7b").smoke_variant()
    params = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    return params, weights.tree_from_numpy(params, device="cpu")


def _cfgs(name="olmoe-1b-7b"):
    return j_get_config(name).smoke_variant(), t_get_config(name).smoke_variant()


@needs_jax
def test_moe_block_matches_reference(olmoe_pair):
    jp, tp = olmoe_pair
    jcfg, tcfg = _cfgs()
    x = np.random.default_rng(6).normal(size=(2, 16, 128)).astype(np.float32)
    bj = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["stages"][0]["b0"])
    bt = TPR.tree_map(lambda a: a[0], tp["stages"][0]["b0"])
    want, aux_j = JB.apply_block(jcfg, jcfg.stages[0].blocks[0], bj,
                                 jnp.asarray(x), None, None)
    got, aux_t = TB.apply_block(tcfg, tcfg.stages[0].blocks[0], bt,
                                torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-6)
    assert float(aux_t) > 0


@needs_jax
def test_moe_forward_loss_and_gradient_match_reference(olmoe_pair):
    jp, tp = olmoe_pair
    jcfg, tcfg = _cfgs()
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 16))
    jpj = jax.tree.map(jnp.asarray, jp)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jpj)
    (lt, mt) = TM.loss_fn(tcfg, tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(mt["moe_aux"]), float(mj["moe_aux"]),
                               rtol=1e-5)
    gt = torch.func.grad(lambda p: TM.loss_fn(
        tcfg, p, {"tokens": torch.as_tensor(toks)})[0])(tp)
    for a, b in zip(TPR.flatten(gt), jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@needs_jax
def test_bfloat16_moe_params_carry_across_with_their_dtypes():
    """A bfloat16 model's params from the reference (ml_dtypes bfloat16
    arrays) keep their own dtypes with ``dtype=None``: bfloat16 experts
    and attention, a float32 router, bit for bit."""
    cfg = j_get_config("olmoe-1b-7b").smoke_variant().replace(
        param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(1)))
    tp = weights.tree_from_numpy(jp, dtype=None, device="cpu")
    ffn = tp["stages"][0]["b0"]["ffn"]
    assert ffn["router"]["w"].dtype == torch.float32
    assert ffn["w_in"].dtype == torch.bfloat16 and ffn["w_in"].ndim == 4
    for a, b in zip(TPR.flatten(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.to(torch.float32).numpy(),
                                      b.astype(np.float32))


@needs_jax
@pytest.mark.parametrize("kernel", ["fused", "reference"])
def test_olmoe_fleet_run_matches_reference(kernel):
    """A TransformerTask(arch_name="olmoe-1b-7b") fleet (1 x 6 clients, 3
    rounds, block masks on the 4-D expert leaves) from the JAX engine's
    draws, params and token pool, in a float64 run: losses and params at
    1e-5."""
    from test_torch_transformer import _port_run, _reference_run, _tiny
    kw = dict(rounds=3, lr=0.5, kernel=kernel, mask_kind="block")
    jcfg = JENG.FleetConfig(
        task=JTASK.TransformerTask(arch_name="olmoe-1b-7b"),
        topology=JTOPO.FleetTopology(1, 6), **kw)
    tcfg = _tiny(task=TTASK.TransformerTask(arch_name="olmoe-1b-7b"), **kw)
    ref = _reference_run(jcfg)
    sim, res = _port_run(tcfg, ref)
    jr = ref["result"]
    assert any(leaf.ndim == 4 for leaf in TPR.flatten(sim.params))
    np.testing.assert_allclose(res.losses, jr.losses, rtol=1e-5, atol=1e-8)
    for a, b in zip(TPR.flatten(res.params), jax.tree.leaves(jr.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_moe_ffn_card_matches_cpu_and_reruns_bitwise_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, x = _moe_case(64, 8, 2, 48, True, seed=4, shape=(4, 16))
    spec = TMOE.MoESpec(8, 2, 48, capacity_factor=1.0)
    out = {}
    for dev in ("cpu", "cuda"):
        tp = weights.tree_from_numpy(p, torch.float32, dev)
        tx = torch.as_tensor(x, dtype=torch.float32, device=dev)
        out[dev] = TMOE.moe_ffn(tp, spec, tx)
        again = TMOE.moe_ffn(tp, spec, tx)
        assert torch.equal(out[dev][0], again[0])
        assert torch.equal(out[dev][1], again[1])
    np.testing.assert_allclose(out["cuda"][0].cpu().numpy(),
                               out["cpu"][0].numpy(), rtol=1e-4, atol=1e-4)
    assert float(out["cuda"][1]) == pytest.approx(float(out["cpu"][1]),
                                                  rel=1e-5)
