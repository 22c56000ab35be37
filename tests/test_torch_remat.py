"""Rematerialization: ``ArchConfig.remat`` and ``layers.checkpoint`` (the
port's ``jax.checkpoint``), and the RG-LRU's associative scan.

At each config's smoke width, with plain autograd (``torch.func``
transforms take no checkpoint, ``layers.checkpoint``): a dense GQA model
through flash attention (2,048 tokens: 4 query chunks x 2 key chunks, each
query chunk's body and key chunk's step checkpointed), MLA, a MoE, the
RG-LRU and a memory model (whisper-base's encoder and cross attention).
``remat="block"`` against ``"none"``: the loss and every gradient within
1e-6 relative, and more flops under ``launch.cost.CostMode`` (the
recompute ran).  ``"block"`` against the reference's loss and gradients
with its config at ``remat="block"``, at the suite's float32 tolerance
(1e-5).  An 8-layer model's peak live bytes under ``CostMode`` at least
3x lower with ``"block"``.  A ``"block"`` backward run on another thread
(as autograd runs a card's) recomputes under the forward's sharding
rules.  The RG-LRU at 4,096 positions traces fewer than 1% of the ops
of the stepped loop it replaced, forward and backward.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import StageSpec
from repro_torch.core import pruning as TPR
from repro_torch.launch.cost import CostMode
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR
from repro_torch.models import sharding as TS

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import model as JM
except ImportError:
    JM = None
needs_jax = pytest.mark.skipif(JM is None, reason="needs the JAX reference")

# (arch, tokens a sequence)
CASES = {"gqa_flash": ("smollm-135m", 2048), "mla": ("minicpm3-4b", 16),
         "moe": ("olmoe-1b-7b", 16), "rglru": ("recurrentgemma-2b", 16),
         "memory": ("whisper-base", 16)}


def _smoke(get, name, remat):
    cfg = get(name).smoke_variant().replace(remat=remat)
    if cfg.moe is not None:
        # capacity routing agrees across the packages only when nothing
        # overflows (tests/test_torch_archs.py's pin)
        cfg = cfg.replace(moe_capacity_factor=8.0)
    return cfg


def _batch(cfg, seq, seed=2):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, seq))}
    if cfg.num_memory_tokens:
        batch["memory"] = rng.normal(
            size=(1, cfg.num_memory_tokens, cfg.memory_dim_)).astype(
                np.float32)
    return batch


def _torch_batch(batch):
    return {k: weights.tensor(v, torch.int64 if k == "tokens"
                              else torch.float32, "cpu")
            for k, v in batch.items()}


def _loss_and_grads(cfg, params, batch):
    with CostMode() as counted:
        (loss, _), grads = TPR.value_and_grad(
            lambda p: TM.loss_fn(cfg, p, batch), params)
    return float(loss), TPR.flatten(grads), counted


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(the batch as numpy, params as numpy, and the port's (loss, grads,
    ``CostMode``) under ``"none"`` and under ``"block"``)."""
    name, seq = CASES[request.param]
    cfg = _smoke(t_get_config, name, "none")
    if JM is not None:
        npp = jax.tree.map(np.asarray, JM.init_params(
            _smoke(j_get_config, name, "none"), jax.random.PRNGKey(0)))
    else:
        npp = TPR.tree_map(lambda t: t.numpy(), TM.init_params(
            cfg, torch.Generator().manual_seed(0)))
    params = weights.tree_from_numpy(npp, device="cpu")
    batch = _batch(cfg, seq)
    runs = {r: _loss_and_grads(cfg.replace(remat=r), params,
                               _torch_batch(batch))
            for r in ("none", "block")}
    return request.param, batch, npp, runs


def test_block_remat_equals_none(case):
    _, _, _, runs = case
    loss, grads, none = runs["none"]
    r_loss, r_grads, block = runs["block"]
    assert r_loss == pytest.approx(loss, rel=1e-6)
    for a, b in zip(r_grads, grads):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert block.cost.flops > none.cost.flops


@needs_jax
def test_block_remat_matches_reference(case):
    label, batch, npp, runs = case
    jcfg = _smoke(j_get_config, CASES[label][0], "block")
    assert jcfg.remat == "block"
    (jl, _), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, npp))
    tl, tg, _ = runs["block"]
    assert tl == pytest.approx(float(jl), rel=1e-5)
    j_leaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    assert len(tg) == len(j_leaves)
    scale = max(np.abs(g).max() for g in j_leaves)
    for a, b in zip(tg, j_leaves):
        # the recurrent input gates' biases hold rounding noise on both
        # sides (tests/test_torch_archs.py): 1e-5 of the largest grad
        floor = max(np.abs(b).max(), 1e-6 * scale)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * floor)


def test_block_remat_cuts_the_peak():
    """Eight repeats of smollm-135m's smoke block: ``"block"`` keeps the
    residual stream between repeats and one repeat's activations, so its
    peak live bytes are at least 3x below ``"none"``'s, for more
    flops."""
    base = t_get_config("smollm-135m").smoke_variant()
    cfg = base.replace(stages=(StageSpec(8, base.stages[0].blocks),))
    params = TM.init_params(cfg, torch.Generator().manual_seed(1))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(2))
    _, _, none = _loss_and_grads(cfg, params, {"tokens": tokens})
    _, _, block = _loss_and_grads(cfg.replace(remat="block"), params,
                                  {"tokens": tokens})
    assert block.peak_bytes * 3 <= none.peak_bytes
    assert block.cost.flops > none.cost.flops


class _FakeMesh:
    """A mesh as ``launch.shardings.mesh_axes`` reads it."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def test_recompute_on_another_thread_keeps_the_forwards_rules():
    """Sharding rules are thread-local, and autograd runs a CUDA backward
    on a device thread of its own, which holds none.  Here a ``"block"``
    step's backward runs on a new thread: the recompute still sees the
    forward's rules, so flash attention cuts its 2,048 queries into the
    same 4 stripes over a "model" dim of 4 (with 1 stripe the saved and
    the recomputed shapes would differ), and the grads are bitwise those
    of a backward on the forward's thread."""
    cfg = _smoke(t_get_config, "smollm-135m", "block")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(cfg, 2048))
    rules = (dict(TS.DEFAULT_RULES), _FakeMesh(data=1, model=4))
    grads = []
    for threaded in (False, True):
        leaves = [p.detach().requires_grad_() for p in TPR.flatten(params)]
        with TS.use_rules(*rules):
            assert TS.axis_size("q_stripes") == 4
            loss, _ = TM.loss_fn(cfg, TPR.unflatten(params, leaves), batch)

        def backward():
            return torch.autograd.grad(loss, leaves, allow_unused=True,
                                       materialize_grads=True)
        if threaded:
            with ThreadPoolExecutor(1) as pool:
                grads.append(pool.submit(backward).result())
        else:
            with TS.use_rules(*rules):
                grads.append(backward())
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _stepped_rglru(p, x):
    """The RG-LRU as the port ran it before the scan: one ``a h + b`` a
    position."""
    a, b = TR._rglru_coeffs(p, x)
    h, hs = b[:, 0], [b[:, 0]]
    for t in range(1, a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype)


def test_rglru_scan_traces_under_one_percent_of_the_stepped_ops():
    d, s = 8, 4096
    p = TR.init_rglru(torch.Generator().manual_seed(0), d, torch.float32)
    x = torch.randn((1, s, d), generator=torch.Generator().manual_seed(1))
    counts, outs = [], []
    for fn in (TR.rglru, _stepped_rglru):
        xg = x.clone().requires_grad_()
        with CostMode() as counted:
            h = fn(p, xg)
            (g,) = torch.autograd.grad(h.sum(), xg)
        counts.append(counted.cost.ops)
        outs.append((h.detach(), g))
    assert counts[0] < 0.01 * counts[1], counts
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
