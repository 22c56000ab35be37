"""The port's continuous-batching engine against the reference's.

The same tiny llama-family model as ``tests/test_serve.py`` (reference
params carried across as numpy), pruned at rho = 0.5 by the reference.
Tokens are compared bitwise: the port's ``generate`` against the
reference's ``ServeEngine.generate``, across slot counts, against a
per-request host loop and against wave mode; ``return_logits`` at 2e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.configs import base as TCB
from repro_torch.serve import ServeConfig as TConfig
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import SparseModel as TSparse

try:  # the card's machine has no JAX: only the gpu tests run there
    import jax
    from repro.configs.base import ArchConfig, BlockSpec, StageSpec
    from repro.fleet.task import TransformerTask as JTask
    from repro.serve import ServeConfig as JConfig
    from repro.serve import ServeEngine as JEngine
    from repro.serve import SparseModel as JSparse
    from repro.serve import make_bundle as j_make_bundle
except ImportError:
    JTask = None
needs_jax = pytest.mark.skipif(JTask is None, reason="needs the JAX reference")

TINY = dict(name="tiny-serve", family="dense", source="test", d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64)
R, P, G = 5, 3, 4


def t_arch():
    return TCB.ArchConfig(**TINY, stages=(
        TCB.StageSpec(2, (TCB.BlockSpec("attn", "mlp"),)),))


@pytest.fixture(scope="module")
def models():
    """(reference SparseModel, port SparseModel on the CPU), rho = 0.5."""
    arch = ArchConfig(**TINY, stages=(StageSpec(2, (BlockSpec("attn",
                                                              "mlp"),)),))
    task = JTask(arch=arch, target_tiles=4)
    bundle = j_make_bundle(task, task.init_params(jax.random.PRNGKey(0)),
                           0.5)
    port = TSparse(t_arch(), weights.bundle_from_numpy(bundle, device="cpu"),
                   device="cpu")
    return JSparse(arch, bundle), port


def _prompts(seed=0, r=R):
    return np.random.RandomState(seed).randint(0, 64, (r, P)).astype(np.int32)


def _cfg(slots, max_new=G):
    return TConfig(max_slots=slots, page_len=16, max_new=max_new)


@needs_jax
def test_generate_matches_reference(models):
    ref, port = models
    prompts = _prompts()
    want, want_logits = JEngine(ref, JConfig(max_slots=2, page_len=16,
                                             max_new=G)).generate(
        prompts, return_logits=True)
    got, got_logits = TEngine(port, _cfg(2)).generate(prompts,
                                                      return_logits=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_logits, want_logits, rtol=2e-4, atol=2e-4)


@needs_jax
def test_slot_count_invariance(models):
    _, port = models
    prompts = _prompts(1)
    np.testing.assert_array_equal(TEngine(port, _cfg(2)).generate(prompts),
                                  TEngine(port, _cfg(8)).generate(prompts))


@needs_jax
def test_generate_equals_host_loop(models):
    _, port = models
    prompts = _prompts(2, r=2)
    got = TEngine(port, _cfg(2)).generate(prompts)
    ref = []
    for row in prompts:
        caches = port.init_caches(1, 16)
        gen = []
        for t in range(P + G - 1):
            tok = int(row[t]) if t < P else gen[-1]
            lg, caches = port.decode_step(
                port.arrays, torch.full((1, 1), tok), caches,
                torch.full((1,), t))
            if t >= P - 1:
                gen.append(int(torch.argmax(lg, -1)[0]))
        ref.append(gen)
    np.testing.assert_array_equal(got, np.asarray(ref))


@needs_jax
@pytest.mark.parametrize("slots", [2, 8])
def test_generate_prefilled_equals_generate(models, slots):
    """Wave mode (prefill + decode, last wave padded with zero prompts)
    gives the continuous-batching tokens."""
    _, port = models
    prompts = _prompts(3)
    np.testing.assert_array_equal(
        TEngine(port, _cfg(slots)).generate_prefilled(prompts),
        TEngine(port, _cfg(slots)).generate(prompts))


@needs_jax
def test_overlong_request_raises(models):
    _, port = models
    eng = TEngine(port, TConfig(max_slots=2, page_len=8, max_new=8))
    with pytest.raises(ValueError):
        eng.generate(np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError):
        eng.generate_prefilled(np.zeros((1, 4), np.int32))


@pytest.mark.gpu
def test_engine_defaults_to_the_card_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.fleet.task import TransformerTask
    from repro_torch.kernels import block_sparse_matmul as TBSM
    from repro_torch.kernels import decode_attention as TDA
    from repro_torch.serve import make_bundle
    task = TransformerTask(arch=t_arch(), target_tiles=4)
    params = task.init_params(torch.Generator(device="cuda").manual_seed(0))
    model = TSparse(t_arch(), make_bundle(task, params, 0.5))
    assert model.device.type == "cuda"
    before = (TBSM.block_sparse_matmul.launches, TDA.decode_attention.launches)
    out = TEngine(model, _cfg(4)).generate(_prompts())
    assert out.shape == (R, G)
    assert TBSM.block_sparse_matmul.launches > before[0]
    assert TDA.decode_attention.launches > before[1]
