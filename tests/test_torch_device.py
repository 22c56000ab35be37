"""Where the port runs: the card unless the caller asks for the CPU.

The converters in ``repro_torch.weights`` place tensors where the entry
points run by default (the card), and ``build_simulation`` refuses
injected tensors that lie anywhere but the run's device, since a CPU
tensor would quietly send the round through the kernels' plain
versions.  No JAX here: the gpu test runs on the card's machine too.
"""

import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import task as TTASK
from repro_torch.fleet import topology as TTOPO

TOPOLOGY = (2, 4)
TASK = TTASK.SyntheticMLPTask(feature_dim=16, hidden=(8,), num_classes=3,
                              test_samples=8, prune_block=8)
CFG = TENG.FleetConfig(task=TASK, topology=TTOPO.FleetTopology(*TOPOLOGY),
                       kernel="fused", rounds=2)


def _numpy_run(seed=0):
    """A population, two rounds of draws and a start, as numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = TOPOLOGY
    pop = {f: rng.uniform(0.1, 1.0, shape)
           for f in TTOPO.POPULATION_ARRAYS}
    draws = [tuple(rng.uniform(0.0, 1.0, shape) for _ in range(4))
             for _ in range(CFG.rounds)]
    d, h, k = TASK.feature_dim, TASK.hidden[0], TASK.num_classes
    params = {"layer0": {"w": rng.normal(size=(d, h)), "b": np.zeros(h)},
              "layer1": {"w": rng.normal(size=(h, k)), "b": np.zeros(k)}}
    state = {"templates": rng.normal(size=(k, d)),
             "x_test": rng.normal(size=(8, d)),
             "y_test": rng.integers(0, k, 8)}
    n = TOPOLOGY[0] * TOPOLOGY[1]
    batches = {"x": rng.normal(size=(n, TASK.local_batch, d)),
               "y": rng.integers(0, k, (n, TASK.local_batch))}
    return pop, draws, (params, state, batches)


def _injected(device, off=None):
    """Draws and start on ``device``, with the part named ``off`` left on
    the CPU instead."""
    pop, draws, start = _numpy_run()
    at = lambda part: "cpu" if part == off else device
    src = TENG.InjectedDraws(
        weights.population_from_numpy(pop, device=at("population")),
        [weights.round_draws_from_numpy(*d, device=at("rounds"))
         for d in draws])
    return src, weights.start_from_numpy(*start, device=at("start"))


def test_converters_default_to_the_card():
    if torch.cuda.is_available():
        assert weights.tensor(np.zeros(2)).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            weights.tensor(np.zeros(2))
    assert weights.tensor(np.zeros(2), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("off", ["population", "rounds", "start"])
def test_tensors_off_the_run_device_raise(off):
    """A run on one device refuses injected tensors on another (``meta``
    stands in for the card, which the CPU tests do not have)."""
    src, start = _injected("meta", off=off)
    with pytest.raises(ValueError, match="lie on cpu"):
        TENG.build_simulation(CFG, device="meta", draws=src, start=start)


def test_injected_tensors_on_the_run_device_build():
    src, start = _injected("cpu")
    sim = TENG.build_simulation(CFG, device="cpu", draws=src, start=start)
    res = sim.finalize(*sim.simulate(sim.params))
    assert res.losses.shape == (CFG.rounds,) and np.isfinite(res.losses).all()


@pytest.mark.gpu
@pytest.mark.parametrize("off", ["population", "rounds", "start"])
def test_cpu_tensors_with_the_default_device_raise_on_gpu(off):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src, start = _injected("cuda", off=off)
    with pytest.raises(ValueError, match="lie on cpu"):
        TENG.run_fleet(CFG, draws=src, start=start)
