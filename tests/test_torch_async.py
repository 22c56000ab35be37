"""The port's async (FedBuff) engine against the JAX async engine.

The JAX async simulation runs under ``jax.enable_x64(True)`` on the
ragged MLP of ``test_torch_engine`` with a buffer of 6 out of 12 clients
and ``max_staleness = 3``: the fused kernel (with stragglers), the
reference kernel, a weighted partial schedule, and a fleet no client of
which can be scheduled, so every ready time ties (see ``ASYNC``).
Its R + 1 draws (draw 0 launches the fleet, event r relaunches with draw
r + 1), params, population, task state and batches are injected into the
port.  Losses, latencies, ``wall_clock``, staleness, participants, the
bound and the final params must agree at 1e-5 relative.

Then the port's own properties, in float64 on the CPU: a buffer of the
whole fleet equals the sync engine at 1e-6; ``control_chunk`` is bitwise
identical to unchunked; a run repeats bit for bit.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax

from repro.fleet import scheduler as JSCHED
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import scheduler as TSCHED

from test_torch_engine import HEX, _configs, _port, _reference

RTOL = 1e-5
# (schedule, topology, overrides).  A round deadline that binds for only
# some clients is no parity case: their latencies equal the deadline up
# to rounding, so which of them fill the buffer depends on the last ulp
# of two float orders.  One that leaves no client schedulable is: every
# client retries at exact multiples of retry_backoff_s, all tied, and the
# buffer fills by index.
ASYNC = {
    "fused_stragglers": (dict(straggler_prob=0.25), (2, 6),
                         dict(kernel="fused")),
    "reference": ({}, (2, 6), dict(kernel="reference")),
    "weighted_cohort": (dict(participation="weighted",
                             participants_per_cell=4), (2, 6),
                        dict(kernel="fused", control_chunk=1)),
    "retry_ties": (dict(round_deadline_s=1e-3), (2, 6),
                   dict(kernel="fused")),
    # features combined; the buffer (6) is one whole cell
    "hex_one_cell_buffer": (dict(straggler_prob=0.25), (2, 6),
                            dict(kernel="fused", geometry=HEX, fp_rtol=0.0)),
    "dirichlet": ({}, (2, 6), dict(kernel="fused", dirichlet_alpha=0.3)),
    "telemetry_weighted_cohort": (dict(participation="weighted",
                                       participants_per_cell=4), (2, 6),
                                  dict(kernel="fused", control_chunk=1,
                                       telemetry=True)),
    "two_tier_cohort": (dict(participation="uniform",
                             participants_per_cell=3), (2, 6),
                        dict(kernel="fused", cloud_period=2)),
}


def _async_configs(schedule, topology, extra, rounds=6, buffer_size=6,
                   max_staleness=3, discount="polynomial"):
    jcfg, tcfg = _configs(schedule, topology, extra, rounds=rounds)
    kw = dict(buffer_size=buffer_size, max_staleness=max_staleness,
              staleness_discount=discount)
    return (dataclasses.replace(jcfg, async_config=JSCHED.AsyncConfig(**kw)),
            dataclasses.replace(tcfg, async_config=TSCHED.AsyncConfig(**kw)))


@pytest.fixture(scope="module", params=sorted(ASYNC))
def async_pair(request):
    jcfg, tcfg = _async_configs(*ASYNC[request.param])
    ref = _reference(jcfg, mode="async")
    return _port(tcfg, ref, mode="async"), ref


def test_async_controls_match(async_pair):
    """Every draw's control pass (the launch's and each relaunch's)."""
    sim, ref = async_pair
    assert len(ref["draws"]) == sim.cfg.rounds + 1
    for r, jc in enumerate(ref["ctls"]):
        tc = sim._control(sim.draws.round(r, sim.population))
        for f in ("mask", "strag", "arrivals"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          getattr(jc, f), err_msg=f)
        np.testing.assert_allclose(tc.t_client.numpy(), jc.t_client,
                                   rtol=RTOL)


def test_async_trajectories_params_and_bound_match(async_pair):
    sim, ref = async_pair
    res = sim.finalize(*sim.simulate(sim.params))
    jr = ref["result"]
    assert res.mode == jr.mode == "async"
    for f in ("losses", "latencies", "wall_clock", "staleness", "deadlines",
              "mean_prune", "mean_per", "bandwidth_util", "learning_cost"):
        np.testing.assert_allclose(getattr(res, f), getattr(jr, f),
                                   rtol=RTOL, atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(res.participants, jr.participants)
    np.testing.assert_array_equal(res.accuracy, jr.accuracy)
    for name, layer in jr.params.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(res.params[name][leaf], np.asarray(v),
                                       rtol=RTOL, atol=1e-10,
                                       err_msg=f"{name}/{leaf}")
    assert math.isclose(res.bound_final, jr.bound_final, rel_tol=RTOL)
    # the buffer really was asynchronous: stale merges, time moving on
    assert res.staleness.max() > 0
    assert np.all(np.diff(res.wall_clock) >= 0)
    assert np.all(res.participants <= 6)


def test_async_needs_one_draw_more_than_events():
    jcfg, tcfg = _async_configs(*ASYNC["reference"], rounds=2)
    ref = _reference(jcfg, mode="async")
    ref["draws"] = ref["draws"][:-1]
    sim = _port(tcfg, ref, mode="async")
    with pytest.raises(IndexError, match="R \\+ 1"):
        sim.simulate(sim.params)


@pytest.mark.parametrize("kernel", ["fused", "reference"])
def test_async_whole_buffer_equals_sync(kernel):
    """A buffer of the whole fleet and no discount: every event is a sync
    round (1e-6 under float64; the buffer is in arrival order, so sums
    reassociate)."""
    _, tcfg = _async_configs({}, (3, 8), dict(kernel=kernel), rounds=5,
                             buffer_size=0, discount="none")
    s = TENG.run_fleet(tcfg, device="cpu", dtype=torch.float64)
    a = TENG.run_fleet(tcfg, mode="async", device="cpu", dtype=torch.float64)
    for f in ("losses", "accuracy", "latencies", "deadlines", "mean_prune",
              "mean_per", "participants", "bandwidth_util", "learning_cost"):
        np.testing.assert_allclose(getattr(a, f), getattr(s, f), rtol=1e-6,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_allclose(a.wall_clock, np.cumsum(s.latencies),
                               rtol=1e-6)
    np.testing.assert_array_equal(a.staleness, 0.0)
    assert math.isclose(a.bound_final, s.bound_final, rel_tol=1e-6)
    for name, layer in s.params.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(a.params[name][leaf], v, rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("schedule", [{}, dict(participation="uniform",
                                               participants_per_cell=5)])
def test_async_control_chunk_is_bitwise_identical(schedule):
    """The in-flight state's rebuild and the solve, blocked over 5 cells in
    blocks of 3 (a ragged tail of 2), give the same bits on the CPU."""
    _, tcfg = _async_configs(schedule, (5, 8), {}, rounds=5)
    a = TENG.run_fleet(tcfg, mode="async", device="cpu", dtype=torch.float64)
    b = TENG.run_fleet(dataclasses.replace(tcfg, control_chunk=3),
                       mode="async", device="cpu", dtype=torch.float64)
    for f in ("losses", "accuracy", "latencies", "deadlines", "mean_prune",
              "mean_per", "participants", "bandwidth_util", "staleness",
              "wall_clock"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for name, layer in a.params.items():
        for leaf, v in layer.items():
            np.testing.assert_array_equal(b.params[name][leaf], v)


def test_async_is_deterministic_and_seeded():
    _, tcfg = _async_configs({}, (3, 8), {}, rounds=5)
    a = TENG.run_fleet(tcfg, mode="async", device="cpu")
    b = TENG.run_fleet(tcfg, mode="async", device="cpu")
    np.testing.assert_array_equal(a.losses, b.losses)
    np.testing.assert_array_equal(a.wall_clock, b.wall_clock)
    c = TENG.run_fleet(dataclasses.replace(tcfg, seed=1), mode="async",
                       device="cpu")
    assert not np.allclose(a.losses, c.losses)
    assert a.losses.shape == a.staleness.shape == (5,)


def test_run_alias_time_to_loss_and_mode_validation():
    assert TENG.run is TENG.run_fleet
    res = TENG.FleetResult(
        losses=np.array([2.0, 1.5, 1.0]), accuracy=None, latencies=None,
        deadlines=None, mean_prune=None, mean_per=None, participants=None,
        bandwidth_util=None, learning_cost=None, bound_final=0.0, params={},
        wall_clock=np.array([1.0, 2.5, 4.0]))
    assert TENG.time_to_loss(res, 1.5) == 2.5
    assert TENG.time_to_loss(res, 0.5) == float("inf")
    _, tcfg = _configs({})
    with pytest.raises(ValueError, match="mode"):
        TENG.run_fleet(tcfg, mode="buffered", device="cpu")
