"""Two-tier aggregation (``cloud_period``): the port against the JAX
engine, then its own properties.

Sync two-tier rounds with ``cloud_period`` 1 and 2, on the fused kernel
and on the reference kernel with block masks, on full and on cohort
(uniform partial) schedules, and async two-tier events (with stragglers
and a buffer of whole cells, not a partly binding deadline: see
``test_torch_async``), all under
``jax.enable_x64(True)`` from the reference's injected draws, params and
batches: trajectories, the final cloud params and the Theorem-1 bound at
1e-5 relative.  Then, in float64 on the CPU: ``cloud_period = 1`` is the
single-tier step; merge rounds, and only they, pay the backhaul; fused
equals reference(block); the cohort path equals the full fleet.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.fleet import scheduler as JSCHED
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import scheduler as TSCHED

from test_torch_engine import UNIFORM, _configs, _port, _reference

RTOL = 1e-5
F64 = dict(device="cpu", dtype=torch.float64)
REF_BLOCK = dict(kernel="reference", mask_kind="block")
# (schedule, topology, overrides)
SYNC = {
    f"{sched}_{kern}_period{p}": (UNIFORM if sched == "cohort" else {},
                                  (3, 5), dict(dict(cloud_period=p),
                                               **(REF_BLOCK if kern ==
                                                  "refblock" else {})))
    for sched in ("full", "cohort") for kern in ("fused", "refblock")
    for p in (1, 2)
}
ASYNC = {
    "fused": dict(kernel="fused"),
    "reference_magnitude": dict(kernel="reference"),
}


def _assert_results_match(res, jr, rtol=RTOL):
    for f in ("losses", "latencies", "wall_clock", "staleness", "deadlines",
              "mean_prune", "mean_per", "bandwidth_util", "learning_cost"):
        np.testing.assert_allclose(getattr(res, f), getattr(jr, f),
                                   rtol=rtol, atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(res.participants, jr.participants)
    np.testing.assert_array_equal(res.accuracy, jr.accuracy)
    for name, layer in jr.params.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(res.params[name][leaf], np.asarray(v),
                                       rtol=rtol, atol=1e-10,
                                       err_msg=f"{name}/{leaf}")
    assert math.isclose(res.bound_final, jr.bound_final, rel_tol=rtol)


@pytest.mark.parametrize("case", sorted(SYNC))
def test_two_tier_sync_matches_reference(case):
    jcfg, tcfg = _configs(*SYNC[case], rounds=4)
    ref = _reference(jcfg)
    sim = _port(tcfg, ref)
    res = sim.finalize(*sim.simulate(sim.params))
    _assert_results_match(res, ref["result"])


@pytest.mark.parametrize("case", sorted(ASYNC))
def test_two_tier_async_matches_reference(case):
    """3 cells of 4 and a buffer of 8.  A cell's scheduled clients all
    finish at its solved deadline, equal up to rounding, so a buffer that
    splits a cell picks among near-ties by the last ulp; a buffer of whole
    cells does not."""
    kw = dict(buffer_size=8, max_staleness=3)
    jcfg, tcfg = _configs(dict(straggler_prob=0.25), (3, 4),
                          dict(ASYNC[case], cloud_period=2), rounds=6)
    jcfg = dataclasses.replace(jcfg, async_config=JSCHED.AsyncConfig(**kw))
    tcfg = dataclasses.replace(tcfg, async_config=TSCHED.AsyncConfig(**kw))
    ref = _reference(jcfg, mode="async")
    sim = _port(tcfg, ref, mode="async")
    res = sim.finalize(*sim.simulate(sim.params))
    _assert_results_match(res, ref["result"])
    assert res.staleness.max() > 0
    assert np.all(np.diff(res.wall_clock) >= 0)


@pytest.mark.parametrize("kernel", ["fused", "reference"])
def test_period_one_is_the_single_tier_step(kernel):
    _, tcfg = _configs({}, (3, 5), dict(kernel=kernel), rounds=4)
    one = TENG.run_fleet(dataclasses.replace(tcfg, cloud_period=1), **F64)
    single = TENG.run_fleet(tcfg, **F64)
    np.testing.assert_allclose(one.losses, single.losses, rtol=1e-9)
    np.testing.assert_allclose(one.latencies - single.latencies,
                               tcfg.wireless.backhaul_s, rtol=1e-9)
    for name, layer in single.params.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(one.params[name][leaf], v, rtol=1e-9,
                                       atol=1e-12)


def test_merge_rounds_pay_the_backhaul():
    """Period 2: rounds 1 and 3 merge and pay ``backhaul_s``, rounds 0 and
    2 do not; the control pass (and so every other latency term) is the
    single tier's."""
    _, tcfg = _configs({}, (3, 5), rounds=4)
    two = TENG.run_fleet(dataclasses.replace(tcfg, cloud_period=2), **F64)
    single = TENG.run_fleet(tcfg, **F64)
    np.testing.assert_allclose(two.latencies - single.latencies,
                               [0.0, tcfg.wireless.backhaul_s] * 2,
                               atol=1e-12)
    np.testing.assert_array_equal(two.deadlines, single.deadlines)
    assert not np.allclose(two.losses[1:], single.losses[1:], rtol=1e-9)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_two_tier_fused_equals_reference_block(mode):
    _, tcfg = _configs(dict(straggler_prob=0.2), (3, 5),
                       dict(cloud_period=2), rounds=4)
    tcfg = dataclasses.replace(tcfg, async_config=TSCHED.AsyncConfig(
        buffer_size=8, max_staleness=3))
    a = TENG.run_fleet(tcfg, mode, **F64)
    b = TENG.run_fleet(dataclasses.replace(tcfg, **REF_BLOCK), mode, **F64)
    np.testing.assert_allclose(a.losses, b.losses, rtol=1e-9)
    for name, layer in a.params.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(b.params[name][leaf], v, rtol=1e-9,
                                       atol=1e-12)


@pytest.mark.parametrize("kernel", ["fused", "reference"])
@pytest.mark.parametrize("participation", ["uniform", "weighted"])
def test_two_tier_cohort_path_equals_full_fleet(kernel, participation):
    """The cohort gather changes only the association of the per-cell
    float sums (1e-6 under float64)."""
    _, tcfg = _configs(dict(participation=participation,
                            participants_per_cell=2), (3, 5),
                       dict(kernel=kernel, cloud_period=2), rounds=4)
    runs = [TENG.run_fleet(dataclasses.replace(tcfg, cohort_gather=g), **F64)
            for g in (None, False)]
    for f in ("losses", "latencies", "mean_prune", "participants"):
        np.testing.assert_allclose(getattr(runs[0], f), getattr(runs[1], f),
                                   rtol=1e-6, err_msg=f)
    for name, layer in runs[1].params.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(runs[0].params[name][leaf], v,
                                       rtol=1e-6, atol=1e-12)


def test_two_tier_is_deterministic_and_finalizes_the_cloud_view():
    _, tcfg = _configs({}, (3, 5), dict(cloud_period=3), rounds=4)
    sim = TENG.build_simulation(tcfg, **F64)
    carry, metrics = sim.simulate(sim.params)
    res = sim.finalize(carry, metrics)
    again = TENG.run_fleet(tcfg, **F64)
    np.testing.assert_array_equal(res.losses, again.losses)
    # round 3 did not merge: the result is the merged-weight edge mean
    edge, acc_w = carry[0], carry[1]
    assert float(acc_w.sum()) > 0
    w = (acc_w / acc_w.sum()).numpy()
    for name, layer in res.params.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(
                v, np.tensordot(w, edge[name][leaf].numpy(), axes=1),
                rtol=1e-12)
