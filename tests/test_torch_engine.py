"""The slice as a whole: the port's synchronous fused fleet round against
the JAX engine.

The JAX sync simulation is built at 2 cells x 4 clients (and 3 cells in
chunks of 2, see ``CASES``) on a ragged MLP
(32 -> 12 -> 6 -> 5, block 8) with ``kernel="fused"`` under
``jax.enable_x64(True)``.  Its params, population, task state and cached
client batches are carried across with ``repro_torch.weights``; its
per-round draws are rebuilt with the engine's own key splits (round key
-> fade / participation / straggler / arrival keys; fading through
``topology.sample_fading``) and injected.  Every round's control, the
trajectories, the final params and the Theorem-1 bound must then agree
at 1e-5 relative: both sides run float64 through the same algorithm, so
what is left is rounding (the absolute floors below cover exact zeros
and ulp cancellations in dimensionless fields).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax

from repro.fleet import engine as JENG
from repro.fleet import scheduler as JSCHED
from repro.fleet import task as JTASK
from repro.fleet import topology as JTOPO
from repro_torch import weights
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import scheduler as TSCHED
from repro_torch.fleet import task as TTASK
from repro_torch.fleet import topology as TTOPO

RTOL = 1e-5
TASK_KW = dict(feature_dim=32, hidden=(12, 6), num_classes=5,
               test_samples=64, prune_block=8)
# (schedule, topology, cell_chunk): full participation; stragglers plus a
# binding round deadline (the solver's cap branch); 3 cells in chunks of 2
# (the chunked gradient sum with its exact-sized ragged tail)
CASES = {
    "full": ({}, (2, 4), 0),
    "stragglers_deadline": (dict(straggler_prob=0.25, round_deadline_s=0.6),
                            (2, 4), 0),
    "ragged_cell_chunks": ({}, (3, 4), 2),
}


def _configs(schedule, topology=(2, 4), cell_chunk=0, rounds=3):
    common = dict(kernel="fused", rounds=rounds, lr=0.05,
                  cell_chunk=cell_chunk)
    jcfg = JENG.FleetConfig(
        task=JTASK.SyntheticMLPTask(**TASK_KW),
        topology=JTOPO.FleetTopology(*topology),
        schedule=JSCHED.ScheduleConfig(**schedule), **common)
    tcfg = TENG.FleetConfig(
        task=TTASK.SyntheticMLPTask(**TASK_KW),
        topology=TTOPO.FleetTopology(*topology),
        schedule=TSCHED.ScheduleConfig(**schedule), **common)
    return jcfg, tcfg


def _reference(jcfg):
    """Run the JAX engine and collect everything the port needs."""
    with jax.enable_x64(True):
        cfg2, task, state, params, pop, k_data, keys = \
            JENG._build_common(jcfg)
        _, data = JENG._make_batch_fn(task, state, cfg2, k_data)
        sim = JENG.build_simulation(jcfg)
        result = sim.finalize(*sim.simulate(sim.params, sim.round_keys))
        control = JENG._make_control_fn(cfg2, pop)
        ctls, draws = [], []
        shape = pop.pathloss.shape
        for rkey in keys[:jcfg.rounds]:
            k_fade, _, k_strag, k_arr = jax.random.split(rkey, 4)
            h_up, h_down = JTOPO.sample_fading(k_fade, pop.pathloss)
            draws.append(tuple(np.asarray(a) for a in (
                h_up, h_down, jax.random.uniform(k_strag, shape),
                jax.random.uniform(k_arr, shape))))
            ctls.append(jax.tree.map(np.asarray, control(rkey)))
        to_np = lambda t: jax.tree.map(np.asarray, t)
        pop_np = {f: np.asarray(getattr(pop, f))
                  for f in TTOPO.ClientPopulation._fields}
        return dict(result=result, ctls=ctls, draws=draws, pop=pop_np,
                    params=to_np(params), state=to_np(state),
                    data=to_np(data))


def _port(tcfg, ref):
    dt, cpu = torch.float64, "cpu"
    draws = TENG.InjectedDraws(
        weights.population_from_numpy(ref["pop"], dt, cpu),
        [weights.round_draws_from_numpy(*d, dtype=dt, device=cpu)
         for d in ref["draws"]])
    start = weights.start_from_numpy(ref["params"], ref["state"], ref["data"],
                                     dtype=dt, device=cpu)
    return TENG.build_simulation(tcfg, device="cpu", dtype=dt, draws=draws,
                                 start=start)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    jcfg, tcfg = _configs(*CASES[request.param])
    ref = _reference(jcfg)
    return _port(tcfg, ref), ref


def test_round_controls_match(pair):
    sim, ref = pair
    for r, jc in enumerate(ref["ctls"]):
        tc = sim.control(r)
        for f in ("mask", "strag", "arrivals"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          getattr(jc, f), err_msg=f)
        np.testing.assert_allclose(tc.t_client.numpy(), jc.t_client,
                                   rtol=RTOL, err_msg="t_client")
        np.testing.assert_allclose(tc.m_round.numpy(), jc.m_round, rtol=RTOL)
        for f in ("prune", "bandwidth", "deadline", "per", "inner_cost"):
            np.testing.assert_allclose(
                getattr(tc.sol, f).numpy(), getattr(jc.sol, f), rtol=RTOL,
                atol=1e-12 if f in ("prune", "per") else 0.0, err_msg=f)
        np.testing.assert_array_equal(tc.sol.iterations.numpy(),
                                      jc.sol.iterations)


def test_trajectories_params_and_bound_match(pair):
    sim, ref = pair
    res = sim.finalize(*sim.simulate(sim.params))
    jr = ref["result"]
    for f in ("losses", "latencies", "deadlines", "mean_prune", "mean_per",
              "bandwidth_util", "learning_cost"):
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
    assert np.isfinite(res.losses).all()


def test_default_draws_are_seed_deterministic_on_cpu():
    _, tcfg = _configs({}, rounds=2)
    a = TENG.run_fleet(tcfg, device="cpu")
    b = TENG.run_fleet(tcfg, device="cpu")
    np.testing.assert_array_equal(a.losses, b.losses)
    np.testing.assert_array_equal(a.params["layer0"]["w"],
                                  b.params["layer0"]["w"])
    assert a.losses.shape == (2,) and np.isfinite(a.losses).all()


@pytest.mark.parametrize("change", [
    dict(kernel="reference"), dict(cloud_period=2), dict(control_chunk=1),
    dict(cohort_gather=True), dict(cache_data=False),
    dict(schedule=TSCHED.ScheduleConfig(participation="uniform",
                                        participants_per_cell=2)),
])
def test_unported_configs_raise(change):
    _, tcfg = _configs({})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TENG.build_simulation(dataclasses.replace(tcfg, **change),
                              device="cpu")


def test_async_mode_raises():
    _, tcfg = _configs({})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TENG.run_fleet(tcfg, mode="async", device="cpu")


def test_unknown_mask_kind_raises():
    _, tcfg = _configs({})
    with pytest.raises(ValueError, match="mask_kind"):
        TENG.build_simulation(dataclasses.replace(tcfg, mask_kind="blocks"),
                              device="cpu")
