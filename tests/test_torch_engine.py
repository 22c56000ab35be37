"""The slice as a whole: the port's synchronous fleet rounds against the
JAX engine.

The JAX sync simulation is built at 2 cells x 4 clients (and larger
fleets, see ``CASES``) on a ragged MLP
(32 -> 12 -> 6 -> 5, block 8) under ``jax.enable_x64(True)``: the fused
kernel; the reference kernel with magnitude and with block masks; uniform
and weighted partial participation on the cohort path; a ragged
``control_chunk``; hex cells with reuse 1, mobility and handover (the
solver's interference fixed point at ``fp_rtol = 0``); two-tier
aggregation; Dirichlet labels.  Its params, population (with its hex
state), task state and cached client batches are carried across with
``repro_torch.weights``; its per-round draws are rebuilt with the
engine's own key splits (round key -> fade / participation / straggler /
arrival keys; fading through ``topology.sample_fading``, the schedule's
scores through ``jax.random.gumbel``, the hex draws through the fade
key's splits and ``fold_in`` salts) and injected.  Every round's control
(masks, cohorts and packet draws exactly), the trajectories, the final
params and the Theorem-1 bound must then agree at 1e-5 relative: both
sides run float64 through the same algorithm, so what is left is
rounding (the absolute floors below cover exact zeros and ulp
cancellations in dimensionless fields).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax

from repro.fleet import engine as JENG
from repro.fleet import scheduler as JSCHED
from repro.fleet import solver as JSOL
from repro.fleet import task as JTASK
from repro.fleet import telemetry as JTEL
from repro.fleet import topology as JTOPO
from repro_torch import weights
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import scheduler as TSCHED
from repro_torch.fleet import solver as TSOL
from repro_torch.fleet import task as TTASK
from repro_torch.fleet import telemetry as TTEL
from repro_torch.fleet import topology as TTOPO

RTOL = 1e-5
TASK_KW = dict(feature_dim=32, hidden=(12, 6), num_classes=5,
               test_samples=64, prune_block=8)
UNIFORM = dict(participation="uniform", participants_per_cell=2)
# reuse 1 on 3 cells: every cell co-channel with the other two
HEX = dict(reuse=1, max_neighbors=2, mobility_m=25.0, handover=True)
# (schedule, topology, FleetConfig overrides): full participation;
# stragglers plus a binding round deadline (the solver's cap branch); 3
# cells in chunks of 2 (the chunked gradient sum with its exact-sized
# ragged tail); the reference kernel with either mask rule; partial
# schedules on the cohort path; the control pass blocked over cells with
# a ragged last block
CASES = {
    "full": ({}, (2, 4), {}),
    "stragglers_deadline": (dict(straggler_prob=0.25, round_deadline_s=0.6),
                            (2, 4), {}),
    "ragged_cell_chunks": ({}, (3, 4), dict(cell_chunk=2)),
    "reference_magnitude": ({}, (2, 4), dict(kernel="reference")),
    "reference_block": ({}, (2, 4), dict(kernel="reference",
                                         mask_kind="block")),
    "uniform_cohort": (UNIFORM, (3, 5), {}),
    "weighted_cohort": (dict(participation="weighted",
                             participants_per_cell=3), (2, 6),
                        dict(kernel="reference")),
    "control_chunk_ragged": (dict(UNIFORM, straggler_prob=0.2), (3, 5),
                             dict(control_chunk=2, cell_chunk=2)),
    "hex_mobility_handover": ({}, (3, 4), dict(geometry=HEX, fp_rtol=0.0)),
    "two_tier": ({}, (3, 4), dict(cloud_period=2)),
    "dirichlet": ({}, (2, 4), dict(dirichlet_alpha=0.3)),
    # features combined (a binding deadline under hex cells is left out:
    # capped clients sit on the deadline, and two float orders split them)
    "hex_cohort": (UNIFORM, (3, 5), dict(geometry=HEX, fp_rtol=0.0)),
    "hex_two_tier": ({}, (3, 4), dict(geometry=HEX, fp_rtol=0.0,
                                      cloud_period=2)),
    "hex_control_chunk": ({}, (3, 4), dict(geometry=HEX, fp_rtol=0.0,
                                           control_chunk=2)),
    "hex_reference": ({}, (3, 4), dict(geometry=HEX, fp_rtol=0.0,
                                       kernel="reference")),
    "dirichlet_cohort": (UNIFORM, (3, 5), dict(dirichlet_alpha=0.3)),
    "two_tier_cohort": (UNIFORM, (3, 5), dict(cloud_period=2)),
    "cloud_period_one": ({}, (3, 4), dict(cloud_period=1)),
    "two_tier_reference_block": ({}, (3, 4), dict(
        cloud_period=2, kernel="reference", mask_kind="block")),
    "telemetry_control_chunk": (dict(UNIFORM, straggler_prob=0.2), (3, 5),
                                dict(control_chunk=2, telemetry=True)),
    "telemetry_hex_cohort": (UNIFORM, (3, 5), dict(geometry=HEX, fp_rtol=0.0,
                                                   telemetry=True)),
}


def _configs(schedule, topology=(2, 4), extra=None, rounds=3):
    """The JAX and the port's FleetConfig.  ``extra`` may hold ``geometry``
    (a dict of HexInterference fields), ``fp_rtol`` (the solver's),
    ``dirichlet_alpha`` (the task's) and ``telemetry`` (True: each
    package's default TelemetryConfig) besides FleetConfig fields."""
    extra = dict(extra or {})
    if extra.pop("telemetry", False):
        extra["telemetry"] = (JTEL.TelemetryConfig(), TTEL.TelemetryConfig())
    tel = extra.pop("telemetry", (None, None))
    hexkw = extra.pop("geometry", None)
    solver = {"fp_rtol": extra.pop("fp_rtol")} if "fp_rtol" in extra else {}
    task_kw = dict(TASK_KW, dirichlet_alpha=extra.pop("dirichlet_alpha",
                                                      None))
    common = dict(dict(kernel="fused", rounds=rounds, lr=0.05), **extra)
    jcfg = JENG.FleetConfig(
        task=JTASK.SyntheticMLPTask(**task_kw),
        topology=JTOPO.FleetTopology(*topology),
        schedule=JSCHED.ScheduleConfig(**schedule),
        geometry=None if hexkw is None else JTOPO.HexInterference(**hexkw),
        solver=JSOL.SolverConfig(**solver), telemetry=tel[0], **common)
    tcfg = TENG.FleetConfig(
        task=TTASK.SyntheticMLPTask(**task_kw),
        topology=TTOPO.FleetTopology(*topology),
        schedule=TSCHED.ScheduleConfig(**schedule),
        geometry=None if hexkw is None else TTOPO.HexInterference(**hexkw),
        solver=TSOL.SolverConfig(**solver), telemetry=tel[1], **common)
    return jcfg, tcfg


def hex_round_draws(k_fade, pop, geo):
    """The hex geometry's round draws (``RoundDraws`` fields from
    ``ray_up`` on), rebuilt from the fade key as ``round_channel`` splits
    and salts it; {} for an orthogonal geometry."""
    if not isinstance(geo, JTOPO.HexInterference):
        return {}
    shape = pop.pathloss.shape
    k_up, k_down = jax.random.split(k_fade)
    out = dict(ray_up=jax.random.exponential(k_up, shape),
               ray_down=jax.random.exponential(k_down, shape))
    state = pop.geometry
    if geo.mobility_m > 0.0:
        out["jitter"] = jax.random.normal(
            jax.random.fold_in(k_fade, JTOPO._SALT_MOBILITY), shape + (2,))
    if state is not None:
        if geo.handover:
            out["ray_handover"] = jax.random.exponential(
                jax.random.fold_in(k_up, JTOPO._SALT_HANDOVER),
                state.cand_gain.shape)
        out["ray_cross"] = jax.random.exponential(
            jax.random.fold_in(k_fade, JTOPO._SALT_CROSS),
            state.cross_gain.shape)
    return {k: np.asarray(v) for k, v in out.items()}


def _draws(rkey, pop, partial, geo=None):
    """One round key's draws, split as the engine splits it: the
    positional ``RoundDraws`` fields, then the hex fields by name."""
    k_fade, k_part, k_strag, k_arr = jax.random.split(rkey, 4)
    shape = pop.pathloss.shape
    h_up, h_down = JTOPO.sample_fading(k_fade, pop.pathloss)
    gumbel = jax.random.gumbel(k_part, shape) if partial else None
    return tuple(None if a is None else np.asarray(a) for a in (
        h_up, h_down, jax.random.uniform(k_strag, shape),
        jax.random.uniform(k_arr, shape), gumbel)) \
        + (hex_round_draws(k_fade, pop, geo),)


def population_numpy(pop):
    """The reference's population as numpy, its hex state included."""
    out = {f: np.asarray(getattr(pop, f)) for f in TTOPO.POPULATION_ARRAYS}
    out["geometry"] = None if pop.geometry is None else \
        {f: np.asarray(getattr(pop.geometry, f))
         for f in TTOPO.HexState._fields}
    return out


def _reference(jcfg, mode="sync"):
    """Run the JAX engine and collect everything the port needs: the
    draws of every key the run reads (R in sync mode, R + 1 in async)."""
    with jax.enable_x64(True):
        cfg2, task, state, params, pop, k_data, keys = \
            JENG._build_common(jcfg)
        _, data = JENG._make_batch_fn(task, state, cfg2, k_data)
        sim = JENG.build_simulation(jcfg, mode=mode)
        result = sim.finalize(*sim.simulate(sim.params, sim.round_keys))
        control = JENG._make_control_fn(cfg2, pop)
        partial = JSCHED.cohort_size(jcfg.schedule, pop.pathloss.shape[-1]) \
            < pop.pathloss.shape[-1]
        used = keys[:jcfg.rounds] if mode == "sync" else keys
        geo = JENG.resolve_geometry(jcfg)
        draws = [_draws(rkey, pop, partial, geo) for rkey in used]
        ctls = [jax.tree.map(np.asarray, control(rkey)) for rkey in used]
        to_np = lambda t: jax.tree.map(np.asarray, t)
        pop_np = population_numpy(pop)
        return dict(result=result, ctls=ctls, draws=draws, pop=pop_np,
                    params=to_np(params), state=to_np(state),
                    data=to_np(data))


def _port(tcfg, ref, mode="sync"):
    dt, cpu = torch.float64, "cpu"
    draws = TENG.InjectedDraws(
        weights.population_from_numpy(ref["pop"], dt, cpu),
        [weights.round_draws_from_numpy(*d[:5], dtype=dt, device=cpu, **d[5])
         for d in ref["draws"]])
    start = weights.start_from_numpy(ref["params"], ref["state"], ref["data"],
                                     dtype=dt, device=cpu)
    return TENG.build_simulation(tcfg, mode, device="cpu", dtype=dt,
                                 draws=draws, start=start)


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
        assert (tc.cohort is None) == (jc.cohort is None)
        if jc.cohort is not None:
            np.testing.assert_array_equal(tc.cohort.numpy(), jc.cohort)
        np.testing.assert_allclose(tc.t_client.numpy(), jc.t_client,
                                   rtol=RTOL, err_msg="t_client")
        np.testing.assert_allclose(tc.m_round.numpy(), jc.m_round, rtol=RTOL)
        for f in ("prune", "bandwidth", "deadline", "per", "inner_cost"):
            np.testing.assert_allclose(
                getattr(tc.sol, f).numpy(), getattr(jc.sol, f), rtol=RTOL,
                atol=1e-12 if f in ("prune", "per") else 0.0, err_msg=f)
        np.testing.assert_array_equal(tc.sol.iterations.numpy(),
                                      jc.sol.iterations)
        assert (tc.sol.interference_psd is None) == \
            (jc.sol.interference_psd is None)
        if jc.sol.interference_psd is not None:
            np.testing.assert_allclose(tc.sol.interference_psd.numpy(),
                                       jc.sol.interference_psd, rtol=RTOL)
            assert int(tc.sol.fp_iterations) == int(jc.sol.fp_iterations)


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


def test_default_config_runs_the_reference_kernel_on_cpu():
    """``FleetConfig()``: 16 x 64 clients, 50 rounds, the reference kernel
    with magnitude masks (the engine's defaults)."""
    cfg = TENG.FleetConfig()
    assert (cfg.kernel, cfg.mask_kind) == ("reference", "magnitude")
    res = TENG.run_fleet(cfg, device="cpu")
    assert res.losses.shape == (50,) and np.isfinite(res.losses).all()
    assert res.losses[-1] < res.losses[0]


def test_unknown_mask_kind_raises():
    _, tcfg = _configs({})
    with pytest.raises(ValueError, match="mask_kind"):
        TENG.build_simulation(dataclasses.replace(tcfg, mask_kind="blocks"),
                              device="cpu")


@pytest.mark.parametrize("change,what", [
    (dict(kernel="pallas"), "kernel"), (dict(control_chunk=-1), "control_chunk"),
    (dict(cloud_period=-1), "cloud_period"),
])
def test_invalid_configs_raise_value_error(change, what):
    _, tcfg = _configs({})
    with pytest.raises(ValueError, match=what):
        TENG.build_simulation(dataclasses.replace(tcfg, **change),
                              device="cpu")


@pytest.mark.parametrize("alias", ["fused_xla", "fused_pallas"])
def test_tpu_kernel_names_are_aliases_of_fused(alias):
    _, tcfg = _configs({}, rounds=2)
    a = TENG.run_fleet(tcfg, device="cpu")
    b = TENG.run_fleet(dataclasses.replace(tcfg, kernel=alias), device="cpu")
    np.testing.assert_array_equal(a.losses, b.losses)


def test_partial_schedule_needs_gumbel_draws():
    jcfg, tcfg = _configs(UNIFORM, (3, 5), rounds=1)
    ref = _reference(jcfg)
    ref["draws"] = [d[:4] + (None,) + d[5:] for d in ref["draws"]]
    with pytest.raises(ValueError, match="gumbel"):
        _port(tcfg, ref)


def test_cohort_path_equals_full_path_in_float64():
    """The port's own property: gathering the cohort changes only the
    association of float sums (1e-6 under float64)."""
    _, tcfg = _configs(dict(participation="weighted",
                            participants_per_cell=2), (3, 5),
                       dict(cell_chunk=2))
    runs = [TENG.run_fleet(dataclasses.replace(tcfg, cohort_gather=g),
                           device="cpu", dtype=torch.float64)
            for g in (None, False)]
    for f in ("losses", "latencies", "mean_prune", "participants"):
        np.testing.assert_allclose(getattr(runs[0], f), getattr(runs[1], f),
                                   rtol=1e-6, err_msg=f)
    for name, layer in runs[1].params.items():
        for leaf, v in layer.items():
            np.testing.assert_allclose(runs[0].params[name][leaf], v,
                                       rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("kernel", ["fused", "reference"])
def test_control_chunk_is_bitwise_identical(kernel):
    """Blocking the solve over cells is elementwise over cells: the same
    bits on the CPU, with or without the cohort path."""
    for schedule in ({}, UNIFORM):
        _, tcfg = _configs(schedule, (5, 4), dict(kernel=kernel))
        a = TENG.run_fleet(tcfg, device="cpu")
        b = TENG.run_fleet(dataclasses.replace(tcfg, control_chunk=2),
                           device="cpu")
        for f in ("losses", "latencies", "deadlines", "bandwidth_util",
                  "mean_prune", "learning_cost"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
