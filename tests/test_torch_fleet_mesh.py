"""The fleet engine on a mesh (``build_simulation`` / ``run_fleet`` with
``mesh=``) against the port's meshless engine and the JAX engine.

Four gloo ranks on the CPU, started once for the module (a ``FileStore``
under the test's directory, each process with a timeout), run every case
of ``CASES`` on a ("cells" 2, "data" 2) fleet mesh (``make_fleet_mesh()``
over four ranks) in float64, from the reference's injected draws, params,
task state and batches (``test_torch_engine``'s harness; the reference
ran under ``jax.enable_x64(True)`` in this process): the fused kernel on
the full path; a uniform cohort with a ``control_chunk`` that cuts the
cells other than the mesh does; async events with stragglers; two-tier
rounds; hex cells at reuse 1 (the whole-fleet fixed point); and 3 cells,
which do not divide the "cells" dim.  Every draw's ``RoundControl`` must
be bitwise the meshless one on every rank; every rank must hold bitwise
the same result; the trajectories, the final params and the Theorem-1
bound must lie within 1e-10 of the port's meshless run (only the order
of Eq. (5)'s sum differs; two-tier runs whole on every rank and equals
it bitwise) and within 1e-5 of the JAX engine; a rerun must repeat bit
for bit.  The ranks count their collectives: one all-reduce a round or
event for Eq. (5), one all-gather a control pass where the cells split.

In this process, on a world of one: the 1 x 1 mesh equals the meshless
run bitwise (the twin of ``tests/test_cohort_equivalence.py::
test_fleet_mesh_run_matches_meshless``), two-tier warns as the reference
does, and the mesh builders' shapes (``test_fleet_mesh_factorization``).
The twin of ``tests/test_fleet_engine.py::test_engine_with_host_mesh``
runs on ``make_host_mesh(model=1)`` here and on the four ranks ("data"
4), each of which caches only the cells its clients lie in.
"""

import math
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import repro_torch
from repro_torch.fleet import engine as TENG
from repro_torch.launch import mesh as TMESH

from test_torch_async import _async_configs
from test_torch_engine import (HEX, JENG, JSCHED, UNIFORM, _configs, _draws,
                               _port, population_numpy)

SRC = Path(repro_torch.__file__).resolve().parents[1]
RTOL, MESH_RTOL = 1e-5, 1e-10
CHILD_TIMEOUT = 240
# name -> (mode, schedule, topology, FleetConfig overrides)
CASES = {
    "fused": ("sync", {}, (4, 4), {}),
    "cohort_control_chunk": ("sync", UNIFORM, (4, 5),
                             dict(control_chunk=3)),
    "async_stragglers": ("async", dict(straggler_prob=0.25), (2, 6), {}),
    "two_tier": ("sync", {}, (3, 4), dict(cloud_period=2)),
    "hex_reuse_1": ("sync", {}, (3, 4), dict(geometry=HEX, fp_rtol=0.0)),
    "cells_not_dividing": ("sync", {}, (3, 4), dict(cell_chunk=2)),
}
# the twin of test_engine_with_host_mesh (the default reference kernel)
HOST_CFG = TENG.FleetConfig(topology=TENG.TOPO.FleetTopology(2, 8), rounds=3)
RESULT_FIELDS = ("losses", "accuracy", "latencies", "deadlines", "mean_prune",
                 "mean_per", "participants", "bandwidth_util",
                 "learning_cost", "wall_clock", "staleness")
CONTROL_FIELDS = ("mask", "strag", "arrivals", "t_client", "m_round",
                  "cohort")

# one rank: waits for the cases (written while it starts), runs each on
# the fleet mesh twice, counting its collectives, then the host mesh's run
_RANK = r"""
import os, pickle, sys, time, warnings
import torch
import torch.distributed as dist
torch.set_num_threads(1)    # four ranks share the host's cores
rank, world, store, inp, out = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch import weights
from repro_torch.fleet import engine as E
from repro_torch.launch import mesh as MESH
while not os.path.exists(inp):
    time.sleep(0.05)

calls = {"all_reduce": 0, "all_gather": 0}
for name in calls:
    def counted(*a, _f=getattr(dist, name), _n=name, **k):
        calls[_n] += 1
        return _f(*a, **k)
    setattr(dist, name, counted)
with open(inp, "rb") as f:
    spec = pickle.load(f)
mesh = MESH.make_fleet_mesh(device="cpu")
dt = torch.float64


def controls(sim, n):
    out = []
    for k in range(n):
        c = sim._control(sim.draws.round(k, sim.population))
        row = {f: getattr(c, f) for f in ("mask", "strag", "arrivals",
                                          "t_client", "m_round", "cohort")}
        row.update({f"sol.{f}": v for f, v in c.sol._asdict().items()})
        out.append({f: None if v is None else v.numpy()
                    for f, v in row.items()})
    return out


res = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
       "cases": {}}
for name, (cfg, mode, ref) in spec["cases"].items():
    def build():
        draws = E.InjectedDraws(
            weights.population_from_numpy(ref["pop"], dt, "cpu"),
            [weights.round_draws_from_numpy(*d[:5], dtype=dt, device="cpu",
                                            **d[5]) for d in ref["draws"]])
        start = weights.start_from_numpy(ref["params"], ref["state"],
                                         ref["data"], dtype=dt, device="cpu")
        return E.build_simulation(cfg, mode, mesh=mesh, device="cpu",
                                  dtype=dt, draws=draws, start=start)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = build()
    for k in calls:
        calls[k] = 0
    result = sim.finalize(*sim.simulate(sim.params))
    counted = dict(calls)
    again = build()
    res["cases"][name] = {
        "result": result, "counts": counted,
        "rerun": again.finalize(*again.simulate(again.params)),
        "controls": controls(sim, len(ref["draws"])),
        "warnings": [str(w.message) for w in caught]}
host = MESH.make_host_mesh(model=1, device="cpu")
sim = E.build_simulation(spec["host"], mesh=host, device="cpu", dtype=dt)
res["host"] = {"result": sim.finalize(*sim.simulate(sim.params)),
               "shape": tuple(host.shape), "names": host.mesh_dim_names,
               "cached": (sim.data.first,
                          int(sim.data.cached["x"].shape[0]))}
with open(out, "wb") as f:
    pickle.dump(res, f)
dist.barrier()
dist.destroy_process_group()
"""


def _case_configs(mode, schedule, topology, extra):
    if mode == "async":
        return _async_configs(schedule, topology, dict(extra, kernel="fused"),
                              rounds=3)
    return _configs(schedule, topology, extra)


def _reference(jcfg, mode):
    """The JAX engine's result and what the port's run takes from it
    (``test_torch_engine._reference`` without the per-draw controls,
    which the mesh tests hold against the port's meshless pass)."""
    with jax.enable_x64(True):
        cfg2, task, state, params, pop, k_data, keys = \
            JENG._build_common(jcfg)
        _, data = JENG._make_batch_fn(task, state, cfg2, k_data)
        sim = JENG.build_simulation(jcfg, mode=mode)
        result = sim.finalize(*sim.simulate(sim.params, sim.round_keys))
        i = pop.pathloss.shape[-1]
        partial = JSCHED.cohort_size(jcfg.schedule, i) < i
        used = keys[:jcfg.rounds] if mode == "sync" else keys
        geo = JENG.resolve_geometry(jcfg)
        to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
        return dict(result=result, pop=population_numpy(pop),
                    draws=[_draws(k, pop, partial, geo) for k in used],
                    params=to_np(params), state=to_np(state),
                    data=to_np(data))


def _inputs(ref):
    return {k: ref[k] for k in ("draws", "pop", "params", "state", "data")}


def _build(tcfg, ref, mode, mesh=None):
    """``test_torch_engine._port``'s simulation, on ``mesh``."""
    sim = _port(tcfg, ref, mode=mode)
    return TENG.build_simulation(
        tcfg, mode, mesh=mesh, device="cpu", dtype=torch.float64,
        draws=sim.draws, start=TENG.SimStart(sim.params, sim.task_state,
                                             sim.data.cached))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's run of every case, the port's meshless run of each,
    and the four ranks' meshed runs (started together once)."""
    tmp = tmp_path_factory.mktemp("fleet_mesh")
    inp = tmp / "in.pkl"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "4", str(tmp / "store"),
         str(inp), str(tmp / f"rank{r}.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    refs, sims, cases = {}, {}, {}
    try:   # the reference and the meshless runs while the ranks start
        for name, (mode, *spec) in CASES.items():
            jcfg, tcfg = _case_configs(mode, *spec)
            refs[name] = _reference(jcfg, mode=mode)
            cases[name] = (tcfg, mode, _inputs(refs[name]))
        with open(tmp / "in.part", "wb") as f:
            pickle.dump({"cases": cases, "host": HOST_CFG}, f)
        os.replace(tmp / "in.part", inp)
        for name, (mode, *_) in CASES.items():
            tcfg, _, _ = cases[name]
            sims[name] = _port(tcfg, refs[name], mode=mode)
        meshless = {name: sim.finalize(*sim.simulate(sim.params))
                    for name, sim in sims.items()}
        errs = [p.communicate(timeout=CHILD_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(refs=refs, sims=sims, meshless=meshless, ranks=ranks,
                cases=cases)


def _params(res):
    return [(f"{n}/{k}", np.asarray(v)) for n, layer in
            sorted(res.params.items()) for k, v in sorted(layer.items())]


def _assert_results_equal(a, b):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for (name, x), (_, y) in zip(_params(a), _params(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.bound_final == b.bound_final


def _assert_results_close(got, want, rtol):
    for f in RESULT_FIELDS:
        if f in ("participants", "accuracy"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        else:
            np.testing.assert_allclose(getattr(got, f),
                                       np.asarray(getattr(want, f)),
                                       rtol=rtol, atol=1e-12, err_msg=f)
    want_params = dict(_params(want))
    for name, x in _params(got):
        np.testing.assert_allclose(x, want_params[name], rtol=rtol,
                                   atol=rtol * 1e-5, err_msg=name)
    assert math.isclose(got.bound_final, want.bound_final, rel_tol=rtol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_control_is_bitwise_meshless(world, case):
    """Every draw's control pass, the solution's fields included, on every
    rank: the same bits and dtypes as the meshless pass."""
    sim = world["sims"][case]
    n = len(world["refs"][case]["draws"])
    want = []
    for k in range(n):
        c = sim._control(sim.draws.round(k, sim.population))
        want.append({**{f: getattr(c, f) for f in CONTROL_FIELDS},
                     **{f"sol.{f}": v for f, v in c.sol._asdict().items()}})
    for rank in world["ranks"]:
        got = rank["cases"][case]["controls"]
        assert len(got) == n
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for f, v in w.items():
                assert (g[f] is None) == (v is None), f
                if v is not None:
                    assert g[f].dtype == v.numpy().dtype, f
                    np.testing.assert_array_equal(g[f], v.numpy(), err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_ranks_hold_bitwise_equal_results(world, case):
    first = world["ranks"][0]["cases"][case]["result"]
    for rank in world["ranks"][1:]:
        _assert_results_equal(rank["cases"][case]["result"], first)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_matches_meshless(world, case):
    """Within 1e-10 of the meshless run (bitwise where the gradient pass
    runs whole on every rank: two-tier)."""
    got = world["ranks"][0]["cases"][case]["result"]
    want = world["meshless"][case]
    if world["cases"][case][0].cloud_period >= 1:
        _assert_results_equal(got, want)
    else:
        _assert_results_close(got, want, MESH_RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_matches_reference(world, case):
    _assert_results_close(world["ranks"][0]["cases"][case]["result"],
                          world["refs"][case]["result"], RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_rerun_is_bitwise(world, case):
    for rank in world["ranks"]:
        _assert_results_equal(rank["cases"][case]["rerun"],
                              rank["cases"][case]["result"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_collectives_a_round(world, case):
    """Eq. (5) is one all-reduce a round or event (none where the
    gradient pass runs whole: two-tier); the control pass one all-gather
    where the cells split (none under interference), an async run's
    launch draw included."""
    mode, _, _, extra = CASES[case]
    cfg = world["cases"][case][0]
    rounds = cfg.rounds
    reduces = 0 if cfg.cloud_period >= 1 else rounds
    gathers = 0 if "geometry" in extra else \
        rounds + (1 if mode == "async" else 0)
    for rank in world["ranks"]:
        assert rank["cases"][case]["counts"] == {"all_reduce": reduces,
                                                 "all_gather": gathers}


def test_two_tier_on_a_mesh_warns_as_the_reference(world):
    for rank in world["ranks"]:
        for case, out in rank["cases"].items():
            want = [TENG._TWO_TIER_MESH_WARNING] \
                if world["cases"][case][0].cloud_period >= 1 else []
            assert out["warnings"] == want, case
    tcfg = world["cases"]["two_tier"][0]
    with pytest.warns(UserWarning, match="serial over cells"):
        TENG.build_simulation(tcfg, mesh=TMESH.make_fleet_mesh(device="cpu"),
                              device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_by_one_mesh_is_bitwise_meshless(world, case):
    mode, *_ = CASES[case]
    tcfg, _, _ = world["cases"][case]
    mesh = TMESH.make_fleet_mesh(cells=1, data=1, device="cpu")
    assert mesh.mesh_dim_names == ("cells", "data")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = _build(tcfg, world["refs"][case], mode, mesh)
    _assert_results_equal(sim.finalize(*sim.simulate(sim.params)),
                          world["meshless"][case])


def test_fleet_mesh_factorization(world):
    """Four ranks split (2, 2); a world of one (1, 1); the cells dim never
    larger than the data dim."""
    for rank in world["ranks"]:
        assert rank["shape"] == (2, 2)
        assert rank["names"] == ("cells", "data")
    mesh = TMESH.make_fleet_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("cells", "data")


def test_engine_with_host_mesh(world):
    """The engine on ("data", "model") meshes: the cells split over
    "data"; four ranks within 1e-10 of the meshless run and equal to each
    other, each caching the cell its 4 of the 16 clients lie in; a world
    of one bitwise the meshless run."""
    meshless = TENG.run_fleet(HOST_CFG, device="cpu", dtype=torch.float64)
    assert np.all(np.isfinite(meshless.losses))
    for r, rank in enumerate(world["ranks"]):
        host = rank["host"]
        assert host["shape"] == (4, 1)
        assert host["names"] == ("data", "model")
        assert host["cached"] == (8 * (r // 2), 8)
        _assert_results_equal(host["result"], world["ranks"][0]["host"]
                              ["result"])
        _assert_results_close(host["result"], meshless, MESH_RTOL)
    mesh = TMESH.make_host_mesh(model=1, device="cpu")
    one = TENG.run_fleet(HOST_CFG, mesh=mesh, device="cpu",
                         dtype=torch.float64)
    _assert_results_equal(one, meshless)
