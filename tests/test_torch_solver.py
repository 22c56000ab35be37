"""The port's batched Algorithm 1 against ``repro.fleet.solver.solve_fleet``,
uncoupled and inside the damped interference fixed point.

Same (C, I) inputs from numpy, both in float64 (JAX under
``jax.enable_x64(True)``).  Tolerance 1e-6 relative (plus a 1e-300
absolute floor for exact zeros): both solvers take the same discrete
steps, so only float64 rounding separates them.  Iteration counts must
match exactly, which pins the frozen-lane semantics of the reference's
vmapped ``while_loop`` (a lane that converged or hit ``max_iters`` keeps
its state while other lanes run on).  The fixed point runs at
``fp_rtol = 0`` against the reference (both take exactly ``fp_iters``
iterations; a tolerance could freeze them one iteration apart near the
threshold), and at the default tolerance on its own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import closed_form as JCF
from repro.fleet import solver as JSOL
from repro.fleet import topology as JTOPO
from repro_torch.core import closed_form as TCF
from repro_torch.fleet import solver as TSOL
from repro_torch.fleet import topology as TTOPO

N0 = 10 ** (-174 / 10) * 1e-3
P_UE = 10 ** (23 / 10) * 1e-3
KW = dict(bandwidth_hz=15e6, noise_psd=N0, waterfall_m0=10 ** 0.0023,
          model_bits=1.6e6, cycles_per_sample=0.168e9)


def _fleet(seed, c=6, i=12, partial=True):
    rng = np.random.default_rng(seed)
    dist = rng.uniform(50, 500, (c, i))
    pl = 10.0 ** (-(128.1 + 37.6 * np.log10(dist / 1000.0)) / 10.0)
    mask = np.ones((c, i))
    if partial:
        mask = (rng.uniform(size=(c, i)) > 0.25).astype(np.float64)
        mask[0] = 1.0
    return dict(h_up=pl * rng.exponential(size=(c, i)),
                num_samples=rng.integers(16, 65, (c, i)).astype(np.float64),
                cpu_hz=rng.uniform(2e9, 8e9, (c, i)),
                tx_power=np.full((c, i), P_UE),
                max_prune=np.full((c, i), 0.7),
                mask=mask)


def _solve_both(d, weight, cap=None, solver_kw=None):
    solver_kw = solver_kw or {}
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in d.items()}
        m = JCF.surrogate_m(j["num_samples"], 1.0, 1.0, 0.1, 1.0, xp=jnp,
                            mask=j["mask"])
        ref = JSOL.solve_fleet(
            j["h_up"], j["num_samples"], j["cpu_hz"], j["tx_power"],
            j["max_prune"], m, j["mask"],
            None if cap is None else jnp.asarray(cap), weight=weight,
            solver=JSOL.SolverConfig(**solver_kw), **KW)
        ref = jax.tree.map(np.asarray, ref)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    mt = TCF.surrogate_m(t["num_samples"], 1.0, 1.0, 0.1, 1.0, mask=t["mask"])
    got = TSOL.solve_fleet(
        t["h_up"], t["num_samples"], t["cpu_hz"], t["tx_power"],
        t["max_prune"], mt, t["mask"],
        None if cap is None else torch.as_tensor(cap), weight=weight,
        solver=TSOL.SolverConfig(**solver_kw), **KW)
    return got, ref


def _assert_solutions_match(got, ref):
    # rho and q are dimensionless in [0, 1]; the breakpoint client's
    # rho = 1 - t*/t_np is an ulp-level cancellation (2e-16 against 0), so
    # they get an absolute floor of 1e-12 beside the relative 1e-6.
    atol = dict(prune=1e-12, per=1e-12)
    for f in ("prune", "bandwidth", "deadline", "per", "inner_cost"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f),
                                   rtol=1e-6, atol=atol.get(f, 0.0),
                                   err_msg=f)
    np.testing.assert_array_equal(got.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(got.feasible.numpy(), ref.feasible)


@pytest.mark.parametrize("weight", [0.0004, 0.05, 0.5])
@pytest.mark.parametrize("partial", [False, True])
def test_solve_fleet_matches_reference(weight, partial):
    got, ref = _solve_both(_fleet(11, partial=partial), weight)
    _assert_solutions_match(got, ref)
    if weight < 0.01:  # latency-dominated: the vertex prunes someone
        assert (got.prune.numpy() > 0).any()


def test_solve_fleet_deadline_cap_matches_reference():
    d = _fleet(4)
    cap = np.array([0.05, 0.2, 0.5, 1.0, 3.0, 0.01])  # binding and slack caps
    got, ref = _solve_both(d, 0.0004, cap=cap)
    _assert_solutions_match(got, ref)
    # the tightest caps sideline somebody (B = 0 for a participant)
    sidelined = (got.bandwidth.numpy() == 0) & (d["mask"] > 0)
    assert sidelined.any()


def test_solve_fleet_lane_at_max_iters_freezes_like_reference():
    """max_iters=1: every lane hits the cap before converging."""
    got, ref = _solve_both(_fleet(8), 0.0004, solver_kw=dict(max_iters=1))
    _assert_solutions_match(got, ref)
    assert (got.iterations.numpy() == 1).all()


def test_solve_fleet_mixed_freeze_and_cap():
    """max_iters=2 with lanes that converge at different counts."""
    got, ref = _solve_both(_fleet(9, c=8), 0.05, solver_kw=dict(max_iters=2))
    _assert_solutions_match(got, ref)


# ---------------------------------------------------------------------------
# The interference fixed point and the per-cell form
# ---------------------------------------------------------------------------

def _coupled(seed, c=5, i=8, k=2):
    """A fleet and a co-channel graph: every cell hears its next ``k``
    cells' clients over cross paths 1-3 km long with Rayleigh fades."""
    d = _fleet(seed, c=c, i=i, partial=False)
    rng = np.random.default_rng(seed + 100)
    dist = rng.uniform(1000, 3000, (c, k, i))
    cross = 10.0 ** (-(128.1 + 37.6 * np.log10(dist / 1000.0)) / 10.0) \
        * rng.exponential(size=(c, k, i))
    idx = np.stack([(np.arange(c) + 1 + j) % c for j in range(k)], axis=1)
    return d, (cross, idx, np.ones((c, k)))


def _fixed_point_both(d, graph, solver_kw, weight=0.0004):
    cross, idx, nmask = graph
    with jax.enable_x64(True):
        j = {key: jnp.asarray(v) for key, v in d.items()}
        m = JCF.surrogate_m(j["num_samples"], 1.0, 1.0, 0.1, 1.0, xp=jnp)
        ref = JSOL.solve_fleet(
            j["h_up"], j["num_samples"], j["cpu_hz"], j["tx_power"],
            j["max_prune"], m, weight=weight,
            solver=JSOL.SolverConfig(**solver_kw),
            interference=JTOPO.InterferenceGraph(
                jnp.asarray(cross), jnp.asarray(idx), jnp.asarray(nmask)),
            **KW)
        ref = jax.tree.map(lambda v: None if v is None else np.asarray(v),
                           ref)
    t = {key: torch.as_tensor(v) for key, v in d.items()}
    mt = TCF.surrogate_m(t["num_samples"], 1.0, 1.0, 0.1, 1.0)
    got = TSOL.solve_fleet(
        t["h_up"], t["num_samples"], t["cpu_hz"], t["tx_power"],
        t["max_prune"], mt, weight=weight,
        solver=TSOL.SolverConfig(**solver_kw),
        interference=TTOPO.InterferenceGraph(
            torch.as_tensor(cross), torch.as_tensor(idx),
            torch.as_tensor(nmask)), **KW)
    return got, ref, graph


@pytest.mark.parametrize("fp_iters", [1, 2, 3, 4])
def test_fixed_point_matches_reference(fp_iters):
    """``fp_rtol = 0``: both run exactly ``fp_iters`` iterations."""
    got, ref, _ = _fixed_point_both(*_coupled(fp_iters), dict(
        fp_iters=fp_iters, fp_rtol=0.0))
    _assert_solutions_match(got, ref)
    np.testing.assert_allclose(got.interference_psd.numpy(),
                               ref.interference_psd, rtol=1e-6)
    np.testing.assert_allclose(float(got.fp_residual), ref.fp_residual,
                               rtol=1e-6)
    assert int(got.fp_iterations) == int(ref.fp_iterations) == fp_iters
    if fp_iters > 1:
        assert (got.interference_psd.numpy() > 0).any()


def test_fixed_point_iterate_is_monotone_from_zero():
    """More interference -> more bandwidth demanded -> more interference:
    the damped iterates climb from I = 0."""
    d, graph = _coupled(7)
    iterates = []
    for k in range(1, 6):
        got, _, _ = _fixed_point_both(d, graph, dict(fp_iters=k, fp_rtol=0.0))
        iterates.append(got.interference_psd.numpy())
    np.testing.assert_array_equal(iterates[0], 0.0)
    for prev, nxt in zip(iterates, iterates[1:]):
        assert np.all(nxt >= prev * (1.0 - 1e-9))
    assert (iterates[-1] > 0).any()


def test_default_tolerance_converges_inside_the_cap():
    """The default ``fp_rtol`` freezes strictly inside a cap of 16, at a
    self-consistent point: F(I*) within the tolerance of I*."""
    d, graph = _coupled(5)
    got, ref, _ = _fixed_point_both(d, graph, dict(fp_iters=16))
    assert 0 < int(got.fp_iterations) < 16
    assert int(got.fp_iterations) == int(ref.fp_iterations)
    cross, idx, nmask = graph
    i_raw = TTOPO.interference_psd(
        got.bandwidth, torch.as_tensor(d["tx_power"]),
        TTOPO.InterferenceGraph(torch.as_tensor(cross), torch.as_tensor(idx),
                                torch.as_tensor(nmask)), KW["bandwidth_hz"])
    i_star = got.interference_psd
    scale = N0 + float(i_star.max())
    assert float((i_raw - i_star).abs().max()) <= 2e-3 * scale


def test_solve_cell_equals_a_row_of_solve_fleet():
    d = _fleet(3, partial=True)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    m = TCF.surrogate_m(t["num_samples"], 1.0, 1.0, 0.1, 1.0, mask=t["mask"])
    cap = torch.full((d["h_up"].shape[0],), 0.3, dtype=torch.float64)
    fleet = TSOL.solve_fleet(t["h_up"], t["num_samples"], t["cpu_hz"],
                             t["tx_power"], t["max_prune"], m, t["mask"], cap,
                             weight=0.0004, **KW)
    for c in (0, 2):
        cell = TSOL.solve_cell(t["h_up"][c], t["num_samples"][c],
                               t["cpu_hz"][c], t["tx_power"][c],
                               t["max_prune"][c], m[c], t["mask"][c],
                               cap[c], weight=0.0004, **KW)
        for f in TSOL.CellSolution._fields[:7]:
            np.testing.assert_array_equal(getattr(cell, f).numpy(),
                                          getattr(fleet, f)[c].numpy(),
                                          err_msg=f)
