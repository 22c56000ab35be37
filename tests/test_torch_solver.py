"""The port's batched Algorithm 1 against ``repro.fleet.solver.solve_fleet``.

Same (C, I) inputs from numpy, both in float64 (JAX under
``jax.enable_x64(True)``).  Tolerance 1e-6 relative (plus a 1e-300
absolute floor for exact zeros): both solvers take the same discrete
steps, so only float64 rounding separates them.  Iteration counts must
match exactly, which pins the frozen-lane semantics of the reference's
vmapped ``while_loop`` (a lane that converged or hit ``max_iters`` keeps
its state while other lanes run on).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import closed_form as JCF
from repro.fleet import solver as JSOL
from repro_torch.core import closed_form as TCF
from repro_torch.fleet import solver as TSOL

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
