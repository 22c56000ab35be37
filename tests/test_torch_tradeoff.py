"""The port's host trade-off solvers (``core/tradeoff.py``) against
``repro.core.tradeoff``.

Both take the same numpy problem (the reference's ``Channel`` draws for
seeds 0-3, Table I parameters) and return numpy.  Continuous outputs
(rates, bandwidths, deadlines, costs, PERs, residuals) must agree at
1e-8 relative (a 1e-300 absolute floor for exact zeros): the closed
forms run in float64 on both sides, the reference's Newton loop stops
early and the port's runs its fixed count, so only rounding separates
them.  The residual is itself a relative difference of two costs: at
convergence it is rounding noise (~1e-16 or 0), so it also passes within
1e-12 absolute.  Discrete outputs (iterations, feasibility) and the
``SolverConvergenceWarning``s raised must be the same (numpy's own
RuntimeWarnings on the reference's float64 arrays have no counterpart in
torch and are not compared).
"""

import warnings

import numpy as np
import pytest

from repro.core import tradeoff as JT
from repro_torch.core import tradeoff as TT
from repro_torch.core import wireless as TW
from repro_torch.core.convergence import ConvergenceBound, SmoothnessParams

from conftest import make_problem

RTOL = 1e-8
FIELDS = ("prune", "bandwidth", "deadline", "inner_cost", "total_cost",
          "per", "residual")


def port_problem(p: JT.TradeoffProblem, **cfg) -> TT.TradeoffProblem:
    return TT.TradeoffProblem(
        cfg=TW.WirelessConfig(**cfg),
        bound=ConvergenceBound(SmoothnessParams(), p.num_samples),
        h_up=p.h_up, h_down=p.h_down, tx_power=p.tx_power, cpu_hz=p.cpu_hz,
        num_samples=p.num_samples, max_prune=p.max_prune, weight=p.weight,
        num_rounds=p.num_rounds)


def close(a, b, what="", atol=1e-300):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=RTOL,
                               atol=atol, err_msg=what)


def assert_solutions_match(got, ref):
    for f in FIELDS:
        close(getattr(got, f), getattr(ref, f), f,
              atol=1e-12 if f == "residual" else 1e-300)
    assert got.iterations == ref.iterations
    assert got.feasible == ref.feasible


def both(fn_name, jp, tp, **kw):
    """Run the solver on both problems, recording its warnings."""
    out = []
    for mod, prob in ((JT, jp), (TT, tp)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sol = getattr(mod, fn_name)(prob, **kw)
        out.append((sol, [str(w.message) for w in caught
                          if issubclass(w.category,
                                        mod.SolverConvergenceWarning)]))
    (ref, ref_warn), (got, got_warn) = out
    assert got_warn == ref_warn
    return got, ref


@pytest.fixture(params=[0, 1, 2, 3])
def problems(request):
    jp = make_problem(5, seed=request.param)
    return jp, port_problem(jp)


@pytest.mark.parametrize("name,kw", [
    ("solve_alternating", {}),
    ("solve_alternating", dict(max_iters=1, rtol=1e-30)),   # capped: warns
    ("solve_gba", {}),
    ("solve_fpr", dict(prune_rate=0.3)),
    ("solve_fpr", dict(prune_rate=0.0, num_grid=64)),
    ("solve_ideal", {}),
    ("solve_exhaustive", dict(rho_grid=4, deadline_grid=16, refine=3)),
])
def test_solver_matches_reference(problems, name, kw):
    got, ref = both(name, *problems, **kw)
    assert_solutions_match(got, ref)


def test_exhaustive_at_default_grid_matches_reference():
    jp = make_problem(5, seed=4)
    got, ref = both("solve_exhaustive", jp, port_problem(jp))
    assert_solutions_match(got, ref)


@pytest.mark.parametrize("kw", [
    dict(mask=np.array([1.0, 0.0, 1.0, 1.0, 0.0])),
    dict(deadline_cap=0.9),
    dict(deadline_cap=0.05, mask=np.array([1.0, 1.0, 0.0, 1.0, 1.0])),
    dict(m=2e-3),
    dict(mask=np.ones(5), m=1e-4, deadline_cap=2.0, max_iters=2),
])
def test_masked_capped_alternation_matches_reference(problems, kw):
    got, ref = both("solve_alternating", *problems, **kw)
    assert_solutions_match(got, ref)


@pytest.mark.parametrize("serving", [
    TT.ServingCostModel(base_latency_s=1e-3),
    TT.ServingCostModel(base_latency_s=5e-3, overhead_frac=0.5,
                        tokens_per_round=200.0, weight=0.3)])
def test_serving_cost_alternation_matches_reference(problems, serving):
    jp, tp = problems
    ref = JT.solve_alternating(jp, serving=JT.ServingCostModel(
        serving.base_latency_s, serving.overhead_frac,
        serving.tokens_per_round, serving.weight))
    got = TT.solve_alternating(tp, serving=serving)
    assert_solutions_match(got, ref)
    close(serving.cost(got.prune), JT.ServingCostModel(
        serving.base_latency_s, serving.overhead_frac,
        serving.tokens_per_round, serving.weight).cost(ref.prune))


def test_serving_rejects_scheduling_extensions(problems):
    with pytest.raises(NotImplementedError):
        TT.solve_alternating(problems[1], mask=np.ones(5),
                             serving=TT.ServingCostModel(1e-3))


def test_sub_problems_match_reference(problems):
    jp, tp = problems
    rng = np.random.default_rng(9)
    bw = rng.uniform(1e5, 6e6, 5)
    mask = np.array([1.0, 1.0, 0.0, 1.0, 1.0])
    for kw in ({}, dict(mask=mask), dict(mask=mask, m=3e-3)):
        (jd, jr), (td, tr) = JT.solve_pruning(jp, bw, **kw), \
            TT.solve_pruning(tp, bw, **kw)
        close(td, jd, "deadline")
        close(tr, jr, "rho")
    t_np = jp.no_prune_latency(bw)
    close(tp.no_prune_latency(bw), t_np)
    close(TT.prune_rates_for_deadline(t_np, 0.4),
          JT.prune_rates_for_deadline(t_np, 0.4))
    prune = rng.uniform(0.0, 0.7, (3, 5))
    close(TT.solve_bandwidth(tp, prune, np.array([0.3, 0.8, 2.0])),
          JT.solve_bandwidth(jp, prune, np.array([0.3, 0.8, 2.0])))
    target = np.array([0.0, 1e5, 1e7, 1e9, 1e12])
    close(TT.min_bandwidth_for_rates(target, tp.tx_power, tp.h_up, 4e-21),
          JT.min_bandwidth_for_rates(target, jp.tx_power, jp.h_up, 4e-21))
    serving = dict(base_latency_s=2e-3, overhead_frac=0.3)
    jd, jr = JT._solve_pruning_serving(jp, bw, JT.ServingCostModel(**serving))
    td, tr = TT._solve_pruning_serving(tp, bw, TT.ServingCostModel(**serving))
    close(td, jd)
    close(tr, jr)
    close(tp.rate_ceiling(), jp.rate_ceiling())
    close(tp.inner_cost(0.5, bw, prune[0]), jp.inner_cost(0.5, bw, prune[0]))
    close(tp.total_cost(bw, prune[0]), jp.total_cost(bw, prune[0]))


def test_converged_alternation_does_not_warn(problems):
    with warnings.catch_warnings():
        warnings.simplefilter("error", TT.SolverConvergenceWarning)
        sol = TT.solve_alternating(problems[1], max_iters=200)
    assert 0.0 <= sol.residual <= 1e-8
