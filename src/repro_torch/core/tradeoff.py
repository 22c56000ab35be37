"""Communication-learning trade-off optimizer (paper §IV, Algorithm 1).

Solves problem (14):

  min_{rho, B, t}  (1-lambda) * t  +  lambda * m * sum_i K_i (q_i + K_i rho_i)
  s.t.  t_i^c + t_i^u <= t,   0 <= rho_i <= rho_i^max,
        sum_i B_i <= B,       B_i >= 0,

by alternating two closed-form sub-problems:

  * Pruning (fixed B):  objective (17a) is convex piecewise-linear in the
    deadline t~ with breakpoints at the no-pruning latencies
    t_i^np = D_M/R_i^u + K_i d^c/f_i;  Proposition 1 picks either t~min or
    the first breakpoint where the slope turns non-negative, and Eq. (16)
    recovers rho_i*(t~) = max{1 - t~/t_i^np, 0}.

  * Bandwidth (fixed rho, t~): by Lemma 1 both q_i(B_i) and R_i^u(B_i) are
    increasing, so the optimum is the *minimum* bandwidth meeting the
    deadline; Eq. (21) is solved per-UE by safeguarded Newton.  Lemma 2
    guarantees sum_i B_i* <= B stays feasible across iterations.

Baselines from §V are provided: GBA, FPR, exhaustive search, ideal FL.

The port of ``repro.core.tradeoff``: host code by design, numpy in and
out, as in the reference.  The closed forms (the pruning vertex, Eq. (16),
the Eq.-(21) inversion, rates, PER and latencies) are the port's
``core.closed_form`` run on float64 CPU tensors (``closed_form.on_host``,
through ``core.wireless``); the alternation, the baselines' scans and
grids and the bookkeeping are numpy.  The reference's numpy lane ends the
Newton loop of Eq. (21) early once every client converged, while the
port's runs its fixed trip count: converged steps move by rounding only,
so the two agree to rounding.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.core import closed_form as CF
from repro_torch.core.convergence import ConvergenceBound
from repro_torch.core.wireless import (
    WirelessConfig,
    packet_error_rate,
    round_latency,
    training_latency,
    uplink_rate,
    upload_latency,
)

__all__ = [
    "SolverConvergenceWarning",
    "ServingCostModel",
    "TradeoffProblem",
    "TradeoffSolution",
    "prune_rates_for_deadline",
    "solve_pruning",
    "min_bandwidth_for_rates",
    "solve_bandwidth",
    "solve_alternating",
    "solve_gba",
    "solve_fpr",
    "solve_exhaustive",
    "solve_ideal",
]

_LN2 = float(np.log(2.0))


class SolverConvergenceWarning(RuntimeWarning):
    """An iterative solver stopped at its iteration cap without meeting
    its convergence tolerance; the reported ``residual`` says by how
    much.  Filterable separately from generic RuntimeWarnings."""


@dataclasses.dataclass(frozen=True)
class TradeoffProblem:
    """One-round problem instance: wireless config + population + channel."""

    cfg: WirelessConfig
    bound: ConvergenceBound
    h_up: np.ndarray             # uplink gains h_i^u
    h_down: np.ndarray           # downlink gains h_i^d
    tx_power: np.ndarray         # p_i
    cpu_hz: np.ndarray           # f_i
    num_samples: np.ndarray      # K_i
    max_prune: np.ndarray        # rho_i^max
    weight: float = 0.0004       # lambda
    num_rounds: int = 200        # S (for psi)

    @property
    def num_clients(self) -> int:
        return int(np.asarray(self.h_up).size)

    # -- latency building blocks -------------------------------------------

    def compute_latency(self, prune: np.ndarray) -> np.ndarray:
        """t_i^c for given pruning rates."""
        return training_latency(self.cfg, prune, self.num_samples, self.cpu_hz)

    def uplink_rates(self, bandwidth: np.ndarray) -> np.ndarray:
        return uplink_rate(bandwidth, self.tx_power, self.h_up,
                           self.cfg.noise_psd_w_per_hz)

    def per(self, bandwidth: np.ndarray) -> np.ndarray:
        return packet_error_rate(bandwidth, self.tx_power, self.h_up,
                                 self.cfg.noise_psd_w_per_hz, self.cfg.waterfall_m0)

    def no_prune_latency(self, bandwidth: np.ndarray) -> np.ndarray:
        """t_i^np = D_M/R_i^u + K_i d^c/f_i — the per-UE breakpoints."""
        rates = self.uplink_rates(bandwidth)
        with np.errstate(divide="ignore"):
            t_u = self.cfg.model_bits / rates
        t_u = np.where(rates > 0.0, t_u, np.inf)
        return t_u + self.compute_latency(np.zeros(self.num_clients))

    def rate_ceiling(self) -> np.ndarray:
        """lim_{B->inf} R_i^u = p_i h_i^u / (N0 ln 2) — uplink capacity."""
        return np.asarray(self.tx_power) * np.asarray(self.h_up) \
            / (self.cfg.noise_psd_w_per_hz * _LN2)

    # -- objectives ----------------------------------------------------------

    def inner_cost(self, deadline: float, bandwidth: np.ndarray,
                   prune: np.ndarray) -> float:
        """(14a): (1-lambda) t~ + lambda m sum_i K_i (q_i + K_i rho_i)."""
        q = self.per(bandwidth)
        return ((1.0 - self.weight) * deadline
                + self.weight * self.bound.learning_cost(q, prune))

    def total_cost(self, bandwidth: np.ndarray, prune: np.ndarray) -> float:
        """(12a): the true weighted sum including broadcast/aggregation and psi."""
        t = round_latency(self.cfg, self.h_down, prune, bandwidth, self.tx_power,
                          self.h_up, self.num_samples, self.cpu_hz)
        q = self.per(bandwidth)
        gamma = self.bound.gamma(q, prune, self.num_rounds)
        return (1.0 - self.weight) * t + self.weight * gamma


@dataclasses.dataclass(frozen=True)
class ServingCostModel:
    """Prices deployment-time decode into the round objective (beyond the
    paper's (14a), which only sees training uplink/compute).

    Block-sparse serving makes per-token latency affine in the mean
    pruning rate: the serve engine skips pruned tiles, so

        t_token(rho) = base_latency_s * (alpha + (1 - alpha)(1 - rho))

    where ``alpha`` (``overhead_frac``) is the non-prunable fraction of a
    decode step — attention, norms, embeddings, dispatch.  Both constants
    are *measured*: ``benchmarks/serve_bench.py --tradeoff`` fits alpha
    from dense vs rho = 0.75 decode timings and feeds the model back in.
    The term rewards pruning (serving cost falls as rho rises), so the
    optimum shifts toward higher rho than the uplink-only solve — the
    serving-aware end of the communication-learning trade-off.
    """

    base_latency_s: float            # dense (rho = 0) per-token latency
    overhead_frac: float = 0.2       # alpha: non-prunable step fraction
    tokens_per_round: float = 1000.0  # serving tokens amortized per round
    weight: float = 1.0              # relative weight vs (14a)

    def per_token_latency(self, rho_mean: float) -> float:
        a = float(self.overhead_frac)
        return float(self.base_latency_s) * (
            a + (1.0 - a) * (1.0 - float(rho_mean)))

    def cost(self, prune: np.ndarray) -> float:
        """Serving-cost term for one round at pruning rates ``prune``."""
        rho_mean = float(np.mean(np.asarray(prune, dtype=np.float64)))
        return float(self.weight) * float(self.tokens_per_round) \
            * self.per_token_latency(rho_mean)


@dataclasses.dataclass
class TradeoffSolution:
    prune: np.ndarray
    bandwidth: np.ndarray
    deadline: float
    inner_cost: float
    total_cost: float
    per: np.ndarray
    iterations: int = 0
    feasible: bool = True
    # Relative cost movement |cost_k - cost_{k-1}| / max(|cost_k|, 1) at
    # the last alternation — 0.0-ish when converged, > rtol when the
    # solver hit max_iters first (in which case solve_alternating also
    # warns with SolverConvergenceWarning).  Single-shot schemes (GBA /
    # FPR / exhaustive / ideal) report 0.0.
    residual: float = 0.0


# ---------------------------------------------------------------------------
# Sub-problem A: pruning rates (Proposition 1 + Eq. 16)
# ---------------------------------------------------------------------------

def prune_rates_for_deadline(t_np: np.ndarray, deadline: float) -> np.ndarray:
    """Eq. (16): rho_i^min(t~) = max{1 - t~/t_i^np, 0}."""
    return CF.on_host(CF.prune_rates_for_deadline, t_np, deadline)


def solve_pruning(prob: TradeoffProblem, bandwidth: np.ndarray,
                  mask: np.ndarray | None = None,
                  m: float | None = None) -> tuple[float, np.ndarray]:
    """Proposition 1: closed-form optimal deadline t~* and pruning rates.

    The objective g(t~) = (1-lambda) t~ + lambda m sum K_i^2 rho_i^min(t~)
    is convex piecewise-linear; its minimum sits at t~min or at the first
    breakpoint t_i^np (ascending) where the slope turns >= 0.  The vertex
    enumeration is the shared ``closed_form.pruning_vertex`` (also the jax
    fleet solver's pruning step).

    ``mask`` restricts the vertex set / slope / rates to the scheduled
    clients (partial participation); ``m`` overrides the population-level
    Eq.-(11) coefficient with the scheduled subset's (see
    ``closed_form.surrogate_m``).
    """
    t_np = prob.no_prune_latency(bandwidth)
    t_star, rho = CF.on_host(
        CF.pruning_vertex, t_np, prob.num_samples, prob.weight,
        prob.bound.m if m is None else m, prob.max_prune, mask=mask)
    return float(t_star), rho


def _solve_pruning_serving(prob: TradeoffProblem, bandwidth: np.ndarray,
                           serving: ServingCostModel
                           ) -> tuple[float, np.ndarray]:
    """Pruning sub-problem with the serving-cost term.

    g(t~) = (1-lambda) t~ + lambda m sum K_i^2 rho_i(t~)
            + serving.cost(rho(t~))
    with rho_i(t~) = clip(1 - t~/t_i^np, 0, rho_i^max) stays piecewise
    linear in t~, but the rho^max clip makes it non-convex (each client's
    rho is constant-then-linear-then-constant), so Proposition 1's
    first-nonneg-slope walk no longer applies.  A piecewise-linear g
    still attains its minimum at a breakpoint: evaluate g exactly at
    every vertex — the no-pruning latencies t_i^np, the saturation points
    (1 - rho_i^max) t_i^np, and the feasibility floor t~min — and take
    the argmin.  O(I^2), exact.
    """
    t_np = prob.no_prune_latency(bandwidth)
    finite = np.isfinite(t_np)
    rho_max = np.asarray(prob.max_prune, dtype=np.float64)
    sat = (1.0 - rho_max) * t_np
    t_lo = float(np.max(sat[finite])) if np.any(finite) else 0.0
    cands = np.concatenate([t_np[finite], sat[finite], [t_lo]])
    cands = np.unique(np.clip(cands, t_lo, None))
    with np.errstate(divide="ignore", invalid="ignore"):
        need = 1.0 - cands[:, None] / t_np[None, :]
    need = np.where(finite[None, :], need, 1.0)
    rho = np.clip(need, 0.0, rho_max[None, :])          # (T, I)
    k = np.asarray(prob.num_samples, dtype=np.float64)
    lam = prob.weight
    g = (1.0 - lam) * cands + lam * prob.bound.m * (rho @ (k * k)) \
        + np.array([serving.cost(r) for r in rho])
    i = int(np.argmin(g))
    return float(cands[i]), rho[i]


# ---------------------------------------------------------------------------
# Sub-problem B: bandwidth allocation (Eq. 21)
# ---------------------------------------------------------------------------

def min_bandwidth_for_rates(target_rate: np.ndarray, tx_power: np.ndarray,
                            h_up: np.ndarray, noise_psd: float,
                            iters: int = 80) -> np.ndarray:
    """Vectorised Newton inversion of R^u(B) = target (Eq. 21), any
    broadcastable shapes.  R^u(B) is increasing in B (Lemma 1); targets
    at/above the capacity ceiling p h / (N0 ln 2) return inf."""
    return CF.on_host(CF.min_bandwidth_for_rates, target_rate, tx_power, h_up,
                      noise_psd, iters=iters)


def solve_bandwidth(prob: TradeoffProblem, prune: np.ndarray, deadline,
                    iters: int = 80) -> np.ndarray:
    """Eq. (21): per-UE minimum bandwidth meeting the deadline.

    ``prune`` may carry extra leading batch dims (grid search); ``deadline``
    broadcasts against it.
    """
    return CF.on_host(
        CF.bandwidth_for_deadline, prune, deadline, prob.num_samples,
        prob.cpu_hz, prob.cfg.cycles_per_sample, prob.cfg.model_bits,
        prob.tx_power, prob.h_up, prob.cfg.noise_psd_w_per_hz, iters=iters)


# ---------------------------------------------------------------------------
# Algorithm 1: alternating optimization
# ---------------------------------------------------------------------------

def _finish(prob: TradeoffProblem, bandwidth: np.ndarray, prune: np.ndarray,
            deadline: float, iterations: int,
            residual: float = 0.0) -> TradeoffSolution:
    feasible = bool(np.all(np.isfinite(bandwidth))
                    and np.sum(bandwidth) <= prob.cfg.bandwidth_hz * (1 + 1e-6))
    return TradeoffSolution(
        prune=prune, bandwidth=bandwidth, deadline=deadline,
        inner_cost=prob.inner_cost(deadline, bandwidth, prune),
        total_cost=prob.total_cost(bandwidth, prune),
        per=prob.per(bandwidth), iterations=iterations, feasible=feasible,
        residual=float(residual))


def _warn_not_converged(what: str, iterations: int, residual: float,
                        rtol: float) -> None:
    warnings.warn(
        f"{what} stopped at its iteration cap ({iterations}) without "
        f"converging: relative residual {residual:.3e} > rtol {rtol:.1e}. "
        "The reported solution is the last iterate; raise max_iters or "
        "loosen rtol to silence this.", SolverConvergenceWarning,
        stacklevel=3)


def solve_alternating(prob: TradeoffProblem, max_iters: int = 50,
                      rtol: float = 1e-8,
                      mask: np.ndarray | None = None,
                      deadline_cap: float | None = None,
                      m: float | None = None,
                      serving: ServingCostModel | None = None
                      ) -> TradeoffSolution:
    """Algorithm 1: equal-split init, then alternate Prop.1 / Eq.(21).

    The plain call (``mask``/``deadline_cap``/``m`` all None) is the
    paper's full-participation solve, unchanged.  The optional arguments
    are the host port of the fleet solver's scheduling extensions
    (``fleet.solver.solve_cell``), mirrored step for step so the two
    paths stay equivalence-testable:

    * ``mask`` — per-client participation; non-participants get
      rho = B = 0 and leave the vertex walk, the cost and the bandwidth
      budget split.
    * ``deadline_cap`` — time-triggered upper bound on t~ (seconds); the
      Eq.-(16) minimum pruning rates are re-derived at the capped
      deadline, unschedulable clients (infinite minimum bandwidth even at
      rho^max) sit out, and — since a binding cap voids Lemma 2's
      feasibility guarantee — the max-cardinality ascending-demand prefix
      that fits the budget keeps its allocation.
    * ``m`` — Eq.-(11) coefficient of the *scheduled subset* (the fleet
      engine re-derives it per round under partial participation).
    * ``serving`` — optional ``ServingCostModel``: adds the measured
      per-token decode cost to the objective, swapping the Prop.-1 vertex
      walk for the exact piecewise-linear argmin
      (``_solve_pruning_serving``).  The bandwidth step and convergence
      loop are unchanged; ``serving=None`` leaves the plain path
      untouched.  Not combinable with the scheduling extensions.
    """
    if serving is not None and (mask is not None or deadline_cap is not None
                                or m is not None):
        raise NotImplementedError(
            "serving-cost term is only supported on the plain "
            "(full-participation) solve")
    if mask is None and deadline_cap is None and m is None:
        if serving is None:
            prune_step = solve_pruning
        else:
            def prune_step(p, bw):
                return _solve_pruning_serving(p, bw, serving)
        bandwidth = np.full(prob.num_clients,
                            prob.cfg.bandwidth_hz / prob.num_clients)
        prev_cost = np.inf
        deadline, prune = prune_step(prob, bandwidth)
        resid = np.inf
        for it in range(1, max_iters + 1):
            deadline, prune = prune_step(prob, bandwidth)
            bandwidth = solve_bandwidth(prob, prune, deadline)
            cost = prob.inner_cost(deadline, bandwidth, prune)
            if serving is not None:
                cost = cost + serving.cost(prune)
            resid = abs(prev_cost - cost) / max(abs(cost), 1.0)
            if resid <= rtol:
                sol = _finish(prob, bandwidth, prune, deadline, it,
                              residual=resid)
                if serving is not None:
                    sol.inner_cost = cost
                return sol
            prev_cost = cost
        _warn_not_converged("Algorithm 1 alternation", max_iters, resid, rtol)
        sol = _finish(prob, bandwidth, prune, deadline, max_iters,
                      residual=resid)
        if serving is not None:
            sol.inner_cost = cost
        return sol

    msk = np.ones(prob.num_clients) if mask is None \
        else np.asarray(mask, dtype=np.float64)
    participating = msk > 0.0
    m_eff = prob.bound.m if m is None else float(m)
    k = np.asarray(prob.num_samples, dtype=np.float64)
    lam = prob.weight
    b_total = prob.cfg.bandwidth_hz

    def inner_cost(deadline, bw, rho):
        q = prob.per(bw)
        learning = m_eff * np.sum(msk * k * (q + k * rho))
        return float((1.0 - lam) * deadline + lam * learning)

    bandwidth = msk * (b_total / max(float(np.sum(msk)), 1.0))
    prev_cost = np.inf
    resid = np.inf
    deadline, prune = solve_pruning(prob, bandwidth, mask=msk, m=m_eff)
    for it in range(1, max_iters + 1):
        t_np = prob.no_prune_latency(bandwidth)
        deadline, prune = solve_pruning(prob, bandwidth, mask=msk, m=m_eff)
        if deadline_cap is not None:
            deadline = min(deadline, float(deadline_cap))
            prune = np.minimum(prune_rates_for_deadline(t_np, deadline),
                               prob.max_prune) * msk
        bandwidth = solve_bandwidth(prob, prune, deadline)
        if deadline_cap is not None:  # unschedulable at rho^max: sit out
            bandwidth = np.where(np.isfinite(bandwidth), bandwidth, 0.0)
            bandwidth = np.where(participating, bandwidth, 0.0)
            order = np.argsort(bandwidth, kind="stable")
            fits = np.cumsum(bandwidth[order]) <= b_total * (1.0 + 1e-9)
            keep = np.zeros_like(bandwidth)
            keep[order] = fits.astype(bandwidth.dtype)
            bandwidth = bandwidth * keep
        bandwidth = np.where(participating, bandwidth, 0.0)
        cost = inner_cost(deadline, bandwidth, prune)
        resid = abs(prev_cost - cost) / max(abs(cost), 1.0)
        if resid <= rtol:
            break
        prev_cost = cost
    else:
        _warn_not_converged("Algorithm 1 alternation (masked)", max_iters,
                            resid, rtol)
    sol = _finish(prob, bandwidth, prune, deadline, it, residual=resid)
    sol.per = sol.per * msk
    sol.inner_cost = cost
    return sol


# ---------------------------------------------------------------------------
# Benchmarks (paper §V)
# ---------------------------------------------------------------------------

def solve_gba(prob: TradeoffProblem) -> TradeoffSolution:
    """Greedy bandwidth allocation: B_i proportional to 1/h_i^u, then the
    pruning sub-problem is solved for that fixed allocation."""
    inv = 1.0 / np.asarray(prob.h_up, dtype=np.float64)
    bandwidth = prob.cfg.bandwidth_hz * inv / inv.sum()
    deadline, prune = solve_pruning(prob, bandwidth)
    return _finish(prob, bandwidth, prune, deadline, 1)


def solve_fpr(prob: TradeoffProblem, prune_rate: float,
              num_grid: int = 256) -> TradeoffSolution:
    """Fixed pruning rate rho_i = const; the deadline is chosen by a 1-D
    scan (the pruning closed form no longer applies) and bandwidth by
    Eq. (21)."""
    prune = np.minimum(np.full(prob.num_clients, prune_rate), prob.max_prune)
    t_c = prob.compute_latency(prune)
    # Deadline range: compute-only latency .. latency at equal-split bandwidth
    eq_bw = np.full(prob.num_clients, prob.cfg.bandwidth_hz / prob.num_clients)
    r_eq = prob.uplink_rates(eq_bw)
    t_hi = float(np.max(t_c + upload_latency(prob.cfg, prune, r_eq))) * 4.0
    t_lo = float(np.max(t_c)) * (1.0 + 1e-9) + 1e-12
    best, best_cost = None, np.inf
    for deadline in np.linspace(t_lo, t_hi, num_grid):
        bandwidth = solve_bandwidth(prob, prune, float(deadline))
        if not np.all(np.isfinite(bandwidth)):
            continue
        if np.sum(bandwidth) > prob.cfg.bandwidth_hz:
            continue
        cost = prob.inner_cost(float(deadline), bandwidth, prune)
        if cost < best_cost:
            best, best_cost = (float(deadline), bandwidth), cost
    if best is None:  # no feasible deadline in range: spend everything
        deadline = t_hi
        bandwidth = solve_bandwidth(prob, prune, deadline)
        return _finish(prob, bandwidth, prune, deadline, num_grid)
    return _finish(prob, best[1], prune, best[0], num_grid)


def _grid_eval(prob: TradeoffProblem, combos: np.ndarray,
               deadlines: np.ndarray):
    """Evaluate cost (14a) on a (combos x deadlines) lattice; returns
    (cost matrix, bandwidth tensor)."""
    c, n = combos.shape
    t = deadlines.size
    prune = np.broadcast_to(combos[:, None, :], (c, t, n))
    dl = np.broadcast_to(deadlines[None, :, None], (c, t, n))
    bw = solve_bandwidth(prob, prune, dl, iters=50)
    feasible = np.all(np.isfinite(bw), axis=-1) & \
        (np.sum(np.where(np.isfinite(bw), bw, 0.0), axis=-1)
         <= prob.cfg.bandwidth_hz)
    q = prob.per(np.where(np.isfinite(bw), bw, 0.0))
    k = np.asarray(prob.num_samples, dtype=np.float64)
    learning = prob.bound.m * np.sum(k * (q + k * prune), axis=-1)
    cost = (1.0 - prob.weight) * deadlines[None, :] + prob.weight * learning
    return np.where(feasible, cost, np.inf), bw


def solve_exhaustive(prob: TradeoffProblem, rho_grid: int = 6,
                     deadline_grid: int = 32, refine: int = 4) -> TradeoffSolution:
    """Exhaustive search (exponential, the paper's oracle benchmark).

    Enumerates every per-client pruning-rate combination on a ``rho_grid``
    lattice (rho_grid^I combos) crossed with a dense deadline grid; for
    each (rho, t~) the minimum bandwidth comes from Eq. (21).  Fully
    vectorised (Eq. (21) on a (combos, deadlines, clients) tensor), then
    ``refine`` rounds shrink the lattice around the incumbent so the
    answer approaches the continuum optimum.
    """
    n = prob.num_clients
    if rho_grid ** n > 100_000:  # exponential blow-up guard
        rho_grid = max(2, int(100_000 ** (1.0 / n)))

    # deadline range: fastest possible compute .. generous no-pruning upper
    eq_bw = np.full(n, prob.cfg.bandwidth_hz / n)
    t_np = prob.no_prune_latency(eq_bw)
    finite = t_np[np.isfinite(t_np)]
    if finite.size == 0:
        return _finish(prob, eq_bw, np.ones(n), np.inf, 0)
    t_lo = float(np.max(prob.compute_latency(prob.max_prune))) * (1 + 1e-9) + 1e-12
    t_hi = float(np.max(finite)) * 4.0

    lo_rho = np.zeros(n)
    hi_rho = np.asarray(prob.max_prune, dtype=np.float64).copy()
    evals = 0
    best = None
    for _ in range(max(refine, 1)):
        axes = [np.linspace(lo_rho[i], hi_rho[i], rho_grid) for i in range(n)]
        combos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, n)
        deadlines = np.geomspace(max(t_lo, 1e-12), t_hi, deadline_grid)
        cost, bw = _grid_eval(prob, combos, deadlines)
        evals += cost.size
        ci, ti = np.unravel_index(int(np.argmin(cost)), cost.shape)
        if not np.isfinite(cost[ci, ti]):
            break
        best = (bw[ci, ti], combos[ci], float(deadlines[ti]))
        # shrink the lattice around the incumbent
        step = (hi_rho - lo_rho) / (rho_grid - 1)
        lo_rho = np.clip(combos[ci] - step, 0.0, prob.max_prune)
        hi_rho = np.clip(combos[ci] + step, 0.0, prob.max_prune)
        ratio = (t_hi / t_lo) ** (1.0 / (deadline_grid - 1))
        t_lo_new = deadlines[ti] / ratio
        t_hi = deadlines[ti] * ratio
        t_lo = max(t_lo, t_lo_new)
    if best is None:
        return solve_alternating(prob)
    return _finish(prob, best[0], best[1], best[2], evals)


def solve_ideal(prob: TradeoffProblem) -> TradeoffSolution:
    """Ideal FL: no pruning, zero packet error (upper reference for accuracy).

    Bandwidth minimizes the round latency alone (equalizing waterfill via
    the Eq.-(21) inversion at the latency-optimal deadline)."""
    prune = np.zeros(prob.num_clients)
    # binary search on deadline: smallest t~ whose min-bandwidth fits B
    t_c = prob.compute_latency(prune)
    lo = float(np.max(t_c)) * (1.0 + 1e-9) + 1e-12
    hi = lo * 2.0 + 1.0
    while True:
        bw = solve_bandwidth(prob, prune, hi)
        if np.all(np.isfinite(bw)) and np.sum(bw) <= prob.cfg.bandwidth_hz:
            break
        hi *= 2.0
        if hi > 1e9:
            break
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        bw = solve_bandwidth(prob, prune, mid)
        if np.all(np.isfinite(bw)) and np.sum(bw) <= prob.cfg.bandwidth_hz:
            hi = mid
        else:
            lo = mid
    bandwidth = solve_bandwidth(prob, prune, hi)
    sol = _finish(prob, bandwidth, prune, hi, 1)
    sol.per = np.zeros(prob.num_clients)  # ideal: error-free channel
    return sol
