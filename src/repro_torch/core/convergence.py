"""Convergence theory of pruned FL (paper §III-A, Theorem 1), in numpy.

The port's own copy of ``repro.core.convergence`` (the fleet engine
evaluates the bound on the host after a run; the host reference path
prices its trade-off with ``gamma`` and tracks the realized rates with
``RoundTracker``):

  (1/(S+1)) sum_s E||grad F(W_s)||^2
    <=  2 beta (F(W_0) - F(W*)) / (d (S+1))
      + (8 xi1 / (d K))                 sum_i K_i qbar_i
      + (2 beta^2 I D^2 / (d K^2))      sum_i K_i^2 rhobar_i

with d = 1 - 8 xi2 (> 0 required) and K = sum_i K_i.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SmoothnessParams", "ConvergenceBound", "RoundTracker"]


@dataclasses.dataclass(frozen=True)
class SmoothnessParams:
    """Assumption constants: beta-smoothness, gradient bound (xi1, xi2),
    weight bound D, and the initial optimality gap F(W0) - F(W*)."""

    beta: float = 1.0
    xi1: float = 1.0
    xi2: float = 0.1          # must satisfy xi2 < 1/8 for d > 0
    weight_bound: float = 1.0  # D
    initial_gap: float = 1.0   # F(W_0) - F(W*)

    @property
    def d(self) -> float:
        d = 1.0 - 8.0 * self.xi2
        if d <= 0.0:
            raise ValueError(
                f"Theorem 1 requires xi2 < 1/8 (d = 1 - 8 xi2 > 0); got xi2={self.xi2}"
            )
        return d


class ConvergenceBound:
    """Evaluates Theorem 1 / Eq. (11) for a client population."""

    def __init__(self, params: SmoothnessParams, num_samples: np.ndarray):
        self.params = params
        self.k = np.asarray(num_samples, dtype=np.float64)
        if np.any(self.k <= 0):
            raise ValueError("every client must hold at least one sample")
        self.num_clients = int(self.k.size)
        self.k_total = float(self.k.sum())

    def initial_term(self, num_rounds: int) -> float:
        p = self.params
        return 2.0 * p.beta * p.initial_gap / (p.d * (num_rounds + 1))

    def packet_error_term(self, avg_per: np.ndarray) -> float:
        p = self.params
        return float(8.0 * p.xi1 / (p.d * self.k_total) * np.sum(self.k * avg_per))

    def pruning_term(self, avg_prune: np.ndarray) -> float:
        p = self.params
        coeff = 2.0 * p.beta**2 * self.num_clients * p.weight_bound**2
        return float(coeff / (p.d * self.k_total**2) * np.sum(self.k**2 * avg_prune))

    def bound(self, num_rounds: int, avg_per: np.ndarray, avg_prune: np.ndarray) -> float:
        """Full Theorem-1 upper bound on the mean squared gradient norm."""
        return (self.initial_term(num_rounds)
                + self.packet_error_term(avg_per)
                + self.pruning_term(avg_prune))

    @property
    def m(self) -> float:
        """Eq. (11) surrogate coefficient."""
        p = self.params
        return max(8.0 * p.xi1 / (p.d * self.k_total),
                   2.0 * p.beta**2 * self.num_clients * p.weight_bound**2
                   / (p.d * self.k_total**2))

    def psi(self, num_rounds: int) -> float:
        return self.initial_term(num_rounds)

    def gamma(self, per: np.ndarray, prune: np.ndarray,
              num_rounds: int) -> float:
        """gamma = psi + m sum_i K_i (q_i + K_i rho_i)."""
        return self.psi(num_rounds) + self.learning_cost(per, prune)

    def learning_cost(self, per: np.ndarray, prune: np.ndarray) -> float:
        """The optimizable part of gamma: m sum_i K_i (q_i + K_i rho_i)."""
        per = np.asarray(per, dtype=np.float64)
        prune = np.asarray(prune, dtype=np.float64)
        return float(self.m * np.sum(self.k * (per + self.k * prune)))


class RoundTracker:
    """Accumulates each round's (q_i, rho_i), so the average rates that
    feed Theorem 1 are exact over the realized schedule."""

    def __init__(self, num_clients: int):
        self.per_sum = np.zeros(num_clients)
        self.prune_sum = np.zeros(num_clients)
        self.rounds = 0

    def record(self, per: np.ndarray, prune: np.ndarray) -> None:
        self.per_sum += np.asarray(per, dtype=np.float64)
        self.prune_sum += np.asarray(prune, dtype=np.float64)
        self.rounds += 1

    @property
    def avg_per(self) -> np.ndarray:
        return self.per_sum / max(self.rounds, 1)

    @property
    def avg_prune(self) -> np.ndarray:
        return self.prune_sum / max(self.rounds, 1)
