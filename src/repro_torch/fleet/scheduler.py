"""Round scheduling: participation, stragglers and deadlines.

The port of the synchronous part of ``repro.fleet.scheduler``.  All
decisions are float masks shaped (num_cells, clients_per_cell).  Random
decisions take their uniforms from the caller: a Bernoulli(p) draw is
``u < p`` on an injected U[0, 1) tensor, which is how ``jax.random.
bernoulli`` draws too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

__all__ = ["ScheduleConfig", "AsyncConfig", "participation_mask", "handover_mask",
           "straggler_mask", "on_time_mask", "clamp_round_latency"]


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    participation: str = "full"         # full | uniform | weighted
    participants_per_cell: int = 0      # m per cell (<=0 or >=I: everyone)
    straggler_prob: float = 0.0         # i.i.d. post-solve dropout
    round_deadline_s: float = math.inf  # hard per-round wall-clock cutoff
    handover_policy: str = "serve"      # serve | exclude (hex geometries)

    def __post_init__(self):
        if self.handover_policy not in ("serve", "exclude"):
            raise ValueError(
                f"handover_policy must be 'serve' or 'exclude', got "
                f"{self.handover_policy!r}")

    @property
    def has_deadline(self) -> bool:
        return math.isfinite(self.round_deadline_s)

    @property
    def is_full(self) -> bool:
        """Whether every client is scheduled every round."""
        m = self.participants_per_cell
        return self.participation == "full" or m <= 0


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the FedBuff-style buffered aggregation path.  Kept so a
    ``FleetConfig`` reads the same in both packages; the async engine
    itself is not ported yet (ROADMAP.md Queue A, item 6e)."""

    buffer_size: int = 64
    max_staleness: int = 20
    staleness_discount: str = "polynomial"
    staleness_alpha: float = 0.5
    retry_backoff_s: float = 60.0


def participation_mask(sched: ScheduleConfig, shape: tuple[int, int],
                       dtype: torch.dtype, device) -> torch.Tensor:
    """(C, I) mask of this round's scheduled clients.  Only full
    participation is ported; a partial schedule raises."""
    if sched.is_full or sched.participants_per_cell >= shape[-1]:
        return torch.ones(shape, dtype=dtype, device=device)
    raise NotImplementedError(
        "partial participation (uniform / weighted Gumbel top-k and the "
        "cohort gather it turns on) is not ported yet: ROADMAP.md Queue A, "
        "item 6b")


def handover_mask(served_home: Optional[torch.Tensor],
                  sched: ScheduleConfig) -> Optional[torch.Tensor]:
    """Participation factor from the round's handover state; ``None`` (a
    no-op) for geometries without handover or under the "serve" policy."""
    if served_home is None or sched.handover_policy == "serve":
        return None
    return served_home


def straggler_mask(sched: ScheduleConfig, u: torch.Tensor) -> torch.Tensor:
    """(C, I) float mask of clients that did NOT straggle out: Bernoulli
    ``1 - straggler_prob`` as ``u < 1 - p`` on the uniforms ``u``."""
    if sched.straggler_prob <= 0.0:
        return torch.ones_like(u)
    return (u < 1.0 - sched.straggler_prob).to(u.dtype)


def on_time_mask(latency_s: torch.Tensor, sched: ScheduleConfig
                 ) -> torch.Tensor:
    """Clients whose realized latency beats the round deadline (with no
    deadline: every finite latency)."""
    if not sched.has_deadline:
        return torch.isfinite(latency_s).to(latency_s.dtype)
    return (latency_s <= sched.round_deadline_s).to(latency_s.dtype)


def clamp_round_latency(makespan_s: torch.Tensor, sched: ScheduleConfig
                        ) -> torch.Tensor:
    """Time-triggered rounds end at the deadline regardless of stragglers."""
    if not sched.has_deadline:
        return makespan_s
    return torch.clamp_max(makespan_s, sched.round_deadline_s)
