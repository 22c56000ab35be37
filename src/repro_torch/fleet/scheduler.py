"""Round scheduling: participation, stragglers, deadlines, async arrivals.

The port of ``repro.fleet.scheduler``.  All decisions are float masks
shaped (num_cells, clients_per_cell).  Random decisions take their draws
from the caller: a Bernoulli(p) draw is ``u < p`` on an injected U[0, 1)
tensor, which is how ``jax.random.bernoulli`` draws too, and partial
participation ranks logits plus an injected standard Gumbel tensor
(Gumbel top-k: m of I without replacement, uniform or weighted by K_i).

Every ranking is a stable ``argsort``, as ``jnp.argsort`` is: ties are
common on the async timeline (every client starts at t = 0, and every
unschedulable client retries exactly ``retry_backoff_s`` later) and break
by index, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

__all__ = ["ScheduleConfig", "AsyncConfig", "MAX_CLIENT_LATENCY_S",
           "cohort_size", "draws_participation", "participation_mask",
           "participation_cohort", "handover_mask", "straggler_mask",
           "on_time_mask", "clamp_round_latency", "arrival_times",
           "select_arrivals"]

# A client whose solved uplink rate is zero has infinite latency; in async
# mode it still takes a finite place on the arrival timeline (~30 years),
# so its update merges with weight zero instead of stalling the buffer.
MAX_CLIENT_LATENCY_S = 1e9


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
    """Knobs of the FedBuff-style buffered aggregation path.

    ``buffer_size`` (K) updates merge per server event (0: the whole
    fleet); ``max_staleness`` (tau_max, server versions) bounds the age of
    a merged update; ``staleness_discount`` / ``staleness_alpha`` pick the
    discount s(tau) (``core.aggregation.staleness_scale``); unschedulable
    clients re-register after ``retry_backoff_s`` seconds.
    """

    buffer_size: int = 64
    max_staleness: int = 20
    staleness_discount: str = "polynomial"
    staleness_alpha: float = 0.5
    retry_backoff_s: float = 60.0

    def __post_init__(self):
        if self.buffer_size < 0:
            raise ValueError(f"buffer_size must be >= 0, got {self.buffer_size}")
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}")
        if self.retry_backoff_s <= 0:
            raise ValueError(
                f"retry_backoff_s must be > 0, got {self.retry_backoff_s}")

    @property
    def history_len(self) -> int:
        """Param versions the ring buffer keeps: any merge with tau <=
        tau_max finds its download version."""
        return self.max_staleness + 1

    def cohort_buffer(self, num_clients: int) -> int:
        """K, with buffer_size = 0 meaning the whole fleet."""
        k = self.buffer_size if self.buffer_size > 0 else num_clients
        return min(k, num_clients)


def cohort_size(sched: ScheduleConfig, clients_per_cell: int) -> int:
    """Per-cell cohort width m (the whole cell for a full schedule)."""
    m = sched.participants_per_cell
    if sched.participation == "full" or m <= 0 or m >= clients_per_cell:
        return clients_per_cell
    return m


def draws_participation(sched: ScheduleConfig, clients_per_cell: int) -> bool:
    """Whether a round draws its schedule (a Gumbel tensor) at all."""
    return cohort_size(sched, clients_per_cell) < clients_per_cell


def _participation_scores(sched: ScheduleConfig, num_samples: torch.Tensor,
                          gumbel: torch.Tensor) -> torch.Tensor:
    """Logits plus the round's Gumbel draw: the one score tensor the mask
    and the cohort are both ranked from.  "weighted" takes the log of K_i
    in float32 before the sum, as the reference does under x64 too."""
    if sched.participation == "uniform":
        return gumbel
    if sched.participation == "weighted":
        return torch.log(num_samples.to(torch.float32)) + gumbel
    raise ValueError(f"unknown participation {sched.participation!r}")


def participation_mask(sched: ScheduleConfig, num_samples: torch.Tensor,
                       gumbel: Optional[torch.Tensor], dtype: torch.dtype
                       ) -> torch.Tensor:
    """(C, I) float mask of this round's scheduled clients: everyone, or
    per cell the m clients of highest score (``gumbel`` is the round's
    standard Gumbel draw, needed only by a partial schedule)."""
    return participation_cohort(sched, num_samples, gumbel, dtype)[0]


def participation_cohort(sched: ScheduleConfig, num_samples: torch.Tensor,
                         gumbel: Optional[torch.Tensor], dtype: torch.dtype
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The schedule as the (C, I) mask and the (C, m) cohort: each cell's
    m scheduled client indices, ascending (int64).  A full schedule is the
    identity cohort and needs no draw."""
    shape = tuple(num_samples.shape)
    dev = num_samples.device
    m = cohort_size(sched, shape[-1])
    if m >= shape[-1]:
        eye = torch.arange(shape[-1], device=dev)
        return (torch.ones(shape, dtype=dtype, device=dev),
                eye.expand(shape))
    if gumbel is None:
        raise ValueError("a partial schedule needs the round's Gumbel draw "
                         "(RoundDraws.gumbel)")
    z = _participation_scores(sched, num_samples, gumbel)
    order = torch.argsort(-z, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    mask = (rank < m).to(dtype)
    cohort = torch.sort(order[..., :m], dim=-1).values
    return mask, cohort


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


def arrival_times(start_time_s: torch.Tensor, client_latency_s: torch.Tensor,
                  retry_s: float = MAX_CLIENT_LATENCY_S) -> torch.Tensor:
    """Absolute times (s) at which in-flight updates reach the server: the
    download time plus the realized latency; an infinite latency (the
    client could not be scheduled) re-registers after ``retry_s``, and
    every latency is clamped to ``MAX_CLIENT_LATENCY_S``."""
    lat = torch.where(torch.isfinite(client_latency_s), client_latency_s,
                      retry_s)
    return start_time_s + torch.clamp_max(lat, MAX_CLIENT_LATENCY_S)


def select_arrivals(ready_time_s: torch.Tensor, buffer_size: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The next server event: the flat indices of the ``buffer_size``
    earliest arrivals in arrival order (ties by index) and the time the
    buffer fills (the last of them)."""
    flat = ready_time_s.reshape(-1)
    sel = torch.argsort(flat, stable=True)[:buffer_size]
    return sel, flat[sel[-1]]
