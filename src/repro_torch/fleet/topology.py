"""Fleet shape, client population and per-round channels (orthogonal cells).

The port of ``repro.fleet.topology``'s default geometry: clients drop
uniformly in an annulus around their serving BS, path loss follows the
urban model 128.1 + 37.6 log10(d_km) dB, small-scale fading is i.i.d.
Rayleigh (exponential power gains) re-drawn every round, and each cell is
an independent instance of the paper's single-BS problem.  Everything is
shaped (num_cells, clients_per_cell).

Random numbers are not drawn here: ``make_population`` and
``OrthogonalCells.round_channel`` take their uniforms / exponentials from
a draw source (``fleet.engine.GeneratorDraws`` or injected arrays), since
JAX's threefry streams cannot be reproduced in torch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

__all__ = ["FleetTopology", "ClientPopulation", "RoundChannel",
           "OrthogonalCells", "path_loss_linear", "make_population",
           "sample_fading"]


@dataclasses.dataclass(frozen=True)
class FleetTopology:
    """Fleet shape + client heterogeneity ranges."""

    num_cells: int = 16
    clients_per_cell: int = 64
    min_dist_m: float = 50.0
    max_dist_m: float = 500.0
    cpu_hz_range: tuple[float, float] = (2e9, 8e9)      # f_i ~ U[lo, hi]
    samples_range: tuple[int, int] = (16, 64)           # K_i ~ U{lo..hi}
    max_prune: float = 0.7                              # rho_i^max

    def __post_init__(self):
        if self.num_cells < 1 or self.clients_per_cell < 1:
            raise ValueError(
                f"fleet needs at least one cell and one client per cell; got "
                f"{self.num_cells} x {self.clients_per_cell}")

    @property
    def num_clients(self) -> int:
        return self.num_cells * self.clients_per_cell

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_cells, self.clients_per_cell)


class ClientPopulation(NamedTuple):
    """Static per-client state, all shaped (num_cells, clients_per_cell)."""

    dist_m: torch.Tensor
    pathloss: torch.Tensor      # linear power gain (no fading)
    cpu_hz: torch.Tensor        # f_i
    num_samples: torch.Tensor   # K_i (float for weighting math)
    tx_power: torch.Tensor      # p_i
    max_prune: torch.Tensor     # rho_i^max


class RoundChannel(NamedTuple):
    """One round's channel realization.  ``served_home`` and
    ``interference`` stay ``None`` for orthogonal cells."""

    h_up: torch.Tensor
    h_down: torch.Tensor
    served_home: Optional[torch.Tensor] = None
    interference: Optional[object] = None


def path_loss_linear(dist_m: torch.Tensor) -> torch.Tensor:
    """Urban path loss 128.1 + 37.6 log10(d_km) dB, as a linear power gain."""
    pl_db = 128.1 + 37.6 * torch.log10(dist_m / 1000.0)
    return 10.0 ** (-pl_db / 10.0)


def make_population(topo: FleetTopology, tx_power_w: float,
                    u_dist: torch.Tensor, u_cpu: torch.Tensor,
                    num_samples: torch.Tensor) -> ClientPopulation:
    """Drop the fleet from its draws: ``u_dist`` and ``u_cpu`` are U[0, 1)
    of shape ``topo.shape``, ``num_samples`` the integer dataset sizes
    K_i ~ U{lo..hi} (as floats)."""
    lo, hi = topo.min_dist_m, topo.max_dist_m
    dist = lo + (hi - lo) * u_dist
    f_lo, f_hi = topo.cpu_hz_range
    cpu = f_lo + (f_hi - f_lo) * u_cpu
    return ClientPopulation(
        dist_m=dist,
        pathloss=path_loss_linear(dist),
        cpu_hz=cpu,
        num_samples=num_samples.to(dist.dtype),
        tx_power=torch.full_like(dist, tx_power_w),
        max_prune=torch.full_like(dist, topo.max_prune),
    )


def sample_fading(pathloss: torch.Tensor, ray_up: torch.Tensor,
                  ray_down: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One round of (uplink, downlink) gains: path loss x Rayleigh power
    (``ray_*`` are exponential(1) draws shaped like ``pathloss``)."""
    return pathloss * ray_up, pathloss * ray_down


@dataclasses.dataclass(frozen=True)
class OrthogonalCells:
    """Independent annular cells, no inter-cell coupling (the default)."""

    name: str = "orthogonal"

    def round_channel(self, h_up: torch.Tensor, h_down: torch.Tensor
                      ) -> RoundChannel:
        return RoundChannel(h_up=h_up, h_down=h_down)
