"""Fleet shape, client population and per-round channels.

The port of ``repro.fleet.topology``.  Two geometries:

* ``OrthogonalCells`` (the default): clients drop uniformly in an annulus
  around their serving BS, path loss follows the urban model 128.1 + 37.6
  log10(d_km) dB, small-scale fading is i.i.d. Rayleigh (exponential
  power gains) re-drawn every round, and each cell is an independent
  instance of the paper's single-BS problem.
* ``HexInterference``: BSs on a hexagonal spiral, clients dropped around
  their home BS at the same radial draw plus an angle, cells coloured into
  frequency-reuse groups, each uplink loaded by the co-channel
  interference of its K nearest same-group cells (``InterferenceGraph``,
  which the solver's damped fixed point prices), optional per-round
  Gaussian mobility and strongest-gain handover.  Its zero-co-channel
  limit (``reuse >= num_cells``, static clients) is the orthogonal
  channel, bit for bit.

Everything is shaped (num_cells, clients_per_cell).  Random numbers are
not drawn here: ``make_population``, ``HexInterference.make_population``
and the ``round_channel`` methods take their uniforms, angles,
exponentials and normals from a draw source (``fleet.engine``'s
``GeneratorDraws`` or injected arrays), since JAX's threefry streams
cannot be reproduced in torch.

Interference model (mean-field over sub-band placement): client j of a
co-channel cell, transmitting p_j over B_j of the shared band B, raises
the interference PSD at a victim BS with cross gain g_j by
``p_j g_j B_j / B^2`` (``interference_psd``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["FleetTopology", "ClientPopulation", "POPULATION_ARRAYS",
           "HexState", "InterferenceGraph", "RoundChannel",
           "interference_psd", "OrthogonalCells", "HexInterference",
           "GEOMETRIES", "make_geometry", "hex_bs_positions",
           "hex_reuse_groups", "path_loss_linear", "make_population",
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


class HexState(NamedTuple):
    """Static spatial state of a ``HexInterference`` population.

    ``nbr_idx[c, k]`` lists the co-channel cells whose clients interfere
    into BS ``c`` (the K nearest same-group cells, padded with ``c`` under
    ``nbr_mask = 0``); ``cross_gain[c, k, i]`` is the path gain from client
    i of cell ``nbr_idx[c, k]`` to BS c; ``cand_gain[c, i, k]`` the gain
    from client (c, i) to BS ``nbr_idx[c, k]``.  Fading-averaged gains,
    recomputed every round under mobility.
    """

    bs_pos: torch.Tensor      # (C, 2) BS coordinates, m
    pos: torch.Tensor         # (C, I, 2) client home positions, m
    nbr_idx: torch.Tensor     # (C, K) co-channel neighbour cells (int64)
    nbr_mask: torch.Tensor    # (C, K) 1.0 real neighbour / 0.0 padding
    cross_gain: torch.Tensor  # (C, K, I) client-of-neighbour -> BS c
    cand_gain: torch.Tensor   # (C, I, K) client -> neighbour BS


class ClientPopulation(NamedTuple):
    """Static per-client state, all shaped (num_cells, clients_per_cell);
    ``geometry`` is the ``HexState`` of a hex population (None for
    orthogonal cells and the hex zero-co-channel limit)."""

    dist_m: torch.Tensor
    pathloss: torch.Tensor      # linear power gain (no fading)
    cpu_hz: torch.Tensor        # f_i
    num_samples: torch.Tensor   # K_i (float for weighting math)
    tx_power: torch.Tensor      # p_i
    max_prune: torch.Tensor     # rho_i^max
    geometry: Optional[HexState] = None


# the population's (C, I) tensors, in field order
POPULATION_ARRAYS = ClientPopulation._fields[:-1]


class InterferenceGraph(NamedTuple):
    """One round's co-channel coupling, which the solver's fixed point
    reads through ``interference_psd``."""

    cross_gain: torch.Tensor  # (C, K, I) faded cross gains
    nbr_idx: torch.Tensor     # (C, K)
    nbr_mask: torch.Tensor    # (C, K)


class RoundChannel(NamedTuple):
    """One round's channel realization.  ``served_home`` flags clients
    whose strongest candidate BS is their home BS (None without
    handover); ``interference`` is None for uncoupled cells."""

    h_up: torch.Tensor
    h_down: torch.Tensor
    served_home: Optional[torch.Tensor] = None
    interference: Optional[InterferenceGraph] = None


def interference_psd(bandwidth: torch.Tensor, tx_power: torch.Tensor,
                     graph: InterferenceGraph,
                     bandwidth_hz: float) -> torch.Tensor:
    """Per-cell co-channel interference PSD in W/Hz from an allocation:
    client j of a neighbour cell adds ``p_j g_j B_j / B^2``, so clients
    with B_j = 0 add nothing."""
    contrib = (tx_power * bandwidth)[graph.nbr_idx]        # (C, K, I)
    i_pow = torch.sum(contrib * graph.cross_gain * graph.nbr_mask[..., None],
                      dim=(-2, -1))
    return i_pow / (bandwidth_hz * bandwidth_hz)


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

    def round_channel(self, draws, pop: ClientPopulation,
                      topo: FleetTopology) -> RoundChannel:
        """The round's gains are the draws' ``h_up`` / ``h_down``."""
        return RoundChannel(h_up=draws.h_up, h_down=draws.h_down)


def hex_bs_positions(num_cells: int, spacing_m: float) -> np.ndarray:
    """Hexagonal-spiral BS layout: (num_cells, 2) coordinates in meters,
    centre-to-centre distance ``spacing_m``."""
    axial = _hex_axial(num_cells)
    q = axial[:, 0].astype(np.float64)
    r = axial[:, 1].astype(np.float64)
    return np.stack([spacing_m * (q + 0.5 * r),
                     spacing_m * (np.sqrt(3.0) / 2.0) * r], axis=-1)


def _hex_axial(num_cells: int) -> np.ndarray:
    """Axial (q, r) coordinates of a hex spiral covering ``num_cells``."""
    coords = [(0, 0)]
    dirs = [(-1, 1), (-1, 0), (0, -1), (1, -1), (1, 0), (0, 1)]
    ring = 0
    while len(coords) < num_cells:
        ring += 1
        q, r = ring, 0
        for dq, dr in dirs:
            for _ in range(ring):
                if len(coords) >= num_cells:
                    break
                coords.append((q, r))
                q, r = q + dq, r + dr
    return np.asarray(coords[:num_cells], dtype=np.int64)


# Proper hex colourings (no same-colour adjacent cells) for the standard
# reuse factors; other factors fall back to shift 2.
_REUSE_SHIFT = {3: 2, 4: 2, 7: 3}


def hex_reuse_groups(num_cells: int, reuse: int) -> np.ndarray:
    """Frequency-reuse group id per cell (0..reuse-1); ``reuse >=
    num_cells`` gives every cell its own group (the orthogonal limit)."""
    if reuse < 1:
        raise ValueError(f"reuse factor must be >= 1, got {reuse}")
    if reuse >= num_cells:
        return np.arange(num_cells, dtype=np.int64)
    axial = _hex_axial(num_cells)
    shift = _REUSE_SHIFT.get(reuse, 2)
    return np.mod(axial[:, 0] + shift * axial[:, 1], reuse)


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, spelled as ``jnp.linalg.norm``."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _hex_gains(pos: torch.Tensor, bs_pos: torch.Tensor, nbr_idx: torch.Tensor,
               min_dist_m: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cross_gain (C, K, I), cand_gain (C, I, K)) from client positions;
    distances clip at the annulus minimum."""
    nbr_bs = bs_pos[nbr_idx]                                   # (C, K, 2)
    cand_d = _norm2(pos[:, :, None, :] - nbr_bs[:, None, :, :])  # (C, I, K)
    cross_d = _norm2(pos[nbr_idx] - bs_pos[:, None, None, :])    # (C, K, I)
    cand = path_loss_linear(torch.clamp_min(cand_d, min_dist_m))
    cross = path_loss_linear(torch.clamp_min(cross_d, min_dist_m))
    return cross, cand


@dataclasses.dataclass(frozen=True)
class HexInterference:
    """Hex-grid cells with frequency reuse, co-channel interference,
    per-round mobility and strongest-gain handover (the reference's fields
    and defaults).

    ``reuse`` colours the grid; ``max_neighbors`` bounds the co-channel
    cells coupling into each BS; ``mobility_m`` is the per-round standard
    deviation of a Gaussian jitter around each home drop (0 = static);
    with ``handover`` a client whose strongest candidate BS (home or a
    co-channel neighbour, instantaneous fading) is not its home BS takes
    that gain, and ``RoundChannel.served_home`` flags it (the home BS wins
    ties).
    """

    reuse: int = 3
    max_neighbors: int = 6
    mobility_m: float = 0.0
    handover: bool = True
    spacing_factor: float = 2.0   # BS spacing = spacing_factor * max_dist_m

    name: str = "hex"

    def _num_neighbors(self, topo: FleetTopology) -> int:
        groups = hex_reuse_groups(topo.num_cells, self.reuse)
        counts = np.bincount(groups, minlength=self.reuse if
                             self.reuse < topo.num_cells else topo.num_cells)
        return int(min(self.max_neighbors, max(counts.max() - 1, 0)))

    def _bs_pos(self, topo: FleetTopology, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(
            hex_bs_positions(topo.num_cells,
                             self.spacing_factor * topo.max_dist_m),
            dtype=like.dtype, device=like.device)

    def round_draw_shapes(self, pop: ClientPopulation) -> dict:
        """The shapes of the round draws this geometry reads beyond the
        serving-link exponentials: ``jitter`` (normal), ``ray_handover``
        and ``ray_cross`` (exponential); absent where unused, so empty at
        the orthogonal limit."""
        c, i = pop.pathloss.shape
        geo = pop.geometry
        shapes = {}
        if self.mobility_m > 0.0:
            shapes["jitter"] = (c, i, 2)
        if geo is not None:
            k = geo.nbr_idx.shape[1]
            if self.handover:
                shapes["ray_handover"] = (c, i, k)
            shapes["ray_cross"] = (c, k, i)
        return shapes

    def make_population(self, topo: FleetTopology, pop: ClientPopulation,
                        angle: torch.Tensor) -> ClientPopulation:
        """Place the dropped clients (``pop``, from ``make_population``) at
        ``angle`` (radians, (C, I)) around their home BS and attach the
        co-channel graph; with no co-channel neighbour the population is
        returned as it is (the orthogonal limit)."""
        bs_pos = self._bs_pos(topo, pop.dist_m)
        pos = bs_pos[:, None, :] + pop.dist_m[..., None] * torch.stack(
            [torch.cos(angle), torch.sin(angle)], dim=-1)
        k_nbr = self._num_neighbors(topo)
        if k_nbr == 0:
            return pop
        groups = hex_reuse_groups(topo.num_cells, self.reuse)
        # distances in the run's dtype, as the reference ranks them: equal
        # hex distances may round apart, and the stable sort sees that
        bs_np = bs_pos.cpu().numpy()
        d2 = np.sum((bs_np[:, None, :] - bs_np[None, :, :]) ** 2, axis=-1)
        same = (groups[:, None] == groups[None, :]) \
            & ~np.eye(topo.num_cells, dtype=bool)
        d2 = np.where(same, d2, np.inf)
        order = np.argsort(d2, axis=-1, kind="stable")[:, :k_nbr]
        mask = np.take_along_axis(np.isfinite(d2), order, axis=-1)
        nbr_idx = torch.as_tensor(
            np.where(mask, order, np.arange(topo.num_cells)[:, None]),
            dtype=torch.int64, device=pos.device)
        cross, cand = _hex_gains(pos, bs_pos, nbr_idx, topo.min_dist_m)
        geo = HexState(bs_pos=bs_pos, pos=pos, nbr_idx=nbr_idx,
                       nbr_mask=torch.as_tensor(mask, dtype=pos.dtype,
                                                device=pos.device),
                       cross_gain=cross, cand_gain=cand)
        return pop._replace(geometry=geo)

    def round_channel(self, draws, pop: ClientPopulation,
                      topo: FleetTopology) -> RoundChannel:
        """One round's channel from the draws: the serving-link
        exponentials ``ray_up`` / ``ray_down`` on this round's path loss,
        then (per ``round_draw_shapes``) the mobility jitter, the handover
        candidates' fades and the cross-link fades.  With no co-channel
        neighbour and static clients this is the orthogonal channel
        (``draws.h_up`` / ``h_down``), bit for bit."""
        geo: Optional[HexState] = pop.geometry
        if geo is None and self.mobility_m <= 0.0:
            return RoundChannel(h_up=draws.h_up, h_down=draws.h_down)

        pathloss, cross, cand = pop.pathloss, None, None
        if geo is not None:
            cross, cand = geo.cross_gain, geo.cand_gain
        if self.mobility_m > 0.0:
            if geo is not None:
                bs_pos, home = geo.bs_pos, geo.pos
            else:
                # no HexState: re-derive a home position at angle 0 (the
                # jitter is isotropic either way)
                bs_pos = self._bs_pos(topo, pop.dist_m)
                home = bs_pos[:, None, :] + torch.stack(
                    [pop.dist_m, torch.zeros_like(pop.dist_m)], dim=-1)
            pos = home + self.mobility_m * draws.jitter
            dist = torch.clamp_min(_norm2(pos - bs_pos[:, None, :]),
                                   topo.min_dist_m)
            pathloss = path_loss_linear(dist)
            if geo is not None:
                cross, cand = _hex_gains(pos, geo.bs_pos, geo.nbr_idx,
                                         topo.min_dist_m)

        h_home = pathloss * draws.ray_up
        h_down = pathloss * draws.ray_down
        served_home = None
        h_up = h_home
        if self.handover and geo is not None:
            cand_inst = cand * draws.ray_handover * geo.nbr_mask[:, None, :]
            best_nbr = cand_inst.amax(dim=-1)
            h_up = torch.maximum(h_home, best_nbr)
            served_home = (h_home >= best_nbr).to(h_home.dtype)

        graph = None
        if geo is not None:
            graph = InterferenceGraph(cross_gain=cross * draws.ray_cross,
                                      nbr_idx=geo.nbr_idx,
                                      nbr_mask=geo.nbr_mask)
        return RoundChannel(h_up=h_up, h_down=h_down, served_home=served_home,
                            interference=graph)


GEOMETRIES = {
    "orthogonal": OrthogonalCells,
    "hex": HexInterference,
}


def make_geometry(name: str, **kw):
    """Build a registered geometry by name."""
    if name not in GEOMETRIES:
        raise ValueError(
            f"unknown geometry {name!r}; one of {sorted(GEOMETRIES)}")
    return GEOMETRIES[name](**kw)
