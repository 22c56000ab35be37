"""Fleet rounds and events: channel -> solver -> pruned FedSGD -> aggregation.

The port of ``repro.fleet.engine``.  Two modes share one control pass
(``_make_control_fn``: the geometry's channel, schedule, Algorithm 1 over
every cell (``fleet/solver.py``, or a foreign ``solve_fn`` such as the
host reference solver of ``federated/system.py``), realized latencies,
straggler and packet draws):

* ``mode="sync"`` — the paper's FedSGD barrier.  A round ranks the model's
  tiles once, trains every scheduled client on its pruned model, applies
  the Eq.-(5)-weighted SGD step and evaluates.
* ``mode="async"`` — FedBuff buffered aggregation.  Clients report at
  their own realized latency (``scheduler.arrival_times``); each server
  event merges the earliest ``buffer_size`` arrivals, with
  staleness-discounted weights (``core.aggregation.buffered_weights``),
  against a ring buffer of the last ``max_staleness + 1`` param versions
  (one stacked tensor per leaf), then relaunches the merged clients with
  a fresh control draw.  With ``buffer_size = 0`` and full participation
  an event is a sync round.

Geometry (``FleetConfig.geometry``): ``OrthogonalCells`` (default) or
``HexInterference``, whose co-channel graph puts the solve inside the
solver's damped interference fixed point (the full fleet under the mask:
no cohort gather, no ``control_chunk`` blocking) and whose realized
uplink rates price the converged interference PSD (SINR, not SNR).

Two-tier aggregation (``cloud_period = n >= 1``): each cell's BS keeps an
edge model (one (C, ...) stacked tensor per leaf) that takes its own
Eq.-(5)-weighted step from its own clients every round (sync: a loop over
cells, one ranking and one gradient call each) or event (async: the
buffered per-client gradients, summed per cell in a fixed order); every n
rounds or events the cloud takes the merged-weight mean of the edges,
broadcasts it and pays ``WirelessConfig.backhaul_s``.  Metrics evaluate
the cloud view; async clients only download cloud checkpoints.

Client gradients (``FleetConfig.kernel``): ``"fused"`` streams the clients
through the fused kernel (``kernels/fleet_fused.py``, block-tile masks;
``"fused_xla"`` and ``"fused_pallas"``, which pin TPU execution paths in
the reference, are aliases of it); ``"reference"`` runs per-client
autodiff under ``torch.func.vmap`` with magnitude or block masks
(``mask_kind``), forming the (clients, params) gradient batch, which
``cell_chunk`` bounds.  The two-tier async event forms per-client
gradients on either kernel, with block masks under ``"fused"``.

Partial participation (uniform or weighted Gumbel top-k) turns on the
cohort path (``cohort_gather``): the control pass emits each cell's m
scheduled clients as a (C, m) index batch, the Algorithm-1 solve runs over
the gathered cohort and scatters back (uncoupled cells only), and the
gradient pass gathers rates, weights and batches along it, so the hot
path scales with m, not I.  ``control_chunk`` blocks the solve, and the
async rebuild of the in-flight state, over cells (elementwise over cells,
so bitwise equal on the CPU).

Client data (``ClientData``): each client's fixed batch is a pure function
of (data seed, client) (``FleetTask.client_batch``).  Below the 512 MB
cache limit (or with ``cache_data=True``) every batch is drawn once onto
the device; above it (or with ``cache_data=False``) each ``cell_chunk``
block, cohort gather, cell and async buffer draws its clients again.
Streaming equals caching bit for bit.

The reference's round ``scan`` is a Python loop here (``Simulation.step``);
every round tensor stays on the device.  Host syncs: one per solver
alternation and fixed-point iteration (the control pass), and in async
mode one per event (the populated ring slots).

Randomness comes from a draw source: ``GeneratorDraws`` (the default,
``torch.Generator``s on the device seeded from ``cfg.seed``) or
``InjectedDraws`` (tensors supplied by the caller, e.g. the reference's
own draws in the parity tests).  A sync run of R rounds reads draws 0 to
R - 1; an async run of R events reads R + 1 (draw 0 launches the fleet,
event r relaunches with draw r + 1).  The model and data side can
likewise be supplied as a ``SimStart``.

Telemetry (``FleetConfig.telemetry``, ``fleet/telemetry.py``; off by
default, and then a run is what it was without it): each round's or
event's metrics gain ``tel_``-prefixed summaries (per-cell histograms of
the control pass, gradient norm and mask density, async staleness, the
solver's diagnostics), device tensors until ``Simulation.finalize``
stacks them into ``FleetResult.telemetry``.  ``run_fleet(sink=...,
recorder=...)`` emits per-round records and records the build, simulate
and finalize spans.  The round's phases are ``record_function`` scopes
(``fleet.channel``, ``fleet.solve``, ``fleet.gradient``, ``fleet.merge``,
``fleet.eval``, ``fleet.cloud_merge``) whether telemetry is on or not.

A mesh (``build_simulation(mesh=...)``, a ``DeviceMesh`` from
``launch.mesh``; each rank runs on its own device, ``launch.mesh.
local_device``) splits a round over the ranks with explicit slices and
``torch.distributed`` collectives, the counterpart of the reference's
shardings.  Every rank holds the draws and the population whole (the same
seeds draw the same fleet).  The interference-free solve splits its cells
into contiguous blocks over the cell dim ("cells" on a fleet mesh, else
"data", as the reference's ``_shard_cells``), and one all-gather a control
pass gives every rank the whole ``RoundControl``, bitwise the meshless one
(the cells are independent); under interference, or with a ``solve_fn``,
every rank solves the whole fleet.  The gradient pass splits the flat
clients (or the flat cohort, or an async buffer) into contiguous slices
over all the mesh's ranks in row-major order; each rank ranks the model
once and runs its slice ``cell_chunk`` cells at a time, and Eq. (5)'s sums
(gradients, weights, losses) are one all-reduce a round or event.  The
step, the metrics and eval then run on identical inputs, so every rank
holds bitwise equal params and the same ``FleetResult``; only the order
of Eq. (5)'s sum differs from a meshless run.  Two-tier rounds and the
async two-tier buffer run whole on every rank, as the reference's serial
scan over cells does (it warns; so does the port).  With a cache, a sync
single-tier rank draws only the cells its slices reach.

Precision: ``dtype`` (default float32) plays the part of the reference's
global x64 flag.  On the card the kernels take float32 only, and
``device.resolve_device`` turns TF32 off for matrix products and cuDNN so
float32 means float32.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import warnings
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import aggregation as AGG
from repro_torch.core import closed_form as CF
from repro_torch.core import pruning, wireless
from repro_torch.core.convergence import ConvergenceBound, SmoothnessParams
from repro_torch.device import resolve_device
from repro_torch.fleet import scheduler as SCHED
from repro_torch.fleet import solver as SOLVER
from repro_torch.fleet import task as TASK
from repro_torch.fleet import telemetry as TEL
from repro_torch.fleet import topology as TOPO
from repro_torch.kernels import fleet_fused as FUSED
from repro_torch.launch.mesh import local_device

PyTree = Any

__all__ = ["FleetConfig", "FleetResult", "RoundControl", "RoundDraws",
           "GeneratorDraws", "InjectedDraws", "SimStart", "ClientData",
           "Simulation", "AsyncState", "build_simulation", "run_fleet",
           "run", "resolve_task", "resolve_geometry", "time_to_loss"]

KERNELS = ("reference", "fused", "fused_xla", "fused_pallas")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Everything a fleet run needs; the reference's field names and
    defaults (units follow ``WirelessConfig``; ``weight`` is lambda;
    ``rounds`` counts sync rounds or async events).

    ``kernel``: ``"reference"`` (per-client vmap + autodiff, ``mask_kind``
    magnitude or block masks) or ``"fused"`` (the fused kernel, block
    masks).  ``"fused_xla"`` and ``"fused_pallas"`` pin the reference's
    TPU execution paths; here both are aliases of ``"fused"``.
    ``cohort_gather``: None turns the cohort path on exactly when the
    schedule is partial; True forces it; False keeps the full fleet.
    ``geometry``: None (``OrthogonalCells``) or ``HexInterference``.
    ``cache_data``: None caches the client batches when the task allows it
    and they fit 512 MB; True always; False streams them.
    ``cloud_period``: 0 is single tier; n >= 1 the two-tier hierarchy.
    ``telemetry``: None (off) or a ``TelemetryConfig``.
    """

    topology: TOPO.FleetTopology = dataclasses.field(
        default_factory=TOPO.FleetTopology)
    geometry: Optional[Any] = None
    schedule: SCHED.ScheduleConfig = dataclasses.field(
        default_factory=SCHED.ScheduleConfig)
    async_config: SCHED.AsyncConfig = dataclasses.field(
        default_factory=SCHED.AsyncConfig)
    wireless: wireless.WirelessConfig = dataclasses.field(
        default_factory=wireless.WirelessConfig)
    smoothness: SmoothnessParams = dataclasses.field(
        default_factory=SmoothnessParams)
    solver: SOLVER.SolverConfig = dataclasses.field(
        default_factory=SOLVER.SolverConfig)
    weight: float = 0.0004
    rounds: int = 50
    lr: float = 1e-2
    seed: int = 0
    task: Optional[TASK.FleetTask] = None
    # synthetic-task fields, used only when task is None
    feature_dim: int = 32
    hidden: tuple[int, ...] = (16,)
    num_classes: int = 4
    local_batch: int = 8
    data_noise: float = 0.5
    test_samples: int = 512
    cell_chunk: int = 0
    cohort_gather: Optional[bool] = None
    control_chunk: int = 0
    kernel: str = "reference"
    mask_kind: str = "magnitude"
    prune_block: int = 8
    cache_data: Optional[bool] = None
    cloud_period: int = 0
    dirichlet_alpha: Optional[float] = None
    telemetry: Optional[TEL.TelemetryConfig] = None


def resolve_task(cfg: FleetConfig) -> TASK.FleetTask:
    """The run's task: ``cfg.task``, or a SyntheticMLPTask built from the
    synthetic-task fields."""
    if cfg.task is not None:
        if cfg.dirichlet_alpha is not None:
            raise ValueError("FleetConfig.dirichlet_alpha only applies to the "
                             "default SyntheticMLPTask")
        return cfg.task
    return TASK.SyntheticMLPTask(
        feature_dim=cfg.feature_dim, hidden=tuple(cfg.hidden),
        num_classes=cfg.num_classes, local_batch=cfg.local_batch,
        data_noise=cfg.data_noise, test_samples=cfg.test_samples,
        prune_block=cfg.prune_block, dirichlet_alpha=cfg.dirichlet_alpha)


def resolve_geometry(cfg: FleetConfig):
    """The run's cell geometry: ``cfg.geometry`` or orthogonal cells."""
    return cfg.geometry if cfg.geometry is not None else TOPO.OrthogonalCells()


def _check_supported(cfg: FleetConfig, mode: str) -> None:
    """Raise ``ValueError`` for invalid configurations."""
    if mode not in ("sync", "async"):
        raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
    if cfg.kernel not in KERNELS:
        raise ValueError(
            "kernel must be 'reference', 'fused', 'fused_xla' or "
            f"'fused_pallas', got {cfg.kernel!r}")
    if cfg.mask_kind not in ("magnitude", "block"):
        raise ValueError(
            f"mask_kind must be 'magnitude' or 'block', got {cfg.mask_kind!r}")
    if cfg.cloud_period < 0:
        raise ValueError(f"cloud_period must be >= 0 (0 = single-tier), got "
                         f"{cfg.cloud_period}")
    if cfg.control_chunk < 0:
        raise ValueError(f"control_chunk must be >= 0 (0 = solve all cells "
                         f"at once), got {cfg.control_chunk}")
    if not isinstance(resolve_geometry(cfg), (TOPO.OrthogonalCells,
                                              TOPO.HexInterference)):
        raise ValueError(f"geometry must be OrthogonalCells or "
                         f"HexInterference, got {type(cfg.geometry).__name__}")


@dataclasses.dataclass
class FleetResult:
    """Per-round (sync) or per-event (async) trajectories (host numpy), as
    in the reference; ``wall_clock`` is the simulated time axis."""

    losses: np.ndarray            # (rounds,)
    accuracy: np.ndarray          # (rounds,)
    latencies: np.ndarray         # (rounds,) realized round/event latency, s
    deadlines: np.ndarray         # (rounds, C) solver deadlines t~*, s
    mean_prune: np.ndarray        # (rounds,)
    mean_per: np.ndarray          # (rounds,)
    participants: np.ndarray      # (rounds,)
    bandwidth_util: np.ndarray    # (rounds, C)
    learning_cost: np.ndarray     # (rounds,)
    bound_final: float            # Theorem 1 on realized averages
    params: PyTree                # numpy arrays in the params layout
    wall_clock: np.ndarray = None  # (rounds,) cumulative simulated time, s
    staleness: np.ndarray = None   # (rounds,) mean merge age, versions
    mode: str = "sync"
    telemetry: Optional[dict] = None  # summaries without the tel_ prefix


class RoundControl(NamedTuple):
    """One draw's system state: schedule, channel, solver, latencies."""

    mask: torch.Tensor       # (C, I) participation
    strag: torch.Tensor      # (C, I) survived straggler churn
    arrivals: torch.Tensor   # (C, I) packet success indicators
    sol: SOLVER.CellSolution
    t_client: torch.Tensor   # (C, I) downlink + compute + uplink, s
    m_round: torch.Tensor    # (C,) scheduled-subset Eq.-(11) coefficient
    # (C, I) realized uplink SINR in dB, with telemetry only
    sinr_db: Optional[torch.Tensor] = None
    # (C, m) scheduled client indices, ascending per cell, on the cohort
    # path; None on the full-fleet path
    cohort: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Draw sources
# ---------------------------------------------------------------------------

class RoundDraws(NamedTuple):
    """One draw's random inputs, all (C, I) unless noted.  The fields from
    ``ray_up`` on are read by a ``HexInterference`` geometry only (see
    ``HexInterference.round_draw_shapes``)."""

    h_up: torch.Tensor      # uplink power gain (path loss x Rayleigh)
    h_down: torch.Tensor    # downlink power gain
    u_strag: torch.Tensor   # U[0, 1): straggler survival is u < 1 - p
    u_arr: torch.Tensor     # U[0, 1): packet arrives when u >= PER
    # standard Gumbel scores of a partial schedule (None for a full one)
    gumbel: Optional[torch.Tensor] = None
    ray_up: Optional[torch.Tensor] = None        # serving-link Exp(1) fades
    ray_down: Optional[torch.Tensor] = None
    jitter: Optional[torch.Tensor] = None        # (C, I, 2) N(0, 1) moves
    ray_handover: Optional[torch.Tensor] = None  # (C, I, K) Exp(1)
    ray_cross: Optional[torch.Tensor] = None     # (C, K, I) Exp(1)


def _seed(seed: int, stream: str, index: int = 0) -> int:
    h = hashlib.sha256(f"{seed}/{stream}/{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


class GeneratorDraws:
    """The default draw source: ``torch.Generator``s on ``device``, one per
    purpose, seeded from ``seed``.  Draw r depends only on (seed, r), so a
    simulation can be run again and repeats exactly.  With
    ``participation`` the draws carry a Gumbel tensor from a stream of its
    own, ``("participation", r)``; a hex ``geometry`` adds the clients'
    angles (stream ``"angle"``) and its round draws (``("hex", r)``).  So
    the other streams, and every orthogonal full-schedule run, are the
    same with or without them."""

    def __init__(self, seed: int, device, participation: bool = False,
                 geometry=None):
        self.seed = seed
        self.device = torch.device(device)
        self.participation = participation
        self.geometry = geometry

    def generator(self, stream: str, index: int = 0) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_seed(self.seed, stream, index))
        return g

    def _hex(self) -> bool:
        return isinstance(self.geometry, TOPO.HexInterference)

    def population(self, topo: TOPO.FleetTopology, tx_power_w: float,
                   dtype: torch.dtype) -> TOPO.ClientPopulation:
        g = self.generator("population")
        kw = dict(generator=g, dtype=dtype, device=self.device)
        u_dist = torch.rand(topo.shape, **kw)
        u_cpu = torch.rand(topo.shape, **kw)
        lo, hi = topo.samples_range
        samples = torch.randint(lo, hi + 1, topo.shape, generator=g,
                                device=self.device)
        pop = TOPO.make_population(topo, tx_power_w, u_dist, u_cpu, samples)
        if self._hex():
            angle = (2.0 * math.pi) * torch.rand(
                topo.shape, generator=self.generator("angle"), dtype=dtype,
                device=self.device)
            pop = self.geometry.make_population(topo, pop, angle)
        return pop

    def _exponential(self, shape, dtype, g) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=self.device
                           ).exponential_(generator=g)

    def round(self, r: int, pop: TOPO.ClientPopulation) -> RoundDraws:
        g = self.generator("round", r)
        shape, dtype = pop.pathloss.shape, pop.pathloss.dtype
        kw = dict(generator=g, dtype=dtype, device=self.device)
        ray_u = self._exponential(shape, dtype, g)
        ray_d = self._exponential(shape, dtype, g)
        h_up, h_down = TOPO.sample_fading(pop.pathloss, ray_u, ray_d)
        gumbel = None
        if self.participation:   # -log(Exp(1)) is standard Gumbel
            gumbel = -torch.log(self._exponential(
                shape, dtype, self.generator("participation", r)))
        draws = RoundDraws(h_up=h_up, h_down=h_down,
                           u_strag=torch.rand(shape, **kw),
                           u_arr=torch.rand(shape, **kw), gumbel=gumbel)
        if not self._hex():
            return draws
        extra = {}
        gh = self.generator("hex", r)
        for name, sh in self.geometry.round_draw_shapes(pop).items():
            extra[name] = (torch.randn(sh, generator=gh, dtype=dtype,
                                       device=self.device)
                           if name == "jitter"
                           else self._exponential(sh, dtype, gh))
        return draws._replace(ray_up=ray_u, ray_down=ray_d, **extra)


class InjectedDraws:
    """A draw source of given tensors: the population and one
    ``RoundDraws`` per draw a run reads (see ``repro_torch.weights`` for
    converters from numpy)."""

    def __init__(self, population: TOPO.ClientPopulation,
                 rounds: Sequence[RoundDraws]):
        self._population = population
        self._rounds = list(rounds)

    def population(self, topo, tx_power_w, dtype):
        if tuple(self._population.pathloss.shape) != topo.shape:
            raise ValueError(
                f"injected population is {tuple(self._population.pathloss.shape)}"
                f", the topology is {topo.shape}")
        return self._population

    def round(self, r: int, pop) -> RoundDraws:
        if r >= len(self._rounds):
            raise IndexError(f"no injected draws for draw {r} (an async run "
                             "of R events reads R + 1 draws)")
        return self._rounds[r]

    def check_participation(self) -> None:
        """Raise unless every draw carries a Gumbel tensor (a partial
        schedule needs one)."""
        missing = [r for r, d in enumerate(self._rounds) if d.gumbel is None]
        if missing:
            raise ValueError(
                f"a partial schedule needs RoundDraws.gumbel; injected draws "
                f"{missing} have none")

    def check_geometry(self, geometry, pop: TOPO.ClientPopulation) -> None:
        """Raise unless every draw carries what a hex geometry reads: the
        serving-link fades and ``round_draw_shapes``'s fields, in shape."""
        if not isinstance(geometry, TOPO.HexInterference):
            return
        want = dict(geometry.round_draw_shapes(pop))
        if want:   # not the orthogonal limit: the serving fades too
            want.update(ray_up=tuple(pop.pathloss.shape),
                        ray_down=tuple(pop.pathloss.shape))
        for r, d in enumerate(self._rounds):
            for name, shape in want.items():
                got = getattr(d, name)
                if got is None or tuple(got.shape) != tuple(shape):
                    raise ValueError(
                        f"the hex geometry reads RoundDraws.{name} of shape "
                        f"{tuple(shape)}; injected draw {r} has "
                        f"{None if got is None else tuple(got.shape)}")


class SimStart(NamedTuple):
    """The model and data side of a run, when the caller supplies it:
    initial params, the task state and every client's cached batch (None:
    the run draws the batches from the task state, as without a start)."""

    params: PyTree
    task_state: PyTree
    batches: Optional[PyTree] = None


def _check_on_device(what: str, tree, dev: torch.device) -> None:
    """Raise unless every tensor in ``tree`` (nested dicts and tuples) lies
    on ``dev``: a tensor left elsewhere would quietly move the round there,
    and CPU tensors take the kernels' plain versions."""
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, tuple):
        for leaf in tree:
            _check_on_device(what, leaf, dev)
    elif isinstance(tree, torch.Tensor) and not (
            tree.device.type == dev.type
            and dev.index in (None, tree.device.index)):
        raise ValueError(
            f"{what} lie on {tree.device} but the run is on {dev}: give the "
            "converters in repro_torch.weights the run's device")


# ---------------------------------------------------------------------------
# Meshes: how the ranks split a round
# ---------------------------------------------------------------------------

class Split(NamedTuple):
    """Work split over ``size`` ranks: this rank's ``index`` among them
    and the process ``group`` over them (None: the default group)."""

    index: int
    size: int
    group: Any


def _cell_split(mesh) -> Optional[Split]:
    """The split of the cells: over "cells" on a fleet mesh, else over
    "data" (the reference's ``_shard_cells``); None without a mesh or
    either dim."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names or ()
    axis = "cells" if "cells" in names else "data"
    if axis not in names:
        return None
    group = mesh.get_group(axis)
    return Split(dist.get_rank(group), dist.get_world_size(group), group)


def _world_split(mesh) -> Optional[Split]:
    """The split over every rank of ``mesh``, which must span the default
    group (``launch.mesh``'s builders' meshes do), in row-major order."""
    if mesh is None:
        return None
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a fleet mesh must span the default group's "
                         f"{dist.get_world_size()} ranks, not {mesh.size()}")
    return Split(dist.get_rank(), mesh.size(), None)


def _block(n: int, split: Optional[Split]) -> tuple[int, int]:
    """This rank's contiguous block of ``n`` items: blocks of ceil(n /
    size), the last ragged (or empty); (0, n) without a split."""
    if split is None:
        return 0, n
    b = -(-n // split.size)
    return min(split.index * b, n), min((split.index + 1) * b, n)


def _all_gather_blocks(part: torch.Tensor, n: int,
                       split: Split) -> torch.Tensor:
    """The (n, ...) whole of every rank's ``_block`` rows ``part``, by one
    all-gather of blocks padded to ceil(n / size) rows."""
    b = -(-n // split.size)
    buf = part.new_zeros((b,) + tuple(part.shape[1:]))
    buf[:part.shape[0]] = part
    parts = [torch.empty_like(buf) for _ in range(split.size)]
    dist.all_gather(parts, buf, group=split.group)
    return torch.cat(parts)[:n]


def _all_reduce_sum(tensors: list, split: Split) -> list:
    """Each tensor summed over the split's ranks by one all-reduce of one
    flat buffer in their promoted dtype; each comes back in its own shape
    and dtype, which must be the same on every rank."""
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in tensors])
    buf = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(buf, group=split.group)
    out, at = [], 0
    for t in tensors:
        out.append(buf[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


# ---------------------------------------------------------------------------
# Client data
# ---------------------------------------------------------------------------

_CACHE_LIMIT_BYTES = 512 << 20
_DRAW_BLOCK = 8192     # clients a cache fill draws at a time


class ClientData:
    """Every client's fixed local batch, cached on the device (``cached``,
    leading dim = clients from ``first`` on) or drawn again at each use
    from the task's per-client function (``cached is None``: streaming).
    Either way a client's batch has the same bits."""

    def __init__(self, task: TASK.FleetTask, state: PyTree, seed: int,
                 device, cached: Optional[PyTree] = None, first: int = 0):
        self.task, self.state, self.seed = task, state, seed
        self.device = torch.device(device)
        self.cached = cached
        self.first = first

    @classmethod
    def draw(cls, task, state, seed: int, num_clients: int, device,
             cache: bool, span: Optional[tuple[int, int]] = None
             ) -> "ClientData":
        """The data of a ``num_clients`` fleet; with ``cache`` the batches
        of the clients in ``span`` (default: all; an empty span caches
        none) are drawn now, ``_DRAW_BLOCK`` clients at a time."""
        lo, hi = (0, num_clients) if span is None else span
        data = cls(task, state, seed, device, first=lo)
        if cache and hi > lo:
            parts = [data.block(j, min(j + _DRAW_BLOCK, hi))
                     for j in range(lo, hi, _DRAW_BLOCK)]
            data.cached = {k: torch.cat([p[k] for p in parts])
                           for k in parts[0]}
        return data

    def take(self, clients: torch.Tensor) -> PyTree:
        """The batches of the flat client indices ``clients``."""
        if self.cached is not None:
            return {k: v[clients - self.first]
                    for k, v in self.cached.items()}
        return self.task.client_batch(self.state, self.seed, clients)

    def block(self, start: int, stop: int) -> PyTree:
        """The batches of clients ``start`` to ``stop - 1`` (a view of the
        cache where there is one)."""
        if self.cached is not None:
            start, stop = start - self.first, stop - self.first
            return {k: v[start:stop] for k, v in self.cached.items()}
        return self.task.client_batch(
            self.state, self.seed,
            torch.arange(start, stop, device=self.device))


def _batch_bytes(task: TASK.FleetTask, state: PyTree, seed: int,
                 num_clients: int, device) -> int:
    """The bytes of every client's batch, from client 0's."""
    one = task.client_batch(state, seed, torch.zeros(1, dtype=torch.int64,
                                                     device=device))
    return num_clients * sum(leaf.numel() * leaf.element_size()
                             for leaf in pruning.flatten(one))


def _cache_data(cfg: FleetConfig, task: TASK.FleetTask, state: PyTree,
                seed: int, device) -> bool:
    """``cfg.cache_data``, with None meaning: cache when the task allows it
    and the fleet's batches fit ``_CACHE_LIMIT_BYTES``."""
    if cfg.cache_data is not None:
        return bool(cfg.cache_data)
    return task.cache_batches and _batch_bytes(
        task, state, seed, cfg.topology.num_clients,
        device) <= _CACHE_LIMIT_BYTES


# ---------------------------------------------------------------------------
# Client gradients
# ---------------------------------------------------------------------------

def _tree_add(a, b):
    return pruning.tree_map(lambda x, y: x + y, a, b)


def _client_masks(task: TASK.FleetTask, params: PyTree, mask_kind: str):
    """``rho (n,) -> per-client masks`` at ``params``: block masks from one
    ranking of the model's tiles (one ``tile_norms`` launch), or magnitude
    masks from its sorted magnitudes."""
    if mask_kind == "block":
        block = task.tile_grid(params)
        state = pruning.block_norm_state(params, block)
        return lambda rho: pruning.masks_from_state(params, state, rho, block)
    mags = pruning.sorted_magnitudes(params)
    return lambda rho: pruning.magnitude_masks(params, rho, mags=mags)


def _grads_fn(task: TASK.FleetTask, params: PyTree, cfg: FleetConfig):
    """The per-model half of the gradient pass, run once for ``params``:
    the fused path's tile ranking (one ``tile_norms`` launch), or the
    reference path's sorted magnitudes or tile ranking.  Returns
    ``grads(rho, batch, weights) -> (weighted grad sum, losses)`` over a
    flat batch of clients."""
    if cfg.kernel != "reference":
        prep = task.kernel_prepare(params)
        return lambda rho, batch, w: task.kernel_grads(params, prep, batch,
                                                       rho, w)
    masks = _client_masks(task, params, cfg.mask_kind)

    def grads(rho, batch, w):
        losses, g = FUSED.masked_client_grads(task.loss, params, masks(rho),
                                              batch)
        return FUSED.weighted_sum(w, g), losses

    return grads


def _grad_template(params: PyTree, w: torch.Tensor) -> PyTree:
    """Zeros in the layout and dtype of a weighted gradient sum (each
    leaf's dtype promoted with the weights' and float32, as the gradient
    paths accumulate): a rank's part where it has no client."""
    return pruning.tree_map(lambda p: torch.zeros(
        p.shape, device=p.device, dtype=torch.promote_types(
            torch.promote_types(p.dtype, w.dtype), torch.float32)), params)


def _fleet_grads(task: TASK.FleetTask, params: PyTree, rho: torch.Tensor,
                 agg_w: torch.Tensor, sched_w: torch.Tensor,
                 cfg: FleetConfig, data: ClientData,
                 cohort: Optional[torch.Tensor] = None,
                 split: Optional[Split] = None):
    """Weighted-sum gradients over the fleet, ``cell_chunk`` cells at a
    time (a ragged remainder is one exact-sized last block), summed in
    order.  Returns (grad_wsum, sum agg_w, mean scheduled loss).

    ``cohort`` ((C, m) scheduled indices) gathers rates, weights and
    batches, so the gradient pass runs over C m clients, not C I;
    unscheduled clients weigh 0, so only the association of the float
    sums changes.  With ``split`` this rank runs its ``_block`` of the
    flat clients (or cohort) and one all-reduce sums the parts."""
    c, i = rho.shape
    flat = None
    if cohort is not None:
        rho, agg_w, sched_w = (torch.take_along_dim(a, cohort, dim=-1)
                               for a in (rho, agg_w, sched_w))
        flat = (torch.arange(c, device=cohort.device)[:, None] * i
                + cohort).reshape(-1)
        i = cohort.shape[-1]
    rho, agg_w, sched_w = (a.reshape(-1) for a in (rho, agg_w, sched_w))
    step = (cfg.cell_chunk if 0 < cfg.cell_chunk < c else c) * i
    lo, hi = _block(c * i, split)
    out = None
    if hi > lo:
        grads = _grads_fn(task, params, cfg)
    for j in range(lo, hi, step):
        k = min(j + step, hi)
        batch = data.block(j, k) if flat is None else data.take(flat[j:k])
        w_flat, lw_flat = agg_w[j:k], sched_w[j:k]
        g, losses = grads(rho[j:k], batch, w_flat)
        part = (g, torch.sum(w_flat), torch.sum(losses * lw_flat),
                torch.sum(lw_flat))
        out = part if out is None else _tree_add(out, part)
    if split is not None:
        template = _grad_template(params, agg_w)
        if out is None:
            zero = agg_w.new_zeros(())
            out = (template, zero, zero, zero)
        leaves = [p.to(t.dtype) for p, t in zip(pruning.flatten(out[0]),
                                                pruning.flatten(template))]
        summed = _all_reduce_sum(leaves + [v.to(agg_w.dtype)
                                           for v in out[1:]], split)
        out = (pruning.unflatten(out[0], summed[:len(leaves)]),
               *summed[len(leaves):])
    g_wsum, w_sum, loss_sum, loss_w = out
    return g_wsum, w_sum, loss_sum / torch.clamp_min(loss_w, 1.0)


# ---------------------------------------------------------------------------
# The control pass
# ---------------------------------------------------------------------------

def _cohort_enabled(cfg: FleetConfig) -> bool:
    """``cfg.cohort_gather``, with None meaning: on exactly when the
    schedule is partial."""
    if cfg.cohort_gather is not None:
        return bool(cfg.cohort_gather)
    return SCHED.draws_participation(cfg.schedule,
                                     cfg.topology.clients_per_cell)


def _map_cell_blocks(fn, chunk: int, operands):
    """``fn(operands)`` over consecutive ``chunk``-cell blocks (a ragged
    remainder is one exact-sized last block), concatenated on the cell
    axis; ``operands`` is a tree (``pruning.flatten``) of tensors leading
    with the cell axis.  ``fn`` must be elementwise over cells; then the
    result equals ``fn(operands)`` and only the working set shrinks."""
    c = pruning.flatten(operands)[0].shape[0]
    if not 0 < chunk < c:
        return fn(operands)
    parts = [fn(pruning.tree_map(lambda a: a[j:j + chunk], operands))
             for j in range(0, c, chunk)]
    return pruning.tree_map(lambda *xs: torch.cat(xs, dim=0), *parts)


def _solve_cells_chunked(chunk: int, h_up, num_samples, cpu_hz, tx_power,
                         max_prune, m_round, mask, cap, **kw
                         ) -> SOLVER.CellSolution:
    """``SOLVER.solve_fleet`` over consecutive blocks of ``chunk`` cells
    (0 or >= C: one solve).  The cells are independent and a frozen cell's
    lanes stay frozen, so the blocked solution equals the global one."""
    def solve(ops):
        return SOLVER.solve_fleet(*ops, **kw)

    return _map_cell_blocks(solve, chunk, (h_up, num_samples, cpu_hz,
                                           tx_power, max_prune, m_round,
                                           mask, cap))


_CLIENT_FIELDS = ("prune", "bandwidth", "per")                 # (C, I)
_CELL_FIELDS = ("deadline", "inner_cost", "iterations", "feasible")  # (C,)


def _solve_cells_split(split: Split, chunk: int, operands: tuple, **kw
                       ) -> SOLVER.CellSolution:
    """``_solve_cells_chunked`` over this rank's ``_block`` of cells, then
    one all-gather of every rank's block (packed in the gains' dtype; the
    iteration counts and feasibility flags are small integers, exact
    there), so every rank holds the whole solution, bitwise the global
    one.  ``operands`` lead with the (C, I) gains."""
    h_up = operands[0]
    c, i = h_up.shape
    lo, hi = _block(c, split)
    packed = h_up.new_zeros((hi - lo, len(_CLIENT_FIELDS) * i
                             + len(_CELL_FIELDS)))
    if hi > lo:
        sol = _solve_cells_chunked(
            chunk, *pruning.tree_map(lambda a: a[lo:hi], operands), **kw)
        packed = torch.cat(
            [getattr(sol, f) for f in _CLIENT_FIELDS]
            + [getattr(sol, f)[:, None].to(h_up.dtype) for f in _CELL_FIELDS],
            dim=-1)
    whole = _all_gather_blocks(packed, c, split)
    n = len(_CLIENT_FIELDS) * i
    out = {f: v.contiguous() for f, v in zip(
        _CLIENT_FIELDS, whole[:, :n].split(i, dim=-1))}
    out.update({f: v.contiguous() for f, v in zip(_CELL_FIELDS,
                                                  whole[:, n:].unbind(-1))})
    return SOLVER.CellSolution(
        **dict(out, iterations=out["iterations"].to(torch.int32),
               feasible=out["feasible"].to(torch.bool)))


def _make_control_fn(cfg: FleetConfig, pop: TOPO.ClientPopulation,
                     solve_fn=None, mesh=None):
    """One draw's control pass: channel -> schedule -> Algorithm 1 ->
    realized latencies -> straggler and packet draws.

    On the cohort path the schedule is also a (C, m) index batch; when the
    schedule is partial and the cells are uncoupled the solve runs over
    the gathered cohort and scatters back, clients outside it taking the
    fill the full solve gives non-participants (rho = 0, B = 0, q = 0).
    Under interference the whole fleet is solved, under the mask, inside
    the fixed point, and the realized uplink rates price its converged
    PSD.  ``solve_fn(h_up, mask, m_round, cap, interference)`` (a
    ``CellSolution`` of the whole fleet on the run's device) replaces the
    solver, as in the reference; every draw and latency term stays the
    engine's own.  With telemetry the pass also computes the realized
    uplink SINR (no extra draw) and the fixed point's residuals.  On a
    ``mesh`` the interference-free solve splits its cells over the cell
    dim (``_solve_cells_split``); the rest runs whole on every rank."""
    cells = _cell_split(mesh)
    w = cfg.wireless
    n0, b_hz = w.noise_psd_w_per_hz, w.bandwidth_hz
    geo = resolve_geometry(cfg)
    sched = cfg.schedule
    sm = cfg.smoothness
    use_cohort = _cohort_enabled(cfg)
    tcfg = cfg.telemetry
    solve_kw = dict(
        bandwidth_hz=b_hz, noise_psd=n0, waterfall_m0=w.waterfall_m0,
        model_bits=w.model_bits, cycles_per_sample=w.cycles_per_sample,
        weight=cfg.weight, solver=cfg.solver)

    def control(draws: RoundDraws) -> RoundControl:
        with torch.profiler.record_function("fleet.channel"):
            chan = geo.round_channel(draws, pop, cfg.topology)
        h_up, h_down = chan.h_up, chan.h_down
        mask, cohort = SCHED.participation_cohort(
            sched, pop.num_samples, draws.gumbel, h_up.dtype)
        if not use_cohort:
            cohort = None
        ho = SCHED.handover_mask(chan.served_home, sched)
        if ho is not None:
            mask = mask * ho
        m_round = CF.surrogate_m(pop.num_samples, sm.beta, sm.xi1, sm.xi2,
                                 sm.weight_bound, mask=mask)

        r_d = CF.downlink_rate(b_hz, w.tx_power_bs_w, h_down, n0)
        t_d = torch.where(mask > 0, w.model_bits / r_d, 0.0
                          ).amax(dim=-1, keepdim=True)
        cap = None
        if sched.has_deadline:
            cap = torch.clamp_min(sched.round_deadline_s
                                  - w.aggregation_latency_s - t_d[..., 0], 0.0)

        with torch.profiler.record_function("fleet.solve"):
            sol = solve(h_up, mask, m_round, cap, cohort, chan.interference)

        i_psd = 0.0 if sol.interference_psd is None \
            else sol.interference_psd[:, None]
        t_c = CF.training_latency(sol.prune, pop.num_samples,
                                  w.cycles_per_sample, pop.cpu_hz)
        r_u = CF.uplink_rate(sol.bandwidth, pop.tx_power, h_up, n0,
                             interference_psd=i_psd)
        t_u = CF.upload_latency(sol.prune, w.model_bits, r_u)
        t_client = t_d + t_c + t_u
        sinr_db = None
        if tcfg is not None:
            sinr_db = 10.0 * torch.log10(CF.uplink_sinr(
                sol.bandwidth, pop.tx_power, h_up, n0,
                interference_psd=i_psd))

        strag = SCHED.straggler_mask(sched, draws.u_strag)
        arrivals = (draws.u_arr >= sol.per).to(h_up.dtype)
        return RoundControl(mask=mask, strag=strag, arrivals=arrivals,
                            sol=sol, t_client=t_client, m_round=m_round,
                            sinr_db=sinr_db, cohort=cohort)

    def solve(h_up, mask, m_round, cap, cohort, interference
              ) -> SOLVER.CellSolution:
        if solve_fn is not None:
            return solve_fn(h_up, mask, m_round, cap, interference)
        clients = (h_up, pop.num_samples, pop.cpu_hz, pop.tx_power,
                   pop.max_prune, mask)
        if interference is not None:
            return SOLVER.solve_fleet(
                *clients[:5], m_round, mask, cap, interference=interference,
                diagnostics=tcfg is not None and tcfg.solver, **solve_kw)
        gathered = cohort is not None and cohort.shape[-1] < mask.shape[-1]
        if gathered:
            clients = tuple(torch.take_along_dim(a, cohort, dim=-1)
                            for a in clients)
        *clients, solve_mask = clients
        operands = (*clients, m_round, solve_mask, cap)
        if cells is None:
            sol = _solve_cells_chunked(cfg.control_chunk, *operands,
                                       **solve_kw)
        else:
            sol = _solve_cells_split(cells, cfg.control_chunk, operands,
                                     **solve_kw)
        if not gathered:
            return sol

        def scatter(v):
            return torch.zeros_like(mask, dtype=v.dtype).scatter(-1, cohort, v)
        return sol._replace(prune=scatter(sol.prune),
                            bandwidth=scatter(sol.bandwidth),
                            per=scatter(sol.per))

    return control


# ---------------------------------------------------------------------------
# Synchronous rounds
# ---------------------------------------------------------------------------

def _round_activity(cfg: FleetConfig, pop: TOPO.ClientPopulation,
                    ctl: RoundControl):
    """(active, arrivals, agg_w): scheduled, survived churn, on time, and
    landed a packet; agg_w = K_i C_i."""
    on_time = SCHED.on_time_mask(
        ctl.t_client + cfg.wireless.aggregation_latency_s, cfg.schedule)
    active = ctl.mask * ctl.strag * on_time
    arrivals = ctl.arrivals * active
    return active, arrivals, pop.num_samples * arrivals


def _round_metrics(cfg: FleetConfig, pop: TOPO.ClientPopulation,
                   ctl: RoundControl, active, arrivals, mean_loss):
    """The round's metric dict (minus task eval, with the control pass's
    telemetry) and the effective PER."""
    w = cfg.wireless
    mask, sol, t_client = ctl.mask, ctl.sol, ctl.t_client
    makespan = torch.where(mask > 0, t_client, -np.inf).amax(dim=-1) \
        + w.aggregation_latency_s
    round_lat = torch.amax(SCHED.clamp_round_latency(makespan, cfg.schedule))
    n_sched = torch.clamp_min(torch.sum(mask), 1.0)
    q_eff = 1.0 - active * (1.0 - sol.per)
    k_all = pop.num_samples
    learning = torch.sum(
        ctl.m_round[:, None] * k_all * (q_eff + k_all * sol.prune) * mask)
    metrics = {
        "loss": mean_loss,
        "round_latency": round_lat,
        "deadline": sol.deadline,
        "mean_prune": torch.sum(sol.prune * mask) / n_sched,
        "mean_per": torch.sum(q_eff * mask) / n_sched,
        "participants": torch.sum(arrivals),
        "bandwidth_util": torch.sum(sol.bandwidth, dim=-1) / w.bandwidth_hz,
        "learning_cost": learning,
    }
    if cfg.telemetry is not None:
        metrics.update(TEL.control_summaries(
            cfg.telemetry, sol, t_client, ctl.sinr_db, w.bandwidth_hz))
    return metrics, q_eff


def _grad_telemetry(tcfg: TEL.TelemetryConfig, sq_norm: torch.Tensor,
                    rho: torch.Tensor, sched: torch.Tensor) -> dict:
    """``tcfg.gradients``'s summaries: the aggregated step's norm (from
    its square ``sq_norm``) and the mean of 1 - rho over the 0/1
    schedule ``sched``."""
    n_sched = torch.clamp_min(torch.sum(sched), 1.0)
    return TEL.grad_summaries(tcfg, sq_norm,
                              torch.sum((1.0 - rho) * sched) / n_sched)


def _step_sq_norm(g: PyTree, w_sum: torch.Tensor) -> torch.Tensor:
    """Squared norm of the aggregated gradient g / sum w (1 for no
    weight)."""
    denom = torch.where(w_sum > 0, w_sum, 1.0)
    return TEL.tree_sq_norm(g) / (denom * denom)


def _sgd(params: PyTree, g_wsum: PyTree, w_sum: torch.Tensor, lr: float
         ) -> PyTree:
    """p - lr g / sum w, leaf by leaf; no step where every weight is 0."""
    denom = torch.where(w_sum > 0, w_sum, 1.0)
    return pruning.tree_map(
        lambda p, g: torch.where(w_sum > 0, (p - lr * g / denom).to(p.dtype),
                                 p), params, g_wsum)


def _with_eval(metrics: dict, task: TASK.FleetTask, state: PyTree,
               params: PyTree) -> dict:
    """The task's eval metrics folded in ("accuracy", the rest under an
    ``eval_`` prefix)."""
    ev = dict(task.eval_metrics(state, params))
    metrics["accuracy"] = ev.pop("accuracy")
    metrics.update({f"eval_{k}": v for k, v in ev.items()})
    return metrics


def _make_apply_round_fn(cfg: FleetConfig, task: TASK.FleetTask,
                         state: PyTree, pop: TOPO.ClientPopulation,
                         data: ClientData, mesh=None):
    """The model half of a sync round: consume a RoundControl and return
    the FedSGD update, the Theorem-1 accumulators and the metrics.  On a
    ``mesh`` the gradient pass splits over its ranks (``_fleet_grads``)."""

    grad_tel = cfg.telemetry is not None and cfg.telemetry.gradients
    split = _world_split(mesh)

    def apply_round(carry, ctl: RoundControl):
        params, per_sum, prune_sum = carry
        mask, sol = ctl.mask, ctl.sol
        active, arrivals, agg_w = _round_activity(cfg, pop, ctl)
        with torch.profiler.record_function("fleet.gradient"):
            g_wsum, w_sum, mean_loss = _fleet_grads(
                task, params, sol.prune, agg_w, mask, cfg, data,
                cohort=ctl.cohort, split=split)
        with torch.profiler.record_function("fleet.merge"):
            new_params = _sgd(params, g_wsum, w_sum, cfg.lr)
        metrics, q_eff = _round_metrics(cfg, pop, ctl, active, arrivals,
                                        mean_loss)
        if grad_tel:
            metrics.update(_grad_telemetry(
                cfg.telemetry, _step_sq_norm(g_wsum, w_sum), sol.prune,
                mask))
        with torch.profiler.record_function("fleet.eval"):
            metrics = _with_eval(metrics, task, state, new_params)
        return (new_params, per_sum + q_eff, prune_sum + sol.prune * mask), \
            metrics

    return apply_round


# ---------------------------------------------------------------------------
# Two-tier aggregation: an edge model per cell, a periodic cloud merge
# ---------------------------------------------------------------------------

def _cloud_view(edge: PyTree, acc_w: torch.Tensor,
                k_cell: torch.Tensor) -> PyTree:
    """The Eq.-(5) mean one tier up: each cell's edge model weighs in with
    the weight mass it merged since the last cloud merge (``acc_w``), or
    with its sample total where no cell merged anything.  With
    ``cloud_period = 1`` this is the single-tier step."""
    w = torch.where(torch.sum(acc_w) > 0, acc_w, k_cell)
    return AGG.aggregate(edge, w, torch.ones_like(w))


def _broadcast(cloud: PyTree, edge: PyTree) -> PyTree:
    """The cloud model in every cell's edge slot."""
    return pruning.tree_map(
        lambda e, cl: cl.to(e.dtype).expand(e.shape).clone(), edge, cloud)


def _make_two_tier_round_fn(cfg: FleetConfig, task: TASK.FleetTask,
                            state: PyTree, pop: TOPO.ClientPopulation,
                            data: ClientData):
    """The model half of a sync two-tier round: every cell's edge model
    takes its own Eq.-(5)-weighted step from its own scheduled clients (a
    loop over cells: one ranking of that edge model and one gradient call
    each; on the cohort path over its m scheduled clients); on every
    ``cloud_period``-th round the cloud merges the edges, broadcasts the
    result and the round pays the backhaul.  Metrics evaluate the cloud
    view.  The carry is (edge, merged weight since the last cloud merge,
    q sum, rho sum, rounds done)."""
    c, i = cfg.topology.shape
    k_cell = torch.sum(pop.num_samples, dim=-1)
    period = cfg.cloud_period
    grad_tel = cfg.telemetry is not None and cfg.telemetry.gradients

    def apply_round(carry, ctl: RoundControl):
        edge, acc_w, per_sum, prune_sum, r = carry
        active, arrivals, agg_w = _round_activity(cfg, pop, ctl)
        rho, sched_w = ctl.sol.prune, ctl.mask
        flat = None
        if ctl.cohort is not None:
            rho, agg_w, sched_w = (torch.take_along_dim(a, ctl.cohort, dim=-1)
                                   for a in (rho, agg_w, sched_w))
            flat = torch.arange(c, device=rho.device)[:, None] * i \
                + ctl.cohort
        cells, w_sums, loss_sums, loss_ws, sq_norms = [], [], [], [], []
        with torch.profiler.record_function("fleet.gradient"):
            for cell in range(c):
                theta = pruning.tree_map(lambda a: a[cell], edge)
                batch = (data.block(cell * i, (cell + 1) * i) if flat is None
                         else data.take(flat[cell]))
                g, losses = _grads_fn(task, theta, cfg)(rho[cell], batch,
                                                        agg_w[cell])
                w_sums.append(torch.sum(agg_w[cell]))
                cells.append(_sgd(theta, g, w_sums[-1], cfg.lr))
                loss_sums.append(torch.sum(losses * sched_w[cell]))
                loss_ws.append(torch.sum(sched_w[cell]))
                if grad_tel:   # this cell's edge-step norm^2
                    sq_norms.append(_step_sq_norm(g, w_sums[-1]))
        edge2 = pruning.tree_map(lambda *xs: torch.stack(xs), *cells)
        w_sums, loss_sums, loss_ws = (torch.stack(v) for v in
                                      (w_sums, loss_sums, loss_ws))
        mean_loss = torch.sum(loss_sums) / torch.clamp_min(
            torch.sum(loss_ws), 1.0)

        acc2 = acc_w + w_sums
        merge = r % period == period - 1
        with torch.profiler.record_function("fleet.cloud_merge"):
            cloud = _cloud_view(edge2, acc2, k_cell)
            if merge:
                edge2, acc2 = _broadcast(cloud, edge2), torch.zeros_like(acc2)
        metrics, q_eff = _round_metrics(cfg, pop, ctl, active, arrivals,
                                        mean_loss)
        if merge:
            metrics["round_latency"] = metrics["round_latency"] \
                + cfg.wireless.backhaul_s
        if grad_tel:
            metrics.update(_grad_telemetry(
                cfg.telemetry, torch.sum(torch.stack(sq_norms)),
                ctl.sol.prune, ctl.mask))
        with torch.profiler.record_function("fleet.eval"):
            metrics = _with_eval(metrics, task, state, cloud)
        return (edge2, acc2, per_sum + q_eff,
                prune_sum + ctl.sol.prune * ctl.mask, r + 1), metrics

    return apply_round


def _edge_mean(edge: PyTree, acc_w: np.ndarray,
               num_samples: np.ndarray) -> PyTree:
    """Host-side cloud view of the final edges (numpy), as
    ``_cloud_view``: merged-weight mass, else sample totals."""
    acc_w = np.asarray(acc_w, dtype=np.float64)
    if acc_w.sum() <= 0:
        acc_w = np.sum(np.asarray(num_samples, dtype=np.float64), axis=-1)
    w = acc_w / acc_w.sum()
    return pruning.tree_map(
        lambda a: np.tensordot(w.astype(a.dtype), a, axes=1), edge)


# ---------------------------------------------------------------------------
# Asynchronous (FedBuff) events
# ---------------------------------------------------------------------------

class AsyncState(NamedTuple):
    """Every client's in-flight update: the (C, I) fields describe the
    update each client is computing or uploading and are overwritten when
    it relaunches; the (C,) fields are the per-cell solver figures of the
    latest control draw."""

    ready: torch.Tensor       # (C, I) absolute arrival time, s
    start_ver: torch.Tensor   # (C, I) server version at download (int64)
    rho: torch.Tensor         # (C, I) pruning rate in flight
    per: torch.Tensor         # (C, I) solved packet error prob
    sched: torch.Tensor       # (C, I) participation mask at start
    alive: torch.Tensor       # (C, I) survived churn, finite latency
    arrive: torch.Tensor      # (C, I) packet success indicator
    m_cell: torch.Tensor      # (C,) surrogate m at start
    deadline_c: torch.Tensor  # (C,) solver deadline t~*, s
    bwutil_c: torch.Tensor    # (C,) sum B_i / B
    per_sum: torch.Tensor     # (C, I) Theorem-1 q accumulator
    prune_sum: torch.Tensor   # (C, I) Theorem-1 rho accumulator


def _fresh_state(t_client, mask, strag, arrivals, prune, per, bandwidth,
                 deadline, m_round, *, now, version, retry, b_hz
                 ) -> AsyncState:
    """A just-launched AsyncState for one control draw (any cell slice)."""
    return AsyncState(
        ready=SCHED.arrival_times(now, t_client, retry),
        start_ver=torch.full(mask.shape, version, dtype=torch.int64,
                             device=mask.device),
        rho=prune, per=per, sched=mask,
        alive=strag * torch.isfinite(t_client).to(mask.dtype),
        arrive=arrivals, m_cell=m_round, deadline_c=deadline,
        bwutil_c=torch.sum(bandwidth, dim=-1) / b_hz,
        per_sum=torch.zeros_like(mask), prune_sum=torch.zeros_like(mask))


def _merge_state(new: AsyncState, prev: AsyncState,
                 coh: torch.Tensor) -> AsyncState:
    """Cohort members adopt the fresh launch, everyone else stays in
    flight; the per-cell figures follow the new draw.  Elementwise over
    cells."""
    def pick(n, p):
        return torch.where(coh > 0, n, p)

    return new._replace(
        **{f: pick(getattr(new, f), getattr(prev, f))
           for f in ("ready", "start_ver", "rho", "per", "sched", "alive",
                     "arrive")},
        per_sum=prev.per_sum, prune_sum=prev.prune_sum)


def _start_state(ctl: RoundControl, now, version: int,
                 prev: Optional[AsyncState], coh: Optional[torch.Tensor],
                 cfg: FleetConfig) -> AsyncState:
    """(Re)launch clients: cohort members (everyone, at the start) adopt
    the fresh control draw and an arrival time at their own latency.
    ``cfg.control_chunk`` rebuilds the state a block of cells at a time."""
    sol = ctl.sol
    cell_args = (ctl.t_client, ctl.mask, ctl.strag, ctl.arrivals, sol.prune,
                 sol.per, sol.bandwidth, sol.deadline, ctl.m_round)
    kw = dict(now=now, version=version,
              retry=cfg.async_config.retry_backoff_s,
              b_hz=cfg.wireless.bandwidth_hz)

    def build(ops):
        new = _fresh_state(*ops[0], **kw)
        return new if ops[1] is None else _merge_state(new, ops[1], ops[2])

    return _map_cell_blocks(build, cfg.control_chunk, (cell_args, prev, coh))


def _slot_groups(cfg: FleetConfig, head: int, tau: torch.Tensor):
    """The buffer bucketed by ring slot (param version): (slot, indices
    into the buffer) for each populated slot, ascending.  Finding them is
    the event's one host sync."""
    hist_len = cfg.async_config.history_len
    slot = (head - torch.clamp(tau, 0, hist_len - 1)) % hist_len
    counts = torch.bincount(slot, minlength=hist_len).tolist()
    order = torch.argsort(slot, stable=True)
    groups, at = [], 0
    for s, count in enumerate(counts):
        if count:
            groups.append((s, order[at:at + count]))
            at += count
    return groups


def _buffer_grads(task: TASK.FleetTask, cfg: FleetConfig, hist: PyTree,
                  head: int, tau: torch.Tensor, data: ClientData,
                  sel: torch.Tensor, rho: torch.Tensor,
                  w_merge: torch.Tensor, split: Optional[Split] = None):
    """The weighted gradient sum of the buffer (the flat clients ``sel``),
    each update at its download version, and its per-client losses.

    Each populated slot (``_slot_groups``), in ascending order, takes its
    own clients only: one ranking (the fused path's ``tile_norms``
    launch) and one gradient call, summed in slot order.  Gathering the
    slot's clients keeps the work at K clients an event (passing the whole
    buffer with zero weights outside the slot, as the reference's static
    shapes force, costs K per populated slot).  With ``split`` this rank
    takes its ``_block`` of the buffer and one all-reduce sums the parts,
    the losses with them (zero outside each block, so those sum exactly)."""
    g_wsum = pruning.tree_map(lambda a: torch.zeros_like(a[0]), hist)
    losses = torch.zeros_like(w_merge)
    lo, hi = _block(sel.shape[0], split)
    batch = data.take(sel[lo:hi]) if hi > lo else None
    for s, idx in _slot_groups(cfg, head, tau[lo:hi]):
        params_s = pruning.tree_map(lambda a: a[s], hist)
        g, l_s = _grads_fn(task, params_s, cfg)(
            rho[lo:hi][idx], {k: v[idx] for k, v in batch.items()},
            w_merge[lo:hi][idx])
        g_wsum = pruning.tree_map(lambda a, b: a + b.to(a.dtype), g_wsum, g)
        losses = losses.index_copy(0, idx + lo, l_s.to(losses.dtype))
    if split is not None:
        leaves = pruning.flatten(g_wsum)
        summed = _all_reduce_sum(leaves + [losses], split)
        g_wsum, losses = pruning.unflatten(g_wsum, summed[:-1]), summed[-1]
    return g_wsum, losses


def _buffer_cell_sums(task: TASK.FleetTask, cfg: FleetConfig, hist: PyTree,
                      head: int, tau: torch.Tensor, batch: PyTree,
                      rho: torch.Tensor, w_merge: torch.Tensor,
                      onehot: torch.Tensor):
    """The two-tier event's per-cell sums sum_k w_k g_k over the buffer,
    one (C, ...) tensor per leaf, and its per-client losses.

    Per-client gradients at each client's download version, as the
    reference forms them: under ``kernel="fused"`` with the block masks
    of that version's ranking (one ``tile_norms`` launch a populated
    slot), under ``"reference"`` with ``cfg.mask_kind``.  Each slot's
    weighted gradients go to their cells through the (C, K) one-hot
    matrix ``onehot``, a product in a fixed order (no float atomics), and
    the slots add up in ascending order."""
    mask_kind = "block" if cfg.kernel != "reference" else cfg.mask_kind
    sums = pruning.tree_map(
        lambda a: a.new_zeros((onehot.shape[0],) + tuple(a.shape[1:])), hist)
    losses = torch.zeros_like(w_merge)
    for s, idx in _slot_groups(cfg, head, tau):
        params_s = pruning.tree_map(lambda a: a[s], hist)
        masks = _client_masks(task, params_s, mask_kind)(rho[idx])
        l_s, g = FUSED.masked_client_grads(
            task.loss, params_s, masks, {k: v[idx] for k, v in batch.items()})
        to_cells = onehot[:, idx] * w_merge[idx]
        sums = pruning.tree_map(
            lambda acc, gg: acc + torch.tensordot(to_cells.to(gg.dtype), gg,
                                                  dims=1), sums, g)
        losses = losses.index_copy(0, idx, l_s.to(losses.dtype))
    return sums, losses


def _make_async_step(cfg: FleetConfig, task: TASK.FleetTask, state: PyTree,
                     pop: TOPO.ClientPopulation, data: ClientData,
                     mesh=None):
    """One server event: fill the buffer with the K earliest arrivals,
    merge them (staleness-discounted) against the ring buffer, bump the
    version, relaunch the merged clients with the control draw ``ctl``.

    Two-tier (``cloud_period >= 1``; the carry gains the edge models and
    the merged weight since the last cloud merge): the buffered updates
    step their home cells' edge models (per-cell Eq.-(5) weights); every
    ``cloud_period``-th event the cloud merges the edges, pays the
    backhaul and pushes its model into the ring buffer, which otherwise
    keeps the current checkpoint, so clients only download cloud
    models.  On a ``mesh`` the single-tier buffer splits over its ranks
    (``_buffer_grads``); the two-tier buffer runs whole on every rank."""
    split = _world_split(mesh)
    acfg = cfg.async_config
    w = cfg.wireless
    n = cfg.topology.num_clients
    c_cells, i_per_cell = cfg.topology.shape
    k_buf = acfg.cohort_buffer(n)
    hist_len = acfg.history_len
    k_all = pop.num_samples
    k_flat = k_all.reshape(-1)
    k_cell = torch.sum(k_all, dim=-1)
    dtype = k_all.dtype
    two_tier = cfg.cloud_period >= 1
    cells = torch.arange(c_cells, device=k_all.device)
    tcfg = cfg.telemetry
    grad_tel = tcfg is not None and tcfg.gradients

    def step(carry, ctl: RoundControl):
        hist, head, version, now, st = carry[:5]

        # 1. the buffer fills with the K earliest pending arrivals
        sel, t_fill = SCHED.select_arrivals(st.ready, k_buf)
        now2 = t_fill + w.aggregation_latency_s
        coh = torch.zeros(n, dtype=dtype, device=k_all.device).index_fill(
            0, sel, 1.0).reshape(st.ready.shape)

        def gather(a):
            return a.reshape(-1)[sel]

        # 2. staleness-discounted merge weights
        tau = version - gather(st.start_ver)
        ok = gather(st.arrive * st.sched * st.alive)
        w_merge = AGG.buffered_weights(
            k_flat[sel], ok, tau, kind=acfg.staleness_discount,
            alpha=acfg.staleness_alpha, max_staleness=acfg.max_staleness,
            dtype=dtype)

        # 3. gradients at each client's download version, then the step
        params = pruning.tree_map(lambda a: a[head], hist)
        tail = ()
        if two_tier:
            edge, acc_w = carry[5:]
            onehot = (cells[:, None] == (sel // i_per_cell)[None, :]
                      ).to(dtype)                                  # (C, K)
            with torch.profiler.record_function("fleet.gradient"):
                num, losses = _buffer_cell_sums(
                    task, cfg, hist, head, tau, data.take(sel),
                    gather(st.rho), w_merge, onehot)
            den = torch.sum(onehot * w_merge, dim=-1)              # (C,)

            def edge_step(e, g):
                shape = (-1,) + (1,) * (g.ndim - 1)
                d = torch.clamp_min(den, 1e-30).reshape(shape)
                return torch.where((den > 0).reshape(shape),
                                   (e - cfg.lr * g / d).to(e.dtype), e)

            with torch.profiler.record_function("fleet.cloud_merge"):
                edge2 = pruning.tree_map(edge_step, edge, num)
                acc2 = acc_w + den
                cloud = _cloud_view(edge2, acc2, k_cell)
                new_params, eval_params = params, cloud
                if (version + 1) % cfg.cloud_period == 0:
                    edge2 = _broadcast(cloud, edge2)
                    acc2 = torch.zeros_like(acc2)
                    new_params = pruning.tree_map(
                        lambda p, cl: cl.to(p.dtype), params, cloud)
                    now2 = now2 + w.backhaul_s
            tail = (edge2, acc2)
            if grad_tel:   # the buffer's update: every cell's sum, added
                g_wsum = pruning.tree_map(lambda g: torch.sum(g, dim=0), num)
        else:
            with torch.profiler.record_function("fleet.gradient"):
                g_wsum, losses = _buffer_grads(task, cfg, hist, head, tau,
                                               data, sel, gather(st.rho),
                                               w_merge, split)
            with torch.profiler.record_function("fleet.merge"):
                new_params = _sgd(params, g_wsum, torch.sum(w_merge), cfg.lr)
            eval_params = new_params
        version2, head2 = version + 1, (head + 1) % hist_len
        hist2 = pruning.tree_map(
            lambda a, p: torch.cat([a[:head2], p[None], a[head2 + 1:]]),
            hist, new_params)

        # 4. event metrics over the merged cohort (the sync definitions)
        sched_coh = coh * st.sched
        n_sched = torch.clamp_min(torch.sum(sched_coh), 1.0)
        loss_w = gather(st.sched)
        mean_loss = torch.sum(losses * loss_w) / torch.clamp_min(
            torch.sum(loss_w), 1.0)
        q_eff = 1.0 - st.sched * st.alive * (1.0 - st.per)
        fresh = (tau <= acfg.max_staleness).to(dtype)
        learning = torch.sum(torch.where(
            coh > 0,
            st.m_cell[:, None] * k_all * (q_eff + k_all * st.rho) * st.sched,
            0.0))
        metrics = {
            "loss": mean_loss,
            "round_latency": now2 - now,
            "deadline": st.deadline_c,
            "mean_prune": torch.sum(coh * st.rho * st.sched) / n_sched,
            "mean_per": torch.sum(coh * q_eff * st.sched) / n_sched,
            "participants": torch.sum(ok * fresh),
            "bandwidth_util": st.bwutil_c,
            "learning_cost": learning,
            "staleness": torch.mean(tau.to(dtype)),
            "sim_time": now2,
        }
        if tcfg is not None:
            metrics.update(TEL.staleness_summary(tcfg, tau,
                                                 acfg.max_staleness, dtype))
        if grad_tel:
            metrics.update(_grad_telemetry(
                tcfg, _step_sq_norm(g_wsum, torch.sum(w_merge)), st.rho,
                sched_coh))
        with torch.profiler.record_function("fleet.eval"):
            metrics = _with_eval(metrics, task, state, eval_params)

        # 5. the merged clients download version2 and start again; their
        # control draw is the event's control telemetry
        if tcfg is not None:
            metrics.update(TEL.control_summaries(
                tcfg, ctl.sol, ctl.t_client, ctl.sinr_db, w.bandwidth_hz))
        st2 = _start_state(ctl, now2, version2, st, coh, cfg)._replace(
            per_sum=st.per_sum + torch.where(coh > 0, q_eff, 1.0),
            prune_sum=st.prune_sum + torch.where(coh > 0, st.rho * st.sched,
                                                 0.0))
        return (hist2, head2, version2, now2, st2) + tail, metrics

    return step


# ---------------------------------------------------------------------------
# Build / run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Simulation:
    """A built fleet run.  ``step(carry, r)`` runs round (sync) or event
    (async) r; ``simulate(params)`` runs them all from ``params``;
    ``finalize`` turns the output into a ``FleetResult``.  A step is
    ``apply(carry, control(r))``: the control pass depends on the draws
    alone, so it can be timed apart.  ``data`` holds the clients' batches
    (cached or streamed); ``solve_fn`` replaces the control pass's solver
    (``_make_control_fn``); ``mesh`` splits the round over its ranks (see
    the module docstring), each of which builds its own Simulation."""

    cfg: FleetConfig
    task: TASK.FleetTask
    params: PyTree
    task_state: PyTree
    population: TOPO.ClientPopulation
    data: ClientData
    draws: Any
    mode: str = "sync"
    solve_fn: Any = None
    mesh: Any = None

    def __post_init__(self):
        self.two_tier = self.cfg.cloud_period >= 1
        self._control = _make_control_fn(self.cfg, self.population,
                                         solve_fn=self.solve_fn,
                                         mesh=self.mesh)
        args = (self.cfg, self.task, self.task_state, self.population,
                self.data)
        if self.mode == "async":
            self._apply = _make_async_step(*args, mesh=self.mesh)
        elif self.two_tier:
            self._apply = _make_two_tier_round_fn(*args)
        else:
            self._apply = _make_apply_round_fn(*args, mesh=self.mesh)

    def control(self, r: int) -> RoundControl:
        """The control pass step r consumes: draw r in a sync round; in
        async event r, the relaunch's draw r + 1 (draw 0 launched the
        fleet)."""
        k = r + 1 if self.mode == "async" else r
        return self._control(self.draws.round(k, self.population))

    def apply(self, carry, ctl: RoundControl):
        """A step's model half: gradients, the merge, metrics (async: and
        the merged clients' relaunch with ``ctl``)."""
        return self._apply(carry, ctl)

    def init_carry(self, params: PyTree):
        """Sync: (params, q sum, rho sum); two-tier: (every cell's edge
        model, merged weight, q sum, rho sum, rounds done).  Async: the
        ring buffer with ``params`` in slot 0, head, version, time and the
        fleet launched at t = 0 with draw 0, and two-tier the edge models
        and merged weight."""
        pathloss = self.population.pathloss
        c = pathloss.shape[0]
        tiers = ()
        if self.two_tier:
            tiers = (pruning.tree_map(
                lambda p: p[None].expand((c,) + tuple(p.shape)).clone(),
                params), pathloss.new_zeros((c,)))
        if self.mode == "sync":
            zeros = torch.zeros_like(pathloss)
            if self.two_tier:
                return tiers + (zeros, zeros, 0)
            return (params, zeros, zeros)
        hist_len = self.cfg.async_config.history_len
        hist = pruning.tree_map(
            lambda p: torch.cat([p[None], p.new_zeros(
                (hist_len - 1,) + tuple(p.shape))]), params)
        now = pathloss.new_zeros(())
        ctl0 = self._control(self.draws.round(0, self.population))
        return (hist, 0, 0, now, _start_state(ctl0, now, 0, None, None,
                                              self.cfg)) + tiers

    def step(self, carry, r: int):
        return self.apply(carry, self.control(r))

    def simulate(self, params: PyTree):
        carry = self.init_carry(params)
        history = []
        for r in range(self.cfg.rounds):
            carry, metrics = self.step(carry, r)
            history.append(metrics)
        return carry, {k: torch.stack([h[k] for h in history])
                       for k in history[0]}

    def finalize(self, carry, metrics) -> FleetResult:
        """Host-side FleetResult, with the Theorem-1 bound on the realized
        (q, rho) averages and the telemetry (keyed without its prefix, or
        None).  Two-tier ``params`` is the cloud view of the final edge
        models (the last cloud merge where the run ended on one)."""
        cfg = self.cfg

        def host(t):
            return t.detach().cpu().numpy()

        if self.mode == "async":
            hist, head, _, _, st = carry[:5]
            params = pruning.tree_map(lambda a: a[head], hist)
            per_sum, prune_sum = st.per_sum, st.prune_sum
            tiers = carry[5:]
        elif self.two_tier:
            *tiers, per_sum, prune_sum, _ = carry
        else:
            params, per_sum, prune_sum = carry
        if self.two_tier:
            edge, acc_w = tiers
            params = _edge_mean(pruning.tree_map(host, edge), host(acc_w),
                                host(self.population.num_samples))
        else:
            params = pruning.tree_map(host, params)
        out, tel = TEL.split_metrics({k: host(v) for k, v in metrics.items()})
        avg_per = host(per_sum).reshape(-1) / cfg.rounds
        avg_prune = host(prune_sum).reshape(-1) / cfg.rounds
        bound = ConvergenceBound(
            cfg.smoothness, host(self.population.num_samples).reshape(-1))
        latencies = out["round_latency"]
        return FleetResult(
            losses=out["loss"],
            accuracy=out["accuracy"],
            latencies=latencies,
            deadlines=out["deadline"],
            mean_prune=out["mean_prune"],
            mean_per=out["mean_per"],
            participants=out["participants"],
            bandwidth_util=out["bandwidth_util"],
            learning_cost=out["learning_cost"],
            bound_final=float(bound.bound(cfg.rounds, avg_per, avg_prune)),
            params=params,
            wall_clock=out.get("sim_time", np.cumsum(latencies)),
            staleness=out.get("staleness", np.zeros_like(latencies)),
            mode=self.mode,
            telemetry=tel,
        )


def _data_span(cfg: FleetConfig, mode: str, split: Optional[Split]
               ) -> Optional[tuple[int, int]]:
    """The clients a rank's cache must hold: on a sync single-tier run the
    cells its ``_block`` of the flat clients (or cohort) reaches; else
    all (None): an async buffer or a two-tier round reaches any client."""
    if split is None or mode != "sync" or cfg.cloud_period >= 1:
        return None
    c, i = cfg.topology.shape
    m = SCHED.cohort_size(cfg.schedule, i) if _cohort_enabled(cfg) else i
    lo, hi = _block(c * m, split)
    return lo // m * i, -(-hi // m) * i


_TWO_TIER_MESH_WARNING = (
    "two-tier aggregation (cloud_period >= 1) runs the gradient "
    "pass as a per-cell scan and does not shard client work over "
    "the mesh; the mesh placement of population tensors still "
    "applies but per-round compute stays serial over cells.")


def build_simulation(cfg: FleetConfig, mode: str = "sync", *,
                     mesh=None, device=None,
                     dtype: torch.dtype = torch.float32,
                     draws=None, start: Optional[SimStart] = None
                     ) -> Simulation:
    """Drop the fleet, build the data and model, and return a Simulation.

    Args:
      cfg: the run configuration.
      mode: ``"sync"`` (FedSGD rounds) or ``"async"`` (FedBuff events).
      mesh: optional ``DeviceMesh`` (``launch.mesh``; every rank of it
        calls this with the same arguments): the cells split over its
        "cells" dim (else "data") and the clients over all its ranks (see
        the module docstring); two-tier runs whole on every rank and
        warns, as the reference does.
      device: where everything runs; ``None`` means ``"cuda"`` (on a
        mesh, this rank's card: ``launch.mesh.local_device``).
      dtype: the float dtype of the run (the reference's x64 flag).
      draws: the draw source (default ``GeneratorDraws(cfg.seed, device)``,
        with Gumbel draws when the schedule is partial and the hex draws
        under ``HexInterference``).  Injected draws must carry ``gumbel``
        under a partial schedule, a hex geometry's fields
        (``InjectedDraws.check_geometry``), and one draw more than
        ``cfg.rounds`` in async mode.
      start: optional ``SimStart`` (initial params, task state and cached
        client batches, which the run then uses whatever ``cache_data``
        says, or None); by default they come from the task, with
        generators and a data seed derived from ``cfg.seed``.

    Injected population, round draws and start tensors must lie on the
    run's device; anything else raises ``ValueError``.
    """
    _check_supported(cfg, mode)
    dev = resolve_device(device) if mesh is None else local_device(device)
    if mesh is not None and cfg.cloud_period >= 1:
        warnings.warn(_TWO_TIER_MESH_WARNING, stacklevel=2)
    task = resolve_task(cfg).client_task()
    geo = resolve_geometry(cfg)
    topo = cfg.topology
    partial = SCHED.draws_participation(cfg.schedule, topo.clients_per_cell)
    if draws is None:
        draws = GeneratorDraws(cfg.seed, dev, participation=partial,
                               geometry=geo)
    pop = draws.population(topo, cfg.wireless.tx_power_ue_w, dtype)
    _check_on_device("the population's tensors", pop, dev)
    if isinstance(draws, InjectedDraws):
        _check_on_device("the injected round draws", tuple(draws._rounds),
                         dev)
        if partial:
            draws.check_participation()
        draws.check_geometry(geo, pop)

    batches = None
    if start is None:
        seeds = GeneratorDraws(cfg.seed, dev)
        state = task.build(seeds.generator("task"), dtype, dev,
                           num_clients=topo.num_clients)
        params = task.init_params(seeds.generator("init"), dtype, dev)
    else:
        _check_on_device("the start's params, task state and batches",
                         tuple(start), dev)
        params, state, batches = start
    # the wireless model prices the task's real model where it knows it
    bits = task.model_bits(params)
    if bits is not None:
        cfg = dataclasses.replace(
            cfg, wireless=cfg.wireless.replace(model_bits=float(bits)))
    seed = _seed(cfg.seed, "data")
    if batches is None:
        data = ClientData.draw(task, state, seed, topo.num_clients, dev,
                               cache=_cache_data(cfg, task, state, seed,
                                                 dev),
                               span=_data_span(cfg, mode,
                                               _world_split(mesh)))
    else:
        data = ClientData(task, state, seed, dev, cached=batches)
    return Simulation(cfg=cfg, task=task, params=params, task_state=state,
                      population=pop, data=data, draws=draws, mode=mode,
                      mesh=mesh)


def run_fleet(cfg: FleetConfig, mode: str = "sync", progress: bool = False,
              *, mesh=None, device=None, dtype: torch.dtype = torch.float32,
              draws=None, start: Optional[SimStart] = None,
              sink: Optional[TEL.TelemetrySink] = None,
              recorder: Optional[TEL.SpanRecorder] = None) -> FleetResult:
    """Simulate ``cfg.rounds`` sync rounds or async events (see
    ``build_simulation`` for the arguments) and return a ``FleetResult``.

    ``sink`` (a ``telemetry.TelemetrySink``) receives the run's header and
    per-round records after the run (it is not closed); ``recorder`` (a
    ``telemetry.SpanRecorder``) records the ``fleet.build``,
    ``fleet.simulate`` (to the device's last op) and ``fleet.finalize``
    spans.  On a ``mesh`` every rank returns the same result, and only
    rank 0 of the default group records spans, emits records and prints
    the ``progress`` lines."""
    lead = mesh is None or dist.get_rank() == 0
    rec = recorder if recorder is not None and lead else TEL.SpanRecorder()
    with rec.span("fleet.build", mode=mode,
                  clients=cfg.topology.num_clients):
        sim = build_simulation(cfg, mode, mesh=mesh, device=device,
                               dtype=dtype, draws=draws, start=start)
    with rec.span("fleet.simulate", rounds=cfg.rounds):
        out = sim.simulate(sim.params)
        if sim.population.pathloss.is_cuda:
            torch.cuda.synchronize(sim.population.pathloss.device)
    with rec.span("fleet.finalize"):
        result = sim.finalize(*out)
    if sink is not None and lead:
        TEL.emit_result(result, sink, meta={
            "clients": cfg.topology.num_clients, "kernel": cfg.kernel,
            "cloud_period": cfg.cloud_period})
    if progress and lead:
        shown = sorted(set(range(0, cfg.rounds, max(cfg.rounds // 10, 1)))
                       | {cfg.rounds - 1})
        for rnd in shown:
            print(f"[fleet] round {rnd:4d} loss={result.losses[rnd]:.4f} "
                  f"acc={result.accuracy[rnd]:.4f}")
    return result


# ``run(cfg, mode="async")`` reads naturally where the mode is data; it is
# the same function.
run = run_fleet


def time_to_loss(result: FleetResult, target: float) -> float:
    """Simulated seconds until the training loss first reaches ``target``
    (on ``result.wall_clock``, so sync and async compare on one axis);
    ``inf`` if it never does."""
    hit = np.flatnonzero(np.asarray(result.losses) <= target)
    if hit.size == 0:
        return float("inf")
    return float(result.wall_clock[hit[0]])
