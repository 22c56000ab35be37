"""Synchronous fleet rounds: channel -> solver -> pruned FedSGD -> Eq. (5).

The port of ``repro.fleet.engine``'s single-tier synchronous path with the
fused kernel.  One round realizes the channel, schedules every client,
runs Algorithm 1 for all cells (``fleet/solver.py``), draws stragglers and
packet arrivals, ranks every layer's tiles once (``block_norms`` kernel),
streams the fleet through the fused pruned-gradient kernel, applies the
Eq.-(5)-weighted SGD step and evaluates.  The reference's round ``scan``
is a Python loop here (``Simulation.step``); the fleet's cached client
data and every round tensor stay on the device.

Randomness comes from a draw source: ``GeneratorDraws`` (the default,
``torch.Generator``s on the device seeded from ``cfg.seed``) or
``InjectedDraws`` (arrays supplied by the caller, e.g. the reference's own
draws in the parity tests).  The model and data side can likewise be
supplied as a ``SimStart``.

Precision: ``dtype`` (default float32) plays the part of the reference's
global x64 flag.  On the card the kernels take float32 only, and
``device.resolve_device`` turns TF32 off for matrix products and cuDNN so
float32 means float32.

What this slice does not carry raises ``NotImplementedError`` naming the
ROADMAP.md item that ports it: ``kernel="reference"`` (still the default,
for field parity with the reference), async mode, two-tier
``cloud_period``, partial participation / cohort gather,
``control_chunk``, ``HexInterference``, telemetry, Dirichlet data and the
streaming (uncached) data path.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import closed_form as CF
from repro_torch.core import wireless
from repro_torch.core.convergence import ConvergenceBound, SmoothnessParams
from repro_torch.device import resolve_device
from repro_torch.fleet import scheduler as SCHED
from repro_torch.fleet import solver as SOLVER
from repro_torch.fleet import task as TASK
from repro_torch.fleet import topology as TOPO

PyTree = Any

__all__ = ["FleetConfig", "FleetResult", "RoundControl", "RoundDraws",
           "GeneratorDraws", "InjectedDraws", "SimStart", "Simulation",
           "build_simulation", "run_fleet", "resolve_task"]

_ROADMAP_REST = "see ROADMAP.md Queue A, item 6 (the rest of the engine)"


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Everything a fleet run needs; the reference's field names and
    defaults (units follow ``WirelessConfig``; ``weight`` is lambda)."""

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
    telemetry: Optional[Any] = None


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


def _check_supported(cfg: FleetConfig, mode: str) -> None:
    """Raise for every configuration this slice does not port."""
    if mode not in ("sync", "async"):
        raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
    if cfg.kernel not in ("reference", "fused", "fused_xla", "fused_pallas"):
        raise ValueError(
            "kernel must be 'reference', 'fused', 'fused_xla' or "
            f"'fused_pallas', got {cfg.kernel!r}")
    if cfg.mask_kind not in ("magnitude", "block"):
        raise ValueError(
            f"mask_kind must be 'magnitude' or 'block', got {cfg.mask_kind!r}")
    unsupported = []
    if cfg.kernel != "fused":
        unsupported.append(f"kernel={cfg.kernel!r} (6a; only 'fused' is "
                           "ported)")
    if cfg.cohort_gather or not cfg.schedule.is_full:
        unsupported.append("partial participation / cohort gather (6b)")
    if cfg.control_chunk:
        unsupported.append("control_chunk (6b)")
    if cfg.cache_data is False:
        unsupported.append("cache_data=False, streaming client data (6c)")
    if cfg.geometry is not None and not isinstance(cfg.geometry,
                                                   TOPO.OrthogonalCells):
        unsupported.append(f"geometry {type(cfg.geometry).__name__} (6d)")
    if mode == "async":
        unsupported.append("mode='async' (6e)")
    if cfg.cloud_period:
        unsupported.append("cloud_period, two-tier aggregation (6f)")
    if cfg.telemetry is not None:
        unsupported.append("telemetry (6g)")
    if unsupported:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(unsupported) + f" — {_ROADMAP_REST}")


@dataclasses.dataclass
class FleetResult:
    """Per-round trajectories (host numpy), as in the reference."""

    losses: np.ndarray            # (rounds,)
    accuracy: np.ndarray          # (rounds,)
    latencies: np.ndarray         # (rounds,) realized round latency, s
    deadlines: np.ndarray         # (rounds, C) solver deadlines t~*, s
    mean_prune: np.ndarray        # (rounds,)
    mean_per: np.ndarray          # (rounds,)
    participants: np.ndarray      # (rounds,)
    bandwidth_util: np.ndarray    # (rounds, C)
    learning_cost: np.ndarray     # (rounds,)
    bound_final: float            # Theorem 1 on realized averages
    params: PyTree                # numpy arrays in the params layout
    wall_clock: np.ndarray = None
    staleness: np.ndarray = None
    mode: str = "sync"
    telemetry: Optional[dict] = None


class RoundControl(NamedTuple):
    """One round's system state: schedule, channel, solver, latencies."""

    mask: torch.Tensor       # (C, I) participation
    strag: torch.Tensor      # (C, I) survived straggler churn
    arrivals: torch.Tensor   # (C, I) packet success indicators
    sol: SOLVER.CellSolution
    t_client: torch.Tensor   # (C, I) downlink + compute + uplink, s
    m_round: torch.Tensor    # (C,) scheduled-subset Eq.-(11) coefficient


# ---------------------------------------------------------------------------
# Draw sources
# ---------------------------------------------------------------------------

class RoundDraws(NamedTuple):
    """One round's random inputs, all (C, I)."""

    h_up: torch.Tensor      # uplink power gain (path loss x Rayleigh)
    h_down: torch.Tensor    # downlink power gain
    u_strag: torch.Tensor   # U[0, 1): straggler survival is u < 1 - p
    u_arr: torch.Tensor     # U[0, 1): packet arrives when u >= PER


def _seed(seed: int, stream: str, index: int = 0) -> int:
    h = hashlib.sha256(f"{seed}/{stream}/{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


class GeneratorDraws:
    """The default draw source: ``torch.Generator``s on ``device``, one per
    purpose, seeded from ``seed``.  Round r's draws depend only on (seed,
    r), so a simulation can be run again and repeats exactly."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)

    def generator(self, stream: str, index: int = 0) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_seed(self.seed, stream, index))
        return g

    def population(self, topo: TOPO.FleetTopology, tx_power_w: float,
                   dtype: torch.dtype) -> TOPO.ClientPopulation:
        g = self.generator("population")
        kw = dict(generator=g, dtype=dtype, device=self.device)
        u_dist = torch.rand(topo.shape, **kw)
        u_cpu = torch.rand(topo.shape, **kw)
        lo, hi = topo.samples_range
        samples = torch.randint(lo, hi + 1, topo.shape, generator=g,
                                device=self.device)
        return TOPO.make_population(topo, tx_power_w, u_dist, u_cpu, samples)

    def round(self, r: int, pop: TOPO.ClientPopulation) -> RoundDraws:
        g = self.generator("round", r)
        shape, dtype = pop.pathloss.shape, pop.pathloss.dtype
        kw = dict(generator=g, dtype=dtype, device=self.device)
        ray_u = torch.empty(shape, dtype=dtype, device=self.device
                            ).exponential_(generator=g)
        ray_d = torch.empty(shape, dtype=dtype, device=self.device
                            ).exponential_(generator=g)
        h_up, h_down = TOPO.sample_fading(pop.pathloss, ray_u, ray_d)
        return RoundDraws(h_up=h_up, h_down=h_down,
                          u_strag=torch.rand(shape, **kw),
                          u_arr=torch.rand(shape, **kw))


class InjectedDraws:
    """A draw source of given tensors: the population and one
    ``RoundDraws`` per round (see ``repro_torch.weights`` for converters
    from numpy)."""

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
            raise IndexError(f"no injected draws for round {r}")
        return self._rounds[r]


class SimStart(NamedTuple):
    """The model and data side of a run, when the caller supplies it:
    initial params, the task state and every client's cached batch."""

    params: PyTree
    task_state: PyTree
    batches: PyTree


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
# The round
# ---------------------------------------------------------------------------

_CACHE_LIMIT_BYTES = 512 << 20


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_tree_add(x, y) for x, y in zip(a, b))
    return a + b


def _chunk_accumulate(step, arrays: tuple, chunk: int):
    """Sum ``step(*slice)`` over consecutive ``chunk``-sized axis-0 slices
    of ``arrays``, in order; a ragged remainder is one exact-sized last
    slice (no padded rows)."""
    out = None
    for j in range(0, arrays[0].shape[0], chunk):
        part = step(*(a[j:j + chunk] for a in arrays))
        out = part if out is None else _tree_add(out, part)
    return out


def _fleet_grads(task: TASK.FleetTask, params: PyTree, rho: torch.Tensor,
                 agg_w: torch.Tensor, sched_w: torch.Tensor,
                 cfg: FleetConfig, data: PyTree):
    """Weighted-sum gradients over the fleet through the fused kernel,
    cell-chunked.  Returns (grad_wsum, sum agg_w, mean scheduled loss)."""
    c, i = rho.shape
    chunk = cfg.cell_chunk if 0 < cfg.cell_chunk < c else c
    xs = data["x"].reshape((c, i) + data["x"].shape[1:])
    ys = data["y"].reshape((c, i) + data["y"].shape[1:])
    # once per round: every layer's tile ranking; per-client keeps are one
    # searchsorted each inside kernel_grads
    prep = task.kernel_prepare(params)

    def step(c_rho, c_w, c_lw, c_x, c_y):
        batch = {"x": c_x.reshape((-1,) + c_x.shape[2:]),
                 "y": c_y.reshape((-1,) + c_y.shape[2:])}
        w_flat = c_w.reshape(-1)
        g, losses = task.kernel_grads(params, prep, batch, c_rho.reshape(-1),
                                      w_flat)
        lw_flat = c_lw.reshape(-1)
        return (g, torch.sum(w_flat), torch.sum(losses * lw_flat),
                torch.sum(lw_flat))

    g_wsum, w_sum, loss_sum, loss_w = _chunk_accumulate(
        step, (rho, agg_w, sched_w, xs, ys), chunk)
    return g_wsum, w_sum, loss_sum / torch.clamp_min(loss_w, 1.0)


def _make_control_fn(cfg: FleetConfig, pop: TOPO.ClientPopulation):
    """The round's control pass: channel -> schedule -> Algorithm 1 ->
    realized latencies -> straggler and packet draws."""
    w = cfg.wireless
    n0, b_hz = w.noise_psd_w_per_hz, w.bandwidth_hz
    geo = cfg.geometry if cfg.geometry is not None else TOPO.OrthogonalCells()
    sched = cfg.schedule
    sm = cfg.smoothness

    def control(draws: RoundDraws) -> RoundControl:
        chan = geo.round_channel(draws.h_up, draws.h_down)
        h_up, h_down = chan.h_up, chan.h_down
        mask = SCHED.participation_mask(sched, tuple(h_up.shape), h_up.dtype,
                                        h_up.device)
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

        sol = SOLVER.solve_fleet(
            h_up, pop.num_samples, pop.cpu_hz, pop.tx_power, pop.max_prune,
            m_round, mask, cap, bandwidth_hz=b_hz, noise_psd=n0,
            waterfall_m0=w.waterfall_m0, model_bits=w.model_bits,
            cycles_per_sample=w.cycles_per_sample, weight=cfg.weight,
            solver=cfg.solver)

        t_c = CF.training_latency(sol.prune, pop.num_samples,
                                  w.cycles_per_sample, pop.cpu_hz)
        r_u = CF.uplink_rate(sol.bandwidth, pop.tx_power, h_up, n0)
        t_u = CF.upload_latency(sol.prune, w.model_bits, r_u)
        t_client = t_d + t_c + t_u

        strag = SCHED.straggler_mask(sched, draws.u_strag)
        arrivals = (draws.u_arr >= sol.per).to(h_up.dtype)
        return RoundControl(mask=mask, strag=strag, arrivals=arrivals,
                            sol=sol, t_client=t_client, m_round=m_round)

    return control


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
    """The round's metric dict (minus task eval) and the effective PER."""
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
    return metrics, q_eff


def _make_apply_round_fn(cfg: FleetConfig, task: TASK.FleetTask,
                         state: PyTree, pop: TOPO.ClientPopulation,
                         data: PyTree):
    """The model half of a sync round: consume a RoundControl and return
    the FedSGD update, the Theorem-1 accumulators and the metrics."""

    def apply_round(carry, ctl: RoundControl):
        params, per_sum, prune_sum = carry
        mask, sol = ctl.mask, ctl.sol
        active, arrivals, agg_w = _round_activity(cfg, pop, ctl)
        g_wsum, w_sum, mean_loss = _fleet_grads(task, params, sol.prune,
                                                agg_w, mask, cfg, data)
        denom = torch.where(w_sum > 0, w_sum, 1.0)

        def sgd(p, g):
            return torch.where(w_sum > 0, (p - cfg.lr * g / denom).to(p.dtype),
                               p)

        new_params = {name: {leaf: sgd(p, g_wsum[name][leaf])
                             for leaf, p in layer.items()}
                      for name, layer in params.items()}
        metrics, q_eff = _round_metrics(cfg, pop, ctl, active, arrivals,
                                        mean_loss)
        ev = dict(task.eval_metrics(state, new_params))
        metrics["accuracy"] = ev.pop("accuracy")
        metrics.update({f"eval_{k}": v for k, v in ev.items()})
        return (new_params, per_sum + q_eff, prune_sum + sol.prune * mask), \
            metrics

    return apply_round


# ---------------------------------------------------------------------------
# Build / run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Simulation:
    """A built fleet run.  ``step(carry, r)`` runs round r;
    ``simulate(params)`` runs every round from ``params``; ``finalize``
    turns the output into a ``FleetResult``."""

    cfg: FleetConfig
    task: TASK.FleetTask
    params: PyTree
    task_state: PyTree
    population: TOPO.ClientPopulation
    data: PyTree
    draws: Any

    def __post_init__(self):
        self._control = _make_control_fn(self.cfg, self.population)
        self._apply = _make_apply_round_fn(self.cfg, self.task,
                                           self.task_state, self.population,
                                           self.data)

    def control(self, r: int) -> RoundControl:
        """Round r's control half: channel, schedule, solver, draws."""
        return self._control(self.draws.round(r, self.population))

    def apply(self, carry, ctl: RoundControl):
        """A round's model half: gradients, Eq.-(5) step, metrics."""
        return self._apply(carry, ctl)

    def init_carry(self, params: PyTree):
        zeros = torch.zeros_like(self.population.pathloss)
        return (params, zeros, zeros)

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
        (q, rho) averages."""
        cfg = self.cfg
        params, per_sum, prune_sum = carry
        host = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
        avg_per = per_sum.detach().cpu().numpy().reshape(-1) / cfg.rounds
        avg_prune = prune_sum.detach().cpu().numpy().reshape(-1) / cfg.rounds
        bound = ConvergenceBound(
            cfg.smoothness,
            self.population.num_samples.detach().cpu().numpy().reshape(-1))
        latencies = host["round_latency"]
        return FleetResult(
            losses=host["loss"],
            accuracy=host["accuracy"],
            latencies=latencies,
            deadlines=host["deadline"],
            mean_prune=host["mean_prune"],
            mean_per=host["mean_per"],
            participants=host["participants"],
            bandwidth_util=host["bandwidth_util"],
            learning_cost=host["learning_cost"],
            bound_final=float(bound.bound(cfg.rounds, avg_per, avg_prune)),
            params={name: {k: v.detach().cpu().numpy()
                           for k, v in layer.items()}
                    for name, layer in params.items()},
            wall_clock=np.cumsum(latencies),
            staleness=np.zeros_like(latencies),
        )


def _batch_bytes(task: TASK.FleetTask, num_clients: int,
                 dtype: torch.dtype) -> int:
    x = num_clients * task.local_batch * task.feature_dim
    return x * torch.finfo(dtype).bits // 8 + num_clients * task.local_batch * 8


def build_simulation(cfg: FleetConfig, mode: str = "sync", *,
                     device=None, dtype: torch.dtype = torch.float32,
                     draws=None, start: Optional[SimStart] = None
                     ) -> Simulation:
    """Drop the fleet, build the data and model, and return a Simulation.

    Args:
      cfg: the run configuration.
      mode: ``"sync"`` (async is not ported yet and raises).
      device: where everything runs; ``None`` means ``"cuda"``.
      dtype: the float dtype of the run (the reference's x64 flag).
      draws: the draw source (default ``GeneratorDraws(cfg.seed, device)``).
      start: optional ``SimStart`` (initial params, task state, cached
        client batches); by default they are drawn from the task with
        generators seeded from ``cfg.seed``.

    Injected population, round draws and start tensors must lie on the
    run's device; anything else raises ``ValueError``.
    """
    _check_supported(cfg, mode)
    dev = resolve_device(device)
    task = resolve_task(cfg)
    topo = cfg.topology
    if draws is None:
        draws = GeneratorDraws(cfg.seed, dev)
    pop = draws.population(topo, cfg.wireless.tx_power_ue_w, dtype)
    _check_on_device("the population's tensors", pop, dev)
    if isinstance(draws, InjectedDraws):
        _check_on_device("the injected round draws", tuple(draws._rounds),
                         dev)

    if start is None:
        seeds = GeneratorDraws(cfg.seed, dev)
        state = task.build(seeds.generator("task"), dtype, dev)
        params = task.init_params(seeds.generator("init"), dtype, dev)
        if cfg.cache_data is None and _batch_bytes(
                task, topo.num_clients, dtype) > _CACHE_LIMIT_BYTES:
            raise NotImplementedError(
                "client data above the 512 MB cache limit needs the streaming "
                f"data path (6c) — {_ROADMAP_REST}")
        data = task.client_batch(state, seeds.generator("data"),
                                 topo.num_clients)
    else:
        _check_on_device("the start's params, task state and batches",
                         tuple(start), dev)
        params, state, data = start
    return Simulation(cfg=cfg, task=task, params=params, task_state=state,
                      population=pop, data=data, draws=draws)


def run_fleet(cfg: FleetConfig, mode: str = "sync", progress: bool = False,
              *, device=None, dtype: torch.dtype = torch.float32,
              draws=None, start: Optional[SimStart] = None) -> FleetResult:
    """Simulate ``cfg.rounds`` synchronous fleet rounds (see
    ``build_simulation`` for the arguments) and return a ``FleetResult``."""
    sim = build_simulation(cfg, mode, device=device, dtype=dtype,
                           draws=draws, start=start)
    result = sim.finalize(*sim.simulate(sim.params))
    if progress:
        shown = sorted(set(range(0, cfg.rounds, max(cfg.rounds // 10, 1)))
                       | {cfg.rounds - 1})
        for rnd in shown:
            print(f"[fleet] round {rnd:4d} loss={result.losses[rnd]:.4f} "
                  f"acc={result.accuracy[rnd]:.4f}")
    return result
