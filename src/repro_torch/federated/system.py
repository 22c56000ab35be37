"""End-to-end wireless pruned-FL simulation (paper §V).

The port of ``repro.federated.system``.  Two 5-UE-scale paths:

* ``run`` — the §V reproduction: the seeded numpy ``wireless.Channel``,
  the host trade-off solver of any scheme (``SCHEMES``: Algorithm 1, GBA,
  FPR, exhaustive search, ideal FL), the synthetic dataset's partitions,
  then one round of masked local FedSGD, packet-error-aware Eq.-(5)
  aggregation and SGD on the device (``_round_update``).
* ``run_fleet_reference`` — the fleet engine stepped on the host with the
  paper's numpy solver (``core.tradeoff.solve_alternating``, per cell,
  with the same interference fixed point) in place of the batched one:
  the engine's own control pass (``_make_control_fn(solve_fn=...)``) and
  update half, so every draw and latency term is the fleet path's.

``run_any`` dispatches between them and ``fleet.run_fleet``.  The
trade-off solves are host float64 code by design; the model side runs on
the card unless the caller passes ``device="cpu"``.  ``run`` draws its
initial params and its per-round packet uniforms from ``torch.Generator``s
seeded by ``cfg.seed``, or takes them from a ``RunStart``
(``weights.run_start_from_numpy``), which is how the reference's draws
are carried across.
"""

from __future__ import annotations

import dataclasses
import warnings
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import aggregation as AGG
from repro_torch.core import pruning, tradeoff, wireless
from repro_torch.core.convergence import (ConvergenceBound, RoundTracker,
                                          SmoothnessParams)
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.fleet import engine as FE
from repro_torch.fleet import solver as FSOLVER
from repro_torch.fleet import telemetry as TEL
from repro_torch.fleet import topology as TOPO
from repro_torch.kernels import fleet_fused as FUSED
from repro_torch.models import mlp

__all__ = ["SCHEMES", "FLConfig", "FLResult", "RunStart", "run",
           "to_fleet_config", "run_fleet_reference", "run_any"]

PyTree = Any

SCHEMES = ("proposed", "gba", "fpr", "exhaustive", "ideal")
STRUCTURED_BLOCK = 16    # tile edge of run(structured=True)'s masks


@dataclasses.dataclass
class FLConfig:
    num_clients: int = 5
    samples: tuple[int, ...] = (30, 40, 50, 30, 40)      # K_i (Table I)
    hidden: tuple[int, ...] = mlp.SHALLOW_HIDDEN
    lr: float = 1e-3
    rounds: int = 200
    scheme: str = "proposed"          # proposed | gba | fpr:<rate> | ...
    weight: float = 0.0004            # lambda
    seed: int = 0
    structured: bool = False          # block-tile vs unstructured pruning
    eval_every: int = 10
    non_iid_alpha: Optional[float] = None
    cpu_hz: float = 5e9
    max_prune: float = 0.7
    wireless: wireless.WirelessConfig = dataclasses.field(
        default_factory=wireless.WirelessConfig)
    smoothness: SmoothnessParams = dataclasses.field(
        default_factory=SmoothnessParams)
    # a FleetTask routes run_any's "proposed" dispatch through the fleet
    # engine's task on both sides of the threshold (run ignores it)
    task: Optional[Any] = None


@dataclasses.dataclass
class FLResult:
    accuracy: list          # [(round, acc)]
    losses: list            # per-round mean local loss
    latencies: list         # per-round FL latency t (Eq. 4)
    total_costs: list       # per-round (12a) cost
    prune_rates: np.ndarray  # (rounds, I)
    per_rates: np.ndarray    # (rounds, I)
    bound_final: float       # Theorem 1 evaluated on realized averages
    params: dict


class RunStart(NamedTuple):
    """What ``run`` draws, supplied by the caller: the MLP's initial
    params and each round's packet uniforms, (rounds, num_clients)."""

    params: PyTree
    uniforms: torch.Tensor


def _solver(scheme: str) -> Callable[[tradeoff.TradeoffProblem],
                                     tradeoff.TradeoffSolution]:
    if scheme == "proposed":
        return tradeoff.solve_alternating
    if scheme == "gba":
        return tradeoff.solve_gba
    if scheme == "exhaustive":
        return tradeoff.solve_exhaustive
    if scheme == "ideal":
        return tradeoff.solve_ideal
    if scheme.startswith("fpr"):
        rate = float(scheme.split(":")[1]) if ":" in scheme else 0.0
        return partial(tradeoff.solve_fpr, prune_rate=rate)
    raise ValueError(f"unknown scheme {scheme!r}")


def _pad_client_batches(data: synthetic.SyntheticImageData, parts, dim: int,
                        dtype: torch.dtype, device):
    """Every client's samples, zero-padded to the largest K_i: x (I, K,
    dim) and the sample weights w (I, K) in ``dtype``, labels y (I, K)
    int64."""
    kmax = max(len(p) for p in parts)
    x = np.zeros((len(parts), kmax, dim), np.float32)
    y = np.zeros((len(parts), kmax), np.int64)
    w = np.zeros((len(parts), kmax), np.float32)
    for i, idx in enumerate(parts):
        x[i, :len(idx)] = data.x_train[idx]
        y[i, :len(idx)] = data.y_train[idx]
        w[i, :len(idx)] = 1.0
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(y).to(device),
            torch.from_numpy(w).to(device, dtype))


def _weighted_nll(params: dict, batch: dict) -> torch.Tensor:
    """One client's mean cross-entropy over its real (weight-1) samples."""
    logp = torch.log_softmax(mlp.mlp_logits(params, batch["x"]), dim=-1)
    nll = -torch.gather(logp, -1, batch["y"][:, None])[:, 0]
    return torch.sum(nll * batch["w"]) / torch.clamp_min(
        torch.sum(batch["w"]), 1.0)


def _round_update(params: dict, rho: torch.Tensor, per: torch.Tensor,
                  u: torch.Tensor, x, y, w, k: torch.Tensor, lr: float,
                  structured: bool = False):
    """One FL round: masks for every client's rate (one block-tile ranking
    at block 16, one tile-norm launch on the card, when ``structured``;
    magnitude masks otherwise) -> per-client masked gradients
    (``torch.func.vmap``) -> packet arrivals from the uniforms ``u`` ->
    Eq. (5) -> SGD.  Returns (new params, mean local loss, arrivals)."""
    masks = (pruning.block_masks(params, rho, block=STRUCTURED_BLOCK)
             if structured else pruning.magnitude_masks(params, rho))
    losses, grads = FUSED.masked_client_grads(_weighted_nll, params, masks,
                                              {"x": x, "y": y, "w": w})
    arrivals = AGG.sample_arrivals(u, per)
    g = AGG.aggregate(grads, k, arrivals)
    new_params = pruning.tree_map(lambda p, gg: p - lr * gg, params, g)
    return new_params, torch.mean(losses), arrivals


def run(cfg: FLConfig, progress: bool = False, *, device=None,
        dtype: torch.dtype = torch.float32,
        start: Optional[RunStart] = None) -> FLResult:
    """The paper's §V experiment: ``cfg.rounds`` rounds of the 5-UE
    system under ``cfg.scheme``.

    Each round draws the channel (numpy), solves the scheme's trade-off on
    the host, and runs ``_round_update`` on ``device`` (None: the card) in
    ``dtype``.  ``start`` (a ``RunStart`` on the run's device) replaces
    the params and packet uniforms the run would draw; anything off the
    device raises ``ValueError``.
    """
    dev = resolve_device(device)
    data = synthetic.make_dataset(seed=cfg.seed)
    if cfg.non_iid_alpha is not None:
        parts = synthetic.partition_dirichlet(list(cfg.samples), data,
                                              alpha=cfg.non_iid_alpha,
                                              seed=cfg.seed)
    else:
        parts = synthetic.partition_iid(list(cfg.samples), data,
                                        seed=cfg.seed)
    x, y, w = _pad_client_batches(data, parts, data.dim, dtype, dev)
    k = torch.tensor(cfg.samples, dtype=torch.float32, device=dev)

    seeds = FE.GeneratorDraws(cfg.seed, dev)
    if start is None:
        params = mlp.init_mlp_classifier(
            seeds.generator("init"), data.dim, cfg.hidden, data.num_classes,
            dtype=dtype, device=dev)
        uniforms = None
    else:
        FE._check_on_device("the start's params and uniforms", tuple(start),
                            dev)
        params, uniforms = start
        if tuple(uniforms.shape) != (cfg.rounds, cfg.num_clients):
            raise ValueError(f"the start's uniforms are "
                             f"{tuple(uniforms.shape)}, the run needs "
                             f"{(cfg.rounds, cfg.num_clients)}")
    channel = wireless.Channel(cfg.num_clients, seed=cfg.seed)
    bound = ConvergenceBound(cfg.smoothness, np.asarray(cfg.samples))
    solver = _solver(cfg.scheme)
    tracker = RoundTracker(cfg.num_clients)

    x_test = torch.from_numpy(data.x_test).to(dev, dtype)
    y_test = torch.from_numpy(data.y_test).to(dev)

    result = FLResult([], [], [], [], None, None, 0.0, None)
    prune_hist, per_hist = [], []

    for rnd in range(cfg.rounds):
        h_up, h_down = channel.sample_gains()
        prob = tradeoff.TradeoffProblem(
            cfg=cfg.wireless, bound=bound, h_up=h_up, h_down=h_down,
            tx_power=np.full(cfg.num_clients, cfg.wireless.tx_power_ue_w),
            cpu_hz=np.full(cfg.num_clients, cfg.cpu_hz),
            num_samples=np.asarray(cfg.samples, np.float64),
            max_prune=np.full(cfg.num_clients, cfg.max_prune),
            weight=cfg.weight, num_rounds=cfg.rounds)
        sol = solver(prob)
        per = np.zeros(cfg.num_clients) if cfg.scheme == "ideal" else sol.per

        u = (uniforms[rnd] if uniforms is not None else torch.rand(
            cfg.num_clients, generator=seeds.generator("arrivals", rnd),
            dtype=dtype, device=dev))
        params, loss, _ = _round_update(
            params, torch.as_tensor(sol.prune, dtype=dtype, device=dev),
            torch.as_tensor(per, dtype=dtype, device=dev), u, x, y, w, k,
            cfg.lr, structured=cfg.structured)

        tracker.record(per, sol.prune)
        prune_hist.append(sol.prune)
        per_hist.append(per)
        result.losses.append(float(loss))
        result.latencies.append(wireless.round_latency(
            cfg.wireless, h_down, sol.prune, sol.bandwidth,
            prob.tx_power, h_up, prob.num_samples, prob.cpu_hz))
        result.total_costs.append(sol.total_cost)

        if rnd % cfg.eval_every == 0 or rnd == cfg.rounds - 1:
            acc = float(mlp.accuracy(params, x_test, y_test))
            result.accuracy.append((rnd, acc))
            if progress:
                print(f"[{cfg.scheme}] round {rnd:4d} loss={float(loss):.4f} "
                      f"acc={acc:.4f} rho_mean={np.mean(sol.prune):.3f}")

    result.prune_rates = np.asarray(prune_hist)
    result.per_rates = np.asarray(per_hist)
    result.bound_final = bound.bound(cfg.rounds, tracker.avg_per,
                                     tracker.avg_prune)
    result.params = pruning.tree_map(lambda t: t.detach().cpu().numpy(),
                                     params)
    return result


def to_fleet_config(cfg: FLConfig, num_cells: int = 1,
                    **overrides) -> FE.FleetConfig:
    """An FLConfig as the fleet engine's configuration: the same wireless
    model, solver constants and smoothness, the engine's own task and
    heterogeneity draws (a simulation engine, not a replay of ``run``)."""
    if cfg.num_clients % num_cells:
        raise ValueError(f"num_clients={cfg.num_clients} not divisible by "
                         f"num_cells={num_cells}")
    k_lo, k_hi = int(min(cfg.samples)), int(max(cfg.samples))
    topo = TOPO.FleetTopology(num_cells=num_cells,
                              clients_per_cell=cfg.num_clients // num_cells,
                              cpu_hz_range=(cfg.cpu_hz, cfg.cpu_hz),
                              samples_range=(k_lo, k_hi),
                              max_prune=cfg.max_prune)
    fields = dict(topology=topo, wireless=cfg.wireless,
                  smoothness=cfg.smoothness, weight=cfg.weight,
                  rounds=cfg.rounds, lr=cfg.lr, seed=cfg.seed,
                  task=cfg.task)
    fields.update(overrides)
    return FE.FleetConfig(**fields)


def _host_cell_solver(fcfg: FE.FleetConfig, pop: TOPO.ClientPopulation):
    """A ``solve_fn`` for the engine's control pass: the paper's numpy
    solver (``tradeoff.solve_alternating``) cell by cell, with the
    participation mask, the deadline cap and the round's surrogate m.
    Under an interference graph the cells solve inside the same damped
    fixed point as the batched solver, iterated on the host in float64
    (``fcfg.solver.fp_*``; the PSD through ``topology.interference_psd``),
    warning when it stops at its cap unconverged.  The ``CellSolution``
    lands on the population's device and dtype; like the reference's it
    reports no alternation counts (zeros) and no residual trajectory."""
    def host(t):
        return t.detach().cpu().numpy()

    k_np, cpu_np, pw_np, mp_np = (host(t) for t in (
        pop.num_samples, pop.cpu_hz, pop.tx_power, pop.max_prune))
    scfg = fcfg.solver
    n0 = fcfg.wireless.noise_psd_w_per_hz
    b_hz = fcfg.wireless.bandwidth_hz
    like = pop.pathloss

    def solve_cells(h_up_np, mask_np, m_np, cap_np, i_psd):
        cells = h_up_np.shape[0]
        prune = np.zeros(h_up_np.shape)
        bandwidth = np.zeros(h_up_np.shape)
        per = np.zeros(h_up_np.shape)
        deadline = np.zeros(cells)
        inner = np.zeros(cells)
        for c in range(cells):
            bound = ConvergenceBound(fcfg.smoothness, k_np[c])
            # interference enters every closed form as extra noise PSD
            wcfg = fcfg.wireless.replace(
                noise_psd_w_per_hz=n0 + float(i_psd[c]))
            prob = tradeoff.TradeoffProblem(
                cfg=wcfg, bound=bound, h_up=h_up_np[c],
                h_down=np.ones_like(h_up_np[c]),  # unused by the solver
                tx_power=pw_np[c], cpu_hz=cpu_np[c],
                num_samples=k_np[c].astype(np.float64), max_prune=mp_np[c],
                weight=fcfg.weight, num_rounds=fcfg.rounds)
            sol_c = tradeoff.solve_alternating(
                prob, max_iters=scfg.max_iters,
                mask=None if mask_np is None else mask_np[c],
                deadline_cap=None if cap_np is None else float(cap_np[c]),
                m=None if m_np is None else float(m_np[c]))
            prune[c], bandwidth[c] = sol_c.prune, sol_c.bandwidth
            per[c], deadline[c] = sol_c.per, sol_c.deadline
            inner[c] = sol_c.inner_cost
        return prune, bandwidth, per, deadline, inner

    def solve(h_up, mask, m_round, cap, interference=None
              ) -> FSOLVER.CellSolution:
        h_up_np = host(h_up)
        mask_np = None if mask is None else host(mask)
        m_np = None if m_round is None else host(m_round)
        cap_np = None if cap is None else host(cap)
        cells = h_up_np.shape[0]
        i_solved = fp_it = fp_err = None
        if interference is None:
            out = solve_cells(h_up_np, mask_np, m_np, cap_np,
                              np.zeros(cells))
        else:
            # the batched solver's fixed point, step for step, on the host
            graph = TOPO.InterferenceGraph(*(
                t.detach().cpu().to(torch.float64) if t.is_floating_point()
                else t.detach().cpu() for t in interference))
            pw64 = torch.from_numpy(pw_np.astype(np.float64))
            i_cur = np.zeros(cells)
            i_solved, fp_it, fp_err = i_cur, 0, np.inf
            converged = False
            for _ in range(scfg.fp_iters):
                out = solve_cells(h_up_np, mask_np, m_np, cap_np, i_cur)
                i_raw = TOPO.interference_psd(
                    torch.from_numpy(out[1]), pw64, graph, b_hz).numpy()
                i_new = i_cur + scfg.fp_damping * (i_raw - i_cur)
                err = np.max(np.abs(i_new - i_cur))
                scale = n0 + np.max(i_cur)
                i_solved, i_cur = i_cur, i_new
                fp_it += 1
                fp_err = float(err)
                if err <= scfg.fp_rtol * scale:
                    converged = True
                    break
            if not converged:
                warnings.warn(
                    f"interference fixed point stopped at fp_iters="
                    f"{scfg.fp_iters} without converging: residual "
                    f"{fp_err:.3e} W/Hz > fp_rtol*scale; using the last "
                    "iterate (raise SolverConfig.fp_iters or fp_damping "
                    "to fix)", tradeoff.SolverConvergenceWarning,
                    stacklevel=2)

        def dev(a):
            return torch.as_tensor(a, dtype=like.dtype, device=like.device)

        prune, bandwidth, per, deadline, inner = out
        return FSOLVER.CellSolution(
            prune=dev(prune), bandwidth=dev(bandwidth),
            deadline=dev(deadline), per=dev(per), inner_cost=dev(inner),
            iterations=torch.zeros(cells, dtype=torch.int32,
                                   device=like.device),
            feasible=torch.ones(cells, dtype=torch.bool, device=like.device),
            interference_psd=None if i_solved is None else dev(i_solved),
            fp_iterations=None if fp_it is None else torch.tensor(
                fp_it, dtype=torch.int32, device=like.device),
            fp_residual=None if fp_err is None else dev(fp_err))

    return solve


def run_fleet_reference(fcfg: FE.FleetConfig, progress: bool = False,
                        sink: Optional[TEL.TelemetrySink] = None, *,
                        device=None, dtype: torch.dtype = torch.float32,
                        draws=None, start: Optional[FE.SimStart] = None
                        ) -> FE.FleetResult:
    """The fleet engine stepped round by round with the host solver.

    Same task, population, draws and FedSGD update as ``run_fleet`` (the
    engine's ``Simulation`` with ``_host_cell_solver`` as its control
    pass's ``solve_fn``); partial participation, stragglers, deadline
    caps and interference geometries included, sync single tier only.
    ``fcfg.telemetry`` rides along as on the fleet path; ``sink`` receives
    the run's records.  ``device``, ``dtype``, ``draws`` and ``start`` are
    ``build_simulation``'s.  Returns a ``FleetResult``.
    """
    if fcfg.cloud_period >= 1:
        raise NotImplementedError(
            "run_fleet_reference is single-tier; two-tier aggregation "
            "(cloud_period >= 1) only exists on the fleet engine path")
    sim = FE.build_simulation(fcfg, "sync", device=device, dtype=dtype,
                              draws=draws, start=start)
    sim = dataclasses.replace(
        sim, solve_fn=_host_cell_solver(sim.cfg, sim.population))
    result = sim.finalize(*sim.simulate(sim.params))
    if progress:
        for rnd in range(fcfg.rounds):
            if rnd % 10 == 0 or rnd == fcfg.rounds - 1:
                print(f"[5ue] round {rnd:4d} loss={result.losses[rnd]:.4f} "
                      f"acc={result.accuracy[rnd]:.4f}")
    if sink is not None:
        TEL.emit_result(result, sink, meta={
            "path": "reference", "clients": fcfg.topology.num_clients})
    return result


def run_any(cfg: FLConfig, progress: bool = False, fleet_threshold: int = 64,
            num_cells: int = 1, mesh=None, *, device=None,
            dtype: torch.dtype = torch.float32):
    """Small populations (``num_clients <= fleet_threshold``) and every
    scheme but "proposed" take ``run`` (an ``FLResult``), or, with
    ``cfg.task`` and "proposed", ``run_fleet_reference`` (a
    ``FleetResult``); larger "proposed" runs take the fleet engine
    (``fleet.run_fleet`` on ``to_fleet_config(cfg, num_cells)``, a
    ``FleetResult``), on ``mesh`` where one is given (the host paths
    ignore it, as the reference's do).  The return type switches with
    the path."""
    if cfg.num_clients <= fleet_threshold or cfg.scheme != "proposed":
        if cfg.task is not None and cfg.scheme == "proposed":
            return run_fleet_reference(
                to_fleet_config(cfg, num_cells=num_cells), progress=progress,
                device=device, dtype=dtype)
        return run(cfg, progress=progress, device=device, dtype=dtype)
    return FE.run_fleet(to_fleet_config(cfg, num_cells=num_cells),
                        progress=progress, mesh=mesh, device=device,
                        dtype=dtype)
