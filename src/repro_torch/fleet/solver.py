"""Algorithm 1 for every cell at once: the batched trade-off solver, with
the damped inter-cell interference fixed point.

The port of ``repro.fleet.solver``.  The reference vmaps a
per-cell ``lax.while_loop``; under vmap JAX steps the whole batch while
any lane is live and freezes each lane whose own condition is false,
whether it converged or hit ``max_iters``.  Here the
batch dimension is written out: the loop runs while
``(~done & (iters < max_iters)).any()`` and every frozen lane keeps its
old state.  Each alternation is the Prop.-1 pruning vertex followed by
the Eq.-(21) bandwidth inversion (``core.closed_form``); the optional
deadline cap re-derives the Eq.-(16) rates at the capped deadline and
sidelines what no longer fits the band.

With an ``InterferenceGraph`` (``fleet.topology``) the cells couple: every
fixed-point iteration solves all cells at effective noise N0 + I_c,
recomputes I from the allocation (``topology.interference_psd``) and
damps, I <- I + d (F(I) - I), from I = 0, freezing when the iterate moves
by at most ``fp_rtol (N0 + max I)`` or after ``fp_iters`` iterations.
Like the alternations, each iteration's freeze test is a host sync.  With
``diagnostics`` each iteration's residual is written into a preallocated
device tensor (``CellSolution.fp_residuals``), which adds no sync.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import closed_form as CF
from repro_torch.fleet import topology as TOPO

__all__ = ["SolverConfig", "CellSolution", "solve_cell", "solve_fleet"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static knobs of the alternating solver; ``fp_*`` govern the
    interference fixed point (``fp_rtol = 0`` always runs ``fp_iters``)."""

    max_iters: int = 16       # Algorithm-1 alternations (cap)
    bw_iters: int = 12        # Eq.-(21) Newton steps
    rtol: float = 1e-8        # freeze threshold on the inner cost; clamped
                              # to a few ulp of the compute dtype
    fp_iters: int = 8         # interference fixed-point cap
    fp_damping: float = 0.5   # damping d of the interference iterate
    fp_rtol: float = 1e-3     # freeze tolerance, relative to N0 + max I


class CellSolution(NamedTuple):
    """Per-cell solver output: (C, I) per-client fields, (C,) per cell.
    The ``interference_psd`` / ``fp_*`` fields are set by coupled solves
    only: the converged per-cell PSD (W/Hz) the solution was solved at,
    the fixed-point iterations and the last iterate movement (W/Hz)."""

    prune: torch.Tensor        # rho_i*
    bandwidth: torch.Tensor    # B_i*, Hz
    deadline: torch.Tensor     # t~*, s
    per: torch.Tensor          # q_i(B_i*)
    inner_cost: torch.Tensor   # (14a)
    iterations: torch.Tensor   # alternations until freeze (int32)
    feasible: torch.Tensor     # finite B and sum B_i <= B
    interference_psd: Optional[torch.Tensor] = None   # (C,)
    fp_iterations: Optional[torch.Tensor] = None      # scalar int32
    fp_residual: Optional[torch.Tensor] = None        # scalar
    fp_residuals: Optional[torch.Tensor] = None       # (fp_iters,)


def solve_fleet(h_up: torch.Tensor, num_samples: torch.Tensor,
                cpu_hz: torch.Tensor, tx_power: torch.Tensor,
                max_prune: torch.Tensor, m: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                deadline_cap: Optional[torch.Tensor] = None, *,
                bandwidth_hz: float, noise_psd: float, waterfall_m0: float,
                model_bits: float, cycles_per_sample: float, weight: float,
                solver: SolverConfig = SolverConfig(),
                interference: Optional[TOPO.InterferenceGraph] = None,
                diagnostics: bool = False) -> CellSolution:
    """Algorithm 1 over every cell of a (C, I) fleet.

    Array args are (C, I) except ``m`` (1/samples) and ``deadline_cap``
    (seconds), which are (C,).  Gains are linear, bandwidth Hz, noise W/Hz
    (a float, or a (C,) tensor of per-cell effective noise), payload bits,
    power W, ``weight`` the trade-off lambda.  Masked-out clients get rho
    = 0 and B = 0 and drop out of the vertex walk and cost.  With
    ``interference`` the cells solve inside the damped fixed point (see
    the module docstring); ``diagnostics`` then also returns the
    per-iteration residuals (``fp_residuals``, shape ``(fp_iters,)``).
    """
    if mask is None:
        mask = torch.ones_like(h_up)
    kw = dict(bandwidth_hz=bandwidth_hz, waterfall_m0=waterfall_m0,
              model_bits=model_bits, cycles_per_sample=cycles_per_sample,
              weight=weight, solver=solver)
    args = (h_up, num_samples, cpu_hz, tx_power, max_prune, m, mask,
            deadline_cap)
    if interference is None:
        return _solve(*args, noise=noise_psd, **kw)

    i_cur = torch.zeros(h_up.shape[:-1], dtype=h_up.dtype,
                        device=h_up.device)
    i_solved, it, err = i_cur, 0, torch.full((), float("inf"),
                                             dtype=h_up.dtype,
                                             device=h_up.device)
    resid = torch.full((solver.fp_iters,), float("nan"), dtype=h_up.dtype,
                       device=h_up.device) if diagnostics else None
    sol = None
    while it < solver.fp_iters:
        sol = _solve(*args, noise=(noise_psd + i_cur)[:, None], **kw)
        i_raw = TOPO.interference_psd(sol.bandwidth, tx_power, interference,
                                      bandwidth_hz)
        i_new = i_cur + solver.fp_damping * (i_raw - i_cur)
        err = torch.amax(torch.abs(i_new - i_cur))
        if resid is not None:
            resid[it] = err
        done = bool(err <= solver.fp_rtol * (noise_psd + torch.amax(i_cur)))
        i_solved, i_cur, it = i_cur, i_new, it + 1
        if done:
            break
    if sol is None:   # fp_iters = 0: the reference's zero solution
        sol = _solve(*args, noise=noise_psd, **kw)
        sol = CellSolution(*(torch.zeros_like(v) for v in sol[:7]))
    return sol._replace(
        interference_psd=i_solved,
        fp_iterations=torch.tensor(it, dtype=torch.int32, device=h_up.device),
        fp_residual=err, fp_residuals=resid)


def solve_cell(h_up: torch.Tensor, num_samples: torch.Tensor,
               cpu_hz: torch.Tensor, tx_power: torch.Tensor,
               max_prune: torch.Tensor, m, mask=None, deadline_cap=None, *,
               noise_psd, solver: SolverConfig = SolverConfig(),
               **kw) -> CellSolution:
    """Algorithm 1 for one cell of I clients: the fleet solve on a
    one-cell fleet, its cell axis taken away again.  Array inputs are
    (I,); ``m`` and ``deadline_cap`` are scalars; ``noise_psd`` may be a
    scalar tensor (N0 + I when the cell sits inside a fixed point)."""
    def row(v):
        return None if v is None else torch.as_tensor(
            v, dtype=h_up.dtype, device=h_up.device).reshape(1, -1)

    if isinstance(noise_psd, torch.Tensor):
        noise_psd = noise_psd.reshape(1, 1)
    sol = _solve(*(row(v) for v in (h_up, num_samples, cpu_hz, tx_power,
                                    max_prune)),
                 row(m)[0], row(mask),
                 None if deadline_cap is None else row(deadline_cap)[0],
                 noise=noise_psd, solver=solver, **kw)
    return CellSolution(*(v[0] for v in sol[:7]))


def _solve(h_up, num_samples, cpu_hz, tx_power, max_prune, m, mask,
           deadline_cap, *, noise, bandwidth_hz, waterfall_m0, model_bits,
           cycles_per_sample, weight, solver) -> CellSolution:
    """The alternations at noise PSD ``noise`` (a float or (C, 1))."""
    noise_psd = noise
    lam = weight
    k = num_samples.to(h_up.dtype)
    if mask is None:
        mask = torch.ones_like(h_up)
    participating = mask > 0.0
    n_part = torch.clamp_min(torch.sum(mask, dim=-1), 1.0)
    m_col = m[..., None]
    cap = deadline_cap

    def no_prune_latency(bw):
        r = CF.uplink_rate(bw, tx_power, h_up, noise_psd)
        t_u = CF.upload_latency(torch.zeros_like(bw), model_bits, r)
        t_c0 = CF.training_latency(torch.zeros_like(bw), k, cycles_per_sample,
                                   cpu_hz)
        return t_u + t_c0

    def inner_cost(deadline, bw, rho):
        q = CF.packet_error_rate(bw, tx_power, h_up, noise_psd, waterfall_m0)
        learning = m * torch.sum(mask * k * (q + k * rho), dim=-1)
        return (1.0 - lam) * deadline + lam * learning

    def body(bw, dl, rho, prev_cost, done, iters):
        t_np = no_prune_latency(bw)
        dl2, rho2 = CF.pruning_vertex(t_np, k, lam, m_col, max_prune,
                                      mask=mask)
        if cap is not None:
            dl2 = torch.minimum(dl2, cap)
            rho2 = torch.minimum(CF.prune_rates_for_deadline(t_np, dl2[:, None]),
                                 max_prune) * mask
        bw2 = CF.bandwidth_for_deadline(
            rho2, dl2, k, cpu_hz, cycles_per_sample, model_bits, tx_power,
            h_up, noise_psd, iters=solver.bw_iters)
        if cap is not None:  # unschedulable at rho^max: sit out
            bw2 = torch.where(torch.isfinite(bw2), bw2, 0.0)
            bw2 = torch.where(participating, bw2, 0.0)
            # A binding cap can oversubscribe B: keep the ascending-demand
            # prefix that fits and sideline the rest for this round.
            order = torch.argsort(bw2, dim=-1, stable=True)
            fits = torch.cumsum(torch.take_along_dim(bw2, order, dim=-1),
                                dim=-1) <= bandwidth_hz * (1.0 + 1e-9)
            keep = torch.zeros_like(bw2).scatter(-1, order,
                                                 fits.to(bw2.dtype))
            bw2 = bw2 * keep
        bw2 = torch.where(participating, bw2, 0.0)
        cost = inner_cost(dl2, bw2, rho2)
        conv = torch.abs(prev_cost - cost) <= eff_rtol * torch.clamp_min(
            torch.abs(cost), 1.0)
        bw = torch.where(done[:, None], bw, bw2)
        dl = torch.where(done, dl, dl2)
        rho = torch.where(done[:, None], rho, rho2)
        prev_cost = torch.where(done, prev_cost, cost)
        iters = iters + (~done).to(iters.dtype)
        return bw, dl, rho, prev_cost, done | conv, iters

    bw0 = mask * (bandwidth_hz / n_part[:, None])
    # A freeze threshold below the dtype's resolution never fires; clamp
    # it to a few ulp, as the reference does.
    eff_rtol = max(solver.rtol, 4.0 * float(torch.finfo(bw0.dtype).eps))
    c = h_up.shape[0]
    state = (bw0, torch.full((c,), float("inf"), dtype=bw0.dtype,
                             device=bw0.device),
             torch.zeros_like(bw0),
             torch.full((c,), float("inf"), dtype=bw0.dtype,
                        device=bw0.device),
             torch.zeros((c,), dtype=torch.bool, device=bw0.device),
             torch.zeros((c,), dtype=torch.int32, device=bw0.device))

    while True:
        live = ~state[4] & (state[5] < solver.max_iters)
        if not bool(live.any()):
            break
        new = body(*state)
        state = tuple(
            torch.where(live.reshape(live.shape + (1,) * (n.ndim - 1)), n, o)
            for n, o in zip(new, state))
    bw, dl, rho, cost, _, iters = state

    per = CF.packet_error_rate(bw, tx_power, h_up, noise_psd,
                               waterfall_m0) * mask
    feasible = torch.all(torch.isfinite(bw), dim=-1) \
        & (torch.sum(bw, dim=-1) <= bandwidth_hz * (1.0 + 1e-6))
    return CellSolution(prune=rho, bandwidth=bw, deadline=dl, per=per,
                        inner_cost=cost, iterations=iters, feasible=feasible)
