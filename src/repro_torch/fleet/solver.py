"""Algorithm 1 for every cell at once: the batched trade-off solver.

The port of ``repro.fleet.solver`` without the interference fixed point.
The reference vmaps a per-cell ``lax.while_loop``; under vmap JAX steps
the whole batch while any lane is live and freezes each lane whose own
condition is false, whether it converged or hit ``max_iters``.  Here the
batch dimension is written out: the loop runs while
``(~done & (iters < max_iters)).any()`` and every frozen lane keeps its
old state.  Each alternation is the Prop.-1 pruning vertex followed by
the Eq.-(21) bandwidth inversion (``core.closed_form``); the optional
deadline cap re-derives the Eq.-(16) rates at the capped deadline and
sidelines what no longer fits the band.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import closed_form as CF

__all__ = ["SolverConfig", "CellSolution", "solve_fleet"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static knobs of the alternating solver (the interference
    fixed point's ``fp_*`` knobs come with item 6d of ROADMAP.md)."""

    max_iters: int = 16       # Algorithm-1 alternations (cap)
    bw_iters: int = 12        # Eq.-(21) Newton steps
    rtol: float = 1e-8        # freeze threshold on the inner cost; clamped
                              # to a few ulp of the compute dtype


class CellSolution(NamedTuple):
    """Per-cell solver output: (C, I) per-client fields, (C,) per cell."""

    prune: torch.Tensor        # rho_i*
    bandwidth: torch.Tensor    # B_i*, Hz
    deadline: torch.Tensor     # t~*, s
    per: torch.Tensor          # q_i(B_i*)
    inner_cost: torch.Tensor   # (14a)
    iterations: torch.Tensor   # alternations until freeze (int32)
    feasible: torch.Tensor     # finite B and sum B_i <= B


def solve_fleet(h_up: torch.Tensor, num_samples: torch.Tensor,
                cpu_hz: torch.Tensor, tx_power: torch.Tensor,
                max_prune: torch.Tensor, m: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                deadline_cap: Optional[torch.Tensor] = None, *,
                bandwidth_hz: float, noise_psd: float, waterfall_m0: float,
                model_bits: float, cycles_per_sample: float, weight: float,
                solver: SolverConfig = SolverConfig()) -> CellSolution:
    """Algorithm 1 over every cell of a (C, I) fleet.

    Array args are (C, I) except ``m`` (1/samples) and ``deadline_cap``
    (seconds), which are (C,).  Gains are linear, bandwidth Hz, noise W/Hz,
    payload bits, power W, ``weight`` the trade-off lambda.  Masked-out
    clients get rho = 0 and B = 0 and drop out of the vertex walk and cost.
    """
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
