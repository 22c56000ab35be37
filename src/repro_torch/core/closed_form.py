"""The trade-off paper's closed forms (§II, §IV) on torch tensors.

The PyTorch counterpart of the ``xp = jax.numpy`` lane of
``repro.core.closed_form``: rates (Eqs. 1/3), waterfall PER, latency terms
(Eqs. 2/4), the Proposition-1 pruning vertex and the Eq.-(21)
minimum-bandwidth inversion (safeguarded Newton on the concave rate
curve).  Every function keeps the reference's operation order, so under
float64 the two agree to rounding.

Tensors may carry any leading batch dims (cells); the client axis is
last.  Loops run a fixed trip count with no early exit, as the device
path of the reference does, so no value leaves the device.  Scalars may
be Python floats; dtypes follow the tensor inputs.

``on_host`` runs any of them on numpy arrays, as float64 CPU tensors: the
reference's numpy lane (``core/wireless.py``, ``core/tradeoff.py``).  The
numpy lane of the reference stops its Newton loop once every element has
converged; here the loop runs its fixed trip count, and since a converged
step moves the iterate by rounding only, the two agree to rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "uplink_sinr",
    "uplink_rate",
    "downlink_rate",
    "packet_error_rate",
    "training_latency",
    "upload_latency",
    "prune_rates_for_deadline",
    "pruning_vertex",
    "min_bandwidth_for_rates",
    "bandwidth_for_deadline",
    "surrogate_m",
    "on_host",
]

_LN2 = math.log(2.0)
_F32_TINY = float(torch.finfo(torch.float32).tiny)


# ---------------------------------------------------------------------------
# Rates / PER / latency terms (Eqs. 1-4 + waterfall PER)
# ---------------------------------------------------------------------------

def uplink_sinr(bandwidth, tx_power, h_up, noise_psd, interference_psd=0.0):
    """Uplink SINR p_i h_i^u / (B_i (N0 + I)); inf at B_i = 0.

    Units: ``bandwidth`` Hz, ``tx_power`` W, ``h_up`` linear power gain,
    ``noise_psd`` and ``interference_psd`` W/Hz.
    """
    sinr = tx_power * h_up / (bandwidth * (noise_psd + interference_psd))
    return torch.where(bandwidth > 0.0, sinr, math.inf)


def uplink_rate(bandwidth, tx_power, h_up, noise_psd, interference_psd=0.0):
    """Eq. (3): R_i^u = B_i log2(1 + SINR_i) in bits/s; 0 at B_i = 0."""
    sinr = uplink_sinr(bandwidth, tx_power, h_up, noise_psd,
                       interference_psd=interference_psd)
    r = bandwidth * torch.log2(1.0 + sinr)
    return torch.where(bandwidth > 0.0, r, 0.0)


def downlink_rate(bandwidth_hz, tx_power_bs, h_down, noise_psd):
    """Eq. (1): the broadcast uses the full bandwidth B; bits/s."""
    snr = tx_power_bs * h_down / (bandwidth_hz * noise_psd)
    return bandwidth_hz * torch.log2(1.0 + snr)


def packet_error_rate(bandwidth, tx_power, h_up, noise_psd, m0,
                      interference_psd=0.0):
    """Waterfall PER q_i = 1 - exp(-m0 B_i (N0 + I) / (p_i h_i^u)).

    Spelled exactly as the reference (``-m0 b N_eff / (p h)``) so the
    rounding agrees.
    """
    return 1.0 - torch.exp(-m0 * bandwidth * (noise_psd + interference_psd)
                           / (tx_power * h_up))


def training_latency(prune_rate, num_samples, cycles_per_sample, cpu_hz):
    """Eq. (2): t_i^c = (1 - rho_i) K_i d^c / f_i, in seconds."""
    return (1.0 - prune_rate) * num_samples * cycles_per_sample / cpu_hz


def upload_latency(prune_rate, model_bits, rate_up):
    """t_i^u = (1 - rho_i) D_M / R_i^u in seconds; inf when the rate is 0."""
    t = (1.0 - prune_rate) * model_bits / rate_up
    return torch.where(rate_up > 0.0, t, math.inf)


# ---------------------------------------------------------------------------
# Proposition 1 (+ Eq. 16): the pruning sub-problem vertex
# ---------------------------------------------------------------------------

def prune_rates_for_deadline(t_np, deadline):
    """Eq. (16): rho_i^min(t~) = max{1 - t~/t_i^np, 0}."""
    return torch.clamp_min(1.0 - deadline / t_np, 0.0)


def pruning_vertex(t_np, num_samples, weight, m, max_prune, mask=None):
    """Proposition 1, batched: optimal deadline t~* and pruning rates.

    ``t_np``, ``num_samples``, ``max_prune`` and ``mask`` are shaped
    (..., I); ``m`` broadcasts against (..., 1) (one surrogate coefficient
    per cell).  The breakpoints are sorted once per row (stable, as
    ``jnp.argsort``) and every candidate vertex's slope comes from one
    batched ``searchsorted(right=True)`` into the suffix sums.

    Returns ``(t_star (...,), rho (..., I))``; a row with an infinite
    t~max degenerates to ``(inf, ones)`` as in the reference.
    """
    k = num_samples
    lam = weight
    if mask is None:
        mask = torch.ones_like(t_np)
    participating = mask > 0.0

    t_max = torch.where(participating, t_np, -math.inf).amax(-1, keepdim=True)
    t_min = torch.where(participating, t_np * (1.0 - max_prune),
                        -math.inf).amax(-1, keepdim=True)

    w = torch.where(participating, k * k / t_np, 0.0)
    w = torch.where(torch.isfinite(w), w, 0.0)

    t_break = torch.where(participating, t_np, math.inf)
    order = torch.argsort(t_break, dim=-1, stable=True)
    t_sorted = torch.take_along_dim(t_break, order, dim=-1)
    w_sorted = torch.take_along_dim(w, order, dim=-1)
    csum = torch.cumsum(w_sorted, dim=-1)
    total = csum[..., -1:]

    cands = torch.cat([t_min, t_sorted], dim=-1)
    idx = torch.searchsorted(t_sorted.contiguous(), cands.contiguous(),
                             right=True)
    prefix = torch.cat([torch.zeros_like(total), csum], dim=-1)
    prefix_at = torch.take_along_dim(prefix, idx, dim=-1)
    slope = (1.0 - lam) - lam * m * (total - prefix_at)

    valid = (cands >= t_min) & (cands <= t_max) & (slope >= 0.0)
    t_star = torch.where(valid, cands, math.inf).amin(-1, keepdim=True)
    t_star = torch.where(torch.isfinite(t_star), t_star, t_max)

    degenerate = ~torch.isfinite(t_max)
    t_star = torch.where(degenerate, math.inf, t_star)
    rho = torch.minimum(prune_rates_for_deadline(t_np, t_star), max_prune)
    rho = torch.where(degenerate, 1.0, rho) * mask
    return t_star.squeeze(-1), rho


# ---------------------------------------------------------------------------
# Eq. (21): minimum bandwidth meeting a rate / deadline
# ---------------------------------------------------------------------------

def min_bandwidth_for_rates(target_rate, tx_power, h_up, noise_psd,
                            iters: int = 80):
    """Invert R^u(B) = target by safeguarded Newton (Lemma 1: R^u rises
    in B and is concave).  ``min(max(iters, 1), 24)`` Newton steps run
    unconditionally, the reference's fixed device trip count.  Targets at
    or above the capacity ceiling p h / (N0 ln 2) return inf; returns Hz.
    """
    target, p, h = torch.broadcast_tensors(target_rate, tx_power, h_up)
    ceiling = p * h / (noise_psd * _LN2)
    feasible = target < ceiling
    pos = target > 0.0

    safe_target = torch.where(pos, target, 1.0)
    c = torch.where(feasible & pos, p * h / noise_psd, 1.0)
    t_ln2 = safe_target * _LN2
    raw_snr = c / safe_target
    big = min(1e300, float(torch.finfo(raw_snr.dtype).max))
    snr_at_target = torch.clamp(raw_snr, 0.0, big)
    b0 = safe_target / torch.clamp_min(torch.log2(1.0 + snr_at_target), 1e-12)
    b0 = torch.clamp_min(b0, 1.0)
    # Near the ceiling the root diverges as c / (2 eps); seed with that
    # asymptote there (see the reference for the derivation).
    eps_gap = torch.clamp_min(1.0 - t_ln2 / c, 1e-12)
    b0 = torch.where(eps_gap < 0.5, torch.maximum(b0, c / (2.0 * eps_gap)),
                     b0)

    b = b0
    for _ in range(min(max(iters, 1), 24)):
        s = c / b
        ln1p = torch.log1p(s)
        fval = b * ln1p - t_ln2
        fprime = torch.clamp_min(ln1p - s / (1.0 + s), _F32_TINY)
        b2 = b - fval / fprime
        b = torch.where(b2 > 0.0, b2, 0.5 * b)
    out = torch.where(pos, b, 0.0)
    return torch.where(feasible | ~pos, out, math.inf)


def bandwidth_for_deadline(prune, deadline, num_samples, cpu_hz,
                           cycles_per_sample, model_bits, tx_power, h_up,
                           noise_psd, iters: int = 80):
    """Eq. (21): per-UE minimum bandwidth meeting the deadline, in Hz.

    ``deadline`` broadcasts against ``prune`` (a missing trailing client
    dim is added).  Zero payload -> 0; positive payload with no slack ->
    inf.
    """
    if deadline.ndim < prune.ndim:
        deadline = deadline[..., None]
    prune, deadline = torch.broadcast_tensors(prune, deadline)
    t_c = training_latency(prune, num_samples, cycles_per_sample, cpu_hz)
    slack = deadline - t_c
    payload = (1.0 - prune) * model_bits
    target = payload / slack
    bw = min_bandwidth_for_rates(
        torch.where((payload > 0) & (slack > 0), target, 0.0),
        tx_power, h_up, noise_psd, iters=iters)
    bw = torch.where(payload <= 0.0, 0.0, bw)
    return torch.where((payload > 0.0) & (slack <= 0.0), math.inf, bw)


# ---------------------------------------------------------------------------
# Eq. (11): surrogate coefficient m
# ---------------------------------------------------------------------------

def surrogate_m(num_samples, beta, xi1, xi2, weight_bound, mask=None):
    """m = max{8 xi1 / (d K), 2 beta^2 I D^2 / (d K^2)}, d = 1 - 8 xi2,
    over the last axis (the participating subset when ``mask`` is given);
    units 1/samples."""
    k = num_samples
    if mask is not None:
        k = k * mask
    d = 1.0 - 8.0 * xi2
    k_tot = torch.sum(k, dim=-1)
    count = torch.sum((k > 0).to(k.dtype), dim=-1)
    k_tot = torch.clamp_min(k_tot, 1e-30)
    return torch.maximum(8.0 * xi1 / (d * k_tot),
                         2.0 * beta**2 * count * weight_bound**2
                         / (d * k_tot**2))


# ---------------------------------------------------------------------------
# The numpy lane
# ---------------------------------------------------------------------------

def _host_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float64))


def on_host(fn, *args, **kw):
    """``fn(*args, **kw)`` on float64 CPU tensors, its result as numpy
    float64 arrays (a tuple stays a tuple).  Every positional argument and
    every float or array keyword argument is converted; integer keywords
    (``iters``) and None pass as they are."""
    args = [_host_tensor(a) for a in args]
    kw = {k: v if v is None or isinstance(v, (bool, int, np.integer))
          else _host_tensor(v) for k, v in kw.items()}
    out = fn(*args, **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()
