"""Wireless channel and latency model of the pruned-FL system (paper §II).

The port of ``repro.core.wireless``: the system parameters
(``WirelessConfig``, Table I), the seeded block-fading ``Channel`` of the
paper's 5-UE experiment, and Eqs. (1)-(4) with the waterfall PER on host
arrays:

  R_i^d = B   log2(1 + p^d h_i^d / (B   N0))          (1)
  t^d   = max_i D_M / R_i^d
  t_i^c = (1 - rho_i) K_i d^c / f_i                    (2)
  R_i^u = B_i log2(1 + p_i h_i^u / (B_i N0))          (3)
  t_i^u = (1 - rho_i) D_M / R_i^u
  t     = max_i { t^d + t_i^c + t_i^u + t^a }          (4)
  q_i   = 1 - exp(-m0 B_i N0 / (p_i h_i^u))

SI units throughout.  The functions take and return numpy arrays, as the
reference's do; the formulas are ``core.closed_form``'s, run on float64
CPU tensors (``closed_form.on_host``), so the fleet engine and this host
path share one implementation.  ``Channel`` draws with numpy's
``default_rng(seed)``, so its gains equal the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import closed_form as CF

__all__ = [
    "WirelessConfig",
    "ClientRadio",
    "Channel",
    "downlink_rate",
    "uplink_sinr",
    "uplink_rate",
    "packet_error_rate",
    "effective_per",
    "expected_tries",
    "broadcast_latency",
    "training_latency",
    "upload_latency",
    "round_latency",
    "dbm_to_watt",
    "db_to_linear",
]


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) * 1e-3


def db_to_linear(db: float) -> float:
    return 10.0 ** (db / 10.0)


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    """System-wide wireless parameters (paper Table I defaults; SI units)."""

    bandwidth_hz: float = 15e6              # B  (total uplink bandwidth)
    noise_psd_w_per_hz: float = dbm_to_watt(-174.0)   # N0
    tx_power_ue_w: float = dbm_to_watt(23.0)          # p_i (max UE power)
    tx_power_bs_w: float = 1.0                        # p^d (BS broadcast)
    waterfall_m0: float = db_to_linear(0.023)         # m0 (waterfall threshold)
    model_bits: float = 1.6e6               # D_M
    cycles_per_sample: float = 0.168e9      # d^c
    aggregation_latency_s: float = 1e-3     # t^a (constant)
    backhaul_rate_bps: float = 1e9          # edge->cloud link rate (two-tier)
    backhaul_latency_s: float = 5e-3        # fixed cloud-merge overhead

    @property
    def backhaul_s(self) -> float:
        """Latency of one edge->cloud model merge, seconds."""
        return self.model_bits / self.backhaul_rate_bps \
            + self.backhaul_latency_s

    def replace(self, **kw) -> "WirelessConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ClientRadio:
    """Per-UE radio and compute profile."""

    uplink_gain: float          # h_i^u (linear power gain)
    downlink_gain: float        # h_i^d
    cpu_hz: float               # f_i
    num_samples: int            # K_i (samples used for local training)
    tx_power_w: float           # p_i
    max_prune_rate: float = 0.7  # rho_i^max


class Channel:
    """Seeded block-fading channel: clients dropped uniformly in an annulus
    around the BS, urban path loss 128.1 + 37.6 log10(d_km) dB, i.i.d.
    Rayleigh fading each round.  Reproducible from ``seed`` (numpy's
    ``default_rng``, the reference's generator and draw order)."""

    def __init__(self, num_clients: int, seed: int = 0,
                 min_dist_m: float = 50.0, max_dist_m: float = 500.0):
        self.num_clients = int(num_clients)
        self.rng = np.random.default_rng(seed)
        self.dist_m = self.rng.uniform(min_dist_m, max_dist_m,
                                       size=self.num_clients)

    def path_loss_linear(self) -> np.ndarray:
        pl_db = 128.1 + 37.6 * np.log10(self.dist_m / 1000.0)
        return 10.0 ** (-pl_db / 10.0)

    def sample_gains(self) -> tuple[np.ndarray, np.ndarray]:
        """One round of (uplink, downlink) channel power gains."""
        pl = self.path_loss_linear()
        ray_u = self.rng.exponential(1.0, size=self.num_clients)
        ray_d = self.rng.exponential(1.0, size=self.num_clients)
        return pl * ray_u, pl * ray_d


# ---------------------------------------------------------------------------
# Rates / PER / latency terms, vectorised over clients
# ---------------------------------------------------------------------------

def downlink_rate(cfg: WirelessConfig, h_down) -> np.ndarray:
    """Eq. (1): the broadcast uses the full bandwidth B."""
    return CF.on_host(CF.downlink_rate, cfg.bandwidth_hz, cfg.tx_power_bs_w,
                      h_down, cfg.noise_psd_w_per_hz)


def uplink_sinr(bandwidth, tx_power, h_up, noise_psd,
                interference_psd=0.0) -> np.ndarray:
    """Uplink SINR p h / (B (N0 + I)); inf at B = 0."""
    return CF.on_host(CF.uplink_sinr, bandwidth, tx_power, h_up, noise_psd,
                      interference_psd=interference_psd)


def uplink_rate(bandwidth, tx_power, h_up, noise_psd,
                interference_psd=0.0) -> np.ndarray:
    """Eq. (3): the FDMA uplink rate of bandwidth B_i; 0 at B_i = 0."""
    return CF.on_host(CF.uplink_rate, bandwidth, tx_power, h_up, noise_psd,
                      interference_psd=interference_psd)


def packet_error_rate(bandwidth, tx_power, h_up, noise_psd, m0,
                      interference_psd=0.0) -> np.ndarray:
    """q_i = 1 - exp(-m0 B_i (N0 + I) / (p_i h_i^u)); increasing in B_i
    (Lemma 1)."""
    return CF.on_host(CF.packet_error_rate, bandwidth, tx_power, h_up,
                      noise_psd, m0, interference_psd=interference_psd)


def effective_per(per, retx: int) -> np.ndarray:
    """PER with up to ``retx`` retransmissions: a gradient is lost only if
    all retx + 1 attempts fail, q_eff = q^(retx+1) (the paper: retx = 0)."""
    return np.asarray(per, dtype=np.float64) ** (retx + 1)


def expected_tries(per, retx: int) -> np.ndarray:
    """Expected uplink transmissions with up to ``retx`` retransmissions:
    (1 - q^(retx+1)) / (1 - q), retx + 1 at q = 1."""
    q = np.asarray(per, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        tries = (1.0 - q ** (retx + 1)) / (1.0 - q)
    return np.where(q < 1.0, tries, retx + 1.0)


def broadcast_latency(cfg: WirelessConfig, h_down) -> float:
    """t^d = max_i D_M / R_i^d: the worst downlink."""
    return float(np.max(cfg.model_bits / downlink_rate(cfg, h_down)))


def training_latency(cfg: WirelessConfig, prune_rate, num_samples,
                     cpu_hz) -> np.ndarray:
    """Eq. (2): t_i^c = (1 - rho_i) K_i d^c / f_i."""
    return CF.on_host(CF.training_latency, prune_rate, num_samples,
                      cfg.cycles_per_sample, cpu_hz)


def upload_latency(cfg: WirelessConfig, prune_rate, rate_up) -> np.ndarray:
    """t_i^u = (1 - rho_i) D_M / R_i^u; inf when the rate is 0."""
    return CF.on_host(CF.upload_latency, prune_rate, cfg.model_bits, rate_up)


def round_latency(cfg: WirelessConfig, h_down, prune_rate, bandwidth,
                  tx_power, h_up, num_samples, cpu_hz) -> float:
    """Eq. (4): one full communication round."""
    t_d = broadcast_latency(cfg, h_down)
    t_c = training_latency(cfg, prune_rate, num_samples, cpu_hz)
    r_u = uplink_rate(bandwidth, tx_power, h_up, cfg.noise_psd_w_per_hz)
    t_u = upload_latency(cfg, prune_rate, r_u)
    return float(np.max(t_d + t_c + t_u + cfg.aggregation_latency_s))
