"""Wireless parameters of the pruned-FL system (paper §II, Table I).

The port's copy of ``repro.core.wireless``'s configuration: the
dataclass the fleet engine reads and the two unit converters its
defaults use.  The rate, PER and latency formulas live in
``repro_torch.core.closed_form``.
"""

from __future__ import annotations

import dataclasses

__all__ = ["WirelessConfig", "dbm_to_watt", "db_to_linear"]


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
