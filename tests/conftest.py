"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on the single real
CPU device; only launch/dryrun.py forces 512 placeholder devices."""

import numpy as np
import pytest

from repro.core import wireless
from repro.core.convergence import ConvergenceBound, SmoothnessParams
from repro.core.tradeoff import TradeoffProblem


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips (with a reason) without one")


@pytest.fixture(scope="session")
def table1_cfg() -> wireless.WirelessConfig:
    """Paper Table I parameters."""
    return wireless.WirelessConfig()


def make_problem(num_clients: int = 5, seed: int = 0, weight: float = 0.0004,
                 cfg: wireless.WirelessConfig | None = None,
                 samples=None) -> TradeoffProblem:
    cfg = cfg or wireless.WirelessConfig()
    ch = wireless.Channel(num_clients, seed=seed)
    h_up, h_down = ch.sample_gains()
    if samples is None:
        samples = np.resize([30, 40, 50], num_clients).astype(np.float64)
    bound = ConvergenceBound(SmoothnessParams(), np.asarray(samples))
    return TradeoffProblem(
        cfg=cfg, bound=bound, h_up=h_up, h_down=h_down,
        tx_power=np.full(num_clients, cfg.tx_power_ue_w),
        cpu_hz=np.full(num_clients, 5e9),
        num_samples=np.asarray(samples, np.float64),
        max_prune=np.full(num_clients, 0.7),
        weight=weight, num_rounds=200)


@pytest.fixture
def problem() -> TradeoffProblem:
    return make_problem()
