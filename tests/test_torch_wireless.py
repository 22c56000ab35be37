"""The port's host wireless model (``core/wireless.py``) against
``repro.core.wireless``: the seeded ``Channel``'s draws bit for bit, and
the rate, SINR, PER and latency terms on the same numpy inputs at 1e-12
relative (float64 on both sides; only torch's and numpy's transcendental
functions can differ, by rounding)."""

import dataclasses

import numpy as np
import pytest

from repro.core import wireless as JW
from repro_torch.core import wireless as TW

RTOL = 1e-12


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=RTOL,
                               atol=1e-300)


@pytest.mark.parametrize("n,seed,lo,hi", [(5, 0, 50.0, 500.0),
                                          (64, 11, 10.0, 1000.0)])
def test_channel_draws_are_bitwise_the_reference(n, seed, lo, hi):
    j = JW.Channel(n, seed=seed, min_dist_m=lo, max_dist_m=hi)
    t = TW.Channel(n, seed=seed, min_dist_m=lo, max_dist_m=hi)
    np.testing.assert_array_equal(t.dist_m, j.dist_m)
    np.testing.assert_array_equal(t.path_loss_linear(), j.path_loss_linear())
    for _ in range(4):
        for a, b in zip(t.sample_gains(), j.sample_gains()):
            np.testing.assert_array_equal(a, b)


def test_config_and_radio_match_reference():
    assert dataclasses.asdict(TW.WirelessConfig()) \
        == dataclasses.asdict(JW.WirelessConfig())
    assert TW.WirelessConfig().backhaul_s == JW.WirelessConfig().backhaul_s
    assert TW.WirelessConfig().replace(bandwidth_hz=1e6).bandwidth_hz == 1e6
    radio = dict(uplink_gain=1e-12, downlink_gain=2e-12, cpu_hz=5e9,
                 num_samples=30, tx_power_w=0.2)
    assert dataclasses.asdict(TW.ClientRadio(**radio)) \
        == dataclasses.asdict(JW.ClientRadio(**radio))
    assert TW.dbm_to_watt(23.0) == JW.dbm_to_watt(23.0)
    assert TW.db_to_linear(0.023) == JW.db_to_linear(0.023)


@pytest.fixture
def inputs():
    ch = JW.Channel(8, seed=3)
    h_up, h_down = ch.sample_gains()
    rng = np.random.default_rng(4)
    bw = rng.uniform(0.0, 4e6, 8)
    bw[2] = 0.0                                   # no allocation: rate 0
    return dict(h_up=h_up, h_down=h_down, bw=bw,
                prune=rng.uniform(0.0, 0.7, 8),
                k=rng.integers(16, 65, 8).astype(np.float64),
                cpu=rng.uniform(2e9, 8e9, 8), p=np.full(8, 0.2),
                i_psd=rng.uniform(0.0, 1e-20, 8))


@pytest.mark.parametrize("i_psd", [False, True])
def test_rate_sinr_and_per_match_reference(inputs, i_psd):
    d, cfg = inputs, JW.WirelessConfig()
    n0 = cfg.noise_psd_w_per_hz
    kw = dict(interference_psd=d["i_psd"]) if i_psd else {}
    close(TW.uplink_sinr(d["bw"], d["p"], d["h_up"], n0, **kw),
          JW.uplink_sinr(d["bw"], d["p"], d["h_up"], n0, **kw))
    close(TW.uplink_rate(d["bw"], d["p"], d["h_up"], n0, **kw),
          JW.uplink_rate(d["bw"], d["p"], d["h_up"], n0, **kw))
    close(TW.packet_error_rate(d["bw"], d["p"], d["h_up"], n0,
                               cfg.waterfall_m0, **kw),
          JW.packet_error_rate(d["bw"], d["p"], d["h_up"], n0,
                               cfg.waterfall_m0, **kw))
    close(TW.downlink_rate(TW.WirelessConfig(), d["h_down"]),
          JW.downlink_rate(cfg, d["h_down"]))


def test_latency_terms_match_reference(inputs):
    d = inputs
    jc, tc = JW.WirelessConfig(), TW.WirelessConfig()
    rate = JW.uplink_rate(d["bw"], d["p"], d["h_up"], jc.noise_psd_w_per_hz)
    close(TW.training_latency(tc, d["prune"], d["k"], d["cpu"]),
          JW.training_latency(jc, d["prune"], d["k"], d["cpu"]))
    close(TW.upload_latency(tc, d["prune"], rate),
          JW.upload_latency(jc, d["prune"], rate))
    assert np.isinf(TW.upload_latency(tc, d["prune"], rate)[2])
    close(TW.broadcast_latency(tc, d["h_down"]),
          JW.broadcast_latency(jc, d["h_down"]))
    bw = np.where(d["bw"] > 0, d["bw"], 1e6)
    args = (d["h_down"], d["prune"], bw, d["p"], d["h_up"], d["k"], d["cpu"])
    close(TW.round_latency(tc, *args), JW.round_latency(jc, *args))
    assert isinstance(TW.round_latency(tc, *args), float)


@pytest.mark.parametrize("retx", [0, 1, 3])
def test_retransmission_terms_match_reference(retx):
    q = np.array([0.0, 0.1, 0.5, 0.99, 1.0])
    close(TW.effective_per(q, retx), JW.effective_per(q, retx))
    close(TW.expected_tries(q, retx), JW.expected_tries(q, retx))
