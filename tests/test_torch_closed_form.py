"""The port's torch closed forms against ``repro.core.closed_form`` (xp=jnp).

Both run in float64 (JAX under ``jax.enable_x64(True)``) on the same
random (C, I) inputs made with numpy, so only the implementations can
separate them.  Tolerance: 1e-6 relative — the two lanes spell every
formula the same way, and float64 rounding differences between XLA and
torch kernels (log/exp/pow) are ~1e-15, far inside it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import closed_form as JCF
from repro_torch.core import closed_form as TCF

RTOL = 1e-6
N0 = 10 ** (-174 / 10) * 1e-3
P_UE = 10 ** (23 / 10) * 1e-3


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(torch_out, jax_out, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out),
                               rtol=rtol, atol=atol)


def _inputs(seed=0, c=5, i=9):
    rng = np.random.default_rng(seed)
    dist = rng.uniform(50, 500, (c, i))
    pl = 10.0 ** (-(128.1 + 37.6 * np.log10(dist / 1000.0)) / 10.0)
    return dict(
        bw=rng.uniform(0, 3e6, (c, i)) * (rng.uniform(size=(c, i)) > 0.1),
        h_up=pl * rng.exponential(size=(c, i)),
        h_down=pl * rng.exponential(size=(c, i)),
        p=np.full((c, i), P_UE),
        k=rng.integers(16, 65, (c, i)).astype(np.float64),
        cpu=rng.uniform(2e9, 8e9, (c, i)),
        rho=rng.uniform(0, 0.7, (c, i)),
        mask=(rng.uniform(size=(c, i)) > 0.3).astype(np.float64),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_rates_per_and_latencies_match(seed):
    d = _inputs(seed)
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in d.items()}
        ref = dict(
            sinr=JCF.uplink_sinr(j["bw"], j["p"], j["h_up"], N0, xp=jnp),
            up=JCF.uplink_rate(j["bw"], j["p"], j["h_up"], N0, xp=jnp),
            up_i=JCF.uplink_rate(j["bw"], j["p"], j["h_up"], N0,
                                 interference_psd=3 * N0, xp=jnp),
            down=JCF.downlink_rate(15e6, 1.0, j["h_down"], N0, xp=jnp),
            per=JCF.packet_error_rate(j["bw"], j["p"], j["h_up"], N0, 1.005,
                                      xp=jnp),
            tc=JCF.training_latency(j["rho"], j["k"], 0.168e9, j["cpu"],
                                    xp=jnp),
            tu=JCF.upload_latency(j["rho"], 1.6e6,
                                  JCF.uplink_rate(j["bw"], j["p"], j["h_up"],
                                                  N0, xp=jnp), xp=jnp),
            m=JCF.surrogate_m(j["k"], 1.0, 1.0, 0.1, 1.0, xp=jnp,
                              mask=j["mask"]),
        )
    t = {k: _t(v) for k, v in d.items()}
    got = dict(
        sinr=TCF.uplink_sinr(t["bw"], t["p"], t["h_up"], N0),
        up=TCF.uplink_rate(t["bw"], t["p"], t["h_up"], N0),
        up_i=TCF.uplink_rate(t["bw"], t["p"], t["h_up"], N0,
                             interference_psd=3 * N0),
        down=TCF.downlink_rate(15e6, 1.0, t["h_down"], N0),
        per=TCF.packet_error_rate(t["bw"], t["p"], t["h_up"], N0, 1.005),
        tc=TCF.training_latency(t["rho"], t["k"], 0.168e9, t["cpu"]),
        tu=TCF.upload_latency(t["rho"], 1.6e6,
                              TCF.uplink_rate(t["bw"], t["p"], t["h_up"], N0)),
        m=TCF.surrogate_m(t["k"], 1.0, 1.0, 0.1, 1.0, mask=t["mask"]),
    )
    for name in ref:
        _close(got[name], ref[name])


def _vertex_case(seed, ties):
    rng = np.random.default_rng(seed)
    c, i = 6, 11
    t_np = rng.uniform(0.2, 2.0, (c, i))
    if ties:  # repeated breakpoints: side="right" must drop the tied group
        t_np[:, 1::2] = t_np[:, ::2][:, :t_np[:, 1::2].shape[1]]
        t_np[0] = 0.7
    k = rng.integers(16, 65, (c, i)).astype(np.float64)
    mask = (rng.uniform(size=(c, i)) > 0.25).astype(np.float64)
    mask[1] = 0.0            # a cell with nobody scheduled
    t_np[2, 3] = np.inf      # a zero-rate client: degenerate cell
    m = rng.uniform(1e-5, 1e-3, (c, 1))
    mp = rng.uniform(0.3, 0.9, (c, i))
    return t_np, k, m, mp, mask


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("weight", [0.0004, 0.3, 0.999])
def test_pruning_vertex_matches_with_ties_and_masks(ties, weight):
    t_np, k, m, mp, mask = _vertex_case(3, ties)
    with jax.enable_x64(True):
        ref_t, ref_rho = JCF.pruning_vertex(
            jnp.asarray(t_np), jnp.asarray(k), weight, jnp.asarray(m),
            jnp.asarray(mp), xp=jnp, mask=jnp.asarray(mask))
    got_t, got_rho = TCF.pruning_vertex(_t(t_np), _t(k), weight, _t(m),
                                        _t(mp), mask=_t(mask))
    _close(got_t, ref_t)
    _close(got_rho, ref_rho)


def test_min_bandwidth_newton_including_near_capacity_ceiling():
    rng = np.random.default_rng(7)
    h = 10.0 ** (-rng.uniform(9, 13, (4, 16)))
    p = np.full_like(h, P_UE)
    ceiling = p * h / (N0 * np.log(2.0))
    frac = rng.uniform(0.0, 1.0, h.shape)
    frac[0] = 1.0 - np.logspace(-1, -9, 16)      # up to the ceiling
    frac[1, :3] = [0.0, 1.0, 1.5]                # zero / at / above ceiling
    target = frac * ceiling
    with jax.enable_x64(True):
        ref = JCF.min_bandwidth_for_rates(jnp.asarray(target), jnp.asarray(p),
                                          jnp.asarray(h), N0, iters=12,
                                          xp=jnp)
    got = TCF.min_bandwidth_for_rates(_t(target), _t(p), _t(h), N0, iters=12)
    _close(got, ref)
    assert np.isinf(np.asarray(got)[1, 1:3]).all()


def test_bandwidth_for_deadline_matches():
    d = _inputs(5)
    rng = np.random.default_rng(5)
    deadline = rng.uniform(0.05, 1.5, (d["k"].shape[0],))
    with jax.enable_x64(True):
        ref = JCF.bandwidth_for_deadline(
            jnp.asarray(d["rho"]), jnp.asarray(deadline), jnp.asarray(d["k"]),
            jnp.asarray(d["cpu"]), 0.168e9, 1.6e6, jnp.asarray(d["p"]),
            jnp.asarray(d["h_up"]), N0, iters=12, xp=jnp)
    got = TCF.bandwidth_for_deadline(
        _t(d["rho"]), _t(deadline), _t(d["k"]), _t(d["cpu"]), 0.168e9, 1.6e6,
        _t(d["p"]), _t(d["h_up"]), N0, iters=12)
    _close(got, ref)
    assert np.isinf(np.asarray(got)).any()  # some deadlines have no slack
