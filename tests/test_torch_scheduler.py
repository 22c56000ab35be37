"""The port's scheduler against ``repro.fleet.scheduler``.

Partial participation ranks logits plus a Gumbel draw; the JAX draw of a
key (``jax.random.gumbel``, as ``_participation_scores`` makes it) is
injected into the port, and masks and cohorts must be equal exactly,
uniform and weighted, float64 under ``jax.enable_x64(True)`` and float32.
``arrival_times`` (infinite latencies retry or clamp) and
``select_arrivals`` (tied ready times break by index) must give the same
times and the same indices; ``AsyncConfig`` validates as the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.fleet import scheduler as JSCHED
from repro_torch.fleet import scheduler as TSCHED


def _samples(shape, seed=0):
    return np.random.default_rng(seed).integers(16, 65, shape).astype(
        np.float64)


@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("participation", ["uniform", "weighted"])
@pytest.mark.parametrize("m", [1, 3, 7])
def test_mask_and_cohort_match_reference(participation, m, x64):
    shape = (4, 9)
    k = _samples(shape, m)
    with jax.enable_x64(x64):
        key = jax.random.PRNGKey(17 + m)
        sched_j = JSCHED.ScheduleConfig(participation=participation,
                                        participants_per_cell=m)
        kj = jnp.asarray(k)
        mask_j, cohort_j = JSCHED.participation_cohort(key, sched_j, kj)
        only_mask = JSCHED.participation_mask(key, sched_j, kj)
        gumbel = np.asarray(jax.random.gumbel(key, shape))
    dt = torch.float64 if x64 else torch.float32
    sched_t = TSCHED.ScheduleConfig(participation=participation,
                                    participants_per_cell=m)
    kt, gt = torch.as_tensor(k, dtype=dt), torch.as_tensor(np.array(gumbel))
    mask_t, cohort_t = TSCHED.participation_cohort(sched_t, kt, gt, dt)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(cohort_t.numpy(), np.asarray(cohort_j))
    np.testing.assert_array_equal(
        TSCHED.participation_mask(sched_t, kt, gt, dt).numpy(),
        np.asarray(only_mask))
    assert mask_t.dtype == dt and int(mask_t.sum()) == shape[0] * m


def test_weighted_logits_take_a_float32_log():
    """The reference takes log K_i in float32 even under x64; so does the
    port, before adding the float64 Gumbel draw."""
    k = torch.tensor([[17.0, 33.0, 61.0]], dtype=torch.float64)
    zero = torch.zeros_like(k)
    sched = TSCHED.ScheduleConfig(participation="weighted",
                                  participants_per_cell=1)
    z = TSCHED._participation_scores(sched, k, zero)
    with jax.enable_x64(True):
        ref = np.asarray(jnp.log(jnp.asarray(k.numpy()).astype(jnp.float32))
                         + jnp.zeros(k.shape))
    np.testing.assert_array_equal(z.numpy(), ref)
    assert z.dtype == torch.float64
    assert float(z[0, 1]) != float(torch.log(k[0, 1]))


def test_full_schedule_is_the_identity_cohort_without_a_draw():
    k = torch.as_tensor(_samples((3, 5)))
    for sched in (TSCHED.ScheduleConfig(),
                  TSCHED.ScheduleConfig(participation="uniform",
                                        participants_per_cell=5)):
        mask, cohort = TSCHED.participation_cohort(sched, k, None,
                                                   torch.float64)
        assert bool((mask == 1).all())
        np.testing.assert_array_equal(cohort.numpy(),
                                      np.tile(np.arange(5), (3, 1)))
        assert not TSCHED.draws_participation(sched, 5)
    partial = TSCHED.ScheduleConfig(participation="uniform",
                                    participants_per_cell=2)
    assert TSCHED.draws_participation(partial, 5)
    with pytest.raises(ValueError, match="Gumbel"):
        TSCHED.participation_cohort(partial, k, None, torch.float64)


@pytest.mark.parametrize("sched", [
    dict(), dict(participation="uniform", participants_per_cell=0),
    dict(participation="weighted", participants_per_cell=3),
    dict(participation="uniform", participants_per_cell=8),
    dict(participation="full", participants_per_cell=2)])
def test_cohort_size_matches_reference(sched):
    assert TSCHED.cohort_size(TSCHED.ScheduleConfig(**sched), 8) == \
        JSCHED.cohort_size(JSCHED.ScheduleConfig(**sched), 8)


@pytest.mark.parametrize("retry", [None, 60.0])
def test_arrival_times_match_reference_with_infinite_latencies(retry):
    lat = np.array([[0.5, np.inf, 2.0], [np.inf, 1e12, 0.0]])
    kw = {} if retry is None else dict(retry_s=retry)
    with jax.enable_x64(True):
        ref = np.asarray(JSCHED.arrival_times(jnp.asarray(10.0),
                                              jnp.asarray(lat), **kw))
    got = TSCHED.arrival_times(torch.tensor(10.0, dtype=torch.float64),
                               torch.as_tensor(lat), **kw)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isfinite(got.numpy()).all()
    assert TSCHED.MAX_CLIENT_LATENCY_S == JSCHED.MAX_CLIENT_LATENCY_S


@pytest.mark.parametrize("k", [1, 3, 5, 8, 12])
def test_select_arrivals_breaks_ties_by_index_as_reference(k):
    # every client launched at t = 0; four retry at exactly 60 s and three
    # share one latency
    ready = np.array([[60.0, 2.5, 60.0, 1.0], [2.5, 60.0, 0.5, 2.5],
                      [60.0, 1.0, 7.0, 2.5]])
    with jax.enable_x64(True):
        sel_j, t_j = JSCHED.select_arrivals(jnp.asarray(ready), k)
    sel_t, t_t = TSCHED.select_arrivals(torch.as_tensor(ready), k)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert float(t_t) == float(t_j)


def test_async_config_validation_and_buffer():
    for cfg_cls in (TSCHED.AsyncConfig, JSCHED.AsyncConfig):
        assert cfg_cls(buffer_size=0).cohort_buffer(24) == 24
        assert cfg_cls(buffer_size=8).cohort_buffer(24) == 8
        assert cfg_cls(buffer_size=999).cohort_buffer(24) == 24
        assert cfg_cls(max_staleness=4).history_len == 5
    for bad in (dict(buffer_size=-1), dict(max_staleness=-2),
                dict(retry_backoff_s=0.0)):
        with pytest.raises(ValueError):
            TSCHED.AsyncConfig(**bad)
