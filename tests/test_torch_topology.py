"""The port's cell geometries against ``repro.fleet.topology``.

Hex placement, reuse colouring and the geometry registry as pure
functions; ``interference_psd`` on numpy inputs; and
``HexInterference.make_population`` / ``round_channel`` against the
reference's, both under float64 (``jax.enable_x64(True)``), with the
reference's own draws rebuilt from its key splits and ``fold_in`` salts
(the population's angle, the serving-link fades, the mobility jitter, the
handover and cross-link fades) and injected into the port: equal up to
1e-12 relative, neighbour lists and handover flags exactly.  Finally the
zero-co-channel limit (``reuse >= num_cells``, static clients) against
``OrthogonalCells``: a whole run, bit for bit, in both packages.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.fleet import engine as JENG
from repro.fleet import topology as JTOPO
from repro_torch import weights
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import topology as TTOPO

from test_torch_engine import _configs, hex_round_draws, population_numpy

RTOL = 1e-12
TX = 10 ** 2.3 * 1e-3


def test_hex_positions_and_spacing():
    for n in (1, 7, 19, 30):
        got = TTOPO.hex_bs_positions(n, 1000.0)
        np.testing.assert_array_equal(got, JTOPO.hex_bs_positions(n, 1000.0))
        assert got.shape == (n, 2) and np.allclose(got[0], 0.0)
        if n > 1:
            d = np.linalg.norm(got[:, None] - got[None], axis=-1)
            d[np.diag_indices(n)] = np.inf
            np.testing.assert_allclose(d.min(axis=1), 1000.0, rtol=1e-12)


@pytest.mark.parametrize("reuse", [3, 4, 7])
def test_reuse_colouring_is_proper(reuse):
    """No two adjacent cells share a group, and the groups equal the
    reference's."""
    n = 37
    groups = TTOPO.hex_reuse_groups(n, reuse)
    np.testing.assert_array_equal(groups, JTOPO.hex_reuse_groups(n, reuse))
    pos = TTOPO.hex_bs_positions(n, 1.0)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    adjacent = np.isclose(d, 1.0)
    assert adjacent.any()
    assert not (adjacent & (groups[:, None] == groups[None, :])).any()
    assert set(groups.tolist()) == set(range(reuse))


def test_reuse_at_least_cells_is_the_orthogonal_limit():
    np.testing.assert_array_equal(TTOPO.hex_reuse_groups(5, 5), np.arange(5))
    np.testing.assert_array_equal(TTOPO.hex_reuse_groups(5, 9), np.arange(5))
    topo = TTOPO.FleetTopology(5, 3)
    assert TTOPO.HexInterference(reuse=5)._num_neighbors(topo) == 0
    assert TTOPO.HexInterference(reuse=1, max_neighbors=3
                                 )._num_neighbors(topo) == 3
    with pytest.raises(ValueError, match="reuse"):
        TTOPO.hex_reuse_groups(5, 0)


def test_make_geometry_registry():
    geo = TTOPO.make_geometry("hex", reuse=7, mobility_m=5.0)
    assert isinstance(geo, TTOPO.HexInterference)
    assert (geo.reuse, geo.mobility_m) == (7, 5.0)
    assert isinstance(TTOPO.make_geometry("orthogonal"),
                      TTOPO.OrthogonalCells)
    assert set(TTOPO.GEOMETRIES) == set(JTOPO.GEOMETRIES)
    with pytest.raises(ValueError, match="unknown geometry"):
        TTOPO.make_geometry("square")


def _graph(seed, c=4, k=2, i=5):
    rng = np.random.default_rng(seed)
    idx = np.stack([(np.arange(c) + 1 + j) % c for j in range(k)], axis=1)
    mask = (rng.uniform(size=(c, k)) > 0.2).astype(np.float64)
    cross = rng.uniform(1e-14, 1e-11, (c, k, i))
    bw = rng.uniform(0.0, 2e6, (c, i))
    bw[0, :2] = 0.0
    return idx, mask, cross, bw, np.full((c, i), TX)


def test_interference_psd_matches_reference_and_vanishes_at_zero_allocation():
    idx, mask, cross, bw, p = _graph(3)
    with jax.enable_x64(True):
        ref = np.asarray(JTOPO.interference_psd(
            jnp.asarray(bw), jnp.asarray(p),
            JTOPO.InterferenceGraph(jnp.asarray(cross), jnp.asarray(idx),
                                    jnp.asarray(mask)), 15e6))
    graph = TTOPO.InterferenceGraph(torch.as_tensor(cross),
                                    torch.as_tensor(idx),
                                    torch.as_tensor(mask))
    got = TTOPO.interference_psd(torch.as_tensor(bw), torch.as_tensor(p),
                                 graph, 15e6).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert (got > 0).all()
    zero = TTOPO.interference_psd(torch.zeros(bw.shape, dtype=torch.float64),
                                  torch.as_tensor(p), graph, 15e6)
    assert (zero == 0).all()


GEOS = {
    "static_reuse3": dict(reuse=3, max_neighbors=6, handover=False),
    "static_handover_reuse1": dict(reuse=1, max_neighbors=3),
    "mobility_handover_reuse3": dict(reuse=3, max_neighbors=6,
                                     mobility_m=40.0),
    "mobility_no_neighbours": dict(reuse=7, mobility_m=25.0),
}


@pytest.mark.parametrize("name", sorted(GEOS))
def test_hex_population_and_channel_match_reference(name):
    kw = GEOS[name]
    jtopo = JTOPO.FleetTopology(7, 6)
    ttopo = TTOPO.FleetTopology(7, 6)
    jgeo, tgeo = JTOPO.HexInterference(**kw), TTOPO.HexInterference(**kw)
    k_pop, k_round = jax.random.split(jax.random.PRNGKey(5))
    with jax.enable_x64(True):
        ref_pop = jgeo.make_population(k_pop, jtopo, TX)
        base = JTOPO.make_population(k_pop, jtopo, TX)
        angle = jax.random.uniform(
            jax.random.fold_in(k_pop, JTOPO._SALT_ANGLE), jtopo.shape,
            minval=0.0, maxval=2.0 * np.pi)
        chans, draws = [], []
        for r in range(2):
            key = jax.random.fold_in(k_round, r)
            chans.append(jax.tree.map(
                np.asarray, jgeo.round_channel(key, ref_pop, jtopo)))
            h_up, h_down = JTOPO.sample_fading(key, ref_pop.pathloss)
            draws.append((np.asarray(h_up), np.asarray(h_down),
                          hex_round_draws(key, ref_pop, jgeo)))
        ref_np = population_numpy(ref_pop)

    dt = torch.float64
    pop = tgeo.make_population(
        ttopo, weights.population_from_numpy(population_numpy(base), dt,
                                             "cpu"),
        weights.tensor(angle, dt, "cpu"))
    assert (pop.geometry is None) == (ref_np["geometry"] is None)
    if pop.geometry is not None:
        for f in TTOPO.HexState._fields:
            got = getattr(pop.geometry, f).numpy()
            if f == "nbr_idx":
                np.testing.assert_array_equal(got, ref_np["geometry"][f])
            else:
                np.testing.assert_allclose(got, ref_np["geometry"][f],
                                           rtol=RTOL, err_msg=f)
    zeros = np.zeros(ttopo.shape)
    for (h_up, h_down, hexd), jc in zip(draws, chans):
        d = weights.round_draws_from_numpy(h_up, h_down, zeros, zeros,
                                           dtype=dt, device="cpu", **hexd)
        tc = tgeo.round_channel(d, pop, ttopo)
        np.testing.assert_allclose(tc.h_up.numpy(), jc.h_up, rtol=RTOL)
        np.testing.assert_allclose(tc.h_down.numpy(), jc.h_down, rtol=RTOL)
        assert (tc.served_home is None) == (jc.served_home is None)
        if jc.served_home is not None:
            np.testing.assert_array_equal(tc.served_home.numpy(),
                                          jc.served_home)
        assert (tc.interference is None) == (jc.interference is None)
        if jc.interference is not None:
            for f in ("cross_gain", "nbr_idx", "nbr_mask"):
                np.testing.assert_allclose(
                    getattr(tc.interference, f).numpy(),
                    getattr(jc.interference, f), rtol=RTOL, err_msg=f)
    if name == "static_handover_reuse1":
        # the case exercises a handover: some client's best BS is not home
        assert any((jc.served_home == 0).any() for jc in chans)


def test_generator_draws_hex_population_and_rounds():
    """The default draw source gives a hex population its state and every
    round the draws ``round_draw_shapes`` names; orthogonal runs draw none
    of them."""
    topo = TTOPO.FleetTopology(7, 6)
    geo = TTOPO.HexInterference(reuse=3, mobility_m=25.0)
    src = TENG.GeneratorDraws(3, "cpu", geometry=geo)
    pop = src.population(topo, TX, torch.float64)
    assert pop.geometry is not None and pop.geometry.nbr_idx.shape == (7, 2)
    d = src.round(0, pop)
    for name, shape in geo.round_draw_shapes(pop).items():
        assert tuple(getattr(d, name).shape) == shape
    assert torch.equal(d.h_up, pop.pathloss * d.ray_up)
    plain = TENG.GeneratorDraws(3, "cpu")
    pop0 = plain.population(topo, TX, torch.float64)
    d0 = plain.round(0, pop0)
    assert torch.equal(pop0.dist_m, pop.dist_m)
    assert torch.equal(d0.h_up, d.h_up) and d0.jitter is None


def test_injected_hex_draws_are_checked():
    jcfg, tcfg = _configs({}, (3, 4), dict(
        geometry=dict(reuse=1, max_neighbors=2, mobility_m=25.0)), rounds=1)
    src = TENG.GeneratorDraws(0, "cpu", geometry=tcfg.geometry)
    pop = src.population(tcfg.topology, TX, torch.float64)
    d = src.round(0, pop)
    bad = TENG.InjectedDraws(pop, [d._replace(ray_cross=None)])
    with pytest.raises(ValueError, match="ray_cross"):
        TENG.build_simulation(tcfg, device="cpu", dtype=torch.float64,
                              draws=bad)
    ok = TENG.InjectedDraws(pop, [d])
    TENG.build_simulation(tcfg, device="cpu", dtype=torch.float64, draws=ok)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_zero_co_channel_limit_is_bitwise_orthogonal(mode):
    """``reuse >= num_cells`` with static clients: no hex state, no
    interference graph, the orthogonal channel; every field of a run equal
    bit for bit, in the port (float32 and float64) and in the reference
    (float64)."""
    jcfg, tcfg = _configs({}, (3, 4), rounds=3)
    hexkw = dict(reuse=3, mobility_m=0.0)
    fields = ("losses", "latencies", "deadlines", "mean_prune", "mean_per",
              "participants", "bandwidth_util", "wall_clock")
    for dt in (torch.float32, torch.float64):
        a = TENG.run_fleet(tcfg, mode, device="cpu", dtype=dt)
        b = TENG.run_fleet(dataclasses.replace(
            tcfg, geometry=TTOPO.HexInterference(**hexkw)), mode,
            device="cpu", dtype=dt)
        for f in fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        np.testing.assert_array_equal(a.params["layer0"]["w"],
                                      b.params["layer0"]["w"])
    with jax.enable_x64(True):
        ja = JENG.run_fleet(jcfg, mode=mode)
        jb = JENG.run_fleet(dataclasses.replace(
            jcfg, geometry=JTOPO.HexInterference(**hexkw)), mode=mode)
    for f in fields:
        np.testing.assert_array_equal(getattr(ja, f), getattr(jb, f),
                                      err_msg=f)
    assert math.isclose(ja.bound_final, jb.bound_final, rel_tol=0.0)
