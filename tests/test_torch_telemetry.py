"""Fleet telemetry: the port's ``fleet/telemetry.py`` and the engine's
summaries against the JAX package.

The primitives first, on the same numpy inputs through both packages:
``histogram`` (interior, clipped, NaN / +-inf, weighted, batched rows),
``bin_edges``, ``TelemetryConfig`` validation, ``split_metrics``, the
sinks, ``round_records`` and the Chrome trace.  Then the engine: telemetry
off leaves ``FleetResult.telemetry`` None and on leaves losses, latencies
and params bit for bit as they are (sync and async x reference and fused,
two-tier, hex and the cohort path); keys carry the prefix, each cell's
histogram mass is its client count, the async staleness histogram holds
the buffer, the hex fixed point's residuals are NaN past its iterations;
and the port's ``FleetResult.telemetry`` against the JAX engine's from
injected draws under ``jax.enable_x64(True)``: histograms equal (up to
values within rounding of a bin edge), gradient norms and mask densities
at 1e-5, the fixed point's residuals at 1e-6.
"""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from repro.fleet import scheduler as JSCHED
from repro.fleet import telemetry as JTEL
from repro_torch.fleet import engine as TENG
from repro_torch.fleet import scheduler as TSCHED
from repro_torch.fleet import task as TTASK
from repro_torch.fleet import telemetry as TTEL
from repro_torch.fleet import topology as TTOPO

from test_torch_engine import HEX, UNIFORM, _configs, _port, _reference

HISTS = ("per_hist", "rho_hist", "bw_hist", "latency_hist", "sinr_hist")


def _both_hist(x, lo, hi, bins, weights=None):
    with jax.enable_x64(True):
        ref = np.asarray(JTEL.histogram(
            np.asarray(x), lo, hi, bins,
            None if weights is None else np.asarray(weights)))
    got = TTEL.histogram(torch.as_tensor(np.asarray(x)), lo, hi, bins,
                         None if weights is None
                         else torch.as_tensor(np.asarray(weights)))
    return got.numpy(), ref


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x,lo,hi,bins", [
    (np.random.default_rng(0).uniform(size=(3, 40)), 0.0, 1.0, 16),
    (np.array([0.05, 0.05, 0.51, 0.97]), 0.0, 1.0, 10),
    (np.array([-5.0, -0.001, 1.001, 42.0]), 0.0, 1.0, 4),
    (np.array([np.nan, np.inf, -np.inf, 0.5]), 0.0, 1.0, 2),
    (np.random.default_rng(1).normal(20.0, 30.0, (2, 3, 50)), -20.0, 60.0,
     16),
])
def test_histogram_matches_reference(x, lo, hi, bins):
    got, ref = _both_hist(x, lo, hi, bins)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == x.shape[:-1] + (bins,)
    np.testing.assert_array_equal(got.sum(-1), x.shape[-1])


def test_stacked_histograms_equal_each_alone():
    """``histograms`` (the control pass's one stacked call) gives each
    input's own ``histogram`` bit for bit, out-of-range and non-finite
    values included."""
    rng = np.random.default_rng(3)
    xs = [torch.as_tensor(rng.normal(c, 2.0 * c, (3, 25)).astype(np.float32))
          for c in (0.5, 1.0, 20.0)]
    xs[0][0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    ranges = [(0.0, 1.0), (0.0, 10.0), (-20.0, 60.0)]
    got = TTEL.histograms(xs, ranges, 16)
    for x, (lo, hi), h in zip(xs, ranges, got):
        assert torch.equal(h, TTEL.histogram(x, lo, hi, 16))


@pytest.mark.parametrize("shape", [(2,), (4, 30)])
def test_weighted_histogram_matches_reference(shape):
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.2, 1.2, shape)
    w = rng.uniform(0.0, 2.0, shape)
    got, ref = _both_hist(x, 0.0, 1.0, 5, weights=w)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_allclose(got.sum(-1), w.sum(-1), rtol=1e-12)


def test_histogram_of_float32_counts_in_float32():
    x = torch.rand(3, 7, generator=torch.Generator().manual_seed(0))
    h = TTEL.histogram(x, 0.0, 1.0, 4)
    assert h.dtype == torch.float32
    assert torch.equal(h.sum(-1), torch.full((3,), 7.0))


@pytest.mark.parametrize("lo,hi,bins", [(-2.0, 2.0, 8), (0.0, 10.0, 16)])
def test_bin_edges_match_reference(lo, hi, bins):
    np.testing.assert_array_equal(TTEL.bin_edges(lo, hi, bins),
                                  np.asarray(JTEL.bin_edges(lo, hi, bins)))


@pytest.mark.parametrize("kw", [dict(bins=0), dict(staleness_bins=0),
                                dict(per_range=(1.0, 0.0)),
                                dict(sinr_db_range=(5.0, 5.0))])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        JTEL.TelemetryConfig(**kw)
    with pytest.raises(ValueError):
        TTEL.TelemetryConfig(**kw)


def test_config_defaults_match_reference():
    assert dataclasses.asdict(TTEL.TelemetryConfig()) \
        == dataclasses.asdict(JTEL.TelemetryConfig())


@pytest.mark.parametrize("metrics", [
    {"loss": 1.0, "tel_per_hist": 2.0, "eval_accuracy": 3.0},
    {"loss": 1.0}])
def test_split_metrics_matches_reference(metrics):
    assert TTEL.split_metrics(metrics) == JTEL.split_metrics(metrics)


def _fake_records():
    return [{"kind": "run", "mode": "sync", "rounds": 2},
            {"kind": "round", "round": 0, "loss": 1.5, "h": [1.0, 2.0]},
            {"kind": "round", "round": 1, "loss": 1.2}]


@pytest.mark.parametrize("name", ["tel.jsonl", "tel.csv"])
def test_file_sinks_write_what_the_reference_writes(tmp_path, name):
    texts = []
    for mod, sub in ((JTEL, "ref"), (TTEL, "port")):
        os.makedirs(tmp_path / sub)
        path = str(tmp_path / sub / name)
        sink = mod.sink_for_path(path)
        assert isinstance(sink, mod.CSVSink if name.endswith(".csv")
                          else mod.JSONLSink)
        for r in _fake_records():
            sink.emit(r)
        sink.close()
        sink.close()
        with open(path) as fh:
            texts.append(fh.read())
    assert texts[0] == texts[1]
    if name.endswith(".csv"):
        with open(tmp_path / "port" / name) as fh:
            rows = list(csv.DictReader(fh))
        assert len(rows) == 3 and float(rows[1]["loss"]) == 1.5
    else:
        with open(tmp_path / "port" / name) as fh:
            assert [json.loads(line) for line in fh] == _fake_records()


def test_memory_sink_protocol():
    sink = TTEL.MemorySink()
    assert isinstance(sink, TTEL.TelemetrySink)
    for r in _fake_records():
        sink.emit(r)
    sink.close()
    assert sink.records == _fake_records() and sink.closed


def test_span_recorder_chrome_trace(tmp_path):
    rec = TTEL.SpanRecorder()
    with rec.span("outer", clients=8):
        with rec.span("inner"):
            pass
    assert [e["name"] for e in rec.events] == ["inner", "outer"]
    doc = rec.chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in evs)
    outer = next(e for e in evs if e["name"] == "outer")
    inner = next(e for e in evs if e["name"] == "inner")
    assert outer["args"] == {"clients": 8}
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    path = str(tmp_path / "trace.json")
    rec.write(path)
    with open(path) as fh:
        assert json.load(fh)["traceEvents"]


def test_spans_group_a_profiler_capture():
    """Each span is a ``record_function`` scope in a torch.profiler
    capture."""
    rec = TTEL.SpanRecorder()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("fleet.build"):
            torch.ones(4).sum()
    assert "fleet.build" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# the engine: off is bitwise, on leaves the trajectories alone
# ---------------------------------------------------------------------------

TASK = dict(feature_dim=32, hidden=(12, 6), num_classes=5, test_samples=64,
            prune_block=8)


def _tiny(rounds=3, cells=2, per_cell=4, **kw):
    return TENG.FleetConfig(
        task=TTASK.SyntheticMLPTask(**TASK),
        topology=TTOPO.FleetTopology(cells, per_cell), rounds=rounds,
        lr=0.05, **kw)


def _runs(cfg, mode, tcfg=None):
    off = TENG.run_fleet(cfg, mode, device="cpu")
    on = TENG.run_fleet(dataclasses.replace(
        cfg, telemetry=tcfg or TTEL.TelemetryConfig()), mode, device="cpu")
    return off, on


def _assert_bitwise(off, on):
    assert off.telemetry is None and on.telemetry is not None
    np.testing.assert_array_equal(off.losses, on.losses)
    np.testing.assert_array_equal(off.latencies, on.latencies)
    np.testing.assert_array_equal(off.deadlines, on.deadlines)
    for name, layer in off.params.items():
        for leaf, v in layer.items():
            np.testing.assert_array_equal(v, on.params[name][leaf])


ASYNC_CFG = TSCHED.AsyncConfig(buffer_size=3)
BITWISE = {
    "sync_fused": ("sync", dict(kernel="fused")),
    "sync_reference": ("sync", dict(kernel="reference")),
    "async_fused": ("async", dict(kernel="fused", async_config=ASYNC_CFG)),
    "async_reference": ("async", dict(kernel="reference",
                                      async_config=ASYNC_CFG)),
    "cohort": ("sync", dict(kernel="fused", schedule=TSCHED.ScheduleConfig(
        participation="uniform", participants_per_cell=2))),
    "two_tier": ("sync", dict(kernel="fused", cloud_period=2)),
    "two_tier_async": ("async", dict(kernel="fused", cloud_period=2,
                                     async_config=TSCHED.AsyncConfig(
                                         buffer_size=4))),
    "hex": ("sync", dict(kernel="fused",
                         geometry=TTOPO.HexInterference(reuse=1))),
}


@pytest.mark.parametrize("case", sorted(BITWISE))
def test_telemetry_on_leaves_trajectories_bitwise(case):
    mode, kw = BITWISE[case]
    cells = 3 if case == "hex" else 2
    off, on = _runs(_tiny(cells=cells, **kw), mode)
    _assert_bitwise(off, on)


def test_default_config_has_no_telemetry():
    assert TENG.FleetConfig().telemetry is None
    assert TENG.run_fleet(_tiny(rounds=1), device="cpu").telemetry is None


def test_prefix_keys_and_per_cell_mass():
    cfg = _tiny(per_cell=8, kernel="fused", telemetry=TTEL.TelemetryConfig())
    sim = TENG.build_simulation(cfg, device="cpu")
    _, metrics = sim.simulate(sim.params)
    core = {"loss", "accuracy", "round_latency", "deadline", "mean_prune",
            "mean_per", "participants", "bandwidth_util", "learning_cost"}
    assert {k for k in metrics if k not in core} \
        == {k for k in metrics if k.startswith("tel_")} != set()
    tel = sim.finalize(*sim.simulate(sim.params)).telemetry
    for name in HISTS:
        assert tel[name].shape == (3, 2, 16)
        np.testing.assert_array_equal(tel[name].sum(-1), 8.0)
    assert tel["grad_norm"].shape == (3,) and np.all(tel["grad_norm"] >= 0)
    assert np.all((tel["mask_density"] >= 0) & (tel["mask_density"] <= 1))
    assert tel["solver_iters"].shape == (3, 2)


def test_solver_and_gradient_flags_drop_their_keys_only():
    on = _runs(_tiny(kernel="fused"), "sync")[1].telemetry
    no_solver = _runs(_tiny(kernel="fused"), "sync",
                      TTEL.TelemetryConfig(solver=False))[1].telemetry
    no_grads = _runs(_tiny(kernel="fused"), "sync",
                     TTEL.TelemetryConfig(gradients=False))[1].telemetry
    assert set(on) - set(no_solver) == {"solver_iters"}
    assert set(on) - set(no_grads) == {"grad_norm", "mask_density"}


def test_async_staleness_hist_holds_the_buffer():
    cfg = _tiny(rounds=4, kernel="fused",
                async_config=TSCHED.AsyncConfig(buffer_size=3),
                telemetry=TTEL.TelemetryConfig(staleness_bins=6))
    tel = TENG.run_fleet(cfg, "async", device="cpu").telemetry
    assert tel["staleness_hist"].shape == (4, 6)
    np.testing.assert_array_equal(tel["staleness_hist"].sum(-1), 3.0)


def test_hex_fixed_point_residuals_nan_padded():
    cfg = _tiny(rounds=2, cells=3, kernel="fused",
                geometry=TTOPO.HexInterference(reuse=1),
                telemetry=TTEL.TelemetryConfig())
    tel = TENG.run_fleet(cfg, device="cpu").telemetry
    fp_it, resid = tel["fp_iterations"], tel["fp_residuals"]
    assert fp_it.shape == (2,) and np.all(fp_it >= 1)
    assert resid.shape == (2, cfg.solver.fp_iters)
    np.testing.assert_array_equal((~np.isnan(resid)).sum(-1), fp_it)
    for r in range(2):
        assert resid[r, fp_it[r] - 1] == tel["fp_residual"][r]


def test_run_fleet_sink_and_recorder(tmp_path):
    sink = TTEL.MemorySink()
    rec = TTEL.SpanRecorder()
    res = TENG.run_fleet(_tiny(kernel="fused",
                               telemetry=TTEL.TelemetryConfig()),
                         device="cpu", sink=sink, recorder=rec)
    assert [r["kind"] for r in sink.records] == ["run"] + ["round"] * 3
    assert sink.records[0]["clients"] == 8 and not sink.closed
    assert len(sink.records[1]["per_hist"]) == 2
    assert sink.records[2]["loss"] == float(res.losses[1])
    assert {e["name"] for e in rec.events} \
        == {"fleet.build", "fleet.simulate", "fleet.finalize"}
    path = str(tmp_path / "run.jsonl")
    n = TTEL.emit_result(res, TTEL.sink_for_path(path), close=True)
    with open(path) as fh:
        assert len(fh.readlines()) == n == 4


# ---------------------------------------------------------------------------
# the engine against the JAX engine (injected draws, float64)
# ---------------------------------------------------------------------------

PARITY = {
    "sync_fused": ("sync", {}, (2, 4), {}),
    "sync_reference_block": ("sync", {}, (2, 4),
                             dict(kernel="reference", mask_kind="block")),
    "cohort": ("sync", UNIFORM, (3, 5), {}),
    "hex": ("sync", {}, (3, 4), dict(geometry=HEX, fp_rtol=0.0)),
    "two_tier": ("sync", {}, (3, 4), dict(cloud_period=2)),
    "async_stragglers": ("async", dict(straggler_prob=0.25), (2, 6), {}),
    "two_tier_async": ("async", dict(straggler_prob=0.25), (2, 6),
                       dict(cloud_period=2)),
}


# the control pass's input to each histogram, and its range's field
HIST_INPUTS = {
    "per_hist": ("per_range", lambda c, b_hz: c.sol.per),
    "rho_hist": ("rho_range", lambda c, b_hz: c.sol.prune),
    "bw_hist": ("bw_share_range", lambda c, b_hz: c.sol.bandwidth / b_hz),
    "latency_hist": ("latency_range_s", lambda c, b_hz: c.t_client),
    "sinr_hist": ("sinr_db_range", lambda c, b_hz: c.sinr_db),
}


def _near_edges(values: np.ndarray, lo: float, hi: float, bins: int
                ) -> np.ndarray:
    """Per row, how many values lie within rounding (1e-9 relative) of an
    interior bin edge: two summation orders may bin those apart."""
    edges = np.linspace(lo, hi, bins + 1)[1:-1]
    gap = np.abs(values[..., None] - edges)
    near = gap <= 1e-9 * np.maximum(np.abs(edges), 1.0)
    return near.any(-1).sum(-1)


@pytest.fixture(scope="module", params=sorted(PARITY))
def tel_pair(request):
    mode, schedule, topo, extra = PARITY[request.param]
    jcfg, tcfg = _configs(schedule, topo, extra)
    if mode == "async":
        kw = dict(buffer_size=6, max_staleness=3)
        jcfg = dataclasses.replace(jcfg,
                                   async_config=JSCHED.AsyncConfig(**kw))
        tcfg = dataclasses.replace(tcfg,
                                   async_config=TSCHED.AsyncConfig(**kw))
    jcfg = dataclasses.replace(jcfg, telemetry=JTEL.TelemetryConfig())
    tcfg = dataclasses.replace(tcfg, telemetry=TTEL.TelemetryConfig())
    ref = _reference(jcfg, mode=mode)
    sim = _port(tcfg, ref, mode=mode)
    got = sim.finalize(*sim.simulate(sim.params)).telemetry
    b_hz = tcfg.wireless.bandwidth_hz
    near = {name: np.stack([
        _near_edges(fn(sim.control(r), b_hz).numpy(),
                    *getattr(tcfg.telemetry, field), tcfg.telemetry.bins)
        for r in range(tcfg.rounds)])
        for name, (field, fn) in HIST_INPUTS.items()}
    return got, ref["result"].telemetry, near


def test_telemetry_matches_reference(tel_pair):
    """Histograms equal (a count may sit in the neighbouring bin only for
    a value within rounding of the edge between them), diagnostics at
    1e-6, gradient figures at 1e-5."""
    got, ref, near = tel_pair
    assert set(got) == set(ref)
    for name, v in ref.items():
        v = np.asarray(v)
        assert got[name].shape == v.shape, name
        if name in near:
            np.testing.assert_array_equal(got[name].sum(-1), v.sum(-1))
            moved = np.abs(got[name] - v).sum(-1)
            assert np.all(moved <= 2 * near[name]), (name, moved,
                                                     near[name])
        elif name.endswith("_hist") or name in ("solver_iters",
                                                "fp_iterations"):
            np.testing.assert_array_equal(got[name], v, err_msg=name)
        elif name.startswith("fp_"):
            np.testing.assert_allclose(got[name], v, rtol=1e-6,
                                       equal_nan=True, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], v, rtol=1e-5, atol=1e-12,
                                       err_msg=name)
