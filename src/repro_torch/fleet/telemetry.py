"""Fleet telemetry: per-round summaries, trace spans, sinks.

The port of ``repro.fleet.telemetry``.  Three layers, all opt-in
(``FleetConfig(telemetry=...)`` is None by default, and a run without it
computes exactly what it computed before this module existed):

* **Per-round summaries** — ``TelemetryConfig`` selects fixed-size
  summaries that the engine adds to each round's (or event's) metrics
  under the ``tel_`` prefix: per-cell static-bin histograms of PER /
  SINR / latency / rho / bandwidth share (``histogram``), the async
  staleness distribution, gradient-norm and mask-density drift, and the
  solver's diagnostics (Algorithm-1 alternations, the interference fixed
  point's residual trajectory).  Every summary stays a device tensor
  until ``Simulation.finalize`` stacks the rounds: no value of them
  crosses to the host inside a round.
* **Trace spans** — ``SpanRecorder`` records named host wall-clock spans
  (build / simulate / finalize) as Chrome-trace JSON, and enters each in
  ``torch.profiler.record_function``, so a ``torch.profiler`` capture
  groups its events by span.  Inside a round the engine's phases
  (``fleet.channel``, ``fleet.solve``, ``fleet.gradient``,
  ``fleet.merge``, ``fleet.eval``, ``fleet.cloud_merge``) are
  ``record_function`` scopes too.
* **Sinks** — the ``TelemetrySink`` protocol (``emit(record)`` /
  ``close()``) with in-memory, JSONL and CSV implementations; the engine
  and the host reference path emit per-round records through
  ``emit_result``.  Pure Python and numpy, copied from the reference.

Histograms on the card repeat bit for bit: unweighted counts are an
integer scatter-add (exact in any order) and the weighted form is a
one-hot product, a fixed-order sum.  A control pass's five histograms go
through one stacked call (``histograms``), and nothing in a summary is
copied from the host, so telemetry adds launches to a round but no sync.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import os
import threading
import time
from typing import Any, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import pruning

__all__ = ["PREFIX", "TelemetryConfig", "bin_edges", "histogram",
           "histograms",
           "control_summaries", "grad_summaries", "tree_sq_norm",
           "staleness_summary", "split_metrics", "SpanRecorder",
           "TelemetrySink", "MemorySink", "JSONLSink", "CSVSink",
           "sink_for_path", "round_records", "emit_result"]

PREFIX = "tel_"


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static knobs of the per-round telemetry.

    Every histogram has ``bins`` equal-width bins over a static
    ``*_range``; values outside it clip into the edge bins, so each
    histogram's mass is exactly the number of clients it counts.
    ``per_range`` / ``rho_range`` / ``bw_share_range`` are probabilities
    and fractions; ``sinr_db_range`` the uplink SINR in dB (clients with
    no allocation, SINR +inf, land in the top bin); ``latency_range_s``
    the realized round latency in seconds.  ``staleness_bins`` buckets
    the async merge age over [0, max_staleness + 1).  ``solver`` adds the
    Algorithm-1 alternation counts and, under interference, the fixed
    point's iterations and residuals; ``gradients`` the aggregated
    gradient's L2 norm and the scheduled mean of 1 - rho.
    """

    bins: int = 16
    per_range: tuple[float, float] = (0.0, 1.0)
    rho_range: tuple[float, float] = (0.0, 1.0)
    bw_share_range: tuple[float, float] = (0.0, 1.0)
    sinr_db_range: tuple[float, float] = (-20.0, 60.0)
    latency_range_s: tuple[float, float] = (0.0, 10.0)
    staleness_bins: int = 8
    solver: bool = True
    gradients: bool = True

    def __post_init__(self):
        if self.bins < 1:
            raise ValueError(f"bins must be >= 1, got {self.bins}")
        if self.staleness_bins < 1:
            raise ValueError(
                f"staleness_bins must be >= 1, got {self.staleness_bins}")
        for name in ("per_range", "rho_range", "bw_share_range",
                     "sinr_db_range", "latency_range_s"):
            lo, hi = getattr(self, name)
            if not hi > lo:
                raise ValueError(f"{name} must satisfy hi > lo, got "
                                 f"({lo}, {hi})")


def bin_edges(lo: float, hi: float, bins: int) -> np.ndarray:
    """The ``bins + 1`` static bin edges of a telemetry histogram."""
    return np.linspace(lo, hi, bins + 1)


# ---------------------------------------------------------------------------
# Per-round summaries (device tensors, no host sync)
# ---------------------------------------------------------------------------

def _positions(x: torch.Tensor, lo: float, hi: float, bins: int
               ) -> torch.Tensor:
    """Where ``x`` falls on the bin axis, (x - lo) bins / (hi - lo), in
    ``x``'s float dtype (the reference's arithmetic for in-range values)."""
    dtype = x.dtype if x.is_floating_point() else torch.get_default_dtype()
    return (x.to(dtype) - lo) * (bins / (hi - lo))


def _counts(pos: torch.Tensor, bins: int,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Histogram over the last axis of bin positions: bin floor(pos),
    clipped into [0, bins - 1], NaN in bin 0 (what clipping x into [lo,
    hi] first gives).  Unweighted counts are an integer scatter-add into
    row-offset bins (O(N), exact in any order); ``weights`` turn counts
    into mass through a one-hot product, a sum in a fixed order."""
    pos = torch.nan_to_num(pos, nan=0.0, posinf=float(bins), neginf=0.0)
    idx = torch.clamp(torch.floor(pos), 0, bins - 1).to(torch.int64)
    lead = tuple(pos.shape[:-1])
    if weights is not None:
        onehot = torch.nn.functional.one_hot(idx, bins).to(pos.dtype)
        w = weights.to(pos.dtype)
        return torch.matmul(w.unsqueeze(-2), onehot).squeeze(-2)
    n = pos.shape[-1] if pos.ndim else 1
    rows = int(np.prod(lead)) if lead else 1
    flat = idx.reshape(rows, n) + (torch.arange(
        rows, device=pos.device) * bins)[:, None]
    counts = torch.zeros(rows * bins, dtype=torch.int64,
                         device=pos.device).scatter_add_(
        0, flat.reshape(-1), torch.ones_like(flat.reshape(-1)))
    return counts.to(pos.dtype).reshape(lead + (bins,))


def histogram(x: torch.Tensor, lo: float, hi: float, bins: int,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Static-bin histogram over the last axis: (..., I) -> (..., bins),
    in ``x``'s float dtype.

    NaN counts in the bottom bin, -inf and +inf clip into the edge bins
    with every other out-of-range value, so the unweighted mass of a row
    is exactly its element count; ``weights`` (shaped like ``x``) turn
    counts into weighted mass.
    """
    return _counts(_positions(x, lo, hi, bins), bins, weights)


def histograms(xs, ranges, bins: int) -> tuple:
    """``histogram`` of each same-shaped tensor of ``xs`` over its own
    ``(lo, hi)`` of ``ranges``, in one stacked call (a handful of
    launches for all of them); each equals its ``histogram``."""
    return _counts(torch.stack([_positions(x, lo, hi, bins) for x, (lo, hi)
                                in zip(xs, ranges)]), bins).unbind(0)


def control_summaries(tcfg: TelemetryConfig, sol, t_client: torch.Tensor,
                      sinr_db: Optional[torch.Tensor],
                      bandwidth_hz: float) -> dict[str, torch.Tensor]:
    """Per-cell histograms and solver diagnostics of one control pass.

    ``sol`` is a ``fleet.solver.CellSolution``; ``t_client`` the realized
    (C, I) latency; ``sinr_db`` the realized uplink SINR in dB (None
    skips its histogram).  Every histogram counts every client, so a
    cell's mass is I whatever the schedule.
    """
    inputs = {
        "per_hist": (sol.per, tcfg.per_range),
        "rho_hist": (sol.prune, tcfg.rho_range),
        "bw_hist": (sol.bandwidth / bandwidth_hz, tcfg.bw_share_range),
        "latency_hist": (t_client, tcfg.latency_range_s),
    }
    if sinr_db is not None:
        inputs["sinr_hist"] = (sinr_db, tcfg.sinr_db_range)
    hists = histograms([v for v, _ in inputs.values()],
                       [r for _, r in inputs.values()], tcfg.bins)
    out = {PREFIX + name: h for name, h in zip(inputs, hists)}
    if tcfg.solver:
        out[PREFIX + "solver_iters"] = sol.iterations
        for name in ("fp_iterations", "fp_residual", "fp_residuals"):
            if getattr(sol, name) is not None:
                out[PREFIX + name] = getattr(sol, name)
    return out


def grad_summaries(tcfg: TelemetryConfig, grad_sq_sum: torch.Tensor,
                   mask_density: torch.Tensor) -> dict[str, torch.Tensor]:
    """Gradient-norm and mask-density drift (``tcfg.gradients``)."""
    if not tcfg.gradients:
        return {}
    return {PREFIX + "grad_norm": torch.sqrt(grad_sq_sum),
            PREFIX + "mask_density": mask_density}


def tree_sq_norm(tree) -> torch.Tensor:
    """Sum of squares over every leaf of a params tree (a 0-d tensor in
    the widest float dtype of its leaves), leaves in ``flatten`` order."""
    leaves = pruning.flatten(tree)
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    total = torch.zeros((), dtype=dtype, device=leaves[0].device)
    for leaf in leaves:
        total = total + torch.sum(torch.square(leaf.to(dtype)))
    return total


def staleness_summary(tcfg: TelemetryConfig, tau: torch.Tensor,
                      max_staleness: int, dtype: torch.dtype
                      ) -> dict[str, torch.Tensor]:
    """Histogram of the merged buffer's staleness (server versions), in
    ``dtype``."""
    hist = histogram(tau.to(dtype), 0.0, float(max_staleness + 1),
                     tcfg.staleness_bins)
    return {PREFIX + "staleness_hist": hist}


def split_metrics(metrics: dict) -> tuple[dict, Optional[dict]]:
    """Split a metrics dict into (core metrics, telemetry dict or None);
    the telemetry dict is keyed without the ``tel_`` prefix."""
    core = {k: v for k, v in metrics.items() if not k.startswith(PREFIX)}
    tel = {k[len(PREFIX):]: v for k, v in metrics.items()
           if k.startswith(PREFIX)}
    return core, (tel or None)


# ---------------------------------------------------------------------------
# Trace spans (host wall clock; Chrome-trace JSON)
# ---------------------------------------------------------------------------

class SpanRecorder:
    """Record named wall-clock spans; export them as Chrome-trace JSON.

    Each ``span`` also enters ``torch.profiler.record_function(name)``,
    so a ``torch.profiler`` capture that is active groups the span's
    events under its name.  Spans may nest; events carry the thread id.
    Timestamps are microseconds from the recorder's construction.
    """

    def __init__(self):
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self.events: list[dict] = []

    @contextlib.contextmanager
    def span(self, name: str, **args):
        start = time.perf_counter()
        with torch.profiler.record_function(name):
            try:
                yield self
            finally:
                end = time.perf_counter()
                event = {
                    "name": name, "ph": "X", "cat": "fleet",
                    "ts": (start - self._t0) * 1e6,
                    "dur": (end - start) * 1e6,
                    "pid": os.getpid(), "tid": threading.get_ident(),
                }
                if args:
                    event["args"] = args
                with self._lock:
                    self.events.append(event)

    def chrome_trace(self) -> dict:
        """The ``chrome://tracing`` / Perfetto JSON document."""
        return {"traceEvents": sorted(self.events, key=lambda e: e["ts"]),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
        return path


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------

@runtime_checkable
class TelemetrySink(Protocol):
    """Anything that accepts flat telemetry records: ``emit`` takes one
    JSON-serializable dict a call (a run header, then one record a round
    or event), ``close`` flushes and releases; records may differ in
    their keys."""

    def emit(self, record: dict) -> None: ...

    def close(self) -> None: ...


class MemorySink:
    """Collect records in a list (tests, notebooks)."""

    def __init__(self):
        self.records: list[dict] = []
        self.closed = False

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        self.closed = True


class JSONLSink:
    """One JSON object per line."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class CSVSink:
    """Flat CSV: a row a record, the header the union of every record's
    keys (rows are written on ``close``); list and dict fields are
    JSON-encoded into their cell."""

    def __init__(self, path: str):
        self.path = path
        self._rows: list[dict] = []
        self._fields: list[str] = []
        self._closed = False

    def emit(self, record: dict) -> None:
        flat = {k: (json.dumps(v) if isinstance(v, (list, dict)) else v)
                for k, v in record.items()}
        for k in flat:
            if k not in self._fields:
                self._fields.append(k)
        self._rows.append(flat)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fields, restval="")
            writer.writeheader()
            for row in self._rows:
                writer.writerow(row)


def sink_for_path(path: str) -> TelemetrySink:
    """A file sink by extension: ``.csv`` -> CSV, anything else JSONL."""
    return CSVSink(path) if path.endswith(".csv") else JSONLSink(path)


# ---------------------------------------------------------------------------
# Emission: FleetResult -> per-round records
# ---------------------------------------------------------------------------

def _jsonable(v: Any):
    a = np.asarray(v)
    if a.ndim == 0:
        return a.item()
    return a.tolist()


def round_records(result, meta: Optional[dict] = None):
    """Yield the run header (``kind: "run"``: mode, rounds, the bound and
    any ``meta``) and then a record a round or event (``kind: "round"``:
    the scalar trajectories and, with telemetry, that round's summaries
    as nested lists) of a ``FleetResult``."""
    header = {"kind": "run", "mode": result.mode,
              "rounds": int(np.asarray(result.losses).shape[0]),
              "bound_final": float(result.bound_final)}
    if meta:
        header.update(meta)
    yield header

    scalars = {
        "loss": result.losses, "accuracy": result.accuracy,
        "round_latency": result.latencies, "mean_prune": result.mean_prune,
        "mean_per": result.mean_per, "participants": result.participants,
        "wall_clock": result.wall_clock, "staleness": result.staleness,
    }
    tel = getattr(result, "telemetry", None) or {}
    n = int(np.asarray(result.losses).shape[0])
    for rnd in range(n):
        rec = {"kind": "round", "round": rnd}
        for k, v in scalars.items():
            if v is not None:
                rec[k] = _jsonable(np.asarray(v)[rnd])
        for k, v in tel.items():
            arr = np.asarray(v)
            rec[k] = _jsonable(arr[rnd]) if arr.ndim and arr.shape[0] == n \
                else _jsonable(arr)
        yield rec


def emit_result(result, sink: TelemetrySink, meta: Optional[dict] = None,
                close: bool = False) -> int:
    """Emit a run's records through ``sink``; returns the record count."""
    n = 0
    for rec in round_records(result, meta=meta):
        sink.emit(rec)
        n += 1
    if close:
        sink.close()
    return n
