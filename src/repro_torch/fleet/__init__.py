"""Fleet-scale FL simulation engine (single and two tier, sync and async).

Batched multi-cell channels (``topology``: orthogonal cells, or hex cells
with co-channel interference, mobility and handover), the closed-form
trade-off solver batched over cells with its interference fixed point
(``solver``), the scheduler's masks, cohorts and async arrivals
(``scheduler``), the tasks with their per-client data (``task``: the
synthetic MLP, a llama-family causal LM, least squares), the round and event loops (``engine``) and the opt-in
telemetry: per-round summaries, trace spans and sinks (``telemetry``).
"""

from repro_torch.fleet.engine import (  # noqa: F401
    AsyncState, ClientData, FleetConfig, FleetResult, GeneratorDraws,
    InjectedDraws, RoundDraws, SimStart, build_simulation, resolve_geometry,
    resolve_task, run, run_fleet, time_to_loss)
from repro_torch.fleet.scheduler import AsyncConfig, ScheduleConfig  # noqa: F401
from repro_torch.fleet.solver import SolverConfig  # noqa: F401
from repro_torch.fleet.task import (  # noqa: F401
    TASKS, FleetTask, LinearRegressionTask, SyntheticMLPTask, TransformerTask,
    make_task)
from repro_torch.fleet.telemetry import (  # noqa: F401
    CSVSink, JSONLSink, MemorySink, SpanRecorder, TelemetryConfig,
    TelemetrySink, emit_result, sink_for_path)
from repro_torch.fleet.topology import (  # noqa: F401
    FleetTopology, HexInterference, OrthogonalCells, make_geometry)
