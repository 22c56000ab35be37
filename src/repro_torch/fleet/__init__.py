"""Fleet-scale FL simulation engine (single tier, sync and async).

Batched multi-cell channels (``topology``: orthogonal cells), the
closed-form trade-off solver batched over cells (``solver``), the
scheduler's masks, cohorts and async arrivals (``scheduler``), the
synthetic MLP task (``task``) and the round and event loops (``engine``).
"""

from repro_torch.fleet.engine import (  # noqa: F401
    AsyncState, FleetConfig, FleetResult, GeneratorDraws, InjectedDraws,
    RoundDraws, SimStart, build_simulation, resolve_task, run, run_fleet,
    time_to_loss)
from repro_torch.fleet.scheduler import AsyncConfig, ScheduleConfig  # noqa: F401
from repro_torch.fleet.solver import SolverConfig  # noqa: F401
from repro_torch.fleet.task import FleetTask, SyntheticMLPTask  # noqa: F401
from repro_torch.fleet.topology import (  # noqa: F401
    FleetTopology, OrthogonalCells)
