"""PyTorch + CUDA port of the fleet engine (the JAX package ``repro`` is
the reference it is tested against).

This slice carries the paper's main path: one synchronous pruned-FedSGD
fleet round (``fleet.run_fleet(cfg, mode="sync")`` with ``kernel="fused"``,
orthogonal cells, full participation, the synthetic MLP task), with the
fused pruned-gradient kernel and the tile-norm kernel written in CUDA for
Hopper (``kernels/csrc``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper uses its plain
PyTorch version.
"""

from repro_torch.fleet import (  # noqa: F401
    FleetConfig, FleetResult, FleetTopology, OrthogonalCells,
    ScheduleConfig, SolverConfig, SyntheticMLPTask, build_simulation,
    run_fleet)
