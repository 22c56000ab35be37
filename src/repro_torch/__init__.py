"""PyTorch + CUDA port of the fleet engine (the JAX package ``repro`` is
the reference it is tested against).

It carries the paper's main path, one synchronous pruned-FedSGD fleet
round (``fleet.run_fleet(cfg, mode="sync")`` with ``kernel="fused"``), the
fleet engine's other paths and tasks, the host reference path
(``federated``), the llama-family models with their dense decode and MoE
(``models``, ``configs``) and block-sparse serving (``serve``), with every
Pallas kernel of the reference written in CUDA for Hopper
(``kernels/csrc``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper uses its plain
PyTorch version.
"""

from repro_torch.fleet import (  # noqa: F401
    FleetConfig, FleetResult, FleetTopology, OrthogonalCells,
    ScheduleConfig, SolverConfig, SyntheticMLPTask, build_simulation,
    run_fleet)
