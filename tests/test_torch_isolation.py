"""The port stands alone: importing every module of ``repro_torch`` pulls
in neither JAX nor anything of the JAX package ``repro``."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

SRC = Path(repro_torch.__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(len(names))
assert not leaked, leaked
"""


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_modules())


def test_package_covers_the_slice_modules():
    expected = {"core.closed_form", "core.wireless", "core.convergence",
                "core.pruning", "core.aggregation", "models.mlp", "kernels.block_norms",
                "kernels.fleet_fused", "fleet.topology", "fleet.scheduler",
                "fleet.solver", "fleet.task", "fleet.engine", "weights",
                "configs", "configs.base", "configs.smollm_135m",
                "models.layers", "models.attention", "models.blocks",
                "models.model", "kernels.block_sparse_matmul",
                "kernels.decode_attention", "kernels.flash_prefill",
                "kernels.ops", "checkpoint", "serve", "serve.export",
                "serve.sparse", "serve.model", "serve.engine",
                "fleet.telemetry", "core.tradeoff", "data", "data.synthetic",
                "data.tokens",
                "federated", "federated.client", "federated.server",
                "federated.system", "federated.trainer", "optimizers",
                "launch", "launch.steps", "launch.mesh", "launch.train",
                "examples", "examples.quickstart",
                "examples.tradeoff_playground", "examples.train_federated",
                "examples.fleet_sim", "examples.pruned_llm_federated",
                "examples.serve_pruned"}
    assert {f"repro_torch.{m}" for m in expected} <= set(_modules())
