"""Where remat is decided for the two training paths of a
``TransformerTask``.

The FL step (``federated.trainer.make_fl_train_step``) trains the model
as given, its ``remat`` included, as the reference's does: the task's
``config`` equals the reference's ``TransformerTask(arch=cfg).config()``
in ``remat``.  The fleet engine's clients train without remat: the task
``build_simulation`` runs is ``client_task()``, the same model at
``remat="none"``.  Under ``launch.cost.CostMode`` (one child process on a
fake group of four ranks, ("data" 2, "model" 2): a fake default group
cannot share a process with the suite's other groups) the FL step's peak
at a smoke width is lower with ``"block"`` than with ``"none"``.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch
from repro_torch.configs import get_config as t_get_config
from repro_torch.fleet import FleetConfig, FleetTopology, build_simulation
from repro_torch.fleet import task as TTASK

try:
    from repro.configs import get_config as j_get_config
    from repro.fleet import task as JTASK
except ImportError:
    JTASK = None
needs_jax = pytest.mark.skipif(JTASK is None, reason="needs the JAX reference")

SRC = Path(repro_torch.__file__).resolve().parents[1]
CHILD_TIMEOUT = 240


def _block(get, name="qwen2-7b"):
    return get(name).smoke_variant().replace(remat="block")


@needs_jax
@pytest.mark.parametrize("name", ["qwen2-7b", "recurrentgemma-2b"])
def test_fl_step_trains_the_models_remat(name):
    """``TransformerTask(arch=cfg).config()``, what ``make_fl_train_step``
    trains, keeps ``remat="block"``, as the reference's does; a named
    arch's smoke reduction keeps its ``"none"`` on both sides."""
    ours = TTASK.TransformerTask(arch=_block(t_get_config, name)).config()
    theirs = JTASK.TransformerTask(arch=_block(j_get_config, name)).config()
    assert ours.remat == theirs.remat == "block"
    assert TTASK.TransformerTask(arch_name=name).config().remat == \
        JTASK.TransformerTask(arch_name=name).config().remat == "none"


def test_fleet_clients_train_without_remat():
    """The engine's task is ``client_task()``: the same model and fields at
    ``remat="none"``; a task already at ``"none"`` is its own."""
    cfg = _block(t_get_config)
    task = TTASK.TransformerTask(arch=cfg, pool_clients=2)
    client = task.client_task()
    assert client.config() == cfg.replace(remat="none")
    assert (client.seq_len, client.local_batch, client.block) == \
        (task.seq_len, task.local_batch, task.block)
    assert client.client_task() is client
    plain = TTASK.SyntheticMLPTask()
    assert plain.client_task() is plain
    sim = build_simulation(FleetConfig(
        topology=FleetTopology(num_cells=1, clients_per_cell=2), rounds=1,
        task=task), device="cpu")
    assert sim.task.config().remat == "none"
    assert sim.cfg.task.config().remat == "block"


_CHILD = r"""
import pickle, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, StageSpec
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.models import sharding as MS
DR.fake_group(4)
mesh = MESH.make_host_mesh(data=2, model=2, device="cpu")
base = get_config("smollm-135m").smoke_variant()
base = base.replace(stages=(StageSpec(8, base.stages[0].blocks),))
shape = InputShape("fl_smoke", 256, 4, "train")
res = {}
for remat in ("none", "block"):
    spec = DR._fl_spec(base.replace(remat=remat), shape, mesh)
    counted, arg_bytes, _ = DR.trace(spec, mesh, dict(MS.DEFAULT_RULES))
    res[remat] = (arg_bytes + counted.peak_bytes, counted.cost.flops)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""


def test_fl_step_peak_falls_with_block_remat(tmp_path):
    """Eight repeats of smollm-135m's smoke block, two clients of 2 x 256
    tokens, each client's weights over "model" 2: the FL step's peak a
    rank (arguments + live) at least 2x lower with ``"block"``, for more
    flops (the recompute ran)."""
    out = tmp_path / "res.pkl"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        res = pickle.load(f)
    (none_peak, none_flops), (block_peak, block_flops) = \
        res["none"], res["block"]
    assert block_peak * 2 <= none_peak, res
    assert block_flops > none_flops, res
