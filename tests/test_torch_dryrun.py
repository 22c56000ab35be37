"""The port's cost model and dry run (``repro_torch.launch.cost``,
``launch.dryrun``, ``launch.diagnose``) against what the reference's
``hlo_cost`` and dry run hold.

In this process, on plain CPU tensors (no group): a matmul's flops and
bytes, a Python loop over stacked weights counted once a repeat (views
free, each slice charged once: the twins of ``tests/test_hlo_cost.py``'s
matmul and scan cases) and the live-memory peak.  In one child process
on a fake 16 x 16 group of 256 ranks (a fake default group cannot share
a process with the suite's other groups): a sharded matmul's local flops
counted once, 2MNK/16, where ``FlopCounterMode`` adds the global product
too; and the collectives' counts and ring bytes by kind, with their
groups' sizes (the twins of ``test_hlo_cost.py``'s collective and
group-size cases and of ``tests/test_substrate.py``'s
``test_collective_stats_parsing``).  Through the command line, as
``tests/test_dryrun_cli.py`` runs the reference's: two combos print
``OK`` and ``0 failed``, and ``--fleet`` exits 0 with rank 0's block and
gradient slice equal to the meshless values.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.launch import cost as COST

SRC = Path(repro_torch.__file__).resolve().parents[1]
CHILD_TIMEOUT = 240


def _counted(fn, *args):
    with COST.CostMode() as counted:
        out = fn(*args)
    return counted, out


# ---------------------------------------------------------------------------
# In process: plain tensors
# ---------------------------------------------------------------------------

def test_single_matmul_flops_and_bytes():
    m = 128
    x, w = torch.ones((m, m)), torch.ones((m, m))
    counted, _ = _counted(lambda a, b: a @ b, x, w)
    assert counted.cost.flops == 2 * m ** 3
    assert counted.cost.hbm_bytes == 3 * m * m * 4     # two reads, a write
    assert counted.cost.collective_bytes == 0


@pytest.mark.parametrize("layers", [2, 8])
def test_python_loop_counts_every_repeat(layers):
    """A loop over stacked weights (the port's stage loop): each repeat's
    product is counted, the unbind's views charge nothing, and each
    slice is read once: weight traffic is the stack's bytes, not a
    stack a repeat."""
    m = 64
    ws = torch.ones((layers, m, m))

    def f(x, stack):
        for w in torch.unbind(stack):
            x = x @ w
        return x

    counted, _ = _counted(f, torch.ones((m, m)), ws)
    assert counted.cost.flops == layers * 2 * m ** 3
    assert counted.cost.hbm_bytes == layers * 3 * m * m * 4


def test_elementwise_ops_charge_bytes_not_flops():
    """Only products carry flops (``torch.utils.flop_counter``); every
    non-view op charges its operands and results."""
    m = 256
    counted, _ = _counted(lambda x: torch.sum(torch.tanh(x) * x),
                          torch.ones((m, m)))
    assert counted.cost.flops == 0
    assert counted.cost.hbm_bytes == (2 + 3) * m * m * 4 + m * m * 4 + 4


def test_peak_counts_live_storages_once():
    """Views share their base's storage; a freed temporary leaves the
    live sum, so the peak is the largest live set."""
    n = 1 << 16

    def f(x):
        a = x * 2                     # live: a
        v = a.view(-1)[: n // 2]      # a view: no new storage
        b = v + 1                     # live: a, b
        del a, v
        c = b * 3                     # live: b, c
        return c

    counted, out = _counted(f, torch.ones((n,)))
    assert counted.peak_bytes == n * 4 + (n // 2) * 4
    del out


# ---------------------------------------------------------------------------
# A child process on a fake 16 x 16 group
# ---------------------------------------------------------------------------

_CHILD = r"""
import pickle, sys
import torch
import torch.distributed as dist
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.launch.cost import CostMode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.utils.flop_counter import FlopCounterMode
DR.fake_group(256)
mesh = MESH.make_production_mesh(device="cpu")
res = {}
m, k, n = 64, 4096, 4096
with FakeTensorMode():
    x = distribute_tensor(torch.empty(m, k), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    w = distribute_tensor(torch.empty(k, n), mesh, [Replicate(), Replicate()],
                          src_data_rank=None)
    with CostMode() as counted:
        y = x @ w
    res["sharded_flops"] = counted.cost.flops
    res["sharded_placements"] = tuple(y.placements) == (Shard(0), Replicate())
    with FlopCounterMode(display=False) as fc:
        x @ w
    res["flop_counter"] = fc.get_total_flops()
    # collectives: DTensor's redistributions and torch.distributed's calls
    r = 1024 * 4
    t = distribute_tensor(torch.empty(1024 * 16), mesh, [Replicate(), Shard(0)],
                          src_data_rank=None)
    pp = DTensor.from_local(torch.empty(1024), mesh, [Replicate(), Partial()])
    with CostMode() as counted:
        t.redistribute(mesh, [Replicate(), Replicate()])          # all-gather
        pp.redistribute(mesh, [Replicate(), Replicate()])         # all-reduce
    res["dtensor"] = (counted.cost.collective_counts,
                      counted.cost.collective_op_bytes)
    with CostMode() as counted:
        pp.redistribute(mesh, [Replicate(), Shard(0)])           # reduce-scatter
    res["reduce_scatter"] = (counted.cost.collective_counts,
                             counted.cost.collective_op_bytes)
    model = mesh.get_group("model")
    with CostMode() as counted:
        dist.all_reduce(torch.empty(1024))                        # world, 256
        dist.all_reduce(torch.empty(1024), group=model)           # 16
        dist.broadcast(torch.empty(1024), src=0)                  # permute
        dist.all_to_all_single(torch.empty(1024 * 16), torch.empty(1024 * 16),
                               group=model)
    res["c10d"] = (counted.cost.collective_counts,
                   counted.cost.collective_op_bytes,
                   counted.cost.collective_bytes)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""


_CLI = {
    "decode": ["--arch", "smollm-135m", "--shape", "decode_32k"],
    "multi_pod": ["--arch", "xlstm-125m", "--shape", "long_500k",
                  "--multi-pod"],
    "fleet": ["--fleet"],
}


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The cost child and the three command lines, started together:
    {name: (returncode, stdout, stderr)}, and the child's pickle under
    "fake256"."""
    out = tmp_path_factory.mktemp("fake256") / "res.pkl"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    argv = {"child": ["-c", _CHILD, str(out)]}
    argv.update({name: ["-m", "repro_torch.launch.dryrun", *args]
                 for name, args in _CLI.items()})
    procs = {name: subprocess.Popen(
        [sys.executable, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for name, args in argv.items()}
    done = {}
    try:
        for name, proc in procs.items():
            so, se = proc.communicate(timeout=CHILD_TIMEOUT)
            done[name] = (proc.returncode, so, se)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    rc, _, err = done["child"]
    assert rc == 0, err[-3000:]
    with open(out, "rb") as f:
        done["fake256"] = pickle.load(f)
    return done


@pytest.fixture(scope="module")
def fake256(children):
    return children["fake256"]


def test_sharded_matmul_counted_once(fake256):
    """x (64, 4096) sharded 16 ways on "data" @ w (4096, 4096): rank 0's
    local product, 2MNK/16, once; ``FlopCounterMode`` counts the
    DTensor product's global 2MNK (and on some torch builds the local
    product on top)."""
    m, k, n = 64, 4096, 4096
    assert fake256["sharded_flops"] == 2 * m * k * n / 16
    assert fake256["sharded_placements"]
    assert fake256["flop_counter"] in (2 * m * k * n,
                                       2 * m * k * n + 2 * m * k * n / 16)


def test_dtensor_collectives_ring_bytes(fake256):
    """A Shard -> Replicate over "model" (16) is an all-gather of the
    16 KB whole, R(g-1)/g; Partial -> Replicate an all-reduce,
    2R(g-1)/g; Partial -> Shard a reduce-scatter of a 256-byte result,
    R(g-1)."""
    counts, by_op = fake256["dtensor"]
    r = 1024 * 4
    assert counts == {"all-gather": 1, "all-reduce": 1}
    assert by_op["all-gather"] == 16 * r * 15 / 16
    assert by_op["all-reduce"] == 2 * r * 15 / 16
    counts, by_op = fake256["reduce_scatter"]
    assert counts == {"reduce-scatter": 1}
    assert by_op["reduce-scatter"] == (r / 16) * 15


def test_c10d_collectives_by_group_size(fake256):
    """torch.distributed's calls: the all-reduce's group size from its
    group (the world's 256, "model"'s 16), a broadcast as a permute of
    R, an all-to-all R(g-1)/g."""
    counts, by_op, total = fake256["c10d"]
    r = 1024 * 4
    assert counts == {"all-reduce": 2, "collective-permute": 1,
                      "all-to-all": 1}
    assert by_op["all-reduce"] == 2 * r * 255 / 256 + 2 * r * 15 / 16
    assert by_op["collective-permute"] == r
    assert by_op["all-to-all"] == 16 * r * 15 / 16
    assert total == sum(by_op.values())


# ---------------------------------------------------------------------------
# The command line, in processes of its own (started by ``children``)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["decode", "multi_pod"])
def test_dryrun_cli_smoke(children, name):
    rc, out, err = children[name]
    assert rc == 0, out + err[-3000:]
    assert "0 failed" in out
    assert "OK" in out


def test_dryrun_cli_fleet(children):
    rc, out, err = children["fleet"]
    assert rc == 0, out + err[-3000:]
    assert "OK   fleet dry-run on 512 fake ranks" in out
    assert "2 cells a block, one all-gather, rank 0's block bitwise" in out
    assert "64 clients a shard, one all-reduce, rank 0's sum equal" in out
