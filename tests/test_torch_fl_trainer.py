"""The mesh trainer (``repro_torch.federated.trainer``) and the collective
Eq. (5) (``core.aggregation.psum_aggregate``) against the JAX package.

At world 1 (a gloo group of one in this process): the twins of
``tests/test_fl_trainer.py``'s three step tests, and the step against
the reference's ``make_fl_train_step`` from the same params and tokens
(masks exactly equal, ``achieved_rho`` equal, params at 1e-5).  At world
2: the port on two gloo ranks in two processes (a ``FileStore`` under
the test's directory) against the reference's step on two host devices
(a process with ``--xla_force_host_platform_device_count=2``), with
arrivals [1, 1] and [1, 0]; both ranks must end with the same params.
``psum_aggregate`` at world 1 and 2 against ``aggregate`` on the stacked
gradients, the all-dropped case included.  The parity steps take lr 5 so
the update is not lost in the params' rounding.

At world 4, the tensor dim: qwen2-7b's smoke width in float32 (qkv
biases drawn N(0, 0.25), the init's are 0) through ``make_fl_train_step(tp_shard_params=True)`` on a
("data" 2, "model" 2) mesh of four gloo ranks, against the reference's
step on four host devices (its weights sharded over "model" by its
``in_shardings``): params at 1e-5, ``loss`` and ``achieved_rho`` at 1e-6;
every rank ending with the same params and the two ranks of each "model"
coordinate with bitwise equal shards; two chained steps and a block-128
step (its leaves' shards cut their tiles, so they are gathered for the
ranking) against the same mesh's unsharded step (``tp_shard_params=
False``), at 1e-5 with the same ``achieved_rho``; the first case's
sharded params through ``checkpoint.save`` (written whole, bitwise the
file of the params gathered, loading in the reference's ``restore``) and
``checkpoint.restore`` (each rank's local shards bitwise).
``fl_input_specs`` against the reference's on a duck-typed 16 x 16 mesh.
"""

import os
import pickle
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro_torch
from repro.configs import get_config as j_get_config
from repro.core import pruning as JPR
from repro.federated import trainer as JFT
from repro.launch import mesh as JMESH
from repro.models import model as JM
from repro_torch import weights
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import aggregation as TAGG
from repro_torch.core import pruning as TPR
from repro_torch.federated import trainer as TFT
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import steps as TST

SRC = Path(repro_torch.__file__).resolve().parents[1]
RTOL = 1e-5
BLOCK, PER_CLIENT, SEQ, PARITY_LR = 16, 2, 16, 5.0
RHO2, K2 = [0.3, 0.5], [40.0, 30.0]
ARRIVALS2 = ([1.0, 1.0], [1.0, 0.0])
CHILD_TIMEOUT = 180


@pytest.fixture(scope="module")
def setup():
    """smollm-135m's smoke width: the reference's params (numpy), the
    port's copy, a world-1 mesh on gloo and the port's step (lr 1e-2)."""
    jcfg = j_get_config("smollm-135m").smoke_variant()
    tcfg = t_get_config("smollm-135m").smoke_variant()
    npp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    mesh = TMESH.make_host_mesh(model=1, device="cpu")
    step = TFT.make_fl_train_step(tcfg, mesh, client_axes=("data",),
                                  block=BLOCK, lr=1e-2)
    return jcfg, tcfg, npp, weights.tree_from_numpy(npp, device="cpu"), \
        mesh, step


def _tokens(n, seed, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab, (n * PER_CLIENT, SEQ)).astype(np.int32)


def _vec(x):
    return torch.tensor(x, dtype=torch.float32)


def _rel(got, want) -> float:
    worst = 0.0
    for g, w in zip(TPR.flatten(got), jax.tree_util.tree_leaves(want)):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        worst = max(worst, float(np.max(np.abs(g - w)))
                    / max(float(np.max(np.abs(w))), 1e-30))
    return worst


# ---------------------------------------------------------------------------
# World 1: the twins of tests/test_fl_trainer.py, and parity
# ---------------------------------------------------------------------------

def test_fl_step_runs_and_updates(setup):
    _, tcfg, _, tp, mesh, step = setup
    n = TFT.num_clients(mesh, ("data",))
    assert n == 1 and TFT.client_index(mesh, ("data",)) == 0
    tokens = torch.as_tensor(_tokens(n, 1, tcfg.vocab_size))
    new, metrics = step(tp, {"tokens": tokens}, _vec([0.3] * n),
                        _vec([1.0] * n), _vec([40.0] * n))
    assert bool(torch.isfinite(metrics["loss"]))
    assert metrics["achieved_rho"].shape == (n,)
    assert float(metrics["achieved_rho"][0]) == pytest.approx(0.3, abs=0.15)
    delta = sum(float(torch.sum(torch.abs(a - b)))
                for a, b in zip(TPR.flatten(new), TPR.flatten(tp)))
    assert delta > 0.0


def test_fl_step_dropped_packet_freezes_params(setup):
    """All arrivals zero: the BS skips the update (Eq. 5's drop rule),
    bit for bit."""
    _, _, _, tp, mesh, step = setup
    n = TFT.num_clients(mesh, ("data",))
    tokens = torch.zeros((n * PER_CLIENT, SEQ), dtype=torch.int64)
    new, _ = step(tp, {"tokens": tokens}, _vec([0.0] * n), _vec([0.0] * n),
                  _vec([40.0] * n))
    for a, b in zip(TPR.flatten(new), TPR.flatten(tp)):
        assert torch.equal(a, b)


def test_fl_step_zero_rho_matches_unpruned_grad(setup):
    """rho = 0: the FL step is FedSGD on the dense model
    (``make_train_step``'s update) at 1e-5."""
    _, tcfg, _, tp, mesh, step = setup
    n = TFT.num_clients(mesh, ("data",))
    tokens = torch.as_tensor(_tokens(n, 2, tcfg.vocab_size))
    new, _ = step(tp, {"tokens": tokens}, _vec([0.0] * n), _vec([1.0] * n),
                  _vec([40.0] * n))
    expect, _ = TST.make_train_step(tcfg, 1e-2)(tp, {"tokens": tokens})
    for a, b in zip(TPR.flatten(new), TPR.flatten(expect)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=1e-6)


def test_mesh_builders_at_world_1(setup):
    """The builders' shapes and dim names over a world of one, the
    production shapes and rank counts equal to the reference's, and the
    production mesh refused on fewer ranks than it needs."""
    assert (TMESH.SINGLE_POD, TMESH.MULTI_POD) == (JMESH.SINGLE_POD,
                                                   JMESH.MULTI_POD)
    for multi in (False, True):
        assert TMESH.required_devices(multi) == JMESH.required_devices(multi)
        with pytest.raises(RuntimeError, match="needs"):
            TMESH.make_production_mesh(multi_pod=multi, device="cpu")
    host = TMESH.make_host_mesh(model=1, device="cpu")
    fleet = TMESH.make_fleet_mesh(device="cpu")
    assert (host.mesh_dim_names, tuple(host.shape)) == (("data", "model"),
                                                        (1, 1))
    assert (fleet.mesh_dim_names, tuple(fleet.shape)) == (("cells", "data"),
                                                          (1, 1))
    pods = TMESH.make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
    assert TFT.num_clients(pods, ("pod", "data")) == 1
    assert TFT.client_index(pods, ("pod", "data")) == 0
    assert TFT.client_group(pods, ("pod", "data")) is not None


def test_fl_step_matches_reference_at_world_1(setup):
    """The reference's step on its one-device host mesh and the port's on
    its world of one, from the same params and tokens: the masks equal,
    ``achieved_rho`` equal, loss and params at 1e-5."""
    jcfg, tcfg, npp, tp, mesh, _ = setup
    tokens = _tokens(1, 3, tcfg.vocab_size)
    jparams = jax.tree.map(jnp.asarray, npp)
    jmasks = JPR.block_masks(jparams, jnp.float32(0.3), block=BLOCK)
    tmasks = TPR.block_masks(tp, torch.tensor(0.3), block=BLOCK)
    for a, b in zip(TPR.flatten(tmasks), jax.tree_util.tree_leaves(jmasks)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jstep = JFT.make_fl_train_step(jcfg, JMESH.make_host_mesh(model=1),
                                   client_axes=("data",), block=BLOCK,
                                   lr=PARITY_LR)
    tstep = TFT.make_fl_train_step(tcfg, mesh, client_axes=("data",),
                                   block=BLOCK, lr=PARITY_LR)
    jnew, jm = jstep(jparams, {"tokens": jnp.asarray(tokens)},
                     jnp.full((1,), 0.3), jnp.ones((1,)),
                     jnp.full((1,), 40.0))
    tnew, tm = tstep(tp, {"tokens": torch.as_tensor(tokens)}, _vec([0.3]),
                     _vec([1.0]), _vec([40.0]))
    assert tm["achieved_rho"].tolist() == \
        np.asarray(jm["achieved_rho"]).tolist()
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
    assert _rel(tnew, jnew) <= RTOL


def test_psum_aggregate_world_1_matches_aggregate(setup):
    mesh = setup[4]
    group = TFT.client_group(mesh, ("data",))
    rng = np.random.default_rng(4)
    grads = {"w": torch.as_tensor(rng.normal(size=(3, 4)), dtype=torch.float32),
             "b": [torch.as_tensor(rng.normal(size=(5,)),
                                   dtype=torch.float32)]}
    for c in (1.0, 0.0):
        got = TAGG.psum_aggregate(grads, torch.tensor(30.0), torch.tensor(c),
                                  group)
        want = TAGG.aggregate(TPR.tree_map(lambda g: g[None], grads),
                              _vec([30.0]), _vec([c]))
        for a, b in zip(TPR.flatten(got), TPR.flatten(want)):
            assert torch.equal(a, b)
        if c == 0.0:
            assert all(not a.any() for a in TPR.flatten(got))


def test_psum_aggregate_promotes_like_jax(setup):
    """A bfloat16 gradient times a float32 weight sums in float32, as
    JAX's promotion of the two does."""
    group = TFT.client_group(setup[4], ("data",))
    g = {"w": torch.ones((2, 2), dtype=torch.bfloat16)}
    got = TAGG.psum_aggregate(g, torch.tensor(40.0), torch.tensor(1.0), group)
    assert got["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# World 2: two gloo ranks against the reference on two host devices
# ---------------------------------------------------------------------------

_PORT_RANK = """
import pickle, sys
import torch
import torch.distributed as dist
rank, world, store, inp, out = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.core import aggregation, pruning
from repro_torch.federated import trainer as FT
from repro_torch.launch import mesh as MESH
with open(inp, "rb") as f:
    data = pickle.load(f)
cfg = get_config("smollm-135m").smoke_variant()
params = weights.tree_from_numpy(data["params"], device="cpu")
mesh = MESH.make_host_mesh(model=1, device="cpu")
n, me = FT.num_clients(mesh, ("data",)), FT.client_index(mesh, ("data",))
step = FT.make_fl_train_step(cfg, mesh, ("data",), block=data["block"],
                             lr=data["lr"])
vec = lambda x: torch.tensor(x, dtype=torch.float32)
res = {"n": n, "me": me, "steps": [], "psum": []}
for arrivals in data["arrivals"]:
    new, m = step(params, {"tokens": torch.as_tensor(data["tokens"])},
                  vec(data["rho"]), vec(arrivals), vec(data["k"]))
    res["steps"].append({"params": [a.numpy() for a in pruning.flatten(new)],
                         "loss": float(m["loss"]),
                         "achieved_rho": m["achieved_rho"].tolist()})
group = FT.client_group(mesh, ("data",))
for arrivals in data["psum_arrivals"]:
    local = weights.tree_from_numpy(data["grads"][me], device="cpu")
    got = aggregation.psum_aggregate(local, vec(data["k"][me]),
                                     vec(arrivals[me]), group)
    res["psum"].append([a.numpy() for a in pruning.flatten(got)])
with open(out, "wb") as f:
    pickle.dump(res, f)
dist.barrier()
dist.destroy_process_group()
"""

_REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.federated import trainer as FT
from repro.launch import mesh as MESH
inp, out = sys.argv[1:3]
with open(inp, "rb") as f:
    data = pickle.load(f)
cfg = get_config("smollm-135m").smoke_variant()
mesh = MESH.make_host_mesh(model=1)
assert FT.num_clients(mesh, ("data",)) == 2
step = FT.make_fl_train_step(cfg, mesh, ("data",), block=data["block"],
                             lr=data["lr"])
params = jax.tree.map(jnp.asarray, data["params"])
res = []
for arrivals in data["arrivals"]:
    new, m = step(params, {"tokens": jnp.asarray(data["tokens"])},
                  jnp.asarray(data["rho"], jnp.float32),
                  jnp.asarray(arrivals, jnp.float32),
                  jnp.asarray(data["k"], jnp.float32))
    res.append({"params": [jax.device_get(a) for a in jax.tree.leaves(new)],
                "loss": float(m["loss"]),
                "achieved_rho": [float(x) for x in m["achieved_rho"]]})
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def _start(code, args, env):
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait_all(procs):
    """Every process's (rc, stderr); a process past its timeout is killed
    and fails the test."""
    outs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=CHILD_TIMEOUT)
            outs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    """One run of each side: the port's two ranks and the reference's two
    devices, started together, on the same inputs."""
    _, tcfg, npp, _, _, _ = setup
    tmp = tmp_path_factory.mktemp("world2")
    rng = np.random.default_rng(6)
    grads = [{"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32)]}
             for _ in range(2)]
    data = {"params": npp, "tokens": _tokens(2, 7, tcfg.vocab_size),
            "rho": RHO2, "k": K2, "arrivals": ARRIVALS2, "block": BLOCK,
            "lr": PARITY_LR, "grads": grads,
            "psum_arrivals": ([1.0, 1.0], [1.0, 0.0], [0.0, 0.0])}
    inp = tmp / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    procs = [_start(_REFERENCE, [inp, tmp / "ref.pkl"], env)] + [
        _start(_PORT_RANK, [r, 2, tmp / "store", inp, tmp / f"rank{r}.pkl"],
               env) for r in range(2)]
    for rc, err in _wait_all(procs):
        assert rc == 0, err[-3000:]
    out = {}
    for name in ("ref", "rank0", "rank1"):
        with open(tmp / f"{name}.pkl", "rb") as f:
            out[name] = pickle.load(f)
    return data, out


def test_world2_ranks_agree(world2):
    _, out = world2
    r0, r1 = out["rank0"], out["rank1"]
    assert (r0["n"], r0["me"], r1["n"], r1["me"]) == (2, 0, 2, 1)
    for s0, s1 in zip(r0["steps"], r1["steps"]):
        assert s0["loss"] == s1["loss"]
        assert s0["achieved_rho"] == s1["achieved_rho"]
        for a, b in zip(s0["params"], s1["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", range(len(ARRIVALS2)))
def test_world2_matches_reference(world2, case):
    """rho [0.3, 0.5], k [40, 30]: ``achieved_rho`` equal, loss and params
    at 1e-5, for arrivals [1, 1] and [1, 0]."""
    data, out = world2
    got, want = out["rank0"]["steps"][case], out["ref"][case]
    assert got["achieved_rho"] == want["achieved_rho"]
    assert got["achieved_rho"][0] == pytest.approx(0.3, abs=0.15)
    assert got["achieved_rho"][1] == pytest.approx(0.5, abs=0.15)
    assert got["loss"] == pytest.approx(want["loss"], rel=RTOL)
    worst = max(float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))
                for a, b in zip(got["params"], want["params"]))
    assert worst <= RTOL
    before = jax.tree_util.tree_leaves(data["params"])
    assert any(not np.array_equal(a, b) for a, b in zip(got["params"],
                                                        before))


@pytest.mark.parametrize("case", range(3))
def test_psum_aggregate_world_2_matches_aggregate(world2, case):
    data, out = world2
    arrivals = data["psum_arrivals"][case]
    stacked = weights.tree_from_numpy(
        {"w": np.stack([g["w"] for g in data["grads"]]),
         "b": [np.stack([g["b"][0] for g in data["grads"]])]}, device="cpu")
    want = TAGG.aggregate(stacked, _vec(data["k"]), _vec(arrivals))
    for rank in ("rank0", "rank1"):
        for a, b in zip(out[rank]["psum"][case], TPR.flatten(want)):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=0)
    if case == 2:
        assert all(not np.any(a) for a in out["rank0"]["psum"][case])


# ---------------------------------------------------------------------------
# World 4: the tensor dim, four gloo ranks against four host devices
# ---------------------------------------------------------------------------

_TP_RANK = r"""
import os, pickle, sys
import torch
import torch.distributed as dist
rank, world, store, inp, out = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from torch.distributed.tensor import DTensor
from repro_torch import checkpoint, weights
from repro_torch.configs import get_config
from repro_torch.core import pruning
from repro_torch.federated import trainer as FT
from repro_torch.launch import mesh as MESH
with open(inp, "rb") as f:
    data = pickle.load(f)
cfg = get_config("qwen2-7b").smoke_variant()
params = weights.tree_from_numpy(data["params"], device="cpu")
mesh = MESH.make_host_mesh(data=2, model=2, device="cpu")
vec = lambda x: torch.tensor(x, dtype=torch.float32)
tokens = {"tokens": torch.as_tensor(data["tokens"])}


def whole(tree):
    return [(a.full_tensor() if isinstance(a, DTensor) else a).numpy()
            for a in pruning.flatten(tree)]


def run(step, start, arrivals, steps=1):
    p, ms = start, []
    for _ in range(steps):
        p, m = step(p, tokens, vec(data["rho"]), vec(arrivals),
                    vec(data["k"]))
        ms.append({"loss": float(m["loss"]),
                   "achieved_rho": m["achieved_rho"].tolist()})
    return p, ms


res = {"coord": mesh.get_coordinate(), "cases": [], "chain": {},
       "block128": {}}
tp = FT.make_fl_train_step(cfg, mesh, ("data",), block=data["block"],
                           lr=data["lr"], tp_shard_params=True)
stepped = []
for arrivals in data["arrivals"]:
    new, ms = run(tp, params, arrivals)
    stepped.append(new)
    res["cases"].append({
        "params": whole(new), "metrics": ms[0],
        "local": [a.to_local().numpy() for a in pruning.flatten(new)],
        "placements": [tuple(a.placements) for a in pruning.flatten(new)]})
# checkpoints of the first case's sharded params: written collectively,
# and, by rank 0 alone, the same params gathered whole as plain tensors
ckpt = os.path.join(os.path.dirname(out), "ckpt")
first = stepped[0]
checkpoint.save(os.path.join(ckpt, "sharded.npz"), first)
gathered = pruning.tree_map(lambda a: a.full_tensor(), first)
if rank == 0:
    checkpoint.save(os.path.join(ckpt, "whole.npz"), gathered)
back = checkpoint.restore(os.path.join(ckpt, "sharded.npz"), first)
res["restored"] = [
    isinstance(b, DTensor) and b.device_mesh == a.device_mesh
    and tuple(b.placements) == tuple(a.placements)
    and torch.equal(b.to_local(), a.to_local())
    for a, b in zip(pruning.flatten(first), pruning.flatten(back))]
res["first"] = whole(first)
for sharded in (True, False):
    step = FT.make_fl_train_step(cfg, mesh, ("data",), block=data["block"],
                                 lr=data["chain_lr"],
                                 tp_shard_params=sharded)
    new, ms = run(step, params, [1.0, 1.0], steps=2)
    res["chain"][sharded] = {"params": whole(new), "metrics": ms}
    step = FT.make_fl_train_step(cfg, mesh, ("data",), block=128,
                                 lr=data["chain_lr"],
                                 tp_shard_params=sharded)
    pruning.block_norm_state.gathers = 0
    new, ms = run(step, params, [1.0, 1.0])
    res["block128"][sharded] = {"params": whole(new), "metrics": ms,
                                "gathers": pruning.block_norm_state.gathers}
with open(out, "wb") as f:
    pickle.dump(res, f)
dist.barrier()
dist.destroy_process_group()
"""

_TP_REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.federated import trainer as FT
from repro.launch import mesh as MESH
inp, out = sys.argv[1:3]
with open(inp, "rb") as f:
    data = pickle.load(f)
cfg = get_config("qwen2-7b").smoke_variant()
mesh = MESH.make_host_mesh(model=2)
assert dict(mesh.shape) == {"data": 2, "model": 2}
step = FT.make_fl_train_step(cfg, mesh, ("data",), block=data["block"],
                             lr=data["lr"], tp_shard_params=True)
params = jax.tree.map(jnp.asarray, data["params"])
res = []
for arrivals in data["arrivals"]:
    new, m = step(params, {"tokens": jnp.asarray(data["tokens"])},
                  jnp.asarray(data["rho"], jnp.float32),
                  jnp.asarray(arrivals, jnp.float32),
                  jnp.asarray(data["k"], jnp.float32))
    res.append({"params": [jax.device_get(a) for a in jax.tree.leaves(new)],
                "loss": float(m["loss"]),
                "achieved_rho": [float(x) for x in m["achieved_rho"]]})
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One run of each side on qwen2-7b's smoke width: the port's four
    ranks and the reference's four devices, started together."""
    tmp = tmp_path_factory.mktemp("world4")
    jcfg = j_get_config("qwen2-7b").smoke_variant()
    npp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(1)))
    rng = np.random.default_rng(9)
    for name in ("wq", "wk", "wv"):   # the init leaves the qkv biases 0
        attn = npp["stages"][0]["b0"]["attn"][name]
        attn["b"] = (0.5 * rng.normal(size=attn["b"].shape)).astype(
            np.float32)
    data = {"params": npp, "tokens": _tokens(2, 8, jcfg.vocab_size),
            "rho": RHO2, "k": K2, "arrivals": ARRIVALS2, "block": BLOCK,
            "lr": PARITY_LR, "chain_lr": 0.5}
    inp = tmp / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    procs = [_start(_TP_REFERENCE, [inp, tmp / "ref.pkl"], env)] + [
        _start(_TP_RANK, [r, 4, tmp / "store", inp, tmp / f"rank{r}.pkl"],
               env) for r in range(4)]
    for rc, err in _wait_all(procs):
        assert rc == 0, err[-3000:]
    out = {"ckpt": tmp / "ckpt"}
    for name in ("ref", "rank0", "rank1", "rank2", "rank3"):
        with open(tmp / f"{name}.pkl", "rb") as f:
            out[name] = pickle.load(f)
    return data, out


def _worst_rel(got, want) -> float:
    return max(float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))
               for a, b in zip(got, want))


def test_tensor_dim_runs_and_matches_unsharded(world4):
    """The tensor dim runs: the step's params come back as DTensors
    sharded over "model" (replicated over the client dim), and two
    chained sharded steps equal the unsharded step on the same mesh at
    1e-5, ``achieved_rho`` equal."""
    _, out = world4
    for r in range(4):
        got = out[f"rank{r}"]
        sharded = [p for p in got["cases"][0]["placements"]
                   if any(pl.is_shard() for pl in p)]
        assert sharded and all(p[0].is_replicate() for p in sharded)
        tp, rep = got["chain"][True], got["chain"][False]
        for a, b in zip(tp["metrics"], rep["metrics"]):
            assert a["achieved_rho"] == b["achieved_rho"]
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
        assert _worst_rel(tp["params"], rep["params"]) <= RTOL


@pytest.mark.parametrize("case", range(len(ARRIVALS2)))
def test_world4_matches_reference(world4, case):
    """rho [0.3, 0.5], k [40, 30], arrivals [1, 1] and [1, 0], lr 5:
    params at 1e-5, loss and ``achieved_rho`` at 1e-6."""
    data, out = world4
    want = out["ref"][case]
    got = out["rank0"]["cases"][case]
    assert got["metrics"]["achieved_rho"] == pytest.approx(
        want["achieved_rho"], abs=1e-6)
    assert got["metrics"]["loss"] == pytest.approx(want["loss"], rel=1e-6)
    assert _worst_rel(got["params"], want["params"]) <= RTOL
    before = jax.tree_util.tree_leaves(data["params"])
    assert any(not np.array_equal(a, b) for a, b in zip(got["params"],
                                                        before))


def test_world4_ranks_agree(world4):
    """Every rank ends with the same params and metrics; the two ranks of
    each "model" coordinate (one a client) hold bitwise equal shards."""
    _, out = world4
    ranks = [out[f"rank{r}"] for r in range(4)]
    by_model = {}
    for r in ranks:
        by_model.setdefault(r["coord"][1], []).append(r)
    assert sorted(len(v) for v in by_model.values()) == [2, 2]
    for case in range(len(ARRIVALS2)):
        for r in ranks[1:]:
            assert r["cases"][case]["metrics"] ==                 ranks[0]["cases"][case]["metrics"]
            for a, b in zip(r["cases"][case]["params"],
                            ranks[0]["cases"][case]["params"]):
                np.testing.assert_array_equal(a, b)
        for pair in by_model.values():
            for a, b in zip(pair[0]["cases"][case]["local"],
                            pair[1]["cases"][case]["local"]):
                np.testing.assert_array_equal(a, b)


def test_world4_block128_gathers_and_matches(world4):
    """Block 128 at the smoke width: the sharded step gathers the leaves
    whose shards cut their tiles (the unsharded one gathers none) and
    equals the unsharded step at 1e-5, ``achieved_rho`` equal."""
    _, out = world4
    for r in range(4):
        tp, rep = (out[f"rank{r}"]["block128"][k] for k in (True, False))
        assert tp["gathers"] > 0 and rep["gathers"] == 0
        assert tp["metrics"][0]["achieved_rho"] ==             rep["metrics"][0]["achieved_rho"]
        assert _worst_rel(tp["params"], rep["params"]) <= RTOL


def test_checkpoint_of_sharded_params_is_written_whole(world4):
    """``checkpoint.save`` of the sharded step's DTensor params (every
    rank calling it, rank 0 writing): the same arrays, byte for byte, as
    the file of the params gathered whole, loading in the reference's
    ``restore`` with the values of the gathered params."""
    from repro import checkpoint as JCK
    data, out = world4
    sharded = zipfile.ZipFile(out["ckpt"] / "sharded.npz")
    whole = zipfile.ZipFile(out["ckpt"] / "whole.npz")
    assert sorted(sharded.namelist()) == sorted(whole.namelist())
    for name in whole.namelist():
        assert sharded.read(name) == whole.read(name), name
    back = JCK.restore(str(out["ckpt"] / "sharded.npz"), data["params"])
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(out["rank0"]["first"])
    for a, b in zip(got, out["rank0"]["first"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_checkpoint_restores_local_shards(world4):
    """``checkpoint.restore`` into the sharded params: DTensors on their
    mesh with their placements, each rank's local shard bitwise."""
    _, out = world4
    for r in range(4):
        restored = out[f"rank{r}"]["restored"]
        assert restored and all(restored)


def test_fl_input_specs_match_reference(monkeypatch):
    """Tokens and the per-client vectors on ``meta``, every spec over the
    client dims, as the reference's on a 16 x 16 and a 2 x 16 x 16 mesh."""
    class FakeMesh:
        def __init__(self, **axes):
            self.shape = dict(axes)
            self.axis_names = tuple(axes)

    monkeypatch.setattr(JFT, "NamedSharding", lambda mesh, spec: spec)
    jcfg = j_get_config("qwen2-7b")
    tcfg = t_get_config("qwen2-7b")
    for mesh, caxes in ((FakeMesh(data=16, model=16), ("data",)),
                        (FakeMesh(pod=2, data=16, model=16),
                         ("pod", "data"))):
        jb, jv, js = JFT.fl_input_specs(jcfg, mesh, caxes, 8, 128)
        tb, tv, ts = TFT.fl_input_specs(tcfg, mesh, caxes, 8, 128)
        assert tuple(tb["tokens"].shape) == jb["tokens"].shape
        assert tb["tokens"].dtype == torch.int32
        assert tuple(tv.shape) == jv.shape and tv.device.type == "meta"
        assert ts[0] == {"tokens": tuple(js[0]["tokens"])}
        assert list(ts[1:]) == [tuple(x) for x in js[1:]]
