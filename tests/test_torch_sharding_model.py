"""The port's logical-axis constraints (``repro_torch.models.sharding``),
striped flash attention, and the ranking, masks and Eq. (5) on DTensor
leaves.

In this process: ``axis_size`` and ``constrain`` are no-ops without
rules, without a mesh or on a plain tensor, drop dims a rule's mesh dims
do not divide and leave the tensor alone when nothing survives (the
twins of ``tests/test_shardings_launch.py``'s two); ``flash_attention``
with rules installed on a (1, 4) mesh runs four query stripes and equals
the reference's unstriped output within 1e-5 in float32, ragged keys
included.  On four gloo ranks on the CPU (processes with a timeout): a
constrained DTensor takes the placements ``placements(spec)`` gives; a
dim sharded over ("pod", "data") holds the row-major chunk; and on
qwen2-7b's smoke width placed by ``param_shardings`` on a (1, 4) mesh,
``block_masks`` of the DTensor leaves is bitwise the unsharded masks at
block 16 (every shard boundary on a tile boundary: no leaf gathered) and
at block 128 (each leaf whose shards cut its tiles gathered, and
counted), one rate and a batch of two, with ``achieved_rate``,
``apply_masks`` and ``value_and_grad`` (grads placed as the params)
against their plain values; ``psum_aggregate`` over the client dim of a
(2, 2) mesh on sharded grads against the whole grads'; and C3: models
whose 3 heads the "model" dim of 2 does not divide (GQA, MLA, xLSTM),
their forward, loss and grads sharded on the (2, 2) mesh against the
unsharded ones; and C5: three decode steps on the (2, 2) mesh with the
cache placed by ``cache_shardings`` against the unsharded steps, every
returned cache leaf keeping its placements.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro_torch
from repro.models import attention as JA
from repro_torch.models import attention as TA
from repro_torch.models import sharding as MS

SRC = Path(repro_torch.__file__).resolve().parents[1]
CHILD_TIMEOUT = 180
WORLD = 4


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


# ---------------------------------------------------------------------------
# In process: no-ops and striped flash attention
# ---------------------------------------------------------------------------

def test_axis_size_and_constrain_no_rules():
    assert MS.axis_size("q_stripes") == 1      # no rules installed
    x = torch.ones((4, 4))
    assert MS.constrain(x, "batch", "embed") is x


def test_constrain_all_dropped_is_noop():
    """Rules without a mesh, and rules with a mesh on a plain tensor,
    leave the tensor alone; on a 16 x 16 mesh nothing divides a (3, 5)
    tensor, and ``axis_size`` reads the installed mesh."""
    x = torch.ones((3, 5))
    with MS.use_rules(dict(MS.DEFAULT_RULES), None):
        assert MS.axis_size("mlp") == 1
        assert MS.constrain(x, "batch", "mlp") is x
    with MS.use_rules(dict(MS.DEFAULT_RULES), FakeMesh(data=16, model=16)):
        assert MS.axis_size("mlp") == 16
        assert MS.axis_size("batch") == 16
        assert MS.axis_size("seq") == 1
        assert MS.constrain(x, "batch", "mlp") is x
    with MS.use_rules(dict(MS.DEFAULT_RULES),
                      FakeMesh(pod=2, data=16, model=16)):
        assert MS.axis_size("batch") == 32
    assert MS.get_rules() is None and MS.get_mesh() is None


@pytest.mark.parametrize("case", [
    # (s, t, causal, window, q_chunk, kv_chunk)
    (64, 64, True, None, 16, 16),
    (64, 64, True, 24, 512, 1024),
    (48, 48, True, None, 16, 32),        # ragged keys: 48 on chunks of 32
    (64, 40, False, None, 8, 16),        # cross attention, ragged keys
])
def test_striped_flash_attention_matches_reference(case):
    """Four query stripes (rules on a (1, 4) mesh) against the
    reference's flash attention without rules (one stripe), float32."""
    s, t, causal, window, qc, kc = case
    rng = np.random.default_rng(s + t)
    b, h, hkv, hd = 2, 4, 2, 8
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, hd)).astype(np.float32)
    want = np.asarray(JA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.35, causal=causal,
        window=window, q_chunk=qc, kv_chunk=kc))
    with MS.use_rules(dict(MS.DEFAULT_RULES), FakeMesh(data=1, model=4)):
        assert MS.axis_size("q_stripes") == 4
        got = TA.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), 0.35, causal=causal,
                                 window=window, q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Four gloo ranks on the CPU
# ---------------------------------------------------------------------------

_RANK = r"""
import pickle, sys
import torch
import torch.distributed as dist
rank, world, store, out = sys.argv[1:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)      # four ranks on the host's cores
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.core import aggregation, pruning
from repro_torch.launch import mesh as MESH
from repro_torch.launch import shardings as SH
from repro_torch.models import model as M
from repro_torch.models import sharding as MS
res = {}
# a constrained DTensor takes the spec's placements
mesh = MESH.make_mesh((2, 2), ("data", "model"), "cpu")
x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
dx = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                       src_data_rank=None)
with MS.use_rules(dict(MS.DEFAULT_RULES), mesh):
    y = MS.constrain(dx, "batch", "mlp")
    z = MS.constrain(dx, None, "seq")
res["constrained"] = (tuple(y.placements) ==
                      SH.placements(("data", "model"), mesh)
                      and torch.equal(y.full_tensor(), x) and z is dx)
# a dim over ("pod", "data"): the row-major chunk
pods = MESH.make_mesh((2, 2), ("pod", "data"), "cpu")
t = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
dt = distribute_tensor(t, pods, SH.placements((("pod", "data"), None), pods),
                       src_data_rank=None)
c = pods.get_coordinate()
at = c[0] * 2 + c[1]
res["row_major"] = torch.equal(dt.to_local(), t[2 * at:2 * at + 2])
# the ranking on qwen2-7b's smoke width over a (1, 4) mesh
cfg = get_config("qwen2-7b").smoke_variant()
params = M.init_params(cfg, torch.Generator().manual_seed(3))
flat = pruning.flatten(params)
tp = MESH.make_mesh((1, 4), ("data", "model"), "cpu")
specs = SH.leaves_like(SH.param_shardings(params, tp, fsdp=False), params)
dparams = pruning.unflatten(params, [
    distribute_tensor(p, tp, SH.placements(s, tp), src_data_rank=None)
    for p, s in zip(flat, specs)])
res["sharded_leaves"] = sum(any(e is not None for e in s) for s in specs)
rates = {"one": torch.tensor(0.4), "batch": torch.tensor([0.3, 0.6])}
for block in (16, 128):
    for label, rate in rates.items():
        pruning.block_norm_state.gathers = 0
        masks = pruning.block_masks(dparams, rate, block=block)
        gathers = pruning.block_norm_state.gathers
        want = pruning.block_masks(params, rate, block=block)
        mflat = pruning.flatten(masks)
        res[(block, label)] = {
            "gathers": gathers,
            "dtensor": all(isinstance(m, DTensor) for m in mflat),
            "equal": all(torch.equal(m.full_tensor(), w) for m, w in
                         zip(mflat, pruning.flatten(want))),
            "rate": pruning.achieved_rate(dparams, masks).tolist(),
            "want_rate": pruning.achieved_rate(params, want).tolist(),
        }
masks = pruning.block_masks(dparams, torch.tensor(0.4), block=16)
want = pruning.block_masks(params, torch.tensor(0.4), block=16)
res["apply"] = all(
    torch.equal(a.full_tensor(), b) for a, b in zip(
        pruning.flatten(pruning.apply_masks(dparams, masks)),
        pruning.flatten(pruning.apply_masks(params, want))))
res["ones"] = all(torch.equal(a.full_tensor(), b) for a, b in zip(
    pruning.flatten(pruning.ones_masks(dparams)),
    pruning.flatten(pruning.ones_masks(params))))
tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                       generator=torch.Generator().manual_seed(4))
from torch.distributed.tensor.experimental import implicit_replication
with implicit_replication():
    (loss, _), grads = pruning.value_and_grad(
        lambda p: M.loss_fn(cfg, p, {"tokens": tokens}), dparams)
(want_loss, _), want_grads = pruning.value_and_grad(
    lambda p: M.loss_fn(cfg, p, {"tokens": tokens}), params)
gflat = pruning.flatten(grads)
res["loss"] = (float(loss), float(want_loss), type(loss) is torch.Tensor)
res["grad_placements"] = all(
    tuple(g.placements) == tuple(p.placements)
    for g, p in zip(gflat, pruning.flatten(dparams)))
res["grad_rel"] = max(
    float((g.full_tensor() - w).abs().max() / w.abs().max().clamp_min(1e-30))
    for g, w in zip(gflat, pruning.flatten(want_grads)))
# Eq. (5) over the (2, 2) mesh's client dim, shard by shard: each
# client's grads on its two "model" ranks
from torch.distributed.tensor import Shard
inner = mesh["model"]
client = mesh.get_coordinate()[0]
gen = torch.Generator().manual_seed(10 + client)
whole = {"w": torch.randn((6, 8), generator=gen),
         "b": torch.randn((8,), generator=gen)}
sharded = {"w": distribute_tensor(whole["w"], inner, [Shard(1)],
                                  src_data_rank=None),
           "b": distribute_tensor(whole["b"], inner, [Replicate()],
                                  src_data_rank=None)}
group = mesh.get_group("data")
res["psum"] = []
for c_i in (torch.tensor(1.0), torch.tensor(float(client == 0)),
            torch.tensor(0.0)):
    k_i = torch.tensor(10.0 + client)
    agg = aggregation.psum_aggregate(sharded, k_i, c_i, group)
    plain = aggregation.psum_aggregate(whole, k_i, c_i, group)
    res["psum"].append(all(
        tuple(agg[key].placements) == tuple(sharded[key].placements)
        and torch.equal(agg[key].full_tensor(), plain[key])
        for key in whole))
# C3: 3 heads over a "model" dim of 2 (a head and a half a rank) in
# GQA, MLA and the xLSTM cells: the sharded forward, loss and grads on
# the (2, 2) mesh against the unsharded ones, with rules installed as the
# dry run installs them
import dataclasses
from concurrent.futures import ThreadPoolExecutor
smol, mla_cfg, xl = (get_config(n).smoke_variant() for n in
                     ("smollm-135m", "minicpm3-4b", "xlstm-125m"))
gqa = dataclasses.replace(smol, head_dim=48)
# (config, sequence length): 2,048 takes flash attention's query stripes
c3 = {"gqa": (gqa, 16), "gqa_flash": (gqa, 2048),
      # each repeat checkpointed on DTensors, as the full configs run
      "gqa_remat": (dataclasses.replace(gqa, remat="block"), 16),
      # and its backward on a thread without rules, as a card runs it
      "gqa_flash_remat_thread": (dataclasses.replace(gqa, remat="block"),
                                 2048),
      "mla": (dataclasses.replace(mla_cfg, num_heads=3, num_kv_heads=3,
                                  mla=dataclasses.replace(mla_cfg.mla,
                                                          num_heads=3)), 16),
      "xlstm": (dataclasses.replace(xl, d_model=96, num_heads=3,
                                    num_kv_heads=3, head_dim=32), 16)}
res["c3"] = {}
for label, (cfg3, seq3) in c3.items():
    p3 = M.init_params(cfg3, torch.Generator().manual_seed(5))
    specs3 = SH.leaves_like(SH.param_shardings(p3, mesh), p3)
    d3 = pruning.unflatten(p3, [
        distribute_tensor(p, mesh, SH.placements(s, mesh),
                          src_data_rank=None)
        for p, s in zip(pruning.flatten(p3), specs3)])
    tok3 = torch.randint(0, cfg3.vocab_size, (4, seq3),
                         generator=torch.Generator().manual_seed(6))
    dtok3 = distribute_tensor(tok3, mesh, SH.placements(
        SH.data_pspec(tuple(tok3.shape), mesh), mesh), src_data_rank=None)
    try:
        with MS.use_rules(dict(MS.DEFAULT_RULES), mesh), \
                implicit_replication():
            logits, _ = M.forward(cfg3, d3, dtok3)
            if label.endswith("_thread"):
                leaves3 = [p.detach().requires_grad_()
                           for p in pruning.flatten(d3)]
                loss3, _ = M.loss_fn(cfg3, pruning.unflatten(d3, leaves3),
                                     {"tokens": dtok3})
                def backward():
                    # a thread without the sharding rules; DTensor's
                    # implicit replication set, as the step sets it
                    with implicit_replication():
                        return torch.autograd.grad(
                            loss3, leaves3, allow_unused=True,
                            materialize_grads=True)
                with ThreadPoolExecutor(1) as pool:
                    grads3 = pool.submit(backward).result()
                loss3 = loss3.full_tensor()
            else:
                (loss3, _), grads3 = pruning.value_and_grad(
                    lambda p: M.loss_fn(cfg3, p, {"tokens": dtok3}), d3)
        want_logits, _ = M.forward(cfg3, p3, tok3)
        (want_loss3, _), want_grads3 = pruning.value_and_grad(
            lambda p: M.loss_fn(cfg3, p, {"tokens": tok3}), p3)
        res["c3"][label] = {
            "cut": sum(any(isinstance(pl, Shard) for pl in q.placements)
                       for q in pruning.flatten(d3)),
            "logits_err": float((logits.full_tensor() - want_logits)
                                .abs().max() / want_logits.abs().max()),
            "loss": (float(loss3), float(want_loss3)),
            # against the largest grad: the input gates' biases get ~1e-12
            # (exp(i - max(., i)) cancels them), float noise either way
            "grad_rel": max(
                float((g.full_tensor() - w).abs().max())
                for g, w in zip(pruning.flatten(grads3),
                                pruning.flatten(want_grads3)))
            / max(float(w.abs().max())
                  for w in pruning.flatten(want_grads3)),
        }
    except RuntimeError as e:
        res["c3"][label] = repr(e)
# C5: the decode step on the (2, 2) mesh, placed as the dry run places
# it (serving params, the cache at cache_shardings: batch rows over
# "data", cache slots over "model"), three steps from a random cache
# whose positions straddle the slot shards, against the unsharded steps
res["c5"] = {}
for name in ("qwen2-7b", "minicpm3-4b", "whisper-base", "recurrentgemma-2b"):
    cfg5 = get_config(name).smoke_variant()
    p5 = M.init_params(cfg5, torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    # 64 slots: the largest dim, so "model" takes them (32 a rank); the
    # positions cross slot 32 and reach the last slot's clamp
    cache5 = M.init_cache(cfg5, 4, 64, device="cpu")
    cache5 = {"pos": torch.tensor([30, 31, 62, 5]), "stages": pruning.tree_map(
        lambda a: (0.5 * torch.randn(a.shape, generator=gen)).to(a.dtype),
        cache5["stages"])}
    if cfg5.num_memory_tokens:
        cache5 = M.fill_cross_caches(cfg5, p5, cache5, torch.randn(
            (4, cfg5.num_memory_tokens, cfg5.memory_dim_), generator=gen))
    tok5 = torch.randint(0, cfg5.vocab_size, (3, 4, 1), generator=gen)

    def placed(tree, specs):
        return pruning.unflatten(tree, [
            distribute_tensor(a, mesh, SH.placements(sp, mesh),
                              src_data_rank=None)
            for a, sp in zip(pruning.flatten(tree),
                             SH.leaves_like(specs, tree))])
    d5 = placed(p5, SH.param_shardings(p5, mesh, fsdp=False))
    dc5 = placed(cache5, SH.cache_shardings(cache5, mesh))
    in_places = [tuple(a.placements) for a in pruning.flatten(dc5)]
    got5 = []
    with torch.no_grad():
        with MS.use_rules(dict(MS.DEFAULT_RULES), mesh), \
                implicit_replication():
            for t in range(3):
                dtok = distribute_tensor(tok5[t], mesh, SH.placements(
                    SH.data_pspec((4, 1), mesh), mesh), src_data_rank=None)
                logits5, dc5 = M.decode_step(cfg5, d5, dtok, dc5)
                got5.append(logits5.full_tensor())
        plain5 = cache5
        want5 = []
        for t in range(3):
            logits5, plain5 = M.decode_step(cfg5, p5, tok5[t], plain5)
            want5.append(logits5)
    leaves5 = pruning.flatten(dc5)
    res["c5"][name] = {
        "logits_err": max(float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(got5, want5)),
        "cache_err": max(
            float((g.full_tensor() - w).abs().max()
                  / w.abs().max().clamp_min(1e-30))
            for g, w in zip(leaves5, pruning.flatten(plain5))),
        "pos": torch.equal(dc5["pos"].full_tensor(), plain5["pos"]),
        "kept": [tuple(a.placements) == want
                 for a, want in zip(leaves5, in_places)],
        "rows_on_data": [a.placements[0] == Shard(1)
                         for a in pruning.flatten(dc5["stages"])],
        "slots_on_model": [a.placements[1] == Shard(2) for path, a in zip(
            SH.leaves_like(SH.cache_shardings(cache5, mesh), cache5),
            pruning.flatten(dc5)) if path[1:3] == ("data", "model")],
    }
with open(out, "wb") as f:
    pickle.dump(res, f)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(WORLD), str(tmp / "store"),
         str(tmp / f"rank{r}.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=CHILD_TIMEOUT)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_constrain_places_dtensor(world4):
    assert all(r["constrained"] for r in world4)


def test_multi_dim_entry_is_row_major(world4):
    """("pod", "data") over a (2, 2) mesh: rank (p, d) holds chunk
    2 p + d, the reference's row-major layout."""
    assert all(r["row_major"] for r in world4)


@pytest.mark.parametrize("rate", ["one", "batch"])
@pytest.mark.parametrize("block", [16, 128])
def test_masks_on_shards_bitwise(world4, block, rate):
    """DTensor masks, bitwise the unsharded ones on every rank; block 16
    gathers no leaf, block 128 gathers every leaf whose 32- or 64-wide
    shards cut its tiles; ``achieved_rate`` counts global elements."""
    for r in world4:
        got = r[(block, rate)]
        assert got["dtensor"] and got["equal"]
        assert got["rate"] == got["want_rate"]
        if block == 16:
            assert got["gathers"] == 0
        else:
            # embed (512 rows / 4) and unembed (512 columns / 4) keep
            # whole 128-tiles; every other sharded leaf is gathered
            assert got["gathers"] == r["sharded_leaves"] - 2


def test_apply_and_ones_masks_on_shards(world4):
    assert all(r["apply"] and r["ones"] for r in world4)


def test_value_and_grad_keeps_placements(world4):
    """Grads placed as their params, within 1e-5 of the unsharded grads;
    the loss a plain tensor equal to the unsharded loss within 1e-6."""
    for r in world4:
        got, want, plain = r["loss"]
        assert plain and got == pytest.approx(want, rel=1e-6)
        assert r["grad_placements"]
        assert r["grad_rel"] <= 1e-5


def test_psum_aggregate_on_shards(world4):
    """Eq. (5) over the client dim of a (2, 2) mesh on DTensor grads
    (arrivals [1, 1], [1, 0] and [0, 0]): shard by shard, bitwise the
    aggregate of the whole grads, placed as the grads."""
    assert all(all(r["psum"]) and len(r["psum"]) == 3 for r in world4)


@pytest.mark.parametrize("name", ["qwen2-7b", "minicpm3-4b", "whisper-base",
                                  "recurrentgemma-2b"])
def test_sharded_decode_keeps_cache_rows_local(world4, name):
    """C5: three decode steps on ("data" 2, "model" 2) with the cache at
    ``cache_shardings`` (batch rows over "data", cache slots over "model";
    GQA, MLA, cross attention and whisper's self attention, the RG-LRU's
    states and its local attention; 64 slots, so every attention cache is
    split over "model" on its slots, and each rank's softmax over its
    slots combines across "model"): logits and the new cache within
    1e-5 of the unsharded steps, and every returned cache leaf keeps its
    placements (its batch dim ``Shard(1)`` on "data"): each rank writes
    and attends its own rows and slots."""
    for r in world4:
        got = r["c5"][name]
        assert got["logits_err"] <= 1e-5
        assert got["cache_err"] <= 1e-5
        assert got["pos"]
        assert all(got["kept"]) and all(got["rows_on_data"])
        assert got["slots_on_model"] and all(got["slots_on_model"])


@pytest.mark.parametrize("label", ["gqa", "gqa_flash", "gqa_remat",
                                   "gqa_flash_remat_thread", "mla", "xlstm"])
def test_heads_the_model_dim_does_not_divide(world4, label):
    """C3: 3 heads over a "model" dim of 2, whose shards of the heads'
    features (the reference's specs) end in the middle of a head: GQA
    (smollm-135m's smoke width at head_dim 48; at 2,048 tokens too, where
    flash attention's query stripes shard the sequence over "model"; and
    with ``remat="block"``, each repeat checkpointed on DTensors, at 16
    tokens and at 2,048 with the backward run on a thread that holds no
    sharding rules, as autograd runs a card's backward: the recompute
    keeps the forward's rules, stripes and constraints), MLA
    (minicpm3-4b's) and the mLSTM and sLSTM cells (xlstm-125m's at
    d_model 96).  The head views replicate such shards first (DTensor
    refuses the view), products flatten their rows through the same
    views, and the recurrent time loops run on local batch rows.  The sharded forward
    and loss equal the unsharded ones within 1e-5, and the grads within
    1e-5 of the largest grad."""
    for r in world4:
        got = r["c3"][label]
        assert isinstance(got, dict), got
        assert got["cut"] > 0
        assert got["logits_err"] <= 1e-5
        loss, want = got["loss"]
        assert loss == pytest.approx(want, rel=1e-5)
        assert got["grad_rel"] <= 1e-5
