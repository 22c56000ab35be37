"""The training launcher: ``repro_torch.launch`` against ``repro.launch``.

``decode_window`` and ``shape_supported`` over every config and input
shape; ``batch_specs`` and ``cache_specs`` (``meta`` tensors) against the
reference's ``ShapeDtypeStruct``s at full width, leaf for leaf; the three
step builders from the reference's params at the smoke widths of
smollm-135m, olmoe-1b-7b (its auxiliary loss) and whisper-base (its
memory) at 1e-5; the host step (each optimizer after clipping) over 3
steps of the same ``TokenStream`` batches against the reference
launcher's jitted closure at 1e-5 (Adam's m and v row by row, its
params wherever the rows' measured gradient gap cannot move the step
further); and the command line on the CPU (``--device cpu``): the
reference's line formats, the ``--fl`` path over a world of one and
over a launcher's world of two gloo ranks, ``--ckpt`` restoring what
the run trained, ``--production`` tracing its combo's step in a process
of its own.
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optimizers as JOPT
from repro.configs import ARCH_NAMES, INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.data import tokens as JTOK
from repro.launch import steps as JST
from repro.models import model as JM
from repro_torch import checkpoint, optimizers, weights
from repro_torch.configs import INPUT_SHAPES as T_INPUT_SHAPES
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import pruning
from repro_torch.data import tokens as TTOK
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TRAIN
from repro_torch.models import model as TM

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL = 1e-5
STEP_ARCHS = ("smollm-135m", "olmoe-1b-7b", "whisper-base")
B, S, LR = 2, 12, 0.5


def _rel(got, want) -> float:
    """max |got - want| over max |want|, leaf by leaf, the worst."""
    worst = 0.0
    for g, w in zip(pruning.flatten(got), jax.tree_util.tree_leaves(want)):
        g = g.detach().to(torch.float64).numpy()
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape
        worst = max(worst, float(np.max(np.abs(g - w)))
                    / max(float(np.max(np.abs(w))), 1e-30))
    return worst


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_window_and_support_match_reference(name):
    jc, tc = j_get_config(name), t_get_config(name)
    for s, shape in T_INPUT_SHAPES.items():
        assert TST.decode_window(tc, shape) == \
            JST.decode_window(jc, INPUT_SHAPES[s]), (name, s)
        assert TST.shape_supported(tc, shape) == \
            JST.shape_supported(jc, INPUT_SHAPES[s]), (name, s)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_specs_match_reference_at_full_width(name):
    """Every supported shape: the batch's and the cache's leaves in
    flatten order with the reference's shapes and dtypes, all on
    ``meta``; the cache's positions are int64 (torch's index type) where
    the reference's are int32."""
    jc, tc = j_get_config(name), t_get_config(name)
    for s, shape in T_INPUT_SHAPES.items():
        if not TST.shape_supported(tc, shape):
            continue
        jshape = INPUT_SHAPES[s]
        jb, tb = JST.batch_specs(jc, jshape), TST.batch_specs(tc, shape)
        assert sorted(tb) == sorted(jb)
        for key in jb:
            assert tb[key].device.type == "meta"
            assert tuple(tb[key].shape) == jb[key].shape, (name, s, key)
            assert _dtype(tb[key]) == str(jb[key].dtype), (name, s, key)
        jcache = JST.cache_specs(jc, jshape)
        tcache = TST.cache_specs(tc, shape)
        assert tcache["pos"].dtype == torch.int64
        assert jcache["pos"].dtype == jnp.int32
        jl = jax.tree_util.tree_leaves(jcache["stages"])
        tl = pruning.flatten(tcache["stages"])
        assert len(tl) == len(jl)
        assert tcache["pos"].shape == jcache["pos"].shape
        for t, j in zip(tl + [tcache["pos"]], jl + [jcache["pos"]]):
            assert t.device.type == "meta"
        assert [tuple(t.shape) for t in tl] == [j.shape for j in jl]
        assert [_dtype(t) for t in tl] == [str(j.dtype) for j in jl]


@pytest.fixture(scope="module", params=STEP_ARCHS)
def arch(request):
    """(reference cfg, port cfg, params as numpy, port params, numpy
    tokens and memory) at the smoke width."""
    name = request.param
    jcfg = j_get_config(name).smoke_variant()
    tcfg = t_get_config(name).smoke_variant()
    npp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    mem = (rng.normal(size=(B, tcfg.num_memory_tokens, tcfg.memory_dim_))
           .astype(np.float32) if tcfg.num_memory_tokens else None)
    return jcfg, tcfg, npp, weights.tree_from_numpy(npp, device="cpu"), \
        toks, mem


def _batches(toks, mem):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    if mem is not None:
        jb["memory"], tb["memory"] = jnp.asarray(mem), torch.as_tensor(mem)
    return jb, tb


def test_train_step_matches_reference(arch):
    jcfg, tcfg, npp, tp, toks, mem = arch
    jb, tb = _batches(toks, mem)
    jp, jm = JST.make_train_step(jcfg, LR)(jax.tree.map(jnp.asarray, npp), jb)
    got, tm = TST.make_train_step(tcfg, LR)(tp, tb)
    assert _rel(got, jp) <= RTOL
    for key in ("loss", "moe_aux"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=RTOL,
                                               abs=1e-7)
    if jcfg.moe is not None:
        assert float(tm["moe_aux"]) > 0.0
    assert not any(leaf.requires_grad for leaf in pruning.flatten(got))


def test_prefill_step_matches_reference(arch):
    jcfg, tcfg, npp, tp, toks, mem = arch
    jb, tb = _batches(toks, mem)
    jl, jaux = JST.make_prefill_step(jcfg)(jax.tree.map(jnp.asarray, npp), jb)
    tl, taux = TST.make_prefill_step(tcfg)(tp, tb)
    assert tl.shape == (B, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=RTOL * float(np.max(np.abs(jl))))
    assert float(taux) == pytest.approx(float(jaux), rel=RTOL, abs=1e-7)


def test_serve_step_matches_reference(arch):
    """Four serve steps from a fresh cache (a memory model's cross caches
    filled first): logits and the cache at 1e-5."""
    jcfg, tcfg, npp, tp, toks, mem = arch
    jparams = jax.tree.map(jnp.asarray, npp)
    jcache = JM.init_cache(jcfg, B, S)
    tcache = TM.init_cache(tcfg, B, S, device="cpu")
    if mem is not None:
        jcache = JM.fill_cross_caches(jcfg, jparams, jcache, jnp.asarray(mem))
        tcache = TM.fill_cross_caches(tcfg, tp, tcache, torch.as_tensor(mem))
    jstep = JST.make_serve_step(jcfg, None)
    tstep = TST.make_serve_step(tcfg, None)
    for t in range(4):
        jl, jcache = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jcache)
        tl, tcache = tstep(tp, torch.as_tensor(toks[:, t:t + 1]), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=RTOL * float(np.max(np.abs(jl))))
    assert _rel(tcache["stages"], jcache["stages"]) <= RTOL
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def _reference_host_step(cfg, opt, lr):
    """The reference launcher's jitted closure (``repro.launch.train``'s
    plain path), built the same way."""
    @jax.jit
    def step(p, st, batch):
        (_, metrics), grads = jax.value_and_grad(
            lambda q, b: JM.loss_fn(cfg, q, b), has_aux=True)(p, batch)
        grads = JOPT.clip_by_global_norm(grads, 1.0)
        p, st = opt.update(p, grads, st, lr)
        return p, st, metrics
    return step


def _host_pair(name):
    """Both packages' host steps with optimizer ``name`` (lr 1e-2) from
    the reference's smoke-width smollm-135m params, and their streams."""
    jcfg = j_get_config("smollm-135m").smoke_variant()
    tcfg = t_get_config("smollm-135m").smoke_variant()
    npp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                  jax.random.PRNGKey(1)))
    jopt, topt = JOPT.REGISTRY[name](), optimizers.REGISTRY[name]()
    jp = jax.tree.map(jnp.asarray, npp)
    tp = weights.tree_from_numpy(npp, device="cpu")
    return (jp, jopt.init(jp), _reference_host_step(jcfg, jopt, 1e-2),
            JTOK.TokenStream(jcfg.vocab_size, seed=0),
            tp, topt.init(tp), TRAIN.make_host_step(tcfg, topt, 1e-2),
            TTOK.TokenStream(tcfg.vocab_size, seed=0))


def _next_tokens(jstream, tstream):
    jt, tt = jstream.sample(8, 32), tstream.sample(8, 32)
    np.testing.assert_array_equal(tt, jt)
    return {"tokens": jnp.asarray(jt)}, {"tokens": torch.as_tensor(tt)}


@pytest.mark.parametrize("name", ["sgd", "momentum"])
def test_host_step_chain_matches_reference_closure(name):
    """Clipping then sgd or momentum, 3 steps on the same TokenStream
    batches (the streams bitwise equal), each package on its own:
    losses, params and state at 1e-5."""
    jp, js, jstep, jstream, tp, ts, tstep, tstream = _host_pair(name)
    for _ in range(3):
        jb, tb = _next_tokens(jstream, tstream)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=RTOL)
    assert _rel(tp, jp) <= RTOL
    assert _rel(ts, js) <= RTOL


def _adam_step_agreement(t, lr, tol, got, want, old):
    """One Adam step (b1 0.9, b2 0.999, eps 1e-8) from a shared state, the
    port's (``got``: params, m, v) against the reference's (``want``),
    leaf by leaf in float64.  ``m`` and ``v`` within ``tol`` of each
    row's largest (a row: the last axis), so a gradient error in a row
    of small values shows.  Adam divides each element by its own
    sqrt(v_hat) + eps, so a row's measured gap g_r (the largest
    |m_hat| or sqrt(v_hat) difference in the row) moves an element's
    step by at most lr (1 + max|u|) g_r / sqrt(v_hat) to first order;
    the params are held within ``tol`` of the leaf's largest wherever
    twice that bound is within it.  Every element stays within 2 lr of
    the reference and of its old value.  Returns (elements held, all
    elements)."""
    bc1, bc2 = 1 - 0.9 ** t, 1 - 0.999 ** t
    held = total = 0
    for leaf in zip(*got, *want, old):
        gp, gm, gv, wp, wm, wv, op = (
            np.asarray(x, np.float64).reshape(-1, np.shape(x)[-1])
            for x in leaf)
        for a, b in ((gm, wm), (gv, wv)):
            scale = np.abs(b).max(axis=1, keepdims=True)
            assert np.all(np.abs(a - b) <= tol * scale)
        root = np.sqrt(wv / bc2)
        gap = np.maximum(np.abs(gm - wm) / bc1,
                         np.abs(np.sqrt(gv / bc2) - root)).max(
                             axis=1, keepdims=True)
        u = np.abs(wm / bc1) / (root + 1e-8)
        top = np.abs(wp).max()
        cond = root >= 2 * (1 + u.max()) * lr * gap / (tol * top)
        diff = np.abs(gp - wp)
        assert np.all(diff[cond] <= tol * top)
        assert np.all(diff <= 2 * lr) and np.all(np.abs(gp - op) <= 2 * lr)
        held += int(cond.sum())
        total += cond.size
    return held, total


def test_host_step_adam_matches_reference_closure():
    """Clipping then Adam (the launcher's default), 3 steps on the same
    batches, each port step from the reference's params and state: the
    loss at 1e-5, ``t`` equal, ``m`` and ``v`` at 1e-5 of each row's
    largest, and the params at 1e-5 of the leaf's largest wherever the
    rows' measured gradient gap cannot move Adam's step further
    (``_adam_step_agreement``; at least 90% of the elements each step).
    Free-running, the params part by 1.5e-3 of the largest after 3
    steps: Adam gives an element whose gradient is at the packages'
    float32 rounding a step of up to lr either way.  Adam itself, fed
    the same gradients, is bitwise the reference's
    (``tests/test_torch_optimizers.py``)."""
    jp, js, jstep, jstream, _, _, tstep, tstream = _host_pair("adam")
    leaves = jax.tree_util.tree_leaves
    for t in range(1, 4):
        jb, tb = _next_tokens(jstream, tstream)
        tp = weights.tree_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        ts = {"m": weights.tree_from_numpy(jax.tree.map(np.asarray,
                                                        js["m"]),
                                           device="cpu"),
              "v": weights.tree_from_numpy(jax.tree.map(np.asarray,
                                                        js["v"]),
                                           device="cpu"),
              "t": torch.tensor(int(js["t"]), dtype=torch.int32)}
        jp, js, jm = jstep(jp, js, jb)
        new, ts_new, tm = tstep(tp, ts, tb)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=RTOL)
        assert int(ts_new["t"]) == int(js["t"]) == t
        held, total = _adam_step_agreement(
            t, 1e-2, RTOL,
            [[x.numpy() for x in pruning.flatten(tree)]
             for tree in (new, ts_new["m"], ts_new["v"])],
            [leaves(tree) for tree in (jp, js["m"], js["v"])],
            [x.numpy() for x in pruning.flatten(tp)])
        assert held >= 0.9 * total


# ---------------------------------------------------------------------------
# The command line on the CPU
# ---------------------------------------------------------------------------

HEAD = re.compile(r"^arch=smollm-135m \(reduced: \d+\.\d\dM params\) "
                  r"devices=\d+$")
STEP = re.compile(r"^step +(\d+) loss=(\d+\.\d{4})$")
FL_STEP = re.compile(r"^step +(\d+) loss=(\d+\.\d{4}) rho=(\d\.\d{3})$")
TAIL = re.compile(r"^3 steps in \d+\.\ds \(\d+\.\d\d steps/s\)$")


def _run_main(capsys, *extra):
    rc = TRAIN.main(["--arch", "smollm-135m", "--device", "cpu", "--steps",
                     "3", "--batch", "2", "--seq", "16", *extra])
    assert rc == 0
    return capsys.readouterr().out.strip().splitlines()


def test_main_plain_prints_reference_lines(capsys):
    lines = _run_main(capsys)
    assert HEAD.match(lines[0]) and TAIL.match(lines[-1])
    steps = [STEP.match(line) for line in lines[1:-1]]
    assert [int(m.group(1)) for m in steps] == [0, 2]
    assert all(np.isfinite(float(m.group(2))) for m in steps)


def test_main_fl_prints_reference_lines(capsys):
    lines = _run_main(capsys, "--fl")
    assert HEAD.match(lines[0]) and TAIL.match(lines[-1])
    steps = [FL_STEP.match(line) for line in lines[1:-1]]
    assert [int(m.group(1)) for m in steps] == [0, 2]
    for m in steps:
        assert np.isfinite(float(m.group(2)))
        assert float(m.group(3)) == pytest.approx(0.3, abs=0.15)


def test_main_ckpt_restores_the_trained_params(capsys, tmp_path):
    """The saved params are what 3 host steps from the run's seed and
    stream give (replayed here bit for bit), and restore as they were."""
    path = str(tmp_path / "ckpt.npz")
    lines = _run_main(capsys, "--ckpt", path)
    assert lines[-1] == f"saved checkpoint to {path}"
    cfg = t_get_config("smollm-135m").smoke_variant()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    opt = optimizers.adam()
    state, step = opt.init(params), TRAIN.make_host_step(cfg, opt, 1e-2)
    stream = TTOK.TokenStream(cfg.vocab_size, seed=0)
    for _ in range(3):
        params, state, _ = step(params, state, {"tokens": torch.as_tensor(
            stream.sample(2, 16).astype(np.int64))})
    restored = checkpoint.restore(path, params)
    for a, b in zip(pruning.flatten(restored), pruning.flatten(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_main_production_traces_the_step():
    """``--production`` runs the dry run for its combo, in a process of
    its own (the dry run starts its fake group of 256 ranks)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--production",
         "--arch", "smollm-135m", "--shape", "decode_32k"],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    assert "OK   smollm-135m" in out.stdout
    assert "1 ok, 0 skipped, 0 failed on mesh 16x16" in out.stdout


def test_main_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRAIN.main(["--steps", "1"])


# one rank of ``python -m repro_torch.launch.train --fl`` under a
# launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as
# torchrun sets them): the launcher's lines, then the world it joined
_LAUNCHED_RANK = r"""
import torch.distributed as dist
from repro_torch.launch import train as TRAIN
rc = TRAIN.main(["--arch", "smollm-135m", "--device", "cpu", "--fl",
                 "--steps", "2", "--batch", "2", "--seq", "16"])
print(f"world={dist.get_world_size()} rank={dist.get_rank()}")
dist.barrier()
dist.destroy_process_group()
raise SystemExit(rc)
"""


def test_main_fl_joins_a_launchers_world():
    """Under a launcher's environment the ``--fl`` path joins the
    launcher's world over ``env://`` (two gloo ranks, one client each),
    not a world of one per process: both ranks report world 2 and log
    the same lines (the loss is the clients' mean)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(SRC), RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _LAUNCHED_RANK], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(out.strip().splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, lines in enumerate(outs):
        assert lines[-1] == f"world=2 rank={rank}"
        steps = [FL_STEP.match(line) for line in lines[1:-2]]
        assert [int(m.group(1)) for m in steps] == [0, 1]
    assert [line for line in outs[0] if line.startswith("step")] == \
        [line for line in outs[1] if line.startswith("step")]
