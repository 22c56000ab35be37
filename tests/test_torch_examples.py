"""The six example entry points (``repro_torch.examples``) on the CPU.

Every module's ``main`` parses the reference script's flags (names,
defaults, choices and help read from ``examples/*.py``'s source) plus
``--device``, and without ``--device`` on a machine with no card fails
as ``device.resolve_device`` does.  The host-computed figures equal the
reference's at 1e-9: ``tradeoff_playground``'s table (each sweep at 2
seeds, from the reference's ``core.tradeoff`` called with the same
arguments) and ``quickstart``'s channel, Algorithm 1's rho, B, PER,
deadline and cost, and the Theorem-1 terms.  ``quickstart``'s FedSGD
round holds its aggregated gradient and step at 1e-5 against the
reference's ``pruning`` / ``aggregation`` from the reference's initial
params (carried over by ``repro_torch.weights``) and injected packet
uniforms that drop two clients.  The other entry points run at small
sizes: ``train_federated`` two rounds with a checkpoint;
``fleet_sim --smoke`` sync (with ``--metrics-out`` holding exactly the
reference script's keys, and the telemetry and trace files parsed),
``--async``, ``--geometry hex``, ``--cloud-period 2`` and
``--task linreg``, each smoke assertion held; ``--task transformer`` at
3 rounds; ``--mesh`` as ``python -m`` in a child process (a world of
one) against the meshless run; ``pruned_llm_federated`` two rounds; and
``serve_pruned`` at its smallest size, the gather tokens equal to the
dense ones.
"""

import argparse
import ast
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import checkpoint as TCK
from repro_torch import weights
from repro_torch.data import synthetic as TSYN

try:
    import jax
    import jax.numpy as jnp
    from repro.core import aggregation as JAGG
    from repro.core import pruning as JPR
    from repro.core import tradeoff as JTR
    from repro.core import wireless as JW
    from repro.core.convergence import (ConvergenceBound as JBound,
                                        SmoothnessParams as JSmooth)
    from repro.models import mlp as JMLP
except ImportError:
    JTR = None
needs_jax = pytest.mark.skipif(JTR is None, reason="needs the JAX reference")

SRC = Path(repro_torch.__file__).resolve().parents[1]
REFERENCE = SRC.parent / "examples"
NAMES = ["quickstart", "tradeoff_playground", "train_federated", "fleet_sim",
         "pruned_llm_federated", "serve_pruned"]
CPU = ["--device", "cpu"]
CHILD_TIMEOUT = 240


def _module(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


# ---------------------------------------------------------------------------
# Flags
# ---------------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _port_flags(name, monkeypatch) -> dict:
    """{option: (default, help, choices)} of the port's parser, caught at
    ``parse_args`` (nothing runs)."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as caught:
        _module(name).main([])
    return {a.option_strings[0]: (a.default, a.help, a.choices)
            for a in caught.value.args[0]._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def _reference_flags(name) -> dict:
    """The same, read from the reference script's ``add_argument`` calls
    (``store_true`` flags default to False, as argparse gives them)."""
    tree = ast.parse((REFERENCE / f"{name}.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}

            def value(key, default=None):
                if key not in kw:
                    return default
                return eval(compile(ast.Expression(kw[key]), name, "eval"),
                            {"math": math})
            store_true = value("action") == "store_true"
            out[node.args[0].value] = (
                value("default", False if store_true else None),
                value("help"), value("choices"))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_flags_are_the_reference_scripts(name, monkeypatch):
    ours = _port_flags(name, monkeypatch)
    device = ours.pop("--device")
    assert device[0] is None
    assert ours == _reference_flags(name)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", NAMES)
def test_no_device_flag_needs_the_card(name):
    argv = {"tradeoff_playground": ["--seeds", "1"],
            "train_federated": ["--rounds", "1"],
            "fleet_sim": ["--smoke"],
            "pruned_llm_federated": ["--rounds", "1"],
            "serve_pruned": ["--rounds", "1"]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _module(name).main(argv)


# ---------------------------------------------------------------------------
# Host figures against the reference
# ---------------------------------------------------------------------------

I, SAMPLES = 5, np.array([30, 40, 50, 30, 40], np.float64)


def _j_solve(cfg, lam, seed):
    h_up, h_down = JW.Channel(I, seed=seed).sample_gains()
    bound = JBound(JSmooth(), SAMPLES)
    prob = JTR.TradeoffProblem(
        cfg=cfg, bound=bound, h_up=h_up, h_down=h_down,
        tx_power=np.full(I, cfg.tx_power_ue_w), cpu_hz=np.full(I, 5e9),
        num_samples=SAMPLES, max_prune=np.full(I, 0.7), weight=lam)
    return JTR.solve_alternating(prob), bound, h_up


_J_SWEEPS = {
    "power": ([13, 18, 23, 28, 33], lambda x: (JW.WirelessConfig(
        tx_power_ue_w=JW.dbm_to_watt(x)), 0.0004)),
    "modelsize": ([0.4, 0.8, 1.6, 3.2, 6.4],
                  lambda x: (JW.WirelessConfig(model_bits=x * 1e6), 0.0004)),
    "lambda": ([1e-5, 1e-4, 4e-4, 1e-3, 4e-3, 1e-2],
               lambda x: (JW.WirelessConfig(), x)),
}


@needs_jax
@pytest.mark.parametrize("sweep", ["power", "modelsize", "lambda"])
def test_tradeoff_table_matches_reference(sweep, capsys):
    seeds = 2
    got = _module("tradeoff_playground").main(
        ["--sweep", sweep, "--seeds", str(seeds)] + CPU)
    xs, make = _J_SWEEPS[sweep]
    assert [r["x"] for r in got["rows"]] == xs
    for r, x in zip(got["rows"], xs):
        sols = [_j_solve(*make(x), s)[0] for s in range(seeds)]
        want = [np.mean([s.total_cost for s in sols]),
                np.mean([s.deadline for s in sols]) * 1e3,
                np.mean([s.prune.mean() for s in sols]),
                np.mean([s.per.mean() for s in sols]),
                np.mean([s.bandwidth.sum() for s in sols]) / 1e6]
        np.testing.assert_allclose(
            [r["cost"], r["latency_ms"], r["mean_rho"], r["mean_per"],
             r["sum_b_mhz"]], want, rtol=1e-9, atol=1e-12)
    assert len(capsys.readouterr().out.splitlines()) == len(xs) + 1


@needs_jax
def test_quickstart_matches_reference(capsys):
    got = _module("quickstart").main(CPU)
    sol, bound, h_up = _j_solve(JW.WirelessConfig(), 0.0004, 0)
    np.testing.assert_allclose(got["h_up"], h_up, rtol=1e-9)
    assert got["iterations"] == sol.iterations
    for key, want in (("prune", sol.prune), ("bandwidth", sol.bandwidth),
                      ("per", sol.per), ("deadline", sol.deadline),
                      ("total_cost", sol.total_cost),
                      ("bound", bound.bound(200, sol.per, sol.prune)),
                      ("initial_term", bound.initial_term(200)),
                      ("packet_error_term", bound.packet_error_term(sol.per)),
                      ("pruning_term", bound.pruning_term(sol.prune))):
        np.testing.assert_allclose(got[key], want, rtol=1e-9, atol=1e-15,
                                   err_msg=key)
    assert np.isfinite(got["mean_loss"])
    assert "Theorem 1 bound after S=200" in capsys.readouterr().out


@needs_jax
def test_quickstart_round_matches_reference():
    qs = _module("quickstart")
    _, _, _, sol = qs.solve_tradeoff()
    data = TSYN.make_dataset(seed=0)
    parts = TSYN.partition_iid([int(k) for k in SAMPLES], data, seed=0)
    j_params = JMLP.init_mlp_classifier(jax.random.PRNGKey(0), data.dim,
                                        JMLP.SHALLOW_HIDDEN, data.num_classes)
    u = np.array([0.5, 0.0, 0.9, 0.3, 0.001], np.float32)
    arrivals = (u >= sol.per).astype(np.float32)
    assert arrivals.tolist() == [1, 0, 1, 1, 0]

    params = weights.tree_from_numpy(jax.tree.map(np.asarray, j_params),
                                     device="cpu")
    new, g, got_arrivals, losses = qs.fl_round(
        params, data, parts, sol.prune, sol.per, torch.as_tensor(u))
    assert got_arrivals.tolist() == arrivals.tolist()

    grads, j_losses = [], []
    for i, idx in enumerate(parts):
        masks = JPR.magnitude_masks(j_params, float(sol.prune[i]))
        pruned = JPR.apply_masks(j_params, masks)
        loss, gi = jax.value_and_grad(JMLP.classifier_loss)(
            pruned, jnp.asarray(data.x_train[idx]),
            jnp.asarray(data.y_train[idx]))
        j_losses.append(float(loss))
        grads.append(JPR.apply_masks(gi, masks))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *grads)
    j_g = JAGG.aggregate(stacked, jnp.asarray(SAMPLES, jnp.float32),
                         jnp.asarray(arrivals))
    j_new = jax.tree.map(lambda p, gg: p - 1e-3 * gg, j_params, j_g)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for ours, theirs in ((g, j_g), (new, j_new)):
        for a, b in zip(weights.to_numpy(ours).values(),
                        jax.tree.map(np.asarray, theirs).values()):
            for key in ("w", "b"):
                scale = max(np.abs(b[key]).max(), 1e-30)
                np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                           atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# The other entry points, small
# ---------------------------------------------------------------------------

def test_train_federated_two_rounds_with_checkpoint(tmp_path, capsys):
    path = tmp_path / "params.npz"
    got = _module("train_federated").main(
        ["--rounds", "2", "--ckpt", str(path)] + CPU)
    for key in ("accuracy", "loss", "latency_ms", "mean_rho", "mean_per",
                "bound"):
        assert np.isfinite(got[key]), key
    assert 0.0 <= got["mean_rho"] <= 0.7
    flat = TCK.restore_flat(str(path))
    assert sorted(flat) == ["layer0/b", "layer0/w", "layer1/b", "layer1/w"]
    out = capsys.readouterr().out
    assert "scheme=proposed rounds=2" in out and f"saved params to {path}" \
        in out


def _reference_metric_keys() -> set:
    """The keys of the ``doc`` dict that the reference's fleet_sim writes
    to ``--metrics-out``."""
    tree = ast.parse((REFERENCE / "fleet_sim.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["doc"]:
            return {k.value for k in node.value.keys}
    raise AssertionError("no metrics dict in the reference's fleet_sim")


@pytest.mark.parametrize("extra", [
    ["--async"], ["--geometry", "hex"], ["--cloud-period", "2"],
    ["--task", "linreg"]], ids=["async", "hex", "two_tier", "linreg"])
def test_fleet_sim_smoke_variants(extra, capsys):
    got = _module("fleet_sim").main(["--smoke"] + extra + CPU)
    losses = got["losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert got["rounds"] == 3
    assert got["clients"] == (24 if "hex" in extra else 16)
    assert ("mean_staleness" in got) == ("--async" in extra)
    assert got["bandwidth_util"] <= 1.0 + 1e-6
    assert "Theorem-1 bound on realized averages" in capsys.readouterr().out


def test_fleet_sim_smoke_writes_its_files(tmp_path, capsys):
    files = {k: tmp_path / f for k, f in (("metrics", "metrics.json"),
                                          ("telemetry", "telemetry.jsonl"),
                                          ("trace", "trace.json"))}
    got = _module("fleet_sim").main(
        ["--smoke", "--metrics-out", str(files["metrics"]),
         "--telemetry-out", str(files["telemetry"]),
         "--trace-out", str(files["trace"])] + CPU)
    out = capsys.readouterr().out
    assert "telemetry smoke OK: histogram mass == 16 clients/round" in out
    doc = json.loads(files["metrics"].read_text())
    assert set(doc) == _reference_metric_keys()
    assert doc["losses"] == got["losses"] and len(doc["losses"]) == 3
    records = [json.loads(line) for line in
               files["telemetry"].read_text().splitlines()]
    assert len(records) == 1 + 3
    trace = json.loads(files["trace"].read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"fleet.build", "fleet.simulate", "fleet.finalize"} <= names


def test_fleet_sim_transformer_and_mesh(tmp_path):
    """The transformer task at 3 rounds; then the mesh flag through
    ``python -m`` in a child (a world of one, gloo), whose printed final
    loss equals the meshless run's."""
    got = _module("fleet_sim").main(
        ["--task", "transformer", "--cells", "1", "--per-cell", "4",
         "--rounds", "3"] + CPU)
    assert got["kernel"] == "fused" and np.all(np.isfinite(got["losses"]))
    assert got["losses"][-1] < got["losses"][0]

    argv = ["--smoke", "--kernel", "fused"] + CPU
    meshless = _module("fleet_sim").main(argv)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.fleet_sim", "--mesh",
         *argv], capture_output=True, text=True, env=env,
        timeout=CHILD_TIMEOUT, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"final loss {meshless['final_loss']:.4f}" in proc.stdout


def test_pruned_llm_federated_two_rounds(capsys):
    got = _module("pruned_llm_federated").main(
        ["--rounds", "2", "--cells", "1", "--clients-per-cell", "4"] + CPU)
    assert got["clients"] == 4 and len(got["losses"]) == 2
    assert np.all(np.isfinite(got["losses"]))
    assert [r["round"] for r in got["rows"]] == [0, 1]
    assert "done; final loss" in capsys.readouterr().out


def test_serve_pruned_gather_equals_dense(tmp_path, capsys):
    got = _module("serve_pruned").main(
        ["--rounds", "1", "--batch", "2", "--prompt-len", "4", "--steps",
         "4", "--out", str(tmp_path / "bundle.npz")] + CPU)
    assert got["tokens"]["gather"] == got["tokens"]["dense"]
    assert np.array(got["tokens"]["gather"]).shape == (2, 4)
    assert 0.0 <= got["rho"] < 1.0
    assert "block-sparse tokens == dense tokens" in capsys.readouterr().out
