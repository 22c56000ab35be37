"""Multi-pod dry run (the port of ``repro.launch.dryrun``): trace every
(architecture x input shape) step on the production mesh, prove it runs
sharded, and extract its roofline terms.

The reference lowers and compiles each step for 256 or 512 placeholder
host devices (``XLA_FLAGS`` set first thing in its module) and reads the
compiled HLO.  The port traces its eager step on one process:

  * a ``"fake"`` default group of 256 (16 x 16) or 512 (2 x 16 x 16 and
    the fleet's 32 x 16) ranks, this process rank 0, started here
    (``fake_group``), so the dry run runs as a process of its own and
    needs no card; its collectives move no data;
  * ``launch.mesh.make_production_mesh`` over it ("cpu" meshes);
  * the step's arguments as DTensors of ``FakeTensorMode`` tensors at
    their specs (``steps.input_specs``; for ``--fl``
    ``federated.trainer.make_fl_train_step``, its params on the mesh at
    ``param_shardings(fsdp=False)`` as the step returns them, its batch
    and per-client vectors whole, as every rank receives them);
  * the step under ``use_rules(DEFAULT_RULES, mesh)`` and
    ``implicit_replication()``, inside ``launch.cost.CostMode``.

Nothing is allocated.  A combo that runs through proves that DTensor can
propagate every op of the step on the mesh; its ``RooflineReport`` holds
rank 0's local flops, bytes and collectives (``launch.cost``).  The
port's layer, chunk and time loops are Python, so the trace's wall grows
with them (the recurrent mixers step over every position).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--fl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fleet
  ... --out DIR   # one JSON per combo
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.core import pruning
from repro_torch.launch import cost as COST
from repro_torch.launch import mesh as MESH
from repro_torch.launch import roofline as RF
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as ST
from repro_torch.models import sharding as MS

__all__ = ["mesh_tag", "fake_group", "combo", "trace", "dryrun_one",
           "fleet_dryrun", "main"]


def mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def fake_group(world_size: int) -> None:
    """Make the default group a ``"fake"`` one of ``world_size`` ranks
    with this process rank 0 (a fake group of another size is replaced).
    A real group already up raises: the dry run runs in a process of its
    own."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: a "
                               f"{dist.get_backend()!r} group is up")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _fake_args(tree, specs, mesh):
    """``tree``'s ``meta`` tensors as fake tensors (the active
    ``FakeTensorMode``): DTensors on ``mesh`` at ``specs`` (a spec tree
    of ``tree``'s structure), or plain where ``specs`` is None."""
    leaves = [torch.empty(m.shape, dtype=m.dtype)
              for m in pruning.flatten(tree)]
    if specs is not None:
        from torch.distributed.tensor import distribute_tensor
        leaves = [distribute_tensor(t, mesh, SH.placements(s, mesh),
                                    src_data_rank=None)
                  for t, s in zip(leaves, SH.leaves_like(specs, tree))]
    return pruning.unflatten(tree, leaves)


def trace(spec: dict, mesh, rules: dict
          ) -> tuple[COST.CostMode, int, int]:
    """Run ``spec``'s step once on fake arguments on ``mesh`` under
    ``rules``: (the ``CostMode`` that counted it, argument bytes, output
    bytes a rank)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    with FakeTensorMode():
        args = [_fake_args(a, s, mesh)
                for a, s in zip(spec["args"], spec["in_specs"])]
        with MS.use_rules(rules, mesh), implicit_replication(), \
                COST.CostMode() as counted:
            out = spec["step"](*args)
        return counted, COST.tree_bytes(args), COST.tree_bytes(out)


def combo(cfg, shape, multi_pod: bool = False, fl: bool = False,
          rules: dict | None = None) -> tuple[dict, object, dict]:
    """(the step's spec, the production mesh over a fake group, the
    logical rules: ``DEFAULT_RULES`` updated by ``rules``) for one
    combo."""
    fake_group(MESH.required_devices(multi_pod))
    mesh = MESH.make_production_mesh(multi_pod=multi_pod, device="cpu")
    spec = _fl_spec(cfg, shape, mesh) if fl else \
        ST.input_specs(cfg, shape, mesh)
    return spec, mesh, dict(MS.DEFAULT_RULES, **(rules or {}))


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               fl: bool = False, verbose: bool = True,
               sharding_overrides: dict | None = None):
    """Trace one combo; returns a ``RooflineReport`` (or None if the
    shape is skipped for this arch, e.g. long_500k on whisper)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if not ST.shape_supported(cfg, shape):
        if verbose:
            print(f"SKIP {arch} x {shape_name}: unsupported "
                  f"(full-attention arch without long-context variant)")
        return None

    t0 = time.time()
    spec, mesh, rules = combo(cfg, shape, multi_pod, fl, sharding_overrides)
    counted, arg_bytes, out_bytes = trace(spec, mesh, rules)
    wall = time.time() - t0
    hc = counted.cost

    n_active = RF.active_param_count(cfg, spec["args"][0])
    peak = arg_bytes + counted.peak_bytes
    report = RF.RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_tag(multi_pod),
        chips=mesh.size(),
        flops_per_chip=float(hc.flops),
        bytes_per_chip=float(hc.hbm_bytes),
        collective_bytes_per_chip=float(hc.collective_bytes),
        peak_memory_per_chip=float(peak),
        argument_bytes=float(arg_bytes),
        output_bytes=float(out_bytes),
        temp_bytes=float(max(peak - arg_bytes - out_bytes, 0)),
        collectives={op: {"count": float(hc.collective_counts[op]),
                          "bytes": float(hc.collective_op_bytes[op])}
                     for op in hc.collective_counts},
        model_flops=RF.model_flops(cfg, shape, n_active),
        wall_s=wall,
    )
    if verbose:
        print(f"OK   {report.row()}  ({wall:.1f}s trace)", flush=True)
    return report


def _fl_spec(cfg, shape, mesh) -> dict:
    """Dry-run spec for the distributed pruned-FL step (the paper's
    technique on the production mesh): clients on ("pod", "data"), each
    client's weights sharded over "model".  The params are DTensors on
    the mesh at ``param_shardings(fsdp=False)``, as the step returns
    them; the batch and the per-client vectors are whole on every rank,
    as the step takes them (``fl_input_specs`` gives their specs over the
    client dims, for callers that place them)."""
    from repro_torch.federated import trainer as FT
    from repro_torch.models import model as M

    client_axes = SH.client_axes(mesh)
    n = FT.num_clients(mesh, client_axes)
    per_client = max(shape.global_batch // n, 1)
    step = FT.make_fl_train_step(cfg, mesh, client_axes=client_axes)
    params_shape = M.init_params(cfg, None)
    batch, vec, _specs = FT.fl_input_specs(cfg, mesh, client_axes,
                                           per_client, shape.seq_len)
    return {
        "step": step,
        "args": (params_shape, batch, vec, vec, vec),
        "in_specs": (SH.param_shardings(params_shape, mesh, fsdp=False),
                     None, None, None, None),
    }


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


class _Collectives(COST.CostMode):
    """A ``CostMode`` that also keeps each collective's kind and its
    tensor operands (a fake group leaves them as this rank sent them)."""

    def __init__(self):
        super().__init__()
        self.issued: list[tuple[str, list]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = COST._KINDS.get(func.overloadpacket.__name__)
        if kind is not None and out is not NotImplemented:
            tensors = [a for a in pruning.flatten(list(args))
                       if isinstance(a, torch.Tensor)]
            self.issued.append((kind, tensors))
        return out


def fleet_dryrun(verbose: bool = True) -> dict:
    """Multi-host fleet dry run: the fleet engine's two mesh blocks
    (``fleet.engine``, "Meshes") on a fake ("cells" 32, "data" 16) mesh
    of 512 ranks, at 64 cells x 64 clients and a cohort of 16 a cell.

    * The control pass's Algorithm-1 solve (``_solve_cells_split``):
      each rank solves its block of C / 32 whole cells, then one
      all-gather of the packed blocks.
    * Eq. (5)'s weighted gradient sum over the flat (C * m) cohort
      clients split over "data": each rank sums its slice, then one
      all-reduce (``_all_reduce_sum``).

    A fake group moves no data, so the values checked are rank 0's own,
    as it sends them: its packed block against the same cells of the
    solve without a mesh (bitwise: the solve is elementwise over cells),
    and its local weighted sum against the same slice summed without a
    mesh.  Asserts the shard shapes (2 cells a block, 64 clients a
    "data" shard) and the collectives issued (one all-gather, one
    all-reduce).  Returns the summary dict."""
    import numpy as np
    from repro_torch.core import wireless as W
    from repro_torch.fleet import engine as FE
    from repro_torch.fleet import solver as FSOLVER

    fake_group(512)
    mesh = MESH.make_fleet_mesh(cells=32, data=16, device="cpu")
    _check(mesh.mesh_dim_names == ("cells", "data")
           and tuple(mesh.shape) == (32, 16), f"fleet mesh {mesh}")

    cells, per_cell, m = 64, 64, 16          # 4096 clients, 1024-cohort
    wcfg = W.WirelessConfig()
    scfg = FSOLVER.SolverConfig()
    rng = np.random.default_rng(0)
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(a, dtype=f64)

    h_up = t(10.0 ** -rng.uniform(8, 12, (cells, per_cell)))
    k = t(rng.integers(16, 64, (cells, per_cell)).astype(float))
    cpu = t(rng.uniform(2e8, 8e9, (cells, per_cell)))
    p_tx = torch.full((cells, per_cell), wcfg.tx_power_ue_w, dtype=f64)
    rho_max = torch.full((cells, per_cell), 0.9, dtype=f64)
    m_cell = torch.full((cells,), 1e-4, dtype=f64)
    mask = torch.ones((cells, per_cell), dtype=f64)
    operands = (h_up, k, cpu, p_tx, rho_max, m_cell, mask, None)
    solve_kw = dict(
        bandwidth_hz=wcfg.bandwidth_hz, noise_psd=wcfg.noise_psd_w_per_hz,
        waterfall_m0=wcfg.waterfall_m0, model_bits=wcfg.model_bits,
        cycles_per_sample=wcfg.cycles_per_sample, weight=4e-4, solver=scfg)

    # -- the per-cell solve over "cells" ------------------------------------
    split = FE._cell_split(mesh)
    lo, hi = FE._block(cells, split)
    _check((split.size, hi - lo) == (32, cells // 32),
           f"cell blocks {split.size} x {hi - lo}")
    t0 = time.time()
    with _Collectives() as seen:
        FE._solve_cells_split(split, 0, operands, **solve_kw)
    solve_s = time.time() - t0
    kinds = [kind for kind, _ in seen.issued]
    _check(kinds == ["all-gather"], f"the solve issued {kinds}")
    sent = seen.issued[0][1][-1]               # the block rank 0 sends
    whole = FSOLVER.solve_fleet(*operands[:7], **solve_kw)
    _check(bool(whole.feasible.all()), "dry-run cells must be feasible")
    want = torch.cat(
        [getattr(whole, f)[lo:hi] for f in FE._CLIENT_FIELDS]
        + [getattr(whole, f)[lo:hi, None].to(f64) for f in FE._CELL_FIELDS],
        dim=-1)
    _check(tuple(sent.shape) == tuple(want.shape) and torch.equal(sent, want),
           "rank 0's block differs from the meshless solve")

    # -- the cohort gradient sum over "data" --------------------------------
    n_flat, dim = cells * m, 128
    wts = torch.as_tensor(rng.uniform(0, 1, (n_flat,)), dtype=torch.float32)
    grads = torch.as_tensor(rng.normal(size=(n_flat, dim)),
                            dtype=torch.float32)
    data = mesh.get_group("data")
    dsplit = FE.Split(dist.get_rank(data), dist.get_world_size(data), data)
    a, b = FE._block(n_flat, dsplit)
    _check((dsplit.size, b - a) == (16, n_flat // 16),
           f"client slices {dsplit.size} x {b - a}")
    t0 = time.time()
    with _Collectives() as seen:
        FE._all_reduce_sum([torch.einsum("c,cd->d", wts[a:b], grads[a:b])],
                           dsplit)
    grad_s = time.time() - t0
    kinds = [kind for kind, _ in seen.issued]
    _check(kinds == ["all-reduce"], f"the sum issued {kinds}")
    local = seen.issued[0][1][0]
    ref = torch.einsum("c,cd->d", wts[:n_flat // 16], grads[:n_flat // 16])
    _check(torch.equal(local, ref), "rank 0's weighted sum differs from the "
           "meshless sum of its slice")

    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "devices": mesh.size(), "cells": cells,
           "clients_per_cell": per_cell, "cohort_m": m,
           "solve_shard_shape": [hi - lo, per_cell],
           "grad_shard_clients": b - a,
           "collectives": {"solve": ["all-gather"], "grad": ["all-reduce"]},
           "solve_s": solve_s, "grad_s": grad_s}
    if verbose:
        print(f"OK   fleet dry-run on {out['devices']} fake ranks "
              f"mesh={out['mesh']}")
        print(f"     solve: {cells} cells x {per_cell} clients, "
              f"{hi - lo} cells a block, one all-gather, rank 0's block "
              f"bitwise the meshless solve ({solve_s:.1f}s)")
        print(f"     cohort grad: {n_flat} clients over 16 data shards, "
              f"{b - a} clients a shard, one all-reduce, rank 0's sum equal to "
              f"the meshless sum of its slice ({grad_s:.1f}s)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES),
                    help="one architecture (default: all)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES),
                    help="one input shape (default: all)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512 ranks) instead of 16x16 (256)")
    ap.add_argument("--fl", action="store_true",
                    help="dry-run the distributed pruned-FL step instead "
                         "of the plain train/serve step (train shapes only)")
    ap.add_argument("--fleet", action="store_true",
                    help="dry-run the fleet engine's cell solve and "
                         "gradient sum on the two-dim ('cells', 'data') "
                         "mesh and assert both dims partition")
    ap.add_argument("--out", default=None,
                    help="directory for per-combo JSON reports")
    args = ap.parse_args(argv)

    if args.fleet:
        try:
            rep = fleet_dryrun()
        except Exception as e:
            traceback.print_exc()
            print(f"FAIL fleet dry-run: {e}")
            return 1
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            path = os.path.join(args.out, "fleet_dryrun_32x16.json")
            with open(path, "w") as f:
                json.dump(rep, f, indent=2)
        return 0

    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)

    failures = []
    n_ok = n_skip = 0
    for arch in archs:
        for shape in shapes:
            if args.fl and INPUT_SHAPES[shape].mode != "train":
                continue
            try:
                rep = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                                 fl=args.fl)
            except Exception as e:  # a failure here is a bug in the port
                traceback.print_exc()
                failures.append((arch, shape, repr(e)))
                print(f"FAIL {arch} x {shape}: {e}", flush=True)
                continue
            if rep is None:
                n_skip += 1
                continue
            n_ok += 1
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                tag = "fl_" if args.fl else ""
                path = os.path.join(
                    args.out,
                    f"{tag}{arch}_{shape}_{rep.mesh}.json".replace("/", "-"))
                RF.save_report(rep, path)

    print(f"\n{n_ok} ok, {n_skip} skipped, {len(failures)} failed "
          f"on mesh {mesh_tag(args.multi_pod)}")
    for arch, shape, err in failures:
        print(f"  FAILED: {arch} x {shape}: {err}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
