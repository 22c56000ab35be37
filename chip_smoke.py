#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero and prints no result line):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every CUDA kernel from src/repro_torch/kernels/csrc;
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the main paths' shapes (the fleet round's, and smollm-135m's
               for the block-sparse matmul, forward and transposed, decode
               attention and flash prefill), with errors, bounds and warm
               device times from torch.profiler (the kernel's own launches,
               the plain version's and, where one exists, a library call's
               device ops), beside the kernel call's CUDA-event time, which
               includes the host's dispatch (``call_ms``); the fused
               call's device time by pass (every launch the wrapper
               records, matched one for one by the profiler) beside the
               two-pass design's floor; the decode
               step's matmul by serving shape (launches a step, ms, bound,
               torch.matmul) and the same products at the prefill wave's
               M = 1024 against torch.matmul (``wave_ms``,
               ``wave_library_ms``); decode attention also timed at a long
               cache (B = 32, S = 2048, pos in [1024, 2047], ``long_*``);
               prefill also at G = 4 / hd = 64 and G = 7 / hd = 128 with
               ragged t_valid, windows, a dead head; phase 16c's shapes:
               the block-sparse matmul on granite-3-2b's and qwen2-7b's
               linears and tile grids at M in {1, 4, 16, 512} and rho in
               {0, 0.5, 1}, decode attention at their head layouts on 16
               and 4 slots over a cache of 64; the tile norms in
               both regimes (the fleet's three layers, and smollm-135m's
               bundle leaves in bfloat16, ``bundle_*``, and the same
               leaves in float32, phase 15b's ranking every round,
               ``smollm_f32_*``) and at block 16 on the DNN's ragged
               leaves (the §V run's ranking, ``block16_ms``): within 1e-4
               of the
               plain version, bitwise alone / grouped / rerun, timed
               beside an einsum, the byte bound and an empty launch's
               device time (``launch_floor_ms``); the xLSTM scans
               (mlstm_scan and slstm_scan, forward and backward) at
               xlstm-125m's heads (4 of 384, 4 of 192) on (2, 256) from
               zero and drawn states: h and every input's gradient
               against autograd of the plain version within 1e-4 of
               max(1, |plain|), rerun bitwise; the same on a ragged
               case, (3, 100) at head dims 72 (mLSTM) and 44 (sLSTM); the
               sLSTM forward's cluster (CTAs, shared memory a CTA,
               cudaOccupancyMaxActiveClusters); at 17a's host-step shape
               (4, 4096) the forward against the plain forward and rerun
               bitwise, and each op's ms (CUDA events over back-to-back
               launches), call ms (a call alone), the mLSTM backward's
               ms by launch (CUDA events between its three launches,
               ``by_kernel``) and bound, with the
               plain forward's ms there and the plain backward's at (2,
               256) (``plain_shape``, ``small_ms``);
  4. main    — 5 synchronous fleet rounds: 10,000 clients (100 x 100 cells),
               the paper's 784-60-20-10 DNN, kernel="fused"; per-round
               metrics and wall time, launch counts (each > 0, the tile
               norms one a round), and a second run that must give
               bitwise-identical losses;
  5. card vs CPU — a small fleet from the same numpy draws (Gumbel scores
               included) on the CPU (plain versions) and on the card
               (kernels), compared at 1e-4: the sync fused round, the
               cohort path, async events, the reference kernel with
               magnitude and with block masks, the paths of phases
               10-12, a sync and a hex fleet with telemetry (masses
               exact, bin counts equal but for values within 1e-5 of an
               edge, which the line names), the §V ``run`` at 5 UEs with
               magnitude and block-16 masks, ``run_fleet_reference``, and
               the generic gradient path's tasks: a LinearRegressionTask
               fleet (2 x 4 clients, 3 rounds) and TransformerTask fleets
               at the smoke width, smollm-135m's and olmoe-1b-7b's (its
               4-D expert leaves in the grouped ranking), 2 x 3 clients,
               2 rounds, each from the task's own draws on the CPU
               carried as numpy;
  6. serve   — smollm-135m at full width (random weights from a seed,
               bfloat16, pruned at rho = 0.5 on its tile grid) through
               ServeEngine: 64 requests x (32 prompt + 32 new tokens) on 32
               slots by generate and by generate_prefilled, with launch
               counts (the bundle's ranking one tile_norms launch), timings
               and a profiled decode step; tokens must be
               equal across 32 and 8 slots, to a per-request host loop and
               (up to near-ties) between the two modes, and a 2-layer
               full-width copy must give the same logits on card and CPU;
  7. cohort  — fleet_bench's cohort arm at the slice: 10 of 100 clients a
               cell, uniform, the cohort gather, control_chunk=25, 5
               rounds: one fused call over the 1,000-client cohort and one
               ranking a round, a profiled round beside phase 4's;
  8. async   — FedBuff events: buffer 2,500 (0.25 n), max_staleness 20,
               polynomial discount, 10 events: fused and tile-norm
               launches equal to the populated ring slots (found from the
               in-flight state apart from the engine), sim_time never
               decreasing, participants <= 2,500, a profiled event;
  9. reference — kernel="reference" with magnitude masks in 1,000-client
               chunks, 2 rounds, beside phase 4's fused rounds; then
               reference(block) against fused on 2 x 8 clients at 1e-4;
 10. hex     — HexInterference(reuse 3, 6 neighbours, 25 m mobility,
               handover) at the slice, default solver, 3 rounds: one fused
               call and one ranking a round, 0 < fixed-point iterations
               <= 8, some cell's interference PSD > 0; per round the
               fixed point's iterations, residual and PSD range, the
               handover share and mean PER;
 11. two-tier — (a) phase 4 with cloud_period 2, 4 rounds: 100 fused
               calls and 100 rankings a round (one per cell), latencies
               minus phase 4's equal to the backhaul on merge rounds and 0
               otherwise; (b) phase 8 with cloud_period 2, 6 events:
               rankings equal to the populated slots, no fused call
               (per-client block masks), sim_time non-decreasing;
 12. data    — (a) 100,000 clients (2.5 GB of client data, over the
               512 MB cache limit) streamed, cell_chunk 10, 2 rounds: 10
               fused calls a round, equal bit for bit to the same run with
               cache_data=True, peak device memory of both; (b)
               Dirichlet(0.3) labels at the slice, 3 rounds, beside the IID
               run's largest-class share;
 13. telemetry — (a) phase 4 with TelemetryConfig(): losses, latencies
               and params bitwise phase 4's, five (5, 100, 16) per-cell
               histograms of mass 100, finite gradient norms and mask
               densities in [0, 1], the warm round wall with telemetry off
               and on in turns (medians) and a profiled round's device time
               by record_function phase; (b) phase 10 (hex): fixed-point
               iterations in 1..8, fp_residuals (3, 8), NaN past each
               round's count, the last finite one fp_residual; (c) phase 8
               (async): staleness mass 2,500 an event; (d) phase 11a
               (two-tier), 2 rounds: finite edge gradient norms; each rerun
               bitwise, telemetry included; (e) JSONL and CSV sinks (rounds
               + 1 records) and a SpanRecorder's chrome trace of the build,
               simulate and finalize spans;
 14. host reference path — (a) the paper's §V run on Table I (5 UEs, K =
               30, 40, 50, 30, 40, the DNN, 8 rounds cut from 200), every
               scheme (fpr at 0.3), magnitude and block-16 masks: finite
               losses, proposed's falling and rerunning bitwise, one
               tile-norm launch a round with block masks (none without),
               proposed's mean total cost at most gba's and fpr:0.3's
               (host float64), per scheme the mean cost, rho, PER, final
               accuracy and wall a round; (b) run_fleet_reference at the
               slice (the host solver over 100 cells), 2 rounds, beside
               run_fleet's device solver on the same draws: one fused and
               one tile-norm launch a round, control and apply ms, every
               cell's deadline within 1e-3 of the device solver's; (c)
               run_any on the card (5 clients an FLResult, 128 a
               FleetResult);
 15. tasks   — (a) LinearRegressionTask at the slice (10,000 clients),
               kernel="fused" (the generic path: one tile-norm ranking a
               round, masked_scan_grads, no fused-kernel launch), 5
               rounds: falling loss, rising R^2, rerun bitwise; (b)
               smollm-135m at full width in float32 trained by the fleet
               (TransformerTask, 4 x 8 clients, sequences of 16, batch 2,
               3 rounds; its clients run without remat, as the fleet
               engine's always do, ``TransformerTask.client_task``):
               finite losses, one grouped
               ranking of its 10 leaves a round, no fused launch, the
               wireless model pricing
               32 x param_count bits, rerun bitwise, peak device memory, a
               profiled round and the generic path's time a client; (c)
               15b's model through export_from_result (its last round's
               mean rate), load_pruned and ServeEngine: 8 requests x (16 +
               16) on 8 slots and on 4 (tokens equal) and in wave mode,
               with block-sparse matmul, flash prefill and decode
               attention launches;
 16. dense decode, the llama configs served, MoE — one config at a time,
               each freed before the next: (a) qwen2-7b's dense
               ``decode_step`` in bfloat16 (B = 8, cache 128, 32 prompt
               + 32 greedy tokens: ms a step, tokens/s, peak memory, a
               profiled step, rerun bitwise), then a 2-layer float32
               copy teacher-forced: decode vs forward within 2e-3 on the
               card, card vs CPU within TOL; (b) granite-3-2b in float32
               with a rolling window of 64 over 96 teacher-forced steps:
               positions < 63 equal forward within 2e-3, the last
               differs; a 2-layer copy with the window card vs CPU; (c)
               granite-3-2b and qwen2-7b from seeded bfloat16 weights
               through make_bundle (rho 0.5, one ranking),
               SparseModel(impl="kernel") and ServeEngine: 16 requests x
               (32 + 32) on 16 slots, the first 8 on 4 (tokens equal),
               all in wave mode, launches of all three serving kernels, a
               profiled decode step by kernel, a step's linears through
               the kernel and torch.matmul beside their byte bound, and
               SparseModel against the dense decode on masked params on
               a 2-layer float32 copy at the engine's shape (16 slots,
               cache 64, 63 steps); (d)
               phase 6's smollm-135m bundle by impl="gather" beside
               "kernel": ms a decode step, logits within TOL over 8
               steps, rerun bitwise; (e) olmoe-1b-7b in float32
               (capacity factor 8) decode vs forward within 2e-3, one
               bfloat16 MoE FFN's input and weight grads (8 x 128
               tokens) twice, bitwise equal, then its bfloat16 config
               greedy at B = 8, timed and rerun bitwise.
 17. the recurrent, MLA and memory models — one config at a time at full
               width from seeded random weights in its own bfloat16, each
               freed before the next: (a) xlstm-125m, (b)
               recurrentgemma-2b, (c) minicpm3-4b, (d)
               llama-3.2-vision-11b, (e) whisper-base; each decodes
               greedily at B = 8 (32 prompt + 32 new tokens, cache 128;
               d and e first fill their cross caches with
               fill_cross_caches from seeded stub embeddings, (8, 1600,
               4096) and (8, 1500, 512), e through its 6-layer encoder):
               ms a step beside the byte bound of its weights and caches,
               a profiled step's busy share, peak memory, rerun bitwise;
               then one repeat of each stage in float32 (the depth cut)
               teacher-forced over 12 tokens: decode vs forward within
               2e-3 on the card, card vs CPU within TOL; (a) also trains
               in float32 at full width by a 2 x 4 fleet
               (TransformerTask(arch=...), the generic path), 2 rounds:
               one grouped tile-norm launch a round over its 4-D and 3-D
               leaves, every scan kernel launched under torch.func.vmap
               (``fleet_launches``), rerun bitwise; then xlstm-125m at
               full width in bfloat16 through the launcher's host step
               (remat "block"), 3 steps on one (4, 4096) batch: the loss
               finite and falling, 12 / 6 / 12 / 6 launches a step of
               mlstm_scan / its backward / slstm_scan / its backward
               (the scan rows' ``launches``: the main path of these
               kernels), a rerun bitwise, ms a warm step, peak memory
               and the scan kernels' share of a profiled step's device
               time.
 18. the training launcher and the mesh trainer — (a) ``launch.train.main``
               in this process on the card at smollm-135m's smoke width:
               20 Adam steps (the last logged loss below the first), 10
               ``--fl`` steps over a world of one rank (NCCL; one
               tile-norm launch a step; the ranking of its seeded smoke
               params, float32 and ragged at block 16, against its plain
               version and its tile keeps against the plain norms'), 5
               steps with ``--ckpt`` (restored bitwise equal to a
               replay); (b) smollm-135m at full width
               (bfloat16 params from a seed) through the launcher's host
               step (Adam at lr 1e-3 after clipping), 10 steps of (8, 128)
               TokenStream tokens at the config's ``remat="block"``: the
               loss falling, a rerun bitwise, ms a warm step, peak memory,
               the same steps at ``remat="none"`` (losses within 1e-6
               relative, its ms and peak memory), a profiled step; the
               prefill step
               against forward's last position (1e-5), the serve step
               against decode_step (bitwise); a 2-layer float32 cut card
               vs CPU, 3 host steps each from the CPU's state (m and v
               within TOL of each row's largest, the params within TOL
               wherever the rows' measured gap cannot move Adam's step
               further, the share held printed); (c) the FL step (``federated.trainer``) at full width
               on a world of one rank, block 16, rho 0.3: one tile-norm
               launch a step, the ranking against its plain version
               (``norms_regime``) and its tile keeps against the plain
               norms' (near ties only), achieved rho within 0.15 of 0.3,
               a rerun bitwise, an all-dropped step leaving the params
               bitwise, rho = 0 against make_train_step (1e-5); (d) the FL
               step on two ranks sharing the card over gloo (two
               processes with a timeout) at the smoke width, rho [0.3,
               0.5], k [40, 30], arrivals [1, 0] and [1, 1]: both ranks'
               params bitwise equal and within 1e-5 of the Eq.-(5)
               aggregate of the two clients' masked gradients, its masks
               built here from the plain tile norms; the ranking of these
               params held as in (a).
 19. the FL step with each client's weights sharded over "model"
               (``tp_shard_params``, DTensor) — (a) four ranks sharing
               the card over gloo (four processes with a timeout) on a
               ("data" 2, "model" 2) mesh at qwen2-7b's smoke width
               (float32, seeded qkv biases), 2 steps at block 16 and at
               block 128: local shards within 1e-5 of the slices of the
               unsharded step's params, the sharded ranking's masks
               bitwise those of the same params whole, one tile-norm
               launch a step a rank, no leaf gathered at block 16 and
               the gathered leaves counted at block 128, metrics equal
               on every rank, the two ranks of each "model" coordinate
               bitwise equal; the kernel on rank (0, 0)'s local shards
               against its plain version (``norms_regime``); (b) with
               four cards, ``torchrun`` (NCCL, a card a rank): qwen2-7b
               at full width in bfloat16 from a seed, block 128, per-
               client batch (8, 128), rho [0.3, 0.5], k [40, 30], lr
               1e-2, 3 steps: losses, ms a warm step, peak memory a
               card, one tile-norm launch a step a rank and no leaf
               gathered, shards bitwise equal across clients after each
               step, a rerun bitwise, the 2-layer float32 cut against
               the unsharded step within 1e-5 with equal tile keeps;
               with fewer cards one line says so.  ``python3
               chip_smoke.py --phase19b`` runs phases 1, 2 (the tile-norm
               kernel alone) and 19b.
 20. the fleet engine on a ("cells" 2, "data" 2) mesh (``make_fleet_mesh``,
               ``run_fleet(mesh=...)``) — each rank runs each path meshless
               on its card, then on the mesh, 3 rounds (control, apply and
               the all-reduce timed, launches counted), then again: (a)
               four ranks sharing the card over gloo (four processes with
               a timeout; first a probe of gloo's all-reduce and
               all-gather of CUDA tensors) at the slice: the sync fused
               round and the uniform cohort (10 of 100 a cell,
               control_chunk 25): every control bitwise the meshless
               run's, losses and params within TOL of it, params bitwise
               equal on every rank, a rerun bitwise, one fused and one
               tile-norm launch a round a rank, one all-reduce and one
               all-gather a round a rank; (b) with four cards,
               ``torchrun`` (NCCL, a card a rank): a million clients
               (1,000 x 1,000, streamed, cell_chunk 100), full
               participation and the cohort (100 a cell, control_chunk
               250), the same gates (3 fused launches a round a rank),
               peak memory a card and a profiled round's busy share; with
               fewer cards one line says so.  ``--phase20a`` runs phases
               1, 2 (the two fleet kernels) and 20a, ``--phase20b`` 1, 2
               and 20b.
 21. the dry run and the roofline (``launch.dryrun``, ``launch.roofline``)
               — (a) phase 18b's warm host step at smollm-135m's full
               width as a roofline share: ``model_flops`` of its B x S
               tokens (6 N D) over (ms x 989 TFLOP/s, the bfloat16
               peak), beside the card's name and power limit; (b) in six
               processes of their own, started together with phase 20
               (no card,
               ``CUDA_VISIBLE_DEVICES`` empty), ``python -m
               repro_torch.launch.dryrun --arch smollm-135m --shape
               decode_32k``, ``--arch qwen2-7b --shape train_4k``, the
               same with ``--fl`` (the pruned-FL step, which trains the
               config's remat "block") and
               ``--arch xlstm-125m --shape train_4k`` (a fake group of
               256 ranks, the step traced on the 16 x 16 mesh under
               ``FakeTensorMode``), ``--fleet`` (512 ranks,
               the fleet engine's cell solve and gradient sum) and
               ``python -m repro_torch.launch.diagnose --arch qwen2-7b
               --shape decode_32k``: their output printed, ``OK`` and
               ``0 failed`` or exit 0; fails if the fake group or
               ``FakeTensorMode`` is missing, if the qwen2-7b decode's
               peak exceeds 8 GiB a chip, an all-gather is among its
               biggest tensors or a stacked cache holds more than a data
               shard's 8 rows, or if any train step's peak is not
               under 70 GiB.
               ``--phase21`` runs phases 1 and 21b.
 22. the example entry points (``repro_torch.examples``) as users run
               them, nine processes of their own started together
               (``PYTHONPATH=src``, each with a timeout):
               ``python -m repro_torch.examples.tradeoff_playground
               --sweep lambda --seeds 2`` and, through
               ``EXAMPLE_RUNNER`` (the module's ``main`` as ``python -m``
               calls it, then its summary, launch counts and the card's
               peak memory as JSON), ``quickstart`` on the card and with
               ``--device cpu``, ``train_federated --rounds 4``,
               ``fleet_sim --kernel fused --rounds 5`` (16 x 64 clients,
               the paper's MLP at full width), ``fleet_sim --smoke
               --async``, ``fleet_sim --task transformer --smoke`` with
               ``--metrics-out``, ``--telemetry-out`` and
               ``--trace-out``, ``pruned_llm_federated --rounds 3`` and
               ``serve_pruned --rounds 2 --steps 16``: each exits 0 and
               prints its summary (printed here), each but the table
               and the CPU quickstart on the card; quickstart's rho and
               B on the card bitwise the CPU run's; the fused fleet
               launches the fused-gradient and tile-norm kernels,
               ``serve_pruned`` decode attention (prompts go through
               decode steps, as the reference script's ``generate``
               does: no flash prefill) and prints equal gather and
               dense tokens; the files parse
               (the metrics JSON with the reference script's keys).
               ``--phase22`` runs phases 1, 2 and 22.
Phase 5 also compares hex, two-tier sync and async, Dirichlet and
streaming fleets card against CPU.  Phases 7-12 print each round or
event's wall (control, apply), loss, participants and launches, and rerun
bitwise.  The line before the last is the kernels JSON (the fleet rows
also carry the launches of phases 7-15: ``telemetry_launches`` phase
13a's, ``host_reference_launches`` phase 14b's, ``linreg_launches`` and
``transformer_launches`` phase 15a's and 15b's, and row 2
``fl_run_launches`` phase 14a's and ``moe_fleet_launches`` phase 5's
olmoe-1b-7b fleet; the serving rows and row 2 carry
``exported_serve_launches``, phase 15c's, and ``served_launches``, phase
16c's; the serving rows ``gather_launches``, 16d's gather impl's, and
``gather_kernel_launches``, 16d's kernel impl's; row 2
``xlstm_fleet_launches``, 17a's fleet's, and ``xlstm_*``, the tile norms
on 17a's ranking; row 2 ``train_cli_fl_launches``, ``fl_step_launches``
and ``fl_two_rank_launches``, phase 18a's ``--fl`` run's, 18c's and 18d's
two ranks', and ``fl_block16_*``, the tile norms on 18c's ranking; row 2
``tp_shard_launches``, phase 19a's four ranks' over both blocks, and
``tp_shard_*``, the tile norms on rank (0, 0)'s local shards at block
16; the fleet rows ``fleet_mesh_launches``, phase 20a's four ranks'
over both paths; the four scan rows ``launches``, 17a's host step's, and
``fleet_launches``, 17a's fleet's; the fleet and serving rows
``examples_launches``, phase 22's ``fleet_sim --kernel fused``'s and
``serve_pruned``'s).  A row's ``ms`` is a
``torch.profiler`` device time, except the four scan rows', which are
CUDA-event times over back-to-back launches (see ``time_scan``); the
last line is the device JSON.
Peak rates for bounds: H100 SXM at 700 W, 67 TFLOP/s float32 without tensor
cores and 3.35 TB/s (the card's own limit is printed beside them).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
BLOCK = 8
SLICE_CELLS, SLICE_PER_CELL, SLICE_ROUNDS = 100, 100, 5
DNN = dict(feature_dim=784, hidden=(60, 20), num_classes=10, local_batch=8,
           prune_block=BLOCK)
TOL = 1e-4
# the engine's record_function phases and run_fleet's spans: a profile
# shows each as a device-side annotation over its kernels, which is no
# device work of its own
PHASES = ("fleet.channel", "fleet.solve", "fleet.gradient", "fleet.merge",
          "fleet.eval", "fleet.cloud_merge")
ANNOTATIONS = frozenset(PHASES + ("fleet.build", "fleet.simulate",
                                  "fleet.finalize"))


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(msg: str) -> None:
    """A phase's header, with the seconds since the script started."""
    log(f"{msg} (t = {time.perf_counter() - T0:.1f} s)")


def cuda_ms(fn, iters: int) -> float:
    """Mean time of one ``fn`` call in ms, CUDA events around ``iters`` warm
    calls (the host's dispatch between launches included)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernels: tuple = ()) -> float:
    """Mean device time of one ``fn`` call in ms: torch.profiler's self
    device time over ``iters`` warm calls, summed over the device kernels
    whose name holds one of ``kernels`` (every device op when empty).
    Unlike ``cuda_ms`` it leaves out the host's dispatch between launches.
    Where the profiler records no device time it falls back to
    ``cuda_ms`` and says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key not in ANNOTATIONS
                   and (not kernels or any(k in e.key for k in kernels)))
    if total_us <= 0:
        log(f"  profiler recorded no device time for "
            f"{kernels or 'the call'}: CUDA-event time instead")
        return cuda_ms(fn, iters)
    return total_us / iters / 1e3


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    diff = float((a - b).abs().max())
    return diff, diff / max(float(b.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# Phase 3: the kernels against their plain versions
# ---------------------------------------------------------------------------

def smollm_ranking(param_dtype: str = "bfloat16") -> tuple[list, list]:
    """smollm-135m's prunable leaves at full width, drawn on the card from
    a seed in ``param_dtype``, and their tile grid: what ``make_bundle``
    ranks in phase 6 (bfloat16, the config's), and what phase 15b's
    fleet ranks every round (float32)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fleet.task import TransformerTask
    task = TransformerTask(arch=get_config("smollm-135m").replace(
        param_dtype=param_dtype))
    return task_ranking(task, task.init_params(
        torch.Generator(device="cuda").manual_seed(SERVE_SEED)))


def task_ranking(task, params) -> tuple[list, list]:
    """The leaves of ``params`` and their (bk, bn) tiles that ``task``'s
    round ranks in its one tile-norm launch (the selection of
    ``pruning.block_norm_state``)."""
    from repro_torch.core import pruning
    leaves = pruning.flatten(params)
    flags = [pruning.prunable((), w) for w in leaves]
    blocks = pruning.leaf_blocks(flags, task.tile_grid(params))
    return ([w for w, f in zip(leaves, flags) if f],
            [b for b in blocks if b is not None])


def norms_regime(what: str, leaves, blocks, iters: int, plain_iters: int,
                 floor_ms: float, card: str) -> dict:
    """The tile-norm kernel on one ranking's leaves: every leaf within TOL
    of the plain version and bitwise equal alone, in the group and on a
    rerun; then the group call's device time (``ms``) and CUDA-event time
    (``call_ms``) beside the plain version's, one einsum a leaf on its
    tiles zero-padded outside the timed call (the library call), the byte
    bound and the launch floor."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import block_norms as BN

    got = BN.tile_norms_group(leaves, blocks)
    again = BN.tile_norms_group(leaves, blocks)
    ref = BN.tile_norms_group_plain(leaves, blocks)
    torch.cuda.synchronize()
    worst = worst_rel = 0.0
    for w, (bk, bn), g, a, r in zip(leaves, blocks, got, again, ref):
        diff, rel = rel_err(g, r)
        worst, worst_rel = max(worst, diff), max(worst_rel, rel)
        if rel > TOL:
            raise AssertionError(f"tile_norms disagrees at {tuple(w.shape)}"
                                 f" ({bk}, {bn}): rel {rel:.3e}")
        if not torch.equal(g, a):
            raise AssertionError(f"tile_norms rerun differs at "
                                 f"{tuple(w.shape)}")
        if not torch.equal(g, BN.tile_norms(w, bk, bn)):
            raise AssertionError(f"tile_norms alone differs from the group "
                                 f"at {tuple(w.shape)}")
    tiles = sum(g.numel() for g in got)
    log(f"  tile_norms {what}: {len(leaves)} leaves, {tiles} tiles, "
        f"max_abs_err={worst:.3e} rel={worst_rel:.3e} (tol {TOL}); alone, "
        f"grouped and rerun bitwise equal")

    def call():
        return BN.tile_norms_group(leaves, blocks)
    ms = device_ms(call, iters, ("tile_norms_kernel",))
    call_ms = cuda_ms(call, iters)
    plain_ms = device_ms(lambda: BN.tile_norms_group_plain(leaves, blocks),
                         plain_iters)
    padded = []
    for w, (bk, bn) in zip(leaves, blocks):
        wp = F.pad(w, (0, (-w.shape[-1]) % bn, 0, (-w.shape[-2]) % bk))
        kp, np_ = wp.shape[-2:]
        padded.append(wp.reshape(tuple(w.shape[:-2])
                                 + (kp // bk, bk, np_ // bn, bn)))
    library_ms = device_ms(lambda: [torch.einsum("...ikjl,...ikjl->...ij",
                                                 v, v) for v in padded],
                           iters)
    del padded
    nbytes = sum(w.numel() * w.element_size() for w in leaves) + 4 * tiles
    bound, bound_by = bound_ms(nbytes,
                               2.0 * sum(w.numel() for w in leaves))
    dtypes = sorted({str(w.dtype).replace("torch.", "") for w in leaves})
    log(f"  tile_norms {what}: {ms:.5f} ms kernel on the device "
        f"({call_ms:.5f} ms a call, dispatch included); launch floor "
        f"{floor_ms:.5f} ms, bound {bound:.6f} ms ({bound_by}: "
        f"{nbytes / 1e6:.2f} MB of {'/'.join(dtypes)}); plain "
        f"{plain_ms:.5f} ms, einsum {library_ms:.5f} ms [{card}]")
    return dict(max_abs_err=worst, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=library_ms)


def check_tile_norms(params, card: str) -> dict:
    """Both regimes of the tile norms: the fleet round's ranking (the main
    path's; the row's own keys) and smollm-135m's bundle (``bundle_*``),
    beside the device time of an empty launch (``launch_floor_ms``)."""
    from repro_torch.kernels import block_norms as BN
    floor_ms = device_ms(BN.empty_launch, 50, ("empty_kernel",))
    log(f"  launch floor (an empty kernel): {floor_ms:.5f} ms on the device "
        f"[{card}]")
    from repro_torch.kernels import fleet_fused as FF
    ws = [params[f"layer{i}"]["w"] for i in range(len(params))]
    fleet = norms_regime(f"fleet ({len(ws)} layers, block {BLOCK})", ws,
                         [(BLOCK, BLOCK)] * len(ws), 50, 50, floor_ms, card)
    from repro_torch.federated.system import STRUCTURED_BLOCK as FL_BLOCK
    dnn = norms_regime(f"the §V DNN's leaves (block {FL_BLOCK}, ragged "
                       f"edges; phase 14's ranking)", ws,
                       [(FL_BLOCK, FL_BLOCK)] * len(ws), 50, 50, floor_ms,
                       card)
    rank_ms = cuda_ms(lambda: FF.layer_norm_states(params, BLOCK), 20)
    log(f"  the round's whole ranking (layer_norm_states: norms, then a sort "
        f"and a cumulative sum a layer): {rank_ms:.5f} ms a call, dispatch "
        f"included [{card}]")
    leaves, blocks = smollm_ranking()
    bundle = norms_regime("smollm-135m bundle (auto_tile_grid)", leaves,
                          blocks, 20, 3, floor_ms, card)
    del leaves
    leaves, blocks = smollm_ranking("float32")
    f32 = norms_regime("smollm-135m float32 (phase 15b's ranking)", leaves,
                       blocks, 20, 3, floor_ms, card)
    del leaves
    row = dict(name="tile_norms", route="cuda",
               source="src/repro_torch/kernels/csrc/block_norms.cu",
               replaces="src/repro/kernels/block_norms.py:24", **fleet)
    row["max_abs_err"] = max(fleet["max_abs_err"], bundle["max_abs_err"],
                             dnn["max_abs_err"], f32["max_abs_err"])
    row.update({f"smollm_f32_{k}": v for k, v in f32.items()
                if k != "max_abs_err"})
    row["block16_ms"] = dnn["ms"]
    row["launch_floor_ms"] = floor_ms
    row.update({f"bundle_{k}": v for k, v in bundle.items()
                if k != "max_abs_err"})
    return row


# every csrc kernel the fused call can launch; fused_split checks that each
# launch the wrapper records is one of these and that the profiler saw
# exactly those launches
FUSED_KERNELS = ("wide_rows_kernel", "masked_rows_kernel", "loss_kernel",
                 "wide_dw_kernel", "dw_partial_kernel",
                 "reduce_segments_kernel")


def fused_bound_ms(params, x, keeps) -> tuple[float, str]:
    """Least time for the fused call on these inputs: kept-tile MACs of the
    forward, dW and (layers > 0) dA products at the float32 peak, against
    each input read once and each output written once at the HBM rate."""
    import torch
    c, batch, _ = x.shape
    macs = 0.0
    nbytes = x.numel() * 4 + c * batch * 8 + c * 4 * 2   # x, y, weights, losses
    for l, k in enumerate(keeps):
        kdim, ndim = params[f"layer{l}"]["w"].shape
        ks = torch.tensor([min(BLOCK, kdim - s) for s in range(0, kdim, BLOCK)],
                          device=k.device, dtype=torch.float64)
        ns = torch.tensor([min(BLOCK, ndim - s) for s in range(0, ndim, BLOCK)],
                          device=k.device, dtype=torch.float64)
        kept = float(torch.einsum("ctn,t,n->", k.double(), ks, ns))
        macs += kept * batch * (3 if l > 0 else 2)
        nbytes += k.numel() * 4 + 2 * (kdim * ndim + ndim) * 4
    t_ops = 2 * macs / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fused_floor_ms(params, x, keeps) -> tuple[float, float]:
    """The floor of the call's two-pass design (row passes, then dW passes
    over row segments): every MAC of the dense forward, dW and (layers > 0)
    dA products at the float32 peak; x read twice (forward and dW), each
    layer's z and dz workspace written once and read once, the keeps read
    twice and the dW partials written and read once, at the HBM rate.
    Returns (ops ms, bytes ms)."""
    from repro_torch.kernels import fleet_fused as FF
    c, batch, _ = x.shape
    rows = c * batch
    nseg = FF.segments(rows)[1]
    macs = 0.0
    nbytes = 2 * x.numel() * 4 + rows * 8 + c * 4 * 2
    for l, k in enumerate(keeps):
        kdim, ndim = params[f"layer{l}"]["w"].shape
        macs += rows * kdim * ndim * (3 if l > 0 else 2)
        nbytes += (4 * rows * ndim * 4 + 2 * k.numel() * 4
                   + 2 * nseg * (kdim + 1) * ndim * 4
                   + 2 * (kdim * ndim + ndim) * 4)
    return 2 * macs / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def warm_profiler() -> None:
    """One throwaway torch.profiler session around a few launches, so that
    the profiler's lazy start-up (CUPTI's) happens outside every measured
    session."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(8):
            x.mul_(1.0)
        torch.cuda.synchronize()


def split_mismatch(ops, passes, iters: int) -> str:
    """Why the profiled device ops are not ``iters`` copies of ``passes``
    in order ("" where they are)."""
    want = [kernel for _ in range(iters) for kernel, _ in passes]
    for i, (kernel, e) in enumerate(zip(want, ops)):
        if kernel not in e.name:
            return (f"device op {i} (launch {i % len(passes)}, "
                    f"{passes[i % len(passes)][1]}) ran {e.name[:80]}, "
                    f"not {kernel}")
    if len(ops) != len(want):
        return (f"profiler saw {len(ops)} device ops in {iters} calls of "
                f"{len(passes)} launches")
    return ""


def fused_split(call, iters: int, card: str, passes=None,
                sessions: int = 3) -> dict:
    """Device ms of one fused call by pass, from torch.profiler over
    ``iters`` warm calls.  The wrapper records the (kernel, pass) of each
    launch it makes (``passes`` gives them for another launch sequence);
    every device op the profiler sees must be those launches, in that
    order, each of a kernel in FUSED_KERNELS, so no launch is left out of
    the sum or counted twice.  A session whose record breaks that (the
    profiler can drop a device event) is logged and profiled again, at
    most ``sessions`` times in all; the sum is only ever taken over a
    complete record."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import fleet_fused as FF
    call()
    torch.cuda.synchronize()
    if passes is None:
        passes = FF.fused_fleet_grads.last_passes
    stray = sorted({k for k, _ in passes} - set(FUSED_KERNELS))
    if stray:
        raise AssertionError(f"FUSED_KERNELS lacks {stray}")
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        why = split_mismatch(ops, passes, iters)
        if not why:
            break
        log(f"  fused call split, profiled session {session} of at most "
            f"{sessions}: {why}")
    else:
        raise AssertionError(f"no complete profiler record in {sessions} "
                             f"sessions: {why}")
    by_pass = {label: 0.0 for _, label in passes}
    by_kernel = {k: 0.0 for k, _ in passes}
    for i, e in enumerate(ops):
        kernel, label = passes[i % len(passes)]
        us = e.time_range.elapsed_us() / iters
        by_pass[label] += us / 1e3
        by_kernel[kernel] += us / 1e3
    total = sum(by_pass.values())
    log(f"  fused call split ({len(passes)} launches a call, {iters} calls "
        f"profiled, {total:.4f} ms a call) [{card}]:")
    for label, ms in by_pass.items():
        log(f"    {label:12s} {ms:8.4f} ms  {100 * ms / total:5.1f}%")
    log("    by kernel: " + ", ".join(f"{k} {ms:.4f} ms"
                                      for k, ms in by_kernel.items()))
    return by_pass


def fused_cases(params, data) -> list:
    """(name, wrapper arguments) of phase 3's fused cases at the slice's
    model and fleet; the second is the timed one, the last two have C = 1001
    and C = 100 (one cell of a two-tier round: 32-row dW segments)."""
    import torch
    from repro_torch.kernels import fleet_fused as FF
    dev = data["x"].device
    c = data["x"].shape[0]
    g = torch.Generator(device=dev).manual_seed(1234)
    states = FF.layer_norm_states(params, BLOCK)
    w_mixed = torch.rand((c,), generator=g, device=dev) * 48 + 16
    rho_mixed = torch.rand((c,), generator=g, device=dev) * 0.7

    def case(name, rho, weights, n=c, kill=None):
        keeps = FF.layer_keeps(states, rho[:n])
        if kill is not None:
            for k in keeps:
                k[kill] = 0.0
        return name, (params, data["x"][:n], data["y"][:n], keeps,
                      weights[:n].contiguous(), BLOCK)

    w_zero = w_mixed.clone()
    w_zero[7] = 0.0
    return [case("rho=0", torch.zeros_like(rho_mixed), w_mixed),
            case("rho~U[0,0.7]", rho_mixed, w_mixed),
            case("one client prunes all", rho_mixed, w_mixed, kill=3),
            case("zero-weight client", rho_mixed, w_zero),
            case("C=1001 (not a tile multiple)", rho_mixed, w_mixed, n=1001),
            case("C=100 (a two-tier cell)", rho_mixed, w_mixed, n=100)]


def check_fused(params, data, card: str) -> dict:
    import torch
    from repro_torch.kernels import fleet_fused as FF
    c = data["x"].shape[0]
    cases = fused_cases(params, data)
    worst = 0.0
    for name, args in cases:
        grads, losses = FF.fused_fleet_grads(*args)
        ref_g, ref_l = FF.fused_grads_plain(*args)
        torch.cuda.synchronize()
        errs = [rel_err(losses, ref_l)]
        errs += [rel_err(grads[k][leaf], ref_g[k][leaf])
                 for k in ref_g for leaf in ("w", "b")]
        diff = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        worst = max(worst, diff)
        log(f"  fused_fleet_grads [{name}]: max_abs_err={diff:.3e} "
            f"rel={rel:.3e} (tol {TOL})")
        if rel > TOL or not torch.isfinite(losses).all():
            raise AssertionError(f"fused kernel disagrees: {name}")
    args = cases[1][1]
    split = fused_split(lambda: FF.fused_fleet_grads(*args), 10, card)
    ms = sum(split.values())
    call_ms = cuda_ms(lambda: FF.fused_fleet_grads(*args), 10)
    plain_ms = device_ms(lambda: FF.fused_grads_plain(*args), 3)
    bound, bound_by = fused_bound_ms(params, args[1], args[3])
    floor_ops, floor_bytes = fused_floor_ms(params, args[1], args[3])
    log(f"  fused_fleet_grads (C={c}, rho~U[0,0.7]): {ms:.3f} ms kernels on "
        f"the device ({call_ms:.3f} ms a call), {plain_ms:.3f} ms plain, "
        f"bound {bound:.4f} ms ({bound_by}; kept tiles, x read once); "
        f"two-pass floor {max(floor_ops, floor_bytes):.4f} ms (dense MACs "
        f"{floor_ops:.4f} ms, x read twice and workspaces {floor_bytes:.4f}"
        f" ms) [{card}]")
    return dict(name="fleet_fused_grads", route="cuda",
                source="src/repro_torch/kernels/csrc/fleet_fused.cu",
                replaces="src/repro/kernels/fleet_fused.py:331",
                max_abs_err=worst, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=None)


# ---------------------------------------------------------------------------
# Phase 3 (serving kernels): smollm-135m's shapes
# ---------------------------------------------------------------------------

# every distinct (K, N, bk, bn) of smollm-135m's linears on its tile grid
# (auto_tile_grid, target_tiles=8): wq/wo, wk/wv, w_in/w_gate, w_out and
# the tied unembedding
SERVE_LINEARS = {"wq": (576, 576, 72, 72), "wk": (576, 192, 72, 24),
                 "w_in": (576, 1536, 72, 192), "w_out": (1536, 576, 192, 72),
                 "unembed": (576, 49152, 72, 6144)}
# one decode step's linears: 30 layers x (wq, wk, wv, wo, w_in, w_gate,
# w_out) and the unembedding
STEP_LINEARS = ["wq", "wk", "wk", "wq", "w_in", "w_in", "w_out"]
SERVE_LAYERS, SERVE_KV, SERVE_GROUP, SERVE_HD = 30, 3, 3, 64
SERVE_BATCH, SERVE_PAGE, SERVE_PROMPT, SERVE_NEW = 32, 128, 32, 32
# the configs phase 16c serves at full width
SERVED_CONFIGS = ("granite-3-2b", "qwen2-7b")


def served_linears(name: str) -> dict:
    """Every distinct (K, N, bk, bn) of ``name``'s served linears on the
    tile grid ``make_bundle`` gives it (params drawn on ``meta``: nothing
    is allocated), keyed by the linears that share it; a tied embedding
    is served transposed, on its grid transposed."""
    from repro_torch.configs import get_config
    from repro_torch.core import pruning
    from repro_torch.fleet.task import TransformerTask
    cfg = get_config(name)
    task = TransformerTask(arch=cfg)
    params = task.init_params(None)
    grid, leaves = task.tile_grid(params), pruning.flatten(params)
    idx = pruning.unflatten(params, list(range(len(leaves))))
    shapes: dict = {}
    for si, stage in enumerate(cfg.stages):
        for bi in range(len(stage.blocks)):
            block = idx["stages"][si][f"b{bi}"]
            for part in ("attn", "ffn"):
                for lin, node in block.get(part, {}).items():
                    i = node["w"]
                    shapes.setdefault((*leaves[i].shape[-2:], *grid[i]),
                                      []).append(lin)
    if cfg.tie_embeddings:
        i = idx["embed"]["embedding"]
        (v, d), (bv, bd) = leaves[i].shape, grid[i]
        shapes.setdefault((d, v, bd, bv), []).append("unembed")
    else:
        i = idx["unembed"]["w"]
        shapes.setdefault((*leaves[i].shape, *grid[i]), []).append("unembed")
    return {"/".join(dict.fromkeys(lins)): tuple(int(n) for n in shape)
            for shape, lins in shapes.items()}


def random_keep(kdim, ndim, bk, bn, rho, g):
    import torch
    return (torch.rand(-(-kdim // bk), -(-ndim // bn), generator=g,
                       device="cuda") >= rho).float()


def kept_elements(keep, kdim, ndim, bk, bn) -> float:
    """Real (unpadded) W elements under kept tiles."""
    import torch
    rows = torch.tensor([min(bk, kdim - s) for s in range(0, kdim, bk)],
                        device=keep.device, dtype=torch.float64)
    cols = torch.tensor([min(bn, ndim - s) for s in range(0, ndim, bn)],
                        device=keep.device, dtype=torch.float64)
    return float(torch.einsum("tn,t,n->", (keep != 0).double(), rows, cols))


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The larger of the bytes at the HBM rate and the float32 operations
    at the peak rate, in ms, and which of the two it is."""
    t_ops = ops / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def matmul_bound_ms(cases, transpose) -> tuple[float, str]:
    """Least time for these products: kept-tile MACs at the float32 peak
    against x, the kept W bytes, the mask and y at the HBM rate."""
    ops = nbytes = 0.0
    for x, w, keep, bk, bn in cases:
        kdim, ndim = w.shape
        kept = kept_elements(keep, kdim, ndim, bk, bn)
        m = x.shape[0]
        ops += 2.0 * m * kept
        nbytes += 4.0 * (x.numel() + kept + keep.numel()
                         + m * (kdim if transpose else ndim))
    return bound_ms(nbytes, ops)


def hold_linears(fn, name: str, transpose: bool, linears: dict, ms_: tuple,
                 g, label: str = "") -> float:
    """Each (K, N, bk, bn) of ``linears`` at M in ``ms_`` and rho in
    {0, 0.5, 1} against the plain version; returns the largest
    |difference|."""
    import torch
    from repro_torch.kernels import block_sparse_matmul as BSM
    worst = 0.0
    for lin, (kdim, ndim, bk, bn) in linears.items():
        w = torch.randn(kdim, ndim, generator=g, device="cuda")
        shape_diff = shape_rel = 0.0
        for m in ms_:
            x = torch.randn(m, kdim if not transpose else ndim, generator=g,
                            device="cuda")
            for rho in (0.0, 0.5, 1.0):
                keep = random_keep(kdim, ndim, bk, bn, rho, g)
                got = fn(x, w, keep, bk, bn)
                ref = BSM.block_sparse_matmul_plain(x, w, keep, bk, bn,
                                                    transpose)
                torch.cuda.synchronize()
                diff, rel = rel_err(got, ref)
                shape_diff = max(shape_diff, diff)
                shape_rel = max(shape_rel, rel)
                if rel > TOL:
                    raise AssertionError(
                        f"{name} disagrees: {label}{lin} M={m} rho={rho} "
                        f"rel={rel:.3e}")
        worst = max(worst, shape_diff)
        log(f"  {name} {label}{lin} ({kdim}x{ndim}, tiles {bk}x{bn}), M in "
            f"{ms_} x rho in (0, 0.5, 1): max_abs_err={shape_diff:.3e}"
            f" rel={shape_rel:.3e} (tol {TOL})")
        del w
    return worst


def check_matmul(card: str, transpose: bool) -> dict:
    """Every distinct linear shape at M in {1, 32, 1024} and rho in
    {0, 0.5, 1} against the plain version; then one decode step's worth
    of products (30 layers + unembedding, B = 32, rho = 0.5) timed.  The
    forward kernel is also held at phase 16c's linears: granite-3-2b's
    and qwen2-7b's on their own tile grids, at the M their engine gives
    them (decode on 16 and on 4 slots, one token, the 16 x 32 prefill
    wave)."""
    import torch
    from repro_torch.kernels import block_sparse_matmul as BSM
    fn = BSM.block_sparse_matmul_t if transpose else BSM.block_sparse_matmul
    name = "block_sparse_matmul_t" if transpose else "block_sparse_matmul"
    g = torch.Generator(device="cuda").manual_seed(11 + transpose)
    worst = hold_linears(fn, name, transpose, SERVE_LINEARS, (1, 32, 1024),
                         g)
    # one decode step's products at B = 32, rho = 0.5
    cases = []
    for lin in STEP_LINEARS * SERVE_LAYERS + ["unembed"]:
        kdim, ndim, bk, bn = SERVE_LINEARS[lin]
        w = torch.randn(kdim, ndim, generator=g, device="cuda")
        x = torch.randn(SERVE_BATCH, ndim if transpose else kdim,
                        generator=g, device="cuda")
        cases.append((x, w, random_keep(kdim, ndim, bk, bn, 0.5, g), bk, bn))
    masked = [torch.where(BSM.expand_mask(k, w.shape, bk, bn), w, 0.0)
              for _, w, k, bk, bn in cases]
    ms = device_ms(lambda: [fn(*c) for c in cases], 10, ("bsmm_kernel",))
    call_ms = cuda_ms(lambda: [fn(*c) for c in cases], 10)
    plain_ms = device_ms(lambda: [BSM.block_sparse_matmul_plain(*c, transpose)
                                  for c in cases], 5)
    lib_ms = device_ms(lambda: [torch.matmul(c[0], wm.T if transpose else wm)
                                for c, wm in zip(cases, masked)], 10)
    bound, bound_by = matmul_bound_ms(cases, transpose)
    log(f"  {name} one decode step ({len(cases)} products, B="
        f"{SERVE_BATCH}, rho=0.5): {ms:.4f} ms kernel on the device "
        f"({call_ms:.4f} ms a call), {plain_ms:.4f} ms plain, {lib_ms:.4f} "
        f"ms torch.matmul on masked W, bound "
        f"{bound:.4f} ms ({bound_by}) [{card}]")
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/block_sparse_matmul.cu",
               replaces="src/repro/kernels/block_sparse_matmul.py:"
                        + ("50" if transpose else "74"),
               max_abs_err=worst, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)
    if not transpose:
        matmul_by_shape(fn, cases, masked, card)
        row.update(matmul_wave(fn, cases, masked, g, card))
        del cases, masked
        served_ms = (1, SERVED_FEW, SERVED_SLOTS,
                     SERVED_SLOTS * SERVED_PROMPT)
        for cfg_name in SERVED_CONFIGS:
            row["max_abs_err"] = max(row["max_abs_err"], hold_linears(
                fn, name, False, served_linears(cfg_name), served_ms, g,
                f"{cfg_name} "))
        torch.cuda.empty_cache()
    return row


def matmul_by_shape(fn, cases, masked, card: str) -> None:
    """The decode step's products by serving shape (B = 32): launches per
    step, device time of one product, its bound and torch.matmul's."""
    import torch
    step = STEP_LINEARS * SERVE_LAYERS + ["unembed"]
    for lin in SERVE_LINEARS:
        i = step.index(lin)
        c, wm = cases[i], masked[i]
        ms = device_ms(lambda: fn(*c), 20, ("bsmm_kernel",))
        lib_ms = device_ms(lambda: torch.matmul(c[0], wm), 20)
        bound, bound_by = matmul_bound_ms([c], False)
        log(f"    {lin} {tuple(c[1].shape)}: {step.count(lin)} launches a "
            f"step, {ms:.4f} ms a product on the device, bound {bound:.5f} "
            f"ms ({bound_by}), torch.matmul {lib_ms:.4f} ms [{card}]")


def matmul_wave(fn, cases, masked, g, card: str) -> dict:
    """The same 211 products at the prefill wave's M = 1024 (32 x 32
    tokens) against torch.matmul on the masked W."""
    import torch
    m = SERVE_BATCH * SERVE_PROMPT
    wave = [(torch.randn(m, w.shape[0], generator=g, device="cuda"), w, k,
             bk, bn) for _, w, k, bk, bn in cases]
    ms = device_ms(lambda: [fn(*c) for c in wave], 3, ("bsmm_kernel",))
    lib_ms = device_ms(lambda: [torch.matmul(c[0], wm)
                                for c, wm in zip(wave, masked)], 3)
    bound, bound_by = matmul_bound_ms(wave, False)
    log(f"  block_sparse_matmul prefill wave ({len(wave)} products, M={m}, "
        f"rho=0.5): {ms:.4f} ms kernel on the device, {lib_ms:.4f} ms "
        f"torch.matmul on masked W ({ms / lib_ms:.2f}x), bound {bound:.4f} "
        f"ms ({bound_by}) [{card}]")
    return dict(wave_ms=ms, wave_library_ms=lib_ms, wave_bound_ms=bound)


def sdpa(q, k, v, valid):
    """The library call: scaled_dot_product_attention on (B, H, S, hd)
    layouts with the boolean validity mask and GQA (the timed cases have
    every head live, so no head mask is applied after)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=valid,
                                          enable_gqa=True)


def time_decode(q, k, v, pos, what: str, card: str) -> dict:
    """Device, call, plain and SDPA times of decode attention on these
    inputs (every head live, no window), with its byte bound, on one log
    line."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    b, s = k.shape[0], k.shape[1]
    ms = device_ms(lambda: DA.decode_attention(q, k, v, pos), 50,
                   ("decode_kernel",))
    call_ms = cuda_ms(lambda: DA.decode_attention(q, k, v, pos), 50)
    plain_ms = device_ms(lambda: DA.decode_attention_plain(q, k, v, pos), 20)
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    valid = (torch.arange(s, device="cuda")[None, :]
             <= pos[:, None])[:, None, None, :]
    lib_err = rel_err(sdpa(qs, ks, vs, valid)[:, :, 0],
                      DA.decode_attention_plain(q, k, v, pos))[1]
    lib_ms = device_ms(lambda: sdpa(qs, ks, vs, valid), 50)
    keys = float((torch.clamp_max(pos, s - 1) + 1).sum()) * SERVE_KV
    nbytes = 4.0 * (2 * q.numel() + 2 * keys * SERVE_HD) + 4.0 * b
    ops = 4.0 * keys * SERVE_GROUP * SERVE_HD
    bound, bound_by = bound_ms(nbytes, ops)
    log(f"  decode_attention {what}: {ms:.4f} ms kernel on the device "
        f"({call_ms:.4f} ms a call), {plain_ms:.4f} ms plain, {lib_ms:.4f} "
        f"ms sdpa (rel err vs plain {lib_err:.1e}), bound {bound:.6f} ms "
        f"({bound_by}, {nbytes / 1e6:.1f} MB) [{card}]")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=bound_by)


def check_decode(card: str) -> dict:
    """B = 32 against caches of 128 and 2048, ragged pos with 0 and S - 1,
    a dead head, a window, rows whose window lies past the cache; timed at
    the serving shape (S = 128, pos as the engine's 32 + 32 requests
    reach) and at a long cache (S = 2048, pos uniform in [1024, 2047]:
    ~75 MB of valid K/V, more than the L2 holds)."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    g = torch.Generator(device="cuda").manual_seed(21)
    b, h = SERVE_BATCH, SERVE_KV * SERVE_GROUP

    def inputs(s, pos_hi, pos_lo=0):
        q = torch.randn(b, h, SERVE_HD, generator=g, device="cuda")
        k = torch.randn(b, s, SERVE_KV, SERVE_HD, generator=g, device="cuda")
        v = torch.randn(b, s, SERVE_KV, SERVE_HD, generator=g, device="cuda")
        pos = torch.randint(pos_lo, pos_hi, (b,), generator=g, device="cuda")
        pos[0], pos[1] = pos_lo, pos_hi - 1
        return q, k, v, pos

    dead = torch.tensor([1.0, 0.0, 1.0], device="cuda")
    worst = 0.0
    # the last case puts some rows' windows past the cache's end: no valid
    # key, zeros out
    for s, window, hm, pos_hi in [(128, None, None, 128),
                                  (128, None, dead, 128),
                                  (2048, None, None, 2048),
                                  (2048, 256, dead, 2048),
                                  (128, 16, None, 200)]:
        q, k, v, pos = inputs(s, pos_hi)
        got = DA.decode_attention(q, k, v, pos, window, hm)
        ref = DA.decode_attention_plain(q, k, v, pos, window, hm)
        torch.cuda.synchronize()
        diff, rel = rel_err(got, ref)
        worst = max(worst, diff)
        log(f"  decode_attention S={s} window={window} head_mask="
            f"{None if hm is None else hm.tolist()}: max_abs_err={diff:.3e} "
            f"rel={rel:.3e} (tol {TOL})")
        if rel > TOL:
            raise AssertionError("decode_attention disagrees")
    worst = max(worst, check_served_decode(g))
    serve = time_decode(*inputs(SERVE_PAGE, SERVE_PROMPT + SERVE_NEW - 1),
                        f"(B={b}, S={SERVE_PAGE}, pos < "
                        f"{SERVE_PROMPT + SERVE_NEW - 1})", card)
    long = time_decode(*inputs(2048, 2048, 1024),
                       f"long cache (B={b}, S=2048, pos in [1024, 2047])",
                       card)
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:88",
                max_abs_err=worst, **serve,
                **{f"long_{key}": val for key, val in long.items()})


def check_served_decode(g) -> float:
    """Phase 16c's decode attention: granite-3-2b's and qwen2-7b's head
    layouts on their engine's 16 and 4 slots over its cache of 32 + 32
    (ragged pos with 0 and the last slot), all heads live, one dead, and
    a window with one dead, against the plain version; returns the
    largest |difference|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    s = SERVED_PROMPT + SERVED_NEW
    worst = 0.0
    for name in SERVED_CONFIGS:
        sp = get_config(name).attn_spec("attn")
        hkv, hd = sp.num_kv_heads, sp.head_dim
        group = sp.num_heads // hkv
        dead = torch.ones(hkv, device="cuda")
        dead[1] = 0.0
        for b in (SERVED_SLOTS, SERVED_FEW):
            for window, hm in [(None, None), (None, dead), (24, dead)]:
                q = torch.randn(b, hkv * group, hd, generator=g,
                                device="cuda")
                k = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
                v = torch.randn(b, s, hkv, hd, generator=g, device="cuda")
                pos = torch.randint(0, s, (b,), generator=g, device="cuda")
                pos[0], pos[1] = 0, s - 1
                got = DA.decode_attention(q, k, v, pos, window, hm)
                ref = DA.decode_attention_plain(q, k, v, pos, window, hm)
                torch.cuda.synchronize()
                diff, rel = rel_err(got, ref)
                worst = max(worst, diff)
                log(f"  decode_attention {name} (G={group}, hd={hd}, "
                    f"Hkv={hkv}) B={b} S={s} window={window} head 1 "
                    f"{'live' if hm is None else 'dead'}: max_abs_err="
                    f"{diff:.3e} rel={rel:.3e} (tol {TOL})")
                if rel > TOL:
                    raise AssertionError(f"decode_attention disagrees at "
                                         f"{name}'s head layout")
    return worst


def check_prefill(card: str) -> dict:
    """B = 32, S = 32 causal; a ragged t_valid and a dead head; timed at
    the serving wave (B = 32, S = T = 32, causal, all heads live)."""
    import torch
    from repro_torch.kernels import flash_prefill as FP
    g = torch.Generator(device="cuda").manual_seed(31)
    b, s, h = SERVE_BATCH, SERVE_PROMPT, SERVE_KV * SERVE_GROUP
    q = torch.randn(b, s, h, SERVE_HD, generator=g, device="cuda")
    k = torch.randn(b, s, SERVE_KV, SERVE_HD, generator=g, device="cuda")
    v = torch.randn(b, s, SERVE_KV, SERVE_HD, generator=g, device="cuda")
    dead = torch.tensor([1.0, 0.0, 1.0], device="cuda")
    worst = 0.0
    for t_valid, hm in [(None, None), (20, None), (None, dead)]:
        got = FP.flash_prefill(q, k, v, True, None, t_valid, hm)
        ref = FP.flash_prefill_plain(q, k, v, True, None, t_valid, hm)
        torch.cuda.synchronize()
        diff, rel = rel_err(got, ref)
        worst = max(worst, diff)
        log(f"  flash_prefill B={b} S={s} t_valid={t_valid} head_mask="
            f"{None if hm is None else hm.tolist()}: max_abs_err={diff:.3e} "
            f"rel={rel:.3e} (tol {TOL})")
        if rel > TOL:
            raise AssertionError("flash_prefill disagrees")
    # granite-3-2b's (G = 4, hd = 64) and qwen2-7b's (G = 7, hd = 128) head
    # layouts: ragged t_valid, a window, a dead KV head
    for group, hd, hkv, window in [(4, 64, 8, None), (4, 64, 8, 24),
                                   (7, 128, 4, None), (7, 128, 4, 24)]:
        qg = torch.randn(4, 100, hkv * group, hd, generator=g, device="cuda")
        kg = torch.randn(4, 100, hkv, hd, generator=g, device="cuda")
        vg = torch.randn(4, 100, hkv, hd, generator=g, device="cuda")
        hm = torch.ones(hkv, device="cuda")
        hm[1] = 0.0
        got = FP.flash_prefill(qg, kg, vg, True, window, 77, hm)
        ref = FP.flash_prefill_plain(qg, kg, vg, True, window, 77, hm)
        torch.cuda.synchronize()
        diff, rel = rel_err(got, ref)
        worst = max(worst, diff)
        log(f"  flash_prefill G={group} hd={hd} Hkv={hkv} S=T=100 t_valid=77 "
            f"window={window} head 1 dead: max_abs_err={diff:.3e} "
            f"rel={rel:.3e} (tol {TOL})")
        if rel > TOL or float(got[:, :, group:2 * group].abs().max()) != 0:
            raise AssertionError("flash_prefill disagrees")
    ms = device_ms(lambda: FP.flash_prefill(q, k, v), 50, ("prefill_kernel",))
    call_ms = cuda_ms(lambda: FP.flash_prefill(q, k, v), 50)
    plain_ms = device_ms(lambda: FP.flash_prefill_plain(q, k, v), 20)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    valid = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    lib_err = rel_err(sdpa(qs, ks, vs, valid).transpose(1, 2),
                      FP.flash_prefill_plain(q, k, v))[1]
    lib_ms = device_ms(lambda: sdpa(qs, ks, vs, valid), 50)
    pairs = b * SERVE_KV * s * (s + 1) / 2
    nbytes = 4.0 * (2 * q.numel() + k.numel() + v.numel())
    ops = 4.0 * pairs * SERVE_GROUP * SERVE_HD
    bound, bound_by = bound_ms(nbytes, ops)
    log(f"  flash_prefill (B={b}, S=T={s}, causal): {ms:.4f} ms kernel on the "
        f"device ({call_ms:.4f} ms a call), {plain_ms:.4f} ms plain, {lib_ms:.4f} ms sdpa (rel err vs plain "
        f"{lib_err:.1e}), bound {bound:.6f} ms ({bound_by}) [{card}]")
    return dict(name="flash_prefill", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_prefill.cu",
                replaces="src/repro/kernels/flash_prefill.py:102",
                max_abs_err=worst, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)


# the xLSTM scans: held against autograd of their plain versions at
# xlstm-125m's heads (mLSTM 4 of 384, sLSTM 4 of 192) on (B, S) = (2,
# 256), and timed at 17a's host step, (4, 4096)
SCAN_B, SCAN_S = 2, 256
XHOST_B, XHOST_S, XHOST_STEPS = 4, 4096, 3
SCAN_HEADS = {"mlstm": (4, 384), "slstm": (4, 192)}
# a ragged case a scan: head dims that fill no lane group, warp or
# cluster evenly, at a length that ends mid-chunk
RAGGED_B, RAGGED_S = 3, 100
RAGGED_HEADS = {"mlstm": (4, 72), "slstm": (4, 44)}
# each op's device kernels (profiler names)
SCAN_KERNELS = {"mlstm_scan": ("mlstm_fwd_kernel",),
                "mlstm_scan_bwd": ("mlstm_bwd_chunk_kernel",
                                   "mlstm_bwd_carry_kernel",
                                   "mlstm_bwd_gate_kernel"),
                "slstm_scan": ("slstm_fwd_kernel",),
                "slstm_scan_bwd": ("slstm_bwd_kernel",)}
# launches a train step of xlstm-125m at remat="block" (6 layers of each
# cell): the forward and the backward's recompute, and the backward
XSCAN_PER_STEP = {"mlstm_scan": 12, "mlstm_scan_bwd": 6, "slstm_scan": 12,
                  "slstm_scan_bwd": 6}


def scan_inputs(kind: str, b: int, s: int, seed: int, state: bool,
                heads: tuple = None) -> list:
    """The scan op's inputs on the card from a seed, at xlstm-125m's heads
    (or ``heads``, (H, hd)): gates spread wide (N(0, 9) pre-activations,
    reaching both sides of the stabiliser's max), and the states zero (the
    model's start; the sLSTM's n at its 1e-6 floor) or drawn."""
    import torch
    g = torch.Generator(device=CARD).manual_seed(seed)
    h, hd = heads or SCAN_HEADS[kind]

    def r(*shape):
        return torch.randn(shape, generator=g, device=CARD)

    if kind == "mlstm":
        ins = [r(b, s, h, hd), r(b, s, h, hd), r(b, s, h, hd),
               3.0 * r(b, s, h), 3.0 * r(b, s, h) + 1.0]
        return ins + ([r(b, h, hd, hd), r(b, h, hd), r(b, h)] if state else
                      [torch.zeros((b, h, hd, hd), device=CARD),
                       torch.zeros((b, h, hd), device=CARD),
                       torch.zeros((b, h), device=CARD)])
    ins = [3.0 * r(b, s, h, 4, hd), r(h, 4, hd, hd) * hd ** -0.5]
    if state:
        c0 = r(b, h, hd)
        return ins + [c0, c0.abs() + 0.5, r(b, h, hd), r(b, h, hd)]
    zero = torch.zeros((b, h, hd), device=CARD)
    return ins + [zero, torch.full_like(zero, 1e-6), zero, zero]


def scan_grads(fn, ins, dh) -> list:
    """[h, and the gradient of <dh, h> with respect to every input] of
    ``fn`` (the op's differentiable entry or its plain version)."""
    import torch
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in ins]
        h = fn(*xs)
        return [h.detach()] + list(torch.autograd.grad(h, xs, dh))


def scan_bytes(kind: str, direction: str, ins) -> float:
    """Bytes the op must move: each input read once, each output written
    once (float32)."""
    b, s, h = ins[0].shape[:3]
    hd = SCAN_HEADS[kind][1]
    vec, pos, state = b * s * h * hd, b * s * h, b * h * hd
    if kind == "mlstm":
        states = b * h * hd * hd + state + b * h
        snaps = b * h * -(-s // 32) * hd * hd     # C every 32 positions
        n = {"fwd": 3 * vec + 2 * pos + states + 2 * vec + 2 * pos + snaps,
             "bwd": 6 * vec + 4 * pos + states + snaps + 3 * vec + 2 * pos
             + states}[direction]
    else:
        rec = h * 4 * hd * hd
        n = {"fwd": 4 * vec + rec + 4 * state + 4 * vec + 4 * vec,
             "bwd": vec + rec + 3 * state + 3 * vec + 4 * vec + 4 * vec
             + 4 * state}[direction]
    return 4.0 * n


def time_scan(kind: str, ins) -> dict:
    """The forward and backward ops on ``ins`` (one shape): ms by CUDA
    events over back-to-back launches (each a millisecond or more, so
    the host's dispatch hides under the device's work; late in a long run
    the profiler drops some of these kernels' records), call ms a call
    alone (its dispatch included), bounds from this run's shapes and the
    registered flop formulas."""
    import torch
    from torch.utils.flop_counter import flop_registry
    fwd = getattr(torch.ops.repro_torch, f"{kind}_scan")
    bwd = getattr(torch.ops.repro_torch, f"{kind}_scan_bwd")
    outs = fwd(*ins)
    dh = torch.randn_like(outs[0])
    saved = list(outs) if kind == "mlstm" else list(outs[1:])
    calls = {"fwd": (fwd, list(ins)), "bwd": (bwd, [dh, *ins, *saved])}
    res = {}
    for direction, (op, args) in calls.items():
        name = f"{kind}_scan" + ("_bwd" if direction == "bwd" else "")
        ops = float(flop_registry[op](*args, out_val=None))
        bound, bound_by = bound_ms(scan_bytes(kind, direction, ins), ops)
        iters = 3 if ins[0].shape[1] > 1024 else 10
        res[name] = dict(
            ms=cuda_ms(lambda: op(*args), iters),
            call_ms=sum(timed_once(lambda: op(*args))[1]
                        for _ in range(iters)) / iters,
            bound_ms=bound, bound_by=bound_by)
        if name == "mlstm_scan_bwd":
            from repro_torch.kernels import mlstm_scan as MS
            res[name]["by_kernel"] = MS.backward_launch_ms(args, iters)
    return res


def timed_once(fn) -> tuple:
    """(fn(), its CUDA-event ms): one call of a plain version too slow to
    repeat (plain PyTorch compiles nothing, so a first call is warm)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_scans(card: str) -> list:
    """Phase 3's scan kernels (``kernels/mlstm_scan.py``,
    ``kernels/slstm_scan.py``).  On (2, 256) at xlstm-125m's heads, from
    zero and from drawn states: h and every input's gradient through the
    differentiable entry (the forward kernel, the backward kernel and,
    for the sLSTM, R's gradient as the product outside it) against
    autograd of the plain version, |kernel - plain| within TOL of max(1,
    |plain|) (a zero-state m0 gradient is ~1e-5, a difference of O(1)
    terms that float32 cancels to ~1e-7 either way), and a rerun
    bitwise.  At 17a's host-step shape (4, 4096), from zero states: the
    forward against the plain forward, and every gradient against
    autograd of the plain version under the same gate, the kernels run
    on the whole batch and rerun bitwise.  The plain backward keeps every
    step's state, so the mLSTM's (2 hd^2 floats a step and head, ~19 GB
    a row) is held on the batch's last row (rows are independent), the
    sLSTM's on the whole batch.  Each op's ms and bound at both shapes;
    the plain versions' ms at both, each one call (the backward's
    autograd of the stepped cell, its forward included).  Returns the
    four kernels' rows (launches filled in by 17a)."""
    import torch
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.kernels import slstm_scan as SS
    rows = []
    for kind, mod in (("mlstm", MS), ("slstm", SS)):
        entry, plain = getattr(mod, f"{kind}_scan"), \
            getattr(mod, f"{kind}_scan_plain")
        worst, plain_small = 0.0, {}
        for state in (False, True):
            ins = scan_inputs(kind, SCAN_B, SCAN_S, 41 + state, state)
            h, plain_small["fwd"] = timed_once(lambda: plain(*ins))
            dh = torch.randn_like(h)
            got = scan_grads(entry, ins, dh)
            again = scan_grads(entry, ins, dh)
            want, plain_small["bwd"] = timed_once(
                lambda: scan_grads(plain, ins, dh))
            errs = []
            for a, w in zip(got, want):
                diff = float((a - w).abs().max())
                errs.append(diff / max(float(w.abs().max()), 1.0))
                worst = max(worst, diff)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"  {kind}_scan (B={SCAN_B}, S={SCAN_S}, heads "
                f"{SCAN_HEADS[kind]}, {'drawn' if state else 'zero'} "
                f"states): h and grads err / max(1, |plain|) "
                f"{', '.join(f'{e:.1e}' for e in errs)} (tol {TOL}); rerun "
                f"{'bitwise' if same else 'DIFFERENT'} [{card}]")
            if max(errs) > TOL or not same:
                raise AssertionError(f"{kind}_scan disagrees with its plain "
                                     f"version or its rerun")
        ins = scan_inputs(kind, RAGGED_B, RAGGED_S, 45, True,
                          RAGGED_HEADS[kind])
        h, _ = timed_once(lambda: plain(*ins))
        dh = torch.randn_like(h)
        got, again = scan_grads(entry, ins, dh), scan_grads(entry, ins, dh)
        want = scan_grads(plain, ins, dh)
        errs = []
        for a, w in zip(got, want):
            diff = float((a - w).abs().max())
            errs.append(diff / max(float(w.abs().max()), 1.0))
            worst = max(worst, diff)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"  {kind}_scan ragged (B={RAGGED_B}, S={RAGGED_S}, heads "
            f"{RAGGED_HEADS[kind]}, drawn states): h and grads err / max(1, "
            f"|plain|) {', '.join(f'{e:.1e}' for e in errs)} (tol {TOL}); "
            f"rerun {'bitwise' if same else 'DIFFERENT'} [{card}]")
        if max(errs) > TOL or not same:
            raise AssertionError(f"{kind}_scan's ragged case disagrees with "
                                 f"its plain version or its rerun")
        if kind == "slstm":
            for hd in (SCAN_HEADS[kind][1], RAGGED_HEADS[kind][1]):
                info = SS.cluster_info(hd)
                log(f"  slstm_fwd_kernel at hd = {hd}: a cluster of "
                    f"{info['cluster']} CTAs a (b, h), {info['smem_bytes']} "
                    f"B of shared memory a CTA, cudaOccupancyMaxActiveClusters"
                    f" {info['max_active_clusters']} [{card}]")
        ins = scan_inputs(kind, SCAN_B, SCAN_S, 42, True)
        small = time_scan(kind, ins)
        ins = scan_inputs(kind, XHOST_B, XHOST_S, 44, False)
        got = entry(*ins)
        same = torch.equal(got, entry(*ins))
        with torch.no_grad():
            want, plain_fwd = timed_once(lambda: plain(*ins))
        diff = float((got - want).abs().max())
        rel = diff / max(float(want.abs().max()), 1.0)
        worst = max(worst, diff)
        log(f"  {kind}_scan forward (B={XHOST_B}, S={XHOST_S}): err / max(1,"
            f" |plain|) {rel:.1e} (tol {TOL}); rerun "
            f"{'bitwise' if same else 'DIFFERENT'} [{card}]")
        if rel > TOL or not same:
            raise AssertionError(f"{kind}_scan at (4, 4096) disagrees")
        dh = torch.randn_like(got)
        del got, want
        got = scan_grads(entry, ins, dh)
        same = all(torch.equal(a, b)
                   for a, b in zip(got, scan_grads(entry, ins, dh)))
        part, dh_part = ins, dh
        if kind == "mlstm":
            part, dh_part = [t[-1:] for t in ins], dh[-1:]
            got = [t[-1:] for t in got]
        plain_shape = [part[0].shape[0], XHOST_S]
        want, plain_bwd = timed_once(lambda: scan_grads(plain, part, dh_part))
        errs = []
        for a, w in zip(got, want):
            diff = float((a - w).abs().max())
            errs.append(diff / max(float(w.abs().max()), 1.0))
            worst = max(worst, diff)
        log(f"  {kind}_scan backward (B={XHOST_B}, S={XHOST_S}; plain on "
            f"{plain_shape[0]} row(s)): h and grads err / max(1, |plain|) "
            f"{', '.join(f'{e:.1e}' for e in errs)} (tol {TOL}); rerun "
            f"{'bitwise' if same else 'DIFFERENT'} [{card}]")
        if max(errs) > TOL or not same:
            raise AssertionError(f"{kind}_scan's gradients at (4, 4096) "
                                 f"disagree with the plain version's or "
                                 f"their rerun")
        del got, want, part, dh_part, dh
        torch.cuda.empty_cache()
        for name, t in time_scan(kind, ins).items():
            bwd = name.endswith("_bwd")
            direction = "bwd" if bwd else "fwd"
            row = dict(
                name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{kind}_scan.cu",
                replaces=("src/repro/models/recurrent.py:"
                          + ("162" if kind == "mlstm" else "243")
                          + " (jax.lax.scan; no Pallas counterpart)"),
                max_abs_err=worst, shape=[XHOST_B, XHOST_S], **t,
                plain_ms=plain_bwd if bwd else plain_fwd,
                plain_shape=plain_shape if bwd else [XHOST_B, XHOST_S],
                small_ms=small[name]["ms"],
                small_bound_ms=small[name]["bound_ms"],
                small_plain_ms=plain_small[direction], library_ms=None)
            rows.append(row)
            split = "".join(f"; {k} {v:.3f} ms" for k, v in
                            t.get("by_kernel", {}).items())
            log(f"  {name} (B={XHOST_B}, S={XHOST_S}): {t['ms']:.3f} ms a "
                f"call (CUDA events; {t['call_ms']:.3f} ms a call alone"
                f"{split}), "
                f"bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}); at (B={SCAN_B}, S={SCAN_S}) "
                f"{small[name]['ms']:.3f} ms (bound "
                f"{small[name]['bound_ms']:.4f}) against "
                f"{row['small_plain_ms']:.3f} ms plain; plain at (B="
                f"{row['plain_shape'][0]}, S={XHOST_S}) {row['plain_ms']:.1f}"
                f" ms; library call: none [{card}]")
        del ins
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path; phase 5: card against CPU
# ---------------------------------------------------------------------------

def slice_config(rounds=SLICE_ROUNDS, cells=SLICE_CELLS, per_cell=SLICE_PER_CELL):
    from repro_torch.fleet import FleetConfig, FleetTopology, SyntheticMLPTask
    return FleetConfig(task=SyntheticMLPTask(**DNN),
                       topology=FleetTopology(num_cells=cells,
                                              clients_per_cell=per_cell),
                       kernel="fused", rounds=rounds)


def run_main_path(card: str) -> tuple[list, dict, dict]:
    import torch
    from repro_torch.fleet import build_simulation
    from repro_torch.kernels import block_norms as BN
    from repro_torch.kernels import fleet_fused as FF

    cfg = slice_config()
    t0 = time.perf_counter()
    sim = build_simulation(cfg)
    torch.cuda.synchronize()
    log(f"  build (population, data {tuple(sim.data.cached['x'].shape)} on the card): "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    FF.fused_fleet_grads.launches = 0
    BN.tile_norms.launches = 0
    carry = sim.init_carry(sim.params)
    history, walls = [], []
    for r in range(cfg.rounds):
        t0 = time.perf_counter()
        ctl = sim.control(r)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        carry, m = sim.apply(carry, ctl)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        history.append(m)
        walls.append((t2 - t0) * 1e3)
        log(f"  round {r}: loss={float(m['loss']):.6f} "
            f"acc={float(m['accuracy']):.4f} "
            f"latency={float(m['round_latency']):.4f} s "
            f"mean_rho={float(m['mean_prune']):.4f} "
            f"participants={int(m['participants'])} "
            f"solver_iters={int(ctl.sol.iterations.max())} "
            f"wall={(t2 - t0) * 1e3:.2f} ms (control {(t1 - t0) * 1e3:.2f}, "
            f"apply {(t2 - t1) * 1e3:.2f}) [{card}]")
    counts = {"fleet_fused_grads": FF.fused_fleet_grads.launches,
              "tile_norms": BN.tile_norms.launches}
    log("  kernels " + json.dumps(counts))
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if counts["tile_norms"] != cfg.rounds:
        raise AssertionError(f"{counts['tile_norms']} tile_norms launches in "
                             f"{cfg.rounds} rounds: the ranking is one a "
                             f"round")
    losses = [float(m["loss"]) for m in history]
    if not all(abs(v) < float("inf") for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    result = sim.finalize(carry, {k: torch.stack([h[k] for h in history])
                                  for k in history[0]})
    log(f"  bound_final={result.bound_final:.6f} "
        f"final accuracy={result.accuracy[-1]:.4f}")

    busy_ms = profile_round(sim, carry, cfg.rounds - 1, card)

    again = build_simulation(cfg)
    _, m2 = again.simulate(again.params)
    losses2 = m2["loss"].cpu().tolist()
    if losses2 != losses:
        raise AssertionError(f"rerun losses differ: {losses} vs {losses2}")
    log("  rerun: losses bitwise identical")
    return losses, counts, dict(busy_ms=busy_ms, warm_ms=sorted(walls[1:]),
                                latencies=result.latencies.tolist(),
                                losses=losses, params=result.params)


def profile_round(sim, carry, r: int, card: str, what: str = "round"):
    """One more (warm) round or event under torch.profiler; its device
    busy ms, or None where not measured."""
    return profile_device(lambda: sim.step(carry, r), what, card)


def profile_device(fn, what: str, card: str):
    """``fn`` once under torch.profiler: device busy share of its wall time
    and the device time by kernel; returns the busy ms.  A measurement
    only: if the profiler records no device time it says "not measured"
    and returns None."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ANNOTATIONS]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log(f"  profiled {what}: device time not measured (no CUDA events)")
        return None
    log(f"  profiled {what}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e.count for e in kernels)} device ops [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return busy_us / 1e3


def numpy_fleet(cells: int, per_cell: int, rounds: int, seed: int = 7):
    """Population, per-round draws, params, task state and client batches
    of a small fleet, made with numpy (both devices start from these)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shape = (cells, per_cell)
    dist = rng.uniform(50, 500, shape)
    pathloss = 10.0 ** (-(128.1 + 37.6 * np.log10(dist / 1000.0)) / 10.0)
    pop = dict(dist_m=dist, pathloss=pathloss,
               cpu_hz=rng.uniform(2e9, 8e9, shape),
               num_samples=rng.integers(16, 65, shape).astype(np.float64),
               tx_power=np.full(shape, 10 ** 2.3 * 1e-3),
               max_prune=np.full(shape, 0.7))
    # the schedule's Gumbel scores from a generator of their own, so the
    # other draws are those of a fleet without them
    gumbel = np.random.default_rng(seed + 1000)
    draws = [(pathloss * rng.exponential(size=shape),
              pathloss * rng.exponential(size=shape),
              rng.uniform(size=shape), rng.uniform(size=shape),
              gumbel.gumbel(size=shape))
             for _ in range(rounds)]
    draws = [dict(zip(("h_up", "h_down", "u_strag", "u_arr", "gumbel"), d))
             for d in draws]
    sizes = (DNN["feature_dim"],) + DNN["hidden"] + (DNN["num_classes"],)
    params = {f"layer{i}": {"w": rng.normal(size=(a, b)) * np.sqrt(2.0 / a),
                            "b": np.zeros(b)}
              for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    templates = rng.normal(size=(DNN["num_classes"], DNN["feature_dim"]))
    y_test = rng.integers(0, DNN["num_classes"], 512)
    state = dict(templates=templates, y_test=y_test,
                 x_test=templates[y_test] + 0.5 * rng.normal(
                     size=(512, DNN["feature_dim"])))
    y = rng.integers(0, DNN["num_classes"], (cells * per_cell, 8))
    batches = dict(y=y, x=templates[y] + 0.5 * rng.normal(
        size=(cells * per_cell, 8, DNN["feature_dim"])))
    return pop, draws, params, state, batches


def to_numpy(tree):
    """A population or round draws (NamedTuples of tensors) as dicts of
    numpy arrays, None kept."""
    import torch
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.cpu().numpy()
    return {k: to_numpy(v) for k, v in tree._asdict().items()}


def card_vs_cpu(card: str, what: str = "sync, fused", mode: str = "sync",
                data: str = "cached", **change) -> None:
    """A small fleet (4 x 8 clients, 3 rounds or events) from the same
    numpy draws on the CPU (plain versions) and on the card (kernels):
    losses, params and (async) the time axis and staleness within TOL.
    A hex geometry's population and draws are made on the CPU by the
    default draw source and carried across as numpy; ``data`` other than
    "cached" leaves the batches for each device to draw from the numpy
    task state ("dirichlet": with a numpy Dirichlet(0.3) label table)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import weights
    from repro_torch.fleet import (GeneratorDraws, InjectedDraws,
                                   build_simulation)

    cells, per_cell, rounds = 4, 8, 3
    n_draws = rounds + (mode == "async")
    pop, draws, params, state, batches = numpy_fleet(cells, per_cell,
                                                     n_draws)
    cfg = dataclasses.replace(
        slice_config(rounds=rounds, cells=cells, per_cell=per_cell), **change)
    if cfg.geometry is not None:
        src = GeneratorDraws(cfg.seed, "cpu", geometry=cfg.geometry)
        hex_pop = src.population(cfg.topology, cfg.wireless.tx_power_ue_w,
                                 torch.float32)
        pop = to_numpy(hex_pop)
        draws = [to_numpy(src.round(r, hex_pop)) for r in range(n_draws)]
    if data == "dirichlet":
        gam = np.random.default_rng(8).gamma(0.3, size=(cells * per_cell,
                                                        DNN["num_classes"]))
        state["label_cdf"] = np.cumsum(gam / gam.sum(-1, keepdims=True), -1)
    if data != "cached":
        batches = None
    results, sims = {}, {}
    for dev in ("cpu", "cuda"):
        src = InjectedDraws(weights.population_from_numpy(pop, device=dev),
                            [weights.round_draws_from_numpy(**d, device=dev)
                             for d in draws])
        start = weights.start_from_numpy(params, state, batches, device=dev)
        sims[dev] = build_simulation(cfg, mode, device=dev, draws=src,
                                     start=start)
        results[dev] = sims[dev].finalize(
            *sims[dev].simulate(sims[dev].params))
    a, b = results["cuda"], results["cpu"]
    loss_rel, par_rel = losses_params_rel(a, b)
    time_rel = float(np.max(np.abs(a.wall_clock - b.wall_clock)
                            / np.abs(b.wall_clock)))
    # a mean staleness is a mean of equal integers: rounding apart
    stale_err = float(np.max(np.abs(a.staleness - b.staleness)))
    log(f"  [{what}] {cells}x{per_cell} clients, {rounds} "
        f"{'events' if mode == 'async' else 'rounds'}: losses card "
        f"{a.losses.tolist()} cpu {b.losses.tolist()}")
    log(f"  [{what}] loss rel err {loss_rel:.3e}, params rel err "
        f"{par_rel:.3e}, wall_clock rel err {time_rel:.3e}, staleness err "
        f"{stale_err:.1e}; participants "
        f"{a.participants.tolist()} (tol {TOL}) [{card}]")
    if loss_rel > TOL or par_rel > TOL or time_rel > TOL or stale_err > TOL:
        raise AssertionError(f"card and CPU runs disagree ({what})")
    if not np.array_equal(a.participants, b.participants):
        raise AssertionError(f"card and CPU participants differ ({what})")
    if cfg.telemetry is not None:
        telemetry_card_vs_cpu(what, sims["cpu"], a.telemetry, b.telemetry,
                              card)


def losses_params_rel(a, b) -> tuple[float, float]:
    """Largest relative loss error and largest params error over each
    leaf's scale, of results ``a`` against ``b`` (numpy params dicts)."""
    import numpy as np
    la, lb = np.asarray(a.losses), np.asarray(b.losses)
    loss_rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    par_rel = max(float(np.max(np.abs(a.params[k][n] - b.params[k][n]))
                        / max(float(np.max(np.abs(b.params[k][n]))), 1e-30))
                  for k in b.params for n in ("w", "b"))
    return loss_rel, par_rel


# the control pass's input to each per-cell histogram, and its range
HIST_INPUTS = {
    "per_hist": ("per_range", lambda c, b_hz: c.sol.per),
    "rho_hist": ("rho_range", lambda c, b_hz: c.sol.prune),
    "bw_hist": ("bw_share_range", lambda c, b_hz: c.sol.bandwidth / b_hz),
    "latency_hist": ("latency_range_s", lambda c, b_hz: c.t_client),
    "sinr_hist": ("sinr_db_range", lambda c, b_hz: c.sinr_db),
}
EDGE_RTOL = 1e-5


def telemetry_card_vs_cpu(what: str, sim_cpu, tel_card: dict, tel_cpu: dict,
                          card: str) -> None:
    """Telemetry of a card run against the CPU run's: every histogram's
    mass exact; per-bin counts equal, except that a count may sit in the
    neighbouring bin for a value within EDGE_RTOL (relative) of the edge
    between them (found from the CPU run's control passes, and named);
    every other summary within TOL of its largest entry (the fixed
    point's last residual, a difference of two nearly equal float32
    PSDs, within TOL of its trajectory's largest, first step)."""
    import collections
    import numpy as np
    tcfg = sim_cpu.cfg.telemetry
    b_hz = sim_cpu.cfg.wireless.bandwidth_hz
    if set(tel_card) != set(tel_cpu):
        raise AssertionError(f"telemetry keys differ ({what})")
    notes, edge_counts, worst = [], collections.Counter(), (0.0, "")
    for name, v in tel_cpu.items():
        g = tel_card[name]
        if g.shape != v.shape:
            raise AssertionError(f"{name} shapes differ ({what})")
        if name.endswith("_hist"):
            if not np.array_equal(g.sum(-1), v.sum(-1)):
                raise AssertionError(f"{name} mass differs ({what})")
            moved = np.abs(g - v).sum(-1)
            if not moved.any():
                continue
            if name not in HIST_INPUTS:
                raise AssertionError(f"{name} counts differ ({what})")
            field, fn = HIST_INPUTS[name]
            lo, hi = getattr(tcfg, field)
            edges = np.linspace(lo, hi, tcfg.bins + 1)[1:-1]
            for r in range(v.shape[0]):
                vals = fn(sim_cpu.control(r), b_hz).numpy()
                near = np.abs(vals[..., None] - edges) \
                    <= EDGE_RTOL * np.maximum(np.abs(edges), 1.0)
                if np.any(moved[r] > 2 * near.any(-1).sum(-1)):
                    raise AssertionError(f"{name} round {r}: counts moved "
                                         f"with no value at an edge ({what})")
                for e in np.nonzero(near.any(-2))[1]:
                    edge_counts[(name, float(edges[e]))] += 1
        elif name in ("solver_iters", "fp_iterations"):
            notes += [f"{name} differs by up to "
                      f"{int(np.max(np.abs(g - v)))}"] if (g != v).any() \
                else []
        else:
            if not np.array_equal(np.isnan(g), np.isnan(v)):
                raise AssertionError(f"{name}: NaN entries differ ({what})")
            ok = ~np.isnan(v)
            ref = tel_cpu["fp_residuals"] if name == "fp_residual" \
                and "fp_residuals" in tel_cpu else v
            scale = max(float(np.nanmax(np.abs(ref))), 1e-30)
            err = float(np.max(np.abs(g[ok] - v[ok]))) / scale
            worst = max(worst, (err, name))
            if err > TOL:
                raise AssertionError(f"{name}: rel err {err:.3e} ({what})")
    notes += [f"{name} {n} cell-round(s) with a value at edge {edge:g}"
              for (name, edge), n in sorted(edge_counts.items())]
    log(f"  [{what}] telemetry: {len(tel_cpu)} summaries, masses exact, "
        f"continuous ones rel err {worst[0]:.3e} (worst {worst[1]}; tol "
        f"{TOL}); {'; '.join(notes) if notes else 'every bin count equal'}"
        f" [{card}]")


def card_vs_cpu_paths(card: str) -> dict:
    """Phase 5: the sync fused round, then each path phases 7-12 drive;
    returns the MoE fleet's launches."""
    from repro_torch.fleet import (AsyncConfig, HexInterference,
                                   ScheduleConfig, SolverConfig,
                                   TelemetryConfig)
    card_vs_cpu(card)
    card_vs_cpu(card, "cohort: uniform m=3, control_chunk=3",
                schedule=ScheduleConfig(participation="uniform",
                                        participants_per_cell=3),
                control_chunk=3)
    card_vs_cpu(card, "async: fused, buffer 12", mode="async",
                async_config=AsyncConfig(buffer_size=12, max_staleness=4))
    card_vs_cpu(card, "reference: magnitude masks", kernel="reference")
    card_vs_cpu(card, "reference: block masks", kernel="reference",
                mask_kind="block")
    card_vs_cpu(card, "hex: reuse 1, 2 neighbours, mobility 25 m, fp_rtol 0",
                geometry=HexInterference(reuse=1, max_neighbors=2,
                                         mobility_m=25.0),
                solver=SolverConfig(fp_rtol=0.0))
    card_vs_cpu(card, "two-tier sync, cloud_period 2", cloud_period=2)
    # a buffer of two whole cells: a cell's clients finish at its deadline,
    # equal up to rounding, so a buffer splitting a cell would pick by ulps
    card_vs_cpu(card, "two-tier async, cloud_period 2, buffer 16",
                mode="async", cloud_period=2,
                async_config=AsyncConfig(buffer_size=16, max_staleness=4))
    card_vs_cpu(card, "Dirichlet(0.3) labels", data="dirichlet")
    card_vs_cpu(card, "streaming, cache_data=False", data="streaming",
                cache_data=False)
    card_vs_cpu(card, "sync, fused, telemetry", telemetry=TelemetryConfig())
    card_vs_cpu(card, "hex: reuse 1, fp_rtol 0, telemetry",
                geometry=HexInterference(reuse=1, max_neighbors=2,
                                         mobility_m=25.0),
                solver=SolverConfig(fp_rtol=0.0),
                telemetry=TelemetryConfig())
    card_vs_cpu_run(card)
    card_vs_cpu_fleet_reference(card)
    return card_vs_cpu_tasks(card)


MOE_FLEET = "transformer olmoe-1b-7b, smoke width"


def card_vs_cpu_tasks(card: str) -> dict:
    """The generic gradient path's tasks from the same numpy population,
    draws, params and task state (drawn by the task on the CPU from a
    seed) on the CPU and on the card: a linreg fleet (2 x 4 clients, 3
    rounds) and transformer fleets at the smoke width, smollm-135m's and
    olmoe-1b-7b's (its 4-D expert leaves in the grouped ranking), 2 x 3
    clients, 2 rounds: losses and params within TOL, one ranking a round
    and no fused call on the card.  Returns the MoE fleet's launches."""
    import numpy as np
    import torch
    from repro_torch import weights
    from repro_torch.core import pruning
    from repro_torch.fleet import (FleetConfig, FleetTopology, InjectedDraws,
                                   LinearRegressionTask, TransformerTask,
                                   run_fleet)
    cases = (("linreg", LinearRegressionTask(noise=0.05), (2, 4), 3, 0.1),
             ("transformer, smoke width", TransformerTask(), (2, 3), 2, 0.5),
             (MOE_FLEET, TransformerTask(arch_name="olmoe-1b-7b"), (2, 3), 2,
              0.5))
    moe_counts = {}
    for what, task, (cells, per_cell), rounds, lr in cases:
        cfg = FleetConfig(task=task, topology=FleetTopology(cells, per_cell),
                          kernel="fused", rounds=rounds, lr=lr)
        pop, draws, *_ = numpy_fleet(cells, per_cell, rounds)
        gen = torch.Generator().manual_seed(5)
        state = weights.to_numpy(task.build(gen, torch.float32, "cpu"))
        params = weights.to_numpy(task.init_params(gen, torch.float32, "cpu"))
        out = {}
        for dev in ("cpu", "cuda"):
            src = InjectedDraws(weights.population_from_numpy(pop, device=dev),
                                [weights.round_draws_from_numpy(**d,
                                                                device=dev)
                                 for d in draws])
            zero_fleet_counts()
            out[dev] = run_fleet(cfg, device=dev, draws=src,
                                 start=weights.start_from_numpy(
                                     params, state, device=dev))
        counts = fleet_counts()
        a, b = out["cuda"], out["cpu"]
        loss_rel = float(np.max(np.abs(a.losses - b.losses)
                                / np.abs(b.losses)))
        par_rel = max(float(np.max(np.abs(x - y)))
                      / max(float(np.max(np.abs(y))), 1e-30)
                      for x, y in zip(pruning.flatten(a.params),
                                      pruning.flatten(b.params)))
        log(f"  [{what}, {cells}x{per_cell} clients, {rounds} rounds] losses "
            f"card {a.losses.tolist()} cpu {b.losses.tolist()}; loss rel err "
            f"{loss_rel:.3e}, params rel err {par_rel:.3e} (tol {TOL}); card "
            f"launches {json.dumps(counts)} [{card}]")
        if loss_rel > TOL or par_rel > TOL:
            raise AssertionError(f"card and CPU runs disagree ({what})")
        if counts != {"fleet_fused_grads": 0, "tile_norms": rounds}:
            raise AssertionError(f"{what}: the card launched {counts}")
        if what == MOE_FLEET:
            moe_counts = counts
    return moe_counts


def card_vs_cpu_run(card: str) -> None:
    """The §V ``run`` at 5 UEs (the DNN, 3 rounds) from the same numpy
    params and packet uniforms on the CPU and on the card, with magnitude
    and with block-16 masks: losses and params within TOL, the host
    solver's costs equal."""
    import numpy as np
    from repro_torch import weights
    from repro_torch.federated import system as SYS
    rng = np.random.default_rng(13)
    sizes = (DNN["feature_dim"],) + DNN["hidden"] + (DNN["num_classes"],)
    params = {f"layer{i}": {"w": rng.normal(size=(a, b)) * np.sqrt(2.0 / a),
                            "b": np.zeros(b)}
              for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    uniforms = rng.uniform(size=(3, 5))
    for structured in (False, True):
        cfg = SYS.FLConfig(rounds=3, hidden=DNN["hidden"],
                           structured=structured)
        out = {dev: SYS.run(cfg, device=dev,
                            start=weights.run_start_from_numpy(
                                params, uniforms, device=dev))
               for dev in ("cpu", "cuda")}
        a, b = out["cuda"], out["cpu"]
        loss_rel, par_rel = losses_params_rel(a, b)
        what = f"run, 5 UEs, structured={structured}"
        log(f"  [{what}] losses card {a.losses} cpu {b.losses}; loss rel "
            f"err {loss_rel:.3e}, params rel err {par_rel:.3e} (tol {TOL}); "
            f"accuracy {a.accuracy} / {b.accuracy} [{card}]")
        if loss_rel > TOL or par_rel > TOL or a.total_costs != b.total_costs:
            raise AssertionError(f"card and CPU runs disagree ({what})")


def card_vs_cpu_fleet_reference(card: str) -> None:
    """``run_fleet_reference`` on a 4 x 8 fleet from the same numpy draws
    on the CPU and on the card: losses, params and deadlines within
    TOL."""
    import numpy as np
    from repro_torch import weights
    from repro_torch.federated import system as SYS
    from repro_torch.fleet import InjectedDraws
    pop, draws, params, state, batches = numpy_fleet(4, 8, 3)
    cfg = slice_config(rounds=3, cells=4, per_cell=8)
    out = {}
    for dev in ("cpu", "cuda"):
        src = InjectedDraws(weights.population_from_numpy(pop, device=dev),
                            [weights.round_draws_from_numpy(**d, device=dev)
                             for d in draws])
        out[dev] = SYS.run_fleet_reference(
            cfg, device=dev, draws=src,
            start=weights.start_from_numpy(params, state, batches,
                                           device=dev))
    a, b = out["cuda"], out["cpu"]
    loss_rel, par_rel = losses_params_rel(a, b)
    dl_rel = float(np.max(np.abs(a.deadlines - b.deadlines)
                          / np.abs(b.deadlines)))
    log(f"  [run_fleet_reference, 4x8] losses card {a.losses.tolist()} cpu "
        f"{b.losses.tolist()}; loss rel err {loss_rel:.3e}, params rel err "
        f"{par_rel:.3e}, deadlines rel err {dl_rel:.3e} (tol {TOL}) [{card}]")
    if loss_rel > TOL or par_rel > TOL or dl_rel > TOL:
        raise AssertionError("card and CPU run_fleet_reference disagree")


# ---------------------------------------------------------------------------
# Phases 7-9: partial participation, async events, the reference kernel
# ---------------------------------------------------------------------------

COHORT_M, COHORT_CHUNK = 10, 25
ASYNC_BUFFER, ASYNC_STALENESS, ASYNC_EVENTS = 2500, 20, 10
REF_ROUNDS, REF_CELL_CHUNK = 2, 10


def fleet_counts() -> dict:
    from repro_torch.kernels import block_norms as BN
    from repro_torch.kernels import fleet_fused as FF
    return {"fleet_fused_grads": FF.fused_fleet_grads.launches,
            "tile_norms": BN.tile_norms.launches}


def zero_fleet_counts() -> None:
    from repro_torch.kernels import block_norms as BN
    from repro_torch.kernels import fleet_fused as FF
    FF.fused_fleet_grads.launches = 0
    BN.tile_norms.launches = 0


def populated_slots(sim, carry) -> int:
    """The ring slots the next event's buffer downloaded from, found from
    the in-flight state apart from the engine (the gate's count)."""
    import torch
    from repro_torch.fleet import scheduler as SCHED
    hist, head, version, _, st = carry[:5]
    acfg = sim.cfg.async_config
    sel, _ = SCHED.select_arrivals(
        st.ready, acfg.cohort_buffer(sim.cfg.topology.num_clients))
    tau = version - st.start_ver.reshape(-1)[sel]
    h = acfg.history_len
    return int(torch.unique((head - tau.clamp(0, h - 1)) % h).numel())


def drive(sim, what: str, card: str, slots: bool = False, note=None):
    """Every round or event of ``sim`` from its start, timed as control and
    apply, with the launch counts (zeroed first) each one added; returns
    (carry, metrics, walls in ms, launches a step, and a step's populated
    slots where ``slots`` is set, else its last fused call's clients).
    ``note(r, ctl, metrics)`` adds to each step's line."""
    import torch
    from repro_torch.kernels import fleet_fused as FF
    zero_fleet_counts()
    FF.fused_fleet_grads.last_clients = 0
    carry = sim.init_carry(sim.params)
    torch.cuda.synchronize()
    history, walls, steps, filled = [], [], [], []
    for r in range(sim.cfg.rounds):
        n_slots = populated_slots(sim, carry) if slots else None
        before = fleet_counts()
        t0 = time.perf_counter()
        ctl = sim.control(r)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        carry, m = sim.apply(carry, ctl)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = fleet_counts()
        step = {k: after[k] - before[k] for k in after}
        history.append(m)
        walls.append((t2 - t0) * 1e3)
        steps.append(step)
        filled.append(n_slots if slots else FF.fused_fleet_grads.last_clients)
        extra = ""
        if slots:
            extra = (f"staleness={float(m['staleness']):.3f} "
                     f"sim_time={float(m['sim_time']):.4f} s "
                     f"slots={n_slots} ")
        if note is not None:
            extra += note(r, ctl, m) + " "
        log(f"  {what} {r}: loss={float(m['loss']):.6f} "
            f"participants={int(m['participants'])} "
            f"latency={float(m['round_latency']):.4f} s {extra}"
            f"wall={(t2 - t0) * 1e3:.2f} ms (control {(t1 - t0) * 1e3:.2f}, "
            f"apply {(t2 - t1) * 1e3:.2f}) launches {json.dumps(step)} "
            f"[{card}]")
    metrics = {k: torch.stack([h[k] for h in history]) for k in history[0]}
    losses = metrics["loss"].cpu().tolist()
    if not all(abs(v) < float("inf") for v in losses):
        raise AssertionError(f"{what}: non-finite losses {losses}")
    return carry, metrics, walls, steps, filled


def rerun_bitwise(cfg, mode: str, losses: list, what: str) -> None:
    from repro_torch.fleet import build_simulation
    again = build_simulation(cfg, mode)
    _, m2 = again.simulate(again.params)
    losses2 = m2["loss"].cpu().tolist()
    if losses2 != losses:
        raise AssertionError(f"{what} rerun losses differ: {losses} vs "
                             f"{losses2}")
    log(f"  {what} rerun: losses bitwise identical")


def run_cohort(card: str, main: dict) -> dict:
    """Phase 7: fleet_bench's cohort arm at full width: 10 of 100 clients
    a cell, uniform, the cohort gather (auto), control_chunk=25."""
    import dataclasses
    from repro_torch.fleet import ScheduleConfig, build_simulation
    cfg = dataclasses.replace(
        slice_config(), control_chunk=COHORT_CHUNK,
        schedule=ScheduleConfig(participation="uniform",
                                participants_per_cell=COHORT_M))
    sim = build_simulation(cfg)
    ctl = sim.control(0)
    if ctl.cohort is None or tuple(ctl.cohort.shape) != (SLICE_CELLS,
                                                         COHORT_M):
        raise AssertionError("the cohort path is off")
    carry, metrics, walls, steps, clients = drive(sim, "cohort round", card)
    counts = fleet_counts()
    log("  kernels " + json.dumps(counts))
    for step in steps:
        if step != {"fleet_fused_grads": 1, "tile_norms": 1}:
            raise AssertionError(f"a cohort round launched {step}, not one "
                                 "fused call and one ranking")
    if set(clients) != {SLICE_CELLS * COHORT_M}:
        raise AssertionError(f"the fused calls took {clients} clients, not "
                             f"the {SLICE_CELLS * COHORT_M}-client cohort")
    log(f"  the fused call of each round took the {clients[0]}-client "
        f"cohort {tuple(ctl.cohort.shape)}")
    busy = profile_round(sim, carry, cfg.rounds - 1, card, "cohort round")
    log(f"  cohort round busy {fmt_ms(busy)} against phase 4's full round "
        f"{fmt_ms(main['busy_ms'])}; warm walls {fmt_walls(walls[1:])} "
        f"against {fmt_walls(main['warm_ms'])} [{card}]")
    rerun_bitwise(cfg, "sync", metrics["loss"].cpu().tolist(), "cohort")
    return counts


def run_async(card: str) -> dict:
    """Phase 8: fleet_bench --compare's async arm at full width: a buffer
    of 0.25 n = 2,500, max_staleness 20, polynomial discount, 10 events."""
    import dataclasses
    from repro_torch.fleet import AsyncConfig, build_simulation
    cfg = dataclasses.replace(
        slice_config(rounds=ASYNC_EVENTS),
        async_config=AsyncConfig(buffer_size=ASYNC_BUFFER,
                                 max_staleness=ASYNC_STALENESS,
                                 staleness_discount="polynomial"))
    sim = build_simulation(cfg, "async")
    carry, metrics, walls, steps, filled = drive(sim, "async event", card,
                                                 slots=True)
    counts = fleet_counts()
    log("  kernels " + json.dumps(counts) + f", populated slots summed "
        f"over events {sum(filled)}")
    if not (counts["fleet_fused_grads"] == counts["tile_norms"]
            == sum(filled) > 0):
        raise AssertionError(f"async launches {counts} against "
                             f"{sum(filled)} populated slots")
    for step, n in zip(steps, filled):
        if step != {"fleet_fused_grads": n, "tile_norms": n}:
            raise AssertionError(f"an event launched {step} over {n} slots")
    sim_time = metrics["sim_time"].cpu().tolist()
    if any(b < a for a, b in zip(sim_time, sim_time[1:])):
        raise AssertionError(f"sim_time decreased: {sim_time}")
    if float(metrics["participants"].max()) > ASYNC_BUFFER:
        raise AssertionError("more participants than the buffer")
    busy = profile_round(sim, carry, cfg.rounds, card, "async event")
    log(f"  async event busy {fmt_ms(busy)}; warm walls "
        f"{fmt_walls(walls[1:])} [{card}]")
    rerun_bitwise(cfg, "async", metrics["loss"].cpu().tolist(), "async")
    return counts


def run_reference(card: str, main: dict) -> tuple[dict, dict]:
    """Phase 9: the reference kernel (vmap autodiff, magnitude masks) at
    full width in 1,000-client chunks, then reference(block) against
    fused on a 2 x 8 fleet from the same draws."""
    import dataclasses
    import numpy as np
    from repro_torch import weights
    from repro_torch.fleet import InjectedDraws, build_simulation, run_fleet
    cfg = dataclasses.replace(slice_config(rounds=REF_ROUNDS),
                              kernel="reference", mask_kind="magnitude",
                              cell_chunk=REF_CELL_CHUNK)
    sim = build_simulation(cfg)
    _, metrics, walls, _, _ = drive(sim, "reference round", card)
    counts = fleet_counts()
    log(f"  kernels {json.dumps(counts)} (magnitude masks have no kernel); "
        f"rounds {fmt_walls(walls)} against phase 4's fused warm rounds "
        f"{fmt_walls(main['warm_ms'])} [{card}]")
    rerun_bitwise(cfg, "sync", metrics["loss"].cpu().tolist(), "reference")

    pop, draws, params, state, batches = numpy_fleet(2, 8, 1)
    out = {}
    zero_fleet_counts()
    for kernel in ("reference", "fused"):
        small = dataclasses.replace(
            slice_config(rounds=1, cells=2, per_cell=8), kernel=kernel,
            mask_kind="block")
        src = InjectedDraws(weights.population_from_numpy(pop, device="cuda"),
                            [weights.round_draws_from_numpy(**d, device="cuda")
                             for d in draws])
        start = weights.start_from_numpy(params, state, batches,
                                         device="cuda")
        out[kernel] = run_fleet(small, device="cuda", draws=src, start=start)
        if kernel == "reference":
            block_counts = fleet_counts()
    a, b = out["reference"], out["fused"]
    loss_rel = float(np.max(np.abs(a.losses - b.losses) / np.abs(b.losses)))
    par_rel = max(float(np.max(np.abs(a.params[k][n] - b.params[k][n]))
                        / max(float(np.max(np.abs(b.params[k][n]))), 1e-30))
                  for k in b.params for n in ("w", "b"))
    log(f"  reference(block) against fused, 2x8 clients, one round: loss "
        f"rel err {loss_rel:.3e}, params rel err {par_rel:.3e} (tol {TOL}); "
        f"reference(block) launches {json.dumps(block_counts)} [{card}]")
    if loss_rel > TOL or par_rel > TOL:
        raise AssertionError("reference(block) and fused disagree")
    if block_counts != {"fleet_fused_grads": 0, "tile_norms": 1}:
        raise AssertionError(f"reference(block) launched {block_counts}, "
                             "not one ranking")
    return counts, block_counts


# ---------------------------------------------------------------------------
# Phases 10-12: hex interference, two-tier aggregation, client data
# ---------------------------------------------------------------------------

HEX_ROUNDS = 3
# phase 10: the fixed point's last step may stand this many freeze tolerances
FP_SLACK = 2.0
TIER_PERIOD, TIER_ROUNDS, TIER_EVENTS = 2, 4, 6
STREAM_CELLS, STREAM_PER_CELL, STREAM_CHUNK, STREAM_ROUNDS = 100, 1000, 10, 2
DIRICHLET_ALPHA, DIRICHLET_ROUNDS = 0.3, 3


def check_steps(what: str, steps: list, want) -> None:
    for r, step in enumerate(steps):
        expect = want(r) if callable(want) else want
        if step != expect:
            raise AssertionError(f"{what} {r} launched {step}, not {expect}")


def run_hex(card: str) -> dict:
    """Phase 10: fleet_bench's geometry arm without cell_chunk: 10,000
    clients, hex cells with reuse 3, 6 co-channel neighbours, 25 m
    mobility and handover, the default solver (damped fixed point)."""
    import dataclasses
    import torch
    from repro_torch.fleet import HexInterference, build_simulation
    cfg = dataclasses.replace(
        slice_config(rounds=HEX_ROUNDS),
        geometry=HexInterference(reuse=3, max_neighbors=6, mobility_m=25.0,
                                 handover=True))
    sim = build_simulation(cfg)
    geo = sim.population.geometry
    log(f"  {cfg.topology.num_cells} cells, {geo.nbr_idx.shape[1]} "
        f"co-channel neighbours a cell ({int(geo.nbr_mask.sum())} real), "
        f"fp_iters {cfg.solver.fp_iters}, fp_rtol {cfg.solver.fp_rtol}")
    fp = []

    def note(r, ctl, m):
        chan = cfg.geometry.round_channel(sim.draws.round(r, sim.population),
                                          sim.population, cfg.topology)
        psd = ctl.sol.interference_psd
        fp.append((int(ctl.sol.fp_iterations), float(psd.max()),
                   float(ctl.sol.fp_residual)))
        return (f"fp_iterations={int(ctl.sol.fp_iterations)} "
                f"fp_residual={float(ctl.sol.fp_residual):.3e} "
                f"psd=[{float(psd.min()):.3e}, {float(psd.max()):.3e}] W/Hz "
                f"handover={float(1.0 - chan.served_home.mean()):.4f} "
                f"mean_per={float(m['mean_per']):.4f}")

    carry, metrics, walls, steps, _ = drive(sim, "hex round", card, note=note)
    counts = fleet_counts()
    check_steps("hex round", steps, {"fleet_fused_grads": 1, "tile_norms": 1})
    if not all(0 < it <= cfg.solver.fp_iters for it, _, _ in fp):
        raise AssertionError(f"fixed-point iterations {fp}")
    if not any(top > 0 for _, top, _ in fp):
        raise AssertionError("no cell saw co-channel interference")
    # the damped iterate converges on the card: the last step is within
    # twice the freeze tolerance even where the cap stopped it
    n0 = cfg.wireless.noise_psd_w_per_hz
    far = [(r, res, FP_SLACK * cfg.solver.fp_rtol * (n0 + top))
           for r, (_, top, res) in enumerate(fp)
           if not res <= FP_SLACK * cfg.solver.fp_rtol * (n0 + top)]
    if far:
        raise AssertionError(f"fixed point not converging (round, residual,"
                             f" limit): {far}")
    busy = profile_round(sim, carry, cfg.rounds - 1, card, "hex round")
    log(f"  hex round busy {fmt_ms(busy)}; walls {fmt_walls(walls)} [{card}]")
    rerun_bitwise(cfg, "sync", metrics["loss"].cpu().tolist(), "hex")
    del sim
    torch.cuda.empty_cache()
    return counts


def run_two_tier(card: str, main: dict) -> tuple[dict, dict]:
    """Phase 11: (a) phase 4's configuration with cloud_period 2, 4
    rounds; (b) phase 8's async configuration with cloud_period 2, 6
    events."""
    import dataclasses
    import torch
    from repro_torch.fleet import AsyncConfig, build_simulation
    cfg = dataclasses.replace(slice_config(rounds=TIER_ROUNDS),
                              cloud_period=TIER_PERIOD)
    sim = build_simulation(cfg)
    carry, metrics, walls, steps, _ = drive(sim, "two-tier round", card)
    cells = cfg.topology.num_cells
    check_steps("two-tier round", steps,
                {"fleet_fused_grads": cells, "tile_norms": cells})
    sync_counts = fleet_counts()
    lat = metrics["round_latency"].cpu().tolist()
    backhaul = cfg.wireless.backhaul_s
    extra = [a - b for a, b in zip(lat, main["latencies"])]
    want = [backhaul if r % TIER_PERIOD == TIER_PERIOD - 1 else 0.0
            for r in range(cfg.rounds)]
    log(f"  latency minus phase 4's single tier: "
        f"{[f'{e:.6f}' for e in extra]} s (backhaul {backhaul:.6f} s on "
        f"merge rounds)")
    if any(abs(e - w) > 1e-5 for e, w in zip(extra, want)):
        raise AssertionError(f"merge rounds do not price the backhaul: "
                             f"{extra} against {want}")
    busy = profile_round(sim, carry, cfg.rounds - 1, card, "two-tier round")
    log(f"  two-tier round busy {fmt_ms(busy)} against phase 4's "
        f"{fmt_ms(main['busy_ms'])}; walls {fmt_walls(walls)} [{card}]")
    rerun_bitwise(cfg, "sync", metrics["loss"].cpu().tolist(), "two-tier")
    del sim, carry
    torch.cuda.empty_cache()

    acfg = dataclasses.replace(
        slice_config(rounds=TIER_EVENTS), cloud_period=TIER_PERIOD,
        async_config=AsyncConfig(buffer_size=ASYNC_BUFFER,
                                 max_staleness=ASYNC_STALENESS,
                                 staleness_discount="polynomial"))
    sim = build_simulation(acfg, "async")
    carry, metrics, walls, steps, filled = drive(
        sim, "two-tier async event", card, slots=True)
    check_steps("two-tier async event", steps,
                lambda r: {"fleet_fused_grads": 0, "tile_norms": filled[r]})
    async_counts = fleet_counts()
    log("  kernels " + json.dumps(async_counts) + f", populated slots "
        f"summed over events {sum(filled)}")
    sim_time = metrics["sim_time"].cpu().tolist()
    if any(b < a for a, b in zip(sim_time, sim_time[1:])):
        raise AssertionError(f"sim_time decreased: {sim_time}")
    if float(metrics["participants"].max()) > ASYNC_BUFFER:
        raise AssertionError("more participants than the buffer")
    busy = profile_round(sim, carry, acfg.rounds, card,
                         "two-tier async event")
    log(f"  two-tier async event busy {fmt_ms(busy)}; walls "
        f"{fmt_walls(walls)} [{card}]")
    rerun_bitwise(acfg, "async", metrics["loss"].cpu().tolist(),
                  "two-tier async")
    del sim, carry
    torch.cuda.empty_cache()
    return sync_counts, async_counts


def label_share(labels) -> float:
    """Mean over clients of the largest class's share of a client's
    labels ((n, batch) int64 on the card)."""
    import torch
    counts = torch.nn.functional.one_hot(labels, DNN["num_classes"]).sum(1)
    return float(counts.max(dim=-1).values.double().mean()) / labels.shape[1]


def run_data(card: str) -> tuple[dict, dict]:
    """Phase 12: (a) 100,000 clients streamed (2.5 GB of float32 client
    data, over the 512 MB cache limit) against the same run cached; (b)
    Dirichlet(0.3) labels at the 10k slice."""
    import dataclasses
    import torch
    from repro_torch.core import pruning
    from repro_torch.fleet import SyntheticMLPTask, build_simulation
    cfg = dataclasses.replace(
        slice_config(rounds=STREAM_ROUNDS, cells=STREAM_CELLS,
                     per_cell=STREAM_PER_CELL), cell_chunk=STREAM_CHUNK)
    runs, peaks = {}, {}
    for what, c in (("streamed", cfg),
                    ("cached", dataclasses.replace(cfg, cache_data=True))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim = build_simulation(c)
        torch.cuda.synchronize()
        cached = sim.data.cached
        log(f"  {what}: build {time.perf_counter() - t0:.2f} s, cache "
            f"{'none' if cached is None else tuple(cached['x'].shape)}")
        if (sim.data.cached is None) != (what == "streamed"):
            raise AssertionError(f"the {what} run's data path is wrong")
        carry, metrics, walls, steps, _ = drive(sim, f"{what} round", card)
        peaks[what] = torch.cuda.max_memory_allocated() / 2**30
        if what == "streamed":
            check_steps("streamed round", steps,
                        {"fleet_fused_grads": STREAM_CELLS // STREAM_CHUNK,
                         "tile_norms": 1})
            stream_counts = fleet_counts()
        runs[what] = (metrics["loss"].cpu().tolist(),
                      [p.cpu() for p in pruning.flatten(carry[0])])
        log(f"  {what}: {cfg.topology.num_clients} clients, walls "
            f"{fmt_walls(walls)}, peak device memory {peaks[what]:.3f} GiB "
            f"[{card}]")
        del sim, carry
    (l_s, p_s), (l_c, p_c) = runs["streamed"], runs["cached"]
    if l_s != l_c or not all(torch.equal(a, b) for a, b in zip(p_s, p_c)):
        raise AssertionError(f"streamed and cached runs differ: {l_s} vs "
                             f"{l_c}")
    log("  streamed and cached runs: losses and params bitwise equal")
    torch.cuda.empty_cache()

    dcfg = dataclasses.replace(
        slice_config(rounds=DIRICHLET_ROUNDS),
        task=SyntheticMLPTask(**DNN, dirichlet_alpha=DIRICHLET_ALPHA))
    sim = build_simulation(dcfg)
    n = dcfg.topology.num_clients
    skew = label_share(sim.data.block(0, n)["y"])
    iid = label_share(build_simulation(slice_config(rounds=1)
                                       ).data.block(0, n)["y"])
    log(f"  mean largest-class share of a client's {DNN['local_batch']} "
        f"labels: Dirichlet({DIRICHLET_ALPHA}) {skew:.4f}, IID {iid:.4f}")
    _, metrics, walls, steps, _ = drive(sim, "Dirichlet round", card)
    check_steps("Dirichlet round", steps,
                {"fleet_fused_grads": 1, "tile_norms": 1})
    dirichlet_counts = fleet_counts()
    rerun_bitwise(dcfg, "sync", metrics["loss"].cpu().tolist(), "Dirichlet")
    del sim
    torch.cuda.empty_cache()
    return stream_counts, dirichlet_counts


# ---------------------------------------------------------------------------
# Phase 13: telemetry at the slice; phase 14: the host reference path
# ---------------------------------------------------------------------------

TEL_HISTS = ("per_hist", "rho_hist", "bw_hist", "latency_hist", "sinr_hist")
TEL_TIER_ROUNDS, TEL_OVERHEAD_PAIRS = 2, 4


def with_telemetry(cfg):
    import dataclasses
    from repro_torch.fleet import TelemetryConfig
    return dataclasses.replace(cfg, telemetry=TelemetryConfig())


def rerun_telemetry(cfg, mode: str, result, what: str) -> None:
    """A second build and run of ``cfg``: losses and every telemetry
    array bitwise equal to ``result``'s (NaN where NaN)."""
    import numpy as np
    from repro_torch.fleet import build_simulation
    again = build_simulation(cfg, mode)
    res2 = again.finalize(*again.simulate(again.params))
    if not np.array_equal(res2.losses, result.losses):
        raise AssertionError(f"{what} rerun losses differ")
    for name, v in result.telemetry.items():
        if not np.array_equal(res2.telemetry[name], v, equal_nan=True):
            raise AssertionError(f"{what} rerun: telemetry {name} differs")
    log(f"  {what} rerun: losses and {len(result.telemetry)} telemetry "
        f"arrays bitwise identical")


def phase_device_ms(fn, card: str) -> None:
    """``fn`` once under torch.profiler: for each ``record_function``
    phase of the engine, the device time of the kernels, copies and
    fills launched inside it (matched to their launch by the trace's
    correlation ids, so the kernels launched through ctypes count too),
    beside the phase's host time."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in PHASES]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    dev, host, total = {}, {}, 0.0
    for name, t0, t1 in spans:
        host[name] = host.get(name, 0.0) + (t1 - t0)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        total += e["dur"]
        t = launched.get(e.get("args", {}).get("correlation"))
        for name, t0, t1 in spans:
            if t is not None and t0 <= t <= t1:
                dev[name] = dev.get(name, 0.0) + e["dur"]
    if not spans or total <= 0:
        log("  device time by phase: not measured (no phase spans or no "
            "device events in the trace)")
        return
    parts = [f"{k} {dev.get(k, 0.0) / 1e3:.3f} ms device / "
             f"{host[k] / 1e3:.2f} ms host" for k in PHASES if k in host]
    log(f"  profiled round by phase: {'; '.join(parts)}; device total "
        f"{total / 1e3:.3f} ms [{card}]")


def telemetry_overhead(sim_off, carry_off, sim_on, carry_on, r: int,
                       card: str) -> dict:
    """Warm steps of the same round with telemetry off and on, in turns
    (off, on, on, off, ...): the medians of their walls in ms."""
    import statistics
    import torch
    walls = {"off": [], "on": []}
    for i in range(TEL_OVERHEAD_PAIRS):
        order = (("off", sim_off, carry_off), ("on", sim_on, carry_on))
        for what, sim, carry in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.step(carry, r)
            torch.cuda.synchronize()
            walls[what].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"  warm round wall, telemetry off {med['off']:.2f} ms / on "
        f"{med['on']:.2f} ms (medians of {TEL_OVERHEAD_PAIRS}, in turns): "
        f"overhead {med['on'] - med['off']:+.2f} ms "
        f"({100 * (med['on'] / med['off'] - 1):+.1f}%); off "
        f"{fmt_walls(walls['off'])}, on {fmt_walls(walls['on'])} [{card}]")
    return med


def run_telemetry(card: str, main: dict) -> dict:
    """Phase 13: telemetry on the main path and on the hex, async and
    two-tier paths at the slice, the sinks and the span recorder."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from repro_torch.fleet import (AsyncConfig, CSVSink, HexInterference,
                                   JSONLSink, SpanRecorder, build_simulation,
                                   emit_result, run_fleet)

    # (a) phase 4's configuration
    cfg = with_telemetry(slice_config())
    sim = build_simulation(cfg)
    carry, metrics, walls, steps, _ = drive(sim, "telemetry round", card)
    check_steps("telemetry round", steps,
                {"fleet_fused_grads": 1, "tile_norms": 1})
    counts = fleet_counts()
    res = sim.finalize(carry, metrics)
    if res.losses.tolist() != main["losses"] \
            or res.latencies.tolist() != main["latencies"]:
        raise AssertionError("telemetry changed the losses or latencies")
    for k, layer in main["params"].items():
        for n, v in layer.items():
            if not np.array_equal(res.params[k][n], v):
                raise AssertionError(f"telemetry changed params {k}/{n}")
    log("  losses, latencies and params bitwise equal to phase 4's "
        "telemetry-off run")
    tel = res.telemetry
    cells, per_cell = cfg.topology.shape
    for name in TEL_HISTS:
        h = tel[name]
        if h.shape != (cfg.rounds, cells, cfg.telemetry.bins) \
                or not np.all(h.sum(-1) == per_cell):
            raise AssertionError(f"{name}: shape {h.shape}, masses "
                                 f"{np.unique(h.sum(-1))}")
    g, d = tel["grad_norm"], tel["mask_density"]
    if not (np.isfinite(g).all() and (g >= 0).all()
            and ((d >= 0) & (d <= 1)).all()):
        raise AssertionError(f"grad_norm {g} mask_density {d}")
    log(f"  {', '.join(TEL_HISTS)}: {tel['per_hist'].shape} each, every "
        f"cell's mass {per_cell}; grad_norm {np.round(g, 6).tolist()}, "
        f"mask_density {np.round(d, 4).tolist()}; bw share bins of round 0 "
        f"summed over cells {tel['bw_hist'][0].sum(0).astype(int).tolist()}")
    off = build_simulation(slice_config())
    carry_off = off.step(off.init_carry(off.params), 0)[0]
    med = telemetry_overhead(off, carry_off, sim, carry, cfg.rounds - 1,
                             card)
    phase_device_ms(lambda: sim.step(carry, cfg.rounds - 1), card)
    rerun_telemetry(cfg, "sync", res, "telemetry")
    del sim, off, carry, carry_off

    # (b) phase 10's hex configuration
    hcfg = with_telemetry(dataclasses.replace(
        slice_config(rounds=HEX_ROUNDS),
        geometry=HexInterference(reuse=3, max_neighbors=6, mobility_m=25.0,
                                 handover=True)))
    sim = build_simulation(hcfg)
    res = sim.finalize(*drive(sim, "telemetry hex round", card)[:2])
    tel = res.telemetry
    it, resid, last = (tel["fp_iterations"], tel["fp_residuals"],
                       tel["fp_residual"])
    fp_iters = hcfg.solver.fp_iters
    if resid.shape != (hcfg.rounds, fp_iters) \
            or not all(1 <= i <= fp_iters for i in it):
        raise AssertionError(f"fp_iterations {it}, fp_residuals "
                             f"{resid.shape}")
    for r in range(hcfg.rounds):
        if not (np.isfinite(resid[r, :it[r]]).all()
                and np.isnan(resid[r, it[r]:]).all()
                and resid[r, it[r] - 1] == last[r]):
            raise AssertionError(f"round {r}: residuals {resid[r]} against "
                                 f"{it[r]} iterations, last {last[r]}")
    log(f"  hex: fp_iterations {it.tolist()}, fp_residuals {resid.shape} "
        f"NaN past each round's count, last finite = fp_residual "
        f"({np.array2string(last, precision=3)} W/Hz)")
    rerun_telemetry(hcfg, "sync", res, "telemetry hex")
    del sim
    torch.cuda.empty_cache()

    # (c) phase 8's async configuration
    acfg = with_telemetry(dataclasses.replace(
        slice_config(rounds=ASYNC_EVENTS),
        async_config=AsyncConfig(buffer_size=ASYNC_BUFFER,
                                 max_staleness=ASYNC_STALENESS,
                                 staleness_discount="polynomial")))
    sim = build_simulation(acfg, "async")
    res = sim.finalize(*drive(sim, "telemetry async event",
                                     card)[:2])
    sh = res.telemetry["staleness_hist"]
    if not np.all(sh.sum(-1) == ASYNC_BUFFER):
        raise AssertionError(f"staleness_hist masses {sh.sum(-1)}")
    log(f"  async: staleness_hist {sh.shape}, every event's mass "
        f"{ASYNC_BUFFER} (the buffer); bins summed over events "
        f"{sh.sum(0).astype(int).tolist()}")
    rerun_telemetry(acfg, "async", res, "telemetry async")
    del sim
    torch.cuda.empty_cache()

    # (d) phase 11a's two-tier configuration
    tcfg = with_telemetry(dataclasses.replace(
        slice_config(rounds=TEL_TIER_ROUNDS), cloud_period=TIER_PERIOD))
    sim = build_simulation(tcfg)
    res = sim.finalize(*drive(sim, "telemetry two-tier round",
                                     card)[:2])
    g = res.telemetry["grad_norm"]
    if not (np.isfinite(g).all() and (g >= 0).all()):
        raise AssertionError(f"two-tier grad_norm {g}")
    log(f"  two-tier: edge grad_norm {g.tolist()}")
    rerun_telemetry(tcfg, "sync", res, "telemetry two-tier")
    del sim
    torch.cuda.empty_cache()

    # (e) sinks and spans
    rec = SpanRecorder()
    with tempfile.TemporaryDirectory() as tmp:
        jsonl, csv_path = Path(tmp) / "run.jsonl", Path(tmp) / "run.csv"
        sink = JSONLSink(str(jsonl))
        res = run_fleet(with_telemetry(slice_config(rounds=2)), sink=sink,
                        recorder=rec)
        sink.close()
        emit_result(res, CSVSink(str(csv_path)), close=True)
        lines = jsonl.read_text().splitlines()
        rows = csv_path.read_text().splitlines()
        trace = rec.write(str(Path(tmp) / "trace.json"))
        names = {e["name"] for e in json.loads(
            Path(trace).read_text())["traceEvents"]}
    if len(lines) != 3 or len(rows) != 4:     # the CSV adds its header
        raise AssertionError(f"sinks wrote {len(lines)} JSONL records and "
                             f"{len(rows)} CSV rows for 2 rounds")
    if names != {"fleet.build", "fleet.simulate", "fleet.finalize"}:
        raise AssertionError(f"trace spans {names}")
    spans = {e["name"]: e["dur"] / 1e3 for e in rec.events}
    log(f"  JSONL and CSV sinks: 3 records each (header + 2 rounds); "
        f"chrome trace spans " + ", ".join(f"{k} {v:.1f} ms"
                                           for k, v in spans.items()))
    return dict(counts=counts, overhead=med)


HOST_SCHEMES = ("proposed", "gba", "fpr:0.3", "exhaustive", "ideal")
SV_ROUNDS, REF_HOST_ROUNDS = 8, 2


def run_host_reference(card: str) -> dict:
    """Phase 14: (a) the §V run on Table I, every scheme, both mask
    kinds; (b) run_fleet_reference at the slice beside run_fleet on the
    same draws; (c) run_any on the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.federated import system as SYS
    from repro_torch.fleet import FleetResult, build_simulation

    # (a) 5 UEs, K = (30, 40, 50, 30, 40), the DNN, SV_ROUNDS rounds
    costs, norms_total = {}, 0
    for structured in (False, True):
        for scheme in HOST_SCHEMES:
            cfg = SYS.FLConfig(hidden=DNN["hidden"], rounds=SV_ROUNDS,
                               scheme=scheme, structured=structured)
            zero_fleet_counts()
            t0 = time.perf_counter()
            res = SYS.run(cfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / cfg.rounds
            counts = fleet_counts()
            want = {"fleet_fused_grads": 0,
                    "tile_norms": cfg.rounds if structured else 0}
            if counts != want:
                raise AssertionError(f"run {scheme} structured={structured}"
                                     f" launched {counts}, not {want}")
            norms_total += counts["tile_norms"]
            if not np.isfinite(res.losses).all():
                raise AssertionError(f"run {scheme}: losses {res.losses}")
            costs[(scheme, structured)] = float(np.mean(res.total_costs))
            log(f"  run [{scheme}, structured={structured}]: mean cost "
                f"{costs[(scheme, structured)]:.6f}, mean rho "
                f"{res.prune_rates.mean():.4f}, mean PER "
                f"{res.per_rates.mean():.5f}, loss {res.losses[0]:.5f} -> "
                f"{res.losses[-1]:.5f}, final accuracy "
                f"{res.accuracy[-1][1]:.4f}, {wall:.1f} ms a round, "
                f"launches {json.dumps(counts)} [{card}]")
            if scheme == "proposed":
                if not res.losses[-1] < res.losses[0]:
                    raise AssertionError(f"proposed loss does not fall: "
                                         f"{res.losses}")
                again = SYS.run(cfg)
                if again.losses != res.losses:
                    raise AssertionError("run rerun losses differ")
                log("  run rerun: losses bitwise identical")
        for base in ("gba", "fpr:0.3"):
            if costs[("proposed", structured)] > costs[(base, structured)]:
                raise AssertionError(f"proposed costs more than {base}: "
                                     f"{costs}")
    log(f"  mean total cost: proposed <= gba and fpr:0.3 (both mask kinds)")

    # (b) run_fleet_reference at the slice, beside run_fleet
    cfg = slice_config(rounds=REF_HOST_ROUNDS)
    dev_sim = build_simulation(cfg)
    host_sim = dataclasses.replace(
        build_simulation(cfg),
        solve_fn=SYS._host_cell_solver(cfg, dev_sim.population))
    gaps = []

    def note(r, ctl, m):
        dev_dl = dev_sim.control(r).sol.deadline
        gap = float(((ctl.sol.deadline - dev_dl).abs() / dev_dl.abs()).max())
        gaps.append(gap)
        return (f"deadline gap to the device solver {gap:.3e}, mean_rho "
                f"{float(m['mean_prune']):.4f}")

    carry, metrics, walls, steps, _ = drive(host_sim, "host-reference round",
                                            card, note=note)
    check_steps("host-reference round", steps,
                {"fleet_fused_grads": 1, "tile_norms": 1})
    host_counts = fleet_counts()
    res = host_sim.finalize(carry, metrics)
    fleet = dev_sim.finalize(*dev_sim.simulate(dev_sim.params))
    log(f"  run_fleet_reference at {cfg.topology.num_clients} clients: "
        f"losses {res.losses.tolist()} (run_fleet {fleet.losses.tolist()}), "
        f"mean prune {res.mean_prune.tolist()} (run_fleet "
        f"{fleet.mean_prune.tolist()}); largest deadline gap "
        f"{max(gaps):.3e} (tol 1e-3) [{card}]")
    if max(gaps) > 1e-3:
        raise AssertionError(f"host and device deadlines differ by "
                             f"{max(gaps):.3e}")
    del dev_sim, host_sim, carry
    torch.cuda.empty_cache()

    # (c) run_any on the card
    small = SYS.run_any(SYS.FLConfig(rounds=2))
    big = SYS.run_any(SYS.FLConfig(num_clients=128, rounds=2))
    if not (isinstance(small, SYS.FLResult)
            and isinstance(big, FleetResult)):
        raise AssertionError(f"run_any gave {type(small).__name__} and "
                             f"{type(big).__name__}")
    log(f"  run_any: 5 clients -> FLResult (losses {small.losses}), 128 -> "
        f"FleetResult (losses {big.losses.tolist()}) [{card}]")
    return dict(host_counts=host_counts, fl_norms=norms_total)


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.3f} ms"


def fmt_walls(walls) -> str:
    return "[" + ", ".join(f"{w:.2f}" for w in walls) + "] ms"


# ---------------------------------------------------------------------------
# Phase 15: the generic gradient path's tasks, and the fleet-trained model
# served
# ---------------------------------------------------------------------------

LINREG_ROUNDS = 5
LM_CELLS, LM_PER_CELL, LM_ROUNDS = 4, 8, 3
LM_PROMPTS, LM_PROMPT, LM_NEW = 8, 16, 16


def run_linreg(card: str) -> dict:
    """Phase 15a: LinearRegressionTask at the slice's 10,000 clients,
    kernel="fused" (the generic path), 5 rounds."""
    import dataclasses
    from repro_torch.fleet import LinearRegressionTask, build_simulation
    cfg = dataclasses.replace(slice_config(rounds=LINREG_ROUNDS),
                              task=LinearRegressionTask())
    sim = build_simulation(cfg)

    def note(r, ctl, m):
        return f"R2={float(m['accuracy']):.5f}"

    _, metrics, walls, steps, _ = drive(sim, "linreg round", card, note=note)
    check_steps("linreg round", steps,
                {"fleet_fused_grads": 0, "tile_norms": 1})
    counts = fleet_counts()
    losses = metrics["loss"].cpu().tolist()
    r2 = metrics["accuracy"].cpu().tolist()
    if not (losses[-1] < losses[0] and r2[-1] > r2[0]):
        raise AssertionError(f"linreg: loss {losses}, R2 {r2}")
    log(f"  linreg: loss {losses[0]:.5f} -> {losses[-1]:.5f}, R2 "
        f"{r2[0]:.5f} -> {r2[-1]:.5f}; warm walls {fmt_walls(walls[1:])} "
        f"[{card}]")
    rerun_bitwise(cfg, "sync", losses, "linreg")
    return counts


def lm_task():
    """smollm-135m at full width in float32, the fleet's transformer."""
    from repro_torch.configs import get_config
    from repro_torch.fleet import TransformerTask
    return TransformerTask(
        arch=get_config("smollm-135m").replace(param_dtype="float32",
                                               compute_dtype="float32"),
        seq_len=16, local_batch=2, pool_clients=32)


def run_lm(card: str):
    """Phase 15b: smollm-135m at full width trained by the fleet: 4 x 8
    clients, kernel="fused" (the generic path over bounded client blocks),
    3 rounds.  Returns (launch counts, the FleetResult)."""
    import torch
    from repro_torch.fleet import FleetConfig, FleetTopology, build_simulation
    from repro_torch.kernels import fleet_fused as FF
    from repro_torch.models import model as M
    task = lm_task()
    cfg = FleetConfig(task=task, topology=FleetTopology(LM_CELLS, LM_PER_CELL),
                      kernel="fused", rounds=LM_ROUNDS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = build_simulation(cfg)
    torch.cuda.synchronize()
    n_params = M.param_count(sim.params)
    log(f"  build {time.perf_counter() - t0:.2f} s: {n_params} params "
        f"(float32), model_bits {sim.cfg.wireless.model_bits:.6g}, "
        f"{FF.scan_block(sim.params, LM_CELLS * LM_PER_CELL)} client(s) a "
        f"gradient block; data "
        f"{'streamed' if sim.data.cached is None else 'cached'}")
    if sim.cfg.wireless.model_bits != 32.0 * n_params:
        raise AssertionError(f"model_bits {sim.cfg.wireless.model_bits} is "
                             f"not 32 x {n_params}")

    def note(r, ctl, m):
        return (f"acc={float(m['accuracy']):.4f} "
                f"mean_rho={float(m['mean_prune']):.4f}")

    carry, metrics, walls, steps, _ = drive(sim, "smollm round", card,
                                            note=note)
    check_steps("smollm round", steps,
                {"fleet_fused_grads": 0, "tile_norms": 1})
    counts = fleet_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  smollm-135m fleet: warm walls {fmt_walls(walls[1:])}, peak "
        f"device memory {peak:.3f} GiB [{card}]")
    profile_round(sim, carry, cfg.rounds - 1, card, "smollm round")

    # the generic path alone (warm from the rounds): the 32 clients'
    # gradients after one ranking, by the task the engine's clients train
    # (``sim.task``: the model without remat)
    params = carry[0]
    n = cfg.topology.num_clients
    rho = torch.linspace(0.0, 0.7, n, device="cuda")
    w = torch.ones(n, device="cuda")
    batch = sim.data.block(0, n)
    prep = sim.task.kernel_prepare(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.task.kernel_grads(params, prep, batch, rho, w)
    torch.cuda.synchronize()
    per_client = (time.perf_counter() - t0) * 1e3 / n
    log(f"  generic path (kernel_grads): {per_client:.3f} ms a client over "
        f"{n} clients [{card}]")
    result = sim.finalize(carry, metrics)
    if not torch.isfinite(metrics["loss"]).all():
        raise AssertionError(f"smollm losses {result.losses}")
    rerun_bitwise(cfg, "sync", metrics["loss"].cpu().tolist(), "smollm")
    del sim, carry, params, prep, batch
    torch.cuda.empty_cache()
    return counts, result


def run_exported(card: str, result) -> dict:
    """Phase 15c: 15b's trained model pruned at its last round's mean
    rate (``export_from_result``), loaded (``load_pruned``) and served:
    8 requests of 16 prompt tokens and 16 new, on 8 slots and on 4 (equal
    tokens) and in wave mode.  Returns the serve kernels' launches."""
    import tempfile
    import numpy as np
    from repro_torch.serve import (ServeConfig, ServeEngine, SparseModel,
                                   export_from_result, load_pruned)
    task = lm_task()
    counters = serve_counters()
    for fn in counters.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = str(Path(tmp) / "smollm_fleet.npz")
        t0 = time.perf_counter()
        bundle = export_from_result(path, task, result)
        t1 = time.perf_counter()
        loaded = load_pruned(path, task)
        t2 = time.perf_counter()
    if loaded.rho != float(np.float32(result.mean_prune[-1])) \
            or bundle.rho != float(result.mean_prune[-1]):
        raise AssertionError(f"the bundle's rate {loaded.rho} is not the last "
                             f"round's mean {result.mean_prune[-1]}")
    log(f"  export (ranking, keeps, .npz) {t1 - t0:.2f} s, load "
        f"{t2 - t1:.2f} s; rho {loaded.rho:.6f} (last round's mean "
        f"{result.mean_prune[-1]:.6f}), achieved {achieved_rho(loaded):.4f}")
    model = SparseModel(task.config(), loaded)
    prompts = np.random.RandomState(SERVE_SEED + 3).randint(
        0, task.config().vocab_size, (LM_PROMPTS, LM_PROMPT)).astype(np.int32)
    tokens = {}
    for slots in (8, 4):
        eng = ServeEngine(model, ServeConfig(max_slots=slots,
                                             page_len=LM_PROMPT + LM_NEW,
                                             max_new=LM_NEW))
        t0 = time.perf_counter()
        tokens[slots] = eng.generate(prompts)
        log(f"  generate on {slots} slots: {LM_PROMPTS} requests x "
            f"({LM_PROMPT} + {LM_NEW}) in {time.perf_counter() - t0:.2f} s "
            f"[{card}]")
    if not np.array_equal(tokens[8], tokens[4]):
        raise AssertionError("the exported model's tokens differ between 8 "
                             "and 4 slots")
    wave = ServeEngine(model, ServeConfig(
        max_slots=8, page_len=LM_PROMPT + LM_NEW,
        max_new=LM_NEW)).generate_prefilled(prompts)
    same = int(sum(np.array_equal(a, b) for a, b in zip(wave, tokens[8])))
    counts = {name: fn.launches for name, fn in counters.items()}
    log(f"  8-slot and 4-slot tokens bitwise equal; wave mode equal on "
        f"{same}/{LM_PROMPTS} requests; serve kernels {json.dumps(counts)}")
    for name in ("block_sparse_matmul", "flash_prefill", "decode_attention"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched serving the export")
    return counts


# ---------------------------------------------------------------------------
# Phase 6: serve smollm-135m
# ---------------------------------------------------------------------------

SERVE_SEED, SERVE_REQUESTS, SERVE_RHO = 2026, 64, 0.5


def serve_counters():
    from repro_torch.kernels import block_norms as BN
    from repro_torch.kernels import block_sparse_matmul as BSM
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_prefill as FP
    return {"block_sparse_matmul": BSM.block_sparse_matmul,
            "block_sparse_matmul_t": BSM.block_sparse_matmul_t,
            "decode_attention": DA.decode_attention,
            "flash_prefill": FP.flash_prefill, "tile_norms": BN.tile_norms}


def achieved_rho(bundle) -> float:
    """Pruned fraction of the prunable leaves' elements."""
    from repro_torch.core import pruning
    kept = total = 0
    for leaf, mask in zip(pruning.flatten(bundle.params),
                          pruning.flatten(bundle.masks())):
        if leaf.ndim >= 2:
            kept += int(mask.sum())
            total += mask.numel()
    return 1.0 - kept / total


def host_loop(model, prompts, card_dev) -> list:
    """Per-request greedy decode through ``decode_step`` at batch 1."""
    import torch
    out = []
    for row in prompts:
        caches = model.init_caches(1, SERVE_PAGE)
        gen = []
        for t in range(SERVE_PROMPT + SERVE_NEW - 1):
            tok = int(row[t]) if t < SERVE_PROMPT else gen[-1]
            lg, caches = model.decode_step(
                model.arrays, torch.full((1, 1), tok, device=card_dev),
                caches, torch.full((1,), t, device=card_dev))
            if t >= SERVE_PROMPT - 1:
                gen.append(int(torch.argmax(lg, -1)[0]))
        out.append(gen)
    return out


def wave_ties(tokens_cb, tokens_wave, ref_logits) -> int:
    """Requests where wave mode first departs from continuous batching;
    each departure must sit on a near-tie of the reference's logits (top-2
    gap under 1e-4 of the logit scale).  Returns their number."""
    import numpy as np
    ties = 0
    for r in range(tokens_cb.shape[0]):
        diff = np.nonzero(tokens_cb[r] != tokens_wave[r])[0]
        if diff.size == 0:
            continue
        lg = ref_logits[r, diff[0]]
        top2 = np.sort(lg)[-2:]
        gap, scale = float(top2[1] - top2[0]), float(np.abs(lg).max())
        if gap >= 1e-4 * scale:
            raise AssertionError(
                f"wave mode differs from generate at request {r}, token "
                f"{diff[0]}: top-2 gap {gap:.3e} of scale {scale:.3e}")
        ties += 1
    return ties


def numpy_params(cfg, seed: int) -> dict:
    """Random weights of ``cfg``'s shapes, drawn with numpy: norm scales 1,
    embedding N(0, 0.02^2), matrices N(0, 1/fan_in) (the init's scales)."""
    import numpy as np
    from repro_torch.core import pruning
    from repro_torch.models import model as M
    rng = np.random.default_rng(seed)
    like = M.init_params(cfg, None)
    leaves = []
    for leaf in pruning.flatten(like):
        shape = tuple(leaf.shape)
        if leaf.ndim == 2 and shape == (cfg.vocab_size, cfg.d_model):
            leaves.append(rng.normal(size=shape).astype(np.float32) * 0.02)
        elif leaf.ndim >= 3:
            leaves.append(rng.normal(size=shape).astype(np.float32)
                          / np.sqrt(shape[-2]))
        else:
            leaves.append(np.ones(shape, np.float32))
    return pruning.unflatten(like, leaves)


def card_vs_cpu_serve(cfg, card: str) -> None:
    """A 2-layer, full-width copy (depth cut only) from the same numpy
    weights and keeps on the card (kernels) and on the CPU (plain
    versions): decode and prefill logits within 1e-4."""
    import types
    import numpy as np
    import torch
    from repro_torch import weights
    from repro_torch.fleet.task import TransformerTask
    from repro_torch.serve import SparseModel, make_bundle

    cfg2 = two_layers(cfg)
    task = TransformerTask(arch=cfg2)
    params = numpy_params(cfg2, SERVE_SEED + 1)
    bundle = make_bundle(task, weights.tree_from_numpy(params, device="cpu"),
                         SERVE_RHO)
    as_numpy = types.SimpleNamespace(
        params=params, keeps=[None if k is None else k.numpy()
                              for k in bundle.keeps],
        grid=bundle.grid, rho=bundle.rho)
    toks = np.random.RandomState(SERVE_SEED + 2).randint(
        0, cfg.vocab_size, (4, 8))
    logits = {}
    for dev in ("cpu", "cuda"):
        model = SparseModel(cfg2, weights.bundle_from_numpy(as_numpy,
                                                            device=dev),
                            device=dev)
        caches = model.init_caches(4, 16)
        outs = []
        for i in range(toks.shape[1]):
            lg, caches = model.decode_step(
                model.arrays, torch.as_tensor(toks[:, i:i + 1], device=dev),
                caches, torch.full((4,), i, device=dev))
            outs.append(lg.cpu())
        lp, _ = model.prefill(model.arrays, torch.as_tensor(toks, device=dev),
                              16)
        logits[dev] = (torch.stack(outs, 1), lp.cpu())
    for what, a, b in zip(("decode", "prefill"), logits["cuda"],
                          logits["cpu"]):
        rel_gate(a, b, f"2-layer full-width card vs CPU {what} logits "
                 f"{tuple(a.shape)}", card)


def run_serve(card: str) -> dict:
    """Serve smollm-135m at full width; returns the serve kernels' launch
    counts over bundling, generate and generate_prefilled."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fleet.task import TransformerTask
    from repro_torch.serve import (ServeConfig, ServeEngine, SparseModel,
                                   make_bundle)

    cfg = get_config("smollm-135m")
    task = TransformerTask(arch=cfg)
    t0 = time.perf_counter()
    params = task.init_params(
        torch.Generator(device="cuda").manual_seed(SERVE_SEED))
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim_}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, params {cfg.param_dtype} "
        f"drawn in {time.perf_counter() - t0:.2f} s")
    prompts = np.random.RandomState(SERVE_SEED).randint(
        0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)
    serve_cfg = ServeConfig(max_slots=SERVE_BATCH, page_len=SERVE_PAGE,
                            max_new=SERVE_NEW)

    counters = serve_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    bundle = make_bundle(task, params, SERVE_RHO)
    torch.cuda.synchronize()
    t_bundle = time.perf_counter() - t0
    bundle_launches = counters["tile_norms"].launches
    model = SparseModel(cfg, bundle)
    engine = ServeEngine(model, serve_cfg)
    t0 = time.perf_counter()
    tokens_cb = engine.generate(prompts)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens_wave = engine.generate_prefilled(prompts)
    t_wave = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}

    live = np.stack([p["head_mask"] for p in model.layers])
    steps = -(-SERVE_REQUESTS // SERVE_BATCH) * (SERVE_PROMPT + SERVE_NEW - 1)
    log(f"  bundle (tile norms + keeps at rho={SERVE_RHO}) "
        f"{t_bundle * 1e3:.2f} ms on the host clock, {bundle_launches} tile_norms launch(es); achieved "
        f"rho {achieved_rho(bundle):.4f}; live KV heads "
        f"{int(live.sum())}/{live.size} [{card}]")
    if bundle_launches != 1:
        raise AssertionError(f"the bundle's ranking took {bundle_launches} "
                             f"tile_norms launches, not 1")
    log(f"  generate: {SERVE_REQUESTS} requests x ({SERVE_PROMPT} prompt + "
        f"{SERVE_NEW} new), {SERVE_BATCH} slots: {t_gen:.2f} s, {steps} "
        f"steps, {t_gen / steps * 1e3:.2f} ms per step, "
        f"{SERVE_REQUESTS * SERVE_NEW / t_gen:.1f} tokens/s "
        f"({SERVE_BATCH * steps / t_gen:.1f} slot-steps/s) [{card}]")
    waves = -(-SERVE_REQUESTS // SERVE_BATCH)
    batch = torch.as_tensor(prompts[:SERVE_BATCH], dtype=torch.long,
                            device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(model.arrays, batch, SERVE_PAGE)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    log(f"  generate_prefilled: {waves} waves in {t_wave:.2f} s; one "
        f"prefill wave ({SERVE_BATCH} x {SERVE_PROMPT}) {t_pre * 1e3:.2f} ms;"
        f" {SERVE_REQUESTS * SERVE_NEW / t_wave:.1f} tokens/s [{card}]")
    log("  serve kernels " + json.dumps(counts))
    for name, n in counts.items():
        if name != "block_sparse_matmul_t" and n <= 0:
            raise AssertionError(f"{name} never launched on the serve path")

    caches = model.init_caches(SERVE_BATCH, SERVE_PAGE)
    tok = batch[:, :1]
    pos = torch.full((SERVE_BATCH,), SERVE_PROMPT, device="cuda")
    model.decode_step(model.arrays, tok, caches, pos)
    profile_device(lambda: model.decode_step(model.arrays, tok, caches, pos),
                   "decode step (B=32)", card)

    # equality checks
    small = ServeEngine(model, ServeConfig(max_slots=8, page_len=SERVE_PAGE,
                                           max_new=SERVE_NEW))
    if not np.array_equal(small.generate(prompts[:16]), tokens_cb[:16]):
        raise AssertionError("tokens differ between 32 and 8 slots")
    log("  slots: 32-slot and 8-slot tokens bitwise equal on 16 requests")
    if not np.array_equal(np.asarray(host_loop(model, prompts[:2], "cuda")),
                          tokens_cb[:2]):
        raise AssertionError("generate differs from the host decode loop")
    log("  host loop: generate equals per-request decode_step on 2 requests")
    ref_tokens, ref_logits = engine.generate(prompts, return_logits=True)
    if not np.array_equal(ref_tokens, tokens_cb):
        raise AssertionError("generate is not repeatable")
    if not np.isfinite(ref_logits).all():
        raise AssertionError("non-finite logits")
    ties = wave_ties(tokens_cb, tokens_wave, ref_logits)
    log(f"  wave mode: generate_prefilled equals generate on "
        f"{SERVE_REQUESTS - ties}/{SERVE_REQUESTS} requests, {ties} "
        f"departures on near-ties (top-2 gap < 1e-4 of the logit scale)")
    del model, engine, small, bundle, params, ref_logits
    torch.cuda.empty_cache()
    card_vs_cpu_serve(cfg, card)
    return counts


# ---------------------------------------------------------------------------
# Phase 16: the dense decode, the llama configs served, MoE
# ---------------------------------------------------------------------------

DEC_SEED = 2216
DEC_BATCH, DEC_CACHE, DEC_PROMPT, DEC_NEW = 8, 128, 32, 32
WIN, WIN_STEPS, WIN_BATCH = 64, 96, 2
# 16c: the 4-slot run takes the first SERVED_FEW_REQUESTS requests (depth
# cut to keep the smoke's time)
SERVED_REQUESTS, SERVED_SLOTS, SERVED_FEW, SERVED_FEW_REQUESTS = 16, 16, 4, 8
SERVED_PROMPT, SERVED_NEW = 32, 32
MOE_PROMPT, MOE_NEW = 8, 32
FORWARD_TOL = 2e-3          # tests/test_decode_equivalence.py's rtol = atol
CARD = "cuda"               # every device phase 16 names
SERVE_KERNELS = ("bsmm_kernel", "decode_kernel", "prefill_kernel",
                 "tile_norms_kernel")


def two_layers(cfg):
    """``cfg`` at full width cut to 2 layers, float32 parameters and
    compute."""
    from repro_torch.configs.base import StageSpec
    return cfg.replace(stages=(StageSpec(2, cfg.stages[0].blocks),),
                       param_dtype="float32", compute_dtype="float32")


def model_params(cfg, seed: int, device=None):
    """``cfg``'s params drawn on ``device`` (None: ``CARD``) from a seed
    (the init's scales), qkv biases N(0, 0.5^2) (the init leaves them
    0)."""
    import torch
    from repro_torch.models import model as M
    device = device or CARD
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, gen)
    if cfg.qkv_bias:
        for stage in params["stages"]:
            for block in stage.values():
                for name in ("wq", "wk", "wv"):
                    b = block["attn"][name]["b"]
                    b.copy_(0.5 * torch.randn(b.shape, generator=gen,
                                              device=device))
    return params


def on_device(tree, device: str):
    from repro_torch.core import pruning
    return pruning.tree_map(lambda a: a.to(device), tree)


def teacher_forced(cfg, params, toks, cache_len: int, window=None,
                   memory=None):
    """Logits (B, T, V) of feeding ``toks`` one at a time through
    ``decode_step`` (the cross caches filled from ``memory`` first, where
    given), on the tokens' device, brought to the CPU."""
    import torch
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, toks.shape[0], cache_len, window=window,
                         device=toks.device)
    if memory is not None:
        cache = M.fill_cross_caches(cfg, params, cache, memory)
    out = []
    for t in range(toks.shape[1]):
        logits, cache = M.decode_step(cfg, params, toks[:, t:t + 1], cache,
                                      window=window)
        out.append(logits.cpu())
    return torch.stack(out, 1)


def greedy(cfg, params, prompts, new: int, cache_len: int, memory=None):
    """Prompts (B, P) fed through ``decode_step`` (the cross caches filled
    from ``memory`` first, where given), then ``new`` greedy tokens;
    returns (tokens (B, new) on the CPU, each step's wall in ms, the last
    token and cache).  Fails on a non-finite logit."""
    import torch
    from repro_torch.models import model as M
    b, p = prompts.shape
    cache = M.init_cache(cfg, b, cache_len, device=prompts.device)
    if memory is not None:
        cache = M.fill_cross_caches(cfg, params, cache, memory)
    tok, out, walls = prompts[:, :1], [], []
    finite = torch.ones((), dtype=torch.bool, device=prompts.device)
    for t in range(p + new - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = M.decode_step(cfg, params, tok, cache)
        tok = prompts[:, t + 1:t + 2] if t + 1 < p \
            else torch.argmax(logits, -1, keepdim=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        finite = finite & torch.isfinite(logits).all()
        if t + 1 >= p:
            out.append(tok)
    if not bool(finite):
        raise AssertionError(f"{cfg.name}: non-finite decode logits")
    return torch.cat(out, 1).cpu(), walls, tok, cache


def close_gate(a, b, what: str, card: str) -> None:
    """``a`` within ``FORWARD_TOL`` of ``b`` elementwise (rtol = atol)."""
    import torch
    diff = float((a - b).abs().max())
    log(f"  {what}: max_abs_err={diff:.3e} (rtol = atol = {FORWARD_TOL}) "
        f"[{card}]")
    if not torch.allclose(a, b, rtol=FORWARD_TOL, atol=FORWARD_TOL):
        raise AssertionError(f"{what}: beyond {FORWARD_TOL}")


def rel_gate(a, b, what: str, card: str) -> None:
    """max |a - b| over max |b| within ``TOL``."""
    diff, rel = rel_err(a, b)
    log(f"  {what}: max_abs_err={diff:.3e} rel={rel:.3e} (tol {TOL}) "
        f"[{card}]")
    if rel > TOL:
        raise AssertionError(f"{what}: rel err {rel:.3e} > {TOL}")


def tree_bytes(tree) -> int:
    from repro_torch.core import pruning
    return sum(a.numel() * a.element_size() for a in pruning.flatten(tree))


def timed_greedy(cfg, params, what: str, card: str, memory=None) -> None:
    """``DEC_BATCH`` prompts through ``greedy`` twice (tokens bitwise
    equal), the step walls' median, tokens/s, peak memory and a profiled
    step; a memory model's cross caches filled from ``memory`` (its
    ``fill_cross_caches`` timed)."""
    import numpy as np
    import torch
    prompt_len = DEC_PROMPT if cfg.moe is None else MOE_PROMPT
    new = DEC_NEW if cfg.moe is None else MOE_NEW
    prompts = torch.as_tensor(np.random.RandomState(DEC_SEED).randint(
        0, cfg.vocab_size, (DEC_BATCH, prompt_len)), device=CARD)
    torch.cuda.reset_peak_memory_stats()
    tokens, walls, tok, cache = greedy(cfg, params, prompts, new, DEC_CACHE,
                                       memory)
    again, walls2, *_ = greedy(cfg, params, prompts, new, DEC_CACHE, memory)
    med = float(np.median(walls[1:] + walls2))
    peak = torch.cuda.max_memory_allocated() / 2**30
    # a step reads every decoder weight and the cache once and writes the
    # cache but the cross caches (fill_cross_caches writes those); of an
    # untied embedding it gathers B rows; the memory projection and the
    # encoder run only in fill_cross_caches
    cross = sum(tree_bytes(sc[f"b{i}"])
                for stage, sc in zip(cfg.stages, cache["stages"])
                for i, spec in enumerate(stage.blocks)
                if spec.kind == "cross_attn")
    nbytes = tree_bytes(params) + 2 * tree_bytes(cache["stages"]) - cross
    for key in ("embed",) * (not cfg.tie_embeddings) + ("memory_proj",
                                                         "encoder"):
        nbytes -= tree_bytes(params.get(key))
    log(f"  {what}: B={DEC_BATCH}, {prompt_len} prompt + {new} greedy "
        f"tokens, cache {DEC_CACHE}: {med:.2f} ms a step (median of "
        f"{len(walls) - 1 + len(walls2)}; first {walls[0]:.1f} ms), "
        f"{DEC_BATCH * 1e3 / med:.1f} tokens/s, peak device memory "
        f"{peak:.2f} GiB; byte bound {nbytes / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms a step ({nbytes / 1e9:.2f} GB) [{card}]")
    if not torch.equal(tokens, again):
        raise AssertionError(f"{what}: rerun tokens differ")
    log(f"  {what}: rerun tokens bitwise equal ({tuple(tokens.shape)})")
    from repro_torch.models import model as M
    if memory is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.fill_cross_caches(cfg, params, cache, memory)
        torch.cuda.synchronize()
        log(f"  {what}: fill_cross_caches from {tuple(memory.shape)} stub "
            f"embeddings {(time.perf_counter() - t0) * 1e3:.2f} ms (warm) "
            f"[{card}]")
    profile_device(lambda: M.decode_step(cfg, params, tok, cache),
                   f"{what} step", card)


def run_dense_decode(card: str) -> None:
    """16a: qwen2-7b's dense decode in bfloat16 at full width, then a
    2-layer float32 copy teacher-forced against forward and the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("qwen2-7b")
    t0 = time.perf_counter()
    params = model_params(cfg, DEC_SEED)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim_}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {M.param_count(params)} "
        f"params {cfg.param_dtype}, drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    timed_greedy(cfg, params, "qwen2-7b dense decode", card)
    del params
    torch.cuda.empty_cache()

    cfg2 = two_layers(cfg)
    params = model_params(cfg2, DEC_SEED + 1, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(DEC_SEED))
    card_params = on_device(params, CARD)
    dec = teacher_forced(cfg2, card_params, toks.to(CARD), 8)
    full, _ = M.forward(cfg2, card_params, toks.to(CARD))
    close_gate(dec, full.cpu(), "qwen2-7b 2-layer float32 decode vs forward "
               "(2 x 8, card)", card)
    del card_params, full
    torch.cuda.empty_cache()
    rel_gate(dec, teacher_forced(cfg2, params, toks, 8),
             "qwen2-7b 2-layer float32 decode card vs CPU", card)


def run_windowed_decode(card: str) -> None:
    """16b: granite-3-2b in float32 with a rolling window of 64 over 96
    teacher-forced steps, and a 2-layer copy card against CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("granite-3-2b").replace(param_dtype="float32",
                                             compute_dtype="float32")
    params = model_params(cfg, DEC_SEED + 2)
    toks = torch.randint(0, cfg.vocab_size, (WIN_BATCH, WIN_STEPS),
                         generator=torch.Generator().manual_seed(DEC_SEED))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = teacher_forced(cfg, params, toks.to(CARD), WIN_STEPS, window=WIN)
    wall = time.perf_counter() - t0
    full, _ = M.forward(cfg, params, toks.to(CARD))
    full = full.cpu()
    log(f"  granite-3-2b float32, window {WIN}: {WIN_STEPS} steps at "
        f"B={WIN_BATCH} in {wall:.2f} s ({wall * 1e3 / WIN_STEPS:.2f} ms a "
        f"step) [{card}]")
    close_gate(dec[:, :WIN - 1], full[:, :WIN - 1],
               f"windowed decode vs forward, positions < {WIN - 1}", card)
    last = float((dec[:, -1] - full[:, -1]).abs().max())
    log(f"  last position: windowed vs forward max diff {last:.3e}")
    if torch.allclose(dec[:, -1], full[:, -1], rtol=FORWARD_TOL,
                      atol=FORWARD_TOL):
        raise AssertionError("the window did not bind at the last position")
    del params, dec, full
    torch.cuda.empty_cache()

    cfg2 = two_layers(cfg)
    params = model_params(cfg2, DEC_SEED + 3, "cpu")
    steps = WIN + 8
    rel_gate(teacher_forced(cfg2, on_device(params, CARD),
                            toks[:, :steps].to(CARD), steps, window=WIN),
             teacher_forced(cfg2, params, toks[:, :steps], steps, window=WIN),
             f"granite-3-2b 2-layer window {WIN} decode ({steps} steps) card "
             f"vs CPU", card)


def step_linears(model) -> list:
    """A decode step's linears as (plan, arrays) pairs, the unembedding
    last."""
    pairs = [(plan[k], la[k]) for plan, la in zip(model.layers,
                                                  model.arrays["layers"])
             for k, v in plan.items() if isinstance(v, dict)]
    return pairs + [(model.unembed, model.arrays["unembed"])]


def step_linears_ms(model, m: int, what: str, card: str) -> None:
    """A decode step's linears at M = ``m`` (random x): the block-sparse
    kernel's device ms, ``torch.matmul``'s on the pre-masked float32
    weights (the library call), and their byte bound (kept float32
    weight read once)."""
    import torch
    from repro_torch.kernels import ops
    pairs = step_linears(model)
    g = torch.Generator(device=CARD).manual_seed(DEC_SEED)
    xs = [torch.randn(m, p["k"], generator=g, device=CARD) for p, _ in pairs]

    def kernel():
        for (p, a), x in zip(pairs, xs):
            ops.masked_matmul(x, a["w"], a["keep"], block_k=p["bk"],
                              block_n=p["bn"])

    def library():
        for (p, a), x in zip(pairs, xs):
            torch.matmul(x, a["w"])

    nbytes = 4 * sum(kept_elements(a["keep"], p["k"], p["n"], p["bk"],
                                   p["bn"]) for p, a in pairs)
    log(f"  {what}: a step's {len(pairs)} linears at M = {m}: kernel "
        f"{device_ms(kernel, 3, ('bsmm_kernel',)):.3f} ms, torch.matmul "
        f"{device_ms(library, 3):.3f} ms, byte bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms ({nbytes / 1e9:.3f} GB of "
        f"kept float32 weight) [{card}]")


def kernel_device_ms(fn, what: str, card: str) -> None:
    """``fn`` once under torch.profiler: the device ms of each serving
    kernel, and of the whole call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in ANNOTATIONS]
    total = sum(e.self_device_time_total for e in events)
    if total <= 0:
        log(f"  {what}: device time not measured (no CUDA events)")
        return
    parts = []
    for k in SERVE_KERNELS:
        hits = [e for e in events if k in e.key]
        if hits:
            parts.append(f"{k} {sum(e.self_device_time_total for e in hits) / 1e3:.3f} ms "
                         f"x{sum(e.count for e in hits)}")
    log(f"  {what}: device {total / 1e3:.3f} ms over "
        f"{sum(e.count for e in events)} ops; " + "; ".join(parts)
        + f" [{card}]")


def dense_masked(cfg, card: str) -> None:
    """A 2-layer float32 copy at full width: SparseModel (kernels) against
    the port's own decode_step on the bundle's masked params, at the
    engine's shape: 16 slots over a cache of 32 + 32, every step of a
    request (positions 0-62)."""
    import torch
    from repro_torch.fleet.task import TransformerTask
    from repro_torch.models import model as M
    from repro_torch.serve import SparseModel, make_bundle
    cfg2 = two_layers(cfg)
    bundle = make_bundle(TransformerTask(arch=cfg2),
                         model_params(cfg2, DEC_SEED + 5), SERVE_RHO)
    masked = bundle.masked_params()
    model = SparseModel(cfg2, bundle, device=CARD)
    b, page = SERVED_SLOTS, SERVED_PROMPT + SERVED_NEW
    steps = page - 1
    toks = torch.randint(0, cfg.vocab_size, (b, steps), device=CARD,
                         generator=torch.Generator(device=CARD)
                         .manual_seed(DEC_SEED))
    cache = M.init_cache(cfg2, b, page, device=CARD)
    caches = model.init_caches(b, page)
    dense, sparse = [], []
    for i in range(steps):
        ld, cache = M.decode_step(cfg2, masked, toks[:, i:i + 1], cache)
        ls, caches = model.decode_step(model.arrays, toks[:, i:i + 1], caches,
                                       torch.full((b,), i, device=CARD))
        dense.append(ld.cpu())
        sparse.append(ls.cpu())
    rel_gate(torch.stack(sparse, 1), torch.stack(dense, 1),
             f"{cfg.name} 2-layer SparseModel vs dense decode on masked "
             f"params (B={b}, cache {page}, {steps} steps)", card)


def serve_one(name: str, card: str) -> dict:
    """16c for one config: seeded bfloat16 weights -> make_bundle at rho
    0.5 -> SparseModel(impl="kernel") -> ServeEngine, 16 requests on 16
    slots and on 4 (tokens equal) and in wave mode; launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fleet.task import TransformerTask
    from repro_torch.serve import (ServeConfig, ServeEngine, SparseModel,
                                   make_bundle)
    cfg = get_config(name)
    counters = serve_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    params = model_params(cfg, DEC_SEED + 4)
    t0 = time.perf_counter()
    bundle = make_bundle(TransformerTask(arch=cfg), params, SERVE_RHO)
    torch.cuda.synchronize()
    t_bundle = time.perf_counter() - t0
    if counters["tile_norms"].launches != 1:
        raise AssertionError(f"{name}: the bundle's ranking took "
                             f"{counters['tile_norms'].launches} launches")
    t0 = time.perf_counter()
    model = SparseModel(cfg, bundle, device=CARD)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    rho = achieved_rho(bundle)
    del bundle, params          # the float32 model holds what it serves
    torch.cuda.empty_cache()
    prompts = np.random.RandomState(DEC_SEED).randint(
        0, cfg.vocab_size, (SERVED_REQUESTS, SERVED_PROMPT)).astype(np.int32)
    page = SERVED_PROMPT + SERVED_NEW

    def engine(slots):
        return ServeEngine(model, ServeConfig(max_slots=slots, page_len=page,
                                              max_new=SERVED_NEW))

    t0 = time.perf_counter()
    tokens = engine(SERVED_SLOTS).generate(prompts)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    few = engine(SERVED_FEW).generate(prompts[:SERVED_FEW_REQUESTS])
    t_few = time.perf_counter() - t0
    wave = engine(SERVED_SLOTS).generate_prefilled(prompts)
    counts = {k: fn.launches for k, fn in counters.items()}
    steps = SERVED_PROMPT + SERVED_NEW - 1
    log(f"  {name}: bundle {t_bundle:.2f} s (1 tile_norms launch, achieved "
        f"rho {rho:.4f}), SparseModel {t_model:.2f} s; generate "
        f"{SERVED_REQUESTS} x ({SERVED_PROMPT} + {SERVED_NEW}) on "
        f"{SERVED_SLOTS} slots {t_gen:.2f} s ({t_gen * 1e3 / steps:.2f} ms a "
        f"step, {SERVED_REQUESTS * SERVED_NEW / t_gen:.1f} tokens/s), "
        f"{SERVED_FEW_REQUESTS} of them on {SERVED_FEW} slots {t_few:.2f} "
        f"s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if not np.array_equal(tokens[:SERVED_FEW_REQUESTS], few):
        raise AssertionError(f"{name}: tokens differ between "
                             f"{SERVED_SLOTS} and {SERVED_FEW} slots")
    log(f"  {name}: {SERVED_SLOTS}- and {SERVED_FEW}-slot tokens bitwise "
        f"equal ({SERVED_FEW_REQUESTS} requests); wave mode equal on "
        f"{int((wave == tokens).all(1).sum())}/{SERVED_REQUESTS} requests; "
        f"launches {json.dumps(counts)}")
    for k in ("block_sparse_matmul", "flash_prefill", "decode_attention"):
        if counts[k] <= 0:
            raise AssertionError(f"{name}: {k} never launched")
    caches = model.init_caches(SERVED_SLOTS, page)
    tok = torch.as_tensor(prompts[:, :1], dtype=torch.long, device=CARD)
    pos = torch.full((SERVED_SLOTS,), SERVED_PROMPT, device=CARD)
    kernel_device_ms(lambda: model.decode_step(model.arrays, tok, caches, pos),
                     f"{name} profiled decode step (B={SERVED_SLOTS})", card)
    step_linears_ms(model, SERVED_SLOTS, name, card)
    del model
    torch.cuda.empty_cache()
    dense_masked(cfg, card)
    torch.cuda.empty_cache()
    return counts


def run_gather(card: str) -> dict:
    """16d: phase 6's smollm-135m bundle served by impl="gather" beside
    "kernel": logits of 8 decode steps within TOL, a gather rerun bitwise,
    ms a decode step of each.  Returns each impl's launches (the gather
    impl's over its run and rerun)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fleet.task import TransformerTask
    from repro_torch.serve import SparseModel, make_bundle
    cfg = get_config("smollm-135m")
    task = TransformerTask(arch=cfg)
    params = task.init_params(
        torch.Generator(device=CARD).manual_seed(SERVE_SEED))
    bundle = make_bundle(task, params, SERVE_RHO)
    toks = torch.as_tensor(np.random.RandomState(SERVE_SEED).randint(
        0, cfg.vocab_size, (SERVE_BATCH, 8)), device=CARD)
    counters = serve_counters()
    counts = {"kernel": {k: 0 for k in counters},
              "gather": {k: 0 for k in counters}}
    out, served = {}, {}
    for impl in ("kernel", "gather", "gather"):
        for fn in counters.values():
            fn.launches = 0
        model = SparseModel(cfg, bundle, impl=impl, device=CARD)
        caches = model.init_caches(SERVE_BATCH, SERVE_PAGE)
        steps = []
        for i in range(8):
            lg, caches = model.decode_step(
                model.arrays, toks[:, i:i + 1], caches,
                torch.full((SERVE_BATCH,), i, device=CARD))
            steps.append(lg)
        run = torch.stack(steps, 1)
        for k, fn in counters.items():
            counts[impl][k] += fn.launches
        if impl in out:
            if not torch.equal(run, out[impl]):
                raise AssertionError("gather rerun logits differ")
            log("  gather rerun: logits bitwise equal over 8 steps")
            continue
        out[impl], served[impl] = run, (model, caches)
    log(f"  launches by impl: {json.dumps(counts)}")
    pos = torch.full((SERVE_BATCH,), 8, device=CARD)
    step_ms = {impl: cuda_ms(lambda: m.decode_step(m.arrays, toks[:, :1], c,
                                                   pos), 10)
               for impl, (m, c) in served.items()}
    log(f"  smollm-135m decode step (B={SERVE_BATCH}, CUDA events, host "
        f"included): kernel {step_ms['kernel']:.3f} ms, gather "
        f"{step_ms['gather']:.3f} ms [{card}]")
    rel_gate(out["gather"].cpu(), out["kernel"].cpu(),
             "gather vs kernel logits (8 steps)", card)
    return counts


def moe_backward_bitwise(cfg, card: str) -> None:
    """One MoE FFN of ``cfg`` at full width (its bfloat16 experts and
    float32 router from a seed) on 8 x 128 tokens: the gradients of a
    loss of its output and aux loss with respect to the input and every
    weight, twice, bitwise equal.  The dispatch gathers each token's up
    to top_k expert slots from its one row, so the gather's backward
    sums them with an accumulating ``index_put``."""
    import torch
    from repro_torch.core import pruning
    from repro_torch.models import moe as MOE
    spec = cfg.moe_spec()
    gen = torch.Generator(device=CARD).manual_seed(DEC_SEED + 8)
    p = MOE.init_moe(gen, cfg.d_model, spec, torch.bfloat16)
    x = torch.randn((8, 128, cfg.d_model), generator=gen,
                    device=CARD).to(torch.bfloat16)
    leaves = [x] + pruning.flatten(p)
    grads = []
    for _ in range(2):
        ins = [a.detach().requires_grad_() for a in leaves]
        y, aux = MOE.moe_ffn(pruning.unflatten(p, ins[1:]), spec, ins[0])
        loss = torch.mean(y.to(torch.float32) ** 2) + aux
        grads.append(torch.autograd.grad(loss, ins))
    same = all(torch.equal(a, b) for a, b in zip(*grads))
    log(f"  {cfg.name} MoE FFN backward (8 x 128 tokens, {spec.num_experts} "
        f"experts top-{spec.top_k}), run twice: input and weight grads "
        f"bitwise {'equal' if same else 'DIFFERENT'} [{card}]")
    if not same:
        raise AssertionError("MoE backward rerun differs")


def run_moe(card: str) -> None:
    """16e: olmoe-1b-7b at full width: float32 (capacity factor 8, the
    reference test's pin) teacher-forced decode vs forward; one MoE FFN's
    backward rerun bitwise (``moe_backward_bitwise``); then its bfloat16
    config decoding greedily, timed, rerun bitwise."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    base = get_config("olmoe-1b-7b")
    cfg = base.replace(param_dtype="float32", compute_dtype="float32",
                       moe_capacity_factor=8.0)
    torch.cuda.reset_peak_memory_stats()
    params = model_params(cfg, DEC_SEED + 6)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=CARD,
                         generator=torch.Generator(device=CARD)
                         .manual_seed(DEC_SEED))
    log(f"  {cfg.name}: {M.param_count(params)} params float32, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    dec = teacher_forced(cfg, params, toks, 16)
    full, aux = M.forward(cfg, params, toks)
    close_gate(dec, full.cpu(), "olmoe-1b-7b float32 decode vs forward "
               "(2 x 16)", card)
    if not torch.isfinite(aux):
        raise AssertionError("non-finite MoE auxiliary loss")
    del params, full, dec
    torch.cuda.empty_cache()
    moe_backward_bitwise(base, card)
    torch.cuda.empty_cache()
    params = model_params(base, DEC_SEED + 7)
    timed_greedy(base, params, "olmoe-1b-7b bfloat16 decode", card)
    del params
    torch.cuda.empty_cache()


def run_phase16(card: str) -> dict:
    """Phase 16; returns the serving kernels' launches of 16c (both
    configs) and of 16d."""
    import torch
    phase("  [16a] qwen2-7b dense decode")
    run_dense_decode(card)
    phase("  [16b] granite-3-2b rolling window")
    run_windowed_decode(card)
    served = {}
    for name in SERVED_CONFIGS:
        phase(f"  [16c] {name} served")
        for k, n in serve_one(name, card).items():
            served[k] = served.get(k, 0) + n
    phase("  [16d] the gather impl")
    gather = run_gather(card)
    phase("  [16e] olmoe-1b-7b")
    run_moe(card)
    torch.cuda.empty_cache()
    return {"served": served, "gather": gather}


# ---------------------------------------------------------------------------
# Phase 17: the recurrent, MLA and memory models at full width
# ---------------------------------------------------------------------------

P17 = ("xlstm-125m", "recurrentgemma-2b", "minicpm3-4b",
       "llama-3.2-vision-11b", "whisper-base")
GATE_BATCH, GATE_STEPS = 2, 12
XLSTM_CELLS, XLSTM_PER_CELL, XLSTM_ROUNDS = 2, 4, 2


def stub_memory(cfg, batch: int, seed: int, device):
    """Seeded stub frontend embeddings (batch, num_memory_tokens,
    memory_dim) in float32, or None for a model without memory."""
    import torch
    if not cfg.num_memory_tokens:
        return None
    return torch.randn((batch, cfg.num_memory_tokens, cfg.memory_dim_),
                       generator=torch.Generator(device=device)
                       .manual_seed(seed), device=device)


def one_repeat(cfg):
    """``cfg`` at full width cut to one repeat of each stage (the encoder
    kept), float32 parameters and compute."""
    import dataclasses
    return cfg.replace(stages=tuple(dataclasses.replace(s, repeats=1)
                                    for s in cfg.stages),
                       param_dtype="float32", compute_dtype="float32")


def p17_gates(cfg, seed: int, card: str) -> None:
    """The depth cut's gates: teacher-forced decode (cross caches filled
    from stub memory) against ``forward`` on the card within 2e-3, and
    the decode's logits on the card against the CPU within ``TOL``, from
    the same params (drawn on the CPU)."""
    import torch
    from repro_torch.models import model as M
    cut = one_repeat(cfg)
    params = model_params(cut, seed, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (GATE_BATCH, GATE_STEPS),
                         generator=torch.Generator().manual_seed(seed))
    mem = stub_memory(cut, GATE_BATCH, seed, "cpu")
    card_params = on_device(params, CARD)
    card_mem = None if mem is None else mem.to(CARD)
    dec = teacher_forced(cut, card_params, toks.to(CARD), GATE_STEPS,
                         memory=card_mem)
    full, _ = M.forward(cut, card_params, toks.to(CARD), card_mem)
    what = (f"{cfg.name} {cut.num_layers}-layer float32 cut "
            f"({M.param_count(params)} params, "
            f"{tree_bytes(params) / 1e9:.2f} GB)")
    close_gate(dec, full.cpu(), f"{what} decode vs forward "
               f"({GATE_BATCH} x {GATE_STEPS}, card)", card)
    del card_params, card_mem, full
    torch.cuda.empty_cache()
    rel_gate(dec, teacher_forced(cut, params, toks, GATE_STEPS, memory=mem),
             f"{what} decode card vs CPU", card)


def run_xlstm_fleet(card: str, floor_ms: float) -> tuple[dict, dict]:
    """17a's fleet: xlstm-125m at full width in float32 trained by 2 x 4
    clients (TransformerTask(arch=...), kernel="fused": the generic
    path), 2 rounds: one grouped tile-norm launch a round over its 4-D
    recurrence matrices, 3-D conv weights and stacked vectors, no fused
    launch, finite losses, rerun bitwise.  Before the rounds the tile-norm
    kernel is held against its plain version on exactly those leaves and
    tiles (``norms_regime``).  Returns the rounds' launches and the
    regime's figures."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import pruning
    from repro_torch.fleet import (FleetConfig, FleetTopology, TransformerTask,
                                   build_simulation)
    arch = get_config("xlstm-125m").replace(param_dtype="float32",
                                            compute_dtype="float32")
    cfg = FleetConfig(task=TransformerTask(arch=arch, seq_len=16,
                                           local_batch=2, pool_clients=8),
                      topology=FleetTopology(XLSTM_CELLS, XLSTM_PER_CELL),
                      kernel="fused", rounds=XLSTM_ROUNDS)
    torch.cuda.reset_peak_memory_stats()
    sim = build_simulation(cfg)
    leaves = pruning.flatten(sim.params)
    log(f"  xlstm-125m fleet: {XLSTM_CELLS} x {XLSTM_PER_CELL} clients, "
        f"{sum(a.numel() for a in leaves)} params float32, prunable leaves "
        f"by rank {json.dumps({d: sum(a.ndim == d for a in leaves) for d in (2, 3, 4)})}")
    ranked, blocks = task_ranking(cfg.task, sim.params)
    regime = norms_regime("xlstm-125m float32 (17a's ranking)", ranked,
                          blocks, 20, 3, floor_ms, card)
    del ranked
    counters = scan_counts()
    for fn in counters.values():
        fn.launches = 0
    _, metrics, walls, steps, _ = drive(sim, "xlstm round", card)
    check_steps("xlstm round", steps, {"fleet_fused_grads": 0,
                                       "tile_norms": 1})
    counts = fleet_counts()
    scans = {k: fn.launches for k, fn in counters.items()}
    log(f"  xlstm-125m fleet: scan launches {json.dumps(scans)} over "
        f"{XLSTM_ROUNDS} rounds (the clients' gradients under "
        f"torch.func.vmap) [{card}]")
    if min(scans.values()) == 0:
        raise AssertionError("xlstm-125m fleet: a scan kernel never ran")
    counts["scans"] = scans
    log(f"  xlstm-125m fleet: walls {fmt_walls(walls)}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")
    rerun_bitwise(cfg, "sync", metrics["loss"].cpu().tolist(),
                  "xlstm-125m fleet")
    del sim
    torch.cuda.empty_cache()
    return counts, regime


def scan_counts() -> dict:
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.kernels import slstm_scan as SS
    return {"mlstm_scan": MS.mlstm_scan, "mlstm_scan_bwd": MS.mlstm_scan_bwd,
            "slstm_scan": SS.slstm_scan, "slstm_scan_bwd": SS.slstm_scan_bwd}


def profile_scan_share(step, card: str) -> None:
    """One more warm host step under torch.profiler: the scan kernels'
    share of its device time, by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ANNOTATIONS]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log("  profiled xlstm host step: device time not measured (no CUDA "
            "events)")
        return
    by = {name: sum(e.self_device_time_total for e in kernels
                    if any(k in e.key for k in ks)) / 1e3
          for name, ks in SCAN_KERNELS.items()}
    scans = sum(by.values())
    log(f"  profiled xlstm host step: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall:.1f}%), the scan kernels "
        f"{scans:.1f} ms ({100 * scans / busy:.1f}% of the device time: "
        + ", ".join(f"{k} {v:.1f}" for k, v in by.items()) + f") [{card}]")


def run_xlstm_host(card: str) -> dict:
    """17a's host step: xlstm-125m at full width (bfloat16 params from a
    seed, its config's ``remat="block"``) through the launcher's host
    step (Adam at ``FULL_LR`` after clipping), ``XHOST_STEPS`` steps on
    one (4, 4096) batch of TokenStream tokens, launch counts zeroed just
    before: the loss finite and falling, each scan kernel launched ``XSCAN_PER_STEP``
    times a step, a rerun bitwise (losses and params); ms a warm step,
    peak memory, and a profiled step's share of the scan kernels.
    Returns the first run's launches by kernel."""
    import numpy as np
    import torch
    from repro_torch import optimizers
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import model as M
    cfg = get_config("xlstm-125m")
    if cfg.remat != "block":
        raise AssertionError(f"xlstm-125m's remat is {cfg.remat!r}")
    # one batch, every step: its loss must fall whatever the stream's
    # statistics (3 steps over fresh TokenStream batches need not)
    batches = host_batches(cfg.vocab_size, XHOST_B, XHOST_S, 1,
                           CARD) * XHOST_STEPS
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = model_params(cfg, P18_SEED + 3)
    counters = scan_counts()
    for fn in counters.values():
        fn.launches = 0
    params, losses, walls = host_run(cfg, start, batches)
    counts = {k: fn.launches for k, fn in counters.items()}
    peak = fmt_peak(base)
    log(f"  xlstm-125m: {M.param_count(start)} params {cfg.param_dtype}, "
        f"remat {cfg.remat!r}; host step at B = {XHOST_B}, S = {XHOST_S}: "
        f"losses {[round(x, 4) for x in losses]}, walls "
        f"{[round(w, 1) for w in walls]} ms, peak device memory {peak}; "
        f"scan launches {json.dumps(counts)} over {XHOST_STEPS} steps "
        f"[{card}]")
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"xlstm-125m host losses do not fall: {losses}")
    want = {k: n * XHOST_STEPS for k, n in XSCAN_PER_STEP.items()}
    if counts != want:
        raise AssertionError(f"xlstm-125m host step: scan launches {counts},"
                             f" not {want}")
    del start
    again, losses2, walls2 = host_run(cfg, model_params(cfg, P18_SEED + 3),
                                      batches)
    if losses2 != losses or not trees_equal(again, params):
        raise AssertionError("xlstm-125m host step: rerun differs")
    log(f"  xlstm-125m host step: rerun losses and params bitwise equal; "
        f"{float(np.median(walls[1:] + walls2[1:])):.1f} ms a warm step "
        f"(median of {2 * XHOST_STEPS - 2}; first {walls[0]:.1f} ms) "
        f"[{card}]")
    del again
    opt = optimizers.adam()
    state, step = opt.init(params), TRAIN.make_host_step(cfg, opt, FULL_LR)
    profile_scan_share(lambda: step(params, state, batches[0]), card)
    del params, state, batches
    torch.cuda.empty_cache()
    return counts


def run_p17_model(name: str, seed: int, card: str) -> None:
    """One phase-17 model at full width from seeded random weights in its
    own dtype: the dense decode timed (``timed_greedy``; a memory model's
    cross caches from seeded stub embeddings), freed, then the depth
    cut's gates."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(name)
    t0 = time.perf_counter()
    params = model_params(cfg, seed)
    torch.cuda.synchronize()
    log(f"  {name}: {cfg.num_layers} layers "
        f"{[(s.repeats, [b.kind for b in s.blocks]) for s in cfg.stages]}, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{M.param_count(params)} params {cfg.param_dtype} "
        f"({tree_bytes(params) / 1e9:.3f} GB), drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    memory = stub_memory(cfg, DEC_BATCH, seed, CARD)
    timed_greedy(cfg, params, f"{name} dense decode", card, memory)
    del params, memory
    torch.cuda.empty_cache()
    p17_gates(cfg, seed + 1, card)
    torch.cuda.empty_cache()


def run_phase17(card: str, floor_ms: float) -> tuple:
    """Phase 17; returns 17a's fleet launches and its ranking's tile-norm
    figures, and 17a's host step's scan launches."""
    fleet = scans = None
    for i, name in enumerate(P17):
        phase(f"  [17{'abcde'[i]}] {name}")
        run_p17_model(name, DEC_SEED + 20 + 2 * i, card)
        if name == "xlstm-125m":
            fleet = run_xlstm_fleet(card, floor_ms)
            scans = run_xlstm_host(card)
    return fleet, scans


# ---------------------------------------------------------------------------
# Phase 18: the training launcher and the mesh trainer
# ---------------------------------------------------------------------------

HOST_BATCH, HOST_SEQ, HOST_STEPS, HOST_LR = 8, 128, 10, 1e-2
# the launcher's lr suits its smoke width; Adam at full width takes 1e-3
FULL_LR = 1e-3
CPU_BATCH, CPU_SEQ, CPU_STEPS = 2, 64, 3
FL_BLOCK, FL_RHO, FL_K, FL_STEPS = 16, 0.3, 40.0, 3
TWO_RHO, TWO_K, TWO_ARRIVALS = [0.3, 0.5], [40.0, 30.0], ([1.0, 0.0],
                                                          [1.0, 1.0])
TWO_BATCH, TWO_SEQ, TWO_TIMEOUT = 2, 32, 240
P18_SEED = DEC_SEED + 40

# 18d: one rank of the two-rank FL step on the card over gloo (NCCL takes
# one rank a device); writes each case's params and metrics
TWO_RANK_CHILD = r"""
import json, sys
import torch
import torch.distributed as dist
rank, world, store, out, spec = sys.argv[1:6]
rank, world, spec = int(rank), int(world), json.loads(spec)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.core import pruning
from repro_torch.data.tokens import TokenStream
from repro_torch.federated import trainer as FT
from repro_torch.kernels import block_norms as BN
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as M
cfg = get_config("smollm-135m").smoke_variant()
dev = spec["device"]
params = pruning.tree_map(lambda a: a.to(dev), M.init_params(
    cfg, torch.Generator().manual_seed(spec["seed"])))
tokens = torch.as_tensor(TokenStream(cfg.vocab_size, seed=spec["seed"])
                         .sample(world * spec["batch"], spec["seq"]),
                         dtype=torch.int64, device=dev)
mesh = MESH.make_host_mesh(model=1, device=dev)
step = FT.make_fl_train_step(cfg, mesh, ("data",), block=spec["block"],
                             lr=spec["lr"])
vec = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
metrics = []
for c, arrivals in enumerate(spec["arrivals"]):
    new, m = step(params, {"tokens": tokens}, vec(spec["rho"]),
                  vec(arrivals), vec(spec["k"]))
    checkpoint.save(f"{out}/rank{rank}_case{c}.npz", new)
    metrics.append({"loss": float(m["loss"]),
                    "achieved_rho": m["achieved_rho"].tolist()})
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump({"client": FT.client_index(mesh, ("data",)),
               "clients": FT.num_clients(mesh, ("data",)),
               "tile_norms": BN.tile_norms.launches, "metrics": metrics}, f)
dist.barrier()
dist.destroy_process_group()
"""


def tree_rel(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|) over every leaf of two trees."""
    from repro_torch.core import pruning
    worst = worst_rel = 0.0
    for x, y in zip(pruning.flatten(a), pruning.flatten(b)):
        diff, rel = rel_err(x.double().cpu(), y.double().cpu())
        worst, worst_rel = max(worst, diff), max(worst_rel, rel)
    return worst, worst_rel


def trees_equal(a, b) -> bool:
    import torch
    from repro_torch.core import pruning
    return all(torch.equal(x, y) for x, y in zip(pruning.flatten(a),
                                                 pruning.flatten(b)))


def run_train_main(argv: list) -> list:
    """``launch.train.main(argv)`` in this process, its printed lines
    echoed and returned; fails on a non-zero return."""
    import io
    from repro_torch.launch import train as TRAIN
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = TRAIN.main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"    | {line}")
    if rc != 0:
        raise AssertionError(f"train.main({argv}) returned {rc}")
    return lines


def logged(lines: list, key: str) -> list:
    """The ``key=value`` floats of the launcher's step lines."""
    return [float(part.split("=")[1]) for line in lines
            if line.startswith("step ") for part in line.split()
            if part.startswith(f"{key}=")]


def smoke_ranking(params, what: str, rhos, floor_ms: float,
                  card: str) -> float:
    """The FL step's ranking at smollm-135m's smoke width (float32 stacked
    leaves, the q/k/v leaves 126 wide: ragged at block 16), on the
    seeded ``params`` a run ranks: the tile norms held against the plain
    version (``norms_regime``) and the tile keeps at each rate against
    those of the plain norms (only near ties may differ).  Returns the
    norms' largest error."""
    from repro_torch.configs import get_config
    from repro_torch.fleet.task import TransformerTask
    cfg = get_config("smollm-135m").smoke_variant()
    regime = norms_regime(
        f"smollm-135m smoke width block {FL_BLOCK} ({what})",
        *task_ranking(TransformerTask(arch=cfg, block=FL_BLOCK), params),
        20, 3, floor_ms, card)
    for rho in rhos:
        tiles, differ = keep_ties(params, rho, FL_BLOCK)
        log(f"  tile keeps at rho {rho} ({what}), kernel vs plain norms: "
            f"{differ} of {tiles} tiles differ (only near ties may)")
    return regime["max_abs_err"]


def run_cli(card: str, floor_ms: float) -> tuple[int, float]:
    """18a: ``python -m repro_torch.launch.train`` in process on the card:
    20 Adam steps (the last logged loss below the first), 10 ``--fl``
    steps over a world of one (one tile-norm launch a step; the ranking
    of the launcher's seeded params held against the plain version), and
    5 steps with ``--ckpt``: the checkpoint restores bitwise to the
    params that 5 host steps from the launcher's seed and stream give.
    Returns the ``--fl`` run's tile-norm launches and the ranking's
    largest error."""
    import math
    import tempfile
    import numpy as np
    import torch
    from repro_torch import checkpoint, optimizers
    from repro_torch.configs import get_config
    from repro_torch.core import pruning
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import model as M
    base = ["--arch", "smollm-135m"]
    t0 = time.perf_counter()
    lines = run_train_main(base + ["--steps", "20"])
    wall = time.perf_counter() - t0
    losses = logged(lines, "loss")
    log(f"  plain (adam): losses {losses}, {wall:.2f} s in all, "
        f"{20 / wall:.2f} steps/s [{card}]")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"launcher losses do not fall: {losses}")
    zero_fleet_counts()
    t0 = time.perf_counter()
    lines = run_train_main(base + ["--fl", "--steps", "10"])
    wall = time.perf_counter() - t0
    fl_launches = fleet_counts()["tile_norms"]
    rhos = logged(lines, "rho")
    log(f"  --fl: losses {logged(lines, 'loss')}, rho {rhos}, {wall:.2f} s "
        f"in all, {10 / wall:.2f} steps/s, tile-norm launches "
        f"{fl_launches} [{card}]")
    if fl_launches != 10 or any(abs(r - 0.3) > 0.15 for r in rhos) \
            or not all(map(math.isfinite, logged(lines, "loss"))):
        raise AssertionError(f"--fl run: {fl_launches} launches, rho {rhos}")
    cfg = get_config("smollm-135m").smoke_variant()

    def seeded():
        return pruning.tree_map(lambda a: a.to(CARD), M.init_params(
            cfg, torch.Generator().manual_seed(0)))

    err = smoke_ranking(seeded(), "18a's --fl", [FL_RHO], floor_ms, card)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ckpt.npz"
        run_train_main(base + ["--steps", "5", "--ckpt", path])
        params = seeded()
        opt = optimizers.adam()
        state, step = opt.init(params), TRAIN.make_host_step(cfg, opt,
                                                             HOST_LR)
        stream = TokenStream(cfg.vocab_size, seed=0)
        for _ in range(5):
            params, state, _ = step(params, state, {"tokens": torch.as_tensor(
                stream.sample(HOST_BATCH, HOST_SEQ).astype(np.int64),
                device=CARD)})
        restored = checkpoint.restore(path, params, device=CARD)
    if not trees_equal(restored, params):
        raise AssertionError("--ckpt: the restored params differ from a "
                             "replay of the run")
    log(f"  --ckpt: restored bitwise equal to a replay of the 5 steps "
        f"({M.param_count(params)} params)")
    return fl_launches, err


def host_batches(vocab: int, batch: int, seq: int, steps: int, device):
    """``steps`` token batches of one TokenStream, int64 on ``device``."""
    import numpy as np
    import torch
    from repro_torch.data.tokens import TokenStream
    stream = TokenStream(vocab, seed=P18_SEED)
    return [{"tokens": torch.as_tensor(stream.sample(batch, seq)
                                       .astype(np.int64), device=device)}
            for _ in range(steps)]


def host_run(cfg, params, batches) -> tuple:
    """The launcher's host step (Adam after clipping, ``FULL_LR``) over
    ``batches``: (params, each step's loss, each step's wall in ms)."""
    import torch
    from repro_torch import optimizers
    from repro_torch.launch import train as TRAIN
    opt = optimizers.adam()
    state, step = opt.init(params), TRAIN.make_host_step(cfg, opt, FULL_LR)
    losses, walls = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    return params, losses, walls


def adam_step_agreement(t: int, lr: float, got: tuple,
                        want: tuple) -> tuple[int, int, float, float]:
    """One Adam step (b1 0.9, b2 0.999, eps 1e-8) from a shared state, the
    card's (``got``: params, m, v trees) against the CPU's (``want``),
    leaf by leaf in float64 on the CPU.  ``m`` and ``v`` within TOL of
    each row's largest (a row: the last axis), so a gradient error in a
    row of small values (an embedding row of a token not drawn) shows.
    Adam divides each element by its own sqrt(v_hat) + eps, so a row's
    measured gap g_r (its largest |m_hat| or sqrt(v_hat) difference)
    moves an element's step by at most lr (1 + max|u|) g_r / sqrt(v_hat)
    to first order; the params are held within TOL of the leaf's largest
    wherever twice that bound is within it.  Every element within 2 lr
    of the CPU's.  Returns (elements held, all elements, the worst m/v
    rel to its row, the worst held param rel)."""
    import torch
    from repro_torch.core import pruning
    bc1, bc2 = 1 - 0.9 ** t, 1 - 0.999 ** t
    held = total = 0
    worst_mv = worst = 0.0
    for leaf in zip(*(pruning.flatten(x) for x in got + want)):
        gp, gm, gv, wp, wm, wv = (x.detach().cpu().double().reshape(
            -1, x.shape[-1]) for x in leaf)
        for a, b in ((gm, wm), (gv, wv)):
            scale = b.abs().amax(dim=1, keepdim=True)
            diff = (a - b).abs()
            if bool((diff > TOL * scale).any()):
                raise AssertionError("host step card vs CPU: m or v differs "
                                     "beyond TOL of its row's largest")
            worst_mv = max(worst_mv, float((diff / scale.clamp_min(
                1e-300)).max()))
        root = torch.sqrt(wv / bc2)
        gap = torch.maximum((gm - wm).abs() / bc1,
                            (torch.sqrt(gv / bc2) - root).abs()).amax(
                                dim=1, keepdim=True)
        u = (wm / bc1).abs() / (root + 1e-8)
        top = float(wp.abs().max())
        cond = root >= 2 * (1 + float(u.max())) * lr * gap / (TOL * top)
        diff = (gp - wp).abs()
        if bool(cond.any()):
            worst = max(worst, float(diff[cond].max()) / top)
        if float(diff.max()) > 2 * lr:
            raise AssertionError("host step card vs CPU: an element moved "
                                 "more than 2 lr apart")
        held += int(cond.sum())
        total += cond.numel()
    if worst > TOL:
        raise AssertionError(f"host step card vs CPU: params rel {worst:.3e}"
                             f" where held > {TOL}")
    return held, total, worst_mv, worst


def host_card_vs_cpu(cfg, card: str) -> None:
    """18b's depth cut: ``cfg`` at 2 float32 layers, params drawn on the
    CPU; 3 host steps, each on the card and on the CPU from the CPU's
    params and Adam state, held by ``adam_step_agreement``, at least 90%
    of the element-steps held."""
    from repro_torch import optimizers
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import model as M
    cut = two_layers(cfg)
    params = model_params(cut, P18_SEED, "cpu")
    opt = optimizers.adam()
    state = opt.init(params)
    step = TRAIN.make_host_step(cut, opt, FULL_LR)
    held = total = 0
    worst_mv = worst = 0.0
    for t, batch in enumerate(host_batches(cut.vocab_size, CPU_BATCH,
                                           CPU_SEQ, CPU_STEPS, "cpu"), 1):
        card_p, card_s, _ = step(on_device(params, CARD),
                                 on_device(state, CARD), on_device(batch,
                                                                   CARD))
        new, state, _ = step(params, state, batch)
        h, n, mv, w = adam_step_agreement(
            t, FULL_LR, (card_p, card_s["m"], card_s["v"]),
            (new, state["m"], state["v"]))
        params = new
        held, total = held + h, total + n
        worst_mv, worst = max(worst_mv, mv), max(worst, w)
    log(f"  {cut.num_layers}-layer float32 cut ({M.param_count(params)} "
        f"params), {CPU_STEPS} host steps of ({CPU_BATCH}, {CPU_SEQ}) card "
        f"vs CPU: m and v rel {worst_mv:.3e} of their rows' largest; params "
        f"rel {worst:.3e} where the rows' measured gap cannot move Adam's "
        f"step further ({100 * held / total:.2f}% of element-steps held) "
        f"(tol {TOL}) [{card}]")
    if held < 0.9 * total:
        raise AssertionError(f"host step card vs CPU: {held} of {total} "
                             f"element-steps held, under 90%")


def fmt_peak(base: int) -> str:
    """The device's peak allocated memory since the last reset: absolute
    (``max_memory_allocated``) and over ``base``, the bytes allocated
    before the run (what the run itself added: its params, optimizer
    state, gradients and activations)."""
    import torch
    top = torch.cuda.max_memory_allocated()
    return (f"{top / 2**30:.2f} GiB ({(top - base) / 2**30:.2f} GiB over "
            f"the {base / 2**30:.2f} GiB before the run)")


def remat_compare(cfg, batches, block_losses: list, block_ms: float,
                  block_peak: str, card: str) -> None:
    """18b's host step without rematerialization: ``cfg``'s run (the
    config's ``remat="block"``: each super-block's forward recomputed in
    the backward; its losses, warm ms and ``fmt_peak`` given) against
    ``remat="none"`` from the same params and batches.  Losses within
    1e-6 relative; each variant's warm ms and peak device memory
    printed."""
    import numpy as np
    import torch
    none = cfg.replace(remat="none")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, losses, walls = host_run(none, model_params(none, P18_SEED), batches)
    peak = fmt_peak(base)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, block_losses))
    log(f"  remat: \"block\" {block_ms:.2f} ms a warm step, peak "
        f"{block_peak}; \"none\" {float(np.median(walls[1:])):.2f} "
        f"ms, peak {peak}; losses rel {rel:.3e} (tol 1e-6) [{card}]")
    if rel > 1e-6:
        raise AssertionError(f"remat block vs none: losses rel {rel:.3e}")


def run_host_full(card: str) -> float:
    """18b: smollm-135m at full width (bfloat16 params, ``remat="block"``)
    through the launcher's host step: 10 steps of (8, 128) from seeded
    params, the loss falling and a rerun bitwise equal; the same steps at
    ``remat="none"`` (``remat_compare``); the warm step's median ms,
    peak memory and a profiled step's busy share; the prefill step's
    logits against ``forward``'s last position within 1e-5 and the serve
    step against ``decode_step`` bitwise; then the depth cut card vs
    CPU.  Returns the warm step's median ms."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TRAIN
    from repro_torch import optimizers
    from repro_torch.models import model as M
    cfg = get_config("smollm-135m")
    batches = host_batches(cfg.vocab_size, HOST_BATCH, HOST_SEQ, HOST_STEPS,
                           CARD)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = model_params(cfg, P18_SEED)
    log(f"  smollm-135m: {M.param_count(start)} params {cfg.param_dtype} "
        f"({tree_bytes(start) / 1e9:.3f} GB), Adam state float32")
    params, losses, walls = host_run(cfg, start, batches)
    peak = fmt_peak(base)
    again, losses2, walls2 = host_run(cfg, model_params(cfg, P18_SEED),
                                      batches)
    med = float(np.median(walls[1:] + walls2[1:]))
    log(f"  host step (adam, lr {FULL_LR}, clip 1.0) at B = {HOST_BATCH}, "
        f"S = {HOST_SEQ}: "
        f"losses {[round(x, 4) for x in losses]}; {med:.2f} ms a warm step "
        f"(median of {len(walls) + len(walls2) - 2}; first {walls[0]:.1f} "
        f"ms), peak device memory {peak} [{card}]")
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"full-width host losses do not fall: {losses}")
    if losses2 != losses or not trees_equal(again, params):
        raise AssertionError("full-width host step: rerun differs")
    log("  host step: rerun losses and params bitwise equal")
    del again
    remat_compare(cfg, batches, losses, med, peak, card)
    opt = optimizers.adam()
    state, step = opt.init(params), TRAIN.make_host_step(cfg, opt, FULL_LR)
    profile_device(lambda: step(params, state, batches[0]), "host step",
                   card)
    del state
    tokens = batches[0]["tokens"]
    last, _ = ST.make_prefill_step(cfg)(params, {"tokens": tokens})
    with torch.no_grad():
        full, _ = M.forward(cfg, params, tokens)
    diff, rel = rel_err(last, full[:, -1])
    log(f"  prefill step vs forward's last position: max_abs_err="
        f"{diff:.3e} rel={rel:.3e} (tol 1e-5) [{card}]")
    if rel > 1e-5:
        raise AssertionError(f"prefill step vs forward: rel {rel:.3e}")
    del full
    cache = M.init_cache(cfg, HOST_BATCH, HOST_SEQ, device=CARD)
    serve = ST.make_serve_step(cfg, None)
    for t in range(4):
        got, got_cache = serve(params, tokens[:, t:t + 1], cache)
        with torch.no_grad():
            want, cache = M.decode_step(cfg, params, tokens[:, t:t + 1],
                                        cache)
        if not (torch.equal(got, want) and trees_equal(got_cache, cache)):
            raise AssertionError("serve step differs from decode_step")
    log("  serve step equals decode_step bitwise (4 steps, logits and cache)")
    del params, cache, start
    torch.cuda.empty_cache()
    host_card_vs_cpu(cfg, card)
    return med


@contextlib.contextmanager
def plain_tile_norms():
    """Within the block, every ranking on the card (``pruning``'s
    ``block_norm_state``, and so ``block_masks``) takes its tile norms
    from the plain version, not the kernel."""
    from repro_torch.kernels import block_norms as BN
    group = BN.tile_norms_group
    BN.tile_norms_group = BN.tile_norms_group_plain
    try:
        yield
    finally:
        BN.tile_norms_group = group


def keep_ties(params, rho: float, block: int) -> tuple[int, int]:
    """Tile keeps at ``rho`` from the kernel's norms against those from the
    plain version's, both ranked on the card: (tiles, tiles that differ).
    A differing tile must be a near tie: its plain norm within TOL of the
    plain threshold."""
    import torch
    from repro_torch.core import pruning
    rate = torch.tensor(rho, device=CARD)
    kernel_state = pruning.block_norm_state(params, block)
    with plain_tile_norms():
        plain_state = pruning.block_norm_state(params, block)
    tiles = differ = 0
    for ks, ps, kk, pk in zip(kernel_state, plain_state,
                              pruning.block_keep(kernel_state, rate),
                              pruning.block_keep(plain_state, rate)):
        if ks is None:
            continue
        tiles += kk.numel()
        split = kk != pk
        if split.any():
            thresh = pruning.block_thresholds(ps, rate)
            # a swap of two tiles at the threshold: each within the
            # kernel's tolerance of it, once a side
            gap = (ps.norms[split] - thresh).abs()
            if float(gap.max()) > 2 * TOL * float(thresh):
                raise AssertionError("tile keeps from kernel and plain norms "
                                     "differ away from the threshold")
            differ += int(split.sum())
    return tiles, differ


def run_fl_full(card: str, floor_ms: float) -> tuple[int, dict]:
    """18c: the FL step (``federated.trainer``) on smollm-135m at full
    width over a world of one rank (NCCL), block 16, rho 0.3, k 40:
    exactly one tile-norm launch a step (counted from zero over the
    steps), the ranking held against the plain version on its leaves and
    tiles (``norms_regime``) and its tile keeps against those of the plain
    norms, ``achieved_rho`` within 0.15 of 0.3, a rerun bitwise, an
    all-dropped step leaving the params bitwise, and rho = 0 against
    ``make_train_step`` within 1e-5.  Returns (launches, the ranking's
    figures)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.federated import trainer as FT
    from repro_torch.fleet.task import TransformerTask
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as ST
    cfg = get_config("smollm-135m")
    mesh = MESH.make_host_mesh(model=1, device=CARD)
    n = FT.num_clients(mesh, ("data",))
    step = FT.make_fl_train_step(cfg, mesh, ("data",), block=FL_BLOCK,
                                 lr=HOST_LR)

    def vec(x):
        return torch.full((n,), x, dtype=torch.float32, device=CARD)

    batches = host_batches(cfg.vocab_size, n * HOST_BATCH, HOST_SEQ,
                           FL_STEPS, CARD)
    start = model_params(cfg, P18_SEED + 1)

    def run():
        params, rhos, walls = start, [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, m = step(params, batch, vec(FL_RHO), vec(1.0), vec(FL_K))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            rhos.append(float(m["achieved_rho"][0]))
        return params, rhos, walls

    torch.cuda.reset_peak_memory_stats()
    zero_fleet_counts()
    params, rhos, walls = run()
    launches = fleet_counts()
    log(f"  FL step (world of {n}, NCCL, block {FL_BLOCK}, rho {FL_RHO}): "
        f"achieved rho {rhos}, walls {fmt_walls(walls)}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{json.dumps(launches)} [{card}]")
    if launches != {"fleet_fused_grads": 0, "tile_norms": FL_STEPS}:
        raise AssertionError(f"FL step launches {launches}: want one "
                             f"tile-norm launch a step")
    if any(abs(r - FL_RHO) > 0.15 for r in rhos):
        raise AssertionError(f"achieved rho {rhos} not within 0.15 of "
                             f"{FL_RHO}")
    again, rhos2, walls2 = run()
    if rhos2 != rhos or not trees_equal(again, params):
        raise AssertionError("FL step: rerun differs")
    log(f"  FL step: rerun bitwise equal; warm step "
        f"{float(np.median(walls[1:] + walls2[1:])):.2f} ms (median) "
        f"[{card}]")
    del again
    regime = norms_regime(f"smollm-135m block {FL_BLOCK} (18c's FL step)",
                          *task_ranking(TransformerTask(arch=cfg,
                                                        block=FL_BLOCK),
                                        start), 20, 3, floor_ms, card)
    tiles, differ = keep_ties(start, FL_RHO, FL_BLOCK)
    log(f"  tile keeps at rho {FL_RHO}, kernel vs plain norms: {differ} of "
        f"{tiles} tiles differ (only near ties may)")
    dropped, _ = step(start, batches[0], vec(FL_RHO), vec(0.0), vec(FL_K))
    if not trees_equal(dropped, start):
        raise AssertionError("an all-dropped FL step moved the params")
    del dropped
    dense, _ = step(start, batches[0], vec(0.0), vec(1.0), vec(FL_K))
    want, _ = ST.make_train_step(cfg, HOST_LR)(start, batches[0])
    diff, rel = tree_rel(dense, want)
    log(f"  all-dropped step: params bitwise unchanged; rho = 0 vs "
        f"make_train_step: max_abs_err={diff:.3e} rel={rel:.3e} (tol 1e-5) "
        f"[{card}]")
    if rel > 1e-5:
        raise AssertionError(f"rho = 0 FL step vs make_train_step: {rel:.3e}")
    del dense, want, params, start
    torch.cuda.empty_cache()
    return launches["tile_norms"], regime


def run_fl_two_ranks(card: str, floor_ms: float) -> tuple[int, float]:
    """18d: the FL step on two ranks sharing the card over gloo (two
    processes, a FileStore, each with a timeout) at smollm-135m's smoke
    width, rho [0.3, 0.5], k [40, 30], arrivals [1, 0] and [1, 1]: both
    ranks' params bitwise equal and within 1e-5 of the Eq.-(5)
    ``aggregate`` of the two clients' masked gradients computed here,
    with masks from the plain tile norms (so a fault of the kernel the
    ranks rank with shows), and the ranking of these params held against
    the plain version.  Returns the ranks' tile-norm launches and the
    ranking's largest error."""
    import os
    import tempfile
    import torch
    from repro_torch import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import aggregation, pruning
    from repro_torch.data.tokens import TokenStream
    from repro_torch.fleet.task import TransformerTask
    from repro_torch.models import model as M
    spec = {"seed": P18_SEED + 2, "batch": TWO_BATCH, "seq": TWO_SEQ,
            "block": FL_BLOCK, "lr": 0.5, "rho": TWO_RHO, "k": TWO_K,
            "arrivals": TWO_ARRIVALS, "device": CARD}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", TWO_RANK_CHILD, str(r), "2",
             f"{tmp}/store", tmp, json.dumps(spec)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=TWO_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"18d rank {r} exited {p.returncode}:"
                                     f"\n{out[-3000:]}")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
        cfg = get_config("smollm-135m").smoke_variant()
        params = pruning.tree_map(lambda a: a.to(CARD), M.init_params(
            cfg, torch.Generator().manual_seed(spec["seed"])))
        results = [[checkpoint.restore(f"{tmp}/rank{r}_case{c}.npz", params,
                                       device=CARD)
                    for c in range(len(TWO_ARRIVALS))] for r in range(2)]
    if [(x["client"], x["clients"]) for x in ranks] != [(0, 2), (1, 2)]:
        raise AssertionError(f"18d ranks {ranks}")
    tokens = torch.as_tensor(TokenStream(cfg.vocab_size, seed=spec["seed"])
                             .sample(2 * TWO_BATCH, TWO_SEQ),
                             dtype=torch.int64, device=CARD)
    err = smoke_ranking(params, "18d's", TWO_RHO, floor_ms, card)
    task = TransformerTask(arch=cfg, block=FL_BLOCK)
    grads = []
    for i in range(2):
        with plain_tile_norms():
            masks = pruning.block_masks(params, torch.tensor(
                TWO_RHO[i], device=CARD), block=task.tile_grid(params))
        batch = {"tokens": tokens[i * TWO_BATCH:(i + 1) * TWO_BATCH]}
        _, g = pruning.value_and_grad(lambda p: (task.loss(
            pruning.apply_masks(p, masks), batch), None), params)
        grads.append(pruning.apply_masks(g, masks))
    stacked = pruning.tree_map(lambda *g: torch.stack(g), *grads)
    worst = 0.0
    for c, arrivals in enumerate(TWO_ARRIVALS):
        g = aggregation.aggregate(stacked, torch.tensor(TWO_K, device=CARD),
                                  torch.tensor(arrivals, device=CARD))
        want = pruning.tree_map(lambda p, gg: p - spec["lr"] * gg, params, g)
        if not trees_equal(results[0][c], results[1][c]):
            raise AssertionError(f"18d case {c}: the ranks' params differ")
        worst = max(worst, tree_rel(results[0][c], want)[1])
        if ranks[0]["metrics"][c] != ranks[1]["metrics"][c]:
            raise AssertionError(f"18d case {c}: the ranks' metrics differ")
    log(f"  two ranks over gloo ({wall:.1f} s with start-up): metrics "
        f"{ranks[0]['metrics']}; both ranks' params bitwise equal; vs "
        f"Eq.-(5) aggregate of the two clients' masked gradients: rel "
        f"{worst:.3e} (tol 1e-5); tile-norm launches {ranks[0]['tile_norms']}"
        f" + {ranks[1]['tile_norms']} [{card}]")
    if worst > 1e-5:
        raise AssertionError(f"18d vs Eq. (5): rel {worst:.3e}")
    return ranks[0]["tile_norms"] + ranks[1]["tile_norms"], err


def run_phase18(card: str, floor_ms: float) -> dict:
    """Phase 18; returns row 2's tile-norm launches, 18c's ranking figures,
    the smoke-width rankings' largest error and 18b's warm step ms."""
    import torch.distributed as dist
    phase("  [18a] the launcher's command line")
    cli, cli_err = run_cli(card, floor_ms)
    phase("  [18b] smollm-135m at full width: the host step")
    host_ms = run_host_full(card)
    phase("  [18c] the FL step at full width, one rank")
    fl, regime = run_fl_full(card, floor_ms)
    dist.destroy_process_group()
    phase("  [18d] the FL step on two ranks")
    two, two_err = run_fl_two_ranks(card, floor_ms)
    return {"cli": cli, "fl": fl, "two": two, "regime": regime,
            "smoke_err": max(cli_err, two_err), "host_ms": host_ms}


# ---------------------------------------------------------------------------
# Phase 19: the FL step with each client's weights sharded over "model"
# ---------------------------------------------------------------------------

P19_SEED = P18_SEED + 10
TP_RHO, TP_K, TP_ARRIVALS = [0.3, 0.5], [40.0, 30.0], [1.0, 1.0]
TP_SMOKE_BATCH, TP_SMOKE_SEQ, TP_SMOKE_STEPS, TP_SMOKE_LR = 2, 32, 2, 0.5
TP_BLOCKS, TP_TIMEOUT = (16, 128), 300
TP_RULES_SEQ = 2048
TP_BATCH, TP_SEQ, TP_STEPS, TP_LR, TP_BLOCK = 8, 128, 3, 1e-2, 128
TP_FULL_TIMEOUT = 600

# 19a: one rank of the ("data" 2, "model" 2) FL step at qwen2-7b's smoke
# width, four ranks sharing the card over gloo; writes its figures (JSON)
# and its shards (torch.save)
TP_RANK_CHILD = r"""
import json, sys
import torch
import torch.distributed as dist
rank, world, store, out, spec = sys.argv[1:6]
rank, world, spec = int(rank), int(world), json.loads(spec)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_config
from repro_torch.core import pruning
from repro_torch.data.tokens import TokenStream
from repro_torch.federated import trainer as FT
from repro_torch.kernels import block_norms as BN
from repro_torch.launch import mesh as MESH
from repro_torch.launch import shardings as SH
from repro_torch.models import model as M
MESH.gloo_cuda_all_gather()
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
# remat "block", as the full config's: the FL step trains the model's
# own remat (TransformerTask.config), so each repeat is a checkpointed
# DTensor step
cfg = get_config("qwen2-7b").smoke_variant().replace(remat="block")
gen = torch.Generator().manual_seed(spec["seed"])
params = M.init_params(cfg, gen)
for name in ("wq", "wk", "wv"):    # the init leaves the qkv biases 0
    b = params["stages"][0]["b0"]["attn"][name]["b"]
    b.copy_(0.5 * torch.randn(b.shape, generator=gen))
params = pruning.tree_map(lambda a: a.to(dev), params)
tokens = torch.as_tensor(TokenStream(cfg.vocab_size, seed=spec["seed"])
                         .sample(2 * spec["batch"], spec["seq"]),
                         dtype=torch.int64, device=dev)
mesh = MESH.make_host_mesh(data=2, model=2, device=dev)
me = FT.client_index(mesh, ("data",))
vec = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
rho, arrivals, k = vec(spec["rho"]), vec(spec["arrivals"]), vec(spec["k"])
specs = SH.leaves_like(SH.param_shardings(params, mesh, fsdp=False), params)
placed = pruning.unflatten(params, [
    distribute_tensor(p, mesh, SH.placements(s, mesh), src_data_rank=None)
    for p, s in zip(pruning.flatten(params), specs)])
torch.save([p.to_local().cpu() for p in pruning.flatten(placed)],
           f"{out}/rank{rank}_start.pt")


def local_of(whole, like):
    return distribute_tensor(whole, mesh, like.placements,
                             src_data_rank=None).to_local()


res = {"coord": list(mesh.get_coordinate()), "blocks": {}}
for block in spec["blocks"]:
    steps = {sharded: FT.make_fl_train_step(
        cfg, mesh, ("data",), block=block, lr=spec["lr"],
        tp_shard_params=sharded) for sharded in (True, False)}
    BN.tile_norms.launches = 0
    pruning.block_norm_state.gathers = 0
    p, metrics = params, []
    for _ in range(spec["steps"]):
        p, m = steps[True](p, {"tokens": tokens}, rho, arrivals, k)
        metrics.append({"loss": float(m["loss"]),
                        "achieved_rho": m["achieved_rho"].tolist()})
    torch.cuda.synchronize()
    launches, gathers = BN.tile_norms.launches, pruning.block_norm_state.gathers
    q = params
    for _ in range(spec["steps"]):
        q, _ = steps[False](q, {"tokens": tokens}, rho, arrivals, k)
    worst = max(float((a.to_local() - local_of(b, a)).abs().max())
                / max(float(b.abs().max()), 1e-30)
                for a, b in zip(pruning.flatten(p), pruning.flatten(q)))
    # the sharded ranking against the same params whole, bitwise
    whole = pruning.tree_map(lambda a: a.full_tensor(), p)
    sharded_masks = pruning.block_masks(p, rho[me], block=block)
    whole_masks = pruning.block_masks(whole, rho[me], block=block)
    masks_equal = all(
        torch.equal(a.to_local(), local_of(b, a)) for a, b in
        zip(pruning.flatten(sharded_masks), pruning.flatten(whole_masks)))
    res["blocks"][str(block)] = {
        "metrics": metrics, "launches": launches, "gathers": gathers,
        "rel": worst, "masks_equal": masks_equal}
    torch.save([a.to_local().cpu() for a in pruning.flatten(p)],
               f"{out}/rank{rank}_block{block}.pt")
# the loss and grads under the sharding rules at 2,048 tokens (flash
# attention's query stripes over "model"), against the unsharded ones:
# the backward, each repeat's recompute in it, runs on autograd's device
# thread, which holds none of the forward's thread-local rules
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.models import sharding as MS
long = torch.as_tensor(TokenStream(cfg.vocab_size, seed=spec["seed"] + 1)
                       .sample(2, spec["rules_seq"]), dtype=torch.int64,
                       device=dev)
dlong = distribute_tensor(long, mesh, SH.placements(
    SH.data_pspec(tuple(long.shape), mesh), mesh), src_data_rank=None)
with MS.use_rules(dict(MS.DEFAULT_RULES), mesh), implicit_replication():
    stripes = MS.axis_size("q_stripes")
    (got, _), grads = pruning.value_and_grad(
        lambda p: M.loss_fn(cfg, p, {"tokens": dlong}), placed)
(want, _), want_grads = pruning.value_and_grad(
    lambda p: M.loss_fn(cfg, p, {"tokens": long}), params)
want_grads = pruning.flatten(want_grads)
res["rules"] = {
    "stripes": stripes, "loss": [float(got), float(want)],
    "rel": max(float((g.full_tensor() - w).abs().max())
               for g, w in zip(pruning.flatten(grads), want_grads))
    / max(float(w.abs().max()) for w in want_grads)}
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(res, f)
dist.barrier()
dist.destroy_process_group()
"""


def run_tp_smoke(card: str, floor_ms: float) -> tuple[int, dict]:
    """19a: the FL step with ``tp_shard_params=True`` on a ("data" 2,
    "model" 2) mesh of four ranks sharing the card over gloo (four
    processes, a FileStore, each with a timeout) at qwen2-7b's smoke
    width (float32, qkv biases, ``remat="block"`` as the full config:
    each repeat checkpointed on DTensors), rho [0.3, 0.5], k [40, 30], arrivals
    [1, 1], 2 steps at block 16 and at block 128: each rank's local
    shards within 1e-5 of the slices of the unsharded step's params
    (``tp_shard_params=False`` on the same mesh), masks of the sharded
    params bitwise those of the same params whole, one tile-norm launch
    a step a rank, no leaf gathered at block 16 and the gathered leaves
    counted at block 128 (their 64-wide shards cut 128-tiles), metrics
    equal on every rank and the two ranks of each "model" coordinate
    holding bitwise equal shards; then the kernel on rank (0, 0)'s local
    shards of the start params against its plain version
    (``norms_regime``).  Also the loss and grads at 2 x 2,048 tokens under
    the sharding rules (flash attention's 2 query stripes over "model")
    within 1e-5 of the unsharded ones: the backward runs on autograd's
    device thread, and each repeat's recompute there keeps the forward's
    rules.  Returns the ranks' tile-norm launches and the block-16
    regime's figures."""
    import os
    import tempfile
    import torch
    spec = {"seed": P19_SEED, "batch": TP_SMOKE_BATCH, "seq": TP_SMOKE_SEQ,
            "steps": TP_SMOKE_STEPS, "lr": TP_SMOKE_LR, "rho": TP_RHO,
            "k": TP_K, "arrivals": TP_ARRIVALS, "blocks": list(TP_BLOCKS),
            "rules_seq": TP_RULES_SEQ}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", TP_RANK_CHILD, str(r), "4",
             f"{tmp}/store", tmp, json.dumps(spec)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(4)]
        try:
            outs = [p.communicate(timeout=TP_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"19a rank {r} exited {p.returncode}:"
                                     f"\n{out[-3000:]}")
        wall = time.perf_counter() - t0
        ranks, shards = [], []
        for r in range(4):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
            shards.append({b: torch.load(f"{tmp}/rank{r}_block{b}.pt")
                           for b in TP_BLOCKS})
        start = [a.to(CARD) for a in torch.load(f"{tmp}/rank0_start.pt")]
    if sorted(tuple(x["coord"]) for x in ranks) != [(0, 0), (0, 1), (1, 0),
                                                     (1, 1)]:
        raise AssertionError(f"19a coordinates {[x['coord'] for x in ranks]}")
    launches = 0
    for b in TP_BLOCKS:
        got = [x["blocks"][str(b)] for x in ranks]
        if any(g["launches"] != TP_SMOKE_STEPS for g in got):
            raise AssertionError(f"19a block {b}: tile-norm launches "
                                 f"{[g['launches'] for g in got]}, want one "
                                 f"a step a rank")
        gathers = [g["gathers"] for g in got]
        if (b == 16) != all(n == 0 for n in gathers):
            raise AssertionError(f"19a block {b}: gathered leaves {gathers}")
        if any(g["metrics"] != got[0]["metrics"] for g in got):
            raise AssertionError(f"19a block {b}: the ranks' metrics differ")
        if not all(g["masks_equal"] for g in got):
            raise AssertionError(f"19a block {b}: sharded masks differ from "
                                 f"the whole params' masks")
        worst = max(g["rel"] for g in got)
        if worst > 1e-5:
            raise AssertionError(f"19a block {b}: local shards vs the "
                                 f"unsharded step: rel {worst:.3e}")
        for m in (0, 1):
            pair = [shards[r][b] for r, x in enumerate(ranks)
                    if x["coord"][1] == m]
            if not all(torch.equal(u, v) for u, v in zip(*pair)):
                raise AssertionError(f"19a block {b}: the shards of model "
                                     f"coordinate {m} differ across clients")
        launches += sum(g["launches"] for g in got)
        log(f"  block {b}: metrics {got[0]['metrics']}; local shards vs the "
            f"unsharded step rel {worst:.3e} (tol 1e-5); masks bitwise; "
            f"tile-norm launches {[g['launches'] for g in got]} "
            f"({TP_SMOKE_STEPS} steps), leaves gathered {gathers}; the two "
            f"ranks of each model coordinate bitwise equal [{card}]")
    rules = [x["rules"] for x in ranks]
    worst = max(g["rel"] for g in rules)
    loss, want = rules[0]["loss"]
    log(f"  under the sharding rules, 2 x {TP_RULES_SEQ} tokens, "
        f"{rules[0]['stripes']} query stripes, backward on autograd's device "
        f"thread: loss {loss:.6f} vs unsharded {want:.6f}, grads rel "
        f"{worst:.3e} of the largest (tol 1e-5) [{card}]")
    if any(g["stripes"] != 2 for g in rules) or worst > 1e-5 or \
            any(abs(g["loss"][0] - g["loss"][1]) > 1e-5 * abs(g["loss"][1])
                for g in rules):
        raise AssertionError(f"19a under the sharding rules: {rules}")
    log(f"  four ranks over gloo ({wall:.1f} s with start-up)")
    from repro_torch.core import pruning
    regimes = {}
    for b in TP_BLOCKS:
        # rank (0, 0) ranks its local shards of the prunable leaves
        leaves = [w for w in start if pruning.prunable((), w)]
        regimes[b] = norms_regime(
            f"qwen2-7b smoke width block {b}, rank (0, 0)'s local shards "
            f"(19a)", leaves, [(b, b)] * len(leaves), 20, 3, floor_ms, card)
    return launches, regimes[16]


# 19b: one rank of the four-card run (``torchrun``, NCCL, one card a rank)
def tp_rank_main(out: str) -> int:
    """19b, one rank: qwen2-7b at full width in bfloat16 from a seed
    through ``make_fl_train_step(tp_shard_params=True)`` on ("data" 2,
    "model" 2), block 128, at the config's ``remat="block"`` (the FL step
    trains the model's own remat: each repeat checkpointed); rank 0
    writes the figures to ``out``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.core import pruning
    from repro_torch.data.tokens import TokenStream
    from repro_torch.federated import trainer as FT
    from repro_torch.kernels import block_norms as BN
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import shardings as SH

    mesh = MESH.make_host_mesh(data=2, model=2)
    dev = MESH.local_device()
    rank = dist.get_rank()
    me = FT.client_index(mesh, ("data",))
    clients = FT.client_group(mesh, ("data",))
    peers = dist.get_process_group_ranks(clients)

    def vec(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    rho, arrivals, k = vec(TP_RHO), vec(TP_ARRIVALS), vec(TP_K)

    def placed(cfg, seed):
        """The seeded model, each leaf replaced by its shard in turn (the
        whole model is on the card only until then)."""
        params = model_params(cfg, seed, device=dev)
        shapes = pruning.tree_map(lambda a: a.to("meta"), params)
        specs = SH.leaves_like(SH.param_shardings(shapes, mesh, fsdp=False),
                               shapes)
        leaves = pruning.flatten(params)
        del params
        for i, s in enumerate(specs):
            leaves[i] = distribute_tensor(leaves[i], mesh,
                                          SH.placements(s, mesh),
                                          src_data_rank=None)
        return pruning.unflatten(shapes, leaves)

    def shards_agree(tree) -> bool:
        """The two ranks of this "model" coordinate (one a client) hold
        bitwise equal shards."""
        same = True
        for a in pruning.flatten(tree):
            mine = a.to_local()
            theirs = mine.clone()
            dist.broadcast(theirs, src=peers[0], group=clients)
            same &= bool(torch.equal(theirs, mine))
        flag = torch.tensor([float(same)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    res = {"rank": rank}
    cfg = get_config("qwen2-7b")
    if cfg.remat != "block":
        raise AssertionError(f"qwen2-7b's remat is {cfg.remat!r}")
    tokens = torch.as_tensor(TokenStream(cfg.vocab_size, seed=P19_SEED)
                             .sample(2 * TP_BATCH, TP_SEQ),
                             dtype=torch.int64, device=dev)
    step = FT.make_fl_train_step(cfg, mesh, ("data",), block=TP_BLOCK,
                                 lr=TP_LR, tp_shard_params=True)

    def run(params):
        losses, rhos, walls, agree = [], [], [], []
        for _ in range(TP_STEPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            params, m = step(params, {"tokens": tokens}, rho, arrivals, k)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            rhos.append(m["achieved_rho"].tolist())
            agree.append(shards_agree(params))
        return params, losses, rhos, walls, agree

    start = placed(cfg, P19_SEED + 1)
    whole_bytes = sum(a.numel() * a.element_size()
                      for a in pruning.flatten(start))
    local_bytes = sum(a.to_local().numel() * a.element_size()
                      for a in pruning.flatten(start))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    BN.tile_norms.launches = 0
    pruning.block_norm_state.gathers = 0
    first, losses, rhos, walls, agree = run(start)
    res.update(losses=losses, achieved_rho=rhos, walls_ms=walls,
               shards_agree=agree, launches=BN.tile_norms.launches,
               gathers=pruning.block_norm_state.gathers,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               whole_gib=whole_bytes / 2**30, local_gib=local_bytes / 2**30)
    # the kernel on this rank's local shards against its plain version
    leaves = [a.to_local() for a in pruning.flatten(first)
              if pruning.prunable((), a)]
    got = BN.tile_norms_group(leaves, [(TP_BLOCK, TP_BLOCK)] * len(leaves))
    ref = BN.tile_norms_group_plain(leaves, [(TP_BLOCK, TP_BLOCK)]
                                    * len(leaves))
    res["norms_rel"] = max(rel_err(g, r)[1] for g, r in zip(got, ref))
    del got, ref, leaves, start
    res["profile"] = profile_tp_step(step, first, tokens, rho, arrivals, k)
    again, losses2, _, _, _ = run(placed(cfg, P19_SEED + 1))
    res["rerun_bitwise"] = losses2 == losses and all(
        torch.equal(a.to_local(), b.to_local()) for a, b in
        zip(pruning.flatten(first), pruning.flatten(again)))
    del first, again
    torch.cuda.empty_cache()
    # the 2-layer float32 cut: sharded against unsharded, one step
    cut = two_layers(cfg)
    whole = model_params(cut, P19_SEED + 2, device=dev)
    steps = {sharded: FT.make_fl_train_step(
        cut, mesh, ("data",), block=TP_BLOCK, lr=TP_LR,
        tp_shard_params=sharded) for sharded in (True, False)}
    tp_new, tp_m = steps[True](whole, {"tokens": tokens}, rho, arrivals,
                               k)
    rep_new, rep_m = steps[False](whole, {"tokens": tokens}, rho,
                                  arrivals, k)

    def local_of(w, like):
        return distribute_tensor(w, mesh, like.placements,
                                 src_data_rank=None).to_local()

    res["cut_rel"] = max(
        rel_err(a.to_local().double(), local_of(b, a).double())[1]
        for a, b in zip(pruning.flatten(tp_new), pruning.flatten(rep_new)))
    res["cut_rho"] = [tp_m["achieved_rho"].tolist(),
                      rep_m["achieved_rho"].tolist()]
    start_cut = pruning.unflatten(whole, [
        distribute_tensor(p, mesh, a.placements, src_data_rank=None)
        for p, a in zip(pruning.flatten(whole), pruning.flatten(tp_new))])
    sharded_masks = pruning.block_masks(start_cut, rho[me], block=TP_BLOCK)
    whole_masks = pruning.block_masks(whole, rho[me], block=TP_BLOCK)
    res["cut_keeps_equal"] = all(
        torch.equal(a.to_local(), local_of(b, a)) for a, b in
        zip(pruning.flatten(sharded_masks), pruning.flatten(whole_masks)))
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, res)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(gathered, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


@contextlib.contextmanager
def counted_collectives():
    """Within the block, the calls and the input bytes of every
    collective DTensor issues (its functional collectives) and of the
    port's own (``dist.all_reduce`` / ``all_gather``), by kind:
    ``{kind: [calls, GB]}``."""
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    moved: dict = {}
    patched, inside = [], [0]    # a collective that calls another counts once
    for mod, names in ((funcol, ("all_gather_single", "all_gather_tensor",
                                 "reduce_scatter_tensor", "all_reduce",
                                 "all_to_all_single")),
                       (dist, ("all_reduce", "all_gather"))):
        for name in names:
            original = getattr(mod, name, None)
            if original is None:
                continue
            kind = f"{'dtensor' if mod is funcol else 'c10d'} {name}"

            def counted(x, *a, _original=original, _kind=kind, **kw):
                if not inside[0]:
                    t = x if isinstance(x, torch.Tensor) else a[0]
                    entry = moved.setdefault(_kind, [0, 0.0])
                    entry[0] += 1
                    entry[1] += t.numel() * t.element_size() / 1e9
                inside[0] += 1
                try:
                    return _original(x, *a, **kw)
                finally:
                    inside[0] -= 1

            patched.append((mod, name, original))
            setattr(mod, name, counted)
    try:
        yield moved
    finally:
        for mod, name, original in patched:
            setattr(mod, name, original)


def profile_tp_step(step, params, tokens, rho, arrivals, k) -> dict:
    """One warm sharded step under torch.profiler on this rank: its wall,
    the device's busy ms split into collectives (NCCL kernels), GEMMs,
    the tile norms and the rest, device ops, host-side aten ops (what
    DTensor dispatches) and the five longest kernels.  Empty where the
    profiler records no device time."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            counted_collectives() as moved:
        t0 = time.perf_counter()
        new, _ = step(params, {"tokens": tokens}, rho, arrivals, k)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    del new
    events = prof.key_averages()
    # "nccl:<op>" events annotate the collectives' kernels on the device
    # timeline: no device work of their own
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("nccl:")]
    busy = {"collectives": 0.0, "gemm": 0.0, "tile_norms": 0.0,
            "other": 0.0}
    ops = dict.fromkeys(busy, 0)
    for e in kernels:
        name = e.key.lower()
        cat = ("collectives" if "nccl" in name else
               "tile_norms" if "tile_norms" in name else
               "gemm" if "gemm" in name or "xmma" in name
               or "cutlass" in name else "other")
        busy[cat] += e.self_device_time_total / 1e3
        ops[cat] += e.count
    if sum(busy.values()) <= 0:
        return {"wall_ms": wall, "moved": moved}
    return {"wall_ms": wall, "busy_ms": busy, "ops": ops, "moved": moved,
            "device_ops": sum(e.count for e in kernels),
            "aten_ops": sum(e.count for e in events
                            if e.device_type == torch.autograd.DeviceType.CPU
                            and e.key.startswith("aten::")),
            "top": [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                    for e in sorted(kernels, key=lambda e:
                                    -e.self_device_time_total)[:5]]}


def run_tp_full(card: str) -> None:
    """19b: with four cards, ``tp_rank_main`` under ``torchrun`` (one rank
    a card, NCCL, a process group of its own, killed whole at its
    timeout): the loss of each step, ms a warm step, peak memory a card
    against what one card would hold unsharded (reckoned), one tile-norm
    launch a step a rank with no leaf gathered, the two ranks of each
    "model" coordinate bitwise equal after each step, a rerun bitwise,
    the kernel on the local shards within TOL of its plain version, and
    the 2-layer float32 cut against the unsharded step within 1e-5 with
    equal tile keeps.  With fewer cards, one line says so."""
    import os
    import signal
    import tempfile
    import numpy as np
    import torch
    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"  19b (qwen2-7b at full width over four cards) needs four "
            f"cards; this machine has {cards}")
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/tp.json"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", str(ROOT / "chip_smoke.py"),
             "--tp-rank", out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            text = proc.communicate(timeout=TP_FULL_TIMEOUT)[0]
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"19b exited {proc.returncode}:\n"
                                 f"{text[-4000:]}")
        wall = time.perf_counter() - t0
        with open(out) as f:
            ranks = json.load(f)
    r0 = ranks[0]
    warm = float(np.median([w for r in ranks for w in r["walls_ms"][1:]]))
    unsharded = 6 * r0["whole_gib"]
    log(f"  qwen2-7b full width, bfloat16, ({'data'} 2, model 2), block "
        f"{TP_BLOCK}, per-client batch ({TP_BATCH}, {TP_SEQ}), rho {TP_RHO},"
        f" k {TP_K}, lr {TP_LR}: losses {r0['losses']}, achieved rho "
        f"{r0['achieved_rho'][-1]}, walls {fmt_walls(r0['walls_ms'])} "
        f"(rank 0), warm step {warm:.1f} ms (median over ranks) [{card}]")
    log(f"  peak device memory a card "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB, params "
        f"{r0['local_gib']:.2f} GiB a card of {r0['whole_gib']:.2f}; "
        f"unsharded one card would hold ~{unsharded:.1f} GiB (6 x "
        f"{r0['whole_gib']:.2f} GiB: params, masked params, grads, masked "
        f"grads, aggregate, new params; reckoned) [{card}]")
    log(f"  tile-norm launches {[r['launches'] for r in ranks]} "
        f"({TP_STEPS} steps), leaves gathered "
        f"{[r['gathers'] for r in ranks]}; shards of each model coordinate "
        f"bitwise equal after each step "
        f"{[all(r['shards_agree']) for r in ranks]}; rerun bitwise "
        f"{[r['rerun_bitwise'] for r in ranks]}; the kernel on local shards "
        f"vs plain rel {max(r['norms_rel'] for r in ranks):.3e} "
        f"({wall:.1f} s with start-up) [{card}]")
    prof = r0["profile"]
    if "busy_ms" in prof:
        busy = prof["busy_ms"]
        log(f"  profiled warm step (rank 0): wall {prof['wall_ms']:.1f} ms, "
            f"device busy {sum(busy.values()):.2f} ms "
            f"({100 * sum(busy.values()) / prof['wall_ms']:.1f}%): "
            + ", ".join(f"{k} {v:.2f} ms ({prof['ops'][k]} ops)"
                        for k, v in busy.items())
            + f"; {prof['device_ops']} device ops, {prof['aten_ops']} "
            f"aten ops on the host (a collective's kernel time includes "
            f"its wait for the other rank) [{card}]")
        for name, ms, count in prof["top"]:
            log(f"    {ms:8.3f} ms  x{count:<5d} {name}")
    else:
        log(f"  profiled warm step (rank 0): wall {prof['wall_ms']:.1f} ms, "
            f"device time not measured (no CUDA events)")
    log("  collectives of that step (rank 0; calls / GB of input): "
        + ", ".join(f"{kind} {n} / {gb:.3f}"
                    for kind, (n, gb) in sorted(prof["moved"].items())))
    log(f"  2-layer float32 cut, sharded vs unsharded step: rel "
        f"{max(r['cut_rel'] for r in ranks):.3e} (tol 1e-5), achieved rho "
        f"{r0['cut_rho'][0]} vs {r0['cut_rho'][1]}, tile keeps equal "
        f"{[r['cut_keeps_equal'] for r in ranks]} [{card}]")
    if not all(np.isfinite(r0["losses"])) or \
            any(r["losses"] != r0["losses"] for r in ranks):
        raise AssertionError("19b: losses not finite or not equal on ranks")
    if any(r["launches"] != TP_STEPS or r["gathers"] for r in ranks):
        raise AssertionError("19b: want one tile-norm launch a step a rank "
                             "and no leaf gathered")
    if not all(all(r["shards_agree"]) and r["rerun_bitwise"]
               and r["cut_keeps_equal"] for r in ranks):
        raise AssertionError("19b: shards, rerun or tile keeps differ")
    if max(r["cut_rel"] for r in ranks) > 1e-5 or \
            r0["cut_rho"][0] != r0["cut_rho"][1]:
        raise AssertionError("19b: the 2-layer cut differs from the "
                             "unsharded step")
    if max(r["norms_rel"] for r in ranks) > TOL:
        raise AssertionError("19b: the kernel on local shards disagrees")


# ---------------------------------------------------------------------------
# Phase 20: the fleet engine on a ("cells", "data") mesh
# ---------------------------------------------------------------------------

MESH_ROUNDS = 3
MESH_TIMEOUT, MESH_FULL_TIMEOUT = 240, 900
# 20b: a million clients (1,000 cells x 1,000), streamed, cell_chunk 100
# (100,000 clients a fused call), the cohort 100 a cell in control blocks
# of 250 cells
MESH_FULL_CELLS, MESH_FULL_PER_CELL, MESH_FULL_CHUNK = 1000, 1000, 100
MESH_FULL_M, MESH_FULL_CONTROL_CHUNK = 100, 250
CONTROL_FIELDS = ("mask", "strag", "arrivals", "t_client", "m_round",
                  "cohort")


def mesh_paths(full: bool) -> dict:
    """Phase 20's two paths: full participation (the sync fused round) and
    the uniform cohort; 20a at the slice, 20b at a million clients."""
    import dataclasses
    from repro_torch.fleet import ScheduleConfig
    if full:
        base = dataclasses.replace(
            slice_config(MESH_ROUNDS, MESH_FULL_CELLS, MESH_FULL_PER_CELL),
            cache_data=False, cell_chunk=MESH_FULL_CHUNK)
        m, chunk = MESH_FULL_M, MESH_FULL_CONTROL_CHUNK
    else:
        base, m, chunk = slice_config(MESH_ROUNDS), COHORT_M, COHORT_CHUNK
    return {"full": base, "cohort": dataclasses.replace(
        base, control_chunk=chunk, schedule=ScheduleConfig(
            participation="uniform", participants_per_cell=m))}


def controls_equal(a, b) -> list:
    """The fields of two ``RoundControl``s (the solution's included) whose
    bits or dtypes differ."""
    import torch
    pairs = [(f, getattr(a, f), getattr(b, f)) for f in CONTROL_FIELDS]
    pairs += [(f"sol.{f}", x, y) for f, x, y in zip(
        a.sol._fields, a.sol, b.sol)]
    return [f for f, x, y in pairs
            if (x is None) != (y is None) or x is not None and not (
                x.dtype == y.dtype and torch.equal(x, y))]


def params_digest(params) -> str:
    import hashlib
    h = hashlib.sha256()
    for name, layer in sorted(params.items()):
        for leaf, v in sorted(layer.items()):
            h.update(f"{name}/{leaf}".encode())
            h.update(v.tobytes())
    return h.hexdigest()


def result_rel(a, b) -> tuple[float, float]:
    """(losses, params): max |a - b| over max |b|, of two FleetResults."""
    import numpy as np

    def rel(x, y):
        return float(np.max(np.abs(x - y))) / max(float(np.max(np.abs(y))),
                                                 1e-30)
    params = max(rel(a.params[n][k], b.params[n][k])
                 for n in b.params for k in b.params[n])
    return rel(a.losses, b.losses), params


def profile_mesh_round(sim, carry, r: int) -> dict:
    """One warm round on every rank, this rank's under torch.profiler: its
    wall, device busy ms (and its NCCL kernels' part, which includes the
    wait for the other ranks), device ops and the five longest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(carry, r)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ANNOTATIONS and not e.key.startswith("nccl:")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall, "busy_ms": busy,
            "nccl_ms": sum(e.self_device_time_total for e in kernels
                           if "nccl" in e.key.lower()) / 1e3,
            "device_ops": sum(e.count for e in kernels),
            "top": [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                    for e in sorted(kernels, key=lambda e:
                                    -e.self_device_time_total)[:5]]}


def fleet_mesh_rank(out: str, spec: dict) -> int:
    """Phase 20, one rank: each of ``mesh_paths(spec["full"])`` run
    meshless on this rank's card, then on the ("cells" 2, "data" 2) mesh
    of ``make_fleet_mesh()``, round by round (control, apply and the
    all-reduce timed, launches counted, each control held bitwise against
    the meshless one), then again (rerun).  20a: four ranks sharing the
    card over gloo (``spec["store"]``, a FileStore); 20b: ``torchrun``'s
    ranks over NCCL, a card each.  Rank 0 writes every rank's figures to
    ``out`` (JSON)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.fleet import build_simulation
    from repro_torch.launch import mesh as MESH
    probe = None
    if spec.get("store"):
        dist.init_process_group("gloo", store=dist.FileStore(
            spec["store"], 4), rank=spec["rank"], world_size=4)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        # gloo's all-reduce and all-gather of CUDA tensors, which the
        # engine's mesh path issues as they are (no staging on the host)
        rank = dist.get_rank()
        x = torch.full((3,), float(rank + 1), device=dev)
        parts = [torch.empty_like(x) for _ in range(4)]
        dist.all_gather(parts, x)
        dist.all_reduce(x)
        probe = [float(x[0])] + [float(p[0]) for p in parts]
        if probe != [10.0, 1.0, 2.0, 3.0, 4.0]:
            raise AssertionError(f"gloo on CUDA tensors gave {probe}")
    else:
        dev = MESH.local_device()
    mesh = MESH.make_fleet_mesh(device=dev)
    rank = dist.get_rank()
    calls = {"all_reduce": [0, 0.0], "all_gather": [0, 0.0]}
    for name in calls:
        def timed(*a, _f=getattr(dist, name), _n=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_ = _f(*a, **kw)
            torch.cuda.synchronize()
            calls[_n][0] += 1
            calls[_n][1] += (time.perf_counter() - t0) * 1e3
            return out_
        setattr(dist, name, timed)

    def drive_rounds(sim):
        """Every round of ``sim``: (carry, FleetResult, its controls, walls
        [control, apply, all-reduce] ms and launches a round)."""
        zero_fleet_counts()
        carry = sim.init_carry(sim.params)
        history, walls, steps, ctls = [], [], [], []
        for r in range(sim.cfg.rounds):
            before, ar = fleet_counts(), calls["all_reduce"][1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctls.append(sim.control(r))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            carry, m = sim.apply(carry, ctls[-1])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            after = fleet_counts()
            steps.append({k: after[k] - before[k] for k in after})
            walls.append([(t1 - t0) * 1e3, (t2 - t1) * 1e3,
                          calls["all_reduce"][1] - ar])
            history.append(m)
        result = sim.finalize(carry, {k: torch.stack([h[k] for h in history])
                                      for k in history[0]})
        return carry, result, ctls, walls, steps

    res = {"rank": rank, "coord": list(mesh.get_coordinate()),
           "shape": list(mesh.shape), "probe": probe, "paths": {}}
    for name, cfg in mesh_paths(spec["full"]).items():
        _, ref_out, ref_ctls, ref_walls, _ = drive_rounds(
            build_simulation(cfg, device=dev))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        sim = build_simulation(cfg, mesh=mesh, device=dev)
        carry, got, ctls, walls, steps = drive_rounds(sim)
        differ = [controls_equal(a, b) for a, b in zip(ctls, ref_ctls)]
        del ctls, ref_ctls
        counts = {k: v[0] for k, v in calls.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        prof = profile_mesh_round(sim, carry, cfg.rounds - 1) \
            if spec["full"] else None
        del sim, carry
        again = build_simulation(cfg, mesh=mesh, device=dev)
        rerun = again.finalize(*again.simulate(again.params))
        del again
        torch.cuda.empty_cache()
        loss_rel, param_rel = result_rel(got, ref_out)
        res["paths"][name] = {
            "clients": cfg.topology.num_clients, "launches": steps,
            "walls_ms": walls, "meshless_walls_ms": ref_walls,
            "collectives": counts, "differ": differ,
            "losses": got.losses.tolist(),
            "meshless_losses": ref_out.losses.tolist(),
            "loss_rel": loss_rel, "param_rel": param_rel,
            "digest": params_digest(got.params),
            "rerun_bitwise": bool(np.array_equal(rerun.losses, got.losses)
                                  and params_digest(rerun.params)
                                  == params_digest(got.params)),
            "peak_gib": peak, "profile": prof}
        for v in calls.values():
            v[:] = [0, 0.0]
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, res)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(ranks, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def check_mesh_ranks(ranks: list, full: bool, card: str, what: str) -> dict:
    """Phase 20's gates on every rank's figures, and rank 0's rounds;
    returns the launches of the meshed runs, summed over ranks and
    paths."""
    import numpy as np
    paths = mesh_paths(full)
    if sorted(tuple(r["coord"]) for r in ranks) != [(0, 0), (0, 1), (1, 0),
                                                     (1, 1)]:
        raise AssertionError(f"{what}: mesh coordinates "
                             f"{[r['coord'] for r in ranks]}")
    total = dict.fromkeys(("fleet_fused_grads", "tile_norms"), 0)
    for name, cfg in paths.items():
        got = [r["paths"][name] for r in ranks]
        r0 = got[0]
        m = cfg.schedule.participants_per_cell \
            if name == "cohort" else cfg.topology.clients_per_cell
        step = (cfg.cell_chunk if 0 < cfg.cell_chunk < cfg.topology.num_cells
                else cfg.topology.num_cells) * m
        per_rank = -(-cfg.topology.num_cells * m // 4)
        fused = -(-per_rank // step)
        want = {"fleet_fused_grads": fused, "tile_norms": 1}
        for r, g in zip(ranks, got):
            log(f"  {what} {name}, rank {r['rank']} {tuple(r['coord'])}: "
                f"losses {g['losses']}")
        for rnd, (wall, alone, launches) in enumerate(zip(
                r0["walls_ms"], r0["meshless_walls_ms"], r0["launches"])):
            log(f"  {what} {name} round {rnd} (rank 0): "
                f"wall {sum(wall[:2]):.2f} ms (control {wall[0]:.2f}, "
                f"apply {wall[1]:.2f}, of it the all-reduce {wall[2]:.2f}) "
                f"launches {json.dumps(launches)}; meshless on the card "
                f"{sum(alone[:2]):.2f} ms (control {alone[0]:.2f}, apply "
                f"{alone[1]:.2f}) [{card}]")
        log(f"  {what} {name}: {got[0]['clients']:,} clients; against the "
            f"meshless run on the card: controls bitwise "
            f"{[not any(d) for g in got for d in g['differ']]}, losses rel "
            f"{max(g['loss_rel'] for g in got):.3e}, params rel "
            f"{max(g['param_rel'] for g in got):.3e} (tol {TOL}); params "
            f"bitwise equal across ranks "
            f"{len({g['digest'] for g in got}) == 1}; rerun bitwise "
            f"{[g['rerun_bitwise'] for g in got]}; collectives a rank "
            f"{r0['collectives']}; peak "
            f"{[round(g['peak_gib'], 2) for g in got]} GiB [{card}]")
        bad = [(r["rank"], d) for r, g in zip(ranks, got)
               for d in g["differ"] if d]
        if bad:
            raise AssertionError(f"{what} {name}: controls differ from the "
                                 f"meshless run's: {bad}")
        if max(max(g["loss_rel"], g["param_rel"]) for g in got) > TOL:
            raise AssertionError(f"{what} {name}: the mesh run is not "
                                 f"within {TOL} of the meshless run")
        if len({g["digest"] for g in got}) != 1 or \
                any(g["losses"] != r0["losses"] for g in got):
            raise AssertionError(f"{what} {name}: the ranks' params differ")
        if not all(g["rerun_bitwise"] for g in got):
            raise AssertionError(f"{what} {name}: a rerun differs")
        if any(s != want for g in got for s in g["launches"]):
            raise AssertionError(
                f"{what} {name}: launches "
                f"{[g['launches'] for g in got]}, want {want} a round a rank")
        rounds = cfg.rounds
        if any(g["collectives"] != {"all_reduce": rounds,
                                    "all_gather": rounds} for g in got):
            raise AssertionError(f"{what} {name}: collectives "
                                 f"{[g['collectives'] for g in got]}, want "
                                 f"one all-reduce and one all-gather a round")
        for g in got:
            for s in g["launches"]:
                for k in total:
                    total[k] += s[k]
        prof = r0["profile"]
        if prof is not None:
            if prof["busy_ms"] > 0:
                log(f"  {what} {name} profiled warm round (rank 0): wall "
                    f"{prof['wall_ms']:.2f} ms, device busy "
                    f"{prof['busy_ms']:.3f} ms "
                    f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%; NCCL "
                    f"{prof['nccl_ms']:.3f} ms, with its wait for the other "
                    f"ranks), {prof['device_ops']} device ops [{card}]")
                for kname, ms, count in prof["top"]:
                    log(f"    {ms:8.3f} ms  x{count:<5d} {kname}")
            else:
                log(f"  {what} {name} profiled warm round (rank 0): wall "
                    f"{prof['wall_ms']:.2f} ms, device time not measured "
                    f"(no CUDA events)")
    return total


def run_fleet_mesh_smoke(card: str) -> dict:
    """20a: four ranks sharing the card over gloo (four processes, a
    FileStore, each with a timeout), ``fleet_mesh_rank`` at the slice on
    (2, 2): the sync fused round and the uniform cohort (10 of 100 a
    cell, ``control_chunk`` 25), 3 rounds each; gates in
    ``check_mesh_ranks``."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--fleet-mesh-rank",
             f"{tmp}/mesh.json", json.dumps(
                 {"full": False, "store": f"{tmp}/store", "rank": r})],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(4)]
        try:
            outs = [p.communicate(timeout=MESH_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"20a rank {r} exited {p.returncode}:"
                                     f"\n{text[-3000:]}")
        wall = time.perf_counter() - t0
        with open(f"{tmp}/mesh.json") as f:
            ranks = json.load(f)
    log(f"  gloo on CUDA tensors: all-gather and all-reduce as they are "
        f"(rank 0's probe {ranks[0]['probe']})")
    total = check_mesh_ranks(ranks, False, card, "20a")
    log(f"  four ranks over gloo ({wall:.1f} s with start-up); launches "
        f"{json.dumps(total)} [{card}]")
    return total


def run_fleet_mesh_full(card: str) -> None:
    """20b: with four cards, ``fleet_mesh_rank`` under ``torchrun`` (one
    rank a card, NCCL, a process group of its own, killed whole at its
    timeout) at a million clients (1,000 x 1,000, streamed, cell_chunk
    100): full participation and the uniform cohort (100 a cell,
    ``control_chunk`` 250), 3 rounds each, each rank's meshless run on
    its own card the comparison; ms a round (control, apply, all-reduce),
    peak memory a card, a profiled round's busy share.  With fewer
    cards, one line says so."""
    import os
    import signal
    import tempfile
    import torch
    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"  20b (a million clients on a (2, 2) mesh over four cards) "
            f"needs four cards; this machine has {cards}")
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", str(ROOT / "chip_smoke.py"),
             "--fleet-mesh-rank", f"{tmp}/mesh.json",
             json.dumps({"full": True})], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            text = proc.communicate(timeout=MESH_FULL_TIMEOUT)[0]
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"20b exited {proc.returncode}:\n"
                                 f"{text[-4000:]}")
        wall = time.perf_counter() - t0
        with open(f"{tmp}/mesh.json") as f:
            ranks = json.load(f)
    total = check_mesh_ranks(ranks, True, card, "20b")
    log(f"  four cards over NCCL ({wall:.1f} s with start-up); launches "
        f"{json.dumps(total)} [{card}]")


# ---------------------------------------------------------------------------
# Phase 21: the dry run and the roofline
# ---------------------------------------------------------------------------

DRYRUN_TIMEOUT = 300


def host_roofline_share(ms: float, card: str) -> None:
    """21a: 18b's warm host step (smollm-135m at full width, B x S
    tokens) as a share of the card's bfloat16 peak: ``model_flops`` (6 N
    D) over ms x ``roofline.PEAK_FLOPS``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import roofline as RF
    from repro_torch.models import model as M
    cfg = get_config("smollm-135m")
    shape = InputShape("host_step", HOST_SEQ, HOST_BATCH, "train")
    n = RF.active_param_count(cfg, M.init_params(cfg, None))
    flops = RF.model_flops(cfg, shape, n)
    share = flops / (ms * 1e-3 * RF.PEAK_FLOPS)
    log(f"  18b's host step: {n} params x {HOST_BATCH * HOST_SEQ} tokens, "
        f"model_flops {flops:.4e} in {ms:.2f} ms = {flops / ms / 1e9:.2f} "
        f"TFLOP/s, {share:.4%} of {RF.PEAK_FLOPS / 1e12:.0f} TFLOP/s "
        f"[{card}]")


# 21b's gates on qwen2-7b's production-mesh steps (16 x 16, a chip's
# figures): the decode_32k step's peak (live + arguments), and the
# train_4k steps' (an H100 holds 80 GB; the config's remat="block" and
# the local decode put them at ~23 and ~5.3 GiB; the FL step keeps the
# model's remat too, ~22 GiB)
DECODE_PEAK_GIB, TRAIN_PEAK_GIB = 8.0, 70.0
DECODE_ROWS = 128 // 16            # decode_32k's batch rows a "data" shard


def decode_gates(out: str) -> None:
    """21b's gates on ``diagnose``'s qwen2-7b decode_32k printout: the
    peak (live + arguments) at most ``DECODE_PEAK_GIB``, no all-gather
    among the biggest local tensors (a gathered cache: each rank attends
    and writes its own rows and slots), and every stacked cache
    ``model._stack`` returns holding only a data shard's rows."""
    import re
    peak = re.search(r"= ([0-9.]+) GiB, \d+ local ops", out)
    if peak is None or float(peak.group(1)) > DECODE_PEAK_GIB:
        raise AssertionError(f"qwen2-7b decode_32k: peak "
                             f"{peak and peak.group(1)} GiB, over "
                             f"{DECODE_PEAK_GIB}")
    big = out.split("-- biggest single local tensors")[1].split(
        "-- collectives")[0]
    if "all_gather" in big:
        raise AssertionError("qwen2-7b decode_32k: a cache-sized all-gather")
    for dims in re.findall(r"stack +\w+\[([0-9x]+)\] in model\._stack", big):
        if int(dims.split("x")[1]) != DECODE_ROWS:
            raise AssertionError(f"qwen2-7b decode_32k: a stacked cache of "
                                 f"{dims}, not {DECODE_ROWS} rows a chip")


def train_gate(out: str, arch: str = "qwen2-7b") -> None:
    """21b's gate on a train_4k row: its peak (``hbm=``) under
    ``TRAIN_PEAK_GIB``."""
    import re
    peak = re.search(rf"OK   {arch} .*hbm= *([0-9.]+)GiB", out)
    if peak is None or float(peak.group(1)) >= TRAIN_PEAK_GIB:
        raise AssertionError(f"{arch} train_4k: peak "
                             f"{peak and peak.group(1)} GiB, not under "
                             f"{TRAIN_PEAK_GIB}")


def start_dryruns() -> dict:
    """21b's processes, started together, each with no card: the dry runs
    of smollm-135m decode_32k, qwen2-7b train_4k (the plain step and the
    pruned-FL step, ``--fl``) and xlstm-125m train_4k, the fleet dry run
    and ``diagnose`` of qwen2-7b decode_32k.  Fails if the fake group or
    ``FakeTensorMode`` is missing.  ``finish_dryruns`` reads them."""
    import os
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode  # noqa
        from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa
        import torch.distributed as dist
        if not dist.is_backend_available("fake"):
            raise ImportError("no 'fake' process-group backend")
    except ImportError as e:
        raise AssertionError(f"the dry run's fake group or FakeTensorMode "
                             f"is missing: {e}") from e
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    env.pop("WORLD_SIZE", None)
    dryrun = ["-m", "repro_torch.launch.dryrun"]
    runs = {"combo": dryrun + ["--arch", "smollm-135m", "--shape",
                               "decode_32k"],
            "train": dryrun + ["--arch", "qwen2-7b", "--shape", "train_4k"],
            "fltrain": dryrun + ["--arch", "qwen2-7b", "--shape", "train_4k",
                                 "--fl"],
            "xtrain": dryrun + ["--arch", "xlstm-125m", "--shape",
                                "train_4k"],
            "decode": ["-m", "repro_torch.launch.diagnose", "--arch",
                       "qwen2-7b", "--shape", "decode_32k"],
            "fleet": dryrun + ["--fleet"]}
    t0 = time.perf_counter()
    procs = {what: subprocess.Popen(
        [sys.executable, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT)) for what, args in runs.items()}
    return {"runs": runs, "procs": procs, "t0": t0}


def stop_dryruns(started: dict) -> None:
    """Kill whichever of ``start_dryruns``' processes still run."""
    for proc in started["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def finish_dryruns(started: dict) -> None:
    """21b: the output of ``start_dryruns``' processes printed.  Fails
    unless all exit 0 (the combos print OK and 0 failed), or if qwen2-7b's
    steps miss ``decode_gates`` or ``train_gate`` (its plain and its FL
    train step), or xlstm-125m's train step ``train_gate``."""
    runs, procs = started["runs"], started["procs"]
    outs = {}
    try:
        for what, proc in procs.items():
            outs[what] = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        stop_dryruns(started)
    for what, (out, err) in outs.items():
        for line in out.splitlines():
            if line.strip():
                log(f"  {line}")
        if procs[what].returncode != 0:
            raise AssertionError(f"dry run {runs[what]} exited "
                                 f"{procs[what].returncode}: {err[-3000:]}")
    for what in ("combo", "train", "fltrain", "xtrain"):
        if "OK   " not in outs[what][0] \
                or "1 ok, 0 skipped, 0 failed" not in outs[what][0]:
            raise AssertionError(f"the dry run {runs[what]} did not print "
                                 f"OK and 0 failed")
    decode_gates(outs["decode"][0])
    train_gate(outs["train"][0])
    train_gate(outs["fltrain"][0])
    train_gate(outs["xtrain"][0], "xlstm-125m")
    log(f"  qwen2-7b on 16 x 16: decode_32k peak <= {DECODE_PEAK_GIB} GiB "
        f"with no all-gather of a cache and {DECODE_ROWS} cache rows a "
        f"chip; train_4k peak < {TRAIN_PEAK_GIB} GiB, its FL step's too; "
        f"xlstm-125m train_4k finished, peak < {TRAIN_PEAK_GIB} GiB")
    log(f"  the six dry runs done {time.perf_counter() - started['t0']:.1f}"
        f" s after their start (wall, run together)")


# ---------------------------------------------------------------------------
# Phase 22: the example entry points
# ---------------------------------------------------------------------------

EXAMPLE_TIMEOUT = 300
# the reference script's --metrics-out keys (examples/fleet_sim.py's doc)
FLEET_METRIC_KEYS = {"task", "kernel", "mode", "clients", "rounds",
                     "host_seconds", "losses", "accuracy", "wall_clock_s",
                     "mean_prune", "bound_final"}
# what each entry point prints last, or near it
EXAMPLE_MARKERS = {
    "quickstart": "Theorem 1 bound after S=200",
    "tradeoff_playground": "sumB_MHz",
    "train_federated": "Theorem-1 bound:",
    "fleet_sim": "Theorem-1 bound on realized averages",
    "pruned_llm_federated": "done; final loss",
    "serve_pruned": "block-sparse tokens == dense tokens"}

# An entry point's main() as ``python -m repro_torch.examples.<name>``
# calls it (its arguments in sys.argv), then its returned summary, the
# kernels' launch counts and the card's peak memory as JSON
EXAMPLE_RUNNER = r"""
import importlib, json, sys
out, name = sys.argv[1:3]
sys.argv = ["repro_torch.examples." + name] + sys.argv[3:]
summary = importlib.import_module("repro_torch.examples." + name).main()
import torch
from repro_torch.kernels import (block_norms, block_sparse_matmul,
                                 decode_attention, flash_prefill, fleet_fused)
counts = {"fleet_fused_grads": fleet_fused.fused_fleet_grads.launches,
          "tile_norms": block_norms.tile_norms.launches,
          "block_sparse_matmul": block_sparse_matmul.block_sparse_matmul.launches,
          "block_sparse_matmul_t":
              block_sparse_matmul.block_sparse_matmul_t.launches,
          "decode_attention": decode_attention.decode_attention.launches,
          "flash_prefill": flash_prefill.flash_prefill.launches}
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() \
    else 0
with open(out, "w") as f:
    json.dump({"summary": summary, "counts": counts, "cuda_peak": peak}, f)
"""


def example_runs(tmp: str) -> dict:
    """Phase 22's runs: {label: (module, arguments)}."""
    return {
        "tradeoff": ("tradeoff_playground",
                     ["--sweep", "lambda", "--seeds", "2"]),
        "quickstart": ("quickstart", []),
        "quickstart_cpu": ("quickstart", ["--device", "cpu"]),
        "train": ("train_federated", ["--rounds", "4"]),
        "fleet_fused": ("fleet_sim", ["--kernel", "fused", "--rounds", "5"]),
        "fleet_async": ("fleet_sim", ["--smoke", "--async"]),
        "fleet_lm": ("fleet_sim", [
            "--task", "transformer", "--smoke",
            "--metrics-out", f"{tmp}/metrics.json",
            "--telemetry-out", f"{tmp}/telemetry.jsonl",
            "--trace-out", f"{tmp}/trace.json"]),
        "pruned_llm": ("pruned_llm_federated", ["--rounds", "3"]),
        "serve": ("serve_pruned", ["--rounds", "2", "--steps", "16",
                                   "--out", f"{tmp}/bundle.npz"]),
    }


def check_example_files(tmp: str, rounds: int) -> None:
    """The transformer smoke's files: the metrics JSON with exactly the
    reference script's keys and ``rounds`` losses, a header and a record
    a round in the JSONL telemetry, and the trace's three run spans."""
    with open(f"{tmp}/metrics.json") as f:
        doc = json.load(f)
    if set(doc) != FLEET_METRIC_KEYS or len(doc["losses"]) != rounds:
        raise AssertionError(f"--metrics-out: keys {sorted(doc)}, "
                             f"{len(doc.get('losses', []))} losses")
    with open(f"{tmp}/telemetry.jsonl") as f:
        records = [json.loads(line) for line in f if line.strip()]
    if len(records) != rounds + 1:
        raise AssertionError(f"--telemetry-out: {len(records)} records, "
                             f"not {rounds + 1}")
    with open(f"{tmp}/trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    if not {"fleet.build", "fleet.simulate", "fleet.finalize"} <= names:
        raise AssertionError(f"--trace-out: spans {sorted(names)}")
    log(f"  the files parse: metrics {len(doc)} keys (the reference's) and "
        f"{rounds} losses, telemetry {len(records)} records, trace spans "
        f"{sorted(names & ANNOTATIONS)}")


def run_examples(card: str) -> dict:
    """22: the six entry points of ``repro_torch.examples`` in processes
    of their own, started together (``PYTHONPATH=src``, each with a
    timeout): ``python -m repro_torch.examples.tradeoff_playground``
    itself, the others' ``main`` through ``EXAMPLE_RUNNER``.  Every run
    exits 0 and prints its summary; every run but the tradeoff table and
    the CPU quickstart uses the card (its peak memory above 0);
    quickstart's Algorithm-1 rho and B on the card equal its ``--device
    cpu`` run's bit for bit (host float64); the fused fleet launches the
    fused-gradient and tile-norm kernels, ``serve_pruned`` decode
    attention (its ``generate`` feeds prompts through decode steps, so
    no flash prefill) and prints equal gather and dense tokens; the
    transformer smoke's files parse.  Returns
    {label: launch counts}."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        runs = example_runs(tmp)
        procs = {}
        for label, (name, args) in runs.items():
            argv = ["-m", f"repro_torch.examples.{name}"] \
                if label == "tradeoff" else \
                ["-c", EXAMPLE_RUNNER, f"{tmp}/{label}.json", name]
            procs[label] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, *argv, *args], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT)))
        outs = {}
        try:
            for label, (start, proc) in procs.items():
                so, se = proc.communicate(timeout=EXAMPLE_TIMEOUT)
                outs[label] = (proc.returncode, so, se,
                               time.perf_counter() - start)
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        results = {}
        for label, (rc, so, se, wall) in outs.items():
            name, args = runs[label]
            log(f"  {name} {' '.join(args)}: exit {rc}, {wall:.1f} s "
                f"(with start-up)")
            for line in so.splitlines():
                if line.strip():
                    log(f"    {line}")
            if rc != 0:
                raise AssertionError(f"{name} {args} exited {rc}: "
                                     f"{se[-3000:]}")
            if EXAMPLE_MARKERS[name] not in so:
                raise AssertionError(f"{name} {args} printed no summary")
            if label != "tradeoff":
                with open(f"{tmp}/{label}.json") as f:
                    results[label] = json.load(f)
        check_example_files(tmp, 10)
    for label, res in results.items():
        on_card = label != "quickstart_cpu"
        if (res["cuda_peak"] > 0) != on_card:
            raise AssertionError(f"{label}: card peak {res['cuda_peak']} "
                                 f"bytes")
    q, q_cpu = results["quickstart"]["summary"], \
        results["quickstart_cpu"]["summary"]
    for key in ("prune", "bandwidth"):
        if q[key] != q_cpu[key]:
            raise AssertionError(f"quickstart {key}: card {q[key]} != "
                                 f"CPU {q_cpu[key]}")
    counts = {label: res["counts"] for label, res in results.items()}
    fused, serve = counts["fleet_fused"], counts["serve"]
    if not (fused["fleet_fused_grads"] > 0 and fused["tile_norms"] > 0):
        raise AssertionError(f"fleet_sim --kernel fused launched {fused}")
    # serve_pruned decodes its prompts token by token (ServeEngine.
    # generate, as the reference script does): no prefill wave, so flash
    # prefill is not on its path
    if not serve["decode_attention"] > 0:
        raise AssertionError(f"serve_pruned launched {serve}")
    if results["serve"]["summary"]["tokens"]["gather"] != \
            results["serve"]["summary"]["tokens"]["dense"]:
        raise AssertionError("serve_pruned: gather tokens != dense tokens")
    log(f"  quickstart: rho and B on the card bitwise its --device cpu "
        f"run's ({q['prune']}, {q['bandwidth']})")
    for label in ("fleet_fused", "fleet_async", "fleet_lm", "pruned_llm",
                  "serve"):
        log(f"  {label} launches {counts[label]}")
    log(f"  the nine runs done {time.perf_counter() - t0:.1f} s after "
        f"their start (wall, run together) [{card}]")
    return counts


def main(argv: list) -> int:
    """No arguments: every phase, on one card.  ``--phase19b``: the
    device line, the tile-norm kernel's build and phase 19b alone (the
    four-card run); ``--phase20b`` likewise with both fleet kernels and
    phase 20b, and ``--phase20a`` with phase 20a (one card);
    ``--phase21``: the device line and the dry runs (21b); ``--phase22``:
    the device line, every kernel's build and the entry points (22)."""
    import torch
    only = argv[0] if argv in (["--phase19b"], ["--phase20a"],
                               ["--phase20b"], ["--phase21"],
                               ["--phase22"]) else None
    if argv and only is None:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    phase("[1] device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device count {torch.cuda.device_count()}")

    if only == "--phase21":
        phase("[21b] the dry runs")
        finish_dryruns(start_dryruns())
        return 0

    phase("[2] build")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    names = {"--phase19b": ("block_norms",), None: build.SOURCES,
             "--phase22": build.SOURCES}.get(
        only, ("block_norms", "fleet_fused"))
    reports = build.build(names)
    for name in names:
        build.load(name)
    log(f"  built {', '.join(names)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    if only == "--phase19b":
        phase("[19b] qwen2-7b at full width over four cards")
        run_tp_full(card)
        return 0
    if only == "--phase20a":
        phase("[20a] the fleet engine on a (2, 2) mesh, four ranks sharing "
              "the card")
        run_fleet_mesh_smoke(card)
        return 0
    if only == "--phase20b":
        phase("[20b] the fleet engine on a (2, 2) mesh over four cards, a "
              "million clients")
        run_fleet_mesh_full(card)
        return 0
    if only == "--phase22":
        phase("[22] the example entry points")
        run_examples(card)
        return 0

    phase("[3] kernels against their plain versions")
    warm_profiler()
    from repro_torch.fleet import build_simulation
    probe = build_simulation(slice_config(rounds=1))
    rows = [check_fused(probe.params, probe.data.cached, card),
            check_tile_norms(probe.params, card)]
    del probe
    serve_rows = [check_matmul(card, transpose=False),
                  check_matmul(card, transpose=True),
                  check_decode(card), check_prefill(card)]
    torch.cuda.empty_cache()
    scan_rows = check_scans(card)

    phase("[4] main path")
    _, counts, main = run_main_path(card)
    for row in rows:
        row["launches"] = counts[row["name"]]

    phase("[5] whole paths, card against CPU")
    moe_fleet = card_vs_cpu_paths(card)
    rows[1]["moe_fleet_launches"] = moe_fleet["tile_norms"]

    phase("[6] serve smollm-135m")
    serve_counts = run_serve(card)
    for row in serve_rows:
        row["launches"] = serve_counts[row["name"]]
    rows[1]["bundle_launches"] = serve_counts["tile_norms"]
    torch.cuda.empty_cache()

    phase("[7] partial participation: the cohort path")
    cohort = run_cohort(card, main)
    phase("[8] async events")
    asynced = run_async(card)
    phase("[9] the reference kernel")
    reference, reference_block = run_reference(card, main)
    phase("[10] hex cells: interference, mobility, handover")
    hexed = run_hex(card)
    phase("[11] two-tier aggregation")
    tier, tier_async = run_two_tier(card, main)
    phase("[12] client data: streaming and Dirichlet labels")
    streamed, dirichlet = run_data(card)
    phase("[13] telemetry at the slice")
    telemetry = run_telemetry(card, main)
    phase("[14] the host reference path")
    host = run_host_reference(card)
    phase("[15] the generic gradient path: linreg, smollm-135m trained by the "
        "fleet, and served")
    linreg = run_linreg(card)
    lm, lm_result = run_lm(card)
    exported = run_exported(card, lm_result)
    for row in rows:
        row["cohort_launches"] = cohort[row["name"]]
        row["async_launches"] = asynced[row["name"]]
        row["reference_launches"] = reference[row["name"]]
        row["reference_block_launches"] = reference_block[row["name"]]
        row["hex_launches"] = hexed[row["name"]]
        row["two_tier_launches"] = tier[row["name"]]
        row["two_tier_async_launches"] = tier_async[row["name"]]
        row["streaming_launches"] = streamed[row["name"]]
        row["dirichlet_launches"] = dirichlet[row["name"]]
        row["telemetry_launches"] = telemetry["counts"][row["name"]]
        row["host_reference_launches"] = host["host_counts"][row["name"]]
        row["linreg_launches"] = linreg[row["name"]]
        row["transformer_launches"] = lm[row["name"]]
    rows[1]["fl_run_launches"] = host["fl_norms"]
    for row in serve_rows:
        row["exported_serve_launches"] = exported[row["name"]]
    rows[1]["exported_serve_launches"] = exported["tile_norms"]

    phase("[16] dense decode, the llama configs served, MoE")
    p16 = run_phase16(card)
    for row in serve_rows:
        row["served_launches"] = p16["served"][row["name"]]
        row["gather_launches"] = p16["gather"]["gather"][row["name"]]
        row["gather_kernel_launches"] = p16["gather"]["kernel"][row["name"]]
    rows[1]["served_launches"] = p16["served"]["tile_norms"]

    phase("[17] the recurrent, MLA and memory models at full width")
    (p17, xlstm), scan_launches = run_phase17(card,
                                              rows[1]["launch_floor_ms"])
    rows[1]["xlstm_fleet_launches"] = p17["tile_norms"]
    for row in scan_rows:
        row["launches"] = scan_launches[row["name"]]
        row["fleet_launches"] = p17["scans"][row["name"]]
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                 xlstm["max_abs_err"])
    rows[1].update({f"xlstm_{k}": v for k, v in xlstm.items()
                    if k != "max_abs_err"})

    phase("[18] the training launcher and the mesh trainer")
    p18 = run_phase18(card, rows[1]["launch_floor_ms"])
    rows[1]["train_cli_fl_launches"] = p18["cli"]
    rows[1]["fl_step_launches"] = p18["fl"]
    rows[1]["fl_two_rank_launches"] = p18["two"]
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                 p18["regime"]["max_abs_err"],
                                 p18["smoke_err"])
    rows[1].update({f"fl_block16_{k}": v for k, v in p18["regime"].items()
                    if k != "max_abs_err"})

    phase("[19] the FL step with each client's weights sharded over model")
    phase("  [19a] four ranks sharing the card, qwen2-7b's smoke width")
    tp_launches, tp_regime = run_tp_smoke(card, rows[1]["launch_floor_ms"])
    rows[1]["tp_shard_launches"] = tp_launches
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                 tp_regime["max_abs_err"])
    rows[1].update({f"tp_shard_{k}": v for k, v in tp_regime.items()
                    if k != "max_abs_err"})
    phase("  [19b] qwen2-7b at full width over four cards")
    run_tp_full(card)

    phase("[20] the fleet engine on a (cells, data) mesh")
    # 21b's dry runs need no card: they run beside phase 20
    dryruns = start_dryruns()
    try:
        phase("  [20a] four ranks sharing the card, the slice")
        mesh_launches = run_fleet_mesh_smoke(card)
        for row in rows:
            row["fleet_mesh_launches"] = mesh_launches[row["name"]]
        phase("  [20b] a million clients over four cards")
        run_fleet_mesh_full(card)
        rows += serve_rows + scan_rows

        phase("[21] the dry run and the roofline")
        phase("  [21a] 18b's host step as a roofline share")
        host_roofline_share(p18["host_ms"], card)
        phase("  [21b] the dry runs, on a fake group (started with phase 20)")
        finish_dryruns(dryruns)
    finally:
        stop_dryruns(dryruns)

    phase("[22] the example entry points")
    examples = run_examples(card)
    for row in rows[:2]:
        row["examples_launches"] = examples["fleet_fused"][row["name"]]
    for row in serve_rows:
        row["examples_launches"] = examples["serve"][row["name"]]

    phase("[end]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--fleet-mesh-rank"]:
        sys.exit(fleet_mesh_rank(sys.argv[2], json.loads(sys.argv[3])))
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:  # any failed phase: report and exit non-zero
        traceback.print_exc()
        sys.exit(1)
