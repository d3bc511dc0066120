#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PlantD on one GPU: the what-if year
grid (registered policies included), the serving pipeline-under-test
(Jamba-1.5, rwkv6-7b, with RoPE
and experts llama3.2-1b, moonshot-v1-16b-a3b and phi3.5-moe, and with
the flash kernel at every head dim stablelm-3b, gemma-7b, minicpm3-4b's
MLA, qwen2-vl-7b and whisper-small's encoder-decoder), the
wind tunnel that measures a pipeline, fits its twin and forecasts its
year, the gradient calibration of twins from what it measured, and the
policy search that answers the what-if questions inversely, the
training side, and the multi-GPU layer over ``torch.distributed``.

    python3 chip_smoke.py

Builds the kernels from ``src/repro_torch/kernels/csrc`` with nvcc (one
process per source, all started together: the policy scans, benign and
fault; flash attention, bf16 and float32; the Mamba selective scan; the
RWKV-6 WKV recurrence, chunked and per step; and the policy scans again
with phase 11's registered policies translated into them), then:

1. prints the card (``nvidia-smi`` name and power limit) and the build,
   and checks the machine code (``cuobjdump -sass``): HGMMA and TMA loads
   in each of the 36 bf16 flash kernels (q/k and v storage dims 16-256),
   no local memory in those of d = 256, HMMA and cp.async in each of the
   6 float32 ones (dv storage dims 16-256), no local memory at dv 256,
   HGMMA and TMA loads in each of the 4 bf16 wide ones (head dims past
   256: ``flash_wide_wgmma_kernel``, a warpgroup's v columns 64-256) and
   HMMA in each of the 4 float32 ones (``flash_wide_f32_kernel``), no
   local memory in any of the 8,
   HMMA and cp.async in the WKV library, the MUFU's
   exp2 and cp.async in the selective-scan library, cp.async and no
   float32 division check in the series policy scans (1b);
2. holds each kernel against its plain PyTorch version on the card,
   bitwise: mixed-policy random blocks (foreign parameters in every slot,
   dt 1 and 1/60, N not a multiple of 32, both SLO modes) and the Table II
   inputs (2a, 2b); the fault kernels on random blocks with outage runs,
   brownouts and all-ones fault rows (2c);
3. drives the main path, ``run_grid``, on Table II (3 paper twins x
   nominal/+50% traffic, SLO 4 h / 95%) in both modes: equal to the
   port's CPU run, the reference's numbers, and the paper's SLO pattern;
   then What-if #7, the chaos suite of examples/whatif_analysis.py, in
   both modes (3b): equal to the CPU run, with the attribution columns
   and a balanced record ledger;
4. at width: the 4,096-scenario What-if #5 cost-lever sweep in series
   mode, its aggregate twin bitwise on sums, max, queue and SLO shares,
   and the 65,536-distinct-scenario full-year aggregate sweep (256 twins
   x 256 growth forecasts), held against the plain version over the
   whole grid (4a, 4b); a 65,536-row chaos sweep (256 twins x 16
   forecasts x 16 fault futures) held the same way (4c); and a
   4,096-row chaos sweep in series mode against its aggregate twin (4d);
5. the serving slices. Jamba-1.5-Large without experts: the flash
   kernels against their plain version on random blocks (both on the
   tensor cores: float32 in 3xTF32 mma.sync, bf16 in wgmma; causal or
   not, GQA g 1, 4 and 8, head dims 64 and 128 (10a takes the others), sq
   and sk around the 128-row tile and unequal, and for float32 around its
   64-row q tile and 32-key tiles, and the prefill shape; 5a); the selective-scan kernel likewise (s 1,
   37, 63, 64, 65, 256 and 2,048 around its 32-step chunks, n 16, 4 and
   13, di 1000 and 999, a carried-in state left unchanged, runs split at
   steps 1, 37, 64, 65 and 100 against one whole run; 5b); the
   smoke-width model served on the card against the port's
   CPU run (the same greedy tokens, logits within tolerance; 5c).
   rwkv6-7b: the WKV kernels against their plain version on random
   blocks (the per-step kernel at s 1 and 37, the chunked one at s 100,
   256 and 300, head dims 16 and 64, bf16 and float32, a carried-in
   state, runs split at a chunk boundary and inside a chunk against one
   whole run, and a block of strong decays, mean log w -6, where the
   TPU kernel errs; 5e); its smoke-width model on the card against the
   CPU run (5f). Then the serving main paths at full width:
   ``ServeEngine`` with 4 slots serves 8 requests of 1,024-2,048 prompt
   tokens and 32 new tokens each, through Jamba-1.5-Large cut to 8
   layers at d_model 8,192 (5d), and through rwkv6-7b at all 32 layers
   and every width, its memory freed first (5g); after each, a
   ``torch.profiler`` pass over one more prefill and 4 decode steps says
   where their time goes (device busy share, top kernels);
6. the wind tunnel (``repro_torch.core.experiment``): the paper's loop of
   examples/quickstart.py, an experiment over the blocking-write
   telemetry pipeline on the host, its fitted twin and a year's forecast
   through run_grid on the card, both modes bitwise the CPU's (6a); the
   slice's main path, an experiment over 5g's full-size rwkv6-7b engine
   (``ServeEngine.as_pipeline``, priced at an assumed card-hour price)
   under a 20 s ramp to 16 rec/s, with no stage error and drained, its
   fitted twin and a year of request traffic forecast on the card, both
   modes bitwise the CPU's, its kernels' counts read from 0 (6b); and 4b's
   sweep again inside ``obs.capture()``, bitwise 4b's rows, with the
   ``grid.*`` spans' share of its wall (6c). Each model kernel is then
   held against its plain version at the shapes the serving paths gave
   it;
7. the calibration slice (``repro_torch.calibrate``) on the card: the
   fit's loss and gradient against the port on the CPU for every policy
   and through the fault layer, and the device memory of one streamed
   fit step over a year of hourly bins (7a); shed's parameters recovered
   from a 6 h ramp replay, with the fit's wall, steps/s, and launches
   and busy share per step under ``torch.profiler`` (7b); 6b's measured
   experiment fitted into fifo and shed twins at 1 s bins and played
   through Table II by ``calibrated_grid``, its rows out of the
   aggregate kernel bitwise the CPU's (7c); 6a's experiment under
   ``obs.capture()``, its ``stage.*`` spans exported as OTel dicts,
   binned into a trace and fitted, with the ``calibrate.fit`` span and
   counters (7d); a ``{"calibrate": ...}`` line of phase 7's numbers.
   ``python3 chip_smoke.py --phase 7`` runs the build and phase 7 alone,
   6a's experiment standing in for 6b's;
8. policy search (``repro_torch.search``) on the card: What-if #6 through
   ``optimize_scenario`` at the example's size (a 2,184-bin gradient
   loop, the exact re-checks at 8,736 hourly bins through the aggregate
   kernel), feasible, below the base and within 1% of the reference's
   winner, against the same call on the CPU, the winner's rows bitwise
   the CPU's and its series-mode p95/p99 within a histogram bucket; the
   4,096-point grid of the same space through ``run_grid``, its best
   feasible row the reference's (8a); the What-if #6b frontier, all
   targets in one gradient loop, non-increasing (8b); What-if #7's
   chance-constrained search through the fault aggregate kernel (8c);
   8b and 8c, cut to 728-bin gradient loops, within 1% of the
   reference's answers to the same calls, and 8c of the CPU's;
   the grid's aggregate launch against its plain version, one step's
   operations, launches and busy share under ``torch.profiler`` and a
   full-resolution step's wall; a ``{"search": ...}`` line.
   ``python3 chip_smoke.py --phase 8`` runs the build and phase 8 alone;
9. serving RoPE and MoE: the CLI ``python -m repro_torch.launch.serve``
   on smoke llama3.2, on the card (9a); smoke llama3.2 and smoke
   moonshot (its published capacity factor) at 4 layers, card against
   CPU (9b); then ``ServeEngine`` as in 5d and 5g, from a card that
   holds no earlier engine, through llama3.2-1b whole (9c),
   moonshot-v1-16b-a3b cut to 12 of its 48 layers (whole it is 28.9 B
   parameters, 57.8 GB in bf16; 9d) and phi3.5-moe cut to 8 of its 32
   layers (9e), the flash
   kernel's launches held to 2 a layer, each with its decode step's
   weight-read floor; the flash kernel against its plain version at
   their prefill shapes. ``python3 chip_smoke.py --phase 9`` runs the
   build and phase 9 alone;
10. the flash kernel at every head dim of the configs, MLA, whisper and
   qwen2-vl: both flash kernels against their plain version at (dqk, dv)
   (80, 80), (256, 256), (96, 64) and (24, 16), sq and sk 63-300 around
   the 128-row q tile and d = 256's 64-key tile, GQA g 1 and 7, causal or
   not, and once at eight more pairs of the rule (10a); smoke minicpm3
   through ``ServeEngine``, smoke qwen2-vl with 4 patch embeddings and
   [3, b, s] positions and smoke whisper with frames through
   ``model.prefill`` / ``decode_step``, card against CPU in float32
   (10b); then, from a card that holds no earlier engine, stablelm-3b
   at 16 of its 32 layers (10c), gemma-7b at 14 of 28 (10d), minicpm3-4b
   at 16 of 62 (10e) and qwen2-vl-7b at 14 of 28 (10f, plus
   one prefill with its 256 stub patches) through
   ``ServeEngine`` as in 9c, the flash kernel's launches held to 2 a
   layer; whisper-small whole through ``model.prefill`` /
   ``decode_step`` (10g: 4 rows of 1,500 frames, prompts of 64-224
   tokens, 32 decode steps, 36 flash launches in its prefill; its first
   row's logits held to the port's CPU run); the flash kernel against
   its plain version at each one's prefill shape.
   ``python3 chip_smoke.py --phase 10`` runs the build and phase 10
   alone;
11. registered policies on the card (``register_policy``: ``null``,
   shed overridden, ``capped``, and the integer and bit-level steps of
   C15: ``diurnal``, an int32 hour of day ``% 24`` and a ``sin`` daily
   curve, ``bits``, a mantissa bit view with shifts, masks and floor
   division, and ``bw_copy``, batch_window's own step), their steps
   translated into the policy kernels (``kernels/lane_codegen.py``; the
   library of phase 11's registry is built in phase 1, its ptxas spills
   held to the plain library's in 1b; 11d's, 47 generated branches, on a
   thread of its own beside phases 2-10): ``run_grid`` over 64 full-year
   scenarios of four built-ins and the six, both modes, the registered
   rows bitwise the port's CPU run (diurnal's latency within
   ``DIURNAL_ULPS``), bw_copy's bitwise the built-in batch_window's, and
   the built-in rows bitwise the plain library's run of the built-ins
   alone, the counters showing every registered row ran in the kernel; a
   chaos suite through the fault kernel; a step with an integer divisor
   of 0 raising the CPU's ``RuntimeError: ZeroDivisionError`` on the card
   (11a); every elementwise operation a step may use on edge values
   (NaN, +-inf, +-0, INT_MIN, shifts at and past the width), one bin
   through the series kernel, bitwise the CPU or within its ulps (11d);
   a search over ``capped``'s replicas
   re-checked through the aggregate kernel (11b); a registered step
   with ``exp`` and ``log`` (``softlat``) and one with ``tanh``,
   ``sigmoid``, ``expm1``, ``log1p``, ``softplus`` and a ``pow``
   (``smooth``; their library built in phase 1) over 32 full-year
   scenarios in both modes, one launch each, their latency within
   ``SOFTLAT_ULPS`` and ``SMOOTH_ULPS`` of the CPU run and everything
   else bitwise, the ulps printed (11c, ROADMAP C15); the flash kernels
   at head dims the wrapper pads to a multiple of 8 (4, 20, 100; q/k 96
   with v 20) and past 256 (the wide kernels: (264, 264), (64, 264),
   (320, 320), DeepSeek-V2-Lite's absorbed (576, 512), (1,024, 64); g 1,
   7 and 16) against their plain version, both types, and the wide
   kernels timed at DeepSeek-V2-Lite's absorbed prefill shape against
   their bound, SDPA and their first form (``tools/flash_wide_first.cu``,
   built beside the sources in phase 1) in the same call (C17).
   ``python3 chip_smoke.py --phase 11`` runs the build and phase 11
   alone;
12. training on one card: one ``make_train_step`` step of smoke
   llama3.2 in float32 against the CPU's (loss, gradients, parameters;
   no model kernel in the step, a serving prefill right after launching
   flash; 12a); ``examples/train_telemetry.py``'s ~100M llama through
   ``train`` for 30 steps with a transient fault and a node loss, its
   losses held to an uninterrupted run's (12b); llama3.2-1b at full
   width and depth, 8 x 1,024 tokens a step, remat full, int8 moments,
   6 steps and a final checkpoint restored bitwise, with step ms,
   tokens/s, the share of 989 TFLOP/s, the busy share of a profiled
   step, peak memory and checkpoint seconds (12c); a ``{"train": ...}``
   line. ``python3 chip_smoke.py --phase 12`` runs the build and phase
   12 alone;
13. the multi-GPU layer (ROADMAP A8.1): two ``gloo`` ranks started once
   on the one card (``torch.multiprocessing``; NCCL will not put two
   ranks on one GPU, so this checks correctness and measures no
   scaling): 4b's 65,536-scenario grid with ``devices=2`` at two
   scenario blocks and 4d's fault grid, bitwise their ``devices=None``
   rows, with their ``grid.round`` spans (13a); 7b's fit and a What-if
   #6 search with ``devices=2`` against ``devices=None`` (13b); 12b's
   model in float32 over ``data=2`` against one rank (loss, first gradients, parameters), checkpoints
   moving 2 -> 2, 2 -> 1 and 1 -> 2 ranks bitwise, a ``pod=2`` step
   with int8 gradient compression bitwise its host emulation (13c);
   llama3.2-1b cut to 4 of 16 layers over ``data=2`` (int8 moments,
   remat full), each step's loss against one rank's, step ms and peak
   memory per rank (13d); training over ``model`` (ROADMAP A8.2b): the
   five smoke kinds (GQA, MLA, Mamba, RWKV-6, experts) in float32 over
   (data, model) = (1, 2) with remat full, losses and first gradients
   against one rank's, remat's recomputation on autograd's CUDA thread
   (13e-smoke), then llama3.2-1b at full width cut to 2 layers over
   (1, 2) as ``launch/train.py --model 2`` builds it, both ranks on the
   whole batch, losses against one rank's, step ms, peak memory,
   parameter and moment GiB a rank and the collectives a step stages
   (13e); a ``{"mesh": ...}`` line. ``python3 chip_smoke.py --phase 13`` runs the
   build, 4b and 4d, and phases 13 and 14;
14. serving over a (data, model) mesh (ROADMAP A8.2a), in phase 13's two
   ranks: the six smoke kinds (GQA, MLA, Mamba with experts, RWKV-6,
   whisper with frames, experts with a shared expert) in float32 over
   (1, 2) and (2, 1), a prefill and 3 decode steps against one rank on
   the card (14e; also smoke llama3.2 with 3 query heads
   over 1 KV head and d_ff 129, widths a model axis of 2 divides
   neither: the fall-back, ROADMAP C19, which 13e-smoke trains too);
   then ``ServeEngine(mesh=)`` with bf16 weights drawn
   on the card a leaf at a time into each rank's shards
   (``init_params(placement=)``), 4 of 9c's prompts: llama3.2-1b whole
   over model=2 (14a, max_len 4,096, 16 new tokens), and at max_len
   1,024 with 8 new tokens Jamba cut as 5d (14b) and rwkv6-7b cut to 8
   layers (14c, then again in float32) over model=2, moonshot-v1-16b-a3b
   cut to 8 layers over data=2, 32 experts a rank (14d): each rank's
   leaves of its placement's shard shapes (none that is split held
   whole) and their bytes, its load peak within its shards and
   one whole leaf, the launches a rank, first-token logits against a
   one-rank engine's in rank 0, both ranks' tokens equal; a
   ``{"serve_mesh": ...}`` line; then 14f, a cache split along its
   sequence over model (ROADMAP A8.3, the reference's decode_32k
   layout): smoke GQA and MLA in float32 over (1, 2) against one rank,
   and llama3.2-1b at full width cut to 2 layers in float32 (max_len
   1,024, 8 new tokens), every greedy token and the first-token logits
   held to a one-rank engine's, TTFT, decode ms and the collectives the
   serve issues. ``python3 chip_smoke.py --phase 14`` runs the build and
   phase 14 alone. 14g, in eight gloo ranks of its own
   started beside phases 13-14's two: whisper-small whole in float32 over
   (data, model) = (1, 8), its 12 heads falling back (C19: each rank
   projects 1.5 heads' columns, gathers them whole and runs attention
   over every head), 10g's frames and prompts, 8 new tokens through
   ``model.prefill`` / ``decode_step``, held to one rank's run (every
   greedy token, first-token logits within SERVE_MESH_F32_RTOL); TTFT,
   decode ms, the collectives a rank's serve issues and the float32
   flash launches; a ``{"serve_mesh_14g": ...}`` line.
   ``python3 chip_smoke.py --phase 14g`` runs the build and 14g alone;
15. the dry run (``python -m repro_torch.launch.dryrun``, CPU only, on
   a fake world of 256 ranks, in background processes started before
   phase 11, beside phases 11-12 and 13-14's ranks)
   of llama3.2-1b decode_32k and jamba-1.5-large long_500k in every mode,
   each mode ``ok`` on the torch that runs the script (its private
   fake process group and ``FlopCounterMode``), and their roofline rows
   with the H100's constants (analytic, not measured); a
   ``{"dryrun": ...}`` line. ``python3 chip_smoke.py --phase 15`` runs it alone;
16. prints one JSON line of per-kernel numbers (nine kernels: launches
   on the main paths of phases 3-5, of 6b, of 7, of 8, of 9, of 10, of
   11, of 12, of 13 (13a-13b, both ranks), of 14 (14a-14d, both ranks),
   of 14f (both ranks) and of 14g (its eight ranks); the flash source's
   float32 kernel has a row
   of its own, ``flash_attention_f32``, at 14f's prefill shape on a rank,
   its ``launches`` those of 14f, its main path), error against the
   plain version, kernel / plain / bound / library times (the policy
   kernels' plain versions run while phase 13-14's ranks work, and their
   times share the card and host with them; each kernel is timed
   alone after); no
   kernel may read faster than its bound; the decode launches of
   ``ssm_scan`` and ``rwkv6_scan`` also with their device time, 100
   launches captured in a CUDA graph and replayed, where the wrapper time
   is mostly host work; the policy rows with their kernel's own device
   time from ``torch.profiler``; the flash row with phase 9's and 10's
   shapes, and 14a's, a rank's heads),
   then the card and ``{"ok": true, ...}`` as its last line.

Any failed check raises, and the script exits non-zero. It needs a CUDA
card and the repository's ``src``; it never falls back to the CPU.
"""
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HOURS_PER_YEAR = 8736
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
#: the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: float32 operations per scenario-bin, counted from csrc/policy_scan.cu:
#: each +, -, *, /, min, max, ceil, compare and select is one, an fma two
POLICY_OPS = {0: 10, 1: 8, 2: 27, 3: 15, 4: 22}     # kernel branch ids
AGG_OPS = 101                                       # + 2 in drop-rate mode
#: the fault layer's operations per scenario-bin (bin_step<true>): the
#: gate's compare and select, avail, a_eff, new_fq, max_rps * capmul, the
#: wait's max and division, and the two adds onto queue and latency
FAULT_OPS = 10
#: shed's fault form: the fma and max of the reported drop, and in the
#: aggregate scan the re-derived queue latency prices (a subtract)
FAULT_SHED_OPS = {False: 3, True: 4}                # keyed by aggregate
FAULT_AGG_OPS = 3                                   # A_FLTH, A_FOKH
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), the bound of
#: attention's matrix products
BF16_OPS_PER_S = 989e12
#: H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet), the bound of
#: the chunked WKV kernel's and the float32 flash kernel's products (their
#: 3xTF32 split counted once)
TF32_OPS_PER_S = 495e12
#: the model kernels against their plain versions (atol = rtol over
#: |want|): float32 sums run in another order with contracted
#: multiply-adds; a bf16 output may take the neighbouring bf16 value
#: (one step, 2^-7 relative)
MODEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
#: the smoke-width slice, card against CPU, float32 logits (cuBLAS and
#: the CPU sum the matrix products in other orders, through 16 layers)
SLICE_TOL = 1e-4
JAMBA = "jamba-1.5-large-398b"
RWKV = "rwkv6-7b"
LLAMA = "llama3.2-1b"
MOONSHOT = "moonshot-v1-16b-a3b"
PHI = "phi3.5-moe-42b-a6.6b"

RPS, USD_HR, LAT = 1.9512, 0.0082, 0.15
SEED = 0
#: the price of one H100 card-hour that phase 6b's cost and forecast
#: assume: an assumption for the arithmetic, not a measured or quoted price
ASSUMED_H100_USD_PER_HOUR = 4.0


def check(ok, what):
    """A check that holds under ``python -O`` too (which strips asserts)."""
    if not ok:
        raise AssertionError(what)


def _u32(t):
    return t.detach().contiguous().view(torch.int32)


def assert_bitwise(name, a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    check(a.shape == b.shape, (name, a.shape, b.shape))
    same = _u32(a) == _u32(b)
    if not bool(same.all()):
        bad = (~same).nonzero()[:3].tolist()
        raise AssertionError(f"{name}: {int((~same).sum())} elements differ "
                             f"bitwise, first at {bad}")


def max_abs_err(pairs):
    return max(float((a.double() - b.double()).abs().max()) if a.numel()
               else 0.0 for a, b in pairs)


def cuda_ms(fn, reps=1):
    """Device time of ``fn()`` by CUDA events, averaged over ``reps``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def kernel_device_ms(fn, marker, reps=5):
    """Device time of the one kernel whose name holds ``marker`` in a
    call of ``fn()``: the mean of its kernel records in ``torch.profiler``
    (CUPTI) over ``reps`` calls after a warm-up, with no host work and
    none of the wrapper's other launches in it (the profiler may drop a
    record; the mean is over those it kept). A policy wrapper reads its
    operand checks back to the host before its launch, which a CUDA graph
    capture forbids, so ``graph_ms`` cannot time it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and marker in e.key]
    check(len(hits) == 1 and 1 <= hits[0].count <= reps,
          (marker, [(e.key, e.count) for e in hits]))
    return hits[0].self_device_time_total / hits[0].count / 1e3


def graph_ms(fn, launches=100):
    """Device time of one ``fn()`` with no host work between launches:
    ``launches`` calls captured in one CUDA graph, the graph replayed
    (CUDA events over 3 replays after a warm-up), per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                            # allocations before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    ms, _ = cuda_ms(graph.replay, reps=3)
    del graph
    return ms / launches


def paper_twins(make):
    return [make.SimpleTwin("blocking-write", 1.9512, 0.0082, 0.15),
            make.SimpleTwin("no-blocking-write", 6.15, 0.0703, 0.06),
            make.SimpleTwin("cpu-limited", 0.6612, 0.0027, 0.29)]


def whatif5_twins(twin):
    """The 256 cost-lever twins of What-if #5 (examples/whatif_analysis.py):
    64 autoscale delay x cap, 64 shed queue caps, 64 batch windows x idle
    fractions, 64 alternating fifo/quickscale capacity points."""
    out = []
    for cap in (2, 4, 8, 16, 24, 32, 48, 64):
        for delay in (0.5, 1, 2, 3, 4, 6, 9, 12):
            out.append(twin.make_twin(
                f"auto-c{cap}-d{delay:g}", "autoscale", max_rps=RPS,
                usd_per_hour=USD_HR, base_latency_s=LAT, max_instances=cap,
                scale_up_hours=delay))
    for q in np.geomspace(0.25, 96.0, 64):
        out.append(twin.make_twin(f"shed-q{q:.2f}", "shed", max_rps=RPS,
                                  usd_per_hour=USD_HR, base_latency_s=LAT,
                                  queue_cap_hours=float(q)))
    for w in np.geomspace(0.5, 24.0, 16):
        for f in (0.05, 0.1, 0.2, 0.4):
            out.append(twin.make_twin(
                f"batch-w{w:.1f}-f{f}", "batch_window", max_rps=RPS,
                usd_per_hour=USD_HR, base_latency_s=LAT,
                window_hours=float(w), idle_cost_fraction=f))
    for i, r in enumerate(np.geomspace(0.5, 16.0, 64)):
        policy = "fifo" if i % 2 else "quickscale"
        out.append(twin.make_twin(f"{policy}-r{r:.2f}", policy,
                                  max_rps=RPS * float(r),
                                  usd_per_hour=USD_HR * float(r),
                                  base_latency_s=LAT))
    return out


def grid_operands(twins, traffics, dev):
    """The kernels' operands for the run_grid (traffic x twin) grid."""
    from repro_torch.core.twin import policy_onehot
    matrix = np.stack([tr.hourly_loads() for tr in traffics]).astype(
        np.float32)
    idx = np.repeat(np.arange(len(traffics), dtype=np.int32), len(twins))
    params = np.tile(np.stack([tw.padded_params() for tw in twins]),
                     (len(traffics), 1))
    pol = np.tile([tw.policy_index for tw in twins], len(traffics))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return {"loads_t": put(matrix.T), "load_index": put(idx),
            "params": put(params), "onehot": put(policy_onehot(pol)),
            "branch": pol, "t_bins": matrix.shape[1], "k_rows": len(matrix)}


def chaos_operands(twins, traffics, schedule, dev):
    """The kernels' operands for run_grid(twins, traffics,
    faults=schedule): the expanded (traffic x twin x future) grid, its
    [T, F] fault rows and fault index."""
    from repro_torch.core.twin import policy_onehot
    from repro_torch.faults import expand_grid, sample_futures
    matrix = np.stack([tr.hourly_loads() for tr in traffics]).astype(
        np.float32)
    idx = np.repeat(np.arange(len(traffics), dtype=np.int32), len(twins))
    fg = expand_grid(sample_futures(schedule, matrix.shape[1]), matrix, idx)
    nf = fg.n_futures
    params = np.repeat(np.tile(np.stack([tw.padded_params() for tw in twins]),
                               (len(traffics), 1)), nf, axis=0)
    pol = np.repeat(np.tile([tw.policy_index for tw in twins],
                            len(traffics)), nf)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return {"loads_t": put(fg.load_matrix.T), "load_index": put(fg.load_index),
            "params": put(params), "onehot": put(policy_onehot(pol)),
            "caps_t": put(fg.cap.T), "fmask_t": put(fg.fmask.T),
            "fault_index": put(fg.fault_index), "branch": pol,
            "t_bins": matrix.shape[1], "k_rows": len(fg.load_matrix),
            "f_rows": nf}


def plain_loads(ops):
    return ops["loads_t"][:, ops["load_index"].long()].t().contiguous()


def plain_rows(ops, key):
    return ops[key][:, ops["fault_index"].long()].t().contiguous()


def bound(ops, agg, slo_mode=0):
    """(bound_ms, bound_by) of one launch: bytes each input read once and
    each output written once, over HBM; float32 operations over peak.
    Operands with ``caps_t`` count the fault layer and its rows."""
    from repro_torch.core.twin import AGG_DIM, CARRY_DIM, PARAM_DIM
    n, t, k = len(ops["branch"]), ops["t_bins"], ops["k_rows"]
    p = ops["onehot"].shape[1]
    fault = "caps_t" in ops
    nbytes = 4 * (t * k + n * (1 + PARAM_DIM + p + CARRY_DIM))
    nbytes += 4 * n * (AGG_DIM if agg else 5 * t)
    per_bin = sum(POLICY_OPS[int(b)] for b in ops["branch"])
    if agg:
        per_bin += n * (AGG_OPS + (2 if slo_mode else 0))
    if fault:
        nbytes += 4 * (n + t * ops["f_rows"] * (2 if agg else 1))
        per_bin += n * (FAULT_OPS + (FAULT_AGG_OPS if agg else 0))
        per_bin += FAULT_SHED_OPS[agg] * int((ops["branch"] == 3).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, per_bin * t / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


def check_random_blocks(dev):
    """Phase 2a: kernels vs plain on mixed-policy random blocks."""
    from repro_torch.kernels import policy_scan as pk, ref
    rng = np.random.default_rng(SEED)
    n, t, k = 1000, 336, 37
    loads_t = torch.from_numpy(
        rng.uniform(0.0, 2e4, (t, k)).astype(np.float32)).to(dev)
    lidx = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(dev)
    # every slot random: each lane carries foreign parameters for the
    # policies it does not run
    params = torch.from_numpy(
        rng.uniform(0.05, 8.0, (n, 6)).astype(np.float32)).to(dev)
    pol = rng.integers(0, 5, n)
    onehot = np.eye(5, dtype=np.float32)[pol]
    onehot[rng.choice(n, 7, replace=False)] = 0.0   # all-zero mask rows
    onehot = torch.from_numpy(onehot).to(dev)
    loads = loads_t[:, lidx.long()].t().contiguous()
    for dt in (1.0, 1.0 / 60.0):
        c_k, s_k = pk.policy_grid_scan(None, params, onehot, dt,
                                       loads_t=loads_t, load_index=lidx)
        c_p, s_p = ref.policy_grid_scan(loads, params, onehot, dt)
        assert_bitwise(f"scan carry dt={dt:.4g}", c_k, c_p)
        for j, (a, b) in enumerate(zip(s_k, s_p)):
            assert_bitwise(f"scan series {j} dt={dt:.4g}", a, b)
        for lim, mode in ((4 * 3600.0, 0), (0.01, 1)):
            c_k, a_k = pk.policy_grid_agg(None, params, onehot, dt,
                                          slo_limit=lim, slo_mode=mode,
                                          loads_t=loads_t, load_index=lidx)
            c_p, a_p = ref.policy_grid_agg(loads, params, onehot, dt,
                                           slo_limit=lim, slo_mode=mode)
            assert_bitwise(f"agg carry dt={dt:.4g} mode={mode}", c_k, c_p)
            assert_bitwise(f"agg rows dt={dt:.4g} mode={mode}", a_k, a_p)
    torch.cuda.synchronize()
    print(f"phase 2a: random blocks N={n} T={t} K={k}, dt 1 and 1/60, "
          f"both SLO modes: kernels == plain bitwise")


def check_table2_kernels(dev, tr, twin_mod):
    """Phase 2b: kernels vs plain on the Table II inputs."""
    from repro_torch.kernels import policy_scan as pk, ref
    nominal = tr.TrafficModel.honda_default("nominal", R=3.5, G=1.0)
    high = tr.TrafficModel.honda_default("high(+50%)", R=3.5, G=1.5)
    ops = grid_operands(paper_twins(twin_mod), [nominal, high], dev)
    loads = plain_loads(ops)
    c_k, s_k = pk.policy_grid_scan(None, ops["params"], ops["onehot"],
                                   loads_t=ops["loads_t"],
                                   load_index=ops["load_index"])
    c_p, s_p = ref.policy_grid_scan(loads, ops["params"], ops["onehot"])
    assert_bitwise("table2 scan carry", c_k, c_p)
    for j, (a, b) in enumerate(zip(s_k, s_p)):
        assert_bitwise(f"table2 scan series {j}", a, b)
    c_k, a_k = pk.policy_grid_agg(None, ops["params"], ops["onehot"],
                                  slo_limit=4 * 3600.0,
                                  loads_t=ops["loads_t"],
                                  load_index=ops["load_index"])
    c_p, a_p = ref.policy_grid_agg(loads, ops["params"], ops["onehot"],
                                   slo_limit=4 * 3600.0)
    assert_bitwise("table2 agg carry", c_k, c_p)
    assert_bitwise("table2 agg rows", a_k, a_p)
    print("phase 2b: Table II inputs (6 x 8736): kernels == plain bitwise")


def check_fault_random_blocks(dev):
    """Phase 2c: the fault kernels vs plain on mixed-policy random blocks
    read through F fault rows: outage runs (the backlog builds and floods
    back), brownout fractions, an all-ones row and a masked window at
    full capacity."""
    from repro_torch.kernels import ops, policy_scan as pk, ref
    rng = np.random.default_rng(SEED + 1)
    n, t, k, f = 1000, 336, 37, 5
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    loads_t = put(rng.uniform(0.0, 2e4, (t, k)).astype(np.float32))
    lidx = put(rng.integers(0, k, n).astype(np.int32))
    params = put(rng.uniform(0.05, 8.0, (n, 6)).astype(np.float32))
    pol = rng.integers(0, 5, n)
    onehot = np.eye(5, dtype=np.float32)[pol]
    onehot[rng.choice(n, 7, replace=False)] = 0.0   # all-zero mask rows
    onehot = put(onehot)
    cap = np.ones((f, t), np.float32)
    for row in range(1, f):
        for start in rng.integers(0, t - 24, 8):
            cap[row, start:start + rng.integers(2, 24)] = 0.0
        brown = rng.uniform(0.0, 1.0, t) < 0.2
        cap[row, brown] *= rng.uniform(0.2, 0.9, int(brown.sum()))
    fmask = (cap != 1.0).astype(np.float32)
    fmask[1, 300:310] = 1.0
    caps_t, fmask_t = put(cap.T), put(fmask.T)
    fidx = put(rng.integers(0, f, n).astype(np.int32))
    loads = loads_t[:, lidx.long()].t().contiguous()
    caps, fm = caps_t[:, fidx.long()].t(), fmask_t[:, fidx.long()].t()
    fault = dict(loads_t=loads_t, load_index=lidx, caps_t=caps_t,
                 fault_index=fidx)
    for dt in (1.0, 1.0 / 60.0):
        c_k, s_k = pk.policy_grid_scan(None, params, onehot, dt, **fault)
        c_p, s_p = ref.policy_grid_scan(loads, params, onehot, dt,
                                        caps=caps)
        assert_bitwise(f"fault scan carry dt={dt:.4g}", c_k, c_p)
        for j, (a, b) in enumerate(zip(s_k, s_p)):
            assert_bitwise(f"fault scan series {j} dt={dt:.4g}", a, b)
        for lim, mode in ((4 * 3600.0, 0), (0.01, 1)):
            c_k, a_k = pk.policy_grid_agg(None, params, onehot, dt,
                                          slo_limit=lim, slo_mode=mode,
                                          fmask_t=fmask_t, **fault)
            c_p, a_p = ref.policy_grid_agg(loads, params, onehot, dt,
                                           slo_limit=lim, slo_mode=mode,
                                           caps=caps, fmask=fm)
            assert_bitwise(f"fault agg carry dt={dt:.4g} mode={mode}", c_k,
                           c_p)
            assert_bitwise(f"fault agg rows dt={dt:.4g} mode={mode}", a_k,
                           a_p)
    check(bool((s_k[1] > 0).any() and (s_k[4] > 0).any()),
          "no fault backlog or no shedding in the blocks")
    # a uniform shed block through ops: the kernel at the uniform scans'
    # rounding (core.twin.SHED_FUSE_ALL)
    p_shed = params[:200].contiguous()
    uni = dict(loads_t=loads_t, load_index=lidx[:200].contiguous(),
               caps_t=caps_t, fault_index=fidx[:200].contiguous())
    c_k, s_k = ops.policy_scan(None, p_shed, policy_index=3, **uni)
    c_p, s_p = ref.policy_grid_scan(loads[:200], p_shed, policy_index=3,
                                    caps=caps[:200])
    assert_bitwise("uniform shed fault carry", c_k, c_p)
    for j, (a, b) in enumerate(zip(s_k, s_p)):
        assert_bitwise(f"uniform shed fault series {j}", a, b)
    torch.cuda.synchronize()
    print(f"phase 2c: fault kernels on random blocks N={n} T={t} K={k} "
          f"F={f}, dt 1 and 1/60, both SLO modes, and a uniform shed "
          f"block: kernels == plain bitwise")


#: the reference's Table II numbers (JAX package, this repository)
TABLE2_ANCHORS = {
    ("nominal no-blocking-write", "cost_usd"): 614.14,
    ("nominal blocking-write", "cost_usd"): 71.64,
    ("high(+50%) blocking-write", "cost_usd"): 72.13,
    ("high(+50%) blocking-write", "latency_backlog_s"): 218920.44,
    ("high(+50%) cpu-limited", "cost_usd"): 62.52,
}
SLO_MET = {"nominal blocking-write", "nominal no-blocking-write",
           "high(+50%) no-blocking-write"}


def same_results(a, b, what):
    """Field-for-field equality of two result lists (floats and arrays
    bitwise; the twin compared by value)."""
    check(len(a) == len(b), what)
    for x, y in zip(a, b):
        for f in x.__dataclass_fields__:
            u, v = getattr(x, f), getattr(y, f)
            if isinstance(u, np.ndarray):
                ok = u.dtype == v.dtype and np.array_equal(
                    u.view(np.uint64 if u.dtype == np.float64 else np.uint32),
                    v.view(np.uint64 if v.dtype == np.float64 else np.uint32))
            else:
                ok = u == v or (u != u and v != v)
            check(ok, f"{what}: {x.name}.{f} {u!r} != {v!r}")


def main_path_table2(whatif, tr, twin_mod, slo_mod):
    """Phase 3: run_grid on Table II, both modes, on the card."""
    twins = paper_twins(twin_mod)
    traffics = [tr.TrafficModel.honda_default("nominal", R=3.5, G=1.0),
                tr.TrafficModel.honda_default("high(+50%)", R=3.5, G=1.5)]
    slo = slo_mod.SLO(limit_s=4 * 3600, met_fraction=0.95)
    for series in (False, True):
        t0 = time.perf_counter()
        gpu = whatif.run_grid(twins, traffics, slo=slo,
                              return_series=series)
        wall = 1e3 * (time.perf_counter() - t0)
        cpu = whatif.run_grid(twins, traffics, slo=slo,
                              return_series=series, device="cpu")
        same_results(gpu, cpu, f"Table II series={series} card vs CPU")
        rows = {r["run"]: r for r in whatif.table2_rows(gpu)}
        for (run, col), want in TABLE2_ANCHORS.items():
            check(rows[run][col] == want, (run, col, rows[run][col], want))
        met = {run for run, r in rows.items() if r["slo_met"]}
        check(met == SLO_MET, met)
        print(f"phase 3: Table II run_grid series={series}: {wall:.1f} ms "
              f"wall, equal to the CPU run, anchors and SLO pattern hold")
        for r in whatif.table2_rows(gpu):
            print("  ", json.dumps(r))


def chaos_schedule(faults, n_futures):
    """The four-spec schedule of benchmarks/faults_bench.py."""
    return faults.FaultSchedule(
        specs=(faults.outage(rate_per_year=6, duration_hours=(1, 4)),
               faults.disconnect(rate_per_year=12,
                                 disconnect_frac=(0.2, 0.5)),
               faults.brownout(rate_per_year=8, capacity_mult=(0.3, 0.7)),
               faults.burst(rate_per_year=8, load_mult=(1.5, 3.0))),
        n_futures=n_futures, seed=0)


def ledger_balances(rows, what):
    for r in rows:
        ledger = r.processed_records + r.dropped_records + r.queue_end
        check(abs(ledger - r.arrived_records)
              <= 1e-6 * abs(r.arrived_records), (what, r.name, ledger,
                                                 r.arrived_records))


def main_path_whatif7(whatif, tr, twin_mod, slo_mod, faults):
    """Phase 3b: What-if #7 of examples/whatif_analysis.py on the card."""
    twins = paper_twins(twin_mod)[:2]
    nominal = tr.TrafficModel.honda_default("nominal", R=3.5, G=1.0)
    slo = slo_mod.SLO(limit_s=4 * 3600, met_fraction=0.95)
    chaos = faults.FaultSchedule(
        specs=(faults.outage(rate_per_year=6, duration_hours=(1, 4)),
               faults.disconnect(rate_per_year=12,
                                 disconnect_frac=(0.2, 0.5),
                                 flood_hours=1.0),
               faults.brownout(rate_per_year=8, capacity_mult=(0.3, 0.7))),
        n_futures=4, seed=0)
    for series in (False, True):
        t0 = time.perf_counter()
        gpu = whatif.run_grid(twins, [nominal], slo=slo, faults=chaos,
                              return_series=series)
        wall = 1e3 * (time.perf_counter() - t0)
        cpu = whatif.run_grid(twins, [nominal], slo=slo, faults=chaos,
                              return_series=series, device="cpu")
        same_results(gpu, cpu, f"What-if #7 series={series} card vs CPU")
        check(len(gpu) == 8 and gpu[0].name == "nominal blocking-write/f0",
              [r.name for r in gpu])
        rows = whatif.table2_rows(gpu)
        if not series:
            check({"fault_hours", "pct_hours_met_in_fault",
                   "pct_hours_met_outside_fault"} <= set(rows[0]), rows[0])
            check(any(r.fault_hours > 0 for r in gpu), "no fault hours")
            ledger_balances(gpu, "What-if #7")
        print(f"phase 3b: What-if #7 chaos suite series={series}: "
              f"{wall:.1f} ms wall, equal to the CPU run"
              + ("" if series else ", ledger balances"))
        for r in rows:
            print("  ", json.dumps(r))


def at_width(whatif, tr, twin_mod, slo_mod):
    """Phase 4: the What-if #5 sweep and the 65,536-scenario grid through
    run_grid. Returns what the kernel comparison needs."""
    sweep_twins = whatif5_twins(twin_mod)
    slo = slo_mod.SLO(limit_s=4 * 3600, met_fraction=0.95)
    growths16 = [tr.TrafficModel.honda_default(f"g{g:.2f}", R=3.5,
                                               G=float(g))
                 for g in np.linspace(1.0, 1.75, 16)]
    t0 = time.perf_counter()
    series = whatif.run_grid(sweep_twins, growths16, slo=slo,
                             return_series=True)
    wall_s = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    aggs = whatif.run_grid(sweep_twins, growths16, slo=slo)
    wall_a = 1e3 * (time.perf_counter() - t0)
    check(len(series) == len(aggs) == 4096, len(series))
    for s, a in zip(series, aggs):
        for x, y in ((a.total_cost_usd, s.total_cost_usd),
                     (a.backlog_s, s.backlog_s),
                     (a.backlog_cost_usd, s.backlog_cost_usd),
                     (a.max_throughput_rph, s.max_throughput_rph),
                     (a.mean_throughput_rph, s.mean_throughput_rph),
                     (a.dropped_records, s.dropped_records),
                     (a.processed_records, np.float64(s.processed).sum()),
                     (a.arrived_records, np.float64(s.load).sum()),
                     (a.queue_end, s.queue[-1]),
                     (a.pct_latency_met, s.pct_latency_met),
                     (a.pct_hours_met, s.pct_hours_met)):
            check(x == y, (s.name, x, y))
        check(a.slo_met == s.slo_met, s.name)
        check(np.isfinite(a.total_cost_usd)
              and np.isfinite(s.latency_s).all(), s.name)
    n_met = sum(a.slo_met for a in aggs)
    print(f"phase 4a: What-if #5, 4,096 scenarios x 8736 h: series "
          f"{wall_s:.1f} ms wall, aggregate {wall_a:.1f} ms wall; sums, "
          f"max, queue and SLO shares bitwise equal; {n_met} meet the SLO")

    growths256 = [tr.TrafficModel.honda_default(f"g{g:.4f}", R=3.5,
                                                G=float(g))
                  for g in np.linspace(1.0, 1.75, 256)]
    t0 = time.perf_counter()
    big = whatif.run_grid(sweep_twins, growths256, slo=slo)
    wall_b = 1e3 * (time.perf_counter() - t0)
    # the part of that wall spent building the [256, 8736] load matrix on
    # the host (run_grid calls hourly_loads once per forecast)
    t0 = time.perf_counter()
    for g in growths256:
        g.hourly_loads()
    loads_ms = 1e3 * (time.perf_counter() - t0)
    check(len(big) == 65536, len(big))
    check(all(np.isfinite(b.total_cost_usd) and b.arrived_records > 0
              for b in big), "non-finite or empty rows in the 65,536 sweep")
    cheapest = min((b for b in big if b.slo_met),
                   key=lambda b: b.grand_total_usd)
    print(f"phase 4b: 65,536 distinct full-year scenarios (aggregate): "
          f"{wall_b:.1f} ms wall, of which {loads_ms:.1f} ms building the "
          f"load matrix on the host; {sum(b.slo_met for b in big)} meet the "
          f"SLO, cheapest {cheapest.name} ${cheapest.total_cost_usd:.2f}")
    return sweep_twins, growths16, growths256, big


def chaos_at_width(whatif, tr, slo_mod, faults, sweep_twins, growths16):
    """Phases 4c and 4d: the chaos sweeps through run_grid(faults=).
    Returns the 4d forecasts and 4d's aggregate rows."""
    from repro_torch.core import simulate as psim
    slo = slo_mod.SLO(limit_s=4 * 3600, met_fraction=0.95)
    schedule = chaos_schedule(faults, 16)
    t0 = time.perf_counter()
    rows = whatif.run_grid(sweep_twins, growths16, slo=slo,
                           faults=schedule)
    wall = 1e3 * (time.perf_counter() - t0)
    nt, ng = len(sweep_twins), len(growths16)
    check(len(rows) == nt * ng * 16, len(rows))
    check(all(np.isfinite(r.total_cost_usd) for r in rows), "non-finite")
    # the host stages of that wall, timed again on their own
    matrix = np.stack([g.hourly_loads() for g in growths16])
    idx = np.repeat(np.arange(ng, dtype=np.int32), nt)
    t0 = time.perf_counter()
    fg = faults.expand_grid(faults.sample_futures(schedule, matrix.shape[1]),
                            matrix, idx)
    expand_ms = 1e3 * (time.perf_counter() - t0)
    params = np.repeat(np.tile(np.stack([tw.padded_params()
                                         for tw in sweep_twins]),
                               (ng, 1)), 16, axis=0)
    pol = np.repeat(np.tile([tw.policy_index for tw in sweep_twins], ng), 16)
    t0 = time.perf_counter()
    dd = psim._dedup_rows(fg.load_index, params, pol,
                          (fg.cap, fg.fmask, fg.fault_index))
    dedup_ms = 1e3 * (time.perf_counter() - t0)
    kept = len(rows) if dd is None else len(dd[0])
    met = sum(r.slo_met for r in rows)
    print(f"phase 4c: chaos sweep, {nt} twins x {ng} forecasts x 16 fault "
          f"futures = {len(rows):,} full-year rows (aggregate): {wall:.1f} ms "
          f"wall; expansion {expand_ms:.1f} ms "
          f"(+{len(fg.load_matrix) - len(matrix)} load rows), dedup "
          f"{dedup_ms:.1f} ms ({kept} rows kept); {met} meet the SLO")

    growths4 = [tr.TrafficModel.honda_default(f"g{g:.2f}", R=3.5, G=float(g))
                for g in np.linspace(1.0, 1.75, 4)]
    schedule4 = chaos_schedule(faults, 4)
    t0 = time.perf_counter()
    series = whatif.run_grid(sweep_twins, growths4, slo=slo,
                             faults=schedule4, return_series=True)
    wall_s = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    aggs = whatif.run_grid(sweep_twins, growths4, slo=slo, faults=schedule4)
    wall_a = 1e3 * (time.perf_counter() - t0)
    check(len(series) == len(aggs) == nt * 16, len(series))
    for s, a in zip(series, aggs):
        check(s.name == a.name, (s.name, a.name))
        for x, y in ((a.total_cost_usd, s.total_cost_usd),
                     (a.backlog_s, s.backlog_s),
                     (a.max_throughput_rph, s.max_throughput_rph),
                     (a.mean_throughput_rph, s.mean_throughput_rph),
                     (a.dropped_records, s.dropped_records),
                     (a.processed_records, np.float64(s.processed).sum()),
                     (a.arrived_records, np.float64(s.load).sum()),
                     (a.queue_end, s.queue[-1]),
                     (a.pct_latency_met, s.pct_latency_met),
                     (a.pct_hours_met, s.pct_hours_met)):
            check(x == y, (s.name, x, y))
        check(a.slo_met == s.slo_met, s.name)
        check(np.isfinite(s.latency_s).all(), s.name)
    print(f"phase 4d: chaos sweep, {nt} twins x 4 forecasts x 4 futures = "
          f"{len(series):,} rows: series {wall_s:.1f} ms wall, aggregate "
          f"{wall_a:.1f} ms wall; sums, max, queue and SLO shares bitwise "
          f"equal")
    return growths4, aggs


def policy_plain(ops, agg):
    """A policy kernel's plain version on ``ops``, timed once (CUDA
    events): (ms, its result)."""
    from repro_torch.kernels import ref
    plain_kw = {}
    if agg:
        plain_kw.update(slo_limit=4 * 3600.0, slo_mode=0)
    if "caps_t" in ops:
        plain_kw["caps"] = plain_rows(ops, "caps_t")
        if agg:
            plain_kw["fmask"] = plain_rows(ops, "fmask_t")
    plain = ref.policy_grid_agg if agg else ref.policy_grid_scan
    loads = plain_loads(ops)
    return cuda_ms(lambda: plain(loads, ops["params"], ops["onehot"], 1.0,
                                 **plain_kw))


def kernel_vs_plain(name, shape, ops, agg, plain=None):
    """Time one kernel on ``ops`` (CUDA events over 3 launches after a
    warm-up) and its plain version once (or take ``plain``, ``policy_plain``'s
    (ms, result) on the same ``ops`` from earlier in the run), hold them
    bitwise over the whole grid, and return the kernels line's numbers
    for it."""
    from repro_torch.kernels import policy_scan as pk
    kw = dict(loads_t=ops["loads_t"], load_index=ops["load_index"])
    if agg:
        kw.update(slo_limit=4 * 3600.0, slo_mode=0)
    if "caps_t" in ops:
        kw.update(caps_t=ops["caps_t"], fault_index=ops["fault_index"])
        if agg:
            kw["fmask_t"] = ops["fmask_t"]
    kernel = pk.policy_grid_agg if agg else pk.policy_grid_scan
    args = (None, ops["params"], ops["onehot"], 1.0)
    kernel(*args, **kw)                                     # warm-up
    ms, got = cuda_ms(lambda: kernel(*args, **kw), reps=3)
    plain_ms, want = plain if plain is not None else policy_plain(ops, agg)
    if agg:
        pairs = [("carry", got[0], want[0]), ("rows", got[1], want[1])]
    else:
        pairs = [("carry", got[0], want[0])] + [
            (f"series {j}", a, b) for j, (a, b) in enumerate(zip(got[1],
                                                                 want[1]))]
    for what, a, b in pairs:
        assert_bitwise(f"{name} {shape} {what}", a, b)
    err = max_abs_err([(a, b) for _, a, b in pairs])
    bound_ms, bound_by = bound(ops, agg=agg)
    del got, want, pairs
    device_ms = kernel_device_ms(
        lambda: kernel(*args, **kw),
        "policy_agg_kernel" if agg else "policy_scan_kernel")
    print(f"{name} at {shape}: kernel {ms:.3f} ms through the wrapper "
          f"(CUDA events), {device_ms:.3f} ms on the device (profiler), "
          f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"whole grid bitwise equal")
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def close_or_raise(name, got, want, tol):
    """Raise unless |got - want| <= tol (1 + |want|) everywhere and got is
    finite; returns the largest absolute error."""
    g, w = got.double(), want.double()
    check(g.shape == w.shape, (name, g.shape, w.shape))
    err = (g - w).abs()
    bad = ~(err <= tol * (1 + w.abs()))
    if bool(bad.any()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} of {g.numel()} "
                             f"elements outside {tol:g}, max abs error "
                             f"{float(err.max()):.3g}")
    return float(err.max())


def check_flash_random_blocks(dev):
    """Phase 5a: the flash kernels against ref.flash_attention: both types
    on random blocks, then bf16 (the wgmma kernel) around its 128-row
    tiles and at the serving path's prefill shape, and float32 (the
    3xTF32 kernel) around its 32-key and 64-row tiles."""
    from repro_torch.kernels import flash_attention as fk, ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(2, 200, 200, 8, 8, 64),      # g 1, sq not a multiple of 64
             (2, 200, 200, 8, 1, 128),     # g 8
             (1, 130, 257, 16, 2, 128),    # sq != sk
             (1, 300, 64, 8, 8, 64)]       # more queries than keys
    bf16_cases = [(1, sq, sk, 8, 2, d) for d in (128, 64)
                  for sq, sk in ((127, 129), (129, 127), (300, 129),
                                 (129, 300), (300, 300))]
    bf16_cases.append((4, 2048, 2048, 64, 8, 128))   # the prefill shape
    # float32 around its kernel's 32-key tiles and 64-row q tile
    f32_cases = [(1, sq, sk, 8, 2, d) for d in (64, 128)
                 for sq, sk in FLASH_F32_SEQS + ((63, 65), (65, 127))]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    fk.reset_launches()
    n_cases = 0
    for (b, sq, sk, h, kh, d), dtypes, causals in (
            [(c, (torch.float32, torch.bfloat16), (True, False))
             for c in cases]
            + [(c, (torch.bfloat16,), (True, False)) for c in bf16_cases]
            + [(c, (torch.float32,), (True, False)) for c in f32_cases]):
        for causal in causals:
            for dtype in dtypes:
                q = torch.randn(b, sq, h, d, generator=g, device=dev)
                k = torch.randn(b, sk, kh, d, generator=g, device=dev)
                v = torch.randn(b, sk, kh, d, generator=g, device=dev)
                q, k, v = (x.to(dtype) for x in (q, k, v))
                got = fk.flash_attention(q, k, v, causal=causal)
                want = ref.flash_attention(q, k, v, causal=causal)
                check(got.dtype == dtype, got.dtype)
                err = close_or_raise(
                    f"flash {(b, sq, sk, h, kh, d)} causal={causal} "
                    f"{dtype}", got, want, MODEL_TOL[dtype])
                worst[dtype] = max(worst[dtype], err)
                n_cases += 1
    torch.cuda.synchronize()
    n_f32 = len(cases) * 2 + len(f32_cases) * 2
    check(fk.launches == {"flash_attention": n_cases - n_f32,
                          "flash_attention_f32": n_f32,
                          "flash_attention_wide": 0,
                          "flash_attention_wide_f32": 0}, fk.launches)
    print(f"phase 5a: flash kernels vs plain on {n_cases} random blocks "
          f"(causal or not, g 1/4/8, d 64/128 (phase 10a takes the other "
          f"head dims), sq and sk 64-300 around "
          f"the 128-row tile (float32 also 31-127 around its 32-key and "
          f"64-row tiles), and the prefill shape in bf16): max abs "
          f"error float32 {worst[torch.float32]:.3g} (tol "
          f"{MODEL_TOL[torch.float32]:g}), bf16 "
          f"{worst[torch.bfloat16]:.3g} (tol {MODEL_TOL[torch.bfloat16]:g});"
          f" launches {fk.launches}")


#: phase 10a's (dqk, dv) pairs: stablelm-3b's 80, gemma-7b's 256,
#: minicpm3-4b's MLA prefill (64 + 32 / 64) and its smoke config's
#: (16 + 8 / 16); then one block each at other pairs of the rule, so
#: every instantiation runs (storage dims 16-256, both key tiles)
FLASH_DIM_PAIRS = ((80, 80), (256, 256), (96, 64), (24, 16))
FLASH_RULE_PAIRS = ((8, 8), (192, 192), (256, 64), (64, 256), (136, 200),
                    (40, 152), (128, 32), (16, 128))
#: sq and sk around the 128-row q tile and d = 256's 64-key tile
FLASH_DIM_SEQS = ((63, 63), (64, 64), (65, 65), (127, 127), (129, 129),
                  (300, 300), (63, 129), (64, 300), (65, 63), (127, 64),
                  (129, 65), (300, 127))
#: float32 only: sq and sk around the float32 kernel's 32-key tiles (its
#: 64-row q tile is among FLASH_DIM_SEQS)
FLASH_F32_SEQS = ((31, 33), (32, 32), (33, 31), (95, 97), (97, 96))


def check_flash_dims_random_blocks(dev):
    """Phase 10a: both flash kernels against ref.flash_attention at the
    head dims phase 10's configs use (dqk != dv for MLA), causal or not,
    GQA g 1 and 7, sq and sk around the 128-row q tile and the 64-key
    tile of d = 256 (and, float32 only, the float32 kernel's 32-key
    tiles); then one block at each further pair of the rule. Holds the
    launch counts. Returns the cases run."""
    from repro_torch.kernels import flash_attention as fk, ref
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    cases = [(1, sq, sk, h, kh, dq, dv, causal, dtype)
             for dq, dv in FLASH_DIM_PAIRS for sq, sk in FLASH_DIM_SEQS
             for h, kh in ((4, 4), (14, 2)) for causal in (True, False)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(1, sq, sk, h, kh, dq, dv, causal, torch.float32)
              for dq, dv in FLASH_DIM_PAIRS for sq, sk in FLASH_F32_SEQS
              for h, kh in ((4, 4), (14, 2)) for causal in (True, False)]
    cases += [(2, 129, 200, 14, 2, dq, dv, causal, dtype)
              for dq, dv in FLASH_RULE_PAIRS for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    fk.reset_launches()
    for b, sq, sk, h, kh, dq, dv, causal, dtype in cases:
        q = torch.randn(b, sq, h, dq, generator=g, device=dev).to(dtype)
        k = torch.randn(b, sk, kh, dq, generator=g, device=dev).to(dtype)
        v = torch.randn(b, sk, kh, dv, generator=g, device=dev).to(dtype)
        got = fk.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        check(got.dtype == dtype and got.shape == (b, sq, h, dv),
              (got.dtype, got.shape))
        err = close_or_raise(
            f"flash {(b, sq, sk, h, kh)} (dqk, dv) {(dq, dv)} "
            f"causal={causal} {dtype}", got, want, MODEL_TOL[dtype])
        worst[dtype] = max(worst[dtype], err)
    torch.cuda.synchronize()
    n_f32 = sum(1 for c in cases if c[-1] == torch.float32)
    check(fk.launches == {"flash_attention": len(cases) - n_f32,
                          "flash_attention_f32": n_f32,
                          "flash_attention_wide": 0,
                          "flash_attention_wide_f32": 0}, fk.launches)
    for dq, dv in ((264, 264), (64, 264)):
        fk.check_head_dims(dq, dv)          # taken: the wide kernels
    print(f"phase 10a: flash kernels vs plain on {len(cases)} random "
          f"blocks ((dqk, dv) {', '.join(map(str, FLASH_DIM_PAIRS))} at "
          f"sq/sk 31-300, g 1 and 7, causal or not; then "
          f"{', '.join(map(str, FLASH_RULE_PAIRS))}): max abs error "
          f"float32 {worst[torch.float32]:.3g} (tol "
          f"{MODEL_TOL[torch.float32]:g}), bf16 "
          f"{worst[torch.bfloat16]:.3g} (tol {MODEL_TOL[torch.bfloat16]:g});"
          f" launches {fk.launches}; head dims past 256 run too "
          f"({fk.HEAD_DIM_RULE}; phase 11 runs them and the padded dims)")
    return len(cases)


def ssm_inputs(b, s, di, n, dtype, dev, g, state=True):
    x = torch.randn(b, s, di, generator=g, device=dev) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, di, generator=g, device=dev) - 1)
    B = torch.randn(b, s, n, generator=g, device=dev) * 0.5
    C = torch.randn(b, s, n, generator=g, device=dev) * 0.5
    A = -torch.exp(torch.randn(di, n, generator=g, device=dev) * 0.5)
    D = torch.randn(di, generator=g, device=dev)
    st = (torch.randn(b, di, n, generator=g, device=dev) * 0.1
          if state else None)
    x, dt, B, C = (t.to(dtype) for t in (x, dt, B, C))
    return x, dt, A, B, C, D, st


def check_ssm_random_blocks(dev):
    """Phase 5b: the selective-scan kernel against ref.ssm_scan, at and
    around its 32- and 16-step chunks (bf16 and float32), n 16, 4 and 13
    (the last leaving its four partial sums of y uneven), and runs split
    anywhere."""
    from repro_torch.kernels import ref, ssm_scan as sk
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst, blocks = 0.0, 0
    cases = [(s, n, dtype, state, 1000) for s in (1, 37, 63, 64, 65, 256)
             for n in (16, 4, 13)
             for dtype in (torch.float32, torch.bfloat16)
             for state in (False, True)]
    # the prefill's length; and di 999, whose rows are not 16-byte pieces
    # (x and dt staged element by element)
    cases += [(s, 16, dtype, True, di) for s, di in ((2048, 1000), (65, 999))
              for dtype in (torch.float32, torch.bfloat16)]
    for s, n, dtype, state, di in cases:
        ops = ssm_inputs(2, s, di, n, dtype, dev, g, state)
        kept = None if ops[-1] is None else ops[-1].clone()
        got, want = sk.ssm(*ops), ref.ssm_scan(*ops)
        for what, a, w in zip(("y", "state"), got, want):
            worst = max(worst, close_or_raise(
                f"ssm s={s} n={n} di={di} {dtype} state={state} {what}", a, w,
                MODEL_TOL[dtype]))
        if kept is not None:
            check(torch.equal(kept, ops[-1]), "the state passed in changed")
        blocks += 1
    # a run split in two, the state carried across, against one whole run:
    # inside the first chunk, on a chunk boundary, one step past it, and
    # inside a later chunk
    tol = MODEL_TOL[torch.float32]
    splits = (1, 37, 64, 65, 100)
    for n in (16, 13):
        x, dt, A, B, C, D, st = ssm_inputs(2, 256, 1000, n, torch.float32,
                                           dev, g)
        y_all, s_all = sk.ssm(x, dt, A, B, C, D, st)
        for cut in splits:
            y1, s1 = sk.ssm(x[:, :cut], dt[:, :cut], A, B[:, :cut],
                            C[:, :cut], D, st)
            y2, s2 = sk.ssm(x[:, cut:], dt[:, cut:], A, B[:, cut:],
                            C[:, cut:], D, s1)
            close_or_raise(f"ssm n={n} split at {cut} y",
                           torch.cat([y1, y2], 1), y_all, tol)
            close_or_raise(f"ssm n={n} split at {cut} state", s2, s_all, tol)
    torch.cuda.synchronize()
    print(f"phase 5b: selective-scan kernel vs plain on {blocks} random "
          f"blocks (s 1/37/63/64/65/256 and 2048, n 16/4/13, di 1000 and "
          f"999, float32 and bf16, zero or carried-in state, the state "
          f"passed in unchanged): max abs error {worst:.3g}; runs split at "
          f"steps "
          f"{'/'.join(map(str, splits))} (n 16 and 13) equal the whole run "
          f"within {tol:g}")


def wkv_inputs(b, s, h, n, dtype, dev, g, state=True, log_w=None):
    """r, k, v, w, u, state for the WKV recurrence. ``log_w`` None draws
    w = exp(-exp(N(-0.5, 0.5))), the JAX package's test decays; a number
    draws per-step log w around that mean (spread 0.5)."""
    r, k, v = (torch.randn(b, s, h, n, generator=g, device=dev) * 0.5
               for _ in range(3))
    z = torch.randn(b, s, h, n, generator=g, device=dev)
    w = (torch.exp(-torch.exp(z * 0.5 - 0.5)) if log_w is None
         else torch.exp(log_w + 0.5 * z))
    u = torch.randn(h, n, generator=g, device=dev) * 0.3
    st = (torch.randn(b, h, n, n, generator=g, device=dev) * 0.1
          if state else None)
    r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
    return r, k, v, w, u, st


def wkv_close(name, got, want, dtype):
    """The WKV kernel's (out, state) against the plain version's: out
    within its type's tolerance, the float32 state within float32's."""
    return max(close_or_raise(f"{name} {what}", a, w, MODEL_TOL[t])
               for what, a, w, t in zip(("out", "state"), got, want,
                                        (dtype, torch.float32)))


def check_wkv_random_blocks(dev):
    """Phase 5e: the WKV kernels against ref.rwkv6_scan: the per-step
    kernel (s < 64) and the chunked one (s >= 64; s 100 and 300 end in a
    ragged chunk), runs split at a chunk boundary and inside a chunk, and
    strong decays through the chunked kernel."""
    from repro_torch.kernels import ref, rwkv6_kernel as rk
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    worst, blocks = 0.0, 0
    rk.reset_launches()
    for s in (1, 37, 100, 256, 300):
        for n in (16, 64):
            for dtype in (torch.float32, torch.bfloat16):
                for state in (False, True):
                    ops = wkv_inputs(2, s, 3, n, dtype, dev, g, state)
                    kept = None if ops[5] is None else ops[5].clone()
                    got = rk.rwkv6(*ops)
                    check(got[0].dtype == dtype, got[0].dtype)
                    worst = max(worst, wkv_close(
                        f"wkv s={s} n={n} {dtype} state={state}", got,
                        ref.rwkv6_scan(*ops), dtype))
                    check(kept is None or torch.equal(kept, ops[5]),
                          "the kernel modified the state passed in")
                    blocks += 1
    check(rk.launches == {"rwkv6_chunked": 24, "rwkv6_scan": 16},
          rk.launches)
    # a run split in two, the state carried across, against one whole
    # run: at step 128 (a chunk boundary) and at step 100 (inside one)
    r, k, v, w, u, st = wkv_inputs(2, 256, 3, 64, torch.float32, dev, g)
    o_all, s_all = rk.rwkv6(r, k, v, w, u, st)
    tol = MODEL_TOL[torch.float32]
    for cut in (128, 100):
        o1, s1 = rk.rwkv6(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut],
                          u, st)
        o2, s2 = rk.rwkv6(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:],
                          u, s1)
        close_or_raise(f"wkv split at {cut} out", torch.cat([o1, o2], 1),
                       o_all, tol)
        close_or_raise(f"wkv split at {cut} state", s2, s_all, tol)
    # strong decays, where the TPU kernel's exponent clamp drops pair
    # terms (ROADMAP C10): the chunked kernel follows the recurrence
    strong = 0.0
    rk.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        ops = wkv_inputs(2, 256, 3, 64, dtype, dev, g, log_w=-6.0)
        strong = max(strong, wkv_close(f"wkv strong decay {dtype}",
                                       rk.rwkv6(*ops), ref.rwkv6_scan(*ops),
                                       dtype))
    check(rk.launches == {"rwkv6_chunked": 2, "rwkv6_scan": 0}, rk.launches)
    torch.cuda.synchronize()
    print(f"phase 5e: WKV kernels vs plain on {blocks} random blocks (s "
          f"1/37 per step, 100/256/300 chunked; n 16/64, float32 and "
          f"bf16, zero or carried-in state): max abs error {worst:.3g}; "
          f"runs split at steps 128 and 100 equal the whole run within "
          f"{tol:g}; strong decays (mean log w -6, chunked): max abs error "
          f"{strong:.3g}")


class LogitRecorder:
    """Wraps a serve step: keeps the logits it returns (``keep``) or only
    checks that they are finite."""

    def __init__(self, step, keep=True):
        self.step, self.keep, self.logits = step, keep, []

    def __call__(self, *args):
        logits, cache = self.step(*args)
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        if self.keep:
            self.logits.append(logits.float().cpu())
        return logits, cache


def check_smoke_slice(dev, phase, cfg, label):
    """Phases 5c and 5f: a smoke-width slice on the card against the
    port's CPU run, from one seeded parameter set."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeEngine
    params = M.init_params(cfg, seed=SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (9, 20, 31, 40)]
    runs = {}
    for where in ("cpu", dev):
        eng = ServeEngine(cfg, params, slots=4, max_len=64, device=where)
        eng._prefill = LogitRecorder(eng._prefill)
        eng._decode = LogitRecorder(eng._decode)
        reqs = [Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng.process_group(reqs)
        runs[str(where)] = ([r.output for r in reqs],
                            eng._prefill.logits + eng._decode.logits)
    (tok_c, lg_c), (tok_g, lg_g) = runs["cpu"], runs[str(dev)]
    check(tok_c == tok_g, f"greedy tokens differ: CPU {tok_c}, card {tok_g}")
    err = max(close_or_raise(f"smoke slice logits step {i}", a, b,
                             SLICE_TOL)
              for i, (a, b) in enumerate(zip(lg_g, lg_c)))
    print(f"phase {phase}: {label} served on the card: greedy tokens equal "
          f"to the CPU run's, logits max abs error {err:.3g} (tol "
          f"{SLICE_TOL:g})")


def model_kernels():
    """The wrappers of the serving path's kernels, whose counts the
    serving phases reset and read."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rwkv6_kernel as rk
    from repro_torch.kernels import ssm_scan as sk
    return fk, sk, rk


def model_launches(mods):
    """The model kernels' launch counts, the wide flash kernels' only
    where they launched (no serving path here has a head dim past 256,
    and the expected counts leave them out)."""
    return {k: v for mod in mods for k, v in mod.launches.items()
            if v or "wide" not in k}


def decode_floor_bytes(eng, new_tokens=32):
    """The bytes a decode step must read, averaged over a group's steps:
    every parameter the step multiplies or reads, as the engine holds it
    (every expert's, since the dispatch multiplies each expert's
    capacity slots, filled or not; the embedding table only where it is
    tied, as the unembedding; not the encoder's, which runs at prefill
    only), the attention cache up to the rows' length (the padded prompt
    and half the new tokens): K and V per kv head, or MLA's latent and
    rope key ((kv_lora_rank + rope) values a token a layer); and an
    encoder-decoder's cross-attention K/V, ``encoder_seq`` long, whole.
    ``eng``: a ``ServeEngine`` or anything with its ``cfg``, ``params``,
    ``slots`` and ``_prefill_len``."""
    from repro_torch.models import model as M
    cfg = eng.cfg
    weights = sum(w.numel() * w.element_size()
                  for name, w in eng.params.items()
                  if (name != "embed.table" or cfg.tie_embeddings)
                  and not name.startswith(("encoder.", "encoder_norm.")))
    kv = 0
    if "attn" in cfg.block_pattern:
        a = cfg.attention
        elem = torch.finfo(M.compute_dtype(cfg)).bits // 8
        if a.kind == "mla":
            per_token = (a.kv_lora_rank + a.qk_rope_head_dim) * elem
        else:
            per_token = 2 * a.num_kv_heads * a.head_dim * elem
        layers = cfg.num_layers * cfg.block_pattern.count("attn") // len(
            cfg.block_pattern)
        kv = (eng.slots * (eng._prefill_len + new_tokens // 2) * layers
              * per_token)
        if cfg.encdec:
            kv += (eng.slots * cfg.encoder_seq * layers
                   * 2 * a.num_kv_heads * a.head_dim * elem)
    return weights, kv


def serve_at_width(dev, phase, cfg, label, expect):
    """Phases 5d, 5g and 9c-9e, the serving main path at every published
    width of ``cfg`` (``label`` says how its depth was cut): 8 requests,
    two groups of 4. The parameters are drawn on the card in the form
    the engine holds them (``init_params(compute=True)``: matrices in
    bf16, each stacked leaf drawn in float32 one group at a time). Holds
    the model kernels' launch counts of this run to ``expect`` and
    returns them with the engine (one card, priced as one chip by phase
    6b) and the step profile."""
    from repro_torch.kernels import policy_scan as pk
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeEngine
    torch.cuda.empty_cache()            # what an earlier phase held
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev, compute=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, slots=4, max_len=4096, chips=1,
                      device=dev)
    load_peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    active = M.active_param_count(cfg)
    print(f"phase {phase}: {cfg.name} {label}: "
          f"{M.param_count(cfg):,} parameters ({active:,} active a "
          f"token) drawn in {init_s:.1f} s (matrices in {cfg.dtype}; "
          f"peak {load_peak / 2**30:.2f} GiB at load), held as "
          f"{held / 2**30:.2f} GiB with the engine")
    rng = np.random.default_rng(SEED)
    lens = rng.integers(1024, 2049, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    # warm-up: one short group (cuBLAS handles and workspaces, the
    # kernels' first launches), then a clean collector
    eng.process_group([Request(rid=-1 - i, prompt=prompts[i], max_new=2)
                       for i in range(4)])
    eng.collector.clear()
    eng._prefill = LogitRecorder(eng._prefill, keep=False)
    eng._decode = LogitRecorder(eng._decode, keep=False)
    reqs = [Request(rid=i, prompt=p, max_new=32) for i, p in
            enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the serving main path: every count from 0, read right after
    mods = model_kernels()
    for mod in (pk,) + mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    done = eng.serve(reqs)
    wall = time.perf_counter() - t0
    launches = model_launches(mods)
    check(sum(pk.launches.values()) == 0, pk.launches)
    peak = torch.cuda.max_memory_allocated()

    check(len(done) == 8 and all(len(r.output) == 32 for r in done),
          [len(r.output) for r in done])
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.output),
          "token out of range")
    check(launches == expect, (launches, expect))
    ttft = np.array([r.ttft_s for r in done]) * 1e3
    summ = eng.collector.summary()
    pre = 1e3 * np.array([s.duration for s in eng.collector.spans("prefill")])
    dec = 1e3 * np.array([s.duration for s in eng.collector.spans("decode")])
    new_tokens = sum(len(r.output) for r in done)
    w_bytes, kv_bytes = decode_floor_bytes(eng)
    floor_ms = 1e3 * (w_bytes + kv_bytes) / HBM_BYTES_PER_S
    print(f"phase {phase}: served 8 requests (prompts {int(lens.min())}-"
          f"{int(lens.max())} tokens, padded to {eng._prefill_len}; 32 new "
          f"tokens each) in {wall * 1e3:.1f} ms wall: TTFT p50 "
          f"{np.percentile(ttft, 50):.1f} ms, p95 "
          f"{np.percentile(ttft, 95):.1f} ms; per-token decode "
          f"{dec.mean():.2f} ms (a step of 4 rows); {new_tokens / wall:.1f} "
          f"tokens/s; span means prefill {pre.mean():.1f} ms, decode "
          f"{dec.mean():.2f} ms ({summ['decode']['records']} decode "
          f"records); peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated); a decode step's floor {floor_ms:.2f} "
          f"ms ({w_bytes / 1e9:.2f} GB of weights and {kv_bytes / 1e9:.2f}"
          f" GB of K/V read at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    out = {
        "phase": phase, "model": cfg.name, "layers": cfg.num_layers,
        "params": M.param_count(cfg), "active_params": active,
        "requests": 8, "slots": eng.slots, "max_len": eng.max_len,
        "max_new": 32, "wall_ms": wall * 1e3,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p95": float(np.percentile(ttft, 95)),
        "decode_step_ms": float(dec.mean()),
        "decode_floor_ms": floor_ms,
        "prefill_span_ms": float(pre.mean()),
        "tokens_per_s": new_tokens / wall, "init_s": init_s,
        "load_peak_gib": load_peak / 2**30, "peak_gib": peak / 2**30,
        "held_gib": held / 2**30, "launches": launches}
    print(json.dumps({"serve": out}))
    out["profile"] = profile_serving(eng, prompts[:4], dev, phase)
    eng._prefill, eng._decode = eng._prefill.step, eng._decode.step
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase {phase}: {out['phase_s']:.1f} s in all")
    return launches, eng, out


#: decode steps ``profile_serving`` traces: the profiler's parse of its
#: events takes seconds a step at ~10,000 operations a step, so every
#: serving phase traces 2 and reports per-step means
PROFILE_DECODE_STEPS = 2


def profile_serving(eng, prompts, dev, phase):
    """Where a group's time goes: one prefill and ``PROFILE_DECODE_STEPS``
    greedy decode steps of the engine's own step functions, as
    ``process_group`` runs them, under ``torch.profiler``: wall and summed
    device (kernel) time, the device's busy share, the kernels that take
    most of it, and the PyTorch operations the host dispatched (top-level
    ``aten::`` calls, the greedy pick included), each a step; and the
    seconds the pass took with the profiler's tables (``cost_s``). Runs
    after the main path's counts were read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    toks = np.zeros((eng.slots, eng._prefill_len), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p[-eng._prefill_len:]
    cache = M.init_cache(eng.cfg, eng.slots, eng.max_len, device=dev)
    steps = PROFILE_DECODE_STEPS
    out = {}
    t_all = time.perf_counter()
    for what in ("prefill", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                logits, cache = eng._prefill(
                    eng.params, {"tokens": torch.from_numpy(toks).to(dev)},
                    cache)
                torch.cuda.synchronize()
                n = 1
            else:
                for _ in range(steps):
                    cur = logits[:, -1].argmax(-1).to(torch.int32).cpu()
                    logits, cache = eng._decode(
                        eng.params, cache, {"token": cur[:, None].to(dev)})
                    torch.cuda.synchronize()
                n = steps
            wall_us = 1e6 * (time.perf_counter() - t0)
        # device-side events only: a CPU op's self device time repeats
        # its kernels'
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
        dev_us = sum(e.self_device_time_total for e in kernels)
        host_ops = sum(1 for e in prof.events()
                       if e.name.startswith("aten::")
                       and not (e.cpu_parent is not None
                                and e.cpu_parent.name.startswith("aten::")))
        if not dev_us:
            print(f"profile {phase} {what}: the profiler saw no device "
                  f"time (busy share not measured), {host_ops / n:.0f} "
                  f"PyTorch operations dispatched")
            continue
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out[what] = {
            "wall_ms": wall_us / n / 1e3, "device_ms": dev_us / n / 1e3,
            "busy": dev_us / wall_us, "host_ops": host_ops / n,
            "top": [[e.key[:70], round(e.self_device_time_total / dev_us, 4),
                     e.count // n] for e in top]}
        print(f"profile {phase} {what} (per "
              f"{'group' if n == 1 else 'step'}): "
              f"wall {wall_us / n / 1e3:.2f} ms, device {dev_us / n / 1e3:.2f}"
              f" ms, busy {dev_us / wall_us:.1%}, {host_ops / n:.0f} "
              f"PyTorch operations dispatched")
    out["cost_s"] = time.perf_counter() - t_all
    print(f"profile {phase}: {out['cost_s']:.1f} s with the profiler's "
          f"tables")
    print(json.dumps({"profile": dict(out, phase=phase)}))
    return out


def forecast_on_card(whatif, twin, traffic, slo, what):
    """A year of ``traffic`` against ``twin`` through run_grid on the card
    in both modes, each bitwise equal to its CPU run; the aggregate row."""
    rows = {}
    for series in (False, True):
        t0 = time.perf_counter()
        card = whatif.run_grid([twin], [traffic], slo=slo,
                               return_series=series)
        wall = 1e3 * (time.perf_counter() - t0)
        cpu = whatif.run_grid([twin], [traffic], slo=slo,
                              return_series=series, device="cpu")
        same_results(card, cpu, f"{what} series={series} card vs CPU")
        rows[series] = (card[0], wall)
    agg, series_row = rows[False][0], rows[True][0]
    check(agg.slo_met == series_row.slo_met
          and agg.total_cost_usd == series_row.total_cost_usd,
          (what, agg.total_cost_usd, series_row.total_cost_usd))
    return agg, rows[False][1], rows[True][1]


def telemetry_experiment(what):
    """The quickstart experiment of examples/quickstart.py: the
    blocking-write telemetry pipeline on the host under a 3 s ramp to
    120 rec/s; fails unless it drained with no stage error."""
    import tempfile
    from repro_torch.core.experiment import Experiment
    from repro_torch.core.loadpattern import LoadPattern
    from repro_torch.pipelines.telemetry import (make_telemetry_dataset,
                                                 make_telemetry_pipeline)
    with tempfile.TemporaryDirectory() as blob_dir:
        pipe = make_telemetry_pipeline("blocking-write", blob_dir=blob_dir)
        dataset = make_telemetry_dataset(num_records=40, seed=SEED)
        load = LoadPattern.ramp("0->120rps", duration_s=3.0, peak_rate=120.0)
        res = Experiment("quickstart", pipe, load, dataset).run()
    check(res.drained and not pipe.errors,
          f"{what}: drained={res.drained}, errors {pipe.errors[:3]}")
    check(res.records_done == res.records_sent > 0, (res.records_done,
                                                     res.records_sent))
    return res


def wind_tunnel_telemetry(dev, whatif, tr, slo_mod):
    """Phase 6a: the paper's loop (examples/quickstart.py) on the port —
    an experiment over the blocking-write telemetry pipeline on the host,
    its fitted twin, and a year's forecast on the card."""
    from repro_torch.core.report import render_table
    from repro_torch.core.twin import fit_simple_twin
    from repro_torch.kernels import policy_scan as pk
    res = telemetry_experiment("6a")
    twin = fit_simple_twin(res)
    print(f"phase 6a: telemetry blocking-write under a 3 s 0->120 rec/s "
          f"ramp: sent {res.records_sent}, done {res.records_done} in "
          f"{res.duration_s:.2f} s, sustained {res.sustained_rps:.2f} rec/s")
    print(render_table([dict(stage=k, **{kk: round(vv, 6) for kk, vv in
                                         v.items()})
                        for k, v in res.stage_summary.items()],
                       "  per-stage measurements"))
    print(f"  twin: capacity {twin.max_rps:.3f} rec/s, "
          f"${twin.usd_per_hour:.4f}/h, base latency "
          f"{twin.base_latency_s * 1e3:.3f} ms")
    traffic = tr.TrafficModel.honda_default("nominal", R=30.0, G=1.0)
    slo = slo_mod.SLO(limit_s=4 * 3600, met_fraction=0.95)
    pk.reset_launches()
    row, wall_a, wall_s = forecast_on_card(whatif, twin, traffic, slo, "6a")
    check(pk.launches["policy_agg"] > 0 and pk.launches["policy_scan"] > 0,
          pk.launches)
    print(f"  forecast on the card (aggregate {wall_a:.1f} ms, series "
          f"{wall_s:.1f} ms wall), bitwise the CPU run's: "
          + json.dumps(whatif.table2_rows([row])[0]))


def wind_tunnel_serving(dev, eng, whatif, tr, slo_mod):
    """Phase 6b: the wind tunnel measures the full-size rwkv6-7b engine
    of 5g as a pipeline under test (``ServeEngine.as_pipeline``), fits a
    twin and forecasts its year on the card. Every count is set to 0 just
    before and read just after. Returns the launches, the experiment's
    result and its closed-form twin (phase 7 calibrates from them)."""
    from repro_torch.core.cost import CostModel
    from repro_torch.core.datagen import DataGenerator
    from repro_torch.core.experiment import Experiment
    from repro_torch.core.loadpattern import LoadPattern
    from repro_torch.core.schema import token_stream_schema
    from repro_torch.core.twin import fit_twin
    from repro_torch.kernels import policy_scan as pk
    dataset = DataGenerator(seed=SEED).generate(
        token_stream_schema(eng.cfg.vocab_size, 8), 256)
    eng.collector.clear()
    pipe = eng.as_pipeline()
    # a group (4 x 2,048 prefill tokens and 3 decode steps) takes ~0.5 s,
    # so full groups serve ~8 rec/s: the ramp tops out at twice that. A
    # tick of 0.5 s hands the stage batches of up to 4 records, one group
    # each, as the ramp nears its top
    load = LoadPattern.ramp("0->16rps", duration_s=20.0, peak_rate=16.0)
    exp = Experiment("serve-rwkv6-7b", pipe, load, dataset,
                     cost_model=CostModel(
                         chip_usd_per_hour=ASSUMED_H100_USD_PER_HOUR),
                     batch_records=4, tick_s=0.5, drain_timeout_s=120.0)
    mods = model_kernels()
    for mod in (pk,) + mods:
        mod.reset_launches()
    res = exp.run()
    check(res.drained and not pipe.errors,
          f"6b: drained={res.drained}, errors {pipe.errors[:3]}")
    check(res.records_done == res.records_sent > 0,
          (res.records_done, res.records_sent))
    twin = fit_twin(res, "fifo")
    rps = twin.max_rps
    traffic = tr.TrafficModel.honda_default("requests", R=0.4 * rps, G=1.3)
    slo = slo_mod.SLO(limit_s=30.0, met_fraction=0.99)
    row, wall_a, wall_s = forecast_on_card(whatif, twin, traffic, slo, "6b")
    launches = {k: v for mod in (pk,) + mods for k, v in
                mod.launches.items()}
    groups = eng.collector.spans("serve_group")
    check(len(eng.collector.spans("prefill")) == len(groups)
          and len(eng.collector.spans("decode")) == 3 * len(groups),
          "6b: a group's prefill or decode spans are missing")
    check(launches["rwkv6_chunked"] == 32 * len(groups)
          and launches["rwkv6_scan"] == 32 * 3 * len(groups), launches)
    check(launches["policy_agg"] > 0 and launches["policy_scan"] > 0,
          launches)
    check(np.isfinite(row.total_cost_usd) and row.total_cost_usd > 0,
          row.total_cost_usd)
    mean_ms = {name: 1e3 * float(np.mean([s.duration for s in
                                          eng.collector.spans(name)]))
               for name in ("serve_group", "prefill", "decode")}
    sizes = [s.records for s in groups]
    print(f"phase 6b: {eng.cfg.name} ({eng.cfg.num_layers} layers, d_model "
          f"{eng.cfg.d_model}) as the wind tunnel's pipeline under a 20 s "
          f"0->16 rec/s ramp: sent {res.records_sent}, done "
          f"{res.records_done} in {res.duration_s:.2f} s, {len(groups)} "
          f"groups (mean "
          f"{np.mean(sizes):.2f} records), sustained "
          f"{res.sustained_rps:.3f} rec/s; span means serve_group "
          f"{mean_ms['serve_group']:.1f} ms, prefill {mean_ms['prefill']:.1f}"
          f" ms, decode {mean_ms['decode']:.2f} ms")
    print(f"  assumed price ${ASSUMED_H100_USD_PER_HOUR:.2f} per H100-hour "
          f"(an assumption, not a measured price): pipeline "
          f"${res.cost['usd_per_hour']:.4f}/h, experiment "
          f"${res.cost['total_usd']:.4f}")
    print(f"  twin: {twin.policy}, capacity {twin.max_rps:.3f} rec/s, "
          f"${twin.usd_per_hour:.4f}/h, base latency "
          f"{twin.base_latency_s * 1e3:.2f} ms")
    print(f"  forecast: R = 0.4 x capacity = {0.4 * rps:.3f} rec/s, G 1.3, "
          f"SLO 30 s / 99%, on the card (aggregate {wall_a:.1f} ms, series "
          f"{wall_s:.1f} ms wall), bitwise the CPU run's: annual cost "
          f"${row.total_cost_usd:,.2f}, latency met "
          f"{row.pct_latency_met:.3f}%, SLO met {row.slo_met}")
    print(json.dumps({"windtunnel": {
        "phase": "6b", "model": eng.cfg.name, "layers": eng.cfg.num_layers,
        "records_sent": res.records_sent, "records_done": res.records_done,
        "duration_s": res.duration_s, "sustained_rps": res.sustained_rps,
        "groups": len(groups), "span_mean_ms": mean_ms,
        "assumed_usd_per_chip_hour": ASSUMED_H100_USD_PER_HOUR,
        "twin": {"policy": twin.policy, "params": list(twin.params)},
        "forecast": {"R": 0.4 * rps, "G": 1.3,
                     "annual_cost_usd": row.total_cost_usd,
                     "grand_total_usd": row.grand_total_usd,
                     "pct_latency_met": row.pct_latency_met,
                     "slo_met": row.slo_met},
        "launches": launches}}))
    return launches, res, twin


def whatif_trace(whatif, slo_mod, sweep_twins, growths256, rows_4b):
    """Phase 6c: 4b's 65,536-row aggregate sweep again, inside
    ``obs.capture()``: its rows bitwise 4b's (obs off), and where the
    sweep's wall goes, span by span."""
    from repro_torch import obs
    slo = slo_mod.SLO(limit_s=4 * 3600, met_fraction=0.95)
    with obs.capture() as rec:
        t0 = time.perf_counter()
        rows = whatif.run_grid(sweep_twins, growths256, slo=slo)
        wall = time.perf_counter() - t0
    same_results(rows, rows_4b, "6c: the 65,536 sweep with obs on vs 4b")
    print("phase 6c: the 65,536-row sweep of 4b inside obs.capture(): "
          f"{wall * 1e3:.1f} ms wall, rows bitwise 4b's")
    print(obs.render(rec))
    stats = obs.summarize(rec)
    spans = {name: {"count": s["count"], "total_ms": s["total_s"] * 1e3,
                    "share": s["total_s"] / wall}
             for name, s in stats.items() if name.startswith("grid.")}
    check({"grid.simulate", "grid.block"} <= set(spans), spans)
    counters = {name: rec.counter_total(name) for name in (
        "grid.scenarios", "grid.dedup.total", "grid.dedup.kept",
        "grid.blocks")}
    print(json.dumps({"trace": {
        "phase": "6c", "rows": len(rows), "wall_ms": wall * 1e3,
        "spans": spans, "counters": counters,
        "gauges": {k[0]: v for k, v in rec.gauges.items()}}}))


#: phase 7a's bounds, the card against the port on the CPU. Both run the
#: same IEEE float32 operations, one PyTorch kernel each; the log is
#: CUDA's and the CPU's (an ulp apart), and the card's cumsum of the
#: target rows associates otherwise (measured 4.8e-6 on the loss)
CAL_LOSS_RTOL = 1e-5
#: d loss / d params at the same parameters (denominator floored at 1e-6
#: of the largest entry, as the reference's gradient tests do)
CAL_GRAD_RTOL = 1e-5
#: d loss / d z end to end (the reparameterisation runs in float64 and
#: rounds once, so both devices fit the same parameters)
CAL_ZGRAD_RTOL = 1e-5
#: the reference test's recovery tolerance (tests/test_calibrate.py)
CAL_RECOVERY_RTOL = 0.05
#: 7b's and 7c's fit steps a restart, cut from the fits' 400 for the
#: script's time limit: 7b's recovery reads 2.45e-4 at 200 (the CPU; at
#: 400 the H100 read 7.52e-5), 7c holds the card's rows bitwise the
#: CPU's rows of the same twins at any step count
CAL_FIT_STEPS = 200


def cal_twins(twin_mod):
    """One ground-truth twin per built-in policy (tests/test_calibrate.py)."""
    return [twin_mod.SimpleTwin("fifo", 2.0, 0.05, 0.2),
            twin_mod.make_twin("quick", "quickscale", max_rps=2.0,
                               usd_per_hour=0.05, base_latency_s=0.2),
            twin_mod.make_twin("auto", "autoscale", max_rps=0.5,
                               usd_per_hour=0.01, base_latency_s=0.1,
                               max_instances=8, scale_up_hours=3),
            twin_mod.make_twin("shed", "shed", max_rps=2.0,
                               usd_per_hour=0.05, base_latency_s=0.2,
                               queue_cap_hours=1.5),
            twin_mod.make_twin("batch", "batch_window", max_rps=4.0,
                               usd_per_hour=0.01, base_latency_s=0.1,
                               window_hours=6)]


def grad_rel(a, b):
    """Largest |a - b| / max(|b|, 1e-6 max|b|) — the reference's gradient
    guard."""
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    floor = 1e-6 * max(float(b.abs().max()), 1.0)
    return float(((a - b).abs() / b.abs().clamp_min(floor)).max())


def loss_rel(a, b):
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def ramp_6h(lp):
    return lp.LoadPattern.ramp("ramp", duration_s=6 * 3600, peak_rate=6.0)


def calibration_gradients(dev, twin_mod):
    """Phase 7a: the fit's loss and gradient on the card against the port
    on the CPU, every policy, K = 16 lanes of a 6 h ramp in 300 s bins;
    the fault fold likewise; and the device memory of one streamed fit
    step at T = 8,736."""
    from repro_torch import calibrate as cal
    from repro_torch.calibrate import objective as obj
    from repro_torch.calibrate.fit import _as_operands
    from repro_torch.core import loadpattern as lp
    from repro_torch.core.traffic import TrafficModel
    from repro_torch.kernels import ops
    cpu = torch.device("cpu")
    k_lanes = 16
    out = {"policies": {}}
    for i, truth in enumerate(cal_twins(twin_mod)):
        trace = cal.ObservedTrace.from_loadpattern(ramp_6h(lp), truth,
                                                   bin_s=300.0)
        cpu_trace = cal.ObservedTrace.from_loadpattern(
            ramp_6h(lp), truth, bin_s=300.0, device="cpu")
        for f in ("processed", "latency_s", "dropped", "cost_usd"):
            assert_bitwise(f"7a {truth.policy} trace {f}",
                           np.asarray(getattr(trace, f), np.float32),
                           np.asarray(getattr(cpu_trace, f), np.float32))
        spec = cal.fit_spec(truth.policy)
        box = (spec.lo, spec.hi, spec.log_mask, spec.free_mask, spec.fixed)
        rng = np.random.default_rng(SEED + i)
        z = (cal.z_from_params(truth.padded_params(), spec.lo, spec.hi,
                               spec.log_mask)[None]
             + rng.normal(0.0, 0.7, (k_lanes, 6))).astype(np.float32)
        p = cal.params_from_z(torch.from_numpy(z), *box).numpy()
        got = []
        for where in (dev, cpu):
            ops_ = _as_operands(trace, None, where)
            zt = torch.tensor(z, device=where, requires_grad=True)
            loss = cal.lane_trace_loss(
                zt, *ops_, truth.policy_index, trace.bin_hours,
                *(torch.as_tensor(b, device=where) for b in box))
            loss.sum().backward()
            pt_ = torch.tensor(p, device=where, requires_grad=True)
            cal.lane_series_loss(pt_, *ops_, truth.policy_index,
                                 trace.bin_hours).sum().backward()
            got.append((loss.detach(), zt.grad, pt_.grad))
        (card_loss, card_gz, card_gp), (cpu_loss, cpu_gz, cpu_gp) = got
        errs = {"loss": loss_rel(card_loss, cpu_loss),
                "grad_z": grad_rel(card_gz, cpu_gz),
                "grad_params": grad_rel(card_gp, cpu_gp)}
        check(errs["loss"] <= CAL_LOSS_RTOL, (truth.policy, errs))
        check(errs["grad_z"] <= CAL_ZGRAD_RTOL, (truth.policy, errs))
        check(errs["grad_params"] <= CAL_GRAD_RTOL, (truth.policy, errs))
        out["policies"][truth.policy] = errs
    # the fault fold: shed's lanes through one outage (bins 30-37 of 72)
    # at the uniform blocks' rounding, the calibration loss folded in
    truth = cal_twins(twin_mod)[3]
    trace = cal.ObservedTrace.from_loadpattern(ramp_6h(lp), truth,
                                               bin_s=300.0, device="cpu")
    t_bins = trace.num_bins
    caps = np.ones((t_bins, k_lanes), np.float32)
    caps[30:38] = 0.0
    p = (np.tile(truth.padded_params(), (k_lanes, 1))
         * np.random.default_rng(SEED).uniform(0.8, 1.2, (k_lanes, 6))
         ).astype(np.float32)
    got = []
    for where in (dev, cpu):
        arrivals, targets, scales, weights = _as_operands(trace, None, where)
        xs, eps = obj._cal_operands(targets, scales)
        pt_ = torch.tensor(p, device=where, requires_grad=True)
        _, acc = ops.policy_scan_fold(
            params=pt_, dt_hours=trace.bin_hours,
            policy_index=truth.policy_index,
            loads_t=arrivals[:, None].expand(t_bins, k_lanes),
            caps_t=torch.from_numpy(caps).to(where),
            fold_init=obj._cal_fold_init, fold_step=obj._cal_fold,
            ops_lane=eps.expand(k_lanes, 4), xs=xs,
            acc_sinks=obj._CAL_SINKS)
        loss = obj._cal_combine(acc, weights, t_bins)
        loss.sum().backward()
        got.append((loss.detach(), pt_.grad))
    out["fault_fold"] = {"loss": loss_rel(got[0][0], got[1][0]),
                         "grad_params": grad_rel(got[0][1], got[1][1])}
    check(out["fault_fold"]["loss"] <= CAL_LOSS_RTOL, out["fault_fold"])
    check(out["fault_fold"]["grad_params"] <= CAL_GRAD_RTOL,
          out["fault_fold"])
    print("phase 7a: the fit's loss and gradient, card vs CPU, K = 16, "
          "T = 72, dt 1/12 (bounds: loss "
          f"{CAL_LOSS_RTOL:g}, d/d params {CAL_GRAD_RTOL:g}, d/d z "
          f"{CAL_ZGRAD_RTOL:g} relative):")
    for name, e in list(out["policies"].items()) + [
            ("shed fault fold", out["fault_fold"])]:
        print(f"  {name}: " + ", ".join(f"{k} {v:.2e}" for k, v in
                                         e.items()))
    # one streamed fit step over a year of hourly bins: the O(sqrt(T))
    # backward holds entry states and one segment's tape, never the
    # [K, T] series the materialised loss holds
    year = TrafficModel.honda_default("nom").hourly_loads()
    trace = cal.ObservedTrace.from_simulation(
        twin_mod.SimpleTwin("fifo", RPS, USD_HR, LAT), year, 1.0,
        name="year")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cal.fit(trace, "fifo", restarts=k_lanes, steps=1, seed=SEED)
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    series = 5 * k_lanes * trace.num_bins * 4
    check(peak < series, ("7a: a streamed fit step held", peak,
                          "bytes; the five [K, T] series are", series))
    out["memory"] = {"t_bins": trace.num_bins, "lanes": k_lanes,
                     "peak_bytes": peak, "series_bytes": series,
                     "step_s": step_s}
    print(f"  one streamed fit step, K = 16, T = {trace.num_bins:,}: "
          f"{step_s:.2f} s, peak device memory {peak / 1e6:.3f} MB above "
          f"the operands, against {series / 1e6:.3f} MB for the five "
          f"[K, T] series it does not hold")
    return out


def fit_profile(trace, policy, restarts, steps):
    """``steps`` fit steps under ``torch.profiler``: wall, summed kernel
    time, busy share and kernel launches per step; None where the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import calibrate as cal
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cal.fit(trace, policy, restarts=restarts, steps=steps, seed=SEED)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if not dev_us:
        return None
    return {"wall_ms": wall_us / steps / 1e3,
            "device_ms": dev_us / steps / 1e3, "busy": dev_us / wall_us,
            "launches": sum(e.count for e in kernels) / steps}


def calibration_recovery(dev, twin_mod):
    """Phase 7b: the first part of examples/calibrate_twin.py on the card
    — shed's parameters recovered from a noiseless 6 h ramp replay (72
    bins of 300 s), 8 restarts x CAL_FIT_STEPS steps; then 5 more steps
    under the profiler."""
    from repro_torch import calibrate as cal
    from repro_torch.core import loadpattern as lp
    truth = twin_mod.make_twin("t", "shed", max_rps=2.0, usd_per_hour=0.05,
                               base_latency_s=0.2, queue_cap_hours=1.5)
    trace = cal.ObservedTrace.from_loadpattern(ramp_6h(lp), truth,
                                               bin_s=300.0)
    steps = CAL_FIT_STEPS
    t0 = time.perf_counter()
    res = cal.fit(trace, "shed", restarts=8, steps=steps, seed=0)
    wall = time.perf_counter() - t0
    tp = truth.padded_params()
    errs = {n: float(abs(res.params[i] - tp[i]) / tp[i])
            for i, n in enumerate(res.spec.param_names)
            if res.spec.free_mask[i]}
    check(max(errs.values()) < CAL_RECOVERY_RTOL, ("7b", errs))
    prof = fit_profile(trace, "shed", 8, 5)
    if prof is not None:
        # the profiler's own host work stretches the wall it sees: the
        # device time over the unprofiled step's wall as well
        prof["busy_unprofiled"] = prof["device_ms"] / (1e3 * wall / steps)
    print(f"phase 7b: shed recovered on the card from a 6 h ramp (72 bins "
          f"of 300 s), 8 restarts x {steps} steps in {wall:.2f} s "
          f"({steps / wall:.1f} steps/s); worst parameter error "
          f"{max(errs.values()):.2e} (bound {CAL_RECOVERY_RTOL:g})")
    if prof is None:
        print("  profile: the profiler saw no device time (busy share "
              "and launches per step not measured)")
    else:
        print(f"  profile over 5 steps, per step: wall "
              f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.3f} "
              f"ms, busy {prof['busy']:.1%} ({prof['busy_unprofiled']:.1%}"
              f" of the unprofiled step's {1e3 * wall / steps:.2f} ms), "
              f"{prof['launches']:.0f} kernel launches")
    return {"wall_s": wall, "steps": steps, "steps_per_s": steps / wall,
            "restarts": 8, "t_bins": trace.num_bins, "rel_err": errs,
            "loss": res.loss, "profile": prof}


def calibrated_table(whatif, tr, slo_mod, res_6b, twin_6b):
    """Phase 7c: 6b's measured experiment over the full-size rwkv6-7b
    engine -> fifo and shed twins fitted at 1 s bins (the fit's defaults,
    16 restarts x CAL_FIT_STEPS steps, 6b's closed-form twins as warm
    starts) ->
    Table II rows of 6b's traffic, out of the aggregate kernel on the
    card, bitwise the CPU's rows of the same twins."""
    from repro_torch import obs
    from repro_torch.kernels import policy_scan as pk
    traffic = tr.TrafficModel.honda_default("requests",
                                            R=0.4 * twin_6b.max_rps, G=1.3)
    slo = slo_mod.SLO(limit_s=30.0, met_fraction=0.99)
    agg0 = pk.launches["policy_agg"]
    with obs.capture() as rec:
        t0 = time.perf_counter()
        rows = whatif.calibrated_grid(res_6b, ["fifo", "shed"], [traffic],
                                      slo=slo, bin_s=1.0, seed=SEED,
                                      steps=CAL_FIT_STEPS)
        wall = time.perf_counter() - t0
    check(pk.launches["policy_agg"] > agg0, "7c: no aggregate launch")
    cpu = whatif.run_grid([r.twin for r in rows], [traffic], slo=slo,
                          device="cpu")
    same_results(rows, cpu, "7c: calibrated rows, card vs CPU")
    fits = rec.find(name="calibrate.fit")
    check([s.attrs["policy"] for s in fits] == ["fifo", "shed"], fits)
    fit_s = {s.attrs["policy"]: s.duration for s in fits}
    t_bins = int(fits[0].attrs["t_bins"])
    print(f"phase 7c: {res_6b.name} ({res_6b.records_sent} records in "
          f"{res_6b.duration_s:.2f} s) binned at 1 s ({t_bins} bins), fifo "
          f"and shed fitted on the card (16 restarts x {CAL_FIT_STEPS} "
          f"steps: fifo "
          f"{fit_s['fifo']:.2f} s, shed {fit_s['shed']:.2f} s), Table II "
          f"at R = 0.4 x capacity, G 1.3, SLO 30 s / 99% through the "
          f"aggregate kernel, bitwise the CPU rows ({wall:.2f} s in all)")
    fifo = rows[0].twin
    print(f"  fifo: calibrated capacity {fifo.max_rps:.3f} rec/s, "
          f"${fifo.usd_per_hour:.4f}/h, base latency "
          f"{fifo.base_latency_s * 1e3:.1f} ms; closed-form (6b) "
          f"{twin_6b.max_rps:.3f} rec/s, ${twin_6b.usd_per_hour:.4f}/h, "
          f"{twin_6b.base_latency_s * 1e3:.1f} ms")
    print(json.dumps(whatif.table2_rows(rows)))
    return {"t_bins": t_bins, "fit_s": fit_s, "wall_s": wall,
            "twins": {r.twin.policy: list(r.twin.params) for r in rows},
            "closed_form_fifo": list(twin_6b.params),
            "annual_cost_usd": {r.twin.policy: r.total_cost_usd
                                for r in rows}}


def otel_roundtrip():
    """Phase 7d: 6a's telemetry experiment under ``obs.capture()``; its
    ``stage.*`` spans through ``obs.to_otel_spans`` into
    ``ObservedTrace.from_otel_spans``, and a fifo fit of that trace on the
    card, recorded as a ``calibrate.fit`` span with its counters."""
    from repro_torch import calibrate as cal
    from repro_torch import obs
    with obs.capture() as rec:
        telemetry_experiment("7d")
    spans = obs.to_otel_spans(rec, prefix="stage.")
    check(spans and all(d["records"] >= 1 for d in spans), "7d: no spans")
    trace = cal.ObservedTrace.from_otel_spans(spans, bin_seconds=0.25,
                                              name="obs-roundtrip")
    check(float(np.sum(trace.arrivals)) == sum(d["records"] for d in spans),
          "7d: the trace lost records")
    with obs.capture() as rec:
        res = cal.fit(trace, "fifo", restarts=4, steps=60, seed=SEED)
    check(np.isfinite(res.loss) and res.twin.max_rps > 0, res.loss)
    (span,) = rec.find(name="calibrate.fit")
    check(span.attrs["policy"] == "fifo" and span.attrs["restarts"] == 4
          and span.attrs["steps"] == 60, span.attrs)
    check(rec.counter_total("calibrate.fits") == 1
          and rec.counter_total("calibrate.restarts") == 4, rec.counters)
    print(f"phase 7d: {len(spans)} stage spans of the telemetry experiment "
          f"-> OTel dicts -> a {trace.num_bins}-bin trace -> a fifo fit on "
          f"the card (4 x 60 steps, {span.duration:.2f} s): capacity "
          f"{res.twin.max_rps:.2f} rec/s; calibrate.fit span and counters "
          f"recorded")
    return {"spans": len(spans), "t_bins": trace.num_bins,
            "fit_s": span.duration, "twin": list(res.twin.params)}


def calibration_on_card(dev, whatif, tr, twin_mod, slo_mod, res_6b,
                        twin_6b):
    """Phase 7, the calibration slice on the card: 7a gradients, 7b the
    example's recovery, 7c the full-size loop (6b's experiment -> fitted
    twins -> Table II), 7d the OTel round trip. Returns phase 7's numbers
    and the policy kernels' launches in it."""
    from repro_torch.kernels import policy_scan as pk
    mods = model_kernels()
    for mod in (pk,) + mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    out = {"7a": calibration_gradients(dev, twin_mod),
           "7b": calibration_recovery(dev, twin_mod),
           "7c": calibrated_table(whatif, tr, slo_mod, res_6b, twin_6b),
           "7d": otel_roundtrip()}
    out["wall_s"] = time.perf_counter() - t0
    launches = dict(pk.launches)
    check(launches["policy_scan"] > 0 and launches["policy_agg"] > 0,
          launches)
    check(sum(sum(m.launches.values()) for m in mods) == 0,
          "a model kernel ran in phase 7")
    out["launches"] = launches
    print(f"phase 7: {out['wall_s']:.1f} s")
    print(json.dumps({"calibrate": out}))
    return launches


#: the reference's answers to What-if #6, #6b and #7
#: (examples/whatif_analysis.py:215-245, :269-292): ``repro`` jitted on
#: XLA:CPU, seed 0 — the base and winning configurations' exact annual
#: cost, the best feasible row of the 4,096-point grid over the same
#: space, the frontier's exact costs (limits 0.5, 1, 2 and 8 h), and the
#: chance-constrained winner's
WHATIF6_BASE_USD = 102.8633832205087
WHATIF6_USD = 84.04913610160897
WHATIF6_GRID_USD = 83.21698596986455
WHATIF6B_USD = (101.32187686860561, 101.32187686860561, 101.32187686860561,
                82.54393454987803)
WHATIF7_USD = 85.22218589553681
#: the reference's answers (XLA:CPU, seed 0) to 8b's and 8c's calls under
#: the cut, ``coarsen=SEARCH_CUT_COARSEN``: the #6b frontier's cost at
#: each of the four limits, and What-if #7's winner
WHATIF6B_C12_USD = 94.6702634356916
WHATIF7_C12_USD = 84.52376812556908
#: a winner's exact cost against the reference's (under the cut too, and
#: there against the port's CPU run of the same call as well); the grid's
#: best row against the
#: reference's; p95 / p99 off the histogram against the series: one
#: quarter-octave bucket (tests/test_search.py:301)
SEARCH_RTOL = 0.01
GRID_RTOL = 1e-9
P_BUCKET_LOG2 = 0.26
#: What-if #6's free parameters and sizes (8a); 8b and 8c take the
#: example's sizes at ``SEARCH_CUT_COARSEN`` bins a gradient-loop bin
SEARCH_FREE = ("max_instances", "scale_up_hours")
SEARCH_COARSEN = 4
SEARCH_CUT_COARSEN = 12
FRONTIER_LIMITS = (1800.0, 3600.0, 7200.0, 28800.0)
#: the CPU side of phase 8 runs in a second process with this many
#: threads, beside the card's host thread, and is given this long
CPU_SEARCH_THREADS = 4
CPU_SEARCH_TIMEOUT_S = 900
#: float32 operations per lane-bin of the vectorised search objective
#: (the compliance sigmoid and the violation softplus with their sums,
#: the cost sum), beside the policy step's POLICY_OPS; a backward is
#: counted at twice its forward
SEARCH_OBJ_OPS = 20
BACKWARD_OPS_FACTOR = 2


def search_problem(tr, twin_mod, slo_mod):
    """What-if #6's problem: the +40% surge year, p95 under 2 h, the
    example's autoscale base twin."""
    surge = tr.TrafficModel.honda_default("surge(+40%)", R=3.5, G=1.4)
    slo = slo_mod.SLO(limit_s=2 * 3600, met_fraction=0.95)
    base = twin_mod.make_twin("autoscale-base", "autoscale", max_rps=RPS,
                              usd_per_hour=USD_HR, base_latency_s=LAT,
                              max_instances=8, scale_up_hours=2)
    return surge, slo, base


def search_loop_run(space, surge, base_cost, coarsen, steps, restarts=6):
    """``steps`` steps of What-if #6's gradient loop on the card (the
    search's own ``_run_kernel``, its read-back included)."""
    from repro_torch.search import optimize as so
    loads = surge.hourly_loads()[None].astype(np.float32)
    g, g_bin = so._coarsen(loads, 1.0, coarsen)
    ocfg = dataclasses.replace(so.DEFAULT_SEARCH_OPT, total_steps=60)
    return so._run_kernel(
        space, g, g_bin, np.ones(1, np.float32), space.z0(restarts, SEED),
        np.full(restarts, 2 * 3600.0), 0, 0.952, so.DEFAULT_PENALTY_WEIGHT,
        base_cost, so.annual_scale(g.shape[1], g_bin), steps, ocfg)


def search_step_profile(space, surge, base_cost):
    """One step of 8a's gradient loop (K = 6, 2,184 bins): the PyTorch
    operations it dispatches (counted by a dispatch mode), then one more
    under ``torch.profiler`` for its wall, device time, launches and busy
    share; the wall of one step at full resolution (8,736 bins) for
    ROADMAP A2; and the least time a step could take."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            OpCount.n += 1
            return func(*args, **(kwargs or {}))

    with OpCount():
        search_loop_run(space, surge, base_cost, SEARCH_COARSEN, 1)
    out = {"ops": OpCount.n}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search_loop_run(space, surge, base_cost, SEARCH_COARSEN, 1)
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)
    out.update({"wall_ms": wall_us / 1e3,
                "device_ms": dev_us / 1e3 if dev_us else None,
                "busy": dev_us / wall_us if dev_us else None,
                "launches": (sum(e.count for e in kernels)
                             if dev_us else None)})
    t0 = time.perf_counter()
    search_loop_run(space, surge, base_cost, 1, 1)
    out["full_resolution_step_s"] = time.perf_counter() - t0
    # the least time a step could take on the card: its operations (the
    # autoscale step and the objective on K x T lane-bins, forward and
    # backward) over the float32 peak, or its bytes (the load row read,
    # the parameters and the gradient written) over HBM
    lane_bins = 6 * (HOURS_PER_YEAR // SEARCH_COARSEN)
    ops = (lane_bins * (POLICY_OPS[2] + SEARCH_OBJ_OPS)
           * (1 + BACKWARD_OPS_FACTOR))
    nbytes = 4 * (HOURS_PER_YEAR // SEARCH_COARSEN + 2 * 6 * 6)
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    out["bound_ms"] = 1e3 * max(t_ops, t_bytes)
    out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


def whatif6_on_card(whatif, surge, slo, base):
    """Phase 8a: What-if #6 at the example's size through
    ``optimize_scenario`` on the card (a 2,184-bin gradient loop, the
    polish and the exact re-checks at 8,736 hourly bins through the
    aggregate kernel), held against the reference's answer; the winner's
    rows card vs CPU and its series-mode percentiles; then the
    4,096-point grid of the same space through ``run_grid`` on the
    card. (``search_on_card`` holds it against the same call on the
    CPU.)"""
    from repro_torch import obs
    kw = whatif6_kwargs()
    with obs.capture() as rec:
        t0 = time.perf_counter()
        res = whatif.optimize_scenario(base, [surge], slo, **kw)
        wall = time.perf_counter() - t0
    (span,) = rec.find(name="search.kernel")
    check(res.feasible and res.cost_usd < WHATIF6_BASE_USD,
          ("8a", res.feasible, res.cost_usd))
    check(abs(res.base_cost_usd / WHATIF6_BASE_USD - 1.0) <= GRID_RTOL,
          ("8a base", res.base_cost_usd))
    ref_gap = res.cost_usd / WHATIF6_USD - 1.0
    check(abs(ref_gap) <= SEARCH_RTOL, ("8a vs the reference", res.cost_usd,
                                        WHATIF6_USD))
    rows = whatif.run_grid([res.twin], [surge], slo=slo)
    same_results(rows, whatif.run_grid([res.twin], [surge], slo=slo,
                                       device="cpu"),
                 "8a: the winner's rows, card vs CPU")
    check(rows[0].total_cost_usd == res.cost_usd, (rows[0].total_cost_usd,
                                                   res.cost_usd))
    series = whatif.run_grid([res.twin], [surge], slo=slo,
                             return_series=True)
    p_log2 = {k: float(np.log2(getattr(rows[0], k) / getattr(series[0], k)))
              for k in ("p95_latency_s", "p99_latency_s")}
    check(all(abs(v) <= P_BUCKET_LOG2 for v in p_log2.values()), p_log2)
    grid = res.space.grid(4096)
    t0 = time.perf_counter()
    grid_rows = whatif.run_grid(grid, [surge], slo=slo)
    grid_wall = time.perf_counter() - t0
    feasible = [r.total_cost_usd for r in grid_rows if r.slo_met]
    grid_best = min(feasible)
    check(abs(grid_best / WHATIF6_GRID_USD - 1.0) <= GRID_RTOL,
          ("8a grid", grid_best, WHATIF6_GRID_USD))
    print(f"phase 8a: What-if #6 on the card, autoscale {SEARCH_FREE}, 6 "
          f"restarts x 60 steps at {span.attrs['t_bins']} bins (coarsen "
          f"{SEARCH_COARSEN}), re-checked at 8736 h: {wall:.1f} s "
          f"(gradient loop {span.duration:.1f} s, "
          f"{60 / span.duration:.2f} steps/s)")
    print(f"  winner {res.config()}: ${res.cost_usd:.4f}/yr (base "
          f"${res.base_cost_usd:.4f}; reference ${WHATIF6_USD:.4f}, gap "
          f"{ref_gap:+.2e}); p95 {rows[0].p95_latency_s:.1f} s")
    print(f"  the winner's rows bitwise the CPU's; series p95/p99 within "
          + ", ".join(f"{v:+.3f}" for v in p_log2.values())
          + " octave of the histogram's")
    print(f"  the 4,096-point grid through run_grid: {grid_wall:.2f} s, "
          f"{len(feasible)} feasible rows, best ${grid_best:.4f} "
          f"(reference ${WHATIF6_GRID_USD:.4f}); search vs grid "
          f"{res.cost_usd / grid_best - 1.0:+.2%}")
    return res, grid, {
        "wall_s": wall, "loop_s": span.duration,
        "steps_per_s": 60 / span.duration, "t_bins": span.attrs["t_bins"],
        "cost_usd": res.cost_usd, "config": res.config(),
        "base_cost_usd": res.base_cost_usd, "ref_gap": ref_gap,
        "p_log2": p_log2, "grid_wall_s": grid_wall,
        "grid_best_usd": grid_best, "grid_feasible": len(feasible),
        "search_vs_grid": res.cost_usd / grid_best - 1.0}


def frontier_on_card(space, surge):
    """Phase 8b: What-if #6b, the cost-vs-p95 frontier over four limits,
    all targets as lanes of one gradient loop on the card."""
    from repro_torch import obs
    from repro_torch.search import pareto_frontier
    with obs.capture() as rec:
        t0 = time.perf_counter()
        fr = pareto_frontier(space, [surge], slo_limits=FRONTIER_LIMITS,
                             restarts=4, steps=60,
                             coarsen=SEARCH_CUT_COARSEN, seed=SEED)
        wall = time.perf_counter() - t0
    spans = rec.find(name="search.kernel")
    check(len(spans) == 1 and spans[0].attrs["restarts"] == 16, spans)
    costs = [p.cost_usd for p in fr.points]
    check(all(p.feasible for p in fr.points), costs)
    check(all(b <= a + 1e-9 for a, b in zip(costs, costs[1:])), costs)
    gaps = [c / WHATIF6B_C12_USD - 1.0 for c in costs]
    check(all(abs(g) <= SEARCH_RTOL for g in gaps),
          ("8b vs the reference under the cut", costs, WHATIF6B_C12_USD))
    print(f"phase 8b: What-if #6b frontier, limits "
          f"{[int(x) for x in FRONTIER_LIMITS]} s, 4 restarts x 4 targets "
          f"in one loop ({spans[0].attrs['t_bins']} bins): {wall:.1f} s; "
          f"$" + " / ".join(f"{c:.2f}" for c in costs)
          + f" (reference at coarsen {SEARCH_CUT_COARSEN}: "
          f"${WHATIF6B_C12_USD:.4f} at each, gaps "
          + ", ".join(f"{g:+.2e}" for g in gaps)
          + "; at coarsen 4: $"
          + " / ".join(f"{c:.2f}" for c in WHATIF6B_USD) + ")")
    return {"wall_s": wall, "loop_s": spans[0].duration,
            "t_bins": spans[0].attrs["t_bins"], "costs": costs,
            "ref_gaps": gaps, "configs": [p.config for p in fr.points]}


#: 8c's gradient steps, cut from the example's 60 for the script's time
#: limit: the port's CPU run at 15, 20 and 30 steps finds the 60-step
#: winner, {max_instances 9.399, scale_up_hours 34.233}, $84.5238,
#: 1.27e-8 from the reference's 60-step answer (WHATIF7_C12_USD)
WHATIF7_STEPS = 15


def whatif7_kwargs(faults):
    """What-if #7's resilient search (examples/whatif_analysis.py:269-292):
    outage, disconnect and brownout, 4 futures, seed 0, quantile 0.95;
    WHATIF7_STEPS steps."""
    chaos = faults.FaultSchedule(
        specs=(faults.outage(rate_per_year=6, duration_hours=(1, 4)),
               faults.disconnect(rate_per_year=12,
                                 disconnect_frac=(0.2, 0.5),
                                 flood_hours=1.0),
               faults.brownout(rate_per_year=8, capacity_mult=(0.3, 0.7))),
        n_futures=4, seed=0)
    return dict(search=SEARCH_FREE, faults=chaos, quantile=0.95, restarts=4,
                steps=WHATIF7_STEPS, coarsen=SEARCH_CUT_COARSEN, seed=SEED)


def whatif6_kwargs():
    return dict(search=SEARCH_FREE, restarts=6, steps=60,
                coarsen=SEARCH_COARSEN, seed=SEED)


def search_cpu(out_path):
    """The CPU side of phase 8, run by a second process beside the card's
    (``--search-cpu PATH``): What-if #6's call with ``device="cpu"``,
    and, under the cut, What-if #7's; writes their winners to PATH."""
    from repro_torch import faults
    from repro_torch.core import slo as slo_mod
    from repro_torch.core import traffic as tr
    from repro_torch.core import twin as twin_mod
    from repro_torch.core import whatif
    torch.set_num_threads(CPU_SEARCH_THREADS)
    surge, slo, base = search_problem(tr, twin_mod, slo_mod)
    out = {}
    runs = [("8a", whatif6_kwargs())]
    if SEARCH_CUT_COARSEN != SEARCH_COARSEN:
        runs.append(("8c", whatif7_kwargs(faults)))
    for key, kw in runs:
        t0 = time.perf_counter()
        res = whatif.optimize_scenario(base, [surge], slo, device="cpu",
                                       **kw)
        out[key] = {"wall_s": time.perf_counter() - t0,
                    "cost_usd": res.cost_usd, "feasible": res.feasible,
                    "config": res.config()}
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def resilient_on_card(whatif, faults, surge, slo, base):
    """Phase 8c: What-if #7's chance-constrained search on the card, its
    exact re-check through the fault aggregate kernel."""
    from repro_torch import obs
    from repro_torch.kernels import policy_scan as pk
    kw = whatif7_kwargs(faults)
    fault0 = pk.launches["policy_agg_fault"]
    with obs.capture() as rec:
        t0 = time.perf_counter()
        res = whatif.optimize_scenario(base, [surge], slo, **kw)
        wall = time.perf_counter() - t0
    fault_launches = pk.launches["policy_agg_fault"] - fault0
    check(fault_launches > 0, "8c: the fault aggregate kernel never ran")
    (span,) = rec.find(name="search.kernel")
    check(res.feasible and res.achieved_quantile >= 0.95,
          ("8c", res.feasible, res.achieved_quantile))
    print(f"phase 8c: What-if #7 resilient search, 4 restarts x 4 futures "
          f"x {WHATIF7_STEPS} steps ({span.attrs['t_bins']} bins): "
          f"{wall:.1f} s; {res.config()} "
          f"${res.cost_usd:.4f}/yr, achieved quantile "
          f"{res.achieved_quantile:.2f}; {fault_launches} fault aggregate "
          f"launches")
    return {"wall_s": wall, "loop_s": span.duration,
            "t_bins": span.attrs["t_bins"], "cost_usd": res.cost_usd,
            "config": res.config(), "achieved_quantile":
            res.achieved_quantile, "fault_agg_launches": fault_launches}


def search_on_card(dev, whatif, tr, twin_mod, slo_mod, faults):
    """Phase 8, policy search on the card: 8a What-if #6 (and its 4,096-
    point grid), 8b the What-if #6b frontier, 8c What-if #7's
    chance-constrained search; the policy kernels' launches in them read
    from 0; then the grid's aggregate launch against its plain version,
    the step profile, and a ``{"search": ...}`` line."""
    import tempfile
    from repro_torch.kernels import policy_scan as pk
    mods = model_kernels()
    for mod in (pk,) + mods:
        mod.reset_launches()
    surge, slo, base = search_problem(tr, twin_mod, slo_mod)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the same calls on the CPU, in a second process beside the card's
        cpu_path = os.path.join(tmp, "search_cpu.json")
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--search-cpu", cpu_path])
        try:
            res6, grid, out_a = whatif6_on_card(whatif, surge, slo, base)
            out = {"8a": out_a, "8b": frontier_on_card(res6.space, surge),
                   "8c": resilient_on_card(whatif, faults, surge, slo,
                                           base)}
            out["wall_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            check(proc.wait(timeout=CPU_SEARCH_TIMEOUT_S) == 0,
                  "the CPU runs of phase 8 failed")
            out["cpu_wait_s"] = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(cpu_path) as f:
            cpu = json.load(f)
    a, c = out["8a"], out["8c"]
    a["cpu"] = cpu["8a"]
    a["cpu_gap"] = a["cost_usd"] / cpu["8a"]["cost_usd"] - 1.0
    a["param_diff"] = {n: a["config"][n] - cpu["8a"]["config"][n]
                       for n in SEARCH_FREE}
    check(cpu["8a"]["feasible"] and abs(a["cpu_gap"]) <= SEARCH_RTOL,
          ("8a card vs CPU", a["cost_usd"], cpu["8a"]))
    if "8c" in cpu:
        # under the cut, the reference's answer to the same call, and the
        # port's own CPU run of it as a second bar
        c["cpu"] = cpu["8c"]
        c["cpu_gap"] = c["cost_usd"] / cpu["8c"]["cost_usd"] - 1.0
        check(abs(c["cpu_gap"]) <= SEARCH_RTOL,
              ("8c vs the CPU run", c["cost_usd"], cpu["8c"]))
        against, what = WHATIF7_C12_USD, (f"the reference's (coarsen "
                                          f"{SEARCH_CUT_COARSEN})")
    else:
        against, what = WHATIF7_USD, "the reference's"
    c["gap"] = c["cost_usd"] / against - 1.0
    check(abs(c["gap"]) <= SEARCH_RTOL, ("8c", c["cost_usd"], what,
                                         against))
    print(f"phase 8a-8c on the CPU ({cpu['8a']['wall_s']:.1f} s for 8a"
          + (f", {cpu['8c']['wall_s']:.1f} s for 8c" if "8c" in cpu else "")
          + f", beside the card's runs): 8a {cpu['8a']['config']} "
          f"${cpu['8a']['cost_usd']:.4f}/yr, card - CPU {a['cpu_gap']:+.2e} "
          f"relative, parameters "
          + ", ".join(f"{n} {d:+.3g}" for n, d in a["param_diff"].items())
          + f"; 8c against {what} ${against:.4f}: {c['gap']:+.2e}"
          + (f", against the CPU run's ${cpu['8c']['cost_usd']:.4f}: "
             f"{c['cpu_gap']:+.2e}" if "8c" in cpu else ""))
    launches = dict(pk.launches)
    check(launches["policy_agg"] > 0 and launches["policy_scan"] > 0
          and launches["policy_agg_fault"] > 0, launches)
    check(sum(sum(m.launches.values()) for m in mods) == 0,
          "a model kernel ran in phase 8")
    out["launches"] = launches
    out["grid_kernel"] = kernel_vs_plain(
        "policy_agg", "4,096 x 8736 (What-if #6 grid)",
        grid_operands(grid, [surge], dev), True)
    out["step"] = search_step_profile(res6.space, surge, res6.base_cost_usd)
    st = out["step"]
    print(f"phase 8: {out['wall_s']:.1f} s; one gradient-loop step (K = 6, "
          f"{out_a['t_bins']} bins): {st['ops']:,} PyTorch operations, "
          + (f"{st['wall_ms']:.1f} ms wall under the profiler, device "
             f"{st['device_ms']:.2f} ms, busy {st['busy']:.1%}, "
             f"{st['launches']:.0f} kernel launches"
             if st["busy"] is not None else
             "the profiler saw no device time (busy share and launches "
             "not measured)")
          + f"; a step at 8,736 bins: {st['full_resolution_step_s']:.2f} s; "
          f"bound of a step {st['bound_ms']:.2e} ms ({st['bound_by']})")
    print(json.dumps({"search": out}))
    return launches


#: the flash kernel's prefill shapes on the serving paths, (b, s, h, kh,
#: dqk, dv, causal): Jamba-1.5 (5d), llama3.2-1b (9c), moonshot-v1-16b-a3b
#: (9d), phi3.5-moe (9e), stablelm-3b (10c), gemma-7b (10d), minicpm3-4b's
#: MLA (10e), qwen2-vl-7b (10f), whisper-small's encoder (10g), a rank's
#: heads of llama3.2-1b over model=2 (14a), 14f's rank (float32: its
#: prompts right-padded to max_len // 2 = 512) and 14g's rank (float32:
#: whisper-small's encoder over every head, the fall-back)
FLASH_SHAPES = {"5d": (4, 2048, 64, 8, 128, 128, True),
                "9c": (4, 2048, 32, 8, 64, 64, True),
                "9d": (4, 2048, 16, 16, 128, 128, True),
                "9e": (4, 2048, 32, 8, 128, 128, True),
                "10c": (4, 2048, 32, 32, 80, 80, True),
                "10d": (4, 2048, 16, 16, 256, 256, True),
                "10e": (4, 2048, 40, 40, 96, 64, True),
                "10f": (4, 2048, 28, 4, 128, 128, True),
                "10g": (4, 1500, 12, 12, 64, 64, False),
                "14a": (4, 2048, 16, 4, 64, 64, True),
                "14f": (4, 512, 16, 4, 64, 64, True),
                "14g": (4, 1500, 12, 12, 64, 64, False),
                # DeepSeek-V2-Lite's absorbed MLA prefill (q/k 512 + 64,
                # v 512, 16 heads over one latent head): the wide kernels
                "11": (4, 2048, 16, 1, 576, 512, True)}


def serve_rope_moe(dev, get_config, get_smoke_config):
    """Phase 9, serving RoPE and MoE: 9a the CLI
    (``repro_torch.launch.serve``) on smoke llama3.2, on the card; 9b
    smoke llama3.2 and smoke moonshot (the published capacity factor) at
    4 layers, card against CPU; then the main paths at every published
    width, each from a card that holds no earlier engine: 9c llama3.2-1b
    whole (16 layers), 9d moonshot-v1-16b-a3b cut to 12 of its 48
    layers (to keep the script inside its time limit), 9e
    phi3.5-moe cut to 8 of its 32 layers (its 83.7 GB of bf16 weights
    do not fit one card; 8 to keep the script inside its time limit). Then the flash kernel against its plain version
    at each one's prefill shape. Returns the model kernels' launches
    summed over 9c-9e, and the flash rows."""
    from repro_torch.launch import serve as launch_serve
    fk, _, _ = model_kernels()
    t0 = time.perf_counter()
    fk.reset_launches()
    launch_serve.main(["--arch", LLAMA, "--requests", "8", "--rate", "16",
                       "--device", "cuda"])
    a_flash = dict(fk.launches)
    check(a_flash["flash_attention"] > 0
          and a_flash["flash_attention"] % 2 == 0
          and a_flash["flash_attention_f32"] == 0, a_flash)
    print(f"phase 9a: python -m repro_torch.launch.serve --arch {LLAMA} "
          f"--device cuda served on the card ({a_flash['flash_attention']} "
          f"bf16 flash launches at head dim "
          f"{get_smoke_config(LLAMA).attention.head_dim}); "
          f"{time.perf_counter() - t0:.1f} s")
    for arch in (LLAMA, MOONSHOT):
        cfg = dataclasses.replace(get_smoke_config(arch), num_layers=4,
                                  dtype="float32")
        check_smoke_slice(dev, "9b", cfg, f"{cfg.name} (4 layers, float32"
                          + (f", capacity factor {cfg.moe.capacity_factor}"
                             if cfg.moe else "") + ")")
    launches, runs = {}, {}
    for phase, arch, layers, label in (
            ("9c", LLAMA, None, "at all 16 layers"),
            ("9d", MOONSHOT, 12, "cut to 12 of its 48 layers (57.8 GB of "
             "bf16 weights whole; cut to keep the script inside its time "
             "limit)"),
            ("9e", PHI, 8, "cut to 8 of its 32 layers (83.7 GB of bf16 "
             "weights whole; cut to keep the script inside its time "
             "limit)")):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        expect = {"flash_attention": 2 * cfg.num_layers,
                  "flash_attention_f32": 0, "ssm_scan": 0,
                  "rwkv6_chunked": 0, "rwkv6_scan": 0}
        got, eng, runs[phase] = serve_at_width(dev, phase, cfg, label,
                                               expect)
        del eng
        torch.cuda.empty_cache()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    flash = {phase: flash_vs_plain(dev, phase) for phase in ("9c", "9d",
                                                             "9e")}
    wall = time.perf_counter() - t0
    print(f"phase 9: {wall:.1f} s; "
          + "; ".join(f"{p} {r['model']} ({r['layers']} layers): TTFT p50 "
                      f"{r['ttft_ms_p50']:.1f} ms, decode "
                      f"{r['decode_step_ms']:.2f} ms a step (floor "
                      f"{r['decode_floor_ms']:.2f}), "
                      f"{r['tokens_per_s']:.1f} tokens/s"
                      for p, r in runs.items()))
    return launches, flash


STABLELM = "stablelm-3b"
GEMMA = "gemma-7b"
MINICPM = "minicpm3-4b"
QWEN_VL = "qwen2-vl-7b"
WHISPER = "whisper-small"
#: whisper-small at width (10g): 4 rows of frames, prompts of 64-224
#: tokens right-padded to 224 inside its 448-token decoder context, 32
#: greedy decode steps
WHISPER_ROWS, WHISPER_PREFILL, WHISPER_MAX_LEN, WHISPER_STEPS = 4, 224, 448, 32
WHISPER_MIN_PROMPT = 64
#: whisper-small at width, card against the port's CPU run, bf16 logits
#: (atol = rtol): the frameworks round bf16 products and sums at other
#: places through 24 layers (ROADMAP C9's bound)
WHISPER_CPU_TOL = 0.15


def frontend_inputs(cfg, b, s_text, rng, n_patch=4):
    """numpy stubs of the frontends for a batch of ``b`` rows: qwen2-vl's
    ``n_patch`` patch embeddings before ``s_text`` tokens with M-RoPE
    positions [3, b, s] (patches at time 0 on a 2-D grid, text after, all
    three rows equal), whisper's ``encoder_seq`` frames; {} otherwise."""
    out = {}
    if cfg.frontend == "vision":
        out["embeds"] = rng.standard_normal(
            (b, n_patch, cfg.d_model)).astype(np.float32)
        side = max(1, int(np.sqrt(n_patch)))
        i = np.arange(n_patch)
        text = side + np.arange(s_text)
        rows = [np.concatenate([np.zeros(n_patch), text]),
                np.concatenate([i // side, text]),
                np.concatenate([i % side, text])]
        out["positions"] = np.broadcast_to(
            np.stack(rows)[:, None], (3, b, n_patch + s_text)).astype(
                np.int32).copy()
    if cfg.encdec:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def check_smoke_model(dev, phase, cfg, label):
    """Phase 10b: a smoke config with its frontend's inputs through
    ``model.prefill`` and 6 greedy ``decode_step``s on the card and on
    the port's CPU, from one seeded parameter set: equal tokens, logits
    within SLICE_TOL."""
    from repro_torch.models import model as M
    params = M.init_params(cfg, seed=SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    b, s_text = 4, 24
    batch = {"tokens": rng.integers(1, cfg.vocab_size,
                                    (b, s_text)).astype(np.int32)}
    batch.update(frontend_inputs(cfg, b, s_text, rng))
    runs = {}
    for where in ("cpu", dev):
        p = {k: v.to(where) for k, v in params.items()}
        logits_all, toks = [], []
        with torch.inference_mode():
            cache = M.init_cache(cfg, b, 64, device=where)
            logits, cache = M.prefill(
                p, cfg, {k: torch.from_numpy(v).to(where)
                         for k, v in batch.items()}, cache)
            for step in range(7):
                logits_all.append(logits.float().cpu())
                toks.append(logits[:, -1].argmax(-1).to(torch.int32))
                if step < 6:
                    logits, cache = M.decode_step(
                        p, cfg, cache, {"token": toks[-1][:, None]})
        runs[str(where)] = ([t.cpu().tolist() for t in toks], logits_all)
    (tok_c, lg_c), (tok_g, lg_g) = runs["cpu"], runs[str(dev)]
    check(tok_c == tok_g, f"greedy tokens differ: CPU {tok_c}, card {tok_g}")
    err = max(close_or_raise(f"{cfg.name} logits step {i}", a, b_, SLICE_TOL)
              for i, (a, b_) in enumerate(zip(lg_g, lg_c)))
    print(f"phase {phase}: {label} on the card: greedy tokens equal to the "
          f"CPU run's, logits max abs error {err:.3g} (tol {SLICE_TOL:g})")


class FramesServe:
    """whisper's serving at width: ``model.prefill`` with the group's
    frames and ``decode_step``, shaped as a ``ServeEngine`` is where
    ``profile_serving`` and ``decode_floor_bytes`` read one (the engine
    takes tokens only, as the reference's does)."""

    def __init__(self, cfg, params, frames, slots, max_len, prefill_len):
        from repro_torch.serve.steps import make_decode_step, \
            make_prefill_step
        self.cfg, self.params, self.frames = cfg, params, frames
        self.slots, self.max_len = slots, max_len
        self._prefill_len = prefill_len
        step = make_prefill_step(cfg)
        self._prefill = lambda p, batch, cache: step(
            p, dict(batch, frames=self.frames), cache)
        self._decode = make_decode_step(cfg)


def whisper_at_width(dev, cfg, expect):
    """Phase 10g: whisper-small whole (12 encoder and 12 decoder layers
    at every published width) through ``model.prefill`` /
    ``decode_step``: 4 rows of 1,500 frames and prompts of 64-224 tokens
    right-padded to 224 (the first token from the last padded position,
    as the engine takes it), then 32 greedy decode steps. Holds the model
    kernels' launches to ``expect`` (the flash kernel 12 times for the
    encoder, 12 for the decoder's self- and 12 for its cross-attention,
    in the one prefill). Holds the first row's logits over the prefill
    and 3 decode steps to the port's CPU run of the same parameters,
    frames and tokens (the plain versions, bf16 on both; C9's bound)."""
    from repro_torch.kernels import policy_scan as pk
    from repro_torch.models import model as M
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev, compute=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(SEED)
    lens = rng.integers(WHISPER_MIN_PROMPT, WHISPER_PREFILL + 1,
                        WHISPER_ROWS)
    toks = np.zeros((WHISPER_ROWS, WHISPER_PREFILL), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    frames = torch.randn(WHISPER_ROWS, cfg.encoder_seq, cfg.d_model,
                         generator=g, device=dev).to(M.compute_dtype(cfg))
    srv = FramesServe(cfg, params, frames, WHISPER_ROWS, WHISPER_MAX_LEN,
                      WHISPER_PREFILL)
    held = torch.cuda.memory_allocated()
    print(f"phase 10g: {cfg.name} at all {cfg.encoder_layers} encoder and "
          f"{cfg.num_layers} decoder layers: {M.param_count(cfg):,} "
          f"parameters drawn in {init_s:.1f} s (peak "
          f"{load_peak / 2**30:.2f} GiB at load), held as "
          f"{held / 2**30:.2f} GiB with 4 rows of {cfg.encoder_seq} frames")
    tok_t = torch.from_numpy(toks).to(dev)

    def run(steps, keep=0):
        """prefill and ``steps`` greedy decode steps; the first row's
        logits of the first ``keep`` outputs"""
        cache = M.init_cache(cfg, WHISPER_ROWS, WHISPER_MAX_LEN, device=dev)
        t0 = time.perf_counter()
        logits, cache = srv._prefill(params, {"tokens": tok_t}, cache)
        out = [logits[:, -1].argmax(-1).to(torch.int32)]
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        dec, kept = [], []
        if keep:
            kept.append(logits[:1, -1].float().cpu())
        for _ in range(steps):
            t1 = time.perf_counter()
            logits, cache = srv._decode(params, cache,
                                        {"token": out[-1][:, None]})
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
            out.append(logits[:, -1].argmax(-1).to(torch.int32))
            torch.cuda.synchronize()
            dec.append(time.perf_counter() - t1)
            if len(kept) < keep:
                kept.append(logits[:1, -1].float().cpu())
        return ttft, dec, torch.stack(out, 1).cpu(), cache, kept

    run(2)                                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mods = model_kernels()
    for mod in (pk,) + mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    ttft, dec, tokens, cache, kept = run(WHISPER_STEPS, keep=4)
    wall = time.perf_counter() - t0
    launches = model_launches(mods)
    check(sum(pk.launches.values()) == 0, pk.launches)
    peak = torch.cuda.max_memory_allocated()
    check(launches == expect, (launches, expect))
    check(tokens.shape == (WHISPER_ROWS, WHISPER_STEPS + 1)
          and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size, tokens.shape)
    check(cache["length"].tolist() == [WHISPER_PREFILL + WHISPER_STEPS]
          * WHISPER_ROWS, cache["length"])
    # the port's CPU run (the plain versions) of the first row, fed the
    # card's tokens: its logits over the prefill and 3 decode steps
    cpu = {k: v.cpu() for k, v in params.items()}
    with torch.inference_mode():
        ccache = M.init_cache(cfg, 1, WHISPER_MAX_LEN, device="cpu")
        logits, ccache = M.prefill(cpu, cfg, {"tokens": tok_t[:1].cpu(),
                                              "frames": frames[:1].cpu()},
                                   ccache)
        clog = [logits[:, -1].float()]
        for i in range(3):
            logits, ccache = M.decode_step(cpu, cfg, ccache,
                                           {"token": tokens[:1, i:i + 1]})
            clog.append(logits[:, -1].float())
    del cpu, ccache
    cpu_err = max(close_or_raise(f"whisper row 0 logits, output {i}", a, b,
                                 WHISPER_CPU_TOL)
                  for i, (a, b) in enumerate(zip(kept, clog)))
    agree = float(np.mean([int(a.argmax()) == int(b.argmax())
                           for a, b in zip(kept, clog)]))
    dec_ms = 1e3 * np.array(dec)
    w_bytes, kv_bytes = decode_floor_bytes(srv, new_tokens=WHISPER_STEPS)
    floor_ms = 1e3 * (w_bytes + kv_bytes) / HBM_BYTES_PER_S
    new_tokens = WHISPER_ROWS * (WHISPER_STEPS + 1)
    print(f"phase 10g: prompts {int(lens.min())}-{int(lens.max())} tokens "
          f"padded to {WHISPER_PREFILL}, {WHISPER_STEPS} decode steps: "
          f"TTFT (encoder and decoder prefill) {ttft * 1e3:.1f} ms; decode "
          f"{dec_ms.mean():.2f} ms a step (floor {floor_ms:.3f} ms: "
          f"{w_bytes / 1e9:.3f} GB of decoder weights and "
          f"{kv_bytes / 1e9:.3f} GB of self and cross K/V); "
          f"{new_tokens / wall:.1f} tokens/s; peak "
          f"{peak / 2**30:.2f} GiB; row 0 against the port's CPU run: "
          f"logits max abs error {cpu_err:.3g} (tol {WHISPER_CPU_TOL:g}), "
          f"greedy tokens equal on {agree:.0%} of 4 outputs; launches "
          f"{launches}")
    out = {
        "phase": "10g", "model": cfg.name, "layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers,
        "params": M.param_count(cfg), "rows": WHISPER_ROWS,
        "prefill_len": WHISPER_PREFILL, "max_len": WHISPER_MAX_LEN,
        "decode_steps": WHISPER_STEPS, "wall_ms": wall * 1e3,
        "ttft_ms": ttft * 1e3, "decode_step_ms": float(dec_ms.mean()),
        "decode_floor_ms": floor_ms, "tokens_per_s": new_tokens / wall,
        "init_s": init_s, "load_peak_gib": load_peak / 2**30,
        "peak_gib": peak / 2**30, "held_gib": held / 2**30,
        "cpu_logits_err": cpu_err, "cpu_token_agreement": agree,
        "launches": launches}
    print(json.dumps({"serve": out}))
    out["profile"] = profile_serving(
        srv, [toks[i, :n].tolist() for i, n in enumerate(lens)], dev, "10g")
    return launches, out


def qwen_patches_prefill(dev, eng):
    """Phase 10f's second call: one ``model.prefill`` of qwen2-vl-7b
    with ``N_PATCHES`` (256) stub patch embeddings before 1,792 tokens
    and M-RoPE positions [3, 4, 2,048], on the engine's parameters:
    finite last-position logits, 28 flash launches, its wall."""
    from repro_torch.configs.qwen2_vl_7b import N_PATCHES
    from repro_torch.models import model as M
    fk, _, _ = model_kernels()
    cfg, b, s = eng.cfg, eng.slots, eng._prefill_len
    rng = np.random.default_rng(SEED + 4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (b, s - N_PATCHES)).astype(np.int32)}
    batch.update(frontend_inputs(cfg, b, s - N_PATCHES, rng, N_PATCHES))
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    tb["embeds"] = tb["embeds"].to(M.compute_dtype(cfg))
    cache = M.init_cache(cfg, b, eng.max_len, device=dev)
    fk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = eng._prefill(eng.params, tb, cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(logits.shape == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), logits.shape)
    check(fk.launches == {"flash_attention": cfg.num_layers,
                          "flash_attention_f32": 0,
                          "flash_attention_wide": 0,
                          "flash_attention_wide_f32": 0}, fk.launches)
    check(cache["length"].tolist() == [s] * b, cache["length"])
    print(f"phase 10f: model.prefill with {N_PATCHES} stub patches before "
          f"{s - N_PATCHES} tokens a row (M-RoPE positions [3, {b}, {s}]): "
          f"{wall * 1e3:.1f} ms, finite logits, {fk.launches}")
    return {"patches": N_PATCHES, "tokens": s - N_PATCHES,
            "wall_ms": wall * 1e3}


def serve_mla_encdec(dev, get_config, get_smoke_config):
    """Phase 10, the flash kernel at every head dim of the configs, MLA,
    whisper's encoder-decoder and qwen2-vl's frontend: 10a the kernels
    at the new head dims; 10b smoke minicpm3 (through ``ServeEngine``),
    qwen2-vl (4 patch embeddings, [3, b, s] positions) and whisper
    (frames), card against CPU in float32; then, each from a card that
    holds no earlier engine, stablelm-3b (10c), gemma-7b (10d),
    minicpm3-4b (10e) and qwen2-vl-7b (10f) cut in depth for the time
    limit (16 of 32, 14 of 28, 16 of 62, 14 of 28 layers; 10f also one
    prefill with its 256 stub patches) through ``serve_at_width`` (flash
    launches 2 a layer), and whisper-small
    whole through ``model.prefill`` /
    ``decode_step`` (10g); the flash kernel against its plain version at
    each one's prefill shape. Returns the model kernels' launches summed
    over 10c-10g, the flash rows and the serving rows."""
    t0 = time.perf_counter()
    check_flash_dims_random_blocks(dev)
    check_smoke_slice(dev, "10b", dataclasses.replace(
        get_smoke_config(MINICPM), dtype="float32"),
        "minicpm3 smoke (MLA, float32)")
    for arch, label in ((QWEN_VL, "qwen2-vl smoke (4 patch embeddings, "
                         "M-RoPE positions [3, b, s], float32)"),
                        (WHISPER, "whisper smoke (16 frames through the "
                         "encoder, float32)")):
        check_smoke_model(dev, "10b", dataclasses.replace(
            get_smoke_config(arch), dtype="float32"), label)
    launches, runs = {}, {}
    zero = {"flash_attention_f32": 0, "ssm_scan": 0, "rwkv6_chunked": 0,
            "rwkv6_scan": 0}
    # cut in depth to keep the whole script inside its time limit
    # (phases 11-14 came after them)
    for phase, arch, layers, label in (
            ("10c", STABLELM, 16, "cut to 16 of its 32 layers"),
            ("10d", GEMMA, 14, "cut to 14 of its 28 layers"),
            ("10e", MINICPM, 16, "cut to 16 of its 62 layers"),
            ("10f", QWEN_VL, 14,
             "cut to 14 of its 28 layers (text through the engine)")):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        expect = dict(zero, flash_attention=2 * cfg.num_layers)
        got, eng, runs[phase] = serve_at_width(dev, phase, cfg, label,
                                               expect)
        if phase == "10f":
            runs[phase]["patch_prefill"] = qwen_patches_prefill(dev, eng)
        del eng
        torch.cuda.empty_cache()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    wcfg = get_config(WHISPER)
    got, runs["10g"] = whisper_at_width(dev, wcfg, dict(
        zero, flash_attention=wcfg.encoder_layers + 2 * wcfg.num_layers))
    torch.cuda.empty_cache()
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    flash = {phase: flash_vs_plain(dev, phase)
             for phase in ("10c", "10d", "10e", "10f", "10g")}
    wall = time.perf_counter() - t0
    print(f"phase 10: {wall:.1f} s; "
          + "; ".join(f"{p} {r['model']} ({r['layers']} layers): TTFT "
                      f"{r.get('ttft_ms_p50', r.get('ttft_ms')):.1f} ms, "
                      f"decode {r['decode_step_ms']:.2f} ms a step (floor "
                      f"{r['decode_floor_ms']:.2f}), "
                      f"{r['tokens_per_s']:.1f} tokens/s"
                      for p, r in runs.items()))
    return launches, flash, runs


def flash_bound(b, sq, sk, h, kh, dq, dv, causal, dtype=torch.bfloat16):
    """(bound_ms, bound_by, operations) of one flash call: 2 b h sq sk
    (dqk + dv) operations (S = QK^T and PV), half of them when causal, at
    the tensor cores' peak for the type (float32: the TF32 peak, where
    its kernel runs the products in 3xTF32, the split counted once as
    ``wkv_bound`` counts it; ``flash_f32_floors`` gives its other two
    figures); q, k, v and the output once each in ``dtype`` at HBM's
    rate."""
    flops = 2 * b * h * sq * sk * (dq + dv) / (2 if causal else 1)
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = size * (b * sq * h * dq + b * sk * kh * (dq + dv)
                     + b * sq * h * dv)
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32_OPS_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def flash_f32_floors(flops):
    """(design floor ms, CUDA-core ms) of a float32 flash call of
    ``flops`` operations: its three TF32 products at the TF32 peak (the
    3xTF32 design's floor), and the operations at the float32 peak outside
    the tensor cores (the bound of a kernel that runs them on the CUDA
    cores, as the float32 kernel's first form did)."""
    return 1e3 * 3 * flops / TF32_OPS_PER_S, 1e3 * flops / F32_OPS_PER_S


def train_attention_bound(cfg, b, s, remat):
    """(bound_ms, bound_by, operations) of one train step's attention,
    worked from the code's shapes: the training route (``ref.sdpa``)
    forms the whole [s, s] logits and masks them, so a layer's forward
    is 2 b h s^2 (dqk + dv) operations at the bf16 peak, its backward
    twice that, and remat "full" runs the forward once more; bytes: a
    forward reads q, k, v and writes the output, the backward reads q, k,
    v and the output's gradient and writes theirs, all bf16, at HBM's
    rate."""
    a = cfg.attention
    layers = cfg.num_layers * cfg.block_pattern.count("attn") // len(
        cfg.block_pattern)
    h, kh, d = a.num_heads, a.num_kv_heads, a.head_dim
    forwards = 2 if remat == "full" else 1
    flops = layers * 2 * b * h * s * s * (d + d) * (forwards + 2)
    q, k, v, o = b * s * h * d, b * s * kh * d, b * s * kh * d, b * s * h * d
    nbytes = 2 * layers * ((forwards + 1) * (q + k + v + o) + (q + k + v))
    t_ops, t_bytes = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def train_attention_times(dev, cfg, b, s, remat):
    """One layer's training attention at a step's shape (bf16 q, k, v,
    causal): the training route (``ref.sdpa`` under autograd, the plain
    version) and ``scaled_dot_product_attention`` (the library), each
    forward alone and forward + backward by CUDA events; and the step's
    equivalent, each layer's forward + backward plus remat "full"'s
    second forward. Returns {"plain": ..., "library": ...} of {"fwd_ms",
    "fwd_bwd_ms", "step_ms"}."""
    from repro_torch.kernels import ref
    a = cfg.attention
    layers = cfg.num_layers * cfg.block_pattern.count("attn") // len(
        cfg.block_pattern)
    h, kh, d = a.num_heads, a.num_kv_heads, a.head_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, k, v = (torch.randn(b, s, n, d, generator=g, device=dev).bfloat16()
               .requires_grad_() for n in (h, kh, kh))
    dout = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()

    def plain():
        return ref.sdpa(q, k, v, causal=True)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)
    out = {}
    for name, fn in (("plain", plain), ("library", library)):
        def both():
            return torch.autograd.grad(fn(), (q, k, v), dout)
        with torch.enable_grad():
            both()                                       # warm-up
            fwd, _ = cuda_ms(fn, reps=3)
            fwd_bwd, _ = cuda_ms(both, reps=3)
        out[name] = {"fwd_ms": fwd, "fwd_bwd_ms": fwd_bwd,
                     "step_ms": layers * (fwd_bwd
                                          + (fwd if remat == "full" else 0))}
    return out


def flash_inputs(dev, phase, dtype):
    """q, k, v and causal at ``FLASH_SHAPES[phase]`` in ``dtype``, drawn
    from one seed (the same operands every time)."""
    b, s, h, kh, dq, dv, causal = FLASH_SHAPES[phase]
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    q = torch.randn(b, s, h, dq, generator=g, device=dev).to(dtype)
    k = torch.randn(b, s, kh, dq, generator=g, device=dev).to(dtype)
    v = torch.randn(b, s, kh, dv, generator=g, device=dev).to(dtype)
    return q, k, v, causal


def flash_vs_plain(dev, phase="5d", dtype=torch.bfloat16):
    """The flash kernel at a serving path's prefill shape
    (``FLASH_SHAPES[phase]``, in ``dtype``: bf16 takes the wgmma kernel,
    float32 the 3xTF32 mma.sync one) against its plain version, with
    SDPA's time for the table (null where SDPA refuses the shape); a
    float32 call also prints ``flash_f32_floors``' two figures."""
    from repro_torch.kernels import flash_attention as fk, ref
    b, s, h, kh, dq, dv, _ = FLASH_SHAPES[phase]
    q, k, v, causal = flash_inputs(dev, phase, dtype)
    key = fk.kernel_name(dtype, dq, dv)
    before = fk.launches[key]

    def kernel():
        return fk.flash_attention(q, k, v, causal=causal)
    kernel()                                                    # warm-up
    ms, got = cuda_ms(kernel, reps=10)
    plain_ms, want = cuda_ms(
        lambda: ref.flash_attention(q, k, v, causal=causal))
    check(fk.launches[key] > before, (phase, key, "not launched"))
    err = close_or_raise(f"flash at {phase}'s shape", got, want,
                         MODEL_TOL[dtype])
    del want

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)
    try:
        library()
        library_ms, _ = cuda_ms(library, reps=10)
    except RuntimeError as e:               # no SDPA backend takes it
        print(f"flash_attention ({phase}): SDPA refused the shape: "
              f"{str(e).splitlines()[0][:200]}")
        library_ms = None
    bound_ms, bound_by, flops = flash_bound(b, s, s, h, kh, dq, dv, causal,
                                            dtype)
    lib = ("not run" if library_ms is None else
           f"{library_ms:.3f} ms (kernel / SDPA {ms / library_ms:.2f})")
    floors = ""
    if dtype == torch.float32:
        floor_ms, cuda_core_ms = flash_f32_floors(flops)
        floors = (f"; the three TF32 products' floor {floor_ms:.4f} ms, "
                  f"the CUDA cores' {cuda_core_ms:.4f} ms")
    print(f"{key} ({phase}) at q {list(q.shape)}, k "
          f"{list(k.shape)}, v {list(v.shape)} "
          f"{'bf16' if dtype == torch.bfloat16 else 'float32'} "
          f"{'causal' if causal else 'not causal'}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, SDPA {lib}, bound "
          f"{bound_ms:.4f} ms ({bound_by}; the kernel at "
          f"{bound_ms / ms:.1%} of it, {flops / ms / 1e9:.0f} TFLOP/s"
          f"{floors}); max abs error {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": [b, s, h, kh, dq, dv],
            "causal": causal}


def ssm_bound(b, s, di, n, state_in):
    """(bound_ms, bound_by): bf16 x, dt, y and B, C; float32 A, D, the
    state out (and in); 7 float32 operations per state element and 3 per
    channel-step, counted from csrc/ssm_scan.cu (exp as one)."""
    nbytes = 2 * (3 * b * s * di + 2 * b * s * n) + 4 * (
        di * n + di + (2 if state_in else 1) * b * di * n)
    ops = (7 * n + 3) * b * s * di
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


def ssm_vs_plain(dev):
    """The selective-scan kernel at the serving path's shapes: prefill
    [4, 2,048, 16,384] x n 16 from a zero state, and a decode step
    [4, 1, 16,384] from a carried state; bf16, as the path runs it."""
    from repro_torch.kernels import ref, ssm_scan as sk
    b, di, n = 4, 16384, 16
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = {}
    for what, s, state in (("prefill", 2048, False), ("decode", 1, True)):
        ops = ssm_inputs(b, s, di, n, torch.bfloat16, dev, g, state)
        sk.ssm(*ops)                                            # warm-up
        ms, got = cuda_ms(lambda: sk.ssm(*ops), reps=3)
        plain_ms, want = cuda_ms(lambda: ref.ssm_scan(*ops))
        err = max(close_or_raise(f"ssm {what} at width {w}", a, b,
                                 MODEL_TOL[torch.bfloat16])
                  for w, a, b in zip(("y", "state"), got, want))
        bound_ms, bound_by = ssm_bound(b, s, di, n, state)
        # a decode launch's wrapper time is mostly host work; replayed
        # from a CUDA graph, its device time
        device_ms = graph_ms(lambda: sk.ssm(*ops)) if s == 1 else None
        graphed = ("" if device_ms is None else
                   f" (device, graph-replayed: {device_ms:.4f} ms)")
        print(f"ssm_scan {what} at [{b}, {s}, {di}] x {n} bf16: kernel "
              f"{ms:.4f} ms{graphed}, plain {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); max abs error {err:.3g}")
        out[what] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
        if device_ms is not None:
            out[what]["device_ms"] = device_ms
    return out


def wkv_bound(b, s, h, n, state_in):
    """(bound_ms, bound_by): the least time for the function. Bytes: bf16
    r, k, v, w and out, float32 u, the state out (and in). Operations:
    the chunked form's multiply-adds (csrc/rwkv6.cu, chunks of 32 steps,
    sub-blocks of 8) over the TF32 tensor-core peak, the 3xTF32 split
    counted once: per step 2 n^2 (inter, state), 24 n (pairs x v), 12 n
    (the off-diagonal pair blocks) and 4.5 n (the diagonal pairs and the
    bonus)."""
    nbytes = 2 * 5 * b * s * h * n + 4 * (
        h * n + (2 if state_in else 1) * b * h * n * n)
    macs = (2 * n * n + (24 + 12 + 4.5) * n) * b * h * s
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * macs / TF32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


def wkv_vs_plain(dev):
    """The WKV kernels at the rwkv6-7b serving path's shapes: prefill
    [4, 2,048, 64, 64] from a zero state (the chunked kernel), and a
    decode step [4, 1, 64, 64] from a carried state (the per-step
    kernel); bf16, as the path runs them."""
    from repro_torch.kernels import ref, rwkv6_kernel as rk
    b, h, n = 4, 64, 64
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {}
    for what, s, state in (("prefill", 2048, False), ("decode", 1, True)):
        ops = wkv_inputs(b, s, h, n, torch.bfloat16, dev, g, state)
        rk.rwkv6(*ops)                                          # warm-up
        ms, got = cuda_ms(lambda: rk.rwkv6(*ops), reps=10)
        plain_ms, want = cuda_ms(lambda: ref.rwkv6_scan(*ops))
        err = wkv_close(f"wkv {what} at width", got, want, torch.bfloat16)
        bound_ms, bound_by = wkv_bound(b, s, h, n, state)
        name = ("rwkv6_chunked" if s >= rk.CHUNKED_MIN_STEPS
                else "rwkv6_scan")
        device_ms = graph_ms(lambda: rk.rwkv6(*ops)) if s == 1 else None
        graphed = ("" if device_ms is None else
                   f" (device, graph-replayed: {device_ms:.4f} ms)")
        print(f"{name} {what} at [{b}, {s}, {h}, {n}] bf16: kernel "
              f"{ms:.4f} ms{graphed}, plain {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms (set by {bound_by}; the kernel at "
              f"{bound_ms / ms:.1%} of it); max abs error {err:.3g}")
        out[what] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
        if device_ms is not None:
            out[what]["device_ms"] = device_ms
    return out


# ---------------------------------------------------------------------------
# Phase 11: registered policies on the card (ROADMAP A10)
# ---------------------------------------------------------------------------

#: phase 11's registered policies in 11a: the reference's
#: ``test_register_policy_extends_and_overrides`` pair (``null``, and
#: ``shed`` overridden to drop everything), ``capped``, a step of
#: + - * / min max (finite at any parameters, a fault's zero capacity
#: included), so its rows are bitwise the CPU's, and (C15) ``diurnal``
#: (an int32 hour of day, ``% 24``, a ``sin`` daily curve: its latency
#: within ``DIURNAL_ULPS``, the rest bitwise), ``bits`` (a mantissa bit
#: view, shifts, masks, integer and float floor division and remainder)
#: and ``bw_copy`` (batch_window's own step, ``_fma``'s int64 view and
#: ``nextafter`` included), both bitwise
REGISTERED = ("null", "shed", "capped", "diurnal", "bits", "bw_copy")
CAP_HOURS = 3600.0
TRIPLE = ("max_rps", "usd_per_hour", "base_latency_s")
TWO_PI_24 = 2.0 * math.pi / 24.0
#: head dims the wrapper pads to the kernels' multiple of 8 (C17)
FLASH_PAD_PAIRS = ((4, 4), (20, 20), (100, 100), (96, 20))
#: head dims past 256, run by the wide kernels (C17): a square 264, a
#: narrow q/k over a wide v, 320, DeepSeek-V2-Lite's absorbed MLA (576,
#: 512) and a wide q/k over a narrow v
FLASH_WIDE_PAIRS = ((264, 264), (64, 264), (320, 320), (576, 512),
                    (1024, 64))
#: 11a's bound on ``diurnal``'s latency: its ``(2 + sin) * 64`` term
#: through CUDA's ``sinf`` (2 ulps from the correctly rounded value) and
#: the CPU's (1 ulp), an ulp of a value near 1 times 64 in a latency of
#: 64 s or more, set before its first run on the card (PERF.md)
DIURNAL_ULPS = 8
DIURNAL_AGG_RTOL = DIURNAL_ULPS * 2.0 ** -23


def diurnal_step(carry, arrive, p, dt):
    """Capacity by the hour of the day (C15): an int32 hour from the
    timer in the carry, ``% 24``, a ``sin`` daily curve; instances
    ceil(3.3 + 2.2 sin) stay 0.1 or more from an integer at every hour,
    so an ulp of ``sin`` never moves the capacity, and only the latency's
    ``sin`` term differs from the CPU. The CPU tests' ``diurnal_step``,
    held there to the reference's registered ``jnp`` step."""
    timer = carry[:, 1] + dt
    hour = timer.to(torch.int32) % 24
    s = torch.sin(hour.float() * TWO_PI_24)
    inst = torch.ceil(3.3 + 2.2 * s)
    cap = torch.clamp_min(p[:, 0] * inst * CAP_HOURS * dt, 1.0)
    avail = carry[:, 0] + arrive
    proc = torch.minimum(avail, cap)
    queue = avail - proc
    lat = p[:, 2] + queue / cap + (2.0 + s) * 64.0
    new = torch.stack([queue, timer], dim=1)
    return new, (proc, queue, lat, p[:, 1] * inst * dt,
                 torch.zeros_like(arrive))


def bits_step(carry, arrive, p, dt):
    """A capped queue whose latency takes a jitter from its queue's
    float32 bits (mantissa and exponent by shifts and masks, integer
    floor division and ``%`` of negative values) and a phase by float
    ``remainder``; its cost a float floor division of a signed load (the
    CPU tests' ``bits_step``)."""
    cap = torch.clamp_min(p[:, 0] * CAP_HOURS * dt, 1.0)
    avail = carry[:, 0] + arrive
    proc = torch.minimum(avail, cap)
    queue = avail - proc
    m = queue.view(torch.int32)
    mant = (m & 0x7FFFFF) >> 13
    expo = (m >> 23) & 0xFF
    tag = ((mant << 2) ^ expo) - 2048
    jitter = ((tag // 7).float() + (tag % 7).float()) * (1.0 / 64.0)
    timer = carry[:, 1] + dt
    phase = torch.remainder(timer - 3.5, 24.0)
    shift = torch.floor_divide(arrive - 1e4, 1000.0)
    lat = p[:, 2] + queue / cap + torch.abs(jitter) + phase * 0.125
    cost = p[:, 1] * dt + torch.abs(shift) * 2.0 ** -10
    new = torch.stack([queue, timer], dim=1)
    return new, (proc, queue, lat, cost, torch.zeros_like(arrive))


def zero_divisor_step(carry, arrive, p, dt):
    """Hours grouped by an integer divisor, (``groups`` + 1) as int32: 0
    for a ``groups`` of -1, where the CPU raises ``RuntimeError:
    ZeroDivisionError`` (the CPU tests' ``zero_divisor_step``)."""
    groups = (p[:, 3] + 1.0).to(torch.int32)
    slot = (carry[:, 1] + dt).to(torch.int32) // groups
    return (torch.stack([carry[:, 0], carry[:, 1] + dt], dim=1),
            (arrive, carry[:, 0], p[:, 2] + slot.float(), p[:, 1],
             torch.zeros_like(arrive)))


# 11d: every elementwise operation of a registered step on edge values,
# the card's emission against the CPU's run of the step
INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
#: the operations bitwise the CPU (class 1 of ``lane_codegen``): (lane
#: type, name, operation on the lane's pair (a, b))
OPS_EXACT = [
    ("i32", "add", lambda a, b: a + b), ("i32", "sub", lambda a, b: a - b),
    ("i32", "mul", lambda a, b: a * b), ("i32", "neg", lambda a, b: -a),
    ("i32", "abs", lambda a, b: torch.abs(a)),
    ("i32", "min", torch.minimum), ("i32", "max", torch.maximum),
    ("i32", "lt", torch.lt), ("i32", "eq", torch.eq),
    ("i32", "and", lambda a, b: a & b), ("i32", "or", lambda a, b: a | b),
    ("i32", "xor", lambda a, b: a ^ b), ("i32", "not", lambda a, b: ~a),
    ("i32", "shl", lambda a, b: a << b), ("i32", "shr", lambda a, b: a >> b),
    ("i32", "floordiv", lambda a, b: a // b),
    ("i32", "mod", lambda a, b: a % b), ("i32", "fmod", torch.fmod),
    ("i32", "div_trunc", lambda a, b: torch.div(a, b, rounding_mode="trunc")),
    ("i32", "true_div", lambda a, b: a / b),
    ("i32", "sign", lambda a, b: torch.sign(a)),
    ("i32", "to_f32", lambda a, b: a.float()),
    ("i32", "to_f64", lambda a, b: a.double()),
    ("i32", "to_i64", lambda a, b: a.long()),
    ("i64", "add", lambda a, b: a + b), ("i64", "mul", lambda a, b: a * b),
    ("i64", "neg", lambda a, b: -a), ("i64", "abs", lambda a, b: torch.abs(a)),
    ("i64", "min", torch.minimum), ("i64", "lt", torch.lt),
    ("i64", "xor", lambda a, b: a ^ b),
    ("i64", "shl", lambda a, b: a << b), ("i64", "shr", lambda a, b: a >> b),
    ("i64", "floordiv", lambda a, b: a // b),
    ("i64", "mod", lambda a, b: a % b), ("i64", "fmod", torch.fmod),
    ("i64", "to_i32", lambda a, b: a.int()),
    ("i64", "to_f32", lambda a, b: a.float()),
    ("i64", "to_f64", lambda a, b: a.double()),
    ("i64", "view_f64", lambda a, b: a.view(torch.float64)),
    ("f32", "remainder", torch.remainder), ("f32", "fmod", torch.fmod),
    ("f32", "floordiv", lambda a, b: a // b),
    ("f32", "div_trunc", lambda a, b: torch.div(a, b, rounding_mode="trunc")),
    ("f32", "nextafter", torch.nextafter),
    ("f32", "copysign", torch.copysign),
    ("f32", "sign", lambda a, b: torch.sign(a)),
    ("f32", "signbit", lambda a, b: torch.signbit(a)),
    ("f32", "isnan", lambda a, b: torch.isnan(a)),
    ("f32", "isinf", lambda a, b: torch.isinf(a)),
    ("f32", "isfinite", lambda a, b: torch.isfinite(a)),
    ("f32", "frac", lambda a, b: torch.frac(a)),
    ("f32", "to_i32", lambda a, b: a.int()),
    ("f32", "to_i64", lambda a, b: a.long()),
    ("f32", "view_i32", lambda a, b: a.view(torch.int32)),
    ("f64", "remainder", torch.remainder),
    ("f64", "floordiv", lambda a, b: a // b),
    ("f64", "nextafter", torch.nextafter),
    ("f64", "to_i32", lambda a, b: a.int()),
    ("f64", "to_i64", lambda a, b: a.long()),
    ("f64", "to_f32", lambda a, b: (a * 3.0).float())]
#: the transcendental ones (class 2): each with its bound in ulps of its
#: type, card against CPU: CUDA's documented maximum error of the
#: function (sinf 2, tanf 4, atan2f 3, ...; the float64 ones 1-2) plus 2
#: for the CPU's (SLEEF's 1-ulp functions, glibc's in a strided tail)
OPS_ULP = [(kind, name, fn, ulps + 2) for kind, table in (
    ("f32", {"sin": 2, "cos": 2, "tan": 4, "atan": 2, "atan2": 3,
             "exp2": 2, "log2": 1, "log10": 2, "erf": 2, "hypot": 3,
             "sinh": 3, "cosh": 2, "rsqrt": 2}),
    ("f64", {"sin": 2, "cos": 2, "tan": 2, "atan": 2, "atan2": 2,
             "exp2": 1, "log2": 1, "log10": 1, "erf": 2, "hypot": 2,
             "sinh": 2, "cosh": 1, "rsqrt": 1}))
    for name, ulps in table.items()
    for fn in ((torch.atan2 if name == "atan2" else torch.hypot
                if name == "hypot" else
                (lambda f: lambda a, b: f(a))(getattr(torch, name))),)]
OPS_DIVIDING = ("floordiv", "mod", "fmod", "div_trunc")
#: 11d's edge values: float32 pairs in p[0], p[1]; int32 pairs as the
#: bits of p[2], p[3]; int64 pairs with p[2], p[3] as low words and
#: p[4], p[5] as high words (``OPS_HIGH``)
OPS_F32 = [math.nan, math.inf, -math.inf, 0.0, -0.0, 1.0, -1.0, 0.5, -0.5,
           2.5, -2.5, 3.0, -3.0, 7.0, -7.0, 24.0, 1e-45, -1e-45, 1e-30,
           3e9, -3e9, 2147483520.0, -2147483648.0, 2147483648.0, 1e20,
           -1e20, 3.4028235e38, -3.4028235e38, 123.456, -0.75]
OPS_I32 = [INT_MIN, INT_MIN + 1, INT_MAX, -1, 0, 1, 2, -2, 3, -3, 7, -7,
           24, -24, 31, 32, 33, 63, 64, 100, -100, 12345678, -12345678]
OPS_HIGH = [0, -1, INT_MIN, INT_MAX, 1, 5]


def ops_operands(kind, p):
    """The lane's (a, b) of ``kind`` from 11d's parameter layout."""
    if kind == "i32":
        return p[:, 2].view(torch.int32), p[:, 3].view(torch.int32)
    if kind == "i64":
        lo = [(p[:, k].view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
              for k in (2, 3)]
        return tuple((p[:, k].view(torch.int32).to(torch.int64) << 32) | w
                     for k, w in zip((4, 5), lo))
    if kind == "f64":
        return p[:, 0].double(), p[:, 1].double()
    return p[:, 0], p[:, 1]


def ops_pieces(r):
    """``r``'s bits as float32 values of 16 bits each (exact, finite and
    non-negative, so the kernels' blend and canonical zero keep them),
    NaN made the one canonical NaN first (a NaN's payload is no value:
    the CPU's vector loops and CUDA give different ones)."""
    if r.dtype == torch.bool:
        return [r.float()]
    if r.is_floating_point():
        r = torch.where(torch.isnan(r), math.nan, r)
        r = r.view(torch.int32 if r.dtype == torch.float32 else torch.int64)
    n = 2 if r.dtype == torch.int32 else 4
    return [((r >> (16 * k)) & 0xFFFF).float() for k in range(n)]


def ops_step(ops):
    """One registered step that runs ``ops`` on the lane's pairs and puts
    each result's 16-bit pieces in the carry and outputs (7 slots). An
    integer division's divisor 0, and -1 under the type's minimum (where
    the CPU traps), become 1: every lane runs every present step in the
    CPU's blend (``zero_divisor_step`` shows the raise)."""
    def step(carry, arrive, p, dt):
        slots = []
        for kind, name, fn, *_ in ops:
            a, b = ops_operands(kind, p)
            if kind in ("i32", "i64") and name in OPS_DIVIDING:
                lowest = INT_MIN if kind == "i32" else -2 ** 63
                b = torch.where((b == 0) | ((a == lowest) & (b == -1)), 1, b)
            slots += ops_pieces(fn(a, b))
        slots += [torch.zeros_like(arrive)] * (7 - len(slots))
        return torch.stack(slots[:2], dim=1), tuple(slots[2:])
    return step


def _ops_slots(kind, fn):
    a = torch.zeros(2, dtype={"i32": torch.int32, "i64": torch.int64,
                              "f64": torch.float64}.get(kind, torch.float32))
    return len(ops_pieces(fn(a, a + 1)))


def ops_groups():
    """11d's operations packed into steps of at most 7 slots: (policy
    name, ops, exact); each op (kind, name, fn[, ulps], slots)."""
    groups = []
    for exact, table in ((True, OPS_EXACT), (False, OPS_ULP)):
        cur, used = [], 0
        for op in table:
            n = _ops_slots(op[0], op[2])
            if used + n > 7:
                groups.append((f"ops{len(groups)}", cur, exact))
                cur, used = [], 0
            cur.append(op + (n,))
            used += n
        groups.append((f"ops{len(groups)}", cur, exact))
    return groups


def register_phase11_policies(twin_mod):
    triple = TRIPLE

    @twin_mod.register_policy("null", triple)
    def _null(carry, arrive, p, dt):
        z = torch.zeros_like(arrive)
        return carry, (z, carry[:, 0], p[:, 2], z, z)

    @twin_mod.register_policy("shed", triple + ("queue_cap_hours",),
                              defaults={"queue_cap_hours": 4.0})
    def _shed_v2(carry, arrive, p, dt):
        z = torch.zeros_like(arrive)
        return carry, (z, carry[:, 0], p[:, 2], p[:, 1], arrive)

    @twin_mod.register_policy("capped", triple + ("replicas",),
                              defaults={"replicas": 1.0},
                              bounds={"replicas": (0.5, 16.0)})
    def _capped(carry, arrive, p, dt):
        cap = torch.clamp_min(p[:, 0] * p[:, 3] * CAP_HOURS, 1.0)
        avail = carry[:, 0] + arrive
        proc = torch.minimum(avail, cap)
        queue = avail - proc
        lat = p[:, 2] + queue / cap
        new = torch.stack([queue, carry[:, 1]], dim=1)
        return new, (proc, queue, lat, p[:, 1] * p[:, 3],
                     torch.zeros_like(arrive))

    twin_mod.register_policy("diurnal", triple)(diurnal_step)
    twin_mod.register_policy("bits", triple)(bits_step)
    bw = twin_mod.policy_spec("batch_window")
    twin_mod.register_policy("bw_copy", bw.param_names,
                             defaults=bw.defaults)(bw.lane_step)
    twin_mod.register_policy("zdiv", triple + ("groups",),
                             defaults={"groups": 1.0})(zero_divisor_step)


def ops_header(twin_mod):
    """The generated header of 11d's registry (the built-ins and
    ``ops_groups``' steps), whose library builds in the background from
    phase 1 on (``ops_build_start``)."""
    from repro_torch.kernels import lane_codegen
    saved = (dict(twin_mod._REGISTRY), twin_mod._VERSION)
    try:
        for name, ops, _ in ops_groups():
            twin_mod.register_policy(name, TRIPLE + ("a", "b", "c"))(
                ops_step(ops))
        gen = lane_codegen.generated()
        check(not gen.refused, gen.refused)
        return gen.header
    finally:
        twin_mod._REGISTRY.clear()
        twin_mod._REGISTRY.update(saved[0])
        twin_mod._VERSION = saved[1]


def ops_build_start(build, header):
    """11d's library (47 generated branches: ptxas takes a minute) built
    by one nvcc on a thread of its own beside phases 2-10; returns the
    thread and the seconds it took, read after ``join``."""
    import threading
    took = {}

    def run():
        took["s"] = build.build([], [("policy_scan", header)])
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, took


#: the wide flash kernels' first form (v slices across blocks, each
#: recomputing S; mma.sync), the baseline they are timed against
FIRST_FORM = Path(__file__).resolve().parent / "tools" / "flash_wide_first.cu"


def first_form_build_start(build):
    """``FIRST_FORM`` built by one nvcc (the flash library's flags) in a
    process of its own beside the phases; returns the process, the
    library's path and the start time, for ``first_form_lib``."""
    out = build.BUILD_DIR / "first" / "flash_wide_first.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = build.nvcc_command("flash_attention", FIRST_FORM, out)
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, out, time.perf_counter()


def first_form_lib(first_build):
    """The first form's library, once its nvcc has ended."""
    import ctypes
    proc, out, t0 = first_build
    rc = proc.wait()
    check(rc == 0, ("nvcc of the wide kernels' first form",
                    out.with_suffix(".log").read_text()[-2000:]))
    print(f"phase 11: the wide kernels' first form ({FIRST_FORM.name}): "
          f"its nvcc, in a process of its own, had ended "
          f"{time.perf_counter() - t0:.1f} s after it started")
    return ctypes.CDLL(str(out))


def flash_wide_vs_first(dev, dtype, first):
    """``flash_vs_plain`` at DeepSeek-V2-Lite's absorbed prefill
    (``FLASH_SHAPES["11"]``) in ``dtype``, then the wide kernel and its
    first form (the library ``first``, launched through the same
    wrapper) timed in turns on the same inputs (kernel, first, first,
    kernel; each the mean of 10 launches after a warm-up), the first
    form within ``MODEL_TOL`` of the plain version too. The first form's
    launches are taken back off the wrapper's counts: they are not the
    port's."""
    from unittest import mock
    from repro_torch.kernels import flash_attention as fk, ref
    row = flash_vs_plain(dev, "11", dtype)
    q, k, v, causal = flash_inputs(dev, "11", dtype)
    dq, dv = q.shape[3], v.shape[3]
    counts = dict(fk.launches)

    def kernel():
        return fk.flash_attention(q, k, v, causal=causal)
    times = {"kernel": [], "first": []}
    for name in ("kernel", "first", "first", "kernel"):
        if name == "first":
            with mock.patch.object(fk.build, "load", lambda _: first):
                got = kernel()                              # warm-up
                times[name].append(cuda_ms(kernel, reps=10)[0])
        else:
            kernel()
            times[name].append(cuda_ms(kernel, reps=10)[0])
    fk.launches.update(counts)
    want = ref.flash_attention(q, k, v, causal=causal)
    first_err = close_or_raise(f"the first form at 11's shape {dtype}",
                               got, want, MODEL_TOL[dtype])
    del want, got
    ms, first_ms = min(times["kernel"]), min(times["first"])
    sdpa = ("" if row["library_ms"] is None else
            f", {ms / row['library_ms']:.2f} of SDPA's")
    print(f"{fk.kernel_name(dtype, dq, dv)} (11) in turns: kernel "
          f"{' / '.join(f'{t:.3f}' for t in times['kernel'])} ms, its "
          f"first form ({FIRST_FORM.name}) "
          f"{' / '.join(f'{t:.3f}' for t in times['first'])} ms (max abs "
          f"error {first_err:.3g}); the kernel at {ms / first_ms:.2f} of "
          f"the first form's time{sdpa}")
    return dict(row, turns_ms=times["kernel"], first_ms=first_ms,
                first_turns_ms=times["first"], first_max_abs_err=first_err)


#: 11c's bound on a latency that goes through CUDA's ``expf`` / ``logf``
#: (2 and 1 ulp from the correctly rounded value) against the CPU's
#: (SLEEF's, 1 ulp each), in float32 ulps of the latency (ROADMAP C15)
SOFTLAT_ULPS = 8
#: 11c's bound on the aggregate rows' latency statistics (relative): each
#: a load-weighted sum of latencies within SOFTLAT_ULPS
SOFTLAT_AGG_RTOL = SOFTLAT_ULPS * 2.0 ** -23
#: 11c's bound on ``smooth``'s latency, set before its first run on the
#: card (PERF.md section 6): a sum of six positive terms through
#: CUDA's ``tanhf``, ``expf`` (sigmoid, softplus), ``log1pf``,
#: ``expm1f`` and ``powf`` (up to 2, 2, 1, 1 and 4 ulps from the
#: correctly rounded value by CUDA's tables) against SLEEF's (1 ulp each);
#: an H100 read 4
SMOOTH_ULPS = 16
SMOOTH_AGG_RTOL = SMOOTH_ULPS * 2.0 ** -23


def register_softlat(twin_mod):
    """11c's registered policies (ROADMAP C15): ``softlat``, a capped
    queue whose latency goes through ``exp`` and ``log``, and ``smooth``,
    the same queue whose wait goes through ``tanh``, ``sigmoid``,
    ``log1p``, ``expm1``, ``softplus`` and a ``pow`` (the CPU tests'
    ``smooth_step``, held there to the reference's run); their carry and
    their other outputs are exact operations."""
    @twin_mod.register_policy("softlat", ("max_rps", "usd_per_hour",
                                          "base_latency_s"))
    def _softlat(carry, arrive, p, dt):
        cap = torch.clamp_min(p[:, 0] * CAP_HOURS * dt, 1.0)
        avail = carry[:, 0] + arrive
        proc = torch.minimum(avail, cap)
        queue = avail - proc
        lat = p[:, 2] + (torch.log(1.0 + queue / cap)
                         * torch.exp(-proc / cap) * 3600.0)
        new = torch.stack([queue, carry[:, 1]], dim=1)
        return new, (proc, queue, lat, p[:, 1] * dt,
                     torch.zeros_like(arrive))

    @twin_mod.register_policy("smooth", ("max_rps", "usd_per_hour",
                                         "base_latency_s"))
    def _smooth(carry, arrive, p, dt):
        cap = torch.clamp_min(p[:, 0] * CAP_HOURS, 1.0)
        avail = carry[:, 0] + arrive
        proc = torch.minimum(avail, cap)
        queue = avail - proc
        load = queue / cap
        wait = (torch.tanh(load) + torch.sigmoid(load - 2.0)
                + torch.log1p(load) - torch.expm1(-load)
                + torch.nn.functional.softplus(load - 1.0, beta=2.0,
                                               threshold=5.0)
                + load ** 1.5)
        new = torch.stack([queue, carry[:, 1]], dim=1)
        return new, (proc, queue, p[:, 2] + wait * 3600.0, p[:, 1] * dt,
                     torch.zeros_like(arrive))


#: 11c's policies, each with its latency bound (ulps) and its aggregate
#: bound (relative)
TRANSCENDENTAL_POLICIES = {"softlat": (SOFTLAT_ULPS, SOFTLAT_AGG_RTOL),
                           "smooth": (SMOOTH_ULPS, SMOOTH_AGG_RTOL)}


def softlat_header(twin_mod):
    """The generated header of 11c's registry (built in phase 1)."""
    from repro_torch.kernels import lane_codegen
    saved = (dict(twin_mod._REGISTRY), twin_mod._VERSION)
    try:
        register_softlat(twin_mod)
        gen = lane_codegen.generated()
        check(gen.transcendental == tuple(TRANSCENDENTAL_POLICIES)
              and not gen.refused, (gen.transcendental, gen.refused))
        return gen.header
    finally:
        twin_mod._REGISTRY.clear()
        twin_mod._REGISTRY.update(saved[0])
        twin_mod._VERSION = saved[1]


def ulp_distance(a, b):
    """Float32 ulps between equal-signed float32 arrays."""
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def within_ulps(card, cpu, bounds, series, what):
    """Card rows against the CPU's run of the same twins: every field
    bitwise but the latency, whose bins are within ``bounds[policy][0]``
    float32 ulps (series) or whose mean is within ``bounds[policy][1]``
    relative, the SLO share within one bin (aggregate). Returns the worst
    figure per policy."""
    worst = dict.fromkeys(bounds, 0)
    for c, h in zip(card, cpu):
        check(c.name == h.name, (c.name, h.name))
        policy = c.twin.policy
        ulp_bound, agg_bound = bounds[policy]
        exact = (("processed", "queue", "cost_usd", "dropped") if series
                 else ("total_cost_usd", "processed_records",
                       "dropped_records", "queue_end", "backlog_s"))
        for f in exact:
            u, v = getattr(c, f), getattr(h, f)
            check(np.array_equal(np.asarray(u), np.asarray(v)),
                  (what, c.name, f))
        if series:
            ulps = int(ulp_distance(c.latency_s.astype(np.float32),
                                    h.latency_s.astype(np.float32)).max())
            worst[policy] = max(worst[policy], ulps)
            check(ulps <= ulp_bound, (what, c.name, ulps))
        else:
            err = abs(c.mean_latency_s - h.mean_latency_s) / max(
                abs(h.mean_latency_s), 1e-30)
            worst[policy] = max(worst[policy], err)
            check(err <= agg_bound, (what, c.name, err))
            check(abs(c.pct_hours_met - h.pct_hours_met)
                  <= 100.0 / HOURS_PER_YEAR, (what, c.name))
    return worst


def softlat_on_card(whatif, tr, twin_mod, slo_mod):
    """11c (ROADMAP C15): registered steps with ``exp`` and ``log``
    (``softlat``) and with ``tanh``, ``sigmoid``, ``expm1``, ``log1p``,
    ``softplus`` and a ``pow`` (``smooth``) in the policy kernels: 8
    twins of each x 2 traffics, full year, both modes, one launch each,
    against the CPU run. Processed, queue, cost and drops bitwise; each
    bin's latency within its policy's ulp bound; the aggregate rows'
    latency statistics within its relative bound, their SLO shares
    within one bin."""
    from repro_torch.kernels import policy_scan as pk
    saved = (dict(twin_mod._REGISTRY), twin_mod._VERSION)
    record = {}
    try:
        register_softlat(twin_mod)
        twins = [twin_mod.make_twin(f"{policy}{i}", policy,
                                    max_rps=0.25 + 0.25 * i,
                                    usd_per_hour=0.0082, base_latency_s=0.15)
                 for policy in TRANSCENDENTAL_POLICIES for i in range(8)]
        traffics = [tr.TrafficModel.honda_default("nominal", R=3.5, G=1.0),
                    tr.TrafficModel.honda_default("high(+50%)", R=3.5,
                                                  G=1.5)]
        slo = slo_mod.SLO(limit_s=4 * 3600, met_fraction=0.95)
        for series in (True, False):
            mode = "series" if series else "aggregate"
            kernel = "policy_scan" if series else "policy_agg"
            pk.reset_launches()
            t0 = time.perf_counter()
            card = whatif.run_grid(twins, traffics, slo=slo,
                                   return_series=series)
            wall = time.perf_counter() - t0
            rows, launched = dict(pk.registered_rows), dict(pk.launches)
            check(sum(rows.values()) == 32 and launched[kernel] == 1
                  and sum(launched.values()) == 1, ("11c", mode, launched,
                                                    rows))
            cpu = whatif.run_grid(twins, traffics, slo=slo,
                                  return_series=series, device="cpu")
            worst = within_ulps(card, cpu, TRANSCENDENTAL_POLICIES, series,
                                f"11c {mode}")
            record[mode] = {"wall_ms": 1e3 * wall, "worst": worst,
                            "launches": launched,
                            "registered_rows": sum(rows.values())}
        ser, agg = record["series"], record["aggregate"]
        print(f"phase 11c: softlat (exp, log) and smooth (tanh, sigmoid, "
              f"expm1, log1p, softplus, pow) in translated steps, 32 "
              f"full-year scenarios in the policy kernels, one launch a "
              f"mode: series {ser['wall_ms']:.1f} ms, latency within "
              f"{ser['worst']['softlat']} ulp (softlat, bound "
              f"{SOFTLAT_ULPS}) and {ser['worst']['smooth']} ulp (smooth, "
              f"bound {SMOOTH_ULPS}) of the CPU run, the other series "
              f"bitwise; aggregate {agg['wall_ms']:.1f} ms, mean latency "
              f"within {agg['worst']['softlat']:.3g} (bound "
              f"{SOFTLAT_AGG_RTOL:.3g}) and {agg['worst']['smooth']:.3g} "
              f"(bound {SMOOTH_AGG_RTOL:.3g}) relative, the exact "
              f"statistics bitwise")
    finally:
        twin_mod._REGISTRY.clear()
        twin_mod._REGISTRY.update(saved[0])
        twin_mod._VERSION = saved[1]
        pk.reset_launches()
    return record


def phase11_builtin_twins(twin_mod):
    """16 twins of the built-ins that keep their kernel branch: Table
    II's three and 13 more."""
    tw = paper_twins(twin_mod)
    for i in range(4):
        tw.append(twin_mod.QuickscalingTwin(f"quick{i}", 0.5 + 0.5 * i,
                                            0.0082, 0.15))
        tw.append(twin_mod.make_twin(
            f"auto{i}", "autoscale", max_rps=0.5, usd_per_hour=0.002,
            base_latency_s=0.1, max_instances=8 + 8 * i, scale_up_hours=3))
        tw.append(twin_mod.make_twin(
            f"batch{i}", "batch_window", max_rps=6.15, usd_per_hour=0.0703,
            base_latency_s=0.06, window_hours=2 + 2 * i))
    tw.append(twin_mod.SimpleTwin("fifo-slow", 0.9, 0.004, 0.2))
    return tw


def phase11_registered_twins(twin_mod):
    """16 twins of the registered policies (shed's override included):
    shed 3, null 2, capped 5, and diurnal, bits and bw_copy 2 each, the
    bw_copy twins at the parameters of ``phase11_builtin_twins``'
    batch0 and batch1."""
    tw = []
    for i in range(3):
        tw.append(twin_mod.make_twin(
            f"shed{i}", "shed", max_rps=1.0 + i, usd_per_hour=0.0082,
            base_latency_s=0.15, queue_cap_hours=2))
    for i in range(2):
        tw.append(twin_mod.make_twin(f"null{i}", "null", max_rps=1.0,
                                     usd_per_hour=0.01 * (i + 1),
                                     base_latency_s=0.1))
    for i in range(5):
        tw.append(twin_mod.make_twin(
            f"capped{i}", "capped", max_rps=0.5, usd_per_hour=0.0082,
            base_latency_s=0.15, replicas=0.5 + 1.5 * i))
    for i in range(2):
        tw.append(twin_mod.make_twin(
            f"diurnal{i}", "diurnal", max_rps=0.5 + 0.5 * i,
            usd_per_hour=0.0082, base_latency_s=0.15))
        tw.append(twin_mod.make_twin(
            f"bits{i}", "bits", max_rps=1.0 + i, usd_per_hour=0.0082,
            base_latency_s=0.15))
        tw.append(twin_mod.make_twin(
            f"bw{i}", "bw_copy", max_rps=6.15, usd_per_hour=0.0703,
            base_latency_s=0.06, window_hours=2 + 2 * i))
    return tw


def ops_on_card(dev, twin_mod, ops_build):
    """11d (C15): every elementwise operation of a registered step
    (``OPS_EXACT``, ``OPS_ULP``: integer arithmetic, shifts, ``//`` and
    ``%``, casts and bit views, float floor division and remainder,
    ``nextafter``, ``sin``, ``atan2``, ...) on edge values (NaN, +-inf,
    +-0, INT_MIN, shift counts at and past the width, negative
    operands), one bin through the series kernel, against the CPU's run
    of the same steps: class 1 bitwise, class 2 within its ulps, NaN as
    NaN. Its registry (the built-ins and these steps) has a library of
    its own, built on ``ops_build``'s thread; its ptxas registers and
    spills are held to the plain library's. The registry is restored
    after. Returns the record."""
    from repro_torch.kernels import build
    from repro_torch.kernels import policy_scan as pk
    thread, took = ops_build
    thread.join()
    check("s" in took, "11d's nvcc failed (see its log in _build/)")
    saved = (dict(twin_mod._REGISTRY), twin_mod._VERSION)
    try:
        groups = ops_groups()
        for name, ops, _ in groups:
            twin_mod.register_policy(name, TRIPLE + ("a", "b", "c"))(
                ops_step(ops))
        from repro_torch.kernels import lane_codegen
        ptxas_generated(build, lane_codegen.generated().header, "11d",
                        "11d's")
        record = ops_check(dev, twin_mod, groups)
    finally:
        twin_mod._REGISTRY.clear()
        twin_mod._REGISTRY.update(saved[0])
        twin_mod._VERSION = saved[1]
        pk.reset_launches()
    record["build_s"] = took["s"]
    return record


def ops_check(dev, twin_mod, groups):
    """11d's run and comparison, in a registry that holds ``groups``."""
    from repro_torch.kernels import policy_scan as pk
    names = twin_mod.policy_names()
    pf = [(x, y) for x in OPS_F32 for y in OPS_F32]
    pi = [(x, y) for x in OPS_I32 for y in OPS_I32]
    lanes = max(len(pf), len(pi))
    hi = [OPS_HIGH[i % len(OPS_HIGH)] for i in range(lanes)]
    hi2 = [OPS_HIGH[(i // len(OPS_HIGH)) % len(OPS_HIGH)]
           for i in range(lanes)]

    def bits32(v):
        return np.asarray(v, np.int64).astype(np.int32).view(np.float32)
    block = np.stack([
        np.asarray([pf[i % len(pf)][0] for i in range(lanes)], np.float32),
        np.asarray([pf[i % len(pf)][1] for i in range(lanes)], np.float32),
        bits32([pi[i % len(pi)][0] for i in range(lanes)]),
        bits32([pi[i % len(pi)][1] for i in range(lanes)]),
        bits32(hi), bits32(hi2)], axis=1)
    params = torch.from_numpy(np.tile(block, (len(groups), 1)))
    policy = np.repeat([names.index(g) for g, _, _ in groups], lanes)
    onehot = torch.from_numpy(twin_mod.policy_onehot(policy))
    loads = torch.zeros(len(policy), 1)
    pk.reset_launches()
    t0 = time.perf_counter()
    card_c, card_s = pk.policy_grid_scan(loads.to(dev), params.to(dev),
                                         onehot.to(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(pk.launches["policy_scan"] == 1
          and pk.registered_rows["policy_scan"] == len(policy),
          (pk.launches, pk.registered_rows))
    cpu_c, cpu_s = pk.policy_grid_scan(loads, params, onehot)

    def slots(c, series):
        return torch.cat([c.cpu(), torch.stack([x[:, 0].cpu()
                                                for x in series], 1)],
                         1).numpy()
    got, want = slots(card_c, card_s), slots(cpu_c, cpu_s)
    check(np.isfinite(got).all() and np.isfinite(want).all(), "11d pieces")
    worst, n_ops = {}, 0
    for k, (name, ops, exact) in enumerate(groups):
        rows = slice(k * lanes, (k + 1) * lanes)
        col = 0
        for op in ops:
            kind, what, n = op[0], op[1], op[-1]
            g, w = got[rows, col:col + n], want[rows, col:col + n]
            col += n
            n_ops += 1
            if exact:
                bad = np.nonzero((g != w).any(axis=1))[0]
                check(len(bad) == 0, ("11d", kind, what, len(bad),
                                      block[bad[:3]].tolist()))
                continue
            # a class-2 result: its value from the pieces, then ulps on
            # the ordered integer line of its type (+-0 adjacent)
            wid = np.int64 if n == 4 else np.int32
            gv = (g.astype(np.int64) << (16 * np.arange(n))).sum(1)
            wv = (w.astype(np.int64) << (16 * np.arange(n))).sum(1)
            gv, wv = gv.astype(wid), wv.astype(wid)
            fl = np.float64 if n == 4 else np.float32
            gf, wf = gv.view(fl), wv.view(fl)
            nan = np.isnan(gf) & np.isnan(wf)
            key = [np.where(x < 0, np.iinfo(wid).min - x, x).astype(
                np.float64) for x in (gv, wv)]
            dist = np.where(nan, 0.0, np.abs(key[0] - key[1]))
            worst[f"{kind} {what}"] = float(dist.max())
            check(float(dist.max()) <= op[3],
                  ("11d", kind, what, float(dist.max()), op[3]))
    record = {"ops": n_ops, "policies": len(groups), "lanes": lanes,
              "wall_ms": 1e3 * wall, "ulps": worst}
    print(f"phase 11d: {n_ops} elementwise operations in {len(groups)} "
          f"registered steps, {lanes} edge-value lanes each (NaN, +-inf, "
          f"+-0, INT_MIN, shift counts at and past the width, negative "
          f"operands of // and %), one launch of the series kernel "
          f"({len(policy)} scenarios, {1e3 * wall:.1f} ms): "
          f"{sum(len(o) for _, o, e in groups if e)} bitwise the CPU run, "
          f"the transcendental ones within their ulps (worst "
          + ", ".join(f"{k} {v:.0f}" for k, v in sorted(worst.items()))
          + ")")
    return record


def zero_divisor_on_card(whatif, traffics, slo, twin_mod):
    """11a (C15): a registered step that divides an integer by zero on
    one twin's parameters raises the CPU's ``RuntimeError:
    ZeroDivisionError`` on the card too, read back after the launch;
    with a divisor of 4 its rows run, bitwise the CPU's."""
    from repro_torch.kernels import policy_scan as pk
    ok = twin_mod.make_twin("zdiv3", "zdiv", max_rps=1.0,
                            usd_per_hour=0.01, base_latency_s=0.1,
                            groups=3.0)
    same_results(whatif.run_grid([ok], traffics, slo=slo),
                 whatif.run_grid([ok], traffics, slo=slo, device="cpu"),
                 "11a zdiv groups 3: card vs CPU")
    bad = twin_mod.make_twin("zdiv0", "zdiv", max_rps=1.0,
                             usd_per_hour=0.01, base_latency_s=0.1,
                             groups=-1.0)
    raised, launched = {}, {}
    for where in ("cuda", "cpu"):
        pk.reset_launches()
        try:
            whatif.run_grid([bad], traffics, slo=slo, device=where)
        except RuntimeError as e:
            raised[where] = str(e)
        launched[where] = pk.launches["policy_agg"]
    # the kernel launched once and the wrapper raised after it
    check(raised.get("cuda") == raised.get("cpu") == "ZeroDivisionError"
          and launched == {"cuda": 1, "cpu": 0}, (raised, launched))
    print(f"phase 11a: zdiv (an int32 // by a parameter): divisor 4 "
          f"bitwise the CPU run; divisor 0 raises RuntimeError("
          f"{raised['cuda']!r}) on the card, read back after the launch, "
          f"as the CPU does")
    pk.reset_launches()
    return raised


def phase11_header(twin_mod):
    """The generated header of phase 11's registry (built with the other
    sources at the start, so that phase 11 loads its library)."""
    from repro_torch.kernels import lane_codegen
    saved = (dict(twin_mod._REGISTRY), twin_mod._VERSION)
    try:
        register_phase11_policies(twin_mod)
        gen = lane_codegen.generated()
        check(gen.header is not None and not gen.refused, gen.refused)
        return gen.header
    finally:
        twin_mod._REGISTRY.clear()
        twin_mod._REGISTRY.update(saved[0])
        twin_mod._VERSION = saved[1]


def by_name(rows, names):
    """The rows of ``names``, in that order."""
    index = {r.name: r for r in rows}
    return [index[n] for n in names]


def check_flash_padding(dev, pad=True):
    """Phase 11 (C17): the flash kernels against ref.flash_attention at
    head dims the wrapper pads to the kernels' multiple of 8 (g 1 and 7;
    left out when ``pad`` is false) and at head dims past 256
    (``FLASH_WIDE_PAIRS``, the wide kernels; g 1, 7 and 16), causal or
    not, both types, sq/sk around the 128-row tile (the wide kernels'
    64-row and 32-key tiles among them); one launch a call, each on its
    kernel's count. Returns the wide kernels' launches."""
    from repro_torch.kernels import flash_attention as fk, ref
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    seqs = ((63, 63), (129, 129), (300, 127), (127, 300))
    cases = [(1, sq, sk, h, kh, dq, dv, causal, dtype)
             for dq, dv in FLASH_PAD_PAIRS if pad for sq, sk in seqs
             for h, kh in ((4, 4), (14, 2)) for causal in (True, False)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(1, sq, sk, h, kh, dq, dv, causal, dtype)
              for dq, dv in FLASH_WIDE_PAIRS for sq, sk in seqs
              for h, kh in ((4, 4), (14, 2), (16, 1))
              for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_wide = {torch.float32: 0.0, torch.bfloat16: 0.0}
    fk.reset_launches()
    for b, sq, sk, h, kh, dq, dv, causal, dtype in cases:
        q = torch.randn(b, sq, h, dq, generator=g, device=dev).to(dtype)
        k = torch.randn(b, sk, kh, dq, generator=g, device=dev).to(dtype)
        v = torch.randn(b, sk, kh, dv, generator=g, device=dev).to(dtype)
        got = fk.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        check(got.dtype == dtype and got.shape == (b, sq, h, dv),
              (got.dtype, got.shape))
        into = worst_wide if max(dq, dv) > fk.MAX_HEAD_DIM else worst
        into[dtype] = max(into[dtype], close_or_raise(
            f"flash {(b, sq, sk, h, kh)} (dqk, dv) {(dq, dv)} "
            f"causal={causal} {dtype}", got, want, MODEL_TOL[dtype]))
    torch.cuda.synchronize()
    want_launches = dict.fromkeys(fk.launches, 0)
    for c in cases:
        want_launches[fk.kernel_name(c[-1], c[5], c[6])] += 1
    check(fk.launches == want_launches, (fk.launches, want_launches))
    n_wide = sum(1 for c in cases if max(c[5], c[6]) > fk.MAX_HEAD_DIM)
    print(f"phase 11: flash kernels vs plain on {len(cases)} random "
          f"blocks: at padded head dims "
          f"{', '.join(map(str, FLASH_PAD_PAIRS))} max abs error float32 "
          f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}; "
          f"past 256 (the wide kernels, {n_wide} blocks at "
          f"{', '.join(map(str, FLASH_WIDE_PAIRS))}, g 1/7/16) float32 "
          f"{worst_wide[torch.float32]:.3g}, bf16 "
          f"{worst_wide[torch.bfloat16]:.3g} (tol float32 "
          f"{MODEL_TOL[torch.float32]:g}, bf16 "
          f"{MODEL_TOL[torch.bfloat16]:g}); launches {fk.launches} "
          f"({fk.HEAD_DIM_RULE})")
    return {k: v for k, v in fk.launches.items() if "wide" in k}


def registered_policies_on_card(dev, whatif, tr, twin_mod, slo_mod, faults,
                                ops_build, first_build):
    """Phase 11: policies added with ``register_policy`` on the card,
    their steps translated into the policy kernels
    (``kernels/lane_codegen.py``). 11a: ``run_grid`` over 32 twins (four
    built-ins that keep their branch, Table II's among them, and three
    registered policies, shed's override included) x 2 traffics = 64
    full-year scenarios, both modes, through the kernels: the registered
    rows bitwise the port's CPU run, the built-in rows bitwise the plain
    library's run of the built-ins alone, before anything is registered;
    ``registered_rows`` counts every registered row in the kernels; the
    registered twins under a chaos schedule (the aggregate fault kernel)
    bitwise the CPU; ``zdiv``'s zero divisor raising on the card as on
    the CPU. 11b: a search over ``capped``'s replicas, re-checked
    through the aggregate kernel. The registry is restored at the end.
    Then 11c, 11d (its library from ``ops_build``) and the flash kernels
    at padded head dims and past 256, the wide kernel timed at
    DeepSeek-V2-Lite's absorbed shape (C17). Returns the policy kernels'
    launches of 11a's main path with the wide flash kernels' of phase 11,
    and the phase's record."""
    from repro_torch.kernels import lane_codegen
    from repro_torch.kernels import policy_scan as pk
    from repro_torch.search import search, search_space
    t0 = time.perf_counter()
    traffics = [tr.TrafficModel.honda_default("nominal", R=3.5, G=1.0),
                tr.TrafficModel.honda_default("high(+50%)", R=3.5, G=1.5)]
    slo = slo_mod.SLO(limit_s=4 * 3600, met_fraction=0.95)
    builtin = phase11_builtin_twins(twin_mod)
    # the built-ins alone, through the plain library (nothing registered)
    alone = {}
    for series in (False, True):
        check(lane_codegen.generated().header is None, "a stale registry")
        t1 = time.perf_counter()
        alone[series] = (whatif.run_grid(builtin, traffics, slo=slo,
                                         return_series=series),
                         time.perf_counter() - t1)
    saved = (dict(twin_mod._REGISTRY), twin_mod._VERSION)
    record = {}
    try:
        register_phase11_policies(twin_mod)
        names = twin_mod.policy_names()
        branches = lane_codegen.generated().branches
        check(names[:5] == ["fifo", "quickscale", "autoscale", "shed",
                            "batch_window"]
              and twin_mod.kernel_branches()[3] is None
              and all(branches[names.index(p)]
                      == lane_codegen.FIRST_GENERATED + names.index(p)
                      for p in REGISTERED), (names, branches))
        check(lane_codegen.generated().header.count("case ")
              == len(names) - 5 + 1, "a branch a registered policy (shed's "
              "override included)")
        reg = phase11_registered_twins(twin_mod)
        # interleaved, so that the kernels' sort by policy has work to do
        twins = [t for pair in zip(builtin, reg) for t in pair]
        n_scen = len(twins) * len(traffics)
        n_reg = len(reg) * len(traffics)
        check(n_scen >= 64 and len(reg) == 16, (n_scen, len(reg)))

        launches = {k: 0 for k in pk.launches}
        for series in (False, True):
            mode = "series" if series else "aggregate"
            kernel = "policy_scan" if series else "policy_agg"
            pk.reset_launches()
            t1 = time.perf_counter()
            card = whatif.run_grid(twins, traffics, slo=slo,
                                   return_series=series)
            wall = time.perf_counter() - t1
            got, rows = dict(pk.launches), dict(pk.registered_rows)
            for k, v in got.items():
                launches[k] += v
            check(got[kernel] > 0 and rows[kernel] == n_reg
                  and sum(rows.values()) == n_reg, (mode, got, rows))
            reg_names = {f"{t_.name} {tw.name}" for t_ in traffics
                         for tw in reg}
            only_reg = [r for r in card if r.name in reg_names]
            t1 = time.perf_counter()
            cpu = whatif.run_grid(reg, traffics, slo=slo,
                                  return_series=series, device="cpu")
            cpu_s = time.perf_counter() - t1
            exact = [r for r in cpu if r.twin.policy != "diurnal"]
            same_results(by_name(only_reg, [r.name for r in exact]), exact,
                         f"11a {mode}: registered rows card vs CPU")
            daily = [r for r in cpu if r.twin.policy == "diurnal"]
            diurnal_worst = within_ulps(
                by_name(only_reg, [r.name for r in daily]), daily,
                {"diurnal": (DIURNAL_ULPS, DIURNAL_AGG_RTOL)}, series,
                f"11a {mode} diurnal")["diurnal"]
            # batch_window's own step, translated, against its
            # hand-written branch at the same parameters
            for i in range(2):
                for t_ in traffics:
                    a, b = by_name(card, [f"{t_.name} bw{i}",
                                          f"{t_.name} batch{i}"])
                    check(a.twin.params == b.twin.params, (a.name, b.name))
                    for f in a.__dataclass_fields__:
                        if f not in ("twin", "name"):
                            check(np.array_equal(np.asarray(getattr(a, f)),
                                                 np.asarray(getattr(b, f))),
                                  ("11a bw_copy vs batch_window", a.name, f))
            rows_alone, alone_s = alone[series]
            same_results(by_name(card, [r.name for r in rows_alone]),
                         rows_alone,
                         f"11a {mode}: built-in rows vs the plain library's "
                         f"run of the built-ins alone")
            record[mode] = {"wall_ms": 1e3 * wall, "launches": got,
                            "registered_rows": rows[kernel],
                            "builtin_alone_ms": 1e3 * alone_s,
                            "cpu_registered_ms": 1e3 * cpu_s,
                            "diurnal_worst": diurnal_worst}
            print(f"phase 11a: run_grid {mode}, {n_scen} full-year "
                  f"scenarios ({len(builtin)} built-in and {len(reg)} "
                  f"registered twins x {len(traffics)} traffics): "
                  f"{1e3 * wall:.1f} ms wall; {kernel} launches "
                  f"{got[kernel]}, of them {rows[kernel]} rows through "
                  f"generated steps; the registered rows bitwise the CPU "
                  f"run's (null, shed, capped, bits, bw_copy), diurnal's "
                  f"latency within "
                  + (f"{diurnal_worst} ulp (bound {DIURNAL_ULPS})" if series
                     else f"{diurnal_worst:.3g} relative (bound "
                     f"{DIURNAL_AGG_RTOL:.3g})")
                  + f" and the rest bitwise; bw_copy bitwise the built-in "
                  f"batch_window at its parameters; the built-in rows "
                  f"bitwise the plain library's "
                  f"run of the built-ins alone ({1e3 * alone_s:.1f} ms for "
                  f"{len(builtin) * len(traffics)} scenarios); the CPU's "
                  f"run of the registered rows {1e3 * cpu_s:.1f} ms")
        # the fault kernel: a registered twin beside built-ins
        schedule = chaos_schedule(faults, 2)
        pk.reset_launches()
        mixed = [t for t in reg if t.policy == "capped"][:1] + builtin[:2]
        t1 = time.perf_counter()
        card = whatif.run_grid(mixed, traffics, slo=slo, faults=schedule)
        fault_s = time.perf_counter() - t1
        check(pk.launches["policy_agg_fault"] > 0
              and pk.registered_rows["policy_agg_fault"] > 0,
              (pk.launches, pk.registered_rows))
        cpu = whatif.run_grid(mixed, traffics, slo=slo, faults=schedule,
                              device="cpu")
        same_results(card, cpu, "11a chaos: card vs CPU")
        record["chaos"] = {"rows": len(card), "wall_ms": 1e3 * fault_s,
                           "registered_rows":
                           pk.registered_rows["policy_agg_fault"]}
        print(f"phase 11a: chaos suite (2 fault futures) over "
              f"{len(mixed)} twins, registered and built-in: {len(card)} "
              f"rows in {1e3 * fault_s:.1f} ms, bitwise the CPU run "
              f"(fault-kernel launches {pk.launches['policy_agg_fault']}, "
              f"registered rows {pk.registered_rows['policy_agg_fault']})")
        gen = lane_codegen.generated()
        check(gen.int_div == ("zdiv",) and not gen.refused
              and gen.transcendental == ("diurnal",),
              (gen.int_div, gen.refused, gen.transcendental))
        record["zero_divisor"] = zero_divisor_on_card(
            whatif, traffics[:1], slo, twin_mod)

        # 11b: search over the registered policy, re-checked on the card
        base = twin_mod.make_twin("capped", "capped", max_rps=0.5,
                                  usd_per_hour=0.0082, base_latency_s=0.15,
                                  replicas=1.0)
        surge = tr.TrafficModel.honda_default("surge", R=3.5, G=1.5)
        pk.reset_launches()
        t1 = time.perf_counter()
        res = search(search_space(base, ("replicas",)), [surge], slo,
                     restarts=2, steps=10, coarsen=12, polish_rounds=0)
        search_s = time.perf_counter() - t1
        rows = pk.registered_rows["policy_agg"]
        check(res.feasible and np.isfinite(res.cost_usd) and rows > 0
              and pk.launches["policy_agg"] > 0,
              ("11b", res.feasible, res.cost_usd, pk.launches,
               pk.registered_rows))
        win = [res.twin]
        same_results(whatif.run_grid(win, [surge], slo=slo),
                     whatif.run_grid(win, [surge], slo=slo, device="cpu"),
                     "11b winner card vs CPU")
        record["search"] = {"s": search_s, "replicas":
                            res.twin.param("replicas"),
                            "cost_usd": res.cost_usd,
                            "launches": pk.launches["policy_agg"],
                            "registered_rows": rows}
        print(f"phase 11b: search over capped's replicas (2 restarts x 10 "
              f"steps at 728 bins, no polish round), re-checked through "
              f"the aggregate kernel ({pk.launches['policy_agg']} "
              f"launches, {rows} registered rows): {search_s:.1f} s, "
              f"feasible, replicas {res.twin.param('replicas'):.4f}, "
              f"${res.cost_usd:.4f}; its rows bitwise the CPU run's")
    finally:
        twin_mod._REGISTRY.clear()
        twin_mod._REGISTRY.update(saved[0])
        twin_mod._VERSION = saved[1]
        pk.reset_launches()
    record["softlat"] = softlat_on_card(whatif, tr, twin_mod, slo_mod)
    record["ops"] = ops_on_card(dev, twin_mod, ops_build)
    wide = check_flash_padding(dev)
    launches.update(wide)
    # the wide kernels at DeepSeek-V2-Lite's absorbed shape, both types,
    # beside their first form
    first = first_form_lib(first_build)
    record["wide"] = {
        "flash_attention_wide": flash_wide_vs_first(dev, torch.bfloat16,
                                                    first),
        "flash_attention_wide_f32": flash_wide_vs_first(dev, torch.float32,
                                                        first)}
    record["s"] = time.perf_counter() - t0
    print(f"phase 11: {record['s']:.1f} s")
    print(json.dumps({"registered": record}))
    return launches, record


# ---------------------------------------------------------------------------
# Phase 12: training on one card (ROADMAP A9)
# ---------------------------------------------------------------------------

#: 12a's bounds, card against CPU in float32 (TF32 off): the loss
#: relative; each gradient relative to its leaf's largest |value|
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
#: the card's ``adamw_update`` against the CPU's, both on the card's
#: gradients, in units in the last place of the new parameter (the two
#: differ only in the order of the global norm's sum)
TRAIN_OPT_ULPS = 4
#: the new parameters of the whole step, card against CPU, in units of
#: the learning rate. AdamW's first step moves a parameter by lr * g /
#: (|g| + eps) (plus the same decay on both sides), which a gradient
#: error dg changes by at most lr * eps * dg / |g|^2: where |g| >= 100 *
#: max(eps, dg) that is below 1e-4 lr, and the step is held to
#: TRAIN_PARAM_LR; the rest, gradients within rounding of eps or of
#: their own error, may move anywhere in (-lr, lr) on either side, and
#: are held to the width of that range
TRAIN_PARAM_LR = 1e-3
TRAIN_PARAM_REST_LR = 2.0
#: 12b's bound on a loss of the restarted run against the uninterrupted
#: one, relative (checked bitwise first; the bound only where it is not)
TRAIN_RESTART_RTOL = 1e-3
H100_BF16_FLOPS = 989e12
#: kernel-name marks that sort a profiled step's device time by kind
STEP_KERNEL_KINDS = (
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce_kernel", "Reduce")),
    ("index", ("index", "scatter", "gather")),
    ("elementwise", ("elementwise", "copy", "fill")))


def train_smoke_card_vs_cpu(dev, get_smoke_config):
    """12a: one ``make_train_step`` step of smoke llama3.2 in float32 on
    the card against the same step on the CPU (loss, every gradient,
    every new parameter); no model kernel launches in it, and a serving
    prefill right after launches flash."""
    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    from repro_torch.train.steps import make_train_step
    mods = model_kernels()
    cfg = dataclasses.replace(get_smoke_config(LLAMA), dtype="float32")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    par = ParallelConfig(batch_axes=("data",))
    params = M.init_params(cfg, seed=SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32)),
        "loss_mask": torch.ones(4, 64)}
    out = {}
    for where in ("cpu", dev):
        step = make_train_step(cfg, ocfg, par, device=where)
        p = {k: v.to(where) for k, v in params.items()}
        b = {k: v.to(where) for k, v in batch.items()}
        for mod in mods:
            mod.reset_launches()
        grads, metrics = step.grads(p, b)
        new_p, _, m = step(p, init_opt_state(p, ocfg), b)
        # the optimizer alone, on the gradients above
        upd_p, _ = adamw_update(p, grads, init_opt_state(p, ocfg), ocfg)
        if where != "cpu":
            torch.cuda.synchronize()
            launched = {k: v for mod in mods for k, v in mod.launches.items()}
            check(sum(launched.values()) == 0, ("12a", launched))
        out[str(where)] = tuple({k: v.cpu() for k, v in d.items()}
                                for d in (grads, new_p, upd_p)) + (
            float(m["loss"]),)
    (g_c, p_c, _, l_c), (g_g, p_g, u_g, l_g) = out["cpu"], out[str(dev)]
    loss_err = abs(l_g - l_c) / abs(l_c)
    check(loss_err <= TRAIN_LOSS_RTOL, ("12a loss", l_g, l_c))
    grad_err = max(float((g_g[k] - g_c[k]).abs().max())
                   / max(float(g_c[k].abs().max()), 1e-30) for k in g_c)
    check(grad_err <= TRAIN_GRAD_RTOL, ("12a grads", grad_err))
    # the optimizer: the CPU's update of the card's gradients
    u_c, _ = adamw_update(params, g_g, init_opt_state(params, ocfg), ocfg)
    opt_ulps = 0.0
    for k in u_c:
        ulp = torch.nextafter(u_c[k].abs(), torch.tensor(float("inf"))) \
            - u_c[k].abs()
        opt_ulps = max(opt_ulps, float(((u_g[k] - u_c[k]).abs() / ulp)
                                       .max()))
    check(opt_ulps <= TRAIN_OPT_ULPS, ("12a optimizer", opt_ulps))
    # the whole step, split by how far each gradient stands above eps
    # and above its own error
    tight = rest = 0.0
    n_tight = n_rest = 0
    worst = None
    for k in p_c:
        err = (p_g[k] - p_c[k]).abs() / ocfg.lr
        dg = (g_g[k] - g_c[k]).abs()
        held = g_c[k].abs() >= 100.0 * torch.clamp_min(dg, ocfg.eps)
        n_tight += int(held.sum())
        n_rest += int((~held).sum())
        if held.any():
            tight = max(tight, float(err[held].max()))
        if (~held).any():
            rest = max(rest, float(err[~held].max()))
        i = int(err.argmax())
        e = float(err.flatten()[i])
        if worst is None or e > worst["err_lr"]:
            worst = {"leaf": k, "index": list(np.unravel_index(
                i, tuple(err.shape))), "err_lr": e,
                "g_cpu": float(g_c[k].flatten()[i]),
                "g_card": float(g_g[k].flatten()[i]),
                "held_tight": bool(held.flatten()[i])}
    worst["index"] = [int(x) for x in worst["index"]]
    check(tight <= TRAIN_PARAM_LR and rest <= TRAIN_PARAM_REST_LR,
          ("12a params", tight, rest, worst))
    param_err = max(tight, rest)
    # serving right after the train step still takes the flash kernel
    fk = mods[0]
    fk.reset_launches()
    with torch.inference_mode():
        p = {k: v.to(dev) for k, v in params.items()}
        cache = M.init_cache(cfg, 4, 64, device=dev)
        logits, _ = M.prefill(p, cfg, {"tokens": batch["tokens"][:, :32]
                                       .to(dev)}, cache)
    torch.cuda.synchronize()
    check(fk.launches["flash_attention_f32"] == cfg.num_layers
          and bool(torch.isfinite(logits).all()), ("12a serve", fk.launches))
    print(f"phase 12a: one train step of {cfg.name} (float32, 4 x 64 "
          f"tokens) on the card vs the CPU: loss {l_g:.6f} (rel error "
          f"{loss_err:.3g}, tol {TRAIN_LOSS_RTOL:g}), gradients max "
          f"{grad_err:.3g} of the leaf's largest (tol {TRAIN_GRAD_RTOL:g}),"
          f" the card's AdamW vs the CPU's on the card's gradients "
          f"{opt_ulps:.3g} ulp (tol {TRAIN_OPT_ULPS}); new parameters "
          f"{tight:.3g} lr over the {n_tight:,} with |g| >= 100 max(eps, "
          f"|dg|) (tol {TRAIN_PARAM_LR:g} lr), {rest:.3g} lr over the other"
          f" {n_rest:,} (tol {TRAIN_PARAM_REST_LR:g} lr); the largest at "
          f"{worst['leaf']}{worst['index']}: g {worst['g_cpu']:.4g} on the "
          f"CPU, {worst['g_card']:.4g} on the card; no model kernel "
          f"launched in the step; a serving prefill right after: "
          f"{fk.launches['flash_attention_f32']} flash launches")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "opt_ulps": opt_ulps, "param_tight_lr": tight,
            "param_rest_lr": rest, "n_tight": n_tight, "n_rest": n_rest,
            "param_worst": worst, "param_err_lr": param_err}


def llama_100m():
    """``examples/train_telemetry.py``'s ~100M llama-family model."""
    from repro_torch.config import AttentionConfig, ModelConfig
    return ModelConfig(
        name="llama-100m", family="dense", num_layers=8, d_model=512,
        d_ff=2048, vocab_size=32768,
        attention=AttentionConfig(kind="gqa", num_heads=8, num_kv_heads=4,
                                  head_dim=64, rope="standard"),
        mlp_kind="swiglu", norm="rmsnorm", tie_embeddings=True,
        max_seq_len=128)


def span_means_ms(collector, names):
    return {n: 1e3 * float(np.mean([s.duration for s in
                                    collector.spans(n)]))
            for n in names if collector.spans(n)}


def train_100m_faults(dev, root):
    """12b: the ~100M llama through ``train`` on the card, 30 steps of
    8 x 128 tokens, a checkpoint every 10, a transient fault and a node
    loss; then the same run uninterrupted, held against it."""
    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    TrainConfig)
    from repro_torch.distributed.fault import FaultInjector
    from repro_torch.models.model import param_count
    from repro_torch.train.loop import train
    from repro_torch.kernels import policy_scan as pk
    mods = model_kernels() + (pk,)
    cfg = llama_100m()
    ocfg = OptimizerConfig(lr=6e-4, total_steps=30, warmup_steps=1)
    par = ParallelConfig(batch_axes=("data",))
    runs, launches = {}, {}
    # the injector counts attempts and the transient fault's retry takes
    # one: attempt 11 is the first after step 10's checkpoint
    for what, inj in (("faults", FaultInjector(transient_at=(2,),
                                               node_loss_at=(11,))),
                      ("clean", None)):
        tcfg = TrainConfig(steps=30, seq_len=128, global_batch=8,
                           checkpoint_every=10, log_every=100,
                           checkpoint_dir=os.path.join(root, what))
        for mod in mods:
            mod.reset_launches()
        t0 = time.perf_counter()
        res = train(cfg, tcfg, ocfg, par, device=dev, injector=inj,
                    verbose=False)
        runs[what] = (res, time.perf_counter() - t0, inj)
        launched = {k: v for mod in mods for k, v in mod.launches.items()}
        check(sum(launched.values()) == 0, ("12b", what, launched))
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
    (res, wall, inj), (clean, clean_wall, _) = runs["faults"], runs["clean"]
    check(res.steps_done == 30 and res.restarts == 1
          and inj.fired == ["transient@2", "node_loss@11"]
          and res.final_loss < res.losses[0], ("12b", res.steps_done,
                                               res.restarts, inj.fired))
    check(len(res.losses) == len(clean.losses) == 30, len(res.losses))
    a, b = np.array(res.losses), np.array(clean.losses)
    bitwise = bool((a.view(np.uint64) == b.view(np.uint64)).all())
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    check(bitwise or rel <= TRAIN_RESTART_RTOL, ("12b restart", rel))
    spans = span_means_ms(res.collector, ("datagen", "datagen+next", "h2d",
                                          "train_step", "checkpoint"))
    print(f"phase 12b: {cfg.name} ({param_count(cfg):,} parameters), 30 "
          f"steps of 8 x 128 tokens, checkpoints every 10, a transient "
          f"fault at attempt 2 and a node loss at attempt 11: "
          f"{res.steps_done} steps, {res.restarts} restart, loss "
          f"{res.losses[0]:.4f} -> {res.final_loss:.4f} in {wall:.1f} s "
          f"(uninterrupted {clean_wall:.1f} s); losses "
          + ("bitwise the uninterrupted run's" if bitwise else
             f"within {rel:.3g} of the uninterrupted run's (tol "
             f"{TRAIN_RESTART_RTOL:g})")
          + "; span means " + ", ".join(f"{k} {v:.2f} ms"
                                        for k, v in spans.items()))
    return {"steps": res.steps_done, "restarts": res.restarts,
            "first_loss": res.losses[0], "final_loss": res.final_loss,
            "wall_s": wall, "clean_wall_s": clean_wall,
            "restart_bitwise": bitwise, "restart_rel_err": rel,
            "span_ms": spans, "launches": launches}


def step_profile(step_fn, params, opt_state, batch):
    """One more train step under ``torch.profiler``: wall and summed
    kernel time (ms), the busy share, and the PyTorch operations the
    host dispatched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        out[2]["loss"].item()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    del out
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)
    ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
              and not (e.cpu_parent is not None
                       and e.cpu_parent.name.startswith("aten::")))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    kinds = {}
    for e in kernels:
        kind = next((k for k, marks in STEP_KERNEL_KINDS
                     if any(m in e.key for m in marks)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total
    return {"wall_ms": wall_us / 1e3, "device_ms": dev_us / 1e3,
            "busy": dev_us / wall_us if dev_us else None, "host_ops": ops,
            "kinds": {k: round(v / max(dev_us, 1), 4)
                      for k, v in sorted(kinds.items(),
                                         key=lambda kv: -kv[1])},
            "top": [[e.key[:90], round(e.self_device_time_total
                                       / max(dev_us, 1), 4), e.count]
                    for e in top]}


def train_llama_1b(dev, root):
    """12c: llama3.2-1b at full width and depth through ``train`` as
    ``python -m repro_torch.launch.train`` builds its configs: 8 x 1024
    tokens a step, ``remat="full"``, int8 moments, 6 steps and one
    final checkpoint (written synchronously, so its span is the write),
    restored onto the card and held bitwise to the final state, then
    deleted; one more step under ``torch.profiler``."""
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.data.loader import TokenBatchLoader
    from repro_torch.distributed.elastic import state_like
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import param_count
    from repro_torch.train.loop import train
    from repro_torch.train.steps import make_train_step
    from repro_torch.kernels import policy_scan as pk
    mods = model_kernels() + (pk,)
    ckpt = os.path.join(root, "llama1b")
    args = launch_train.parse_args([
        "--arch", LLAMA, "--steps", "6", "--seq-len", "1024", "--batch",
        "8", "--ckpt-dir", ckpt, "--ckpt-every", "6", "--remat", "full",
        "--device", "cuda"])
    cfg, tcfg, ocfg, par = launch_train.configs(args)
    tcfg = dataclasses.replace(tcfg, async_checkpoint=False)
    ocfg = dataclasses.replace(ocfg, state_dtype="int8")
    n_params = param_count(cfg)
    tokens = tcfg.global_batch * tcfg.seq_len
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    res = train(cfg, tcfg, ocfg, par, device=dev, verbose=False)
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = {k: v for mod in mods for k, v in mod.launches.items()}
    check(sum(launched.values()) == 0, ("12c", launched))
    check(res.steps_done == 6 and all(np.isfinite(res.losses)),
          ("12c", res.losses))
    steps = [s.duration for s in res.collector.spans("train_step")]
    step_ms = 1e3 * float(np.mean(steps[1:6]))
    (ck,) = res.collector.spans("checkpoint")
    t1 = time.perf_counter()
    (p2, o2), step, _ = restore_checkpoint(ckpt, None,
                                           state_like(cfg, ocfg, dev))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    check(step == 6, step)
    for k in res.params:
        assert_bitwise(f"12c restored {k}", p2[k], res.params[k])
    for field in ("m", "v", "m_scale", "v_scale"):
        got, want = getattr(o2, field), getattr(res.opt_state, field)
        check(set(got) == set(want), field)
        for k in want:
            check(bool(torch.equal(got[k], want[k])), ("12c", field, k))
    check(int(o2.step) == int(res.opt_state.step) == 6, "12c opt step")
    ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(ckpt) for f in fs)
    del p2, o2
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()
    loader = TokenBatchLoader(cfg.vocab_size, tcfg.seq_len,
                              tcfg.global_batch, seed=tcfg.seed)
    loader.load_state_dict({"step": 6, "seed": tcfg.seed})
    batch = {k: torch.from_numpy(v).to(dev) for k, v in loader.next().items()}
    loader.close()
    prof = step_profile(make_train_step(cfg, ocfg, par, dev), res.params,
                        res.opt_state, batch)
    mfu = 6.0 * n_params * tokens / (step_ms / 1e3) / H100_BF16_FLOPS
    att_ms, att_by, att_ops = train_attention_bound(
        cfg, tcfg.global_batch, tcfg.seq_len, par.remat)
    att_times = train_attention_times(dev, cfg, tcfg.global_batch,
                                      tcfg.seq_len, par.remat)
    out = {"model": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "attention_bound_ms": att_ms, "attention_bound_by": att_by,
           "attention_ops": att_ops, "attention_times": att_times,
           "tokens_per_step": tokens, "remat": par.remat,
           "state_dtype": ocfg.state_dtype, "step_ms": step_ms,
           "step_ms_all": [1e3 * s for s in steps],
           "tokens_per_s": tokens / (step_ms / 1e3), "mfu_bf16": mfu,
           "peak_gib": peak_gib,
           "first_loss": res.losses[0], "last_loss": res.losses[-1],
           "losses": res.losses, "ckpt_write_s": ck.duration,
           "ckpt_restore_s": restore_s, "ckpt_bytes": ckpt_bytes,
           "wall_s": wall, "profile": prof, "launches": launched}
    print(f"phase 12c: {cfg.name} at all {cfg.num_layers} layers "
          f"({n_params:,} float32 parameters, int8 moments, remat full), "
          f"6 steps of {tcfg.global_batch} x {tcfg.seq_len} tokens through "
          f"train(): step {step_ms:.1f} ms (mean of steps 2-6), "
          f"{out['tokens_per_s']:.0f} tokens/s, 6 N T / step = "
          f"{mfu:.1%} of 989 TFLOP/s bf16; loss {res.losses[0]:.4f} -> "
          f"{res.losses[-1]:.4f}; peak {peak_gib:.2f} GiB; checkpoint "
          f"{ckpt_bytes / 1e9:.2f} GB written in {ck.duration:.2f} s, "
          f"restored in {restore_s:.2f} s, bitwise the final state; one "
          f"step profiled: wall {prof['wall_ms']:.1f} ms, device "
          f"{prof['device_ms']:.1f} ms, busy "
          + (f"{prof['busy']:.1%}" if prof["busy"] is not None
             else "not measured (the profiler saw no device time)")
          + f", {prof['host_ops']} PyTorch operations; device time by "
          f"kind {prof['kinds']}; the step's attention (ref.sdpa's whole "
          f"[s, s], remat {par.remat}) {att_ops / 1e12:.2f} TFLOP, bound "
          f"{att_ms:.3f} ms ({att_by}); a layer's attention forward / "
          f"forward + backward at {tcfg.global_batch} x {tcfg.seq_len}: "
          + ", ".join(f"{n} {t['fwd_ms']:.3f} / {t['fwd_bwd_ms']:.3f} ms "
                      f"({t['step_ms']:.1f} ms a step)"
                      for n, t in (("ref.sdpa", att_times["plain"]),
                                   ("SDPA", att_times["library"]))))
    return out


def training_on_card(dev, get_smoke_config):
    """Phase 12: the training side on one card (12a-12c, see those).
    Returns the model kernels' launches that 12b (both runs) and 12c
    read after their resets, summed (each checked to be zero), and the
    phase's record, printed as a ``{"train": ...}`` line."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="plantd_train_")
    try:
        print(f"phase 12: checkpoints under {root} "
              f"({shutil.disk_usage(root).free / 1e9:.1f} GB free)")
        record = {"12a": train_smoke_card_vs_cpu(dev, get_smoke_config)}
        record["12b"] = train_100m_faults(dev, root)
        # 12c from a card that holds no earlier model
        torch.cuda.empty_cache()
        record["12c"] = train_llama_1b(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record["s"] = time.perf_counter() - t0
    print(f"phase 12: {record['s']:.1f} s")
    print(json.dumps({"train": record}))
    launches = {}
    for part in ("12b", "12c"):
        for k, v in record[part]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches, record


# ---------------------------------------------------------------------------
# Phase 13: the multi-GPU layer (ROADMAP A8.1) over two gloo ranks on the
# one card: correctness, not scaling (the ranks share the card's time)
# ---------------------------------------------------------------------------

MESH_RANKS = 2
#: 13a's scenario blocks for 4b's grid (five policy runs of 8,192 to
#: 16,384 scenarios: 5 and 8 policy-uniform blocks) and for 4d's
MESH_BLOCKS = (32768, 8192)
MESH_4D_BLOCK = 2048
#: 13b: phase 7b's fit cut to 10 steps; a search at coarsen=12 of 4
#: steps (cut from 20 and 8 for the time limit: every step is
#: held bitwise to devices=None either way)
MESH_FIT_STEPS = 10
MESH_SEARCH_STEPS = 4
#: 13b's bound where a restart mesh is not bitwise: the reference's own
#: bound on its sharded fit (src/repro/calibrate/fit.py:177-185)
MESH_RESTART_RTOL = 2e-6
#: 13c, 12b's model in float32 (TF32 off) over data=2 against one rank
#: on the whole batch: the loss of each step (relative), the first
#: step's gradients (each leaf's largest difference over its largest
#: |value|, the bound of tests/test_torch_train_mesh.py), and the
#: parameters after MESH_100M_STEPS steps in learning rates (measured on
#: the H100: 1.17e-7, 2.61e-6, 0.0514 lr; AdamW moves a
#: parameter by about lr a step, so a step that never updated would
#: miss by about MESH_100M_STEPS lr)
MESH_100M_STEPS = 4
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_RTOL = 1e-5
MESH_PARAM_LR = 0.5
#: 13d: llama3.2-1b over data=2, each step's loss against one rank's
#: steps on the whole batch (bf16 products over 4 rows a rank against
#: 8), about 10x what the H100 measured at 8 layers: 7.99e-8, then
#: 8.46e-5 after one AdamW step (a parameter moves by about lr times
#: its gradient's sign, which flips where the gradient is near zero)
MESH_1B_STEPS = 2
MESH_1B_LOSS_RTOL = (1e-6, 1e-3)
#: 13d's depth: 4 of llama3.2-1b's 16 layers, for the script's time
#: limit (at all 16 the first loss equalled 12c's bitwise; at 8, 7.99e-8
#: and 8.46e-5 of one rank's). 2 layers ran 18.1 s against 4's 19.4 s:
#: staging the embedding's gather and reduce through the host dominates
MESH_1B_LAYERS = 4
#: 13e-smoke and 14e's kind whose widths fall back over a model axis of 2
#: (ROADMAP C19): smoke llama3.2 with 3 query heads over 1 KV head and
#: d_ff 129, which 2 divides neither: wq / wk / wv / wo cut across a head
#: (1.5 query heads and half the KV head a rank, gathered whole),
#: attention over every head on every rank, the MLP whole; in
#: MESH_TP_SMOKE and SERVE_MESH_SMOKE as ``None``
FALLBACK_SMOKE = ("llama3.2 3:1 heads d_ff 129", LLAMA, 3, 1, 129)
#: 13e-smoke: the five smoke kinds the training step splits over
#: ``model`` (GQA with RoPE, MLA, Mamba without experts, RWKV-6,
#: experts), FALLBACK_SMOKE and smoke moonshot with its experts over
#: ``model`` itself (``expert_axis="model"``: 4 of its 8 experts a rank
#: at their whole width, their results summed over ``model``), in
#: float32 with TF32 off, over (data, model) = (1, 2),
#: remat "full", MESH_TP_STEPS steps against one rank's on the whole
#: batch, within 13c's bounds (MESH_LOSS_RTOL on each loss,
#: MESH_GRAD_RTOL on each first gradient); (arch, config overrides,
#: ParallelConfig overrides)
MESH_TP_SMOKE = ((LLAMA, {}, {}), ("minicpm3-4b", {}, {}),
                 (JAMBA, {"moe": None}, {}), (RWKV, {}, {}), (PHI, {}, {}),
                 (None, {}, {}), (MOONSHOT, {}, {"expert_axis": "model"}))
MESH_TP_STEPS = 2
#: 13e-smoke's bound on RWKV-6's first gradients: the H100 read 2.05e-5
#: of one rank's (the CPU 5.4e-6), past 13c's 1e-5, where the other four
#: kinds read 5.7e-7 to 4.4e-6. The WKV recurrence grows summation-order
#: rounding (tools/serve_mesh_drift.py --parts: one rank drifts from a
#: float64 forward as far as the mesh does); the CPU tests hold RWKV-6
#: to the reference at 1e-4 (tests/test_torch_train_tp.py's
#: REF_GRAD_RTOL); a wrong shard reads O(0.1)
MESH_TP_GRAD_RTOL = {RWKV: 1e-4}
#: 13e: llama3.2-1b at full width over model=2 as ``launch/train.py
#: --model 2`` builds it (int8 moments, remat full), cut to
#: MESH_TP_1B_LAYERS layers, MESH_TP_STEPS steps of 4 x 1,024 tokens,
#: both ranks on the whole batch. Each loss against one rank's steps,
#: bounds set before the first run (PERF.md section 6): the
#: first differs from one rank only by where bf16 rounds (a row-parallel
#: sum rounds once after the ranks' float32 partials; the
#: vocabulary-parallel logsumexp sums exponentials in another order),
#: the second also by an int8 AdamW step, which moves a parameter by
#: about lr and flips where its gradient is near zero (13d over data=2:
#: 7.6e-8, then 3.5e-4)
MESH_TP_1B_LAYERS = 2
MESH_TP_1B_BATCH = 4
MESH_TP_1B_LOSS_RTOL = (1e-3, 5e-3)


def rows_array(rows):
    """The numbers of grid result rows as {field: array}, for a bitwise
    comparison (``slo_met`` None as -1)."""
    out = {}
    for f in rows[0].__dataclass_fields__:
        if f in ("name", "twin"):
            continue
        vals = [getattr(r, f) for r in rows]
        if f == "slo_met":
            vals = [-1 if v is None else int(v) for v in vals]
        out[f] = np.asarray(vals)
    return out


def same_arrays(got, want, what):
    check(sorted(got) == sorted(want), what)
    for f, v in want.items():
        g = got[f]
        ok = g.shape == v.shape and (
            np.array_equal(g.view(np.uint64), v.view(np.uint64))
            if v.dtype == np.float64 else np.array_equal(g, v))
        check(ok, f"{what}: field {f} differs")


def mesh_grid(ref):
    """13a: 4b's 65,536-scenario grid and 4d's 4,096-row fault grid with
    ``devices=2``, bitwise their ``devices=None`` rows (``ref``), and
    each round's ``grid.round`` span."""
    from repro_torch import faults, obs
    from repro_torch.core import slo as slo_mod
    from repro_torch.core import traffic as tr
    from repro_torch.core import twin as twin_mod
    from repro_torch.core import whatif
    sweep = whatif5_twins(twin_mod)
    slo = slo_mod.SLO(limit_s=4 * 3600, met_fraction=0.95)
    growths256 = [tr.TrafficModel.honda_default(f"g{g:.4f}", R=3.5,
                                                G=float(g))
                  for g in np.linspace(1.0, 1.75, 256)]
    out = {}
    for block in MESH_BLOCKS:
        with obs.capture() as rec:
            t0 = time.perf_counter()
            rows = whatif.run_grid(sweep, growths256, slo=slo,
                                   scenario_block=block, devices=MESH_RANKS)
            wall = time.perf_counter() - t0
        rounds = [dict(sp.attrs) for sp in rec.find("grid.round")]
        check(len(rounds) >= 1 and all(
            r == {"round": i, "devices": MESH_RANKS, "block": block,
                  "backend": "cuda", "scenarios": MESH_RANKS * block}
            for i, r in enumerate(rounds)), ("13a rounds", rounds))
        same_arrays(rows_array(rows), ref["4b"], f"13a block {block}")
        out[f"block_{block}"] = {"wall_ms": 1e3 * wall,
                                 "rounds": len(rounds)}
    growths4 = [tr.TrafficModel.honda_default(f"g{g:.2f}", R=3.5,
                                              G=float(g))
                for g in np.linspace(1.0, 1.75, 4)]
    t0 = time.perf_counter()
    rows = whatif.run_grid(sweep, growths4, slo=slo,
                           faults=chaos_schedule(faults, 4),
                           scenario_block=MESH_4D_BLOCK, devices=MESH_RANKS)
    out["fault_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    same_arrays(rows_array(rows), ref["4d"], "13a 4d's fault grid")
    return out


def rel_or_bitwise(a, b):
    """(bitwise, largest relative difference) of two float arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bitwise = a.shape == b.shape and np.array_equal(a.view(np.uint64),
                                                    b.view(np.uint64))
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))) \
        if a.size else 0.0
    return bitwise, rel


def mesh_restarts():
    """13b: phase 7b's fit (cut to MESH_FIT_STEPS steps) and a small
    What-if #6 search, each with ``devices=2`` against ``devices=None``
    on the same card."""
    from repro_torch import calibrate as cal
    from repro_torch.core import loadpattern as lp
    from repro_torch.core import slo as slo_mod
    from repro_torch.core import traffic as tr
    from repro_torch.core import twin as twin_mod
    from repro_torch.search import search, search_space
    truth = twin_mod.make_twin("t", "shed", max_rps=2.0, usd_per_hour=0.05,
                               base_latency_s=0.2, queue_cap_hours=1.5)
    trace = cal.ObservedTrace.from_loadpattern(ramp_6h(lp), truth,
                                               bin_s=300.0)
    surge, slo, base = search_problem(tr, twin_mod, slo_mod)
    space = search_space(base, SEARCH_FREE)
    runs = {}
    for devices in (MESH_RANKS, None):
        t0 = time.perf_counter()
        fit = cal.fit(trace, "shed", restarts=8, steps=MESH_FIT_STEPS,
                      seed=SEED, devices=devices)
        t1 = time.perf_counter()
        res = search(space, [surge], slo, restarts=4,
                     steps=MESH_SEARCH_STEPS, coarsen=SEARCH_CUT_COARSEN,
                     polish_rounds=0, devices=devices)
        runs[devices] = (fit, res, t1 - t0, time.perf_counter() - t1)
    (fit, res, fit_s, search_s), (fit1, res1, fit1_s, search1_s) = (
        runs[MESH_RANKS], runs[None])
    out = {"fit_s": fit_s, "fit_s_unsharded": fit1_s, "search_s": search_s,
           "search_s_unsharded": search1_s}
    for name, a, b in (("fit_params", fit.start_params, fit1.start_params),
                       ("fit_losses", fit.start_losses, fit1.start_losses),
                       ("fit_history", fit.loss_history, fit1.loss_history),
                       ("search_params", res.restart_params,
                        res1.restart_params),
                       ("search_history", res.history, res1.history)):
        bitwise, rel = rel_or_bitwise(a, b)
        check(bitwise or rel <= MESH_RESTART_RTOL, ("13b", name, rel))
        out[name] = {"bitwise": bitwise, "rel": rel}
    check(res.cost_usd == res1.cost_usd or abs(
        res.cost_usd - res1.cost_usd) <= MESH_RESTART_RTOL * res1.cost_usd,
        ("13b search cost", res.cost_usd, res1.cost_usd))
    out["search_cost_usd"] = res.cost_usd
    return out


def mesh_state_equal(a, b):
    from repro_torch.checkpoint.ckpt import _items
    a, b = dict(_items(a)), dict(_items(b))
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                          for k in a)


def mesh_train_100m(rank, dev, root):
    """13c: 12b's model in float32 over data=2 for MESH_100M_STEPS steps
    of 8 x 128 against one rank; checkpoints 2 -> 2, 2 -> 1 and 1 -> 2
    ranks bitwise; a pod=2 step with int8 gradient compression against
    its host emulation."""
    from repro_torch.checkpoint.ckpt import (gather_tree, reshard_tree,
                                             save_checkpoint)
    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.data.loader import TokenBatchLoader
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step
    from torch.distributed.device_mesh import DeviceMesh
    cfg = dataclasses.replace(llama_100m(), dtype="float32")
    ocfg = OptimizerConfig(lr=6e-4, total_steps=30, warmup_steps=1)
    par = ParallelConfig(batch_axes=("data",))
    loader = TokenBatchLoader(cfg.vocab_size, 128, 8, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                loader.next().items()} for _ in range(MESH_100M_STEPS)]
    loader.close()
    rows = torch.from_numpy(sh.batch_rows(8, rank, MESH_RANKS)).to(dev)
    fresh = M.init_params(cfg, seed=SEED, device=dev)
    out, one = {}, None
    if rank == 0:           # the one-rank run, on rank 0 alone
        step1 = make_train_step(cfg, ocfg, par, dev)
        one_grads, _ = step1.grads(fresh, batches[0])
        one = (fresh, init_opt_state(fresh, ocfg))
        one_losses = []
        for b in batches:
            p, o, m = step1(one[0], one[1], b)
            one = (p, o)
            one_losses.append(float(m["loss"]))
    sh.barrier()
    mesh = make_host_mesh(MESH_RANKS, 1)
    step = make_train_step(cfg, ocfg, par, dev, mesh=mesh)
    state = reshard_tree((fresh, init_opt_state(fresh, ocfg)),
                         step.shardings)
    grads, _ = step.grads(state[0], {k: v[rows] for k, v in
                                     batches[0].items()})
    grads = {k: step.shardings[0][k].gather(g) for k, g in grads.items()}
    if rank == 0:
        grad_err = max(float((grads[k] - g).abs().max())
                       / max(float(g.abs().max()), 1e-30)
                       for k, g in one_grads.items())
        check(grad_err <= MESH_GRAD_RTOL, ("13c gradients", grad_err))
        out["grad_rel"] = grad_err
        del one_grads
    del grads
    losses = []
    t0 = time.perf_counter()
    for b in batches:
        p, o, m = step(state[0], state[1], {k: v[rows] for k, v in
                                             b.items()})
        state = (p, o)
        losses.append(float(m["loss"]))
    out["step_ms"] = 1e3 * (time.perf_counter() - t0) / MESH_100M_STEPS
    whole = gather_tree(state, step.shardings)
    out["losses"] = losses
    if rank == 0:
        rels = [abs(a - b) / abs(b) for a, b in zip(losses, one_losses)]
        lr_err = max(float((whole[0][k] - one[0][k]).abs().max())
                     for k in one[0]) / ocfg.lr
        check(max(rels) <= MESH_LOSS_RTOL, ("13c loss", rels))
        check(lr_err <= MESH_PARAM_LR, ("13c params", lr_err))
        out.update(one_losses=one_losses, loss_rel=max(rels),
                   param_err_lr=lr_err)
    # checkpoints 2 -> 2 and 2 -> 1
    two = os.path.join(root, "two")
    if rank == 0:
        save_checkpoint(two, MESH_100M_STEPS, whole)
    sh.barrier()
    p2, o2, _, _ = elastic_restore(two, cfg, ocfg, par, devices=MESH_RANKS)
    check(mesh_state_equal(state, (p2, o2)), "13c checkpoint 2 -> 2")
    if rank == 0:
        p1, o1, _, _ = elastic_restore(two, cfg, ocfg, par, devices=1)
        check(mesh_state_equal(whole, (p1, o1)), "13c checkpoint 2 -> 1")
        del p1, o1
    del p2, o2, whole
    # 1 -> 2: rank 0's one-rank state onto both ranks
    one_dir = os.path.join(root, "one")
    if rank == 0:
        save_checkpoint(one_dir, MESH_100M_STEPS, one)
    sh.barrier()
    p3, o3, _, _ = elastic_restore(one_dir, cfg, ocfg, par,
                                   devices=MESH_RANKS)
    back = gather_tree((p3, o3), step.shardings)
    if rank == 0:
        check(mesh_state_equal(back, one), "13c checkpoint 1 -> 2")
    del p3, o3, back, state, one
    shutil.rmtree(two, ignore_errors=True)
    shutil.rmtree(one_dir, ignore_errors=True)
    # pod=2 with int8 gradient compression, one step's gradients
    pods = DeviceMesh("cuda", torch.arange(MESH_RANKS).reshape(
        MESH_RANKS, 1, 1), mesh_dim_names=("pod", "data", "model"))
    pod_par = ParallelConfig(batch_axes=("pod", "data"),
                             grad_compression="int8")
    pod_step = make_train_step(cfg, ocfg, pod_par, dev, mesh=pods)
    batch = {k: v[rows] for k, v in batches[0].items()}
    comp, _ = pod_step.grads(fresh, batch)
    own, _ = make_train_step(cfg, ocfg, par, dev).grads(fresh, batch)
    torch.save({k: v.cpu() for k, v in own.items()},
               os.path.join(root, f"own{rank}.pt"))
    sh.barrier()
    if rank == 0:
        owns = [torch.load(os.path.join(root, f"own{r}.pt"))
                for r in range(MESH_RANKS)]
        for k, g in comp.items():
            want = pod_emulation([o[k].numpy() for o in owns])
            got = g.cpu().numpy()
            check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
                  ("13c pod compression", k))
        out["pod_leaves"] = len(comp)
    sh.barrier()
    return out


def pod_emulation(grads, block=256):
    """The reference's cross-pod int8 reduction in numpy: a shared
    per-block scale (the pods' absmax MAX / 127), int8 payloads against
    it (round half to even), their int32 sum, dequantized over the
    number of pods; float32 throughout."""
    shape, n = grads[0].shape, grads[0].size
    pad = (-n) % block

    def blocks(g):
        return np.concatenate([g.reshape(-1).astype(np.float32),
                               np.zeros(pad, np.float32)]).reshape(-1, block)
    bs = [blocks(g) for g in grads]
    scale = np.maximum.reduce([np.abs(b).max(axis=1) for b in bs]) \
        / np.float32(127.0)
    safe = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
    qsum = sum(np.clip(np.round(b / safe[:, None]), -127, 127
                       ).astype(np.int8).astype(np.int32) for b in bs)
    deq = (qsum.astype(np.float32) * scale[:, None]).reshape(-1)[:n]
    return (deq.reshape(shape) / np.float32(len(grads))).astype(np.float32)


def mesh_train_1b(rank, dev):
    """13d: llama3.2-1b over data=2 as ``launch/train.py --data 2``
    builds it (int8 moments, remat full), cut to MESH_1B_LAYERS layers,
    MESH_1B_STEPS steps of 8 x 1,024 tokens (4 rows a rank): each loss
    against one rank's steps on the whole batch (rank 0, before the mesh
    runs), step ms and peak memory per rank."""
    from repro_torch.checkpoint.ckpt import reshard_tree
    from repro_torch.data.loader import TokenBatchLoader
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.models.model import param_count
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step
    args = launch_train.parse_args([
        "--arch", LLAMA, "--steps", str(MESH_1B_STEPS), "--seq-len", "1024",
        "--batch", "8", "--remat", "full", "--data", str(MESH_RANKS)])
    cfg, tcfg, ocfg, par = launch_train.configs(args)
    ocfg = dataclasses.replace(ocfg, state_dtype="int8")
    if MESH_1B_LAYERS is not None:
        cfg = dataclasses.replace(cfg, num_layers=MESH_1B_LAYERS)

    def fresh():
        params = M.init_params(cfg, seed=tcfg.seed, device=dev)
        return params, init_opt_state(params, ocfg)

    def batches(rows=None):
        loader = TokenBatchLoader(cfg.vocab_size, tcfg.seq_len,
                                  tcfg.global_batch, seed=tcfg.seed,
                                  rows=rows)
        got = [loader.next() for _ in range(MESH_1B_STEPS)]
        loader.close()
        return [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                for b in got]

    one_losses = None
    if rank == 0:
        one, state, one_losses = make_train_step(cfg, ocfg, par, dev), \
            fresh(), []
        for batch in batches():
            p, o, m = one(state[0], state[1], batch)
            one_losses.append(float(m["loss"]))
            state = (p, o)
        del one, state, p, o
    torch.cuda.empty_cache()
    sh.barrier()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, ocfg, par, dev, mesh=launch_train.mesh_of(
        args))
    state = reshard_tree(fresh(), step.shardings)
    losses, ms = [], []
    for batch in batches(sh.batch_rows(tcfg.global_batch, rank,
                                       MESH_RANKS)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(state[0], state[1], batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        state = (p, o)
    check(all(np.isfinite(losses)), ("13d", losses))
    out = {"layers": cfg.num_layers, "params": param_count(cfg),
           "losses": losses, "step_ms": ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if rank == 0:
        out["one_rank_losses"] = one_losses
        out["loss_rel"] = [abs(a - b) / abs(b)
                           for a, b in zip(losses, one_losses)]
        check(all(r <= bound for r, bound in
                  zip(out["loss_rel"], MESH_1B_LOSS_RTOL)),
              ("13d losses", losses, one_losses))
    del state, p, o
    return out


class CollectiveCount:
    """Within the block, the calls and bytes of each
    ``torch.distributed`` collective this process makes (the port calls
    them only in ``distributed/sharding.py``, through the module, so
    wrapping the module's functions sees every one, on every thread):
    {name: [calls, bytes]}, the bytes those of the tensor the rank puts
    in (gloo stages each through the host)."""
    NAMES = ("all_reduce", "all_gather", "reduce_scatter_tensor",
             "all_to_all_single")

    def __enter__(self):
        import torch.distributed as dist
        self.counts, self._orig = {}, {}

        def counted(name, fn):
            def call(*args, **kwargs):
                # all_reduce(tensor); all_gather(parts, src);
                # reduce_scatter_tensor(out, src); all_to_all_single(out,
                # src)
                t = args[0] if name == "all_reduce" else args[1]
                c = self.counts.setdefault(name, [0, 0])
                c[0] += 1
                c[1] += t.numel() * t.element_size()
                return fn(*args, **kwargs)
            return call
        for name in self.NAMES:
            self._orig[name] = getattr(dist, name)
            setattr(dist, name, counted(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self._orig.items():
            setattr(dist, name, fn)
        return False


def smoke_kind(arch, get_smoke_config, **kw):
    """(label, float32 smoke config) of an arch's smoke config with
    ``kw``, or with ``arch`` None of FALLBACK_SMOKE's."""
    if arch is not None:
        return arch, dataclasses.replace(get_smoke_config(arch),
                                         dtype="float32", **kw)
    label, arch, heads, kv_heads, d_ff = FALLBACK_SMOKE
    cfg = get_smoke_config(arch)
    return label, dataclasses.replace(
        cfg, dtype="float32", d_ff=d_ff, attention=dataclasses.replace(
            cfg.attention, num_heads=heads, num_kv_heads=kv_heads), **kw)


def smoke_train_batch(vocab, s, dev):
    """4 seeded rows of ``s`` tokens, row 0's second half masked (the
    CPU tests' batch: the ranks' mask counts could differ)."""
    rng = np.random.default_rng(SEED)
    mask = np.ones((4, s), np.float32)
    mask[0, s // 2:] = 0.0
    return {"tokens": torch.from_numpy(rng.integers(
        0, vocab, (4, s)).astype(np.int32)).to(dev),
        "loss_mask": torch.from_numpy(mask).to(dev)}


def mesh_tp_smoke(rank, dev):
    """13e-smoke: each of MESH_TP_SMOKE in float32 over (data, model) =
    (1, 2), remat "full", both ranks on the whole batch: the losses of
    MESH_TP_STEPS steps and the first gradients against one rank's
    (rank 0, on the card). The recomputation of remat runs in backward,
    on autograd's CUDA device thread, inside the forward's mesh context.
    Returns {arch: (loss error, gradient error)} on rank 0."""
    from repro_torch.checkpoint.ckpt import reshard_tree
    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = make_host_mesh(1, 2)
    out = {}
    for arch, kw, par_kw in MESH_TP_SMOKE:
        par = ParallelConfig(batch_axes=("data",), remat="full", **par_kw)
        arch, cfg = smoke_kind(arch, get_smoke_config, **kw)
        if par_kw:
            arch = f"{arch} experts over model"
        params = M.init_params(cfg, seed=SEED, device=dev)
        batch = smoke_train_batch(cfg.vocab_size,
                                  128 if cfg.moe is not None else 32, dev)
        step = make_train_step(cfg, ocfg, par, dev, mesh=mesh)
        state = reshard_tree((params, init_opt_state(params, ocfg)),
                             step.shardings)
        if par_kw:
            # a rank computes with E / 2 experts at their whole width
            m = cfg.moe
            w = step.compute_params(state[0])["stack.blk0.moe.w_gate"]
            check(tuple(w.shape[-3:]) == (m.num_experts // 2, cfg.d_model,
                                          m.d_ff),
                  ("13e-smoke", arch, tuple(w.shape)))
            del w
        grads, _ = step.grads(state[0], batch)
        grads = {k: step.shardings[0][k].gather(g) for k, g in grads.items()}
        losses = []
        for _ in range(MESH_TP_STEPS):
            p, o, m = step(state[0], state[1], batch)
            state = (p, o)
            losses.append(float(m["loss"]))
        if rank == 0:
            one = make_train_step(cfg, ocfg, par, dev)
            one_grads, _ = one.grads(params, batch)
            state, one_losses = (params, init_opt_state(params, ocfg)), []
            for _ in range(MESH_TP_STEPS):
                p, o, m = one(state[0], state[1], batch)
                state = (p, o)
                one_losses.append(float(m["loss"]))
            out[arch] = (max(abs(a - b) / abs(b)
                             for a, b in zip(losses, one_losses)),
                         max(float((grads[k] - g).abs().max())
                             / max(float(g.abs().max()), 1e-30)
                             for k, g in one_grads.items()))
        del params, state, grads
    if rank == 0:
        print("phase 13e-smoke (rank 0): "
              + ", ".join(f"{a} loss {e[0]:.3g} gradients {e[1]:.3g}"
                          for a, e in out.items()), flush=True)
        check(all(e[0] <= MESH_LOSS_RTOL and e[1] <= MESH_TP_GRAD_RTOL.get(
            a, MESH_GRAD_RTOL) for a, e in out.items()), ("13e-smoke", out))
    return out


def state_gib(tree):
    from repro_torch.checkpoint.ckpt import _items
    return sum(v.numel() * v.element_size() for _, v in _items(tree)) / 2 ** 30


def mesh_train_tp_1b(rank, dev):
    """13e: llama3.2-1b at full width over (data, model) = (1, 2) as
    ``launch/train.py --model 2`` builds it (int8 moments, remat full),
    cut to MESH_TP_1B_LAYERS layers, MESH_TP_STEPS steps of 4 x 1,024
    tokens, both ranks on the whole batch: each loss against one rank's
    steps (rank 0, before the mesh runs), step ms, peak memory, the
    parameter and moment GiB a rank holds, and the collectives a step
    stages (calls and bytes, ``CollectiveCount``)."""
    from repro_torch.checkpoint.ckpt import reshard_tree
    from repro_torch.data.loader import TokenBatchLoader
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.models.model import param_count
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step
    args = launch_train.parse_args([
        "--arch", LLAMA, "--steps", str(MESH_TP_STEPS), "--seq-len", "1024",
        "--batch", str(MESH_TP_1B_BATCH), "--remat", "full", "--data", "1",
        "--model", str(MESH_RANKS)])
    cfg, tcfg, ocfg, par = launch_train.configs(args)
    ocfg = dataclasses.replace(ocfg, state_dtype="int8")
    cfg = dataclasses.replace(cfg, num_layers=MESH_TP_1B_LAYERS)

    def fresh():
        params = M.init_params(cfg, seed=tcfg.seed, device=dev)
        return params, init_opt_state(params, ocfg)

    loader = TokenBatchLoader(cfg.vocab_size, tcfg.seq_len,
                              tcfg.global_batch, seed=tcfg.seed)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                loader.next().items()} for _ in range(MESH_TP_STEPS)]
    loader.close()
    one_losses = None
    if rank == 0:
        one, state, one_losses = make_train_step(cfg, ocfg, par, dev), \
            fresh(), []
        for batch in batches:
            p, o, m = one(state[0], state[1], batch)
            one_losses.append(float(m["loss"]))
            state = (p, o)
        del one, state, p, o
    torch.cuda.empty_cache()
    sh.barrier()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, ocfg, par, dev,
                           mesh=launch_train.mesh_of(args))
    state = reshard_tree(fresh(), step.shardings)
    param_gib, moment_gib = state_gib(state[0]), state_gib(state[1])
    losses, ms, staged = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CollectiveCount() as cc:
            p, o, m = step(state[0], state[1], batch)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        staged.append(cc.counts)
        state = (p, o)
    check(all(np.isfinite(losses)), ("13e", losses))
    check(staged[0] == staged[-1], ("13e collectives a step", staged))
    out = {"layers": cfg.num_layers, "params": param_count(cfg),
           "mesh": [1, MESH_RANKS], "losses": losses, "step_ms": ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "param_gib": param_gib, "moment_gib": moment_gib,
           "collectives": staged[0],
           "staged_gb": sum(b for _, b in staged[0].values()) / 1e9}
    if rank == 0:
        out["one_rank_losses"] = one_losses
        out["loss_rel"] = [abs(a - b) / abs(b)
                           for a, b in zip(losses, one_losses)]
        print(f"phase 13e (rank 0): losses {losses} against one rank's "
              f"{one_losses}", flush=True)
        check(all(r <= bound for r, bound in
                  zip(out["loss_rel"], MESH_TP_1B_LOSS_RTOL)),
              ("13e losses", losses, one_losses))
    del state, p, o
    return out


# ---------------------------------------------------------------------------
# Phase 14: serving over a (data, model) mesh, in phase 13's two gloo ranks
# ---------------------------------------------------------------------------

#: 14e: the CPU tests' bound on float32 serving over a mesh against one
#: device (tests/test_torch_serve_mesh.py's MESH_RTOL), here card
#: against card, max |mesh - one| / (1 + max |one|)
SERVE_MESH_F32_RTOL = 1e-5
#: 14a-14d: first-token logits of bf16 weights over a mesh against a
#: one-rank engine's in the same rank, max |mesh - one| / (1 + |one|)
#: elementwise: C9's scale (the row-parallel sums round at other places).
#: RWKV-6 grows any rounding ~2.5-3x for each doubling of its depth:
#: tools/serve_mesh_drift.py read rwkv6-7b over model=2 on an H100 at
#: 0.033 / 0.096 / 0.286 (2 / 4 / 8 layers), while one rank's own bf16
#: read 0.156 / 0.258 / 0.752 from its float32; 14c's 0.5 is below that
SERVE_MESH_BF16_TOL = {RWKV: 0.5}
SERVE_MESH_BF16_DEFAULT_TOL = 0.15
#: 14c in float32 at the same width and depth, the same measure: only
#: the float32 summation order differs, which the depth grows as it
#: grows bf16's (the drift tool: 2.4e-5 / 5.6e-5 / 1.5e-4 at 2 / 4 / 8
#: layers); a wrong shard reads O(0.1) at any depth
SERVE_MESH_F32_WIDTH_TOL = 1e-3
#: 14e's smoke kinds (GQA with RoPE, MLA, Mamba with experts, RWKV-6,
#: whisper with frames, experts with a shared expert, and FALLBACK_SMOKE
#: as ``None``) and meshes
SERVE_MESH_SMOKE = (LLAMA, MINICPM, JAMBA, RWKV, WHISPER, MOONSHOT, None)
SERVE_MESH_SHAPES = ((1, 2), (2, 1))
#: (part, arch, (data, model), layers or None, max_len, new tokens, dtype
#: or None for the config's) of 14a-14d: 4 of 9c's seeded prompts, one
#: group of 4 slots. 14a is llama3.2-1b whole at 9c's max_len; 14b-14d
#: take prompts padded to 512 (max_len 1,024) and 8 new tokens, and
#: rwkv6-7b and moonshot 8 layers, to keep phase 14 near 90 s of the
#: script's limit; "14c-f32" is 14c with float32 weights
SERVE_MESH_RUNS = (("14a", LLAMA, (1, 2), None, 4096, 16, None),
                   ("14b", JAMBA, (1, 2), 8, 1024, 8, None),
                   ("14c", RWKV, (1, 2), 8, 1024, 8, None),
                   ("14c-f32", RWKV, (1, 2), 8, 1024, 8, "float32"),
                   ("14d", MOONSHOT, (2, 1), 8, 1024, 8, None))
#: what a rank may hold while its parameters are drawn, past its shards
#: and one whole leaf (with its float32 group draw): the allocator's
#: rounding and the index of a cut
SERVE_MESH_LOAD_SLACK = 256 * 2 ** 20
#: 14f: a cache split along its sequence over model, the flash-decoding
#: layout of the reference's decode_32k dry-run cells (ROADMAP A8.3):
#: smoke GQA, MLA and whisper (its cross-attention cache of 16 encoder
#: positions split too) in float32 over (1, 2), a prefill of 4 x 64
#: tokens into a cache of 128 (one chunk a rank) and 4 decode steps;
#: smoke GQA again with a cache of SEQ_SPLIT_ODD_LEN positions, which 2
#: does not divide (the caches whole along their sequence, as the
#: reference's specs leave them, and the step as without the split); then
#: llama3.2-1b at full width (hf:meta-llama/Llama-3.2-1B) cut to 2 of 16
#: layers for the time limit, float32 weights (every greedy token held
#: to one rank's), max_len 1,024, 8 new tokens, 4 of 9c's prompts
SEQ_SPLIT_SMOKE = (LLAMA, MINICPM, WHISPER)
SEQ_SPLIT_ODD_LEN = 127
SEQ_SPLIT_RUN = ("14f", LLAMA, (1, 2), 2, 1024, 8, "float32")


def seq_split_parallel():
    from repro_torch.config import ParallelConfig
    return ParallelConfig(fsdp_axis=None, shard_cache_seq=True,
                          seq_axis="model")


def shard_bytes(part, what, held, placement, mesh_shape):
    """The bytes of ``held``'s leaves, checked against their placement:
    each leaf has its ``Sharding``'s local shape (so nothing is held
    beyond the rank's shard), and none that its spec splits over a mesh
    axis of more than one rank is held whole. Returns (bytes held, bytes
    of the placement's shards)."""
    from repro_torch.distributed import sharding as sh
    nbytes = plan = 0
    for name, w in held.items():
        p = placement[name]
        check(tuple(w.shape) == tuple(p.local_shape),
              (part, what, name, tuple(w.shape), p.local_shape))
        nbytes += w.numel() * w.element_size()
        plan += int(np.prod(p.local_shape)) * w.element_size()
        if any(sh.axis_size(mesh_shape, e) > 1 for e in p.spec):
            check(int(np.prod(p.local_shape)) < int(np.prod(p.shape)),
                  (part, what, name, "held whole", p.shape))
    return nbytes, plan


def whole_leaf_bytes(cfg):
    """The largest whole leaf in the engine's form, plus one group's
    float32 draw of it."""
    from repro_torch.models import model as M
    elem = torch.finfo(M.compute_dtype(cfg)).bits // 8
    most = 0
    for name, d in M.full_schema(cfg).items():
        n = int(np.prod(d.shape))
        size = 4 if M._is_float32_leaf(name) else elem
        group = n // d.shape[0] if d.axes[0] == "groups" else n
        most = max(most, n * size + 4 * group)
    return most


def serve_mesh_smoke(rank, dev, get_smoke_config, par=None,
                     shapes=SERVE_MESH_SHAPES, archs=SERVE_MESH_SMOKE,
                     label="14e", max_len=256, steps=3):
    """14e (and 14f's smoke part): the smoke kinds ``archs`` in float32
    over each (data, model) of ``shapes`` under ``par`` (default
    ``ParallelConfig()``), a prefill of 4 x ``max_len // 2`` tokens and
    ``steps`` decode steps through the steps on the rank's rows and
    shards, against one rank's steps on the card (rank 0): tokens equal,
    logits within SERVE_MESH_F32_RTOL. Returns ({kind: worst error},
    {kind: whether its self- and cross-attention caches were split
    along their sequence})."""
    from repro_torch.config import ParallelConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    par, b, splits = par or ParallelConfig(), 4, {}

    def run(cfg, params, batch, mesh):
        rows = np.arange(b)
        cplace = None
        if mesh is not None:
            smesh = M.serve_mesh_of(cfg, par, mesh, max_len)
            splits[arch] = (smesh.seq_self, smesh.seq_cross)
            rows = sh.batch_rows(b, smesh.batch_rank, smesh.batch_size)
            pplace, cplace = M.serve_placement(cfg, par, mesh, b, max_len)
            params = M.place_params(params, pplace)
        prefill = make_prefill_step(cfg, par, mesh, max_len)
        decode = make_decode_step(cfg, par, mesh, max_len)
        cache = M.init_cache(cfg, b, max_len, device=dev, placement=cplace)
        logits, cache = prefill(params, {k: v[rows] for k, v in
                                         batch.items()}, cache)
        got = [logits.float().cpu()]
        for _ in range(steps):
            tok = got[-1][:, -1].argmax(-1).to(torch.int32)
            logits, cache = decode(params, cache,
                                   {"token": tok[rows][:, None].to(dev)})
            got.append(logits.float().cpu())
        return got

    worst = {}
    for shape in shapes:
        mesh = make_host_mesh(*shape)
        for arch in archs:
            arch, cfg = smoke_kind(arch, get_smoke_config)
            params = M.compute_params(M.init_params(cfg, seed=SEED,
                                                    device=dev), cfg, dev)
            rng = np.random.default_rng(SEED)
            batch = {"tokens": torch.from_numpy(rng.integers(
                1, cfg.vocab_size, (b, max_len // 2)).astype(np.int32)).to(
                    dev)}
            if cfg.encdec:
                batch["frames"] = torch.from_numpy(rng.standard_normal(
                    (b, cfg.encoder_seq, cfg.d_model)).astype(
                        np.float32)).to(dev)
            arch = f"{arch} {shape[0]}x{shape[1]}"
            got = run(cfg, params, batch, mesh)
            if rank == 0:
                one = run(cfg, params, batch, None)
                for step, (a, w) in enumerate(zip(got, one)):
                    check(torch.equal(a[:, -1].argmax(-1),
                                      w[:, -1].argmax(-1)),
                          (f"{label} tokens", arch, shape, step))
                    e = float((a - w).abs().max()) / (1 + float(
                        w.abs().max()))
                    check(e <= SERVE_MESH_F32_RTOL, (f"{label} logits",
                                                     arch, shape, step, e))
                    worst[arch] = max(worst.get(arch, 0.0), e)
            del params
    return worst, splits


def serve_mesh_at_width(rank, dev, part, cfg, shape, max_len, new,
                        expect, tol, par=None, strict=False):
    """One of 14a-14d: ``cfg`` served by ``ServeEngine(mesh=)`` over a
    (data, model) = ``shape`` mesh of the two ranks, weights in the
    config's compute dtype drawn on the card a leaf at a time into each
    rank's shards (``init_params(placement=)``), 4 of 9c's seeded prompts
    and ``new`` greedy tokens; rank 0 first serves them through a
    one-rank engine. Checks the rank's bytes against its placement's
    shards, its load peak against its shards and one whole leaf, the
    launch counts against ``expect``, and (on rank 0) the first-token
    logits against the one-rank engine's within ``tol`` (with ``strict``
    every greedy token equal to its). ``par`` is the mesh's
    ``ParallelConfig`` (default ``ParallelConfig()``); the collectives
    the serve issues are counted (``sharding.tally``). Returns the
    record and (on rank 0) the one-rank engine's first-token logits."""
    from repro_torch.config import ParallelConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeEngine
    par, slots = par or ParallelConfig(), 4
    rng = np.random.default_rng(SEED)
    lens = rng.integers(1024, 2049, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in lens][:slots]
    t_part = time.perf_counter()

    def requests():
        return [Request(rid=i, prompt=p, max_new=new)
                for i, p in enumerate(prompts)]

    one = None
    if rank == 0:               # the one-rank engine, on the whole model
        eng = ServeEngine(cfg, M.init_params(cfg, seed=SEED, device=dev,
                                             compute=True),
                          slots=slots, max_len=max_len, device=dev)
        eng._prefill = LogitRecorder(eng._prefill)
        reqs = requests()
        eng.process_group(reqs)
        one = ([r.output for r in reqs], eng._prefill.logits[0])
        del eng, reqs
    torch.cuda.empty_cache()
    sh.barrier()

    mesh = make_host_mesh(*shape)
    mesh_shape = {"data": shape[0], "model": shape[1]}
    pplace, cplace = M.serve_placement(cfg, par, mesh, slots, max_len)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev, compute=True,
                           placement=pplace)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() - base
    held, plan_p = shard_bytes(part, "parameters", params, pplace,
                               mesh_shape)
    check(held == plan_p, (part, "parameter bytes", held, plan_p))
    whole = whole_leaf_bytes(cfg)
    check(load_peak <= plan_p + whole + SERVE_MESH_LOAD_SLACK,
          (part, "load peak", load_peak, plan_p, whole))
    cache = M.init_cache(cfg, slots, max_len, device=dev, placement=cplace)
    cache_bytes, plan_c = shard_bytes(part, "cache", cache, cplace,
                                      mesh_shape)
    check(cache_bytes == plan_c, (part, "cache bytes", cache_bytes, plan_c))
    del cache
    eng = ServeEngine(cfg, params, mesh=mesh, parallel=par, slots=slots,
                      max_len=max_len, device=dev)
    del params
    eng._prefill = LogitRecorder(eng._prefill)
    mods = model_kernels()
    torch.cuda.synchronize()
    sh.barrier()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    with sh.tally() as coll:
        done = eng.serve(requests())
    wall = time.perf_counter() - t0
    launches = model_launches(mods)
    peak = torch.cuda.max_memory_allocated()
    check(launches == expect, (part, launches, expect))
    outputs = [r.output for r in sorted(done, key=lambda r: r.rid)]
    check(all(len(o) == new and all(0 <= t < cfg.vocab_size for t in o)
              for o in outputs), (part, outputs))
    ttft = np.array([r.ttft_s for r in done]) * 1e3
    dec = 1e3 * np.array([s.duration for s in eng.collector.spans("decode")])
    pre = 1e3 * np.array([s.duration
                          for s in eng.collector.spans("prefill")])
    out = {"model": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "mesh": list(shape), "max_len": max_len, "new_tokens": new,
           "outputs": outputs, "param_gib": held / 2 ** 30,
           "plan_param_gib": plan_p / 2 ** 30,
           "cache_gib": cache_bytes / 2 ** 30,
           "load_peak_gib": load_peak / 2 ** 30,
           "whole_leaf_gib": whole / 2 ** 30, "init_s": init_s,
           "wall_ms": wall * 1e3,
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p95": float(np.percentile(ttft, 95)),
           "prefill_span_ms": float(pre.mean()),
           "decode_step_ms": float(dec.mean()) if len(dec) else None,
           "peak_gib": peak / 2 ** 30, "launches": launches,
           "collectives": {k: v for k, v in coll.items() if v["count"]}}
    if one is not None:
        err = first_logits_rel(eng._prefill.logits[0], one[1])
        print(f"phase {part} (rank 0): first-token logits within {err:.3g} "
              f"of one rank's (bound {tol:g})", flush=True)
        check(err <= tol, (part, "first-token logits", err))
        same = sum(x == y for o, p in zip(outputs, one[0])
                   for x, y in zip(o, p))
        out.update(first_logits_err=err, first_logits_tol=tol,
                   same_tokens=same / (len(outputs) * new),
                   first_tokens_equal=[o[0] for o in outputs]
                   == [p[0] for p in one[0]])
        if strict:
            check(outputs == one[0], (part, "greedy tokens", outputs,
                                      one[0]))
    del eng
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_part
    return out, (None if one is None else one[1])


def serve_mesh_config(arch, layers, dtype):
    """A config of 14a-14d (or the drift tool's): Jamba as 5d (one
    group, no experts), cut to ``layers`` where given, in ``dtype``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == JAMBA:
        cfg = dataclasses.replace(cfg, moe=None)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg


def serve_mesh_launches(cfg, new):
    """The model kernels' launches a rank makes serving one group of
    ``cfg`` with ``new`` new tokens: one flash launch an attention layer
    (the prefill; decode attends in PyTorch), a scan a Mamba layer and
    token, a chunked WKV launch an RWKV layer and a per-step one for each
    token after the first."""
    n_attn = cfg.num_layers * cfg.block_pattern.count("attn") // len(
        cfg.block_pattern)
    n_other = cfg.num_layers - n_attn
    f32 = cfg.dtype == "float32"
    return {"flash_attention": 0 if f32 else n_attn,
            "flash_attention_f32": n_attn if f32 else 0,
            "ssm_scan": n_other * new if cfg.name == JAMBA else 0,
            "rwkv6_chunked": n_other if cfg.name == RWKV else 0,
            "rwkv6_scan": n_other * (new - 1) if cfg.name == RWKV else 0}


def first_logits_rel(a, w):
    """max |a - w| / (1 + |w|), elementwise."""
    return float(((a - w).abs() / (1 + w.abs())).max())


def serve_mesh_rank(rank, dev):
    """Phase 14 in one of the ranks: 14e, then 14a-14d (14c also in
    float32). Returns its record and the model kernels' launches of
    14a-14d's serves."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    rec, launches, one_logits = {}, {}, {}
    t0 = time.perf_counter()
    rec["14e"], _ = serve_mesh_smoke(rank, dev, get_smoke_config)
    rec["14e_s"] = time.perf_counter() - t0
    for part, arch, shape, layers, max_len, new, dtype in SERVE_MESH_RUNS:
        cfg = serve_mesh_config(arch, layers, dtype)
        tol = (SERVE_MESH_F32_WIDTH_TOL if cfg.dtype == "float32" else
               SERVE_MESH_BF16_TOL.get(cfg.name,
                                       SERVE_MESH_BF16_DEFAULT_TOL))
        rec[part], one_logits[part] = serve_mesh_at_width(
            rank, dev, part, cfg, shape, max_len, new,
            serve_mesh_launches(cfg, new), tol)
        for k, v in rec[part]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        sh.barrier()
    if rank == 0:
        # one rank's own bf16 drift from its float32 logits, the scale
        # 14c's bf16 bound is read against
        rec["14c"]["one_bf16_vs_f32"] = first_logits_rel(
            one_logits["14c"], one_logits["14c-f32"])
    # 14f: the cache split along its sequence over model
    t1 = time.perf_counter()
    rec["14f_smoke"], splits = serve_mesh_smoke(
        rank, dev, get_smoke_config, seq_split_parallel(), ((1, 2),),
        SEQ_SPLIT_SMOKE, "14f", 128, 4)
    check(all(v == (True, k.startswith(WHISPER)) for k, v in splits.items()),
          ("14f split", splits))
    # a cache whose length the model axis does not divide: whole along
    # its sequence, the step as without the split
    rec["14f_odd"], splits = serve_mesh_smoke(
        rank, dev, get_smoke_config, seq_split_parallel(), ((1, 2),),
        (LLAMA,), "14f-odd", SEQ_SPLIT_ODD_LEN, 4)
    check(list(splits.values()) == [(False, False)], ("14f-odd", splits))
    rec["14f_smoke_s"] = time.perf_counter() - t1
    part, arch, shape, layers, max_len, new, dtype = SEQ_SPLIT_RUN
    cfg = serve_mesh_config(arch, layers, dtype)
    rec[part], _ = serve_mesh_at_width(
        rank, dev, part, cfg, shape, max_len, new,
        serve_mesh_launches(cfg, new), SERVE_MESH_F32_WIDTH_TOL,
        seq_split_parallel(), strict=True)
    sh.barrier()
    rec["s"] = time.perf_counter() - t0
    return rec, launches


def mesh_rank(rank, init_file, root, parts):
    """One of phase 13's ranks: joins the gloo group on the one card and
    runs 13a-13e (with "13" in ``parts``) and phase 14 (with "14"),
    writing its record to ``root``."""
    import torch.distributed as dist
    from repro_torch.kernels import policy_scan as pk
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=MESH_RANKS)
    try:
        mods = model_kernels() + (pk,)
        rec = {"backend": dist.get_backend(), "world": dist.get_world_size()}
        if "13" in parts:
            data = np.load(os.path.join(root, "ref.npz"))
            ref = {g: {k[len(g) + 1:]: data[k] for k in data.files
                       if k.startswith(g + ".")} for g in ("4b", "4d")}
            for mod in mods:
                mod.reset_launches()
            for part, run in (("13a", lambda: mesh_grid(ref)),
                              ("13b", mesh_restarts)):
                t0 = time.perf_counter()
                rec[part] = run()
                rec[part]["s"] = time.perf_counter() - t0
            rec["launches"] = {k: v for mod in mods
                               for k, v in mod.launches.items()}
            del ref, data
            for mod in mods:
                mod.reset_launches()
            for part, run in (("13c", lambda: mesh_train_100m(rank, dev,
                                                              root)),
                              ("13d", lambda: mesh_train_1b(rank, dev)),
                              ("13e-smoke", lambda: {
                                  "errors": mesh_tp_smoke(rank, dev)}),
                              ("13e", lambda: mesh_train_tp_1b(rank, dev))):
                t0 = time.perf_counter()
                rec[part] = run()
                rec[part]["s"] = time.perf_counter() - t0
                torch.cuda.empty_cache()
            train_launches = sum(sum(mod.launches.values()) for mod in mods)
            check(train_launches == 0, ("13c-13e launched kernels",
                                        train_launches))
        if "14" in parts:
            rec["14"], rec["launches_14"] = serve_mesh_rank(rank, dev)
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def mesh_report_13(recs):
    """Phase 13's lines from the ranks' records; returns the policy
    kernels' launches of 13a-13b summed over the ranks and its record."""
    rec = recs[0]
    check(all(recs[1][p]["losses"] == rec[p]["losses"]
              for p in ("13c", "13d", "13e")),
          "13c-13e: the ranks' losses differ")
    launches = {}
    for r in recs:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    check(launches["policy_agg"] > 0 and launches["policy_agg_fault"] > 0,
          ("13a launches", launches))
    a, b, c, d = rec["13a"], rec["13b"], rec["13c"], rec["13d"]
    for block in MESH_BLOCKS:
        x = a[f"block_{block}"]
        print(f"phase 13a: 4b's 65,536 x 8736 grid with devices=2, "
              f"scenario_block {block:,}: {x['rounds']} rounds, "
              f"{x['wall_ms']:.1f} ms wall, rows bitwise 4b's "
              f"devices=None rows")
    print(f"phase 13a: 4d's 4,096-row fault grid with devices=2 in blocks "
          f"of {MESH_4D_BLOCK:,}: {a['fault_wall_ms']:.1f} ms wall, rows "
          f"bitwise 4d's; grid.round spans with the reference's attrs")
    print(f"phase 13b: fit (8 restarts x {MESH_FIT_STEPS} steps) "
          f"{b['fit_s']:.2f} s with devices=2, {b['fit_s_unsharded']:.2f} s "
          f"without; search (4 restarts x {MESH_SEARCH_STEPS} steps at "
          f"coarsen={SEARCH_CUT_COARSEN}) {b['search_s']:.2f} s / "
          f"{b['search_s_unsharded']:.2f} s; against devices=None: "
          + ", ".join(f"{k} " + ("bitwise" if b[k]["bitwise"] else
                                 f"{b[k]['rel']:.3g} relative")
                      for k in ("fit_params", "fit_losses", "fit_history",
                                "search_params", "search_history")))
    print(f"phase 13c: {llama_100m().name} in float32 over data=2, "
          f"{MESH_100M_STEPS} steps of 8 x 128: {c['step_ms']:.1f} ms a "
          f"step (two ranks on one card, gloo through the host); loss "
          f"within {c['loss_rel']:.3g} of one rank's (bound "
          f"{MESH_LOSS_RTOL:g}), first gradients within "
          f"{c['grad_rel']:.3g} (bound {MESH_GRAD_RTOL:g}), parameters "
          f"within {c['param_err_lr']:.3g} lr (bound {MESH_PARAM_LR:g}); "
          f"checkpoints 2 -> 2, 2 -> 1 and 1 -> 2 ranks bitwise; pod=2 "
          f"int8 compression bitwise its host emulation over "
          f"{c['pod_leaves']} leaves")
    print(f"phase 13d: {LLAMA} ({d['layers']} layers, {d['params']:,} "
          f"parameters) over data=2, int8 moments, remat full, "
          f"{MESH_1B_STEPS} steps of 8 x 1,024 tokens: losses "
          f"{d['losses']} against one rank's {d['one_rank_losses']} on "
          f"the whole batch ({[f'{r:.3g}' for r in d['loss_rel']]} "
          f"relative, bounds {list(MESH_1B_LOSS_RTOL)}), step ms "
          f"{[round(x, 1) for x in d['step_ms']]}, "
          f"peak {d['peak_gib']:.2f} / {recs[1]['13d']['peak_gib']:.2f} GiB "
          f"per rank")
    es, e = rec["13e-smoke"], rec["13e"]
    print(f"phase 13e-smoke: {len(MESH_TP_SMOKE)} smoke kinds in float32 "
          f"over (data, model) (1, 2), remat full, {MESH_TP_STEPS} steps "
          f"against one rank on the whole batch: "
          + ", ".join(f"{k} loss {v[0]:.3g} gradients {v[1]:.3g}"
                      for k, v in es["errors"].items())
          + f" (bounds {MESH_LOSS_RTOL:g}, {MESH_GRAD_RTOL:g}; "
          f"{RWKV}'s gradients {MESH_TP_GRAD_RTOL[RWKV]:g}); "
          f"{es['s']:.1f} s")
    print(f"phase 13e: {LLAMA} ({e['layers']} layers, {e['params']:,} "
          f"parameters) over (data, model) (1, 2) as launch/train.py "
          f"--model 2 builds it, int8 moments, remat full, {MESH_TP_STEPS} "
          f"steps of {MESH_TP_1B_BATCH} x 1,024 tokens: losses "
          f"{e['losses']} against one rank's {e['one_rank_losses']} "
          f"({[f'{r:.3g}' for r in e['loss_rel']]} relative, bounds "
          f"{list(MESH_TP_1B_LOSS_RTOL)}), step ms "
          f"{[round(x, 1) for x in e['step_ms']]}, peak {e['peak_gib']:.2f} "
          f"/ {recs[1]['13e']['peak_gib']:.2f} GiB per rank, parameters "
          f"{e['param_gib']:.2f} GiB and moments {e['moment_gib']:.2f} GiB "
          f"a rank; staged a step: "
          + ", ".join(f"{k} {v[0]} calls {v[1] / 1e9:.3f} GB"
                      for k, v in sorted(e["collectives"].items()))
          + f" ({e['staged_gb']:.3f} GB); {e['s']:.1f} s")
    record = {"backend": rec["backend"], "world": rec["world"],
              "s": {k: rec[k]["s"] for k in ("13a", "13b", "13c", "13d",
                                             "13e-smoke", "13e")},
              "13a": a, "13b": b, "13c": c, "13d": d,
              "13d_rank1_peak_gib": recs[1]["13d"]["peak_gib"],
              "13e-smoke": es, "13e": e,
              "13e_rank1_peak_gib": recs[1]["13e"]["peak_gib"],
              "launches": launches}
    return launches, record


def mesh_report_14(recs):
    """Phase 14's lines from the ranks' records (the ranks' tokens
    equal); returns the model kernels' launches of 14a-14d summed over
    the ranks and a ``{"serve_mesh": ...}`` record."""
    rec = recs[0]["14"]
    launches = {}
    for r in recs:
        for k, v in r["launches_14"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"phase 14e: {len(SERVE_MESH_SMOKE)} smoke kinds in float32 over "
          f"(data, model) {SERVE_MESH_SHAPES}, prefill + 3 decode steps "
          f"against one rank on the card: tokens equal, logits within "
          + ", ".join(f"{k} {v:.3g}" for k, v in rec["14e"].items())
          + f" (bound {SERVE_MESH_F32_RTOL:g}); {rec['14e_s']:.1f} s")
    runs = {}
    for part, *_ in SERVE_MESH_RUNS:
        x, y = rec[part], recs[1]["14"][part]
        check(x["outputs"] == y["outputs"], (part, "the ranks' tokens"))
        print(f"phase {part}: {x['model']} ({x['layers']} layers, "
              f"{x['dtype']}) over "
              f"(data, model) {tuple(x['mesh'])}, max_len {x['max_len']}, "
              f"4 requests x {x['new_tokens']} new tokens: TTFT p50 "
              f"{x['ttft_ms_p50']:.1f} ms, p95 {x['ttft_ms_p95']:.1f} ms, "
              f"decode {x['decode_step_ms']:.2f} ms a step; first-token "
              f"logits within {x['first_logits_err']:.3g} of one rank's "
              f"(bound {x['first_logits_tol']:g}), "
              f"{x['same_tokens']:.1%} of greedy tokens equal to one "
              f"rank's; both ranks' tokens equal; parameters "
              f"{x['param_gib']:.2f} / {y['param_gib']:.2f} GiB a rank "
              f"(the plan's), cache {x['cache_gib']:.3f} GiB, load peak "
              f"{x['load_peak_gib']:.2f} GiB (shards + one whole leaf "
              f"{x['whole_leaf_gib']:.2f}), peak {x['peak_gib']:.2f} / "
              f"{y['peak_gib']:.2f} GiB; launches a rank {x['launches']}; "
              f"{x['s']:.1f} s")
        if "one_bf16_vs_f32" in x:
            print(f"phase {part}: one rank's bf16 first-token logits within "
                  f"{x['one_bf16_vs_f32']:.3g} of its float32 ones")
        runs[part] = {k: v for k, v in x.items() if k != "outputs"}
        runs[part]["rank1_peak_gib"] = y["peak_gib"]
    x, y = rec["14f"], recs[1]["14"]["14f"]
    check(x["outputs"] == y["outputs"], ("14f", "the ranks' tokens"))
    launches_14f = {}
    for r in (x, y):
        for k, v in r["launches"].items():
            launches_14f[k] = launches_14f.get(k, 0) + v
    print(f"phase 14f: the cache split along its sequence over model; "
          f"{len(SEQ_SPLIT_SMOKE)} smoke kinds in float32 over (1, 2), "
          f"prefill of 4 x 64 into 128 positions + 4 decode steps against "
          f"one rank on the card (whisper's cross-attention cache split "
          f"too): tokens equal, logits within "
          + ", ".join(f"{k} {v:.3g}" for k, v in rec["14f_smoke"].items())
          + f"; {SEQ_SPLIT_ODD_LEN} positions, which model=2 does not "
          f"divide (the caches whole along their sequence, as the "
          f"reference's specs leave them): "
          + ", ".join(f"{k} {v:.3g}" for k, v in rec["14f_odd"].items())
          + f" (bound {SERVE_MESH_F32_RTOL:g}); {rec['14f_smoke_s']:.1f} s")
    print(f"phase 14f: {x['model']} ({x['layers']} layers, {x['dtype']}) "
          f"over (data, model) {tuple(x['mesh'])}, its cache's sequence "
          f"over model, max_len {x['max_len']}, 4 requests x "
          f"{x['new_tokens']} new tokens: TTFT p50 {x['ttft_ms_p50']:.1f} "
          f"ms, p95 {x['ttft_ms_p95']:.1f} ms, decode "
          f"{x['decode_step_ms']:.2f} ms a step; first-token logits within "
          f"{x['first_logits_err']:.3g} of one rank's (bound "
          f"{x['first_logits_tol']:g}), every greedy token one rank's; "
          f"cache {x['cache_gib']:.3f} GiB a rank; launches a rank "
          f"{x['launches']}; staged by the serve: "
          + ", ".join(f"{k} {v['count']} calls {v['bytes'] / 1e6:.2f} MB"
                      for k, v in sorted(x["collectives"].items()))
          + f"; {x['s']:.1f} s")
    runs["14f"] = {k: v for k, v in x.items() if k != "outputs"}
    runs["14f"]["rank1_peak_gib"] = y["peak_gib"]
    record = {"runs": runs, "smoke_f32_err": rec["14e"],
              "seq_split_smoke_err": rec["14f_smoke"],
              "seq_split_odd_err": rec["14f_odd"],
              "bounds": {"smoke_f32_rtol": SERVE_MESH_F32_RTOL,
                         "first_logits": {
                             p: rec[p]["first_logits_tol"]
                             for p, *_ in SERVE_MESH_RUNS + (
                                 SEQ_SPLIT_RUN,)}},
              "launches": launches, "launches_14f": launches_14f,
              "s": rec["s"]}
    print(json.dumps({"serve_mesh": record}))
    return launches, record


def mesh_on_card(rows_4b=None, rows_4d=None, parts=("13", "14"),
                 beside=None):
    """Phases 13 and 14: the multi-GPU layer, two gloo ranks started once
    on the one card (NCCL will not put two ranks on one GPU; gloo stages
    the card's tensors through host memory), for 13a-13e and 14a-14e
    (see those). It checks correctness and measures no scaling: the
    ranks share the card. ``beside`` (no arguments) runs in this process
    while the ranks run, and its result is returned beside theirs.
    Returns the launches of 13a-13b (the policy kernels, summed over the
    ranks), of 14a-14d (the model kernels), the phases' records
    (``{"mesh": ...}`` and ``{"serve_mesh": ...}`` lines) and
    ``beside``'s result."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="plantd_mesh_")
    beside_out = None
    try:
        if "13" in parts:
            np.savez(os.path.join(root, "ref.npz"),
                     **{f"4b.{k}": v for k, v in rows_4b.items()},
                     **{f"4d.{k}": v for k, v in rows_4d.items()})
        torch.cuda.empty_cache()
        ctx = mp.start_processes(mesh_rank, args=(os.path.join(root, "init"),
                                                  root, parts),
                                 nprocs=MESH_RANKS, start_method="spawn",
                                 join=False)
        try:
            if beside is not None:
                beside_out = beside()
            while not ctx.join():
                pass
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join()
        recs = []
        for r in range(MESH_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches_13 = launches_14 = record_13 = record_14 = None
    if "13" in parts:
        launches_13, record_13 = mesh_report_13(recs)
        print(f"phase 13: {sum(record_13['s'].values()):.1f} s")
        print(json.dumps({"mesh": record_13}))
    if "14" in parts:
        launches_14, record_14 = mesh_report_14(recs)
        print(f"phase 14: {record_14['s']:.1f} s")
    print(f"phases {' and '.join(parts)} (the ranks' start included): "
          f"{time.perf_counter() - t0:.1f} s")
    return launches_13, launches_14, record_13, record_14, beside_out


# ---------------------------------------------------------------------------
# Phase 14g: whisper-small over model=8, the fall-back (ROADMAP C19)
# ---------------------------------------------------------------------------

#: 14g: whisper-small whole (hf:openai/whisper-small: 12 encoder and 12
#: decoder layers at every published width) in float32 over (data,
#: model) = (1, 8), in a world of 8 gloo ranks on the one card. 12 heads
#: over 8 fall back: a rank projects 1.5 heads' columns of each wq / wk /
#: wv (the encoder's, the decoder's and cross-attention's) and gathers
#: them whole, runs attention over every head, and takes its 96 rows of
#: wo; the MLPs split (384 of 3,072 columns a rank), the 51,865-token
#: vocabulary stays whole. 10g's seeded frames and prompts (4 rows of
#: 1,500 frames, prompts of 64-224 tokens padded to 224), 8 new tokens
#: (the prefill's and 7 decode steps), through ``model.prefill`` /
#: ``decode_step`` (``serve.steps``), against one rank's run of the same
#: parameters in rank 0: every greedy token equal, the first-token logits
#: within SERVE_MESH_F32_RTOL (14e's measure)
WHISPER_MESH_RANKS = 8
WHISPER_MESH_NEW = 8
WHISPER_MESH_MAX_LEN = 256


def whisper_mesh_serve(rank, dev):
    """14g in one of the ranks (see WHISPER_MESH_RANKS): one rank's run
    in rank 0, then the mesh's. Returns the rank's record."""
    import warnings
    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    t_part = time.perf_counter()
    cfg = dataclasses.replace(get_config(WHISPER), dtype="float32")
    par, rows = ParallelConfig(), WHISPER_ROWS
    rng = np.random.default_rng(SEED)
    lens = rng.integers(WHISPER_MIN_PROMPT, WHISPER_PREFILL + 1, rows)
    toks = np.zeros((rows, WHISPER_PREFILL), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    tok_t = torch.from_numpy(toks).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    frames = torch.randn(rows, cfg.encoder_seq, cfg.d_model, generator=g,
                         device=dev)
    # load the flash library and cuBLAS before anything is timed
    x = torch.zeros(1, 16, 1, 64, device=dev)
    ops.sdpa(x, x, x, causal=True)
    torch.mm(x[0, :, 0], x[0, :, 0].t())

    def serve(params, mesh, cplace):
        prefill = make_prefill_step(cfg, par, mesh)
        decode = make_decode_step(cfg, par, mesh)
        cache = M.init_cache(cfg, rows, WHISPER_MESH_MAX_LEN, device=dev,
                             placement=cplace)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tok_t, "frames": frames},
                                cache)
        first = logits[:, -1].float()
        out = [first.argmax(-1).to(torch.int32)]
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        dec = []
        for _ in range(WHISPER_MESH_NEW - 1):
            t1 = time.perf_counter()
            logits, cache = decode(params, cache, {"token": out[-1][:, None]})
            check(bool(torch.isfinite(logits).all()), ("14g", "logits"))
            out.append(logits[:, -1].argmax(-1).to(torch.int32))
            torch.cuda.synchronize()
            dec.append(time.perf_counter() - t1)
        return first.cpu(), torch.stack(out, 1).cpu(), ttft, dec

    one = None
    if rank == 0:
        one = serve(M.init_params(cfg, seed=SEED, device=dev), None, None)
        torch.cuda.empty_cache()
    sh.barrier()
    mesh = make_host_mesh(1, WHISPER_MESH_RANKS)
    mesh_shape = {"data": 1, "model": WHISPER_MESH_RANKS}
    sh._REPLICATION_WARNED.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pplace, cplace = M.serve_placement(cfg, par, mesh, rows,
                                           WHISPER_MESH_MAX_LEN)
        params = M.init_params(cfg, seed=SEED, device=dev, placement=pplace)
        held, plan = shard_bytes("14g", "parameters", params, pplace,
                                 mesh_shape)
        check(held == plan, ("14g parameter bytes", held, plan))
        mods = model_kernels()
        for mod in mods:
            mod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        sh.barrier()
        with sh.tally() as coll:
            first, tokens, ttft, dec = serve(params, mesh, cplace)
    launches = model_launches(mods)
    expect = {"flash_attention": 0, "flash_attention_f32":
              cfg.encoder_layers + 2 * cfg.num_layers, "ssm_scan": 0,
              "rwkv6_chunked": 0, "rwkv6_scan": 0}
    check(launches == expect, ("14g launches", launches, expect))
    warned = [str(m.message) for m in caught
              if issubclass(m.category, RuntimeWarning)]
    check(any(f"'heads_act'): dim {cfg.attention.num_heads} " in m
              and f"'model' (size {WHISPER_MESH_RANKS})" in m
              for m in warned), ("14g fall-back warning", warned))
    rec = {"model": cfg.name, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "dtype": cfg.dtype,
           "heads": cfg.attention.num_heads, "frames": cfg.encoder_seq,
           "mesh": [1, WHISPER_MESH_RANKS], "rows": rows,
           "prefill_len": WHISPER_PREFILL, "new_tokens": WHISPER_MESH_NEW,
           "tokens": tokens.tolist(), "ttft_ms": ttft * 1e3,
           "decode_step_ms": 1e3 * float(np.mean(dec)),
           "param_gib": held / 2 ** 30,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches,
           "collectives": {k: v for k, v in coll.items() if v["count"]},
           "warnings": sorted(set(m.split(":")[0] for m in warned))}
    if one is not None:
        one_first, one_tokens, one_ttft, one_dec = one
        err = float((first - one_first).abs().max()) / (
            1 + float(one_first.abs().max()))
        rec.update(first_logits_err=err, one_tokens=one_tokens.tolist(),
                   one_ttft_ms=one_ttft * 1e3,
                   one_decode_step_ms=1e3 * float(np.mean(one_dec)))
        print(f"phase 14g (rank 0): first-token logits within {err:.3g} of "
              f"one rank's (bound {SERVE_MESH_F32_RTOL:g})", flush=True)
        check(err <= SERVE_MESH_F32_RTOL, ("14g first-token logits", err))
        check(torch.equal(tokens, one_tokens),
              ("14g greedy tokens", tokens.tolist(), one_tokens.tolist()))
    rec["s"] = time.perf_counter() - t_part
    return rec


def whisper_mesh_rank(rank, init_file, root):
    """One of 14g's ranks: joins the gloo group of WHISPER_MESH_RANKS on
    the one card, runs ``whisper_mesh_serve`` and writes its record."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WHISPER_MESH_RANKS)
    try:
        rec = whisper_mesh_serve(rank, dev)
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def whisper_mesh_start():
    """Starts 14g's ranks (see WHISPER_MESH_RANKS) in the background:
    returns (their processes, their records' folder, the start time)."""
    import torch.multiprocessing as mp
    root = tempfile.mkdtemp(prefix="plantd_14g_")
    ctx = mp.start_processes(whisper_mesh_rank,
                             args=(os.path.join(root, "init"), root),
                             nprocs=WHISPER_MESH_RANKS, start_method="spawn",
                             join=False)
    return ctx, root, time.perf_counter()


def whisper_mesh_finish(started):
    """Phase 14g's end: waits for the ranks, checks that every rank's
    tokens are rank 0's, prints its lines and a ``{"serve_mesh_14g":
    ...}`` record. Returns the model kernels' launches summed over the
    ranks and the record."""
    ctx, root, t0 = started
    try:
        try:
            while not ctx.join():
                pass
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join()
        recs = []
        for r in range(WHISPER_MESH_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    x = recs[0]
    check(all(r["tokens"] == x["tokens"] for r in recs),
          "14g: the ranks' tokens differ")
    launches = {}
    for r in recs:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"phase 14g: {x['model']} whole ({x['encoder_layers']} + "
          f"{x['layers']} layers, {x['dtype']}) over (data, model) "
          f"{tuple(x['mesh'])}, {WHISPER_MESH_RANKS} gloo ranks on the one "
          f"card, {x['heads']} heads falling back (C19: "
          f"{', '.join(x['warnings'])}); {x['rows']} rows of "
          f"{x['frames']:,} frames, prompts padded to "
          f"{x['prefill_len']}, {x['new_tokens']} new tokens: TTFT "
          f"{x['ttft_ms']:.1f} ms (one rank {x['one_ttft_ms']:.1f}), decode "
          f"{x['decode_step_ms']:.2f} ms a step (one rank "
          f"{x['one_decode_step_ms']:.2f}); first-token logits within "
          f"{x['first_logits_err']:.3g} of one rank's (bound "
          f"{SERVE_MESH_F32_RTOL:g}), every greedy token one rank's, every "
          f"rank's tokens equal; parameters {x['param_gib']:.3f} GiB a rank "
          f"(the plan's), peak {max(r['peak_gib'] for r in recs):.2f} GiB; "
          f"launches a rank {x['launches']}; staged by a rank's serve: "
          + ", ".join(f"{k} {v['count']} calls {v['bytes'] / 1e6:.2f} MB"
                      for k, v in sorted(x["collectives"].items()))
          + f"; {x['s']:.1f} s in the ranks")
    record = {k: v for k, v in x.items() if k not in ("tokens",
                                                      "one_tokens")}
    record.update(launches=launches, bound=SERVE_MESH_F32_RTOL,
                  s=time.perf_counter() - t0)
    print(f"phase 14g (the ranks' start included): {record['s']:.1f} s "
          f"from its start")
    print(json.dumps({"serve_mesh_14g": record}))
    return launches, record


def policy_jobs(faults, sweep_twins, growths16, growths256, growths4, dev):
    """The policy kernels' rows of the kernels line at the what-if main
    path's widths: (name, replaces, shape, operands, aggregate)."""
    return [
        ("policy_agg", "src/repro/kernels/policy_scan.py:190",
         "65,536 x 8736", grid_operands(sweep_twins, growths256, dev), True),
        ("policy_scan", "src/repro/kernels/policy_scan.py:104",
         "4,096 x 8736", grid_operands(sweep_twins, growths16, dev), False),
        ("policy_agg_fault", "src/repro/kernels/policy_scan.py:234",
         "65,536 x 8736 (F=16)",
         chaos_operands(sweep_twins, growths16, chaos_schedule(faults, 16),
                        dev), True),
        ("policy_scan_fault", "src/repro/core/simulate.py:375 (XLA)",
         "4,096 x 8736 (F=4)",
         chaos_operands(sweep_twins, growths4, chaos_schedule(faults, 4),
                        dev), False)]


def policy_plains(jobs):
    """Each of ``jobs``' plain versions once on its operands, run while
    phases 13-14's and 14g's ranks work (the plain versions step their
    8,736 bins from the host; this process has nothing else to do then),
    with phase 15's dry runs as well where they still go: {name: (ms,
    result)}. Their times share the card and the host with them."""
    t0 = time.perf_counter()
    out = {name: policy_plain(ops, agg) for name, _, _, ops, agg in jobs}
    print(f"the policy kernels' plain versions, beside phases 13-14's "
          f"and 14g's ranks: {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v[0]:.1f} ms" for k, v in out.items()) + ")",
          flush=True)
    return out


def policy_rows(jobs, plains):
    """The kernels line's policy rows: each kernel timed alone, held
    bitwise against its plain version's result from ``plains``."""
    rows = []
    for name, replaces, shape, ops, agg in jobs:
        stats = kernel_vs_plain(name, shape, ops, agg, plains.pop(name))
        rows.append((name, "policy_scan", replaces,
                     dict(stats, library_ms=None,
                          plain_timed="beside phases 13-14's and 14g's "
                                      "ranks and phase 15's dry runs")))
    return rows


#: phase 15: the dry run's cells (every mode), the reference's decode
#: layouts on the (16, 16) fake world: llama3.2-1b decode_32k (the cache
#: over model) and jamba-1.5-large long_500k (over (data, model), the
#: experts over data)
DRYRUN_CELLS = ((LLAMA, "decode_32k"), (JAMBA, "long_500k"))
#: the background dry runs still going, stopped at exit
_DRYRUN_PROCS = []


def _stop_dryruns():
    for p in _DRYRUN_PROCS:
        if p.poll() is None:
            p.kill()
            p.wait()


def dryrun_start():
    """Phase 15, started in the background beside the card's phases:
    ``python -m repro_torch.launch.dryrun`` (CPU only, no card visible)
    for each of DRYRUN_CELLS in a process of its own. Returns (the
    processes, the records' folder, the start time)."""
    import atexit
    root = tempfile.mkdtemp(prefix="plantd_dryrun_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    if not _DRYRUN_PROCS:
        atexit.register(_stop_dryruns)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", root], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape in DRYRUN_CELLS]
    _DRYRUN_PROCS.extend(procs)
    return procs, root, time.perf_counter()


def dryrun_finish(started):
    """Phase 15's end: each dry run exits 0 with every mode ``ok`` (a
    torch without the private fake process group or ``FlopCounterMode``
    fails here, loudly), and its roofline row with the H100's constants
    (``launch.roofline.analyze_cell``; analytic and fake-world numbers,
    not measured on the card). Returns a ``{"dryrun": ...}`` record."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R
    procs, root, t0 = started
    try:
        cells = {}
        for (arch, shape), p in zip(DRYRUN_CELLS, procs):
            log = p.communicate(timeout=900)[0]
            check(p.returncode == 0, ("phase 15 dry run", arch, shape,
                                      p.returncode, log[-3000:]))
            recs = {}
            for mode in D.MODES:
                with open(D.cell_path(root, arch, shape, "single",
                                      mode)) as f:
                    recs[mode] = json.load(f)
                check(recs[mode]["status"] == "ok",
                      ("phase 15", arch, shape, mode,
                       recs[mode].get("error"), log[-3000:]))
            memfit = recs["memfit"]
            check(memfit["direct"]["flops"] > 0, ("phase 15 flops", arch))
            c = R.analyze_cell(root, arch, shape)
            check(c.status == "ok", ("phase 15 roofline", arch, c.status))
            cells[f"{arch}/{shape}"] = {
                "bound": c.bound, "compute_ms": c.compute_s * 1e3,
                "memory_ms": c.memory_s * 1e3,
                "collective_ms": c.collective_s * 1e3,
                "roofline_frac": c.roofline_fraction,
                "useful_ratio": c.useful_ratio, "mem_gb": c.mem_gb_dev,
                "fits_80gb": c.fits_hbm,
                "flops_direct": memfit["direct"]["flops"],
                "flops_extrapolated": memfit["extrapolated"]["flops"],
                "argument_bytes": memfit["memory"]["argument_size_in_bytes"],
                "collectives": {k: v for k, v in
                                recs["probe1_exact"]["collectives"].items()
                                if v["count"]},
                "run_s": sum(r["lower_s"] + r["compile_s"]
                             for r in recs.values())}
            x = cells[f"{arch}/{shape}"]
            print(f"phase 15: dry run of {arch} {shape} on a fake world of "
                  f"256 ranks, every mode ok ({x['run_s']:.1f} s of fake "
                  f"steps): {x['argument_bytes'] / 1e9:.3f} GB of arguments "
                  f"a rank, memfit {x['flops_direct']:.4g} flops counted "
                  f"directly, {x['flops_extrapolated']:.4g} by the probes; "
                  f"roofline (H100 constants, analytic): {c.bound}-bound, "
                  f"compute {x['compute_ms']:.4g} ms, memory "
                  f"{x['memory_ms']:.4g} ms, collective "
                  f"{x['collective_ms']:.4g} ms, {x['mem_gb']:.2f} GB a "
                  f"rank, fits 80 GB: {c.fits_hbm}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record = {"torch": torch.__version__, "cells": cells,
              "s": time.perf_counter() - t0}
    print(f"phase 15: {record['s']:.1f} s from its start (in the "
          f"background of the card's phases)")
    print(json.dumps({"dryrun": record}))
    return record


def ptxas_spills(log):
    """{kernel: (registers, spill stores, spill loads)} of an nvcc -Xptxas
    -v log: each "Compiling entry function" line's kernel, then its
    "spill" and "registers" lines."""
    import re
    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
        elif name is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        elif name is not None and "registers" in line:
            out[name][0] = int(re.search(r"Used (\d+) registers",
                                         line).group(1))
    return {k: tuple(v) for k, v in out.items()}


def ptxas_generated(build, header, phase="1b", what="phase 11's"):
    """Phase 1b and 11d (C15): the policy kernels built with generated
    steps (int32 and int64 values; 11d's 47 branches) spill no more than
    the plain library's: ptxas' registers and spills of each, side by
    side."""
    plain = ptxas_spills(build.library_path("policy_scan")
                         .with_suffix(".log"))
    gen = ptxas_spills(build.library_path("policy_scan", header)
                       .with_suffix(".log"))
    check(set(plain) == set(gen) and plain, (sorted(plain), sorted(gen)))
    for name in sorted(gen):
        check(gen[name][1] <= plain[name][1], ("spills", name, gen[name],
                                               plain[name]))
    print(f"phase {phase}: ptxas policy_scan, plain -> with {what} "
          "generated "
          "steps (registers, spill stores, spill loads): " + ", ".join(
              f"{name.split('policy_')[-1][:40]} {plain[name]} -> "
              f"{gen[name]}" for name in sorted(gen)))


def sass_functions(sass):
    """{kernel name: its lines} of ``cuobjdump -sass`` output."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def sass_flash(tool, build):
    """Phase 1b's flash part: every bf16 instantiation
    (``flash_wgmma_kernel<DQ, DV>`` over the q/k and v storage dims, 36
    of them) holds wgmma (HGMMA) and TMA loads (UTMALDG); the ones of
    d = 256 (a storage dim past 128, which takes the 64-key tile; dv's
    256 holds 128 accumulator registers a thread) touch no local memory
    (LDL / STL: no spills). Every float32 one (``flash_f32_kernel<DV>``,
    one per storage dim of dv, 6) holds mma.sync (HMMA)
    and cp.async (LDGSTS); the one of dv 256 touches no local memory.
    Past 256: every bf16 wide kernel (``flash_wide_wgmma_kernel<DVH>``,
    DVH 64, 128, 192, 256) holds HGMMA and UTMALDG, every float32 one
    (``flash_wide_f32_kernel<NVH>``, NVH 4, 8, 16, 32) HMMA, and none of
    the 8 touches local memory."""
    import re
    sass = subprocess.run([tool, "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    local = re.compile(r"\b(LDL|STL)\b")
    found, found_f32, found_wide = {}, {}, {}
    for fn, lines in sass_functions(sass).items():
        m = re.search(r"flash_wgmma_kernelILi(\d+)ELi(\d+)E", fn)
        m32 = re.search(r"flash_f32_kernelILi(\d+)E", fn)
        mw = re.search(r"flash_wide_(wgmma|f32)_kernelILi(\d+)E", fn)
        if mw is not None:
            kind = "bf16" if mw.group(1) == "wgmma" else "f32"
            ops = ("HGMMA", "UTMALDG") if kind == "bf16" else ("HMMA",)
            counts = [sum(op in line for line in lines) for op in ops]
            counts.append(sum(bool(local.search(line)) for line in lines))
            check(all(counts[:-1]) and counts[-1] == 0,
                  ("wide", kind, mw.group(2), ops, counts))
            found_wide[(kind, int(mw.group(2)))] = counts
            continue
        if m32 is not None:
            dv = int(m32.group(1))
            counts = [sum("HMMA" in line for line in lines),
                      sum("LDGSTS" in line for line in lines),
                      sum(bool(local.search(line)) for line in lines)]
            check(counts[0] and counts[1], ("float32", dv, counts))
            if dv == 256:
                check(counts[2] == 0, ("local memory", "float32", dv,
                                       counts))
            found_f32[dv] = counts
            continue
        if m is None:
            continue
        dq, dv = int(m.group(1)), int(m.group(2))
        counts = [sum("HGMMA" in line for line in lines),
                  sum("UTMALDG" in line for line in lines),
                  sum(bool(local.search(line)) for line in lines)]
        check(counts[0] and counts[1], (dq, dv, counts))
        if max(dq, dv) > 128:
            check(counts[2] == 0, ("local memory", dq, dv, counts))
        found[(dq, dv)] = counts
    check(len(found) == 36, sorted(found))
    check(sorted(found_f32) == [16, 32, 64, 128, 192, 256],
          sorted(found_f32))
    check(sorted(found_wide) == [("bf16", d) for d in (64, 128, 192, 256)]
          + [("f32", n) for n in (4, 8, 16, 32)], sorted(found_wide))
    print("phase 1b: cuobjdump -sass flash_attention: bf16 kernels "
          "<dqk storage, dv storage>: HGMMA / UTMALDG / LDL+STL "
          "instructions " + ", ".join(
              f"<{dq}, {dv}> {c[0]}/{c[1]}/{c[2]}"
              for (dq, dv), c in sorted(found.items())))
    print("phase 1b: cuobjdump -sass flash_attention: float32 kernels "
          "<dv storage>: HMMA / LDGSTS / LDL+STL instructions " + ", ".join(
              f"<{dv}> {c[0]}/{c[1]}/{c[2]}"
              for dv, c in sorted(found_f32.items())))
    print("phase 1b: cuobjdump -sass flash_attention: past 256, "
          "flash_wide_wgmma_kernel<DVH>: HGMMA / UTMALDG / LDL+STL "
          + ", ".join(f"<{d}> {'/'.join(map(str, c))}"
                      for (k, d), c in sorted(found_wide.items())
                      if k == "bf16")
          + "; flash_wide_f32_kernel<NVH>: HMMA / LDL+STL "
          + ", ".join(f"<{d}> {'/'.join(map(str, c))}"
                      for (k, d), c in sorted(found_wide.items())
                      if k == "f32"))


def sass_check(build):
    """Phase 1b: the built libraries' machine code holds the instructions
    the redesigned kernels are built on: wgmma (HGMMA) and TMA loads
    (UTMALDG) in each bf16 flash kernel, and no local memory in those of
    d = 256, mma.sync (HMMA) and cp.async (LDGSTS) in each float32 one,
    and no local memory at dv 256 (``sass_flash``), mma.sync and cp.async
    in rwkv6, the special-function unit's exp2 (MUFU.EX2) and cp.async in
    ssm_scan, and cp.async in both series kernels of policy_scan, which
    have no float32 division check (FCHK, the branch to the IEEE
    division's slow path): they divide through float64 reciprocals."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass_flash(tool, build)
    for name, want in (("rwkv6", ("HMMA", "LDGSTS")),
                       ("ssm_scan", ("MUFU.EX2", "LDGSTS")),
                       ("policy_scan", ("LDGSTS", "FCHK"))):
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        if name == "policy_scan":
            series = [lines for fn, lines in sass_functions(sass).items()
                      if "policy_scan_kernel" in fn]
            check(len(series) == 2, ("series kernels", len(series)))
            counts = {op: [sum(op in line for line in lines)
                           for lines in series] for op in want}
            check(all(counts["LDGSTS"]) and not any(counts["FCHK"]),
                  (name, counts))
            print("phase 1b: cuobjdump -sass policy_scan: series kernels "
                  f"(benign, fault): LDGSTS {counts['LDGSTS']}, FCHK "
                  f"{counts['FCHK']}")
            continue
        counts = {op: sum(op in line for line in sass.splitlines())
                  for op in want}
        check(all(counts.values()), (name, counts))
        print(f"phase 1b: cuobjdump -sass {name}: "
              + ", ".join(f"{n} {op} instructions" for op, n in counts.items()))


_T0 = time.perf_counter()


def elapsed(what):
    """The script's wall time so far, printed after ``what``: where a
    slow host's seconds go."""
    print(f"[{time.perf_counter() - _T0:.1f} s] {what}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--search-cpu"]:
        return search_cpu(sys.argv[2])
    from repro_torch.core import slo as slo_mod
    from repro_torch.core import traffic as tr
    from repro_torch.core import twin as twin_mod
    from repro_torch import faults
    from repro_torch.core import whatif
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.kernels import policy_scan as pk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # phase 11's registry gets a library of its own (its steps in a
    # generated header), built beside the four sources
    header_11 = phase11_header(twin_mod)
    build_s = build.build(variants=[("policy_scan", header_11),
                                    ("policy_scan",
                                     softlat_header(twin_mod))])
    print(f"phase 1: nvcc build of {len(build.SOURCES)} sources and "
          f"policy_scan with phase 11's and 11c's generated steps in "
          f"parallel, {build_s:.2f} s")
    for name in build.SOURCES:
        print(f"  {name}: {' '.join(build.FLAGS[name])}")
        log = build.library_path(name).with_suffix(".log")
        if not log.exists():        # built by an earlier run
            continue
        for line in log.read_text().splitlines():
            if "registers" in line or "entry function" in line:
                print("  ptxas:", line.strip())
    ptxas_generated(build, header_11)
    sass_check(build)
    dev = torch.device("cuda", 0)
    # float32 matrix products in full float32 on the card (5c compares
    # them with the CPU's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if sys.argv[1:] == ["--phase", "13"]:
        # the multi-GPU layer alone, 4b's and 4d's rows first, the policy
        # kernels' plain versions and phase 15 beside the ranks
        sweep_twins, growths16, growths256, rows_4b = at_width(
            whatif, tr, twin_mod, slo_mod)
        growths4, rows_4d = chaos_at_width(whatif, tr, slo_mod, faults,
                                           sweep_twins, growths16)
        dryrun = dryrun_start()
        torch.cuda.empty_cache()
        whisper = whisper_mesh_start()
        jobs = policy_jobs(faults, sweep_twins, growths16, growths256,
                           growths4, dev)
        *_, plains = mesh_on_card(rows_array(rows_4b), rows_array(rows_4d),
                                  beside=lambda: policy_plains(jobs))
        whisper_mesh_finish(whisper)
        dryrun_finish(dryrun)
        policy_rows(jobs, plains)
        flash_vs_plain(dev, "14a")
        flash_vs_plain(dev, "14f", torch.float32)
        flash_vs_plain(dev, "14g", torch.float32)
        print(card)
        return 0
    if sys.argv[1:] == ["--phase", "14"]:
        # serving over a mesh alone (for iterating on it)
        mesh_on_card(parts=("14",))
        flash_vs_plain(dev, "14a")
        flash_vs_plain(dev, "14f", torch.float32)
        print(card)
        return 0
    if sys.argv[1:] == ["--phase", "14g"]:
        # whisper-small over model=8, the fall-back, alone
        whisper_mesh_finish(whisper_mesh_start())
        flash_vs_plain(dev, "14g", torch.float32)
        print(card)
        return 0
    if sys.argv[1:] == ["--phase", "15"]:
        # the dry run and its roofline alone
        dryrun_finish(dryrun_start())
        print(card)
        return 0
    if sys.argv[1:] == ["--phase", "12"]:
        # the training side alone (for iterating on it)
        training_on_card(dev, get_smoke_config)
        print(card)
        return 0
    if sys.argv[1:] == ["--phase", "11"]:
        # registered policies and the padded flash head dims alone
        registered_policies_on_card(
            dev, whatif, tr, twin_mod, slo_mod, faults,
            ops_build_start(build, ops_header(twin_mod)),
            first_form_build_start(build))
        print(card)
        return 0
    if sys.argv[1:] == ["--phase", "10"]:
        # the MLA / encoder-decoder / vision slice alone (for iterating)
        serve_mla_encdec(dev, get_config, get_smoke_config)
        print(card)
        return 0
    if sys.argv[1:] == ["--phase", "9"]:
        # the RoPE and MoE serving slice alone (for iterating on it)
        serve_rope_moe(dev, get_config, get_smoke_config)
        print(card)
        return 0
    if sys.argv[1:] == ["--phase", "8"]:
        # the search slice alone (for iterating on it)
        search_on_card(dev, whatif, tr, twin_mod, slo_mod, faults)
        print(card)
        return 0
    if sys.argv[1:] == ["--phase", "7"]:
        # the calibration slice alone (for iterating on it): 6a's
        # experiment stands in for 6b's, which needs the 30 GB engine
        res = telemetry_experiment("7")
        calibration_on_card(dev, whatif, tr, twin_mod, slo_mod, res,
                            twin_mod.fit_twin(res, "fifo"))
        print(card)
        return 0

    # 11d's library builds on a thread of its own beside phases 2-10, the
    # wide kernels' first form in a process of its own
    ops_build = ops_build_start(build, ops_header(twin_mod))
    first_build = first_form_build_start(build)
    elapsed("phase 1")
    check_random_blocks(dev)
    check_table2_kernels(dev, tr, twin_mod)
    check_fault_random_blocks(dev)
    check_flash_random_blocks(dev)
    check_ssm_random_blocks(dev)
    check_smoke_slice(dev, "5c", dataclasses.replace(
        get_smoke_config(JAMBA), moe=None, num_layers=16, dtype="float32"),
        "Jamba smoke without experts (16 layers, 2 groups, float32)")
    check_wkv_random_blocks(dev)
    check_smoke_slice(dev, "5f", dataclasses.replace(
        get_smoke_config(RWKV), num_layers=4, dtype="float32"),
        "rwkv6 smoke (4 layers, float32)")

    # the what-if main path: every count from 0, read right after
    mods = model_kernels()
    for mod in (pk,) + mods:
        mod.reset_launches()
    main_path_table2(whatif, tr, twin_mod, slo_mod)
    main_path_whatif7(whatif, tr, twin_mod, slo_mod, faults)
    sweep_twins, growths16, growths256, rows_4b = at_width(
        whatif, tr, twin_mod, slo_mod)
    growths4, rows_4d = chaos_at_width(whatif, tr, slo_mod, faults,
                                       sweep_twins, growths16)
    launches = dict(pk.launches)
    check(all(v > 0 for v in launches.values()), launches)
    check(sum(sum(mod.launches.values()) for mod in mods) == 0,
          "a model kernel ran on the what-if path")
    elapsed("phases 2-4")

    # the serving main paths (counts reset and read inside): Jamba's
    # attention layer once per group's prefill (bf16: the wgmma kernel)
    # and 7 Mamba layers x (1 prefill + 31 decode steps) x 2 groups;
    # rwkv6's 32 layers x 2 groups' prefill through the chunked WKV
    # kernel and x 31 decode steps x 2 groups through the per-step one
    for phase, cfg, label, expect in (
            ("5d", dataclasses.replace(get_config(JAMBA), num_layers=8,
                                       moe=None),
             "cut to 8 layers without experts",
             {"flash_attention": 2, "flash_attention_f32": 0,
              "ssm_scan": 2 * 7 * 32, "rwkv6_chunked": 0, "rwkv6_scan": 0}),
            ("5g", get_config(RWKV), "at all 32 layers",
             {"flash_attention": 0, "flash_attention_f32": 0, "ssm_scan": 0,
              "rwkv6_chunked": 32 * 2, "rwkv6_scan": 32 * 2 * 31})):
        got, eng, _ = serve_at_width(dev, phase, cfg, label, expect)
        launches.update({k: v for k, v in got.items() if v})
        if phase != "5g":           # 5g's engine stays for phase 6b
            del eng
            torch.cuda.empty_cache()

    # the wind tunnel over the port: the paper's loop (6a), the full-size
    # rwkv6-7b engine as the pipeline under test (6b, this slice's main
    # path) and the what-if trace (6c)
    wind_tunnel_telemetry(dev, whatif, tr, slo_mod)
    launches_6b, res_6b, twin_6b = wind_tunnel_serving(dev, eng, whatif, tr,
                                                       slo_mod)
    del eng
    torch.cuda.empty_cache()
    whatif_trace(whatif, slo_mod, sweep_twins, growths256, rows_4b)
    rows_4b, rows_4d = rows_array(rows_4b), rows_array(rows_4d)
    elapsed("phases 5-6")

    # the calibration slice: 6b's experiment fitted into twins on the card
    launches_7 = calibration_on_card(dev, whatif, tr, twin_mod, slo_mod,
                                     res_6b, twin_6b)
    elapsed("phase 7")

    # the search slice: What-if #6, #6b and #7's inverse questions
    launches_8 = search_on_card(dev, whatif, tr, twin_mod, slo_mod, faults)
    elapsed("phase 8")

    # the RoPE and MoE serving slice: llama3.2-1b whole, moonshot and
    # phi3.5-moe cut, from a card that holds no earlier engine
    launches_9, flash_9 = serve_rope_moe(dev, get_config, get_smoke_config)
    elapsed("phase 9")

    # the flash kernel at every head dim, MLA, whisper and qwen2-vl:
    # stablelm-3b, gemma-7b, qwen2-vl-7b and whisper-small whole,
    # minicpm3-4b cut, from a card that holds no earlier engine
    launches_10, flash_10, _ = serve_mla_encdec(dev, get_config,
                                                get_smoke_config)
    elapsed("phase 10")

    # phase 15's dry runs start here, in the background: CPU processes
    # beside phases 11-12 (the training steps keep the card busy) and on
    # into 13-14, kept off the host-bound phases before
    dryrun = dryrun_start()

    # registered policies on the card (their steps translated into the
    # policy kernels) and the padded flash head dims
    launches_11, record_11 = registered_policies_on_card(
        dev, whatif, tr, twin_mod, slo_mod, faults, ops_build, first_build)

    # the training side: no model kernel runs in a train step
    launches_12, _ = training_on_card(dev, get_smoke_config)
    elapsed("phases 11-12")

    # the multi-GPU layer and serving over a mesh: two gloo ranks on the
    # one card, and 14g's eight beside them (whisper-small over model=8:
    # the fall-back); the policy kernels' plain versions run meanwhile
    # in this process
    torch.cuda.empty_cache()
    whisper = whisper_mesh_start()
    jobs = policy_jobs(faults, sweep_twins, growths16, growths256, growths4,
                       dev)
    launches_13, launches_14, _, record_14, plains = mesh_on_card(
        rows_4b, rows_4d, beside=lambda: policy_plains(jobs))
    launches_14g, _ = whisper_mesh_finish(whisper)
    # 14f runs float32: its prefills launch the flash source's float32
    # kernel, its own row
    launches_14f = record_14["launches_14f"]
    del rows_4b, rows_4d

    elapsed("phases 13-14 and 14g")

    # the dry run of the production meshes and its roofline
    dryrun_finish(dryrun)

    # each kernel against its plain version at the main path's widths
    rows = policy_rows(jobs, plains)
    del jobs, plains
    ssm_stats = ssm_vs_plain(dev)
    wkv_stats = wkv_vs_plain(dev)
    # the ssm_scan row is the prefill's; its decode launch rides along
    ssm_row = dict(ssm_stats["prefill"],
                   decode_ms=ssm_stats["decode"]["ms"],
                   decode_device_ms=ssm_stats["decode"]["device_ms"])
    # the flash row is 5d's shape; phase 9's, 10's and 14a's (a rank's
    # heads) shapes ride along
    flash_row = dict(flash_vs_plain(dev), at_9=flash_9, at_10=flash_10,
                     at_14={"14a": flash_vs_plain(dev, "14a")})
    # the float32 kernel on its main path, 14f's prefill on a rank
    flash_f32_row = dict(flash_vs_plain(dev, "14f", torch.float32),
                         launches_of="14f (both ranks)",
                         at_14={"14g": flash_vs_plain(dev, "14g",
                                                      torch.float32)})
    rows += [("flash_attention", "flash_attention",
              "src/repro/kernels/flash_attention.py:23", flash_row),
             ("flash_attention_f32", "flash_attention",
              "src/repro/kernels/flash_attention.py:23", flash_f32_row),
             # past 256: phase 11's launches, timed at DeepSeek-V2-Lite's
             # absorbed shape in that phase
             ("flash_attention_wide", "flash_attention",
              "src/repro/kernels/flash_attention.py:23",
              dict(record_11["wide"]["flash_attention_wide"],
                   launches_of="11")),
             ("flash_attention_wide_f32", "flash_attention",
              "src/repro/kernels/flash_attention.py:23",
              dict(record_11["wide"]["flash_attention_wide_f32"],
                   launches_of="11")),
             ("ssm_scan", "ssm_scan", "src/repro/kernels/ssm_scan.py:27",
              ssm_row),
             ("rwkv6_chunked", "rwkv6",
              "src/repro/kernels/rwkv6_kernel.py:33", wkv_stats["prefill"]),
             ("rwkv6_scan", "rwkv6", "src/repro/kernels/rwkv6_kernel.py:33",
              wkv_stats["decode"])]
    # no kernel runs faster than the least time the card could take
    for name, _, _, stats in rows:
        for st in ([stats] + list(stats.get("at_9", {}).values())
                   + list(stats.get("at_10", {}).values())
                   + list(stats.get("at_14", {}).values())):
            check(st["ms"] >= st["bound_ms"], (name, st))
    elapsed("the kernels against their plain versions")
    print(json.dumps({"kernels": [
        dict({"name": name, "route": "cuda",
              "source": f"src/repro_torch/kernels/csrc/{src}.cu",
              "replaces": replaces,
              "launches": ({"14f (both ranks)": launches_14f,
                            "11": launches_11}[stats["launches_of"]].get(
                                name, 0)
                           if "launches_of" in stats else launches[name]),
              "launches_6b": launches_6b.get(name, 0),
              "launches_7": launches_7.get(name, 0),
              "launches_8": launches_8.get(name, 0),
              "launches_9": launches_9.get(name, 0),
              "launches_10": launches_10.get(name, 0),
              "launches_11": launches_11.get(name, 0),
              "launches_12": launches_12.get(name, 0),
              "launches_13": launches_13.get(name, 0),
              "launches_14": launches_14.get(name, 0),
              "launches_14f": launches_14f.get(name, 0),
              "launches_14g": launches_14g.get(name, 0)}, **stats)
        for name, src, replaces, stats in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
