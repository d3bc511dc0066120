#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PlantD on one GPU: the what-if year
grid and the serving pipeline-under-test (Jamba-1.5 and rwkv6-7b).

    python3 chip_smoke.py

Builds the kernels from ``src/repro_torch/kernels/csrc`` with nvcc (one
process per source, all started together: the policy scans, benign and
fault; flash attention, bf16 and float32; the Mamba selective scan; the
RWKV-6 WKV recurrence, chunked and per step), then:

1. prints the card (``nvidia-smi`` name and power limit) and the build,
   and checks the machine code (``cuobjdump -sass``): HGMMA and TMA loads
   in the flash library, HMMA and cp.async in the WKV library (1b);
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
   kernels against their plain version on random blocks (float32 on the
   CUDA cores, bf16 on the tensor cores; causal or not, GQA g 1, 4 and
   8, head dims 64 and 128, sq and sk around the 128-row tile and unequal,
   and the prefill shape; 5a); the selective-scan kernel likewise (s 1,
   37 and 256, a carried-in state, a run split in two against one whole
   run; 5b); the smoke-width model served on the card against the port's
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
   ``torch.profiler`` pass over one more prefill and 8 decode steps says
   where their time goes (device busy share, top kernels). Each model
   kernel is then held against its plain version at the shapes those
   paths gave it;
6. prints one JSON line of per-kernel numbers (eight kernels: launches
   on the main path, error against the plain version, kernel / plain /
   bound / library times; no kernel may read faster than its bound),
   then the card and ``{"ok": true, ...}`` as its last line.

Any failed check raises, and the script exits non-zero. It needs a CUDA
card and the repository's ``src``; it never falls back to the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

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
#: the chunked WKV kernel's products (its 3xTF32 split counted once)
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

RPS, USD_HR, LAT = 1.9512, 0.0082, 0.15
SEED = 0


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
    return sweep_twins, growths16, growths256


def chaos_at_width(whatif, tr, slo_mod, faults, sweep_twins, growths16):
    """Phases 4c and 4d: the chaos sweeps through run_grid(faults=).
    Returns the 4d forecasts."""
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
    return growths4


def kernel_vs_plain(name, shape, ops, agg):
    """Time one kernel on ``ops`` (CUDA events over 3 launches after a
    warm-up) and its plain version once, hold them bitwise over the whole
    grid, and return the kernels line's numbers for it."""
    from repro_torch.kernels import policy_scan as pk, ref
    kw = dict(loads_t=ops["loads_t"], load_index=ops["load_index"])
    plain_kw = {}
    if agg:
        kw.update(slo_limit=4 * 3600.0, slo_mode=0)
        plain_kw.update(slo_limit=4 * 3600.0, slo_mode=0)
    if "caps_t" in ops:
        kw.update(caps_t=ops["caps_t"], fault_index=ops["fault_index"])
        plain_kw["caps"] = plain_rows(ops, "caps_t")
        if agg:
            kw["fmask_t"] = ops["fmask_t"]
            plain_kw["fmask"] = plain_rows(ops, "fmask_t")
    kernel = pk.policy_grid_agg if agg else pk.policy_grid_scan
    plain = ref.policy_grid_agg if agg else ref.policy_grid_scan
    args = (None, ops["params"], ops["onehot"], 1.0)
    kernel(*args, **kw)                                     # warm-up
    ms, got = cuda_ms(lambda: kernel(*args, **kw), reps=3)
    loads = plain_loads(ops)
    plain_ms, want = cuda_ms(lambda: plain(loads, ops["params"],
                                           ops["onehot"], 1.0, **plain_kw))
    del loads, plain_kw
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
    print(f"{name} at {shape}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); whole grid bitwise equal")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    tiles and at the serving path's prefill shape."""
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
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    fk.reset_launches()
    n_cases = 0
    for (b, sq, sk, h, kh, d), dtypes, causals in (
            [(c, (torch.float32, torch.bfloat16), (True, False))
             for c in cases]
            + [(c, (torch.bfloat16,), (True, False)) for c in bf16_cases]):
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
    n_f32 = len(cases) * 2
    check(fk.launches == {"flash_attention": n_cases - n_f32,
                          "flash_attention_f32": n_f32}, fk.launches)
    print(f"phase 5a: flash kernels vs plain on {n_cases} random blocks "
          f"(causal or not, g 1/4/8, d 64/128, sq and sk 64-300 around "
          f"the 128-row tile, and the prefill shape in bf16): max abs "
          f"error float32 {worst[torch.float32]:.3g} (tol "
          f"{MODEL_TOL[torch.float32]:g}), bf16 "
          f"{worst[torch.bfloat16]:.3g} (tol {MODEL_TOL[torch.bfloat16]:g});"
          f" launches {fk.launches}")


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
    """Phase 5b: the selective-scan kernel against ref.ssm_scan."""
    from repro_torch.kernels import ref, ssm_scan as sk
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = 0.0
    for s in (1, 37, 256):
        for n in (16, 4):
            for dtype in (torch.float32, torch.bfloat16):
                for state in (False, True):
                    ops = ssm_inputs(2, s, 1000, n, dtype, dev, g, state)
                    got, want = sk.ssm(*ops), ref.ssm_scan(*ops)
                    for what, a, w in zip(("y", "state"), got, want):
                        worst = max(worst, close_or_raise(
                            f"ssm s={s} n={n} {dtype} state={state} {what}",
                            a, w, MODEL_TOL[dtype]))
    # a run split in two, the state carried across, against one whole run
    x, dt, A, B, C, D, st = ssm_inputs(2, 256, 1000, 16, torch.float32, dev,
                                       g)
    y_all, s_all = sk.ssm(x, dt, A, B, C, D, st)
    y1, s1 = sk.ssm(x[:, :100], dt[:, :100], A, B[:, :100], C[:, :100], D,
                    st)
    y2, s2 = sk.ssm(x[:, 100:], dt[:, 100:], A, B[:, 100:], C[:, 100:], D,
                    s1)
    tol = MODEL_TOL[torch.float32]
    close_or_raise("ssm split y", torch.cat([y1, y2], 1), y_all, tol)
    close_or_raise("ssm split state", s2, s_all, tol)
    torch.cuda.synchronize()
    print(f"phase 5b: selective-scan kernel vs plain on 24 random blocks "
          f"(s 1/37/256, n 16/4, di 1000, float32 and bf16, zero or "
          f"carried-in state): max abs error {worst:.3g}; a run split at "
          f"step 100 equals the whole run within {tol:g}")


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


def serve_at_width(dev, phase, cfg, label, expect):
    """Phases 5d and 5g, the serving main path at every published width
    of ``cfg`` (``label`` says how its depth was cut): 8 requests, two
    groups of 4. Holds the model kernels' launch counts of this run to
    ``expect`` and returns them."""
    from repro_torch.kernels import policy_scan as pk
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeEngine
    torch.cuda.empty_cache()            # what an earlier phase held
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, slots=4, max_len=4096, device=dev)
    load_peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"phase {phase}: {cfg.name} {label}: "
          f"{M.param_count(cfg):,} parameters drawn in "
          f"{init_s:.1f} s (float32, peak {load_peak / 2**30:.1f} GiB at "
          f"load), held as {held / 2**30:.1f} GiB (matrices in "
          f"{cfg.dtype})")
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
    launches = {k: v for mod in mods for k, v in mod.launches.items()}
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
    print(f"phase {phase}: served 8 requests (prompts {int(lens.min())}-"
          f"{int(lens.max())} tokens, padded to {eng._prefill_len}; 32 new "
          f"tokens each) in {wall * 1e3:.1f} ms wall: TTFT p50 "
          f"{np.percentile(ttft, 50):.1f} ms, p95 "
          f"{np.percentile(ttft, 95):.1f} ms; per-token decode "
          f"{dec.mean():.2f} ms (a step of 4 rows); {new_tokens / wall:.1f} "
          f"tokens/s; span means prefill {pre.mean():.1f} ms, decode "
          f"{dec.mean():.2f} ms ({summ['decode']['records']} decode "
          f"records); peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated)")
    print(json.dumps({"serve": {
        "phase": phase, "model": cfg.name, "layers": cfg.num_layers,
        "params": M.param_count(cfg), "requests": 8, "slots": eng.slots,
        "max_len": eng.max_len,
        "max_new": 32, "wall_ms": wall * 1e3,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p95": float(np.percentile(ttft, 95)),
        "decode_step_ms": float(dec.mean()),
        "prefill_span_ms": float(pre.mean()),
        "tokens_per_s": new_tokens / wall, "peak_gib": peak / 2**30,
        "held_gib": held / 2**30, "launches": launches}}))
    profile_serving(eng, prompts[:4], dev, phase)
    del eng, done
    torch.cuda.empty_cache()
    return launches


def profile_serving(eng, prompts, dev, phase):
    """Where a group's time goes: one prefill and ``steps`` greedy decode
    steps of the engine's own step functions, as ``process_group`` runs
    them, under ``torch.profiler``: wall and summed device (kernel) time,
    the device's busy share, the kernels that take most of it, and the
    PyTorch operations the host dispatched (top-level ``aten::`` calls,
    the greedy pick included). Runs after the main path's counts were
    read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    toks = np.zeros((eng.slots, eng._prefill_len), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p[-eng._prefill_len:]
    cache = M.init_cache(eng.cfg, eng.slots, eng.max_len, device=dev)
    steps = 8
    out = {}
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
    print(json.dumps({"profile": dict(out, phase=phase)}))


def flash_vs_plain(dev):
    """The flash kernel at the serving path's prefill shape (q [4, 2,048,
    64, 128], k/v [4, 2,048, 8, 128], bf16, causal), against its plain
    version, with SDPA's time for the table."""
    from repro_torch.kernels import flash_attention as fk, ref
    b, s, h, kh, d = 4, 2048, 64, 8, 128
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    q = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    k = torch.randn(b, s, kh, d, generator=g, device=dev).bfloat16()
    v = torch.randn(b, s, kh, d, generator=g, device=dev).bfloat16()
    fk.flash_attention(q, k, v)                                 # warm-up
    ms, got = cuda_ms(lambda: fk.flash_attention(q, k, v), reps=10)
    plain_ms, want = cuda_ms(lambda: ref.flash_attention(q, k, v))
    err = close_or_raise("flash at width", got, want,
                         MODEL_TOL[torch.bfloat16])
    del want

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
    library()
    library_ms, _ = cuda_ms(library, reps=10)
    flops = 4 * b * h * s * s * d / 2                  # causal: half
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"flash_attention at q {list(q.shape)} bf16 causal: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, SDPA {library_ms:.3f} ms "
          f"(kernel / SDPA {ms / library_ms:.2f}), bound {bound_ms:.4f} ms "
          f"({bound_by}; the kernel at {bound_ms / ms:.1%} of it, "
          f"{flops / ms / 1e9:.0f} TFLOP/s); max abs error {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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
        print(f"ssm_scan {what} at [{b}, {s}, {di}] x {n} bf16: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); max abs error {err:.3g}")
        out[what] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
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
        print(f"{name} {what} at [{b}, {s}, {h}, {n}] bf16: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms (set by {bound_by}; the kernel at "
              f"{bound_ms / ms:.1%} of it); max abs error {err:.3g}")
        out[what] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
    return out


def sass_check(build):
    """Phase 1b: the built libraries' machine code holds the instructions
    the redesigned kernels are built on: wgmma (HGMMA) and TMA loads
    (UTMALDG) in flash_attention, mma.sync (HMMA) and cp.async (LDGSTS)
    in rwkv6."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    for name, want in (("flash_attention", ("HGMMA", "UTMALDG")),
                       ("rwkv6", ("HMMA", "LDGSTS"))):
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {op: sum(op in line for line in sass.splitlines())
                  for op in want}
        check(all(counts.values()), (name, counts))
        print(f"phase 1b: cuobjdump -sass {name}: "
              + ", ".join(f"{n} {op} instructions" for op, n in counts.items()))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
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
    build_s = build.build()
    print(f"phase 1: nvcc build of {len(build.SOURCES)} sources in "
          f"parallel, {build_s:.2f} s")
    for name in build.SOURCES:
        print(f"  {name}: {' '.join(build.FLAGS[name])}")
        log = build.library_path(name).with_suffix(".log")
        if not log.exists():        # built by an earlier run
            continue
        for line in log.read_text().splitlines():
            if "registers" in line or "entry function" in line:
                print("  ptxas:", line.strip())
    sass_check(build)
    dev = torch.device("cuda", 0)
    # float32 matrix products in full float32 on the card (5c compares
    # them with the CPU's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    sweep_twins, growths16, growths256 = at_width(whatif, tr, twin_mod,
                                                  slo_mod)
    growths4 = chaos_at_width(whatif, tr, slo_mod, faults, sweep_twins,
                              growths16)
    launches = dict(pk.launches)
    check(all(v > 0 for v in launches.values()), launches)
    check(sum(sum(mod.launches.values()) for mod in mods) == 0,
          "a model kernel ran on the what-if path")

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
        got = serve_at_width(dev, phase, cfg, label, expect)
        launches.update({k: v for k, v in got.items() if v})

    # each kernel against its plain version at the main path's widths
    rows = [
        ("policy_agg", "src/repro/kernels/policy_scan.py:190",
         kernel_vs_plain("policy_agg", "65,536 x 8736",
                         grid_operands(sweep_twins, growths256, dev), True)),
        ("policy_scan", "src/repro/kernels/policy_scan.py:104",
         kernel_vs_plain("policy_scan", "4,096 x 8736",
                         grid_operands(sweep_twins, growths16, dev), False)),
        ("policy_agg_fault", "src/repro/kernels/policy_scan.py:234",
         kernel_vs_plain("policy_agg_fault", "65,536 x 8736 (F=16)",
                         chaos_operands(sweep_twins, growths16,
                                        chaos_schedule(faults, 16), dev),
                         True)),
        ("policy_scan_fault", "src/repro/core/simulate.py:375 (XLA)",
         kernel_vs_plain("policy_scan_fault", "4,096 x 8736 (F=4)",
                         chaos_operands(sweep_twins, growths4,
                                        chaos_schedule(faults, 4), dev),
                         False)),
    ]
    rows = [(name, "policy_scan", replaces, dict(stats, library_ms=None))
            for name, replaces, stats in rows]
    ssm_stats = ssm_vs_plain(dev)
    wkv_stats = wkv_vs_plain(dev)
    rows += [("flash_attention", "flash_attention",
              "src/repro/kernels/flash_attention.py:23", flash_vs_plain(dev)),
             ("ssm_scan", "ssm_scan", "src/repro/kernels/ssm_scan.py:27",
              ssm_stats["prefill"]),
             ("rwkv6_chunked", "rwkv6",
              "src/repro/kernels/rwkv6_kernel.py:33", wkv_stats["prefill"]),
             ("rwkv6_scan", "rwkv6", "src/repro/kernels/rwkv6_kernel.py:33",
              wkv_stats["decode"])]
    # no kernel runs faster than the least time the card could take
    for name, _, _, stats in rows:
        check(stats["ms"] >= stats["bound_ms"], (name, stats))
    print(json.dumps({"kernels": [
        dict({"name": name, "route": "cuda",
              "source": f"src/repro_torch/kernels/csrc/{src}.cu",
              "replaces": replaces, "launches": launches[name]}, **stats)
        for name, src, replaces, stats in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
