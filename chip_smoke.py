#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PlantD's what-if year grid on one GPU.

    python3 chip_smoke.py

Builds the policy-scan kernels (benign and fault) from
``src/repro_torch/kernels/csrc`` with nvcc, then:

1. prints the card (``nvidia-smi`` name and power limit) and the build;
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
5. prints one JSON line of per-kernel numbers (launches on the main path,
   error against the plain version, kernel / plain / bound times), then
   ``{"ok": true, ...}`` as its last line.

Any failed check raises, and the script exits non-zero. It needs a CUDA
card and the repository's ``src``; it never falls back to the CPU.
"""
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from repro_torch.core import slo as slo_mod
    from repro_torch.core import traffic as tr
    from repro_torch.core import twin as twin_mod
    from repro_torch import faults
    from repro_torch.core import whatif
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
    log = build.library_path("policy_scan").with_suffix(".log")
    print(f"phase 1: nvcc build {build_s:.2f} s ({' '.join(build.NVCC_FLAGS)})")
    for line in log.read_text().splitlines():
        if "registers" in line or "entry function" in line:
            print("  ptxas:", line.strip())
    dev = torch.device("cuda", 0)

    check_random_blocks(dev)
    check_table2_kernels(dev, tr, twin_mod)
    check_fault_random_blocks(dev)

    # the main path: every count from 0, read right after
    pk.reset_launches()
    main_path_table2(whatif, tr, twin_mod, slo_mod)
    main_path_whatif7(whatif, tr, twin_mod, slo_mod, faults)
    sweep_twins, growths16, growths256 = at_width(whatif, tr, twin_mod,
                                                  slo_mod)
    growths4 = chaos_at_width(whatif, tr, slo_mod, faults, sweep_twins,
                              growths16)
    launches = dict(pk.launches)
    check(all(v > 0 for v in launches.values()), launches)

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
    source = "src/repro_torch/kernels/csrc/policy_scan.cu"
    print(json.dumps({"kernels": [
        dict({"name": name, "route": "cuda", "source": source,
              "replaces": replaces, "launches": launches[name]}, **stats,
             library_ms=None)
        for name, replaces, stats in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
