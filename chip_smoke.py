#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PlantD's what-if year grid on one GPU.

    python3 chip_smoke.py

Builds the two policy-scan kernels from ``src/repro_torch/kernels/csrc``
with nvcc, then:

1. prints the card (``nvidia-smi`` name and power limit) and the build;
2. holds each kernel against its plain PyTorch version on the card,
   bitwise: mixed-policy random blocks (foreign parameters in every slot,
   dt 1 and 1/60, N not a multiple of 32, both SLO modes) and the Table II
   inputs;
3. drives the main path, ``run_grid``, on Table II (3 paper twins x
   nominal/+50% traffic, SLO 4 h / 95%) in both modes: equal to the
   port's CPU run, the reference's numbers, and the paper's SLO pattern;
4. at width: the 4,096-scenario What-if #5 cost-lever sweep in series
   mode, its aggregate twin bitwise on sums, max, queue and SLO shares,
   and the 65,536-distinct-scenario full-year aggregate sweep (256 twins
   x 256 growth forecasts), held against the plain version over the
   whole grid;
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


def plain_loads(ops):
    return ops["loads_t"][:, ops["load_index"].long()].t().contiguous()


def bound(ops, agg, slo_mode=0):
    """(bound_ms, bound_by) of one launch: bytes each input read once and
    each output written once, over HBM; float32 operations over peak."""
    from repro_torch.core.twin import AGG_DIM, CARRY_DIM, PARAM_DIM
    n, t, k = len(ops["branch"]), ops["t_bins"], ops["k_rows"]
    p = ops["onehot"].shape[1]
    nbytes = 4 * (t * k + n * (1 + PARAM_DIM + p + CARRY_DIM))
    nbytes += 4 * n * (AGG_DIM if agg else 5 * t)
    per_bin = sum(POLICY_OPS[int(b)] for b in ops["branch"])
    if agg:
        per_bin += n * (AGG_OPS + (2 if slo_mode else 0))
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from repro_torch.core import slo as slo_mod
    from repro_torch.core import traffic as tr
    from repro_torch.core import twin as twin_mod
    from repro_torch.core import whatif
    from repro_torch.kernels import build
    from repro_torch.kernels import policy_scan as pk
    from repro_torch.kernels import ref

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

    # the main path: every count from 0, read right after
    pk.reset_launches()
    main_path_table2(whatif, tr, twin_mod, slo_mod)
    sweep_twins, growths16, growths256 = at_width(whatif, tr, twin_mod,
                                                  slo_mod)
    launches = dict(pk.launches)
    check(launches["policy_agg"] > 0 and launches["policy_scan"] > 0,
          launches)

    # each kernel against its plain version at the main path's widths
    agg_ops = grid_operands(sweep_twins, growths256, dev)
    agg_args = (None, agg_ops["params"], agg_ops["onehot"], 1.0)
    agg_kw = dict(slo_limit=4 * 3600.0, slo_mode=0,
                  loads_t=agg_ops["loads_t"],
                  load_index=agg_ops["load_index"])
    pk.policy_grid_agg(*agg_args, **agg_kw)                 # warm-up
    agg_ms, (c_k, a_k) = cuda_ms(lambda: pk.policy_grid_agg(*agg_args,
                                                            **agg_kw),
                                 reps=3)
    loads = plain_loads(agg_ops)
    agg_plain_ms, (c_p, a_p) = cuda_ms(lambda: ref.policy_grid_agg(
        loads, agg_ops["params"], agg_ops["onehot"], 1.0,
        slo_limit=4 * 3600.0, slo_mode=0))
    del loads
    assert_bitwise("65,536 agg carry", c_k, c_p)
    assert_bitwise("65,536 agg rows", a_k, a_p)
    agg_err = max_abs_err([(c_k, c_p), (a_k, a_p)])
    agg_bound, agg_by = bound(agg_ops, agg=True)
    print(f"policy_agg at 65,536 x 8736: kernel {agg_ms:.3f} ms, plain "
          f"{agg_plain_ms:.1f} ms, bound {agg_bound:.4f} ms ({agg_by}); "
          f"whole grid bitwise equal")
    del c_k, a_k, c_p, a_p, agg_ops

    scan_ops = grid_operands(sweep_twins, growths16, dev)
    scan_args = (None, scan_ops["params"], scan_ops["onehot"], 1.0)
    scan_kw = dict(loads_t=scan_ops["loads_t"],
                   load_index=scan_ops["load_index"])
    pk.policy_grid_scan(*scan_args, **scan_kw)              # warm-up
    scan_ms, (c_k, s_k) = cuda_ms(lambda: pk.policy_grid_scan(*scan_args,
                                                              **scan_kw),
                                  reps=3)
    loads = plain_loads(scan_ops)
    scan_plain_ms, (c_p, s_p) = cuda_ms(lambda: ref.policy_grid_scan(
        loads, scan_ops["params"], scan_ops["onehot"], 1.0))
    del loads
    assert_bitwise("4,096 scan carry", c_k, c_p)
    for j, (a, b) in enumerate(zip(s_k, s_p)):
        assert_bitwise(f"4,096 scan series {j}", a, b)
    scan_err = max_abs_err([(c_k, c_p)] + list(zip(s_k, s_p)))
    scan_bound, scan_by = bound(scan_ops, agg=False)
    print(f"policy_scan at 4,096 x 8736: kernel {scan_ms:.3f} ms, plain "
          f"{scan_plain_ms:.1f} ms, bound {scan_bound:.4f} ms ({scan_by}); "
          f"all five series bitwise equal")

    source = "src/repro_torch/kernels/csrc/policy_scan.cu"
    print(json.dumps({"kernels": [
        {"name": "policy_agg", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/policy_scan.py:190",
         "launches": launches["policy_agg"], "max_abs_err": agg_err,
         "ms": agg_ms, "plain_ms": agg_plain_ms, "bound_ms": agg_bound,
         "bound_by": agg_by, "library_ms": None},
        {"name": "policy_scan", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/policy_scan.py:104",
         "launches": launches["policy_scan"], "max_abs_err": scan_err,
         "ms": scan_ms, "plain_ms": scan_plain_ms, "bound_ms": scan_bound,
         "bound_by": scan_by, "library_ms": None},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
