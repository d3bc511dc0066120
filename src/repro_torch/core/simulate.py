"""Year-long pipeline simulation (paper Sec. V-G / Tables II & IV) on the
port.

Counterpart: ``repro.core.simulate``. ``simulate_grid`` plays N (twin x
load) scenarios through the policy scan in one kernel launch per mode, on
the device ``device=`` names (default ``"cuda"``; ``"cpu"`` runs the plain
PyTorch versions):

* ``return_series=True`` — the five [N, T] per-bin series come back and
  each scenario is summarised into a ``SimulationResult``
  (``kernels.ops.policy_scan``);
* ``return_series=False`` — the streaming-aggregate kernel folds the
  Table II statistics into the scan and returns O(N) ``GridSummary`` rows
  (``kernels.ops.policy_scan_agg``); sums, maxima, end queue and SLO
  percentages equal the series mode's bit for bit, the median is read off
  the quarter-octave histogram.

Scenarios arrive as a stacked ``loads`` [N, T] grid or as a [K, T]
``load_matrix`` plus an [N] ``load_index``; either way the kernels read the
K distinct rows through the index. Bitwise-duplicate scenarios are
simulated once (``_dedup_rows``). Aggregate grids beyond
``AGG_AUTO_BLOCK`` scenarios (or with ``scenario_block=``) run in
policy-uniform blocks (``_agg_block_plan``), with identical results.

``faults=`` (a ``repro_torch.faults.FaultSchedule`` or ``SampledFaults``)
plays every scenario against F fault futures: the grid expands to N*F
rows named ``"{name}/f{f}"``, scenario-major, and the fault kernels read
the [F, T] capacity and in-fault rows through a per-row fault index.

Not yet in the port: ``devices`` > 1 and the telemetry spans of
``repro.obs``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cost import CostModel
from repro_torch.core.slo import SLO
from repro_torch.core.traffic import DAYS_PER_YEAR, HOURS_PER_YEAR, MONTH_DAYS
from repro_torch.core.twin import (A_COST, A_DROP, A_FLTH, A_FOKH, A_LATW,
                                   A_LOAD, A_MAXP, A_OKH, A_OKW, A_PROC,
                                   AGG_DIM, AGG_HIST_BINS, AGG_KDIM,
                                   AGG_SCALARS, AGG_SLO_DROP_RATE,
                                   AGG_SLO_LATENCY, CARRY_DIM, PARAM_DIM,
                                   Twin, aggregate_hist_centers,
                                   num_policies, policy_onehot)
from repro_torch.device import resolve_device
from repro_torch.faults import (FaultSchedule, SampledFaults, expand_grid,
                                sample_futures, validate_sampled)
from repro_torch.kernels import ops


@dataclass
class SimulationResult:
    name: str
    twin: Twin
    # hourly arrays [8736]
    load: np.ndarray
    processed: np.ndarray
    queue: np.ndarray
    latency_s: np.ndarray
    cost_usd: np.ndarray
    # scalars
    total_cost_usd: float
    backlog_s: float
    backlog_cost_usd: float
    mean_throughput_rph: float
    max_throughput_rph: float
    median_latency_s: float
    mean_latency_s: float
    pct_latency_met: float          # record-weighted, vs slo.limit
    pct_hours_met: float            # hour-weighted
    slo_met: Optional[bool]
    network_cost_usd: float = 0.0
    storage_cost_usd: float = 0.0
    # hourly records shed by bounded-queue policies (zeros otherwise)
    dropped: np.ndarray = field(default_factory=lambda: np.zeros(0))
    dropped_records: float = 0.0
    # record-weighted tail latencies (same CDF the median is read from)
    p95_latency_s: float = 0.0
    p99_latency_s: float = 0.0

    def __post_init__(self):
        if self.dropped.shape != self.load.shape:
            if self.dropped.size == 0:
                self.dropped = np.zeros_like(self.load)
            else:
                raise ValueError(
                    f"dropped has shape {self.dropped.shape}, want "
                    f"{self.load.shape} to match the hourly series")

    @property
    def grand_total_usd(self) -> float:
        return self.total_cost_usd + self.network_cost_usd + self.storage_cost_usd


@dataclass
class GridSummary:
    """One scenario of an aggregate-mode grid: Table II scalars, no series
    (fields as in ``repro.core.simulate.GridSummary``)."""
    name: str
    twin: Twin
    total_cost_usd: float
    backlog_s: float
    backlog_cost_usd: float
    mean_throughput_rph: float
    max_throughput_rph: float
    median_latency_s: float
    mean_latency_s: float
    pct_latency_met: float
    pct_hours_met: float
    slo_met: Optional[bool]
    network_cost_usd: float = 0.0
    storage_cost_usd: float = 0.0
    dropped_records: float = 0.0
    p95_latency_s: float = 0.0
    p99_latency_s: float = 0.0
    processed_records: float = 0.0
    arrived_records: float = 0.0
    queue_end: float = 0.0
    latency_hist: np.ndarray = field(default_factory=lambda: np.zeros(0))
    fault_hours: float = 0.0
    pct_hours_met_in_fault: float = 100.0
    pct_hours_met_outside_fault: float = 100.0

    @property
    def grand_total_usd(self) -> float:
        return self.total_cost_usd + self.network_cost_usd + self.storage_cost_usd


#: device memory one aggregate launch may take; larger grids run in blocks
AGG_BLOCK_BUDGET_BYTES = 1 << 30
#: bytes one scenario holds on the device during an aggregate launch:
#: params, one-hot row, load-row, fault-row and branch indices, carry, the
#: kernel's scalar slots and [3, 152] histogram scratch, the packed
#: AGG_KDIM row, the f64 recombination of the histogram triple, and the
#: AGG_DIM row (8,232 B). The fault backlog lives in a register and folds
#: into the carry; the [F, T] fault rows are shared by the whole grid.
AGG_BYTES_PER_SCENARIO = (
    4 * (PARAM_DIM + num_policies() + 3 + CARRY_DIM + AGG_SCALARS
         + 3 * AGG_HIST_BINS + AGG_KDIM + AGG_DIM)
    + 8 * 3 * AGG_HIST_BINS)
#: aggregate grids beyond this many scenarios run in policy-uniform blocks
#: (a multiple of the kernels' 128-thread blocks)
AGG_AUTO_BLOCK = AGG_BLOCK_BUDGET_BYTES // AGG_BYTES_PER_SCENARIO // 128 * 128


def _agg_block_plan(policy_idx: np.ndarray, block: int):
    """Group scenarios into single-policy blocks of ``block``.

    Returns (positions [NB, block] int64, block_policy [NB] int32):
    ``positions[b, i]`` is the scenario index occupying slot i of block b,
    or -1 for a pad slot (each policy's run is padded up to a block
    multiple independently). Grouping is a STABLE sort by policy, so
    scenarios of one policy keep their grid order; results are scattered
    back through ``positions``. On the card a policy-uniform block also
    keeps the kernels' warps on one branch."""
    policy_idx = np.asarray(policy_idx)
    order = np.argsort(policy_idx, kind="stable")
    positions, block_policy = [], []
    for p in np.unique(policy_idx):
        pos = order[policy_idx[order] == p]
        nb = -(-len(pos) // block)
        padded = np.full(nb * block, -1, np.int64)
        padded[:len(pos)] = pos
        positions.append(padded.reshape(nb, block))
        block_policy.extend([int(p)] * nb)
    if positions:
        positions = np.concatenate(positions)
    else:
        positions = np.zeros((0, block), np.int64)
    return positions, np.asarray(block_policy, np.int32)


def _dedup_rows(load_index: np.ndarray, params: np.ndarray,
                policy_idx: np.ndarray, fault=None):
    """Exact duplicate-scenario detection for the aggregate dispatch: two
    rows are duplicates when their (load row, param vector, policy index,
    fault row) are BITWISE identical, so one simulation serves both.
    Fault rows are canonicalized first (bitwise-equal [F, T] cap+fmask
    rows map to one id), which collapses benign futures. Returns (keep
    [U], inv [N], fidx_canon [N] or None) — first occurrences, the
    expansion map back to grid order and the canonical fault rows — or
    None when every row is already distinct."""
    lidx = np.ascontiguousarray(load_index, np.int32)
    n = lidx.shape[0]
    pp = np.ascontiguousarray(params, np.float32)
    key = [lidx[:, None].view(np.uint32),
           np.ascontiguousarray(policy_idx, np.int32)[:, None]
           .view(np.uint32), pp.view(np.uint32)]
    fidx_canon = None
    if fault is not None:
        frows = np.concatenate(
            [np.ascontiguousarray(fault[0], np.float32).view(np.uint32),
             np.ascontiguousarray(fault[1], np.float32).view(np.uint32)],
            axis=1)
        _, ffirst, finv = np.unique(frows, axis=0, return_index=True,
                                    return_inverse=True)
        fidx_canon = ffirst[finv.reshape(-1)][np.asarray(fault[2])] \
            .astype(np.int32)
        key.append(fidx_canon[:, None].view(np.uint32))
    keep, inv = np.unique(np.concatenate(key, axis=1), axis=0,
                          return_index=True, return_inverse=True)[1:]
    if keep.shape[0] == n:
        return None
    return keep, inv.reshape(-1), fidx_canon


def _to(dev, a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


def _agg_launch(matrix_t: torch.Tensor, load_index: np.ndarray,
                params: np.ndarray, policy_idx: np.ndarray, dt_hours: float,
                slo_limit: float, slo_mode: int, fault_t=None,
                fault_index=None):
    """One aggregate launch on ``matrix_t``'s device; host f64 results.
    ``fault_t`` = (caps_t, fmask_t), each [T, F] on that device, with the
    launch's [B] ``fault_index``."""
    dev = matrix_t.device
    caps_t = fmask_t = findex = None
    if fault_t is not None:
        caps_t, fmask_t = fault_t
        findex = _to(dev, fault_index, np.int32)
    carry, agg = ops.policy_scan_agg(
        None, _to(dev, params, np.float32),
        torch.from_numpy(policy_onehot(policy_idx)).to(dev), dt_hours,
        slo_limit=slo_limit, slo_mode=slo_mode, loads_t=matrix_t,
        load_index=_to(dev, load_index, np.int32), caps_t=caps_t,
        fmask_t=fmask_t, fault_index=findex)
    return (carry.cpu().numpy().astype(np.float64),
            agg.cpu().numpy().astype(np.float64))


def _grid_agg_dispatch(load_matrix: np.ndarray, load_index: np.ndarray,
                       params: np.ndarray, policy_idx: np.ndarray,
                       dt_hours: float, slo_limit: float, slo_mode: int,
                       scenario_block: Optional[int], device: torch.device,
                       fault=None):
    """Aggregate scan over (matrix, index)-encoded scenarios: one launch,
    or policy-uniform blocks of ``scenario_block`` (default: beyond
    ``AGG_AUTO_BLOCK`` scenarios). Duplicate rows run once. ``fault`` =
    (cap [F, T], fmask [F, T], fault_index [N]) threads a fault grid
    through every path: fault rows are read through the index as load
    rows are. Returns host (carry_end [N, CARRY_DIM], agg [N, AGG_DIM])
    in f64, bit-identical on every path."""
    n = len(load_index)
    dd = _dedup_rows(load_index, params, policy_idx, fault)
    if dd is not None:
        keep, inv, fidx_canon = dd
        fault_k = None if fault is None else (fault[0], fault[1],
                                              fidx_canon[keep])
        carry_u, agg_u = _grid_agg_dispatch(
            load_matrix, np.asarray(load_index)[keep],
            np.asarray(params)[keep], np.asarray(policy_idx)[keep],
            dt_hours, slo_limit, slo_mode, scenario_block, device, fault_k)
        return carry_u[inv], agg_u[inv]
    matrix_t = _to(device, np.asarray(load_matrix).T, np.float32)
    fault_t = fidx = None
    if fault is not None:
        fault_t = (_to(device, np.asarray(fault[0]).T, np.float32),
                   _to(device, np.asarray(fault[1]).T, np.float32))
        fidx = np.asarray(fault[2])
    if scenario_block is None and n > AGG_AUTO_BLOCK:
        scenario_block = AGG_AUTO_BLOCK
    if scenario_block is None or scenario_block >= n:
        return _agg_launch(matrix_t, load_index, params, policy_idx,
                           dt_hours, slo_limit, slo_mode, fault_t, fidx)
    positions, _ = _agg_block_plan(policy_idx, int(scenario_block))
    carry_end = np.zeros((n, CARRY_DIM), np.float64)
    out_agg = np.zeros((n, AGG_DIM), np.float64)
    for pos in positions:
        pos = pos[pos >= 0]     # pad slots run nothing
        carry_end[pos], out_agg[pos] = _agg_launch(
            matrix_t, np.asarray(load_index)[pos], np.asarray(params)[pos],
            np.asarray(policy_idx)[pos], dt_hours, slo_limit, slo_mode,
            fault_t, None if fidx is None else fidx[pos])
    return carry_end, out_agg


def _expand_faults(faults, load_matrix, load_index, t_bins: int,
                   bin_hours: float):
    """Sample (or take) the fault futures, validate them, and expand the
    (matrix, index) grid by them: returns (FaultGrid, (cap, fmask,
    fault_index))."""
    if isinstance(faults, FaultSchedule):
        sampled = sample_futures(faults, t_bins, float(bin_hours))
    elif isinstance(faults, SampledFaults):
        if faults.t_bins != t_bins:
            raise ValueError(
                f"SampledFaults covers {faults.t_bins} bins but the "
                f"grid has {t_bins}; resample with sample_futures("
                f"schedule, {t_bins}, bin_hours={bin_hours})")
        sampled = faults
    else:
        raise TypeError(
            f"faults= must be a repro_torch.faults.FaultSchedule or "
            f"SampledFaults, got {type(faults).__name__}")
    validate_sampled(sampled)
    fg = expand_grid(sampled, load_matrix, load_index)
    return fg, (fg.cap, fg.fmask, fg.fault_index)


def simulate_grid(twins: Sequence[Twin], loads: Optional[np.ndarray] = None,
                  names: Optional[Sequence[str]] = None,
                  slo: Optional[SLO] = None,
                  cost_model: Optional[CostModel] = None,
                  record_mb: float = 0.0,
                  bin_hours: Optional[float] = None, *,
                  return_series: bool = True,
                  load_matrix: Optional[np.ndarray] = None,
                  load_index: Optional[np.ndarray] = None,
                  scenario_block: Optional[int] = None,
                  devices: Optional[int] = None,
                  faults=None, device="cuda"):
    """Simulate N scenarios — twins[i] against loads[i] — in one launch.

    The contract of ``repro.core.simulate.simulate_grid``: ``loads`` [N, T]
    or ``load_matrix`` [K, T] + ``load_index`` [N]; omitting ``bin_hours``
    pins the hourly full year; ``return_series`` picks the mode;
    ``scenario_block`` streams the aggregate mode in blocks; ``faults=``
    crosses the grid with F fault futures (rows ``i * F + f`` named
    ``"{name}/f{f}"``; a negative or non-finite sampled multiplier raises
    ``ValueError`` naming the spec and bin). ``device`` is ``"cuda"`` (the
    kernels; raises without a card) or ``"cpu"`` (the plain versions).
    ``devices`` > 1 is not ported yet and raises
    ``NotImplementedError``."""
    if (loads is None) == (load_matrix is None):
        raise ValueError("pass exactly one of loads= (stacked [N, T] grid) "
                         "or load_matrix= [K, T] + load_index= [N]")
    if load_matrix is not None:
        load_matrix = np.asarray(load_matrix, np.float32)
        if load_matrix.ndim != 2:
            raise ValueError(f"load_matrix must be [K, T], got shape "
                             f"{load_matrix.shape}")
        if load_index is None:
            raise ValueError("load_matrix= needs load_index= mapping each "
                             "scenario to a matrix row")
        load_index = np.asarray(load_index, np.int32)
        if load_index.ndim != 1:
            raise ValueError(f"load_index must be [N], got shape "
                             f"{load_index.shape}")
        if load_index.size and (load_index.min() < 0
                                or load_index.max() >= load_matrix.shape[0]):
            raise ValueError(f"load_index out of range for "
                             f"{load_matrix.shape[0]} load_matrix rows")
    else:
        loads = np.asarray(loads, np.float32)
        if loads.ndim != 2:
            raise ValueError(f"loads must be a [N, T] scenario grid, got "
                             f"shape {loads.shape}")
        load_matrix = loads
        load_index = np.arange(loads.shape[0], dtype=np.int32)
    n, t_bins = len(load_index), load_matrix.shape[1]
    if bin_hours is None:
        if t_bins != HOURS_PER_YEAR:
            raise ValueError(
                f"hourly grids must cover the {HOURS_PER_YEAR}-hour year, "
                f"got {t_bins} bins; pass bin_hours= for sub-hour "
                f"or short-horizon traces")
        bin_hours = 1.0
    year_grid = t_bins == HOURS_PER_YEAR and bin_hours == 1.0
    if cost_model is not None and record_mb > 0.0 and not year_grid:
        raise ValueError("storage/network costs need the hourly full-year "
                         "grid (daily rolling retention); drop the cost "
                         "model or simulate the full year")
    if len(twins) != n:
        raise ValueError(f"{len(twins)} twins for {n} load "
                         f"rows — the grid pairs twins[i] with loads[i]")
    if scenario_block is not None and scenario_block <= 0:
        raise ValueError(f"scenario_block must be a positive block size, "
                         f"got {scenario_block}")
    if scenario_block is not None and return_series:
        raise ValueError("scenario_block chunks the streaming-aggregate "
                         "backend only; pass return_series=False")
    if devices is not None:
        if return_series:
            raise ValueError("devices= shards the streaming-aggregate "
                             "backend only; pass return_series=False")
        if devices <= 0:
            raise ValueError(f"devices must be a positive mesh size, "
                             f"got {devices}")
        if devices > 1:
            raise NotImplementedError(
                "devices > 1 is not in the port yet: the multi-GPU slice "
                "shards the scenario blocks with torch.distributed")
    dev = resolve_device(device)
    params = np.stack([tw.padded_params() for tw in twins]) if n else \
        np.zeros((0, PARAM_DIM), np.float32)
    idx = np.asarray([tw.policy_index for tw in twins], np.int32)
    names = list(names) if names is not None else [tw.name for tw in twins]

    fault = None
    if faults is not None:
        fg, fault = _expand_faults(faults, load_matrix, load_index, t_bins,
                                   bin_hours)
        nf = fg.n_futures
        load_matrix, load_index = fg.load_matrix, fg.load_index
        params = np.repeat(params, nf, axis=0)
        idx = np.repeat(idx, nf)
        twins = [tw for tw in twins for _ in range(nf)]
        names = [f"{nm}/f{f}" for nm in names for f in range(nf)]
        n = n * nf

    if not return_series:
        slo_mode = (AGG_SLO_DROP_RATE
                    if slo is not None and slo.metric == "drop_rate"
                    else AGG_SLO_LATENCY)
        slo_limit = float(slo.limit_s) if slo is not None else float("inf")
        carry_end, agg = _grid_agg_dispatch(
            load_matrix, load_index, params, idx, float(bin_hours),
            slo_limit, slo_mode, scenario_block, dev, fault)
        return _summarise_aggregates(
            names, twins, carry_end[:, 0], agg, slo, cost_model, record_mb,
            float(bin_hours), t_bins, load_matrix, load_index)

    caps_t = fidx = None
    if fault is not None:
        caps_t = _to(dev, np.asarray(fault[0]).T, np.float32)
        fidx = _to(dev, fault[2], np.int32)
    carry_end, series = ops.policy_scan(
        None, _to(dev, params, np.float32),
        torch.from_numpy(policy_onehot(idx)).to(dev), float(bin_hours),
        loads_t=_to(dev, load_matrix.T, np.float32),
        load_index=_to(dev, load_index, np.int32), caps_t=caps_t,
        fault_index=fidx)
    q_end = carry_end[:, 0].cpu().numpy().astype(np.float64)
    processed, queue, latency, cost, dropped = \
        torch.stack(series).cpu().numpy()   # [5, N, T] f32, row-major
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    return [
        _summarise(names[i], twins[i], f64(load_matrix[load_index[i]]),
                   f64(processed[i]), f64(queue[i]), f64(latency[i]),
                   f64(cost[i]), f64(dropped[i]), float(q_end[i]), slo,
                   cost_model, record_mb, bin_hours)
        for i in range(n)
    ]


def simulate_year(twin: Twin, hourly_load: np.ndarray,
                  slo: Optional[SLO] = None,
                  cost_model: Optional[CostModel] = None,
                  record_mb: float = 0.0,
                  name: Optional[str] = None,
                  device="cuda") -> SimulationResult:
    """Batch-of-one wrapper over ``simulate_grid`` (the seed's API)."""
    load = np.asarray(hourly_load, np.float32)
    if load.shape != (HOURS_PER_YEAR,):
        raise ValueError(f"hourly_load must cover the {HOURS_PER_YEAR}-hour "
                         f"year, got shape {load.shape}; use simulate_grid "
                         f"with bin_hours= for other horizons")
    return simulate_grid([twin], load[None], names=[name or twin.name],
                         slo=slo, cost_model=cost_model,
                         record_mb=record_mb, device=device)[0]


def _summarise(name: str, twin: Twin, load_np: np.ndarray,
               processed: np.ndarray, queue: np.ndarray, lat_np: np.ndarray,
               cost_np: np.ndarray, dropped: np.ndarray, q_end: float,
               slo: Optional[SLO], cost_model: Optional[CostModel],
               record_mb: float, bin_hours: float = 1.0) -> SimulationResult:
    backlog_s = q_end / max(twin.max_rps, 1e-9)
    backlog_cost = backlog_s / 3600.0 * twin.usd_per_hour

    # record-weighted latency stats (records arriving each hour share the
    # hour's latency estimate); p95/p99 read off the same CDF as the median
    w = load_np / max(load_np.sum(), 1e-9)
    order = np.argsort(lat_np)
    sorted_lat = lat_np[order]
    cdf = np.cumsum(w[order])
    qidx = np.minimum(np.searchsorted(cdf, (0.5, 0.95, 0.99)),
                      len(sorted_lat) - 1)
    median_lat, p95_lat, p99_lat = (float(v) for v in sorted_lat[qidx])
    mean_lat = float((lat_np * w).sum())

    pct_rec_met = pct_hours_met = 100.0
    slo_met = None
    if slo is not None:
        if slo.metric == "drop_rate":
            vals = dropped / np.maximum(load_np, 1e-9)
        else:
            vals = lat_np
        pct_rec_met, slo_met = slo.evaluate(vals, weights=load_np)
        pct_hours_met = slo.evaluate(vals)[0]

    net_cost = stor_cost = 0.0
    if cost_model is not None and record_mb > 0.0:
        daily = storage_costs(load_np, cost_model, record_mb)
        net_cost = float(daily["network_usd"].sum())
        stor_cost = float(daily["storage_usd"].sum())

    return SimulationResult(
        name=name, twin=twin, load=load_np,
        processed=processed, queue=queue, latency_s=lat_np, cost_usd=cost_np,
        total_cost_usd=float(cost_np.sum() + backlog_cost),
        backlog_s=backlog_s, backlog_cost_usd=backlog_cost,
        mean_throughput_rph=float(processed.mean() / bin_hours),
        max_throughput_rph=float(processed.max() / bin_hours),
        median_latency_s=median_lat, mean_latency_s=mean_lat,
        pct_latency_met=pct_rec_met, pct_hours_met=pct_hours_met,
        slo_met=slo_met, network_cost_usd=net_cost,
        storage_cost_usd=stor_cost, dropped=dropped,
        dropped_records=float(dropped.sum()),
        p95_latency_s=p95_lat, p99_latency_s=p99_lat)


def _summarise_aggregates(names: Sequence[str], twins: Sequence[Twin],
                          q_end: np.ndarray, agg: np.ndarray,
                          slo: Optional[SLO],
                          cost_model: Optional[CostModel], record_mb: float,
                          bin_hours: float, t_bins: int,
                          load_matrix: np.ndarray,
                          load_index: np.ndarray) -> List[GridSummary]:
    """ONE vectorized numpy pass over the [N, AGG_DIM] aggregate rows:
    compensated triples recombined in f64 (bitwise the series path's
    sums), quantiles read off the load-weighted histogram CDF."""
    n = agg.shape[0]
    tri = lambda i: agg[:, i] + agg[:, i + 1] + agg[:, i + 2]  # noqa: E731
    sum_proc, sum_cost = tri(A_PROC), tri(A_COST)
    sum_drop, sum_latw = tri(A_DROP), tri(A_LATW)
    sum_load, sum_okw = tri(A_LOAD), tri(A_OKW)
    okh, maxp = agg[:, A_OKH], agg[:, A_MAXP]
    flth, fokh = agg[:, A_FLTH], agg[:, A_FOKH]

    max_rps = np.array([tw.max_rps for tw in twins], np.float64)
    usd_hr = np.array([tw.usd_per_hour for tw in twins], np.float64)
    backlog_s = q_end / np.maximum(max_rps, 1e-9)
    backlog_cost = backlog_s / 3600.0 * usd_hr

    hist = agg[:, AGG_SCALARS:]
    cdf = np.cumsum(hist, axis=1)
    centers = aggregate_hist_centers()
    median, p95, p99 = (
        centers[np.argmax(cdf >= q * cdf[:, -1:], axis=1)]
        for q in (0.5, 0.95, 0.99))
    mean_lat = sum_latw / np.maximum(sum_load, 1e-9)

    if slo is not None:
        pct_rec = sum_okw / np.maximum(sum_load, 1e-12) * 100.0
        pct_hours = okh / t_bins * 100.0
        met = pct_rec >= slo.met_fraction * 100.0
    else:
        pct_rec = pct_hours = np.full(n, 100.0)
        met = None

    fault_hours = flth * bin_hours
    pct_in = np.where(flth > 0, fokh / np.maximum(flth, 1.0) * 100.0,
                      100.0)
    out_bins = t_bins - flth
    pct_out = np.where(out_bins > 0,
                       (okh - fokh) / np.maximum(out_bins, 1.0) * 100.0,
                       100.0)

    net = stor = np.zeros(n)
    if cost_model is not None and record_mb > 0.0:
        # per distinct load row, then spread by the index map
        daily = np.asarray(load_matrix, np.float64).reshape(
            -1, DAYS_PER_YEAR, 24).sum(axis=2)
        ingest_mb = daily * record_mb
        ret = cost_model.retention_days
        csum = np.concatenate(
            [np.zeros((len(ingest_mb), 1)), np.cumsum(ingest_mb, axis=1)],
            axis=1)
        lo = np.maximum(np.arange(DAYS_PER_YEAR) + 1 - ret, 0)
        stored_mb = csum[:, 1:] - csum[:, lo]
        net_k = ingest_mb.sum(axis=1) * cost_model.network_usd_per_mb
        stor_k = (stored_mb / 1024.0).sum(axis=1) \
            * cost_model.storage_usd_per_gb_day
        net, stor = net_k[load_index], stor_k[load_index]

    return [
        GridSummary(
            name=names[i], twin=twins[i],
            total_cost_usd=float(sum_cost[i] + backlog_cost[i]),
            backlog_s=float(backlog_s[i]),
            backlog_cost_usd=float(backlog_cost[i]),
            mean_throughput_rph=float(sum_proc[i] / t_bins / bin_hours),
            max_throughput_rph=float(maxp[i] / bin_hours),
            median_latency_s=float(median[i]),
            mean_latency_s=float(mean_lat[i]),
            pct_latency_met=float(pct_rec[i]),
            pct_hours_met=float(pct_hours[i]),
            slo_met=None if met is None else bool(met[i]),
            network_cost_usd=float(net[i]),
            storage_cost_usd=float(stor[i]),
            dropped_records=float(sum_drop[i]),
            p95_latency_s=float(p95[i]),
            p99_latency_s=float(p99[i]),
            processed_records=float(sum_proc[i]),
            arrived_records=float(sum_load[i]),
            queue_end=float(q_end[i]),
            latency_hist=hist[i],
            fault_hours=float(fault_hours[i]),
            pct_hours_met_in_fault=float(pct_in[i]),
            pct_hours_met_outside_fault=float(pct_out[i]))
        for i in range(n)
    ]


def storage_costs(hourly_load: np.ndarray, cost_model: CostModel,
                  record_mb: float) -> Dict[str, np.ndarray]:
    """Daily rolling-retention storage + network costs (Table IV)."""
    daily_records = hourly_load.reshape(DAYS_PER_YEAR, 24).sum(axis=1)
    ingest_mb = daily_records * record_mb
    ret = cost_model.retention_days
    # stored_mb[d] = sum of ingest over the trailing retention window
    csum = np.concatenate([[0.0], np.cumsum(ingest_mb)])
    lo = np.maximum(np.arange(DAYS_PER_YEAR) + 1 - ret, 0)
    stored_mb = csum[1:] - csum[lo]
    return {
        "ingest_mb": ingest_mb,
        "stored_gb": stored_mb / 1024.0,
        "network_usd": ingest_mb * cost_model.network_usd_per_mb,
        "storage_usd": stored_mb / 1024.0 * cost_model.storage_usd_per_gb_day,
    }


def monthly_table(sim: SimulationResult, cost_model: CostModel,
                  record_mb: float) -> List[Dict[str, float]]:
    """Monthly cloud/network/storage breakdown (Table IV rows)."""
    daily = storage_costs(sim.load, cost_model, record_mb)
    rows = []
    day0 = 0
    hourly_cost = sim.cost_usd
    for m, nd in enumerate(MONTH_DAYS):
        days = slice(day0, day0 + nd)
        hours = slice(day0 * 24, (day0 + nd) * 24)
        cloud = float(hourly_cost[hours].sum())
        net = float(daily["network_usd"][days].sum())
        stor = float(daily["storage_usd"][days].sum())
        rows.append({"month": m + 1, "cloud_usd": cloud, "network_usd": net,
                     "storage_usd": stor, "total_usd": cloud + net + stor})
        day0 += nd
    return rows
