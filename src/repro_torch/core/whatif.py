"""What-if scenario engine (paper Sec. VII) on the port: run (twin x
traffic) grids, compare retention policies, and render Table II / Table IV
style results.

Counterpart: ``repro.core.whatif``. ``run_grid`` holds each traffic's
[8736] load row once in a [K, T] load matrix with an [N] index map and
runs the whole grid through ``simulate_grid`` — on the card by default
(``device="cuda"``), through the plain PyTorch versions with
``device="cpu"``. Aggregate mode (``GridSummary`` rows) is the default;
``return_series=True`` returns full ``SimulationResult`` series.

``calibrated_grid`` closes the paper's loop end to end: it gradient-fits
one twin per requested policy to a measured ``ExperimentResult`` (or a
prebuilt ``ObservedTrace``) through ``repro_torch.calibrate`` and plays
the fitted twins through the Table II grid — measurement in, scenario
table out. ``optimize_scenario`` is the inverse of ``run_grid``: the
cheapest configuration of a twin's policy that meets an SLO, through
``repro_torch.search``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost import CostModel
from repro_torch.core.simulate import (GridSummary, SimulationResult,
                                       monthly_table, simulate_grid,
                                       simulate_year)
from repro_torch.core.slo import SLO
from repro_torch.core.traffic import TrafficModel
from repro_torch.core.twin import Twin

#: what grid runners return: per-bin series or streaming-aggregate scalars
GridResult = Union[SimulationResult, GridSummary]


@dataclass(frozen=True)
class Scenario:
    name: str
    twin: Twin
    traffic: TrafficModel


def run_grid(twins: Sequence[Twin], traffics: Sequence[TrafficModel],
             slo: Optional[SLO] = None,
             cost_model: Optional[CostModel] = None,
             record_mb: float = 0.0, *,
             return_series: bool = False,
             scenario_block: Optional[int] = None,
             devices: Optional[int] = None,
             faults=None, device="cuda") -> List[GridResult]:
    """Every (traffic x twin) combination — the paper's Table II grid —
    simulated in one launch over the (load matrix, index map) batch; rows
    named ``"{traffic} {twin}"``, traffic-major."""
    if not twins or not traffics:
        return []
    load_matrix = np.stack([tr.hourly_loads() for tr in traffics])
    load_index = np.repeat(np.arange(len(traffics), dtype=np.int32),
                           len(twins))
    grid_twins = [tw for _ in traffics for tw in twins]
    names = [f"{tr.name} {tw.name}" for tr in traffics for tw in twins]
    return simulate_grid(grid_twins, names=names, slo=slo,
                         cost_model=cost_model, record_mb=record_mb,
                         return_series=return_series,
                         load_matrix=load_matrix, load_index=load_index,
                         scenario_block=scenario_block, devices=devices,
                         faults=faults, device=device)


def calibrated_grid(source, policies: Sequence[str],
                    traffics: Sequence[TrafficModel],
                    slo: Optional[SLO] = None,
                    cost_model: Optional[CostModel] = None,
                    record_mb: float = 0.0,
                    bin_s: float = 1.0, device="cuda",
                    **fit_kwargs) -> List[GridResult]:
    """Measured pipeline -> fitted twins -> Table II grid, in one call.

    ``source`` is an ``ExperimentResult`` or a
    ``repro_torch.calibrate.ObservedTrace``; one twin is calibrated per
    entry of ``policies`` (extra kwargs forward to
    ``repro_torch.calibrate.fit``), then the whole (traffic x fitted twin)
    grid runs through ``run_grid`` — fits and grid on ``device``."""
    from repro_torch.calibrate import calibrated_twin   # late: calibrate
    twins = [calibrated_twin(source, policy, bin_s=bin_s,  # sits above core
                             name=f"{policy}-cal", device=device,
                             **fit_kwargs)
             for policy in policies]
    return run_grid(twins, traffics, slo=slo, cost_model=cost_model,
                    record_mb=record_mb, device=device)


def optimize_scenario(base: Twin, traffics, slo: Optional[SLO] = None,
                      *, search: Optional[Sequence[str]] = None,
                      bounds: Optional[Dict] = None,
                      tie: Optional[Dict] = None,
                      **search_kwargs):
    """The inverse of ``run_grid``: the cheapest configuration, not a
    table.

    Searches ``base``'s policy for the cheapest parameter setting that
    meets ``slo`` on every traffic scenario — gradient descent on the
    smooth annual-cost objective (``repro_torch.search``), all restarts x
    scenarios as lanes of one gradient loop, feasibility re-checked
    through the bit-exact aggregate grid. ``search`` names the free
    parameters (default: the policy's extras, or priced capacity for
    extra-less policies); ``bounds``/``tie`` refine the space; remaining
    kwargs (``restarts``, ``steps``, ``coarsen``, ``faults=`` with
    ``quantile=`` for the chance-constrained variant, ``device=``, ...)
    forward to ``repro_torch.search.search``. Returns a
    ``repro_torch.search.SearchResult`` whose ``.twin`` drops straight
    into ``run_grid`` / ``table2_rows``."""
    from repro_torch.search import search as _search     # late: search
    from repro_torch.search import search_space          # sits above core
    space = search_space(base, search, bounds=bounds, tie=tie)
    return _search(space, traffics, slo, **search_kwargs)


def run_scenarios(scenarios: Sequence[Scenario],
                  slo: Optional[SLO] = None,
                  cost_model: Optional[CostModel] = None,
                  record_mb: float = 0.0, *,
                  return_series: bool = False,
                  scenario_block: Optional[int] = None,
                  devices: Optional[int] = None,
                  device="cuda") -> List[GridResult]:
    """Arbitrary named (twin, traffic) pairs, batched like ``run_grid``
    (the load matrix holds each distinct traffic object once)."""
    if not scenarios:
        return []
    row_of: Dict[int, int] = {}
    rows: List[np.ndarray] = []
    load_index = np.empty(len(scenarios), np.int32)
    for i, s in enumerate(scenarios):
        key = id(s.traffic)
        if key not in row_of:
            row_of[key] = len(rows)
            rows.append(s.traffic.hourly_loads())
        load_index[i] = row_of[key]
    return simulate_grid([s.twin for s in scenarios],
                         names=[s.name for s in scenarios], slo=slo,
                         cost_model=cost_model, record_mb=record_mb,
                         return_series=return_series,
                         load_matrix=np.stack(rows), load_index=load_index,
                         scenario_block=scenario_block, devices=devices,
                         device=device)


def table2_rows(sims: Sequence[GridResult]) -> List[Dict]:
    # chaos-suite grids grow three attribution columns; benign tables keep
    # the seed's exact column set
    fault_cols = any(getattr(s, "fault_hours", 0.0) > 0.0 for s in sims)
    rows = []
    for s in sims:
        row = {
            "run": s.name,
            "policy": s.twin.policy,
            "cost_usd": round(s.total_cost_usd, 2),
            "latency_median_s": round(s.median_latency_s, 2),
            "latency_p95_s": round(s.p95_latency_s, 2),
            "latency_p99_s": round(s.p99_latency_s, 2),
            "latency_mean_s": round(s.mean_latency_s, 2),
            "latency_backlog_s": round(s.backlog_s, 2),
            "thruput_mean_rph": round(s.mean_throughput_rph, 2),
            "thruput_max_rph": round(s.max_throughput_rph, 2),
            "dropped": round(s.dropped_records, 1),
            "pct_latency_met": round(s.pct_latency_met, 2),
            "slo_met": s.slo_met,
        }
        if fault_cols:
            row["fault_hours"] = round(getattr(s, "fault_hours", 0.0), 1)
            row["pct_hours_met_in_fault"] = round(
                getattr(s, "pct_hours_met_in_fault", 100.0), 2)
            row["pct_hours_met_outside_fault"] = round(
                getattr(s, "pct_hours_met_outside_fault", 100.0), 2)
        rows.append(row)
    return rows


def retention_whatif(twin: Twin, traffic: TrafficModel, record_mb: float,
                     retentions_days: Sequence[int] = (91, 182),
                     cost_model: Optional[CostModel] = None,
                     slo: Optional[SLO] = None,
                     device="cuda") -> Dict[int, List[Dict]]:
    """The paper's 3-month vs 6-month retention comparison (Table IV)."""
    cm = cost_model or CostModel()
    loads = traffic.hourly_loads()
    out = {}
    for ret in retentions_days:
        cmr = replace(cm, retention_days=ret)
        sim = simulate_year(twin, loads, slo=slo, cost_model=cmr,
                            record_mb=record_mb,
                            name=f"{traffic.name} {twin.name} ret{ret}",
                            device=device)
        out[ret] = monthly_table(sim, cmr, record_mb)
    return out
