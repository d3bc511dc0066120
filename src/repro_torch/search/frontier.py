"""Cost-vs-SLO Pareto frontier: the price of tightening an SLO.

Counterpart: ``repro.search.frontier``. ``pareto_frontier`` runs one
policy search per SLO target — but not one gradient loop per target:
all M targets x K restarts x S scenarios are lanes of the same loop (the
per-restart ``slo_limit_k`` operand is exactly the hook the loop exposes
for this). Each target's candidates are then re-checked through the
bit-exact aggregate grid, and the frontier is assembled tightest target
first, carrying the best feasible configuration forward: a configuration
feasible at a tight SLO is feasible at every looser one, so the quoted
cost is non-increasing as the SLO loosens by construction.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.config import OptimizerConfig
from repro_torch.core.slo import SLO
from repro_torch.core.twin import AGG_SLO_DROP_RATE, AGG_SLO_LATENCY, Twin
from repro_torch.device import resolve_device
from repro_torch.search.objective import annual_scale
from repro_torch.search.optimize import (DEFAULT_PENALTY_WEIGHT,
                                         DEFAULT_SEARCH_OPT, _as_loads,
                                         _coarsen, _norm_weights,
                                         _restart_devices, _run_kernel,
                                         evaluate_exact)
from repro_torch.search.space import SearchSpace, default_space


@dataclass
class FrontierPoint:
    """One SLO target on the frontier."""
    limit_s: float
    cost_usd: float                # exact annual cost (inf if infeasible)
    feasible: bool
    twin: Optional[Twin]
    pct_met: float                 # worst-scenario exact compliance
    p95_latency_s: float = 0.0
    p99_latency_s: float = 0.0
    config: Dict[str, float] = None     # the searched parameters


@dataclass
class Frontier:
    """The assembled cost-vs-SLO curve (tightest target first)."""
    policy: str
    metric: str
    met_fraction: float
    points: List[FrontierPoint]

    def rows(self) -> List[Dict]:
        """Table rows: the price of each SLO tightening step."""
        rows = []
        prev_cost = None
        for p in self.points:
            rows.append({
                "slo_limit": p.limit_s,
                "feasible": p.feasible,
                "cost_usd": round(p.cost_usd, 2) if p.feasible else None,
                "tightening_premium_usd":
                    None if (prev_cost is None or not p.feasible)
                    else round(prev_cost - p.cost_usd, 2),
                "latency_p95_s": round(p.p95_latency_s, 2),
                "config": ", ".join(
                    f"{k}={v:g}" for k, v in (p.config or {}).items())
                    or "-",
            })
            if p.feasible:
                prev_cost = p.cost_usd
        return rows


def pareto_frontier(space_or_base: Union[SearchSpace, Twin],
                    traffics=None,
                    slo_limits: Sequence[float] = (),
                    *, metric: str = "latency",
                    met_fraction: float = 0.95,
                    loads: Optional[np.ndarray] = None,
                    bin_hours: Optional[float] = None,
                    restarts: int = 6, steps: int = 120, seed: int = 0,
                    scenario_weights: Optional[Sequence[float]] = None,
                    opt: Optional[OptimizerConfig] = None,
                    penalty_weight: float = DEFAULT_PENALTY_WEIGHT,
                    met_margin: float = 0.005,
                    coarsen: int = 1,
                    devices: Optional[int] = None,
                    device="cuda") -> Frontier:
    """Sweep the SLO limit and return the cost to serve at each target.

    All ``len(slo_limits) * restarts`` searches are lanes of ONE gradient
    loop (the SLO limit is a per-restart operand), recorded as one
    ``search.kernel`` span; the per-target exact re-checks and the
    monotone assembly happen on the host. Targets are processed tightest
    first regardless of input order; the returned points follow that
    order. ``device`` and ``devices`` as in ``search`` (default
    ``"cuda"``; ``devices=D`` splits the M*K restarts over D ranks).
    """
    if len(slo_limits) == 0:
        raise ValueError("pareto_frontier needs at least one SLO limit")
    _restart_devices(devices)
    resolve_device(device)
    space = space_or_base if isinstance(space_or_base, SearchSpace) \
        else default_space(space_or_base)
    loads_np, bin_hours, _ = _as_loads(traffics, loads, bin_hours)
    scen_w = _norm_weights(scenario_weights, loads_np.shape[0])
    horizon = annual_scale(loads_np.shape[1], bin_hours)
    slo_mode = (AGG_SLO_DROP_RATE if metric == "drop_rate"
                else AGG_SLO_LATENCY)

    limits = np.sort(np.asarray(slo_limits, np.float64))   # tightest first
    m, k = len(limits), restarts

    base_cost, _, _, _ = evaluate_exact(
        [space.base], loads_np, bin_hours, None, scen_w, horizon,
        device=device)

    g_loads, g_bin = _coarsen(loads_np, bin_hours, int(coarsen))
    g_horizon = annual_scale(g_loads.shape[1], g_bin)
    ocfg = dataclasses.replace(opt or DEFAULT_SEARCH_OPT, total_steps=steps)
    # M targets x K restarts = M*K restarts of one loop: the same starts
    # per target, each block penalised against its own limit
    p_fin, _ = _run_kernel(
        space, g_loads, g_bin, scen_w, np.tile(space.z0(k, seed), (m, 1)),
        np.repeat(limits, k), slo_mode,
        min(met_fraction + met_margin, 1.0), penalty_weight,
        max(base_cost[0], 1.0), g_horizon, steps, ocfg, devices=devices,
        device=device)
    p_fin = p_fin.reshape(m, k, -1)

    points: List[FrontierPoint] = []
    carry_twin: Optional[Twin] = None
    for j, limit in enumerate(limits):
        slo = SLO(metric=metric, limit_s=float(limit),
                  met_fraction=met_fraction)
        cands = [space.twin(p_fin[j, i], f"{space.policy}-L{j}-c{i}")
                 for i in range(k)]
        # monotone assembly: a configuration feasible at a TIGHTER limit
        # is feasible here too, so the tighter winner competes in this
        # target's exact re-check (its compliance re-measured against
        # this limit) and the quoted cost can only fall as the SLO
        # loosens
        if carry_twin is not None:
            cands.append(carry_twin)
        cost, feas, pct, rows = evaluate_exact(
            cands, loads_np, bin_hours, slo, scen_w, horizon, device=device)
        cost = np.where(np.isfinite(cost), cost, np.inf)
        pct = np.nan_to_num(pct, nan=0.0)
        if feas.any():
            best = int(np.where(feas, cost, np.inf).argmin())
            pt = FrontierPoint(
                limit_s=float(limit), cost_usd=float(cost[best]),
                feasible=True, twin=cands[best], pct_met=float(pct[best]),
                p95_latency_s=max(r.p95_latency_s for r in rows[best]),
                p99_latency_s=max(r.p99_latency_s for r in rows[best]),
                config={n: float(cands[best].param(n))
                        for n in space.free_names})
            carry_twin = cands[best]
        else:
            best = int(pct.argmax())
            pt = FrontierPoint(
                limit_s=float(limit), cost_usd=float("inf"),
                feasible=False, twin=None, pct_met=float(pct[best]))
        points.append(pt)
    return Frontier(policy=space.policy, metric=metric,
                    met_fraction=met_fraction, points=points)
