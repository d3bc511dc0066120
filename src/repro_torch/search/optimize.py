"""Multi-start projected-AdamW policy search, one gradient loop a search.

Counterpart: ``repro.search.optimize``. ``search`` inverts the what-if
simulator for one policy: instead of enumerating configurations and
scanning the Table II grid, it descends the differentiable
annual-cost-plus-SLO-hinge objective (``repro_torch.search.objective``)
over a declarative ``SearchSpace`` and returns the cheapest configuration
that provably meets the SLO — every candidate is re-checked through the
bit-exact aggregate grid (the CUDA aggregate kernels on the card) before
any number is reported.

The optimizer is built like twin calibration's multi-start fit
(``repro_torch.calibrate.fit``): all K restarts x S traffic scenarios (x
F fault futures) are lanes of ONE objective evaluation a step, and each
step is

    the gradient of the lane-block objective  +  AdamW, each restart
    clipped on its own (``optim.adamw_update(lanes=1)``)  +  the ±Z_CLIP
    clip of z

— the body of the reference's ``_search_kernel``. The reference compiles
the whole loop into one XLA program; the port runs the same steps
eagerly, on the card by default (``device=``), with the history and the
last step's diagnostics kept on the device and read back once. There is
no Python loop over restarts, scenarios or futures.

``search_policies`` is the cross-policy tournament: one search per
policy, ranked into a leaderboard (feasible first, then by exact annual
cost). Feasibility failures are never silent: a search whose candidates
all miss the SLO warns with the policy, the achieved vs required
compliance, and any parameters pinned against their search box.

``devices=D`` is the reference's restart mesh over the first D ranks
of the ``torch.distributed`` default group: each rank runs its K/D
restarts through the same gradient loop, every rank gets the candidates
and the history in restart order, and the exact re-checks run on every
rank. The streamed-vs-vectorised objective is decided from the global
K*S*F*T and the backward's schedule is planned for all K
(``policy_vjp.whole_lanes``), so the sharded loop is bitwise the
unsharded one. A K that D does not divide runs unsharded, with the
warn-once replication ``RuntimeWarning``.

With run telemetry on (``repro_torch.obs``) each gradient loop records a
``search.kernel`` span (attrs restarts, scenarios, futures, t_bins,
steps, stream, devices, policy) and the counters
``search.objective_choice{stream,policy}``, ``search.restarts``,
``search.restarts.diverged`` and ``search.restarts.feasible`` per policy;
an infeasible search also counts ``warn.search_infeasible{policy,
pinned}``. None of it changes a searched number.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.calibrate.objective import _softplus, params_from_z
from repro_torch.config import OptimizerConfig
from repro_torch.core.simulate import GridSummary, simulate_grid
from repro_torch.core.slo import SLO
from repro_torch.core.traffic import TrafficModel
from repro_torch.core.twin import (AGG_SLO_DROP_RATE, AGG_SLO_LATENCY,
                                   PARAM_DIM, Twin)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (require_ranks,
                                              resolve_mesh_axis, run_lanes)
from repro_torch.kernels.policy_vjp import whole_lanes
from repro_torch.optim.adamw import adamw_update, init_opt_state
from repro_torch.search.objective import (CHANCE_W, HINGE_S, annual_scale,
                                          lane_objective_t,
                                          lane_objective_vectorized)
from repro_torch.search.space import (Z_CLIP, SearchSpace, apply_ties,
                                      default_space, search_space)

#: AdamW settings for the z-space search: no decay (z=0 is mid-box, not a
#: prior), generous clip, short warmup; total_steps is overwritten with
#: the search's step count so the cosine tail anneals the final approach
#: to the SLO boundary.
DEFAULT_SEARCH_OPT = OptimizerConfig(lr=0.12, betas=(0.9, 0.95), eps=1e-8,
                                     weight_decay=0.0, grad_clip=10.0,
                                     warmup_steps=10, total_steps=200)

#: dollars of penalty per unit of hinged SLO shortfall, in multiples of
#: the base configuration's annual cost: a 1% compliance shortfall costs
#: one full base-year of spend, so feasibility dominates until met
DEFAULT_PENALTY_WEIGHT = 100.0

#: stand-in SLO operands when no SLO constrains the search (sigmoid
#: compliance saturates at 1, the hinge at met_fraction=0 is exactly 0)
_NO_SLO_LIMIT = 1e30

#: lane-bins (global K*S*F*T) above which the gradient loop streams its
#: objective reductions through the scan state instead of materialising
#: the [L, T] series; below it the vectorised hinge is cheaper
_STREAM_MIN_ELEMS = 1 << 21


class SearchInfeasibleWarning(UserWarning):
    """No candidate configuration met the SLO (details in the message)."""


def _search_loop(steps: int, n_scen: int, n_fut: int, dt_hours: float,
                 slo_mode: int, surrogate: bool, ocfg: OptimizerConfig,
                 stream: bool, z0, loads_t, scen_w, box, ties,
                 policy_index: int, slo_limit_k, met_fraction: float,
                 penalty_weight: float, penalty_scale: float,
                 horizon_scale: float, caps_t=None, quantile: float = 1.0):
    """K restarts x S scenarios (x F fault futures), one objective
    evaluation a step.

    z0 [K, PARAM_DIM]; loads_t [T, S*F] scenario-minor (columns
    scenario-major, future-minor); scen_w [S] (normalised); ``box`` the
    (lo, hi, log_mask, free_mask, fixed) and ``ties`` the (tie_src,
    tie_coeff) operands on the device; slo_limit_k [K] per-restart
    limits (a search broadcasts one; the Pareto frontier packs its
    targets here). ``stream`` picks the streamed objective over the
    vectorised one (the caller decides from the global size).

    ``n_fut == 1`` is the plain objective: per restart the
    scenario-weighted sum of the per-lane cost + hinge. With
    ``n_fut > 1`` (``caps_t`` [T, S*F]) it is chance-constrained:
    expected cost over futures plus a hinge on the smoothed probability
    of meeting the SLO falling below ``quantile`` (each future votes
    sigmoid((frac - met) / CHANCE_W)), plus the per-lane penalty gated by
    that shortfall, so deeply infeasible futures still pull.

    Returns (z_fin [K, D], params_fin [K, D], objective [K],
    cost_ann [K, S*F], met_frac [K, S*F], history [steps, K]) on the
    device; the aux triple is the LAST gradient evaluation's (z at step
    ``steps - 1``), carried out of the loop instead of a forward on
    z_fin."""
    k = z0.shape[0]
    n_lanes = n_scen * n_fut
    loads_t_block = loads_t.repeat(1, k)
    caps_t_block = None if caps_t is None else caps_t.repeat(1, k)
    slo_lane = slo_limit_k.repeat_interleave(n_lanes)

    def params_of(z):
        return apply_ties(params_from_z(z, *box), *ties)

    def objective(z):
        pb = params_of(z).repeat_interleave(n_lanes, dim=0)
        args = (dt_hours, policy_index, slo_lane, slo_mode, met_fraction,
                penalty_weight, penalty_scale, horizon_scale)
        if stream:
            per_lane, (cost_ann, frac) = lane_objective_t(
                pb, loads_t_block, *args, surrogate=surrogate,
                caps_t_block=caps_t_block)
        else:
            per_lane, (cost_ann, frac) = lane_objective_vectorized(
                pb, loads_t_block.t(), *args, surrogate=surrogate,
                caps_block=(None if caps_t_block is None
                            else caps_t_block.t()))
        if n_fut == 1:
            per_restart = (per_lane.reshape(k, n_scen) * scen_w).sum(dim=1)
        else:
            cost_sf = cost_ann.reshape(k, n_scen, n_fut)
            frac_sf = frac.reshape(k, n_scen, n_fut)
            exp_cost = (cost_sf.mean(dim=2) * scen_w).sum(dim=1)
            chance = torch.sigmoid((frac_sf - met_fraction)
                                   / CHANCE_W).mean(dim=2)
            # a future exactly ON the met boundary votes 0.5, so the
            # reachable smooth chance tops out half a vote short of the
            # exact count: aim the hinge at that grid
            q_eff = quantile - 0.5 / n_fut
            short = _softplus((q_eff - chance) / HINGE_S) * HINGE_S
            # once futures are deeply infeasible the chance carries no
            # gradient; the per-lane penalty (linear in the violation
            # depth) is the rescue slope, gated by the chance shortfall
            # so the allowed worst futures stop pulling once it is met
            pen_lane = (per_lane - cost_ann).reshape(k, n_scen, n_fut)
            gate = torch.sigmoid((q_eff - chance) / HINGE_S)
            pen = (penalty_weight * penalty_scale * short
                   + gate * pen_lane.mean(dim=2))
            per_restart = exp_cost + (pen * scen_w).sum(dim=1)
        return per_restart, cost_ann.reshape(k, n_lanes), \
            frac.reshape(k, n_lanes)

    z = z0
    opt = init_opt_state({"z": z}, ocfg)
    history = torch.empty((steps, k), dtype=torch.float32, device=z0.device)
    aux = (torch.zeros(k, device=z0.device),
           torch.zeros((k, n_lanes), device=z0.device),
           torch.zeros((k, n_lanes), device=z0.device))
    for i in range(steps):
        with torch.enable_grad():
            zr = z.detach().requires_grad_()
            out = objective(zr)
            (g,) = torch.autograd.grad(out[0].sum(), zr)
        aux = tuple(x.detach() for x in out)
        history[i] = aux[0]
        new, opt = adamw_update({"z": z}, {"z": g}, opt, ocfg, lanes=1)
        # the projection: stay on the live part of the bijection
        z = torch.clamp(new["z"], -Z_CLIP, Z_CLIP)
    return (z, params_of(z)) + aux + (history,)


@dataclass
class SearchResult:
    """Cheapest SLO-feasible configuration plus the evidence trail."""
    policy: str
    space: SearchSpace
    twin: Twin                     # best candidate (feasible when any is)
    cost_usd: float                # exact annual cost of ``twin``
    feasible: bool                 # SLO met on EVERY traffic scenario
    scenario_rows: List[GridSummary]      # twin's bit-exact rows, per scen
    base_cost_usd: float
    base_feasible: bool
    best_restart: int
    restart_params: np.ndarray     # [K, PARAM_DIM]
    restart_costs: np.ndarray      # [K] exact annual cost per restart
    restart_feasible: np.ndarray   # [K] bool
    restart_pct: np.ndarray        # [K] worst-scenario exact SLO pct
    history: np.ndarray            # [steps, K] smooth objective
    slo: Optional[SLO] = None
    # chance-constrained runs (search(faults=..., quantile=q)) only: the
    # target quantile and the winner's exact empirical quantile — the
    # worst scenario's fraction of fault futures meeting the SLO on the
    # bit-exact aggregate re-check. Benign searches report 1.0 / 1.0.
    quantile: float = 1.0
    achieved_quantile: float = 1.0
    n_futures: int = 1

    @property
    def saving_vs_base(self) -> float:
        """Annual dollars saved against the base configuration."""
        return self.base_cost_usd - self.cost_usd

    @property
    def p95_latency_s(self) -> float:
        """Worst-scenario p95 latency of the chosen configuration (off
        the bit-exact aggregate histogram — the p-latency SLO evidence)."""
        return max((r.p95_latency_s for r in self.scenario_rows),
                   default=0.0)

    @property
    def p99_latency_s(self) -> float:
        return max((r.p99_latency_s for r in self.scenario_rows),
                   default=0.0)

    def config(self) -> Dict[str, float]:
        """The searched parameters of the winning configuration."""
        return {n: float(self.twin.param(n))
                for n in self.space.free_names}

    def restart_table(self) -> List[Dict]:
        rows = []
        for i in range(len(self.restart_costs)):
            row = {"restart": i,
                   "cost_usd": round(float(self.restart_costs[i]), 2),
                   "feasible": bool(self.restart_feasible[i]),
                   "pct_met": round(float(self.restart_pct[i]), 3),
                   "best": i == self.best_restart}
            for j, n in enumerate(self.space.param_names):
                if self.space.free_mask[j]:
                    row[n] = round(float(self.restart_params[i, j]), 5)
            rows.append(row)
        return rows

    def leaderboard_row(self) -> Dict:
        return {"policy": self.policy,
                "feasible": self.feasible,
                "cost_usd": round(self.cost_usd, 2),
                "saving_vs_base": round(self.saving_vs_base, 2),
                "latency_p95_s": round(self.p95_latency_s, 2),
                "config": ", ".join(f"{k}={v:g}"
                                    for k, v in self.config().items())}


def _norm_weights(scenario_weights, n_scen: int) -> np.ndarray:
    w = np.asarray(scenario_weights if scenario_weights is not None
                   else np.full(n_scen, 1.0 / n_scen), np.float32)
    if w.shape != (n_scen,):
        raise ValueError(f"scenario_weights has shape {w.shape} for "
                         f"{n_scen} traffic scenarios — one weight per "
                         f"scenario")
    return w / max(w.sum(), 1e-12)


def _restart_devices(devices):
    """Check ``devices=`` before any work (``_run_kernel`` resolves it):
    more than one needs a ``torch.distributed`` group that large."""
    if devices is not None and devices != 1:
        require_ranks(devices, "search(devices=) restart mesh")


def _run_kernel(space: SearchSpace, g_loads: np.ndarray, g_bin: float,
                scen_w: np.ndarray, z0: np.ndarray, slo_limit_k: np.ndarray,
                slo_mode: int, met: float, penalty_weight: float,
                penalty_scale: float, g_horizon: float, steps: int,
                ocfg: OptimizerConfig, *, caps: Optional[np.ndarray] = None,
                n_fut: int = 1, quantile: float = 1.0,
                devices: Optional[int] = None, device="cuda"):
    """Marshal one gradient loop for a space and return ([K, PARAM_DIM]
    finite candidate vectors, [steps, K] history) — diverged restarts
    fall back to the base configuration's vector. Shared by ``search``
    (one SLO limit broadcast over K) and ``pareto_frontier`` (M*K
    lane-packed limits). ``caps`` [S*F, T] + ``n_fut``/``quantile``
    switch to the chance-constrained objective; ``g_loads`` then has S*F
    rows, scenario-major / future-minor. The streamed-vs-vectorised
    choice is made here, from the global K*S*F*T lane-bin count, never
    from a rank's share. ``devices=D`` runs K/D restarts a rank
    (``sharding.run_lanes``)."""
    dev = resolve_device(device)
    d = resolve_mesh_axis(devices, z0.shape[0],
                          "search(devices=) restart mesh") or 1
    stream = (z0.shape[0] * g_loads.shape[0] * g_loads.shape[1]
              >= _STREAM_MIN_ELEMS)

    def put(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    box = tuple(put(a) for a in (space.lo, space.hi, space.log_mask,
                                 space.free_mask, space.fixed))
    obs.count("search.objective_choice", stream=stream, policy=space.policy)
    with obs.span("search.kernel", restarts=z0.shape[0],
                  scenarios=g_loads.shape[0] // int(n_fut),
                  futures=int(n_fut), t_bins=g_loads.shape[1],
                  steps=int(steps), stream=stream, devices=d,
                  policy=space.policy):
        def run(lo, hi):
            with whole_lanes(d):
                out = _search_loop(
                    int(steps), g_loads.shape[0] // int(n_fut), int(n_fut),
                    float(g_bin), int(slo_mode),
                    bool(space.needs_surrogate), ocfg, stream,
                    put(z0[lo:hi], torch.float32),
                    put(g_loads.T, torch.float32),
                    put(scen_w, torch.float32), box,
                    (put(space.tie_src), put(space.tie_coeff)),
                    space.policy_index,
                    put(slo_limit_k[lo:hi], torch.float32), float(met),
                    float(penalty_weight), float(penalty_scale),
                    float(g_horizon),
                    caps_t=None if caps is None else put(caps.T,
                                                         torch.float32),
                    quantile=float(quantile))
            return (out[1].cpu().numpy().astype(np.float64),
                    out[5].cpu().numpy().astype(np.float64))

        if d == 1:
            p_fin, history = run(0, z0.shape[0])
        else:
            p_fin, history = run_lanes(run, z0.shape[0], d, (0, 1))
    bad = ~np.isfinite(p_fin).all(axis=1)
    obs.count("search.restarts", z0.shape[0], policy=space.policy)
    if bad.any():
        obs.count("search.restarts.diverged", int(bad.sum()),
                  policy=space.policy)
        p_fin[bad] = space._resolve(space.base.padded_params())
    return p_fin, history


def _as_loads(traffics, loads, bin_hours):
    if (traffics is None) == (loads is None):
        raise ValueError("pass exactly one of traffics= (TrafficModels) "
                         "or loads= [S, T] with bin_hours=")
    if traffics is not None:
        if isinstance(traffics, TrafficModel):
            traffics = [traffics]
        loads_np = np.stack([tr.hourly_loads() for tr in traffics]) \
            .astype(np.float32)
        return loads_np, 1.0, [tr.name for tr in traffics]
    loads_np = np.asarray(loads, np.float32)
    if loads_np.ndim == 1:
        loads_np = loads_np[None]
    if bin_hours is None:
        raise ValueError("raw loads= need bin_hours=")
    return loads_np, float(bin_hours), \
        [f"scenario{i}" for i in range(len(loads_np))]


def achieved_quantile(rows: Sequence[GridSummary], n_scen: int,
                      n_fut: int) -> float:
    """Worst-scenario fraction of fault futures whose exact re-check met
    the SLO — the empirical quantile a chance-constrained candidate
    achieves. ``rows`` is one candidate's [S*F] rows, scenario-major /
    future-minor."""
    met = np.array([bool(r.slo_met) for r in rows], bool) \
        .reshape(n_scen, n_fut)
    return float(met.mean(axis=1).min())


def evaluate_exact(twins: Sequence[Twin], loads_np: np.ndarray,
                   bin_hours: float, slo: Optional[SLO],
                   scen_w: np.ndarray, horizon_scale: float, *,
                   faults=None, quantile: float = 1.0, device="cuda"
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              List[List[GridSummary]]]:
    """Bit-exact candidate scoring through the aggregate grid.

    Every (candidate x scenario) pair runs as one aggregate-mode
    ``simulate_grid`` launch on ``device`` (the aggregate kernels on the
    card); a candidate is feasible only when the SLO holds on EVERY
    scenario (``GridSummary.slo_met``, the exact counters, with the
    histogram p95/p99 riding along). Returns (annual_cost [C],
    feasible [C], worst_pct [C], rows [C][S]).

    ``faults=`` (a ``repro_torch.faults.SampledFaults`` or
    ``FaultSchedule``) re-checks every candidate across the F fault
    futures: rows come back [C][S*F], scenario-major / future-minor;
    cost becomes the scenario-weighted expected cost over futures, and
    feasibility ``achieved_quantile(rows) >= quantile``."""
    c, s = len(twins), loads_np.shape[0]
    grid_twins = [tw for tw in twins for _ in range(s)]
    load_index = np.tile(np.arange(s, dtype=np.int32), c)
    names = [f"{tw.name}@s{j}" for tw in twins for j in range(s)]
    rows = simulate_grid(grid_twins, names=names, slo=slo,
                         bin_hours=bin_hours, return_series=False,
                         load_matrix=loads_np, load_index=load_index,
                         faults=faults, device=device)
    f = len(rows) // (c * s) if c and s else 1
    per = s * f
    rows_by_cand = [rows[i * per:(i + 1) * per] for i in range(c)]
    w_sf = np.repeat(np.asarray(scen_w, np.float64), f) / f
    cost = np.array([sum(w * r.total_cost_usd
                         for w, r in zip(w_sf, rr)) * horizon_scale
                     for rr in rows_by_cand])
    if slo is None:
        feas = np.ones(c, bool)
        pct = np.full(c, 100.0)
    elif faults is not None and f > 1:
        aq = np.array([achieved_quantile(rr, s, f) for rr in rows_by_cand])
        feas = aq >= float(quantile) - 1e-9
        pct = np.array([min(r.pct_latency_met for r in rr)
                        for rr in rows_by_cand])
    else:
        feas = np.array([all(r.slo_met for r in rr)
                         for rr in rows_by_cand])
        pct = np.array([min(r.pct_latency_met for r in rr)
                        for rr in rows_by_cand])
    return cost, feas, pct, rows_by_cand


def _coarsen(loads_np: np.ndarray, bin_hours: float, factor: int):
    """Sum groups of ``factor`` bins for the gradient loop (the policy
    steps are bin-width aware, so dt simply grows); the exact re-check
    always runs on the original bins."""
    if factor <= 1:
        return loads_np, bin_hours
    t = loads_np.shape[1] // factor * factor
    coarse = loads_np[:, :t].reshape(loads_np.shape[0], -1, factor) \
        .sum(axis=2)
    return np.ascontiguousarray(coarse, np.float32), bin_hours * factor


def _coarsen_caps(caps: np.ndarray, factor: int) -> np.ndarray:
    """Mean-coarsen a capacity-multiplier series (loads SUM per coarse
    bin, multipliers AVERAGE — an outage covering half a coarse bin is a
    50% brownout at that scale). A gradient-guide approximation; the
    exact re-check replays the original bins."""
    if factor <= 1:
        return caps
    t = caps.shape[1] // factor * factor
    coarse = caps[:, :t].reshape(caps.shape[0], -1, factor).mean(axis=2)
    return np.ascontiguousarray(coarse, np.float32)


def _bounds_diagnosis(space: SearchSpace, params: np.ndarray) -> List[str]:
    """Free parameters pinned against their search box (within 0.5% of an
    edge, in the parameter's own fit scale — log for log-fitted ones):
    the actionable half of an infeasibility report."""
    pinned = []
    for i, n in enumerate(space.param_names):
        if not space.free_mask[i]:
            continue
        lo, hi = float(space.lo[i]), float(space.hi[i])
        if not (np.isfinite(hi) and hi > lo):
            continue
        v = float(params[i])
        if space.log_mask[i] and lo > 0:
            frac = (np.log(max(v, 1e-300)) - np.log(lo)) \
                / max(np.log(hi) - np.log(lo), 1e-12)
        else:
            frac = (v - lo) / (hi - lo)
        if frac <= 0.005:
            pinned.append(f"{n}={v:g} at lower bound {lo:g}")
        elif frac >= 0.995:
            pinned.append(f"{n}={v:g} at upper bound {hi:g}")
    return pinned


def _box_pos(space: SearchSpace, p: np.ndarray) -> np.ndarray:
    """Free coords of ``p`` as normalised positions in their boxes (log
    scale where the space fits the exponent)."""
    u = np.zeros(PARAM_DIM)
    for i in np.where(space.free_mask)[0]:
        lo, hi = float(space.lo[i]), float(space.hi[i])
        if space.log_mask[i] and lo > 0:
            u[i] = (np.log(max(p[i], lo)) - np.log(lo)) \
                / max(np.log(hi) - np.log(lo), 1e-12)
        else:
            u[i] = (p[i] - lo) / max(hi - lo, 1e-12)
    return np.clip(u, 0.0, 1.0)


def _box_params(space: SearchSpace, p_base: np.ndarray,
                u: np.ndarray) -> np.ndarray:
    """Inverse of ``_box_pos``: a full parameter vector from normalised
    free coords (ties re-applied). Positions 0/1 land on the box edges
    EXACTLY — the one thing the sigmoid reparameterisation cannot do."""
    p = p_base.astype(np.float64).copy()
    for i in np.where(space.free_mask)[0]:
        lo, hi = float(space.lo[i]), float(space.hi[i])
        if space.log_mask[i] and lo > 0:
            p[i] = lo * (hi / lo) ** u[i]
        else:
            p[i] = lo + u[i] * (hi - lo)
    return space._resolve(p)


def _polish_ladder(space: SearchSpace, p_best: np.ndarray,
                   span: float) -> np.ndarray:
    """[C, PARAM_DIM] polish candidates around the incumbent: per free
    coordinate, +-span * (1, 1/2, 1/4, 1/8) steps in normalised box
    position plus the two exact box edges; incumbent first."""
    u0 = _box_pos(space, p_best)
    offs = np.array([span, -span, span / 2, -span / 2,
                     span / 4, -span / 4, span / 8, -span / 8])
    cands = [space._resolve(p_best)]
    for j in np.where(space.free_mask)[0]:
        for target in list(np.clip(u0[j] + offs, 0.0, 1.0)) + [0.0, 1.0]:
            u = u0.copy()
            u[j] = target
            cands.append(_box_params(space, p_best, u))
    return np.stack(cands)


def _sampled_faults(faults, t_bins: int, bin_hours: float, quantile: float):
    """``faults=`` as SampledFaults (None without a schedule)."""
    if faults is None:
        return None
    from repro_torch.faults import (FaultSchedule, SampledFaults,
                                    sample_futures)
    if isinstance(faults, FaultSchedule):
        sampled = sample_futures(faults, t_bins, bin_hours)
    elif isinstance(faults, SampledFaults):
        sampled = faults
    else:
        raise TypeError(f"faults= must be a repro_torch.faults."
                        f"FaultSchedule or SampledFaults, got "
                        f"{type(faults).__name__}")
    if not 0.0 < quantile <= 1.0:
        raise ValueError(f"quantile must be in (0, 1], got {quantile}")
    return sampled


def search(space_or_base: Union[SearchSpace, Twin],
           traffics=None, slo: Optional[SLO] = None, *,
           loads: Optional[np.ndarray] = None,
           bin_hours: Optional[float] = None,
           restarts: int = 8, steps: int = 120, seed: int = 0,
           scenario_weights: Optional[Sequence[float]] = None,
           opt: Optional[OptimizerConfig] = None,
           penalty_weight: float = DEFAULT_PENALTY_WEIGHT,
           met_margin: float = 0.002,
           coarsen: int = 1,
           polish_rounds: int = 3,
           search_params: Optional[Sequence[str]] = None,
           faults=None, quantile: float = 1.0,
           devices: Optional[int] = None, device="cuda") -> SearchResult:
    """Find the cheapest configuration of one policy that meets ``slo``.

    ``space_or_base`` is a ``SearchSpace`` (full control) or a base
    ``Twin`` (the policy's ``default_space`` — or ``search_params`` —
    around it). Traffic comes as ``traffics=`` TrafficModels (hourly year
    rows) or raw ``loads=`` [S, T] with ``bin_hours=``. All K
    ``restarts`` x S scenarios are lanes of one gradient loop;
    ``coarsen`` sums that many bins per gradient-loop bin (the exact
    re-check always uses the original bins). ``met_margin`` tightens the
    smooth objective's compliance target slightly so candidates land on
    the feasible side of the boundary the exact re-check draws;
    ``polish_rounds`` batched coordinate-ladder refinements around the
    winner (each one exact aggregate launch, the span quartering per
    round) then walk it onto that exact boundary.

    ``faults=`` (a ``repro_torch.faults.FaultSchedule`` or
    ``SampledFaults``) makes the search chance-constrained: every
    (restart x scenario) lane fans out over the schedule's F fault
    futures, the objective becomes expected annual cost over futures
    plus a smooth-quantile hinge, and a candidate is feasible when the
    bit-exact re-check meets the SLO in at least ``quantile`` of the
    futures on every scenario (``SearchResult.achieved_quantile``).

    ``device`` is ``"cuda"`` (default; raises without a card) or
    ``"cpu"``: the gradient loop and every exact re-check run there. On
    the card the re-check runs through the CUDA aggregate kernels, a
    policy added with ``register_policy`` as its translated step (see
    ``kernels/lane_codegen.py``). ``devices=D`` splits the restarts over
    D ranks (see the module docstring); it raises ``ValueError`` without
    a ``torch.distributed`` group of at least D ranks.
    """
    _restart_devices(devices)
    resolve_device(device)
    if isinstance(space_or_base, SearchSpace):
        space = space_or_base
    elif search_params is not None:
        space = search_space(space_or_base, search_params)
    else:
        space = default_space(space_or_base)
    loads_np, bin_hours, _ = _as_loads(traffics, loads, bin_hours)
    s = loads_np.shape[0]
    scen_w = _norm_weights(scenario_weights, s)
    horizon = annual_scale(loads_np.shape[1], bin_hours)
    sampled = _sampled_faults(faults, loads_np.shape[1], bin_hours,
                              quantile)
    n_fut = 1 if sampled is None else sampled.n_futures

    def exact(twins):
        return evaluate_exact(twins, loads_np, bin_hours, slo, scen_w,
                              horizon, faults=sampled, quantile=quantile,
                              device=device)

    # the base configuration's exact cost anchors the penalty scale and
    # the "what did the search buy us" delta
    base_cost, base_feas, _, _ = exact([space.base])

    if slo is None:
        slo_mode, slo_limit, met = AGG_SLO_LATENCY, _NO_SLO_LIMIT, 0.0
    else:
        slo_mode = (AGG_SLO_DROP_RATE if slo.metric == "drop_rate"
                    else AGG_SLO_LATENCY)
        slo_limit = float(slo.limit_s)
        met = min(float(slo.met_fraction) + met_margin, 1.0)

    if sampled is not None:
        # the gradient loop's lanes fan out over the futures: each
        # scenario's F perturbed load rows (reconnect floods baked in),
        # with the matching capacity series
        grad_loads = np.stack([sampled.apply_loads(r) for r in loads_np]) \
            .reshape(s * n_fut, -1).astype(np.float32)
        grad_caps = np.tile(np.asarray(sampled.cap, np.float32), (s, 1))
    else:
        grad_loads, grad_caps = loads_np, None

    g_loads, g_bin = _coarsen(grad_loads, bin_hours, int(coarsen))
    g_caps = (None if grad_caps is None
              else _coarsen_caps(grad_caps, int(coarsen)))
    g_horizon = annual_scale(g_loads.shape[1], g_bin)
    ocfg = dataclasses.replace(opt or DEFAULT_SEARCH_OPT, total_steps=steps)
    p_fin, history = _run_kernel(
        space, g_loads, g_bin, scen_w, space.z0(restarts, seed),
        np.full((restarts,), slo_limit), slo_mode, met, penalty_weight,
        max(base_cost[0], 1.0), g_horizon, steps, ocfg,
        caps=g_caps, n_fut=n_fut, quantile=quantile, devices=devices,
        device=device)
    cand_twins = [space.twin(p_fin[i], f"{space.policy}-cand{i}")
                  for i in range(restarts)]
    cost, feas, pct, rows = exact(cand_twins)
    cost = np.where(np.isfinite(cost), cost, np.inf)
    pct = np.nan_to_num(pct, nan=0.0)
    obs.count("search.restarts.feasible", int(feas.sum()),
              policy=space.policy)

    if feas.any():
        best = int(np.where(feas, cost, np.inf).argmin())
        feasible = True
        # polish: batched coordinate ladders around the winner (the exact
        # box edges included), scored through the same exact aggregate
        # path — one launch per round, the span quartering. This walks
        # the configuration onto the exact SLO boundary the smooth hinge
        # can only approach, and onto box-edge optima the sigmoid
        # reparameterisation can only approach
        p_best = p_fin[best].copy()
        best_cost = float(cost[best])
        best_twin, best_rows = cand_twins[best], rows[best]
        span = 0.5
        for _ in range(int(polish_rounds) if space.num_free else 0):
            p_c = _polish_ladder(space, p_best, span)
            twins_c = [space.twin(p_c[i], f"{space.policy}-pol{i}")
                       for i in range(len(p_c))]
            c_c, f_c, _, r_c = exact(twins_c)
            c_c = np.where(f_c & np.isfinite(c_c), c_c, np.inf)
            i_c = int(c_c.argmin())
            if c_c[i_c] < best_cost:
                best_cost = float(c_c[i_c])
                best_twin, best_rows = twins_c[i_c], r_c[i_c]
                p_best = p_c[i_c]
            span /= 4.0
        cand_twins[best] = best_twin
        rows[best] = best_rows
        cost[best] = best_cost
        p_fin[best] = best_twin.padded_params()
    else:
        best = int(pct.argmax())       # closest to compliance
        feasible = False
        desc = (f"{slo.metric} <= {slo.limit_s:g} in "
                f"{slo.met_fraction:.0%} of records" if slo is not None
                else "unconstrained")
        if sampled is not None:
            desc += (f", in >= {quantile:.0%} of {n_fut} fault futures "
                     f"per scenario")
        pins = _bounds_diagnosis(space, p_fin[best])
        obs.event("warn.search_infeasible", policy=space.policy,
                  pinned=bool(pins))
        warnings.warn(
            f"{space.policy} search found NO feasible configuration for "
            f"SLO ({desc}): best candidate reaches "
            f"{pct[best]:.2f}% compliance (needs "
            f"{(slo.met_fraction if slo else 0) * 100:.2f}%)"
            + (f"; pinned against the search box: {'; '.join(pins)} — "
               f"widen bounds= on those parameters or relax the SLO"
               if pins else
               "; no parameter is pinned at its bound — this policy "
               "likely cannot meet the SLO on this traffic at any "
               "configuration in the space"),
            SearchInfeasibleWarning, stacklevel=2)

    aq = 1.0
    if sampled is not None and slo is not None:
        aq = achieved_quantile(rows[best], s, n_fut)
    return SearchResult(
        policy=space.policy, space=space,
        twin=dataclasses.replace(cand_twins[best],
                                 name=f"{space.policy}-opt"),
        cost_usd=float(cost[best]), feasible=feasible,
        scenario_rows=rows[best],
        base_cost_usd=float(base_cost[0]), base_feasible=bool(base_feas[0]),
        best_restart=best, restart_params=p_fin,
        restart_costs=cost, restart_feasible=feas, restart_pct=pct,
        history=history, slo=slo,
        quantile=float(quantile) if sampled is not None else 1.0,
        achieved_quantile=float(aq), n_futures=n_fut)


@dataclass
class TournamentResult:
    """Ranked cross-policy search results (feasible first, then cost)."""
    results: List[SearchResult] = field(default_factory=list)

    @property
    def best(self) -> SearchResult:
        return self.ranked()[0]

    def ranked(self) -> List[SearchResult]:
        return sorted(self.results,
                      key=lambda r: (not r.feasible, r.cost_usd))

    def leaderboard_rows(self) -> List[Dict]:
        rows = []
        best_cost = self.best.cost_usd
        for i, r in enumerate(self.ranked()):
            row = {"rank": i + 1}
            row.update(r.leaderboard_row())
            row["vs_winner_usd"] = round(r.cost_usd - best_cost, 2)
            rows.append(row)
        return rows


def search_policies(bases: Sequence[Twin], traffics=None,
                    slo: Optional[SLO] = None, *,
                    search_params: Optional[Dict[str, Sequence[str]]] = None,
                    spaces: Optional[Sequence[SearchSpace]] = None,
                    **kwargs) -> TournamentResult:
    """The cross-policy tournament: one search per base twin (its
    policy's default space, a ``search_params[policy]`` override, or a
    prebuilt entry of ``spaces``), each one gradient loop. Extra kwargs
    (``device=`` included) forward to ``search``. Returns the ranked
    leaderboard."""
    if spaces is None:
        spaces = []
        for base in bases:
            override = (search_params or {}).get(base.policy)
            spaces.append(search_space(base, override)
                          if override is not None else default_space(base))
    return TournamentResult(results=[search(sp, traffics, slo, **kwargs)
                                     for sp in spaces])
