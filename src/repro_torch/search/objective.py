"""The search objective: differentiable annual cost under a smooth SLO.

Counterpart: ``repro.search.objective``. ``lane_objective`` scores a
[L, PARAM_DIM] block of candidate configurations against a [L, T] block
of traffic scenarios in ONE lane scan — the same dispatch shape (and the
same ``kernels.ops`` gradient scans) twin calibration uses for its
restarts, with ``surrogate=True`` so hard-gated policy extras
(quickscale/autoscale's ceil, batch_window's flush comparison) carry
gradients. Per lane it returns

    annual cost  +  penalty_weight * penalty_scale * hinge(SLO shortfall)

where annual cost is the simulated cost series total plus the paper's
end-of-horizon backlog pricing (queue / capacity hours at the twin's
hourly rate), scaled from the simulated horizon to the 8736-hour year;
and the SLO term is a fixed-weight softplus hinge on the smoothed
met-fraction: each bin's compliance is a sigmoid of its distance to the
limit (width ``tau`` of the limit), load-weighted into a fraction, and
any shortfall below ``met_fraction`` is hinged through softplus, plus a
small violation-magnitude term gated by infeasibility.

**The reductions stream.** ``stream=True`` (and ``lane_objective_t``)
folds the four per-lane sums — cost, the load-weighted compliance
numerator and denominator, and the violation softplus mass — into the
scan state as twice-compensated float32 triples through
``kernels.ops.policy_scan_fold``, whose checkpointed backward replays
segments instead of taping the horizon. The port holds the four sums as
the columns of one [L, 4] triple (one compensated add a bin, the same
float32 arithmetic per element as the reference's four). ``stream=False``
materialises the series and replays the identical fold code, so the two
agree bit for bit. ``lane_objective_vectorized`` is the third form: the
same math as one vectorised [L, T] hinge with plain float32 sums — the
gradient guide the search loop takes below its streaming size.

The objective is a gradient guide only: ``repro_torch.search.optimize``
re-checks every candidate through the bit-exact aggregate grid
(``simulate_grid(return_series=False)``) before it reports a number.
"""
from __future__ import annotations

import torch

from repro_torch.calibrate.objective import _softplus
from repro_torch.core.traffic import HOURS_PER_YEAR
from repro_torch.core.twin import (AGG_SLO_DROP_RATE, fold_triple_add,
                                   fold_triple_finalize, fold_triple_init)

#: softplus hinge softness, in met-fraction units: a razor hinge — the
#: tail must be ~zero a few tenths of a percent INSIDE feasibility, or
#: its slope (times the dollar-denominated penalty weight) out-muscles
#: the real cost gradient and parks the optimum well short of the
#: boundary the SLO actually draws
HINGE_S = 0.001
#: compliance-sigmoid width as a fraction of the SLO limit: narrow, so a
#: comfortably feasible configuration scores frac ~= 1 and feels pure
#: cost gradients
DEFAULT_TAU = 0.02
#: weight of the violation-*magnitude* term relative to penalty_weight.
#: The met-fraction hinge saturates once every violating bin's sigmoid
#: does (deeply infeasible configurations would feel no restoring
#: gradient); the magnitude term keeps growing with violation depth. It
#: is gated by infeasibility and kept small: the SLO budget allows
#: (1 - met_fraction) of the load to violate, so charging feasible
#: configurations for allowed violations would bias the optimum
EXCESS_WEIGHT = 0.002
#: width of the per-future met/miss sigmoid in met-fraction units for the
#: chance constraint (``search(faults=..., quantile=...)``): each fault
#: future contributes sigmoid((frac - met) / CHANCE_W) to the smoothed
#: probability of meeting the SLO
CHANCE_W = 0.01

#: the fold's [L, 4] columns: cost, ok * load, load, softplus excess *
#: load
_COST, _OKW, _LOAD, _EXCESS = range(4)
#: the fold's state is one compensated triple, all three leaves sinks
_OBJ_SINKS = (0, 1, 2)


def annual_scale(t_bins: int, bin_hours: float) -> float:
    """Scale factor from a simulated horizon to the 8736-hour year."""
    return HOURS_PER_YEAR / (t_bins * bin_hours)


def smooth_met_fraction(values, loads, slo_limit_lane, width):
    """[L] smoothed load-weighted fraction of bins within the SLO limit.

    values [L, T] (latency seconds or drop fractions); loads [L, T];
    slo_limit_lane [L] per-lane limits; ``width`` [L, 1] or a scalar
    sigmoid width. Each bin contributes a sigmoid of its margin — the
    differentiable stand-in for the aggregate path's exact ``<=``
    counters."""
    ok = torch.sigmoid((slo_limit_lane[:, None] - values) / width)
    return (ok * loads).sum(dim=1) / torch.clamp_min(loads.sum(dim=1),
                                                     1e-9)


# ---------------------------------------------------------------------------
# The shared per-bin fold — one implementation for both dispatch shapes.
# ---------------------------------------------------------------------------

def _obj_fold_init(n, device=None):
    """The (sum, comp, comp2) triple of [n, 4] sums (``_COST`` ..)."""
    return fold_triple_init((n, 4), device)


def _obj_fold(acc, w, v, cost, limits, width):
    ok = torch.sigmoid((limits - v) / width)
    sp = _softplus((v - limits) / width)
    return fold_triple_add(acc, torch.stack((cost, ok * w, w, sp * w),
                                            dim=1))


def _obj_fold_latency(acc, arrive, outs, ops_lane, xs_row):
    del xs_row
    _proc, _q, lat, cost, _drop = outs
    limits, width = ops_lane
    return _obj_fold(acc, arrive, lat, cost, limits, width)


def _obj_fold_droprate(acc, arrive, outs, ops_lane, xs_row):
    del xs_row
    _proc, _q, _lat, cost, drop = outs
    limits, width = ops_lane
    v = drop / torch.clamp_min(arrive, 1e-9)
    return _obj_fold(acc, arrive, v, cost, limits, width)


def _obj_ops_lane(slo_limit_lane, slo_mode: int, tau):
    """Per-lane (limits, width) operands of the fold, by SLO mode."""
    if slo_mode == AGG_SLO_DROP_RATE:
        width = tau * slo_limit_lane + 1e-4   # rate floor
        # small absolute allowance: a zero-tolerance limit (drop_rate
        # <= 0) would otherwise park every compliant bin at sigmoid(0)
        # = 0.5 and the penalty could never release; the shift keeps
        # v == limit counting as met (the exact counters' <=) at the
        # price of a ~3-width optimism the exact re-check absorbs
        limits = slo_limit_lane + 3e-4
    else:
        width = tau * slo_limit_lane + 1e-6
        limits = slo_limit_lane
    return limits, width


def _fold_step(slo_mode: int):
    return (_obj_fold_droprate if slo_mode == AGG_SLO_DROP_RATE
            else _obj_fold_latency)


def _penalised(cost_ann, frac, excess, met_fraction, penalty_weight,
               penalty_scale):
    shortfall = met_fraction - frac
    hinge = _softplus(shortfall / HINGE_S) * HINGE_S
    gate = torch.sigmoid(shortfall / HINGE_S)
    penalty = penalty_weight * penalty_scale * (
        hinge + EXCESS_WEIGHT * gate * excess)
    return cost_ann + penalty


def _backlog_cost(carry_end, params_block):
    return (carry_end[:, 0] / torch.clamp_min(params_block[:, 0], 1e-9)
            / 3600.0 * params_block[:, 1])


def _obj_combine(acc, carry_end, params_block, met_fraction,
                 penalty_weight, penalty_scale, horizon_scale, tau):
    """Folded sums -> (objective [L], (annual_cost [L], met_frac [L]))."""
    fin = fold_triple_finalize(acc)
    total, okl, load, excess_sum = fin.unbind(dim=1)
    cost_ann = (total + _backlog_cost(carry_end, params_block)) \
        * horizon_scale
    frac = okl / torch.clamp_min(load, 1e-9)
    # violation magnitude in widths, rescaled by tau so it reads as "per
    # unit of the limit", gated off in the feasible region
    excess = tau * excess_sum / torch.clamp_min(load, 1e-9)
    return (_penalised(cost_ann, frac, excess, met_fraction,
                       penalty_weight, penalty_scale), (cost_ann, frac))


def lane_objective_t(params_block, loads_t_block, dt_hours, policy_index,
                     slo_limit_lane, slo_mode: int, met_fraction,
                     penalty_weight, penalty_scale, horizon_scale,
                     tau=DEFAULT_TAU, surrogate: bool = True,
                     caps_t_block=None):
    """Streaming ``lane_objective`` over scenario-minor operands
    (``loads_t_block`` / ``caps_t_block`` [T, L]): the reductions fold
    into the scan state through ``kernels.ops.policy_scan_fold``, so no
    [L, T] tensor exists in either direction. Same return contract as
    ``lane_objective``, bitwise its values."""
    from repro_torch.kernels import ops
    carry_end, acc = ops.policy_scan_fold(
        params=params_block, dt_hours=dt_hours, policy_index=policy_index,
        surrogate=surrogate, loads_t=loads_t_block, caps_t=caps_t_block,
        fold_init=_obj_fold_init, fold_step=_fold_step(slo_mode),
        ops_lane=_obj_ops_lane(slo_limit_lane, slo_mode, tau),
        acc_sinks=_OBJ_SINKS)
    return _obj_combine(acc, carry_end, params_block, met_fraction,
                        penalty_weight, penalty_scale, horizon_scale, tau)


def lane_objective(params_block, loads_block, dt_hours, policy_index,
                   slo_limit_lane, slo_mode: int, met_fraction,
                   penalty_weight, penalty_scale, horizon_scale,
                   tau=DEFAULT_TAU, surrogate: bool = True,
                   caps_block=None, stream: bool = True):
    """[L] smooth objective values for a lane block (see the module
    docstring).

    params_block [L, PARAM_DIM]; loads_block [L, T]; ``policy_index`` an
    int (a uniform block); ``slo_limit_lane`` [L]; ``slo_mode`` an
    AGG_SLO_* value. Pass ``surrogate=False``
    (``SearchSpace.needs_surrogate``) when no searched parameter is
    hard-gated, so the optimizer descends the true landscape.
    ``caps_block`` [L, T] (optional) threads a fault schedule's capacity
    multipliers through the scan (each lane is then one (candidate,
    scenario, fault future) triple).

    ``stream=True`` (default) folds the reductions into the scan state;
    ``stream=False`` materialises the series and replays the identical
    fold — the same values, bit for bit. Returns (objective [L],
    (annual_cost [L], met_frac [L]))."""
    if stream:
        return lane_objective_t(
            params_block, loads_block.t(), dt_hours, policy_index,
            slo_limit_lane, slo_mode, met_fraction, penalty_weight,
            penalty_scale, horizon_scale, tau=tau, surrogate=surrogate,
            caps_t_block=None if caps_block is None else caps_block.t())
    from repro_torch.kernels import ops
    carry_end, outs = ops.policy_scan(
        loads_block, params_block, dt_hours=dt_hours,
        policy_index=policy_index, differentiable=True,
        surrogate=surrogate,
        caps_t=None if caps_block is None else caps_block.t())
    ops_lane = _obj_ops_lane(slo_limit_lane, slo_mode, tau)
    step = _fold_step(slo_mode)
    acc = _obj_fold_init(loads_block.shape[0], loads_block.device)
    for t in range(loads_block.shape[1]):
        acc = step(acc, loads_block[:, t], tuple(o[:, t] for o in outs),
                   ops_lane, None)
    return _obj_combine(acc, carry_end, params_block, met_fraction,
                        penalty_weight, penalty_scale, horizon_scale, tau)


def lane_objective_vectorized(params_block, loads_block, dt_hours,
                              policy_index, slo_limit_lane, slo_mode: int,
                              met_fraction, penalty_weight, penalty_scale,
                              horizon_scale, tau=DEFAULT_TAU,
                              surrogate: bool = True, caps_block=None):
    """Small-problem form: materialise the [L, T] series and take the
    hinge reductions as plain vectorised sums.

    Same arguments and return contract as ``lane_objective``, same math,
    but the compliance sigmoid and violation softplus run once over the
    whole block and the sums are plain float32 ``sum(dim=1)`` instead of
    compensated triples: values differ from the streamed form by float32
    summation order only. ``optimize._run_kernel`` picks between the two
    on the global problem size."""
    from repro_torch.kernels import ops
    carry_end, (_proc, _q, lat, cost, drop) = ops.policy_scan(
        loads_block, params_block, dt_hours=dt_hours,
        policy_index=policy_index, differentiable=True,
        surrogate=surrogate,
        caps_t=None if caps_block is None else caps_block.t())
    # lane-major rows: a row sum of a transposed view is blocked by the
    # lane count, which would tie each lane's value to how many lanes
    # run beside it (a restart mesh's share)
    lat, cost, drop = (x.contiguous() for x in (lat, cost, drop))
    limits, width = _obj_ops_lane(slo_limit_lane, slo_mode, tau)
    w = loads_block.contiguous()
    values = (drop / torch.clamp_min(w, 1e-9)
              if slo_mode == AGG_SLO_DROP_RATE else lat)
    cost_ann = (cost.sum(dim=1) + _backlog_cost(carry_end, params_block)) \
        * horizon_scale
    frac = smooth_met_fraction(values, w, limits, width[:, None])
    rel = (values - limits[:, None]) / width[:, None]
    excess = (tau * (_softplus(rel) * w).sum(dim=1)
              / torch.clamp_min(w.sum(dim=1), 1e-9))
    return (_penalised(cost_ann, frac, excess, met_fraction,
                       penalty_weight, penalty_scale), (cost_ann, frac))
