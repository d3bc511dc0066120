"""Calibration objective: bounded reparameterisation + multi-series loss.

Counterpart: ``repro.calibrate.objective``. The fit never optimises twin
parameters directly — it optimises an unconstrained vector ``z`` mapped
onto each policy's declared parameter box (``PolicySpec.bounds``):

* finite box, linear param:   p = lo + (hi - lo) * sigmoid(z)
* finite box, log-scale param: p = exp(log lo + (log hi - log lo) * sigmoid(z))
* half-open box (hi = inf):    p = lo + softplus(z)

Frozen parameters and the zero-padding slots take fixed values.

``trace_loss`` plays the candidate parameters through the scan the
what-if engine uses (``core.simulate.scan_trace``) and scores the
simulated throughput / latency / drop / cost series against an
``ObservedTrace`` with a weighted, per-series-normalised MSE of log
ratios. The lane-block form the fit runs (``lane_series_loss``) streams
that score: running flow sums and compensated residual accumulators fold
into the scan state (``kernels.ops.policy_scan_fold``), so neither the
forward nor the checkpointed backward holds a [K, T] series.

The fold's layout differs from the reference's (one [K, 4] tensor per
accumulator channel instead of four [K] ones, one ``fold_triple_add`` a
bin instead of four), not its arithmetic: every element goes through the
same float32 operations in the same order. The target rows plus their
floors (``tgt + eps``) are formed once outside the scan, as the same
float32 add the reference does inside it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.calibrate.trace import SERIES_KEYS
from repro_torch.core.simulate import scan_trace
from repro_torch.core.twin import (PARAM_DIM, Twin, fold_triple_add,
                                   fold_triple_finalize, fold_triple_init,
                                   policy_spec)

#: default loss mix: throughput and latency curves carry most signal; the
#: drop curve pins bounded-queue policies; cost identifies $/hr parameters
DEFAULT_WEIGHTS: Dict[str, float] = {
    "processed": 1.0, "latency": 1.0, "dropped": 1.0, "cost": 1.0,
}


@dataclass(frozen=True)
class FitSpec:
    """Per-policy fit layout: which PARAM_DIM slots are free, their boxes,
    their transform, and the fixed values of everything else."""
    policy: str
    param_names: Tuple[str, ...]
    lo: np.ndarray          # [PARAM_DIM] f32
    hi: np.ndarray          # [PARAM_DIM] f32 (may be +inf -> softplus)
    log_mask: np.ndarray    # [PARAM_DIM] bool — fit exponent, not value
    free_mask: np.ndarray   # [PARAM_DIM] bool — optimized slots
    fixed: np.ndarray       # [PARAM_DIM] f32 — value wherever not free

    @property
    def free_names(self) -> Tuple[str, ...]:
        return tuple(n for i, n in enumerate(self.param_names)
                     if self.free_mask[i])


def fit_spec(policy: str, freeze: Sequence[str] = (),
             unfreeze: Sequence[str] = (),
             fixed_values: Optional[Dict[str, float]] = None,
             init: Optional[Twin] = None) -> FitSpec:
    """Build the fit layout for ``policy`` from the registry metadata.

    ``freeze``/``unfreeze`` adjust the policy's default frozen set; fixed
    values come from ``fixed_values``, then the ``init`` twin, then the
    registered defaults — a frozen parameter with none of the three is an
    error.
    """
    spec = policy_spec(policy)
    names = spec.param_names
    frozen = (set(spec.frozen) | set(freeze)) - set(unfreeze)
    unknown = (set(freeze) | set(unfreeze)) - set(names)
    if unknown:
        raise KeyError(f"{policy} has no params {sorted(unknown)}")

    values: Dict[str, float] = dict(spec.defaults)
    if init is not None:
        if init.policy != policy:
            raise ValueError(f"init twin is {init.policy!r}, want {policy!r}")
        values.update(zip(names, init.padded_params()))
    values.update(fixed_values or {})

    lo = np.zeros(PARAM_DIM, np.float32)
    hi = np.ones(PARAM_DIM, np.float32)
    log_mask = np.zeros(PARAM_DIM, bool)
    free_mask = np.zeros(PARAM_DIM, bool)
    fixed = np.zeros(PARAM_DIM, np.float32)
    for i, pname in enumerate(names):
        b_lo, b_hi = spec.bound(pname)
        lo[i], hi[i] = b_lo, b_hi
        log_mask[i] = pname in spec.log_params
        if pname in frozen:
            if pname not in values:
                raise KeyError(f"frozen param {pname!r} needs a value "
                               f"(fixed_values=, init=, or a default)")
            fixed[i] = float(values[pname])
        else:
            free_mask[i] = True
    return FitSpec(policy=policy, param_names=names, lo=lo, hi=hi,
                   log_mask=log_mask, free_mask=free_mask, fixed=fixed)


# ---------------------------------------------------------------------------
# the z <-> params bijection
# ---------------------------------------------------------------------------

def _softplus(z):
    """``jnp.logaddexp(z, 0)``: max(z, 0) + log1p(exp(-|z|))."""
    return (torch.maximum(z, torch.zeros_like(z))     # half each way at 0
            + torch.log1p(torch.exp(-torch.abs(z))))


def params_from_z(z, lo, hi, log_mask, free_mask, fixed):
    """Map unconstrained ``z`` [..., PARAM_DIM] onto the parameter box
    (the box operands broadcast over leading lane axes and are moved to
    ``z``'s device). Every ``where`` keeps its guard: the untaken branch
    stays finite, so no NaN reaches the gradient.

    The map runs in float64 and rounds once to float32, so that the card
    and the CPU give the same parameters: their float32 sigmoid, exp and
    log differ in the last ulp, and an ulp of a parameter can move a
    queue across a kink of the loss (a bin's ``min(avail, capacity)``
    switching sides), which changes the gradient by far more than an
    ulp. (The reference rounds in float32 with XLA's functions: within an
    ulp of this.)"""
    dev = z.device
    z = z.to(torch.float64)

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev).to(
            torch.float64)

    def flag(a):
        return torch.as_tensor(a, dtype=torch.bool, device=dev)

    lo, hi, fixed = f64(lo), f64(hi), f64(fixed)
    finite = torch.isfinite(hi)
    lo_pos = torch.clamp_min(lo, 1e-12)        # log path needs lo > 0
    hi_safe = torch.where(finite, hi, lo_pos * 2.0)  # keep logs/NaNs out
    s = torch.sigmoid(z)                              # of the untaken branch
    lin = lo + (hi_safe - lo) * s
    logp = torch.exp(torch.log(lo_pos)
                     + (torch.log(torch.maximum(hi_safe, lo_pos))
                        - torch.log(lo_pos)) * s)
    boxed = torch.where(flag(log_mask), logp, lin)
    soft = lo + _softplus(z)
    p = torch.where(finite, boxed, soft)
    return torch.where(flag(free_mask), p, fixed).to(torch.float32)


def z_from_params(params, lo, hi, log_mask) -> np.ndarray:
    """Inverse bijection (numpy): a warm-start z for a known twin."""
    params = np.asarray(params, np.float64)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    lo_pos = np.maximum(lo, 1e-12)
    finite = np.isfinite(hi)
    hi_safe = np.where(finite, hi, lo_pos * 2.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac_lin = (params - lo) / np.maximum(hi_safe - lo, 1e-12)
        frac_log = ((np.log(np.maximum(params, 1e-12)) - np.log(lo_pos))
                    / np.maximum(np.log(np.maximum(hi_safe, lo_pos))
                                 - np.log(lo_pos), 1e-12))
    frac = np.clip(np.where(log_mask, frac_log, frac_lin), 1e-4, 1.0 - 1e-4)
    z = np.log(frac / (1.0 - frac))
    # softplus inverse for half-open boxes: z = log(exp(p - lo) - 1),
    # which is ~identity past gap 30 (expm1 would overflow there)
    gap = np.maximum(params - lo, 1e-6)
    z_soft = np.where(gap > 30.0, gap,
                      np.log(np.expm1(np.minimum(gap, 30.0))))
    return np.where(finite, z, z_soft).astype(np.float32)


def twin_from_z(z: np.ndarray, spec: FitSpec, name: str) -> Twin:
    """Materialize the fitted Twin from an optimized z vector."""
    p = params_from_z(torch.as_tensor(np.asarray(z, np.float32)), spec.lo,
                      spec.hi, spec.log_mask, spec.free_mask,
                      spec.fixed).numpy()
    return Twin(name=name, policy=spec.policy, kind="calibrated",
                params=tuple(float(v) for v in p[:len(spec.param_names)]))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def series_loss(params_vec, arrivals, targets, scales, weights, policy_index,
                dt_hours):
    """Weighted MSE of log-ratio residuals, simulated vs observed, for one
    parameter vector [PARAM_DIM] (tensors on one device: ``arrivals``
    [T], ``targets`` {key: [T]}, ``scales`` / ``weights`` {key: 0-d}).

    Residuals are multiplicative — ``log((sim + eps) / (obs + eps))`` —
    because the series span decades within one trace; the floor ``eps``
    is six decades below each series' magnitude. Flow series (processed /
    dropped / cost) are matched *cumulatively* (bursty policies' per-bin
    spikes would make the landscape a step function of the parameters);
    latency stays per bin.
    """
    _, (proc, _queue, lat, cost, drop) = scan_trace(
        arrivals, params_vec, policy_index, dt_hours)
    sim = {"processed": proc, "latency": lat, "dropped": drop, "cost": cost}
    total = torch.zeros((), dtype=torch.float32, device=arrivals.device)
    for key in SERIES_KEYS:
        s, t = sim[key], targets[key]
        if key != "latency":            # flow series: match the running sum
            s, t = torch.cumsum(s, 0), torch.cumsum(t, 0)
            eps = t[-1] * 1e-6 + 1e-12
        else:
            eps = scales[key] * 1e-6 + 1e-12
        r = torch.log((s + eps) / (t + eps))
        total = total + weights[key] * torch.mean(r * r)
    return total


def trace_loss(z, arrivals, targets, scales, weights, policy_index, dt_hours,
               lo, hi, log_mask, free_mask, fixed):
    """The calibration objective: reparameterize, simulate, score."""
    p = params_from_z(z, lo, hi, log_mask, free_mask, fixed)
    return series_loss(p, arrivals, targets, scales, weights, policy_index,
                       dt_hours)


# ---------------------------------------------------------------------------
# the lane-block loss — K restarts as K lanes of one scan
# ---------------------------------------------------------------------------
#
# The streamed form folds the loss into the simulation scan: the fold
# carries each lane's running flow sums and one twice-compensated residual
# triple per series. Its columns are ordered (processed, dropped, cost,
# latency) — ``_FOLD_COL`` maps SERIES_KEYS to them — so that the three
# flow sums are one [K, 3] tensor the latency column is appended to. Both
# the streamed and the materialised paths run the same fold over the same
# rows, so their losses are bitwise equal.

#: the fold column of each SERIES_KEYS entry
_FOLD_COL = {"processed": 0, "dropped": 1, "cost": 2, "latency": 3}


def _cal_fold_init(n, device=None):
    """Per-lane accumulator: the running flow sums [n, 3] (processed,
    dropped, cost) and a compensated squared-log-ratio triple of [n, 4]
    (the fold's column order)."""
    return (torch.zeros((n, 3), dtype=torch.float32, device=device),
            fold_triple_init((n, 4), device))


#: the triple's three leaves (after the flow sums) only accumulate
_CAL_SINKS = (1, 2, 3)


def _cal_fold(acc, arrive, outs, ops_lane, xs_row):
    """One bin of the calibration loss: advance the flow sums, score this
    bin's log-ratio residual per series against the target row plus its
    floor (``xs_row``, [4] or one per lane), accumulate r^2 into the
    triple. ``ops_lane`` [n, 4] holds the per-series floors."""
    del arrive
    cum, triple = acc
    proc, _queue, lat, cost, drop = outs
    cum = cum + torch.stack((proc, drop, cost), dim=1)
    sim = torch.cat((cum, lat[:, None]), dim=1)
    r = torch.log((sim + ops_lane) / xs_row)
    return cum, fold_triple_add(triple, r * r)


def _cal_operands(targets, scales):
    """The target rows plus their floors, [T, 4] in the fold's column
    order (flow cumsums, per-bin latency), and the floors [4] — computed
    once outside the scan and fed to both paths."""
    tgt = torch.stack((torch.cumsum(targets["processed"], 0),
                       torch.cumsum(targets["dropped"], 0),
                       torch.cumsum(targets["cost"], 0),
                       targets["latency"]), dim=1)
    eps = torch.cat((tgt[-1, :3] * 1e-6 + 1e-12,
                     (scales["latency"] * 1e-6 + 1e-12)[None]))
    return tgt + eps, eps


def _cal_combine(acc, weights, t_bins):
    """Finalize the triples -> per-series means -> weighted total, in
    SERIES_KEYS order."""
    fin = fold_triple_finalize(acc[1])
    total = torch.zeros((), dtype=torch.float32, device=fin.device)
    for key in SERIES_KEYS:
        total = total + weights[key] * (fin[:, _FOLD_COL[key]] / t_bins)
    return total


def lane_series_loss(params_block, arrivals, targets, scales, weights,
                     policy_index, dt_hours, stream: bool = True):
    """[K] per-restart losses for a [K, PARAM_DIM] block of candidates.

    The K restarts are K lanes of one scan of a single policy
    (``policy_index``, an int: one lane step, no blend). Same scoring as
    ``series_loss``, vectorised over lanes. ``stream=True`` (what ``fit``
    runs) folds the sums into the scan state through
    ``kernels.ops.policy_scan_fold`` — no [K, T] series in either
    direction. ``stream=False`` materialises the five series through
    ``kernels.ops.policy_scan(differentiable=True)`` and replays the same
    fold over them: the O(T)-memory reference the stream is pinned
    against, bit for bit.
    """
    from repro_torch.kernels import ops
    k = params_block.shape[0]
    t_bins = arrivals.shape[-1]
    xs, eps = _cal_operands(targets, scales)
    eps_lanes = eps.expand(k, 4)
    if stream:
        loads_t = arrivals[:, None].expand(t_bins, k)
        _, acc = ops.policy_scan_fold(
            params=params_block, dt_hours=dt_hours,
            policy_index=policy_index, loads_t=loads_t,
            fold_init=_cal_fold_init, fold_step=_cal_fold,
            ops_lane=eps_lanes, xs=xs, acc_sinks=_CAL_SINKS)
        return _cal_combine(acc, weights, t_bins)
    loads = arrivals.expand(k, t_bins)
    _, outs = ops.policy_scan(loads, params_block, dt_hours=dt_hours,
                              policy_index=policy_index,
                              differentiable=True)
    acc = _cal_fold_init(k, arrivals.device)
    for t in range(t_bins):
        acc = _cal_fold(acc, loads[:, t], tuple(o[:, t] for o in outs),
                        eps_lanes, xs[t])
    return _cal_combine(acc, weights, t_bins)


def lane_trace_loss(z_block, arrivals, targets, scales, weights,
                    policy_index, dt_hours, lo, hi, log_mask, free_mask,
                    fixed, stream: bool = True):
    """``trace_loss`` over a [K, PARAM_DIM] restart block: reparameterize
    every lane, then score the block in one lane scan."""
    p = params_from_z(z_block, lo, hi, log_mask, free_mask, fixed)
    return lane_series_loss(p, arrivals, targets, scales, weights,
                            policy_index, dt_hours, stream=stream)
