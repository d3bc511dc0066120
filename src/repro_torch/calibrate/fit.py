"""Multi-start gradient calibration of digital twins.

Counterpart: ``repro.calibrate.fit``. ``fit`` matches a registered
TwinPolicy's parameter vector to an ``ObservedTrace`` by differentiating
through the simulation scan. The K random restarts are K lanes of one
lane scan, and each step is

    per-restart losses and gradients (``objective.lane_trace_loss``
    streamed through ``kernels.ops.policy_scan_fold`` with its
    checkpointed backward)  +  AdamW, each restart clipped and scheduled
    on its own (``optim.adamw_update(lanes=1)``)

— the body of the reference's ``_fit_kernel``. The reference compiles
the whole fit (steps x grad + AdamW) into one XLA program; the port runs
the same steps eagerly, on the card by default (``device=``), with the
loss history and each restart's best-seen iterate kept on the device and
read back once at the end (no host read inside the step loop).

``fit(devices=D)`` is the reference's restart mesh over the first D
ranks of the ``torch.distributed`` default group: each runs its K/D
restarts through the same loop on its own device, and every rank gets
z, the losses and the history in restart order. Restarts are
independent lanes, and the backward's schedule is planned for all K
(``policy_vjp.whole_lanes``), so the result is bitwise the unsharded
fit's. A K that D does not divide runs unsharded, with the warn-once
replication ``RuntimeWarning``.

The public surface:

* ``fit(trace, policy, ...) -> FitResult`` — best twin + per-start
  convergence table + loss history.
* ``fit_with_holdout(train, holdout, ...)`` — fit on one trace, score the
  fitted twin on another, report the generalization gap.
* ``calibrated_twin(result, policy=...) -> Twin`` — an
  ``ExperimentResult`` (or a prebuilt trace) straight to a
  simulation-ready Twin for Table II grids.

With run telemetry on (``repro_torch.obs``) a fit records a
``calibrate.fit`` span (attrs policy, restarts, steps, t_bins, devices)
and the counters ``calibrate.fits{policy}`` / ``calibrate.restarts``; its
two warnings also count as ``warn.fit_warm_start_outside{policy}`` and
``warn.fit_pinned{policy}``.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.calibrate.objective import (DEFAULT_WEIGHTS, FitSpec,
                                             fit_spec, lane_trace_loss,
                                             params_from_z, series_loss,
                                             twin_from_z, z_from_params)
from repro_torch.calibrate.trace import SERIES_KEYS, ObservedTrace
from repro_torch.config import OptimizerConfig
from repro_torch.core.twin import PARAM_DIM, Twin, fit_twin, policy_spec
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import resolve_mesh_axis, run_lanes
from repro_torch.kernels.policy_vjp import whole_lanes
from repro_torch.optim.adamw import adamw_update, init_opt_state

#: AdamW settings tuned for the z-space objective: no weight decay (z=0 is
#: mid-box, not a prior), generous clip, short warmup; total_steps is
#: overwritten with the fit's step count so the cosine tail anneals the
#: last iterations for tight parameter recovery.
DEFAULT_FIT_OPT = OptimizerConfig(lr=0.08, betas=(0.9, 0.95), eps=1e-8,
                                  weight_decay=0.0, grad_clip=10.0,
                                  warmup_steps=25, total_steps=400)


@dataclass
class FitResult:
    """Best fit plus the evidence: per-start convergence + loss history."""
    twin: Twin
    policy: str
    loss: float
    params: np.ndarray            # [PARAM_DIM] best-fit full vector
    spec: FitSpec
    best_start: int
    start_losses: np.ndarray      # [K] final loss per restart
    start_params: np.ndarray      # [K, PARAM_DIM] fitted params per restart
    loss_history: np.ndarray      # [steps, K]
    trace_name: str
    holdout_loss: Optional[float] = None
    holdout_name: Optional[str] = None

    @property
    def generalization_gap(self) -> Optional[float]:
        """holdout loss / train loss (1.0 = generalizes perfectly)."""
        if self.holdout_loss is None:
            return None
        return float(self.holdout_loss / max(self.loss, 1e-12))

    def restart_table(self) -> List[Dict]:
        """Per-start convergence rows for report.render_table."""
        first = self.loss_history[0] if len(self.loss_history) else \
            self.start_losses
        rows = []
        for k in range(len(self.start_losses)):
            row = {"start": k,
                   "loss0": float(first[k]),
                   "loss": float(self.start_losses[k]),
                   "converged": bool(self.start_losses[k]
                                     <= 2.0 * self.loss + 1e-9),
                   "best": k == self.best_start}
            for i, pname in enumerate(self.spec.param_names):
                if self.spec.free_mask[i]:
                    row[pname] = round(float(self.start_params[k, i]), 6)
            rows.append(row)
        return rows


def _fit_loop(steps: int, dt_hours: float, ocfg: OptimizerConfig, z0,
              arrivals, targets, scales, weights, box, policy_index):
    """K restarts: ``steps`` x (gradient of the lane-block loss + AdamW).

    Returns (z_best [K, D], best_loss [K], history [steps, K]), all on the
    device: the BEST-SEEN iterate per restart, not the endpoint — each
    step's loss (which the gradient needs anyway) updates a running
    per-restart argmin, as in the reference's ``_fit_kernel_body``."""
    z = z0
    opt = init_opt_state({"z": z}, ocfg)
    z_best = z0.clone()
    best = torch.full((z0.shape[0],), float("inf"), dtype=torch.float32,
                      device=z0.device)
    history = torch.empty((steps, z0.shape[0]), dtype=torch.float32,
                          device=z0.device)
    for i in range(steps):
        with torch.enable_grad():
            zr = z.detach().requires_grad_()
            loss = lane_trace_loss(zr, arrivals, targets, scales, weights,
                                   policy_index, dt_hours, *box)
            (g,) = torch.autograd.grad(loss.sum(), zr)
        loss = loss.detach()
        better = loss < best
        z_best = torch.where(better[:, None], z, z_best)
        best = torch.where(better, loss, best)
        history[i] = loss
        new, opt = adamw_update({"z": z}, {"z": g}, opt, ocfg, lanes=1)
        z = new["z"]
    return z_best, best, history


def _as_operands(trace: ObservedTrace, weights: Optional[Dict[str, float]],
                 dev: torch.device):
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    arrivals = f32(trace.arrivals)
    targets = {k: f32(v) for k, v in trace.series().items()}
    scales = {k: f32(v) for k, v in trace.scales().items()}
    w = dict(DEFAULT_WEIGHTS)
    w.update(weights or {})
    return arrivals, targets, scales, {k: f32(w[k]) for k in SERIES_KEYS}


def fit(trace: ObservedTrace, policy: str = "fifo", *,
        restarts: int = 16, steps: int = 400, seed: int = 0,
        init: Optional[Twin] = None,
        freeze: Sequence[str] = (), unfreeze: Sequence[str] = (),
        fixed_values: Optional[Dict[str, float]] = None,
        weights: Optional[Dict[str, float]] = None,
        opt: Optional[OptimizerConfig] = None,
        name: Optional[str] = None,
        devices: Optional[int] = None, device="cuda") -> FitResult:
    """Fit ``policy``'s parameter vector to ``trace`` by gradient descent
    through the simulation scan, from ``restarts`` random starts at once.

    Start 0 is deterministic: the ``init`` twin's parameters if given,
    else the middle of every parameter box; the rest are Gaussian in
    z-space (seeded with ``seed``). The loss streams through the
    checkpointed scan, so a long trace holds O(K * sqrt(T)) live values.
    ``device`` is ``"cuda"`` (default; raises without a card) or
    ``"cpu"``. Warns (and counts a ``warn.*`` event) when the warm start
    lies outside the calibration box, and when the best fit is pinned at
    an edge of a finite box. ``devices=D`` splits the restarts over D
    ranks (see the module docstring); it raises ``ValueError`` without a
    ``torch.distributed`` group of at least D ranks.
    """
    d = resolve_mesh_axis(devices, int(restarts),
                          "fit(devices=) restart mesh") or 1
    dev = resolve_device(device)
    spec = fit_spec(policy, freeze=freeze, unfreeze=unfreeze,
                    fixed_values=fixed_values, init=init)
    arrivals, targets, scales, w = _as_operands(trace, weights, dev)

    rng = np.random.default_rng(seed)
    z0 = rng.normal(0.0, 1.5, (restarts, PARAM_DIM)).astype(np.float32)
    if init is not None:
        ip = init.padded_params()
        outside = [
            f"{n}={ip[i]:g} vs box ({spec.lo[i]:g}, {spec.hi[i]:g})"
            for i, n in enumerate(spec.param_names)
            if spec.free_mask[i] and not spec.lo[i] <= ip[i] <= spec.hi[i]]
        if outside:
            obs.event("warn.fit_warm_start_outside", policy=policy)
            warnings.warn(
                f"{policy} fit on trace {trace.name!r}: warm start lies "
                f"outside the calibration bounds — {'; '.join(outside)}. "
                f"The sigmoid bijection cannot reach it; widen that "
                f"parameter's bounds (register_policy(bounds=...)) or "
                f"freeze it", stacklevel=2)
        z0[0] = z_from_params(ip, spec.lo, spec.hi, spec.log_mask)
    else:
        z0[0] = 0.0          # mid-box start

    ocfg = dataclasses.replace(opt or DEFAULT_FIT_OPT, total_steps=steps)
    box = tuple(torch.as_tensor(a, device=dev) for a in (
        spec.lo, spec.hi, spec.log_mask, spec.free_mask, spec.fixed))
    obs.count("calibrate.fits", policy=policy)
    obs.count("calibrate.restarts", restarts)
    with obs.span("calibrate.fit", policy=policy, restarts=restarts,
                  steps=int(steps), t_bins=int(arrivals.shape[0]),
                  devices=d):
        def run(lo, hi):
            with whole_lanes(d):
                out = _fit_loop(
                    int(steps), float(trace.bin_hours), ocfg,
                    torch.as_tensor(z0[lo:hi], device=dev), arrivals,
                    targets, scales, w, box, policy_spec(policy).index)
            return tuple(x.cpu().numpy() for x in out)

        if d == 1:
            z_fin, final_loss, history = run(0, restarts)
        else:
            z_fin, final_loss, history = run_lanes(run, restarts, d,
                                                   (0, 0, 1))

    final_loss = np.asarray(final_loss, np.float64)
    best = int(np.nanargmin(final_loss))
    start_params = params_from_z(torch.as_tensor(z_fin), spec.lo, spec.hi,
                                 spec.log_mask, spec.free_mask,
                                 spec.fixed).numpy()
    pinned = [
        f"{n}={start_params[best, i]:g} at the "
        f"{'upper' if z_fin[best, i] > 0 else 'lower'} edge of "
        f"({spec.lo[i]:g}, {spec.hi[i]:g})"
        for i, n in enumerate(spec.param_names)
        if spec.free_mask[i] and np.isfinite(spec.hi[i])
        and abs(z_fin[best, i]) > 7.0]    # sigmoid(7) ~ 0.999
    if pinned:
        obs.event("warn.fit_pinned", policy=policy)
        warnings.warn(
            f"{policy} fit on trace {trace.name!r} pinned "
            f"{'; '.join(pinned)} — the measured pipeline likely lies "
            f"outside that parameter's box; widen the policy's bounds "
            f"(register_policy(bounds=...)) or treat the fit as a "
            f"lower/upper bound", stacklevel=2)
    twin = twin_from_z(z_fin[best], spec,
                       name or f"{trace.name}-{policy}-cal")
    return FitResult(twin=twin, policy=policy,
                     loss=float(final_loss[best]),
                     params=start_params[best], spec=spec, best_start=best,
                     start_losses=final_loss, start_params=start_params,
                     loss_history=np.asarray(history, np.float64),
                     trace_name=trace.name)


def evaluate(twin: Twin, trace: ObservedTrace,
             weights: Optional[Dict[str, float]] = None,
             device="cuda") -> float:
    """Score an existing twin against a trace with the calibration loss
    (no fitting) — the holdout metric."""
    dev = resolve_device(device)
    arrivals, targets, scales, w = _as_operands(trace, weights, dev)
    loss = series_loss(torch.as_tensor(twin.padded_params(), device=dev),
                       arrivals, targets, scales, w, twin.policy_index,
                       float(trace.bin_hours))
    return float(loss)


def fit_with_holdout(train: ObservedTrace, holdout: ObservedTrace,
                     policy: str = "fifo", **fit_kwargs) -> FitResult:
    """Fit on one trace, validate on another (the measure-on-ramp /
    validate-on-steady workflow): the returned FitResult carries the
    holdout loss and the generalization gap. Extra kwargs (``device=``
    included) forward to ``fit``."""
    result = fit(train, policy, **fit_kwargs)
    result.holdout_loss = evaluate(
        result.twin, holdout, weights=fit_kwargs.get("weights"),
        device=fit_kwargs.get("device", "cuda"))
    result.holdout_name = holdout.name
    return result


def calibrated_twin(source: Union[ObservedTrace, "ExperimentResult"],
                    policy: str = "fifo", *, bin_s: float = 1.0,
                    name: Optional[str] = None,
                    **fit_kwargs) -> Twin:
    """Measured pipeline -> simulation-ready Twin, in one call.

    ``source`` is an ``ExperimentResult`` (binned into a trace at
    ``bin_s``-second resolution, with the paper's closed-form fit as the
    warm start) or a prebuilt ``ObservedTrace``. Extra kwargs (``device=``
    included) forward to ``fit``. Use ``fit()`` directly when you want
    the convergence table.
    """
    if isinstance(source, ObservedTrace):
        trace = source
    else:
        trace = ObservedTrace.from_experiment(source, bin_s=bin_s)
        if "init" not in fit_kwargs:
            try:
                fit_kwargs["init"] = fit_twin(source, policy)
            except (KeyError, AttributeError):
                fit_kwargs["init"] = None
    result = fit(trace, policy, name=name, **fit_kwargs)
    return result.twin
