"""Plain PyTorch versions of the policy-scan kernels.

Counterparts: ``repro.kernels.ref.policy_grid_scan`` / ``policy_grid_agg``.
A Python loop over the T bins steps all N scenarios at once through the
lane steps of ``repro_torch.core.twin`` — the same arithmetic, in the same
order, as the reference, so on the CPU the results are bitwise the JAX
package's. The CPU path of the port runs these; ``chip_smoke.py`` holds
the CUDA kernels (``kernels/csrc/policy_scan.cu``) against them on the
card.

The branch selector is exactly one of ``onehot`` [N, P] (mixed grid: the
masked blend ``lane_policy_step``) or ``policy_index`` (an int: one lane
step for a uniform block, selected without the blend). ``caps`` [N, T]
(and, for the aggregate scan, ``fmask`` [N, T]) run the fault layer
(``core.twin.fault_lane_policy_step`` / ``fault_switch_step``): a fault
backlog rides beside the policy carry and folds into ``carry_end[:, 0]``
at the end. No surrogate branches yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.twin import (CARRY_DIM, SHED_FUSE_ALL,
                                   SHED_FUSE_DROP, SHED_FUSE_LATENCY,
                                   fault_lane_branches,
                                   fault_lane_policy_step,
                                   fault_switch_step, finalize_aggregate,
                                   init_aggregate, lane_branches,
                                   lane_policy_step, lane_update_aggregate,
                                   pack_aggregate)


def _bin_step(params, onehot, policy_index, dt, fuse):
    """``step(state, arrive, capmul) -> (state, outs)``. ``fuse`` None is
    the benign scan (the state is the policy carry); a SHED_FUSE_* level
    runs the fault layer (the state is (carry, fault backlog)) with the
    rounding of the reference's scan of that kind."""
    if (onehot is None) == (policy_index is None):
        raise ValueError("pass exactly one of onehot= (mixed grid) or "
                         "policy_index= (uniform lane block)")
    if onehot is not None:
        columns = torch.nonzero(onehot.any(dim=0)).flatten().tolist()
        if fuse is not None:
            branches = fault_lane_branches(fuse)
            return lambda state, arrive, capmul: fault_lane_policy_step(
                state, arrive, capmul, params, onehot, dt, branches,
                columns)
        branches = lane_branches()
        return lambda carry, arrive, _: lane_policy_step(
            carry, arrive, params, onehot, dt, branches, columns)
    if fuse is not None:
        return lambda state, arrive, capmul: fault_switch_step(
            state, arrive, capmul, params, policy_index, dt, fuse)
    lstep = lane_branches()[int(policy_index)]
    return lambda carry, arrive, _: lstep(carry, arrive, params, dt)


def _fuse_level(caps, policy_index, shed_fuse, mixed_default):
    """The SHED_FUSE_* level of a scan: None without faults, else the
    one asked for, else the reference's rounding for this kind of scan."""
    if caps is None:
        return None
    if shed_fuse is not None:
        return shed_fuse
    return SHED_FUSE_ALL if policy_index is not None else mixed_default


def _start(n, dev, fault: bool):
    carry = torch.zeros((n, CARRY_DIM), dtype=torch.float32, device=dev)
    if not fault:
        return carry
    return carry, torch.zeros(n, dtype=torch.float32, device=dev)


def _carry_end(state, fault: bool):
    """The final carry, the fault backlog folded into the queue slot."""
    if not fault:
        return state
    carry, fq = state
    return torch.stack([carry[:, 0] + fq, carry[:, 1]], dim=1)


def policy_grid_scan(loads: torch.Tensor, params: torch.Tensor,
                     onehot: torch.Tensor = None, dt_hours=1.0,
                     policy_index=None, caps: torch.Tensor = None,
                     shed_fuse: int = None):
    """loads [N, T] records/bin, params [N, PARAM_DIM], optional caps
    [N, T] -> (carry_end [N, CARRY_DIM], (processed, queue, latency, cost,
    dropped)), each series [N, T] (a transposed view of a scenario-minor
    [T, N] buffer, the kernel's layout). ``shed_fuse`` overrides the
    SHED_FUSE_* level (default: DROP mixed, ALL uniform)."""
    n, t_bins = loads.shape
    dev = loads.device
    fault = caps is not None
    dt = torch.tensor(dt_hours, dtype=torch.float32, device=dev)
    step = _bin_step(params, onehot, policy_index, dt,
                     _fuse_level(caps, policy_index, shed_fuse,
                                 SHED_FUSE_DROP))
    loads_t = loads.t().contiguous()
    caps_t = caps.t().contiguous() if fault else [None] * t_bins
    series = torch.empty((5, t_bins, n), dtype=torch.float32, device=dev)
    state = _start(n, dev, fault)
    for t in range(t_bins):
        state, outs = step(state, loads_t[t], caps_t[t])
        for k, o in enumerate(outs):
            series[k, t] = o
    return (_carry_end(state, fault),
            tuple(series[k].t() for k in range(5)))


def policy_grid_agg(loads: torch.Tensor, params: torch.Tensor,
                    onehot: torch.Tensor = None, dt_hours=1.0, *,
                    policy_index=None, slo_limit: float = float("inf"),
                    slo_mode: int = 0, caps: torch.Tensor = None,
                    fmask: torch.Tensor = None, shed_fuse: int = None):
    """Streaming-aggregate scan: same operands and selector as
    ``policy_grid_scan``, but the Table II statistics fold into the scan
    state (``core.twin.lane_update_aggregate``) and no series is kept.
    ``slo_limit`` is compared in float32. ``caps`` and ``fmask`` come
    together; the statistics stay weighted by the offered load and
    ``fmask`` drives A_FLTH/A_FOKH; ``shed_fuse`` as in
    ``policy_grid_scan`` (default: LATENCY mixed, ALL uniform). Returns
    (carry_end [N, CARRY_DIM],
    agg [N, AGG_DIM]) — the compensated histogram triples recombined in
    f64 by ``finalize_aggregate``."""
    if (caps is None) != (fmask is None):
        raise ValueError("pass caps= and fmask= together (or neither)")
    n, t_bins = loads.shape
    dev = loads.device
    fault = caps is not None
    dt = torch.tensor(dt_hours, dtype=torch.float32, device=dev)
    lim = torch.tensor(slo_limit, dtype=torch.float32, device=dev)
    step = _bin_step(params, onehot, policy_index, dt,
                     _fuse_level(caps, policy_index, shed_fuse,
                                 SHED_FUSE_LATENCY))
    loads_t = loads.t().contiguous()
    caps_t = caps.t().contiguous() if fault else [None] * t_bins
    fmask_t = fmask.t().contiguous() if fault else [None] * t_bins
    state = _start(n, dev, fault)
    agg = init_aggregate(n, dev)
    for t in range(t_bins):
        state, outs = step(state, loads_t[t], caps_t[t])
        agg = lane_update_aggregate(agg, loads_t[t], outs, lim, slo_mode,
                                    fmask_t[t])
    return _carry_end(state, fault), finalize_aggregate(pack_aggregate(agg))
