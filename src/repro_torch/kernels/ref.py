"""Plain PyTorch versions of the policy-scan kernels.

Counterparts: ``repro.kernels.ref.policy_grid_scan`` / ``policy_grid_agg``.
A Python loop over the T bins steps all N scenarios at once through the
lane steps of ``repro_torch.core.twin`` — the same arithmetic, in the same
order, as the reference, so on the CPU the results are bitwise the JAX
package's. The CPU path of the port runs these; ``chip_smoke.py`` holds
the CUDA kernels (``kernels/csrc/policy_scan.cu``) against them on the
card. No fault streams (``caps``/``fmask``) and no surrogate branches yet.

The branch selector is exactly one of ``onehot`` [N, P] (mixed grid: the
masked blend ``lane_policy_step``) or ``policy_index`` (an int: one lane
step for a uniform block, selected without the blend).
"""
from __future__ import annotations

import torch

from repro_torch.core.twin import (CARRY_DIM, finalize_aggregate,
                                   init_aggregate, lane_branches,
                                   lane_policy_step, lane_update_aggregate,
                                   pack_aggregate)


def _bin_step(params, onehot, policy_index, dt):
    if (onehot is None) == (policy_index is None):
        raise ValueError("pass exactly one of onehot= (mixed grid) or "
                         "policy_index= (uniform lane block)")
    branches = lane_branches()
    if onehot is not None:
        columns = torch.nonzero(onehot.any(dim=0)).flatten().tolist()
        return lambda carry, arrive: lane_policy_step(
            carry, arrive, params, onehot, dt, branches, columns)
    lstep = branches[int(policy_index)]
    return lambda carry, arrive: lstep(carry, arrive, params, dt)


def policy_grid_scan(loads: torch.Tensor, params: torch.Tensor,
                     onehot: torch.Tensor = None, dt_hours=1.0,
                     policy_index=None):
    """loads [N, T] records/bin, params [N, PARAM_DIM] -> (carry_end
    [N, CARRY_DIM], (processed, queue, latency, cost, dropped)), each
    series [N, T] (a transposed view of a scenario-minor [T, N] buffer,
    the kernel's layout)."""
    n, t_bins = loads.shape
    dt = torch.tensor(dt_hours, dtype=torch.float32, device=loads.device)
    step = _bin_step(params, onehot, policy_index, dt)
    loads_t = loads.t().contiguous()
    series = torch.empty((5, t_bins, n), dtype=torch.float32,
                         device=loads.device)
    carry = torch.zeros((n, CARRY_DIM), dtype=torch.float32,
                        device=loads.device)
    for t in range(t_bins):
        carry, outs = step(carry, loads_t[t])
        for k, o in enumerate(outs):
            series[k, t] = o
    return carry, tuple(series[k].t() for k in range(5))


def policy_grid_agg(loads: torch.Tensor, params: torch.Tensor,
                    onehot: torch.Tensor = None, dt_hours=1.0, *,
                    policy_index=None, slo_limit: float = float("inf"),
                    slo_mode: int = 0):
    """Streaming-aggregate scan: same operands and selector as
    ``policy_grid_scan``, but the Table II statistics fold into the scan
    state (``core.twin.lane_update_aggregate``) and no series is kept.
    ``slo_limit`` is compared in float32. Returns (carry_end
    [N, CARRY_DIM], agg [N, AGG_DIM]) — the compensated histogram triples
    recombined in f64 by ``finalize_aggregate``."""
    n, t_bins = loads.shape
    dev = loads.device
    dt = torch.tensor(dt_hours, dtype=torch.float32, device=dev)
    lim = torch.tensor(slo_limit, dtype=torch.float32, device=dev)
    step = _bin_step(params, onehot, policy_index, dt)
    loads_t = loads.t().contiguous()
    carry = torch.zeros((n, CARRY_DIM), dtype=torch.float32, device=dev)
    agg = init_aggregate(n, dev)
    for t in range(t_bins):
        carry, outs = step(carry, loads_t[t])
        agg = lane_update_aggregate(agg, loads_t[t], outs, lim, slo_mode)
    return carry, finalize_aggregate(pack_aggregate(agg))
