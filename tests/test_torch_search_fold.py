"""The streaming gradient scan (the fold) with the surrogate on, against
the reference.

Counterpart of the fold cases of ``tests/test_stream_objectives.py`` run
through the smooth branches, a uniform block as search runs it: the
fold's value is bitwise folding the reference's surrogate series, with
and without the fault layer, and its gradients (params, the per-lane
operands) match ``jax.grad`` of the reference's fold within 1e-5
relative — through both backward schedules, with the one stated bound
below.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import twin as pt
from repro_torch.kernels.policy_vjp import policy_grid_scan_fold

from test_torch_search_surrogate import (GRAD_RTOL, all_twins,  # noqa: F401
                                         jref, mixed, outages, rel_err,
                                         schedule, t)
from torch_port_ref import assert_bitwise, one_torch_thread  # noqa: F401

#: the batched backward's bound through hard outages (measured 5.7e-4 on
#: autoscale's d/d params): a dead pipeline divides by the 1e-9 capacity
#: floors, state cotangents reach ~1e12, and the Jacobian chain between
#: segments associates their cancellation otherwise than a sequential
#: backward (``kernels/policy_vjp.py``'s docstring). The search's fault
#: lanes never take that schedule: they run the plain scan under autograd
#: below the streaming size and the sequential schedule above it
PARALLEL_OUTAGE_RTOL = 1e-3


def _sum_init(n, device=None):
    return (torch.zeros(n, dtype=torch.float32, device=device),)


def _sum_fold(acc, arrive, outs, ops_lane, xs_row):
    proc, _queue, lat, cost, drop = outs
    (w,) = ops_lane
    (s,) = acc
    return (s + w * proc + 0.3 * lat + 1.1 * cost + 0.7 * drop
            + 0.1 * arrive,)


def _jsum_init(n):
    import jax.numpy as jnp
    return (jnp.zeros((n,), jnp.float32),)


def _jsum_fold(acc, arrive, outs, ops_lane, xs_row):
    proc, _queue, lat, cost, drop = outs
    (w,) = ops_lane
    (s,) = acc
    return (s + w * proc + 0.3 * lat + 1.1 * cost + 0.7 * drop
            + 0.1 * arrive,)


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("policy", ["quickscale", "autoscale",
                                    "batch_window"])
def test_fold_surrogate_equals_reference(jref, schedule, policy, faulted):
    """The fold with the surrogate on (a uniform block, as search runs
    it; through outages and brownouts too): its value bitwise folding
    the reference's surrogate series, its gradients (params and the
    per-lane weights; the capacity series is data, as in search) within
    1e-5 of ``jax.grad`` of the reference's fold."""
    jax, jnp = jref.jax, jref.jax.numpy
    n, t_bins = 4, 97
    j = pt.policy_spec(policy).index
    rng = np.random.default_rng(5)
    loads, _, _ = mixed(n, t_bins)
    params = (np.tile(all_twins(pt)[j].padded_params(), (n, 1))
              * rng.uniform(0.8, 1.2, (n, 6))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (n,)).astype(np.float32)
    caps = outages(n, t_bins) if faulted else None
    got = {"params": t(params, True), "w": t(w, True)}
    carry, (acc,) = policy_grid_scan_fold(
        t(loads), got["params"], None, 1.0, policy_index=j, surrogate=True,
        caps=None if caps is None else t(caps), fold_init=_sum_init,
        fold_step=_sum_fold, ops_lane=(got["w"],))
    (acc.sum() + carry.sum()).backward()

    c_j, outs = jref.ref.policy_grid_scan(loads, params, None, 1.0,
                                          policy_index=jnp.int32(j),
                                          surrogate=True, caps=caps)
    (s,) = _sum_init(n)
    outs = [torch.from_numpy(np.array(o)) for o in outs]
    for b in range(t_bins):
        (s,) = _sum_fold((s,), t(loads)[:, b], tuple(o[:, b] for o in outs),
                         (t(w),), None)
    assert_bitwise(acc.detach().numpy(), s.numpy(), "fold vs reference")
    assert_bitwise(carry.detach().numpy(), np.asarray(c_j), "carry")

    names = sorted(got)

    def jloss(*vals):
        v = dict(zip(names, vals))
        c, (a,) = jref.policy_vjp.policy_grid_scan_fold(
            jnp.asarray(loads), v["params"], None, 1.0,
            policy_index=jnp.int32(j), surrogate=True, caps=caps,
            fold_init=_jsum_init, fold_step=_jsum_fold, ops_lane=(v["w"],))
        return jnp.sum(a) + jnp.sum(c)

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(got[k].detach().numpy()) for k in names))
    rtol = (PARALLEL_OUTAGE_RTOL if faulted and schedule == "parallel"
            else GRAD_RTOL)
    for k, b in zip(names, want):
        assert rel_err(got[k].grad, b) <= rtol, (k, rel_err(got[k].grad, b))
