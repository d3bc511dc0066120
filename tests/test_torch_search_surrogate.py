"""The smooth surrogate lane steps of policy search against the reference.

Counterparts of the surrogate cases of ``tests/test_policy_vjp.py``
(``test_forward_bit_identical_to_ref_mixed_grid[True]``,
``test_grad_parity_uniform_index_all_policies_jit[True]``), of the
registry audit of ``tests/test_search.py`` (the fold with the surrogate
on is in ``test_torch_search_fold.py``):

* the surrogate scans' values are bitwise the reference's: mixed grid
  and uniform blocks, hourly and sub-hour, with and without the fault
  layer, through the plain scan and the checkpointed scan.
  batch_window's flush gate needs the reference's rounding written out
  (XLA:CPU's exp, flush-to-zero, the mixed scans' fused multiply-add;
  ``core.twin._batch_window_lane_smooth``);
* gradients match ``jax.grad`` of the reference within 1e-5 relative
  (denominator floored at 1e-6 of the largest entry), through both
  backward schedules;
* every registered policy has a surrogate, a distinct one where it flags
  hard-gated parameters, and registration checks it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import twin as pt
from repro_torch.core.traffic import TrafficModel
from repro_torch.kernels import ops, policy_vjp, ref
from repro_torch.kernels.policy_vjp import (policy_grid_scan_ckpt,
                                            policy_grid_scan_fold)

from torch_port_ref import assert_bitwise, one_torch_thread  # noqa: F401
from torch_port_ref import reference

W = (1.0, 0.7, 1.3, -0.5, 0.9)
GRAD_RTOL = 1e-5
#: the batched backward's bound on d/d loads of the surrogate scans
#: (measured 1.04e-5: autoscale, lane 0, bin 80, 0.0914 out of per-bin
#: terms of ~5 that cancel; the Jacobian chain between segments
#: associates them otherwise than a sequential backward, which is within
#: 1.4e-6 there). d/d params, what search follows, holds GRAD_RTOL
PARALLEL_LOADS_RTOL = 2e-5
SCHEDULES = {"sequential": 0, "parallel": 64 << 20}


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


@pytest.fixture(params=sorted(SCHEDULES))
def schedule(request, monkeypatch):
    monkeypatch.setattr(policy_vjp, "PARALLEL_REMAT_BYTES",
                        SCHEDULES[request.param])
    return request.param


def all_twins(tw):
    return [tw.SimpleTwin("fifo", 1.9512, 0.0082, 0.15),
            tw.QuickscalingTwin("quick", 1.9512, 0.0082, 0.15),
            tw.make_twin("auto", "autoscale", max_rps=0.5,
                         usd_per_hour=0.002, base_latency_s=0.1,
                         max_instances=32, scale_up_hours=3),
            tw.make_twin("shed", "shed", max_rps=1.0, usd_per_hour=0.0082,
                         base_latency_s=0.15, queue_cap_hours=2),
            tw.make_twin("batch", "batch_window", max_rps=6.15,
                         usd_per_hour=0.0703, base_latency_s=0.06,
                         window_hours=6)]


def mixed(n, t_bins):
    twins = [all_twins(pt)[i % 5] for i in range(n)]
    hl = TrafficModel.honda_default("nom").hourly_loads()[:t_bins]
    loads = np.stack([hl * (1.0 + 0.1 * i) for i in range(n)]) \
        .astype(np.float32)
    params = np.stack([tw.padded_params() for tw in twins]) \
        .astype(np.float32)
    idx = np.asarray([tw.policy_index for tw in twins], np.int32)
    return loads, params, idx


def outages(n, t_bins, seed=2):
    rng = np.random.default_rng(seed)
    return rng.choice([0.0, 0.5, 1.0], (n, t_bins),
                      p=[0.1, 0.1, 0.8]).astype(np.float32)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    denom = np.maximum(np.abs(b), 1e-6 * max(np.abs(b).max(), 1.0))
    return float((np.abs(a - b) / denom).max())


def weighted(carry, outs, xp):
    return sum(w * xp.sum(o) for w, o in zip(W, outs)) + xp.sum(carry)


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def assert_scan_bitwise(got, want, what):
    (c_p, outs_p), (c_j, outs_j) = got, want
    assert_bitwise(c_p.detach().numpy(), np.asarray(c_j), f"{what} carry")
    for k, (a, b) in enumerate(zip(outs_p, outs_j)):
        assert_bitwise(a.detach().numpy(), np.asarray(b), f"{what} {k}")


# ---------------------------------------------------------------------------
# values: bitwise the reference's surrogate scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faulted", [False, True])
def test_forward_bitwise_reference_mixed_grid(jref, faulted):
    """``test_forward_bit_identical_to_ref_mixed_grid[True]``: the plain
    and the checkpointed surrogate scans equal the reference's, every
    policy on a lane, 257 hourly bins (and through outages)."""
    loads, params, idx = mixed(5, 257)
    onehot = pt.policy_onehot(idx)
    caps = outages(5, 257) if faulted else None
    want = jref.ref.policy_grid_scan(loads, params, onehot, 1.0,
                                     surrogate=True, caps=caps)
    got = ref.policy_grid_scan(t(loads), t(params), t(onehot), 1.0,
                               surrogate=True,
                               caps=None if caps is None else t(caps))
    assert_scan_bitwise(got, want, "plain")
    if not faulted:
        got = policy_grid_scan_ckpt(t(loads), t(params), t(onehot), 1.0,
                                    surrogate=True)
        assert_scan_bitwise(got, want, "ckpt")


@pytest.mark.parametrize("dt", [1.0, 0.25, 1.0 / 60.0])
def test_forward_bitwise_reference_uniform_blocks(jref, dt):
    jnp = jref.jax.numpy
    loads, _, _ = mixed(4, 97)
    caps = outages(4, 97)
    for j, tw in enumerate(all_twins(pt)):
        p = np.tile(tw.padded_params(), (4, 1)).astype(np.float32)
        for c in (None, caps):
            want = jref.ref.policy_grid_scan(
                loads, p, None, dt, policy_index=jnp.int32(j),
                surrogate=True, caps=c)
            got = ops.policy_scan(t(loads), t(p), dt_hours=dt,
                                  policy_index=j, surrogate=True,
                                  caps_t=None if c is None else t(c.T))
            assert_scan_bitwise(got, want, f"{tw.policy} caps="
                                           f"{c is not None}")


def test_surrogate_differs_from_exact_where_it_should():
    """The smooth branches are not the exact ones: the fluid instance
    counts and the sigmoid flush change cost; fifo and shed are their
    own surrogates."""
    loads, _, _ = mixed(2, 97)
    for j, tw in enumerate(all_twins(pt)):
        p = t(np.tile(tw.padded_params(), (2, 1)).astype(np.float32))
        exact = ref.policy_grid_scan(t(loads), p, policy_index=j)[1][3]
        smooth = ref.policy_grid_scan(t(loads), p, policy_index=j,
                                      surrogate=True)[1][3]
        same = torch.equal(exact, smooth)
        assert same == (tw.policy in ("fifo", "shed")), tw.policy


# ---------------------------------------------------------------------------
# gradients against jax.grad of the reference's surrogate scan
# ---------------------------------------------------------------------------

def test_grad_parity_uniform_block_all_policies(jref, schedule):
    """``test_grad_parity_uniform_index_all_policies_jit[True]``: loads
    and params, every policy, 97 bins at dt 0.25 (a tail segment)."""
    jax, jnp = jref.jax, jref.jax.numpy
    loads, _, _ = mixed(4, 97)
    for j, tw in enumerate(all_twins(pt)):
        p = np.tile(tw.padded_params(), (4, 1)).astype(np.float32)

        def jloss(L, P):
            return weighted(*jref.ref.policy_grid_scan(
                L, P, None, 0.25, policy_index=jnp.int32(j),
                surrogate=True), jnp)

        want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jnp.asarray(loads), jnp.asarray(p))
        got = [t(loads, True), t(p, True)]
        weighted(*policy_grid_scan_ckpt(*got, None, 0.25, policy_index=j,
                                        surrogate=True), torch).backward()
        for name, a, b in zip(("loads", "params"), got, want):
            rtol = (PARALLEL_LOADS_RTOL if (name, schedule)
                    == ("loads", "parallel") else GRAD_RTOL)
            assert rel_err(a.grad, b) <= rtol, (tw.policy, name,
                                                rel_err(a.grad, b))


def test_grad_parity_mixed_onehot(jref, schedule):
    jax, jnp = jref.jax, jref.jax.numpy
    loads, params, idx = mixed(5, 97)
    onehot = pt.policy_onehot(idx)

    def jloss(L, P, O):
        return weighted(*jref.ref.policy_grid_scan(L, P, O, 1.0,
                                                   surrogate=True), jnp)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(loads), jnp.asarray(params), jnp.asarray(onehot))
    got = [t(loads, True), t(params, True), t(onehot, True)]
    weighted(*policy_grid_scan_ckpt(*got, 1.0, surrogate=True),
             torch).backward()
    for name, a, b in zip(("loads", "params", "onehot"), got, want):
        assert rel_err(a.grad, b) <= GRAD_RTOL, (name, rel_err(a.grad, b))


# ---------------------------------------------------------------------------
# the registry audit
# ---------------------------------------------------------------------------

def test_registry_surrogate_audit():
    for name in pt.policy_names():
        spec = pt.policy_spec(name)
        assert set(spec.nondiff_params) <= set(spec.param_names)
        assert spec.surrogate_lane_step is not None
        if spec.nondiff_params:
            assert spec.surrogate_lane_step is not spec.lane_step
        else:
            assert spec.surrogate_lane_step is spec.lane_step
    assert pt.surrogate_lane_branches() == tuple(
        pt.policy_spec(n).surrogate_lane_step for n in pt.policy_names())


def test_registry_audit_matches_reference(jref):
    for name in pt.policy_names():
        assert (pt.policy_spec(name).nondiff_params
                == jref.twin.policy_spec(name).nondiff_params), name


def test_surrogate_carries_gradients_for_hard_gated_params():
    loads = t(np.maximum(4000.0 + 3000.0 * np.sin(
        2 * np.pi * np.arange(336) / 24.0), 50.0).astype(np.float32)[None])
    spec = pt.policy_spec("batch_window")
    base = pt.make_twin("b", "batch_window", max_rps=2.5, usd_per_hour=0.01,
                        base_latency_s=0.2, window_hours=6.0)
    widx = spec.param_names.index("window_hours")
    grads = {}
    for surrogate in (False, True):
        p = t(base.padded_params()[None], True)
        _, (_p, _q, lat, cost, _d) = ops.policy_scan(
            loads, p, dt_hours=1.0, policy_index=spec.index,
            differentiable=True, surrogate=surrogate)
        (cost.sum() + 1e-6 * lat.sum()).backward()
        grads[surrogate] = p.grad[0]
    assert torch.isfinite(grads[True]).all()
    assert grads[True][widx] != 0.0, "surrogate lost the window gradient"
    assert grads[True][widx] != grads[False][widx]


def test_register_policy_validates_the_surrogate():
    def step(carry, arrive, p, dt):
        z = torch.zeros_like(arrive)
        return carry, (arrive, z, p[:, 2], p[:, 1] * dt, z)

    names = ("max_rps", "usd_per_hour", "base_latency_s", "knob")
    with pytest.raises(ValueError, match=r"nondiff_params \['nope'\] not in"):
        pt.register_policy("surr_a", names, nondiff_params=("nope",))(step)
    with pytest.raises(ValueError, match="supplies no surrogate_lane_step"):
        pt.register_policy("surr_b", names, nondiff_params=("knob",))(step)

    def bad(carry, arrive, p, dt):
        c, outs = step(carry, arrive, p, dt)
        return c, (outs[0], outs[1], torch.log(p[:, 3] - 100.0), outs[3],
                   outs[4])

    with pytest.raises(AssertionError, match="non-finite"):
        pt.register_policy("surr_c", names, nondiff_params=("knob",),
                           surrogate_lane_step=bad)(step)
    assert not {"surr_a", "surr_b", "surr_c"} & set(pt.policy_names())


def test_xla_exp_is_bitwise_xla_cpu(jref):
    """The gate's exp, over the range the logistic reaches (and past its
    clamps), against XLA:CPU's jitted ``jnp.exp``."""
    jax, jnp = jref.jax, jref.jax.numpy
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-100.0, 100.0, 50000),
                        rng.uniform(-3.0, 3.0, 50000),
                        [0.0, -0.0, 88.7, 88.8, -87.3, -87.8, -100.0]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    assert_bitwise(pt._xla_exp(t(x)).numpy(), want, "exp")
    want = np.asarray(jax.jit(jax.nn.sigmoid)(jnp.asarray(x)))
    assert_bitwise(pt._logistic(t(x)).numpy(), want, "sigmoid")
