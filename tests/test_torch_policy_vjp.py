"""The port's checkpointed gradient scan against ``repro.kernels.policy_vjp``.

Counterparts of ``tests/test_policy_vjp.py``'s non-surrogate cases and of
the fold cases of ``tests/test_stream_objectives.py``:

* the forward is bitwise ``ref.policy_grid_scan`` (the port's, and the
  reference's), mixed grid and uniform block, hourly and sub-hour;
* gradients (params, loads, onehot) match ``jax.grad`` of the reference
  scan within 1e-5 relative (the reference test's guard: the denominator
  is floored at 1e-6 of the largest entry), for all five policies, on a
  horizon the segment plan splits evenly and one with a tail — through
  both backward schedules (segments one at a time, and all at once
  through their Jacobians);
* the fold streams the same loss as folding the materialised series,
  bitwise, benign and with the fault layer, and its gradients (params,
  onehot, caps, per-lane operands, per-bin rows) match ``jax.grad`` of
  the reference's fold within 1e-5;
* nothing lane-major [K, T] is saved for the backward.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import twin as pt
from repro_torch.core.traffic import TrafficModel
from repro_torch.kernels import ops, policy_vjp, ref
from repro_torch.kernels.policy_vjp import (_segment_plan,
                                            policy_grid_scan_ckpt,
                                            policy_grid_scan_fold)

from torch_port_ref import assert_bitwise, one_torch_thread  # noqa: F401
from torch_port_ref import reference

#: mixed weights keep the scalar loss sensitive to every output series
W = (1.0, 0.7, 1.3, -0.5, 0.9)
#: the gradient bound, relative (see ``rel_err``)
GRAD_RTOL = 1e-5
#: (PARALLEL_REMAT_BYTES) of the two backward schedules
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


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    denom = np.maximum(np.abs(b), 1e-6 * max(np.abs(b).max(), 1.0))
    return float((np.abs(a - b) / denom).max())


def weighted(carry, outs, xp):
    return sum(w * xp.sum(o) for w, o in zip(W, outs)) + xp.sum(carry)


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# the forward: bitwise the plain scan
# ---------------------------------------------------------------------------

def test_forward_bitwise_plain_scan_mixed_grid(jref):
    loads, params, idx = mixed(5, 257)
    onehot = pt.policy_onehot(idx)
    c_p, outs_p = ref.policy_grid_scan(t(loads), t(params), t(onehot), 1.0)
    c_k, outs_k = policy_grid_scan_ckpt(t(loads), t(params), t(onehot),
                                        1.0)
    c_j, outs_j = jref.ref.policy_grid_scan(loads, params, onehot, 1.0)
    assert_bitwise(c_k.numpy(), c_p.numpy(), "carry")
    assert_bitwise(c_k.numpy(), np.asarray(c_j), "carry vs reference")
    for k, (a, b, j) in enumerate(zip(outs_k, outs_p, outs_j)):
        assert_bitwise(a.numpy(), b.numpy(), f"series {k}")
        assert_bitwise(a.numpy(), np.asarray(j), f"series {k} vs reference")


def test_forward_bitwise_uniform_block_subhour(jref):
    jnp = jref.jax.numpy
    loads, _, _ = mixed(4, 97)
    for j, tw in enumerate(all_twins(pt)):
        p = np.tile(tw.padded_params(), (4, 1)).astype(np.float32)
        c_p, outs_p = ref.policy_grid_scan(t(loads), t(p), None, 1.0 / 60.0,
                                           policy_index=j)
        c_k, outs_k = policy_grid_scan_ckpt(t(loads), t(p), None,
                                            1.0 / 60.0, policy_index=j)
        c_j, outs_j = jref.policy_vjp.policy_grid_scan_ckpt(
            loads, p, None, 1.0 / 60.0, policy_index=jnp.int32(j))
        assert_bitwise(c_k.numpy(), c_p.numpy(), f"{tw.policy} carry")
        assert_bitwise(c_k.numpy(), np.asarray(c_j), f"{tw.policy} ref")
        for k, (a, b, r) in enumerate(zip(outs_k, outs_p, outs_j)):
            assert_bitwise(a.numpy(), b.numpy(), f"{tw.policy} {k}")
            assert_bitwise(a.numpy(), np.asarray(r), f"{tw.policy} {k} ref")


# ---------------------------------------------------------------------------
# gradients against jax.grad of the reference scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_bins", [97, 256])
def test_grad_parity_mixed_onehot(jref, schedule, t_bins):
    # 97 leaves a tail segment (9 * 10 + 7); 256 splits evenly (16 * 16)
    _, _, tail = _segment_plan(t_bins)
    assert (tail > 0) == (t_bins == 97)
    jax, jnp = jref.jax, jref.jax.numpy
    loads, params, idx = mixed(5, t_bins)
    onehot = pt.policy_onehot(idx)

    def jloss(L, P, O):
        return weighted(*jref.ref.policy_grid_scan(L, P, O, 1.0), jnp)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(loads), jnp.asarray(params), jnp.asarray(onehot))
    got = [t(loads, True), t(params, True), t(onehot, True)]
    weighted(*policy_grid_scan_ckpt(*got[:3], 1.0), torch).backward()
    for name, a, b in zip(("loads", "params", "onehot"), got, want):
        assert rel_err(a.grad, b) <= GRAD_RTOL, (name, t_bins,
                                                 rel_err(a.grad, b))


def test_grad_parity_uniform_block_all_policies(jref, schedule):
    jax, jnp = jref.jax, jref.jax.numpy
    loads, _, _ = mixed(4, 97)
    for j, tw in enumerate(all_twins(pt)):
        p = np.tile(tw.padded_params(), (4, 1)).astype(np.float32)

        def jloss(L, P):
            return weighted(*jref.ref.policy_grid_scan(
                L, P, None, 0.25, policy_index=jnp.int32(j)), jnp)

        want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jnp.asarray(loads), jnp.asarray(p))
        got = [t(loads, True), t(p, True)]
        weighted(*policy_grid_scan_ckpt(*got, None, 0.25, policy_index=j),
                 torch).backward()
        for name, a, b in zip(("loads", "params"), got, want):
            assert rel_err(a.grad, b) <= GRAD_RTOL, (tw.policy, name,
                                                     rel_err(a.grad, b))


def test_schedules_agree():
    """Both backward schedules give the gradient of plain autograd
    through the whole scan, within float32 reassociation."""
    loads, params, idx = mixed(5, 150)
    onehot = pt.policy_onehot(idx)
    grads = {}
    for name, budget in SCHEDULES.items():
        policy_vjp.PARALLEL_REMAT_BYTES = budget
        try:
            got = [t(loads, True), t(params, True), t(onehot, True)]
            weighted(*policy_grid_scan_ckpt(*got, 1.0), torch).backward()
        finally:
            policy_vjp.PARALLEL_REMAT_BYTES = SCHEDULES["parallel"]
        grads[name] = [x.grad for x in got]
    plain = [t(loads, True), t(params, True), t(onehot, True)]
    weighted(*ref.policy_grid_scan(*plain, 1.0), torch).backward()
    for name, gs in grads.items():
        for what, a, b in zip(("loads", "params", "onehot"), gs, plain):
            assert rel_err(a, b.grad) <= GRAD_RTOL, (name, what)
    # one segment at a time sums the gradient in plain autograd's order
    for a, b in zip(grads["sequential"][:2], plain[:2]):
        assert_bitwise(a.numpy(), b.grad.numpy(), "sequential vs plain")


def test_segment_plan_shapes(jref):
    for t_bins in (1, 2, 97, 100, 256, 8736):
        seg, nseg, tail = _segment_plan(t_bins)
        assert seg * nseg + tail == t_bins
        assert seg >= 1 and nseg >= 1 and 0 <= tail < seg
        assert (seg, nseg, tail) == jref.policy_vjp._segment_plan(t_bins)


def test_selector_ambiguity_rejected():
    loads, params, idx = mixed(3, 10)
    with pytest.raises(ValueError, match="exactly one"):
        policy_grid_scan_ckpt(t(loads), t(params))
    with pytest.raises(ValueError, match="exactly one"):
        policy_grid_scan_ckpt(t(loads), t(params), t(pt.policy_onehot(idx)),
                              policy_index=0)
    with pytest.raises(ValueError, match="exactly one"):
        policy_grid_scan_fold(t(loads), t(params), fold_init=_sum_init,
                              fold_step=_sum_fold)
    with pytest.raises(ValueError, match="exactly one"):
        policy_grid_scan_ckpt(t(loads), t(params), surrogate=True)


def test_ops_routes_differentiable_scan_through_ckpt(monkeypatch):
    loads, params, idx = mixed(5, 97)
    onehot = t(pt.policy_onehot(idx))
    calls = []
    orig = policy_vjp.policy_grid_scan_ckpt

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(policy_vjp, "policy_grid_scan_ckpt", spy)
    c, outs = ops.policy_scan(t(loads), t(params), onehot, 1.0,
                              differentiable=True)
    assert calls, "a differentiable scan must take the checkpointed path"
    c_r, outs_r = ref.policy_grid_scan(t(loads), t(params), onehot, 1.0)
    assert_bitwise(c.numpy(), c_r.numpy(), "carry")
    for a, b in zip(outs, outs_r):
        assert_bitwise(a.numpy(), b.numpy(), "series")


# ---------------------------------------------------------------------------
# the fold: stream == materialise-then-fold, gradients vs the reference
# ---------------------------------------------------------------------------

def _sum_init(n, device=None):
    return (torch.zeros(n, dtype=torch.float32, device=device),)


def _sum_fold(acc, arrive, outs, ops_lane, xs_row):
    proc, _queue, lat, cost, drop = outs
    (w,) = ops_lane
    (s,) = acc
    return (s + w * proc + 0.3 * lat + 1.1 * cost + 0.7 * drop
            + 0.1 * arrive + xs_row,)


def _jsum_init(n):
    import jax.numpy as jnp
    return (jnp.zeros((n,), jnp.float32),)


def _jsum_fold(acc, arrive, outs, ops_lane, xs_row):
    proc, _queue, lat, cost, drop = outs
    (w,) = ops_lane
    (s,) = acc
    return (s + w * proc + 0.3 * lat + 1.1 * cost + 0.7 * drop
            + 0.1 * arrive + xs_row[0],)


def _fold_problem(n, t_bins, selector, faulted):
    """The inputs of the reference's fold test
    (``test_fold_mixed_onehot_matches_materialized``): light loads, every
    policy on a lane (or shed on all of them), outages on a tenth of the
    bins."""
    rng = np.random.default_rng(2)
    loads = rng.uniform(0.2, 3.0, (n, t_bins)).astype(np.float32)
    twins = all_twins(pt)
    if selector == "uniform":
        params = np.tile(twins[3].padded_params(), (n, 1)) \
            * rng.uniform(0.8, 1.2, (n, 1))
    else:
        params = np.stack([tw.padded_params() for tw in twins])
    w = rng.uniform(0.5, 1.5, (n,)).astype(np.float32)
    xs = rng.uniform(0, 1, (t_bins,)).astype(np.float32)
    caps = (rng.choice([0.0, 1.0], (n, t_bins), p=[0.1, 0.9])
            .astype(np.float32) if faulted else None)
    return loads, params.astype(np.float32), w, xs, caps


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("selector", ["mixed", "uniform"])
def test_fold_equals_materialised_and_reference(jref, schedule, faulted,
                                                selector):
    """The fold's value is bitwise folding the materialised series (the
    port's ``ref.policy_grid_scan``, the same rounding on the fault
    layer), and its gradients — params, onehot, caps, the per-lane
    weights and the per-bin rows — match ``jax.grad`` of the reference's
    ``policy_grid_scan_fold`` within 1e-5."""
    jax, jnp = jref.jax, jref.jax.numpy
    n, t_bins = 5, 97
    loads, params, w, xs, caps = _fold_problem(n, t_bins, selector,
                                               faulted)
    if selector == "uniform":
        sel, jsel, onehot = (dict(policy_index=3),
                             dict(policy_index=jnp.int32(3)), None)
    else:
        sel, jsel = {}, {}
        onehot = pt.policy_onehot(np.arange(n))

    got = {"params": t(params, True), "w": t(w, True), "xs": t(xs, True)}
    if onehot is not None:
        got["onehot"] = t(onehot, True)
    if faulted:
        got["caps"] = t(caps, True)
    carry, (acc,) = policy_grid_scan_fold(
        t(loads), got["params"], got.get("onehot"), 1.0,
        caps=got.get("caps"), fold_init=_sum_init, fold_step=_sum_fold,
        ops_lane=(got["w"],), xs=got["xs"], **sel)
    (acc.sum() + carry.sum()).backward()

    # materialise, then fold the same rows
    c_m, outs = ref.policy_grid_scan(
        t(loads), t(params), None if onehot is None else t(onehot), 1.0,
        caps=None if caps is None else t(caps), **sel)
    (s,) = _sum_init(n)
    for b in range(t_bins):
        (s,) = _sum_fold((s,), t(loads)[:, b], tuple(o[:, b] for o in outs),
                         (t(w),), t(xs)[b])
    assert_bitwise(acc.detach().numpy(), s.numpy(), "fold vs materialised")
    assert_bitwise(carry.detach().numpy(), c_m.numpy(), "carry")

    names = sorted(got)

    def jloss(*vals):
        v = dict(zip(names, vals))
        c, (a,) = jref.policy_vjp.policy_grid_scan_fold(
            jnp.asarray(loads), v["params"], v.get("onehot"), 1.0,
            caps=v.get("caps"), fold_init=_jsum_init, fold_step=_jsum_fold,
            ops_lane=(v["w"],), xs=(v["xs"],), **jsel)
        return jnp.sum(a) + jnp.sum(c)

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(got[k].detach().numpy()) for k in names))
    for k, b in zip(names, want):
        assert rel_err(got[k].grad, b) <= GRAD_RTOL, (k, rel_err(
            got[k].grad, b))


def test_declared_sinks_change_no_gradient(monkeypatch):
    """A fold whose compensated triple is declared a sink (one lane
    replica for all its slots in the batched backward) gets the gradient
    it gets without the declaration."""
    from repro_torch.core.twin import (fold_triple_add, fold_triple_init,
                                       fold_triple_finalize)

    def init(n, device=None):
        return (torch.zeros(n, device=device),
                fold_triple_init((n,), device))

    def fold(acc, arrive, outs, ops_lane, xs_row):
        cum, tri = acc
        cum = cum + outs[0]
        r = torch.log((cum + 1.0) / xs_row) * outs[2]
        return cum, fold_triple_add(tri, r * r)

    loads, params, idx = mixed(4, 120)
    xs = t(np.linspace(1.0, 5e5, 120).astype(np.float32))
    grads = []
    for sinks in ((), (1, 2, 3)):
        p = t(params, True)
        _, (_, tri) = policy_grid_scan_fold(
            t(loads), p, t(pt.policy_onehot(idx)), 1.0, fold_init=init,
            fold_step=fold, xs=xs, acc_sinks=sinks)
        fold_triple_finalize(tri).sum().backward()
        grads.append(p.grad)
    assert rel_err(grads[1], grads[0]) <= 1e-6


def test_no_lane_major_series_is_saved(schedule):
    """Counterpart of the reference's no-[L, T]-in-the-jaxpr check: what
    the streamed scan saves for its backward, and what its backward's
    rematerialisations save, holds no [K, T]-shaped tensor — the
    scenario-minor [T, K] operands are the caller's, and besides them
    only O(K) per-segment states are kept."""
    k, t_bins = 3, 256
    loads, params, _ = mixed(k, t_bins)
    shapes = []

    def pack(x):
        shapes.append(tuple(x.shape))
        return x

    loads_t = t(np.ascontiguousarray(loads.T))
    p = t(params, True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        _, (acc,) = policy_grid_scan_fold(
            None, p, None, 1.0, policy_index=2, loads_t=loads_t,
            fold_init=_sum_init, fold_step=_sum_fold,
            ops_lane=(t(np.ones(k, np.float32)),),
            xs=t(np.zeros(t_bins, np.float32)))
        acc.sum().backward()
    assert shapes and (k, t_bins) not in shapes
    big = [s for s in shapes if t_bins in s and s != (t_bins, k)
           and s != (t_bins,)]
    assert not big, big
    assert torch.isfinite(p.grad).all()


def test_shed_overflow_tie_gradient_matches_reference(jref):
    """At a full queue with no capacity (an outage: backlog and cap both
    0) shed's overflow ``max(backlog - qmax, 0)`` sits on its tie; the
    port passes half the gradient there, as ``jnp.maximum`` does."""
    jax, jnp = jref.jax, jref.jax.numpy
    shed = jref.twin.policy_spec("shed").lane_step
    p = np.array([[0.0, 0.01, 0.2, 1.5, 0, 0], [2.0, 0.01, 0.2, 1.5, 0, 0]],
                 np.float32)
    carry = np.zeros((2, 2), np.float32)
    arrive = np.zeros(2, np.float32)

    def jdrop(pp):
        return jnp.sum(shed(jnp.asarray(carry), jnp.asarray(arrive), pp,
                            jnp.float32(1.0))[1][4])

    want = np.asarray(jax.grad(jdrop)(jnp.asarray(p)))
    pp = t(p, True)
    pt.policy_spec("shed").lane_step(t(carry), t(arrive), pp,
                                     torch.tensor(1.0))[1][4].sum().backward()
    assert_bitwise(pp.grad.numpy(), want, "d dropped / d params")


def test_fma_gradient_is_the_plain_products():
    """``_fma`` (batch_window's fused latency, shed's fused overflow under
    faults) differentiates as ``a * b + c``, through no derivative that a
    PyTorch release may lack (``nextafter``'s is missing from some)."""
    rng = np.random.default_rng(4)
    a, b, c = (t(rng.uniform(-5, 5, 1000).astype(np.float32), True)
               for _ in range(3))
    out = pt._fma(a, b, c)
    seen, stack = set(), [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack += [f for f, _ in node.next_functions]
    assert not [n for n in seen if "extafter" in type(n).__name__]
    out.sum().backward()
    assert_bitwise(a.grad.numpy(), b.detach().numpy(), "d/da")
    assert_bitwise(b.grad.numpy(), a.detach().numpy(), "d/db")
    assert_bitwise(c.grad.numpy(), np.ones(1000, np.float32), "d/dc")
