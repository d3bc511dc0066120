"""The port's twin arithmetic against ``repro.core.twin``, bit for bit.

Every lane step, the blended ``lane_policy_step``, ``lane_update_aggregate``
(scalar slots and histogram), ``_hist_bucket`` and ``finalize_aggregate``,
at bin widths 1 h and 1 min, on random blocks whose lanes carry foreign
parameters in every slot. The reference runs each step inside a jitted
``lax.scan`` — the context its grid scans compile it in (see the note above
the port's lane steps) — and the port steps the same bins eagerly. Inputs
come from a numpy seed and go to both packages.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import traffic as port_traffic
from repro_torch.core import twin as pt

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import assert_bitwise, reference

POLICIES = ["fifo", "quickscale", "autoscale", "shed", "batch_window"]
DTS = [1.0, 1.0 / 60.0]
LANES, BINS = 64, 12


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _block(seed: int):
    rng = np.random.default_rng(seed)
    carry = rng.uniform(0.0, 5e4, (LANES, pt.CARRY_DIM)).astype(np.float32)
    arrive = rng.uniform(0.0, 2e5, (BINS, LANES)).astype(np.float32)
    params = rng.uniform(0.05, 8.0, (LANES, pt.PARAM_DIM)).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, LANES)]
    onehot[:3] = 0.0                 # all-zero mask rows blend to zeros
    return carry, arrive, params, onehot


def _jax_scan(ref, step, carry, arrive, operands, dt):
    """The reference step over the bins, as its scans compile it: a
    jitted ``lax.scan`` with the bin width a trace constant and the
    per-lane operands (params, one-hot) arguments — constants would let
    XLA fold the parameter-only terms, which its scans never see."""
    jax = ref.jax
    dt_f = jax.numpy.float32(dt)

    def run(c, a, ops):
        return jax.lax.scan(lambda c_, a_: step(c_, a_, ops, dt_f), c, a)

    carry, outs = jax.jit(run)(carry, arrive, operands)
    return np.asarray(carry), [np.asarray(o) for o in outs]


def _port_scan(step, carry, arrive, dt):
    dt_t = torch.tensor(dt, dtype=torch.float32)
    c = torch.from_numpy(carry)
    outs = []
    for a in torch.from_numpy(arrive):
        c, o = step(c, a, dt_t)
        outs.append(torch.stack(o))
    return c.numpy(), [o.numpy() for o in torch.stack(outs).unbind(1)]


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("policy", POLICIES)
def test_lane_step_bitwise(ref, policy, dt):
    carry, arrive, params, _ = _block(POLICIES.index(policy))
    j_step = ref.twin.policy_spec(policy).lane_step
    p_step = pt.policy_spec(policy).lane_step
    pp = torch.from_numpy(params)
    cj, oj = _jax_scan(ref, lambda c, a, p, d: j_step(c, a, p, d), carry,
                       arrive, params, dt)
    cp, op = _port_scan(lambda c, a, d: p_step(c, a, pp, d), carry, arrive,
                        dt)
    assert_bitwise(cp, cj, f"{policy} carry")
    for k, (a, b) in enumerate(zip(op, oj)):
        assert_bitwise(a, b, f"{policy} output {k}")
    if policy == "shed":
        assert (oj[4] > 0).any()     # the block really sheds records


@pytest.mark.parametrize("dt", DTS)
def test_lane_policy_step_bitwise(ref, dt):
    carry, arrive, params, onehot = _block(11)
    pp, po = torch.from_numpy(params), torch.from_numpy(onehot)
    cj, oj = _jax_scan(
        ref, lambda c, a, ops, d: ref.twin.lane_policy_step(c, a, *ops, d),
        carry, arrive, (params, onehot), dt)
    for columns in (None, [0, 1, 2, 3, 4]):
        cp, op = _port_scan(
            lambda c, a, d: pt.lane_policy_step(c, a, pp, po, d,
                                                columns=columns),
            carry, arrive, dt)
        assert_bitwise(cp, cj, "blend carry")
        for k, (a, b) in enumerate(zip(op, oj)):
            assert_bitwise(a, b, f"blend output {k}")


def test_unselected_columns_skip_without_changing_bits():
    carry, arrive, params, _ = _block(12)
    onehot = np.eye(5, dtype=np.float32)[np.full(LANES, 3)]   # shed only
    pp, po = torch.from_numpy(params), torch.from_numpy(onehot)
    full = _port_scan(lambda c, a, d: pt.lane_policy_step(c, a, pp, po, d),
                      carry, arrive, 1.0)
    only = _port_scan(lambda c, a, d: pt.lane_policy_step(
        c, a, pp, po, d, columns=[3]), carry, arrive, 1.0)
    assert_bitwise(only[0], full[0])
    for a, b in zip(only[1], full[1]):
        assert_bitwise(a, b)


@pytest.mark.parametrize("slo_mode,slo_limit", [(0, 4 * 3600.0), (1, 0.01)])
@pytest.mark.parametrize("dt", DTS)
def test_lane_update_aggregate_bitwise(ref, dt, slo_mode, slo_limit):
    _, arrive, params, onehot = _block(21)
    jax, jnp = ref.jax, ref.jax.numpy
    dt_f = jnp.float32(dt)

    def j_run(state, arrive, jp, jo):
        def j_bin(state, a):
            carry, agg = state
            carry, outs = ref.twin.lane_policy_step(carry, a, jp, jo, dt_f)
            return (carry, ref.twin.lane_update_aggregate(
                agg, a, outs, slo_limit, slo_mode)), None
        return jax.lax.scan(j_bin, state, arrive)

    j_state = (jnp.zeros((LANES, 2), jnp.float32),
               ref.twin.init_aggregate((LANES,)))
    (_, j_agg), _ = jax.jit(j_run)(j_state, arrive, params, onehot)
    j_packed = np.asarray(ref.twin.pack_aggregate(j_agg))

    pp, po = torch.from_numpy(params), torch.from_numpy(onehot)
    dt_t = torch.tensor(dt, dtype=torch.float32)
    carry, agg = torch.zeros((LANES, 2)), pt.init_aggregate(LANES)
    for a in torch.from_numpy(arrive):
        carry, outs = pt.lane_policy_step(carry, a, pp, po, dt_t)
        agg = pt.lane_update_aggregate(agg, a, outs, slo_limit, slo_mode)
    p_packed = pt.pack_aggregate(agg)
    assert_bitwise(p_packed.numpy(), j_packed, "packed aggregate")
    # pack/unpack round-trip in the port's own layout
    assert_bitwise(pt.pack_aggregate(pt.unpack_aggregate(p_packed)).numpy(),
                   p_packed.numpy(), "unpack")


def test_hist_bucket_bitwise(ref):
    rng = np.random.default_rng(3)
    lat = np.concatenate([
        10.0 ** rng.uniform(-6.0, 10.0, 4000),
        pt.aggregate_hist_edges(), [0.0, 2.0 ** -10, 2.0 ** 28, 1e30]
    ]).astype(np.float32)
    j = np.asarray(ref.twin._hist_bucket(ref.jax.numpy.asarray(lat)))
    p = pt._hist_bucket(torch.from_numpy(lat)).numpy()
    np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(pt.np_hist_bucket(lat), j)
    assert p.min() == 0 and p.max() == pt.AGG_HIST_BINS - 1


def _hit_bucket_update(hist, bucket, arrive):
    """The CUDA kernel's histogram rule: only the hit bucket's triple
    takes the compensated step."""
    rows = torch.arange(len(bucket))
    hs, hc, hcc = (h.clone() for h in hist)
    s, c, cc = pt._neumaier2(hs[rows, bucket], hc[rows, bucket],
                             hcc[rows, bucket], arrive)
    hs[rows, bucket], hc[rows, bucket], hcc[rows, bucket] = s, c, cc
    return hs, hc, hcc


def test_hit_bucket_update_equals_masked_compare_add():
    rng = np.random.default_rng(4)
    n, t = 33, 500
    loads = torch.from_numpy(rng.uniform(0.0, 3e4, (t, n)).astype(np.float32))
    lat = torch.from_numpy(
        (10.0 ** rng.uniform(-4.0, 8.0, (t, n))).astype(np.float32))
    state = pt.init_aggregate(n)
    hit = state[1]
    for a, lt in zip(loads, lat):
        outs = (a, a, lt, a, a)
        state = pt.lane_update_aggregate(state, a, outs, 1e4, 0)
        hit = _hit_bucket_update(hit, pt._hist_bucket(lt), a)
    for masked, h in zip(state[1], hit):
        assert_bitwise(h.numpy(), masked.numpy(), "hit vs masked")
    # and the recombined triple is numpy's f64 bincount, rounded once
    final = pt.finalize_aggregate(pt.pack_aggregate(state)).numpy()
    want = pt.np_latency_histogram(lat.t().numpy(), loads.t().numpy())
    assert_bitwise(final[:, pt.AGG_SCALARS:], want, "histogram")


def test_finalize_aggregate_bitwise(ref):
    rng = np.random.default_rng(5)
    packed = np.zeros((17, pt.AGG_KDIM), np.float32)
    packed[:, :pt.AGG_SCALARS] = rng.uniform(0, 1e6, (17, pt.AGG_SCALARS))
    b, s0 = pt.AGG_HIST_BINS, pt.AGG_SCALARS
    packed[:, s0:s0 + b] = rng.uniform(0, 1e9, (17, b))
    packed[:, s0 + b:s0 + 2 * b] = rng.uniform(-32.0, 32.0, (17, b))
    packed[:, s0 + 2 * b:] = rng.uniform(-1e-5, 1e-5, (17, b))
    j = np.asarray(ref.twin.finalize_aggregate_x64(
        ref.jax.numpy.asarray(packed)))
    p = pt.finalize_aggregate(torch.from_numpy(packed)).numpy()
    assert_bitwise(p, j, "finalize")


@pytest.mark.parametrize("g", [1.0, 1.5, 1.75])
def test_hourly_loads_bitwise(ref, g):
    j = ref.traffic.TrafficModel.honda_default("x", R=3.5, G=g).hourly_loads()
    p = port_traffic.TrafficModel.honda_default("x", R=3.5,
                                                G=g).hourly_loads()
    assert_bitwise(p, j, "hourly_loads")


def test_registry_order_and_catalog(ref):
    assert pt.policy_names() == ref.twin.policy_names() == POLICIES
    assert pt.kernel_branches() == (0, 1, 2, 3, 4)
    assert pt.policy_table_rows() == ref.twin.policy_table_rows()
    twin = pt.make_twin("a", "autoscale", max_rps=2.0, usd_per_hour=0.1,
                        base_latency_s=0.2, max_instances=8)
    ref_twin = ref.twin.make_twin("a", "autoscale", max_rps=2.0,
                                  usd_per_hour=0.1, base_latency_s=0.2,
                                  max_instances=8)
    assert twin.params == ref_twin.params
    assert_bitwise(twin.padded_params(), ref_twin.padded_params())
