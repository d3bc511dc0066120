"""The port's chaos suites against ``repro.faults`` and the reference's
fault scans.

* ``repro_torch.faults`` (a copy) samples and expands bitwise the
  reference's futures, and its errors name the same spec and bin;
* the fault layer (``core.twin.fault_lane_policy_step``, the uniform
  ``fault_switch_step`` and shed's fault rounding) is bitwise the
  reference's on random blocks with outage, brownout and full-capacity
  bins, a fault backlog that builds and floods back, at dt 1 h and 1 min;
* the plain fault scans (``kernels.ref`` with ``caps``/``fmask``) equal
  the reference's jnp oracle and its Pallas fault kernel in interpret
  mode, bitwise;
* ``simulate_grid(faults=)`` equals the JAX package run under
  ``pallas_mode()`` field for field, unblocked and in blocks, in both SLO
  modes. Against the reference's XLA fault paths (its default) it is
  bitwise except batch_window's cost, which those paths round differently
  (see the note above the lane steps in ``repro_torch/core/twin.py``);
  the bound is stated in ``test_chaos_grid_against_reference_xla``;
* What-if #7 through ``run_grid(faults=)``, full year, equals the JAX
  package in both modes, and ``convert.sampled_faults_from_arrays``
  carries the reference's futures across.

A test that needs the card is in ``test_torch_kernels.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import faults as pf
from repro_torch.core import simulate as psim
from repro_torch.core import slo as pslo
from repro_torch.core import traffic as ptraffic
from repro_torch.core import twin as pt
from repro_torch.core import whatif as pwhatif
from repro_torch.kernels import ops, ref
from repro_torch.kernels import policy_scan as pk

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import (assert_bitwise, assert_same_results, bits,
                            bucket_run_histogram, reference)

DTS = [1.0, 1.0 / 60.0]
SLOS = [(0, 4 * 3600.0), (1, 0.01)]
T_WEEK = 168


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the fault library: sampler, expansion, errors
# ---------------------------------------------------------------------------

def dense_schedule(f):
    """All four kinds at rates that fill a month."""
    return f.FaultSchedule(
        specs=(f.outage(rate_per_year=30), f.disconnect(rate_per_year=40),
               f.brownout(rate_per_year=30), f.burst(rate_per_year=30)),
        n_futures=4, seed=123)


def bench_schedule(f, n_futures=16):
    """The four-spec schedule of benchmarks/faults_bench.py."""
    return f.FaultSchedule(
        specs=(f.outage(rate_per_year=6, duration_hours=(1, 4)),
               f.disconnect(rate_per_year=12, disconnect_frac=(0.2, 0.5)),
               f.brownout(rate_per_year=8, capacity_mult=(0.3, 0.7)),
               f.burst(rate_per_year=8, load_mult=(1.5, 3.0))),
        n_futures=n_futures, seed=0)


def assert_same_sampled(p, j):
    for f in ("cap", "mask", "load_mult"):
        assert_bitwise(getattr(p, f), getattr(j, f), f)
    assert p.events == j.events
    assert (p.n_futures, p.t_bins, p.bin_hours, p.seed) == \
        (j.n_futures, j.t_bins, j.bin_hours, j.seed)
    assert [len(r) for r in p.replay] == [len(r) for r in j.replay]
    for rp, rj in zip(p.replay, j.replay):
        for a, b in zip(rp, rj):
            assert_bitwise(a.removed, b.removed, "replay removed")
            assert_bitwise(a.profile, b.profile, "replay profile")


@pytest.mark.parametrize("schedule,t_bins", [(dense_schedule, 720),
                                             (bench_schedule, 8736)])
def test_sampler_bitwise(jref, schedule, t_bins):
    got = pf.sample_futures(schedule(pf), t_bins, 1.0)
    want = jref.faults.sample_futures(schedule(jref.faults), t_bins, 1.0)
    assert_same_sampled(got, want)
    assert got.has_load_faults.any() and got.has_capacity_faults.any()
    np.testing.assert_array_equal(pf.benign_futures(got),
                                  jref.faults.benign_futures(want))


def test_expand_grid_field_for_field(jref):
    rng = np.random.default_rng(1)
    matrix = rng.uniform(0.0, 9e3, (3, 720)).astype(np.float32)
    index = np.array([2, 0, 2, 1, 0], np.int32)
    got = pf.expand_grid(pf.sample_futures(dense_schedule(pf), 720),
                         matrix, index)
    want = jref.faults.expand_grid(
        jref.faults.sample_futures(dense_schedule(jref.faults), 720),
        matrix, index)
    for f in ("load_matrix", "load_index", "cap", "fmask", "fault_index"):
        assert_bitwise(getattr(got, f), getattr(want, f), f)
    assert (got.n_futures, got.n_base, got.n_rows) == \
        (want.n_futures, want.n_base, want.n_rows) == (4, 5, 20)
    assert got.load_matrix.shape[0] > 3        # faulted rows were added


def _hand_sampled(f, bad, t_bins=24):
    """One future of module ``f`` with a bad bin at 7 (``bad`` names
    which series; None: none), blamed on 'bad-spec'."""
    cap = np.ones((1, t_bins), np.float32)
    lm = np.ones((1, t_bins), np.float64)
    replay = ((),)
    if bad == "cap":
        cap[0, 7] = -0.25
    elif bad == "load_mult":
        lm[0, 7] = np.nan
    elif bad == "replay":   # a flood that drives the perturbed load negative
        profile = np.zeros(t_bins)
        profile[7] = -3.0
        removed = np.zeros(t_bins)
        removed[2] = 1.0
        replay = ((f.ReplayTerm(removed=removed, profile=profile),),)
    events = (({"spec": "bad-spec", "kind": "disconnect", "start": 0,
                "end": 12},),)
    return f.SampledFaults(cap=cap, mask=np.zeros((1, t_bins), np.float32),
                           load_mult=lm, replay=replay, events=events,
                           n_futures=1, t_bins=t_bins, bin_hours=1.0,
                           seed=0)


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("bad", ["cap", "load_mult", "replay"])
def test_bad_bins_raise_naming_spec_and_bin(jref, bad):
    matrix = np.full((1, 24), 100.0, np.float32)
    index = np.zeros(1, np.int32)
    msgs = []
    for f in (pf, jref.faults):
        s = _hand_sampled(f, bad)
        if bad == "replay":
            msgs.append(_error(lambda: f.expand_grid(s, matrix, index)))
        else:
            msgs.append(_error(lambda: f.validate_sampled(s)))
    assert msgs[0] == msgs[1]
    assert "bin 7" in msgs[0] and "'bad-spec'" in msgs[0]
    # simulate_grid checks before any device work
    tw = [pt.SimpleTwin("fifo", 1.9512, 0.0082, 0.15)]
    with pytest.raises(ValueError, match=r"bin 7.*bad-spec"):
        psim.simulate_grid(tw, load_matrix=matrix, load_index=index,
                           bin_hours=1.0, return_series=False,
                           faults=_hand_sampled(pf, bad), device="cpu")


def test_faults_argument_errors():
    tw = [pt.SimpleTwin("fifo", 1.9512, 0.0082, 0.15)]
    kw = dict(load_matrix=np.full((1, 24), 100.0, np.float32),
              load_index=np.zeros(1, np.int32), bin_hours=1.0,
              return_series=False, device="cpu")
    with pytest.raises(ValueError, match="covers 12 bins"):
        psim.simulate_grid(tw, faults=_hand_sampled(pf, None, 12), **kw)
    with pytest.raises(TypeError, match="FaultSchedule"):
        psim.simulate_grid(tw, faults={"not": "a schedule"}, **kw)
    with pytest.raises(NotImplementedError, match="devices"):
        psim.simulate_grid(tw, faults=dense_schedule(pf), devices=2, **kw)


# ---------------------------------------------------------------------------
# the fault layer, step by step
# ---------------------------------------------------------------------------

LANES, BINS = 64, 12


def _fault_block(seed):
    """Lanes with foreign parameters in every slot; capmul 0 in ~30% of
    bins (a backlog builds), fractional in ~30%, else 1."""
    rng = np.random.default_rng(seed)
    carry = rng.uniform(0.0, 5e4, (LANES, pt.CARRY_DIM)).astype(np.float32)
    fq = rng.uniform(0.0, 3e4, LANES).astype(np.float32)
    fq[: LANES // 4] = 0.0
    arrive = rng.uniform(0.0, 2e5, (BINS, LANES)).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (BINS, LANES))
    capmul = np.where(u < 0.3, 0.0, np.where(
        u < 0.6, rng.uniform(0.2, 0.9, (BINS, LANES)), 1.0)).astype(
            np.float32)
    params = rng.uniform(0.05, 8.0, (LANES, pt.PARAM_DIM)).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, LANES)]
    onehot[:3] = 0.0
    return carry, fq, arrive, capmul, params, onehot


def _jax_fault_scan(jref, step, state, arrive, capmul, operands, dt):
    """The reference fault step over the bins in a jitted scan that
    returns every series (the series scans' context), the per-lane
    operands passed as arguments (as constants XLA would fold them)."""
    jax = jref.jax
    dt_f = jax.numpy.float32(dt)

    def run(s, a, c, ops_):
        return jax.lax.scan(lambda s_, x: step(s_, x[0], x[1], ops_, dt_f),
                            s, (a, c))

    (carry, fq), outs = jax.jit(run)(state, arrive, capmul, operands)
    return [np.asarray(carry), np.asarray(fq)] + [np.asarray(o)
                                                  for o in outs]


def _port_fault_scan(step, state, arrive, capmul, dt):
    dt_t = torch.tensor(dt, dtype=torch.float32)
    state = tuple(_t(s) for s in state)
    outs = []
    for a, c in zip(_t(arrive), _t(capmul)):
        state, o = step(state, a, c, dt_t)
        outs.append(torch.stack(o))
    return [s.numpy() for s in state] + [
        o.numpy() for o in torch.stack(outs).unbind(1)]


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("form", ["mixed", 0, 1, 2, 3, 4])
def test_fault_step_bitwise(jref, form, dt):
    carry, fq, arrive, capmul, params, onehot = _fault_block(
        7 if form == "mixed" else form)
    pp, po = _t(params), _t(onehot)
    if form == "mixed":
        j_step = lambda s, a, c, ops_, d: jref.twin.fault_lane_policy_step(  # noqa: E731
            s, a, c, *ops_, d)
        p_step = lambda s, a, c, d: pt.fault_lane_policy_step(  # noqa: E731
            s, a, c, pp, po, d)
    else:
        j_step = lambda s, a, c, ops_, d: jref.ref._fault_switch_step(  # noqa: E731
            form, jref.twin.lane_branches(), ops_[0], d)(s, a, c)
        p_step = lambda s, a, c, d: pt.fault_switch_step(  # noqa: E731
            s, a, c, pp, form, d)
    want = _jax_fault_scan(jref, j_step, (carry, fq), arrive, capmul,
                           (params, onehot), dt)
    got = _port_fault_scan(p_step, (carry, fq), arrive, capmul, dt)
    names = ["carry", "backlog", "processed", "queue", "latency", "cost",
             "dropped"]
    for name, a, b in zip(names, got, want):
        assert_bitwise(a, b, f"{form} {name}")
    assert (got[1] > 0).any()                  # a backlog builds
    if form in ("mixed", 3):
        assert (got[6] > 0).any()              # and shed drops


def test_shed_fault_forms_differ_only_where_fused():
    """The three SHED_FUSE_* levels share every output but the fused ones,
    and a backlog of 0 with capmul 1 is the benign step."""
    carry, _, arrive, _, params, _ = _fault_block(3)
    pp, dt = _t(params), torch.tensor(1.0)
    c, a = _t(carry), _t(arrive[0])
    benign = pt.policy_spec("shed").lane_step(c, a, pp, dt)
    forms = [pt._shed(c, a, pp, dt, fuse) for fuse in
             (pt.SHED_FUSE_DROP, pt.SHED_FUSE_LATENCY, pt.SHED_FUSE_ALL)]
    for k in (0, 3):            # processed, cost: never fused
        for f in forms:
            assert_bitwise(f[1][k].numpy(), benign[1][k].numpy())
    drop, lat, alls = forms
    assert_bitwise(drop[0].numpy(), benign[0].numpy(), "carried queue")
    assert_bitwise(lat[0].numpy(), benign[0].numpy(), "carried queue")
    assert_bitwise(drop[1][2].numpy(), benign[1][2].numpy(), "latency")
    assert_bitwise(lat[1][4].numpy(), drop[1][4].numpy(), "dropped")
    assert_bitwise(alls[1][2].numpy(), lat[1][2].numpy(), "latency")
    state = (c, torch.zeros(LANES))
    (c1, fq1), outs = pt.fault_switch_step(
        state, a, torch.ones(LANES), pp, pt.policy_spec("fifo").index, dt)
    c0, outs0 = pt.policy_spec("fifo").lane_step(c, a, pp, dt)
    assert not fq1.any()
    for x, y in zip((c1,) + outs, (c0,) + outs0):
        assert_bitwise(x.numpy(), y.numpy(), "benign bin")


# ---------------------------------------------------------------------------
# the plain fault scans against the jnp oracle and Pallas interpret
# ---------------------------------------------------------------------------

N, T, F = 13, 168, 5


def _scan_grid(seed):
    """Mixed-policy block with foreign parameters, an all-zero mask row,
    and F fault rows (outage runs, brownouts, all-ones) read through a
    fault index."""
    rng = np.random.default_rng(seed)
    loads = rng.uniform(0.0, 2e4, (N, T)).astype(np.float32)
    params = rng.uniform(0.05, 8.0, (N, pt.PARAM_DIM)).astype(np.float32)
    idx = np.arange(N) % 5
    rng.shuffle(idx)
    onehot = pt.policy_onehot(idx)
    onehot[0] = 0.0
    cap = np.ones((F, T), np.float32)
    for f in range(1, F):
        for start in rng.integers(0, T - 12, 6):
            cap[f, start:start + rng.integers(2, 12)] = 0.0
        brown = rng.uniform(0.0, 1.0, T) < 0.15
        cap[f, brown] *= rng.uniform(0.3, 0.7, int(brown.sum()))
    fmask = (cap != 1.0).astype(np.float32)
    fmask[1, :5] = 1.0           # a window with full capacity still counts
    findex = rng.integers(0, F, N).astype(np.int32)
    return loads, params, onehot, cap, fmask, findex


@pytest.mark.parametrize("slo_mode,slo_limit", SLOS)
@pytest.mark.parametrize("dt", DTS)
def test_plain_fault_agg_matches_reference(jref, dt, slo_mode, slo_limit):
    loads, params, onehot, cap, fmask, findex = _scan_grid(1)
    jnp = jref.jax.numpy
    j_args = (jnp.asarray(loads), jnp.asarray(params), jnp.asarray(onehot),
              dt)
    kw = dict(slo_limit=slo_limit, slo_mode=slo_mode)
    j_kw = dict(kw, caps=jnp.asarray(cap[findex]),
                fmask=jnp.asarray(fmask[findex]))
    c_pl, a_pl = jref.policy_scan.policy_grid_agg(*j_args, interpret=True,
                                                  **j_kw)
    c_or, a_or = jref.ref.policy_grid_agg(*j_args, **j_kw)
    pk.reset_launches()
    c_p, a_p = pk.policy_grid_agg(
        _t(loads), _t(params), _t(onehot), dt, caps_t=_t(cap.T),
        fmask_t=_t(fmask.T), fault_index=_t(findex), **kw)
    assert not any(pk.launches.values())
    for c_w, a_w in ((c_pl, a_pl), (c_or, a_or)):
        assert_bitwise(c_p.numpy(), np.asarray(c_w), "carry_end")
        assert_bitwise(a_p.numpy(), np.asarray(a_w), "agg rows")
    flth = a_p[:, pt.A_FLTH].numpy()
    np.testing.assert_array_equal(flth, fmask[findex].sum(axis=1))


@pytest.mark.parametrize("slo_mode,slo_limit", SLOS)
@pytest.mark.parametrize("dt", DTS)
def test_fault_bucket_run_histogram_matches_reference(jref, dt, slo_mode,
                                                      slo_limit):
    """The CUDA fault aggregate kernel's bucket-run cache (a numpy model,
    ``torch_port_ref.bucket_run_histogram``) on the grid above: bitwise
    the plain version's and the reference's histogram, weighted by the
    offered load."""
    loads, params, onehot, cap, fmask, findex = _scan_grid(1)
    _, (_, _, latency, _, _) = ref.policy_grid_scan(
        _t(loads), _t(params), _t(onehot), dt, caps=_t(cap[findex]),
        shed_fuse=pt.SHED_FUSE_LATENCY)
    hist, changes, revisits = bucket_run_histogram(latency.numpy(), loads)
    assert changes > 2 * N and (revisits > 0 or dt != 1.0)
    jnp = jref.jax.numpy
    _, a_j = jref.ref.policy_grid_agg(
        jnp.asarray(loads), jnp.asarray(params), jnp.asarray(onehot), dt,
        slo_limit=slo_limit, slo_mode=slo_mode,
        caps=jnp.asarray(cap[findex]), fmask=jnp.asarray(fmask[findex]))
    _, a_p = pk.policy_grid_agg(
        _t(loads), _t(params), _t(onehot), dt, caps_t=_t(cap.T),
        fmask_t=_t(fmask.T), fault_index=_t(findex), slo_limit=slo_limit,
        slo_mode=slo_mode)
    assert_bitwise(hist, a_p[:, pt.AGG_SCALARS:].numpy(), "plain histogram")
    assert_bitwise(hist, np.asarray(a_j)[:, pt.AGG_SCALARS:],
                   "reference histogram")


@pytest.mark.parametrize("dt", DTS)
def test_plain_fault_scan_matches_reference(jref, dt):
    loads, params, onehot, cap, _, findex = _scan_grid(2)
    jnp = jref.jax.numpy
    c_j, s_j = jref.ref.policy_grid_scan(
        jnp.asarray(loads), jnp.asarray(params), jnp.asarray(onehot), dt,
        caps=jnp.asarray(cap[findex]))
    c_p, s_p = ops.policy_scan(None, _t(params), _t(onehot), dt,
                               loads_t=_t(loads.T), caps_t=_t(cap.T),
                               fault_index=_t(findex))
    assert_bitwise(c_p.numpy(), np.asarray(c_j), "carry_end")
    for k, (a, b) in enumerate(zip(s_p, s_j)):
        assert_bitwise(a.numpy(), np.asarray(b), f"series {k}")


@pytest.mark.parametrize("policy", range(5))
def test_uniform_fault_scans_match_reference(jref, policy):
    """The policy_index form at dt = 1 (at sub-hour bins the reference's
    uniform aggregate scan fuses quickscale's and autoscale's cost into
    its compensated sum; ROADMAP queue C)."""
    loads, params, _, cap, fmask, findex = _scan_grid(3)
    jnp = jref.jax.numpy
    j_args = (jnp.asarray(loads), jnp.asarray(params), None, 1.0)
    c_j, s_j = jref.ref.policy_grid_scan(*j_args, policy_index=policy,
                                         caps=jnp.asarray(cap[findex]))
    c_p, s_p = ops.policy_scan(_t(loads), _t(params), policy_index=policy,
                               caps_t=_t(cap.T), fault_index=_t(findex))
    assert_bitwise(c_p.numpy(), np.asarray(c_j), "carry_end")
    for k, (a, b) in enumerate(zip(s_p, s_j)):
        assert_bitwise(a.numpy(), np.asarray(b), f"series {k}")
    c_j, a_j = jref.ref.policy_grid_agg(
        *j_args, policy_index=policy, slo_limit=3600.0,
        caps=jnp.asarray(cap[findex]), fmask=jnp.asarray(fmask[findex]))
    c_p, a_p = ops.policy_scan_agg(
        _t(loads), _t(params), policy_index=policy, slo_limit=3600.0,
        caps_t=_t(cap.T), fmask_t=_t(fmask.T), fault_index=_t(findex))
    assert_bitwise(c_p.numpy(), np.asarray(c_j), "agg carry_end")
    assert_bitwise(a_p.numpy(), np.asarray(a_j), "agg rows")


def test_fault_operands_are_checked():
    loads, params, onehot, cap, fmask, findex = _scan_grid(4)
    args = (_t(loads), _t(params), _t(onehot))
    with pytest.raises(ValueError, match="together"):
        pk.policy_grid_agg(*args, caps_t=_t(cap.T))
    bad = findex.copy()
    bad[3] = F
    with pytest.raises(ValueError, match="out of range"):
        pk._row_index(_t(bad), N, F, torch.device("cpu"), "fault")
    with pytest.raises(ValueError, match=r"must be \[168, F\]"):
        pk._fault_operands(_t(cap), None, _t(findex), N, T,
                           torch.device("cpu"))


# ---------------------------------------------------------------------------
# simulate_grid(faults=) and run_grid(faults=)
# ---------------------------------------------------------------------------

def chaos_twins(tw):
    """tests/test_faults.py's twins and one of each other policy."""
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


def chaos_schedule(f):
    """tests/test_faults.py's chaos schedule."""
    return f.FaultSchedule(
        specs=(f.outage(rate_per_year=200, duration_hours=(2, 6)),
               f.disconnect(rate_per_year=150),
               f.brownout(rate_per_year=150)),
        n_futures=3, seed=7)


def _week_grid(tw, tr):
    traffics = [tr.TrafficModel.honda_default("nom"),
                tr.TrafficModel.honda_default("high", G=1.4)]
    matrix = np.stack([t.hourly_loads()[:T_WEEK] for t in traffics]) \
        .astype(np.float32)
    twins = chaos_twins(tw)
    index = np.repeat(np.arange(2, dtype=np.int32), len(twins))
    return [x for _ in traffics for x in twins], matrix, index


def _slo(mod, metric):
    limit = 4 * 3600.0 if metric == "latency" else 0.01
    return mod.SLO(metric=metric, limit_s=limit, met_fraction=0.9)


@functools.lru_cache(maxsize=None)
def port_week(metric, series=False, block=None, schedule=chaos_schedule):
    twins, matrix, index = _week_grid(pt, ptraffic)
    return psim.simulate_grid(twins, slo=_slo(pslo, metric),
                              return_series=series, load_matrix=matrix,
                              load_index=index, bin_hours=1.0,
                              scenario_block=block, faults=schedule(pf),
                              device="cpu")


def jax_week(jref, metric, series=False, block=None):
    twins, matrix, index = _week_grid(jref.twin, jref.traffic)
    return jref.simulate.simulate_grid(
        twins, slo=_slo(jref.slo, metric), return_series=series,
        load_matrix=matrix, load_index=index, bin_hours=1.0,
        scenario_block=block, faults=chaos_schedule(jref.faults))


@pytest.mark.parametrize("block", [None, 4])
@pytest.mark.parametrize("metric", ["latency", "drop_rate"])
def test_chaos_grid_matches_reference_kernel(jref, metric, block):
    with jref.ops.pallas_mode():
        want = jax_week(jref, metric, block=block)
    got = port_week(metric, block=block)
    assert len(got) == 30 and got[0].name == "fifo/f0"
    assert_same_results(got, want)
    assert pwhatif.table2_rows(got) == jref.whatif.table2_rows(want)
    rows = pwhatif.table2_rows(got)
    assert {"fault_hours", "pct_hours_met_in_fault",
            "pct_hours_met_outside_fault"} <= set(rows[0])
    assert any(r.fault_hours > 0 for r in got)
    if block:
        assert_same_results(got, port_week(metric))


#: batch_window's cost under the reference's XLA fault scans: each bin's
#: cost within one ulp of the kernel's, so (all terms >= 0) every cost
#: total within a relative 2**-23
ULP_BOUND = 2.0 ** -23


def _split_rows(got, want):
    """Bitwise on everything but batch_window's cost; returns that cost's
    largest relative difference."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.twin.policy != "batch_window":
            assert_same_results([g], [w])
            continue
        worst = max(worst, abs(g.total_cost_usd - w.total_cost_usd)
                    / w.total_cost_usd)
        keep = [f.name for f in dataclasses.fields(w)
                if f.name not in ("twin", "total_cost_usd", "cost_usd")]
        for f in keep:
            u, v = getattr(g, f), getattr(w, f)
            if isinstance(v, np.ndarray):
                assert_bitwise(u, v, f"{w.name}.{f}")
            else:
                assert u == v, (w.name, f, u, v)
        if hasattr(w, "cost_usd"):
            ulps = np.abs(bits(g.cost_usd.astype(np.float32)).astype(
                np.int64) - bits(w.cost_usd.astype(np.float32)).astype(
                    np.int64))
            assert ulps.max() <= 1, (w.name, ulps.max())
    assert worst <= ULP_BOUND, worst
    return worst


@pytest.mark.parametrize("mode", ["aggregate", "blocked", "series"])
def test_chaos_grid_against_reference_xla(jref, mode):
    block = 4 if mode == "blocked" else None
    series = mode == "series"
    want = jax_week(jref, "latency", series=series, block=block)
    got = port_week("latency", series=series, block=block)
    worst = _split_rows(got, want)
    assert worst > 0.0      # the XLA paths do round batch_window apart


def test_series_mode_equals_aggregate_mode():
    series, aggs = port_week("latency", series=True), port_week("latency")
    for s, a in zip(series, aggs):
        assert s.name == a.name
        for x, y in ((a.total_cost_usd, s.total_cost_usd),
                     (a.max_throughput_rph, s.max_throughput_rph),
                     (a.mean_throughput_rph, s.mean_throughput_rph),
                     (a.dropped_records, s.dropped_records),
                     (a.processed_records, s.processed.sum()),
                     (a.arrived_records, s.load.sum()),
                     (a.queue_end, s.queue[-1]),
                     (a.backlog_s, s.backlog_s),
                     (a.pct_latency_met, s.pct_latency_met),
                     (a.pct_hours_met, s.pct_hours_met)):
            assert x == y, s.name
        assert a.slo_met == s.slo_met
        ledger = a.processed_records + a.dropped_records + a.queue_end
        assert ledger == pytest.approx(a.arrived_records, rel=1e-6)


def empty_schedule(f):
    return f.FaultSchedule(specs=(), n_futures=2, seed=0)


def test_empty_schedule_is_the_fault_free_grid():
    twins, matrix, index = _week_grid(pt, ptraffic)
    plain = psim.simulate_grid(twins, slo=_slo(pslo, "latency"),
                               return_series=False, load_matrix=matrix,
                               load_index=index, bin_hours=1.0,
                               device="cpu")
    chaos = port_week("latency", schedule=empty_schedule)
    for i, p in enumerate(plain):
        for f in range(2):
            row = chaos[2 * i + f]
            assert row.name == f"{p.name}/f{f}" and row.fault_hours == 0.0
            assert_same_results([dataclasses.replace(row, name=p.name)], [p])


def test_dedup_collapses_benign_futures(jref, monkeypatch):
    """Futures 0 and 2 perturb nothing: the grid simulates one benign row
    per base scenario, and the dedup equals the reference's."""
    t_bins = 48
    cap = np.ones((3, t_bins), np.float32)
    cap[1, 10:20] = 0.0
    mask = (cap != 1.0).astype(np.float32)
    sampled = convert.sampled_faults_from_arrays(
        cap, mask, np.ones((3, t_bins)), ((), (), ()),
        ((), ({"spec": "o", "kind": "outage", "start": 10, "end": 20},),
         ()), t_bins, 1.0, 0)
    twins = chaos_twins(pt)
    matrix = np.full((1, t_bins), 5000.0, np.float32)
    fg = pf.expand_grid(sampled, matrix, np.zeros(5, np.int32))
    params = np.repeat(np.stack([t.padded_params() for t in twins]), 3, 0)
    pol = np.repeat([t.policy_index for t in twins], 3).astype(np.int32)
    fault = (fg.cap, fg.fmask, fg.fault_index)
    got = psim._dedup_rows(fg.load_index, params, pol, fault)
    want = jref.simulate._dedup_rows(fg.load_index, params, pol, fault)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == 10                # 5 benign + 5 outage rows
    launched = []
    real = psim._agg_launch

    def spy(matrix_t, load_index, *a, **k):
        launched.append(len(load_index))
        return real(matrix_t, load_index, *a, **k)

    monkeypatch.setattr(psim, "_agg_launch", spy)
    rows = psim.simulate_grid(twins, load_matrix=matrix,
                              load_index=np.zeros(5, np.int32),
                              bin_hours=1.0, return_series=False,
                              faults=sampled, device="cpu")
    assert launched == [10]
    for i in range(5):
        assert_same_results([dataclasses.replace(rows[3 * i + 2],
                                                 name=rows[3 * i].name)],
                            [rows[3 * i]])


@pytest.mark.parametrize("series", [False, True])
def test_whatif7_run_grid_full_year(jref, series):
    """What-if #7 of examples/whatif_analysis.py, as the example writes
    it, on the CPU: equal to the JAX package (its XLA default; the paper
    twins are fifo, where every fault path agrees)."""
    def run(tw, tr, slo, whatif, f):
        twins = [tw.SimpleTwin("blocking-write", 1.9512, 0.0082, 0.15),
                 tw.SimpleTwin("no-blocking-write", 6.15, 0.0703, 0.06)]
        chaos = f.FaultSchedule(
            specs=(f.outage(rate_per_year=6, duration_hours=(1, 4)),
                   f.disconnect(rate_per_year=12,
                                disconnect_frac=(0.2, 0.5),
                                flood_hours=1.0),
                   f.brownout(rate_per_year=8, capacity_mult=(0.3, 0.7))),
            n_futures=4, seed=0)
        kw = {} if whatif is jref.whatif else {"device": "cpu"}
        return whatif.run_grid(
            twins, [tr.TrafficModel.honda_default("nominal", R=3.5, G=1.0)],
            slo=slo.SLO(limit_s=4 * 3600, met_fraction=0.95), faults=chaos,
            return_series=series, **kw)

    got = run(pt, ptraffic, pslo, pwhatif, pf)
    want = run(jref.twin, jref.traffic, jref.slo, jref.whatif, jref.faults)
    assert len(got) == 8 and got[0].name == "nominal blocking-write/f0"
    assert_same_results(got, want)
    rows = pwhatif.table2_rows(got)
    assert rows == jref.whatif.table2_rows(want)
    # the attribution columns come off the aggregate counters only
    assert ("pct_hours_met_in_fault" in rows[0]) == (not series)


def test_sampled_faults_from_arrays_round_trip(jref):
    want = jref.faults.sample_futures(dense_schedule(jref.faults), 720)
    got = convert.sampled_faults_from_arrays(
        want.cap, want.mask, want.load_mult,
        [[(t.removed, t.profile) for t in terms] for terms in want.replay],
        want.events, want.t_bins, want.bin_hours, want.seed)
    assert isinstance(got, pf.SampledFaults)
    assert_same_sampled(got, want)
    assert_same_sampled(got, pf.sample_futures(dense_schedule(pf), 720))
    # one set of futures sampled by JAX, through both packages
    twins, matrix, index = _week_grid(pt, ptraffic)
    j_twins, _, _ = _week_grid(jref.twin, jref.traffic)
    week = jref.faults.sample_futures(chaos_schedule(jref.faults), T_WEEK)
    port_week_faults = convert.sampled_faults_from_arrays(
        week.cap, week.mask, week.load_mult,
        [[(t.removed, t.profile) for t in terms] for terms in week.replay],
        week.events, week.t_bins, week.bin_hours, week.seed)
    kw = dict(load_matrix=matrix, load_index=index, bin_hours=1.0,
              return_series=False)
    with jref.ops.pallas_mode():
        j_rows = jref.simulate.simulate_grid(j_twins, faults=week, **kw)
    p_rows = psim.simulate_grid(twins, faults=port_week_faults,
                                device="cpu", **kw)
    assert_same_results(p_rows, j_rows)
    with pytest.raises(ValueError, match="futures"):
        convert.sampled_faults_from_arrays(
            want.cap, want.mask, want.load_mult, [], want.events,
            want.t_bins, want.bin_hours, want.seed)
