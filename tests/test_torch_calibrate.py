"""The port's calibration slice against ``repro.calibrate`` / ``repro.optim``.

The cases of ``tests/test_calibrate.py`` that fit nothing, run through
the port, with parity against the reference on the same inputs:

* ``scan_trace`` — bitwise the year kernel at dt = 1 and bitwise the
  reference's ``scan_trace`` at dt = 1 and 1/12 (every policy);
* the traces — ``bin_loadpattern``, ``from_loadpattern`` (+
  ``with_noise``), ``from_experiment``, ``from_otel_spans`` and
  ``from_prometheus`` — bitwise the reference's;
* the reparameterisation — ``z_from_params`` bitwise (numpy on both
  sides), ``params_from_z`` within ``PARAMS_RTOL`` (float32 with XLA's
  functions in the reference, float64 rounded once here);
* the loss and its gradient (``lane_trace_loss`` streamed, ``trace_loss``)
  within ``LOSS_RTOL`` / ``GRAD_RTOL``;
* AdamW (``tests/test_optim.py``'s numpy reference, and the reference's
  ``adamw_update``) and its schedule;
* the fit's bookkeeping: metadata, freezing, the two warnings and their
  ``warn.*`` events, the result table, ``devices=``, and the first steps
  of a fit's loss history against the reference's within ``HISTORY_RTOL``.
"""
import math
import warnings

import numpy as np
import pytest
import torch

from repro_torch import calibrate as pc
from repro_torch import obs
from repro_torch.calibrate import objective as pobj
from repro_torch.config import OptimizerConfig
from repro_torch.core import experiment as pexp
from repro_torch.core import loadpattern as plp
from repro_torch.core import metrics as pmetrics
from repro_torch.core import simulate as psim
from repro_torch.core import spans as pspans
from repro_torch.core import traffic as ptraffic
from repro_torch.core import twin as pt
from repro_torch.optim import adamw_update, init_opt_state, lr_at

from torch_port_ref import assert_bitwise, one_torch_thread  # noqa: F401
from torch_port_ref import reference, synthetic_result

CPU = torch.device("cpu")
#: params_from_z: the port maps in float64 and rounds once, the
#: reference in float32, where the exponent of a log-scale box (up to
#: ~14 wide) rounds to ~1e-6 absolute (measured 1.3e-6 relative)
PARAMS_RTOL = 3e-6
#: the calibration loss from the same z: the parameters (above), the
#: fold's log, and the cumsums and means of the per-scenario loss, against
#: XLA's (measured at most 7.3e-6)
LOSS_RTOL = 1e-5
#: d loss / d params at the same parameters, with the reference test's
#: guard (denominator floored at 1e-6 of the largest entry; measured at
#: most 2e-6)
GRAD_RTOL = 1e-5
#: d loss / d z end to end: the parameters differ from the reference's
#: (above), and a queue near a kink of the loss (a bin's min(avail,
#: capacity)) turns that into a larger change of the gradient (measured
#: at most 3.2e-5, autoscale)
Z_GRAD_RTOL = 5e-5
#: the first steps of a fit's loss history (the loss's rounding,
#: amplified by the optimizer's steps; measured below 1e-5 over 5 steps)
HISTORY_RTOL = 1e-4


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


def twins(tw):
    return [tw.SimpleTwin("t", 2.0, 0.05, 0.2),
            tw.make_twin("q", "quickscale", max_rps=2.0, usd_per_hour=0.05,
                         base_latency_s=0.2),
            tw.make_twin("a", "autoscale", max_rps=0.5, usd_per_hour=0.01,
                         base_latency_s=0.1, max_instances=8,
                         scale_up_hours=3),
            tw.make_twin("t", "shed", max_rps=2.0, usd_per_hour=0.05,
                         base_latency_s=0.2, queue_cap_hours=1.5),
            tw.make_twin("b", "batch_window", max_rps=4.0,
                         usd_per_hour=0.01, base_latency_s=0.1,
                         window_hours=6)]


POLICIES = [tw.policy for tw in twins(pt)]


def ramp(lp):
    return lp.LoadPattern.ramp("ramp", duration_s=6 * 3600, peak_rate=6.0)


def steady(lp):
    return lp.LoadPattern.steady("steady", duration_s=6 * 3600, rate=3.0)


FIFO_TRUTH = pt.SimpleTwin("t", 2.0, 0.05, 0.2)
SHED_TRUTH = twins(pt)[3]
TRACE_FIELDS = ("arrivals", "processed", "latency_s", "dropped", "cost_usd")


def assert_same_trace(got, want):
    assert got.name == want.name and got.bin_hours == want.bin_hours
    for f in TRACE_FIELDS:
        assert_bitwise(getattr(got, f), getattr(want, f), f)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())


def grad_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    denom = np.maximum(np.abs(b), 1e-6 * max(np.abs(b).max(), 1.0))
    return float((np.abs(a - b) / denom).max())


# ---------------------------------------------------------------------------
# scan_trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", range(5), ids=POLICIES)
def test_scan_trace_dt1_bitwise_year_kernel_and_reference(jref, k):
    """scan_trace at dt = 1 equals simulate_year (the year grid's scan)
    and the reference's scan_trace, bit for bit."""
    jnp = jref.jax.numpy
    tw = twins(pt)[k]
    loads = ptraffic.TrafficModel.honda_default("nom").hourly_loads()
    sim = psim.simulate_year(tw, loads, device="cpu")
    q_end, outs = psim.scan_trace(torch.tensor(loads),
                                  torch.tensor(tw.padded_params()),
                                  tw.policy_index, 1.0)
    for got, want in zip(outs, (sim.processed, sim.queue, sim.latency_s,
                                sim.cost_usd, sim.dropped)):
        assert_bitwise(got.numpy().astype(np.float64), want)
    assert float(q_end[0]) == sim.queue[-1]
    jt = twins(jref.twin)[k]
    _, jouts = jref.simulate.scan_trace(jnp.asarray(loads, jnp.float32),
                                        jnp.asarray(jt.padded_params()),
                                        jt.policy_index, 1.0)
    for got, want in zip(outs, jouts):
        assert_bitwise(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", range(5), ids=POLICIES)
def test_scan_trace_subhour_bitwise_reference(jref, k):
    jnp = jref.jax.numpy
    arrivals = pc.bin_loadpattern(ramp(plp), 300.0).astype(np.float32)
    tw, jt = twins(pt)[k], twins(jref.twin)[k]
    carry, outs = psim.scan_trace(torch.tensor(arrivals),
                                  torch.tensor(tw.padded_params()),
                                  tw.policy_index, 1.0 / 12)
    jcarry, jouts = jref.simulate.scan_trace(
        jnp.asarray(arrivals), jnp.asarray(jt.padded_params()),
        jt.policy_index, 1.0 / 12)
    assert_bitwise(carry.numpy(), np.asarray(jcarry), "carry")
    for i, (got, want) in enumerate(zip(outs, jouts)):
        assert_bitwise(got.numpy(), np.asarray(want), f"series {i}")


@pytest.mark.parametrize("policy", ["fifo", "shed"])
def test_subhour_bins_conserve_records(policy):
    """processed + queue_end + dropped == arrived at dt = 0.25 h."""
    twin = FIFO_TRUTH if policy == "fifo" else SHED_TRUTH
    arrivals = pc.bin_loadpattern(ramp(plp), bin_s=900.0).astype(np.float32)
    _, (proc, queue, _lat, _cost, drop) = psim.scan_trace(
        torch.tensor(arrivals), torch.tensor(twin.padded_params()),
        twin.policy_index, 0.25)
    arrived = float(arrivals.astype(np.float64).sum())
    total = (float(proc.double().sum()) + float(queue[-1])
             + float(drop.double().sum()))
    assert abs(total - arrived) / arrived < 1e-5
    assert float(proc.max()) <= 2.0 * 3600.0 * 0.25 * (1 + 1e-6)


def test_scan_trace_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.ObservedTrace.from_loadpattern(ramp(plp), FIFO_TRUTH, 300.0)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def test_bin_loadpattern_integrates_exactly_and_matches(jref):
    bins = pc.bin_loadpattern(ramp(plp), bin_s=300.0)
    assert bins.shape == (72,)
    assert bins.sum() == pytest.approx(ramp(plp).total_records, rel=1e-6)
    assert (np.diff(bins) > 0).all()
    assert_bitwise(bins, jref.calibrate.bin_loadpattern(
        ramp(jref.loadpattern), bin_s=300.0))


def test_trace_from_loadpattern_and_noise(jref):
    tr = pc.ObservedTrace.from_loadpattern(ramp(plp), FIFO_TRUTH,
                                           bin_s=300.0, device="cpu")
    want = jref.calibrate.ObservedTrace.from_loadpattern(
        ramp(jref.loadpattern), twins(jref.twin)[0], bin_s=300.0)
    assert_same_trace(tr, want)
    assert tr.num_bins == 72 and tr.bin_hours == pytest.approx(1 / 12)
    assert (tr.latency_s >= FIFO_TRUTH.base_latency_s - 1e-6).all()
    noisy = tr.with_noise(0.05, seed=1)
    assert_same_trace(noisy, want.with_noise(0.05, seed=1))
    assert not np.array_equal(noisy.processed, tr.processed)
    assert (noisy.processed >= 0).all() and (noisy.latency_s >= 0).all()
    assert tr.scales() == want.scales()
    assert tr.scales()["dropped"] == pytest.approx(
        float(np.abs(tr.arrivals).mean()))


def test_trace_from_experiment(jref):
    res = synthetic_result(pspans, pmetrics, pexp)
    tr = pc.ObservedTrace.from_experiment(res, bin_s=10.0)
    assert tr.num_bins == 6
    assert tr.arrivals.sum() == pytest.approx(res.records_sent, rel=1e-6)
    assert tr.processed.sum() == pytest.approx(res.records_done, rel=1e-6)
    assert (tr.latency_s >= 0).all()
    assert tr.cost_usd.sum() == pytest.approx(0.1 * 60.0 / 3600.0, rel=1e-6)
    want = jref.calibrate.ObservedTrace.from_experiment(
        synthetic_result(jref.spans, jref.metrics, jref.experiment),
        bin_s=10.0)
    assert_same_trace(tr, want)


def otel_spans():
    return [
        {"start": 1000.0, "end": 1002.0},
        {"start": 1001.0, "end": 1065.0, "records": 3},
        {"start": 1070.0, "end": 1075.0, "status": "ERROR"},
        {"start": 1130.0, "end": 1150.0, "records": 2},
    ]


def test_from_otel_spans_bins_arrivals_completions_and_errors(jref):
    tr = pc.ObservedTrace.from_otel_spans(otel_spans(), bin_seconds=60.0,
                                          name="t", usd_per_hour=0.36)
    assert tr.num_bins == 3 and tr.bin_hours == pytest.approx(1 / 60.0)
    np.testing.assert_allclose(tr.arrivals, [4.0, 1.0, 2.0])
    np.testing.assert_allclose(tr.processed, [1.0, 3.0, 2.0])
    np.testing.assert_allclose(tr.dropped, [0.0, 1.0, 0.0])
    np.testing.assert_allclose(tr.latency_s, [2.0, 64.0, 20.0])
    np.testing.assert_allclose(tr.cost_usd, 0.36 / 60.0)
    assert_same_trace(tr, jref.calibrate.ObservedTrace.from_otel_spans(
        otel_spans(), bin_seconds=60.0, name="t", usd_per_hour=0.36))


def test_from_otel_spans_otlp_field_names_and_status_codes():
    ns = 1e9
    for status in ({"code": 2}, {"code": "STATUS_CODE_ERROR"}, "ERROR",
                   "STATUS_CODE_ERROR", 2, "2"):
        spans = [
            {"start_time_unix_nano": 5_000 * ns,
             "end_time_unix_nano": 5_010 * ns},
            {"start_time_unix_nano": 5_020 * ns,
             "end_time_unix_nano": 5_030 * ns, "status": status},
        ]
        tr = pc.ObservedTrace.from_otel_spans(spans, bin_seconds=30.0)
        np.testing.assert_allclose(tr.arrivals, [2.0])
        np.testing.assert_allclose(tr.processed, [1.0], err_msg=str(status))
        np.testing.assert_allclose(tr.dropped, [1.0], err_msg=str(status))
    for status in ("OK", {"code": 0}, {"code": "STATUS_CODE_OK"}, 0):
        tr = pc.ObservedTrace.from_otel_spans(
            [{"start": 0.0, "end": 1.0, "status": status}], bin_seconds=30.0)
        np.testing.assert_allclose(tr.processed, [1.0], err_msg=str(status))
        np.testing.assert_allclose(tr.dropped, [0.0], err_msg=str(status))


def test_from_otel_spans_rejects_bad_input():
    with pytest.raises(ValueError):
        pc.ObservedTrace.from_otel_spans([])
    with pytest.raises(KeyError):
        pc.ObservedTrace.from_otel_spans([{"end": 1.0}])
    with pytest.raises(ValueError):
        pc.ObservedTrace.from_otel_spans([{"start": 2.0, "end": 1.0}])


def test_from_prometheus_matches_reference(jref):
    def matrix(values, **labels):
        return {"status": "success", "data": {"resultType": "matrix",
                "result": [{"metric": labels,
                            "values": [[t, str(v)] for t, v in values]}]}}

    ts = [1000.0 + 15.0 * i for i in range(40)]
    responses = {
        "arrivals": matrix([(t, 2.0 + 0.01 * i) for i, t in enumerate(ts)]),
        "processed": matrix([(t, 1.9 + 0.01 * i) for i, t in enumerate(ts)]),
        "latency": matrix([(t, 0.3 + 0.001 * i) for i, t in enumerate(ts)]),
        "dropped": matrix([(t, 0.05) for t in ts[::3]]),
    }
    tr = pc.ObservedTrace.from_prometheus(responses, bin_seconds=60.0,
                                          usd_per_hour=0.2)
    assert_same_trace(tr, jref.calibrate.ObservedTrace.from_prometheus(
        responses, bin_seconds=60.0, usd_per_hour=0.2))
    with pytest.raises(ValueError, match="unknown series"):
        pc.ObservedTrace.from_prometheus({"bogus": responses["arrivals"]})


# ---------------------------------------------------------------------------
# the reparameterisation, the loss and its gradient
# ---------------------------------------------------------------------------

def test_policies_declare_calibration_metadata(jref):
    for name in pt.policy_names():
        spec, want = pt.policy_spec(name), jref.twin.policy_spec(name)
        assert spec.bounds == want.bounds
        assert spec.log_params == want.log_params
        assert spec.frozen == want.frozen
        for pname in spec.param_names:
            lo, hi = spec.bound(pname)
            assert lo < hi and (lo, hi) == want.bound(pname)
        assert set(spec.frozen) <= set(spec.param_names)
        assert set(spec.log_params) <= set(spec.param_names)
    assert pt.SHARED_BOUNDS == jref.twin.SHARED_BOUNDS
    assert pt.GENERIC_BOUNDS == jref.twin.GENERIC_BOUNDS
    assert pt.SHARED_LOG == jref.twin.SHARED_LOG


def test_register_policy_fills_calibration_defaults(jref):
    """register_policy's defaults are the reference's: the shared boxes,
    the shared triple in log space, nothing frozen; and every
    registration bumps the registry version."""
    before = pt.registry_version()
    name = "calibration-defaults-probe"
    pt.register_policy(name, ("max_rps", "usd_per_hour", "base_latency_s",
                              "extra"), defaults={"extra": 1.0})(
        pt.policy_spec("fifo").lane_step)
    try:
        spec = pt.policy_spec(name)
        assert pt.registry_version() == before + 1
        assert spec.log_params == pt.SHARED_LOG and spec.frozen == ()
        assert spec.bound("extra") == pt.GENERIC_BOUNDS
        assert spec.bound("max_rps") == pt.SHARED_BOUNDS["max_rps"]
    finally:
        del pt._REGISTRY[name]


@pytest.mark.parametrize("policy", POLICIES)
def test_reparameterisation_matches_reference(jref, policy):
    jnp = jref.jax.numpy
    spec = pc.fit_spec(policy)
    jspec = jref.calibrate.fit_spec(policy)
    for f in ("lo", "hi", "fixed"):
        assert_bitwise(getattr(spec, f), getattr(jspec, f), f)
    for f in ("log_mask", "free_mask"):
        assert np.array_equal(getattr(spec, f), getattr(jspec, f)), f
    z = np.random.default_rng(1).normal(0.0, 2.0, (16, 6)).astype(
        np.float32)
    got = pc.params_from_z(torch.tensor(z), spec.lo, spec.hi,
                           spec.log_mask, spec.free_mask, spec.fixed).numpy()
    want = np.stack([np.asarray(jref.calibrate.params_from_z(
        jnp.asarray(zk), jspec.lo, jspec.hi, jspec.log_mask,
        jspec.free_mask, jspec.fixed)) for zk in z])
    assert rel(got, want) <= PARAMS_RTOL
    assert_bitwise(got[:, ~spec.free_mask], want[:, ~spec.free_mask])
    assert_bitwise(pc.z_from_params(got[0], spec.lo, spec.hi,
                                    spec.log_mask),
                   jref.calibrate.z_from_params(got[0], jspec.lo, jspec.hi,
                                                jspec.log_mask))


def operands(trace):
    from repro_torch.calibrate.fit import _as_operands
    return _as_operands(trace, None, CPU)


def joperands(jref, trace):
    jnp = jref.jax.numpy
    return (jnp.asarray(trace.arrivals, jnp.float32),
            {k: jnp.asarray(v, jnp.float32)
             for k, v in trace.series().items()},
            {k: jnp.float32(v) for k, v in trace.scales().items()},
            {k: jnp.float32(1.0) for k in jref.calibrate.SERIES_KEYS})


@pytest.mark.parametrize("k", range(5), ids=POLICIES)
def test_lane_loss_and_gradient_match_reference(jref, k):
    """The fit's loss (streamed through the fold) and its gradient,
    against the reference's ``lane_series_loss`` at the same parameters
    and ``lane_trace_loss`` end to end from the same z."""
    jax, jnp = jref.jax, jref.jax.numpy
    tw = twins(pt)[k]
    trace = pc.ObservedTrace.from_loadpattern(ramp(plp), tw, bin_s=300.0,
                                              device="cpu")
    spec = pc.fit_spec(tw.policy)
    box = (spec.lo, spec.hi, spec.log_mask, spec.free_mask, spec.fixed)
    z = (pc.z_from_params(tw.padded_params(), spec.lo, spec.hi,
                          spec.log_mask)[None]
         + np.random.default_rng(k).normal(0.0, 0.7, (4, 6))).astype(
             np.float32)
    jargs = (*joperands(jref, trace), tw.policy_index, trace.bin_hours)
    jbox = tuple(jnp.asarray(b) for b in box)

    def jloss(zz):
        return jref.calibrate.lane_trace_loss(zz, *jargs, *jbox)

    # at the reference's parameters
    p = np.stack([np.asarray(jref.calibrate.params_from_z(
        jnp.asarray(zk), *jbox)) for zk in z])
    want_p = np.asarray(jax.grad(lambda pp: jref.calibrate.lane_series_loss(
        pp, *jargs).sum())(jnp.asarray(p)))
    pt_ = torch.tensor(p, requires_grad=True)
    pc.lane_series_loss(pt_, *operands(trace), tw.policy_index,
                        trace.bin_hours).sum().backward()
    assert grad_rel(pt_.grad, want_p) <= GRAD_RTOL, grad_rel(pt_.grad,
                                                             want_p)
    # end to end from z
    want = np.asarray(jloss(jnp.asarray(z)))
    want_g = np.asarray(jax.grad(lambda zz: jloss(zz).sum())(
        jnp.asarray(z)))
    zt = torch.tensor(z, requires_grad=True)
    got = pc.lane_trace_loss(zt, *operands(trace), tw.policy_index,
                             trace.bin_hours,
                             *(torch.as_tensor(b) for b in box))
    got.sum().backward()
    assert rel(got.detach(), want) <= LOSS_RTOL, rel(got.detach(), want)
    assert grad_rel(zt.grad, want_g) <= Z_GRAD_RTOL, grad_rel(zt.grad,
                                                              want_g)


@pytest.mark.parametrize("k", [0, 2, 3], ids=["fifo", "autoscale", "shed"])
def test_lane_loss_stream_equals_materialised(k):
    """Counterpart of the reference's stream-vs-materialise pin: the
    streamed fold and the fold replayed over the materialised series give
    the same per-lane losses bit for bit, and gradients within 1e-5."""
    tw = twins(pt)[k]
    trace = pc.ObservedTrace.from_loadpattern(ramp(plp), tw, bin_s=300.0,
                                              device="cpu")
    rng = np.random.default_rng(0)
    block = (np.tile(tw.padded_params(), (4, 1))
             * rng.uniform(0.8, 1.2, (4, 6))).astype(np.float32)
    out = {}
    for stream in (True, False):
        p = torch.tensor(block, requires_grad=True)
        loss = pc.lane_series_loss(p, *operands(trace), tw.policy_index,
                                   trace.bin_hours, stream=stream)
        loss.sum().backward()
        out[stream] = (loss.detach().numpy(), p.grad.numpy())
    assert_bitwise(out[True][0], out[False][0], "loss")
    assert grad_rel(out[True][1], out[False][1]) <= GRAD_RTOL


@pytest.mark.parametrize("k", [0, 2, 3], ids=["fifo", "autoscale", "shed"])
def test_trace_loss_matches_reference(jref, k):
    """The one-scenario loss (``series_loss`` through ``scan_trace``) and
    its gradient, against the reference's."""
    jax, jnp = jref.jax, jref.jax.numpy
    tw = twins(pt)[k]
    trace = pc.ObservedTrace.from_loadpattern(ramp(plp), tw, bin_s=300.0,
                                              device="cpu")
    spec = pc.fit_spec(tw.policy)
    box = (spec.lo, spec.hi, spec.log_mask, spec.free_mask, spec.fixed)
    z0 = pc.z_from_params(tw.padded_params() * 1.17, spec.lo, spec.hi,
                          spec.log_mask)

    def jloss(zz):
        return jref.calibrate.trace_loss(
            zz, *joperands(jref, trace), tw.policy_index, trace.bin_hours,
            *(jnp.asarray(b) for b in box))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(z0))
    zt = torch.tensor(z0, requires_grad=True)
    got = pc.trace_loss(zt, *operands(trace), tw.policy_index,
                        trace.bin_hours, *(torch.as_tensor(b) for b in box))
    got.backward()
    assert rel(float(got.detach()), float(want)) <= LOSS_RTOL
    assert grad_rel(zt.grad, np.asarray(want_g)) <= Z_GRAD_RTOL
    assert pc.evaluate(tw, trace, device="cpu") == pytest.approx(
        float(jref.calibrate.evaluate(twins(jref.twin)[k],
                                      _jtrace(jref, trace))),
        rel=LOSS_RTOL)


def _jtrace(jref, trace):
    return jref.calibrate.ObservedTrace(
        name=trace.name, bin_hours=trace.bin_hours, arrivals=trace.arrivals,
        processed=trace.processed, latency_s=trace.latency_s,
        dropped=trace.dropped, cost_usd=trace.cost_usd)


@pytest.mark.parametrize("policy,truth_k", [("fifo", 0), ("quickscale", 1),
                                            ("shed", 3)])
def test_gradient_matches_finite_differences(policy, truth_k):
    """Central finite differences confirm d(loss)/d(z) through the scan
    (the reference test, its tolerances)."""
    truth = twins(pt)[truth_k]
    pattern = steady(plp) if policy == "quickscale" else ramp(plp)
    trace = pc.ObservedTrace.from_loadpattern(pattern, truth, bin_s=300.0,
                                              device="cpu")
    spec = pc.fit_spec(policy, init=truth)
    box = [torch.as_tensor(b) for b in (spec.lo, spec.hi, spec.log_mask,
                                        spec.free_mask, spec.fixed)]
    ops_ = operands(trace)
    w = {k: torch.tensor(1.0) for k in pc.SERIES_KEYS}

    def loss(z):
        return pc.trace_loss(z, ops_[0], ops_[1], ops_[2], w,
                             truth.policy_index, trace.bin_hours, *box)

    z0 = pc.z_from_params(truth.padded_params() * 1.17, spec.lo, spec.hi,
                          spec.log_mask)
    zt = torch.tensor(z0, requires_grad=True)
    loss(zt).backward()
    g_ad = zt.grad.numpy().astype(np.float64)
    h = 1e-3
    for i in np.nonzero(spec.free_mask)[0]:
        zp, zm = z0.copy(), z0.copy()
        zp[i] += h
        zm[i] -= h
        g_fd = (float(loss(torch.tensor(zp)))
                - float(loss(torch.tensor(zm)))) / (2 * h)
        assert g_ad[i] == pytest.approx(
            g_fd, rel=0.05, abs=max(5e-3, 1e-2 * abs(g_ad).max())), \
            (policy, spec.param_names[i], g_ad[i], g_fd)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _numpy_adamw(p, g, m, v, step, ocfg):
    gn = np.sqrt(np.sum(g * g))
    g = g * min(1.0, ocfg.grad_clip / (gn + 1e-9))
    m = ocfg.betas[0] * m + (1 - ocfg.betas[0]) * g
    v = ocfg.betas[1] * v + (1 - ocfg.betas[1]) * g * g
    mh = m / (1 - ocfg.betas[0] ** step)
    vh = v / (1 - ocfg.betas[1] ** step)
    warm = min(step / max(ocfg.warmup_steps, 1), 1.0)
    t = min(max((step - ocfg.warmup_steps)
                / max(ocfg.total_steps - ocfg.warmup_steps, 1), 0.0), 1.0)
    lr = ocfg.lr * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))
    p = p - lr * (mh / (np.sqrt(vh) + ocfg.eps) + ocfg.weight_decay * p)
    return p, m, v


def test_adamw_matches_numpy_reference(jref):
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=100,
                           weight_decay=0.1)
    from repro.config import OptimizerConfig as JOptimizerConfig
    jocfg = JOptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=100,
                             weight_decay=0.1)
    jnp = jref.jax.numpy
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    p = {"w": torch.tensor(p0)}
    state = init_opt_state(p, ocfg)
    jp = {"w": jnp.asarray(p0)}
    jstate = jref.optim.init_opt_state(jp, jocfg)
    pn, mn, vn = p0.copy(), np.zeros_like(p0), np.zeros_like(p0)
    for step in range(1, 4):
        g = rng.normal(size=(5, 7)).astype(np.float32)
        p, state = adamw_update(p, {"w": torch.tensor(g)}, state, ocfg)
        jp, jstate = jref.optim.adamw_update(jp, {"w": jnp.asarray(g)},
                                             jstate, jocfg)
        pn, mn, vn = _numpy_adamw(pn, g, mn, vn, step, ocfg)
        np.testing.assert_allclose(p["w"].numpy(), pn, atol=1e-5, rtol=1e-5)
        # against the reference's update: the float32 pow and cos of
        # libm and of XLA may differ in the last ulp
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-7)
    assert int(state.step) == 3


def test_adamw_lanes_clip_each_problem_on_its_own():
    """``lanes=1``: each row is its own problem, clipped by its own global
    norm (the reference vmaps the update over the fit's restarts)."""
    ocfg = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=10,
                           grad_clip=1.0, weight_decay=0.0)
    z = torch.zeros((3, 6))
    g = torch.tensor(np.random.default_rng(2).normal(
        0, [[0.1], [10.0], [100.0]], (3, 6)).astype(np.float32))
    new, _ = adamw_update({"z": z}, {"z": g}, init_opt_state({"z": z}, ocfg),
                          ocfg, lanes=1)
    for k in range(3):
        row, _ = adamw_update({"z": z[k]}, {"z": g[k]},
                              init_opt_state({"z": z[k]}, ocfg), ocfg)
        assert_bitwise(new["z"][k].numpy(), row["z"].numpy(), f"row {k}")


def test_lr_schedule_shape(jref):
    ocfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(lr_at(0, ocfg)) == 0.0
    assert abs(float(lr_at(10, ocfg)) - 1.0) < 1e-6
    assert float(lr_at(100, ocfg)) == pytest.approx(0.1, abs=1e-6)
    vals = [float(lr_at(s, ocfg)) for s in range(10, 101, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    jnp = jref.jax.numpy
    from repro.config import OptimizerConfig as JOptimizerConfig
    jocfg = JOptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100)
    got = np.array([float(lr_at(s, ocfg)) for s in range(0, 120, 7)])
    want = np.array([float(jref.optim.lr_at(jnp.asarray(s, jnp.int32),
                                            jocfg))
                     for s in range(0, 120, 7)])
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("state_dtype", ["bfloat16", "int8"])
def test_quantized_states_are_not_ported(jref, state_dtype):
    """The quantized moments were refused until the training side was
    ported (ROADMAP A9); now their layout is the reference's (int8 blocks
    of ``state_block`` with per-block scales; bf16 moments of the
    parameter's shape) and an update runs. Only the fit's ``lanes`` form
    still takes float32 moments alone. The values against the
    reference's are ``tests/test_torch_train.py``'s."""
    from repro.config import OptimizerConfig as JOptimizerConfig
    ocfg = OptimizerConfig(state_dtype=state_dtype, state_block=4)
    p = {"w": torch.arange(10, dtype=torch.float32)}
    st = init_opt_state(p, ocfg)
    jst = jref.optim.init_opt_state(
        {"w": jref.jax.numpy.asarray(p["w"].numpy())},
        JOptimizerConfig(state_dtype=state_dtype, state_block=4))
    for got, want in ((st.m, jst.m), (st.v, jst.v), (st.m_scale, jst.m_scale),
                      (st.v_scale, jst.v_scale)):
        assert set(got) == set(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    new_p, st2 = adamw_update(p, {"w": torch.ones(10)}, st, ocfg)
    assert int(st2.step) == 1 and st2.m["w"].dtype == st.m["w"].dtype
    assert torch.isfinite(new_p["w"]).all()
    with pytest.raises(ValueError, match="float32 moments"):
        adamw_update(p, {"w": torch.ones(10)}, st, ocfg, lanes=1)


# ---------------------------------------------------------------------------
# the fit's bookkeeping
# ---------------------------------------------------------------------------

def test_fit_spec_freeze_and_fixed_values():
    spec = pc.fit_spec("autoscale", fixed_values={"min_instances": 2.0,
                                                  "max_instances": 8.0})
    assert spec.free_names == ("max_rps", "usd_per_hour", "base_latency_s",
                               "scale_up_hours")
    assert spec.fixed[3] == 2.0 and spec.fixed[4] == 8.0
    spec2 = pc.fit_spec("autoscale", unfreeze=("max_instances",),
                        fixed_values={"min_instances": 1.0})
    assert "max_instances" in spec2.free_names
    spec3 = pc.fit_spec("fifo", freeze=("usd_per_hour",),
                        fixed_values={"usd_per_hour": 0.01})
    assert "usd_per_hour" not in spec3.free_names
    with pytest.raises(KeyError):
        pc.fit_spec("fifo", freeze=("bogus",))
    with pytest.raises(ValueError):
        pc.fit_spec("fifo", init=SHED_TRUTH)


def test_fit_warns_when_warm_start_outside_bounds():
    """A measured pipeline faster than the calibration box is not clamped
    silently: both warnings fire, and each counts its ``warn.*`` event."""
    tr = pc.ObservedTrace.from_loadpattern(
        plp.LoadPattern.steady("s", 1800.0, 3.0), FIFO_TRUTH, bin_s=300.0,
        device="cpu")
    giant = pt.SimpleTwin("g", 2000.0, 0.05, 0.2)   # max_rps box tops at 1e3
    with obs.capture() as rec, pytest.warns(UserWarning) as warned:
        pc.fit(tr, "fifo", restarts=2, steps=5, seed=0, init=giant,
               device="cpu")
    messages = [str(w.message) for w in warned]
    assert any("outside the calibration bounds" in m for m in messages)
    assert any("pinned" in m for m in messages)
    counters = obs.counters()
    assert rec.counter_total("warn.fit_warm_start_outside") == 1
    assert rec.counter_total("warn.fit_pinned") == 1
    assert counters["calibrate.fits{policy=fifo}"] == 1
    assert counters["calibrate.restarts"] == 2


def test_fit_result_reporting():
    tr = pc.ObservedTrace.from_loadpattern(ramp(plp), SHED_TRUTH,
                                           bin_s=300.0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # a clean fit warns nothing
        res = pc.fit(tr, "shed", restarts=4, steps=150, seed=0,
                     device="cpu")
    assert res.loss_history.shape == (150, 4)
    assert res.start_losses.shape == (4,)
    assert res.loss == pytest.approx(res.start_losses.min())
    rows = res.restart_table()
    assert len(rows) == 4
    assert sum(r["best"] for r in rows) == 1
    assert all(set(res.spec.free_names) <= set(r) for r in rows)
    assert res.twin.kind == "calibrated" and res.twin.policy == "shed"
    assert res.generalization_gap is None


def test_fit_history_matches_reference_first_steps(jref):
    """The first steps of a fit run the reference's arithmetic: the loss
    history agrees within HISTORY_RTOL (not bitwise: the loss's log, the
    sigmoid of the reparameterisation and the schedule's cos are libm's
    here and XLA's there)."""
    steps = 5
    tr = pc.ObservedTrace.from_loadpattern(ramp(plp), SHED_TRUTH,
                                           bin_s=300.0, device="cpu")
    got = pc.fit(tr, "shed", restarts=4, steps=steps, seed=0, device="cpu")
    want = jref.calibrate.fit(_jtrace(jref, tr), "shed", restarts=4,
                              steps=steps, seed=0)
    assert rel(got.loss_history, want.loss_history) <= HISTORY_RTOL, \
        rel(got.loss_history, want.loss_history)


def test_fit_devices_beyond_one_are_not_ported():
    tr = pc.ObservedTrace.from_loadpattern(ramp(plp), SHED_TRUTH,
                                           bin_s=300.0, device="cpu")
    # more than one device is the restart mesh over torch.distributed
    # ranks (tests/test_torch_restart_mesh.py); without a process group
    # it raises, naming how to start the ranks
    with pytest.raises(ValueError, match="torchrun"):
        pc.fit(tr, "shed", restarts=4, steps=2, devices=2, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        pc.fit(tr, "shed", restarts=4, steps=2, devices=-2, device="cpu")
    res = pc.fit(tr, "shed", restarts=2, steps=2, devices=1, device="cpu")
    assert res.loss_history.shape == (2, 2)


def test_calibrate_exports_the_reference_surface(jref):
    assert pc.__all__ == jref.calibrate.__all__
    assert pobj.DEFAULT_WEIGHTS == jref.calibrate.DEFAULT_WEIGHTS
    assert pc.DEFAULT_FIT_OPT == pc.DEFAULT_FIT_OPT.__class__(
        **{f: getattr(jref.calibrate.DEFAULT_FIT_OPT, f)
           for f in pc.DEFAULT_FIT_OPT.__dataclass_fields__})
