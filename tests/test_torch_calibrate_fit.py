"""The port's twin fits, end to end on the CPU (``tests/test_calibrate.py``'s
fitting cases, at the reference tests' sizes and tolerances).

Noiseless replays recover their twin: fifo and shed within 5% (8
restarts x 400 steps, a 6 h ramp in 300 s bins), fifo within 10% under 2%
measurement noise; the fit generalises to a holdout trace;
``calibrated_twin`` and ``calibrated_grid`` take a measured experiment
(or a trace) to Table II rows. The two slow recoveries (16 restarts x 800
steps) have files of their own: autoscale
(``test_torch_calibrate_autoscale.py``) and batch_window
(``test_torch_calibrate_batch_window.py``).
"""
import numpy as np
import pytest

from repro_torch import calibrate as pc
from repro_torch.core import loadpattern as plp
from repro_torch.core import metrics as pmetrics
from repro_torch.core import spans as pspans
from repro_torch.core import experiment as pexp
from repro_torch.core import traffic as ptraffic
from repro_torch.core import twin as pt
from repro_torch.core import whatif as pwhatif

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import synthetic_result

RAMP = plp.LoadPattern.ramp("ramp", duration_s=6 * 3600, peak_rate=6.0)
STEADY = plp.LoadPattern.steady("steady", duration_s=6 * 3600, rate=3.0)
FIFO_TRUTH = pt.SimpleTwin("t", 2.0, 0.05, 0.2)
SHED_TRUTH = pt.make_twin("t", "shed", max_rps=2.0, usd_per_hour=0.05,
                          base_latency_s=0.2, queue_cap_hours=1.5)


def relerrs(result, truth):
    tp = truth.padded_params()
    return {n: float(abs(result.params[i] - tp[i]) / max(abs(tp[i]), 1e-9))
            for i, n in enumerate(result.spec.param_names)
            if result.spec.free_mask[i]}


def replay(pattern, truth, bin_s=300.0):
    return pc.ObservedTrace.from_loadpattern(pattern, truth, bin_s=bin_s,
                                             device="cpu")


def test_recover_fifo_params():
    res = pc.fit(replay(RAMP, FIFO_TRUTH), "fifo", restarts=8, steps=400,
                 seed=0, device="cpu")
    assert max(relerrs(res, FIFO_TRUTH).values()) < 0.05


def test_recover_shed_params():
    tr = replay(RAMP, SHED_TRUTH)
    res = pc.fit(tr, "shed", restarts=8, steps=400, seed=0, device="cpu")
    assert max(relerrs(res, SHED_TRUTH).values()) < 0.05
    assert tr.dropped.sum() > 0       # the trace actually exercised the cap


def test_recover_fifo_params_under_noise():
    tr = replay(RAMP, FIFO_TRUTH)
    res = pc.fit(tr.with_noise(0.02, seed=3), "fifo", restarts=8, steps=400,
                 seed=0, device="cpu")
    assert max(relerrs(res, FIFO_TRUTH).values()) < 0.10


def test_holdout_fit_on_ramp_validates_on_steady():
    train = replay(RAMP, SHED_TRUTH)
    hold = replay(STEADY, SHED_TRUTH)
    res = pc.fit_with_holdout(train, hold, "shed", restarts=8, steps=400,
                              seed=0, device="cpu")
    assert res.holdout_loss is not None and res.holdout_name == hold.name
    assert res.holdout_loss < 0.05
    assert res.generalization_gap == pytest.approx(
        res.holdout_loss / res.loss, rel=1e-6)
    assert pc.evaluate(res.twin, hold, device="cpu") == pytest.approx(
        res.holdout_loss)


def test_calibrated_twin_from_trace_and_experiment():
    tw = pc.calibrated_twin(replay(RAMP, FIFO_TRUTH), "fifo", restarts=8,
                            steps=400, seed=0, device="cpu")
    assert isinstance(tw, pt.Twin) and tw.policy == "fifo"
    assert abs(tw.max_rps - 2.0) / 2.0 < 0.05
    res = synthetic_result(pspans, pmetrics, pexp, rate_rps=20.0)
    tw2 = pc.calibrated_twin(res, "fifo", bin_s=10.0, restarts=4, steps=200,
                             device="cpu")
    assert tw2.policy == "fifo" and np.isfinite(tw2.max_rps)
    # the synthetic pipeline kept up at 20 rec/s, so fitted capacity >= that
    assert tw2.max_rps > 5.0


def test_calibrated_grid_end_to_end():
    """Experiment -> one fitted twin per policy -> Table II rows, the rows
    those twins give through run_grid."""
    res = synthetic_result(pspans, pmetrics, pexp, rate_rps=20.0)
    traffics = [ptraffic.TrafficModel.honda_default("nom", R=3.5)]
    sims = pwhatif.calibrated_grid(res, ["fifo", "quickscale"], traffics,
                                   bin_s=10.0, restarts=4, steps=200,
                                   device="cpu")
    assert len(sims) == 2
    assert {s.twin.policy for s in sims} == {"fifo", "quickscale"}
    assert [s.twin.name for s in sims] == ["fifo-cal", "quickscale-cal"]
    for s in sims:
        assert np.isfinite(s.total_cost_usd) and s.processed_records > 0.0
    again = pwhatif.run_grid([s.twin for s in sims], traffics,
                             device="cpu")
    assert [r.total_cost_usd for r in again] == \
        [s.total_cost_usd for s in sims]


def test_from_otel_spans_feeds_calibration():
    """The importer's trace drops straight into fit."""
    rng = np.random.default_rng(3)
    spans, t = [], 0.0
    for _ in range(400):
        t += float(rng.exponential(2.0))
        spans.append({"start": t, "end": t + float(rng.uniform(0.2, 1.0))})
    tr = pc.ObservedTrace.from_otel_spans(spans, bin_seconds=120.0)
    res = pc.fit(tr, "fifo", restarts=4, steps=60, seed=0,
                 weights={"cost": 0.0}, device="cpu")
    assert np.isfinite(res.loss)
    assert res.twin.policy == "fifo"
