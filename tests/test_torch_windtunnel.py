"""The port's wind tunnel against ``repro.core`` / ``repro.pipelines``.

Same seeded inputs through the reference and the port: load patterns,
synthetic data (every field kind, the telemetry zips), the metric store,
the telemetry pipeline's ETL output per variant, and the fits of a twin
from an experiment. Then the reference's own wind-tunnel checks
(``tests/test_windtunnel.py``) through the port, within its tolerances,
and an experiment over a smoke-width ``ServeEngine`` on the CPU.
"""
import dataclasses
import inspect
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.core import cost as pcost
from repro_torch.core import datagen as pdatagen
from repro_torch.core import experiment as pexperiment
from repro_torch.core import loadpattern as plp
from repro_torch.core import metrics as pmetrics
from repro_torch.core import schema as pschema
from repro_torch.core import spans as pspans
from repro_torch.core import twin as ptwin
from repro_torch.core.pipeline import Pipeline, PipelineStage, Resources
from repro_torch.models import model as M
from repro_torch.pipelines import telemetry as ptelemetry
from repro_torch.serve.engine import ServeEngine

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import reference


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


def patterns(lp):
    return [lp.LoadPattern.ramp("ramp", duration_s=120, peak_rate=40),
            lp.LoadPattern.steady("steady", 7.5, 33.3),
            lp.LoadPattern("multi", (lp.Segment(10, 0, 100),
                                     lp.Segment(10, 50, 50),
                                     lp.Segment(0.3, 7.0, 1e-3),
                                     lp.Segment(25.0, 12.5, 0.0)))]


@pytest.mark.parametrize("k", range(3))
def test_load_patterns_match_reference(jref, k):
    want, got = patterns(jref.loadpattern)[k], patterns(plp)[k]
    assert got.total_records == want.total_records
    assert got.total_duration == want.total_duration
    ts = np.linspace(-1.0, want.total_duration + 2.0, 257)
    assert [got.rate_at(float(t)) for t in ts] == \
        [want.rate_at(float(t)) for t in ts]
    for t0, t1, n in ((0.0, want.total_duration, 32), (1.25, 9.5, 7),
                      (3.0, 3.02, 32), (5.0, want.total_duration + 4, 200)):
        assert got.records_between(t0, t1, n) == \
            want.records_between(t0, t1, n)


def every_kind(sc):
    return sc.Schema("every-kind", (
        sc.FieldSpec("f", "float", -3.0, 9.5),
        sc.FieldSpec("i", "int", 5, 5000),
        sc.FieldSpec("ts", "timestamp"),
        sc.FieldSpec("c", "choice", choices=("a", "bb", "ccc")),
        sc.FieldSpec("ll", "latlon"),
        sc.FieldSpec("tok", "tokens", vocab_size=65536, length=8),
        sc.FieldSpec("raw", "bytes", length=13)))


@pytest.mark.parametrize("schema", ["every_kind", "telemetry", "tokens"])
@pytest.mark.parametrize("seed", [0, 7])
def test_datagen_matches_reference(jref, schema, seed):
    make = {"every_kind": every_kind,
            "telemetry": lambda sc: sc.telemetry_schema(),
            "tokens": lambda sc: sc.token_stream_schema(65536, 8)}[schema]
    want = jref.datagen.DataGenerator(seed=seed).generate(
        make(jref.schema), 37)
    got = pdatagen.DataGenerator(seed=seed).generate(make(pschema), 37)
    assert got.num_records == want.num_records
    assert got.total_bytes == want.total_bytes
    assert dataclasses.astuple(got.schema) == dataclasses.astuple(want.schema)
    assert list(got.columns) == list(want.columns)
    for name, col in want.columns.items():
        assert got.columns[name].dtype == col.dtype, name
        assert np.array_equal(got.columns[name], col), name
    for start, count in ((0, 4), (35, 5)):
        a = got.record_batch(start, count)
        b = want.record_batch(start, count)
        for name in b:
            assert np.array_equal(a[name], b[name]), name


def test_telemetry_dataset_matches_reference(jref):
    want = jref.telemetry.make_telemetry_dataset(num_records=6, seed=3)
    got = ptelemetry.make_telemetry_dataset(num_records=6, seed=3)
    assert dataclasses.astuple(got.schema) == dataclasses.astuple(want.schema)
    assert got.num_records == want.num_records
    assert [bytes(b) for b in got.columns["zip"]] == \
        [bytes(b) for b in want.columns["zip"]]


def fill(ms):
    rng = np.random.default_rng(11)
    for i, (v, dt) in enumerate(zip(rng.normal(3.0, 2.0, 60),
                                    rng.uniform(0.01, 0.4, 60))):
        t = float(np.sum(dt) + i * 0.1)
        ms.observe("lat", float(v), t=t)
        ms.inc("count", float(abs(v)), t=t)
    return ms


def test_metric_store_matches_reference(jref, tmp_path):
    want = fill(jref.metrics.MetricStore())
    got = fill(pmetrics.MetricStore())
    assert got.names() == want.names()
    for q in (0.0, 0.5, 0.95, 1.0):
        assert got.quantile("lat", q) == want.quantile("lat", q)
    assert got.mean("lat") == want.mean("lat")
    for w in (0.5, 3.0, 100.0):
        assert got.rate("count", window_s=w) == want.rate("count", window_s=w)
    assert [(s.t, s.value) for s in got.window("lat", 1.0, 4.0)] == \
        [(s.t, s.value) for s in want.window("lat", 1.0, 4.0)]
    got.dump_jsonl(str(tmp_path / "p.jsonl"))
    want.dump_jsonl(str(tmp_path / "r.jsonl"))
    text = (tmp_path / "p.jsonl").read_text()
    assert text == (tmp_path / "r.jsonl").read_text()
    back = pmetrics.MetricStore.load_jsonl(str(tmp_path / "r.jsonl"))
    assert back.values("lat") == want.values("lat")


def etl_output(tel, variant, dataset, blob_dir):
    """One batch through the three stage functions in order (no worker
    threads): the rows the ETL inserted and its counters."""
    pipe = tel.make_telemetry_pipeline(variant, blob_dir=str(blob_dir))
    out = dataset.record_batch(0, dataset.num_records)
    for stage in pipe.stages:
        out = stage.fn(out)
    rows = pipe.etl.db.execute(
        "SELECT * FROM telemetry ORDER BY vehicle, subsystem, channel"
    ).fetchall()
    return (pipe.name, [s.name for s in pipe.stages],
            [s.cpu_quota for s in pipe.stages],
            dataclasses.astuple(pipe.resources), pipe.etl.rows,
            pipe.etl.scrubbed, rows)


@pytest.mark.parametrize("variant", ["blocking-write", "no-blocking-write",
                                     "cpu-limited"])
def test_telemetry_pipeline_etl_matches_reference(jref, variant, tmp_path):
    assert ptelemetry.TELEMETRY_VARIANTS == jref.telemetry.TELEMETRY_VARIANTS
    want = etl_output(jref.telemetry, variant,
                      jref.telemetry.make_telemetry_dataset(5, seed=1),
                      tmp_path / "ref")
    got = etl_output(ptelemetry, variant,
                     ptelemetry.make_telemetry_dataset(5, seed=1),
                     tmp_path / "port")
    assert got == want
    assert got[4] > 0 and got[5] > 0       # rows inserted, NaNs scrubbed


def experiment_result(ex, sp, ms, cost):
    """An ExperimentResult with fixed fields (no run), as the fits read
    them."""
    summary = {"a": {"records": 40, "mean_latency_s": 0.011,
                     "p50_latency_s": 0.0103, "throughput_rps": 31.7,
                     "busy_s": 0.44},
               "b": {"records": 40, "mean_latency_s": 0.2,
                     "p50_latency_s": 0.1875, "throughput_rps": 5.3,
                     "busy_s": 8.1}}
    return ex.ExperimentResult(
        name="e", pipeline_name="pipe", started=0.0, duration_s=7.31,
        records_sent=43, records_done=41, ingest_mb=0.5,
        stage_summary=summary, cost=cost.CostModel(
            chip_usd_per_hour=2.5).experiment_cost(
                Resources(vcpus=2, ram_gb=4, chips=1), 7.31, 0.5),
        collector=sp.SpanCollector(), metrics=ms.MetricStore(),
        drained=True)


def test_fits_match_reference(jref):
    want = experiment_result(jref.experiment, jref.spans, jref.metrics,
                             jref.cost)
    got = experiment_result(pexperiment, pspans, pmetrics, pcost)
    assert got.cost == want.cost
    assert got.sustained_rps == want.sustained_rps
    assert got.base_latency_s == want.base_latency_s
    fits = [lambda t, r: t.fit_twin(r), lambda t, r: t.fit_simple_twin(r),
            lambda t, r: t.fit_quickscaling_twin(r, name="q"),
            lambda t, r: t.fit_twin(r, "shed", queue_cap_hours=2.0),
            lambda t, r: t.fit_twin(r, "autoscale", name="a",
                                    max_instances=8)]
    for fit in fits:
        a, b = fit(ptwin, got), fit(jref.twin, want)
        assert (a.name, a.policy, a.kind, a.params) == \
            (b.name, b.policy, b.kind, b.params)


def test_roofline_twin_needs_a_price(jref):
    params = inspect.signature(ptwin.roofline_twin).parameters
    assert params["chip_usd_per_hour"].default is inspect.Parameter.empty
    with pytest.raises(TypeError, match="chip_usd_per_hour"):
        ptwin.roofline_twin("r", step_seconds=0.05, records_per_step=4,
                            chips=8)
    kw = dict(step_seconds=0.05, records_per_step=4, chips=8,
              chip_usd_per_hour=3.25)
    a = ptwin.roofline_twin("r", **kw)
    b = jref.twin.roofline_twin("r", **kw)
    assert (a.policy, a.kind, a.params) == (b.policy, b.kind, b.params)


# ---------------------------------------------------------------------------
# the reference's wind-tunnel checks (tests/test_windtunnel.py), on the port
# ---------------------------------------------------------------------------

def test_ramp_total_records():
    lp = plp.LoadPattern.ramp("r", duration_s=120, peak_rate=40)
    assert abs(lp.total_records - 2400) < 1e-6      # paper's 120s 0->40 ramp


@settings(max_examples=30, deadline=None)
@given(d=st.floats(1.0, 50.0), r0=st.floats(0.0, 100.0),
       r1=st.floats(0.0, 100.0), split=st.floats(0.1, 0.9))
def test_records_between_additive(d, r0, r1, split):
    lp = plp.LoadPattern("x", (plp.Segment(d, r0, r1),))
    t = d * split
    a = lp.records_between(0, t, n=200) + lp.records_between(t, d, n=200)
    b = lp.records_between(0, d, n=400)
    assert abs(a - b) < max(0.02 * b, 0.5)


def test_rate_interpolation():
    lp = plp.LoadPattern("x", (plp.Segment(10, 0, 100),
                               plp.Segment(10, 50, 50)))
    assert abs(lp.rate_at(5) - 50) < 1e-9
    assert abs(lp.rate_at(15) - 50) < 1e-9
    assert lp.rate_at(25) == 0.0


def test_datagen_deterministic_and_constrained():
    schema = pschema.telemetry_schema()
    ds1 = pdatagen.DataGenerator(seed=1).generate(schema, 50)
    ds2 = pdatagen.DataGenerator(seed=1).generate(schema, 50)
    np.testing.assert_array_equal(ds1.columns["speed_kph"],
                                  ds2.columns["speed_kph"])
    assert (ds1.columns["speed_kph"] >= 0).all()
    assert (ds1.columns["speed_kph"] <= 200).all()
    lat = ds1.columns["location"][:, 0]
    assert (lat > 35).all() and (lat < 45).all()   # land box, not mid-ocean


def test_token_stream_zipfian():
    schema = pschema.token_stream_schema(vocab_size=1000, seq_len=64)
    toks = pdatagen.DataGenerator(seed=0).generate(schema, 100).columns[
        "tokens"]
    assert toks.shape == (100, 64)
    assert toks.min() >= 0 and toks.max() < 1000
    assert (toks == 0).mean() > 10 / 1000      # Zipf: token 0 dominates


def test_span_nesting_and_summary():
    col = pspans.SpanCollector()
    with pspans.span("outer", col, records=10):
        with pspans.span("inner", col, records=10):
            time.sleep(0.01)
    s = col.summary()
    assert s["outer"]["records"] == 10
    assert s["inner"]["mean_latency_s"] >= 0.001 / 10
    assert s["outer"]["busy_s"] >= s["inner"]["busy_s"]


def test_metric_store_rate_and_quantile(tmp_path):
    ms = pmetrics.MetricStore()
    for i in range(10):
        ms.inc("count", 5, t=float(i))
        ms.observe("lat", float(i), t=float(i))
    assert abs(ms.rate("count", window_s=100) - 5.0) < 1e-6
    assert ms.quantile("lat", 0.5) == 5.0
    assert ms.mean("lat") == 4.5
    p = str(tmp_path / "m.jsonl")
    ms.dump_jsonl(p)
    assert pmetrics.MetricStore.load_jsonl(p).values("lat") == \
        [float(i) for i in range(10)]


def _rate_limited_pipeline(service_s: float) -> Pipeline:
    def work(batch):
        time.sleep(service_s)
        return batch

    return Pipeline("calibrated", [PipelineStage("only_stage", work)],
                    resources=Resources(vcpus=1, ram_gb=1))


def test_experiment_measures_known_capacity():
    # the reference's case as it stands (no time_scale: a dilated run
    # would need a shorter stage, whose sleep jitter weighs more)
    pipe = _rate_limited_pipeline(0.01)   # 100 rec/s capacity
    schema = pschema.Schema("one", (pschema.FieldSpec("x", "float"),))
    ds = pdatagen.DataGenerator(0).generate(schema, 100)
    load = plp.LoadPattern.steady("over", duration_s=1.5, rate=300)
    res = pexperiment.Experiment("cal", pipe, load, ds,
                                 drain_timeout_s=30).run()
    assert res.drained and not pipe.errors
    tw = ptwin.fit_simple_twin(res)
    # sustained throughput within 40% of the known 100 rec/s (sleep jitter)
    assert 55 < tw.max_rps < 145, tw.max_rps
    assert res.records_sent == pytest.approx(450, abs=2)
    assert tw.usd_per_hour > 0


def test_experiment_engaged_serially():
    pipe = _rate_limited_pipeline(0.001)
    schema = pschema.Schema("one", (pschema.FieldSpec("x", "float"),))
    ds = pdatagen.DataGenerator(0).generate(schema, 10)
    load = plp.LoadPattern.steady("s", 0.2, 50)
    e = pexperiment.Experiment("a", pipe, load, ds)
    assert not pexperiment._ENGAGED.locked()
    r = e.run()
    assert e.status == "completed"
    assert r.cost["total_usd"] > 0
    # a second experiment waits while one is engaged
    with pexperiment._ENGAGED:
        assert not pexperiment._ENGAGED.acquire(timeout=0.01)


def test_pipeline_queue_backlog_visible():
    pipe = _rate_limited_pipeline(0.05)   # 20 rec/s
    pipe.start()
    for i in range(20):
        pipe.submit({"x": i}, records=1)
    assert pipe.inflight > 5              # backlog forms
    assert pipe.drain(timeout=10)
    pipe.stop()


def test_experiment_over_chips_needs_a_price():
    pipe = Pipeline("card", [PipelineStage("s", lambda b: None)],
                    resources=Resources(chips=1))
    schema = pschema.Schema("one", (pschema.FieldSpec("x", "float"),))
    ds = pdatagen.DataGenerator(0).generate(schema, 4)
    exp = pexperiment.Experiment("x", pipe, plp.LoadPattern.steady(
        "s", 0.1, 10), ds)
    with pytest.raises(ValueError, match="chip_usd_per_hour"):
        exp.run()
    assert exp.status == "pending"
    priced = dataclasses.replace(
        exp, cost_model=pcost.CostModel(chip_usd_per_hour=2.0))
    res = priced.run()
    assert res.cost["usd_per_hour"] == pytest.approx(
        2.0 + 2 * pcost.VCPU_USD_PER_HOUR + 4 * pcost.RAM_USD_PER_GB_HOUR)


def test_telemetry_experiment_fits_a_twin(tmp_path):
    """The quickstart loop's measurement on the port, dilated 3x: the
    blocking-write pipeline drains, every stage is measured and the fitted
    twin has a positive capacity and price."""
    pipe = ptelemetry.make_telemetry_pipeline("blocking-write",
                                              blob_dir=str(tmp_path))
    ds = ptelemetry.make_telemetry_dataset(num_records=12, seed=0)
    load = plp.LoadPattern.ramp("0->120rps", duration_s=3.0,
                                peak_rate=120.0)
    res = pexperiment.Experiment("quick", pipe, load, ds,
                                 time_scale=3.0).run()
    assert res.drained and not pipe.errors
    assert res.records_sent == pytest.approx(180, abs=2)
    assert res.records_done == res.records_sent
    assert set(res.stage_summary) == {"unzipper_phase", "v2x_phase",
                                      "etl_phase"}
    assert pipe.etl.rows > 0
    tw = ptwin.fit_simple_twin(res)
    assert tw.max_rps > 0 and tw.usd_per_hour > 0 and tw.base_latency_s > 0


def test_serving_engine_through_an_experiment():
    """The serving slice's wind tunnel on the CPU: an experiment over a
    smoke-width rwkv6 engine's pipeline drains with no stage error, the
    engine's prefill / decode spans land in the result, and with
    telemetry on they mirror into obs beside the serving counters."""
    cfg = get_smoke_config("rwkv6-7b")
    params = M.init_params(cfg, seed=0, device="cpu")
    eng = ServeEngine(cfg, params, slots=4, max_len=16, chips=1,
                      device="cpu")
    pipe = eng.as_pipeline()
    ds = pdatagen.DataGenerator(seed=0).generate(
        pschema.token_stream_schema(cfg.vocab_size, 8), 32)
    exp = pexperiment.Experiment(
        "serve", pipe, plp.LoadPattern.ramp("r", 2.0, 16.0), ds,
        cost_model=pcost.CostModel(chip_usd_per_hour=2.0),
        batch_records=4, tick_s=0.25, drain_timeout_s=60)
    with obs.capture() as rec:
        res = exp.run()
    assert res.drained and pipe.errors == []
    assert res.records_done == res.records_sent
    assert res.records_sent == pytest.approx(16, abs=1)
    assert {"serve_group", "prefill", "decode"} <= set(res.stage_summary)
    groups = res.collector.spans("serve_group")
    assert len(res.collector.spans("prefill")) == len(groups)
    assert len(res.collector.spans("decode")) == 3 * len(groups)
    assert sum(s.records for s in groups) == res.records_sent
    assert rec.counter_total("serve.requests") == res.records_sent
    assert len(rec.find(name="stage.prefill")) == len(groups)
    assert len(rec.find(name="stage.serve_group")) == len(groups)
    tw = ptwin.fit_twin(res, "fifo")
    assert tw.max_rps == res.sustained_rps > 0
    assert tw.usd_per_hour == res.cost["usd_per_hour"]
