"""The port's run telemetry (``repro_torch.obs``) against ``repro.obs``.

The cases of the reference's ``tests/test_obs.py`` that the port's
modules reach, through the port: off by default with a shared null span,
no numeric effect, nesting and mutable attrs, ``instrument`` / ``timed`` /
``capture``, labelled counters, ring capacity and retention, the grid's
spans and counters, the ``faults.*`` counts, the Prometheus page, JSONL
retention, the report and the serving loop. Then the port against the
reference: the same grid counters and ``grid.simulate`` attrs for one
grid, rows bitwise the same with telemetry on and off, the same
Prometheus text for the Table II rows, and the ``stage.*`` mirror of an
experiment; the golden round trip (an instrumented experiment's spans,
exported as OTel dicts, binned by ``ObservedTrace.from_otel_spans`` and
refitted) with the ``calibrate.fit`` span and counters, the same as the
reference's. ``profile_dispatch`` and ``jit_cache_grew`` on the CPU path
close it.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch import faults, obs
from repro_torch.configs import get_smoke_config
from repro_torch.core import datagen as pdatagen
from repro_torch.core import experiment as pexperiment
from repro_torch.core import loadpattern as plp
from repro_torch.core import schema as pschema
from repro_torch.core import slo as pslo
from repro_torch.core import traffic as ptraffic
from repro_torch.core import twin as ptwin
from repro_torch.core import whatif as pwhatif
from repro_torch.core.pipeline import Pipeline, PipelineStage, Resources
from repro_torch.core import simulate as psim
from repro_torch.core.simulate import simulate_grid
from repro_torch.kernels import build
from repro_torch.models import model as M
from repro_torch.obs.export import (append_jsonl, prometheus_exposition,
                                    read_jsonl, to_otel_spans)
from repro_torch.obs.record import _NULL, Recorder
from repro_torch.obs.report import _demo, _report_file, render, summarize
from repro_torch.serve.engine import Request, ServeEngine

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import assert_same_results, reference

SLO_KW = dict(limit_s=4 * 3600, met_fraction=0.95)
SLO_4H = pslo.SLO(**SLO_KW)


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


@pytest.fixture(autouse=True)
def _obs_clean_slate():
    """Every test starts disabled with an empty global recorder and
    leaves the module state the way it found it."""
    was_enabled = obs.enabled()
    obs.disable()
    obs.get_recorder().clear()
    yield
    if was_enabled:
        obs.enable()
    else:
        obs.disable()
    obs.get_recorder().clear()


def _small_grid(tw, tr, n=16, distinct=4, t_bins=168):
    """n scenarios over ``distinct`` twin configs x 2 traffics, a week of
    hourly bins (pass ``bin_hours=1.0``); dedup collapses the grid
    ``n / distinct``-fold."""
    twins = [tw.SimpleTwin(f"tw{i % distinct}", 1.5 + 0.3 * (i % distinct),
                           0.01, 0.15) for i in range(n)]
    matrix = np.stack(
        [tr.TrafficModel.honda_default("a", G=1.2).hourly_loads()[:t_bins],
         tr.TrafficModel.honda_default("b", G=1.5).hourly_loads()[:t_bins]],
    ).astype(np.float32)
    index = (np.arange(n, dtype=np.int32) % distinct) % 2
    return twins, matrix, index


def _grid(series=False, **kw):
    twins, matrix, index = _small_grid(ptwin, ptraffic,
                                       n=kw.pop("n", 16),
                                       distinct=kw.pop("distinct", 4))
    return simulate_grid(twins, slo=SLO_4H, bin_hours=1.0,
                         return_series=series, load_matrix=matrix,
                         load_index=index, device="cpu", **kw)


# ---------------------------------------------------------------------------
# off by default: no recording, no allocation, no numeric effect
# ---------------------------------------------------------------------------

def test_disabled_by_default_records_nothing():
    rec = obs.get_recorder()
    assert not obs.enabled()
    with obs.span("should.not.record", n=1):
        pass
    obs.count("should.not.count", 5)
    obs.gauge("should.not.gauge", 1.0)
    obs.event("should.not.event")
    _grid()
    assert len(rec.spans) == 0
    assert rec.counters == {} and rec.gauges == {}


def test_disabled_span_is_shared_null():
    s1 = obs.span("a", x=1)
    s2 = obs.span("b")
    assert s1 is _NULL and s2 is _NULL
    with obs.span("c") as sp:
        sp.attrs["compiled"] = 1.0     # the block-engine write pattern


@pytest.mark.parametrize("series", [False, True])
def test_enabling_does_not_change_grid_numbers(series):
    base = _grid(series, scenario_block=None if series else 2)
    with obs.capture() as rec:
        instrumented = _grid(series, scenario_block=None if series else 2)
    assert rec.find(name="grid.simulate")
    assert_same_results(instrumented, base)


# ---------------------------------------------------------------------------
# spans: nesting, attrs, decorator, timed, capture
# ---------------------------------------------------------------------------

def test_span_nesting_links_parent_ids():
    with obs.capture() as rec:
        with obs.span("outer", layer=0):
            with obs.span("inner", layer=1):
                time.sleep(0.002)
    outer_sp, = rec.find(name="outer")
    inner_sp, = rec.find(name="inner")
    assert outer_sp.parent_id is None
    assert inner_sp.parent_id == outer_sp.span_id
    assert inner_sp.attrs["layer"] == 1
    assert outer_sp.duration >= inner_sp.duration > 0


def test_span_attrs_mutable_until_exit():
    with obs.capture() as rec:
        with obs.span("block", size=8) as sp:
            sp.attrs["compiled"] = 1.0
    sp, = rec.find(name="block")
    assert sp.attrs == {"size": 8, "compiled": 1.0}


def test_instrument_decorator_names_and_gates():
    @obs.instrument(name="custom.op", kind="unit")
    def work(x):
        return x + 1

    assert work.__obs_name__ == "custom.op"
    assert work(1) == 2                      # disabled: plain call
    assert len(obs.get_recorder().spans) == 0
    with obs.capture() as rec:
        assert work(2) == 3
    sp, = rec.find(name="custom.op")
    assert sp.attrs["kind"] == "unit"


def test_timed_always_records_and_exposes_elapsed():
    assert not obs.enabled()
    with obs.timed("bench.thing", n=4) as tm:
        time.sleep(0.002)
    assert tm.elapsed >= 0.002
    sp, = obs.get_recorder().find(name="bench.thing")
    assert sp.attrs["n"] == 4
    assert sp.duration == pytest.approx(tm.elapsed)


def test_capture_restores_state_and_injected_recorder():
    global_rec = obs.get_recorder()
    mine = Recorder()
    with obs.capture(recorder=mine) as rec:
        assert rec is mine
        assert obs.enabled()
        with obs.span("inside"):
            pass
    assert not obs.enabled()
    assert obs.get_recorder() is global_rec
    assert len(mine.find(name="inside")) == 1
    assert len(global_rec.spans) == 0


# ---------------------------------------------------------------------------
# counters, gauges, bounded retention
# ---------------------------------------------------------------------------

def test_labeled_counters_accumulate_and_flatten():
    with obs.capture() as rec:
        obs.count("grid.blocks", 3, backend="plain", devices=1)
        obs.count("grid.blocks", 2, backend="plain", devices=1)
        obs.count("grid.blocks", 5, backend="cuda", devices=1)
        obs.gauge("grid.block_size", 4480)
        flat = obs.counters()
    assert rec.counter_total("grid.blocks") == 10
    assert flat["grid.blocks{backend=plain,devices=1}"] == 5
    assert flat["grid.blocks{backend=cuda,devices=1}"] == 5


def test_ring_capacity_drops_oldest():
    rec = Recorder(capacity=4)
    for i in range(10):
        rec.add_span(f"s{i}", float(i), float(i) + 0.5)
    assert [s.name for s in rec.find()] == ["s6", "s7", "s8", "s9"]


def test_retention_prunes_by_injected_clock():
    t = {"now": 100.0}
    rec = Recorder(retention_s=10.0, clock=lambda: t["now"])
    rec.add_span("old", 80.0, 85.0)
    rec.add_span("fresh", 95.0, 99.0)
    # the next add prunes lazily: cutoff = 100 - 10 = 90 drops "old"
    rec.add_span("new", 99.0, 100.0)
    assert [s.name for s in rec.find()] == ["fresh", "new"]
    t["now"] = 120.0
    assert rec.prune() == 2
    assert rec.find() == []


# ---------------------------------------------------------------------------
# the engines emit: grid spans and counters, faults, serving
# ---------------------------------------------------------------------------

def test_grid_emits_spans_and_dedup_counters():
    with obs.capture() as rec:
        # scenario_block=2 runs the 4 kept (deduped) scenarios in 2 blocks
        rows = _grid(scenario_block=2)
    assert len(rows) == 16
    top, = rec.find(name="grid.simulate")
    assert top.attrs["n"] == 16 and top.attrs["mode"] == "agg"
    blocks = rec.find(name="grid.block")
    assert len(blocks) == 2, "blocked run must emit per-block spans"
    for b, sp in enumerate(blocks):
        assert sp.parent_id == top.span_id
        assert sp.attrs["backend"] == "plain"
        assert sp.attrs["compiled"] == 0.0       # the CPU builds nothing
        assert sp.attrs["size"] == 2 and sp.attrs["block"] == b
        assert sp.attrs["policy"] == ptwin.policy_spec("fifo").index
    assert rec.counter_total("grid.dedup.total") == 16
    assert rec.counter_total("grid.dedup.kept") == 4
    assert rec.counter_total("grid.scenarios") == 16
    assert obs.counters()["grid.blocks{backend=plain,devices=1}"] == 2
    assert rec.gauges[("grid.block_size", ())] == 2


def test_unblocked_grid_is_one_mixed_launch():
    with obs.capture() as rec:
        _grid(n=4, distinct=4)
    top, = rec.find(name="grid.simulate")
    block, = rec.find(name="grid.block")
    assert block.parent_id == top.span_id
    assert block.attrs["size"] == 4 and block.attrs["policy"] == -1
    assert rec.counter_total("grid.dedup.total") == 0     # all distinct
    assert rec.counter_total("grid.blocks") == 0


def test_series_mode_emits_simulate_span():
    with obs.capture() as rec:
        sims = _grid(True, n=4, distinct=4)
    assert len(sims) == 4
    top, = rec.find(name="grid.simulate")
    assert top.attrs["mode"] == "series"
    assert top.attrs["faulted"] is False
    assert rec.find(name="grid.block") == []


def test_faults_expand_grid_counts():
    sched = faults.FaultSchedule(
        specs=(faults.outage(rate_per_year=6, duration_hours=(1, 4)),),
        n_futures=2, seed=0)
    twins, matrix, index = _small_grid(ptwin, ptraffic, n=4, distinct=4)
    sampled = faults.sample_futures(sched, matrix.shape[1])
    with obs.capture() as rec:
        grid = faults.expand_grid(sampled, matrix, index)
    assert grid.load_index.shape[0] == 8
    assert rec.counter_total("faults.futures") == 2
    assert rec.counter_total("faults.rows") == 8
    assert rec.counter_total("faults.load_rows_added") == 0
    assert rec.find(name="faults.expand_grid")


def test_faulted_grid_counts_match_reference(jref):
    """A chaos grid through the port and the reference: the same
    ``faults.*`` counts, ``grid.*`` counts and ``grid.simulate`` attrs."""
    def run(o, sim, flt, tw, tr, slo, **kw):
        sched = flt.FaultSchedule(
            specs=(flt.outage(rate_per_year=6, duration_hours=(1, 4)),
                   flt.burst(rate_per_year=300)), n_futures=3, seed=2)
        twins, matrix, index = _small_grid(tw, tr, n=4, distinct=2)
        with o.capture() as rec:
            sim.simulate_grid(twins, slo=slo.SLO(**SLO_KW),
                              bin_hours=1.0, return_series=False,
                              load_matrix=matrix, load_index=index,
                              faults=sched, **kw)
        top, = rec.find(name="grid.simulate")
        names = ("faults.futures", "faults.rows", "faults.load_rows_added",
                 "grid.scenarios", "grid.dedup.total", "grid.dedup.kept")
        return ({k: rec.counter_total(k) for k in names},
                {k: top.attrs[k] for k in ("n", "t_bins", "mode",
                                           "faulted")},
                len(rec.find(name="faults.expand_grid")))
    got = run(obs, psim, faults, ptwin, ptraffic, pslo, device="cpu")
    want = run(jref.obs, jref.simulate, jref.faults, jref.twin,
               jref.traffic, jref.slo)
    assert got == want
    assert got[0]["faults.load_rows_added"] > 0


def test_grid_counts_match_reference(jref):
    """One blocked, deduplicated grid through both: the same counters,
    the same ``grid.simulate`` attrs and block count, rows equal to the
    reference's and bitwise the same as the port's run with obs off."""
    kw = dict(bin_hours=1.0, return_series=False, scenario_block=2)
    twins, matrix, index = _small_grid(jref.twin, jref.traffic)
    with jref.obs.capture() as jrec:
        want = jref.simulate.simulate_grid(
            twins, slo=jref.slo.SLO(**SLO_KW), load_matrix=matrix,
            load_index=index, **kw)
    off = _grid(scenario_block=2)
    with obs.capture() as rec:
        got = _grid(scenario_block=2)
    assert_same_results(got, off)
    assert_same_results(got, want)
    for name in ("grid.scenarios", "grid.dedup.total", "grid.dedup.kept",
                 "grid.blocks"):
        assert rec.counter_total(name) == jrec.counter_total(name), name
    assert rec.gauges[("grid.block_size", ())] == \
        jrec.gauges[("grid.block_size", ())]
    top, = rec.find(name="grid.simulate")
    jtop, = jrec.find(name="grid.simulate")
    assert top.attrs == jtop.attrs
    assert len(rec.find(name="grid.block")) == \
        len(jrec.find(name="grid.block"))


def test_serve_loop_emits_span_and_counters():
    """``ServeEngine.serve`` (smoke rwkv6 on the CPU): one ``serve.loop``
    span, ``serve.requests`` / ``serve.groups``, and the engine's stage
    spans mirrored as ``stage.*``."""
    cfg = get_smoke_config("rwkv6-7b")
    eng = ServeEngine(cfg, M.init_params(cfg, seed=0, device="cpu"),
                      slots=2, max_len=16, device="cpu")
    reqs = [Request(rid=i, prompt=[3 + i, 17, 5], max_new=2)
            for i in range(3)]
    with obs.capture() as rec:
        done = eng.serve(reqs)
    assert len(done) == 3
    loop, = rec.find(name="serve.loop")
    assert loop.attrs == {"requests": 3, "slots": 2}
    assert rec.counter_total("serve.requests") == 3
    assert rec.counter_total("serve.groups") == 2
    for name in ("stage.queue_wait", "stage.prefill"):
        spans = rec.find(name=name)
        assert len(spans) == 2, name
        assert all(sp.parent_id == loop.span_id for sp in spans)
    assert sum(sp.attrs["records"] for sp in rec.find(
        name="stage.prefill")) == 3
    assert len(rec.find(name="stage.decode")) == 2


def paper_twins(tw):
    return [tw.SimpleTwin("blocking-write", 1.9512, 0.0082, 0.15),
            tw.SimpleTwin("no-blocking-write", 6.15, 0.0703, 0.06),
            tw.SimpleTwin("cpu-limited", 0.6612, 0.0027, 0.29)]


def test_prometheus_text_matches_reference(jref):
    """The Table II rows as a scrape page: the port's text is the
    reference's, with the grid's counters riding along."""
    def page(o, whatif, tw, tr, slo, **kw):
        traffics = [tr.TrafficModel.honda_default("nominal", R=3.5, G=1.0),
                    tr.TrafficModel.honda_default("high", R=3.5, G=1.5)]
        with o.capture(recorder=o.Recorder()) as rec:
            rows = whatif.run_grid(paper_twins(tw), traffics,
                                   slo=slo.SLO(**SLO_KW), **kw)
        rec.spans.clear()      # span seconds are timings, not results
        return rows, o.prometheus_exposition(rows, recorder=rec)
    rows, text = page(obs, pwhatif, ptwin, ptraffic, pslo, device="cpu")
    jrows, jtext = page(jref.obs, jref.whatif, jref.twin, jref.traffic,
                        jref.slo)
    assert_same_results(rows, jrows)
    assert text == jtext
    assert 'event="grid.scenarios"' in text
    assert len([ln for ln in text.splitlines()
                if ln.startswith("plantd_latency_seconds{")]) == 18


def test_prometheus_exposition_shape():
    with obs.capture() as rec:
        rows = _grid(n=4, distinct=4)
        text = prometheus_exposition(rows, recorder=rec)
    lines = text.strip().split("\n")
    families = [ln.split()[2] for ln in lines if ln.startswith("# TYPE")]
    for fam in ("plantd_latency_seconds", "plantd_latency_mean_seconds",
                "plantd_message_count",
                "plantd_target_compliance_percent", "plantd_cost_usd",
                "plantd_throughput_rph", "plantd_obs_events_total",
                "plantd_obs_span_count"):
        assert fam in families, fam
    samples = [ln for ln in lines if not ln.startswith("#")]
    assert len(samples) > 20
    for ln in samples:
        metric, val = ln.rsplit(" ", 1)
        float(val)
        assert metric[0].isalpha()
    q_lines = [ln for ln in samples
               if ln.startswith("plantd_latency_seconds{")]
    assert len(q_lines) == 3 * len(rows)
    assert 'quantile="0.95"' in text
    assert 'event="grid.scenarios"' in text


def test_jsonl_append_prunes_by_retention(tmp_path):
    path = str(tmp_path / "collect.jsonl")
    rec = Recorder()
    t0 = rec.mono0
    rec.add_span("tick.a", t0 + 0.0, t0 + 1.0)
    rec.count("events", 2)
    n = append_jsonl(path, rec, retention_s=3600.0, now=rec.wall0 + 10.0)
    assert n == 2                            # one span + one snapshot
    assert len(rec.spans) == 0               # clear=True drained the ring
    rec.add_span("tick.b", t0 + 3599.0, t0 + 3600.0)
    rec.count("events", 3)
    append_jsonl(path, rec, retention_s=1800.0, now=rec.wall0 + 3601.0)
    data = read_jsonl(path)
    assert [d["name"] for d in data["spans"]] == ["tick.b"]
    assert data["counters"][-1]["values"]["events"] == 5.0
    with open(path) as f:
        for ln in f:
            assert json.loads(ln)["type"] in ("span", "counters")


def test_experiment_mirrors_stage_spans():
    """An instrumented experiment's stage spans export as OTel-style dicts
    on the unix epoch, with their record counts."""
    def work(batch):
        time.sleep(0.004)
        return batch

    pipe = Pipeline("rt", [PipelineStage("only_stage", work)],
                    resources=Resources(vcpus=1, ram_gb=1))
    schema = pschema.Schema("one", (pschema.FieldSpec("x", "float"),))
    ds = pdatagen.DataGenerator(0).generate(schema, 100)
    load = plp.LoadPattern.steady("rt-load", duration_s=1.2, rate=60)
    with obs.capture() as rec:
        res = pexperiment.Experiment("rt", pipe, load, ds,
                                     drain_timeout_s=30, time_scale=2.0).run()
    assert res.drained
    spans = to_otel_spans(rec, prefix="stage.")
    assert len(spans) == len(res.collector.spans("only_stage"))
    for d in spans:
        assert d["name"] == "stage.only_stage" and d["status"] == "OK"
        assert d["records"] >= 1 and d["end"] >= d["start"] > 1e9
    assert sum(d["records"] for d in spans) == res.records_done


# ---------------------------------------------------------------------------
# the golden round trip: instrumented experiment -> OTel export ->
# from_otel_spans -> refit, and the fit's own span and counters
# ---------------------------------------------------------------------------

def test_otel_export_roundtrip_refits_twin():
    from repro_torch.calibrate import ObservedTrace, fit

    def work(batch):
        time.sleep(0.004)
        return batch

    pipe = Pipeline("rt", [PipelineStage("only_stage", work)],
                    resources=Resources(vcpus=1, ram_gb=1))
    schema = pschema.Schema("one", (pschema.FieldSpec("x", "float"),))
    ds = pdatagen.DataGenerator(0).generate(schema, 100)
    load = plp.LoadPattern.steady("rt-load", duration_s=1.2, rate=60)
    with obs.capture() as rec:
        res = pexperiment.Experiment("rt", pipe, load, ds,
                                     drain_timeout_s=30).run()
    assert res.drained
    spans = to_otel_spans(rec, prefix="stage.")
    assert spans, "instrumented experiment produced no stage spans"
    trace = ObservedTrace.from_otel_spans(spans, bin_seconds=0.25,
                                          name="obs-roundtrip")
    assert trace.num_bins >= 2
    assert float(np.sum(trace.arrivals)) == pytest.approx(
        sum(d["records"] for d in spans))
    with obs.capture() as rec:
        result = fit(trace, "fifo", restarts=2, steps=30, seed=0,
                     device="cpu")
    assert np.isfinite(result.loss)
    assert result.twin.max_rps > 0
    (span,) = rec.find(name="calibrate.fit")
    assert span.attrs == {"policy": "fifo", "restarts": 2, "steps": 30,
                          "t_bins": trace.num_bins, "devices": 1}
    assert obs.counters() == {"calibrate.fits{policy=fifo}": 1.0,
                              "calibrate.restarts": 2.0}


def test_fit_counters_match_reference(jref):
    """One fit records the span and counters the reference's records, by
    name, labels and attrs."""
    from repro_torch.calibrate import ObservedTrace, fit
    trace = ObservedTrace.from_otel_spans(
        [{"start": float(i), "end": i + 0.5} for i in range(40)],
        bin_seconds=5.0, name="c")
    jtrace = jref.calibrate.ObservedTrace.from_otel_spans(
        [{"start": float(i), "end": i + 0.5} for i in range(40)],
        bin_seconds=5.0, name="c")
    with obs.capture() as rec:
        fit(trace, "shed", restarts=3, steps=4, seed=0, device="cpu")
        got = obs.counters()
    with jref.obs.capture() as jrec:
        jref.calibrate.fit(jtrace, "shed", restarts=3, steps=4, seed=0)
        want = jref.obs.counters()
    assert got == want
    (span,) = rec.find(name="calibrate.fit")
    (jspan,) = jrec.find(name="calibrate.fit")
    assert span.attrs == jspan.attrs


# ---------------------------------------------------------------------------
# the report and the dispatch profile
# ---------------------------------------------------------------------------

def test_report_renders_spans_counters_and_profiles():
    with obs.capture() as rec:
        with obs.span("demo.outer", records=8):
            time.sleep(0.002)
        obs.count("demo.events", 3, kind="x")
        obs.gauge("demo.level", 7.0)
        stats = summarize(rec)
        text = render(rec)
    assert stats["demo.outer"]["count"] == 1
    assert stats["demo.outer"]["records"] == 8.0
    assert "demo.outer" in text
    assert "demo.events{kind=x}" in text
    assert "demo.level" in text


def test_report_from_jsonl_file(tmp_path):
    path = str(tmp_path / "obs.jsonl")
    rec = Recorder()
    rec.add_span("tick", rec.mono0, rec.mono0 + 0.5, {"records": 4})
    rec.count("ticks", 2)
    append_jsonl(path, rec)
    text = _report_file(path)
    assert "tick" in text and "ticks" in text


def test_report_demo_runs_on_the_cpu():
    text = _demo("cpu")
    for name in ("grid.simulate", "grid.block", "faults.expand_grid",
                 "grid.dedup.kept", "faults.futures"):
        assert name in text, name


def test_profile_dispatch_splits_first_call_and_steady_state():
    x = torch.ones((64, 64), dtype=torch.float32)
    out, prof = obs.profile_dispatch("unit.matmul", lambda a: (a @ a.T).sum(),
                                     x, reps=2, size=64)
    assert float(out) == 64.0 ** 3
    assert prof.compile_s > 0 and prof.execute_s > 0 and prof.reps == 2
    assert prof.peak_temp_bytes is None              # no card, no peak
    row = prof.row()
    assert row["name"] == "unit.matmul" and row["size"] == 64.0
    rec = obs.get_recorder()
    sp, = rec.find(name="dispatch.unit.matmul")
    assert sp.attrs["compile_s"] == prof.compile_s
    assert "peak_temp_bytes" not in sp.attrs
    assert rec.profiles[-1] is prof
    assert "unit.matmul" in render(rec)


def test_library_count_does_not_grow_without_a_build():
    """``jit_cache_size`` reads the count of kernel libraries built or
    loaded in the process; the CPU path builds none, so a grid leaves it
    where it was and no block is tagged ``compiled``."""
    before = obs.jit_cache_size()
    assert before == build.library_count()
    with obs.capture() as rec:
        _grid(scenario_block=2)
    assert not obs.jit_cache_grew(None, before)
    assert obs.jit_cache_size() == before
    assert all(sp.attrs["compiled"] == 0.0
               for sp in rec.find(name="grid.block"))
