"""Exporters: OTel-style span dicts, Prometheus text exposition, JSONL.

Copy of ``repro.obs.export`` for the port; the text it writes is the
reference's, byte for byte. Three ways telemetry leaves the process:

* ``to_otel_spans`` — plain span dicts with unix-seconds ``start`` /
  ``end``, ``records`` and ``status`` keys: the shape the calibration
  slice's ``ObservedTrace.from_otel_spans`` consumes (calibration is
  not in the port yet).
* ``prometheus_exposition`` — the text exposition format, serving the
  Realtime-Datastreaming monitor's metric family (p50/p95/p99, mean,
  max, message count, target compliance) from ``GridSummary`` rows,
  plus the recorder's own counters/gauges/span stats. Any scrape
  endpoint can serve it verbatim.
* ``append_jsonl`` / ``read_jsonl`` — the collect-continuously shape:
  every append writes the new spans (+ a counter snapshot) as JSON
  lines and prunes lines older than the retention window, so the file
  is a rolling window, not a log that grows forever.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.record import Recorder, get_recorder

__all__ = ["append_jsonl", "prometheus_exposition", "read_jsonl",
           "to_otel_spans"]


def to_otel_spans(recorder: Optional[Recorder] = None, *,
                  name: Optional[str] = None,
                  prefix: Optional[str] = None) -> List[Dict]:
    """Export recorded spans as OTel-style dicts.

    Keys per span: ``name``, ``start`` / ``end`` (unix seconds — the
    recorder's wall/monotonic anchor places the monotonic timestamps on
    the epoch), ``records`` (from the span attr, default 1), ``status``
    ``"OK"``, and the remaining attrs under ``attributes``. Filter with
    ``name=`` (exact) or ``prefix=``.
    """
    rec = recorder or get_recorder()
    out = []
    for sp in rec.find(name=name, prefix=prefix):
        attrs = dict(sp.attrs)
        records = attrs.pop("records", 1.0)
        out.append({
            "name": sp.name,
            "start": rec.wall_time(sp.start),
            "end": rec.wall_time(sp.end),
            "records": float(records),
            "status": "OK",
            "attributes": attrs,
        })
    return out


def _esc(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _line(name: str, labels: Dict, value) -> str:
    lab = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
    v = float(value)
    sval = ("+Inf" if np.isposinf(v) else "-Inf" if np.isneginf(v)
            else repr(v))
    return f"{name}{{{lab}}} {sval}" if lab else f"{name} {sval}"


def prometheus_exposition(rows: Optional[Sequence] = None, *,
                          recorder: Optional[Recorder] = None,
                          namespace: str = "plantd") -> str:
    """Render Prometheus text exposition from grid rows + the recorder.

    ``rows`` are ``GridSummary`` (or ``SimulationResult``) rows — duck-
    typed: anything with ``name``, ``median_latency_s``/``p95``/``p99``,
    ``mean_latency_s``, ``pct_latency_met``, throughput and cost fields.
    Emitted families (the Snippet-2 monitor's vocabulary):

    * ``{ns}_latency_seconds{scenario,quantile=0.5|0.95|0.99}`` — the
      histogram-CDF quantiles;
    * ``{ns}_latency_mean_seconds`` / ``{ns}_latency_max_seconds``;
    * ``{ns}_message_count`` — records processed;
    * ``{ns}_target_compliance_percent`` — pct of records meeting the
      SLO (load-weighted), the monitor's "target compliance";
    * ``{ns}_cost_usd`` / ``{ns}_throughput_rph``.

    The recorder's own telemetry rides along: every counter as
    ``{ns}_obs_{name}_total``, gauges as ``{ns}_obs_{name}``, and
    per-span-name count/total-seconds summaries.
    """
    rec = recorder or get_recorder()
    lines: List[str] = []

    def family(name, ftype, help_text):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {ftype}")

    if rows:
        ns = namespace
        family(f"{ns}_latency_seconds", "gauge",
               "Record-weighted latency quantiles per scenario")
        for r in rows:
            for q, v in (("0.5", r.median_latency_s),
                         ("0.95", getattr(r, "p95_latency_s", 0.0)),
                         ("0.99", getattr(r, "p99_latency_s", 0.0))):
                lines.append(_line(f"{ns}_latency_seconds",
                                   {"scenario": r.name, "quantile": q},
                                   v))
        family(f"{ns}_latency_mean_seconds", "gauge",
               "Record-weighted mean latency per scenario")
        for r in rows:
            lines.append(_line(f"{ns}_latency_mean_seconds",
                               {"scenario": r.name}, r.mean_latency_s))
        family(f"{ns}_message_count", "gauge",
               "Records processed over the horizon")
        for r in rows:
            processed = getattr(r, "processed_records", None)
            if processed is None:       # series rows: integrate
                processed = float(np.sum(r.processed))
            lines.append(_line(f"{ns}_message_count",
                               {"scenario": r.name}, processed))
        family(f"{ns}_target_compliance_percent", "gauge",
               "Percent of records meeting the SLO target")
        for r in rows:
            lines.append(_line(f"{ns}_target_compliance_percent",
                               {"scenario": r.name}, r.pct_latency_met))
        family(f"{ns}_cost_usd", "gauge",
               "Total cost of the scenario (incl. backlog)")
        for r in rows:
            lines.append(_line(f"{ns}_cost_usd", {"scenario": r.name},
                               r.grand_total_usd))
        family(f"{ns}_throughput_rph", "gauge",
               "Mean records per hour processed")
        for r in rows:
            lines.append(_line(f"{ns}_throughput_rph",
                               {"scenario": r.name},
                               r.mean_throughput_rph))

    with rec._lock:
        counters = list(rec.counters.items())
        gauges = list(rec.gauges.items())
    if counters:
        family(f"{namespace}_obs_events_total", "counter",
               "repro.obs counters (runtime decisions + warn events)")
        for (nm, labels), v in sorted(counters):
            lab = dict(labels)
            lab["event"] = nm
            lines.append(_line(f"{namespace}_obs_events_total", lab, v))
    if gauges:
        family(f"{namespace}_obs_gauge", "gauge",
               "repro.obs gauges (latest value)")
        for (nm, labels), v in sorted(gauges):
            lab = dict(labels)
            lab["name"] = nm
            lines.append(_line(f"{namespace}_obs_gauge", lab, v))

    by_name: Dict[str, List[float]] = {}
    for sp in rec.find():
        by_name.setdefault(sp.name, []).append(sp.duration)
    if by_name:
        family(f"{namespace}_obs_span_count", "gauge",
               "Recorded spans per name (current retention window)")
        for nm in sorted(by_name):
            lines.append(_line(f"{namespace}_obs_span_count",
                               {"name": nm}, len(by_name[nm])))
        family(f"{namespace}_obs_span_seconds_total", "gauge",
               "Total recorded span seconds per name")
        for nm in sorted(by_name):
            lines.append(_line(f"{namespace}_obs_span_seconds_total",
                               {"name": nm}, sum(by_name[nm])))
    return "\n".join(lines) + "\n"


def append_jsonl(path: str, recorder: Optional[Recorder] = None, *,
                 retention_s: Optional[float] = None,
                 now: Optional[float] = None,
                 clear: bool = True) -> int:
    """Append the recorder's spans (+ one counter snapshot) to a JSONL
    file, then prune lines older than ``retention_s`` — the continuous
    collect loop's storage step. Returns the number of lines now in the
    file. ``clear=True`` empties the recorder's span ring after writing
    (each collect tick appends only what it saw); counters are
    cumulative and re-snapshotted each tick. ``now`` (unix seconds)
    overrides the wall clock for the retention cut, which is how tests
    pin the pruning.
    """
    rec = recorder or get_recorder()
    t_now = time.time() if now is None else float(now)
    new_lines = []
    for d in to_otel_spans(rec):
        d["type"] = "span"
        new_lines.append(json.dumps(d, sort_keys=True))
    with rec._lock:
        snap = dict(rec.counters)
    if snap:
        flat = {}
        for (nm, labels), v in snap.items():
            key = nm if not labels else nm + "{" + ",".join(
                f"{k}={val}" for k, val in labels) + "}"
            flat[key] = v
        new_lines.append(json.dumps(
            {"type": "counters", "t": t_now, "values": flat},
            sort_keys=True))

    old_lines: List[str] = []
    if os.path.exists(path):
        with open(path) as f:
            old_lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    lines = old_lines + new_lines
    if retention_s is not None:
        cutoff = t_now - float(retention_s)

        def ts(ln: str) -> float:
            try:
                d = json.loads(ln)
                return float(d.get("end", d.get("t", t_now)))
            except (ValueError, TypeError):
                return t_now
        lines = [ln for ln in lines if ts(ln) >= cutoff]
    with open(path, "w") as f:
        for ln in lines:
            f.write(ln + "\n")
    if clear:
        with rec._lock:
            rec.spans.clear()
    return len(lines)


def read_jsonl(path: str) -> Dict[str, list]:
    """Read a collect file back: ``{"spans": [...], "counters": [...]}``
    — span dicts in the ``from_otel_spans`` shape, counter snapshots in
    append order (latest last)."""
    spans, counters = [], []
    with open(path) as f:
        for ln in f:
            if not ln.strip():
                continue
            d = json.loads(ln)
            if d.get("type") == "counters":
                counters.append(d)
            else:
                spans.append(d)
    return {"spans": spans, "counters": counters}
