"""Span instrumentation (OpenTelemetry analogue) + collector.

Copy of ``repro.core.spans`` for the port. Pipeline stages are wrapped in
``with span("stage", collector, records=n):`` blocks. The collector
converts finished spans into time-series metrics (throughput, latency per
stage) — the paper's OTel-collector -> Prometheus path, in-process.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from repro_torch import obs


@dataclass
class Span:
    name: str
    start: float
    duration: float
    records: int = 1
    attrs: Dict[str, float] = field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.start + self.duration


class SpanCollector:
    """Accumulates spans; converts them to per-stage metrics on demand."""

    def __init__(self, clock=time.perf_counter):
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self.clock = clock

    def add(self, s: Span):
        with self._lock:
            self._spans.append(s)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def stage_names(self) -> List[str]:
        seen: Dict[str, None] = {}
        for s in self.spans():
            seen.setdefault(s.name, None)
        return list(seen)

    def clear(self):
        with self._lock:
            self._spans.clear()

    # -- metric conversions (the "collector module") ------------------------

    def stage_latency(self, name: str) -> List[float]:
        """Per-record latency estimates of one stage (duration/records)."""
        return [s.duration / max(s.records, 1) for s in self.spans(name)]

    def stage_throughput(self, name: str, bucket_s: float = 1.0) -> List[tuple]:
        """(bucket_time, records/s) series for one stage."""
        spans = self.spans(name)
        if not spans:
            return []
        t0 = min(s.start for s in spans)
        t1 = max(s.end for s in spans)
        n_buckets = max(1, int((t1 - t0) / bucket_s) + 1)
        counts = [0.0] * n_buckets
        for s in spans:
            b = int((s.end - t0) / bucket_s)
            counts[min(b, n_buckets - 1)] += s.records
        return [(t0 + (i + 0.5) * bucket_s, c / bucket_s)
                for i, c in enumerate(counts)]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name in self.stage_names():
            lats = self.stage_latency(name)
            spans = self.spans(name)
            recs = sum(s.records for s in spans)
            wall = (max(s.end for s in spans) - min(s.start for s in spans)
                    ) if spans else 0.0
            out[name] = {
                "records": recs,
                "mean_latency_s": sum(lats) / max(len(lats), 1),
                "p50_latency_s": sorted(lats)[len(lats) // 2] if lats else 0.0,
                "throughput_rps": recs / wall if wall > 0 else 0.0,
                "busy_s": sum(s.duration for s in spans),
            }
        return out


@contextlib.contextmanager
def span(name: str, collector: Optional[SpanCollector],
         records: int = 1, **attrs) -> Iterator[None]:
    """Wrap one stage invocation. Spans land in the pipeline's own
    ``collector`` as always; when run-telemetry is on they ALSO mirror
    into ``repro_torch.obs`` as ``stage.{name}`` spans with a ``records``
    attr, so ``obs.to_otel_spans(prefix="stage.")`` exports an
    instrumented experiment."""
    if collector is None:
        with obs.span(f"stage.{name}", records=records, **attrs):
            yield
        return
    t0 = collector.clock()
    try:
        with obs.span(f"stage.{name}", records=records, **attrs):
            yield
    finally:
        collector.add(Span(name, t0, collector.clock() - t0, records,
                           {k: float(v) for k, v in attrs.items()}))
