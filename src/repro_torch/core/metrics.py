"""In-process time-series store (Prometheus analogue).

Counters, gauges and histograms with timestamped samples; rate/mean/quantile
queries over time windows. JSONL export for post-hoc analysis (the paper's
"review later / compare experiments" workflow).

Copy of ``repro.core.metrics`` for the port.
"""
from __future__ import annotations

import bisect
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class Sample:
    t: float
    value: float


class MetricStore:
    def __init__(self, clock=time.perf_counter):
        self._series: Dict[str, List[Sample]] = defaultdict(list)
        self._lock = threading.Lock()
        self.clock = clock

    # -- writers ------------------------------------------------------------
    def observe(self, name: str, value: float, t: Optional[float] = None):
        with self._lock:
            self._series[name].append(Sample(self.clock() if t is None else t,
                                             float(value)))

    def inc(self, name: str, delta: float = 1.0, t: Optional[float] = None):
        with self._lock:
            prev = self._series[name][-1].value if self._series[name] else 0.0
            self._series[name].append(
                Sample(self.clock() if t is None else t, prev + delta))

    # -- readers ------------------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str) -> List[Sample]:
        with self._lock:
            return list(self._series.get(name, []))

    def values(self, name: str) -> List[float]:
        return [s.value for s in self.series(name)]

    def window(self, name: str, t0: float, t1: float) -> List[Sample]:
        ss = self.series(name)
        ts = [s.t for s in ss]
        i0 = bisect.bisect_left(ts, t0)
        i1 = bisect.bisect_right(ts, t1)
        return ss[i0:i1]

    def mean(self, name: str) -> float:
        v = self.values(name)
        return sum(v) / len(v) if v else 0.0

    def quantile(self, name: str, q: float) -> float:
        v = sorted(self.values(name))
        if not v:
            return 0.0
        return v[min(int(q * len(v)), len(v) - 1)]

    def rate(self, name: str, window_s: float = 10.0) -> float:
        """Per-second increase of a counter over the trailing window."""
        ss = self.series(name)
        if len(ss) < 2:
            return 0.0
        t1 = ss[-1].t
        w = self.window(name, t1 - window_s, t1)
        if len(w) < 2:
            return 0.0
        dt = w[-1].t - w[0].t
        return (w[-1].value - w[0].value) / dt if dt > 0 else 0.0

    # -- export -------------------------------------------------------------
    def dump_jsonl(self, path: str):
        with open(path, "w") as f:
            for name in self.names():
                for s in self.series(name):
                    f.write(json.dumps({"name": name, "t": s.t, "v": s.value}) + "\n")

    @staticmethod
    def load_jsonl(path: str) -> "MetricStore":
        ms = MetricStore()
        with open(path) as f:
            for line in f:
                d = json.loads(line)
                ms.observe(d["name"], d["v"], t=d["t"])
        return ms
