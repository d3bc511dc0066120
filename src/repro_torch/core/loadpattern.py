"""LoadPattern (the paper's K6 load generator config): piecewise-linear
records/second over named segments. ``rate_at(t)`` linearly interpolates
within a segment; ``records_between(t0, t1)`` integrates the trapezoid so
callers can drive discrete steps at exact record counts.

Copy of ``repro.core.loadpattern`` for the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

# numpy < 2.0 ships the integrator as np.trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


@dataclass(frozen=True)
class Segment:
    duration_s: float
    start_rate: float        # records/s at segment start
    end_rate: float          # records/s at segment end


@dataclass(frozen=True)
class LoadPattern:
    name: str
    segments: Tuple[Segment, ...]

    @property
    def total_duration(self) -> float:
        return sum(s.duration_s for s in self.segments)

    @property
    def total_records(self) -> float:
        return sum(0.5 * (s.start_rate + s.end_rate) * s.duration_s
                   for s in self.segments)

    def rate_at(self, t: float) -> float:
        off = 0.0
        for s in self.segments:
            if t <= off + s.duration_s:
                frac = (t - off) / max(s.duration_s, 1e-9)
                return s.start_rate + frac * (s.end_rate - s.start_rate)
            off += s.duration_s
        return 0.0

    def records_between(self, t0: float, t1: float, n: int = 32) -> float:
        """Trapezoidal integral of rate over [t0, t1]."""
        ts = np.linspace(t0, t1, n)
        rs = np.array([self.rate_at(float(t)) for t in ts])
        return float(_trapezoid(rs, ts))

    @staticmethod
    def ramp(name: str, duration_s: float, peak_rate: float) -> "LoadPattern":
        """The paper's canonical pattern: ramp 0 -> above-capacity peak to
        find nominal throughput and overload behaviour."""
        return LoadPattern(name, (Segment(duration_s, 0.0, peak_rate),))

    @staticmethod
    def steady(name: str, duration_s: float, rate: float) -> "LoadPattern":
        return LoadPattern(name, (Segment(duration_s, rate, rate),))
