"""Service-level objectives (paper Sec. V-G): a measurement type, a limit,
and the required fraction of compliance. Example from the paper: processing
latency may not exceed 4 hours more than 5% of the time.

Beyond-paper: ``metric="drop_rate"`` targets the hourly shed fraction of
bounded-queue twin policies (core/twin.py ``shed``) instead of latency —
``limit_s`` is then a dimensionless fraction (``SLO.for_drop_rate``).

Copy of ``repro.core.slo`` for the port (pure numpy)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SLO:
    metric: str = "latency"        # latency | drop_rate | error_rate
    limit_s: float = 4 * 3600.0    # seconds (latency) or fraction (rates)
    met_fraction: float = 0.95     # required proportion within the limit

    @property
    def limit(self) -> float:
        """Metric-agnostic alias for ``limit_s``."""
        return self.limit_s

    @classmethod
    def for_drop_rate(cls, max_fraction: float = 0.0,
                      met_fraction: float = 0.95) -> "SLO":
        """E.g. "no more than 1% of records shed in 95% of hours"."""
        return cls(metric="drop_rate", limit_s=max_fraction,
                   met_fraction=met_fraction)

    def evaluate(self, values: np.ndarray, weights: np.ndarray | None = None):
        """Returns (pct_met, met_bool); weights for record-weighted checks."""
        values = np.asarray(values, float)
        ok = values <= self.limit_s
        if weights is None:
            pct = float(ok.mean() * 100.0)
        else:
            w = np.asarray(weights, float)
            pct = float((ok * w).sum() / max(w.sum(), 1e-12) * 100.0)
        return pct, bool(pct >= self.met_fraction * 100.0)
