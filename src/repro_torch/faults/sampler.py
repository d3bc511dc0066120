"""Seeded deterministic sampler: FaultSchedule -> concrete fault futures.

Counterpart: ``repro.faults.sampler``, copied unchanged (numpy only): the
same schedule gives bitwise the same futures in both packages.

``sample_futures`` expands a ``FaultSchedule`` into F concrete futures
over a T-bin horizon. Each future is three per-bin series plus a sparse
replay structure:

* ``cap``  [F, T] f32 — capacity multiplier (0 during outages, in (0,1)
  during brownouts, 1 benign); overlapping events compose
  multiplicatively;
* ``mask`` [F, T] f32 — 1.0 where ANY fault event (of any kind) covers
  the bin; feeds the in-carry fault-attribution counters;
* ``load_mult`` [F, T] f64 — multiplicative load perturbation (bursts,
  and the removed fraction during disconnect windows);
* rank-1 replay terms per future: a disconnect event that removes
  weight vector ``w`` from a base load row replays the removed mass
  ``row . w`` as a uniform reconnect flood over the bins right after
  the window (``flood_hours`` wide) — mass-conserving by construction.

Seeding follows the ``core/datagen.py`` idiom: a fresh
``np.random.default_rng`` keyed by ``crc32(f"{spec.name}:{seed}:{f}")``
per (spec, future), so results are independent of spec iteration
details, process hash randomization (PYTHONHASHSEED), platform, and the
number of other specs in the schedule. Event counts are Poisson with
mean ``rate_per_year * horizon_hours / 8736`` (the repo's 52-week
year, ``core/traffic.HOURS_PER_YEAR``).

Sampled series are validated here: a capacity or load multiplier that
is negative or non-finite raises ``ValueError`` naming the fault spec
and bin index (satellite requirement) rather than flowing garbage into
the aggregates.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .spec import FaultSchedule, FaultSpec

HOURS_PER_YEAR = 8736.0  # mirrors core/traffic.HOURS_PER_YEAR


def _spec_rng(spec_name: str, seed: int, future: int) -> np.random.Generator:
    """PYTHONHASHSEED-stable rng for one (spec, future) pair."""
    key = zlib.crc32(f"fault:{spec_name}:{seed}:{future}".encode())
    return np.random.default_rng(key % (2 ** 31))


@dataclass(frozen=True)
class ReplayTerm:
    """One rank-1 reconnect-flood term: row' += (row . removed) * profile.

    ``removed`` [T] is the per-bin weight stripped from the base row
    during the disconnect window; ``profile`` [T] spreads exactly that
    mass (it sums to 1 over the flood bins), so total records are
    conserved bin-for-bin in expectation and exactly in sum.
    """
    removed: np.ndarray    # [T] f64, nonzero only inside the window
    profile: np.ndarray    # [T] f64, nonzero only on flood bins, sums to 1


@dataclass(frozen=True)
class SampledFaults:
    """F concrete fault futures over a T-bin horizon (see module doc)."""
    cap: np.ndarray                       # [F, T] f32 capacity multiplier
    mask: np.ndarray                      # [F, T] f32 in-fault indicator
    load_mult: np.ndarray                 # [F, T] f64 load multiplier
    replay: Tuple[Tuple[ReplayTerm, ...], ...]   # per-future replay terms
    events: Tuple[Tuple[Dict, ...], ...]  # per-future event records
    n_futures: int
    t_bins: int
    bin_hours: float
    seed: int

    @property
    def has_load_faults(self) -> np.ndarray:
        """[F] bool — does future f perturb the load series at all?"""
        out = np.zeros(self.n_futures, dtype=bool)
        for f in range(self.n_futures):
            out[f] = (bool(self.replay[f])
                      or bool(np.any(self.load_mult[f] != 1.0)))
        return out

    @property
    def has_capacity_faults(self) -> np.ndarray:
        """[F] bool — does future f perturb the capacity series?"""
        return np.any(self.cap != 1.0, axis=1)

    def apply_loads(self, row: np.ndarray) -> np.ndarray:
        """Perturb one base load row [T] into its F faulted rows [F, T].

        Computed in f64 (rank-1 replay terms on top of the elementwise
        multiplier), cast to the row's dtype at the end. A benign future
        (mult == 1, no replay) reproduces the row bit-for-bit.
        """
        row64 = np.asarray(row, dtype=np.float64)
        out = row64[None, :] * self.load_mult
        for f in range(self.n_futures):
            for term in self.replay[f]:
                mass = float(row64 @ term.removed)
                if mass != 0.0:
                    out[f] = out[f] + mass * term.profile
        return out.astype(np.asarray(row).dtype, copy=False)


def _window_bins(rng: np.random.Generator, spec: FaultSpec, t_bins: int,
                 bin_hours: float) -> Tuple[int, int]:
    """Sample one event window as [start_bin, end_bin) clipped to grid."""
    horizon_h = t_bins * bin_hours
    start_h = rng.uniform(0.0, horizon_h)
    dur_h = rng.uniform(*spec.duration_hours)
    start = min(int(start_h // bin_hours), t_bins - 1)
    end = min(t_bins, start + max(1, int(math.ceil(dur_h / bin_hours))))
    return start, end


def _named_bad_bin(arr: np.ndarray, events: Tuple[Dict, ...], what: str,
                   future: int):
    """Raise ValueError naming the responsible spec + bin, if any bad."""
    bad = ~np.isfinite(arr) | (arr < 0)
    if not bad.any():
        return
    bin_ix = int(np.argmax(bad))
    culprit = "unknown fault"
    for ev in events:
        if ev["start"] <= bin_ix < max(ev["end"], ev.get("flood_end", 0)):
            culprit = f"fault spec {ev['spec']!r} ({ev['kind']})"
            break
    raise ValueError(
        f"sampled {what} is "
        f"{'negative' if np.isfinite(arr[bin_ix]) else 'non-finite'} at "
        f"bin {bin_ix} of future {future}: {culprit} produced "
        f"{arr[bin_ix]!r}")


def validate_sampled(sampled: SampledFaults) -> SampledFaults:
    """Re-check a SampledFaults (possibly hand-built) for bad bins.

    Raises ``ValueError`` naming the responsible fault spec and bin
    index when any capacity or load multiplier is negative or
    non-finite — the simulate-layer input-validation hook
    (``core.simulate.simulate_grid(faults=...)`` calls this before any
    device work). Returns the input unchanged when clean.
    """
    cap = np.asarray(sampled.cap)
    lm = np.asarray(sampled.load_mult)
    if cap.shape != (sampled.n_futures, sampled.t_bins):
        raise ValueError(f"SampledFaults.cap shape {cap.shape} != "
                         f"({sampled.n_futures}, {sampled.t_bins})")
    if lm.shape != (sampled.n_futures, sampled.t_bins):
        raise ValueError(f"SampledFaults.load_mult shape {lm.shape} != "
                         f"({sampled.n_futures}, {sampled.t_bins})")
    for f in range(sampled.n_futures):
        evs = sampled.events[f] if f < len(sampled.events) else ()
        _named_bad_bin(cap[f], evs, "capacity multiplier", f)
        _named_bad_bin(lm[f], evs, "load multiplier", f)
    return sampled


def sample_futures(schedule: FaultSchedule, t_bins: int,
                   bin_hours: float = 1.0) -> SampledFaults:
    """Expand a FaultSchedule into F concrete futures over t_bins bins.

    Deterministic in (schedule.seed, spec names, t_bins, bin_hours) —
    and in nothing else. Specs compose in declaration order; capacity
    multipliers compose multiplicatively, disconnects strip a fraction
    of whatever load multiplier is in force when they fire.
    """
    if t_bins < 1:
        raise ValueError(f"t_bins must be >= 1, got {t_bins}")
    if bin_hours <= 0:
        raise ValueError(f"bin_hours must be > 0, got {bin_hours}")
    F = schedule.n_futures
    horizon_years = (t_bins * bin_hours) / HOURS_PER_YEAR

    cap = np.ones((F, t_bins), dtype=np.float64)
    mask = np.zeros((F, t_bins), dtype=np.float32)
    load_mult = np.ones((F, t_bins), dtype=np.float64)
    replay: List[Tuple[ReplayTerm, ...]] = []
    events: List[Tuple[Dict, ...]] = []

    for f in range(F):
        f_terms: List[ReplayTerm] = []
        f_events: List[Dict] = []
        for spec in schedule.specs:
            rng = _spec_rng(spec.name, schedule.seed, f)
            n_events = int(rng.poisson(spec.rate_per_year * horizon_years))
            for _ in range(n_events):
                start, end = _window_bins(rng, spec, t_bins, bin_hours)
                ev = {"spec": spec.name, "kind": spec.kind,
                      "start": start, "end": end}
                mask[f, start:end] = 1.0
                if spec.kind == "outage":
                    cap[f, start:end] = 0.0
                elif spec.kind == "brownout":
                    m = rng.uniform(*spec.capacity_mult)
                    cap[f, start:end] *= m
                    ev["capacity_mult"] = m
                elif spec.kind == "burst":
                    m = rng.uniform(*spec.load_mult)
                    load_mult[f, start:end] *= m
                    ev["load_mult"] = m
                elif spec.kind == "disconnect":
                    frac = rng.uniform(*spec.disconnect_frac)
                    # strip `frac` of the load in force over the window…
                    removed = np.zeros(t_bins, dtype=np.float64)
                    removed[start:end] = load_mult[f, start:end] * frac
                    load_mult[f, start:end] *= (1.0 - frac)
                    # …and replay it over the flood bins after the window
                    n_flood = max(1, int(math.ceil(spec.flood_hours
                                                   / bin_hours)))
                    fl_start = min(end, t_bins - 1)
                    fl_end = min(t_bins, fl_start + n_flood)
                    profile = np.zeros(t_bins, dtype=np.float64)
                    profile[fl_start:fl_end] = 1.0 / (fl_end - fl_start)
                    mask[f, fl_start:fl_end] = 1.0
                    f_terms.append(ReplayTerm(removed=removed,
                                              profile=profile))
                    ev["disconnect_frac"] = frac
                    ev["flood_end"] = fl_end
                f_events.append(ev)
        replay.append(tuple(f_terms))
        events.append(tuple(f_events))
        _named_bad_bin(cap[f], events[-1], "capacity multiplier", f)
        _named_bad_bin(load_mult[f], events[-1], "load multiplier", f)

    return SampledFaults(cap=cap.astype(np.float32), mask=mask,
                         load_mult=load_mult, replay=tuple(replay),
                         events=tuple(events), n_futures=F, t_bins=t_bins,
                         bin_hours=float(bin_hours), seed=schedule.seed)
