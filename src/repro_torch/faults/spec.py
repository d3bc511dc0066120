"""Declarative fault & outage scenario specs (ROADMAP fault library).

Counterpart: ``repro.faults.spec``, copied unchanged (pure Python).

A ``FaultSpec`` describes one *family* of stochastic fault events as the
chaos-engineering literature frames them (ESPBench's degraded-operation
modes; the broker disconnect drills of real streaming testbeds:
"disconnect 20-50% of devices for 5-30 min, measure queue flush time").
Specs are declarative and policy-agnostic: they perturb the *load* and
*capacity* series a scenario plays, never the policy step itself, so any
fault composes with any registered policy on any grid backend.

Four built-in kinds:

* ``outage``     — capacity -> 0 for the event window (the pipeline is
                   down; arrivals back up in a fault-layer queue and
                   flood back in when capacity returns);
* ``brownout``   — degraded capacity: a multiplier in (0, 1] scales the
                   twin's ``max_rps`` for the window;
* ``disconnect`` — a fraction of upstream devices drops for the window;
                   their records are NOT lost — the missed mass replays
                   as a reconnect flood spread over ``flood_hours``
                   after the window closes (conservation is a test
                   invariant: no record lost or duplicated);
* ``burst``      — anomalous load: arrivals scale by a multiplier for
                   the window (retry storms, replay attacks, flash
                   crowds).

A ``FaultSchedule`` bundles specs with a seed and a future count F: the
seeded sampler (``repro_torch.faults.sampler``) expands it into F concrete
*fault futures* — per-bin capacity-multiplier / load-perturbation /
in-fault-mask series — deterministically (crc32 seeding like
``core/datagen.py``, stable under PYTHONHASHSEED). The grid engine then
runs every (base scenario x future) pair as one more row of the same
matrix+index grid representation (``repro_torch.faults.grid``).

Event counts are Poisson with mean ``rate_per_year`` scaled to the
simulated horizon; windows start uniformly over the horizon and last
``duration_hours`` drawn uniformly from the declared range.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

#: the four built-in fault kinds (see module docstring)
FAULT_KINDS = ("outage", "brownout", "disconnect", "burst")


def _as_range(value, name: str, kind: str) -> Tuple[float, float]:
    """Normalize a scalar or (lo, hi) pair into an ordered float range."""
    if isinstance(value, (int, float)):
        lo = hi = float(value)
    else:
        try:
            lo, hi = (float(v) for v in value)
        except (TypeError, ValueError):
            raise ValueError(
                f"{kind} fault: {name} must be a number or a (lo, hi) "
                f"pair, got {value!r}") from None
    if hi < lo:
        raise ValueError(f"{kind} fault: {name} range ({lo:g}, {hi:g}) "
                         f"is inverted")
    return lo, hi


@dataclass(frozen=True)
class FaultSpec:
    """One stochastic fault family (build via the kind constructors)."""
    kind: str                          # one of FAULT_KINDS
    name: str                          # names this spec in errors/reports
    rate_per_year: float               # Poisson mean event count per year
    duration_hours: Tuple[float, float]    # uniform window length range
    # kind-specific parameter ranges (sampled uniformly per event):
    capacity_mult: Tuple[float, float] = (1.0, 1.0)   # brownout
    disconnect_frac: Tuple[float, float] = (0.0, 0.0)  # disconnect
    flood_hours: float = 1.0                           # disconnect replay
    load_mult: Tuple[float, float] = (1.0, 1.0)        # burst

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")
        if self.rate_per_year < 0:
            raise ValueError(f"{self.name}: rate_per_year must be >= 0, "
                             f"got {self.rate_per_year:g}")
        if self.duration_hours[0] <= 0:
            raise ValueError(f"{self.name}: duration_hours must be "
                             f"positive, got {self.duration_hours}")
        if self.flood_hours <= 0:
            raise ValueError(f"{self.name}: flood_hours must be positive, "
                             f"got {self.flood_hours:g}")


def outage(name: str = "outage", *, rate_per_year: float = 4.0,
           duration_hours=(1.0, 8.0)) -> FaultSpec:
    """Hard outage: capacity -> 0 for the window. Arrivals during the
    window back up in the fault layer and flood back at reconnect."""
    return FaultSpec(kind="outage", name=name,
                     rate_per_year=float(rate_per_year),
                     duration_hours=_as_range(duration_hours,
                                              "duration_hours", "outage"))


def brownout(name: str = "brownout", *, rate_per_year: float = 6.0,
             duration_hours=(2.0, 24.0),
             capacity_mult=(0.3, 0.8)) -> FaultSpec:
    """Degraded capacity: ``max_rps`` scales by a multiplier drawn from
    ``capacity_mult`` for the window (overlapping events compose
    multiplicatively)."""
    mult = _as_range(capacity_mult, "capacity_mult", "brownout")
    if mult[0] < 0:
        raise ValueError(f"{name}: capacity_mult must be >= 0, got {mult}")
    return FaultSpec(kind="brownout", name=name,
                     rate_per_year=float(rate_per_year),
                     duration_hours=_as_range(duration_hours,
                                              "duration_hours", "brownout"),
                     capacity_mult=mult)


def disconnect(name: str = "disconnect", *, rate_per_year: float = 12.0,
               duration_hours=(0.5, 2.0), disconnect_frac=(0.2, 0.5),
               flood_hours: float = 1.0) -> FaultSpec:
    """Correlated device disconnect: a fraction ``disconnect_frac`` of the
    load vanishes for the window, then replays as a reconnect flood
    spread uniformly over ``flood_hours`` after the window closes. Mass
    is conserved exactly: no record is lost or duplicated."""
    frac = _as_range(disconnect_frac, "disconnect_frac", "disconnect")
    if not (0.0 <= frac[0] and frac[1] <= 1.0):
        raise ValueError(f"{name}: disconnect_frac must lie in [0, 1], "
                         f"got {frac}")
    return FaultSpec(kind="disconnect", name=name,
                     rate_per_year=float(rate_per_year),
                     duration_hours=_as_range(duration_hours,
                                              "duration_hours",
                                              "disconnect"),
                     disconnect_frac=frac, flood_hours=float(flood_hours))


def burst(name: str = "burst", *, rate_per_year: float = 8.0,
          duration_hours=(0.5, 3.0), load_mult=(1.5, 4.0)) -> FaultSpec:
    """Anomalous load burst: arrivals scale by ``load_mult`` for the
    window (retry storms, flash crowds). Multipliers below 1 model
    anomalous lulls; negative multipliers are rejected at sampling with
    the spec name and bin index."""
    return FaultSpec(kind="burst", name=name,
                     rate_per_year=float(rate_per_year),
                     duration_hours=_as_range(duration_hours,
                                              "duration_hours", "burst"),
                     load_mult=_as_range(load_mult, "load_mult", "burst"))


@dataclass(frozen=True)
class FaultSchedule:
    """A set of fault specs plus the sampling contract (seed, futures).

    ``n_futures`` is F: how many independent Monte-Carlo fault futures
    the sampler draws. Every base scenario of a faulted grid expands into
    F rows (one per future), so a chance-constrained search can ask for
    "meets the SLO in >= 95% of futures". An empty ``specs`` tuple is
    legal and yields benign futures (capacity multiplier 1, no load
    perturbation) — the bit-parity anchor the tests pin.
    """
    specs: Tuple[FaultSpec, ...] = ()
    n_futures: int = 4
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))
        if self.n_futures < 1:
            raise ValueError(f"n_futures must be >= 1, got "
                            f"{self.n_futures}")
        names = [s.name for s in self.specs]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate fault spec names {sorted(dupes)}; "
                             f"names key the deterministic per-spec seeds")
