"""Run-telemetry recorder — the wind tunnel observing itself.

Copy of ``repro.obs.record`` for the port. ``repro_torch.obs`` is the
off-by-default telemetry layer for the *tool's own* runtime:
monotonic-clock spans around every dispatch boundary (the grid engine's
kernel launches, fault expansion, the serve engine, pipeline stages),
counters and gauges for the load-bearing decisions that used to vanish
into warn-once messages (dedup hit rates, replication fallbacks,
stream-vs-vectorized objective choice), and a bounded ring buffer with
time-based retention so a long-running collect loop never grows without
bound (the collect → prune-by-retention → report cycle of the
Realtime-Datastreaming monitor).

Design rules:

* **Off by default, trivially cheap when off.** The gate is one module
  attribute; ``obs.span(...)`` returns a shared null context manager
  without allocating, ``obs.count`` returns immediately. Set
  ``REPRO_OBS=1`` in the environment, or call ``obs.enable()`` /
  ``obs.capture()``, to record.
* **Strictly at dispatch boundaries.** Instrumentation wraps host-side
  calls that launch kernels — never code inside a kernel or between the
  launches of one call — so enabling it cannot change any computed
  number, and it adds no host synchronisation.
* **Monotonic durations, wall-clock export.** Spans are timed with
  ``time.perf_counter``; the recorder anchors one (wall, monotonic)
  pair at construction so exporters can place every span on the unix
  epoch — which is what lets ``ObservedTrace.from_otel_spans`` re-import
  the tool's own telemetry (see ``repro_torch.obs.export``).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "ObsSpan", "Recorder", "capture", "count", "counters", "disable",
    "enable", "enabled", "event", "gauge", "get_recorder", "instrument",
    "set_recorder", "span", "timed",
]


@dataclass
class ObsSpan:
    """One finished span: monotonic start/end plus free-form attributes.

    ``records`` rides in ``attrs`` (the OTel-export batch size);
    ``parent_id`` links nested spans (``None`` for roots).
    """
    name: str
    start: float                      # monotonic seconds (recorder clock)
    end: float
    attrs: Dict[str, float] = field(default_factory=dict)
    span_id: int = 0
    parent_id: Optional[int] = None

    @property
    def duration(self) -> float:
        return self.end - self.start


#: labeled counter/gauge key: (name, sorted (label, value) pairs)
_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, object]) -> _Key:
    if not labels:
        return (name, ())
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class Recorder:
    """Bounded span ring + counters/gauges, thread-safe.

    ``capacity`` bounds the ring absolutely; ``retention_s`` additionally
    ages spans out by time (pruned lazily on add and explicitly via
    ``prune``), so a continuous collector holds a rolling window instead
    of an ever-growing log. ``clock`` is injectable for tests.
    """

    def __init__(self, capacity: int = 65536,
                 retention_s: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.capacity = int(capacity)
        self.retention_s = retention_s
        self.clock = clock
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.counters: Dict[_Key, float] = {}
        self.gauges: Dict[_Key, float] = {}
        self.profiles: List = []      # DispatchProfile rows (obs.profile)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._stack = threading.local()
        # wall/monotonic anchor pair for epoch placement of spans
        self.wall0 = time.time()
        self.mono0 = self.clock()

    # -- spans ----------------------------------------------------------

    def _parents(self) -> List[int]:
        st = getattr(self._stack, "ids", None)
        if st is None:
            st = self._stack.ids = []
        return st

    def add_span(self, name: str, start: float, end: float,
                 attrs: Optional[Dict] = None,
                 parent_id: Optional[int] = None) -> ObsSpan:
        sp = ObsSpan(name, start, end, dict(attrs or {}),
                     next(self._ids), parent_id)
        with self._lock:
            self.spans.append(sp)
        if self.retention_s is not None:
            self.prune()
        return sp

    def prune(self, retention_s: Optional[float] = None,
              now: Optional[float] = None) -> int:
        """Drop spans older than the retention window (by END time);
        returns how many were dropped."""
        ret = self.retention_s if retention_s is None else retention_s
        if ret is None:
            return 0
        cutoff = (self.clock() if now is None else now) - ret
        dropped = 0
        with self._lock:
            while self.spans and self.spans[0].end < cutoff:
                self.spans.popleft()
                dropped += 1
        return dropped

    def wall_time(self, mono: float) -> float:
        """Place a monotonic timestamp on the unix epoch."""
        return self.wall0 + (mono - self.mono0)

    def find(self, name: Optional[str] = None,
             prefix: Optional[str] = None) -> List[ObsSpan]:
        with self._lock:
            out = list(self.spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        if prefix is not None:
            out = [s for s in out if s.name.startswith(prefix)]
        return out

    # -- counters / gauges ----------------------------------------------

    def count(self, name: str, n: float = 1.0,
              labels: Optional[Dict] = None):
        k = _key(name, labels or {})
        with self._lock:
            self.counters[k] = self.counters.get(k, 0.0) + float(n)

    def gauge(self, name: str, value: float,
              labels: Optional[Dict] = None):
        with self._lock:
            self.gauges[_key(name, labels or {})] = float(value)

    def counter_total(self, name: str) -> float:
        """Sum of one counter across all label sets."""
        with self._lock:
            return sum(v for (n, _), v in self.counters.items()
                       if n == name)

    def clear(self):
        with self._lock:
            self.spans.clear()
            self.counters.clear()
            self.gauges.clear()
            self.profiles.clear()


# -- module state (the fast path) ---------------------------------------

_ENABLED = os.environ.get("REPRO_OBS", "0") not in ("", "0", "false",
                                                    "False", "no")
_RECORDER = Recorder()


def enabled() -> bool:
    """Is run-telemetry recording on? (the one check hot paths pay)"""
    return _ENABLED


def enable() -> Recorder:
    global _ENABLED
    _ENABLED = True
    return _RECORDER


def disable():
    global _ENABLED
    _ENABLED = False


def get_recorder() -> Recorder:
    return _RECORDER


def set_recorder(rec: Recorder) -> Recorder:
    """Swap the global recorder (tests inject clocks/retention); returns
    the previous one."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, rec
    return prev


@contextlib.contextmanager
def capture(clear: bool = True, recorder: Optional[Recorder] = None):
    """Enable telemetry for a block and yield the active recorder::

        with obs.capture() as rec:
            simulate_grid(..., return_series=False)
        print(rec.find(prefix="grid."))

    Restores the previous enabled state (and recorder, if one was
    injected) on exit; ``clear=True`` starts the block from an empty
    recorder.
    """
    global _ENABLED
    prev_state = _ENABLED
    prev_rec = set_recorder(recorder) if recorder is not None else None
    rec = _RECORDER
    if clear:
        rec.clear()
    _ENABLED = True
    try:
        yield rec
    finally:
        _ENABLED = prev_state
        if prev_rec is not None:
            set_recorder(prev_rec)


# -- recording primitives -----------------------------------------------

class _NullSpan:
    """Shared do-nothing span for the disabled path: no allocation, a
    writable class-level ``attrs`` dict call sites may set keys on
    (bounded — the same few keys are overwritten forever)."""
    __slots__ = ()
    attrs: Dict[str, float] = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _OpenSpan:
    """Context manager recording one span. The span id is allocated
    eagerly on enter so nested children link to this span as parent
    while it is still open; ``attrs`` stays mutable inside the block
    (for results known only at exit, e.g. a compile flag)."""
    __slots__ = ("name", "attrs", "_rec", "_t0", "span")

    def __init__(self, rec: Recorder, name: str, attrs: Dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self.span = None

    def __enter__(self):
        self.span = ObsSpan(self.name, 0.0, 0.0, self.attrs,
                            next(self._rec._ids))
        stack = self._rec._parents()
        self.span.parent_id = stack[-1] if stack else None
        stack.append(self.span.span_id)
        self._t0 = self._rec.clock()
        return self

    def __exit__(self, *exc):
        t1 = self._rec.clock()
        self._rec._parents().pop()
        self.span.start, self.span.end = self._t0, t1
        with self._rec._lock:
            self._rec.spans.append(self.span)
        if self._rec.retention_s is not None:
            self._rec.prune()
        return False


def span(name: str, **attrs):
    """Record a span around a block (when telemetry is on)::

        with obs.span("grid.block", block=3, size=4480) as sp:
            ...
            sp.attrs["compiled"] = 1.0

    Disabled, this returns a shared null context manager — the cost is
    the enabled check plus assembling the kwargs dict.
    """
    if not _ENABLED:
        return _NULL
    return _OpenSpan(_RECORDER, name, attrs)


class timed:
    """Like ``span`` but ALWAYS records (benchmarks call it explicitly —
    intent is the opt-in) and exposes the measured wall time::

        with obs.timed("bench.grid", n=1024) as t:
            run()
        print(t.elapsed)
    """

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.elapsed = float("nan")

    def __enter__(self):
        self._t0 = _RECORDER.clock()
        return self

    def __exit__(self, *exc):
        t1 = _RECORDER.clock()
        self.elapsed = t1 - self._t0
        self.span = _RECORDER.add_span(self.name, self._t0, t1, self.attrs)
        return False


def instrument(fn=None, *, name: Optional[str] = None, **attrs):
    """Decorator form of ``span``: wrap a function in a span named after
    it (or ``name=``). Works bare (``@obs.instrument``) or called
    (``@obs.instrument(name="faults.expand_grid")``). Disabled, the
    wrapper is one check then the plain call."""
    def deco(f):
        label = name or f"{f.__module__.rsplit('.', 1)[-1]}.{f.__name__}"

        @functools.wraps(f)
        def wrapped(*a, **kw):
            if not _ENABLED:
                return f(*a, **kw)
            with span(label, **attrs):
                return f(*a, **kw)
        wrapped.__obs_name__ = label
        return wrapped
    if fn is not None:
        return deco(fn)
    return deco


def count(name: str, n: float = 1.0, **labels):
    """Bump a (optionally labeled) counter — no-op when disabled."""
    if _ENABLED:
        _RECORDER.count(name, n, labels)


def gauge(name: str, value: float, **labels):
    """Set a gauge to its latest value — no-op when disabled."""
    if _ENABLED:
        _RECORDER.gauge(name, value, labels)


def event(name: str, **labels):
    """A structured countable event (warn-once messages route through
    here so they stay visible in exports even after Python's warning
    dedup silences the repeat)."""
    if _ENABLED:
        _RECORDER.count(name, 1.0, labels)


def counters() -> Dict[str, float]:
    """Flattened counter snapshot: ``name{k=v,...}`` -> value."""
    out = {}
    with _RECORDER._lock:
        items = list(_RECORDER.counters.items())
    for (nm, labels), v in items:
        if labels:
            nm = nm + "{" + ",".join(f"{k}={val}" for k, val in labels) \
                + "}"
        out[nm] = v
    return out
