"""Per-dispatch profiling: first call vs steady state, and peak memory.

Counterpart: ``repro.obs.profile``, rewritten for torch. The reference
AOT-lowers a jitted callable through ``jax.stages`` and times the
compile apart from the execution. The port has no trace to compile:
``profile_dispatch`` times the FIRST call of ``fn`` (which includes any
kernel build or library load and the warm-up) apart from the steady
state, best of ``reps``. On the card it times with CUDA events and reads
the peak memory the call allocates through
``torch.cuda.reset_peak_memory_stats`` / ``max_memory_allocated``; on the
CPU it times with the host clock and reports no peak. The result is
recorded as a ``dispatch.{name}`` span and a ``DispatchProfile`` row, as
in the reference (``compile_s`` holds the first call's time).

``jit_cache_grew`` is the lightweight sibling for hot paths: did this
call build or load something? The port has no trace cache, so
``jit_cache_size`` reads the count of kernel libraries that
``kernels/build.py`` has built or loaded in the process
(``build.library_count``), whatever callable it is given; the grid
engine tags each ``grid.block`` span with ``compiled=1`` exactly when
that count grew during the launch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.obs.record import get_recorder

__all__ = ["DispatchProfile", "jit_cache_grew", "jit_cache_size",
           "profile_dispatch"]


@dataclass
class DispatchProfile:
    """One profiled dispatch: the first-call / steady-state split, and on
    the card the peak memory the call allocated (None on the CPU). The
    reference's compiled-program statistics (generated code, argument
    and output bytes, flops) have no counterpart in the port."""
    name: str
    compile_s: float                  # the first call (build/load, warm-up)
    execute_s: float                  # steady state, best of reps
    reps: int
    peak_temp_bytes: Optional[int] = None
    attrs: Dict[str, float] = field(default_factory=dict)

    def row(self) -> Dict:
        """JSON-ready row (the BENCH_*.json shape)."""
        out = {"name": self.name,
               "compile_s": round(self.compile_s, 4),
               "execute_s": round(self.execute_s, 4),
               "reps": self.reps}
        if self.peak_temp_bytes is not None:
            out["peak_temp_mb"] = round(self.peak_temp_bytes / 2**20, 1)
        out.update(self.attrs)
        return out


def _cuda_device(args) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            return a.device
    return None


def _timed_call(fn, args, dev):
    """One call of ``fn(*args)``, its time in seconds (CUDA events on the
    card, the host clock otherwise) and its output."""
    if dev is None:
        t0 = time.perf_counter()
        out = fn(*args)
        return time.perf_counter() - t0, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def profile_dispatch(name: str, fn, *args, reps: int = 3,
                     **attrs) -> "tuple":
    """Profile one dispatch of ``fn(*args)``; returns ``(last_output,
    profile)``.

    The first call is timed on its own (``compile_s``), then ``reps``
    calls, best of (``execute_s``). Where an argument is a CUDA tensor the
    calls are timed with CUDA events on that device's current stream and
    ``peak_temp_bytes`` is the most memory the steady-state calls held
    above what was allocated before them. Like ``obs.timed`` this records
    UNCONDITIONALLY: a ``dispatch.{name}`` span lands in the global
    recorder with the split (and peak) as attrs, and the
    ``DispatchProfile`` is appended to ``recorder.profiles``.
    """
    rec = get_recorder()
    dev = _cuda_device(args)
    reps = max(int(reps), 1)
    compile_s, out = _timed_call(fn, args, dev)
    peak = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    best = float("inf")
    for _ in range(reps):
        s, out = _timed_call(fn, args, dev)
        best = min(best, s)
    if dev is not None:
        peak = max(int(torch.cuda.max_memory_allocated(dev)) - base, 0)

    prof = DispatchProfile(
        name=name, compile_s=compile_s, execute_s=best, reps=reps,
        peak_temp_bytes=peak,
        attrs={k: float(v) for k, v in attrs.items()})
    span_attrs = dict(prof.attrs, compile_s=compile_s, execute_s=best)
    if peak is not None:
        span_attrs["peak_temp_bytes"] = float(peak)
    now = rec.clock()
    rec.add_span(f"dispatch.{name}", now - compile_s - best, now,
                 span_attrs)
    rec.profiles.append(prof)
    return out, prof


def jit_cache_grew(fn, before: int) -> bool:
    """Did the process build or load a kernel library since ``before``
    (taken with ``jit_cache_size`` before the call)? — the cheap "this
    call compiled" signal for per-block spans."""
    return jit_cache_size(fn) > before


def jit_cache_size(fn=None) -> int:
    """The count of kernel libraries ``kernels/build.py`` has built or
    loaded in this process (the port's stand-in for the reference's
    trace-cache size; ``fn`` is accepted for the reference's signature
    and not read)."""
    return build.library_count()
