"""Fault tolerance: straggler detection, retry wrapper, failure simulation.

Copy of ``repro.distributed.fault`` for the port, on its own
``core.spans.SpanCollector``. On a real cluster the runtime signals node
loss via exceptions from the collective layer; here the same control flow
is exercised through injected ``FaultInjector`` failures (tests) so the
recovery paths are real even if the failures are synthetic.

* ``StragglerWatchdog`` — the wind-tunnel spans double as a straggler
  detector: a stage whose latest duration exceeds k x rolling-median is
  flagged (the paper's per-stage latency view, used operationally).
* ``retry_step`` — retries a step through transient faults with exponential
  backoff; unrecoverable faults propagate to the restart-from-checkpoint
  path in the train loop.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.spans import SpanCollector


class TransientFault(RuntimeError):
    """Recoverable in-process (preemption notice, timeout, flaky link)."""


class NodeLoss(RuntimeError):
    """Unrecoverable without re-meshing: restart from checkpoint."""


@dataclass
class FaultInjector:
    """Deterministic fault schedule for tests/examples."""
    transient_at: tuple = ()
    node_loss_at: tuple = ()
    step: int = 0
    fired: List[str] = field(default_factory=list)

    def check(self):
        s = self.step
        self.step += 1
        if s in self.node_loss_at:
            self.fired.append(f"node_loss@{s}")
            raise NodeLoss(f"injected node loss at step {s}")
        if s in self.transient_at:
            self.fired.append(f"transient@{s}")
            raise TransientFault(f"injected transient fault at step {s}")


class StragglerWatchdog:
    """Flags pipeline stages whose latest span blew past the rolling median."""

    def __init__(self, collector: SpanCollector, factor: float = 3.0,
                 window: int = 32, min_samples: int = 8):
        self.collector = collector
        self.factor = factor
        self.window = window
        self.min_samples = min_samples

    def stragglers(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name in self.collector.stage_names():
            spans = self.collector.spans(name)[-self.window:]
            if len(spans) < self.min_samples:
                continue
            durs = sorted(s.duration for s in spans[:-1])
            med = durs[len(durs) // 2]
            last = spans[-1].duration
            if med > 0 and last > self.factor * med:
                out[name] = {"last_s": last, "median_s": med,
                             "ratio": last / med}
        return out


def retry_step(fn: Callable, *args, retries: int = 3, backoff_s: float = 0.05,
               injector: Optional[FaultInjector] = None, **kw):
    """Run fn, retrying TransientFault with exponential backoff + jitter.
    NodeLoss propagates (handled by the checkpoint-restart layer)."""
    attempt = 0
    while True:
        try:
            if injector is not None:
                injector.check()
            return fn(*args, **kw)
        except TransientFault:
            attempt += 1
            if attempt > retries:
                raise
            time.sleep(backoff_s * (2 ** (attempt - 1))
                       * (1.0 + 0.1 * random.random()))
