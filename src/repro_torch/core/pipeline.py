"""Pipeline-under-test abstraction (a copy of ``repro.core.pipeline``).

A Pipeline is a chain of named stages connected by bounded queues, each
stage running on its own worker thread (the in-process analogue of the
paper's Kafka-decoupled stages). Every stage execution is wrapped in a span,
so the collector sees per-stage latency/throughput exactly like the paper's
OpenTelemetry instrumentation. Ingestion happens by ``submit``-ing record
batches; ``drain`` waits until all queues are empty (the paper's "can't even
tell when the pipeline is done without instrumentation" — here the harness
owns the queues, so it can).

Resources (vCPU/RAM) are declared per pipeline for cost allocation — the
OpenCost analogue prorates their price over the experiment window.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.spans import SpanCollector, span


@dataclass
class PipelineStage:
    name: str
    fn: Callable[[Any], Any]          # batch -> batch (None output = sink)
    # simulated cgroup CPU quota: fraction of a core this stage may use
    # (1.0 = unthrottled). Implements the paper's `cpu-limited` variant.
    cpu_quota: float = 1.0


@dataclass
class Resources:
    vcpus: float = 2.0
    ram_gb: float = 4.0
    chips: int = 0                    # accelerator cards (serving/training)


class Pipeline:
    def __init__(self, name: str, stages: Sequence[PipelineStage],
                 resources: Resources = Resources(),
                 collector: Optional[SpanCollector] = None,
                 queue_depth: int = 100000):
        self.name = name
        self.stages = list(stages)
        self.resources = resources
        self.collector = collector or SpanCollector()
        self._queues: List[queue.Queue] = [queue.Queue(queue_depth)
                                           for _ in self.stages]
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.errors: List[Exception] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        self._stop.clear()
        for i, stage in enumerate(self.stages):
            t = threading.Thread(target=self._worker, args=(i, stage),
                                 daemon=True, name=f"{self.name}.{stage.name}")
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()

    def _worker(self, idx: int, stage: PipelineStage):
        while not self._stop.is_set():
            try:
                batch, records = self._queues[idx].get(timeout=0.05)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            try:
                with span(stage.name, self.collector, records=records):
                    out = stage.fn(batch)
            except Exception as e:   # noqa: BLE001 — stage fault isolation
                self.errors.append(e)
                out = None
            busy = time.perf_counter() - t0
            if stage.cpu_quota < 1.0 and busy > 0:
                # cgroup-style throttle: a quota q stretches wall time by 1/q
                time.sleep(busy * (1.0 / stage.cpu_quota - 1.0))
            if out is not None and idx + 1 < len(self.stages):
                self._queues[idx + 1].put((out, records))
            else:
                with self._inflight_lock:
                    self._inflight -= records
            self._queues[idx].task_done()

    # -- ingestion ------------------------------------------------------------
    def submit(self, batch: Any, records: int = 1):
        with self._inflight_lock:
            self._inflight += records
        self._queues[0].put((batch, records))

    def queue_depths(self) -> Dict[str, int]:
        return {s.name: q.qsize() for s, q in zip(self.stages, self._queues)}

    @property
    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def drain(self, timeout: float = 600.0) -> bool:
        """Wait until every submitted record has left the last stage."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if self.inflight <= 0:
                return True
            time.sleep(0.01)
        return False
