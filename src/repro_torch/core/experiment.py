"""Experiment management (the paper's Experiment custom resource).

An Experiment ties a DataSet, a LoadPattern and a Pipeline together, runs
the load at the requested rates, waits for the pipeline to finish, and
packages spans + metrics + cost into an ExperimentResult. Only one
experiment is "engaged" at a time (module-level lock), exactly as PlantD
serializes experiments against a pipeline.

Copy of ``repro.core.experiment`` for the port, with its own ``_ENGAGED``
lock. The port's ``CostModel`` states no accelerator price: an experiment
over a pipeline whose resources hold chips needs
``cost_model=CostModel(chip_usd_per_hour=...)`` and raises without one.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.cost import CostModel
from repro_torch.core.datagen import DataSet
from repro_torch.core.loadpattern import LoadPattern
from repro_torch.core.metrics import MetricStore
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.spans import SpanCollector

_ENGAGED = threading.Lock()


@dataclass
class ExperimentResult:
    name: str
    pipeline_name: str
    started: float
    duration_s: float
    records_sent: int
    records_done: int
    ingest_mb: float
    stage_summary: Dict[str, Dict[str, float]]
    cost: Dict[str, float]
    collector: SpanCollector
    metrics: MetricStore
    drained: bool
    # dilation the experiment ran under; trace binning (calibration)
    # uses it to convert real span timestamps back to virtual time
    time_scale: float = 1.0

    @property
    def sustained_rps(self) -> float:
        """Apparent sustained throughput: records fully processed / total
        time to process them (the paper's simple-twin capacity estimate)."""
        return self.records_done / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def base_latency_s(self) -> float:
        """End-to-end per-record latency with no queueing: sum of stage
        median service times."""
        return sum(v["p50_latency_s"] for v in self.stage_summary.values())


@dataclass
class Experiment:
    name: str
    pipeline: Pipeline
    load: LoadPattern
    dataset: DataSet
    cost_model: CostModel = field(default_factory=CostModel)
    batch_records: int = 1          # records per submitted batch
    tick_s: float = 0.02
    drain_timeout_s: float = 600.0
    # time dilation for tests: 2.0 runs the pattern twice as fast while
    # reporting undialted rates (keeps CI quick without changing semantics)
    time_scale: float = 1.0
    status: str = "pending"

    def run(self) -> ExperimentResult:
        # an unpriced accelerator raises here, before the load runs
        self.cost_model.pipeline_usd_per_hour(self.pipeline.resources)
        with _ENGAGED:          # one engaged experiment at a time
            return self._run()

    def _run(self) -> ExperimentResult:
        self.status = "engaged"
        pipe = self.pipeline
        metrics = MetricStore()
        pipe.start()
        sent = 0
        carry = 0.0
        t_start = time.perf_counter()
        virt_total = self.load.total_duration
        try:
            virt_prev = 0.0
            while virt_prev < virt_total:
                time.sleep(self.tick_s)
                virt_now = min((time.perf_counter() - t_start) * self.time_scale,
                               virt_total)
                due = self.load.records_between(virt_prev, virt_now) + carry
                n = int(due)
                carry = due - n
                virt_prev = virt_now
                while n > 0:
                    take = min(n, self.batch_records)
                    batch = self.dataset.record_batch(sent, take)
                    pipe.submit(batch, take)
                    sent += take
                    n -= take
                # every experiment series shares the virtual (undilated)
                # clock, so time_scale'd runs export one coherent time base
                # and calibration can bin records_sent into an ObservedTrace
                metrics.observe("load_rps", self.load.rate_at(virt_now),
                                t=virt_now)
                metrics.observe("queued_records", pipe.inflight, t=virt_now)
                metrics.observe("records_sent", sent, t=virt_now)
            drained = pipe.drain(self.drain_timeout_s)
        finally:
            pipe.stop()
        t_end = time.perf_counter()
        # report in *virtual* (undilated) time so time_scale is transparent
        duration = (t_end - t_start) * self.time_scale
        summary = pipe.collector.summary()
        if self.time_scale != 1.0:
            for v in summary.values():
                v["throughput_rps"] = v["throughput_rps"] / self.time_scale
        ingest_mb = sent * self.dataset.schema.record_bytes() / 1e6
        cost = self.cost_model.experiment_cost(pipe.resources, duration, ingest_mb)
        self.status = "completed"
        return ExperimentResult(
            name=self.name, pipeline_name=pipe.name, started=t_start,
            duration_s=duration, records_sent=sent,
            records_done=sent - max(pipe.inflight, 0), ingest_mb=ingest_mb,
            stage_summary=summary, cost=cost, collector=pipe.collector,
            metrics=metrics, drained=drained, time_scale=self.time_scale)
