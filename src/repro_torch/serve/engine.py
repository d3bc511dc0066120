"""Batched serving engine — the inference pipeline-under-test.

Counterpart: ``repro.serve.engine``, with the same behaviour. Requests
queue up; groups of up to ``slots`` are prefilled together (prompts
right-padded to ``max_len // 2``; the first token comes from the last,
padded, position), then decoded step by step from the padded length
until every member finishes. Stages (queue wait / prefill / decode) are
wind-tunnel spans, so PlantD experiments measure TTFT, per-token latency
and throughput of a serving pipeline as of the paper's telemetry pipeline.

The engine runs on one device (``device=``, default ``"cuda"``; it raises
without a card) and takes no mesh. It holds the parameters as the forward
pass reads them (``models.model.compute_params``: matrices in the compute
dtype, cast once). Every tensor it makes names the engine's device, so a
pipeline's worker thread (``as_pipeline``) serves on it as the caller's
thread does.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.config import ModelConfig
from repro_torch.core.pipeline import Pipeline, PipelineStage, Resources
from repro_torch.core.spans import SpanCollector, span
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.steps import make_decode_step, make_prefill_step


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    submitted: float = 0.0
    first_token: Optional[float] = None
    completed: Optional[float] = None
    output: List[int] = field(default_factory=list)

    @property
    def ttft_s(self) -> Optional[float]:
        return (None if self.first_token is None
                else self.first_token - self.submitted)

    @property
    def latency_s(self) -> Optional[float]:
        return (None if self.completed is None
                else self.completed - self.submitted)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256,
                 collector: Optional[SpanCollector] = None, chips: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = M.compute_params(params, cfg, self.device)
        self.slots = slots
        self.max_len = max_len
        self.collector = collector or SpanCollector()
        self.chips = chips
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)
        self._prefill_len = max_len // 2

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        return logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()

    # -- one group ------------------------------------------------------------
    def process_group(self, group: Sequence[Request]) -> None:
        now = self.collector.clock
        g = len(group)
        if g > self.slots:
            raise ValueError(f"{g} requests for {self.slots} slots")
        obs.count("serve.requests", g)
        plen = self._prefill_len
        toks = np.zeros((self.slots, plen), np.int32)
        for i, r in enumerate(group):
            p = r.prompt[-plen:]
            toks[i, :len(p)] = p        # left-aligned, right-padded
        with span("prefill", self.collector, records=g):
            cache = M.init_cache(self.cfg, self.slots, self.max_len,
                                 device=self.device)
            logits, cache = self._prefill(
                self.params,
                {"tokens": torch.from_numpy(toks).to(self.device)}, cache)
            self._sync()
        tok = self._greedy(logits)
        t = now()
        for i, r in enumerate(group):
            r.first_token = t
            r.output.append(int(tok[i]))
        max_new = max(r.max_new for r in group)
        cur = torch.from_numpy(tok)[:, None].to(self.device)
        for _ in range(1, max_new):
            with span("decode", self.collector, records=g):
                logits, cache = self._decode(self.params, cache,
                                             {"token": cur})
                self._sync()
            nxt = self._greedy(logits)
            t = now()
            for i, r in enumerate(group):
                if len(r.output) < r.max_new:
                    r.output.append(int(nxt[i]))
                    if len(r.output) == r.max_new:
                        r.completed = t
            cur = torch.from_numpy(nxt)[:, None].to(self.device)
        t = now()
        for r in group:
            if r.completed is None:
                r.completed = t

    # -- request-loop driver ---------------------------------------------------
    def serve(self, requests: List[Request]) -> List[Request]:
        """FIFO grouped batching over a pre-timestamped request list
        (timestamps relative to start). The stage spans (queue_wait /
        prefill / decode) land in the engine's collector as always and
        mirror into ``repro_torch.obs`` as ``stage.*`` spans when
        telemetry is on; the request loop itself records a ``serve.loop``
        span with the request count and bumps ``serve.requests`` /
        ``serve.groups`` counters."""
        with obs.span("serve.loop", requests=len(requests),
                      slots=self.slots):
            start = self.collector.clock()
            pending = sorted(requests, key=lambda r: r.submitted)
            for r in pending:
                r.submitted += start
            done: List[Request] = []
            i = 0
            while i < len(pending):
                nowt = self.collector.clock()
                group = []
                while (i < len(pending) and len(group) < self.slots
                       and pending[i].submitted <= nowt):
                    group.append(pending[i])
                    i += 1
                if not group:
                    nxt = pending[i].submitted
                    time.sleep(max(0.0, min(nxt - nowt, 0.01)))
                    continue
                with span("queue_wait", self.collector,
                          records=len(group)):
                    pass
                obs.count("serve.groups")
                self.process_group(group)
                done.extend(group)
            return done

    def as_pipeline(self, name: str = "serve") -> Pipeline:
        """Wind-tunnel adapter: one stage that serves a group per record
        batch (records are token-id arrays from a DataSet)."""
        def stage(batch: Dict) -> None:
            toks = batch["tokens"]
            reqs = [Request(rid=i, prompt=list(map(int, row[:8])), max_new=4)
                    for i, row in enumerate(np.atleast_2d(toks)[: self.slots])]
            # the worker thread's current card is its own: name the engine's
            with (torch.cuda.device(self.device)
                  if self.device.type == "cuda" else contextlib.nullcontext()):
                self.process_group(reqs)
            return None
        return Pipeline(name, [PipelineStage("serve_group", stage)],
                        resources=Resources(vcpus=2, ram_gb=4,
                                            chips=self.chips),
                        collector=self.collector)
