"""Host-side training data pipeline.

Copy of ``repro.data.loader`` for the port, over its own copies of
``core/schema`` and ``core/spans``. Synthesizes token batches from a core
Schema (the LM pipeline's ingest is itself a PlantD pipeline-under-test:
datagen -> pack -> h2d are the spans the wind tunnel measures). A
background thread prefetches; ``state_dict``/``load_state_dict`` make the
stream restart-exactly (checkpointed alongside model state). Batch
``step`` is zipf tokens from ``default_rng((seed * 1_000_003 + step) %
2**31)``, numpy arrays bitwise the reference's. A rank of a data mesh
passes ``rows=``, its rows of every global batch
(``distributed.sharding.batch_rows``): it draws the whole batch, as every
rank does, and keeps those.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.schema import token_stream_schema
from repro_torch.core.spans import SpanCollector, span


class TokenBatchLoader:
    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, prefetch: int = 2,
                 collector: Optional[SpanCollector] = None,
                 zipf_a: float = 1.2, rows: Optional[np.ndarray] = None):
        self.schema = token_stream_schema(vocab_size, seq_len)
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.step = 0
        self.collector = collector
        self.zipf_a = zipf_a
        self.rows = None if rows is None else np.asarray(rows)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._produce_step = 0
        self._stop = threading.Event()
        self._thread.start()

    # -- deterministic per-step batch ----------------------------------------
    def _make(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + step) % 2 ** 31)
        z = rng.zipf(self.zipf_a, size=(self.batch, self.seq_len))
        tokens = ((z - 1) % self.vocab_size).astype(np.int32)
        if self.rows is not None:
            tokens = tokens[self.rows]
        return {"tokens": tokens,
                "loss_mask": np.ones_like(tokens, np.float32)}

    def _producer(self):
        while not self._stop.is_set():
            with self._lock:
                step = self._produce_step
            with span("datagen", self.collector, records=self.batch):
                batch = self._make(step)
            placed = False
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    placed = True
                    break
                except queue.Full:
                    with self._lock:
                        if self._produce_step != step:   # rewound mid-flight
                            break
            if placed:
                with self._lock:
                    # only advance if no rewind raced with this iteration
                    if self._produce_step == step:
                        self._produce_step = step + 1

    def next(self) -> Dict[str, np.ndarray]:
        while True:
            step, batch = self._q.get()
            if step == self.step:            # drop stale prefetches on resume
                self.step += 1
                return batch
            if step > self.step:             # producer ahead of a rewind
                with self._lock:
                    self._produce_step = self.step
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    # -- restart-exact state --------------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: Dict):
        self.step = int(state["step"])
        with self._lock:
            self._produce_step = self.step
        # drain stale queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        """Stop the producer and wait for its thread (it wakes within its
        0.2 s put timeout)."""
        self._stop.set()
        self._thread.join(timeout=5)
