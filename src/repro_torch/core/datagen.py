"""Synthetic data generation (the paper's GoFakeIt-based data service).

Copy of ``repro.core.datagen`` for the port: the same numbers for the same
(schema, seed).

Generates a DataSet ahead of an experiment (the paper stores generated data
before the run so generation never throttles the load generator). Generation
is numpy-based and deterministic per (schema, seed).

For LM pipelines the interesting structure is token statistics: uniform
token ids exercise an LM pipeline the way mid-ocean lat/lons exercise a
map-matching stage (the paper's own example of unrealistic synthetic data) —
so token streams use a Zipfian distribution by default, which matches the
rank-frequency profile of real text corpora.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.schema import FieldSpec, Schema


@dataclass
class DataSet:
    """Pre-generated records for an experiment (Kubernetes DataSet CRD)."""
    schema: Schema
    columns: Dict[str, np.ndarray]
    num_records: int

    def record_batch(self, start: int, count: int) -> Dict[str, np.ndarray]:
        idx = (np.arange(start, start + count)) % self.num_records
        return {k: v[idx] for k, v in self.columns.items()}

    @property
    def total_bytes(self) -> int:
        return self.num_records * self.schema.record_bytes()


class DataGenerator:
    def __init__(self, seed: int = 0, zipf_a: float = 1.2):
        self.seed = seed
        self.zipf_a = zipf_a

    def generate(self, schema: Schema, num_records: int) -> DataSet:
        # stable across processes: Python's str hash is salted by
        # PYTHONHASHSEED, so hash((name, seed)) would break "deterministic
        # per (schema, seed)" between runs; crc32 is not
        rng = np.random.default_rng(
            zlib.crc32(f"{schema.name}:{self.seed}".encode()) % (2 ** 31))
        cols: Dict[str, np.ndarray] = {}
        for f in schema.fields:
            cols[f.name] = self._field(rng, f, num_records)
        return DataSet(schema, cols, num_records)

    def _field(self, rng, f: FieldSpec, n: int) -> np.ndarray:
        if f.kind == "float":
            return rng.uniform(f.low, f.high, n).astype(np.float32)
        if f.kind == "int":
            return rng.integers(int(f.low), int(f.high), n, dtype=np.int64)
        if f.kind == "timestamp":
            base = np.datetime64("2026-01-01").astype("datetime64[s]").astype(np.int64)
            return base + rng.integers(0, 86400 * 364, n)
        if f.kind == "choice":
            return rng.choice(np.array(f.choices), n)
        if f.kind == "latlon":
            # constrained land box (avoids the paper's mid-ocean pitfall)
            lat = rng.uniform(38.4, 41.9, n)
            lon = rng.uniform(-84.8, -80.5, n)
            return np.stack([lat, lon], -1).astype(np.float32)
        if f.kind == "tokens":
            # Zipfian token ids folded into the vocab
            z = rng.zipf(self.zipf_a, size=(n, f.length))
            return ((z - 1) % f.vocab_size).astype(np.int32)
        if f.kind == "bytes":
            return rng.integers(0, 256, (n, f.length), dtype=np.uint8)
        raise ValueError(f.kind)
