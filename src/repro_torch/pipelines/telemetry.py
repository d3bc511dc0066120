"""The paper's pipeline-under-test: automotive telemetry, three variants.

Mirrors Sec. VI-A with real compute on CPU:

  unzipper_phase — receives one zip blob per car transmission (five binary
                   subsystem files), decompresses, forwards the binaries.
  v2x_phase      — parses the custom binary telematics format into columnar
                   ("parquet-like") arrays; the ``blocking-write`` variant
                   synchronously backs every file up to a blob store
                   (tempdir + fsync), the paper's deliberate design flaw.
  etl_phase      — scrubs records with missing/bad data and inserts the
                   clean rows into an in-memory SQLite database (the RDS
                   analogue).

Variants (paper Sec. VII-A):
  blocking-write    — synchronous blob backup inside v2x_phase
  no-blocking-write — backup handed to a background writer thread
  cpu-limited       — no-blocking, with v2x_phase CPU-throttled (cgroup-style)

Copy of ``repro.pipelines.telemetry`` for the port (stdlib and numpy).
"""
from __future__ import annotations

import io
import os
import queue
import sqlite3
import struct
import tempfile
import time
import threading
import zipfile
import zlib
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.datagen import DataSet
from repro_torch.core.pipeline import Pipeline, PipelineStage, Resources
from repro_torch.core.schema import Schema, FieldSpec

SUBSYSTEMS = ("engine", "location", "speed", "battery", "adas")
CHANNELS = 12
SAMPLES = 64          # samples per channel per transmission
MAGIC = 0x56325821    # 'V2X!'
# blob-store PUT round-trip (the S3 latency the paper's blocking write
# paid inline; local fsync alone is instant on this container's FS)
BLOB_RTT_S = 0.002

TELEMETRY_VARIANTS = ("blocking-write", "no-blocking-write", "cpu-limited")


# ---------------------------------------------------------------------------
# Synthetic raw data: one zip per car transmission
# ---------------------------------------------------------------------------

def _binary_subsystem(rng: np.random.Generator, vehicle: int, name: str) -> bytes:
    """Custom binary format: header + float32 channel block (with a few NaNs
    so etl has real scrubbing work)."""
    data = rng.normal(0, 100, (CHANNELS, SAMPLES)).astype(np.float32)
    bad = rng.random((CHANNELS, SAMPLES)) < 0.01
    data[bad] = np.nan
    head = struct.pack("<IIH6sII", MAGIC, vehicle, len(name),
                       name.encode()[:6].ljust(6), CHANNELS, SAMPLES)
    return head + data.tobytes()


def make_telemetry_dataset(num_records: int, seed: int = 0) -> DataSet:
    """num_records zip transmissions (the DataSet fed to the load generator)."""
    rng = np.random.default_rng(seed)
    blobs: List[bytes] = []
    for i in range(num_records):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for sub in SUBSYSTEMS:
                z.writestr(f"{sub}.bin", _binary_subsystem(rng, i, sub))
        blobs.append(buf.getvalue())
    mean_bytes = int(np.mean([len(b) for b in blobs]))
    schema = Schema("vehicle-zip", (FieldSpec("zip", "bytes", length=mean_bytes),))
    cols = {"zip": np.array(blobs, dtype=object)}
    return DataSet(schema, cols, num_records)


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def _unzip(batch: Dict) -> List[bytes]:
    out: List[bytes] = []
    for blob in batch["zip"]:
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            for name in z.namelist():
                out.append(z.read(name))
    return out


class _V2XParser:
    def __init__(self, blob_dir: Optional[str], blocking: bool):
        self.blob_dir = blob_dir
        self.blocking = blocking
        self._bg_queue: "queue.Queue[bytes]" = queue.Queue()
        self._bg: Optional[threading.Thread] = None
        if blob_dir and not blocking:
            self._bg = threading.Thread(target=self._bg_writer, daemon=True)
            self._bg.start()
        self._counter = 0

    def _write_blob(self, payload: bytes):
        path = os.path.join(self.blob_dir, f"blob_{os.getpid()}_{id(self)}_"
                            f"{self._counter}.bin")
        self._counter += 1
        with open(path, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())       # the blocking S3 PUT analogue
        time.sleep(BLOB_RTT_S)         # network round-trip to the blob store

    def _bg_writer(self):
        while True:
            payload = self._bg_queue.get()
            if payload is None:
                return
            try:
                self._write_blob(payload)
            except OSError:
                pass

    def __call__(self, binaries: List[bytes]) -> List[Dict]:
        tables: List[Dict] = []
        for raw in binaries:
            magic, vehicle, nlen, name, ch, ns = struct.unpack_from(
                "<IIH6sII", raw, 0)
            assert magic == MAGIC, "corrupt subsystem file"
            off = struct.calcsize("<IIH6sII")
            arr = np.frombuffer(raw, np.float32, ch * ns, off).reshape(ch, ns)
            # "parquet conversion": columnar dict + checksum pass
            table = {"vehicle": vehicle, "subsystem": name[:nlen].decode(),
                     "data": arr, "crc": zlib.crc32(raw)}
            if self.blob_dir is not None:
                payload = zlib.compress(raw, 1)
                if self.blocking:
                    self._write_blob(payload)
                else:
                    self._bg_queue.put(payload)
            tables.append(table)
        return tables


class _ETL:
    def __init__(self):
        self.db = sqlite3.connect(":memory:", check_same_thread=False)
        self.db.execute("CREATE TABLE telemetry (vehicle INT, subsystem TEXT,"
                        " channel INT, mean REAL, mn REAL, mx REAL, n INT)")
        self.rows = 0
        self.scrubbed = 0

    def __call__(self, tables: List[Dict]) -> None:
        rows = []
        for t in tables:
            data = t["data"]
            good = np.isfinite(data)
            self.scrubbed += int((~good).sum())
            for c in range(data.shape[0]):
                col = data[c][good[c]]
                if col.size == 0:
                    continue
                rows.append((int(t["vehicle"]), t["subsystem"], c,
                             float(col.mean()), float(col.min()),
                             float(col.max()), int(col.size)))
        with self.db:
            self.db.executemany("INSERT INTO telemetry VALUES (?,?,?,?,?,?,?)",
                                rows)
        self.rows += len(rows)
        return None


# ---------------------------------------------------------------------------
# Pipeline factory
# ---------------------------------------------------------------------------

def make_telemetry_pipeline(variant: str, blob_dir: Optional[str] = None
                            ) -> Pipeline:
    assert variant in TELEMETRY_VARIANTS, variant
    if blob_dir is None:
        blob_dir = tempfile.mkdtemp(prefix=f"plantd_blob_{variant.replace('-','_')}_")
    os.makedirs(blob_dir, exist_ok=True)
    blocking = variant == "blocking-write"
    v2x = _V2XParser(blob_dir, blocking=blocking)
    etl = _ETL()
    # cpu-limited throttles v2x below even the blocking variant's capacity
    # (paper Sec. VII-A: "deliberately throttle the CPU of the second stage
    # ... verify it has a similar effect as the blocking write did")
    quota = 0.02 if variant == "cpu-limited" else 1.0
    stages = [
        PipelineStage("unzipper_phase", _unzip),
        PipelineStage("v2x_phase", v2x, cpu_quota=quota),
        PipelineStage("etl_phase", etl),
    ]
    # resource declarations drive the cost model (vCPUs sized per variant:
    # the non-blocking variant provisions bigger nodes, as in the paper where
    # it cost ~8x more per hour)
    res = {"blocking-write": Resources(vcpus=2, ram_gb=4),
           "no-blocking-write": Resources(vcpus=16, ram_gb=32),
           "cpu-limited": Resources(vcpus=0.5, ram_gb=2)}[variant]
    p = Pipeline(f"telemetry-{variant}", stages, resources=res)
    p.etl = etl          # expose for result validation
    return p
