"""Data schemas (GoFakeIt analogue): field specs with constraints.

Copy of ``repro.core.schema`` for the port.

A Schema describes one record type the pipeline-under-test ingests. Fields
carry type + range/choice constraints; the DataGenerator synthesizes records
matching them. For LM pipelines a Schema can also describe a token stream
(field kind "tokens" with a vocab size and length distribution) — the
serving pipeline's equivalent of the paper's zipped telemetry files.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class FieldSpec:
    name: str
    kind: str                      # float | int | choice | latlon | timestamp | tokens | bytes
    low: float = 0.0
    high: float = 1.0
    choices: Tuple[str, ...] = ()
    vocab_size: int = 0            # kind == tokens
    length: int = 0                # kind in (tokens, bytes)

    def byte_size(self) -> int:
        """Approximate on-the-wire size of one field value (CSV-ish)."""
        if self.kind == "float":
            return 12
        if self.kind == "int":
            return 8
        if self.kind == "timestamp":
            return 20
        if self.kind == "choice":
            return max((len(c) for c in self.choices), default=4)
        if self.kind == "latlon":
            return 24
        if self.kind == "tokens":
            return 4 * self.length
        if self.kind == "bytes":
            return self.length
        raise ValueError(self.kind)


@dataclass(frozen=True)
class Schema:
    name: str
    fields: Tuple[FieldSpec, ...]

    def record_bytes(self) -> int:
        return sum(f.byte_size() for f in self.fields) + len(self.fields)

    def field(self, name: str) -> FieldSpec:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)


def telemetry_schema(subsystems: int = 5, floats_per_subsystem: int = 12) -> Schema:
    """The Honda-style automotive telemetry record: one zip per car
    transmission containing ``subsystems`` binary channel files."""
    fields = [
        FieldSpec("vehicle_id", "int", 0, 2 ** 31),
        FieldSpec("ts", "timestamp"),
        FieldSpec("location", "latlon", low=-84.8, high=41.5),  # Ohio-ish box
        FieldSpec("speed_kph", "float", 0, 200),
    ]
    for s in range(subsystems):
        for i in range(floats_per_subsystem):
            fields.append(FieldSpec(f"sub{s}_ch{i}", "float", -1e3, 1e3))
    return Schema("automotive-telemetry", tuple(fields))


def token_stream_schema(vocab_size: int, seq_len: int) -> Schema:
    """LM pipeline ingest: one record == one sequence of token ids."""
    return Schema(f"tokens-v{vocab_size}-s{seq_len}",
                  (FieldSpec("tokens", "tokens", vocab_size=vocab_size,
                             length=seq_len),))
