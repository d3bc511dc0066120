"""Expand sampled fault futures into the matrix+index grid representation.

Counterpart: ``repro.faults.grid``, copied without its ``repro.obs`` span
and counters (the port has no run telemetry yet).

The aggregate grid engine (``core/simulate.py``) runs N scenarios as a
[K, T] load matrix plus an [N] row index. ``expand_grid`` lifts that
representation to faults: N base scenarios x F futures become N*F grid
rows ordered **scenario-major, future-minor** (row ``i*F + f`` plays
base scenario i under future f — the ordering the chance-constrained
search relies on to reshape result lanes to [..., S, F]).

Load perturbations are baked into new matrix rows; capacity and
in-fault-mask series stay as separate small [F, T] matrices indexed by
a per-row ``fault_index`` so a 65k-row chaos grid carries F extra rows
of fault state, not 65k. Futures that do not touch the load (outage /
brownout only) alias the *original* matrix rows — the benign-future
path literally reads the same memory as the pre-fault grid, which is
how empty-schedule bit-parity is guaranteed structurally rather than
numerically.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .sampler import SampledFaults


def _named_bad_load(row: np.ndarray, sampled: SampledFaults, future: int,
                    base_row: int):
    bad = ~np.isfinite(row) | (row < 0)
    if not bad.any():
        return
    bin_ix = int(np.argmax(bad))
    culprit = "unknown fault"
    for ev in sampled.events[future]:
        if ev["start"] <= bin_ix < max(ev["end"], ev.get("flood_end", 0)):
            culprit = f"fault spec {ev['spec']!r} ({ev['kind']})"
            break
    val = row[bin_ix]
    raise ValueError(
        f"perturbed load series for base row {base_row}, future {future} "
        f"is {'negative' if np.isfinite(val) else 'non-finite'} at bin "
        f"{bin_ix}: {culprit} produced {val!r}")


@dataclass(frozen=True)
class FaultGrid:
    """A faulted grid: expanded load rows + per-row fault series indices.

    ``load_matrix`` [K', T] / ``load_index`` [N*F] drive the same grid
    engines as before; ``cap`` / ``fmask`` [F, T] are gathered per row
    through ``fault_index`` [N*F] exactly like load rows are gathered
    through ``load_index``.
    """
    load_matrix: np.ndarray     # [K', T] — base rows first, then faulted
    load_index: np.ndarray      # [N*F] int32 row index into load_matrix
    cap: np.ndarray             # [F, T] f32 capacity multipliers
    fmask: np.ndarray           # [F, T] f32 in-fault indicators
    fault_index: np.ndarray     # [N*F] int32 row index into cap/fmask
    n_futures: int
    n_base: int                 # N: base scenario count before expansion
    sampled: SampledFaults

    @property
    def n_rows(self) -> int:
        return self.load_index.shape[0]


def benign_futures(sampled: SampledFaults) -> np.ndarray:
    """[F] bool — futures that perturb NOTHING: no load fault, no
    capacity fault, and no fault-window mask (a masked-but-harmless
    window still changes the A_FLTH/A_FOKH attribution counters, so it
    is not benign). Every benign future plays a base scenario through
    the identical fault-free dynamics, so the grid dispatcher simulates
    ONE benign representative per scenario and replicates its summary
    row instead of re-scanning the same year F-benign times."""
    return (~sampled.has_load_faults
            & ~sampled.has_capacity_faults
            & ~np.any(np.asarray(sampled.mask) != 0.0, axis=1))


def expand_grid(sampled: SampledFaults, load_matrix: np.ndarray,
                load_index: np.ndarray) -> FaultGrid:
    """Expand (load_matrix [K,T], load_index [N]) by F fault futures.

    Perturbed load rows are deduplicated per (base row, future): two
    scenarios sharing a base matrix row also share its faulted variants.
    Rows whose future leaves loads untouched reuse the base row
    untouched. Perturbed series that come out negative or NaN raise
    ``ValueError`` naming the fault spec and bin index.
    """
    load_matrix = np.asarray(load_matrix)
    load_index = np.asarray(load_index)
    k, t = load_matrix.shape
    if t != sampled.t_bins:
        raise ValueError(f"fault futures were sampled over "
                         f"{sampled.t_bins} bins but the load matrix has "
                         f"{t} bins")
    F = sampled.n_futures
    n = load_index.shape[0]
    touches_load = sampled.has_load_faults      # [F] bool

    rows = [load_matrix]                        # base rows keep indices 0..K-1
    next_row = k
    # row_of[k_base, f] -> row index in the expanded matrix
    row_of = np.tile(np.arange(k, dtype=np.int64)[:, None], (1, F))
    used_base = np.unique(load_index)
    for kb in used_base:
        base_row = load_matrix[kb]
        faulted = None
        for f in range(F):
            if not touches_load[f]:
                continue
            if faulted is None:                 # lazy: one apply per row
                faulted = sampled.apply_loads(base_row)
            _named_bad_load(faulted[f], sampled, f, int(kb))
            rows.append(faulted[f][None, :])
            row_of[kb, f] = next_row
            next_row += 1

    expanded = np.concatenate(rows, axis=0) if len(rows) > 1 else load_matrix
    new_index = row_of[load_index].reshape(-1).astype(np.int32)   # [N*F]
    fault_index = np.tile(np.arange(F, dtype=np.int32), n)        # [N*F]
    return FaultGrid(load_matrix=expanded, load_index=new_index,
                     cap=np.asarray(sampled.cap, dtype=np.float32),
                     fmask=np.asarray(sampled.mask, dtype=np.float32),
                     fault_index=fault_index, n_futures=F, n_base=n,
                     sampled=sampled)
