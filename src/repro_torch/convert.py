"""Carry the reference's state across into the port.

The what-if engine has no trained weights: its state is the grid the JAX
package builds in numpy — padded twin parameters [N, PARAM_DIM], policy
indices [N] (positions in the reference's ``policy_names()``), a load
matrix [K, T] and a load index [N] — and, for a chaos suite, the sampled
fault futures. ``twins_from_arrays`` rebuilds the port's ``Twin`` records
from them and ``grid_tensors`` moves them onto a device in the layout the
kernels take. Both first check that the reference's policy order is the
port's, so an index means the same policy on both sides.
``sampled_faults_from_arrays`` rebuilds the port's ``SampledFaults`` from
the reference's fault arrays.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.twin import (PARAM_DIM, Twin, policy_names,
                                   policy_onehot, policy_spec)
from repro_torch.device import resolve_device
from repro_torch.faults import ReplayTerm, SampledFaults, validate_sampled


def check_policy_order(reference_names: Sequence[str]):
    """Raise unless the reference's registry order is the port's (the
    built-ins: fifo 0, quickscale 1, autoscale 2, shed 3, batch_window 4)."""
    if list(reference_names) != policy_names():
        raise ValueError(f"policy order differs: reference "
                         f"{list(reference_names)}, port {policy_names()}")


def twins_from_arrays(params: np.ndarray, policy_idx: np.ndarray,
                      names: Sequence[str],
                      reference_names: Sequence[str]) -> List[Twin]:
    """Port ``Twin``s from the reference's padded parameter rows; each
    twin's ``padded_params()`` gives its row back bit for bit."""
    check_policy_order(reference_names)
    params = np.asarray(params, np.float32)
    idx = np.asarray(policy_idx)
    if params.shape != (len(idx), PARAM_DIM) or len(names) != len(idx):
        raise ValueError(f"params {params.shape}, policy_idx {idx.shape} "
                         f"and {len(names)} names do not describe one grid")
    twins = []
    for name, row, i in zip(names, params, idx):
        spec = policy_spec(reference_names[int(i)])
        k = len(spec.param_names)
        if np.any(row[k:] != 0):
            raise ValueError(f"{name}: {spec.name} takes {k} parameters "
                             f"but its row pads with {row[k:]}")
        twins.append(Twin(name=name, policy=spec.name,
                          params=tuple(float(v) for v in row[:k])))
    return twins


def grid_tensors(load_matrix: np.ndarray, load_index: np.ndarray,
                 params: np.ndarray, policy_idx: np.ndarray,
                 reference_names: Sequence[str],
                 device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's grid arrays as the kernels' operands on ``device``:
    ``loads_t`` [T, K] scenario-minor, ``load_index`` [N] int32,
    ``params`` [N, PARAM_DIM] and ``onehot`` [N, P] float32."""
    check_policy_order(reference_names)
    dev = resolve_device(device)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return {
        "loads_t": as_t(np.asarray(load_matrix, np.float32).T),
        "load_index": as_t(np.asarray(load_index, np.int32)),
        "params": as_t(np.asarray(params, np.float32)),
        "onehot": as_t(policy_onehot(policy_idx)),
    }


def sampled_faults_from_arrays(cap: np.ndarray, mask: np.ndarray,
                               load_mult: np.ndarray,
                               replay: Sequence[Sequence[Tuple[np.ndarray,
                                                               np.ndarray]]],
                               events: Sequence[Sequence[Dict]],
                               t_bins: int, bin_hours: float,
                               seed: int) -> SampledFaults:
    """The port's ``SampledFaults`` from the reference's: ``cap`` and
    ``mask`` [F, T] (float32), ``load_mult`` [F, T] (float64), per future
    the (removed, profile) [T] arrays of its replay terms and its event
    records. Validated as ``simulate_grid`` would (a bad bin raises
    ``ValueError`` naming the spec)."""
    cap = np.array(cap, np.float32)
    f = cap.shape[0]
    if len(replay) != f or len(events) != f:
        raise ValueError(f"{f} futures in cap but {len(replay)} replay "
                         f"and {len(events)} event lists")
    sampled = SampledFaults(
        cap=cap, mask=np.array(mask, np.float32),
        load_mult=np.array(load_mult, np.float64),
        replay=tuple(tuple(ReplayTerm(removed=np.array(r, np.float64),
                                      profile=np.array(q, np.float64))
                           for r, q in terms) for terms in replay),
        events=tuple(tuple(dict(e) for e in evs) for evs in events),
        n_futures=f, t_bins=int(t_bins), bin_hours=float(bin_hours),
        seed=int(seed))
    if sampled.mask.shape != cap.shape:
        raise ValueError(f"mask {sampled.mask.shape} and cap {cap.shape} "
                         f"must match")
    return validate_sampled(sampled)
