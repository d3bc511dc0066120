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

The serving model's state is its parameter dict: ``model_params_from_arrays``
takes the JAX package's (as numpy arrays, with its flat ``stack.blk{i}.…``
names and the leading ``groups`` axis, which the port shares) and returns
the port's, checked leaf for leaf against the port's schema. Training adds
the optimizer's state: ``opt_state_from_arrays`` takes the reference's
``OptState`` fields as numpy arrays (step, moments of float32, bfloat16 or
int8, and the int8 moments' per-block scales) and returns the port's.
(Checkpoints carry both across as files: ``repro_torch.checkpoint`` reads
and writes the reference's layout.)
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.twin import (PARAM_DIM, Twin, policy_names,
                                   policy_onehot, policy_spec)
from repro_torch.device import resolve_device
from repro_torch.faults import ReplayTerm, SampledFaults, validate_sampled
from repro_torch.models.model import full_schema
from repro_torch.optim.adamw import OptState


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


def model_params_from_arrays(arrays: Dict[str, np.ndarray], cfg: ModelConfig,
                             device="cuda") -> Dict[str, torch.Tensor]:
    """The port's parameters from the reference's: every leaf of the
    port's schema for ``cfg``, with its shape, and no other, as a tensor
    of ``cfg.param_dtype`` on ``device`` (values unchanged)."""
    dev = resolve_device(device)
    schema = full_schema(cfg)
    if set(arrays) != set(schema):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(schema) - set(arrays))}, unexpected "
                         f"{sorted(set(arrays) - set(schema))}")
    dtype = getattr(torch, cfg.param_dtype)
    out = {}
    for name, d in schema.items():
        a = np.asarray(arrays[name])
        if a.shape != d.shape:
            raise ValueError(f"{name}: shape {a.shape}, schema {d.shape}")
        out[name] = torch.from_numpy(np.array(a, np.float32)).to(
            device=dev, dtype=dtype)
    return out


def _tensor(a, dev) -> torch.Tensor:
    """A numpy array as a tensor of its dtype (bfloat16, which numpy
    holds as ml_dtypes', through float32: exact)."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def opt_state_from_arrays(step, m: Dict[str, np.ndarray],
                          v: Dict[str, np.ndarray],
                          m_scale: Dict[str, np.ndarray] = None,
                          v_scale: Dict[str, np.ndarray] = None,
                          device="cuda") -> OptState:
    """The port's ``OptState`` from the reference's fields as numpy
    arrays, values and dtypes unchanged: ``step`` (int32), the moments
    ``m`` and ``v`` keyed as the parameters, and for int8 moments their
    per-block scales (the same keys)."""
    dev = resolve_device(device)
    m_scale, v_scale = m_scale or {}, v_scale or {}
    if set(m) != set(v) or set(m_scale) != set(v_scale) or (
            m_scale and set(m_scale) != set(m)):
        raise ValueError("m, v (and the scales, when given) must have the "
                         "same keys")
    return OptState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
        {k: _tensor(x, dev) for k, x in m.items()},
        {k: _tensor(x, dev) for k, x in v.items()},
        {k: _tensor(x, dev) for k, x in m_scale.items()},
        {k: _tensor(x, dev) for k, x in v_scale.items()})
