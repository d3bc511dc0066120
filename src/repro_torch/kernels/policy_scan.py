"""Wrappers of the policy-scan kernels (``csrc/policy_scan.cu``).

Counterpart: ``repro.kernels.policy_scan`` (the Pallas kernels
``_policy_scan_kernel``, ``_policy_agg_kernel`` and
``_policy_agg_fault_kernel``). Same operands, same outputs:

* ``policy_grid_scan`` — carry_end [N, CARRY_DIM] and five [N, T] series
  (processed, queue, latency, cost, dropped);
* ``policy_grid_agg`` — carry_end [N, CARRY_DIM] and the Table II
  aggregate rows [N, AGG_DIM], no series at all.

Loads come either as ``loads`` [N, T] or as ``loads_t`` [T, K], the
scenario-minor matrix of K distinct load rows, with ``load_index`` [N]
naming each scenario's row (identity when omitted); the kernels read
through the index, so a (twin x traffic) grid never stages an [N, T] panel.
A fault schedule comes the same way: ``caps_t`` (and, for the aggregate
scan, ``fmask_t``) [T, F] hold F fault rows scenario-minor, and
``fault_index`` [N] names each scenario's row; they select the fault
kernels, which run the fault layer of ``core.twin`` (the backlog folds
into ``carry_end[:, 0]``).

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``. A
tensor on a CUDA device goes to the kernel, or the call raises: there is
no fallback. The kernels run only the five built-in policies; a one-hot
row that selects any other policy, or is not a one-hot row, raises. Each
kernel launch adds one to ``launches[<kernel>]``, and nothing else does.
``shed_fuse`` (a ``core.twin.SHED_FUSE_*`` level) picks the rounding of
shed under the fault layer; the defaults are the mixed-policy scans'.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.twin import (AGG_HIST_BINS, AGG_SCALARS, CARRY_DIM,
                                   PARAM_DIM, SHED_FUSE_DROP,
                                   SHED_FUSE_LATENCY, finalize_aggregate,
                                   kernel_branches, num_policies,
                                   policy_names)
from repro_torch.kernels import build, ref

#: kernel launches since the last ``reset_launches()``
launches = {"policy_scan": 0, "policy_agg": 0, "policy_scan_fault": 0,
            "policy_agg_fault": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def gather_loads(loads, loads_t, load_index) -> torch.Tensor:
    """The [N, T] per-scenario loads of either operand form (the plain
    versions' input)."""
    if (loads is None) == (loads_t is None):
        raise ValueError("pass exactly one of loads= ([N, T]) or "
                         "loads_t= ([T, K] scenario-minor)")
    if loads is not None:
        return loads if load_index is None else loads[load_index.long()]
    cols = loads_t if load_index is None else loads_t[:, load_index.long()]
    return cols.t()


def gather_rows(matrix_t, index):
    """[N, T] rows of a [T, F] scenario-minor matrix through ``index``
    (identity when None): the plain versions' fault operands."""
    if matrix_t is None:
        return None
    return (matrix_t if index is None else matrix_t[:, index.long()]).t()


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = build.load("policy_scan")
    if not getattr(lib, "bound", False):
        lib.bound = True
        lib.policy_agg_launch.argtypes = [_P, _I, _I, _P, _P, _P, _I, _F,
                                          _F, _I, _P, _P, _P, _P]
        lib.policy_agg_launch.restype = _I
        lib.policy_scan_launch.argtypes = [_P, _I, _I, _P, _P, _P, _I, _F,
                                           _P, _P, _P]
        lib.policy_scan_launch.restype = _I
        lib.policy_agg_fault_launch.argtypes = [_P, _I, _I, _P, _P, _P, _I,
                                                _P, _P, _P, _I, _F, _F, _I,
                                                _I, _P, _P, _P, _P]
        lib.policy_agg_fault_launch.restype = _I
        lib.policy_scan_fault_launch.argtypes = [_P, _I, _I, _P, _P, _I, _P,
                                                 _P, _P, _I, _F, _I, _P, _P,
                                                 _P]
        lib.policy_scan_fault_launch.restype = _I
        lib.policy_error_string.argtypes = [_I]
        lib.policy_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, rc: int, what: str):
    if rc:
        msg = lib.policy_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _kernel_branch_index(onehot: torch.Tensor) -> torch.Tensor:
    """[N] int32 kernel branch per scenario from the [N, P] one-hot mask
    (-1 for an all-zero row, which the blend turns into zeros). Raises for
    a row that is not one-hot or selects a policy without a kernel
    branch."""
    table = torch.tensor([-2 if b is None else b for b in kernel_branches()],
                         dtype=torch.int32, device=onehot.device)
    rows = onehot.sum(dim=1)
    col = onehot.argmax(dim=1)
    branch = torch.where(rows > 0, table[col], -1)
    bad = ~(((onehot == 0) | (onehot == 1)).all(dim=1) & (rows <= 1))
    if bool((bad | (branch == -2)).any()):
        if bool(bad.any()):
            raise ValueError("onehot rows must be one-hot (a single 1.0) "
                             "or all zeros for the CUDA kernels")
        names = sorted({policy_names()[c] for c in
                        col[branch == -2].unique().tolist()})
        raise NotImplementedError(
            f"policies {names} have no CUDA kernel branch; the kernels run "
            f"the built-ins only (run them with device='cpu')")
    return branch.to(torch.int32).contiguous()


def _cuda_operands(loads, loads_t, load_index, params, onehot):
    """Validate the CUDA operands; returns (matrix_t [T, K], index [N]
    int32, branch [N] int32, n, t_bins, k_rows)."""
    dev = params.device
    if (loads is None) == (loads_t is None):
        raise ValueError("pass exactly one of loads= ([N, T]) or "
                         "loads_t= ([T, K] scenario-minor)")
    if loads is not None:
        if loads.dim() != 2:
            raise ValueError(f"loads must be [N, T], got {tuple(loads.shape)}")
        _require(loads, dev, "loads")
        matrix_t = loads.t().contiguous()
    else:
        if loads_t.dim() != 2:
            raise ValueError(f"loads_t must be [T, K], got "
                             f"{tuple(loads_t.shape)}")
        _require(loads_t, dev, "loads_t")
        matrix_t = loads_t
    t_bins, k_rows = matrix_t.shape
    n = params.shape[0]
    if params.dim() != 2 or params.shape[1] != PARAM_DIM:
        raise ValueError(f"params must be [N, {PARAM_DIM}], got "
                         f"{tuple(params.shape)}")
    _require(params, dev, "params")
    if onehot.shape != (n, num_policies()):
        raise ValueError(f"onehot must be [{n}, {num_policies()}], got "
                         f"{tuple(onehot.shape)}")
    _require(onehot, dev, "onehot")
    index = _row_index(load_index, n, k_rows, dev, "load")
    return (matrix_t, index, _kernel_branch_index(onehot), n, t_bins,
            k_rows)


def _row_index(index, n: int, rows: int, dev, what: str):
    """[n] int32 row index on ``dev`` (identity when None), range-checked
    against ``rows``."""
    if index is None:
        if rows != n:
            raise ValueError(f"{rows} {what} rows for {n} scenarios need "
                             f"an index")
        return torch.arange(n, dtype=torch.int32, device=dev)
    if index.shape != (n,) or index.device != dev:
        raise ValueError(f"{what} index must be [{n}] on {dev}")
    index = index.to(torch.int32).contiguous()
    if n and not bool((index.min() >= 0) & (index.max() < rows)):
        raise ValueError(f"{what} index out of range for {rows} rows")
    return index


def _fault_operands(caps_t, fmask_t, fault_index, n: int, t_bins: int,
                    dev):
    """Validate the CUDA fault operands; returns (f_rows, fault index [N]
    int32)."""
    for x, what in ((caps_t, "caps_t"), (fmask_t, "fmask_t")):
        if x is None:
            continue
        if x.dim() != 2 or x.shape[0] != t_bins:
            raise ValueError(f"{what} must be [{t_bins}, F], got "
                             f"{tuple(x.shape)}")
        _require(x, dev, what)
    if fmask_t is not None and fmask_t.shape != caps_t.shape:
        raise ValueError(f"fmask_t {tuple(fmask_t.shape)} and caps_t "
                         f"{tuple(caps_t.shape)} must match")
    f_rows = caps_t.shape[1]
    return f_rows, _row_index(fault_index, n, f_rows, dev, "fault")


def _require(x: torch.Tensor, dev: torch.device, what: str):
    if x.device != dev:
        raise ValueError(f"{what} is on {x.device}, params on {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def policy_grid_scan(loads, params, onehot, dt_hours: float = 1.0, *,
                     loads_t=None, load_index=None, caps_t=None,
                     fault_index=None, shed_fuse: int = SHED_FUSE_DROP):
    """Scenario-grid scan with per-bin series; semantics of
    ``ref.policy_grid_scan`` (with ``caps=`` when ``caps_t`` is given).
    Returns (carry_end [N, CARRY_DIM], (processed, queue, latency, cost,
    dropped)), each series [N, T] (a transposed view of the kernel's
    scenario-minor [T, N] output)."""
    fault = caps_t is not None
    if not params.is_cuda:
        return ref.policy_grid_scan(gather_loads(loads, loads_t, load_index),
                                    params, onehot, dt_hours,
                                    caps=gather_rows(caps_t, fault_index),
                                    shed_fuse=shed_fuse)
    matrix_t, index, branch, n, t_bins, k_rows = _cuda_operands(
        loads, loads_t, load_index, params, onehot)
    dev = params.device
    if fault:
        f_rows, findex = _fault_operands(caps_t, None, fault_index, n,
                                         t_bins, dev)
    carry_end = torch.empty((n, CARRY_DIM), dtype=torch.float32, device=dev)
    series = torch.empty((5, t_bins, n), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fault:
            rc = lib.policy_scan_fault_launch(
                matrix_t.data_ptr(), k_rows, t_bins, index.data_ptr(),
                caps_t.data_ptr(), f_rows, findex.data_ptr(),
                params.data_ptr(), branch.data_ptr(), n, float(dt_hours),
                int(shed_fuse), carry_end.data_ptr(), series.data_ptr(),
                stream)
        else:
            rc = lib.policy_scan_launch(
                matrix_t.data_ptr(), k_rows, t_bins, index.data_ptr(),
                params.data_ptr(), branch.data_ptr(), n, float(dt_hours),
                carry_end.data_ptr(), series.data_ptr(), stream)
    name = "policy_scan_fault" if fault else "policy_scan"
    _check(lib, rc, name)
    launches[name] += 1
    return carry_end, tuple(series[k].t() for k in range(5))


def policy_grid_agg(loads, params, onehot, dt_hours: float = 1.0, *,
                    slo_limit: float = float("inf"), slo_mode: int = 0,
                    loads_t=None, load_index=None, caps_t=None,
                    fmask_t=None, fault_index=None,
                    shed_fuse: int = SHED_FUSE_LATENCY):
    """Streaming-aggregate scenario-grid scan; semantics of
    ``ref.policy_grid_agg`` (with ``caps=``/``fmask=`` when ``caps_t`` and
    ``fmask_t`` are given). ``slo_limit`` is compared in float32 against
    the stream ``slo_mode`` selects (``core.twin.AGG_SLO_*``). Returns
    (carry_end [N, CARRY_DIM], agg [N, AGG_DIM]): the kernel's raw rows
    with each histogram bucket's compensated triple recombined in f64."""
    if (caps_t is None) != (fmask_t is None):
        raise ValueError("pass caps_t= and fmask_t= together (or neither)")
    fault = caps_t is not None
    if not params.is_cuda:
        return ref.policy_grid_agg(gather_loads(loads, loads_t, load_index),
                                   params, onehot, dt_hours,
                                   slo_limit=slo_limit, slo_mode=slo_mode,
                                   caps=gather_rows(caps_t, fault_index),
                                   fmask=gather_rows(fmask_t, fault_index),
                                   shed_fuse=shed_fuse)
    matrix_t, index, branch, n, t_bins, k_rows = _cuda_operands(
        loads, loads_t, load_index, params, onehot)
    dev = params.device
    if fault:
        f_rows, findex = _fault_operands(caps_t, fmask_t, fault_index, n,
                                         t_bins, dev)
    # the kernel runs the scenarios in policy order, so that nearly every
    # warp's 32 run one policy (and take that policy's own scan, with no
    # switch per bin); the rows go back to the caller's order at the end
    order = torch.argsort(branch, stable=True)
    params, index, branch = (x[order].contiguous()
                             for x in (params, index, branch))
    if fault:
        findex = findex[order].contiguous()
    carry_end = torch.empty((n, CARRY_DIM), dtype=torch.float32, device=dev)
    scal = torch.empty((AGG_SCALARS, n), dtype=torch.float32, device=dev)
    # [152, N, 4]: each bucket's compensated triple, padded to 16 bytes
    hist = torch.zeros((AGG_HIST_BINS, n, 4), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fault:
            rc = lib.policy_agg_fault_launch(
                matrix_t.data_ptr(), k_rows, t_bins, index.data_ptr(),
                caps_t.data_ptr(), fmask_t.data_ptr(), f_rows,
                findex.data_ptr(), params.data_ptr(), branch.data_ptr(), n,
                float(dt_hours), float(slo_limit), int(slo_mode),
                int(shed_fuse), carry_end.data_ptr(), scal.data_ptr(),
                hist.data_ptr(), stream)
        else:
            rc = lib.policy_agg_launch(
                matrix_t.data_ptr(), k_rows, t_bins, index.data_ptr(),
                params.data_ptr(), branch.data_ptr(), n, float(dt_hours),
                float(slo_limit), int(slo_mode), carry_end.data_ptr(),
                scal.data_ptr(), hist.data_ptr(), stream)
    name = "policy_agg_fault" if fault else "policy_agg"
    _check(lib, rc, name)
    launches[name] += 1
    packed = torch.cat([scal.t(),
                        hist[..., :3].permute(1, 2, 0).reshape(n, -1)], dim=1)
    back = torch.empty_like(order)
    back[order] = torch.arange(n, device=dev)
    return carry_end[back], finalize_aggregate(packed)[back]
