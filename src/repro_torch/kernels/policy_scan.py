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
no fallback. The kernels run the five built-in policies
(``PolicySpec.kernel_branch``) and every policy added with
``register_policy`` (an override of a built-in included), whose lane step
``kernels/lane_codegen.py`` translates into a device function of a
library built for the registry (``lane_codegen.generated()``); a row
whose step has no CUDA form, or that is not a one-hot row, raises, and so
does a launch in which a registered step divided an integer by zero (the
CPU's ``RuntimeError: ZeroDivisionError``, read back after it). Each
kernel launch adds one to ``launches[<kernel>]``, and nothing else does;
``registered_rows[<kernel>]`` counts the scenarios a launch ran through a
registered policy's generated step.
``shed_fuse`` (a ``core.twin.SHED_FUSE_*`` level) picks the rounding of
shed under the fault layer; the defaults are the mixed-policy scans'.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.twin import (AGG_HIST_BINS, AGG_SCALARS, CARRY_DIM,
                                   PARAM_DIM, SHED_FUSE_DROP,
                                   SHED_FUSE_LATENCY, finalize_aggregate,
                                   num_policies, policy_names)
from repro_torch.kernels import build, lane_codegen, ref

#: kernel launches since the last ``reset_launches()``
launches = {"policy_scan": 0, "policy_agg": 0, "policy_scan_fault": 0,
            "policy_agg_fault": 0}
#: scenarios run through a registered policy's generated step since the
#: last ``reset_launches()``, by kernel (read back with the checks, and
#: only while a policy is registered)
registered_rows = {k: 0 for k in launches}


def reset_launches():
    for counts in (launches, registered_rows):
        for k in counts:
            counts[k] = 0


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


def _lib(generated=None):
    """The kernels' library: the plain build, or with ``generated`` (the
    header of the registry's steps) the one built for it."""
    lib = build.load("policy_scan", generated)
    if not getattr(lib, "bound", False):
        lib.bound = True
        lib.policy_agg_launch.argtypes = [_P, _I, _I, _P, _P, _P, _I, _F,
                                          _F, _I, _P, _P, _P, _P]
        lib.policy_agg_launch.restype = _I
        lib.policy_scan_launch.argtypes = [_P, _I, _I, _P, _P, _P, _P, _I,
                                           _F, _P, _P, _P]
        lib.policy_scan_launch.restype = _I
        lib.policy_agg_fault_launch.argtypes = [_P, _I, _I, _P, _P, _P, _I,
                                                _P, _P, _P, _I, _F, _F, _I,
                                                _I, _P, _P, _P, _P]
        lib.policy_agg_fault_launch.restype = _I
        lib.policy_scan_fault_launch.argtypes = [_P, _I, _I, _P, _P, _I, _P,
                                                 _P, _P, _P, _I, _F, _I, _P,
                                                 _P, _P]
        lib.policy_scan_fault_launch.restype = _I
        lib.policy_div_flag_take.argtypes = [_P, _P]
        lib.policy_div_flag_take.restype = _I
        lib.policy_error_string.argtypes = [_I]
        lib.policy_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, rc: int, what: str):
    if rc:
        msg = lib.policy_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


#: [P + 1] int32 per device and policy registry: entry 0 is -1 (an
#: all-zero row), entry p + 1 policy p's kernel branch (``lane_codegen``'s
#: ``Generated.branches``: built-in, generated or ``REFUSED``).
#: Made once: a table copied from the host at each call would wait for
#: the work already queued on the card, as a read-back does.
_BRANCH_TABLES = {}


def _branch_table(dev) -> torch.Tensor:
    branches = lane_codegen.generated().branches
    table = _BRANCH_TABLES.get((dev, branches))
    if table is None:
        table = torch.tensor([-1, *branches], dtype=torch.int32, device=dev)
        _BRANCH_TABLES[(dev, branches)] = table
    return table


def _zero_divisor_check(lib, dev, stream):
    """After a launch of a library whose registered steps divide
    integers: read back and clear the kernel's zero-divisor flag, and
    raise the CPU's ``RuntimeError: ZeroDivisionError`` where a row
    divided by zero (its results are dropped)."""
    if not lane_codegen.generated().int_div:
        return
    flag = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):            # the flag is per device
        _check(lib, lib.policy_div_flag_take(flag.data_ptr(), stream),
               "zero-divisor flag")
    _raise_failed([(flag != 0, lambda: RuntimeError("ZeroDivisionError"))])


def _raise_failed(checks, count=None):
    """Raise the error of the first failing check: (flag, error) pairs,
    each flag a 0-dim bool tensor, all read back in one copy, with
    ``count`` (a 0-dim integer tensor, or None) beside them. Returns the
    count as an int (0 for None)."""
    if count is None:
        values = [flag for flag, _ in checks]
    else:
        values = [flag.to(torch.int64) for flag, _ in checks] + [count]
    if not values:
        return 0
    got = torch.stack(values).tolist()
    for failed, (_, error) in zip(got, checks):
        if failed:
            raise error()
    return got[-1] if count is not None else 0


def _registered_count(branch: torch.Tensor):
    """The 0-dim count of rows that run a generated step, or None when
    no policy is registered (then nothing is added to the read-back)."""
    if lane_codegen.generated().header is None:
        return None
    return (branch >= lane_codegen.FIRST_GENERATED).sum()


def _defer_or_raise(checks, flag, error):
    """Add a check to ``checks``, or, with none, run it now."""
    if checks is None:
        _raise_failed([(flag, error)])
    else:
        checks.append((flag, error))


def _kernel_branch_index(onehot: torch.Tensor, checks=None) -> torch.Tensor:
    """[N] int32 kernel branch per scenario from the [N, P] one-hot mask
    (-1 for an all-zero row, which the blend turns into zeros; a
    registered policy's generated branch). A row that is not one-hot, or
    selects a registered policy whose step has no CUDA form, raises: here,
    or where ``checks`` are read when a list is passed."""
    rows = onehot.sum(dim=1)
    col = onehot.argmax(dim=1)
    branch = _branch_table(onehot.device)[torch.where(rows > 0, col + 1, 0)]
    bad = ~(((onehot == 0) | (onehot == 1)).all(dim=1) & (rows <= 1))
    _defer_or_raise(checks, bad.any(), lambda: ValueError(
        "onehot rows must be one-hot (a single 1.0) or all zeros for the "
        "CUDA kernels"))
    refused = lane_codegen.generated().refused
    if refused:
        def no_branch():
            names = sorted({policy_names()[c] for c in
                            col[branch == lane_codegen.REFUSED]
                            .unique().tolist()})
            why = "; ".join(f"{k}: {refused[k]}" for k in names)
            return NotImplementedError(
                f"policies {names} have no CUDA form ({why}); run them "
                f"with device='cpu'")
        _defer_or_raise(checks, (branch == lane_codegen.REFUSED).any(),
                        no_branch)
    return branch


def policy_order(branch: torch.Tensor):
    """The order the kernels run the scenarios in: sorted by policy,
    stable within a policy, so that nearly every warp's 32 run one policy
    and take that policy's own scan, with no switch per bin. Returns
    (``order`` [N] int64, ``dest`` [N] int32): the kernel's scenario j is
    the caller's ``order[j]`` (its operands are ``x[order]``), and a series
    kernel writes scenario j's outputs to the caller's column ``dest[j]``,
    so they come back in the caller's order with no gather."""
    order = torch.argsort(branch, stable=True)
    return order, order.to(torch.int32)


def _cuda_operands(loads, loads_t, load_index, params, onehot, checks):
    """Validate the CUDA operands (the checks that read the card are added
    to ``checks``); returns (matrix_t [T, K], index [N] int32, branch [N]
    int32, n, t_bins, k_rows)."""
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
    index = _row_index(load_index, n, k_rows, dev, "load", checks)
    return (matrix_t, index, _kernel_branch_index(onehot, checks), n,
            t_bins, k_rows)


def _row_index(index, n: int, rows: int, dev, what: str, checks=None):
    """[n] int32 row index on ``dev`` (identity when None), range-checked
    against ``rows`` (here, or where ``checks`` are read)."""
    if index is None:
        if rows != n:
            raise ValueError(f"{rows} {what} rows for {n} scenarios need "
                             f"an index")
        return torch.arange(n, dtype=torch.int32, device=dev)
    if index.shape != (n,) or index.device != dev:
        raise ValueError(f"{what} index must be [{n}] on {dev}")
    index = index.to(torch.int32).contiguous()
    if n:
        lo, hi = torch.aminmax(index)
        _defer_or_raise(checks, (lo < 0) | (hi >= rows), lambda: ValueError(
            f"{what} index out of range for {rows} rows"))
    return index


def _fault_operands(caps_t, fmask_t, fault_index, n: int, t_bins: int,
                    dev, checks=None):
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
    return f_rows, _row_index(fault_index, n, f_rows, dev, "fault", checks)


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
    scenario-minor [T, N] output). The kernel runs the scenarios in policy
    order (``policy_order``) and writes each one's series and end carry
    to its caller's column and row."""
    fault = caps_t is not None
    if not params.is_cuda:
        return ref.policy_grid_scan(gather_loads(loads, loads_t, load_index),
                                    params, onehot, dt_hours,
                                    caps=gather_rows(caps_t, fault_index),
                                    shed_fuse=shed_fuse)
    checks = []
    matrix_t, index, branch, n, t_bins, k_rows = _cuda_operands(
        loads, loads_t, load_index, params, onehot, checks)
    dev = params.device
    if fault:
        f_rows, findex = _fault_operands(caps_t, None, fault_index, n,
                                         t_bins, dev, checks)
    order, dest = policy_order(branch)
    params, index, branch = (x[order] for x in (params, index, branch))
    if fault:
        findex = findex[order]
    carry_end = torch.empty((n, CARRY_DIM), dtype=torch.float32, device=dev)
    series = torch.empty((5, t_bins, n), dtype=torch.float32, device=dev)
    # read back once, with all of the above queued: the card runs it
    # while the host waits, right after the work queued before this call
    n_reg = _raise_failed(checks, _registered_count(branch))
    lib = _lib(lane_codegen.generated().header)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fault:
            rc = lib.policy_scan_fault_launch(
                matrix_t.data_ptr(), k_rows, t_bins, index.data_ptr(),
                caps_t.data_ptr(), f_rows, findex.data_ptr(),
                params.data_ptr(), branch.data_ptr(), dest.data_ptr(), n,
                float(dt_hours), int(shed_fuse), carry_end.data_ptr(),
                series.data_ptr(), stream)
        else:
            rc = lib.policy_scan_launch(
                matrix_t.data_ptr(), k_rows, t_bins, index.data_ptr(),
                params.data_ptr(), branch.data_ptr(), dest.data_ptr(), n,
                float(dt_hours), carry_end.data_ptr(), series.data_ptr(),
                stream)
    name = "policy_scan_fault" if fault else "policy_scan"
    _check(lib, rc, name)
    launches[name] += 1
    registered_rows[name] += n_reg
    _zero_divisor_check(lib, dev, stream)
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
    checks = []
    matrix_t, index, branch, n, t_bins, k_rows = _cuda_operands(
        loads, loads_t, load_index, params, onehot, checks)
    dev = params.device
    if fault:
        f_rows, findex = _fault_operands(caps_t, fmask_t, fault_index, n,
                                         t_bins, dev, checks)
    # the kernel runs the scenarios in policy order; its few rows go back
    # to the caller's order at the end
    order, _ = policy_order(branch)
    params, index, branch = (x[order] for x in (params, index, branch))
    if fault:
        findex = findex[order]
    carry_end = torch.empty((n, CARRY_DIM), dtype=torch.float32, device=dev)
    scal = torch.empty((AGG_SCALARS, n), dtype=torch.float32, device=dev)
    # [152, N, 4]: each bucket's compensated triple, padded to 16 bytes
    hist = torch.zeros((AGG_HIST_BINS, n, 4), dtype=torch.float32,
                       device=dev)
    n_reg = _raise_failed(checks, _registered_count(branch))
    lib = _lib(lane_codegen.generated().header)
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
    registered_rows[name] += n_reg
    _zero_divisor_check(lib, dev, stream)
    packed = torch.cat([scal.t(),
                        hist[..., :3].permute(1, 2, 0).reshape(n, -1)], dim=1)
    back = torch.empty_like(order)
    back[order] = torch.arange(n, device=dev)
    return carry_end[back], finalize_aggregate(packed)[back]
