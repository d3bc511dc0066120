"""Wrapper of the Mamba-1 selective-scan kernel (``csrc/ssm_scan.cu``).

Counterpart: ``repro.kernels.ssm_scan`` (the Pallas kernel
``_ssm_kernel``, called through ``ssm``). Same operands and results:
x, dt [b, s, di] and B, C [b, s, n] (float32 or bfloat16, one type),
A [di, n] and D [di] float32, ``state`` [b, di, n] float32 or None
(zeros); returns (y [b, s, di] in x's type, the final state [b, di, n]
float32). A state carried in from an earlier call continues the scan:
a run split in two equals one whole run (chunk associativity). The state
passed in is not modified.

A tensor on the CPU goes to the plain version, ``ref.ssm_scan``. A
tensor on a CUDA device goes to the kernel, or the call raises: there is
no fallback. The kernel holds n <= 16 state values per channel in
registers. Each launch adds one to ``launches["ssm_scan"]``, and nothing
else does. A forward kernel: a call in grad mode with an operand that
requires grad raises ``RuntimeError`` on either device
(``flash_attention.no_grad_operands``); ``kernels/ops.py`` routes training
to ``ref.ssm_scan``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import no_grad_operands

#: kernel launches since the last ``reset_launches()``
launches = {"ssm_scan": 0}

MAX_STATE = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for k in launches:
        launches[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("ssm_scan")
    if not getattr(lib, "bound", False):
        lib.bound = True
        lib.ssm_scan_launch.argtypes = [_P] * 9 + [_I] * 5 + [_P]
        lib.ssm_scan_launch.restype = _I
        lib.ssm_scan_error_string.argtypes = [_I]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(x, dt, A, B, C, D, state):
    if x.dim() != 3:
        raise ValueError(f"x must be [b, s, di], got {tuple(x.shape)}")
    b, s, di = x.shape
    n = A.shape[-1]
    want = {"dt": (dt, (b, s, di)), "A": (A, (di, n)), "B": (B, (b, s, n)),
            "C": (C, (b, s, n)), "D": (D, (di,))}
    if state is not None:
        want["state"] = (state, (b, di, n))
    for what, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{what} is on {t.device}, x on {x.device}")
    if not 1 <= n <= MAX_STATE:
        raise NotImplementedError(f"state dim {n}: the kernel holds at "
                                  f"most {MAX_STATE} per channel")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise TypeError(f"x, dt, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {dt.dtype}, {B.dtype}, {C.dtype}")
    for what, t in (("A", A), ("D", D), ("state", state)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what} must be float32, got {t.dtype}")


def ssm(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor, state: torch.Tensor = None):
    """Selective scan, ``ref.ssm_scan``'s semantics: (y, final state)."""
    no_grad_operands("ssm_scan", x, dt, A, B, C, D, state)
    if not x.is_cuda:
        return ref.ssm_scan(x, dt, A, B, C, D, state)
    _check_operands(x, dt, A, B, C, D, state)
    b, s, di = x.shape
    n = A.shape[-1]
    x, dt, A, B, C, D = (t.contiguous() for t in (x, dt, A, B, C, D))
    if state is not None:
        state = state.contiguous()
    y = torch.empty_like(x)
    s_out = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssm_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(),
            None if state is None else state.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), _DTYPES[x.dtype], b, s, di, n, stream)
    if rc:
        msg = lib.ssm_scan_error_string(rc).decode()
        raise RuntimeError(f"ssm_scan kernel launch failed: error {rc} "
                           f"({msg})")
    launches["ssm_scan"] += 1
    return y, s_out
