"""Wrapper of the RWKV-6 WKV recurrence kernel (``csrc/rwkv6.cu``).

Counterpart: ``repro.kernels.rwkv6_kernel`` (the Pallas kernel
``_wkv_kernel``, called through ``rwkv6``). Same operands and results:
r, k, v, w [b, s, h, n] (float32 or bfloat16, one type; w the decay in
(0, 1)), u [h, n] float32, ``state`` [b, h, n, n] float32 or None
(zeros); returns (out [b, s, h, n] in r's type, the final state
[b, h, n, n] float32). The state passed in is not modified. Unlike the
Pallas kernel it takes any s >= 1, not only multiples of its chunk, and
computes the exact recurrence of ``ref.rwkv6_scan`` at any decay (the
Pallas kernel's exponent clamp departs from it at strong decays).

A tensor on the CPU goes to the plain version, ``ref.rwkv6_scan``. A
tensor on a CUDA device goes to a kernel, or the call raises: there is no
fallback. The number of steps picks the kernel: s >= ``CHUNKED_MIN_STEPS``
(prefill) runs ``wkv_chunked`` (32-step chunks as 3xTF32 matrix products
on the tensor cores, every decay factor <= 1), shorter runs and decode
(s = 1) run ``wkv_kernel`` (the per-step recurrence). Both take float32
and bfloat16 and are built for head dims 16, 32 and 64. Each launch adds
one to its kernel's count, ``launches["rwkv6_chunked"]`` or
``launches["rwkv6_scan"]``, and nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: kernel launches since the last ``reset_launches()``
launches = {"rwkv6_chunked": 0, "rwkv6_scan": 0}

#: the fewest steps that run the chunked kernel (two chunks)
CHUNKED_MIN_STEPS = 64

HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for k in launches:
        launches[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("rwkv6")
    if not getattr(lib, "bound", False):
        lib.bound = True
        lib.rwkv6_launch.argtypes = [_P] * 8 + [_I] * 6 + [_P]
        lib.rwkv6_launch.restype = _I
        lib.rwkv6_error_string.argtypes = [_I]
        lib.rwkv6_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(r, k, v, w, u, state):
    if r.dim() != 4:
        raise ValueError(f"r must be [b, s, h, n], got {tuple(r.shape)}")
    b, s, h, n = r.shape
    want = {"k": (k, (b, s, h, n)), "v": (v, (b, s, h, n)),
            "w": (w, (b, s, h, n)), "u": (u, (h, n))}
    if state is not None:
        want["state"] = (state, (b, h, n, n))
    for what, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if t.device != r.device:
            raise ValueError(f"{what} is on {t.device}, r on {r.device}")
    if n not in HEAD_DIMS:
        raise NotImplementedError(f"head dim {n}: the kernel is built for "
                                  f"{HEAD_DIMS}")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"r, k, v, w must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")
    for what, t in (("u", u), ("state", state)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what} must be float32, got {t.dtype}")


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor, state: torch.Tensor = None):
    """The WKV recurrence, ``ref.rwkv6_scan``'s semantics: (out, final
    state)."""
    if not r.is_cuda:
        return ref.rwkv6_scan(r, k, v, w, u, state)
    _check_operands(r, k, v, w, u, state)
    b, s, h, n = r.shape
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    chunked = s >= CHUNKED_MIN_STEPS
    if chunked:               # its cp.async loads need 16-byte alignment
        r, k, v, w = (t.clone() if t.data_ptr() % 16 else t
                      for t in (r, k, v, w))
    if state is not None:
        state = state.contiguous()
    out = torch.empty_like(r)
    s_out = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.rwkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            out.data_ptr(), s_out.data_ptr(), _DTYPES[r.dtype], b, s, h, n,
            int(chunked), stream)
    if rc:
        msg = lib.rwkv6_error_string(rc).decode()
        raise RuntimeError(f"rwkv6 kernel launch failed: error {rc} "
                           f"({msg})")
    launches["rwkv6_chunked" if chunked else "rwkv6_scan"] += 1
    return out, s_out
