"""Wrapper of the forward attention kernel (``csrc/flash_attention.cu``).

Counterpart: ``repro.kernels.flash_attention`` (the Pallas kernel
``_flash_kernel``). Same operands and result: q [b, sq, h, d], k/v
[b, sk, kh, d] (float32 or bfloat16, one type), query head i reads kv
head i // (h // kh); returns [b, sq, h, d] in q's type, computed in
float32 (see ``ref.flash_attention``). Unlike the Pallas kernel it takes
any sq and sk, not only multiples of its tile.

A tensor on the CPU goes to the plain version, ``ref.flash_attention``.
A tensor on a CUDA device goes to the kernel, or the call raises: there
is no fallback. The kernel is built for head dims 16, 32, 64 and 128
with d == dv. Each launch adds one to ``launches["flash_attention"]``, and
nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: kernel launches since the last ``reset_launches()``
launches = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for k in launches:
        launches[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "bound", False):
        lib.bound = True
        lib.flash_attention_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                               _I, _I, _I, _I,
                                               ctypes.c_float, _I, _P]
        lib.flash_attention_launch.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [b, s, heads, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)} (the kernel needs "
                         f"d == dv)")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"head dim {d}: the kernel is built for "
                                  f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float = None) -> torch.Tensor:
    """Forward attention, ``ref.flash_attention``'s semantics."""
    if not q.is_cuda:
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    _check_operands(q, k, v)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, h, kh, d, float(scale),
            int(bool(causal)), stream)
    if rc:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: error "
                           f"{rc} ({msg})")
    launches["flash_attention"] += 1
    return out
