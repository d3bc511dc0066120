"""Wrapper of the forward attention kernel (``csrc/flash_attention.cu``).

Counterpart: ``repro.kernels.flash_attention`` (the Pallas kernel
``_flash_kernel``). Same operands and result: q [b, sq, h, dqk], k
[b, sk, kh, dqk], v [b, sk, kh, dv] (float32 or bfloat16, one type),
query head i reads kv head i // (h // kh); returns [b, sq, h, dv] in q's
type, computed in float32 (see ``ref.flash_attention``). Unlike the
Pallas kernel it takes any sq and sk, not only multiples of its tile.

A tensor on the CPU goes to the plain version, ``ref.flash_attention``.
A tensor on a CUDA device goes to a kernel, or the call raises: there is
no fallback. The type picks the kernel: bfloat16 runs
``flash_wgmma_kernel`` (TMA loads, ``wgmma`` products on the tensor
cores, P rounded to bf16 before the PV product), float32 runs
``flash_fwd_kernel`` (float32 on the CUDA cores). Both take dqk and dv
separately, each under ``HEAD_DIM_RULE`` (a multiple of 8 from 8 to 256,
``check_head_dims``; the Pallas kernel takes any, ROADMAP C17): on the
card a head dim outside it raises ``NotImplementedError``, it never goes
to the plain version. Each launch adds one to its
kernel's count, ``launches["flash_attention"]`` (bf16) or
``launches["flash_attention_f32"]``, and nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: kernel launches since the last ``reset_launches()``
launches = {"flash_attention": 0, "flash_attention_f32": 0}

#: the head dims the kernels take, q/k and v alike (a tensor map's row
#: stride must be a multiple of 16 bytes; the kernels pad to 256 at most)
HEAD_DIM_RULE = "a multiple of 8 from 8 to 256"
MAX_HEAD_DIM = 256
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
                                               _I, _I, _I, _I, _I,
                                               ctypes.c_float, _I, _P]
        lib.flash_attention_launch.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_head_dims(dqk: int, dv: int):
    """Raise ``NotImplementedError`` unless the kernels take q/k head dim
    ``dqk`` and v head dim ``dv`` (``HEAD_DIM_RULE``, each on its own)."""
    for what, d in (("q/k", dqk), ("v", dv)):
        if not (8 <= d <= MAX_HEAD_DIM and d % 8 == 0):
            raise NotImplementedError(
                f"{what} head dim {d}: the flash kernels take head dims "
                f"that are {HEAD_DIM_RULE}")


def _check_operands(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [b, s, heads, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b
            or k.shape[3] != d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)} (k's head dim is "
                         f"q's; v shares k's batch, keys and heads)")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    check_head_dims(d, v.shape[3])
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
    sk, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else d ** -0.5
    # the bf16 kernel's tensor maps need 16-byte aligned bases
    q, k, v = (x.contiguous() for x in (q, k, v))
    q, k, v = (x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))
    out = q.new_empty((b, sq, h, dv))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, h, kh, d, dv, float(scale),
            int(bool(causal)), stream)
    if rc:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: error "
                           f"{rc} ({msg})")
    launches["flash_attention" if q.dtype == torch.bfloat16
             else "flash_attention_f32"] += 1
    return out
