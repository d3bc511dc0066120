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
``flash_f32_kernel`` (``cp.async`` loads, ``mma.sync`` products on the
tensor cores in 3xTF32: each float split into a TF32 high part and its
remainder, three TF32 products for each float32 one, float32 sums; one
TF32 pass would miss the float32 tolerance). Both take dqk and dv
separately, each a multiple of 8 from 8 to 256 (a tensor map's row stride
is a multiple of 16 bytes). Past 256, either dim, the wide kernel of the
type runs, so that DeepSeek-V2-Lite's absorbed MLA (576, 512) runs on the
card (ROADMAP C17): a block holds a 64-row q tile and up to 512 columns
of v, split between two halves of its warps that share one S (each half
computes S for half of a 32-key tile's keys; the halves swap their rows'
maxima and their P through shared memory), so no block recomputes S for
v's columns up to 512 (past 512, slices of 512 across blocks).
bfloat16 runs ``flash_wide_wgmma_kernel`` (TMA, ``wgmma``, q held whole
in shared memory where it fits, P rounded to bf16 as above), float32
``flash_wide_f32_kernel`` (3xTF32 ``mma.sync`` on q, K, V and P split
once a tile into shared memory). The wrapper takes any head dim from 1
(``HEAD_DIM_RULE``, ``check_head_dims``): it pads q and k, and v, with
zero columns to the next multiple of 8 (zeros add nothing to a q.k
product and give zero output columns), scales by the real q/k dim and
slices the output back to the real v dim. It never goes to the plain
version. Each launch adds one to its kernel's count,
``launches["flash_attention"]`` (bf16), ``launches["flash_attention_f32"]``,
``launches["flash_attention_wide"]`` (bf16 past 256) or
``launches["flash_attention_wide_f32"]``, and nothing else does.

This is a forward kernel: its output is written outside autograd. A call
in grad mode with an operand that requires grad raises ``RuntimeError``
(``no_grad_operands``), on either device, rather than return an output
whose gradient would be dropped. Training attention goes through
``kernels/ops.py``, which routes it to ``ref.sdpa`` as the reference's
training does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: kernel launches since the last ``reset_launches()``
launches = {"flash_attention": 0, "flash_attention_f32": 0,
            "flash_attention_wide": 0, "flash_attention_wide_f32": 0}

#: the head dims the wrapper takes, q/k and v alike; the kernels run
#: multiples of 8 (a tensor map's row stride must be a multiple of 16
#: bytes), and the wrapper pads the rest with zeros
HEAD_DIM_RULE = ("from 1 up (padded with zeros to a multiple of 8; past "
                 "256 through the wide kernels)")
#: the largest head dim the bf16 and float32 kernels hold whole; a q/k or
#: v dim past it runs the wide kernel of the type
#: (``flash_wide_wgmma_kernel``, ``flash_wide_f32_kernel``), which have no
#: upper limit
MAX_HEAD_DIM = 256
DIM_STEP = 8
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
    """Raise ``ValueError`` unless the wrapper takes q/k head dim ``dqk``
    and v head dim ``dv`` (``HEAD_DIM_RULE``, each on its own: 1 and
    up)."""
    for what, d in (("q/k", dqk), ("v", dv)):
        if d < 1:
            raise ValueError(f"{what} head dim {d}: a head needs at least "
                             f"one dimension")


def kernel_name(dtype, dqk: int, dv: int) -> str:
    """The ``launches`` key of the kernel that runs head dims ``dqk`` and
    ``dv`` in ``dtype``: the wide kernel where either pads past
    ``MAX_HEAD_DIM``."""
    wide = max(padded_dim(dqk), padded_dim(dv)) > MAX_HEAD_DIM
    name = "flash_attention_wide" if wide else "flash_attention"
    return name if dtype == torch.bfloat16 else name + "_f32"


def padded_dim(d: int) -> int:
    """The storage dim a kernel runs head dim ``d`` at: the next multiple
    of ``DIM_STEP``."""
    return -(-d // DIM_STEP) * DIM_STEP


def pad_head_dims(q, k, v):
    """q, k and v with zero columns up to ``padded_dim`` of their head
    dims (the operands themselves where no padding is needed)."""
    pq = padded_dim(q.shape[3]) - q.shape[3]
    pv = padded_dim(v.shape[3]) - v.shape[3]
    if pq:
        q, k = (torch.nn.functional.pad(x, (0, pq)) for x in (q, k))
    if pv:
        v = torch.nn.functional.pad(v, (0, pv))
    return q, k, v


def needs_grad(*operands) -> bool:
    """Grad mode is on and an operand requires grad: the call belongs to
    a training step."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in operands)


def no_grad_operands(what: str, *operands):
    """Raise ``RuntimeError`` when ``needs_grad(*operands)``: the kernels
    write their outputs outside autograd, so the gradient would be
    dropped without a word."""
    if needs_grad(*operands):
        raise RuntimeError(
            f"{what} is a forward kernel with no backward: an operand "
            f"requires grad in grad mode, and its gradient would be "
            f"dropped. Call it under torch.no_grad(), or go through "
            f"repro_torch.kernels.ops, which routes training to the "
            f"reference's differentiable plain version")


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
    no_grad_operands("flash_attention", q, k, v)
    if not q.is_cuda:
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    _check_operands(q, k, v)
    d, dv_real = q.shape[3], v.shape[3]
    scale = scale if scale is not None else d ** -0.5
    if d % DIM_STEP or dv_real % DIM_STEP:
        q, k, v = pad_head_dims(q, k, v)
        return _launch(q, k, v, causal, scale)[..., :dv_real].contiguous()
    return _launch(q, k, v, causal, scale)


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """One kernel launch; head dims already multiples of ``DIM_STEP``."""
    b, sq, h, d = q.shape
    sk, kh, dv = k.shape[1], k.shape[2], v.shape[3]
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
    launches[kernel_name(q.dtype, d, dv)] += 1
    return out
