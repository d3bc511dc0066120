"""Block-wise int8 quantization: the 8-bit moments of ``optim.adamw``
(``state_dtype="int8"``) and the payload of the reference's cross-pod
gradient compression (``train.steps``, a mesh with a ``pod`` axis).

Counterpart: ``repro.optim.compression``, operation for operation: a
tensor is flattened, zero-padded to whole blocks of ``block`` values, and
each block scaled by its absmax / 127 (a block of zeros by 1). Both
``jnp.round`` and ``torch.round`` round half to even, so on the CPU these
are bitwise the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _pad_to(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8: (q int8 [n / block, block], scale
    float32 [n / block]); ``dequantize_int8`` restores any shape."""
    blocks = _pad_to(x.to(torch.float32), block).reshape(-1, block)
    scale = blocks.abs().amax(dim=1) / 127.0
    return _quantize(blocks, scale), scale


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(blocks / safe[:, None]), -127, 127
                       ).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape)).to(dtype)


def block_absmax(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Per-block absmax (the scale's numerator) without quantizing."""
    return _pad_to(x.to(torch.float32), block).reshape(-1, block
                                                       ).abs().amax(dim=1)


def quantize_int8_with_scale(x: torch.Tensor, scale: torch.Tensor,
                             block: int = 256) -> torch.Tensor:
    """Quantize against an agreed per-block scale: int8 payloads from
    several devices that share it sum exactly up to rounding."""
    blocks = _pad_to(x.to(torch.float32), block).reshape(-1, block)
    return _quantize(blocks, scale)
