"""Shapes and dtypes of every model input, and batches drawn to match.

Counterpart: ``repro.launch.specs``. ``input_specs(cfg, shape)`` gives the
prefill / train batch of an (arch x shape) cell as ``{name: (shape, torch
dtype)}``, with nothing allocated; ``decode_input_specs`` a decode
step's. The modality frontends are stubs, as in the reference: for the
vision frontend the batch carries ``N_PATCHES`` precomputed patch
embeddings (at most half the sequence) before the text tokens and M-RoPE
positions [3, b, s]; for the audio frontend (the encoder-decoder)
``encoder_seq`` precomputed frames; both at model width.
``concrete_batch`` draws a real batch of those shapes from a
``torch.Generator`` on ``device`` (default ``"cuda"``; it raises without
a card): uniform tokens, positions 0 .. s - 1 in every row, a loss mask
of ones, standard-normal embeddings and frames.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.configs.qwen2_vl_7b import N_PATCHES
from repro_torch.device import resolve_device
from repro_torch.models.layers import compute_dtype

Spec = Tuple[Tuple[int, ...], torch.dtype]


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Spec]:
    """The prefill / train batch; decode takes ``decode_input_specs``."""
    b, s = shape.global_batch, shape.seq_len
    dt = compute_dtype(cfg)
    batch: Dict[str, Spec] = {}
    if cfg.frontend == "vision":
        n_patch = min(N_PATCHES, s // 2)
        batch["tokens"] = ((b, s - n_patch), torch.int32)
        batch["embeds"] = ((b, n_patch, cfg.d_model), dt)
        batch["positions"] = ((3, b, s), torch.int32)
    elif cfg.encdec:
        batch["tokens"] = ((b, s), torch.int32)
        batch["frames"] = ((b, cfg.encoder_seq, cfg.d_model), dt)
    else:
        batch["tokens"] = ((b, s), torch.int32)
    if shape.kind == "train":
        batch["loss_mask"] = (batch["tokens"][0], torch.float32)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Dict[str, Spec]:
    return {"token": ((shape.global_batch, 1), torch.int32)}


def concrete_batch(cfg: ModelConfig, shape: ShapeConfig,
                   generator: Optional[torch.Generator] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """A real batch matching ``input_specs`` on ``device``, drawn from
    ``generator`` (which must live there; seed 0 when None)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(
        device=dev).manual_seed(0)
    out = {}
    for name, (shp, dtype) in input_specs(cfg, shape).items():
        if name == "tokens":
            out[name] = torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                      dtype=torch.int32, device=dev)
        elif name == "positions":
            out[name] = torch.arange(shp[-1], dtype=torch.int32,
                                     device=dev).expand(shp).contiguous()
        elif name == "loss_mask":
            out[name] = torch.ones(shp, dtype=torch.float32, device=dev)
        else:
            out[name] = torch.randn(shp, generator=gen, dtype=torch.float32,
                                    device=dev).to(dtype)
    return out
