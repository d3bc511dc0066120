"""Serve steps: prefill and single-token decode.

Counterpart: ``repro.serve.steps``. The reference compiles each step with
``jax.jit`` over a sharded mesh and donates the cache; here each is a
plain function on one device under ``torch.inference_mode()``, and the
cache is updated in place. Multi-GPU serving is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``step(params, batch, cache) -> (last-position logits [b, 1, vocab],
    cache)``."""
    def step(params, batch_in: Dict, cache) -> Tuple[torch.Tensor, Dict]:
        with torch.inference_mode():
            return M.prefill(params, cfg, batch_in, cache)
    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``step(params, cache, batch) -> (logits [b, 1, vocab], cache)``."""
    def step(params, cache, batch_in: Dict) -> Tuple[torch.Tensor, Dict]:
        with torch.inference_mode():
            return M.decode_step(params, cfg, cache, batch_in)
    return step
