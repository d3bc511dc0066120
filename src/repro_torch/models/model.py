"""Top-level model API: schemas, init, prefill, decode.

Counterpart: ``repro.models.model``. Batch convention:
  prefill: {"tokens": [b, s] int}            (+ the cache to fill)
  decode:  {"token": [b, 1] int} + the cache (which holds per-row lengths)

The port runs the text-only, dense-MLP, RoPE-free subset that its slices
have ported (``transformer.check_supported``): attention and Mamba blocks,
as in Jamba-1.5 without experts. ``init_params`` and ``init_cache`` take
``device=`` (default ``"cuda"``) and raise without a card. Caches are
updated in place; ``prefill`` and ``decode_step`` return the same dict.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (ParamDef, Params, Schema, apply_norm,
                                       compute_dtype, embed_schema,
                                       embed_tokens, init_from_schema,
                                       norm_schema, unembed)

#: leaves the reference reads in float32 (norm scales and biases, and the
#: SSM's dt_bias, A_log and D); every other leaf it casts to the compute
#: dtype at use
FLOAT32_LEAVES = ("scale", "bias", "dt_bias", "A_log", "D")


def full_schema(cfg: ModelConfig) -> Schema:
    s: Schema = {}
    s.update(embed_schema(cfg))
    s.update(tf.stack_params_schema(cfg, "stack"))
    s.update(norm_schema(cfg, "final_norm"))
    return s


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> Params:
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn from
    a ``torch.Generator`` seeded with ``seed`` on that device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return init_from_schema(full_schema(cfg), gen,
                            getattr(torch, cfg.param_dtype), dev)


def param_count(cfg: ModelConfig) -> int:
    total = 0
    for d in full_schema(cfg).values():
        n = 1
        for dim in d.shape:
            n *= dim
        total += n
    return total


def compute_params(params: Params, cfg: ModelConfig, device) -> Params:
    """The parameters as the forward pass reads them, on ``device``: each
    leaf the reference casts to the compute dtype at use, cast once here
    (the same numbers, without a cast per call); ``FLOAT32_LEAVES`` as
    they are. Leaves already in that form are not copied."""
    dev = resolve_device(device)
    cdt = compute_dtype(cfg)
    out = {}
    for name, w in params.items():
        keep = name.rsplit(".", 1)[-1] in FLOAT32_LEAVES
        out[name] = w.to(device=dev, dtype=w.dtype if keep else cdt)
    return out


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _stack_cache(cache: Params) -> Params:
    return {k[len("stack."):]: v for k, v in cache.items()
            if k.startswith("stack.")}


def forward(params: Params, cfg: ModelConfig, batch: Dict,
            cache: Optional[Params] = None, decode: bool = False
            ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Full forward. Returns (logits [b, s, vocab], the cache updated in
    place or None, aux loss)."""
    if decode:
        tokens = batch["token"]
        b, t = tokens.shape
        x = embed_tokens(params, tokens, cfg)
        lengths = cache["length"]
        positions = lengths[:, None].to(torch.int32)
        y, _, aux = tf.apply_stack(params, cfg, x, positions,
                                   cache=_stack_cache(cache), decode=True,
                                   lengths=lengths, prefix="stack")
        cache["length"] = lengths + t
    else:
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_tokens(params, tokens, cfg)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device).expand(b, s)
        stack_cache = None if cache is None else _stack_cache(cache)
        lengths = None if cache is None else cache["length"]
        y, _, aux = tf.apply_stack(params, cfg, x, positions,
                                   cache=stack_cache, decode=False,
                                   lengths=lengths, prefix="stack")
        if cache is not None:
            cache["length"] = torch.full((b,), s, dtype=torch.int32,
                                         device=x.device)
    y = apply_norm(params, "final_norm", y, cfg)
    return unembed(params, y, cfg), cache, aux


# ---------------------------------------------------------------------------
# Serve caches
# ---------------------------------------------------------------------------

def cache_schema(cfg: ModelConfig, batch: int, max_len: int) -> Schema:
    s = tf.stack_cache_schema(cfg, batch, max_len, "stack")
    s["length"] = ParamDef((batch,), ("batch",), "zeros")
    return s


def _cache_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    if name == "length":
        return torch.int32
    # recurrent states carry long-horizon accumulators -> float32
    if name.endswith(".wkv") or name.endswith(".ssm"):
        return torch.float32
    return compute_dtype(cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Params:
    dev = resolve_device(device)
    return {name: torch.zeros(d.shape, dtype=_cache_dtype(cfg, name),
                              device=dev)
            for name, d in cache_schema(cfg, batch, max_len).items()}


def prefill(params: Params, cfg: ModelConfig, batch: Dict, cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    logits, cache, _ = forward(params, cfg, batch, cache=cache,
                               decode=False)
    return logits[:, -1:], cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params, batch: Dict
                ) -> Tuple[torch.Tensor, Params]:
    logits, cache, _ = forward(params, cfg, batch, cache=cache, decode=True)
    return logits, cache
