"""Grouped-query self-attention (MHA and MQA are special cases).

Counterpart: the GQA half of ``repro.models.attention`` (``gqa_schema``,
``_write_kv``, ``apply_gqa``, ``gqa_cache_schema``). Caches are dicts of
tensors sized to the full serve context; prefill fills them from position
0, decode writes the new K/V at per-sequence positions and masks by valid
length. Unlike the reference, which returns new arrays, the port writes
into the cache tensors in place (the reference's engine donates them).
Not ported yet: MLA, cross-attention (whisper) and RoPE; they raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, Params, Schema

Cache = Dict[str, torch.Tensor]


def gqa_schema(cfg: ModelConfig, name: str) -> Schema:
    a = cfg.attention
    d = cfg.d_model
    return {
        f"{name}.wq": ParamDef((d, a.num_heads * a.head_dim),
                               ("embed", "heads")),
        f"{name}.wk": ParamDef((d, a.num_kv_heads * a.head_dim),
                               ("embed", "kv")),
        f"{name}.wv": ParamDef((d, a.num_kv_heads * a.head_dim),
                               ("embed", "kv")),
        f"{name}.wo": ParamDef((a.num_heads * a.head_dim, d),
                               ("heads", "embed")),
    }


def _write_kv(cache_k, cache_v, k_new, v_new, pos):
    """Write k_new/v_new [b, t, kh, hd] into the caches [b, S, kh, hd] at
    per-row offsets pos [b], in place. A start past S - t is clamped to
    S - t, as ``lax.dynamic_update_slice`` clamps it."""
    b, t = k_new.shape[:2]
    start = pos.long().clamp(0, cache_k.shape[1] - t)
    rows = torch.arange(b, device=cache_k.device)[:, None]
    cols = start[:, None] + torch.arange(t, device=cache_k.device)[None]
    cache_k[rows, cols] = k_new.to(cache_k.dtype)
    cache_v[rows, cols] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


def apply_gqa(params: Params, name: str, x: torch.Tensor,
              positions: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Cache] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x [b, t, d]. Prefill: t is the whole prompt; a cache, if given, is
    filled from position 0. Decode (``cache["decode"]``): t new tokens
    attend to the cache's first ``length + t`` entries."""
    a = cfg.attention
    if a.rope != "none":
        raise NotImplementedError(f"RoPE ({a.rope}) is not ported yet")
    b, t, _ = x.shape
    dt = x.dtype
    q = (x @ params[f"{name}.wq"].to(dt)).reshape(b, t, a.num_heads,
                                                 a.head_dim)
    k = (x @ params[f"{name}.wk"].to(dt)).reshape(b, t, a.num_kv_heads,
                                                 a.head_dim)
    v = (x @ params[f"{name}.wv"].to(dt)).reshape(b, t, a.num_kv_heads,
                                                 a.head_dim)

    if cache is not None and cache.get("decode", False):
        pos = cache["length"]                                   # [b] int32
        ck, cv = _write_kv(cache["k"], cache["v"], k, v, pos)
        new_len = pos + t
        out = ops.sdpa(q, ck.to(dt), cv.to(dt), causal=False,
                       logit_cap=a.logit_cap, kv_len=new_len)
        cache = dict(cache, k=ck, v=cv, length=new_len)
    else:
        out = ops.sdpa(q, k, v, causal=a.causal, logit_cap=a.logit_cap)
        if cache is not None:                                   # prefill
            ck, cv = _write_kv(cache["k"], cache["v"], k, v,
                               torch.zeros(b, dtype=torch.int32,
                                           device=x.device))
            cache = dict(cache, k=ck, v=cv,
                         length=torch.full((b,), t, dtype=torch.int32,
                                           device=x.device))
    out = out.reshape(b, t, -1)
    return out @ params[f"{name}.wo"].to(dt), cache


def gqa_cache_schema(cfg: ModelConfig, name: str, batch: int,
                     max_len: int) -> Schema:
    a = cfg.attention
    return {
        f"{name}.k": ParamDef((batch, max_len, a.num_kv_heads, a.head_dim),
                              ("batch", "cache_seq", "kv_heads", None),
                              "zeros"),
        f"{name}.v": ParamDef((batch, max_len, a.num_kv_heads, a.head_dim),
                              ("batch", "cache_seq", "kv_heads", None),
                              "zeros"),
    }
