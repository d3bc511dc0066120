"""Stack assembly: repeating block groups, run group by group.

Counterpart: ``repro.models.transformer``. A model is ``num_layers``
layers arranged as ``n_groups`` repetitions of ``cfg.block_pattern``.
Parameters of one group are a flat dict keyed ``blk{i}.<module>.<leaf>``;
the stack stacks every leaf along a leading ``groups`` axis, as the
reference does for its ``lax.scan``. Here a Python loop walks that axis:
group g's parameters and cache are views ``leaf[g]``, and the new serve
state is written back into the stacked cache tensors in place.

Block kinds ported: ``attn`` (norm, GQA attention, norm, dense MLP) and
``mamba`` (norm, selective SSM, norm, dense MLP). ``rwkv`` and ``xattn``
blocks, MLA and MoE raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Params, Schema, apply_mlp,
                                       apply_norm, mlp_schema, norm_schema,
                                       prefix_schema, stack_schema)

BLOCK_KINDS = ("attn", "mamba")


def n_groups(cfg: ModelConfig) -> int:
    p = len(cfg.block_pattern)
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.num_layers} layers are not whole groups of "
                         f"the {p}-block pattern")
    return cfg.num_layers // p


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for what the port's model does not
    run yet."""
    missing = []
    for kind in cfg.block_pattern:
        if kind not in BLOCK_KINDS:
            missing.append(f"{kind!r} blocks")
    if "attn" in cfg.block_pattern and cfg.attention.kind != "gqa":
        missing.append(f"{cfg.attention.kind} attention")
    if "attn" in cfg.block_pattern and cfg.attention.rope != "none":
        missing.append(f"RoPE ({cfg.attention.rope})")
    if cfg.moe is not None:
        missing.append("MoE")
    if cfg.encdec:
        missing.append("encoder-decoder")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not "
                                  f"ported yet")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

def _block_schema(cfg: ModelConfig, kind: str, idx: int) -> Schema:
    """Schema for pattern position ``idx`` of one group."""
    pre = f"blk{idx}"
    s: Schema = {}
    s.update(norm_schema(cfg, f"{pre}.norm1"))
    if kind == "attn":
        s.update(attn_mod.gqa_schema(cfg, f"{pre}.attn"))
    else:
        s.update(ssm_mod.mamba_schema(cfg, f"{pre}.mixer"))
    s.update(norm_schema(cfg, f"{pre}.norm2"))
    s.update(mlp_schema(cfg, f"{pre}.mlp"))
    return s


def group_schema(cfg: ModelConfig) -> Schema:
    check_supported(cfg)
    s: Schema = {}
    for i, kind in enumerate(cfg.block_pattern):
        s.update(_block_schema(cfg, kind, i))
    return s


def stack_params_schema(cfg: ModelConfig, prefix: str = "stack") -> Schema:
    return prefix_schema(prefix, stack_schema(group_schema(cfg),
                                              n_groups(cfg), "groups"))


def group_cache_schema(cfg: ModelConfig, batch: int, max_len: int) -> Schema:
    """Serve-state schema for one group (stacked by caller)."""
    check_supported(cfg)
    s: Schema = {}
    for i, kind in enumerate(cfg.block_pattern):
        pre = f"blk{i}"
        if kind == "attn":
            s.update(attn_mod.gqa_cache_schema(cfg, f"{pre}.attn", batch,
                                               max_len))
        else:
            s.update(ssm_mod.mamba_state_schema(cfg, f"{pre}.mixer", batch))
    return s


def stack_cache_schema(cfg: ModelConfig, batch: int, max_len: int,
                       prefix: str = "stack") -> Schema:
    return prefix_schema(prefix, stack_schema(
        group_cache_schema(cfg, batch, max_len), n_groups(cfg), "groups"))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _subcache(cache: Optional[Params], name: str, extra: dict
              ) -> Optional[dict]:
    if cache is None:
        return None
    pre = f"{name}."
    sub = {k[len(pre):]: v for k, v in cache.items() if k.startswith(pre)}
    sub.update(extra)
    return sub


def _store(cache_out: dict, name: str, sub: Optional[dict], keys):
    if sub is None:
        return
    for k in keys:
        if k in sub:
            cache_out[f"{name}.{k}"] = sub[k]


def _apply_block(gp: Params, cfg: ModelConfig, idx: int, kind: str,
                 x: torch.Tensor, positions, cache: Optional[Params],
                 cache_out: dict, decode: bool, lengths):
    pre = f"blk{idx}"
    h = apply_norm(gp, f"{pre}.norm1", x, cfg)
    if kind == "attn":
        extra = {"decode": decode, "length": lengths} if decode else (
            {"length": lengths} if lengths is not None else {})
        name = f"{pre}.attn"
        sub = _subcache(cache, name, extra)
        y, sub = attn_mod.apply_gqa(gp, name, h, positions, cfg, sub)
        _store(cache_out, name, sub, ("k", "v"))
    else:
        name = f"{pre}.mixer"
        sub = _subcache(cache, name, {"decode": decode})
        y, sub = ssm_mod.apply_mamba(gp, name, h, cfg, sub)
        _store(cache_out, name, sub, ("conv", "ssm"))
    x = x + y
    h = apply_norm(gp, f"{pre}.norm2", x, cfg)
    return x + apply_mlp(gp, f"{pre}.mlp", h, cfg)


def apply_stack(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions, cache: Optional[Params] = None,
                decode: bool = False, lengths: Optional[torch.Tensor] = None,
                prefix: str = "stack"
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Run the full stack. Returns (y, the stacked cache written in place
    or None, aux loss: zero without MoE)."""
    check_supported(cfg)
    pre = f"{prefix}."
    stacked = {k[len(pre):]: v for k, v in params.items()
               if k.startswith(pre)}
    for g in range(n_groups(cfg)):
        gp = {k: v[g] for k, v in stacked.items()}
        gcache = None if cache is None else {k: v[g]
                                             for k, v in cache.items()}
        cache_out: dict = {}
        for i, kind in enumerate(cfg.block_pattern):
            x = _apply_block(gp, cfg, i, kind, x, positions, gcache,
                             cache_out, decode, lengths)
        for k, v in cache_out.items():
            if v is not gcache[k]:      # K/V were written in place
                cache[k][g].copy_(v)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, cache, aux
