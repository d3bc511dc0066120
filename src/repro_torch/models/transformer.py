"""Stack assembly: repeating block groups, run group by group.

Counterpart: ``repro.models.transformer``. A model is ``num_layers``
layers arranged as ``n_groups`` repetitions of ``cfg.block_pattern``.
Parameters of one group are a flat dict keyed ``blk{i}.<module>.<leaf>``;
the stack stacks every leaf along a leading ``groups`` axis, as the
reference does for its ``lax.scan``. Here a Python loop walks that axis:
group g's parameters and cache are views ``leaf[g]``, and the new serve
state is written back into the stacked cache tensors in place.

Block kinds: ``attn`` (norm, GQA or MLA attention, norm, MLP) and
``mamba`` (norm, selective SSM, norm, MLP), where the MLP is the dense
one or, at the pattern positions ``cfg.layer_uses_moe`` picks, the
experts of ``models.moe`` (under ``.moe``); ``rwkv`` (norm, RWKV-6
time-mix, norm, RWKV channel-mix; its serve state ``x_att``, ``x_ffn``
and ``wkv`` sits under the block's prefix, not under ``.mixer``, as in
the reference); and ``xattn``, the ``attn`` blocks of a decoder stack
built with ``cross=True`` (whisper): an attention block with a
cross-attention sub-block (``norm_x``, then GQA over the encoder's
output under ``.cross``, its K/V cache ``encoder_seq`` long) before the
MLP. The MoE layers' aux losses sum over the stack, as the reference's
scan carries them.

``remat`` (``REMAT_POLICIES``, the reference's ``set_remat``, passed as
an argument here) checkpoints each group's body in training, as the
reference wraps its scan body: ``"none"`` keeps every activation for the
backward, ``"full"`` keeps only the group's inputs and recomputes the
rest (``torch.utils.checkpoint``), ``"dots"`` keeps the outputs of the
matrix products and recomputes the rest (a selective-checkpoint policy,
the counterpart of ``jax.checkpoint_policies.checkpoint_dots``). The
recomputation runs the same operations on the same inputs, so gradients
are those of ``"none"``. A serving call (with a cache) runs no remat.
The recomputation runs inside backward, which autograd may run on
another thread (CUDA's device thread): the checkpointed body re-enters
the ``sharding.RankContext`` its forward ran in (a rank's mesh, the
whole batch's MoE statistics), so it splits its work as the forward did.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Params, Schema, apply_mlp,
                                       apply_norm, mlp_schema, norm_schema,
                                       prefix_schema, stack_schema)

BLOCK_KINDS = ("attn", "mamba", "rwkv")
REMAT_POLICIES = ("none", "full", "dots")
#: the matrix products whose outputs ``"dots"`` keeps (what ``@``,
#: ``einsum`` and ``F.linear`` dispatch to)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)
ATTENTION_KINDS = ("gqa", "mla")
FRONTENDS = ("none", "vision", "audio")


def n_groups(cfg: ModelConfig) -> int:
    p = len(cfg.block_pattern)
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.num_layers} layers are not whole groups of "
                         f"the {p}-block pattern")
    return cfg.num_layers // p


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for a block kind, attention kind or
    frontend the model does not know (every config of ``configs`` runs)."""
    missing = []
    for kind in cfg.block_pattern:
        if kind not in BLOCK_KINDS:
            missing.append(f"{kind!r} blocks")
    if ("attn" in cfg.block_pattern
            and cfg.attention.kind not in ATTENTION_KINDS):
        missing.append(f"{cfg.attention.kind} attention")
    if cfg.frontend not in FRONTENDS:
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not "
                                  f"supported")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

def _block_schema(cfg: ModelConfig, kind: str, idx: int) -> Schema:
    """Schema for pattern position ``idx`` of one group."""
    pre = f"blk{idx}"
    s: Schema = {}
    s.update(norm_schema(cfg, f"{pre}.norm1"))
    if kind in ("attn", "xattn"):
        if cfg.attention.kind == "mla":
            s.update(attn_mod.mla_schema(cfg, f"{pre}.attn"))
        else:
            s.update(attn_mod.gqa_schema(cfg, f"{pre}.attn"))
    elif kind == "mamba":
        s.update(ssm_mod.mamba_schema(cfg, f"{pre}.mixer"))
    else:
        s.update(rwkv_mod.rwkv_schema(cfg, f"{pre}.mixer"))
    if kind == "xattn":
        s.update(norm_schema(cfg, f"{pre}.norm_x"))
        s.update(attn_mod.gqa_schema(cfg, f"{pre}.cross"))
    s.update(norm_schema(cfg, f"{pre}.norm2"))
    if kind == "rwkv":
        s.update(rwkv_mod.channel_mix_schema(cfg, f"{pre}.cmix"))
    elif cfg.layer_uses_moe(idx):
        s.update(moe_mod.moe_schema(cfg, f"{pre}.moe"))
    else:
        s.update(mlp_schema(cfg, f"{pre}.mlp"))
    return s


def _kind(kind: str, cross: bool) -> str:
    """A decoder stack built with ``cross`` runs its attention blocks as
    ``xattn``."""
    return "xattn" if (cross and kind == "attn") else kind


def group_schema(cfg: ModelConfig, cross: bool = False) -> Schema:
    check_supported(cfg)
    s: Schema = {}
    for i, kind in enumerate(cfg.block_pattern):
        s.update(_block_schema(cfg, _kind(kind, cross), i))
    return s


def stack_params_schema(cfg: ModelConfig, prefix: str = "stack",
                        cross: bool = False) -> Schema:
    return prefix_schema(prefix, stack_schema(group_schema(cfg, cross),
                                              n_groups(cfg), "groups"))


def group_cache_schema(cfg: ModelConfig, batch: int, max_len: int,
                       cross: bool = False) -> Schema:
    """Serve-state schema for one group (stacked by caller)."""
    check_supported(cfg)
    s: Schema = {}
    for i, kind in enumerate(cfg.block_pattern):
        pre = f"blk{i}"
        if kind == "attn":
            if cfg.attention.kind == "mla":
                s.update(attn_mod.mla_cache_schema(cfg, f"{pre}.attn",
                                                   batch, max_len))
            else:
                s.update(attn_mod.gqa_cache_schema(cfg, f"{pre}.attn",
                                                   batch, max_len))
            if cross:
                s.update(attn_mod.gqa_cache_schema(cfg, f"{pre}.cross",
                                                   batch, max_len,
                                                   cross=True))
        elif kind == "mamba":
            s.update(ssm_mod.mamba_state_schema(cfg, f"{pre}.mixer", batch))
        else:
            s.update(rwkv_mod.rwkv_state_schema(cfg, pre, batch))
    return s


def stack_cache_schema(cfg: ModelConfig, batch: int, max_len: int,
                       prefix: str = "stack", cross: bool = False) -> Schema:
    return prefix_schema(prefix, stack_schema(
        group_cache_schema(cfg, batch, max_len, cross), n_groups(cfg),
        "groups"))


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
                 cache_out: dict, decode: bool, lengths,
                 memory: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x after the block, the MoE aux loss or None). ``memory``: the
    encoder's output, read by an ``xattn`` block at prefill."""
    pre = f"blk{idx}"
    h = apply_norm(gp, f"{pre}.norm1", x, cfg)
    if kind in ("attn", "xattn"):
        extra = {"decode": decode, "length": lengths} if decode else (
            {"length": lengths} if lengths is not None else {})
        name = f"{pre}.attn"
        sub = _subcache(cache, name, extra)
        if cfg.attention.kind == "mla":
            y, sub = attn_mod.apply_mla(gp, name, h, positions, cfg, sub)
            _store(cache_out, name, sub, ("ckv", "k_rope"))
        else:
            y, sub = attn_mod.apply_gqa(gp, name, h, positions, cfg, sub)
            _store(cache_out, name, sub, ("k", "v"))
    elif kind == "mamba":
        name = f"{pre}.mixer"
        sub = _subcache(cache, name, {"decode": decode})
        y, sub = ssm_mod.apply_mamba(gp, name, h, cfg, sub)
        _store(cache_out, name, sub, ("conv", "ssm"))
    else:
        sub = _subcache(cache, pre, {"decode": decode})
        y, sub = rwkv_mod.apply_time_mix(gp, f"{pre}.mixer", h, cfg, sub)
        _store(cache_out, pre, sub, ("x_att", "wkv"))
    x = x + y
    if kind == "xattn":
        h = apply_norm(gp, f"{pre}.norm_x", x, cfg)
        name = f"{pre}.cross"
        sub = _subcache(cache, name, {"decode": decode})
        y, sub = attn_mod.apply_gqa(gp, name, h, positions, cfg, sub,
                                    memory=memory, is_cross=True)
        _store(cache_out, name, sub, ("k", "v"))
        x = x + y
    h = apply_norm(gp, f"{pre}.norm2", x, cfg)
    if kind == "rwkv":
        sub = _subcache(cache, pre, {"decode": decode})
        y, sub = rwkv_mod.apply_channel_mix(gp, f"{pre}.cmix", h, cfg, sub)
        _store(cache_out, pre, sub, ("x_ffn",))
        return x + y, None
    if cfg.layer_uses_moe(idx):
        y, aux = moe_mod.apply_moe(gp, f"{pre}.moe", h, cfg)
        return x + y, aux
    return x + apply_mlp(gp, f"{pre}.mlp", h, cfg), None


def _save_dots(ctx, op, *args, **kwargs):
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOT_OPS else policy.PREFER_RECOMPUTE


def _remat(body, remat: str):
    """``body`` under the remat policy (see the module docstring)."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat={remat!r}: one of {REMAT_POLICIES}")
    if remat == "none":
        return body
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _save_dots)

    def checkpointed(*args):
        ctx = sh.context()

        def within(*a):
            with sh.within(ctx):
                return body(*a)
        return torch_checkpoint.checkpoint(within, *args,
                                           use_reentrant=False, **kw)
    return checkpointed


def apply_stack(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions, cache: Optional[Params] = None,
                decode: bool = False, lengths: Optional[torch.Tensor] = None,
                prefix: str = "stack", memory: Optional[torch.Tensor] = None,
                cross: bool = False, remat: str = "none"
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Run the full stack. Returns (y, the stacked cache written in place
    or None, aux loss: the MoE layers' summed, zero without MoE).
    ``cross``: a decoder stack whose attention blocks also attend to the
    encoder's output (``memory`` at prefill, the cache at decode).
    ``remat``: the training remat policy of each group's body (ignored
    with a cache)."""
    check_supported(cfg)
    pre = f"{prefix}."
    stacked = {k[len(pre):]: v for k, v in params.items()
               if k.startswith(pre)}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache is None:
        def group(x, aux, gp):
            for i, kind in enumerate(cfg.block_pattern):
                x, a = _apply_block(gp, cfg, i, _kind(kind, cross), x,
                                    positions, None, {}, decode, lengths,
                                    memory)
                if a is not None:
                    aux = aux + a
            return x, aux
        body = _remat(group, remat)
        for g in range(n_groups(cfg)):
            x, aux = body(x, aux, {k: v[g] for k, v in stacked.items()})
        return x, None, aux
    for g in range(n_groups(cfg)):
        gp = {k: v[g] for k, v in stacked.items()}
        gcache = {k: v[g] for k, v in cache.items()}
        cache_out: dict = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, a = _apply_block(gp, cfg, i, _kind(kind, cross), x,
                                positions, gcache, cache_out, decode,
                                lengths, memory)
            if a is not None:
                aux = aux + a
        for k, v in cache_out.items():
            if v is not gcache[k]:      # K/V were written in place
                cache[k][g].copy_(v)
    return x, cache, aux
