"""Mixture-of-Experts with grouped capacity dispatch.

Counterpart: ``repro.models.moe``, with its semantics. Tokens are split
into groups of ``min(GROUP_SIZE, tokens)``; within a group every expert
has capacity C = ceil(group * top_k * capacity_factor / E). The router
runs in float32; each token picks its top_k experts, whose weights are
renormalised. A (token, k) pair's slot in its expert's buffer is the
number of pairs before it, in token-major, k-minor order, that picked the
same expert; a pair past the capacity drops (its token's residual passes
through) and sends its payload to a sink slot, ``E * C``, that is cut off.
Dispatch and combine are index gathers and one scatter into the slot
table, never a [tokens, E, C] one-hot; the kept slots are unique, so the
scatter is deterministic. Every expert multiplies all of its C slots,
filled or not, as the reference's batched products do. Shared experts,
where the config has them, run on every token. Returns the Switch
load-balancing loss beside the output.

The expert products are batched matrix products over the expert axis,
in the activations' dtype (cuBLAS on the card): the JAX package computes
them outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import ParamDef, Params, Schema

#: tokens per dispatch group (capacity is per group and expert)
GROUP_SIZE = 256

# the whole batch's balance statistics on a rank of a data mesh: a
# function of this rank's (token fractions, probability means) [E], set
# by ``batch_stats`` (``train.steps``); None on one device
_BATCH_STATS = None


@contextlib.contextmanager
def batch_stats(fn):
    """Within the block, every MoE layer takes its balance loss's two
    per-expert means [E] through ``fn(frac_tokens, frac_probs)``: a rank
    of a data mesh turns its rows' means into the whole batch's, so the
    loss is the reference's product of whole-batch means (see
    ``train.steps``). A module global rather than a context variable, so
    that the recomputation of remat in autograd's threads sees it."""
    global _BATCH_STATS
    prev, _BATCH_STATS = _BATCH_STATS, fn
    try:
        yield
    finally:
        _BATCH_STATS = prev


def moe_schema(cfg: ModelConfig, name: str) -> Schema:
    m = cfg.moe
    d = cfg.d_model
    s: Schema = {
        f"{name}.router": ParamDef((d, m.num_experts), ("embed", None),
                                   "small"),
        f"{name}.w_gate": ParamDef((m.num_experts, d, m.d_ff),
                                   ("expert", "embed", "mlp")),
        f"{name}.w_up": ParamDef((m.num_experts, d, m.d_ff),
                                 ("expert", "embed", "mlp")),
        f"{name}.w_down": ParamDef((m.num_experts, m.d_ff, d),
                                   ("expert", "mlp", "embed")),
    }
    if m.num_shared_experts > 0:
        f_sh = m.d_ff * m.num_shared_experts
        s[f"{name}.shared.w_gate"] = ParamDef((d, f_sh), ("embed", "mlp"))
        s[f"{name}.shared.w_up"] = ParamDef((d, f_sh), ("embed", "mlp"))
        s[f"{name}.shared.w_down"] = ParamDef((f_sh, d), ("mlp", "embed"))
    return s


def _capacity(group: int, num_experts: int, top_k: int,
              factor: float) -> int:
    c = int(math.ceil(group * top_k * factor / num_experts))
    return max(c, 1)


def group_size(tokens: int) -> int:
    """The dispatch group for a call of ``tokens`` tokens; raises unless
    they make whole groups (the reference asserts it)."""
    group = min(GROUP_SIZE, tokens)
    if tokens % group:
        raise ValueError(f"MoE dispatch needs whole groups of {group} "
                         f"tokens, got {tokens} (batch x sequence)")
    return group


def dispatch(probs: torch.Tensor, top_k: int, cap: int):
    """Routing of one call: probs [G, T, E] -> (expert [G, T, K], weight
    [G, T, K] float32 with dropped pairs at 0, position in the expert's
    buffer [G, T, K], keep mask [G, T, K])."""
    n_groups, group, num_experts = probs.shape
    topw, tope = torch.topk(probs, top_k, dim=-1)              # [G, T, K]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = tope.reshape(n_groups, group * top_k)
    onehot = F.one_hot(flat, num_experts)                       # [G, TK, E]
    before = onehot.cumsum(dim=1) - onehot
    pos = before.gather(-1, flat[..., None]).reshape(n_groups, group, top_k)
    keep = pos < cap
    return tope, topw * keep, pos, keep


def apply_moe(params: Params, name: str, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, d] -> (y [b, s, d], aux loss, a float32 scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    dt = x.dtype
    tokens = b * s
    group = group_size(tokens)
    n_groups = tokens // group
    E, K = m.num_experts, m.top_k
    cap = _capacity(group, E, K, m.capacity_factor)

    xg = x.reshape(n_groups, group, d)
    logits = xg.float() @ params[f"{name}.router"].float()     # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    tope, weight, pos, keep = dispatch(probs, K, cap)

    # the slot table: the token filling each expert slot (e, c); dropped
    # pairs write the sink slot E * cap, which is cut off
    slot_idx = torch.where(keep, tope * cap + pos, E * cap).reshape(
        n_groups, group * K)
    token_ids = torch.arange(group, device=x.device).repeat_interleave(
        K).expand(n_groups, -1)
    slot_token = torch.zeros(n_groups, E * cap + 1, dtype=torch.long,
                             device=x.device).scatter_(1, slot_idx,
                                                       token_ids)
    slot_filled = torch.zeros(n_groups, E * cap + 1, dtype=dt,
                              device=x.device).scatter_(1, slot_idx, 1.0)
    # the expert-major payload [E, G * cap, d], an empty slot zero
    rows = (slot_token[:, :E * cap]
            + group * torch.arange(n_groups, device=x.device)[:, None])
    rows = rows.reshape(n_groups, E, cap).transpose(0, 1).reshape(E, -1)
    filled = slot_filled[:, :E * cap].reshape(n_groups, E, cap).transpose(
        0, 1).reshape(E, -1, 1)
    xe = x.reshape(tokens, d)[rows] * filled                   # [E, GC, d]

    h = (F.silu(torch.bmm(xe, params[f"{name}.w_gate"].to(dt)))
         * torch.bmm(xe, params[f"{name}.w_up"].to(dt)))
    ye = torch.bmm(h, params[f"{name}.w_down"].to(dt))         # [E, GC, d]

    # each pair's expert output, a dropped pair's from slot 0 (weight 0)
    gidx = torch.arange(n_groups, device=x.device)[:, None, None] * cap
    src = torch.where(keep, tope * (n_groups * cap) + gidx + pos, gidx)
    picked = ye.reshape(E * n_groups * cap, d)[src.reshape(-1)].reshape(
        n_groups, group, K, d)
    y = (picked.float() * weight[..., None]).sum(dim=2).to(dt)
    y = y.reshape(b, s, d)

    if m.num_shared_experts > 0:
        pre = f"{name}.shared"
        h = (F.silu(x @ params[f"{pre}.w_gate"].to(dt))
             * (x @ params[f"{pre}.w_up"].to(dt)))
        y = y + h @ params[f"{pre}.w_down"].to(dt)

    # the Switch load-balancing loss
    frac_tokens = F.one_hot(tope[..., 0], E).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    if _BATCH_STATS is not None:
        frac_tokens, frac_probs = _BATCH_STATS(frac_tokens, frac_probs)
    aux = E * (frac_tokens * frac_probs).sum() * m.aux_loss_weight
    return y, aux
