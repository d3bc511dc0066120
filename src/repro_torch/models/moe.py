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

Under a serving mesh whose expert axis (``ParallelConfig.expert_axis``,
``data`` by default) splits the experts, a rank holds ``E / size``
experts and the rows the batch axis gives it, and the groups stay the
whole batch's: where the rank's tokens make whole groups it routes them
and sends each expert's slots to its rank and back
(``sharding.expert_exchange``); where a group straddles ranks (a decode
step, a short prefill) the rank gathers the whole batch's tokens, routes
every group as one device does, multiplies its experts' slots and
gathers every expert's results; so does a rank whose rows are not split
over the expert axis (a cache split along its sequence over it, where
every rank holds every row), so that each expert multiplies each slot
once. The expert axis may be ``model`` itself: its group then holds
``E / size`` experts a rank with their widths whole (the reference's
specs give the experts' dim the axis first), and every rank routes the
whole batch, its experts' products whole. The expert weights'
``mlp`` columns on ``model`` make the products row-parallel; where
``model`` does not divide the experts' (or the shared expert's) width
the leaves stay whole, as the reference's specs leave them, and every
rank runs those products whole, summing nothing. The balance
loss is that of the rank's groups (serving does not read it).

A training step over a mesh (``train.steps``) gathers every expert (FSDP
over ``data``) and routes the rank's own rows; ``model`` splits the
experts' ``mlp`` width (the payload enters through ``layers.tp_in``),
and the step's ``sharding.RankContext`` turns the balance loss's two
per-expert means into the whole batch's (``batch_stats``). With the
experts over ``model`` (``expert_axis="model"``) FSDP gathers each
rank's ``E / size`` experts at their whole width; the ``model`` ranks
hold the same rows, so each routes them as one device does, multiplies
its own experts' slots and the results are gathered over ``model``
(``_gathered_experts``; ROADMAP C26). Where ``model`` does not divide
the experts they stay whole on every rank, and nothing is gathered.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.models.layers import (ParamDef, Params, Schema, model_split,
                                       row_parallel, tp_in)

#: tokens per dispatch group (capacity is per group and expert)
GROUP_SIZE = 256


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


def _local_experts(params: Params, name: str, xe: torch.Tensor,
                   d_ff: int) -> torch.Tensor:
    """Every held expert's products on its slots: xe [E_held, slots, d];
    split over ``model`` where the leaves' ``d_ff`` (of ``d_ff``) is."""
    dt = xe.dtype
    split = model_split(params[f"{name}.w_gate"].shape[2], d_ff)
    xe = tp_in(xe, split)
    h = (F.silu(torch.bmm(xe, params[f"{name}.w_gate"].to(dt)))
         * torch.bmm(xe, params[f"{name}.w_up"].to(dt)))
    return row_parallel(h, params[f"{name}.w_down"].to(dt), split)


def _exchanged_experts(params, name, xe, d_ff, mesh):
    """The experts' results for this rank's groups, xe [E, slots, d]:
    each expert's slots sent to its rank, multiplied there with the
    slots of every rank's groups, and returned."""
    n, held = mesh.expert_size, xe.shape[0] // mesh.expert_size
    got = sh.expert_exchange(xe, mesh.experts)          # [n * held, S, d]
    slots = got.shape[1]
    mine = got.reshape(n, held, slots, -1).transpose(0, 1).reshape(
        held, n * slots, -1)
    ye = _local_experts(params, name, mine, d_ff)
    back = ye.reshape(held, n, slots, -1).transpose(0, 1).reshape(
        n * held, slots, -1)
    return sh.expert_exchange(back, mesh.experts)       # [E, S, d]


def _gathered_experts(params, name, xe, d_ff, mesh):
    """The experts' results for the whole batch's groups, held by every
    rank: this rank's experts' slots multiplied and every rank's
    gathered. Under autograd the payload enters the rank's part
    (``sharding.tp_enter``: its gradient summed over the group) and the
    gather's backward keeps the rank's own slice (``sharding.tp_gather``),
    so each expert's gradient stays on the rank that holds it."""
    held = xe.shape[0] // mesh.expert_size
    lo = mesh.expert_rank * held
    xe = sh.tp_enter(xe, mesh.experts)
    return sh.tp_gather(_local_experts(params, name, xe[lo:lo + held], d_ff),
                        0, mesh.experts)


def _routed(params: Params, name: str, x: torch.Tensor, cfg: ModelConfig,
            experts) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts' output [b, s, d] and the balance loss:
    ``experts(xe)`` turns the expert-major payload [E, G * cap, d] into
    the experts' results."""
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
    ye = experts(xe)                                           # [E, GC, d]

    # each pair's expert output, a dropped pair's from slot 0 (weight 0)
    gidx = torch.arange(n_groups, device=x.device)[:, None, None] * cap
    src = torch.where(keep, tope * (n_groups * cap) + gidx + pos, gidx)
    picked = ye.reshape(E * n_groups * cap, d)[src.reshape(-1)].reshape(
        n_groups, group, K, d)
    y = (picked.float() * weight[..., None]).sum(dim=2).to(dt)

    # the Switch load-balancing loss
    frac_tokens = F.one_hot(tope[..., 0], E).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    stats = sh.context().batch_stats
    if stats is not None:
        frac_tokens, frac_probs = stats(frac_tokens, frac_probs)
    aux = E * (frac_tokens * frac_probs).sum() * m.aux_loss_weight
    return y.reshape(b, s, d), aux


def apply_moe(params: Params, name: str, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, d] -> (y [b, s, d], aux loss, a float32 scalar)."""
    m = cfg.moe
    mesh = sh.serve_mesh()
    b, s, _ = x.shape
    # the experts split over the expert axis, or whole on every rank where
    # it does not divide them (the reference's specs leave them whole)
    split = mesh is not None and mesh.expert_size > 1 and \
        params[f"{name}.w_gate"].shape[0] < m.num_experts
    if mesh is None or (mesh.batch_size == 1 and not split):
        y, aux = _routed(params, name, x, cfg,
                         lambda xe: _local_experts(params, name, xe, m.d_ff))
    elif (b * s) % min(GROUP_SIZE, b * s * mesh.batch_size) or (
            split and not mesh.rows_over_experts):
        # a group straddles the ranks, or the expert ranks hold the same
        # rows: route the whole batch, each rank multiplying its experts'
        # slots once
        whole = mesh.gather_rows(x)
        experts = (functools.partial(_gathered_experts, mesh=mesh)
                   if split else _local_experts)
        y, aux = _routed(params, name, whole, cfg,
                         lambda xe: experts(params, name, xe, m.d_ff))
        y = y.narrow(0, mesh.batch_rank * b, b)
    else:
        experts = (functools.partial(_exchanged_experts, mesh=mesh)
                   if split else _local_experts)
        y, aux = _routed(params, name, x, cfg,
                         lambda xe: experts(params, name, xe, m.d_ff))
    if m.num_shared_experts > 0:
        pre, dt = f"{name}.shared", x.dtype
        split = model_split(params[f"{pre}.w_gate"].shape[1],
                            m.d_ff * m.num_shared_experts)
        xs = tp_in(x, split)
        h = (F.silu(xs @ params[f"{pre}.w_gate"].to(dt))
             * (xs @ params[f"{pre}.w_up"].to(dt)))
        y = y + row_parallel(h, params[f"{pre}.w_down"].to(dt), split)
    return y, aux
