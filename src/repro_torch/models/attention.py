"""Attention blocks: GQA (MHA and MQA are special cases), MLA and
cross-attention.

Counterpart: ``repro.models.attention``. Caches are dicts of tensors
sized to the full serve context; prefill fills them from position 0,
decode writes the new K/V at per-sequence positions and masks by valid
length. Unlike the reference, which returns new arrays, the port writes
into the cache tensors in place (the reference's engine donates them).
q and k are rotated (``layers.apply_rope``) before the cache write, so
the cache holds rotated keys.

MLA (minicpm3) caches the compressed latent (``ckv``, kv_lora_rank wide)
and the one-head rotated ``k_rope``. Prefill expands them into per-head
K (nope + rope) and V and runs the flash kernel with q/k and v head dims
that differ; decode takes the absorbed form (scores over the latent in
float32, ``-1e30`` past the valid length, probabilities cast to the
compute dtype before the latent product), as the reference does.
Cross-attention (whisper's decoder) takes K/V from the encoder's output
at prefill, through the flash kernel without a causal mask, and keeps
them in its cache (``encoder_seq`` long) for decode, which reads them
through ``ref.sdpa``.

Under a serving mesh whose ``model`` axis divides the query heads each
rank runs its query heads (``wq``'s, ``wq_b``'s and ``wkv_b``'s columns)
and the KV heads they read (``wk`` / ``wv``'s columns: its share of
them, or where ``model`` exceeds the KV heads the one head its query
heads read); the head counts come from the shapes of the rank's leaves.
``wo`` is row-parallel (``layers.row_parallel``). Where the axis does not
divide the query heads, or where it splits them but neither splits
the KV heads nor is a multiple of them (12 over 3 KV heads at 4), the
reference's specs and ``constrain`` fall back and so does the port
(ROADMAP C19): each leaf is placed by its spec (``wq`` / ``wk`` / ``wv``
/ ``wq_b`` / ``wkv_b`` column shards where the axis divides the
flattened width, else whole; ``wo``'s rows likewise), a rank projects
with its shard and gathers the columns into whole heads
(``layers.tp_gather_parts``), attention runs over every head on every
rank, and the rank takes its rows of the output for ``wo``
(``layers.tp_slice``). MLA's absorbed decode over a ``wkv_b`` cut across
a head contracts each head with the columns the rank holds and sums the
partials over ``model`` (what is projected is gathered, never the
weight). MLA's latent, rope key and their cache are replicated over
``model``. Under autograd (training over a mesh) each replicated tensor
enters the rank's part of a split computation through ``layers.tp_in``:
x before the split products, MLA's query latent before ``wq_b``, its KV
latent before ``wkv_b`` and its rope key before it joins the rank's
heads.

With a cache split along its sequence (``ParallelConfig.shard_cache_seq``,
the reference's flash-decoding layout) a rank's self-attention cache
holds one chunk of the positions (every KV head where the sequence axes
include ``model``); prefill attends as above and writes each rank's
chunk, and decode combines the chunks' softmax over the sequence axes as
GSPMD partitions ``ref.sdpa`` (see the section below). So does a
cross-attention cache where the axes divide ``encoder_seq``: prefill
attends to the whole encoder output and writes the rank's chunk of its
K/V, decode combines the chunks with no mask (ROADMAP C25). A cache
whose length the axes do not divide is whole on every rank, as without
the split (``sharding.ServeMesh.seq_self`` / ``seq_cross``; C24).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import AttentionConfig, ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (ParamDef, Params, Schema, apply_rope,
                                       heads_split, model_split,
                                       row_parallel, tp_gather_parts, tp_in,
                                       tp_slice)

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


def kv_heads_cut(heads: int, kv_heads: int, size: int) -> bool:
    """Whether a rank's K/V leaves over a ``model`` axis of ``size`` hold
    just the KV heads its query heads read: the axis splits the query
    heads and either splits the KV heads or is a multiple of them (one
    head a rank, ROADMAP C23). Otherwise the KV leaves are placed by the
    reference's specs (a column shard gathered whole, or whole) and
    attention runs over every head on every rank."""
    return size > 1 and heads % size == 0 and (
        kv_heads % size == 0 or size % kv_heads == 0)


def _out_rows(out: torch.Tensor, wo: torch.Tensor,
              width: int) -> torch.Tensor:
    """``out`` [b, t, the heads held x d] through ``wo`` (``width`` rows
    whole): where ``wo``'s rows are split, the rank's part of ``out``
    (its own heads already, or its rows of every head) summed over
    ``model``; else the whole product."""
    return row_parallel(tp_slice(out, wo.shape[0]), wo,
                        model_split(wo.shape[0], width))


# ---------------------------------------------------------------------------
# a cache split along its sequence (flash-decoding over the mesh)
# ---------------------------------------------------------------------------
#
# Under ``ParallelConfig.shard_cache_seq`` each rank's self-attention
# cache holds one chunk of the sequence (rank ``seq_rank`` of the
# sequence axes holds positions [seq_rank * S_loc, (seq_rank + 1) *
# S_loc)); where the sequence axes include ``model`` the chunk holds
# every KV head (or MLA's latent), while the rank's query heads stay
# its own. A decode step gathers the new token's query heads (and its
# K/V heads, for the write) over ``model``, scores every head against
# the rank's chunk and combines the chunks as GSPMD partitions the
# reference's ``ref.sdpa``: the row max and then the row sum of the
# exponentials all-reduced in float32, P = exp / sum normalised on each
# rank and cast to V's dtype, P V summed over the sequence axes in
# float32 and rounded once. So bf16 rounds the same normalised P that one
# device rounds (ROADMAP C8), and only the order of the chunks' sum
# differs; the (max, sum, output) rescale of flash-decoding would round
# an unnormalised P instead.

def _seq_mesh(cross: bool = False) -> Optional[sh.ServeMesh]:
    """The step's serving mesh where its self-attention caches (with
    ``cross``, its cross-attention caches) are split along their
    sequence, else None."""
    mesh = sh.serve_mesh()
    if mesh is None or mesh.seq_size == 1:
        return None
    return mesh if (mesh.seq_cross if cross else mesh.seq_self) else None


def _all_heads(x: torch.Tensor, heads: int, mesh: sh.ServeMesh
               ) -> torch.Tensor:
    """x [b, t, the rank's heads, ...] -> [b, t, heads, ...]: every
    ``model`` rank's heads, where the sequence axes include ``model``
    (a head that several ranks hold, a KV head where ``model`` exceeds
    them, taken once); else, or where x holds every head already (the
    fall-back), x."""
    if not mesh.seq_over_model or mesh.model_size == 1 or \
            x.shape[2] == heads:
        return x
    full = sh.all_gather(x, 2, mesh.model)
    step = full.shape[2] // heads
    return full if step == 1 else full[:, :, ::step]


def _own_heads(x: torch.Tensor, mesh: sh.ServeMesh, local: int
               ) -> torch.Tensor:
    """The rank's ``local`` query heads of x [b, t, heads, ...]."""
    if x.shape[2] == local:
        return x
    return x.narrow(2, mesh.model_rank * local, local)


def _chunk(cache: torch.Tensor, mesh: sh.ServeMesh) -> Tuple[int, int]:
    """(the rank's first position, the whole sequence's length)."""
    s_loc = cache.shape[1]
    return mesh.seq_rank * s_loc, s_loc * mesh.seq_size


def _write_prompt(caches, news, mesh: sh.ServeMesh):
    """A prefill's write from position 0: each cache [b, S_loc, ...] takes
    its chunk's part of new [b, t, ...]."""
    lo, _ = _chunk(caches[0], mesh)
    n = max(0, min(news[0].shape[1] - lo, caches[0].shape[1]))
    for c, x in zip(caches, news):
        c[:, :n] = x[:, lo:lo + n].to(c.dtype)


def _write_token(caches, news, pos: torch.Tensor, mesh: sh.ServeMesh):
    """A decode step's write of one token a row at position ``pos`` [b]
    (clamped to the whole sequence, as ``_write_kv``): the rank whose
    chunk holds it writes it, every other keeps its chunk."""
    if news[0].shape[1] != 1:
        raise NotImplementedError("a cache split along its sequence is "
                                  "written one token a decode step")
    lo, total = _chunk(caches[0], mesh)
    s_loc = caches[0].shape[1]
    local = pos.long().clamp(0, total - 1) - lo
    inside = (local >= 0) & (local < s_loc)
    idx = local.clamp(0, s_loc - 1)
    rows = torch.arange(idx.shape[0], device=idx.device)
    for c, x in zip(caches, news):
        old = c[rows, idx]
        keep = inside.view((-1,) + (1,) * (old.dim() - 1))
        c[rows, idx] = torch.where(keep, x[:, 0].to(c.dtype), old)


def _kv_heads(k, v, a: AttentionConfig, mesh: sh.ServeMesh):
    """(k, v) [b, t, kh, hd] of the heads the rank's cache chunk holds:
    every KV head, gathered over ``model`` in one call, where the
    sequence axes include it; else the rank's own."""
    kv = _all_heads(torch.cat([k, v], dim=-1), a.num_kv_heads, mesh)
    return kv[..., :k.shape[-1]], kv[..., k.shape[-1]:]


def _seq_probs(logits: torch.Tensor, kv_len: torch.Tensor,
               mesh: sh.ServeMesh) -> torch.Tensor:
    """The softmax over the whole sequence of float32 logits [b, ...,
    S_loc] of the rank's chunk, positions past ``kv_len`` [b] masked as
    ``ref.sdpa`` masks them: the row max and the row sum all-reduced
    over the sequence axes."""
    s_loc = logits.shape[-1]
    lo = mesh.seq_rank * s_loc
    valid = (torch.arange(lo, lo + s_loc, device=logits.device)[None, :]
             < kv_len[:, None])
    valid = valid.view((valid.shape[0],) + (1,) * (logits.dim() - 2)
                       + (s_loc,))
    logits = torch.where(valid, logits, NEG_INF)
    top = sh.all_reduce(logits.amax(-1, keepdim=True), "max", mesh.seq)
    e = torch.exp(logits - top)
    return e / sh.all_reduce(e.sum(-1, keepdim=True), "sum", mesh.seq)


def _seq_sdpa(q, k, v, kv_len, mesh: sh.ServeMesh, heads: int,
              logit_cap: float = 0.0):
    """``ref.sdpa``'s decode (no causal mask, ``kv_len`` masking) over a
    cache chunk: q [b, t, the rank's heads (or all ``heads``), dq], k / v
    [b, S_loc, kh, d] -> [b, t, the rank's heads, dv] in ``v.dtype``."""
    local = q.shape[2]
    kh = k.shape[2]
    q = _all_heads(q, heads, mesh)
    b, sq, h, dq = q.shape
    qg = q.reshape(b, sq, kh, h // kh, dq).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * dq ** -0.5
    if logit_cap > 0.0:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    probs = _seq_probs(logits, kv_len, mesh)
    part = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                        v.float())
    out = sh.all_reduce(part, "sum", mesh.seq).to(v.dtype)
    return _own_heads(out.reshape(b, sq, h, -1), mesh, local)


def _cross_kv(params: Params, name: str, memory: Optional[torch.Tensor],
              cfg: ModelConfig, cache: Optional[Cache], dt: torch.dtype,
              split: bool, entered: bool,
              seq: Optional[sh.ServeMesh] = None):
    """Cross-attention's K/V [b, s_enc, heads held, hd]: projected from
    ``memory`` (the encoder's output) at prefill, the columns gathered
    into whole heads where ``split`` cuts one, and written into the cache
    as placed (with ``seq``, the cache split along its sequence: the
    rank's chunk of every head it holds); read back from it at decode
    (with ``seq``, the rank's chunk). ``entered``: the products are the
    rank's part of a split computation (``tp_in``)."""
    a = cfg.attention
    if memory is None:
        if cache is None or not cache.get("decode", False):
            raise ValueError(f"{name}: cross-attention needs the encoder's "
                             f"output at prefill")
        return cache["k"].to(dt), cache["v"].to(dt), cache
    b = memory.shape[0]
    memory = tp_in(memory, entered)
    k = memory @ params[f"{name}.wk"].to(dt)
    v = memory @ params[f"{name}.wv"].to(dt)
    if split:
        k, v = tp_gather_parts([k, v])
    k = k.reshape(b, memory.shape[1], -1, a.head_dim)
    v = v.reshape(b, memory.shape[1], -1, a.head_dim)
    if cache is not None:
        news = (k, v) if seq is None else _kv_heads(k, v, a, seq)
        want = list(news[0].shape)
        if seq is not None:
            want[1] //= seq.seq_size
        if list(cache["k"].shape) != want:
            raise ValueError(f"{name}: the encoder's output gives K/V "
                             f"{tuple(want)} a rank, the cache holds "
                             f"{tuple(cache['k'].shape)} (encoder_seq "
                             f"{cfg.encoder_seq})")
        if seq is None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
        else:
            _write_prompt((cache["k"], cache["v"]), news, seq)
    return k, v, cache


def apply_gqa(params: Params, name: str, x: torch.Tensor,
              positions: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Cache] = None,
              memory: Optional[torch.Tensor] = None,
              is_cross: bool = False
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x [b, t, d]. Prefill: t is the whole prompt; a cache, if given, is
    filled from position 0. Decode (``cache["decode"]``): t new tokens
    attend to the cache's first ``length + t`` entries. ``is_cross`` (or
    a ``memory`` [b, s_enc, d]): cross-attention, K/V from the encoder's
    output (``memory`` at prefill, the cache at decode), no mask."""
    a = cfg.attention
    b, t, _ = x.shape
    dt = x.dtype
    H, hd = a.num_heads, a.head_dim
    mesh = sh.serve_mesh()
    wq, wk = params[f"{name}.wq"], params[f"{name}.wk"]
    # the rank's query heads and the KV heads they read, else every head
    local = heads_split(H) and kv_heads_cut(H, a.num_kv_heads,
                                            mesh.model_size)
    q_split = model_split(wq.shape[1], H * hd)
    kv_split = model_split(wk.shape[1], a.num_kv_heads * hd)
    # columns that cut a head are gathered into whole heads
    q_gather, kv_gather = q_split and not local, kv_split and not local
    cross = is_cross or memory is not None
    x_in = tp_in(x, q_split or (not cross and (kv_split or local)))
    q = (x_in if q_split else x) @ wq.to(dt)
    if cross:
        if q_gather:
            q, = tp_gather_parts([q])
        seq = _seq_mesh(cross=True) if cache is not None else None
        k, v, cache = _cross_kv(params, name, memory, cfg, cache, dt,
                                kv_gather, kv_split or local, seq)
        if seq is not None and memory is None:
            # decode over the rank's chunk of the encoder's K/V
            whole = torch.full((b,), cfg.encoder_seq, dtype=torch.int32,
                               device=x.device)
            out = _seq_sdpa(q.reshape(b, t, -1, hd), k, v, whole, seq, H,
                            a.logit_cap)
        else:
            out = ops.sdpa(q.reshape(b, t, -1, hd), k, v, causal=False,
                           logit_cap=a.logit_cap)
        return _out_rows(out.reshape(b, t, -1), params[f"{name}.wo"].to(dt),
                         H * hd), cache
    src = x_in if (kv_split or local) else x
    k = src @ wk.to(dt)
    v = src @ params[f"{name}.wv"].to(dt)
    gathered = tp_gather_parts([y for y, g in ((q, q_gather), (k, kv_gather),
                                               (v, kv_gather)) if g])
    if q_gather:
        q = gathered.pop(0)
    if kv_gather:
        k, v = gathered
    q = q.reshape(b, t, -1, hd)
    k = k.reshape(b, t, -1, hd)
    v = v.reshape(b, t, -1, hd)
    if a.rope != "none":
        q = apply_rope(q, positions, a)
        k = apply_rope(k, positions, a)

    seq = _seq_mesh() if cache is not None else None
    if cache is not None and cache.get("decode", False):
        pos = cache["length"]                                   # [b] int32
        new_len = pos + t
        if seq is None:
            ck, cv = _write_kv(cache["k"], cache["v"], k, v, pos)
            out = ops.sdpa(q, ck.to(dt), cv.to(dt), causal=False,
                           logit_cap=a.logit_cap, kv_len=new_len)
        else:
            ck, cv = cache["k"], cache["v"]
            _write_token((ck, cv), _kv_heads(k, v, a, seq), pos, seq)
            out = _seq_sdpa(q, ck.to(dt), cv.to(dt), new_len, seq, H,
                            a.logit_cap)
        cache = dict(cache, k=ck, v=cv, length=new_len)
    else:
        out = ops.sdpa(q, k, v, causal=a.causal, logit_cap=a.logit_cap)
        if cache is not None:                                   # prefill
            if seq is None:
                ck, cv = _write_kv(cache["k"], cache["v"], k, v,
                                   torch.zeros(b, dtype=torch.int32,
                                               device=x.device))
            else:
                ck, cv = cache["k"], cache["v"]
                _write_prompt((ck, cv), _kv_heads(k, v, a, seq), seq)
            cache = dict(cache, k=ck, v=cv,
                         length=torch.full((b,), t, dtype=torch.int32,
                                           device=x.device))
    return _out_rows(out.reshape(b, t, -1), params[f"{name}.wo"].to(dt),
                     H * hd), cache


def gqa_cache_schema(cfg: ModelConfig, name: str, batch: int,
                     max_len: int, cross: bool = False) -> Schema:
    """Self-attention's K/V cache (``max_len`` long), or with ``cross``
    cross-attention's (``cfg.encoder_seq`` long)."""
    a = cfg.attention
    s_len = cfg.encoder_seq if cross else max_len
    return {
        f"{name}.k": ParamDef((batch, s_len, a.num_kv_heads, a.head_dim),
                              ("batch", "cache_seq", "kv_heads", None),
                              "zeros"),
        f"{name}.v": ParamDef((batch, s_len, a.num_kv_heads, a.head_dim),
                              ("batch", "cache_seq", "kv_heads", None),
                              "zeros"),
    }


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_schema(cfg: ModelConfig, name: str) -> Schema:
    a = cfg.attention
    d = cfg.d_model
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    s: Schema = {}
    if a.q_lora_rank > 0:
        s[f"{name}.wq_a"] = ParamDef((d, a.q_lora_rank), ("embed", "rank"))
        s[f"{name}.q_norm"] = ParamDef((a.q_lora_rank,), ("rank",), "ones")
        s[f"{name}.wq_b"] = ParamDef((a.q_lora_rank, a.num_heads * qk),
                                     ("rank", "heads"))
    else:
        s[f"{name}.wq"] = ParamDef((d, a.num_heads * qk), ("embed", "heads"))
    s[f"{name}.wkv_a"] = ParamDef((d, a.kv_lora_rank + a.qk_rope_head_dim),
                                  ("embed", "rank"))
    s[f"{name}.kv_norm"] = ParamDef((a.kv_lora_rank,), ("rank",), "ones")
    s[f"{name}.wkv_b"] = ParamDef(
        (a.kv_lora_rank, a.num_heads * (a.qk_nope_head_dim + a.v_head_dim)),
        ("rank", "heads"))
    s[f"{name}.wo"] = ParamDef((a.num_heads * a.v_head_dim, d),
                               ("heads", "embed"))
    return s


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, cast back (MLA's latent norms)."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _rope_cfg(a: AttentionConfig) -> AttentionConfig:
    """MLA rotates its rope parts with standard RoPE over their width."""
    return AttentionConfig(rope="standard", rope_theta=a.rope_theta)


def _mla_q(params: Params, name: str, x: torch.Tensor,
           a: AttentionConfig, eps: float) -> Tuple[torch.Tensor, bool]:
    """(q [b, t, the columns held], whether they cut a head): the query
    projection through ``wq_b`` (or ``wq``) as the leaf is placed."""
    dt = x.dtype
    w = params[f"{name}.wq_b" if a.q_lora_rank > 0 else f"{name}.wq"]
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    split = model_split(w.shape[1], a.num_heads * qk)
    if a.q_lora_rank > 0:
        x = x @ params[f"{name}.wq_a"].to(dt)
        x = _rms(x, params[f"{name}.q_norm"], eps)
    return tp_in(x, split) @ w.to(dt), split and not heads_split(a.num_heads)


def _head_window(w: torch.Tensor, width: int):
    """(first head, w [r, n, width]) of a rank's column shard w [r, c] of
    a [r, heads x width] leaf cut across heads: the n heads its columns
    touch, zeros where another rank holds the columns."""
    mesh = sh.serve_mesh()
    c0 = mesh.model_rank * w.shape[1]
    h0, h1 = c0 // width, -(-(c0 + w.shape[1]) // width)
    pad = w.new_zeros(w.shape[0], (h1 - h0) * width)
    pad[:, c0 - h0 * width:c0 - h0 * width + w.shape[1]] = w
    return h0, pad.reshape(w.shape[0], h1 - h0, width)


def _head_sum(part: torch.Tensor, h0: int, heads: int,
              dt: torch.dtype) -> torch.Tensor:
    """The ranks' float32 partials [b, t, n, d] of heads h0 .. h0 + n,
    placed among every head and summed over ``model``, rounded once."""
    mesh = sh.serve_mesh()
    b, t, n, d = part.shape
    whole = part.new_zeros(b, t, heads, d)
    whole[:, :, h0:h0 + n] = part
    return sh.model_sum(whole, mesh.model).to(dt)


def apply_mla(params: Params, name: str, x: torch.Tensor,
              positions: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Cache] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x [b, t, d]. Prefill expands the latent into K and V per head and
    runs ``ops.sdpa`` at q/k head dim nope + rope and v head dim
    ``v_head_dim`` with scale (nope + rope)^-0.5; decode scores the new
    queries against the cached latent directly (absorbed form)."""
    a = cfg.attention
    b, t, _ = x.shape
    dt = x.dtype
    H = a.num_heads
    n_nope, n_rope, n_v = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    r = a.kv_lora_rank
    scale = (n_nope + n_rope) ** -0.5
    local = heads_split(H)

    kv_a = x @ params[f"{name}.wkv_a"].to(dt)
    ckv = _rms(kv_a[..., :r], params[f"{name}.kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., None, r:], positions,
                        _rope_cfg(a))                       # [b, t, 1, rope]
    q, q_gather = _mla_q(params, name, x, a, cfg.norm_eps)

    w_kv = params[f"{name}.wkv_b"].to(dt)
    kv_split = model_split(w_kv.shape[1], H * (n_nope + n_v))
    kv_gather = kv_split and not local
    # the rank's heads, or every head (the fall-back)
    heads = w_kv.shape[1] // (n_nope + n_v) if local else H

    seq = _seq_mesh() if cache is not None else None
    decode = cache is not None and cache.get("decode", False)
    if q_gather:
        q, = tp_gather_parts([q])
    q = q.reshape(b, t, heads, n_nope + n_rope)
    q_nope = q[..., :n_nope]
    q_rope = apply_rope(q[..., n_nope:], positions, _rope_cfg(a))
    if decode:
        pos = cache["length"]
        cckv, ckr = cache["ckv"], cache["k_rope"]
        if seq is None:
            _write_kv(cckv[..., None], ckr, ckv[..., None], k_rope, pos)
        else:
            _write_token((cckv, ckr), (ckv, k_rope), pos, seq)
        new_len = pos + t
        if kv_gather:
            # wkv_b's columns cut a head: each rank contracts the heads
            # its columns touch and the partials are summed
            h0, window = _head_window(w_kv, n_nope + n_v)
            n = window.shape[1]
            q_abs = _head_sum(torch.einsum(
                "bthn,rhn->bthr", q_nope[:, :, h0:h0 + n].float(),
                window[..., :n_nope].float()), h0, H, dt)
        else:
            wkv_b = w_kv.reshape(r, heads, n_nope + n_v)
            q_abs = torch.einsum("bthn,rhn->bthr", q_nope,
                                 wkv_b[..., :n_nope])         # [b, t, h, r]
        if seq is not None:
            # every query head against the rank's chunk of the latent
            qa = _all_heads(torch.cat([q_abs, q_rope], dim=-1), H, seq)
            q_abs, q_rope = qa[..., :r], qa[..., r:]
        logits = (torch.einsum("bthr,bsr->bhts", q_abs.float(),
                               cckv.float())
                  + torch.einsum("bthn,bsn->bhts", q_rope.float(),
                                 ckr[:, :, 0].float())) * scale
        if seq is None:
            valid = (torch.arange(cckv.shape[1], device=x.device)[None, :]
                     < new_len[:, None])
            logits = torch.where(valid[:, None, None, :], logits, -1e30)
            probs = torch.softmax(logits, dim=-1)
            out_lat = torch.einsum("bhts,bsr->bthr", probs.to(dt),
                                   cckv.to(dt))
        else:
            probs = _seq_probs(logits, new_len, seq)
            part = torch.einsum("bhts,bsr->bthr", probs.to(dt).float(),
                                cckv.to(dt).float())
            out_lat = _own_heads(sh.all_reduce(part, "sum", seq.seq).to(dt),
                                 seq, heads)
        if kv_gather:
            out = _head_sum(torch.einsum(
                "bthr,rhv->bthv", out_lat[:, :, h0:h0 + n].float(),
                window[..., n_nope:].float()), h0, H, dt)
        else:
            out = torch.einsum("bthr,rhv->bthv", out_lat,
                               wkv_b[..., n_nope:])
        cache = dict(cache, ckv=cckv, k_rope=ckr, length=new_len)
    else:
        kv = tp_in(ckv, kv_split) @ w_kv
        if kv_gather:
            kv, = tp_gather_parts([kv])
        kv = kv.reshape(b, t, heads, n_nope + n_v)
        k_nope, v = kv[..., :n_nope], kv[..., n_nope:]
        k = torch.cat([k_nope, tp_in(k_rope, local).expand(b, t, heads,
                                                            n_rope)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = ops.sdpa(q, k, v, causal=a.causal, scale=scale)
        if cache is not None and seq is not None:
            _write_prompt((cache["ckv"], cache["k_rope"]), (ckv, k_rope),
                          seq)
        elif cache is not None:
            _write_kv(cache["ckv"][..., None], cache["k_rope"],
                      ckv[..., None], k_rope,
                      torch.zeros(b, dtype=torch.int32, device=x.device))
            cache = dict(cache, length=torch.full((b,), t, dtype=torch.int32,
                                                  device=x.device))
    return _out_rows(out.reshape(b, t, heads * n_v),
                     params[f"{name}.wo"].to(dt), H * n_v), cache


def mla_cache_schema(cfg: ModelConfig, name: str, batch: int,
                     max_len: int) -> Schema:
    a = cfg.attention
    return {
        f"{name}.ckv": ParamDef((batch, max_len, a.kv_lora_rank),
                                ("batch", "cache_seq", None), "zeros"),
        f"{name}.k_rope": ParamDef((batch, max_len, 1, a.qk_rope_head_dim),
                                   ("batch", "cache_seq", None, None),
                                   "zeros"),
    }
