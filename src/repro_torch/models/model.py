"""Top-level model API: schemas, init, loss, prefill, decode.

Counterpart: ``repro.models.model``. Batch convention:
  train / prefill: {"tokens": [b, s_text] int, "positions": [b, s] or
            [3, b, s] (optional), "loss_mask": [b, s] (train only,
            optional), "embeds": [b, n_patch, d] (vision frontend stub,
            optional), "frames": [b, encoder_seq, d] (audio frontend stub,
            needed by an encoder-decoder)}   (+ the cache to fill)
  decode:  {"token": [b, 1] int} + the cache (which holds per-row lengths)

``loss_fn`` is the reference's training loss: next-token cross-entropy
over the text positions (after any patch embeddings), a float32
logsumexp, the loss mask, and the MoE balance loss. Called with
parameters that require grad, its attention and scans take the
reference's training semantics (``kernels/ops.py``).

Every config of ``configs`` runs: GQA attention blocks with standard,
partial or M-RoPE or none, or MLA (minicpm3); Mamba (Jamba-1.5) and
RWKV-6 (rwkv6-7b) blocks; a dense MLP or experts; the vision frontend
stub (qwen2-vl: precomputed patch embeddings at model width, placed
before the tokens) and the encoder-decoder (whisper: precomputed frames
through the encoder stack and ``encoder_norm``, sinusoidal positions on
frames and decoder tokens, the decoder's blocks attending to the
encoder's output). ``init_params`` and ``init_cache`` take ``device=``
(default ``"cuda"``) and raise without a card. Caches are updated in
place; ``prefill`` and ``decode_step`` return the same dict.

Serving over a mesh (``serve_placement``): each rank holds its shard of
every parameter and cache leaf, laid out by the reference's
``partition_specs`` / ``cache_partition_specs`` with the FSDP axis
(``embed``) left whole (serving gathers no weights; ROADMAP C20), and
in the compute layout where that differs from the specs' contiguous
chunks: a Mamba ``in_proj`` takes the rank's channels of both halves
(x and z), and where ``model`` exceeds the KV heads ``wk`` / ``wv`` and
the K/V caches hold the one head the rank's query heads read
(``distributed.sharding.split_index``). ``init_params(placement=)``
draws each leaf whole, keeps the rank's part and frees the rest, so the
draws are one device's; ``checkpoint.gather_tree`` over the placement
gives the whole leaves back. With ``ParallelConfig.shard_cache_seq`` the
self-attention caches and whisper's cross-attention caches are split
along their sequence over ``seq_axis`` (a name or a tuple of axes), as
the reference's specs split them; where ``model`` carries the sequence
the KV heads stay whole (its specs drop ``kv_heads`` there). A cache
whose length the axes do not divide stays whole along its sequence, as
the reference's spec leaves it, with its warning (``serve_mesh_of``
then splits no work of it); a spec that would name an axis twice
raises.
``prefill`` / ``decode_step`` take the rank's rows and leaves, inside
the step's ``sharding.serving`` block (``serve.steps``).

Training over a mesh (``train_layout``, ``train.steps``) computes in the
same layout with ``embed`` split over the FSDP axis, as the reference's
specs split it (FSDP gathers it before the forward); ``loss_fn`` over a
vocabulary split over ``model`` reduces the rank's columns of the logits
where they lie (``sharding.model_sum`` of the [b, s] sums of
exponentials and gold logits) and never gathers them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (ParamDef, Params, Schema, apply_norm,
                                       compute_dtype, embed_schema,
                                       embed_tokens, init_from_schema,
                                       norm_schema, sinusoidal_embed,
                                       specs_from_schema, unembed)

#: leaves the reference reads in float32 (norm scales and biases, MLA's
#: latent norms, the SSM's dt_bias, A_log and D, RWKV-6's decay_base,
#: decay_w2 and bonus, and the MoE router); every other leaf it casts to
#: the compute dtype at use
FLOAT32_LEAVES = ("scale", "bias", "q_norm", "kv_norm", "dt_bias", "A_log",
                  "D", "decay_base", "decay_w2", "bonus", "router")


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack of an encoder-decoder: ``encoder_layers``
    attention blocks, not causal, no RoPE, dense MLPs."""
    return dataclasses.replace(
        cfg, num_layers=cfg.encoder_layers, block_pattern=("attn",),
        attention=dataclasses.replace(cfg.attention, causal=False,
                                      rope="none"),
        moe=None, moe_every=0)


def full_schema(cfg: ModelConfig) -> Schema:
    s: Schema = {}
    s.update(embed_schema(cfg))
    s.update(tf.stack_params_schema(cfg, "stack", cross=cfg.encdec))
    s.update(norm_schema(cfg, "final_norm"))
    if cfg.encdec:
        ecfg = encoder_cfg(cfg)
        s.update(tf.stack_params_schema(ecfg, "encoder"))
        s.update(norm_schema(ecfg, "encoder_norm"))
    return s


def _is_float32_leaf(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in FLOAT32_LEAVES


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                compute: bool = False, placement=None) -> Params:
    """Random parameters on ``device``, drawn in float32 from a
    ``torch.Generator`` seeded with ``seed`` on that device, a stacked
    leaf one group at a time. In ``cfg.param_dtype``, or with
    ``compute=True`` in the form ``compute_params`` gives (matrices in the
    compute dtype, ``FLOAT32_LEAVES`` in float32) with no float32 copy of
    a whole leaf: the way to draw a model whose float32 parameters do not
    fit the card. With ``placement`` (``serve_placement``'s parameter
    shardings) each leaf is drawn whole, this rank's shard kept and the
    rest freed: the draws are one device's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    param_dt = getattr(torch, cfg.param_dtype)
    cdt = compute_dtype(cfg)
    if compute:
        def dtype_of(name):
            return torch.float32 if _is_float32_leaf(name) else cdt
    else:
        def dtype_of(name):
            return param_dt
    place = None
    if placement is not None:
        def place(name, w):
            return placement[name].shard(w)
    return init_from_schema(full_schema(cfg), gen, dtype_of, dev, place)


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameters' shapes and dtype as ``meta`` tensors (no memory):
    the counterpart of the reference's ``ShapeDtypeStruct`` tree."""
    dt = getattr(torch, cfg.param_dtype)
    return {name: torch.empty(d.shape, dtype=dt, device="meta")
            for name, d in sorted(full_schema(cfg).items())}


def partition_specs(cfg: ModelConfig, rules: Dict[str, object],
                    mesh_shape: Dict[str, int]) -> Dict[str, tuple]:
    """Each parameter's spec over a mesh of ``mesh_shape`` under
    ``rules`` (``distributed.sharding.build_rules``)."""
    return specs_from_schema(full_schema(cfg), rules, mesh_shape)


def _numel(shape) -> int:
    n = 1
    for dim in shape:
        n *= dim
    return n


def param_count(cfg: ModelConfig) -> int:
    return sum(_numel(d.shape) for d in full_schema(cfg).values())


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE counts top_k + shared experts)."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    total = 0
    for name, d in full_schema(cfg).items():
        n = _numel(d.shape)
        if ".moe.w_" in name:          # routed expert weights
            n = n * (m.top_k / m.num_experts)
        total += int(n)
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
        keep = _is_float32_leaf(name)
        out[name] = w.to(device=dev, dtype=w.dtype if keep else cdt)
    return out


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _stack_cache(cache: Params) -> Params:
    return {k[len("stack."):]: v for k, v in cache.items()
            if k.startswith("stack.")}


def _default_positions(cfg: ModelConfig, b: int, s: int, device,
                       offset=0) -> torch.Tensor:
    """Positions 0 .. s - 1 (+ ``offset``) for every row: [b, s], or
    [3, b, s] under M-RoPE (the three rows equal, as for text)."""
    pos = (torch.arange(s, dtype=torch.int32, device=device)[None, :]
           + offset).expand(b, s)
    if cfg.attention.rope == "mrope":
        return pos[None].expand(3, b, s)
    return pos


def _encode(params: Params, cfg: ModelConfig,
            frames: torch.Tensor) -> torch.Tensor:
    """The encoder's output [b, s_enc, d]: frames plus sinusoidal
    positions through the encoder stack and ``encoder_norm``."""
    ecfg = encoder_cfg(cfg)
    b, s, _ = frames.shape
    x = frames.to(compute_dtype(cfg))
    x = x + sinusoidal_embed(torch.arange(s, device=x.device),
                             cfg.d_model)[None].to(x.dtype)
    pos = _default_positions(ecfg, b, s, x.device)
    x, _, _ = tf.apply_stack(params, ecfg, x, pos, prefix="encoder")
    return apply_norm(params, "encoder_norm", x, ecfg)


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """(x [b, s, d], positions, the encoder's output or None): patch
    embeddings (``embeds``) before the tokens; for an encoder-decoder the
    frames through the encoder and sinusoidal positions on the tokens."""
    x = embed_tokens(params, batch["tokens"], cfg)
    memory = None
    if cfg.frontend == "vision" and "embeds" in batch:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
    if cfg.encdec:
        if "frames" not in batch:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: its prefill needs "
                f"'frames' [b, {cfg.encoder_seq}, {cfg.d_model}] beside "
                f"the tokens (the audio frontend's stub output)")
        memory = _encode(params, cfg, batch["frames"])
        x = x + sinusoidal_embed(torch.arange(x.shape[1], device=x.device),
                                 cfg.d_model)[None].to(x.dtype)
    b, s, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, b, s, x.device)
    return x, positions, memory


def forward(params: Params, cfg: ModelConfig, batch: Dict,
            cache: Optional[Params] = None, decode: bool = False,
            remat: str = "none", gather_logits: bool = True
            ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Full forward. Returns (logits [b, s, vocab], the cache updated in
    place or None, aux loss). ``remat``: the decoder stack's training
    remat policy (``transformer.REMAT_POLICIES``). ``gather_logits=False``
    leaves a vocabulary split over ``model`` as this rank's columns."""
    if decode:
        tokens = batch["token"]
        b, t = tokens.shape
        x = embed_tokens(params, tokens, cfg)
        lengths = cache["length"]
        if cfg.encdec:
            # the absolute position at each row's current length
            x = x + sinusoidal_embed(lengths.float(),
                                     cfg.d_model)[:, None].to(x.dtype)
        positions = lengths[:, None].to(torch.int32)
        if cfg.attention.rope == "mrope":
            positions = positions[None].expand(3, b, t)
        y, _, aux = tf.apply_stack(params, cfg, x, positions,
                                   cache=_stack_cache(cache), decode=True,
                                   lengths=lengths, prefix="stack",
                                   cross=cfg.encdec)
        cache["length"] = lengths + t
    else:
        x, positions, memory = _embed_inputs(params, cfg, batch)
        b, s, _ = x.shape
        stack_cache = None if cache is None else _stack_cache(cache)
        lengths = None if cache is None else cache["length"]
        y, _, aux = tf.apply_stack(params, cfg, x, positions,
                                   cache=stack_cache, decode=False,
                                   lengths=lengths, prefix="stack",
                                   memory=memory, cross=cfg.encdec,
                                   remat=remat)
        if cache is not None:
            cache["length"] = torch.full((b,), s, dtype=torch.int32,
                                         device=x.device)
    y = apply_norm(params, "final_norm", y, cfg)
    return unembed(params, y, cfg, gather_logits), cache, aux


def loss_mask(batch: Dict) -> torch.Tensor:
    """The float32 weights [b, s_text - 1] of the scored next-token
    positions: ``loss_mask`` past the first text token, or ones."""
    tokens = batch["tokens"]
    n_text = tokens.shape[1]
    mask = batch.get("loss_mask")
    if mask is None:
        return torch.ones((tokens.shape[0], n_text - 1), dtype=torch.float32,
                          device=tokens.device)
    return mask[:, -n_text:][:, 1:].to(torch.float32)


def _split_logz_gold(lg: torch.Tensor, targets: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, gold logit) [b, s] of float32 logits whose vocabulary
    ``model`` splits, ``lg`` this rank's columns [b, s, V / m]: the
    row's max over every rank (no gradient: the logsumexp does not
    depend on it), each rank's sum of exponentials below it and its gold
    logit where the target is one of its columns, both summed over
    ``model``."""
    mesh = sh.serve_mesh()
    width = lg.shape[-1]
    top = sh.all_reduce(lg.detach().amax(dim=-1), "max", mesh.model)
    local = targets - mesh.model_rank * width
    inside = (local >= 0) & (local < width)
    gold = torch.gather(lg, -1, local.clamp(0, width - 1)[..., None])[..., 0]
    part = torch.stack([torch.exp(lg - top[..., None]).sum(dim=-1),
                        gold * inside])
    total, gold = sh.model_sum(part, mesh.model).unbind(0)
    return top + torch.log(total), gold


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict,
            remat: str = "none", denom: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """(loss, {"loss", "nll", "aux", "tokens"}): the mean next-token
    negative log-likelihood over the unmasked text positions (float32
    logsumexp; the logits of prepended patch embeddings are not scored),
    plus the MoE balance loss ``aux``; ``tokens`` is the mask's sum
    (at least 1), the mean's denominator. A rank of a data mesh passes
    ``denom``, the whole batch's denominator, so its rows' ``nll`` is
    their share of the whole batch's mean. A vocabulary split over
    ``model`` is reduced where it lies (``_split_logz_gold``)."""
    logits, _, aux = forward(params, cfg, batch, remat=remat,
                             gather_logits=False)
    tokens = batch["tokens"]
    n_text = tokens.shape[1]
    lg = logits[:, -n_text:][:, :-1].to(torch.float32)
    targets = tokens[:, 1:].long()
    mask = loss_mask(batch)
    if lg.shape[-1] < cfg.vocab_size:
        logz, gold = _split_logz_gold(lg, targets)
    else:
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, targets[..., None])[..., 0]
    nll = (logz - gold) * mask
    if denom is None:
        denom = torch.clamp_min(mask.sum(), 1.0)
    nll_mean = nll.sum() / denom
    loss = nll_mean + aux
    return loss, {"loss": loss, "nll": nll_mean, "aux": aux,
                  "tokens": denom}


# ---------------------------------------------------------------------------
# Serve caches
# ---------------------------------------------------------------------------

def cache_schema(cfg: ModelConfig, batch: int, max_len: int) -> Schema:
    s = tf.stack_cache_schema(cfg, batch, max_len, "stack",
                              cross=cfg.encdec)
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
               device="cuda", placement=None) -> Params:
    """Zeroed caches for ``batch`` rows of ``max_len``; with
    ``placement`` (``serve_placement``'s cache shardings of a ``batch``
    of the whole batch) only this rank's shard of each leaf."""
    dev = resolve_device(device)
    return {name: torch.zeros(d.shape if placement is None
                              else placement[name].local_shape,
                              dtype=_cache_dtype(cfg, name), device=dev)
            for name, d in cache_schema(cfg, batch, max_len).items()}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    """The cache's shapes and dtypes as ``meta`` tensors (no memory): the
    counterpart of the reference's ``abstract_cache``."""
    return {name: torch.empty(d.shape, dtype=_cache_dtype(cfg, name),
                              device="meta")
            for name, d in cache_schema(cfg, batch, max_len).items()}


def cache_partition_specs(cfg: ModelConfig, batch: int, max_len: int,
                          rules: Dict[str, object],
                          mesh_shape: Dict[str, int]) -> Dict[str, tuple]:
    """Each cache leaf's spec over a mesh of ``mesh_shape``."""
    return specs_from_schema(cache_schema(cfg, batch, max_len), rules,
                             mesh_shape)


# ---------------------------------------------------------------------------
# Serving placement
# ---------------------------------------------------------------------------

#: leaves whose last dim holds the KV heads (GQA's and cross-attention's
#: K/V projections) and the K/V caches, whose dim -2 does
_KV_WEIGHTS = (".attn.wk", ".attn.wv", ".cross.wk", ".cross.wv")
_KV_CACHES = (".attn.k", ".attn.v", ".cross.k", ".cross.v")


def check_serve_model_axis(cfg: ModelConfig, size: int,
                           axis: str = "model") -> List[Tuple[str, int]]:
    """The widths a ``model`` axis ``axis`` of ``size`` does not divide,
    ``[(the reference's activation axis, width)]``, each warned once a
    process with the reference's ``constrain`` message (and an ``obs``
    event each call): there the reference's specs leave a leaf whole, or
    cut its flattened columns across a head, and its ``constrain``
    replicates the activations; the blocks fall back alike (ROADMAP C19,
    ``models.attention``, ``layers.model_split``). The query heads (of the
    decoder and an encoder) as ``heads_act``; the KV heads as
    ``kv_heads_act`` unless the axis splits the query heads and is a
    multiple of the KV heads (a whole head a rank, C23); the MLP and
    expert widths as ``mlp_act``; Mamba's ``d_inner`` and RWKV's heads as
    ``heads_act``. The vocabulary is warned where it is embedded
    (``layers.embed_tokens``)."""
    if size == 1:
        return []
    widths = []
    kinds = set(cfg.block_pattern)
    if "attn" in kinds:
        a = cfg.attention
        widths.append(("heads_act", a.num_heads))
        if a.kind != "mla" and not attn_mod.kv_heads_cut(
                a.num_heads, a.num_kv_heads, size) and \
                a.num_kv_heads % size:
            widths.append(("kv_heads_act", a.num_kv_heads))
    if cfg.moe is not None:
        widths.append(("mlp_act", cfg.moe.d_ff))
    if not all(cfg.layer_uses_moe(i) for i in range(len(cfg.block_pattern))):
        widths.append(("mlp_act", cfg.d_ff))        # a dense or channel mix
    if "mamba" in kinds:
        widths.append(("heads_act", cfg.ssm.expand * cfg.d_model))
    if "rwkv" in kinds:
        widths.append(("heads_act", cfg.d_model // cfg.rwkv.head_dim))
    out = []
    for what, n in widths:
        if n % size:
            sh._warn_replicated(f"constrain(logical axis {what!r})", axis,
                                n, size)
            out.append((what, n))
    return out


def serve_specs(cfg: ModelConfig, parallel: ParallelConfig, mesh,
                batch: int, max_len: int):
    """(parameter specs, cache specs) a serving rank is placed by: the
    reference's, with the FSDP axis (``embed``) left whole."""
    rules = dict(sh.build_rules(parallel, mesh), embed=None)
    shape = sh.mesh_shape_dict(mesh)
    return (partition_specs(cfg, rules, shape),
            cache_partition_specs(cfg, batch, max_len, rules, shape))


def _with_entry(spec: tuple, dim: int, axis: str) -> tuple:
    out = list(spec)
    out[dim] = axis
    return tuple(out)


def _compute_layout(cfg: ModelConfig, schema: Schema, specs, tp: str,
                    size: int, kv_names, kv_dim: int):
    """{name: (spec, shape, kind)}: ``specs`` in the compute layout (see
    the module docstring) over a ``model`` axis ``tp`` of ``size``: a
    Mamba ``in_proj``'s halves where the axis divides ``d_inner``, and the
    KV heads a rank's query heads read where the axis splits the query
    heads (``attention.kv_heads_cut``); every other leaf by its spec."""
    a, out = cfg.attention, {}
    halves = cfg.ssm is not None and \
        (cfg.ssm.expand * cfg.d_model) % size == 0
    kv_cut = "attn" in cfg.block_pattern and attn_mod.kv_heads_cut(
        a.num_heads, a.num_kv_heads, size)
    for name, d in schema.items():
        spec, kind = specs[name], None
        if size > 1 and halves and name.endswith(".mixer.in_proj"):
            kind = (len(d.shape) - 1, "halves", 0)
        elif kv_cut and name.endswith(kv_names) and not any(
                tp in sh.entry_names(e)
                for i, e in enumerate(spec) if i != len(d.shape) + kv_dim):
            # (a cache whose sequence is split over model holds every
            # KV head: the reference's specs leave them whole)
            dim = len(d.shape) + kv_dim
            spec = _with_entry(spec, dim, tp)
            kind = (dim, "heads", a.num_kv_heads)
        out[name] = (spec, tuple(d.shape), kind)
    return out


def _model_size(parallel: ParallelConfig, mesh) -> int:
    tp = parallel.tp_axis
    return sh.mesh_shape_dict(mesh).get(tp, 1) if tp else 1


def _check_seq_split(cfg: ModelConfig, parallel: ParallelConfig, mesh,
                     cspecs, batch: int, max_len: int):
    """With a cache split along its sequence, each cache leaf with a
    sequence dim (``max_len`` long for self-attention, ``encoder_seq`` for
    cross-attention) is split along the sequence axes where they divide
    its length, as the serving mesh splits the work
    (``sharding.ServeMesh``); where they do not, it stays whole, as the
    reference's spec leaves it, with the reference's warning naming the
    axis and the size, and the mesh splits no work of that cache along
    the sequence. A leaf whose length the axes divide but whose rows
    take an axis of the sequence raises ``ValueError`` (ROADMAP C24,
    C25)."""
    shape = sh.mesh_shape_dict(mesh)
    seq = tuple(a for a in sh.entry_names(parallel.seq_axis)
                if shape.get(a, 1) > 1) if parallel.shard_cache_seq else ()
    if not seq:
        return
    n = sh.axis_size(shape, seq)
    for name, d in cache_schema(cfg, batch, max_len).items():
        if "cache_seq" not in d.axes:
            continue
        spec = cspecs[name]
        sh.check_spec(spec, f"{name}'s cache spec")
        dim = d.axes.index("cache_seq")
        if d.shape[dim] % n:
            kind = "cross" if ".cross." in name else "self"
            sh._warn_replicated(f"a {kind}-attention cache's sequence "
                                f"(logical axis 'cache_seq')",
                                parallel.seq_axis, d.shape[dim], n)
            continue
        split = tuple(a for a in sh.entry_names(spec[dim])
                      if shape.get(a, 1) > 1)
        if split != seq:
            raise ValueError(
                f"{name}: a cache of {d.shape[dim]} positions is not split "
                f"over the sequence axes {seq} (size {n}): its rows take "
                f"{split or 'none of them'}")


def serve_mesh_of(cfg: ModelConfig, parallel: ParallelConfig, mesh,
                  max_len: int) -> sh.ServeMesh:
    """The ``sharding.ServeMesh`` of a serving step over ``mesh`` whose
    self-attention caches hold ``max_len`` positions (and cross-attention
    caches ``cfg.encoder_seq``): what it splits along the sequence, each
    cache where the sequence axes divide its length."""
    return sh.ServeMesh.of(mesh, parallel, max_len=max_len,
                           encoder_seq=cfg.encoder_seq if cfg.encdec
                           else None)


def serve_layout(cfg: ModelConfig, parallel: ParallelConfig, mesh,
                 batch: int, max_len: int):
    """({name: (spec, shape, kind)} of the parameters, of the cache) over
    ``mesh`` (a ``DeviceMesh`` or an ``{axis: size}`` mapping):
    ``serve_specs`` in the compute layout (see the module docstring), a
    ``kind`` as ``sharding.Sharding`` takes it or None."""
    size = _model_size(parallel, mesh)
    check_serve_model_axis(cfg, size, parallel.tp_axis)
    pspecs, cspecs = serve_specs(cfg, parallel, mesh, batch, max_len)
    _check_seq_split(cfg, parallel, mesh, cspecs, batch, max_len)
    tp = parallel.tp_axis
    return (_compute_layout(cfg, full_schema(cfg), pspecs, tp, size,
                            _KV_WEIGHTS, -1),
            _compute_layout(cfg, cache_schema(cfg, batch, max_len), cspecs,
                            tp, size, _KV_CACHES, -2))


def train_layout(cfg: ModelConfig, parallel: ParallelConfig, mesh):
    """{name: (spec, shape, kind)} of the parameters a training rank
    holds and computes with over ``mesh``: the reference's
    ``partition_specs`` (``embed`` over the FSDP axis, which the step
    gathers) in the compute layout where ``model`` splits a leaf
    otherwise than in the spec's chunk, as ``serve_layout``; where the
    ``model`` axis does not divide a width, the leaf as its spec places
    it, with the fall-back's warning (C19)."""
    size = _model_size(parallel, mesh)
    check_serve_model_axis(cfg, size, parallel.tp_axis)
    shape = sh.mesh_shape_dict(mesh)
    pspecs = partition_specs(cfg, sh.build_rules(parallel, mesh), shape)
    return _compute_layout(cfg, full_schema(cfg), pspecs, parallel.tp_axis,
                           size, _KV_WEIGHTS, -1)


def serve_placement(cfg: ModelConfig, parallel: ParallelConfig, mesh,
                    batch: int, max_len: int):
    """({name: Sharding} of the parameters, {name: Sharding} of the cache
    of a ``batch`` x ``max_len`` serve) over ``mesh`` (a ``DeviceMesh``),
    by ``serve_layout``."""
    return tuple({name: sh.Sharding(mesh, spec, shape, kind=kind)
                  for name, (spec, shape, kind) in part.items()}
                 for part in serve_layout(cfg, parallel, mesh, batch,
                                          max_len))


def place_params(params: Params, placement) -> Params:
    """This rank's shard of each leaf: a whole leaf is cut, a leaf that
    is already the rank's shard (``init_params(placement=)``) kept."""
    out = {}
    for name, w in params.items():
        p = placement[name]
        if tuple(w.shape) == tuple(p.local_shape):
            out[name] = w
        elif tuple(w.shape) == tuple(p.shape):
            out[name] = p.shard(w)
        else:
            raise ValueError(f"{name}: a leaf of {tuple(w.shape)} is neither "
                             f"the whole {p.shape} nor this rank's "
                             f"{p.local_shape}")
    return out


def prefill(params: Params, cfg: ModelConfig, batch: Dict, cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    logits, cache, _ = forward(params, cfg, batch, cache=cache,
                               decode=False)
    return logits[:, -1:], cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params, batch: Dict
                ) -> Tuple[torch.Tensor, Params]:
    logits, cache, _ = forward(params, cfg, batch, cache=cache, decode=True)
    return logits, cache
