"""Shared layer primitives and the parameter-schema machinery.

Counterpart: ``repro.models.layers``. Every module declares its parameters
as a *schema*, a flat dict mapping parameter path -> ``ParamDef(shape,
logical_axes, init)``, with the reference's names, shapes and init
distributions, so a parameter dict of the JAX package carries over leaf
for leaf (``repro_torch.convert.model_params_from_arrays``).

Numerics follow the reference: norms run in float32 and cast back; every
matrix is cast to the activations' dtype at use (a no-op where the engine
holds a compute-dtype copy, ``models.model.compute_params``); RoPE's cos
and sin are computed in float32 and cast to the activations' dtype before
the rotation, so a bf16 model rotates in bf16.

Under a serving or training mesh (``distributed.sharding.serve_mesh()``)
the functions here take a rank's shards. Each leaf is placed by its
spec, which splits a dim over ``model`` where the axis divides it and
leaves it whole where it does not (the reference's fall-back), so a
block reads from its leaves whether a width is split (``model_split``:
a split dim is narrower than the schema's) and tells the helpers:
``row_parallel`` sums a row-parallel product over ``model`` (float32
partials, rounded once) only where the leaf's rows are split, and a
product over a whole leaf runs whole on every rank and sums nothing.
``embed_tokens`` and ``unembed`` split the vocabulary over ``model``
where it divides (a vocabulary it does not divide stays whole, with the
reference's warn-once), ``apply_mlp`` is column-parallel in ``w_gate`` /
``w_up`` and row-parallel in ``w_down`` where ``model`` divides the
width, and whole where it does not; norms are replicated. Under
autograd a replicated tensor enters each split computation through
``tp_in`` (Megatron's "f"), so every rank holds the whole gradient of
every replicated tensor and leaf: the blocks call it before each
column-parallel product, and ``tp_slice`` calls it itself; a whole
computation takes no ``tp_in``, whose sum would multiply its gradient by
the axis size. Columns split across a head (a width the axis divides
where it does not divide the heads) are gathered whole by
``tp_gather_parts``, whose backward gives each rank its part of the
gradient every rank then holds whole.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import AttentionConfig, ModelConfig
from repro_torch.distributed import sharding as sh

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | embed | small
    scale: Optional[float] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


Schema = Dict[str, ParamDef]


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[0]
    # convention: last dim is fan-out, second-to-last (or product of the
    # rest) is fan-in; good enough for init purposes.
    return int(np.prod(shape[:-1])) if len(shape) == 2 else shape[-2]


def init_std(d: ParamDef) -> float:
    """The standard deviation of a normal-initialised leaf."""
    if d.scale is not None:
        return d.scale
    if d.init == "embed":
        return 1.0
    if d.init == "small":
        return 0.02
    return 1.0 / math.sqrt(max(_fan_in(d.shape), 1))


def init_from_schema(schema: Schema, generator: torch.Generator,
                     dtype_of: Callable[[str], torch.dtype],
                     device, place: Optional[Callable] = None) -> Params:
    """Leaves in sorted name order, each drawn from ``generator`` (which
    lives on ``device``) as float32 N(0, std) and cast to
    ``dtype_of(name)``: the reference's distributions, not its bits
    (``jax.random`` and ``torch.Generator`` differ; parity tests convert
    one parameter set). A stacked leaf (a leading ``groups`` axis) is
    drawn one group at a time into its cast result, so the float32 draw
    never holds more than one group's slice. ``place(name, leaf)``, where
    given, takes each whole leaf as it is drawn and returns what is kept
    of it (a rank's shard), so at most one whole leaf is held."""
    params = {}
    for name in sorted(schema):
        d = schema[name]
        dtype = dtype_of(name)
        if d.init == "zeros":
            params[name] = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            params[name] = torch.ones(d.shape, dtype=dtype, device=device)
        elif d.axes[0] == "groups":
            w = torch.empty(d.shape, dtype=dtype, device=device)
            for g in range(d.shape[0]):
                w[g] = torch.randn(d.shape[1:], generator=generator,
                                   dtype=torch.float32,
                                   device=device).mul_(init_std(d))
            params[name] = w
        else:
            w = torch.randn(d.shape, generator=generator,
                            dtype=torch.float32, device=device)
            params[name] = w.mul_(init_std(d)).to(dtype)
        if place is not None:
            params[name] = place(name, params[name])
            w = None                    # the whole leaf goes before the next
    return params


def specs_from_schema(schema: Schema, rules: Dict[str, object],
                      mesh_shape: Dict[str, int]) -> Dict[str, tuple]:
    """Each leaf's spec (``distributed.sharding``): its logical axes
    mapped through ``rules``, an entry dropped to ``None`` where the dim
    does not divide the mesh axis or the axis is already taken."""
    specs = {}
    for name, d in schema.items():
        out, used = [], set()
        for dim, ax in zip(d.shape, d.axes):
            mesh_ax = rules.get(ax) if ax is not None else None
            if mesh_ax is None or mesh_ax in used:
                out.append(None)
                continue
            names = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
            size = int(np.prod([mesh_shape.get(a, 1) for a in names]))
            if size > 1 and dim % size == 0:
                # one axis by its name, as PartitionSpec writes it
                out.append(names[0] if len(names) == 1 else mesh_ax)
                used.add(mesh_ax)
            else:
                out.append(None)
        specs[name] = tuple(out)
    return specs


def prefix_schema(prefix: str, schema: Schema) -> Schema:
    return {f"{prefix}.{k}": v for k, v in schema.items()}


def stack_schema(schema: Schema, n: int, axis_name: str = "layers") -> Schema:
    """Prepend a stacked (group) dimension to every leaf."""
    return {
        k: ParamDef((n,) + d.shape, (axis_name,) + d.axes, d.init, d.scale)
        for k, d in schema.items()
    }


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dim() == 3 and w.dim() == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


class _F32Product(torch.autograd.Function):
    """cuBLAS's float32-output product, which has no derivative of its
    own; its backward runs in the operands' dtype, as the product of one
    device does (the float32 result's gradient is ``row_sum``'s: a
    gradient of the operands' dtype widened, so casting it back is
    exact)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = g @ w.transpose(-1, -2)
        if ctx.needs_input_grad[1]:
            if w.dim() == 3:
                gw = x.transpose(-1, -2) @ g
            else:
                gw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(
                    -1, g.shape[-1])
        return gx, gw


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (batched where both are 3-dim) accumulated and returned in
    float32: for low-precision operands on the card cuBLAS's product with
    a float32 output (a PyTorch without ``out_dtype`` raises; under
    autograd ``_F32Product``), else the float32 product of the widened
    operands (exact products, float32 sums)."""
    if x.dtype == torch.float32 or not x.is_cuda:
        return x.float() @ w.float()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _F32Product.apply(x, w)
    return _mm_f32(x, w)


def model_split(local: int, whole: int) -> bool:
    """Whether a leaf dim of ``local`` entries on this rank is its part of
    a dim of ``whole`` that the step's ``model`` axis splits. The leaf's
    spec decides: it splits the dim where the axis divides it and leaves
    it whole where it does not, so a split dim is narrower than the
    whole (a whole dim and one rank's shard never share a width)."""
    mesh = sh.serve_mesh()
    return mesh is not None and mesh.model_size > 1 and local < whole


def heads_split(heads: int) -> bool:
    """Whether the step's ``model`` axis splits ``heads`` heads into equal
    whole parts (each rank runs its own); where it does not, the block
    runs every head on every rank (the fall-back)."""
    mesh = sh.serve_mesh()
    return mesh is not None and mesh.model_size > 1 and \
        heads % mesh.model_size == 0


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 split: bool) -> torch.Tensor:
    """``x @ w``. With ``split`` (``w``'s rows are this rank's part of the
    contraction, ``x``'s last dim the same part) the partials summed over
    ``model`` in float32 and rounded once to ``x``'s dtype; else (one
    device, or a leaf the axis leaves whole) the plain product, which
    every rank computes whole."""
    mesh = sh.serve_mesh()
    if not split or mesh is None or mesh.model_size == 1:
        return x @ w
    return sh.row_sum(f32_product(x, w), x.dtype, mesh.model)


def tp_in(x: torch.Tensor, split: bool) -> torch.Tensor:
    """``x``, replicated over ``model``, where it enters this rank's part
    of a split computation (``split``: a column-parallel product over a
    split leaf): the identity, whose backward sums the ranks' gradients
    over ``model`` (``sharding.tp_enter``). Without ``split`` or a
    ``model`` axis, ``x`` (a whole computation's gradient is already
    whole on every rank)."""
    mesh = sh.serve_mesh()
    if not split or mesh is None or mesh.model_size == 1:
        return x
    return sh.tp_enter(x, mesh.model)


def tp_slice(x: torch.Tensor, width: int, dim: int = -1) -> torch.Tensor:
    """This rank's ``width``-wide part along ``dim`` of a replicated
    tensor whose width the ``model`` axis splits (entered by ``tp_in``);
    ``x`` where it is ``width`` wide."""
    mesh = sh.serve_mesh()
    if mesh is None or mesh.model_size == 1 or x.shape[dim] == width:
        return x
    return tp_in(x, True).narrow(dim, mesh.model_rank * width, width)


def tp_gather(x: torch.Tensor, split: bool, dim: int = -1) -> torch.Tensor:
    """The whole tensor along ``dim`` from every ``model`` rank's part
    where ``split`` (``x`` is this rank's part); else ``x``."""
    mesh = sh.serve_mesh()
    if not split or mesh is None or mesh.model_size == 1:
        return x
    return sh.tp_gather(x, dim, mesh.model)


def tp_gather_parts(parts):
    """Each tensor of ``parts`` whole along its last dim from every
    ``model`` rank's equal part of it, in one gather (the columns of
    several products that split a head: q, k and v)."""
    mesh = sh.serve_mesh()
    if mesh is None or mesh.model_size == 1 or not parts:
        return list(parts)
    widths = [p.shape[-1] for p in parts]
    whole = tp_gather(torch.cat(parts, dim=-1) if len(parts) > 1
                      else parts[0], True)
    whole = whole.unflatten(-1, (mesh.model_size, sum(widths)))
    return [w.flatten(-2) for w in whole.split(widths, dim=-1)]


def _vocab_split(table_rows: int, cfg: ModelConfig) -> bool:
    """Whether this rank holds part of the vocabulary; a vocabulary the
    ``model`` axis does not divide stays whole, with the warn-once."""
    mesh = sh.serve_mesh()
    size = 1 if mesh is None else mesh.model_size
    if size == 1:
        return False
    if table_rows == cfg.vocab_size:
        sh._warn_replicated("constrain(logical axis 'vocab_act')", "model",
                            cfg.vocab_size, size)
        return False
    return True


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_schema(cfg: ModelConfig, name: str) -> Schema:
    s: Schema = {f"{name}.scale": ParamDef((cfg.d_model,), ("norm",), "ones")}
    if cfg.norm == "layernorm":
        s[f"{name}.bias"] = ParamDef((cfg.d_model,), ("norm",), "zeros")
    return s


def apply_norm(params: Params, name: str, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + cfg.norm_eps)
    else:
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps)
    y = y * params[f"{name}.scale"].float()
    if cfg.norm == "layernorm":
        y = y + params[f"{name}.bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard, partial, M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(att: AttentionConfig, rot_dim: int,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    return 1.0 / (att.rope_theta ** exponent)          # [rot_dim // 2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               att: AttentionConfig) -> torch.Tensor:
    """x [b, s, h, hd]; positions [b, s], or [3, b, s] for M-RoPE. The
    first ``int(hd * rotary_pct) // 2 * 2`` channels rotate (as two
    halves), the rest pass through."""
    if att.rope == "none":
        return x
    hd = x.shape[-1]
    rot_dim = int(hd * att.rotary_pct) // 2 * 2
    inv = rope_freqs(att, rot_dim, x.device)           # [rot / 2]
    if att.rope == "mrope":
        # positions [3, b, s]; the frequencies split into sections (t, h, w)
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs [3, b, s] positions, got "
                             f"{tuple(positions.shape)}")
        parts, start = [], 0
        for row, sec in enumerate(att.mrope_sections):
            pos = positions[row].float()               # [b, s]
            parts.append(pos[..., None] * inv[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)              # [b, s, rot / 2]
    else:
        angles = positions.float()[..., None] * inv    # [b, s, rot / 2]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Sinusoidal positions (whisper)
# ---------------------------------------------------------------------------

def sinusoidal_positions(seq: int, dim: int) -> torch.Tensor:
    """[seq, dim] float32: sin then cos of pos / 10000^(2i / dim), the
    angles in float64 (numpy), as the reference builds its table."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32))


def sinusoidal_embed(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., dim] float32 for positions [...]: sin then cos of
    pos / 10000^(2i / dim), computed in float32; the caller casts."""
    i = torch.arange(dim // 2, dtype=torch.float32,
                     device=positions.device)
    angle = positions.float()[..., None] / torch.pow(10000.0, 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig, name: str,
               d_ff: Optional[int] = None) -> Schema:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s: Schema = {}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        s[f"{name}.w_gate"] = ParamDef((d, f), ("embed", "mlp"))
        s[f"{name}.w_up"] = ParamDef((d, f), ("embed", "mlp"))
    else:
        s[f"{name}.w_up"] = ParamDef((d, f), ("embed", "mlp"))
    s[f"{name}.w_down"] = ParamDef((f, d), ("mlp", "embed"))
    return s


def apply_mlp(params: Params, name: str, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """The dense MLP; over ``model`` column-parallel in ``w_gate`` /
    ``w_up`` and row-parallel in ``w_down`` where the axis divides
    ``d_ff``, whole on every rank where it does not."""
    dt = x.dtype
    split = model_split(params[f"{name}.w_up"].shape[1], cfg.d_ff)
    x = tp_in(x, split)
    up = x @ params[f"{name}.w_up"].to(dt)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ params[f"{name}.w_gate"].to(dt)) * up
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(x @ params[f"{name}.w_gate"].to(dt),
                   approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return row_parallel(h, params[f"{name}.w_down"].to(dt), split)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_schema(cfg: ModelConfig) -> Schema:
    s: Schema = {"embed.table": ParamDef((cfg.vocab_size, cfg.d_model),
                                         ("vocab", "embed"), "small")}
    if not cfg.tie_embeddings:
        s["unembed.w"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                  ("embed", "vocab"))
    return s


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Rows of the table in the compute dtype. The reference casts the
    whole table and then gathers; gathering first and casting the rows
    gives the same numbers without a table-sized copy."""
    table = params["embed.table"]
    if _vocab_split(table.shape[0], cfg):
        mesh = sh.serve_mesh()
        x = sh.vocab_embed(table, tokens, mesh.model_rank * table.shape[0],
                           mesh.model).to(compute_dtype(cfg))
    else:
        x = table[tokens.long()].to(compute_dtype(cfg))
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig,
            gather: bool = True) -> torch.Tensor:
    """The logits of ``x``; where ``model`` splits the vocabulary, every
    rank's columns gathered, or with ``gather=False`` this rank's
    columns alone (training's loss reduces them where they lie)."""
    if cfg.tie_embeddings:
        w = params["embed.table"].to(x.dtype).t()
    else:
        w = params["unembed.w"].to(x.dtype)
    if _vocab_split(w.shape[1], cfg):
        local = tp_in(x, True) @ w
        return sh.vocab_logits(local, sh.serve_mesh().model) if gather \
            else local
    return x @ w
