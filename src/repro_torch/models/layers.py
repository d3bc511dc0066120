"""Shared layer primitives and the parameter-schema machinery.

Counterpart: ``repro.models.layers``. Every module declares its parameters
as a *schema*, a flat dict mapping parameter path -> ``ParamDef(shape,
logical_axes, init)``, with the reference's names, shapes and init
distributions, so a parameter dict of the JAX package carries over leaf
for leaf (``repro_torch.convert.model_params_from_arrays``).

Numerics follow the reference: norms run in float32 and cast back; every
matrix is cast to the activations' dtype at use (a no-op where the engine
holds a compute-dtype copy, ``models.model.compute_params``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

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


def init_from_schema(schema: Schema, generator: torch.Generator, dtype,
                     device) -> Params:
    """Leaves in sorted name order, each drawn from ``generator`` (which
    lives on ``device``) as float32 N(0, std) and cast to ``dtype``:
    the reference's distributions, not its bits (``jax.random`` and
    ``torch.Generator`` differ; parity tests convert one parameter set)."""
    params = {}
    for name in sorted(schema):
        d = schema[name]
        if d.init == "zeros":
            params[name] = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            params[name] = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            w = torch.randn(d.shape, generator=generator,
                            dtype=torch.float32, device=device)
            params[name] = w.mul_(init_std(d)).to(dtype)
    return params


def prefix_schema(prefix: str, schema: Schema) -> Schema:
    return {f"{prefix}.{k}": v for k, v in schema.items()}


def stack_schema(schema: Schema, n: int, axis_name: str = "layers") -> Schema:
    """Prepend a stacked (group) dimension to every leaf."""
    return {
        k: ParamDef((n,) + d.shape, (axis_name,) + d.axes, d.init, d.scale)
        for k, d in schema.items()
    }


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
    dt = x.dtype
    up = x @ params[f"{name}.w_up"].to(dt)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ params[f"{name}.w_gate"].to(dt)) * up
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(x @ params[f"{name}.w_gate"].to(dt),
                   approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ params[f"{name}.w_down"].to(dt)


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
    x = params["embed.table"][tokens.long()].to(compute_dtype(cfg))
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(params: Params, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed.table"].to(x.dtype).t()
    return x @ params["unembed.w"].to(x.dtype)
