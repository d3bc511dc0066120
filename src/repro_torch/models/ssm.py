"""Mamba-1 selective-SSM block (Jamba's recurrent layer).

Counterpart: ``repro.models.ssm``. in_proj -> (x, z) gate split,
depthwise causal conv1d + silu on x, input-dependent (dt, B, C) via
x_proj, softplus dt with dt_proj, diagonal A = -exp(A_log), the selective
scan (``ops.ssm_scan``: the CUDA kernel on the card, the plain version on
the CPU), gated output, out_proj.

Serve state per layer: {conv: [b, d_conv - 1, d_inner], ssm: [b, d_inner,
n]}; only a decode step reads it back (a prefill starts from zeros even
when a state is passed, as the reference does).

Under a serving mesh a rank runs its ``d_inner / model`` channels
(``in_proj``'s x and z columns of them, the conv, ``dt_proj``, ``A_log``,
``D`` and the scan, and its channels of the state); ``x_proj`` is
row-parallel, so every rank reads the whole (dt, B, C), and so is
``out_proj``. Under autograd x enters ``in_proj`` and the whole (dt, B,
C) the rank's channels through ``layers.tp_in``. Where ``model`` does
not divide ``d_inner`` the block runs whole on every rank, its leaves
placed by the reference's specs: whole, but for an ``in_proj`` whose
``2 d_inner`` columns the axis divides, which the rank projects with its
contiguous shard and gathers whole.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamDef, Params, Schema, model_split,
                                       row_parallel, tp_gather_parts, tp_in)

State = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or max(1, math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank, s.d_state


def mamba_schema(cfg: ModelConfig, name: str) -> Schema:
    s = cfg.ssm
    d = cfg.d_model
    di, dtr, n = _dims(cfg)
    return {
        f"{name}.in_proj": ParamDef((d, 2 * di), ("embed", "heads")),
        f"{name}.conv_w": ParamDef((s.d_conv, di), ("conv", "heads"),
                                   "small"),
        f"{name}.conv_b": ParamDef((di,), ("heads",), "zeros"),
        f"{name}.x_proj": ParamDef((di, dtr + 2 * n), ("heads", "rank")),
        f"{name}.dt_proj": ParamDef((dtr, di), ("rank", "heads"), "small"),
        f"{name}.dt_bias": ParamDef((di,), ("heads",), "zeros"),
        f"{name}.A_log": ParamDef((di, n), ("heads", "state"), "ones"),
        f"{name}.D": ParamDef((di,), ("heads",), "ones"),
        f"{name}.out_proj": ParamDef((di, d), ("heads", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x [b, s, di], w [k, di]; ``prev`` the last
    k - 1 inputs (zeros when None). Returns (y, new buffer)."""
    k = w.shape[0]
    if prev is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = prev.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # [b, s+k-1, di]
    s = x.shape[1]
    y = xp[:, 0:s] * w[0][None, None]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i][None, None]
    y = y + b[None, None]
    return y, xp[:, xp.shape[1] - (k - 1):]


def apply_mamba(params: Params, name: str, x: torch.Tensor,
                cfg: ModelConfig, state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
    d_inner, dtr, n = _dims(cfg)
    di = params[f"{name}.D"].shape[0]               # the rank's channels
    split = model_split(di, d_inner)
    dt_ = x.dtype

    w_in = params[f"{name}.in_proj"]
    in_split = model_split(w_in.shape[1], 2 * d_inner)
    xz = tp_in(x, in_split) @ w_in.to(dt_)
    if in_split and not split:
        # the spec's contiguous columns of a whole block: gathered
        xz, = tp_gather_parts([xz])
    xs, z = xz[..., :di], xz[..., di:]

    decode = state is not None and state.get("decode", False)
    conv_prev = state["conv"] if decode else None
    xs, conv_buf = _causal_conv(xs, params[f"{name}.conv_w"].to(dt_),
                                params[f"{name}.conv_b"].to(dt_), conv_prev)
    xs = F.silu(xs)

    proj = tp_in(row_parallel(xs, params[f"{name}.x_proj"].to(dt_), split),
                 split)
    dt_raw, B, C = torch.split(proj, [dtr, n, n], dim=-1)
    dt = F.softplus((dt_raw @ params[f"{name}.dt_proj"].to(dt_)).float()
                    + params[f"{name}.dt_bias"].float())
    A = -torch.exp(params[f"{name}.A_log"].float())             # [di, n]

    ssm_prev = state["ssm"] if decode else None
    y, new_ssm = ops.ssm_scan(xs, dt.to(dt_), A, B, C,
                              params[f"{name}.D"].float(), ssm_prev)
    y = y * F.silu(z)
    out = row_parallel(y, params[f"{name}.out_proj"].to(dt_), split)

    if state is not None:
        state = dict(state, conv=conv_buf, ssm=new_ssm)
    return out, state


def mamba_state_schema(cfg: ModelConfig, name: str, batch: int) -> Schema:
    s = cfg.ssm
    di, _, n = _dims(cfg)
    return {
        f"{name}.conv": ParamDef((batch, s.d_conv - 1, di),
                                 ("batch", None, "heads"), "zeros"),
        f"{name}.ssm": ParamDef((batch, di, n), ("batch", "heads", "state"),
                                "zeros"),
    }
