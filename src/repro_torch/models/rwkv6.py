"""RWKV-6 "Finch" blocks: time-mix with data-dependent decay, channel-mix.

Counterpart: ``repro.models.rwkv6`` (arXiv:2404.05892), with the same
parameters and casts. Token-shift interpolation with data-dependent mix
coefficients (LoRA-produced), per-channel decay w_t = exp(-exp(w0 +
lora(x))) read in float32 and cast to the activations' dtype, bonus u in
float32, the WKV recurrence (``ops.rwkv6_scan``: the CUDA kernel on the
card, the plain version on the CPU), a per-head group norm in float32
(population variance, eps 64e-5) and a silu gate; the channel mix is a
squared-relu MLP gated by a sigmoid.

Serve state per layer: {x_att, x_ffn: [b, d] the previous token's
activations; wkv: [b, H, n, n] the recurrent state, float32}. Only a
decode step reads it back: a prefill shifts in zeros and starts the
recurrence from a zero state, as the reference does.

Under a serving mesh a rank runs its ``H / model`` heads of the time mix
(``wr`` / ``wk`` / ``wv`` / ``wg``'s columns, ``bonus``, its part of the
whole-width decay and of ``ln_x``, its heads of the ``wkv`` state; ``wo``
row-parallel) and its share of the channel mix's width: ``k @ wv`` is a
row-parallel sum whose result is the whole width, and the gate's
columns are gathered to meet it. ``x_att`` / ``x_ffn`` are replicated.
Under autograd the replicated mixes enter the rank's columns through
``layers.tp_in``, and the decay and ``ln_x`` through ``tp_slice``.
Where ``model`` does not divide the heads the time mix runs every head
on every rank (the fall-back): ``wr`` / ``wk`` / ``wv`` / ``wg`` are the
reference's column shards where the axis divides ``d`` (gathered whole
in one call) or whole, ``bonus`` and the ``wkv`` state whole, ``wo``'s
rows split as its spec splits them; the channel mix's widths fall back
alike, each leaf by its spec.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamDef, Params, Schema, heads_split,
                                       model_split, row_parallel, tp_gather,
                                       tp_gather_parts, tp_in, tp_slice)

State = Dict[str, torch.Tensor]
MIXES = 5  # r, w, k, v, g


def rwkv_schema(cfg: ModelConfig, name: str) -> Schema:
    r = cfg.rwkv
    d = cfg.d_model
    H = d // r.head_dim
    return {
        # token-shift data-dependent mixing
        f"{name}.maa_x": ParamDef((d,), ("norm",), "zeros"),
        f"{name}.maa_base": ParamDef((MIXES, d), (None, "norm"), "zeros"),
        f"{name}.maa_w1": ParamDef((d, MIXES * r.mix_lora),
                                   ("embed", "rank"), "small"),
        f"{name}.maa_w2": ParamDef((MIXES, r.mix_lora, d),
                                   (None, "rank", "embed"), "small"),
        # data-dependent decay
        f"{name}.decay_base": ParamDef((d,), ("norm",), "zeros"),
        f"{name}.decay_w1": ParamDef((d, r.decay_lora), ("embed", "rank"),
                                     "small"),
        f"{name}.decay_w2": ParamDef((r.decay_lora, d), ("rank", "embed"),
                                     "small"),
        f"{name}.bonus": ParamDef((H, r.head_dim), ("kv_heads", None),
                                  "small"),
        # projections
        f"{name}.wr": ParamDef((d, d), ("embed", "heads")),
        f"{name}.wk": ParamDef((d, d), ("embed", "heads")),
        f"{name}.wv": ParamDef((d, d), ("embed", "heads")),
        f"{name}.wg": ParamDef((d, d), ("embed", "heads")),
        f"{name}.wo": ParamDef((d, d), ("heads", "embed")),
        # per-head groupnorm
        f"{name}.ln_x.scale": ParamDef((d,), ("norm",), "ones"),
        f"{name}.ln_x.bias": ParamDef((d,), ("norm",), "zeros"),
    }


def channel_mix_schema(cfg: ModelConfig, name: str) -> Schema:
    d, f = cfg.d_model, cfg.d_ff
    return {
        f"{name}.mix_k": ParamDef((d,), ("norm",), "zeros"),
        f"{name}.mix_r": ParamDef((d,), ("norm",), "zeros"),
        f"{name}.wk": ParamDef((d, f), ("embed", "mlp")),
        f"{name}.wr": ParamDef((d, d), ("embed", "heads")),
        f"{name}.wv": ParamDef((f, d), ("mlp", "embed")),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """[b, s, d] -> the previous token's x; position 0 takes ``prev``
    (zeros when None)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _decoding(state: Optional[State]) -> bool:
    return state is not None and state.get("decode", False)


def apply_time_mix(params: Params, name: str, x: torch.Tensor,
                   cfg: ModelConfig, state: Optional[State] = None
                   ) -> Tuple[torch.Tensor, Optional[State]]:
    r_cfg = cfg.rwkv
    b, s, d_model = x.shape
    dt = x.dtype
    n = r_cfg.head_dim
    # the rank's heads where model divides them, else every head
    local = heads_split(d_model // n)
    split = model_split(params[f"{name}.wr"].shape[1], d_model)
    d = params[f"{name}.wr"].shape[1] if local else d_model
    H = d // n
    decode = _decoding(state)

    xs = _token_shift(x, state["x_att"] if decode else None)
    dx = xs - x
    # data-dependent mix coefficients
    xx = x + dx * params[f"{name}.maa_x"].to(dt)
    lora = torch.tanh(xx @ params[f"{name}.maa_w1"].to(dt))
    lora = lora.reshape(b, s, MIXES, r_cfg.mix_lora)
    mix = params[f"{name}.maa_base"].to(dt)[None, None] + torch.einsum(
        "bsmr,mrd->bsmd", lora, params[f"{name}.maa_w2"].to(dt))
    xr, xw, xk, xv, xg = [x + dx * mix[:, :, i] for i in range(MIXES)]

    rr, kk, vv, gg = [tp_in(xi, split) @ params[f"{name}.{w}"].to(dt)
                      for xi, w in ((xr, "wr"), (xk, "wk"), (xv, "wv"),
                                    (xg, "wg"))]
    if split and not local:
        rr, kk, vv, gg = tp_gather_parts([rr, kk, vv, gg])
    rr, kk, vv = (y.reshape(b, s, H, n) for y in (rr, kk, vv))

    # data-dependent decay in (0, 1), formed in float32
    dlora = torch.tanh(xw @ params[f"{name}.decay_w1"].to(dt))
    decay_log = params[f"{name}.decay_base"].float() + (
        dlora.float() @ params[f"{name}.decay_w2"].float())
    w = torch.exp(-torch.exp(tp_slice(decay_log, d))).reshape(
        b, s, H, n)

    u = params[f"{name}.bonus"].float()
    out, new_wkv = ops.rwkv6_scan(rr, kk, vv, w.to(rr.dtype), u,
                                  state["wkv"] if decode else None)

    # per-head group norm in float32, then the gate
    o = out.reshape(b, s, H, n).float()
    mean = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, unbiased=False)
    o = ((o - mean) * torch.rsqrt(var + 64e-5)).reshape(b, s, d)
    o = (o * tp_slice(params[f"{name}.ln_x.scale"], d).float()
         + tp_slice(params[f"{name}.ln_x.bias"], d).float())
    o = o.to(dt) * F.silu(gg)
    # the rank's rows of every head where wo's rows are split
    wo = params[f"{name}.wo"].to(dt)
    y = row_parallel(tp_slice(o, wo.shape[0]), wo,
                     model_split(wo.shape[0], d_model))

    if state is not None:
        state = dict(state, x_att=x[:, -1], wkv=new_wkv)
    return y, state


def apply_channel_mix(params: Params, name: str, x: torch.Tensor,
                      cfg: ModelConfig, state: Optional[State] = None
                      ) -> Tuple[torch.Tensor, Optional[State]]:
    dt = x.dtype
    decode = _decoding(state)
    xs = _token_shift(x, state["x_ffn"] if decode else None)
    dx = xs - x
    xk = x + dx * params[f"{name}.mix_k"].to(dt)
    xr = x + dx * params[f"{name}.mix_r"].to(dt)
    wk, wr = params[f"{name}.wk"], params[f"{name}.wr"]
    k_split = model_split(wk.shape[1], cfg.d_ff)
    r_split = model_split(wr.shape[1], x.shape[-1])
    k = torch.square(F.relu(tp_in(xk, k_split) @ wk.to(dt)))
    r = tp_gather(torch.sigmoid(tp_in(xr, r_split) @ wr.to(dt)), r_split)
    y = r * row_parallel(k, params[f"{name}.wv"].to(dt), k_split)
    if state is not None:
        state = dict(state, x_ffn=x[:, -1])
    return y, state


def rwkv_state_schema(cfg: ModelConfig, name: str, batch: int) -> Schema:
    r = cfg.rwkv
    d = cfg.d_model
    H = d // r.head_dim
    return {
        f"{name}.x_att": ParamDef((batch, d), ("batch", None), "zeros"),
        f"{name}.x_ffn": ParamDef((batch, d), ("batch", None), "zeros"),
        f"{name}.wkv": ParamDef((batch, H, r.head_dim, r.head_dim),
                                ("batch", "kv_heads", None, None), "zeros"),
    }
