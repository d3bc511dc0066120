"""AdamW with global-norm clipping, a warmup + cosine schedule, and
float32, bfloat16 or int8 moments.

Counterpart: ``repro.optim.adamw`` (``lr_at``, ``init_opt_state``,
``adamw_update``), in the reference's update order: the global-norm
clip, the schedule (linear warmup, cosine decay to a 0.1 floor), the
moments, the bias corrections from ``b ** step`` in float32, then the
decoupled weight decay. Plain functions over dicts of tensors — no
``torch.optim`` optimizer stands in.

``OptimizerConfig.state_dtype`` picks the moments' storage, as in the
reference: ``"float32"``; ``"bfloat16"`` (each moment rounded to bf16
after the update); ``"int8"``, block-quantized by ``state_block``
(``optim.compression``: int8 [n / block, block] with the per-block
scales in ``m_scale`` / ``v_scale``; the second moment stored as
sqrt(v), which halves the range the int8 grid covers). A stored moment
is widened to float32 before the update and stored again after it.

``lanes=`` extends the reference's per-problem contract to a batch:
the leading ``lanes`` axes of every parameter index independent
problems, each clipped by its own global norm — what the reference gets
by ``jax.vmap`` over the update (the K restarts of a calibration fit).
It takes float32 moments only.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.optim.compression import dequantize_int8, quantize_int8


class OptState(NamedTuple):
    step: torch.Tensor               # int32, shared by every lane
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    # the int8 moments' per-block scales; empty for float32 and bfloat16
    m_scale: Dict[str, torch.Tensor]
    v_scale: Dict[str, torch.Tensor]


STATE_DTYPES = ("float32", "bfloat16", "int8")


def _check_state_dtype(ocfg: OptimizerConfig, lanes: int = 0):
    if ocfg.state_dtype not in STATE_DTYPES:
        raise ValueError(f"state_dtype={ocfg.state_dtype!r}: one of "
                         f"{STATE_DTYPES}")
    if lanes and ocfg.state_dtype != "float32":
        raise ValueError(f"lanes={lanes} takes float32 moments, not "
                         f"{ocfg.state_dtype!r}")


def _moment_like(p: torch.Tensor, ocfg: OptimizerConfig):
    """(zero moment, zero per-block scales or None) for parameter p."""
    if ocfg.state_dtype == "int8":
        nblk = -(-p.numel() // ocfg.state_block)
        return (torch.zeros((nblk, ocfg.state_block), dtype=torch.int8,
                            device=p.device),
                torch.zeros((nblk,), dtype=torch.float32, device=p.device))
    dt = torch.bfloat16 if ocfg.state_dtype == "bfloat16" else torch.float32
    return torch.zeros(p.shape, dtype=dt, device=p.device), None


def init_opt_state(params: Dict[str, torch.Tensor],
                   ocfg: OptimizerConfig) -> OptState:
    _check_state_dtype(ocfg)
    m, v, ms, vs = {}, {}, {}, {}
    for k, p in params.items():
        m[k], sc = _moment_like(p, ocfg)
        v[k] = torch.zeros_like(m[k])
        if sc is not None:
            ms[k], vs[k] = sc, torch.zeros_like(sc)
    dev = next(iter(params.values())).device if params else None
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), m, v,
                    ms, vs)


def abstract_opt_state(params: Dict[str, torch.Tensor],
                       ocfg: OptimizerConfig) -> OptState:
    """``init_opt_state``'s shapes and dtypes as ``meta`` tensors (no
    memory), from parameters of any device (``models.model
    .abstract_params``): the counterpart of the reference's."""
    return init_opt_state({k: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta")
                           for k, p in params.items()}, ocfg)


def _load_moment(mm, sc, shape, ocfg: OptimizerConfig,
                 second: bool = False) -> torch.Tensor:
    """A stored moment widened to float32 (float32 moments as they are)."""
    if ocfg.state_dtype == "int8":
        x = dequantize_int8(mm, sc, shape)
        return torch.square(x) if second else x
    return mm.to(torch.float32)


def _store_moment(x: torch.Tensor, ocfg: OptimizerConfig,
                  second: bool = False):
    """(stored moment, per-block scales or None)."""
    if ocfg.state_dtype == "int8":
        return quantize_int8(torch.sqrt(x) if second else x,
                             ocfg.state_block)
    if ocfg.state_dtype == "bfloat16":
        return x.to(torch.bfloat16), None
    return x, None


def opt_state_specs(param_specs: Dict[str, tuple], ocfg: OptimizerConfig,
                    params_abstract: Dict = None, fsdp_axis: str = "data",
                    mesh_shape: Dict[str, int] = None) -> OptState:
    """The optimizer state's specs (``distributed.sharding``): float32
    and bfloat16 moments take their parameter's spec; the int8 moments'
    [n_blocks, block] layout (and its [n_blocks] scales) split the block
    dim over ``fsdp_axis`` when it divides the number of blocks, and are
    replicated otherwise. ``params_abstract`` gives the parameters'
    shapes (``models.model.abstract_params``)."""
    if ocfg.state_dtype == "int8":
        size = (mesh_shape or {}).get(fsdp_axis, 1)

        def blk_spec(k):
            if params_abstract is None or size <= 1:
                return (), ()
            nblk = -(-params_abstract[k].numel() // ocfg.state_block)
            if nblk % size == 0:
                return (fsdp_axis, None), (fsdp_axis,)
            return (), ()
        m, scales = {}, {}
        for k in param_specs:
            m[k], scales[k] = blk_spec(k)
        return OptState((), m, dict(m), scales, dict(scales))
    m = dict(param_specs)
    return OptState((), m, dict(m), {}, {})


def lr_at(step, ocfg: OptimizerConfig) -> torch.Tensor:
    """The float32 learning rate at ``step`` (an int or an integer
    tensor): linear warmup over ``warmup_steps``, then a cosine from 1 to
    0.1 of ``lr`` at ``total_steps``."""
    step = torch.as_tensor(step)
    warm = torch.clamp_max(step / max(ocfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - ocfg.warmup_steps)
                    / max(ocfg.total_steps - ocfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return ocfg.lr * warm * (0.1 + 0.9 * cos)


def sq_norm(g: torch.Tensor, lanes: int = 0) -> torch.Tensor:
    """The float32 sum of squares of ``g`` over all but its ``lanes``
    leading axes: one leaf's share of the global gradient norm."""
    return torch.sum(torch.square(g.to(torch.float32)),
                     dim=tuple(range(lanes, g.dim())))


def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: OptState,
                 ocfg: OptimizerConfig, lanes: int = 0,
                 gnorm: torch.Tensor = None
                 ) -> Tuple[Dict[str, torch.Tensor], OptState]:
    """One AdamW step: (new params, new state). ``lanes`` leading axes of
    every parameter index independent problems (see the module
    docstring); the global norm reduces over the other axes. A rank that
    holds shards passes ``gnorm``, the norm of the whole gradient
    (``train.steps`` sums the shards' ``sq_norm`` over the mesh); the
    update is elementwise, so it runs on the shards as they are."""
    _check_state_dtype(ocfg, lanes)
    step = state.step + 1
    if gnorm is None:
        gnorm = torch.sqrt(sum(sq_norm(g, lanes) for g in grads.values()))
    clip = torch.clamp_max(ocfg.grad_clip / (gnorm + 1e-9), 1.0)
    lr = lr_at(step, ocfg)
    b1, b2 = ocfg.betas
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    new_p, new_m, new_v, new_ms, new_vs = {}, {}, {}, {}, {}
    for k, p in params.items():
        c = clip.reshape(clip.shape + (1,) * (p.dim() - lanes))
        g = grads[k].to(torch.float32) * c
        m = _load_moment(state.m[k], state.m_scale.get(k), p.shape, ocfg)
        v = _load_moment(state.v[k], state.v_scale.get(k), p.shape, ocfg,
                         second=True)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        upd = (mhat / (torch.sqrt(vhat) + ocfg.eps)
               + ocfg.weight_decay * p.to(torch.float32))
        new_p[k] = (p.to(torch.float32) - lr * upd).to(p.dtype)
        new_m[k], msc = _store_moment(m, ocfg)
        new_v[k], vsc = _store_moment(v, ocfg, second=True)
        if msc is not None:
            new_ms[k], new_vs[k] = msc, vsc
    return new_p, OptState(step, new_m, new_v, new_ms, new_vs)
