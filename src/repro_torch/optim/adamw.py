"""AdamW with global-norm clipping and a warmup + cosine schedule.

Counterpart: ``repro.optim.adamw`` (``lr_at``, ``init_opt_state``,
``adamw_update``), in the reference's update order: the global-norm
clip, the schedule (linear warmup, cosine decay to a 0.1 floor), the
moments, the bias corrections from ``b ** step`` in float32, then the
decoupled weight decay. Plain functions over dicts of tensors — no
``torch.optim`` optimizer stands in.

Only float32 moments are ported: the reference's int8 (block-quantized)
and bfloat16 states belong to the training side (ROADMAP A9), and
``state_dtype`` other than ``"float32"`` raises.

``lanes=`` extends the reference's per-problem contract to a batch:
the leading ``lanes`` axes of every parameter index independent
problems, each clipped by its own global norm — what the reference gets
by ``jax.vmap`` over the update (the K restarts of a calibration fit).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.config import OptimizerConfig


class OptState(NamedTuple):
    step: torch.Tensor               # int32, shared by every lane
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    # the reference's int8 per-block scales; empty for float32 moments
    m_scale: Dict[str, torch.Tensor]
    v_scale: Dict[str, torch.Tensor]


def _float32_only(ocfg: OptimizerConfig):
    if ocfg.state_dtype != "float32":
        raise NotImplementedError(
            f"state_dtype={ocfg.state_dtype!r}: only float32 optimizer "
            f"states are in the port; the int8 and bfloat16 moments "
            f"come with the training side (ROADMAP A9)")


def init_opt_state(params: Dict[str, torch.Tensor],
                   ocfg: OptimizerConfig) -> OptState:
    _float32_only(ocfg)
    m = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for k, p in params.items()}
    v = {k: torch.zeros_like(x) for k, x in m.items()}
    dev = next(iter(params.values())).device if params else None
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), m, v,
                    {}, {})


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


def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: OptState,
                 ocfg: OptimizerConfig, lanes: int = 0
                 ) -> Tuple[Dict[str, torch.Tensor], OptState]:
    """One AdamW step: (new params, new state). ``lanes`` leading axes of
    every parameter index independent problems (see the module
    docstring); the global norm reduces over the other axes."""
    _float32_only(ocfg)
    step = state.step + 1

    def sq_norm(g):
        return torch.sum(torch.square(g.to(torch.float32)),
                         dim=tuple(range(lanes, g.dim())))

    gnorm = torch.sqrt(sum(sq_norm(g) for g in grads.values()))
    clip = torch.clamp_max(ocfg.grad_clip / (gnorm + 1e-9), 1.0)
    lr = lr_at(step, ocfg)
    b1, b2 = ocfg.betas
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        c = clip.reshape(clip.shape + (1,) * (p.dim() - lanes))
        g = grads[k].to(torch.float32) * c
        m = b1 * state.m[k] + (1 - b1) * g
        v = b2 * state.v[k] + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        upd = (mhat / (torch.sqrt(vhat) + ocfg.eps)
               + ocfg.weight_decay * p.to(torch.float32))
        new_p[k] = (p.to(torch.float32) - lr * upd).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, OptState(step, new_m, new_v, {}, {})
