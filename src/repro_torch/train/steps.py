"""Train-step factory: loss -> grads -> AdamW, on one device.

Counterpart: ``repro.train.steps.make_train_step``. The step computes
what the reference's jitted step computes:

* ``loss_of``: with an FSDP axis configured and a compute dtype other
  than the parameters', every float32 leaf is cast to the compute dtype
  before the forward (the reference's pre-gather cast; the float32
  master copy only feeds the optimizer), then ``models.model.loss_fn``
  under ``parallel.remat``;
* the gradient through autograd (the reference's ``value_and_grad``):
  the parameters enter as leaves that require grad, so the attention and
  scans take the reference's training route (``kernels/ops.py``) and no
  forward kernel runs;
* ``parallel.microbatches`` > 1: the batch split into equal microbatches
  (``positions`` [3, b, s] along its batch axis), gradients summed in
  float32 and divided by their number, metrics averaged likewise;
* ``optim.adamw.adamw_update``.

``parallel.grad_compression="int8"`` compresses gradients across a
``pod`` mesh axis only (the reference's ``_pod_compressed_grads``); one
device has no such axis, so here, as on the reference's meshes without
one, it does nothing. The pod path is the multi-GPU slice (ROADMAP A8).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.config import ModelConfig, OptimizerConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.layers import compute_dtype
from repro_torch.optim.adamw import OptState, adamw_update

METRICS = ("loss", "nll", "aux", "tokens")


def _microbatch(batch: Dict, k: int) -> list:
    """The batch as ``k`` equal microbatches (dim 0 split; ``positions``
    [3, b, s] split along its batch axis)."""
    out = [dict() for _ in range(k)]
    for key, v in batch.items():
        axis = 1 if key == "positions" and v.dim() == 3 else 0
        if v.shape[axis] % k:
            raise ValueError(f"{key}: batch {v.shape[axis]} does not split "
                             f"into {k} equal microbatches")
        for i, part in enumerate(torch.chunk(v, k, dim=axis)):
            out[i][key] = part
    return out


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    parallel: ParallelConfig, device="cuda"
                    ) -> Callable[[Dict, OptState, Dict],
                                  Tuple[Dict, OptState, Dict]]:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on ``device`` (``"cuda"`` by default; raises without a card): new
    parameter and state dicts (the inputs are not modified) and 0-dim
    float32 metrics ``loss``, ``nll``, ``aux`` and ``tokens``. The step's
    ``grads`` attribute is its gradient half alone."""
    resolve_device(device)
    cdt = compute_dtype(cfg)
    cast = bool(parallel.fsdp_axis) and cdt != getattr(torch,
                                                       cfg.param_dtype)
    k = int(parallel.microbatches)
    if k < 1:
        raise ValueError(f"microbatches must be >= 1, got {k}")

    def loss_of(params, batch):
        if cast:
            params = {n: p.to(cdt) if p.dtype == torch.float32 else p
                      for n, p in params.items()}
        return M.loss_fn(params, cfg, batch, remat=parallel.remat)

    def grad_fn(params, batch):
        names = list(params)
        leaves = [params[n].detach().requires_grad_() for n in names]
        with torch.enable_grad():
            loss, metrics = loss_of(dict(zip(names, leaves)), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(x) if g is None else g
                 for n, x, g in zip(names, leaves, grads)}
        return grads, {m: metrics[m].detach() for m in METRICS}

    def compute_grads(params, batch):
        if k == 1:
            return grad_fn(params, batch)
        gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for n, p in params.items()}
        msum = None
        for mb in _microbatch(batch, k):
            g, metrics = grad_fn(params, mb)
            gsum = {n: gsum[n] + g[n].to(torch.float32) for n in gsum}
            msum = metrics if msum is None else {
                m: msum[m] + metrics[m] for m in METRICS}
        return ({n: g / float(k) for n, g in gsum.items()},
                {m: v / float(k) for m, v in msum.items()})

    def step(params, opt_state, batch):
        grads, metrics = compute_grads(params, batch)
        new_params, new_state = adamw_update(params, grads, opt_state, ocfg)
        return new_params, new_state, dict(metrics)

    #: ``grads(params, batch) -> (grads, metrics)``: the step's gradient
    #: half alone, for checks against another device or the reference
    step.grads = compute_grads
    return step
