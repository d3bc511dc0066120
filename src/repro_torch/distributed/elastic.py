"""Elastic restore: resume a run from its checkpoint.

Counterpart: ``repro.distributed.elastic``. Checkpoints store whole
(host) arrays, so elasticity is a placement problem; the reference
re-places the restored tree under a new mesh's shardings. The port runs
on one device: ``elastic_restore`` brings train state, optimizer state
and the data position back onto it, and a mesh of more than one device
raises (the multi-GPU slice, ROADMAP A8).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.config import ModelConfig, OptimizerConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import full_schema
from repro_torch.optim.adamw import OptState, init_opt_state


def state_like(cfg: ModelConfig, ocfg: OptimizerConfig, device="cuda"
               ) -> Tuple[dict, OptState]:
    """(params, opt_state) of the shapes and dtypes a checkpoint of
    ``cfg`` holds, on ``device``: uninitialised parameters and zero
    moments, the ``like`` tree of ``restore_checkpoint`` (no random
    draw)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    params = {name: torch.empty(d.shape, dtype=dt, device=dev)
              for name, d in sorted(full_schema(cfg).items())}
    return params, init_opt_state(params, ocfg)


def elastic_restore(ckpt_dir: str, cfg: ModelConfig, ocfg: OptimizerConfig,
                    parallel: ParallelConfig, devices: int = 1,
                    step: Optional[int] = None, device="cuda"):
    """(params, opt_state, step, extra): the checkpoint at ``step`` (the
    latest when None) restored onto ``device``. ``devices`` > 1, the
    reference's restore onto a larger mesh, raises."""
    if int(devices) <= 0:
        raise ValueError(f"devices must be a positive mesh size, "
                         f"got {devices}")
    if devices != 1:
        raise NotImplementedError(
            "elastic_restore(devices=) > 1 is not in the port yet: "
            "restoring onto a mesh comes with the multi-GPU slice "
            "(ROADMAP A8)")
    (params, opt_state), step_r, extra = restore_checkpoint(
        ckpt_dir, step, state_like(cfg, ocfg, device))
    return params, opt_state, step_r, extra
