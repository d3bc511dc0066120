"""Elastic restore: resume a run from its checkpoint on another mesh.

Counterpart: ``repro.distributed.elastic``. Checkpoints store whole
(host) arrays, so elasticity is a placement problem: rebuild the
shardings for the new mesh and cut each rank's shards out of the
restored tree. ``elastic_restore`` is the one-call path after losing (or
gaining) ranks: train state, optimizer state and data position all carry
over; only the layout changes. A checkpoint written by any number of
ranks restores onto any other.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.config import ModelConfig, OptimizerConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptState, init_opt_state, opt_state_specs


def state_like(cfg: ModelConfig, ocfg: OptimizerConfig, device="cuda"
               ) -> Tuple[dict, OptState]:
    """(params, opt_state) of the shapes and dtypes a checkpoint of
    ``cfg`` holds, on ``device``: uninitialised parameters and zero
    moments, the ``like`` tree of ``restore_checkpoint`` (no random
    draw). ``device="meta"`` gives the shapes alone."""
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    params = {name: torch.empty(d.shape, dtype=dt, device=dev)
              for name, d in sorted(M.full_schema(cfg).items())}
    return params, init_opt_state(params, ocfg)


def state_shardings(cfg: ModelConfig, ocfg: OptimizerConfig,
                    parallel: ParallelConfig, mesh):
    """({name: Sharding} of the parameters, an ``OptState`` of
    Shardings): how each rank holds the train state over ``mesh``. A
    parameter and its float32 or bf16 moments follow
    ``models.model.train_layout`` (the reference's specs in the compute
    layout over ``model``); int8 moments follow ``opt_state_specs``
    (blocks of the whole leaf over the FSDP axis, replicated over
    ``model``), and their parameter their block layout (the block
    quantization couples a block's values, so a parameter and its
    moments are split alike)."""
    rules = sh.build_rules(parallel, mesh)
    mshape = sh.mesh_shape_dict(mesh)
    layout = M.train_layout(cfg, parallel, mesh)
    abstract = M.abstract_params(cfg)
    ospecs = opt_state_specs(M.partition_specs(cfg, rules, mshape), ocfg,
                             abstract, parallel.fsdp_axis or "data", mshape)
    int8 = ocfg.state_dtype == "int8"
    blk = ocfg.state_block
    params, m, ms = {}, {}, {}
    for k, p in abstract.items():
        shape = tuple(p.shape)
        if int8:
            nblk = -(-p.numel() // blk)
            params[k] = sh.Sharding(mesh, ospecs.m[k], shape, blk)
            m[k] = sh.Sharding(mesh, ospecs.m[k], (nblk, blk))
            ms[k] = sh.Sharding(mesh, ospecs.m_scale[k], (nblk,))
        else:
            spec, _, kind = layout[k]
            params[k] = sh.Sharding(mesh, spec, shape, kind=kind)
            m[k] = params[k]
    step = sh.Sharding(mesh, (), ())
    return params, OptState(step, m, dict(m), ms, dict(ms))


def elastic_restore(ckpt_dir: str, cfg: ModelConfig, ocfg: OptimizerConfig,
                    parallel: ParallelConfig, devices: int = 1,
                    step: Optional[int] = None, device="cuda", mesh=None):
    """(params, opt_state, step, extra): the checkpoint at ``step`` (the
    latest when None) restored onto ``mesh``, or with ``devices=D`` > 1
    onto a ``data=D`` host mesh over the first D ranks of the
    ``torch.distributed`` default group (``launch.mesh.make_host_mesh``;
    ``ValueError`` without a group that large): each rank gets its shards
    (``state_shardings``; a rank past the mesh gets the whole state).
    ``devices=1`` and no mesh restore the whole state onto ``device``."""
    if int(devices) <= 0:
        raise ValueError(f"devices must be a positive mesh size, "
                         f"got {devices}")
    if mesh is None and devices > 1:
        sh.require_ranks(devices, "elastic_restore")
        mesh = make_host_mesh(data=devices, model=1, device=device)
    if mesh is None:
        (params, opt_state), step_r, extra = restore_checkpoint(
            ckpt_dir, step, state_like(cfg, ocfg, device))
        return params, opt_state, step_r, extra
    (params, opt_state), step_r, extra = restore_checkpoint(
        ckpt_dir, step, state_like(cfg, ocfg, "meta"),
        state_shardings(cfg, ocfg, parallel, mesh))
    return params, opt_state, step_r, extra
