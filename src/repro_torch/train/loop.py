"""Training loop: the canonical pipeline-under-test.

Counterpart: ``repro.train.loop.train``. Every stage is a wind-tunnel
span (``datagen+next`` / ``h2d`` / ``train_step`` / ``checkpoint``, and
the loader's own ``datagen``), so an Experiment can measure a *training*
pipeline exactly like the paper measures a telemetry pipeline. Fault
tolerance: transient faults retry in place; ``NodeLoss`` restarts from the
latest checkpoint (parameters, optimizer state and data-stream position
all restore); the straggler watchdog reports stages that fall behind.

The loop runs on one device (``device=``, ``"cuda"`` by default, the
rank's current card; raises without one) or, with ``mesh=``, as one rank
of an FSDP mesh (``train.steps``): every rank calls ``train`` with the
same arguments. The loader gives each rank its rows of the global batch;
the fresh state is ``init_params`` drawn on the device from
``tcfg.seed`` (a stacked leaf one layer group at a time) with zero
moments, cut to the rank's shards; a checkpoint is gathered whole and
written once, by rank 0, in the single-device layout, and restored by
every rank onto its shards, so checkpoints move between mesh sizes. The
fault injector fires on every rank alike (it counts attempts), and every
rank restarts from the same checkpoint. The ``train_step`` span ends
when the step's loss has reached the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, gather_tree,
                                         latest_step, reshard_tree,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.config import (ModelConfig, OptimizerConfig, ParallelConfig,
                                TrainConfig)
from repro_torch.core.metrics import MetricStore
from repro_torch.core.spans import SpanCollector, span
from repro_torch.data.loader import TokenBatchLoader
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.elastic import state_like
from repro_torch.distributed.fault import (FaultInjector, NodeLoss,
                                           StragglerWatchdog, TransientFault,
                                           retry_step)
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptState, init_opt_state
from repro_torch.train.steps import make_train_step


@dataclass
class TrainResult:
    steps_done: int
    final_loss: float
    losses: list
    restarts: int
    retries: int
    stragglers_seen: Dict[str, int]
    collector: SpanCollector
    metrics: MetricStore
    #: the final parameters and optimizer state on the device (beyond the
    #: reference's record: what the last checkpoint must hold)
    params: Optional[dict] = None
    opt_state: Optional[OptState] = None


def train(cfg: ModelConfig, tcfg: TrainConfig, ocfg: OptimizerConfig,
          parallel: ParallelConfig, device="cuda",
          injector: Optional[FaultInjector] = None,
          collector: Optional[SpanCollector] = None,
          verbose: bool = True, mesh=None) -> TrainResult:
    """Train for ``tcfg.steps`` steps; see the module docstring. With
    ``mesh`` the result's ``params`` / ``opt_state`` are the rank's
    shards (``distributed.elastic.state_shardings``)."""
    dev = resolve_device(device)
    collector = collector or SpanCollector()
    metrics = MetricStore()
    step_fn = make_train_step(cfg, ocfg, parallel, dev, mesh=mesh)
    rows, writer = None, True
    if mesh is not None:
        shardings = step_fn.shardings
        axes = sh.batch_partition(parallel, mesh)
        sizes = sh.mesh_shape_dict(mesh)
        index = 0
        for a in axes:
            index = index * sizes[a] + mesh.get_local_rank(a)
        rows = sh.batch_rows(tcfg.global_batch, index,
                             sh.axis_size(sizes, axes),
                             int(parallel.microbatches))
        writer = sh.rank() == 0
    loader = TokenBatchLoader(cfg.vocab_size, tcfg.seq_len, tcfg.global_batch,
                              seed=tcfg.seed, collector=collector, rows=rows)
    records = tcfg.global_batch if rows is None else len(rows)
    watchdog = StragglerWatchdog(collector)
    ckpt_dir = tcfg.checkpoint_dir
    ckptr = (AsyncCheckpointer(ckpt_dir)
             if tcfg.async_checkpoint and writer else None)

    def fresh_state():
        params = M.init_params(cfg, seed=tcfg.seed, device=dev)
        state = (params, init_opt_state(params, ocfg))
        return state if mesh is None else reshard_tree(state, shardings)

    def try_restore():
        if mesh is not None:
            sh.barrier()        # the writer's checkpoint is on disk
        ls = latest_step(ckpt_dir)
        if ls is None:
            return None
        if mesh is None:
            like, placed = state_like(cfg, ocfg, dev), None
        else:
            like, placed = state_like(cfg, ocfg, "meta"), shardings
        (params, opt_state), step0, extra = restore_checkpoint(
            ckpt_dir, ls, like, placed)
        loader.load_state_dict(extra.get("loader", {"step": step0,
                                                    "seed": tcfg.seed}))
        return params, opt_state, step0

    try:
        restored = try_restore()
        if restored is not None:
            params, opt_state, step0 = restored
        else:
            params, opt_state = fresh_state()
            step0 = 0

        losses = []
        restarts = retries = 0
        stragglers_seen: Dict[str, int] = {}
        step = step0
        while step < tcfg.steps:
            try:
                with span("datagen+next", collector, records=records):
                    host_batch = loader.next()
                with span("h2d", collector, records=records):
                    batch = {k: torch.from_numpy(v).to(dev)
                             for k, v in host_batch.items()}

                def do_step():
                    with span("train_step", collector, records=records):
                        out = step_fn(params, opt_state, batch)
                        out[2]["loss"].item()     # the step has finished
                        return out

                try:
                    new_params, new_opt, m = retry_step(do_step,
                                                        injector=injector)
                except TransientFault:
                    retries += 1
                    continue
                params, opt_state = new_params, new_opt
                loss = float(m["loss"])
                losses.append(loss)
                metrics.observe("loss", loss)
                metrics.inc("steps")
                step += 1

                for name, info in watchdog.stragglers().items():
                    stragglers_seen[name] = stragglers_seen.get(name, 0) + 1
                    metrics.observe(f"straggler.{name}", info["ratio"])

                if step % tcfg.checkpoint_every == 0 or step == tcfg.steps:
                    with span("checkpoint", collector, records=1):
                        extra = {"loader": loader.state_dict()}
                        state = (params, opt_state)
                        if mesh is not None:
                            state = gather_tree(state, shardings)
                        if ckptr is not None:
                            ckptr.save(step, state, extra)
                        elif writer:
                            save_checkpoint(ckpt_dir, step, state, extra)
                        del state
                if verbose and writer and step % tcfg.log_every == 0:
                    print(f"step {step:5d} loss {loss:.4f}")
            except NodeLoss:
                # restart-from-checkpoint: the real cluster would re-mesh
                restarts += 1
                if ckptr is not None:
                    ckptr.wait()
                params = opt_state = None      # free the lost state first
                restored = try_restore()
                if restored is not None:
                    params, opt_state, step = restored
                else:
                    params, opt_state = fresh_state()
                    step = 0
    finally:
        if ckptr is not None:
            ckptr.close()
        loader.close()
    if ckptr is not None and ckptr.errors:
        raise RuntimeError(f"checkpoint writes failed: {ckptr.errors!r}")
    return TrainResult(step, losses[-1] if losses else float("nan"), losses,
                       restarts, retries, stragglers_seen, collector, metrics,
                       params, opt_state)
