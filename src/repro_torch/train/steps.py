"""Train-step factory: loss -> grads -> AdamW, on one device or over a
mesh of ranks.

Counterpart: ``repro.train.steps`` (``train_shardings``,
``make_train_step``). The step computes what the reference's jitted step
computes:

* with an FSDP axis configured and a compute dtype other than the
  parameters', every float32 leaf is cast to the compute dtype before the
  forward (the reference's pre-gather cast; the float32 master copy only
  feeds the optimizer), then ``models.model.loss_fn`` under
  ``parallel.remat``;
* the gradient through autograd (the reference's ``value_and_grad``):
  the parameters enter as leaves that require grad, so the attention and
  scans take the reference's training route (``kernels/ops.py``) and no
  forward kernel runs;
* ``parallel.microbatches`` > 1: the batch split into equal microbatches
  (``positions`` [3, b, s] along its batch axis), gradients summed in
  float32 and divided by their number, metrics averaged likewise;
* ``optim.adamw.adamw_update``, clipped by the norm of the whole
  gradient.

With ``mesh=`` (a ``DeviceMesh`` with axes among ``pod``, ``data`` and
``model``; ``launch.mesh``) the same step is FSDP over the batch axes
and tensor parallelism over ``model``, one process per GPU, each calling
it with its own shards and rows (one device is the step with no mesh
axes):

* each rank holds its shard of every leaf as
  ``distributed.elastic.state_shardings`` lays it out (the reference's
  specs in the compute layout over ``model``; under int8 moments a
  parameter takes its moments' block layout, whole along ``model``,
  since the block quantization couples a block's values);
* the float32 shards are cast, then all-gathered over the FSDP axis
  alone into the rank's compute shard (a block-laid leaf is gathered
  whole and cut to its ``model`` part); the forward runs inside the
  step's ``sharding.RankContext``: the blocks split their heads, widths
  and vocabulary over ``model`` (``models``), and with
  ``expert_axis="model"`` the experts (``models.moe``: each rank's own,
  their results summed over ``model``); remat's recomputation
  re-enters that context on whatever thread autograd runs it;
* the batch arrives as the rank's rows over ``batch_axes``
  (``sharding.batch_rows``, microbatch by microbatch as the reference
  splits; the ranks of one batch index take the same rows); the loss is
  the reference's, the nll summed over the whole (micro)batch over the
  mask count of the whole (micro)batch, an all-reduced count, so ranks
  whose masks differ still give its mean; over a vocabulary split over
  ``model`` the loss reduces the rank's columns where they lie; the MoE
  balance loss is the product of the whole (micro)batch's per-expert
  means (the ranks' [E] token fractions and probability means
  all-reduced before the product, ``RankContext.batch_stats``), which
  needs each rank's tokens in whole dispatch groups;
* the gradients (float32) of the compute shards are reduce-scattered
  back over the FSDP axis and summed over the batch axes a leaf is not
  split over; a leaf whose ``model`` parts several ranks hold (K/V heads
  where ``model`` exceeds them) has its parts' gradients summed over
  those ranks, and a block-laid leaf its ``model`` parts assembled into
  the whole leaf first; AdamW runs on the shards, clipped by the norm of
  the whole gradient (each shard counted once);
* ``grad_compression="int8"`` on a mesh with a ``pod`` axis is the
  reference's ``_pod_compressed_grads``: each pod's gradient of its own
  rows' mean loss (all-reduced over its ``data`` ranks, whole along
  ``model``), a per-block absmax taken as a MAX across pods, int8
  quantization against that shared scale, an int32 SUM across pods,
  dequantization divided by the number of pods; the metrics are
  averaged over pods. On a mesh without a pod axis (one device
  included) it does nothing, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, OptimizerConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.elastic import state_shardings
from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import compute_dtype
from repro_torch.optim.adamw import (OptState, adamw_update,
                                     opt_state_specs, sq_norm)
from repro_torch.optim.compression import (block_absmax,
                                           quantize_int8_with_scale)

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


def train_shardings(cfg: ModelConfig, ocfg: OptimizerConfig,
                    parallel: ParallelConfig, mesh, batch_abstract: Dict):
    """(parameter specs, optimizer-state specs, batch specs) over
    ``mesh`` (a ``DeviceMesh`` or an ``{axis: size}`` mapping), the
    reference's."""
    rules = sh.build_rules(parallel, mesh)
    mshape = sh.mesh_shape_dict(mesh)
    pspecs = M.partition_specs(cfg, rules, mshape)
    ospecs = opt_state_specs(pspecs, ocfg, M.abstract_params(cfg),
                             parallel.fsdp_axis or "data", mshape)
    bspecs = sh.input_batch_specs(batch_abstract, parallel, mesh)
    return pspecs, ospecs, bspecs


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    parallel: ParallelConfig, device="cuda", mesh=None
                    ) -> Callable[[Dict, OptState, Dict],
                                  Tuple[Dict, OptState, Dict]]:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on ``device`` (``"cuda"`` by default, the rank's current card; raises
    without one): new parameter and state dicts (the inputs are not
    modified) and 0-dim float32 metrics ``loss``, ``nll``, ``aux`` and
    ``tokens``. The step's ``grads`` attribute is its gradient half
    alone (float32). With ``mesh`` the state is each rank's shards
    (``step.shardings``) and the batch its rows (see the module
    docstring); the metrics are the whole batch's on every rank. One
    device is the case of no mesh axes: nothing is gathered, reduced or
    split."""
    resolve_device(device)
    shape = sh.mesh_shape_dict(mesh) if mesh is not None else {}
    tp = parallel.tp_axis
    pshard = oshard = comp = None
    if mesh is not None:
        pshard, oshard = state_shardings(cfg, ocfg, parallel, mesh)
        comp = {n: sh.Sharding(mesh, tuple(e if e == tp else None
                                           for e in spec), shp, kind=kind)
                for n, (spec, shp, kind) in M.train_layout(
                    cfg, parallel, mesh).items()}
    cdt = compute_dtype(cfg)
    cast = bool(parallel.fsdp_axis) and cdt != getattr(torch,
                                                       cfg.param_dtype)
    k = int(parallel.microbatches)
    if k < 1:
        raise ValueError(f"microbatches must be >= 1, got {k}")
    batch_axes = sh.batch_partition(parallel, shape)
    compress = (parallel.grad_compression == "int8" and "pod" in shape
                and shape["pod"] > 1)
    pods = mesh.get_group("pod") if compress else None
    npods = shape.get("pod", 1)
    # the ranks whose rows make one batch mean: the whole batch's, or a
    # pod's when the pods reduce their gradients themselves
    mean_axes = tuple(a for a in batch_axes
                      if shape[a] > 1 and not (compress and a == "pod"))
    n_mean = int(np.prod([shape[a] for a in mean_axes])) if mean_axes else 1
    moe_stats = cfg.moe is not None and n_mean > 1

    def over(axes, x, op="sum"):
        for a in axes:
            x = sh.all_reduce(x, op, mesh.get_group(a))
        return x

    def batch_mean(x):
        # the mean over the mean's ranks of their equal-sized rows' means
        return over(mean_axes, x) / float(n_mean)

    def stats(frac_tokens, frac_probs):
        # the whole batch's balance statistics; each rank's probabilities
        # carry their share (1/n) of the gradient, so the ranks' summed
        # gradients are those of the whole batch's product
        probs = batch_mean(frac_probs.detach())
        return (batch_mean(frac_tokens.detach()),
                probs + (frac_probs - frac_probs.detach()) / float(n_mean))

    tp_mesh = None
    if shape.get(tp, 1) > 1:
        tp_mesh = sh.ServeMesh.of(mesh, parallel, model_only=True)
    context = sh.RankContext(tp_mesh, stats if moe_stats else None)

    def fsdp(s):
        # the axes a leaf's FSDP shard is gathered and reduced over
        return tuple(a for a in s.axes if a != tp)

    def gathered(params):
        full = {}
        for n, p in params.items():
            if cast and p.dtype == torch.float32:
                p = p.to(cdt)
            if pshard is None:
                full[n] = p
            elif pshard[n].block is not None:
                # the block layout: the whole leaf, then its model part
                p = pshard[n].gather(p)
                full[n] = comp[n].shard(p) if comp[n].axes else p
            else:
                full[n] = pshard[n].gather(p, fsdp(pshard[n]))
        return full

    def to_shard(n, g):
        # this rank's shard of the whole batch's gradient, from the
        # gradient of its compute shard
        s, c = pshard[n], comp[n]
        rest = tuple(a for a in mean_axes if a not in s.axes)
        if compress or s.block is not None:
            if c.axes:
                g = c.assemble(g) if c.sharers() > 1 else c.gather(g)
            if compress:
                return s.shard(_pod_compress(over(mean_axes, g), pods,
                                             npods))
            return over(rest, s.reduce(g))
        if c.sharers() > 1:
            g = c.shard(c.assemble(g))
        return over(rest, s.reduce(g, fsdp(s)))

    def grad_fn(full, batch, denom):
        if moe_stats and batch["tokens"].numel() % moe_mod.GROUP_SIZE:
            raise ValueError(
                f"an MoE model over a data mesh needs each rank's tokens "
                f"in whole dispatch groups of {moe_mod.GROUP_SIZE}, got "
                f"{batch['tokens'].numel()} (rows x sequence a rank and "
                f"microbatch)")
        names = list(full)
        leaves = [full[n].detach().requires_grad_() for n in names]
        with torch.enable_grad(), sh.within(context):
            loss, metrics = M.loss_fn(dict(zip(names, leaves)), cfg, batch,
                                      remat=parallel.remat, denom=denom)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: (torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device) if g is None
                     else g.to(torch.float32))
                 for n, x, g in zip(names, leaves, grads)}
        return grads, {m: metrics[m].detach() for m in METRICS}

    def compute_grads(params, batch):
        full = gathered(params)
        parts = [batch] if k == 1 else _microbatch(batch, k)
        counts = torch.stack([M.loss_mask(mb).sum() for mb in parts])
        denoms = torch.clamp_min(over(mean_axes, counts), 1.0)
        gsum, ms = None, []
        for i, mb in enumerate(parts):
            g, metrics = grad_fn(full, mb, denoms[i])
            gsum = g if gsum is None else {n: gsum[n] + g[n] for n in gsum}
            ms.append(metrics)
        del full
        # each microbatch's loss: its nll summed over the mean's ranks
        # (each holds its share of the count), its aux the whole batch's
        nlls = over(mean_axes, torch.stack([m["nll"] for m in ms]))
        per = [{"loss": nlls[i] + m["aux"], "nll": nlls[i], "aux": m["aux"],
                "tokens": m["tokens"]} for i, m in enumerate(ms)]
        metrics = per[0]
        for m in per[1:]:
            metrics = {name: metrics[name] + m[name] for name in METRICS}
        if k > 1:
            gsum = {n: g / float(k) for n, g in gsum.items()}
            metrics = {m: v / float(k) for m, v in metrics.items()}
        local = {n: to_shard(n, g) if pshard else g
                 for n, g in gsum.items()}
        if compress:
            metrics = {m: sh.all_reduce(v, "sum", pods) / float(npods)
                       for m, v in metrics.items()}
        return local, metrics

    def global_norm(grads):
        # each leaf's squares summed over the axes it is split over, a
        # shard that several ranks hold counted once
        by_axes = {}
        for n, g in grads.items():
            a = pshard[n].axes if pshard else ()
            sq = sq_norm(g)
            if pshard and not pshard[n].counted():
                sq = torch.zeros_like(sq)
            by_axes[a] = by_axes.get(a, 0.0) + sq
        total = sum(over(a, v) for a, v in sorted(by_axes.items()))
        return torch.sqrt(total)

    def step(params, opt_state, batch):
        grads, metrics = compute_grads(params, batch)
        new_params, new_state = adamw_update(params, grads, opt_state, ocfg,
                                             gnorm=global_norm(grads))
        return new_params, new_state, dict(metrics)

    #: ``grads(params, batch) -> (grads, metrics)``: the step's gradient
    #: half alone, for checks against another device or the reference
    step.grads = compute_grads
    #: the rank's compute shards of its state's parameters, and the
    #: context its forward runs in (for driving the forward by hand)
    step.compute_params = gathered
    step.context = context
    step.shardings = (pshard, oshard)
    return step


def _pod_compress(g: torch.Tensor, pods, npods: int,
                  block: int = 256) -> torch.Tensor:
    """The reference's cross-pod int8 reduction of one pod-local
    gradient: a shared per-block scale (MAX across pods), an int32 SUM of
    the int8 payloads, dequantized and divided by the number of pods."""
    absmax = block_absmax(g.to(torch.float32), block)
    # tensor divisors: CUDA divides by a Python scalar through its
    # reciprocal, which is not the division the reference rounds
    scale = (sh.all_reduce(absmax, "max", pods)
             / torch.full_like(absmax, 127.0))
    q = quantize_int8_with_scale(g.to(torch.float32), scale, block)
    qsum = sh.all_reduce(q.to(torch.int32), "sum", pods)
    deq = (qsum.to(torch.float32) * scale[:, None]).reshape(-1)
    deq = deq[: g.numel()].reshape(g.shape)
    return (deq / torch.full_like(deq, float(npods))).to(g.dtype)
