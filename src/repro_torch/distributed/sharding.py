"""Logical-axis -> mesh-axis rules, specs, shardings and the collectives
of the multi-GPU layer.

Counterpart: ``repro.distributed.sharding``. The reference is
single-controller SPMD: one program over a ``jax.sharding.Mesh``, laid
out by ``PartitionSpec``s, ``shard_map`` and GSPMD. The port is one
process per GPU under ``torch.distributed``: the caller starts the ranks
(``torchrun``, or ``torch.multiprocessing`` in tests), every rank makes
the same call with the same arguments, and every rank gets the same
result. "cuda" means the rank's current CUDA device, which the launcher
sets from ``LOCAL_RANK``.

* The rule table (``build_rules``, ``batch_partition``,
  ``input_batch_specs``) is the reference's, over the mesh's axis sizes:
  a ``torch.distributed.device_mesh.DeviceMesh`` (``launch.mesh``) or a
  plain ``{axis: size}`` mapping, for planning without ranks.
* A spec is a tuple with one entry per dim: ``None`` (not split), a mesh
  axis name, or a tuple of names (split over their product, the first
  slowest) — the counterpart of ``PartitionSpec``, and equal to
  ``tuple(spec)`` of the reference's; ``()`` replicates every dim. A
  spec that names one axis twice raises (``check_spec``); a dim over
  several axes is cut, gathered and reduced through the group of the
  ranks that share every other coordinate (``axis_group``, a flattened
  sub-mesh).
* ``Sharding`` (the counterpart of ``NamedSharding``) places a leaf: it
  cuts a rank's shard out of a whole tensor and gathers the shards back.
  With ``block=`` the spec applies to the leaf's flattened, zero-padded
  ``[n_blocks, block]`` view, the layout of the int8 optimizer moments.
* ``shard_map``, ``set_activation_mesh`` and ``constrain`` have no
  counterpart. They are anchors for GSPMD's layout solve; here each rank
  runs its own program and the modules split tensors explicitly. The
  reference's warn-once on a dim that does not divide its mesh axis
  therefore fires where the port splits a tensor: ``input_batch_specs``
  and ``resolve_mesh_axis`` (each also counting
  ``warn.replication_fallback``).
* The collectives live here and nowhere else: ``all_gather``,
  ``reduce_scatter``, ``all_reduce``, ``gather_host`` (a rank's host
  result rows to every rank) and ``gather_objects`` (``run_lanes``, the
  restart meshes), plain functions of tensors that carry no gradient (a
  tensor that needs one raises), and the model's, each a
  ``torch.autograd.Function`` that keeps its process group from its
  forward for its backward: ``row_sum`` (a row-parallel product's
  partials summed over ``model`` in float32) and ``model_sum`` (its
  backward the identity: the sum feeds work every rank repeats),
  ``tp_enter`` (Megatron's "f": the identity, and in backward the
  ranks' gradients summed), ``vocab_embed`` and ``vocab_logits`` /
  ``tp_gather`` (the vocabulary or a width split over ``model``; the
  gather's backward the rank's slice) and ``expert_exchange`` (the
  experts' slots to and from their ranks over the expert axis,
  ``all_to_all_single``; its backward the reverse exchange). On a
  ``gloo`` group they stage CUDA tensors through host memory (gloo's
  collectives are host collectives) and a reduce-scatter is an
  all-reduce and a slice; on ``nccl`` host arrays travel through the
  rank's card; on the ``fake`` backend of the dry run
  (``launch.dryrun``) they stay on the tensors' device and move nothing.
  ``tally()`` counts every collective this module issues, by XLA's kind
  names and result bytes.
* A step over a mesh (``ServeMesh``, ``RankContext``, ``within``): the
  model code asks ``serve_mesh()`` for the mesh of the serving or
  training step it runs in (None on one device) and splits its work by
  it (the rows over one batch axis or over ``("pod", "data")``; a cache
  split along its sequence over ``seq_axis``), and an MoE layer asks
  ``context().batch_stats`` for the whole batch's balance statistics;
  ``Sharding`` with ``kind`` places the leaves whose compute layout is
  not the spec's contiguous chunk (``models.model.serve_placement`` /
  ``train_layout``).
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.config import ParallelConfig

Spec = Tuple

# replication fall-backs already reported, keyed by (where, axis, dim,
# size): each distinct one warns once a process
_REPLICATION_WARNED = set()


def _warn_replicated(where: str, axis, dim: int, size: int):
    # the counter bumps on every fall-back; the warning fires once
    obs.event("warn.replication_fallback", where=where, axis=str(axis))
    key = (where, str(axis), int(dim), int(size))
    if key in _REPLICATION_WARNED:
        return
    _REPLICATION_WARNED.add(key)
    warnings.warn(
        f"{where}: dim {dim} is not divisible by mesh axis {axis!r} "
        f"(size {size}); falling back to replication — this dimension "
        f"gets NO parallelism. Pad the dim to a multiple of {size} or "
        f"shrink the mesh axis to recover it.",
        RuntimeWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def world_size() -> int:
    """Ranks in the default process group (0 when there is none)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_world_size()


def rank() -> int:
    return dist.get_rank() if world_size() else 0


def require_ranks(devices: int, where: str) -> int:
    """``devices`` as a mesh size the default group can give: a positive
    int no larger than its world. Raises ``ValueError`` naming how to
    start the ranks otherwise (the counterpart of the reference's
    ``XLA_FLAGS`` message)."""
    devices = int(devices)
    if devices <= 0:
        raise ValueError(f"devices must be a positive mesh size, "
                         f"got {devices}")
    world = world_size()
    if devices > world:
        have = ("no torch.distributed process group is initialized"
                if not world else
                f"the process group has only {world} rank(s)")
        raise ValueError(
            f"{where}: devices={devices} but {have}; start {devices} "
            f"ranks (torchrun --nproc-per-node={devices} ..., or "
            f"torch.multiprocessing) and call "
            f"torch.distributed.init_process_group in each before this "
            f"call")
    return devices


def resolve_mesh_axis(devices, dim: int, where: str,
                      axis: str = "restart") -> Optional[int]:
    """Validate a user-facing ``devices=`` request and return the mesh
    size to run, or ``None`` to run unsharded.

    ``None``/1 asks for no mesh; a non-positive size, or more than the
    default group's ranks (or no group at all), raises ``ValueError``;
    a ``dim`` that the size does not divide falls back to the unsharded
    path with the warn-once replication ``RuntimeWarning`` — results are
    the same either way."""
    if devices is None or devices == 1:
        return None
    devices = require_ranks(devices, where)
    if dim % devices != 0:
        _warn_replicated(where, axis, dim, devices)
        return None
    return devices


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------

def mesh_shape_dict(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` or of an ``{axis: size}``
    mapping, in the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"a mesh is a DeviceMesh with named axes or an "
                        f"{{axis: size}} mapping, got {type(mesh).__name__}")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def build_rules(parallel: ParallelConfig, mesh) -> Dict[str, object]:
    axes = set(mesh_shape_dict(mesh))

    def ax(a):
        return a if a in axes else None

    batch = tuple(a for a in parallel.batch_axes if a in axes)
    seq_ax = parallel.seq_axis
    if isinstance(seq_ax, tuple):
        seq_ax = tuple(a for a in seq_ax if a in axes) or None
    else:
        seq_ax = ax(seq_ax)
    return {
        "vocab": ax(parallel.tp_axis),
        "embed": ax(parallel.fsdp_axis),
        "mlp": ax(parallel.tp_axis),
        "heads": ax(parallel.tp_axis),
        "kv": ax(parallel.tp_axis),
        "kv_heads": ax(parallel.tp_axis),
        "expert": ax(parallel.expert_axis),
        "batch": batch if batch else None,
        "cache_seq": seq_ax if parallel.shard_cache_seq else None,
        # activation-only logical axes (the reference's constrain())
        "heads_act": ax(parallel.tp_axis),
        "kv_heads_act": ax(parallel.tp_axis),
        "vocab_act": ax(parallel.tp_axis),
        "mlp_act": ax(parallel.tp_axis),
        "expert_act": ax(parallel.expert_axis),
        "seq_act": None,
        # small / replicated dims
        "rank": None, "state": None, "conv": None, "norm": None,
        "layers": None, "groups": None,
    }


def batch_partition(parallel: ParallelConfig, mesh) -> Tuple[str, ...]:
    axes = set(mesh_shape_dict(mesh))
    return tuple(a for a in parallel.batch_axes if a in axes)


def axis_size(mesh_shape: Dict[str, int], entry) -> int:
    """The number of shards a spec entry makes."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return int(np.prod([mesh_shape.get(a, 1) for a in names]))


def entry_names(entry) -> Tuple[str, ...]:
    """The mesh axes of a spec entry (a name or a tuple of names)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def check_spec(spec: Spec, where: str = "a spec"):
    """Raise ``ValueError`` where ``spec`` names one mesh axis twice (the
    reference's ``PartitionSpec`` refuses it too): a dim cannot be cut
    along an axis another dim already takes."""
    seen = set()
    for entry in spec:
        for a in entry_names(entry):
            if a in seen:
                raise ValueError(f"{where} {spec!r} names mesh axis {a!r} "
                                 f"twice")
            seen.add(a)


#: flattened sub-meshes of ``axis_group``, keyed by (mesh, axes)
_FLAT: Dict[Tuple, object] = {}


def axis_group(mesh, entry):
    """(process group, size, this rank's index) of a spec entry over a
    ``DeviceMesh``: one axis's own group, or for several axes the group
    of the ranks that share every other coordinate, indexed with the
    first-named axis slowest (as ``PartitionSpec(("data", "model"))``
    orders a dim's shards). Axes of size one drop out; with none left
    ``(None, 1, 0)``."""
    shape = mesh_shape_dict(mesh)
    names = tuple(a for a in entry_names(entry) if shape.get(a, 1) > 1)
    if not names:
        return None, 1, 0
    index = 0
    for a in names:
        index = index * shape[a] + mesh.get_local_rank(a)
    size = int(np.prod([shape[a] for a in names]))
    if len(names) == 1:
        return mesh.get_group(names[0]), size, index
    key = (id(mesh), names)
    if key not in _FLAT:
        _FLAT[key] = (mesh, mesh[names]._flatten())
    return _FLAT[key][1].get_group(), size, index


def _entry(axes: Tuple[str, ...]):
    """A spec entry of ``axes``, written as the reference's
    ``PartitionSpec`` normalizes it: one axis by its name, none as
    ``None``."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def input_batch_specs(batch_abstract: Dict, parallel: ParallelConfig,
                      mesh) -> Dict[str, Spec]:
    """Specs of a model input batch (values with a ``.shape``): dim 0
    (the batch) split over the data-parallel axes when it divides them;
    positions [3, b, s] split on dim 1."""
    dp = batch_partition(parallel, mesh)
    size = axis_size(mesh_shape_dict(mesh), dp)
    dp_entry = _entry(dp)
    out = {}
    for k, v in batch_abstract.items():
        shape = tuple(v.shape)
        if k == "positions" and len(shape) == 3:
            if shape[1] % size == 0:
                out[k] = (None, dp_entry, None)
            else:
                if size > 1:
                    _warn_replicated(f"input_batch_specs({k!r})", dp,
                                     shape[1], size)
                out[k] = ()
        elif len(shape) >= 1 and shape[0] % size == 0 and size > 1:
            out[k] = (dp_entry,) + (None,) * (len(shape) - 1)
        else:
            if size > 1 and len(shape) >= 1:
                _warn_replicated(f"input_batch_specs({k!r})", dp,
                                 shape[0], size)
            out[k] = ()
    return out


def batch_rows(batch: int, index: int, size: int,
               microbatches: int = 1) -> np.ndarray:
    """The rows of a global batch of ``batch`` that shard ``index`` of
    ``size`` holds under a batch spec, in the order it feeds them: with
    ``microbatches`` k the reference splits the global batch into k
    microbatches first and each of them over the shards, so shard
    ``index`` holds rows ``i * b/k + index * b/(k size) + [0, b/(k
    size))`` for each microbatch i."""
    if batch % (size * microbatches):
        raise ValueError(f"a batch of {batch} does not split into "
                         f"{microbatches} microbatch(es) over {size} "
                         f"shard(s)")
    per_mb = batch // microbatches
    per = per_mb // size
    return np.concatenate([i * per_mb + index * per + np.arange(per)
                           for i in range(microbatches)])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _comm_device(group, like: torch.device) -> torch.device:
    """Where a collective's tensors must live: the host for gloo, the
    rank's card for nccl, the tensor's own device for the ``fake``
    backend of a dry run (``launch.dryrun``), whose collectives move
    nothing."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "fake" or like.type == "cuda":
        return like
    return torch.device("cuda", torch.cuda.current_device())


#: the open tallies of ``tally()``, innermost last
_TALLIES: List[Dict[str, Dict[str, int]]] = []

#: the collectives' kinds, named as XLA's HLO names them
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


@contextlib.contextmanager
def tally():
    """Within the block, every collective this module issues, as
    ``{kind: {"bytes", "count"}}`` over ``COLLECTIVE_KINDS``: the bytes
    of each call's result on this rank (an all-gather's whole result, a
    reduce-scatter's part), as the reference's dry run sums the result
    operands of the collectives in its HLO. A rank's own calls, on
    every thread; a group of one issues none."""
    out = {k: {"bytes": 0, "count": 0} for k in COLLECTIVE_KINDS}
    _TALLIES.append(out)
    try:
        yield out
    finally:
        _TALLIES.remove(out)


def _count(kind: str, result: torch.Tensor):
    for t in _TALLIES:
        t[kind]["bytes"] += result.numel() * result.element_size()
        t[kind]["count"] += 1


def _no_gradient(x: torch.Tensor, what: str):
    """A plain collective carries no gradient: refuse a tensor that needs
    one rather than cut it (the model's collectives are the
    ``autograd.Function``s below)."""
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"sharding.{what} carries no gradient; a tensor "
                           f"that needs one goes through the model's "
                           f"collectives (row_sum, model_sum, tp_enter, "
                           f"tp_gather, expert_exchange)")


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim``, in
    rank order, on ``x``'s device."""
    _no_gradient(x, "all_gather")
    n = dist.get_world_size(group)
    if n == 1:
        return x
    dev = _comm_device(group, x.device)
    src = x.movedim(dim, 0).contiguous().to(dev)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    _count("all-gather", out)
    return out.to(x.device).movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int = 0,
                   group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` (equal shapes), this rank's equal
    part of it along ``dim``, on ``x``'s device: ``reduce_scatter_tensor``
    on ``nccl``; on ``gloo`` the whole sum (an all-reduce, which every
    gloo build has) and this rank's part of it."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {n} ranks")
    dev = _comm_device(group, x.device)
    src = x.movedim(dim, 0).contiguous().to(dev)
    part = src.shape[0] // n
    if dist.get_backend(group) == "gloo":
        dist.all_reduce(src, group=group)
        me = dist.get_rank(group)
        out = src[me * part:(me + 1) * part]
    else:
        out = torch.empty((part,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=dev)
        dist.reduce_scatter_tensor(out, src, group=group)
    _count("reduce-scatter", out)
    return out.to(x.device).movedim(0, dim).contiguous()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The reduction (``"sum"``, ``"max"`` or ``"min"``) of every rank's
    ``x``, as a new tensor on ``x``'s device."""
    _no_gradient(x, "all_reduce")
    if dist.get_world_size(group) == 1:
        return x.clone()
    dev = _comm_device(group, x.device)
    buf = x.to(dev, copy=True).contiguous()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    _count("all-reduce", buf)
    return buf.to(x.device)


def gather_host(rows: np.ndarray, group=None) -> List[np.ndarray]:
    """Every rank's host array (equal shapes and dtypes), in rank order,
    on every rank: how a rank's result rows reach the others, bit for
    bit. Without a process group (or in a group of one) ``[rows]``."""
    if not world_size() or dist.get_world_size(group) == 1:
        return [rows]
    t = torch.from_numpy(np.ascontiguousarray(rows))
    n = dist.get_world_size(group)
    full = all_gather(t.reshape((1,) + t.shape), 0, group)
    return [full[k].numpy() for k in range(n)]


def gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj`` (a tuple of host arrays, or None
    from a rank that computed nothing), in rank order, on every rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def run_lanes(run, lanes: int, devices: int, axes: Tuple[int, ...]):
    """A lane-parallel problem over the first ``devices`` ranks: rank k
    calls ``run(lo, hi)`` on its equal share [lo, hi) of the ``lanes``
    lanes (ranks past ``devices`` call nothing), and every rank gets the
    tuple of host arrays ``run`` returns with the shares joined in lane
    order, each array along its entry of ``axes``."""
    me, per = rank(), lanes // devices
    got = gather_objects(run(me * per, (me + 1) * per)
                         if me < devices else None)
    return tuple(np.concatenate([g[i] for g in got[:devices]], axis=ax)
                 for i, ax in enumerate(axes))


def barrier(group=None):
    if world_size():
        dist.barrier(group=group)


# ---------------------------------------------------------------------------
# the model's collectives, under autograd
# ---------------------------------------------------------------------------
#
# Each keeps its group in ``ctx`` at forward time: autograd may run the
# backward on another thread (CUDA's device thread), where nothing of the
# forward's ``RankContext`` is set.

class _ModelSum(torch.autograd.Function):
    """The sum over ``group``; backward the identity (the sum feeds work
    every rank repeats, so each rank's gradient of it is the whole)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Enter(torch.autograd.Function):
    """Megatron's "f": the identity; backward the sum over ``group``, in
    float32 and rounded once to the gradient's dtype (as ``row_sum``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.float(), group=ctx.group).to(grad.dtype), None


class _Gather(torch.autograd.Function):
    """Every rank's part along ``dim`` concatenated; backward the slice
    of this rank's part (the whole feeds work every rank repeats)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.width, ctx.group = dim, x.shape[dim], group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        me = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, me * ctx.width, ctx.width), None, None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    dev = _comm_device(group, x.device)
    src = x.contiguous().to(dev)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _count("all-to-all", out)
    return out.to(x.device)


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks; backward the same exchange
    of the gradient, which sends each chunk back where it came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def model_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``, for work that every
    rank of the group then repeats; the gradient of the sum is each
    rank's gradient of its own term."""
    if dist.get_world_size(group) == 1:
        return x
    return _ModelSum.apply(x, group)


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, replicated over ``group``, where it enters the rank's part of
    a split computation: the identity, whose backward sums the ranks'
    gradients of their parts, so every rank holds the whole gradient of
    ``x`` (Megatron's "f"). A tensor without a gradient is returned as
    it is."""
    if not (x.requires_grad and torch.is_grad_enabled()) or \
            dist.get_world_size(group) == 1:
        return x
    return _Enter.apply(x, group)


def tp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor along ``dim`` from every rank's equal part, in
    rank order, for work that every rank then repeats."""
    if dist.get_world_size(group) == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), group)


def row_sum(partial: torch.Tensor, dtype: torch.dtype,
            group=None) -> torch.Tensor:
    """A row-parallel product's result: every rank's float32 partial
    product (its rows of the contraction) summed in float32 and rounded
    once to ``dtype``, as a one-device product accumulates in float32
    and rounds once. The gradient of the partial is the result's, cast to
    the partial's dtype."""
    return model_sum(partial.float(), group).to(dtype)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, lo: int,
                group=None) -> torch.Tensor:
    """Rows of a vocabulary-parallel table for ``tokens``: this rank holds
    rows [lo, lo + len(table)); a token outside them takes zeros here, and
    the sum over ``group`` gives each token its one row (exact: the other
    terms are zeros). The gradient reaches the rank's own rows."""
    local = tokens.long() - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)].float()
    rows = rows * inside[..., None]
    return model_sum(rows, group).to(table.dtype)


def vocab_logits(local: torch.Tensor, group=None) -> torch.Tensor:
    """The whole vocabulary's logits from every rank's columns (its
    vocabulary rows), in rank order along the last dim."""
    return tp_gather(local, local.dim() - 1, group)


def expert_exchange(x: torch.Tensor, group=None) -> torch.Tensor:
    """The expert-parallel exchange over ``group`` (n ranks): ``x``'s dim 0
    in n equal chunks, chunk j sent to rank j; returns the chunks received,
    rank i's in place i (``all_to_all_single``; gloo stages CUDA tensors
    through the host). Its backward is the reverse exchange."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of size {x.shape[0]} does not split over "
                         f"{n} ranks")
    return _Exchange.apply(x, group)


@dataclass(frozen=True)
class ServeMesh:
    """The groups a step splits its work over: ``model`` (the
    tensor-parallel axis: heads, channels, MLP widths, the vocabulary),
    the expert axis (``ParallelConfig.expert_axis``), the batch axes
    (the rows: one axis, or ``("pod", "data")`` as one group) and the
    sequence axes of a cache split along its sequence
    (``ParallelConfig.shard_cache_seq`` over ``seq_axis``: a name or a
    tuple), each with its size and this rank's place in it (a group of
    several axes indexed with the first-named slowest). A training step
    splits its blocks over ``model`` alone (``of(..., model_only=True)``):
    its rows are the rank's own batch, and FSDP gathers every expert
    unless they lie over ``model`` itself. Experts over the
    tensor-parallel axis share its group: the reference's specs then
    give the experts' dim the axis and leave their widths whole (a leaf
    names an axis once), so each rank multiplies its experts whole and
    the gathered results sum nothing; where the axis does not divide
    the experts they stay whole on every rank (``models.moe`` reads that
    off the leaves).

    A cache whose sequence the sequence axes do not divide stays whole,
    as the reference's spec leaves it: ``seq_self`` and ``seq_cross`` say
    whether the self-attention caches (``max_len`` long) and the
    cross-attention caches (``encoder_seq`` long) are split, and where
    neither is the mesh has no sequence group and serves as without
    ``shard_cache_seq``."""
    model: object
    model_size: int
    model_rank: int
    experts: object
    expert_size: int
    expert_rank: int
    batch: object
    batch_size: int
    batch_rank: int
    seq: object = None
    seq_size: int = 1
    seq_rank: int = 0
    #: whether the sequence axes include ``model``: the cache then holds
    #: every KV head (the reference's specs drop ``kv_heads`` where
    #: ``model`` already carries ``cache_seq``)
    seq_over_model: bool = False
    #: whether the rows are split over the expert axis; where they are
    #: not, the ranks of the expert group hold the same rows
    rows_over_experts: bool = True
    #: whether the self-attention caches and the cross-attention caches
    #: are split along the sequence axes (each where they divide its
    #: length)
    seq_self: bool = False
    seq_cross: bool = False

    @classmethod
    def of(cls, mesh, parallel: ParallelConfig, model_only: bool = False,
           max_len: Optional[int] = None,
           encoder_seq: Optional[int] = None) -> "ServeMesh":
        """The groups over ``mesh`` under ``parallel``. The rows go over
        the batch axes unless a cache is split along its sequence over
        one of them: then the reference's specs leave the batch whole
        (a batch that the axes divide would name an axis twice, which
        the placement refuses) and every rank holds every row. With
        ``shard_cache_seq`` over axes of more than one rank, ``max_len``
        (the self-attention caches' length) is needed, and
        ``encoder_seq`` (the cross-attention caches') where there are
        any."""
        shape = mesh_shape_dict(mesh)
        m = axis_group(mesh, parallel.tp_axis)
        if model_only:
            experts = (m if parallel.expert_axis == parallel.tp_axis
                       else (None, 1, 0))
            return cls(*m, *experts, None, 1, 0, rows_over_experts=False)
        seq = ()
        if parallel.shard_cache_seq:
            seq = tuple(a for a in entry_names(parallel.seq_axis)
                        if shape.get(a, 1) > 1)
        seq_self = seq_cross = False
        if seq:
            if max_len is None:
                raise ValueError(
                    f"a cache split along its sequence over {seq}: the "
                    f"serving step needs the cache's max_len")
            n = axis_size(shape, seq)
            seq_self = max_len % n == 0
            seq_cross = encoder_seq is not None and encoder_seq % n == 0
            if not (seq_self or seq_cross):
                seq = ()
        batch = tuple(a for a in batch_partition(parallel, mesh)
                      if shape[a] > 1)
        if set(batch) & set(seq):
            batch = ()
        return cls(*m, *axis_group(mesh, parallel.expert_axis),
                   *axis_group(mesh, batch), *axis_group(mesh, seq),
                   seq_over_model=parallel.tp_axis in seq,
                   rows_over_experts=parallel.expert_axis in batch,
                   seq_self=seq_self, seq_cross=seq_cross)

    def gather_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The whole batch's ``x`` from every rank's rows."""
        if self.batch_size == 1:
            return x
        return all_gather(x, dim, self.batch)


@dataclass(frozen=True)
class RankContext:
    """What the model code reads of the step it runs in: ``mesh``, the
    ``ServeMesh`` it splits its work over (None: one device), and
    ``batch_stats``, a function that turns an MoE layer's per-expert
    balance means [E] of the rank's rows into the whole batch's (None:
    the rank's rows are the batch; ``train.steps``)."""
    mesh: Optional[ServeMesh] = None
    batch_stats: Optional[Callable] = None


_NO_CONTEXT = RankContext()
_LOCAL = threading.local()


@contextlib.contextmanager
def within(ctx: RankContext):
    """Within the block the model code runs in ``ctx``, on this thread
    only: an engine serving on a worker thread (``ServeEngine.as_pipeline``)
    leaves the routing of another thread's steps as it was. A
    recomputation in backward, which autograd may run on another thread,
    re-enters the context its forward saw (``models.transformer``'s
    remat)."""
    prev = context()
    _LOCAL.ctx = ctx
    try:
        yield
    finally:
        _LOCAL.ctx = prev


def context() -> RankContext:
    """The ``RankContext`` of the step that runs on this thread."""
    return getattr(_LOCAL, "ctx", _NO_CONTEXT)


def serving(mesh: Optional[ServeMesh]):
    """``within`` a serving step's context: its mesh (None: one
    device)."""
    return within(RankContext(mesh=mesh))


def serve_mesh() -> Optional[ServeMesh]:
    """The ``ServeMesh`` of the serving or training step that runs on
    this thread, or None."""
    return context().mesh


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _block_view(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def split_index(n: int, size: int, index: int, kind: str = "chunk",
                heads: int = 0) -> torch.Tensor:
    """The positions along a dim of ``n`` that shard ``index`` of ``size``
    holds: ``"chunk"``, the contiguous chunk (the reference's layout);
    ``"halves"``, chunk ``index`` of each half (a Mamba ``in_proj``, whose
    halves are x and z: a rank needs its channels of both); ``"heads"``,
    a dim of ``heads`` equal heads: the contiguous chunk where they split
    evenly, else (``size`` a multiple of ``heads``) the one head that
    shard's query heads read, which ``size / heads`` shards share."""
    if kind == "halves":
        half = n // 2
        if half % size:
            raise ValueError(f"halves of {half} do not split over {size}")
        part = half // size
        own = torch.arange(index * part, (index + 1) * part)
        return torch.cat([own, half + own])
    if kind == "heads" and heads % size:
        if size % heads:
            raise NotImplementedError(
                f"{heads} heads over {size} shards: the shards must split "
                f"the heads or the heads the shards")
        width = n // heads
        head = index * heads // size
        return torch.arange(head * width, (head + 1) * width)
    if kind not in ("chunk", "heads"):
        raise ValueError(f"unknown split kind {kind!r}")
    if n % size:
        raise ValueError(f"a dim of {n} does not split over {size}")
    part = n // size
    return torch.arange(index * part, (index + 1) * part)


def cut_indices(shape, spec: Spec, mesh_shape: Dict[str, int],
                coord: Dict[str, int], kind=None) -> List[Tuple]:
    """[(dim, mesh axis, positions)] of each dim a leaf of ``shape`` is
    split along at mesh coordinate ``coord`` ({axis: index}) under
    ``spec``; ``kind`` (dim, kind, heads) names a dim cut by
    ``split_index``'s other kinds. A dim split over several axes (of
    size > 1) gives their tuple as its axis, cut in chunks by the
    flattened coordinate, the first-named axis slowest. A spec naming
    one axis twice raises ``ValueError``."""
    check_spec(spec)
    out = []
    for dim, entry in enumerate(spec):
        names = tuple(a for a in entry_names(entry)
                      if mesh_shape.get(a, 1) > 1)
        if not names:
            continue
        # several axes: their flattened coordinate, the first slowest
        index = 0
        for a in names:
            index = index * mesh_shape[a] + coord[a]
        k, heads = ("chunk", 0)
        if kind is not None and kind[0] == dim:
            if len(names) > 1:
                raise NotImplementedError(
                    f"a {kind[1]!r} cut over several mesh axes {names}")
            k, heads = kind[1], kind[2]
        axis = names[0] if len(names) == 1 else names
        out.append((dim, axis, split_index(shape[dim],
                                           axis_size(mesh_shape, axis),
                                           index, k, heads)))
    return out


@dataclass(frozen=True)
class Sharding:
    """How a leaf of global shape ``shape`` is laid out over ``mesh`` (a
    ``DeviceMesh``): ``spec`` names the mesh axes each dim is split over
    (the reference's ``NamedSharding(mesh, spec)``). With ``block`` the
    spec applies to the leaf's flattened, zero-padded ``[n_blocks,
    block]`` view. ``kind`` (dim, kind, heads) cuts that dim by
    ``split_index``'s ``"halves"`` or ``"heads"`` instead of in chunks. A
    rank outside the mesh holds the whole leaf."""
    mesh: object
    spec: Spec
    shape: Tuple[int, ...]
    block: Optional[int] = None
    kind: Optional[Tuple[int, str, int]] = None

    @property
    def device(self) -> torch.device:
        kind = self.mesh.device_type
        if kind == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(kind)

    def _view_shape(self) -> Tuple[int, ...]:
        if self.block is None:
            return tuple(self.shape)
        n = int(np.prod(self.shape)) if self.shape else 1
        return (-(-n // self.block), self.block)

    def _splits(self, axes=None):
        """[(dim, axis, positions)] of the dims actually split here (over
        ``axes`` alone, where given)."""
        if self.mesh.get_coordinate() is None:
            return []
        shape = mesh_shape_dict(self.mesh)
        coord = {a: self.mesh.get_local_rank(a) for a in shape
                 if shape[a] > 1}
        cuts = cut_indices(self._view_shape(), self.spec, shape, coord,
                           self.kind)
        return [c for c in cuts if axes is None or c[1] in axes]

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes this leaf is split over on this rank."""
        return tuple(a for _, a, _ in self._splits())

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """This rank's shard's shape (of the block view with ``block``)."""
        shape = list(self._view_shape())
        for dim, _, idx in self._splits():
            shape[dim] = len(idx)
        return tuple(shape)

    def sharers(self) -> int:
        """How many ranks hold this rank's shard: more than one for a
        ``"heads"`` cut where the axis exceeds the heads (the ranks whose
        query heads read one K/V head)."""
        if self.kind is None or self.kind[1] != "heads":
            return 1
        for dim, axis, _ in self._splits():
            if dim == self.kind[0]:
                size, heads = mesh_shape_dict(self.mesh)[axis], self.kind[2]
                return size // heads if heads % size else 1
        return 1

    def counted(self) -> bool:
        """Whether this rank's shard counts in a sum over the ranks (a
        norm): the first of its sharers."""
        n = self.sharers()
        if n == 1:
            return True
        axis = next(a for d, a, _ in self._splits() if d == self.kind[0])
        return self.mesh.get_local_rank(axis) % n == 0

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole leaf ``full`` (a new tensor on
        ``full``'s device)."""
        if tuple(full.shape) != tuple(self.shape):
            raise ValueError(f"a leaf of shape {tuple(full.shape)} for a "
                             f"sharding of {tuple(self.shape)}")
        x = full if self.block is None else _block_view(full, self.block)
        splits = self._splits()
        for dim, _, idx in splits:
            x = x.index_select(dim, idx.to(x.device))
        return x.contiguous() if splits else x.clone()

    def _partial(self, axes, what: str):
        splits = self._splits(axes)
        if axes is not None and self.block is not None and \
                len(splits) != len(self._splits()):
            raise NotImplementedError(f"a {what} over some of a block "
                                      f"layout's axes")
        return splits

    def gather(self, local: torch.Tensor, axes=None) -> torch.Tensor:
        """The whole leaf from every rank's shard (a collective over the
        split axes), on ``local``'s device; with ``axes`` the leaf whole
        along those mesh axes alone (a training rank's compute shard from
        its FSDP shard)."""
        x = local
        splits = self._partial(axes, "gather")
        shape = mesh_shape_dict(self.mesh) if splits else {}
        view = self._view_shape()
        for dim, axis, _ in reversed(splits):
            size = axis_size(shape, axis)
            parts = all_gather(x, dim, axis_group(self.mesh, axis)[0]).chunk(
                size, dim)
            whole = list(x.shape)
            whole[dim] = view[dim]
            out = x.new_empty(whole)
            k, heads = (self.kind[1], self.kind[2]) if (
                self.kind is not None and self.kind[0] == dim) else (
                "chunk", 0)
            for j, part in enumerate(parts):
                idx = split_index(view[dim], size, j, k, heads)
                out.index_copy_(dim, idx.to(x.device), part)
            x = out
        if self.block is not None:
            n = int(np.prod(self.shape)) if self.shape else 1
            x = x.reshape(-1)[:n].reshape(self.shape)
        return x

    def assemble(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf as the sum over the ranks of each rank's
        ``local`` put at its positions (zeros elsewhere): ``shard``'s
        adjoint, which turns the ranks' gradients of their parts into the
        whole leaf's gradient, parts that several ranks hold (``sharers``)
        summed. Not for a block layout."""
        if self.block is not None:
            raise NotImplementedError("assemble of a block layout")
        x = local
        for dim, axis, idx in self._splits():
            whole = list(x.shape)
            whole[dim] = self.shape[dim]
            x = all_reduce(x.new_zeros(whole).index_copy_(
                dim, idx.to(x.device), x),
                group=axis_group(self.mesh, axis)[0])
        return x

    def reduce(self, full: torch.Tensor, axes=None) -> torch.Tensor:
        """This rank's shard of the sum over the split axes (over ``axes``
        alone, where given) of every rank's ``full`` (a reduce-scatter),
        ``full`` whole along those axes; unsplit leaves come back whole
        and unreduced. A dim cut by ``kind`` takes no reduce-scatter."""
        splits = self._partial(axes, "reduce")
        if self.kind is not None and any(d == self.kind[0]
                                         for d, _, _ in splits):
            raise NotImplementedError("a reduce-scatter of a leaf cut by "
                                      f"kind {self.kind[1]!r}")
        x = full if self.block is None else _block_view(full, self.block)
        for dim, axis, _ in splits:
            x = reduce_scatter(x, dim, axis_group(self.mesh, axis)[0])
        return x
