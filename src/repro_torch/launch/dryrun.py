"""Production-mesh dry run: build and run every (arch x shape x mesh) cell
on a fake world of ranks, in one process, with no device memory.

Counterpart: ``repro.launch.dryrun``. The reference lowers and compiles
each cell's jitted step on 512 fake host devices and reads XLA's cost,
memory and collective analyses. Eager PyTorch has no compile to read, so
the port runs the cell's step itself, as rank 0 of a world of 256 (one
pod, ``(data, model)`` = (16, 16)) or 512 ranks (two pods, ``(pod, data,
model)``) made by torch's ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``, a private module: its
collectives return at once and move nothing). Every parameter, optimizer
state, cache and batch leaf is a ``FakeTensor`` (``FakeTensorMode``: a
shape, a dtype and no storage) of the rank's local shard shape
(``Sharding.local_shape`` of ``models.model.serve_placement``, of the
train step's ``shardings``), so a cell allocates no memory. The step
runs the port's plain route: CPU fake tensors take ``kernels/ref.py``, as
the reference's dry run runs with Pallas off (the CUDA kernels are
``ctypes`` calls on raw pointers and cannot run on fake tensors). The
Mamba and RWKV-6 recurrences run their body for one step, its output
repeated along the sequence (``_scans_once``): XLA's cost analysis
counts a scan's body once too (the reference's roofline puts the
recurrence under 1% of the projections' flops), and an eager loop over
4,096 steps of fake tensors, every layer and microbatch, would take
hours.

What a cell's record holds, and where the reference's number comes from:

* ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
  the step. It counts matrix products and attention, not elementwise
  work, where XLA's ``cost_analysis`` counts both: a lower bound of the
  HLO's flops.
* ``cost.bytes``: the operand and result bytes of every ATen operation
  the step dispatches (views excluded), the diagnostic counterpart of
  XLA's ``bytes accessed``. Eager runs fuse nothing, so it counts more
  traffic than a fused program; the roofline's memory term stays the
  analytic model (``launch.roofline.analytic_bytes``), as in the
  reference.
* ``collectives``: every collective ``distributed/sharding.py`` issues
  (``sharding.tally``), by the reference's kind names, the result's bytes
  on this rank, as ``parse_collectives`` sums the result operands of the
  HLO's collectives.
* ``memory``: ``argument_size_in_bytes`` is the exact sum of the rank's
  argument shards (parameters and optimizer state or cache, and the
  batch) that the step reads, as ``jax.jit`` prunes the arguments a step
  does not use (whisper's decode reads neither the encoder's weights nor
  cross-attention's K/V projections: its cache holds their output).
  ``temp_size_in_bytes`` is the peak of the bytes held by the
  storages the step makes, tracked through weak references to each new
  storage (``_Counters``): an eager step's peak, in program order, which
  holds a step's new state beside its arguments (the port's train step is
  not in place) and every temporary until Python frees it, where XLA's
  scheduler reorders and donates. ``output_size_in_bytes`` is the new
  storages still held by the step's results; ``peak_memory_in_bytes``
  the arguments plus the temporaries' peak.
* ``hlo_has_while`` has no eager meaning and stays ``False``: the port's
  stack is a Python loop over its groups, every layer runs and is
  counted, so memfit's own counts are a direct count of the whole stack
  (recorded beside the probes' extrapolation ``B + (n_groups - 1)(C -
  B)`` as ``direct`` and ``extrapolated`` in memfit's record).
  ``lower_s`` is the time to build the step and its fake arguments,
  ``compile_s`` that of the run under the counters. The reference's
  ``DTYPE_BYTES`` and ``parse_collectives`` have no counterpart: the
  port reads each tensor's element size, and counts the collectives
  where it issues them.

The modes are the reference's: ``memfit`` runs the full config (the
attention chunk ``ops.set_attn_chunk(1024)`` for sequences of 4,096 and
more, so long prompts take ``ref.sdpa_blocked``); ``probe1_*`` /
``probe2_*`` one and two layer groups with ``microbatches=1``,
``*_exact`` with exact attention and ``*_chunked`` with the 1,024 chunk.

Run it as a fresh process (it owns its process group): ``python -m
repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k --mode
probe1_exact``; records go to ``experiments/dryrun_torch/`` for
``python -m repro_torch.launch.roofline``. ``REPRO_SERVE_PARAM_DTYPE``
(default ``bfloat16``) sets the serving cells' parameter dtype, as in the
reference.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import (SHAPES, OptimizerConfig, ParallelConfig,
                                ShapeConfig, get_shape)
from repro_torch.configs import all_archs, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import decode_input_specs, input_specs
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import OptState, abstract_opt_state
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.steps import make_train_step

COLLECTIVES = sh.COLLECTIVE_KINDS

MODES = ("memfit", "probe1_exact", "probe2_exact", "probe1_chunked",
         "probe2_chunked")


def default_parallel(shape: ShapeConfig) -> ParallelConfig:
    """Production-default layouts per workload kind, the reference's.

    train:   FSDP over 'data' + TP over 'model', full remat.
    serve:   TP over 'model' + EP over 'data' for experts; no FSDP.
    decode:  the flash-decoding layout: the KV cache's sequence split
             over 'model' (batch over the data axes), or over ('data',
             'model') below a batch of 16 (every rank holds every row).
    """
    if shape.kind == "train":
        return ParallelConfig(remat="full", microbatches=4)
    if shape.kind == "decode":
        seq_axis = "model" if shape.global_batch >= 16 else ("data", "model")
        return ParallelConfig(fsdp_axis=None, shard_cache_seq=True,
                              seq_axis=seq_axis)
    return ParallelConfig(fsdp_axis=None)


def skip_reason(arch: str, shape: ShapeConfig) -> Optional[str]:
    cfg = get_config(arch)
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: 500k-token decode needs "
                "sub-quadratic attention (run only for ssm/hybrid)")
    return None


def reduced_cfg(cfg, groups: int):
    return dataclasses.replace(cfg,
                               num_layers=groups * len(cfg.block_pattern))


# ---------------------------------------------------------------------------
# the fake world and the counters
# ---------------------------------------------------------------------------

def fake_world(size: int):
    """This process as rank 0 of a ``fake`` process group of ``size``
    ranks (a group of another size or backend is torn down first).
    Raises ``RuntimeError`` naming the private module where this torch
    lacks it."""
    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the dry run needs torch's fake process group "
            f"(torch.testing._internal.distributed.fake_pg), which torch "
            f"{torch.__version__} lacks: {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counters(TorchDispatchMode):
    """Within the block, the operand and result bytes of every ATen
    operation but views (``bytes``), the storages of the step's arguments
    the operations read (``read``), and the bytes of the storages the
    operations make, live and at their peak (``live``, ``peak``): each
    new storage is counted from its first appearance until Python frees
    it (a weak reference's finalizer)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._known = set()
        self.read = set()

    def know(self, tensors):
        """Storages that exist before the step (its arguments): never
        counted as the step's."""
        for t in tensors:
            self._known.add(t.untyped_storage()._cdata)

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._sizes:
            return
        self._sizes[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._sizes.pop(key, 0)

    def held(self, tensors) -> int:
        """Bytes of the new storages among ``tensors``."""
        seen, n = set(), 0
        for t in tensors:
            key = t.untyped_storage()._cdata
            if key in self._sizes and key not in seen:
                seen.add(key)
                n += self._sizes[key]
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        operands = _tensors((args, kwargs))
        if not getattr(func, "is_view", False):
            self.bytes += sum(_nbytes(t) for t in operands)
            self.bytes += sum(_nbytes(t) for t in outs)
        # an operation reads its operands where it writes one of them or
        # makes a new storage (a view, an alias such as a ``to`` that
        # converts nothing and a metadata query read nothing)
        held = {t.untyped_storage()._cdata for t in operands}
        if outs and (func._schema.is_mutable or any(
                t.untyped_storage()._cdata not in held for t in outs)):
            self.read.update(held & self._known)
        for t in outs:
            self._track(t)
        return out


# ---------------------------------------------------------------------------
# a cell's step and its fake arguments
# ---------------------------------------------------------------------------

def _batch_shards(batch_specs, parallel, mesh):
    """{name: (the rank's shape, dtype)} of a model batch."""
    abstract = {k: torch.empty(shp, device="meta") for k, (shp, _) in
                batch_specs.items()}
    specs = sh.input_batch_specs(abstract, parallel, mesh)
    return {k: (sh.Sharding(mesh, specs[k], shp).local_shape, dt)
            for k, (shp, dt) in batch_specs.items()}


def _serve_rows(cfg, batch_specs, parallel, mesh, max_len):
    """A serving batch's rows on this rank: the serving mesh's batch
    groups (every row where the cache's sequence takes a batch axis)."""
    smesh = M.serve_mesh_of(cfg, parallel, mesh, max_len)
    out = {}
    for k, (shp, dt) in batch_specs.items():
        axis = 1 if k == "positions" and len(shp) == 3 else 0
        local = list(shp)
        if shp[axis] % smesh.batch_size:
            raise ValueError(f"{k}: a batch of {shp[axis]} does not split "
                             f"over the batch axes' {smesh.batch_size} "
                             f"ranks")
        local[axis] //= smesh.batch_size
        out[k] = (tuple(local), dt)
    return out


def build_lowered(cfg, shape: ShapeConfig, parallel: ParallelConfig, mesh,
                  ocfg: OptimizerConfig):
    """The cell's step on this rank and its arguments' (shape, dtype)
    trees: ``(step, args)``, where ``step(*fake(args))`` runs it (the
    counterpart of the reference's lowering: the plain step, built over
    ``mesh``)."""
    if shape.kind == "train":
        step = make_train_step(cfg, ocfg, parallel, "cpu", mesh=mesh)
        pshard, oshard = step.shardings
        pdt = getattr(torch, cfg.param_dtype)
        params = {n: (s.local_shape, pdt) for n, s in pshard.items()}
        ostate = abstract_opt_state(M.abstract_params(cfg), ocfg)
        opt = OptState(
            ((), torch.int32),
            *[{n: (place[n].local_shape, ostate[i][n].dtype) for n in place}
              for i, place in ((1, oshard.m), (2, oshard.v),
                               (3, oshard.m_scale), (4, oshard.v_scale))])
        batch = _batch_shards(input_specs(cfg, shape), parallel, mesh)
        return step, (params, opt, batch)
    b, s = shape.global_batch, shape.seq_len
    pplace, cplace = M.serve_placement(cfg, parallel, mesh, b, s)
    pdt = getattr(torch, cfg.param_dtype)
    params = {n: (p.local_shape, pdt) for n, p in pplace.items()}
    acache = M.abstract_cache(cfg, b, s)
    cache = {n: (c.local_shape, acache[n].dtype) for n, c in cplace.items()}
    if shape.kind == "prefill":
        batch = _serve_rows(cfg, input_specs(cfg, shape), parallel, mesh, s)
        return (make_prefill_step(cfg, parallel, mesh, s),
                (params, batch, cache))
    batch = _serve_rows(cfg, decode_input_specs(cfg, shape), parallel, mesh,
                        s)
    return make_decode_step(cfg, parallel, mesh, s), (params, cache, batch)


def _fake_args(args):
    """Empty tensors of each (shape, dtype) leaf of ``args`` (inside a
    ``FakeTensorMode``: storage-less)."""
    if isinstance(args, tuple) and len(args) == 2 and \
            isinstance(args[1], torch.dtype):
        return torch.zeros(args[0], dtype=args[1])
    if isinstance(args, OptState):
        return OptState(*[_fake_args(x) for x in args])
    if isinstance(args, dict):
        return {k: _fake_args(v) for k, v in args.items()}
    return tuple(_fake_args(x) for x in args)


def memory_dict(counters: _Counters, args, out) -> Dict[str, float]:
    arg = sum(_nbytes(t) for t in _tensors(args)
              if t.untyped_storage()._cdata in counters.read)
    return {"argument_size_in_bytes": int(arg),
            "output_size_in_bytes": int(counters.held(_tensors(out))),
            "temp_size_in_bytes": int(counters.peak),
            "alias_size_in_bytes": 0,
            "peak_memory_in_bytes": int(arg + counters.peak)}


def run_mode(arch: str, shape: ShapeConfig, mesh_kind: str, mode: str,
             remat: str = "none", parallel_over: Optional[dict] = None
             ) -> Dict:
    cfg = get_config(arch)
    if shape.kind != "train":
        # serving runs bf16 weights (production inference numerics)
        cfg = dataclasses.replace(
            cfg, param_dtype=os.environ.get("REPRO_SERVE_PARAM_DTYPE",
                                            "bfloat16"))
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    parallel = default_parallel(shape)
    if remat != "none":
        parallel = dataclasses.replace(parallel, remat=remat)
    if parallel_over:
        parallel = dataclasses.replace(parallel, **parallel_over)
    ocfg = OptimizerConfig()

    if mode == "memfit":
        run_cfg = cfg
        ops.set_attn_chunk(1024 if shape.seq_len >= 4096 else 0)
    else:
        groups = 1 if mode.startswith("probe1") else 2
        run_cfg = reduced_cfg(cfg, groups)
        ops.set_attn_chunk(1024 if mode.endswith("chunked") else 0)
        # probes must not hide per-step cost inside the microbatches; the
        # roofline layer re-adds per-microbatch weight traffic
        parallel = dataclasses.replace(parallel, microbatches=1)

    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind, "mode": mode,
           "n_groups_full": tf.n_groups(cfg),
           "pattern_len": len(cfg.block_pattern), "status": "ok",
           "microbatches": parallel.microbatches, "remat": parallel.remat,
           "fsdp": parallel.fsdp_axis,
           "param_dtype": cfg.param_dtype}
    t0 = time.time()
    try:
        step, shapes = build_lowered(run_cfg, shape, parallel, mesh, ocfg)
        with FakeTensorMode(allow_non_fake_inputs=True), _scans_once():
            args = _fake_args(shapes)
            t_lower = time.time()
            counters = _Counters()
            # the arguments as passed (a step may replace a cache leaf)
            passed = _tensors(args)
            counters.know(passed)
            with sh.tally() as coll, FlopCounterMode(display=False) as fc, \
                    counters:
                out = step(*args)
            t_comp = time.time()
            rec["cost"] = {"flops": float(fc.get_total_flops()),
                           "bytes": float(counters.bytes)}
            rec["memory"] = memory_dict(counters, passed, out)
            del out
        rec["collectives"] = coll
        rec["hlo_has_while"] = False
        rec["lower_s"] = round(t_lower - t0, 2)
        rec["compile_s"] = round(t_comp - t_lower, 2)
    except Exception as e:   # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        ops.set_attn_chunk(0)
    return rec


def _once(scan, seq_args, rest, state):
    """``scan`` over the first step of each [b, s, ...] ``seq_args``, its
    output repeated along s."""
    s = seq_args[0].shape[1]
    out, last = scan(*[x[:, :1] for x in seq_args], *rest, state)
    return out.expand(out.shape[0], s, *out.shape[2:]).contiguous(), last


@contextlib.contextmanager
def _scans_once():
    """The cell's recurrences counted once: inside, ``ops.ssm_scan`` and
    ``ops.rwkv6_scan`` (which the models call through ``ops``) run their
    plain recurrence's body for the first step alone and repeat its
    output along the sequence, as XLA's cost analysis counts a scan's
    body once. Shapes and dtypes are the scan's; the values are not.
    Both are restored on exit."""
    ssm, wkv = ops.ssm_scan, ops.rwkv6_scan

    def ssm_once(x, dt, A, B, C, D, state=None):
        return _once(lambda x, dt, B, C, A, D, h: ref.ssm_scan(
            x, dt, A, B, C, D, h), (x, dt, B, C), (A, D), state)

    def wkv_once(r, k, v, w, u, state=None):
        return _once(ref.rwkv6_scan, (r, k, v, w), (u,), state)
    ops.ssm_scan, ops.rwkv6_scan = ssm_once, wkv_once
    try:
        yield
    finally:
        ops.ssm_scan, ops.rwkv6_scan = ssm, wkv


def cell_path(out_dir: str, arch: str, shape: str, mesh_kind: str,
              mode: str, tag: str = "") -> str:
    t = f".{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}__{mode}{t}.json")


def _coll_bytes(rec: Dict) -> float:
    return sum(v["bytes"] for v in rec.get("collectives", {}).values())


def add_extrapolation(out_dir: str, arch: str, shape: str, mesh_kind: str,
                      tag: str = "") -> Optional[Dict]:
    """memfit's record with its direct count of the whole stack beside the
    exact probes' extrapolation ``B + (n_groups - 1)(C - B)`` (flops and
    collective bytes), written back; None where a record is missing or
    not ok."""
    recs = {}
    for mode in ("memfit", "probe1_exact", "probe2_exact"):
        path = cell_path(out_dir, arch, shape, mesh_kind, mode, tag)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            recs[mode] = json.load(f)
        if recs[mode].get("status") != "ok":
            return None
    memfit, b, c = (recs["memfit"], recs["probe1_exact"],
                    recs["probe2_exact"])
    n = memfit["n_groups_full"]

    def extra(x, y):
        return x + (n - 1) * (y - x)
    memfit["direct"] = {"flops": memfit["cost"]["flops"],
                        "coll_bytes": _coll_bytes(memfit)}
    memfit["extrapolated"] = {
        "flops": extra(b["cost"]["flops"], c["cost"]["flops"]),
        "coll_bytes": extra(_coll_bytes(b), _coll_bytes(c))}
    with open(cell_path(out_dir, arch, shape, mesh_kind, "memfit", tag),
              "w") as f:
        json.dump(memfit, f, indent=1)
    return memfit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--mode", default=None, choices=MODES)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--tag", default="", help="variant tag for perf iterations")
    ap.add_argument("--parallel-json", default="",
                    help="JSON dict of ParallelConfig overrides")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else all_archs()
    shapes = [get_shape(args.shape)] if args.shape else list(SHAPES)
    modes = [args.mode] if args.mode else list(MODES)
    overrides = json.loads(args.parallel_json) if args.parallel_json else None
    if overrides and isinstance(overrides.get("seq_axis"), list):
        overrides["seq_axis"] = tuple(overrides["seq_axis"])

    for arch in archs:
        for shape in shapes:
            reason = skip_reason(arch, shape)
            if reason:
                rec = {"arch": arch, "shape": shape.name, "mesh": args.mesh,
                       "mode": "memfit", "status": "skipped",
                       "skip_reason": reason}
                with open(cell_path(args.out, arch, shape.name, args.mesh,
                                    "memfit", args.tag), "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"SKIP {arch} {shape.name}: {reason}")
                continue
            for mode in modes:
                path = cell_path(args.out, arch, shape.name, args.mesh, mode,
                                 args.tag)
                if os.path.exists(path) and not args.force:
                    print(f"cached {path}")
                    continue
                rec = run_mode(arch, shape, args.mesh, mode,
                               remat=args.remat, parallel_over=overrides)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                ok = rec["status"]
                extra = (f" flops={rec.get('cost', {}).get('flops', 0):.3e}"
                         f" lower={rec.get('lower_s')}s"
                         f" compile={rec.get('compile_s')}s"
                         if ok == "ok" else f" {rec.get('error', '')[:200]}")
                print(f"{ok:7s} {arch} {shape.name} {args.mesh} {mode}{extra}",
                      flush=True)
            add_extrapolation(args.out, arch, shape.name, args.mesh, args.tag)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
