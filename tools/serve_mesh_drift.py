#!/usr/bin/env python3
"""How far rwkv6-7b's first-token logits served over a (data, model) =
(1, 2) mesh move from one rank's, by depth and type, on the card.

    python3 tools/serve_mesh_drift.py [LAYERS ...]      (default 2 4 8)

Two gloo ranks share the one card, as in ``chip_smoke.py``'s phase 14.
At each depth the model is served as 14c serves it (4 of 9c's seeded
prompts, max_len 1,024, 8 new tokens), in bf16 and in float32, once by a
one-rank engine and once over the mesh. Each row gives, as
max |a - w| / (1 + |w|) over the first-token logits: the mesh against
one rank in bf16 and in float32, and one rank's bf16 against its own
float32 (the drift a drop in precision alone gives at that depth), with
the share of greedy tokens the mesh and one rank agree on in bf16. The
last line is one JSON object of the rows.

    python3 tools/serve_mesh_drift.py --parts [LAYERS ...]   (default 2 4)

reads where in the block the drift grows (ROADMAP C21): a prefill of 4
seeded rows of 512 tokens through rwkv6-7b at each depth, once in float64
on one rank (the port's forward with every float32 cast widened to
float64 and the WKV recurrence in float64) and, in bf16 and in float32,
once on one rank and once over the mesh. At each layer it records the
block's parts, each as max |a - w| / (1 + |w|) against the float64
forward: the time mix's decay (``decay_log``, a rank's channels), the
WKV output (a rank's heads), its output after ``ln_x`` and the gate (a
rank's channels), the time mix's output, the channel mix's gate (``r``,
gathered), its squared-relu key (a rank's channels), its output, and the
layer's output. A rank's part is held against the same channels of the
float64 forward. Where the mesh reads as one rank does at a part, the
shard there adds nothing of its own.
"""
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

MAX_LEN, NEW = 1024, 8


def rank_main(rank, init_file, root, depths):
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=cs.MESH_RANKS)
    try:
        rows = []
        for layers in depths:
            row, one = {"layers": layers}, {}
            for dtype in ("bfloat16", "float32"):
                cfg = cs.serve_mesh_config(cs.RWKV, layers, dtype)
                out, one[dtype] = cs.serve_mesh_at_width(
                    rank, dev, f"{layers} layers {dtype}", cfg, (1, 2),
                    MAX_LEN, NEW, cs.serve_mesh_launches(cfg, NEW),
                    math.inf)
                if rank == 0:
                    row[f"mesh_vs_one_{dtype}"] = out["first_logits_err"]
                    row[f"same_tokens_{dtype}"] = out["same_tokens"]
            if rank == 0:
                row["one_bf16_vs_f32"] = cs.first_logits_rel(
                    one["bfloat16"], one["float32"])
            rows.append(row)
        if rank == 0:
            with open(os.path.join(root, "rows.json"), "w") as f:
                json.dump(rows, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


PART_ROWS, PART_SEQ = 4, 512
#: the parts recorded at each layer, and the dim along which a rank of
#: the mesh holds its share of the part (None: the whole, replicated)
PARTS = (("decay", -1), ("wkv", 2), ("ln_x+gate", -1), ("time_mix", None),
         ("cmix_r", None), ("cmix_k", -1), ("cmix", None),
         ("layer", None))


class PartRecorder:
    """Within the block, every RWKV layer's parts (``PARTS``) as float64
    host arrays, from wrappers of the names ``models/rwkv6.py`` calls
    (the time and channel mix, ``tp_slice``, ``ops.rwkv6_scan``,
    ``row_parallel``, ``tp_gather``); with ``wkv`` a replacement of the
    WKV recurrence (the float64 one)."""

    def __init__(self, wkv=None):
        self.layers, self.wkv = [], wkv

    def __enter__(self):
        from types import SimpleNamespace
        from repro_torch.models import rwkv6 as rw
        self.rw, self.saved = rw, {n: getattr(rw, n) for n in (
            "apply_time_mix", "apply_channel_mix", "tp_slice",
            "row_parallel", "tp_gather", "ops")}
        saved, rec = self.saved, self

        def keep(name, x):
            rec.layers[-1][name] = x.detach().double().cpu()
            return x

        def time_mix(params, name, x, cfg, state=None):
            rec.layers.append({})
            rec.where = "time"
            y, state = saved["apply_time_mix"](params, name, x, cfg, state)
            rec.x_mid = x + y
            return keep("time_mix", y), state

        def channel_mix(params, name, x, cfg, state=None):
            rec.where = "cmix"
            y, state = saved["apply_channel_mix"](params, name, x, cfg,
                                                  state)
            keep("layer", rec.x_mid + y)
            return keep("cmix", y), state

        def tp_slice(x, width, dim=-1):
            out = saved["tp_slice"](x, width, dim)
            # the decay is the layer's first 3-d slice (wo's input after)
            first = x.dim() == 3 and "decay" not in rec.layers[-1]
            return keep("decay", out) if first else out

        def row_parallel(x, w, split):
            keep("ln_x+gate" if rec.where == "time" else "cmix_k", x)
            return saved["row_parallel"](x, w, split)

        def tp_gather(x, split, dim=-1):
            return keep("cmix_r", saved["tp_gather"](x, split, dim))

        def scan(r, k, v, w, u, state=None):
            fn = rec.wkv or saved["ops"].rwkv6_scan
            out, s = fn(r, k, v, w, u, state)
            keep("wkv", out)
            return out, s
        rw.apply_time_mix, rw.apply_channel_mix = time_mix, channel_mix
        rw.tp_slice, rw.row_parallel, rw.tp_gather = (tp_slice, row_parallel,
                                                      tp_gather)
        rw.ops = SimpleNamespace(rwkv6_scan=scan)
        return self

    def __exit__(self, *exc):
        for n, v in self.saved.items():
            setattr(self.rw, n, v)
        return False


def wkv_float64(r, k, v, w, u, state=None):
    """``kernels/ref.py``'s WKV recurrence in float64."""
    b, s, h, n = r.shape
    S = torch.zeros((b, h, n, n), dtype=torch.float64, device=r.device)
    u = u.double()[None, :, :, None]
    out = torch.empty((b, s, h, n), dtype=torch.float64, device=r.device)
    for t in range(s):
        rt, kt, vt, wt = (x[:, t].double() for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        out[:, t] = torch.einsum("bhi,bhij->bhj", rt, S + u * kv)
        S = wt[..., :, None] * S + kv
    return out, S


class Float64:
    """Within the block ``Tensor.float()`` widens to float64, so the
    model's float32 casts (norms, the decay, ``ln_x``) run in float64."""

    def __enter__(self):
        self.saved = torch.Tensor.float
        torch.Tensor.float = lambda t, *a, **k: t.to(torch.float64)
        return self

    def __exit__(self, *exc):
        torch.Tensor.float = self.saved
        return False


def part_err(got, want, dim, rank, size):
    """max |got - want| / (1 + |want|) over ``got``'s elements; a rank's
    share (``dim`` not None) against its part of the whole."""
    if dim is not None and got.shape[dim] != want.shape[dim]:
        part = got.shape[dim]
        assert part * size == want.shape[dim], (got.shape, want.shape)
        want = want.narrow(dim, rank * part, part)
    return float(((got - want).abs() / (1 + want.abs())).max())


def parts_main(rank, init_file, root, depths):
    """Each depth's layer parts: float64, bf16 and float32 on one rank
    (rank 0), bf16 and float32 over the mesh (both ranks)."""
    import dataclasses
    import numpy as np
    import torch.distributed as dist
    from repro_torch.config import ParallelConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=cs.MESH_RANKS)
    try:
        par = ParallelConfig()
        mesh = make_host_mesh(1, cs.MESH_RANKS)
        smesh = sh.ServeMesh.of(mesh, par)
        rows = []
        for layers in depths:
            cfg = cs.serve_mesh_config(cs.RWKV, layers, "float32")
            whole = M.init_params(cfg, seed=cs.SEED, device=dev)
            rng = np.random.default_rng(cs.SEED)
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (PART_ROWS, PART_SEQ)).astype(
                    np.int32)).to(dev)}
            got = {}

            def run(dtype, meshed, wkv=None):
                c = dataclasses.replace(cfg, dtype=dtype)
                params = M.compute_params(whole, c, dev) if dtype != \
                    "float64" else {k: v.double() for k, v in whole.items()}
                if meshed:
                    pplace, _ = M.serve_placement(c, par, mesh, PART_ROWS,
                                                  2 * PART_SEQ)
                    params = M.place_params(params, pplace)
                with torch.inference_mode(), sh.serving(
                        smesh if meshed else None), PartRecorder(wkv) as rec:
                    M.forward(params, c, batch)
                del params
                torch.cuda.empty_cache()
                return rec.layers
            if rank == 0:
                with Float64():
                    got["f64"] = run("float64", False, wkv_float64)
                for dtype in ("bfloat16", "float32"):
                    got[f"one {dtype}"] = run(dtype, False)
            sh.barrier()
            for dtype in ("bfloat16", "float32"):
                got[f"mesh {dtype}"] = run(dtype, True)
            if rank == 0:
                for i, want in enumerate(got["f64"]):
                    for part, dim in PARTS:
                        row = {"layers": layers, "layer": i, "part": part}
                        for key in ("one bfloat16", "mesh bfloat16",
                                    "one float32", "mesh float32"):
                            row[key] = part_err(got[key][i][part],
                                                want[part], dim, 0,
                                                cs.MESH_RANKS)
                        rows.append(row)
            del whole, got
            torch.cuda.empty_cache()
        if rank == 0:
            with open(os.path.join(root, "rows.json"), "w") as f:
                json.dump(rows, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def print_parts(rows):
    print("rwkv6-7b over model=2, each part against a float64 forward: "
          "max |a - w| / (1 + |w|)")
    print(f"{'layers':>6} {'layer':>5} {'part':>10} {'one bf16':>10} "
          f"{'mesh bf16':>10} {'one f32':>10} {'mesh f32':>10}")
    for r in rows:
        print(f"{r['layers']:>6} {r['layer']:>5} {r['part']:>10} "
              f"{r['one bfloat16']:>10.3g} {r['mesh bfloat16']:>10.3g} "
              f"{r['one float32']:>10.3g} {r['mesh float32']:>10.3g}")


def main(argv):
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("serve_mesh_drift: no CUDA device is visible", file=sys.stderr)
        return 1
    parts = argv[:1] == ["--parts"]
    if parts:
        argv = argv[1:]
    depths = [int(a) for a in argv] or ([2, 4] if parts else [2, 4, 8])
    from repro_torch.kernels import build
    build.build()
    root = tempfile.mkdtemp(prefix="plantd_drift_")
    try:
        mp.start_processes(parts_main if parts else rank_main,
                           args=(os.path.join(root, "init"), root, depths),
                           nprocs=cs.MESH_RANKS, start_method="spawn",
                           join=True)
        with open(os.path.join(root, "rows.json")) as f:
            rows = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if parts:
        print_parts(rows)
    for r in rows if not parts else ():
        print(f"rwkv6-7b, {r['layers']} layers over model=2: mesh vs one "
              f"rank bf16 {r['mesh_vs_one_bfloat16']:.3g} "
              f"({r['same_tokens_bfloat16']:.1%} of tokens equal), float32 "
              f"{r['mesh_vs_one_float32']:.3g}; one rank's bf16 vs its "
              f"float32 {r['one_bf16_vs_f32']:.3g}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"serve_mesh_drift_parts" if parts
                      else "serve_mesh_drift": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
