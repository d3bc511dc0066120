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


def main(argv):
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("serve_mesh_drift: no CUDA device is visible", file=sys.stderr)
        return 1
    depths = [int(a) for a in argv] or [2, 4, 8]
    from repro_torch.kernels import build
    build.build()
    root = tempfile.mkdtemp(prefix="plantd_drift_")
    try:
        mp.start_processes(rank_main, args=(os.path.join(root, "init"),
                                            root, depths),
                           nprocs=cs.MESH_RANKS, start_method="spawn",
                           join=True)
        with open(os.path.join(root, "rows.json")) as f:
            rows = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r in rows:
        print(f"rwkv6-7b, {r['layers']} layers over model=2: mesh vs one "
              f"rank bf16 {r['mesh_vs_one_bfloat16']:.3g} "
              f"({r['same_tokens_bfloat16']:.1%} of tokens equal), float32 "
              f"{r['mesh_vs_one_float32']:.3g}; one rank's bf16 vs its "
              f"float32 {r['one_bf16_vs_f32']:.3g}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"serve_mesh_drift": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
