"""CLI train driver: the end-to-end training pipeline under the wind
tunnel.

Counterpart: ``repro.launch.train``, with its flags, configs and
printout. ``--data`` / ``--model`` are the reference's host mesh
(``launch.mesh.make_host_mesh``) over the ranks of a
``torch.distributed`` run; a mesh of one rank trains on one device.
``--device`` picks the card (``cuda``, the default: the rank's
``LOCAL_RANK`` card, raising without one) or the CPU. Under ``torchrun``
the launcher joins the process group itself: ``nccl`` when each local
rank has its own card, ``gloo`` on the CPU or for ranks that share one.

    python -m repro_torch.launch.train --arch llama3.2-1b --smoke
    python -m repro_torch.launch.train --smoke --device cpu --steps 4
    torchrun --nproc-per-node=2 -m repro_torch.launch.train --smoke \
        --data 2
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.config import OptimizerConfig, ParallelConfig, TrainConfig
from repro_torch.configs import all_archs, get_config, get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import REMAT_POLICIES
from repro_torch.train.loop import TrainResult, train


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3.2-1b", choices=all_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config runnable on CPU")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--remat", default="none", choices=REMAT_POLICIES)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def join_ranks(args: argparse.Namespace):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1) with no process group yet:
    set the rank's card from ``LOCAL_RANK`` and join the group, over
    ``nccl`` when every local rank has a card of its own and over
    ``gloo`` on the CPU or when local ranks share a card (NCCL puts no
    two ranks on one GPU)."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    backend = "gloo"
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % max(cards, 1))
        if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) <= cards:
            backend = "nccl"
    dist.init_process_group(backend)


def mesh_of(args: argparse.Namespace):
    """The ``--data`` x ``--model`` host mesh, or None for one device."""
    if args.data * args.model <= 1:
        return None
    return make_host_mesh(args.data, args.model, device=args.device)


def configs(args: argparse.Namespace):
    """(cfg, tcfg, ocfg, parallel) of the parsed flags."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(steps=args.steps, seq_len=args.seq_len,
                       global_batch=args.batch,
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir)
    ocfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 10, 1))
    parallel = ParallelConfig(batch_axes=("data",), remat=args.remat,
                              microbatches=args.microbatches)
    return cfg, tcfg, ocfg, parallel


def report(res: TrainResult):
    print(f"done: {res.steps_done} steps, loss {res.losses[0]:.4f} -> "
          f"{res.final_loss:.4f}, restarts={res.restarts}")
    print("stage summary:")
    for name, v in res.collector.summary().items():
        print(f"  {name:14s} mean={v['mean_latency_s']*1e3:8.2f} ms/rec "
              f"thr={v['throughput_rps']:8.1f} rec/s")


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    join_ranks(args)
    cfg, tcfg, ocfg, parallel = configs(args)
    res = train(cfg, tcfg, ocfg, parallel, device=args.device,
                mesh=mesh_of(args))
    if not dist.is_initialized() or dist.get_rank() == 0:
        report(res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
