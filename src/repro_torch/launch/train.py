"""CLI train driver: the end-to-end training pipeline under the wind
tunnel.

Counterpart: ``repro.launch.train``, with its flags, configs and
printout. The reference builds a host mesh from ``--data`` / ``--model``;
the port runs on one device and takes ``--device`` instead, ``cuda`` by
default, which raises without a card.

    python -m repro_torch.launch.train --arch llama3.2-1b --smoke
    python -m repro_torch.launch.train --smoke --device cpu --steps 4
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.config import OptimizerConfig, ParallelConfig, TrainConfig
from repro_torch.configs import all_archs, get_config, get_smoke_config
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
    ap.add_argument("--remat", default="none", choices=REMAT_POLICIES)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


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
    cfg, tcfg, ocfg, parallel = configs(args)
    report(train(cfg, tcfg, ocfg, parallel, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
