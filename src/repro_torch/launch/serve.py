"""CLI serve driver: batched serving of a smoke model under a request
rate, measured by the wind tunnel's spans (TTFT / latency / throughput
per stage).

Counterpart: ``repro.launch.serve``, with its flags, its model
(``get_smoke_config(arch)``, random parameters from seed 0, ``max_len``
128, prompts of 8 seeded tokens) and its printout. The reference builds a
one-device host mesh (``launch/mesh.py``); the port takes ``--device``
instead, ``cuda`` by default, which raises without a card.

    python -m repro_torch.launch.serve --arch llama3.2-1b
    python -m repro_torch.launch.serve --device cpu --requests 4
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import all_archs, get_smoke_config
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeEngine


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b", choices=all_archs())
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=4.0, help="requests/s")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch)
    params = M.init_params(cfg, seed=0, device=args.device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=128,
                      device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=list(rng.integers(0, cfg.vocab_size, 8)),
                    max_new=args.max_new, submitted=i / args.rate)
            for i in range(args.requests)]
    done = eng.serve(reqs)
    ttfts = [r.ttft_s for r in done]
    lats = [r.latency_s for r in done]
    print(f"served {len(done)} requests")
    print(f"TTFT   p50={np.median(ttfts)*1e3:8.1f} ms  "
          f"p95={np.percentile(ttfts, 95)*1e3:8.1f} ms")
    print(f"E2E    p50={np.median(lats)*1e3:8.1f} ms  "
          f"p95={np.percentile(lats, 95)*1e3:8.1f} ms")
    for name, v in eng.collector.summary().items():
        print(f"  {name:12s} mean={v['mean_latency_s']*1e3:8.2f} ms "
              f"thr={v['throughput_rps']:8.1f}/s busy={v['busy_s']:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
