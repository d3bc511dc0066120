#!/usr/bin/env python3
"""What sets the time of the selective-scan and aggregate policy-scan
kernels, on the card: copies of a kernel source with one part of the work
left out, each built and timed at the main path's shape.

    python3 tools/kernel_leave_out.py KERNEL:VARIANT ...

The profilers that count by instruction (ncu, nsys) are not available on
the machines this port is measured on, so a part's cost is read off the
time a copy without it takes. KERNEL is ``ssm`` (``ssm_scan`` at the
Jamba-1.5-Large prefill shape, [4, 2,048, 16,384] x n 16 bf16 from a zero
state), ``agg`` (``policy_agg`` on the 65,536-scenario What-if #5 grid,
8,736 bins) or ``fault`` (``policy_agg_fault`` on the 65,536-row chaos
grid, F = 16); ``agg-fifo`` ... ``agg-batch_window`` time ``policy_agg``
on 65,536 scenarios of one policy (its What-if #5 twins repeated to 256,
x the 256 forecasts). A spec given twice is built once and timed twice
(to see the spread within a call). Variants that leave work out give
wrong results and are not checked:

* ``base``: the source as it is;
* ``ssm:no-exp``: each exp replaced by the constant 0.5; ``ssm:no-y``: no
  sum into y (y = D x); ``ssm:no-bc``: B and C not staged after the
  first chunk (the shared buffers are read as they are); ``ssm:no-xdt``:
  the x and dt tiles after the first not copied; ``ssm:bc-once``: every
  step reads its chunk's first B and C, which the compiler then keeps in
  registers (no shared-memory reads of B and C a step);
* ``agg:fastdiv``: the division of the IEEE build replaced by the
  approximate one (``-prec-div=false``); ``agg:no-loads``: the loads of
  the bins after the first replaced by arithmetic;
* ``agg:no-hist`` / ``fault:no-hist``: no histogram at all;
  ``agg:one-triple`` / ``fault:one-triple``: every bin adds into one
  register triple (no device-memory traffic, the bucket still computed);
  ``agg:no-scalars`` / ``fault:no-scalars``: the six compensated sums of
  the scalar statistics replaced by one plain sum of the step's outputs;
* ``agg:unsorted`` / ``fault:unsorted``: the source as it is, but the
  wrapper's sort of the scenarios by policy replaced by the identity, so
  the kernel runs them in the grid's own order (warps of mixed policies
  switch on the policy per bin); the results stay right.

Prints one JSON line per variant: CUDA-event ms of the wrapper (checks and
allocation included, as ``chip_smoke.py`` times it; mean of several
launches after a warm-up), ptxas's registers, and the card. The copies
build into ``kernels/_build/leave_out``.
"""
import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

POLICIES = ("fifo", "quickscale", "autoscale", "shed", "batch_window")
SOURCE = {"ssm": "ssm_scan", "agg": "policy_scan", "fault": "policy_scan",
          **{f"agg-{p}": "policy_scan" for p in POLICIES}}
#: kernel -> variant -> [(text in the source, its replacement)]
CUTS = {
    # one thread a channel, exp2 on the MUFU, x and dt staged by cp.async
    "ssm": {
        "no-exp": [("h[j] = fmaf(ex2_mufu(dv * a2[j]), h[j], dx * bt[j]);",
                    "h[j] = fmaf(0.5f, h[j], dx * bt[j]);")],
        "no-y": [("part[j % kSums] = fmaf(h[j], ct[j], part[j % kSums]);",
                  "")],
        "no-bc": [("      fetch(t0 + kChunk);", ""),
                  ("    if (more) stage(buf ^ 1);", "")],
        "no-xdt": [("      load_xdt(t0 + kChunk, buf ^ 1);", "")],
        "bc-once": [("const float* bt = bs[buf][tt];",
                     "const float* bt = bs[buf][0];"),
                    ("const float* ct = cs[buf][tt];",
                     "const float* ct = cs[buf][0];")],
    },
    # the bucket-run cache: the last bucket's triple held in registers
    "agg": {
        "no-hist": [("      hold_bucket(cur.latency);\n", ""),
                    ("      neumaier2(hs, hc, hcc, a_cur);\n", ""),
                    ("    hold_bucket(o.latency);\n", ""),
                    ("""    neumaier2(hs, hc, hcc, arrive);
    hp[0] = hs;
    hp[1] = hc;
    hp[2] = hcc;
""", "")],
        "no-loads": [("      next_arrive = *a_ahead;",
                      "      next_arrive = next_arrive * 0.999f + 1.0f;")],
        "no-scalars": [("""    neumaier2(s[0], s[1], s[2], o.processed);
    neumaier2(s[3], s[4], s[5], o.cost);
    neumaier2(s[6], s[7], s[8], o.dropped);
    neumaier2(s[9], s[10], s[11], __fmul_rn(o.latency, arrive));
    neumaier2(s[12], s[13], s[14], arrive);
    neumaier2(s[15], s[16], s[17], __fmul_rn(arrive, ok));
""", "    s[0] += o.processed + o.cost + o.dropped + o.latency;\n")],
        "one-triple": [("    const bool change = bucket != held;",
                        "    const bool change = false;"),
                       ("    held = bucket;\n  };",
                        "    held += bucket;\n  };"),
                       ("""    hp[0] = hs;
    hp[1] = hc;
    hp[2] = hcc;
  }
  if constexpr (kFault) c0 = c0 + fq;""",
                        """    hcol[0] = hs + hc + hcc + (float)held;
  }
  if constexpr (kFault) c0 = c0 + fq;""")],
    },
}
#: variants built from the source as it is
AS_IS = ("base", "fastdiv", "unsorted")


def variant_source(kernel, variant, text):
    """(source text, extra nvcc flags) of ``kernel:variant``."""
    family = "ssm" if kernel == "ssm" else "agg"
    if variant in AS_IS and (variant == "base" or family == "agg"):
        return text, ["-prec-div=false"] if variant == "fastdiv" else []
    cuts = CUTS[family].get(variant)
    if cuts is None:
        raise SystemExit(f"{kernel}:{variant}: no such variant")
    for old, new in cuts:
        if old not in text:
            raise SystemExit(f"{kernel}:{variant}: the source no longer has "
                             f"{old!r}")
        text = text.replace(old, new)
    return text, []


def build_all(specs):
    """Build every variant, one nvcc each, all at once; returns
    {spec: (library path, ptxas register lines)}."""
    out_dir = build.BUILD_DIR / "leave_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for spec in dict.fromkeys(specs):
        kernel, variant = spec.split(":")
        name = SOURCE[kernel]
        text, flags = variant_source(
            kernel, variant, (build.CSRC / f"{name}.cu").read_text())
        stem = spec.replace(":", "-")
        cu, so = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
        cu.write_text(text)
        cmd = build.nvcc_command(name, cu, so)
        if "-prec-div=false" in flags:
            cmd.remove("-prec-div=true")
        cmd[1:1] = flags
        procs[spec] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for spec, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{spec}: nvcc failed\n{log}")
        built[spec] = (so, [line.split("ptxas info    : ")[-1] for line in
                            log.splitlines() if "registers" in line])
    return built


def operands(dev):
    """The three main-path shapes' operands (made once, on the card)."""
    from repro_torch import faults
    from repro_torch.core import traffic as tr
    from repro_torch.core import twin as twin_mod
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 3)
    twins = chip_smoke.whatif5_twins(twin_mod)

    def growths(k):
        return [tr.TrafficModel.honda_default(f"g{x:.4f}", R=3.5, G=float(x))
                for x in np.linspace(1.0, 1.75, k)]
    ops = {
        "ssm": chip_smoke.ssm_inputs(4, 2048, 16384, 16, torch.bfloat16, dev,
                                     g, state=False),
        "agg": chip_smoke.grid_operands(twins, growths(256), dev),
        "fault": chip_smoke.chaos_operands(
            twins, growths(16), chip_smoke.chaos_schedule(faults, 16), dev),
    }
    # one policy's twins, repeated to 256, x the 256 forecasts
    for p in POLICIES:
        own = [tw for tw in twins if tw.policy == p]
        ops[f"agg-{p}"] = chip_smoke.grid_operands(
            (own * (256 // len(own)))[:256], growths(256), dev)
    return ops


def runner(kernel, ops):
    from repro_torch.kernels import policy_scan as pk, ssm_scan as sk
    if kernel == "ssm":
        return lambda: sk.ssm(*ops), 5
    kernel = kernel.split("-")[0]
    kw = dict(loads_t=ops["loads_t"], load_index=ops["load_index"],
              slo_limit=4 * 3600.0, slo_mode=0)
    if kernel == "fault":
        kw.update(caps_t=ops["caps_t"], fmask_t=ops["fmask_t"],
                  fault_index=ops["fault_index"])
    return (lambda: pk.policy_grid_agg(None, ops["params"], ops["onehot"],
                                       1.0, **kw)), 3


def caller_order(branch, stable=True):
    """The identity permutation, in place of the wrapper's sort."""
    return torch.arange(branch.numel(), device=branch.device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("specs", nargs="+", metavar="KERNEL:VARIANT")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_leave_out: no CUDA device is visible", file=sys.stderr)
        return 1
    for spec in args.specs:
        if spec.split(":")[0] not in SOURCE or spec.count(":") != 1:
            raise SystemExit(f"{spec}: want KERNEL:VARIANT, KERNEL one of "
                             f"{sorted(SOURCE)}")
    built = build_all(args.specs)
    dev = torch.device("cuda", 0)
    ops = operands(dev)
    for spec in args.specs:
        kernel, variant = spec.split(":")
        so, ptxas = built[spec]
        name = SOURCE[kernel]
        build._LOADED[name] = ctypes.CDLL(str(so))   # the wrapper binds it
        fn, reps = runner(kernel, ops[kernel])
        # `unsorted`: the wrapper's argsort by policy returns the identity
        order = (mock.patch.object(torch, "argsort", caller_order)
                 if variant == "unsorted" else contextlib.nullcontext())
        with order:
            fn()                                      # warm-up
            ms, _ = chip_smoke.cuda_ms(fn, reps=reps)
        print(json.dumps({"kernel": kernel, "variant": variant, "ms": ms,
                          "ptxas": ptxas,
                          "card": torch.cuda.get_device_name(0)}),
              flush=True)
    build._LOADED.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
