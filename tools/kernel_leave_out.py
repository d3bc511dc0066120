#!/usr/bin/env python3
"""What sets the time of the selective-scan and policy-scan kernels, on
the card: copies of a kernel source with one part of the work left out,
each built and timed at the main path's shape.

    python3 tools/kernel_leave_out.py KERNEL:VARIANT ...

The profilers that count by instruction (ncu, nsys) are not available on
the machines this port is measured on, so a part's cost is read off the
time a copy without it takes. KERNEL is ``ssm`` (``ssm_scan`` at the
Jamba-1.5-Large prefill shape, [4, 2,048, 16,384] x n 16 bf16 from a zero
state), ``agg`` (``policy_agg`` on the 65,536-scenario What-if #5 grid,
8,736 bins), ``fault`` (``policy_agg_fault`` on the 65,536-row chaos
grid, F = 16), ``scan`` (``policy_scan`` on the 4,096-scenario What-if #5
grid) or ``scanf`` (``policy_scan_fault`` on the 4,096-row chaos grid:
256 twins x 4 forecasts x 4 futures, F = 4), the shapes of
``chip_smoke.py``'s kernel table; ``agg-fifo`` ... ``agg-batch_window``
time ``policy_agg`` on 65,536 scenarios of one policy (its What-if #5
twins repeated to 256, x the 256 forecasts), and ``scan-<policy>`` /
``scanf-<policy>`` the series kernels on 4,096 rows of one policy (the
twins repeated to 256, x 16 forecasts, or x 4 forecasts x 4 futures). A
spec given twice is timed twice (to see the spread within a call); specs
whose copies have the same text share one build. Variants that leave
work out give wrong results and are not checked:

* ``base``: the source as it is;
* ``ssm:no-exp``: each exp replaced by the constant 0.5; ``ssm:no-y``: no
  sum into y (y = D x); ``ssm:no-bc``: B and C not staged after the
  first chunk (the shared buffers are read as they are); ``ssm:no-xdt``:
  the x and dt tiles after the first not copied; ``ssm:bc-once``: every
  step reads its chunk's first B and C, which the compiler then keeps in
  registers (no shared-memory reads of B and C a step);
* ``fastdiv`` (any policy kernel): the division of the IEEE build
  replaced by the approximate one (``-prec-div=false``);
* ``agg:no-loads``: the loads of the bins after the first replaced by
  arithmetic;
* ``agg:no-hist`` / ``fault:no-hist``: no histogram at all;
  ``agg:one-triple`` / ``fault:one-triple``: every bin adds into one
  register triple (no device-memory traffic, the bucket still computed);
  ``agg:no-scalars`` / ``fault:no-scalars``: the six compensated sums of
  the scalar statistics replaced by one plain sum of the step's outputs;
* ``scan:no-loads`` / ``scanf:no-loads``: no chunk of inputs staged
  after the first, every chunk reading the first one's (the arrivals
  scaled by arithmetic), so no device-memory reads and no waits on them;
  ``scan:no-stores``: the five outputs of every bin folded into one
  register sum, written once at the end (the work kept, no series
  traffic); ``scan:chain``: the five stores dropped, so that the
  compiler drops all but the carry chain (its latency, the design's
  floor); ``scan:unroll1``: one bin a loop iteration;
  ``scan:block64`` / ``scan:block128``: the series kernels in blocks of
  64 or 128 threads (one warp a block as it is; 16-bin chunks at 128);
* ``unsorted`` (any policy kernel): the source as it is, but the
  wrapper's sort of the scenarios by policy replaced by the identity, so
  the kernel runs them in the grid's own order (warps of mixed policies
  switch on the policy per bin); the results stay right.

Prints one JSON line per variant: CUDA-event ms of the wrapper (checks and
allocation included, as ``chip_smoke.py`` times it; mean of 3 launches,
10 for the series kernels, after a second of warm-up launches), for the
policy kernels also ``kernel_ms``, CUDA events around each launch alone
(mean of as many), ptxas's registers, and the card; after the first
``base`` of the policy kernels, one line of the SASS loop bodies of the
series kernels (instructions and some of their kinds; an unrolled body
holds 4 bins). The copies build into ``kernels/_build/leave_out``.
"""
import argparse
import contextlib
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
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
BASES = ("ssm", "agg", "fault", "scan", "scanf")
SOURCE = {"ssm": "ssm_scan", **{k: "policy_scan" for k in BASES[1:]},
          **{f"{k}-{p}": "policy_scan" for k in ("agg", "scan", "scanf")
             for p in POLICIES}}
#: the cuts each kernel takes: its own, or those of a kernel that shares
#: its code
FAMILY = {"ssm": "ssm", "agg": "agg", "fault": "agg", "scan": "scan",
          "scanf": "scan"}
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
  sc.store_carry(carry_end, i);""",
                        """    hcol[0] = hs + hc + hcc + (float)held;
  }
  sc.store_carry(carry_end, i);""")],
    },
    # one warp a block, inputs staged a chunk ahead, four bins unrolled
    "scan": {
        "no-loads": [
            ("    if (t0 + kChunk < t_bins) stage(t0 + kChunk, buf ^ 1);\n",
             ""),
            ("capmul = st.v[1][buf][j][lane];",
             "capmul = st.v[1][0][j][lane];"),
            ("change |= st.v[1][buf][j][lane] != sc.rc_cap;",
             "change |= st.v[1][0][j][lane] != sc.rc_cap;"),
            ("(st.v[0][buf][j][lane],",
             "(st.v[0][0][j][lane] * (1.0f + 0.001f * (float)(t0 & 15)),")],
        "no-stores": [
            ("  const size_t plane = (size_t)t_bins * n;\n",
             "  float acc = 0.0f;\n"),
            ("""        out[0] = o.processed;
        out[plane] = o.queue;
        out[2 * plane] = o.latency;
        out[3 * plane] = o.cost;
        out[4 * plane] = o.dropped;
        out += n;
""", "        acc += o.processed + o.queue + o.latency + o.cost"
    " + o.dropped;\n"),
            ("  sc.store_carry(carry_end, dest);",
             "  series[dest] = acc;\n  sc.store_carry(carry_end, dest);")],
        "chain": [("""        out[0] = o.processed;
        out[plane] = o.queue;
        out[2 * plane] = o.latency;
        out[3 * plane] = o.cost;
        out[4 * plane] = o.dropped;
""", "")],
        "unroll1": [("#pragma unroll kScanUnroll", "#pragma unroll 1")],
        "block64": [("constexpr int kScanThreads = 32;",
                     "constexpr int kScanThreads = 64;")],
        # 16-bin chunks: 32 of 128 threads' would pass 48 KB of static
        # shared memory under faults
        "block128": [("constexpr int kScanThreads = 32;\n"
                      "constexpr int kChunk = 32;",
                      "constexpr int kScanThreads = 128;\n"
                      "constexpr int kChunk = 16;")],
    },
}
#: one instruction of ``cuobjdump -sass``: its address and its text
SASS_LINE = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
#: variants built from the source as it is
AS_IS = ("base", "fastdiv", "unsorted")


def variant_source(kernel, variant, text):
    """(source text, extra nvcc flags) of ``kernel:variant``."""
    family = FAMILY[kernel.split("-")[0]]
    if variant in AS_IS and (variant == "base" or family != "ssm"):
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
    """Build every distinct copy, one nvcc each, all at once; returns
    {spec: (library path, ptxas register lines)}."""
    out_dir = build.BUILD_DIR / "leave_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, of_spec = {}, {}
    for spec in dict.fromkeys(specs):
        kernel, variant = spec.split(":")
        name = SOURCE[kernel]
        text, flags = variant_source(
            kernel, variant, (build.CSRC / f"{name}.cu").read_text())
        key = hashlib.sha256((name + text + " ".join(flags)).encode()
                             ).hexdigest()[:16]
        of_spec[spec] = key
        if key in procs:
            continue
        cu, so = out_dir / f"{name}-{key}.cu", out_dir / f"{name}-{key}.so"
        cu.write_text(text)
        cmd = build.nvcc_command(name, cu, so)
        if "-prec-div=false" in flags:
            cmd.remove("-prec-div=true")
        cmd[1:1] = flags
        procs[key] = (spec, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    done = {}
    for key, (spec, so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{spec}: nvcc failed\n{log}")
        done[key] = (so, [line.split("ptxas info    : ")[-1] for line in
                          log.splitlines() if "registers" in line])
    return {spec: done[key] for spec, key in of_spec.items()}


def operands(kernel, dev):
    """The operands of one kernel's main-path shape, on the card."""
    from repro_torch import faults
    from repro_torch.core import traffic as tr
    from repro_torch.core import twin as twin_mod
    twins = chip_smoke.whatif5_twins(twin_mod)

    def growths(k):
        return [tr.TrafficModel.honda_default(f"g{x:.4f}", R=3.5, G=float(x))
                for x in np.linspace(1.0, 1.75, k)]
    if kernel == "ssm":
        g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 3)
        return chip_smoke.ssm_inputs(4, 2048, 16384, 16, torch.bfloat16, dev,
                                     g, state=False)
    base, _, policy = kernel.partition("-")
    if policy:      # one policy's twins, repeated to 256
        own = [tw for tw in twins if tw.policy == policy]
        twins = (own * (256 // len(own)))[:256]
    if base == "agg":
        return chip_smoke.grid_operands(twins, growths(256), dev)
    if base == "scan":
        return chip_smoke.grid_operands(twins, growths(16), dev)
    n_futures = 16 if base == "fault" else 4
    return chip_smoke.chaos_operands(
        twins, growths(16 if base == "fault" else 4),
        chip_smoke.chaos_schedule(faults, n_futures), dev)


def runner(kernel, ops):
    from repro_torch.kernels import policy_scan as pk, ssm_scan as sk
    if kernel == "ssm":
        return lambda: sk.ssm(*ops), 5
    base = kernel.split("-")[0]
    kw = dict(loads_t=ops["loads_t"], load_index=ops["load_index"])
    if "caps_t" in ops:
        kw.update(caps_t=ops["caps_t"], fault_index=ops["fault_index"])
    args = (None, ops["params"], ops["onehot"], 1.0)
    if base in ("scan", "scanf"):
        return (lambda: pk.policy_grid_scan(*args, **kw)), 10
    kw.update(slo_limit=4 * 3600.0, slo_mode=0)
    if "caps_t" in ops:
        kw["fmask_t"] = ops["fmask_t"]
    return (lambda: pk.policy_grid_agg(*args, **kw)), 3


class TimedLaunches:
    """A policy-scan library whose ``*_launch`` entry points record CUDA
    events around each launch: the kernels' own device time, without the
    wrapper's checks, sort and allocations."""

    def __init__(self, lib):
        self.lib, self.events = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.endswith("_launch"):
            return fn

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self.events.append((start, end))
            return rc
        return timed

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / len(
            self.events)


def caller_order(branch, stable=True):
    """The identity permutation, in place of the wrapper's sort."""
    return torch.arange(branch.numel(), device=branch.device)


def sass_loops(so):
    """{kernel: [(instructions, {op: count})]} of the loops of the series
    kernels in library ``so``: each backward branch over more than 40
    instructions, its body counted from ``cuobjdump -sass``."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for name, lines in chip_smoke.sass_functions(sass).items():
        if "policy_scan_kernel" not in name:
            continue
        ins = [m.groups() for m in map(SASS_LINE.match, lines) if m]
        at = {int(a, 16): k for k, (a, _) in enumerate(ins)}
        loops = []
        for k, (a, text) in enumerate(ins):
            hit = re.search(r"\bBRA (0x[0-9a-f]+)", text)
            start = at.get(int(hit.group(1), 16)) if hit else None
            if start is not None and k - start > 40:
                body = [t.split()[1 if t.startswith("@") else 0]
                        .split(".")[0] for _, t in ins[start:k + 1]]
                loops.append((len(body), {op: body.count(op) for op in
                                          ("STG", "LDS", "F2F", "DMUL",
                                           "DFMA", "MUFU", "BRA")}))
        out["fault" if "ILb1E" in name else "benign"] = loops
    return out


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
    ops, looped = {}, set()
    for spec in args.specs:
        kernel, variant = spec.split(":")
        if kernel not in ops:
            ops[kernel] = operands(kernel, dev)
        so, ptxas = built[spec]
        name = SOURCE[kernel]
        # the wrapper binds it
        build._LOADED[(name, None)] = ctypes.CDLL(str(so))
        fn, reps = runner(kernel, ops[kernel])
        # `unsorted`: the wrapper's argsort by policy returns the identity
        order = (mock.patch.object(torch, "argsort", caller_order)
                 if variant == "unsorted" else contextlib.nullcontext())
        with order:
            # warm-up: a second of launches, so that the card's clocks
            # have risen before the first spec is timed
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 1.0:
                fn()
            ms, _ = chip_smoke.cuda_ms(fn, reps=reps)
            kernel_ms = None
            if name == "policy_scan":
                from repro_torch.kernels import policy_scan as pk
                timed = TimedLaunches(pk._lib())
                with mock.patch.object(pk, "_lib",
                                       lambda generated=None: timed):
                    for _ in range(reps):
                        fn()
                kernel_ms = timed.ms()
        print(json.dumps({"kernel": kernel, "variant": variant, "ms": ms,
                          "kernel_ms": kernel_ms, "ptxas": ptxas,
                          "card": torch.cuda.get_device_name(0)}),
              flush=True)
        if name == "policy_scan" and variant == "base" and so not in looped:
            looped.add(so)
            print(json.dumps({"spec": spec, "loops": sass_loops(so)}),
                  flush=True)
    build._LOADED.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
