#!/usr/bin/env python3
"""Builds of ``csrc/flash_attention.cu`` side by side on the card: ptxas's
resources of the float32 kernels, ``chip_smoke.py``'s checks against the
plain version, and the float32 kernel's times at 14g's and 14f's shapes.

    python3 tools/flash_f32_probe.py [--variant NAME=SOURCE[:DEFINE,...]] ...

Each variant is a copy of the flash source (the source as it is, another
revision's, or an edited one, unpacked into a directory that
``.gitignore`` lists; its directory is searched for headers before
``csrc``), built with the model kernels' flags (``kernels/build.py``)
plus ``-D`` of each DEFINE into ``kernels/_build/probe/``, one nvcc per
variant, all started together. With no ``--variant``: the source as it
is, named ``this``.

For each variant it prints ptxas's registers, spills and shared memory of
its float32 kernels and the builds' seconds, then runs phases 5a and 10a
of ``chip_smoke.py`` (``check_flash_random_blocks``,
``check_flash_dims_random_blocks``: both types against the plain version
on random blocks, every storage dim, within ``MODEL_TOL``) through its
library. Then it times every variant with ``chip_smoke.flash_vs_plain``
at 14g's and 14f's shapes (float32) in turns (a b ... b a), and prints
one JSON line per variant and shape: the least of its times, its max abs
error, SDPA's and the plain version's least times, the bound, and the
card. Needs a CUDA card and nvcc.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import build                    # noqa: E402
from repro_torch.kernels import flash_attention as fk    # noqa: E402

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"


def parse_variant(spec):
    name, rest = spec.split("=", 1)
    source, _, defines = rest.partition(":")
    return name, ROOT / source, [d for d in defines.split(",") if d]


def ptxas_lines(text):
    """ptxas's registers, spills and shared memory of the float32
    kernels in a build log."""
    lines, keep = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            keep = "flash_f32_kernel" in line or "flash_fwd_kernel" in line
            if keep:
                lines.append(line.split("'")[1] if "'" in line else line)
        elif keep and re.search(r"registers|spill|smem|stack", line):
            lines.append("  " + line.split("ptxas info    :")[-1].strip())
    return lines


def build_all(variants):
    """{name: loaded library}, the builds in parallel; prints their
    seconds and each variant's ptxas lines."""
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, source, defines in variants:
        lib = out_dir / f"flash_attention-{name}.so"
        cmd = build.nvcc_command("flash_attention", source, lib)
        cmd[1:1] = ["-I", str(source.parent)] + [f"-D{d}" for d in defines]
        log = open(lib.with_suffix(".log"), "w")
        procs[name] = (lib, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, log, proc) in procs.items():
        rc = proc.wait()
        log.close()
        text = lib.with_suffix(".log").read_text()
        if rc:
            print(text[-4000:])
            raise RuntimeError(f"nvcc failed for {name}")
        print(f"{name}: ptxas of the float32 kernels")
        for line in ptxas_lines(text):
            print("  " + line)
        libs[name] = ctypes.CDLL(str(lib))
    print(f"nvcc of {len(variants)} variants in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    return libs


def use(lib):
    """The flash wrapper launches through ``lib`` (``fk._lib`` binds it)."""
    return mock.patch.object(fk.build, "load", lambda name: lib)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=SOURCE[:DEFINE,...], repeatable")
    ap.add_argument("--turns", type=int, default=2,
                    help="timing turns a b ... b a (each turn times every "
                         "variant once forward and once back)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32_probe: no CUDA device is visible", file=sys.stderr)
        return 1
    import chip_smoke
    variants = [parse_variant(s)
                for s in (args.variant or [f"this={SOURCE}"])]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = build_all(variants)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, lib in libs.items():
        print(f"{name}: phases 5a and 10a")
        with use(lib):
            chip_smoke.check_flash_random_blocks(dev)
            chip_smoke.check_flash_dims_random_blocks(dev)
    names = list(libs)
    for phase in ("14g", "14f"):
        rows = {name: [] for name in names}
        for _ in range(args.turns):
            for name in names + names[::-1]:
                with use(libs[name]):
                    rows[name].append(chip_smoke.flash_vs_plain(
                        dev, phase, torch.float32))
        for name in names:
            runs = rows[name]
            print(json.dumps({
                "variant": name, "shape": phase,
                "ms": min(r["ms"] for r in runs),
                "ms_all": [r["ms"] for r in runs],
                "max_abs_err": runs[0]["max_abs_err"],
                "sdpa_ms": min((r["library_ms"] for r in runs
                                if r["library_ms"] is not None),
                               default=None),
                "plain_ms": min(r["plain_ms"] for r in runs),
                "bound_ms": runs[0]["bound_ms"],
                "bound_by": runs[0]["bound_by"], "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
