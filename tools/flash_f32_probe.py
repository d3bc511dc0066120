#!/usr/bin/env python3
"""Builds of ``csrc/flash_attention.cu`` side by side on the card: ptxas's
resources of the float32 and wide kernels, ``chip_smoke.py``'s checks
against the plain version, and the kernels' times at a prefill shape.

    python3 tools/flash_f32_probe.py [--variant NAME=SOURCE[:DEFINE,...]] ...
        [--shape 14g --shape 14f] [--dtype float32|bf16|both]
        [--check dims|wide|none] [--turns 2]

Each variant is a copy of the flash source (the source as it is, another
revision's, or an edited one, unpacked into a directory that
``.gitignore`` lists; its directory is searched for headers before
``csrc``), built with the model kernels' flags (``kernels/build.py``)
plus ``-D`` of each DEFINE into ``kernels/_build/probe/``, one nvcc per
variant, all started together. With no ``--variant``: the source as it
is, named ``this``. ``tools/flash_wide_first.cu`` (the wide kernel's
first form, with its leave-out defines ``WIDE_ONE_SLICE``,
``WIDE_NO_PV``, ``WIDE_V32``, ``WIDE_NO_BARRIERS``) is such a source; it
takes only head dims past 256.

For each variant it prints ptxas's registers, spills and shared memory of
its float32 and wide kernels and the builds' seconds, then runs, through
its library, ``--check dims`` (the default: phases 5a and 10a of
``chip_smoke.py``, ``check_flash_random_blocks`` and
``check_flash_dims_random_blocks``, both types against the plain version
on random blocks, every storage dim, within ``MODEL_TOL``), ``--check
wide`` (phase 11's blocks past 256, ``FLASH_WIDE_PAIRS``) or nothing
(``--check none``, for copies with a part left out, whose results are
wrong). Then it times every variant at each ``--shape`` of
``chip_smoke.FLASH_SHAPES`` (default 14g and 14f; ``11`` is
DeepSeek-V2-Lite's absorbed prefill, the wide kernel's) in each
``--dtype`` (default float32) in turns (a b ... b a; CUDA events, mean
of 10 launches after a warm-up), and prints one JSON line per variant,
shape and type: the least of its times, its max abs error against the
plain version (not checked: a copy with a part left out is wrong), SDPA's
and the plain version's times, the bound, and the card. Needs a CUDA
card and nvcc.
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
    """ptxas's registers, spills and shared memory of the float32 and
    wide kernels in a build log."""
    lines, keep = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            keep = any(n in line for n in ("flash_f32_kernel",
                                           "flash_fwd_kernel",
                                           "flash_wide"))
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
        print(f"{name}: ptxas of the float32 and wide kernels")
        for line in ptxas_lines(text):
            print("  " + line)
        libs[name] = ctypes.CDLL(str(lib))
    print(f"nvcc of {len(variants)} variants in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    return libs


def use(lib):
    """The flash wrapper launches through ``lib`` (``fk._lib`` binds it)."""
    return mock.patch.object(fk.build, "load", lambda name: lib)


def time_shape(dev, phase, dtype, libs, turns):
    """One JSON line per variant at ``phase``'s shape in ``dtype``."""
    import chip_smoke
    from repro_torch.kernels import ref
    q, k, v, causal = chip_smoke.flash_inputs(dev, phase, dtype)
    plain_ms, want = chip_smoke.cuda_ms(
        lambda: ref.flash_attention(q, k, v, causal=causal))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)
    try:
        sdpa()
        sdpa_ms, _ = chip_smoke.cuda_ms(sdpa, reps=10)
    except RuntimeError:                    # no SDPA backend takes it
        sdpa_ms = None

    def kernel():
        return fk.flash_attention(q, k, v, causal=causal)
    names = list(libs)
    rows = {name: [] for name in names}
    errs = {}
    for _ in range(turns):
        for name in names + names[::-1]:
            with use(libs[name]):
                got = kernel()                              # warm-up
                errs[name] = float((got.double() - want.double())
                                   .abs().max())
                rows[name].append(chip_smoke.cuda_ms(kernel, reps=10)[0])
    b, s, h, kh, dq, dv, _ = chip_smoke.FLASH_SHAPES[phase]
    bound_ms, bound_by, _ = chip_smoke.flash_bound(b, s, s, h, kh, dq, dv,
                                                   causal, dtype)
    for name in names:
        print(json.dumps({
            "variant": name, "shape": phase, "dtype": str(dtype),
            "ms": min(rows[name]), "ms_all": rows[name],
            "max_abs_err": errs[name], "sdpa_ms": sdpa_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=SOURCE[:DEFINE,...], repeatable")
    ap.add_argument("--shape", action="append", default=[],
                    help="a key of chip_smoke.FLASH_SHAPES, repeatable "
                         "(default 14g and 14f)")
    ap.add_argument("--dtype", choices=("float32", "bf16", "both"),
                    default="float32")
    ap.add_argument("--check", choices=("dims", "wide", "none"),
                    default="dims")
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
        if args.check == "none":
            continue
        print(f"{name}: check {args.check}")
        with use(lib):
            if args.check == "dims":
                chip_smoke.check_flash_random_blocks(dev)
                chip_smoke.check_flash_dims_random_blocks(dev)
            else:
                chip_smoke.check_flash_padding(dev, pad=False)
    dtypes = {"float32": [torch.float32], "bf16": [torch.bfloat16],
              "both": [torch.bfloat16, torch.float32]}[args.dtype]
    with torch.no_grad():
        for phase in args.shape or ["14g", "14f"]:
            for dtype in dtypes:
                time_shape(dev, phase, dtype, libs, args.turns)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
