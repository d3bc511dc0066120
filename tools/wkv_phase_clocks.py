#!/usr/bin/env python3
"""Where a chunk of the chunked WKV kernel spends its time, on the card.

    python3 tools/wkv_phase_clocks.py [variant ...]

The profilers that count by instruction (ncu, nsys) are not available on
the machines this port is measured on, so this script builds an
instrumented copy of ``wkv_chunked`` (``src/repro_torch/kernels/csrc/
rwkv6.cu``): thread 0 of block 0 reads ``clock64()`` after each of the
block barriers of a chunk (one more is added at the chunk's end) and adds
the cycles since the last mark to that phase's counter. It runs the copy
once at the rwkv6-7b prefill shape (r/k/v/w [4, 2,048, 64, 64] bf16, zero
state) and prints one JSON line per variant: the kernel's CUDA-event
time and block 0's cycles per chunk in each phase: (0) waiting at the
top barrier, (1) the first pass's own steps, (2) its cross-segment sums
and decay factors, (3) the pairs, inter and the state update, (4) the
pairs times v and the output. Variants leave work out to see what it
costs (their results are wrong, and are not checked): ``base``,
``no-diagonal`` (no elementwise diagonal pairs; the bonus stays),
``no-offdiagonal`` (no off-diagonal pair blocks), ``one-pass`` (one TF32 product where 3xTF32
takes three). The instrumented copy builds into ``kernels/_build``.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

SIG = ("template <typename T, int N>\n__global__ void "
       "__launch_bounds__(kCThreads, 2)\nwkv_chunked(")
END = "\ntemplate <typename T, int N>\nint launch("
MARK = ("#define PH(n) if (blockIdx.x == 0 && threadIdx.x == 0) { "
        "unsigned long long now = clock64(); g_ph[n] += now - t_last; "
        "t_last = now; }\n__device__ unsigned long long g_ph[8];\n")
READ = ('\nextern "C" int wkv_phases(unsigned long long* h, int reset) {\n'
        '  if (reset) { unsigned long long z[8] = {};\n'
        '    return (int)cudaMemcpyToSymbol(g_ph, z, sizeof(z)); }\n'
        '  return (int)cudaMemcpyFromSymbol(h, g_ph, sizeof(g_ph)); }\n')
#: variant -> (text in the kernel, its replacement)
CUTS = {
    "no-diagonal": ("for (int p = tid; p < kChunk / kSub * kPairs + kChunk;",
                    "for (int p = tid + kChunk / kSub * kPairs; "
                    "p < kChunk / kSub * kPairs + kChunk;"),
    "no-offdiagonal": ("if (warp < kChunk / kSub * (kChunk / kSub - 1) / 2)",
                       "if (false)"),
    "one-pass": ("mma_tf32(cross[x], al, bh);", ""),
}


def instrumented(variant):
    src = (build.CSRC / "rwkv6.cu").read_text()
    head, rest = src.split(SIG, 1)
    kern, tail = rest.split(END, 1)
    kern = kern.replace("  const int bh = blockIdx.x;",
                        "  unsigned long long t_last = clock64();\n"
                        "  const int bh = blockIdx.x;", 1)
    lines, n = [], 0
    for line in kern.split("\n"):
        lines.append(line)
        if line.strip().startswith("__syncthreads();"):
            lines.append(f"    PH({n});")
            n += 1
    kern = "\n".join(lines)
    loop_end = "\n  }\n  if (owns_state)"
    kern = kern.replace(loop_end, f"\n    __syncthreads();\n    PH({n});"
                        + loop_end, 1)
    if variant in CUTS:
        old, new = CUTS[variant]
        where = head if variant == "one-pass" else kern
        if old not in where:
            raise SystemExit(f"{variant}: the kernel no longer has {old!r}")
        if variant == "one-pass":
            head = head.replace(old, new).replace(
                "if (!B_EXACT) mma_tf32(cross[x], ah, bl);", "").replace(
                "      mma_tf32(cross[x], ah, bl);\n", "")
            kern = kern.replace("mma_tf32(cross, al, bh);", "").replace(
                "mma_tf32(cross, ah, bl);", "")
        else:
            kern = kern.replace(old, new)
    return head + MARK + SIG + kern + END + tail + READ, n + 1


def main(variants):
    if not torch.cuda.is_available():
        print("wkv_phase_clocks: no CUDA device is visible", file=sys.stderr)
        return 1
    out_dir = build.BUILD_DIR / "phase_clocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, h, n = 4, 2048, 64, 64
    r, k, v = (0.5 * torch.randn(b, s, h, n, generator=g, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * torch.randn(b, s, h, n, generator=g,
                                               device=dev) - 0.5))
    r, k, v, w = (x.bfloat16() for x in (r, k, v, w))
    u = 0.3 * torch.randn(h, n, generator=g, device=dev)
    out = torch.empty_like(r)
    s_out = torch.empty(b, h, n, n, device=dev)
    for variant in variants:
        text, phases = instrumented(variant)
        cu, so = out_dir / f"{variant}.cu", out_dir / f"{variant}.so"
        cu.write_text(text)
        subprocess.run([build.nvcc_path(), *build.FLAGS["rwkv6"], "-o",
                        str(so), str(cu)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.rwkv6_launch.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.wkv_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            rc = lib.rwkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  w.data_ptr(), u.data_ptr(), None,
                                  out.data_ptr(), s_out.data_ptr(), 1, b, s,
                                  h, n, 1, stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
        launch()                                             # warm-up
        torch.cuda.synchronize()
        lib.wkv_phases(None, 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 8)()
        lib.wkv_phases(counts, 0)
        chunks = (s + 31) // 32
        print(json.dumps({
            "variant": variant, "ms": start.elapsed_time(end),
            "cycles_per_chunk": [round(c / chunks) for c in
                                 list(counts)[:phases]],
            "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["base", "no-diagonal", "no-offdiagonal",
                                  "one-pass"]))
