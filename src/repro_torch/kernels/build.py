"""Build the CUDA sources of ``kernels/csrc`` with ``nvcc`` at first use
and load them with ``ctypes`` (plain C entry points, no PyTorch headers).

Each ``csrc/<name>.cu`` compiles to ``_build/<name>-<hash>.so`` beside this
file, keyed by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once; ``_build/`` is listed in
``.gitignore`` and nothing built is committed. ``build()`` starts one
``nvcc`` per source, all together, and waits for them.

Flags, per source (``FLAGS``): ``sm_90a`` (Hopper) and ``-O3`` for all;
``-Xptxas -v`` writes each kernel's registers and spills to
``<name>-<hash>.log``. ``policy_scan`` adds ``--fmad=false`` with IEEE
division and square root and no flush-to-zero, because its kernels must
round every operation as the plain versions do (see
``csrc/policy_scan.cu``). The model kernels (``flash_attention``,
``ssm_scan``, ``rwkv6``) are held to a stated tolerance, not to bits, and
may contract multiply-adds. ``flash_attention`` also links ``-ldl``: it
finds libcuda's ``cuTensorMapEncodeTiled`` (TMA descriptors) with
``dlsym`` rather than linking libcuda.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: policy_scan's flags (bit parity with the plain versions)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")
#: the model kernels' flags (a tolerance, contraction allowed)
MODEL_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
FLAGS = {"policy_scan": NVCC_FLAGS,
         "flash_attention": MODEL_FLAGS + ("-ldl",),
         "ssm_scan": MODEL_FLAGS, "rwkv6": MODEL_FLAGS}
SOURCES = tuple(FLAGS)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "kernels/csrc at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(FLAGS[name]).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together. Returns the seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        log = open(out.with_suffix(".log"), "w")
        procs.append((name, out, tmp, log, subprocess.Popen(
            [nvcc, *FLAGS[name], "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(f"{name} (exit {rc}, see {log.name})")
        else:
            os.replace(tmp, out)    # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built first if needed)."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
