"""Build the CUDA sources of ``kernels/csrc`` with ``nvcc`` at first use
and load them with ``ctypes`` (plain C entry points, no PyTorch headers).

Each ``csrc/<name>.cu`` compiles to ``_build/<name>-<hash>.so`` beside this
file, keyed by a hash of the source, the shared headers (``csrc/*.cuh``,
found through ``-I csrc``) and the flags, so an edited source
rebuilds and an unchanged one loads at once; ``_build/`` is listed in
``.gitignore`` and nothing built is committed. ``build()`` starts one
``nvcc`` per source, all together, and waits for them.

Flags, per source (``FLAGS``): ``sm_90a`` (Hopper) and ``-O3`` for all;
``policy_scan`` may also be built with a generated header
(``load(name, generated=text)``, ``build(variants=...)``): the lane steps
of the registered policies (``kernels/lane_codegen.py``), written to
``_build/<name>-<hash>.gen/`` and included with
``-DREPRO_REGISTERED_STEPS``; the header's text is part of the hash, so
each registry gets a library of its own.
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
from typing import Dict, Iterable, Optional, Tuple

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

#: loaded libraries by (source name, generated header or None): a lookup
#: per kernel call, so it reads no file (``library_path`` hashes them)
_LOADED: Dict[Tuple[str, Optional[str]], ctypes.CDLL] = {}
#: sources this process has built with nvcc or loaded (``library_count``)
_SEEN: set = set()


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


#: the generated header each source includes when it is given one
GENERATED_HEADER = {"policy_scan": "registered_steps.cuh"}


def library_path(name: str, generated: Optional[str] = None) -> Path:
    """The built library of ``csrc/<name>.cu``, keyed by the source, the
    shared headers (``csrc/*.cuh``), the flags and the generated header's
    text (None: none)."""
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    if generated is not None:
        text += b"\0" + generated.encode()
    digest = hashlib.sha256(text + " ".join(FLAGS[name]).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def nvcc_command(name: str, source: Path, out: Path,
                 generated_dir: Optional[Path] = None) -> list:
    """The nvcc command that builds ``source`` (``csrc/<name>.cu`` or an
    edited copy of it elsewhere) with ``name``'s flags into ``out``; the
    shared headers are found in ``csrc``, a generated one in
    ``generated_dir``."""
    extra = [] if generated_dir is None else [
        "-DREPRO_REGISTERED_STEPS", "-I", str(generated_dir)]
    return [nvcc_path(), *FLAGS[name], *extra, "-I", str(CSRC), "-o",
            str(out), str(source)]


def build(names: Iterable[str] = SOURCES,
          variants: Iterable[Tuple[str, str]] = ()) -> float:
    """Compile every named source that is not built yet, and each
    (name, generated header) of ``variants``, one ``nvcc`` per library,
    all started together. Returns the seconds spent."""
    t0 = time.perf_counter()
    jobs = [(n, None) for n in names] + list(variants)
    todo = [(n, g) for n, g in jobs if not library_path(n, g).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, generated in todo:
        out = library_path(name, generated)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        gen_dir = None
        if generated is not None:
            gen_dir = out.with_suffix(".gen")
            gen_dir.mkdir(exist_ok=True)
            (gen_dir / GENERATED_HEADER[name]).write_text(generated)
        log = open(out.with_suffix(".log"), "w")
        procs.append((name, out, tmp, log, subprocess.Popen(
            nvcc_command(name, CSRC / f"{name}.cu", tmp, gen_dir),
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(f"{name} (exit {rc}, see {log.name})")
        else:
            os.replace(tmp, out)    # atomic: concurrent builds agree
            _SEEN.add(name)
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
    return time.perf_counter() - t0


def load(name: str, generated: Optional[str] = None) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, with the generated header
    ``generated`` when given (built first if needed)."""
    lib = _LOADED.get((name, generated))
    if lib is None:
        if generated is None:
            build([name])
        else:
            build([], [(name, generated)])
        lib = ctypes.CDLL(str(library_path(name, generated)))
        _LOADED[(name, generated)] = lib
        _SEEN.add(name)
    return lib


def library_count() -> int:
    """How many kernel libraries this process has built or loaded: it
    grows on the first launch of each kernel source and never after
    (``repro_torch.obs.jit_cache_size`` reads it)."""
    return len(_SEEN)
