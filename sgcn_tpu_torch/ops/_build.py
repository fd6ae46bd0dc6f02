"""Build and load the port's CUDA kernels.

Each source under ``sgcn_tpu_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes.  Libraries land in
``build/sgcn_tpu_torch/`` at the repository root, named by a hash of their
source (and flags), so an edited source rebuilds and an unchanged one is
reused.  Nothing is built at import: the first launch builds, or a caller
(``chip_smoke.py``) calls ``build()`` up front to build every source at
once, one ``nvcc`` each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sgcn_tpu_torch"
SOURCES = {"tile_spmm": "tile_spmm.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source at first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives for its current text."""
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that have no library for
    their current text yet, one ``nvcc`` each, all started together.
    Returns ``{name: {"seconds": wall, "log": ptxas report}}`` for the
    sources it compiled.  Raises with nvcc's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(n))   # atomic: never a partial library
        out[n] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, building it first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
