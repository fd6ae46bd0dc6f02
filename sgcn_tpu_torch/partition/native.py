"""ctypes binding of the native multilevel partitioners
(port of ``sgcn_tpu/partition/native.py``).

The library is the repository's ``native/sgcnpart.cpp``, compiled as it
is with the flags of ``native/Makefile`` (``g++ -O3 -std=c++17 -Wall
-Wextra -fPIC -shared``) at first use, into ``build/sgcn_tpu_torch/``
under a name hashed from the source, the compiler and the flags, and put
in place by an atomic rename: two processes building at once each write
their own temporary file and never leave a partial library.  Nothing is
written under ``native/``.  A failed build raises with the compiler's
output; no other partition stands in for it.

The library reads ``SGCN_HP_RB``, ``SGCN_RESTARTS`` and ``SGCN_TIMING``
from the environment at call time; this binding passes them through.

* ``partition_graph`` — k-way graph partition of the symmetrized pattern,
  edge-cut objective (the role of METIS in the paper's GP flavor);
* ``partition_hypergraph_colnet`` — column-net hypergraph partition,
  cells = rows weighted by row nnz, nets = columns, connectivity-1 (km1)
  objective (the role of PaToH in the HP flavor);
* ``partition_hypergraph_colnet_cache`` — the same, co-optimized with a
  replica budget (hot-halo replication);
* ``cache_aware_km1`` — a numpy evaluation of that cache-aware objective
  for any part vector.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import scipy.sparse as sp

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "sgcnpart.cpp"
BUILD_DIR = REPO / "build" / "sgcn_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared")

_loaded: dict[str, ctypes.CDLL] = {}
# one build and load at a time in this process: threads share its pid,
# and so the build's temporary file name
_load_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for the current source, compiler and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        (CXX,) + CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsgcnpart-{digest[:16]}.so"


def build() -> Path:
    """Compile ``native/sgcnpart.cpp`` unless its library exists; returns
    the library's path.  Raises with the compiler's output on failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except OSError as e:
        raise RuntimeError(f"native partitioner build failed: cannot run "
                           f"{CXX!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native partitioner build failed ({' '.join(cmd)}, exit "
            f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)            # atomic: never a partial library
    return path


def _load() -> ctypes.CDLL:
    with _load_lock:
        path = str(build())
        if path not in _loaded:
            _loaded[path] = _bind(ctypes.CDLL(path))
        return _loaded[path]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C ABI's argument and result types on ``lib``."""
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.sgcn_partition_graph.restype = ctypes.c_int
    lib.sgcn_partition_graph.argtypes = [
        ctypes.c_int32, i64p, i32p,
        ctypes.c_void_p,   # adjwgt (nullable)
        ctypes.c_void_p,   # vwgt (nullable)
        ctypes.c_int, ctypes.c_double, ctypes.c_int,
        i32p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sgcn_partition_hypergraph.restype = ctypes.c_int
    lib.sgcn_partition_hypergraph.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i64p, i32p,
        ctypes.c_void_p,   # cwgt (nullable)
        ctypes.c_int, ctypes.c_double, ctypes.c_int,
        i32p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sgcn_partition_hypergraph_cache.restype = ctypes.c_int
    lib.sgcn_partition_hypergraph_cache.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i64p, i32p,
        ctypes.c_void_p,   # cwgt (nullable)
        ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int32,    # replica_budget
        i32p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def _check_n(n: int) -> None:
    # the C ABI takes vertex and net ids as int32
    if n >= 2 ** 31:
        raise ValueError(f"the native partitioner takes n < 2^31, got {n}")


def partition_graph(a: sp.spmatrix, k: int, imbalance: float = 0.03,
                    seed: int = 1) -> tuple[np.ndarray, int]:
    """Multilevel k-way graph partition of the symmetrized pattern of ``a``:
    unit pattern, ``(pat + pat.T) > 0``, diagonal dropped, unit edge and
    vertex weights.  Returns (partvec int64 (n,), edge cut)."""
    a = sp.csr_matrix(a)
    n = a.shape[0]
    _check_n(n)
    pat = a.copy()
    pat.data[:] = 1.0
    sym = ((pat + pat.T) > 0).astype(np.float32)
    sym.setdiag(0)
    sym.eliminate_zeros()
    sym = sp.csr_matrix(sym)
    lib = _load()
    part = np.empty(n, dtype=np.int32)
    cut = ctypes.c_int64(0)
    rc = lib.sgcn_partition_graph(
        n, sym.indptr.astype(np.int64), sym.indices.astype(np.int32),
        None, None, k, imbalance, seed, part, ctypes.byref(cut))
    if rc != 0:
        raise RuntimeError(f"sgcn_partition_graph failed rc={rc}")
    return part.astype(np.int64), int(cut.value)


def _colnet_inputs(a: sp.spmatrix):
    """CSR of ``a`` (cells = rows, nets = columns) and its cell weights
    ``max(row nnz, 1)`` as int64."""
    a = sp.csr_matrix(a)
    _check_n(max(a.shape))
    cwgt = np.maximum(np.diff(a.indptr), 1).astype(np.int64)
    return a, cwgt


def partition_hypergraph_colnet(a: sp.spmatrix, k: int,
                                imbalance: float = 0.03,
                                seed: int = 1) -> tuple[np.ndarray, int]:
    """Column-net hypergraph partition: cells = rows (weight = row nnz),
    nets = columns, km1/connectivity-1 objective.

    Returns (partvec int64 (n,), km1 = Σ(λ−1))."""
    a, cwgt = _colnet_inputs(a)
    n, m = a.shape
    lib = _load()
    part = np.empty(n, dtype=np.int32)
    km1 = ctypes.c_int64(0)
    rc = lib.sgcn_partition_hypergraph(
        n, m, a.indptr.astype(np.int64), a.indices.astype(np.int32),
        cwgt.ctypes.data_as(ctypes.c_void_p), k, imbalance, seed, part,
        ctypes.byref(km1))
    if rc != 0:
        raise RuntimeError(f"sgcn_partition_hypergraph failed rc={rc}")
    return part.astype(np.int64), int(km1.value)


def partition_hypergraph_colnet_cache(
        a: sp.spmatrix, k: int, replica_budget: int,
        imbalance: float = 0.03,
        seed: int = 1) -> tuple[np.ndarray, int, int]:
    """Cache-aware column-net partition: the partition of
    ``partition_hypergraph_colnet``, then the cut co-optimized with the
    replica budget (a net whose source vertex is replicated costs 0).

    Returns ``(partvec int64 (n,), km1, km1_cache)``: ``km1_cache`` is km1
    minus the top-``replica_budget`` nets' contribution, nets ranked by
    (λ−1)·pins."""
    a, cwgt = _colnet_inputs(a)
    n, m = a.shape
    lib = _load()
    part = np.empty(n, dtype=np.int32)
    km1 = ctypes.c_int64(0)
    km1_cache = ctypes.c_int64(0)
    rc = lib.sgcn_partition_hypergraph_cache(
        n, m, a.indptr.astype(np.int64), a.indices.astype(np.int32),
        cwgt.ctypes.data_as(ctypes.c_void_p), k, imbalance, seed,
        int(replica_budget), part, ctypes.byref(km1),
        ctypes.byref(km1_cache))
    if rc != 0:
        raise RuntimeError(
            f"sgcn_partition_hypergraph_cache failed rc={rc}")
    return part.astype(np.int64), int(km1.value), int(km1_cache.value)


def cache_aware_km1(a: sp.spmatrix, part: np.ndarray,
                    replica_budget: int) -> int:
    """The cache-aware km1 objective of any part vector, in numpy (unit
    net weights): Σ_j (λ_j − 1) minus the contribution of the
    top-``replica_budget`` nets by (λ−1)·pins, net id breaking ties."""
    a = sp.csc_matrix(a)
    part = np.asarray(part)
    n_nets = a.shape[1]
    lam = np.zeros(n_nets, np.int64)
    pins = np.diff(a.indptr)
    for j in range(n_nets):
        rows = a.indices[a.indptr[j]: a.indptr[j + 1]]
        if len(rows):
            lam[j] = len(np.unique(part[rows]))
    contrib = np.maximum(lam - 1, 0)
    score = contrib * pins
    cut = np.nonzero(lam >= 2)[0]
    order = cut[np.lexsort((cut, -score[cut]))]
    chosen = order[: max(0, int(replica_budget))]
    return int(contrib.sum() - contrib[chosen].sum())
