"""Preprocessing (port of ``sgcn_tpu/prep/normalize.py``): strip
self-loops, add the identity, ``Â = D_r^{-1/2} (A + I) D_c^{-1/2}`` with
degrees counted as structural nonzeros, as the reference does; synthesize
an all-ones feature matrix and seeded one-hot labels; write the file
family ``<name>.{A,H,Y}.mtx`` + ``config`` that every later stage reads."""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from ..io.config import ModelConfig, write_config
from ..io.mtx import write_mtx


def normalize_adjacency(a: sp.spmatrix, add_self_loops: bool = True) -> sp.csr_matrix:
    """``Â = D_r^{-1/2} (A + I) D_c^{-1/2}`` with prior self-loop stripping."""
    a = sp.csr_matrix(a, dtype=np.float32)
    a = a - sp.diags(a.diagonal())          # strip existing self-loops
    a.eliminate_zeros()
    if add_self_loops:
        a = (a + sp.eye(a.shape[0], dtype=np.float32, format="csr")).tocsr()
    coo = a.tocoo()
    # degree = number of structural nonzeros per row / column
    dr = np.bincount(coo.row, minlength=a.shape[0]).astype(np.float32)
    dc = np.bincount(coo.col, minlength=a.shape[1]).astype(np.float32)
    with np.errstate(divide="ignore"):
        dri = np.where(dr > 0, 1.0 / np.sqrt(dr), 0.0).astype(np.float32)
        dci = np.where(dc > 0, 1.0 / np.sqrt(dc), 0.0).astype(np.float32)
    vals = coo.data * dri[coo.row] * dci[coo.col]
    return sp.csr_matrix((vals, (coo.row, coo.col)), shape=a.shape)


def synthetic_features(n: int, f: int = 1) -> sp.csr_matrix:
    """All-ones n×f feature matrix."""
    return sp.csr_matrix(np.ones((n, f), dtype=np.float32))


def synthetic_labels(n: int, nclasses: int = 2, seed: int = 0) -> sp.csr_matrix:
    """One-hot n×nclasses label matrix, each vertex's class drawn from a
    seeded RNG (the same draw as the reference)."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, nclasses, size=n)
    return sp.csr_matrix(
        (np.ones(n, dtype=np.float32), (np.arange(n), cls)), shape=(n, nclasses)
    )


def preprocess(
    a: sp.spmatrix,
    out_dir: str,
    name: str,
    nlayers: int = 2,
    hidden: int = 16,
    nclasses: int = 2,
    seed: int = 0,
) -> ModelConfig:
    """Normalize ``a``, synthesize H and Y, and write ``<name>.A.mtx``,
    ``<name>.H.mtx``, ``<name>.Y.mtx`` and ``config`` into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    n = a.shape[0]
    ahat = normalize_adjacency(a)
    h = synthetic_features(n)
    y = synthetic_labels(n, nclasses, seed)
    write_mtx(os.path.join(out_dir, f"{name}.A.mtx"), ahat)
    write_mtx(os.path.join(out_dir, f"{name}.H.mtx"), h)
    write_mtx(os.path.join(out_dir, f"{name}.Y.mtx"), y)
    widths = [hidden] * (nlayers - 1) + [nclasses]
    cfg = ModelConfig(nlayers=nlayers, nvtx=n, widths=widths)
    write_config(os.path.join(out_dir, "config"), cfg)
    return cfg
