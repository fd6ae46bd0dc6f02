"""MatrixMarket coordinate I/O (port of ``sgcn_tpu/io/mtx.py``).

The reference pipeline communicates through MatrixMarket files
(``<name>.A.mtx`` adjacency, ``.H.mtx`` features, ``.Y.mtx`` one-hot
labels).  Same semantics as the reference: ``scipy.io.mmread`` into CSR
float32, duplicates summed, symmetric/pattern storage expanded; and
``scipy.io.mmwrite`` of the COO form at precision 8, so a file the port
writes is byte-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import scipy.io
import scipy.sparse as sp


def read_mtx(path: str) -> sp.csr_matrix:
    """Read a MatrixMarket file into CSR float32 (pattern files → ones)."""
    m = scipy.io.mmread(path)
    m = sp.csr_matrix(m, dtype=np.float32)
    m.sum_duplicates()
    return m


def write_mtx(path: str, m: sp.spmatrix, comment: str = "") -> None:
    """Write CSR/COO to MatrixMarket coordinate general format (1-based)."""
    scipy.io.mmwrite(path, sp.coo_matrix(m), comment=comment, precision=8)


def read_dense_features(path: str) -> np.ndarray:
    """Read an ``H.mtx`` feature matrix as dense (n, f) float32."""
    return np.asarray(read_mtx(path).todense(), np.float32)


def read_onehot_labels(path: str) -> np.ndarray:
    """Read a ``Y.mtx`` one-hot label matrix as (n,) int32 class ids."""
    return np.asarray(read_mtx(path).todense()).argmax(1).astype(np.int32)
