"""MatrixMarket coordinate input (port of ``sgcn_tpu/io/mtx.py``).

The reference pipeline communicates through MatrixMarket files
(``<name>.A.mtx`` adjacency, ``.H.mtx`` features, ``.Y.mtx`` one-hot
labels).  Same semantics as the reference reader: ``scipy.io.mmread``,
CSR float32, duplicates summed, symmetric/pattern storage expanded.
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


def read_dense_features(path: str) -> np.ndarray:
    """Read an ``H.mtx`` feature matrix as dense (n, f) float32."""
    return np.asarray(read_mtx(path).todense(), np.float32)


def read_onehot_labels(path: str) -> np.ndarray:
    """Read a ``Y.mtx`` one-hot label matrix as (n,) int32 class ids."""
    return np.asarray(read_mtx(path).todense()).argmax(1).astype(np.int32)
