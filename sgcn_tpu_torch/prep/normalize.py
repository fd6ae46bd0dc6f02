"""Adjacency normalization (port of ``sgcn_tpu/prep/normalize.py``):
strip self-loops, add the identity, ``Â = D_r^{-1/2} (A + I) D_c^{-1/2}``
with degrees counted as structural nonzeros, as the reference does."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


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
