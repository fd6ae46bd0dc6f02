"""Dataset loaders and generators (port of the serving and training subset
of ``sgcn_tpu/io/datasets.py``): the planetoid/ogbn ``.npz`` snapshot
reader, the Erdős–Rényi benchmark stand-in graph and the planetoid
train/test split.  Same numpy RNG calls as the reference, so the same seed
gives the same graph and the same split."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# on-disk .npz layout used by the public planetoid/ogbn snapshot dumps
_NPZ_ADJ = ("adj_data", "adj_indices", "adj_indptr", "adj_shape")
_NPZ_ATTR = ("attr_data", "attr_indices", "attr_indptr", "attr_shape")


def er_graph(n: int, avg_deg: int = 14, seed: int = 0) -> sp.csr_matrix:
    """Random symmetric graph with ~n·avg_deg/2 edges (benchmark stand-in
    for the ogbn-* graphs when offline)."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    a = sp.coo_matrix((np.ones(len(src), np.float32), (src, dst)), shape=(n, n))
    return sp.csr_matrix(((a + a.T) > 0).astype(np.float32))


def planetoid_split(labels: np.ndarray, per_class: int = 20,
                    ntest: int = 1000, seed: int = 0):
    """Planetoid split semantics: ``per_class`` train nodes per class, a
    held-out test block of ``ntest`` nodes, the rest unused.

    Returns ``(train_mask, test_mask)`` float32 0/1 vectors.
    """
    labels = np.asarray(labels)
    n = len(labels)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    train = np.zeros(n, np.float32)
    for c in np.unique(labels):
        picks = perm[labels[perm] == c][:per_class]
        train[picks] = 1.0
    test = np.zeros(n, np.float32)
    pool = perm[train[perm] == 0.0]
    test[pool[-min(ntest, len(pool)):]] = 1.0
    return train, test


def load_npz_dataset(path: str):
    """Read a planetoid/ogbn-style ``.npz`` snapshot.

    Accepts sparse (``attr_data/indices/indptr/shape``) and dense
    (``attr_matrix``) feature storage.  Returns ``(adjacency csr, features
    float32 ndarray, labels int32)``.
    """
    adj_data, adj_indices, adj_indptr, adj_shape = _NPZ_ADJ
    attr_data, attr_indices, attr_indptr, attr_shape = _NPZ_ATTR
    with np.load(path, allow_pickle=False) as z:
        a = sp.csr_matrix(
            (z[adj_data], z[adj_indices], z[adj_indptr]),
            shape=tuple(z[adj_shape]))
        if "attr_matrix" in z:
            feats = np.asarray(z["attr_matrix"], np.float32)
        else:
            feats = np.asarray(sp.csr_matrix(
                (z[attr_data], z[attr_indices], z[attr_indptr]),
                shape=tuple(z[attr_shape])).todense(), np.float32)
        labels = np.asarray(z["labels"]).astype(np.int32)
    a = sp.csr_matrix(a, dtype=np.float32)
    a.sum_duplicates()
    return a, feats, labels
