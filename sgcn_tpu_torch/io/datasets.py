"""Dataset loaders and generators (port of ``sgcn_tpu/io/datasets.py``).

  * ``karate()`` — Zachary's karate club (34 vertices, the two factions as
    labels);
  * ``planted_partition()`` — a community graph with noisy one-hot
    features a GCN can learn;
  * ``er_graph()`` — the Erdős–Rényi benchmark stand-in for the ogbn-*
    graphs;
  * ``dcsbm_graph()`` — a degree-corrected block model: power-law degrees
    and planted communities, the synthetic graph a partitioner can cut
    well (ogbn-products has both);
  * ``ba_graph()`` — preferential attachment: the hub-heavy degree tail;
  * ``cora_like()`` — a citation-style graph with sparse binary
    bag-of-words features in cora's format;
  * ``load_npz_dataset()`` / ``save_npz_dataset()`` — the planetoid/ogbn
    ``.npz`` snapshot layout;
  * ``planetoid_split()`` — the per-class train / held-out test split;
  * ``save_fixture()`` — any of them as the ``A/H/Y`` ``.mtx`` family.

Each makes the same numpy RNG calls in the same order as the reference,
so the same seed gives the same arrays.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

_KARATE_EDGES = [
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31),
    (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30),
    (2, 3), (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32),
    (3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16),
    (6, 16), (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
    (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
    (31, 33), (32, 33),
]


_KARATE_LABELS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 1, 0,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], dtype=np.int32)


def karate() -> tuple[sp.csr_matrix, np.ndarray]:
    """(adjacency, labels) — 34 vertices, 78 undirected edges."""
    e = np.array(_KARATE_EDGES, dtype=np.int64)
    row = np.concatenate([e[:, 0], e[:, 1]])
    col = np.concatenate([e[:, 1], e[:, 0]])
    a = sp.csr_matrix(
        (np.ones(len(row), np.float32), (row, col)), shape=(34, 34))
    return a, _KARATE_LABELS.copy()


def planted_partition(n: int = 96, nclasses: int = 3, p_in: float = 0.25,
                      p_out: float = 0.02, noise: float = 0.4,
                      seed: int = 0):
    """Community graph + noisy one-hot features a GCN can learn.

    Returns (adjacency, features, labels).
    """
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % nclasses).astype(np.int32)
    prob = np.where(labels[:, None] == labels[None, :], p_in, p_out)
    dense = rng.random((n, n)) < prob
    dense = np.triu(dense, 1)
    dense = dense | dense.T
    a = sp.csr_matrix(dense.astype(np.float32))
    feats = np.eye(nclasses, dtype=np.float32)[labels]
    feats = feats + rng.normal(0, noise, (n, nclasses)).astype(np.float32)
    return a, feats, labels


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


def dcsbm_graph(n: int, ncomm: int = 64, avg_deg: int = 14,
                p_in: float = 0.85, alpha: float = 2.5,
                seed: int = 0) -> sp.csr_matrix:
    """Degree-corrected stochastic block model: power-law degrees AND
    planted community structure — the closest synthetic stand-in for the
    real ogbn graphs, which have BOTH (``ba_graph`` has the degree tail but
    is an expander: no partitioner can beat random by much there, measured
    1.07× at products scale; real ogbn-products partitions well because of
    its community structure).

    Vertices get Pareto(α) degree propensities; each edge endpoint is drawn
    ∝ propensity, with the partner drawn from the same community with
    probability ``p_in`` (else uniform across the graph).  Fully vectorized.
    """
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, ncomm, size=n)
    w = rng.pareto(alpha, size=n) + 1.0          # degree propensities
    m = n * avg_deg // 2
    # endpoint sampling ∝ w, globally and within each community
    order = np.argsort(comm, kind="stable")      # community-contiguous view
    wc = w[order]
    starts = np.searchsorted(comm[order], np.arange(ncomm + 1))
    cum = np.cumsum(wc)
    cum_tot = cum[-1]
    src = order[np.searchsorted(cum, rng.random(m) * cum_tot)]
    intra = rng.random(m) < p_in
    # intra partner: inverse-CDF restricted to src's community slice
    lo, hi = starts[comm[src]], starts[comm[src] + 1]
    c_lo = np.where(lo > 0, cum[lo - 1], 0.0)
    c_hi = cum[hi - 1]
    pick = c_lo + rng.random(m) * (c_hi - c_lo)
    dst_in = order[np.searchsorted(cum, pick)]
    dst_out = order[np.searchsorted(cum, rng.random(m) * cum_tot)]
    dst = np.where(intra, dst_in, dst_out)
    keep = src != dst
    a = sp.coo_matrix((np.ones(keep.sum(), np.float32),
                       (src[keep], dst[keep])), shape=(n, n))
    return sp.csr_matrix(((a + a.T) > 0).astype(np.float32))


def ba_graph(n: int, m: int = 7, seed: int = 0) -> sp.csr_matrix:
    """Preferential-attachment (Barabási–Albert) graph: ~n·m edges with a
    power-law degree tail — the degree profile of the real ogbn-*/citation
    graphs the paper benchmarks on; ``er_graph`` has no hubs, so only this
    generator exercises hub rows (long serial row walks in the tile
    kernel) at benchmark scale.

    Vectorized attachment: each new vertex draws ``m`` targets uniformly
    from the running endpoint list (endpoint frequency ∝ degree — the
    standard repeated-nodes trick), built in geometric batches so the
    Python-level loop is O(log n) long.
    """
    rng = np.random.default_rng(seed)
    if n <= m:
        raise ValueError(f"need n > m (got n={n}, m={m})")
    # seed: an (m+1)-vertex chain — vertex i attaches to i-1 (any connected
    # seed works; degrees equalize within a few batches)
    src = [np.arange(1, m + 1)]
    dst = [np.arange(0, m)]
    endpoints = [np.concatenate(src + dst)]
    count = m + 1
    while count < n:
        batch = min(max(count // 2, 1), n - count)   # grow geometrically
        pool = np.concatenate(endpoints)
        # new vertices in this batch attach to endpoints sampled from the
        # pool frozen at the batch start (a standard batched approximation
        # of sequential preferential attachment)
        new = np.repeat(np.arange(count, count + batch), m)
        # pool ids are all < count <= every new id, so no new vertex can be
        # drawn as its own (or a same-batch) target
        targets = pool[rng.integers(0, len(pool), size=batch * m)]
        src.append(new)
        dst.append(targets)
        endpoints.append(np.concatenate([new, targets]))
        count += batch
    s = np.concatenate(src)
    d = np.concatenate(dst)
    keep = s != d
    a = sp.coo_matrix((np.ones(keep.sum(), np.float32), (s[keep], d[keep])),
                      shape=(n, n))
    return sp.csr_matrix(((a + a.T) > 0).astype(np.float32))


def cora_like(n: int = 600, nclasses: int = 7, vocab: int = 64,
              words_per_doc: int = 12, avg_deg: int = 4,
              p_intra: float = 0.9, seed: int = 0):
    """Citation-network generator in cora's exact data format.

    Cora (the paper's accuracy-experiment dataset) is 2708 papers, 7 classes,
    sparse binary bag-of-words features over a 1433-word vocabulary, citation
    edges mostly intra-topic.  Zero egress forbids downloading it, so this
    reproduces the *format and learnability structure*: each class has a
    preferred word subset (a topic), each document samples ``words_per_doc``
    words from a mixture of its topic and the background, and citations
    attach preferentially within class with a heavy-tailed degree profile.

    Returns ``(adjacency csr, features csr binary (n, vocab), labels int32)``.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, nclasses, size=n).astype(np.int32)
    # topic word distributions: each class concentrates on vocab/nclasses words
    word_logits = np.full((nclasses, vocab), 0.1)
    block = vocab // nclasses
    for c in range(nclasses):
        word_logits[c, c * block:(c + 1) * block] = 3.0
    word_p = np.exp(word_logits)
    word_p /= word_p.sum(axis=1, keepdims=True)
    rows, cols = [], []
    for i in range(n):
        w = rng.choice(vocab, size=words_per_doc, replace=False,
                       p=word_p[labels[i]])
        rows.extend([i] * len(w))
        cols.extend(w)
    feats = sp.csr_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(n, vocab))
    feats.sum_duplicates()
    feats.data[:] = 1.0                      # binary bag-of-words, like cora
    # citations: preferential attachment within class (heavy-tailed degrees)
    m = n * avg_deg // 2
    src = rng.integers(0, n, size=2 * m)
    # heavy tail: square a uniform to bias destinations toward low ids
    dst_pool = (rng.random(2 * m) ** 2 * n).astype(np.int64)
    intra = rng.random(2 * m) < p_intra
    same = labels[src] == labels[dst_pool]
    keep = (src != dst_pool) & (intra == same)
    src, dst = src[keep][:m], dst_pool[keep][:m]
    a = sp.coo_matrix((np.ones(len(src), np.float32), (src, dst)),
                      shape=(n, n))
    a = sp.csr_matrix(((a + a.T) > 0).astype(np.float32))
    return a, feats, labels


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


# on-disk .npz layout used by the public planetoid/ogbn snapshot dumps
_NPZ_ADJ = ("adj_data", "adj_indices", "adj_indptr", "adj_shape")


_NPZ_ATTR = ("attr_data", "attr_indices", "attr_indptr", "attr_shape")


def save_npz_dataset(path: str, a: sp.spmatrix, features, labels) -> None:
    """Write the standard sparse-graph ``.npz`` snapshot layout."""
    a = sp.csr_matrix(a)
    arrs = dict(zip(_NPZ_ADJ, (a.data, a.indices, a.indptr, a.shape)))
    if sp.issparse(features):
        f = sp.csr_matrix(features)
        arrs.update(zip(_NPZ_ATTR, (f.data, f.indices, f.indptr, f.shape)))
    else:
        arrs["attr_matrix"] = np.asarray(features, np.float32)
    arrs["labels"] = np.asarray(labels)
    np.savez_compressed(path, **arrs)


def load_npz_dataset(path: str):
    """Read a planetoid/ogbn-style ``.npz`` snapshot.

    Accepts both sparse (``attr_data/indices/indptr/shape``) and dense
    (``attr_matrix``) feature storage, the two layouts the public snapshot
    dumps use.  Returns ``(adjacency csr, features float32 ndarray, labels
    int32)`` — features densified because the trainers consume dense rows.
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


def save_fixture(prefix: str, a: sp.spmatrix,
                 labels: np.ndarray | None = None,
                 features=None) -> dict[str, str]:
    """Write ``<prefix>.A.mtx`` (normalized Â) and optionally ``<prefix>.H.mtx``
    (features) / ``<prefix>.Y.mtx`` (one-hot labels) — the preprocessor's
    output family."""
    from ..prep import normalize_adjacency
    from .mtx import write_mtx
    paths = {}
    ahat = normalize_adjacency(sp.csr_matrix(a))
    write_mtx(f"{prefix}.A.mtx", ahat)
    paths["A"] = f"{prefix}.A.mtx"
    if features is not None:
        write_mtx(f"{prefix}.H.mtx", sp.csr_matrix(features))
        paths["H"] = f"{prefix}.H.mtx"
    if labels is not None:
        n = len(labels)
        nclasses = int(labels.max()) + 1
        y = sp.csr_matrix(
            (np.ones(n, np.float32), (np.arange(n), labels)),
            shape=(n, nclasses))
        write_mtx(f"{prefix}.Y.mtx", y)
        paths["Y"] = f"{prefix}.Y.mtx"
    return paths
