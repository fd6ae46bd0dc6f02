"""Stochastic hypergraph partitioning (SHP): partitions for mini-batch
communication (port of ``sgcn_tpu/shp/model.py``).

A partition that minimizes the full graph's connectivity is not the best
one for mini-batch training, where a step touches a random vertex subset.
SHP stacks the column-nets of ``nbatches`` sampled batch submatrices side
by side (``generate_stochastic_hypergraph``), partitions that stochastic
hypergraph with the column-net km1 objective (the native partitioner,
``partition/native.py``), and checks the result by simulating random
batches and comparing their expected communication volume against the
full graph's hypergraph partition (``simulate``).

Offline numpy; every random draw is the reference's, in its order, so a
seed gives the reference's part vectors and volumes.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..partition.native import partition_hypergraph_colnet


def sample_sparse_submatrix(a: sp.spmatrix, batch_size: int,
                            rng: np.random.Generator) -> sp.csc_matrix:
    """The batch-restricted submatrix in the global row space, empty
    columns dropped: the nonzeros whose row AND column lie in a random
    ``batch_size``-vertex subset."""
    a = sp.coo_matrix(a)
    n = a.shape[0]
    sub = rng.choice(n, size=min(batch_size, n), replace=False)
    member = np.zeros(n, dtype=bool)
    member[sub] = True
    keep = member[a.row] & member[a.col]
    s = sp.csc_matrix(
        (a.data[keep], (a.row[keep], a.col[keep])), shape=a.shape)
    nonempty = np.diff(s.indptr) != 0
    return s[:, nonempty]


def generate_stochastic_hypergraph(a: sp.spmatrix, nbatches: int,
                                   batch_size: int,
                                   rng: np.random.Generator) -> sp.csc_matrix:
    """The sampled batch submatrices side by side: rows are the cells
    (vertices), columns the nets drawn from the batch distribution."""
    subs = [sample_sparse_submatrix(a, batch_size, rng)
            for _ in range(nbatches)]
    return sp.csc_matrix(sp.hstack(subs))


def communication_volume(s: sp.spmatrix, partvec: np.ndarray) -> int:
    """Σ over columns of (distinct parts touching the column − 1), from
    the unique (column, part) pairs."""
    s = sp.coo_matrix(s)
    if s.nnz == 0:
        return 0
    pv = np.asarray(partvec)
    pairs = s.col.astype(np.int64) * (pv.max() + 1) + pv[s.row]
    n_pairs = len(np.unique(pairs))
    n_cols = len(np.unique(s.col))
    return int(n_pairs - n_cols)


def simulate(a: sp.spmatrix, partvecs: dict[str, np.ndarray], niter: int,
             batch_size: int, rng: np.random.Generator) -> dict[str, int]:
    """Total batch communication volume of each part vector over ``niter``
    sampled batches."""
    totals = {name: 0 for name in partvecs}
    for _ in range(niter):
        s = sample_sparse_submatrix(a, batch_size, rng)
        for name, pv in partvecs.items():
            totals[name] += communication_volume(s, pv)
    return totals


def run_shp(
    a: sp.spmatrix,
    k: int,
    nsampled_batches: int = 10,
    batch_size: int = 256,
    sim_iters: int = 20,
    imbalance: float = 0.03,
    seed: int = 1,
) -> dict:
    """The whole SHP pipeline: the full graph's hypergraph partition
    (``hp``), the stochastic hypergraph's (``stchp``), and the simulated
    batch communication of both.  Returns ``partvec_{hp,stchp}``,
    ``km1_{hp,stchp}`` and ``sim_comm_volume_{hp,stchp}``."""
    a = sp.csr_matrix(a)
    rng = np.random.default_rng(seed)
    pv_hp, km1_hp = partition_hypergraph_colnet(a, k, imbalance, seed)
    stc = generate_stochastic_hypergraph(a, nsampled_batches, batch_size, rng)
    pv_stchp, km1_stc = partition_hypergraph_colnet(
        sp.csr_matrix(stc), k, imbalance, seed)
    sim = simulate(a, {"hp": pv_hp, "stchp": pv_stchp}, sim_iters,
                   batch_size, rng)
    return {
        "partvec_hp": pv_hp,
        "partvec_stchp": pv_stchp,
        "km1_hp": km1_hp,
        "km1_stchp": km1_stc,
        "sim_comm_volume_hp": sim["hp"],
        "sim_comm_volume_stchp": sim["stchp"],
    }
