"""Accuracy-parity experiment — does partitioning change predictive power?
(port of ``sgcn_tpu/train/accuracy.py``).

Trains (a) the single-device dense oracle, (b) the partitioned
full-batch trainer and, with ``batch_size``, (c) the partitioned
mini-batch trainer, all from the same init seed on the same split, and
reports the test accuracy of each (the mini-batch one evaluated on the
whole graph).  On a rank group (``mesh``; ROADMAP A2c) the partitioned
trainers run one part per process and the dense oracle runs on every
rank, on its own device, as the reference's harness does on each
process; every rank returns the same report.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..baselines.oracle import DenseOracle
from ..parallel.plan import build_comm_plan
from .fullbatch import (FullBatchTrainer, make_train_data,
                        make_train_data_multihost)
from .minibatch import MiniBatchTrainer


def train_test_split_masks(n: int, train_frac: float = 0.6,
                           seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Random vertex-level split: ``train_frac`` of the vertices train,
    the rest test."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    ntrain = int(n * train_frac)
    train = np.zeros(n, dtype=np.float32)
    test = np.zeros(n, dtype=np.float32)
    train[perm[:ntrain]] = 1.0
    test[perm[ntrain:]] = 1.0
    return train, test


def run_accuracy_parity(
    a: sp.spmatrix,
    features: np.ndarray,
    labels: np.ndarray,
    partvec: np.ndarray,
    k: int,
    widths: list[int],
    train_mask: np.ndarray,
    test_mask: np.ndarray,
    epochs: int = 15,
    batch_size: int | None = None,
    lr: float = 0.01,
    seed: int = 0,
    device=None,
    verbose: bool = False,
    mesh=None,
) -> dict:
    """Train the oracle and the partitioned trainer(s) on the same split;
    report ``oracle_test_acc``, ``fullbatch_test_acc`` and, with
    ``batch_size``, ``minibatch_test_acc``.  ``device`` as in
    ``FullBatchTrainer`` (``None`` = ``cuda``; the group's with
    ``mesh``); ``mesh`` a ``RankGroup`` of ``k`` ranks."""
    if mesh is not None and device is None:
        device = mesh.device
    fin = features.shape[1]
    results: dict = {}

    oracle = DenseOracle(a, fin, widths, lr=lr, seed=seed, device=device)
    for _ in range(epochs):
        oracle.step(features, labels, train_mask)
    pred = oracle.predict(features).argmax(axis=1)
    results["oracle_test_acc"] = float(
        ((pred == labels) * test_mask).sum() / test_mask.sum())

    plan = build_comm_plan(a, partvec, k)
    tr = FullBatchTrainer(plan, fin, widths, lr=lr, seed=seed, device=device,
                          mesh=mesh)
    data = (make_train_data(plan, features, labels, train_mask, test_mask,
                            device=tr.device) if mesh is None else
            make_train_data_multihost(plan, mesh, features, labels,
                                      train_mask, test_mask))
    for _ in range(epochs):
        tr.step(data)
    _, acc = tr.evaluate(data)
    results["fullbatch_test_acc"] = float(acc)

    if batch_size is not None:
        mb = MiniBatchTrainer(a, partvec, k, fin, widths,
                              batch_size=batch_size, lr=lr, seed=seed,
                              device=device, mesh=mesh)
        mb.fit(features, labels, train_mask, epochs=epochs, verbose=verbose)
        _, acc = mb.evaluate_fullgraph(features, labels, test_mask)
        results["minibatch_test_acc"] = float(acc)
    return results
