"""Accuracy-parity experiment — does partitioning change predictive power?
(port of ``sgcn_tpu/train/accuracy.py``, full-batch branch).

Trains (a) the single-device dense oracle and (b) the partitioned
full-batch trainer from the same init seed on the same split, and
reports the test accuracy of each.  The mini-batch flavor is not ported
yet (ROADMAP A8).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..baselines.oracle import DenseOracle
from ..parallel.plan import build_comm_plan
from .fullbatch import FullBatchTrainer, make_train_data


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
) -> dict:
    """Train the oracle and the partitioned trainer on the same split;
    report ``oracle_test_acc`` and ``fullbatch_test_acc``.  ``device``
    as in ``FullBatchTrainer`` (``None`` = ``cuda``)."""
    if batch_size is not None:
        raise NotImplementedError(
            "mini-batch trainer not ported yet (ROADMAP A8)")
    fin = features.shape[1]
    results: dict = {}

    oracle = DenseOracle(a, fin, widths, lr=lr, seed=seed, device=device)
    for _ in range(epochs):
        oracle.step(features, labels, train_mask)
    pred = oracle.predict(features).argmax(axis=1)
    results["oracle_test_acc"] = float(
        ((pred == labels) * test_mask).sum() / test_mask.sum())

    plan = build_comm_plan(a, partvec, k)
    tr = FullBatchTrainer(plan, fin, widths, lr=lr, seed=seed, device=device)
    data = make_train_data(plan, features, labels, train_mask, test_mask,
                           device=tr.device)
    for _ in range(epochs):
        tr.step(data)
    _, acc = tr.evaluate(data)
    results["fullbatch_test_acc"] = float(acc)
    return results
