"""Random partitioning with exact balance (port of
``sgcn_tpu/partition/random_part.py``; same numpy RNG, same vector)."""

from __future__ import annotations

import numpy as np


def balanced_random_partition(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Random permutation chopped into equal parts (exact balance)."""
    perm = np.random.default_rng(seed).permutation(n)
    part = np.empty(n, dtype=np.int64)
    part[perm] = np.arange(n) % k
    return part
