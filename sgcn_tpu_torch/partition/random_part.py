"""Random partitioning (port of ``sgcn_tpu/partition/random_part.py``;
same numpy RNG, same vectors): the ``.rp`` baseline flavor."""

from __future__ import annotations

import numpy as np


def random_partition(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Uniform iid random part vector (may be unbalanced)."""
    return np.random.default_rng(seed).integers(0, k, size=n).astype(np.int64)


def balanced_random_partition(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Random permutation chopped into equal parts (exact balance)."""
    perm = np.random.default_rng(seed).permutation(n)
    part = np.empty(n, dtype=np.int64)
    part[perm] = np.arange(n) % k
    return part
