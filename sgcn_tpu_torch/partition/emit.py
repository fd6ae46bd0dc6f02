"""Part-vector readers (port of the reader half of
``sgcn_tpu/partition/emit.py``): the flat text ``<name>.<k>.{gp,hp,rp}``
and the SHP pickle list."""

from __future__ import annotations

import pickle

import numpy as np


def read_partvec(path: str) -> np.ndarray:
    """Whitespace-separated part ids → (n,) int64."""
    with open(path) as f:
        return np.array([int(t) for t in f.read().split()], dtype=np.int64)


def read_partvec_pickle(path: str) -> np.ndarray:
    """Pickled list of part ids → (n,) int64.  Unpickling runs code, so
    only read part vectors this project's own tools wrote."""
    with open(path, "rb") as f:
        return np.array(pickle.load(f), dtype=np.int64)
