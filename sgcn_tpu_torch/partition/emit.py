"""The partitioner's file family (port of ``sgcn_tpu/partition/emit.py``;
the same formats, byte for byte).

* Part vectors: flat whitespace-separated text ``<name>.<k>.{gp,hp,rp}``
  and the pickled list of the SHP flavor.
* Per-rank files ``A.r`` / ``H.r`` / ``Y.r`` (triplets with global ids),
  the connectivity plan ``conn.r``, the receive sizes ``buff.r`` and the
  shared ``config``.  ``conn``/``buff`` come from ``build_comm_plan`` with
  ``row_order="id"``, the plan the trainers build, so the files and the
  run-time exchange agree.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import scipy.sparse as sp

from ..io.config import ModelConfig, write_config
from ..parallel.plan import build_comm_plan


# ---------------------------------------------------------------- part vectors
def write_partvec(path: str, pv: np.ndarray) -> None:
    """Flat whitespace-separated text, one line."""
    with open(path, "w") as f:
        f.write(" ".join(str(int(p)) for p in pv) + "\n")


def read_partvec(path: str) -> np.ndarray:
    """Whitespace-separated part ids → (n,) int64."""
    with open(path) as f:
        return np.array([int(t) for t in f.read().split()], dtype=np.int64)


def write_partvec_pickle(path: str, pv: np.ndarray) -> None:
    """Pickled list of Python ints (the SHP flavor)."""
    with open(path, "wb") as f:
        pickle.dump([int(p) for p in pv], f)


def read_partvec_pickle(path: str) -> np.ndarray:
    """Pickled list of part ids → (n,) int64.  Unpickling runs code, so
    only read part vectors this project's own tools wrote."""
    with open(path, "rb") as f:
        return np.array(pickle.load(f), dtype=np.int64)


# ------------------------------------------------------------- per-rank family
def write_rank_files(outdir: str, a: sp.spmatrix,
                     y: sp.spmatrix, pv: np.ndarray, k: int,
                     cfg: ModelConfig) -> None:
    """Emit ``A.r / H.r / Y.r / conn.r / buff.r / config`` for r in 0..k-1.

    Formats (0-based ids, global shapes):

      * ``A.r``:   ``n nnz_r`` then ``i j v`` triplet lines (rows owned by r);
      * ``H.r``:   ``nrows`` then one global row id per line (owned rows);
      * ``Y.r``:   ``n nnz_r`` then ``i j v`` triplets of owned label rows;
      * ``conn.r``: ``nt`` then per target ``q cnt g1 ... gcnt`` — global ids
        of boundary rows r must send to q each layer;
      * ``buff.r``: ``ns`` then per source ``q cnt`` — rows r receives from q;
      * ``config``: shared model config line.
    """
    os.makedirs(outdir, exist_ok=True)
    a = sp.coo_matrix(a)
    y = sp.coo_matrix(y)
    n = a.shape[0]
    pv = np.asarray(pv, dtype=np.int64)
    # id row order: local index == rank by ascending global id in the part,
    # so owned[r] (r's vertices, ascending) maps local index -> global id
    plan = build_comm_plan(sp.csr_matrix(a), pv, k, row_order="id")
    owned = [np.where(pv == r)[0] for r in range(k)]

    arow_mask = [pv[a.row] == r for r in range(k)]
    yrow_mask = [pv[y.row] == r for r in range(k)]
    for r in range(k):
        am = arow_mask[r]
        with open(os.path.join(outdir, f"A.{r}"), "w") as f:
            f.write(f"{n} {int(am.sum())}\n")
            for i, j, v in zip(a.row[am], a.col[am], a.data[am]):
                f.write(f"{i} {j} {v:.8g}\n")
        with open(os.path.join(outdir, f"H.{r}"), "w") as f:
            f.write(f"{len(owned[r])}\n")
            for g in owned[r]:
                f.write(f"{g}\n")
        ym = yrow_mask[r]
        with open(os.path.join(outdir, f"Y.{r}"), "w") as f:
            f.write(f"{n} {int(ym.sum())}\n")
            for i, j, v in zip(y.row[ym], y.col[ym], y.data[ym]):
                f.write(f"{i} {j} {v:.8g}\n")
        # conn.r: send lists (targets); buff.r: recv sizes (sources)
        with open(os.path.join(outdir, f"conn.{r}"), "w") as f:
            targets = [q for q in range(k)
                       if q != r and plan.send_counts[r, q] > 0]
            f.write(f"{len(targets)}\n")
            for q in targets:
                cnt = plan.send_counts[r, q]
                gids = owned[r][plan.send_idx[r, q, :cnt]]
                f.write(f"{q} {cnt} " + " ".join(str(g) for g in gids) + "\n")
        with open(os.path.join(outdir, f"buff.{r}"), "w") as f:
            sources = [q for q in range(k)
                       if q != r and plan.send_counts[q, r] > 0]
            f.write(f"{len(sources)}\n")
            for q in sources:
                f.write(f"{q} {int(plan.send_counts[q, r])}\n")
    write_config(os.path.join(outdir, "config"), cfg)


def read_conn(path: str) -> dict[int, np.ndarray]:
    """conn.r → {target rank: global ids to send}."""
    out: dict[int, np.ndarray] = {}
    with open(path) as f:
        nt = int(f.readline())
        for _ in range(nt):
            toks = f.readline().split()
            q, cnt = int(toks[0]), int(toks[1])
            out[q] = np.array([int(t) for t in toks[2:2 + cnt]], dtype=np.int64)
    return out


def read_buff(path: str) -> dict[int, int]:
    """buff.r → {source rank: rows received}."""
    out: dict[int, int] = {}
    with open(path) as f:
        ns = int(f.readline())
        for _ in range(ns):
            q, cnt = f.readline().split()
            out[int(q)] = int(cnt)
    return out
