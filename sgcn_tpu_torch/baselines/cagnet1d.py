"""CAGNET-style uniform 1-D broadcast baseline, inference only (port of
``sgcn_tpu/baselines/cagnet1d.py``).

Reference: ``Cagnet/main.c``, the baseline the paper's partitioned
algorithm is measured against.  Per layer every rank broadcasts its whole
H block and every rank accumulates ``A_local · H_bcast``
(``Cagnet/main.c:158-208``); forward only, sigmoid on every layer
(``:204-207``), with a phase-time breakdown (``data_comm`` /
``local_spmm``, ``:35-38,148-151,171-175,395-413``).  No boundary is
selected: all of H crosses the wire on every layer, whatever the
partition, which is the cost the paper's halo exchange removes.

On one device the ``k`` parts run stacked, as the port's trainer does.
The reference's ``lax.all_gather`` of the local block becomes one row
pack into a ``(k, k·B, f)`` receive layout, ``recv[q, p·B + t] = h[p,
t]``, by a flat index built in numpy (``bcast_src``, the broadcast's
counterpart of ``recv_src``): every part materialises every block, as
the broadcast does.  The local SpMM is one launch of K1's float-weight
family entry (``ops/tile_spmm.py::spmm_tiles_classes``) over each part's
rows of Â, tiled by ``stack_tile_family`` with the sources re-based into
the receive layout (``broadcast_edge_lists``), then ``torch.matmul`` and
the activation: ``act((Â·H)·W)``, aggregation first.  With ``mesh`` (a
``parallel/mesh.py::RankGroup``, one process per part) the pack becomes
one all-gather of the rank's block.  On CPU tensors both kernels are
their plain versions.

The phase split times ``data_comm`` and ``local_spmm`` apart with a
device synchronize between them; ``fused=True`` runs the same launches
with no synchronize between layers (one ``total`` phase), bit for bit
the same rows.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from ..models.activations import get_activation
from ..models.gcn import init_gcn_params, weight_tensors
from ..ops.row_shuffle import row_pack
from ..ops.tile_spmm import (spmm_tiles_classes, stack_tile_family,
                             tile_classes_from_buckets)
from ..parallel.plan import CommPlan, relabel_plan
from ..utils.backend import resolve_device, synchronize
from ..utils.timers import PhaseTimer

# the tile height: the partitioned path's (``choose_tile_dispatch``)
TB = 256


def broadcast_edge_lists(a, plan: CommPlan):
    """Per-part dst-sorted edge lists whose src indexes the gathered
    ``(k·B, f)`` table (the reference's, array for array): the plan's
    local rows, with ``src = owner·B + local_idx`` — the global table's
    slot — instead of the ``[local; halo]`` compaction."""
    a = sp.coo_matrix(a)
    k, b = plan.k, plan.b
    eo = plan.owner[a.row]
    e = plan.e
    edge_dst = np.full((k, e), b - 1, dtype=np.int32)
    edge_src = np.zeros((k, e), dtype=np.int32)
    edge_w = np.zeros((k, e), dtype=np.float32)
    for p in range(k):
        em = eo == p
        rows = plan.local_idx[a.row[em]].astype(np.int32)
        cols = a.col[em]
        gsrc = (plan.owner[cols] * b + plan.local_idx[cols]).astype(np.int32)
        vals = a.data[em].astype(np.float32)
        srt = np.argsort(rows, kind="stable")
        cnt = int(em.sum())
        edge_dst[p, :cnt] = rows[srt]
        edge_src[p, :cnt] = gsrc[srt]
        edge_w[p, :cnt] = vals[srt]
    return edge_dst, edge_src, edge_w


class BroadcastGCN1D:
    """Inference-only 1-D broadcast GCN (the ``Cagnet/main.c`` role)."""

    def __init__(self, a, partvec: np.ndarray, k: int, fin: int,
                 widths: list[int], mesh=None, activation: str = "sigmoid",
                 seed: int = 0, fused: bool = False, params=None,
                 device=None):
        """``params``: ``(fin, fout)`` weights (numpy, e.g. the JAX
        package's, or tensors); ``None`` draws the port's init from a
        ``torch.Generator`` seeded with ``seed``.  ``device``: ``None``
        is ``cuda`` (or the group's device under ``mesh``), ``"cpu"``
        the plain versions."""
        # relabel-only plan: no halo exchange, so no send/halo layout
        self.plan = relabel_plan(a, partvec, k)
        self.mesh = mesh
        if mesh is not None and mesh.size != k:
            raise ValueError(f"a rank group of {mesh.size} ranks for k={k} "
                             "parts: one rank per part")
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self.activation = activation
        self.fused = fused
        dims = list(zip([fin] + list(widths[:-1]), widths))
        if params is None:
            params = init_gcn_params(torch.Generator().manual_seed(seed),
                                     dims)
        self.params = weight_tensors(params, self.device)
        plan, b = self.plan, self.plan.b
        ed, es, ew = broadcast_edge_lists(a, plan)
        nnz = plan.nnz
        src, ld, w, self.classes = stack_tile_family(
            [ed[p, : nnz[p]] for p in range(k)],
            [es[p, : nnz[p]] for p in range(k)],
            [ew[p, : nnz[p]] for p in range(k)], b, TB,
            tile_classes_from_buckets(None, b, TB))
        # the gather's flat sources: every part receives every block
        bcast_src = np.tile(np.arange(k * b, dtype=np.int32), (k, 1))
        parts = slice(None) if mesh is None else slice(mesh.rank,
                                                       mesh.rank + 1)
        self.pa = {name: torch.as_tensor(np.ascontiguousarray(x[parts])).to(
            self.device) for name, x in (("tsrc", src), ("tld", ld),
                                         ("tw", w), ("bcast_src", bcast_src))}
        self.timer = PhaseTimer()

    # ------------------------------------------------------------- phases
    def _sync(self):
        synchronize(self.device)

    def gather(self, h):
        """``data_comm``: every block to every part — ``(k, B, f)`` →
        ``(k, k·B, f)`` in one row pack, or a rank's ``(1, B, f)`` →
        ``(1, k·B, f)`` in one all-gather."""
        if self.mesh is None:
            return row_pack(h.contiguous(), self.pa["bcast_src"])
        return self.mesh.all_gather(h[0])[None]

    def compute(self, w, table):
        """``local_spmm``: ``act((Â_local · table) · w)`` for each part's
        ``B`` rows, the SpMM in one family launch."""
        ah = spmm_tiles_classes(self.pa["tsrc"], self.pa["tld"],
                                self.pa["tw"], table, self.classes,
                                TB)[:, : self.plan.b]
        return get_activation(self.activation)(torch.matmul(ah, w))

    # ---------------------------------------------------------------- api
    def _blocks(self, features):
        chips = None if self.mesh is None else [self.mesh.rank]
        h = self.plan.scatter_rows(np.asarray(features, np.float32),
                                   chips=chips)
        return torch.as_tensor(h).to(self.device)

    def forward(self, features: np.ndarray) -> np.ndarray:
        """One inference pass; returns the global ``(n, nout)`` rows (on a
        rank group every rank's, all-gathered)."""
        h = self._blocks(features)
        with torch.inference_mode():
            if self.fused:
                with self.timer.phase("total", sync=self._sync):
                    for w in self.params:
                        h = self.compute(w, self.gather(h))
            else:
                for w in self.params:
                    with self.timer.phase("data_comm", sync=self._sync):
                        table = self.gather(h)
                    with self.timer.phase("local_spmm", sync=self._sync):
                        h = self.compute(w, table)
            if self.mesh is not None:
                h = self.mesh.all_gather(h[0]).reshape(
                    self.mesh.size, *h.shape[1:])
        return self.plan.gather_rows(h.cpu().numpy())

    def run_epochs(self, features: np.ndarray,
                   epochs: int = 5) -> tuple[dict, np.ndarray]:
        """Reference protocol: repeated forward passes, phase times
        reported (``Cagnet/main.c:125-220,395-413``)."""
        if epochs < 1:
            raise ValueError("epochs must be >= 1")
        t0 = time.perf_counter()
        for _ in range(epochs):
            out = self.forward(features)
        elapsed = time.perf_counter() - t0
        report = {
            "epochs": epochs,
            "elapsed_s": elapsed,
            "epoch_s": elapsed / max(epochs, 1),
            "phases": self.timer.report(),
            # the broadcast ships every row to every peer each layer
            "send_volume_per_exchange": int(
                (self.plan.k - 1) * self.plan.part_sizes.sum()),
        }
        return report, out
