"""Vertex router: query vertex ids → owning part + local slot (copied from
``sgcn_tpu/serve/router.py``).

A query names a GLOBAL vertex id, but logits live per part under the
plan's vertex relabeling (``CommPlan.owner`` / ``CommPlan.local_idx``).
The router resolves that mapping on the host and validates ids loudly;
``route`` additionally groups queries by owning part.
"""

from __future__ import annotations

import numpy as np

# CommPlan fields the serve subsystem reads for routing (global
# vertex-indexed arrays, never per-part-stacked)
SERVE_ROUTER_FIELDS = ("owner", "local_idx")


class VertexRouter:
    """Owner/slot lookup + co-location grouping over one ``CommPlan``."""

    def __init__(self, plan):
        self.n = int(plan.n)
        self.k = int(plan.k)
        self.owner = np.asarray(plan.owner, dtype=np.int32)
        self.local_idx = np.asarray(plan.local_idx, dtype=np.int32)

    def lookup(self, qids) -> tuple[np.ndarray, np.ndarray]:
        """``(owners, locals)`` for a batch of global vertex ids; raises on
        out-of-range ids (a bad query must fail at the router, not as a
        wrong-row gather deep inside the forward)."""
        q = np.asarray(qids, dtype=np.int64).reshape(-1)
        if q.size and (q.min() < 0 or q.max() >= self.n):
            bad = q[(q < 0) | (q >= self.n)][:5]
            raise ValueError(
                f"query vertex ids out of range [0, {self.n}): {bad.tolist()}")
        return self.owner[q], self.local_idx[q]

    def route(self, qids) -> dict[int, np.ndarray]:
        """Group a batch of query ids by owning part; parts with no queries
        are absent."""
        q = np.asarray(qids, dtype=np.int64).reshape(-1)
        owners, _ = self.lookup(q)
        order = np.argsort(owners, kind="stable")
        out: dict[int, np.ndarray] = {}
        for chip in np.unique(owners):
            out[int(chip)] = q[order][owners[order] == chip]
        return out
