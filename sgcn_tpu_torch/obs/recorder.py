"""The comm plan's identity (port of ``sgcn_tpu/obs/recorder.py:48-68``).

``plan_digest`` must equal the reference's digest of the same plan, byte
for byte: a checkpoint records it as provenance, and a file written by
either package is verified against the other's plan.  The digest hashes
the plan's static sizes and its count arrays (their dtypes included), so
the port's ``CommPlan`` keeps the reference's dtypes for those fields
(``tests/test_torch_plan.py``).  The recorder itself (manifest, event
stream, heartbeats) is not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import hashlib


def plan_digest(plan) -> str:
    """Stable 16-hex digest of a CommPlan's comm structure — enough to tell
    "same partition/layout" apart across runs without storing the arrays."""
    h = hashlib.sha256()
    h.update(repr((plan.n, plan.k, plan.b, plan.s, plan.r, plan.e,
                   bool(plan.symmetric), tuple(plan.ell_buckets))).encode())
    for arr in (plan.send_counts, plan.halo_counts, plan.nnz,
                plan.part_sizes):
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def plan_manifest_block(plan) -> dict:
    """The plan's sizes, per-exchange volumes and digest as one dict (the
    reference's manifest ``plan`` block)."""
    return {
        "n": int(plan.n), "k": int(plan.k), "b": int(plan.b),
        "s": int(plan.s), "r": int(plan.r), "e": int(plan.e),
        "symmetric": bool(plan.symmetric),
        "send_rows_per_exchange": int(plan.predicted_send_volume.sum()),
        "messages_per_exchange": int(plan.predicted_message_count.sum()),
        "digest": plan_digest(plan),
    }
