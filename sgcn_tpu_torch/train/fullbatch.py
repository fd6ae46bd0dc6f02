"""Forward setup shared by the serve engine and, in the next slice, the
full-batch trainer (port of ``ForwardSetup``/``resolve_forward_setup`` of
``sgcn_tpu/train/fullbatch.py``).

Only the GCN / dense-a2a / tile-kernel selection is ported.  What the
reference resolves beyond it raises a clear "not ported yet" error: GAT,
the ragged ring and asymmetric plans (``pspmm_overlap``); bf16 tables
are refused by the kernel wrapper.  Stale halos and replicas have no
entry here at all.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.gcn import gcn_forward_local, init_gcn_params
from ..ops.tile_spmm import TILE_PLAN_FIELDS, choose_tile_dispatch


@dataclass
class ForwardSetup:
    """Resolved forward configuration: the plan fields the forward reads,
    its static kwargs, and the selection log."""

    model: str
    comm_schedule: str            # resolved: 'a2a'
    plan_fields: tuple            # CommPlan array fields the forward reads
    fwd_static: dict              # static kwargs of the forward fn
    forward_fn: object            # stacked forward
    init_fn: object               # param init
    decision: dict                # selection log

    def ship_arrays(self, plan, device) -> dict:
        """The plan arrays the forward consumes, as tensors on ``device``
        (integer arrays stay int32, the kernel's stored form)."""
        return {f: torch.as_tensor(np.ascontiguousarray(getattr(plan, f)))
                .to(device) for f in self.plan_fields}


def resolve_forward_setup(plan, model: str = "gcn",
                          comm_schedule: str | None = None) -> ForwardSetup:
    """Resolve the ported subset: GCN on a symmetric plan over the dense
    a2a exchange, every tile class on the tile kernel
    (``choose_tile_dispatch``, tile height 256).  Builds the plan's tile
    layout as a side effect, as the reference does.  The reference's
    ``fin``/``widths`` fed its VMEM-fit rule, which is not carried."""
    if model != "gcn":
        raise NotImplementedError(
            f"model {model!r} is not ported yet (GCN only; GAT is "
            "ROADMAP item A5)")
    if comm_schedule not in (None, "a2a"):
        raise NotImplementedError(
            f"comm_schedule {comm_schedule!r} is not ported yet (dense a2a "
            "only; the ragged ring is ROADMAP item A4)")
    if not plan.symmetric:
        raise NotImplementedError(
            "asymmetric plans need pspmm_overlap, which is not ported yet "
            "(ROADMAP item A2); this port serves symmetric Â")
    decision: dict = {"asked": comm_schedule, "resolved": "a2a",
                      "rule": "only transport ported"}
    fwd_static = choose_tile_dispatch(plan, decision=decision)
    return ForwardSetup(model=model, comm_schedule="a2a",
                        plan_fields=TILE_PLAN_FIELDS, fwd_static=fwd_static,
                        forward_fn=gcn_forward_local,
                        init_fn=init_gcn_params, decision=decision)
