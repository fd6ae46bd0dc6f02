"""Analytic per-step cost attribution — plan-derived FLOPs, bytes, roofline
(port of ``sgcn_tpu/obs/attribution.py``).

One home for every "how fast SHOULD this step be" number, derived from the
``CommPlan``'s exact padded layout at the per-layer exchanged widths
(``models.gcn.exchange_widths`` — the trainer's project-first rule): the
recorder's step events and ``scripts/obs_report.py`` attribute measured
step time against the SAME model.  The functions are the reference's,
field for field; only the two ceilings are the card's:

  * **gather bytes** — what the row gathers move.  ``achieved_gather_GBs
    / STREAM_CEILING_GBS`` is the MFU-analogue for this gather-bound
    workload.
  * **FLOPs** — per-layer SpMM (2·nnz·f) and dense projection
    (2·B·fin·fout) at the layer's true aggregation width, forward +
    backward (backward ≈ 2× the dense forward — dX and dW — plus one more
    SpMM pass under the symmetric custom VJP).
  * **halo bytes** — TWO figures per exchange: ``halo_bytes_true`` from the
    plan's predicted send volume (Σ(λ−1)) and ``halo_bytes_wire`` from what
    the SELECTED schedule ships — ``k²·S·f·itemsize`` for the dense a2a,
    ``Σ_d k·S_d·f·itemsize`` for the ragged ring — at the wire dtype, per
    step from the exchange count (2·L: forward + backward), with a
    PER-DIRECTION itemsize split when the two directions ride different
    dtypes (see ``step_cost``).

The model is the reference's PER-CHIP step (one part's program); the port
stacks all ``k`` parts on one device, which runs ``k`` parts' gathers and
FLOPs in one step, so a stacked step is joined against
``stacked_cost(cost, k)`` (the halo bytes are global figures already).
The trainer books it only where the reference does: on the ELL
aggregator's steps (``SGCN_PALLAS_SPMM=0``), never on the tile kernel's.
A rank of a rank group books its own step, ``stacked_cost(cost, 1)``:
the full plan's per-chip figures and its slice's halo bytes
(``step_cost(..., halo_plan=slice)``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

# The card's achievable HBM stream rate, the denominator of the
# gather-utilization figure (the reference's ``STREAM_CEILING_GBS`` = 655,
# a TPU v5e measurement, is not carried): the lower end of the 2488-2529
# GB/s that ``tools/spmm_micro.py``'s streaming probe measured on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §5; ``chip_smoke.py`` phase 13
# re-measures it on every run).
STREAM_CEILING_GBS = 2488.0

# The serialization rate one wire byte pays in the analytic exchange
# model, in place of the reference's ``ICI_CEILING_GBS`` (50, a TPU v5e
# ICI link): NVLink 4 on an H100 SXM, 900 GB/s in both directions
# together, so 450 GB/s each way — a DATASHEET figure, not a measured
# one (one card has no link to measure; the ``exchange`` join of
# ``measured_vs_model`` shows how far a run lands from it).
LINK_CEILING_GBS = 450.0


def _exchange_gather_rows(plan, comm_schedule: str = "a2a") -> int:
    """Per-chip rows the SELECTED transport's exchange machinery gathers
    per exchange direction.  The dense a2a gathers the whole padded
    ``(k, S)`` send buffer and then the ``R``-row halo table out of the
    receive buffer; the ragged ring gathers only its per-round send
    buffers (``Σ_d S_d`` rows) and SCATTERS receives (``.set`` — no
    halo-table gather), so charging the dense figure to a ragged run would
    overstate the stream by exactly the padded rows the ring deletes.
    The send buffer has a bucket for each of the ``k`` peers
    (``send_idx``'s second axis: a one-part slice keeps them all)."""
    if comm_schedule == "ragged":
        sizes = (plan.rr_sizes if plan.rr_sizes is not None
                 else plan.ragged_round_sizes())
        return int(sum(sizes))
    peers = int(plan.send_idx.shape[1])
    return int(peers * plan.s + plan.r)


def gather_bytes_per_epoch(plan, fin: int, widths,
                           itemsize: int = 4,
                           comm_schedule: str = "a2a") -> int:
    """Bytes the epoch's row gathers move (fwd + symmetric bwd), from the
    plan's padded layout — the numerator of the roofline figure.

    Counts the gather streams only (ELL slots, hub tails, halo-src edges,
    and the selected transport's exchange gathers —
    ``_exchange_gather_rows``), at the aggregation width of each layer
    (``models/gcn.py::exchange_widths`` — the trainer's project-first
    rule).  Accumulate-side traffic is deliberately excluded: the metric
    is 'how fast are the gathers running', matching the measured stream
    ceiling denominator (``STREAM_CEILING_GBS``).
    """
    from ..models.gcn import exchange_widths
    ell_slots = sum(nb * wb for nb, wb in plan.ell_buckets)
    rows = ell_slots + plan.tl          # local ELL + tail
    rows += plan.eh                     # halo-src edge gathers
    rows += _exchange_gather_rows(plan, comm_schedule)
    return int(2 * rows * itemsize * sum(exchange_widths(fin, widths)))


@dataclass
class StepCostModel:
    """Analytic cost of ONE full-batch training step on one chip.

    Per-chip figures (plan arrays are padded identically across chips, so
    one chip's program is every chip's program; multiply by ``k`` for
    global totals — except ``halo_send_rows``, which is already the global
    per-exchange row count Σ(λ−1))."""

    nlayers: int
    widths: list            # exchanged/aggregated width per layer (lanes)
    spmm_flops: int         # fwd SpMM FLOPs per chip (all layers)
    dense_flops: int        # fwd dense-projection FLOPs per chip
    step_flops: int         # fwd+bwd total per chip (2·spmm + 3·dense)
    gather_bytes: int       # fwd+bwd gather-stream bytes per chip
    halo_send_rows: int     # global TRUE boundary rows per exchange
    #                         (Σ(λ−1))
    halo_bytes_per_exchange: int   # global TRUE bytes per exchange (legacy
    #                                name; == the Σ(λ−1) volume)
    halo_bytes_per_step: int       # 2·L exchanges per training step (true)
    per_layer: list = field(default_factory=list)  # [{width, spmm_flops,
    #   dense_flops, halo_bytes, halo_bytes_true, halo_bytes_wire}] — the
    #   attribution table obs_report renders
    # padded-vs-true split of the selected exchange schedule
    comm_schedule: str = "a2a"
    halo_wire_rows: int = 0        # padded rows per exchange on the wire
    padding_efficiency: float = 1.0  # halo_send_rows / halo_wire_rows
    halo_bytes_true_per_step: int = 0   # == halo_bytes_per_step (explicit)
    halo_bytes_wire_per_step: int = 0   # what the schedule ships per step


def step_cost(plan, fin: int, widths, compute_dtype: str | None = None,
              wire_itemsize=None,
              comm_schedule: str = "a2a",
              model: str = "gcn",
              replica: bool = False,
              halo_plan=None) -> StepCostModel:
    """Build the cost model for one (plan, layer-stack) pair.

    ``compute_dtype='bfloat16'`` halves the gather/wire itemsize (the
    packed bf16 path); ``wire_itemsize`` overrides the wire bytes alone
    (the ``--halo-dtype bfloat16`` wire-only lever).  It takes either one
    int for BOTH exchange directions, or a ``(fwd, bwd)`` pair (entries
    ``None`` = the compute itemsize) — the PER-STEP itemsize split: under
    ``--halo-delta`` the feature wire is bf16 on stale steps and full f32
    on re-base sync steps while the gradient wire follows ``--halo-dtype``,
    so the trainer builds one cost model per step kind and a single
    blended number would misstate both directions.  ``comm_schedule``
    selects the wire-byte model: the plan's TRUE volume (Σ(λ−1)) is
    schedule-independent, but the shipped bytes are the schedule's padded
    buffer — ``plan.wire_rows_per_exchange(schedule)``.

    ``model='gat'`` switches every per-layer width to the GAT exchange's
    REAL table lanes (``models.gat.gat_exchange_lane_widths``: fused
    ``fout+1``, packed-bf16 ``fout/2+1``, split pair ``fout+1`` across its
    buffers — all in f32-lane equivalents, so the itemsize stays 4 and
    narrow dtypes are encoded in the lane count), the SpMM term to the
    combined-edge num/den slot passes (one fused gather-accumulate per
    combined slot and tail edge, at the table width), and the gather-stream
    model to the combined layout (slot + tail table gathers plus the
    exchange's send/halo gathers).  Wire accounting is therefore the same
    figure CommStats' lane-weighted gauges report — the parity the
    reconciliation smokes pin (``wire_itemsize`` is ignored for GAT; its
    wire levers are the table forms themselves).

    ``replica=True`` prices the hot-halo-replication REPLICA step
    (``--replica-budget``): the exchange ships the
    shrunken ``nrep_*`` layout, so BOTH the true volume (replicated rows
    genuinely leave the exchange — ``plan.replica_send_volume``) and the
    wire rows (``plan.wire_rows_per_exchange(..., replica=True)``)
    shrink; refresh steps use the default full model.  GCN only (the
    trainer gates replication to it).

    ``halo_plan`` (default ``plan``) gives the halo figures alone — the
    true and wire rows per exchange — while ``plan`` gives the per-chip
    FLOPs and gather bytes: a rank prices its step with the full plan's
    per-chip figures and its slice's own exchange
    (``parallel/proxy.py``), what its ``CommStats`` counts.  On a
    one-part slice as ``plan`` the per-chip figures are the part's: its
    own true nnz, where the reference's per-chip figure takes the parts'
    maximum."""
    if halo_plan is None:
        halo_plan = plan
    if model == "gat":
        from ..models.gat import gat_exchange_lane_widths
        plan.ensure_cell()
        fs = gat_exchange_lane_widths(list(widths), compute_dtype)
        itemsize = 4                    # lanes are f32 equivalents
        wire_f = wire_bwd = 4
        # combined-edge work per layer: bucketed slots + hub tail
        nnz = sum(nb * wb for nb, wb in plan.cell_buckets) + int(plan.ctl)
    else:
        from ..models.gcn import exchange_widths
        itemsize = 2 if compute_dtype == "bfloat16" else 4
        if wire_itemsize is None:
            wire_f = wire_bwd = itemsize
        elif isinstance(wire_itemsize, (tuple, list)):
            wire_f, wire_bwd = (itemsize if x is None else int(x)
                                for x in wire_itemsize)
        else:
            wire_f = wire_bwd = int(wire_itemsize)
        fs = exchange_widths(fin, list(widths))
        nnz = int(plan.nnz.max()) if plan.nnz.size else 0
    dims = list(zip([fin] + list(widths)[:-1], widths))
    b = plan.b
    if replica:
        if model == "gat":
            raise ValueError("replica pricing is a GCN-trainer lever")
        send_rows = int(halo_plan.replica_send_volume.sum())
        wire_rows = int(halo_plan.wire_rows_per_exchange(comm_schedule,
                                                         replica=True))
    else:
        send_rows = int(halo_plan.predicted_send_volume.sum())
        wire_rows = int(halo_plan.wire_rows_per_exchange(comm_schedule))

    # per-layer bytes are PER EXCHANGE at the mean of the two directions'
    # itemsizes, so 2L × per-layer == the per-step totals exactly (the
    # split values are 2/4, whose sum is always even)
    per_layer, spmm_f, dense_f = [], 0, 0
    true_step = wire_step = 0
    for (fi, fo), w in zip(dims, fs):
        lf_spmm = 2 * nnz * w           # one multiply-add per (edge, lane)
        lf_dense = 2 * b * fi * fo
        hb2 = send_rows * w * (wire_f + wire_bwd)    # fwd + bwd of layer w
        hbw2 = wire_rows * w * (wire_f + wire_bwd)
        per_layer.append({"width": int(w), "spmm_flops": int(lf_spmm),
                          "dense_flops": int(lf_dense),
                          "halo_bytes": int(hb2 // 2),
                          "halo_bytes_true": int(hb2 // 2),
                          "halo_bytes_wire": int(hbw2 // 2)})
        spmm_f += lf_spmm
        dense_f += lf_dense
        true_step += hb2
        wire_step += hbw2
    halo_per_ex = sum(pl["halo_bytes"] for pl in per_layer) // max(
        len(per_layer), 1)
    true_step = int(true_step)
    wire_step = int(wire_step)
    if model == "gat":
        # fwd + bwd table-gather streams: per layer, one gathered row per
        # combined slot/tail edge plus the SELECTED transport's exchange
        # gathers (dense: send buffer + halo table; ragged: per-round send
        # buffers only — receives scatter), at that layer's table width
        rows = nnz + _exchange_gather_rows(plan, comm_schedule)
        gather_b = int(2 * rows * 4 * sum(fs))
    else:
        gather_b = int(gather_bytes_per_epoch(plan, fin, widths,
                                              itemsize=itemsize,
                                              comm_schedule=comm_schedule))
    return StepCostModel(
        nlayers=len(widths),
        widths=[int(w) for w in fs],
        spmm_flops=int(spmm_f),
        dense_flops=int(dense_f),
        # symmetric bwd = one more SpMM pass; dense bwd = dX + dW ≈ 2× fwd
        step_flops=int(2 * spmm_f + 3 * dense_f),
        gather_bytes=gather_b,
        halo_send_rows=send_rows,
        halo_bytes_per_exchange=int(halo_per_ex),
        halo_bytes_per_step=true_step,
        per_layer=per_layer,
        comm_schedule=comm_schedule,
        halo_wire_rows=wire_rows,
        padding_efficiency=(send_rows / wire_rows if wire_rows else 1.0),
        halo_bytes_true_per_step=true_step,
        halo_bytes_wire_per_step=wire_step,
    )


def forward_flops(plan, fin: int, widths, model: str = "gcn") -> int:
    """Analytic FLOPs of ONE full partitioned forward over all ``k`` parts
    (inference: no backward, no optimizer) — the denominator of the
    sub-graph serving A/B.  Reuses ``step_cost``'s per-chip SpMM/dense
    models at the padded layout, ×k."""
    cost = step_cost(plan, fin, widths, model=model)
    return int(plan.k * (cost.spmm_flops + cost.dense_flops))


def subgraph_batch_flops(touched_rows: int, recipe_edges: int, fin: int,
                         widths, model: str = "gcn") -> int:
    """Analytic FLOPs of ONE sub-graph serving batch (``serve/subgraph.py``)
    at its TRUE receptive-set size: per layer, one multiply-add per
    (recipe edge, lane) at the layer's aggregation width plus the dense
    projection over the touched rows — the same per-(edge, lane) /
    per-(row, fin, fout) vocabulary as ``step_cost``, so the A/B ratio
    against ``forward_flops`` compares like with like.  Deterministic in
    (graph, queries)."""
    touched_rows = int(touched_rows)
    recipe_edges = int(recipe_edges)
    dims = list(zip([fin] + list(widths)[:-1], widths))
    total = 0
    if model == "gat":
        for fi, fo in dims:
            # z = h·w, the score projection, and the (fout+1)-lane num/den
            # gather-macs per combined edge
            total += 2 * touched_rows * (fi * fo + fo)
            total += 2 * recipe_edges * (fo + 1)
    else:
        from ..models.gcn import exchange_widths
        for (fi, fo), w in zip(dims, exchange_widths(fin, list(widths))):
            total += 2 * touched_rows * fi * fo
            total += 2 * recipe_edges * w
    return int(total)


def add_partial_refresh(cost: StepCostModel, refresh_rows,
                        wire_rows: int, itemsize_fwd: int,
                        itemsize_bwd: int) -> StepCostModel:
    """Price one ``--refresh-band`` PARTIAL refresh step: the shrunken
    replica-step cost (``step_cost(..., replica=True)`` — pass that model
    in) plus the replica-only side channel at the step's ACTUAL per-layer
    shipped rows.  The byte arithmetic is the SAME formula
    ``CommStats.count_partial_refresh_step`` accumulates (value lanes per
    direction; the gradient side channel's 0/1 indicator adds one
    f32-equivalent lane to its wire bytes), so the per-step roofline event
    and the cumulative gauges reconcile exactly.  Returns a new model;
    the input is not mutated."""
    refresh_rows = [int(x) for x in refresh_rows]
    if len(refresh_rows) != len(cost.widths):
        raise ValueError(
            f"add_partial_refresh: {len(refresh_rows)} per-layer counts "
            f"for {len(cost.widths)} layers")
    true_extra = wire_extra = 0
    per_layer = []
    for pl, rows, w in zip(cost.per_layer, refresh_rows, cost.widths):
        t = rows * w * (itemsize_fwd + itemsize_bwd)
        wi = int(wire_rows) * (w * itemsize_fwd + (w + 1) * itemsize_bwd)
        true_extra += t
        wire_extra += wi
        per_layer.append(dict(pl,
                              halo_bytes=pl["halo_bytes"] + t // 2,
                              halo_bytes_true=pl["halo_bytes_true"] + t // 2,
                              halo_bytes_wire=pl["halo_bytes_wire"]
                              + wi // 2))
    return replace(
        cost,
        per_layer=per_layer,
        halo_bytes_per_step=cost.halo_bytes_per_step + true_extra,
        halo_bytes_true_per_step=cost.halo_bytes_true_per_step + true_extra,
        halo_bytes_wire_per_step=cost.halo_bytes_wire_per_step + wire_extra,
    )


def roofline_fields(cost: StepCostModel, wall_s: float,
                    exchanges: int = 0, exposed_exchanges: int = 0) -> dict:
    """Join the analytic cost against ONE measured step time.

    ``exchanges`` / ``exposed_exchanges`` are the step's exchange counts
    (from ``CommStats``); ``exposed_comm_frac`` is the fraction of this
    step's wire traffic that sat on the critical path — 1.0 in exact mode,
    0.0 for a fully pipelined stale step, in between for a mixed window.
    """
    def sig(x, n=4):
        # significant digits, not fixed decimals: a CPU-smoke step is
        # micro-scale and a fixed round would collapse it to 0.0
        return float(f"{x:.{n}g}")

    wall_s = max(float(wall_s), 1e-12)
    out = {
        "gather_GB": sig(cost.gather_bytes / 1e9, 6),
        "achieved_gather_GBs": sig(cost.gather_bytes / wall_s / 1e9),
        "stream_ceiling_frac": sig(
            cost.gather_bytes / wall_s / 1e9 / STREAM_CEILING_GBS),
        "model_step_GFLOP": sig(cost.step_flops / 1e9, 6),
        "achieved_GFLOPs": sig(cost.step_flops / wall_s / 1e9),
        "halo_bytes_per_step": cost.halo_bytes_per_step,
        # the padded-vs-true wire split (schema.ROOFLINE_WIRE_KEYS):
        # *_true is the Σ(λ−1) volume the partitioner optimizes, *_wire the
        # selected schedule's shipped bytes — these must reconcile EXACTLY
        # with CommStats' wire_rows/padding_efficiency gauges
        "comm_schedule": cost.comm_schedule,
        "halo_bytes_true_per_step": cost.halo_bytes_true_per_step,
        "halo_bytes_wire_per_step": cost.halo_bytes_wire_per_step,
        "halo_wire_rows_per_exchange": cost.halo_wire_rows,
        "padding_efficiency": cost.padding_efficiency,
    }
    if exchanges > 0:
        out["exposed_comm_frac"] = round(exposed_exchanges / exchanges, 6)
        # exposed bytes charge the WIRE volume: a padded schedule's dead
        # slots cross the link and sit on the critical path like any other byte
        # (the pre-ragged model charged Σ(λ−1) and under-counted exactly
        # the padding a schedule should be judged on)
        out["exposed_halo_bytes"] = int(
            cost.halo_bytes_wire_per_step * exposed_exchanges / exchanges)
    return out


def stacked_cost(cost: StepCostModel, parts: int) -> StepCostModel:
    """The device's cost of a step that runs ``parts`` parts stacked on
    one device (the port's layout): every per-chip figure — gather bytes
    and FLOPs — times ``parts``; the halo bytes are already global.
    ``parts = 1`` (a one-part slice, or the reference's one chip) returns
    ``cost``."""
    parts = int(parts)
    if parts == 1:
        return cost
    return replace(cost, spmm_flops=cost.spmm_flops * parts,
                   dense_flops=cost.dense_flops * parts,
                   step_flops=cost.step_flops * parts,
                   gather_bytes=cost.gather_bytes * parts)
