"""Analytic FLOP counts of serving (the slice of
``sgcn_tpu/obs/attribution.py`` the sub-graph mode reports).

``forward_flops`` prices one full partitioned forward, ``subgraph_batch_flops``
one sub-graph batch at its true receptive-set size, in the same
per-(edge, lane) and per-(row, fin, fout) vocabulary, so their ratio
compares like with like.  The rest of the reference's module (the step
cost model, gather bytes, the roofline) is ROADMAP A10.
"""

from __future__ import annotations


def forward_flops(plan, fin: int, widths, model: str = "gcn") -> int:
    """FLOPs of ONE full partitioned forward over all ``k`` parts at the
    plan's padded layout: per layer one multiply-add per (edge slot, lane)
    at the aggregated width and the dense projection over the ``B`` rows,
    times ``k`` (the reference's ``k · (spmm_flops + dense_flops)`` of
    ``step_cost``).  GCN's edges are the largest part's nnz at the
    project-first widths; GAT's the combined layout's bucketed slots plus
    its tail, at ``fout + 1`` lanes."""
    widths = list(widths)
    dims = list(zip([fin] + widths[:-1], widths))
    if model == "gat":
        plan.ensure_cell()
        lanes = [fout + 1 for fout in widths]
        nnz = sum(nb * wb for nb, wb in plan.cell_buckets) + int(plan.ctl)
    else:
        from ..models.gcn import exchange_widths
        lanes = exchange_widths(fin, widths)
        nnz = int(plan.nnz.max()) if plan.nnz.size else 0
    spmm = sum(2 * nnz * w for w in lanes)
    dense = sum(2 * plan.b * fi * fo for fi, fo in dims)
    return int(plan.k * (spmm + dense))


def subgraph_batch_flops(touched_rows: int, recipe_edges: int, fin: int,
                         widths, model: str = "gcn") -> int:
    """FLOPs of ONE sub-graph serving batch at its TRUE receptive-set size:
    per layer one multiply-add per (recipe edge, lane) at the layer's
    aggregation width plus the dense projection over the touched rows (GAT:
    ``z = h·w``, the score projection and ``fout + 1`` lanes per edge)."""
    touched_rows = int(touched_rows)
    recipe_edges = int(recipe_edges)
    dims = list(zip([fin] + list(widths)[:-1], widths))
    total = 0
    if model == "gat":
        for fi, fo in dims:
            total += 2 * touched_rows * (fi * fo + fo)
            total += 2 * recipe_edges * (fo + 1)
    else:
        from ..models.gcn import exchange_widths
        for (fi, fo), w in zip(dims, exchange_widths(fin, list(widths))):
            total += 2 * touched_rows * fi * fo
            total += 2 * recipe_edges * w
    return int(total)
