"""Serving subsystem of the port: partitioned inference, full-forward or
sub-graph.

``ServeEngine`` runs the stacked partitioned GCN or GAT forward per
micro-batch, or (``mode='subgraph'``) only the routed queries' L-hop
receptive rows (``SubgraphIndex``, ``build_batch``),
``VertexRouter`` maps query vertex ids to owning parts, ``MicroBatcher``
batches against a latency budget, and ``loadgen`` drives synthetic
open/closed-loop traffic.  CLI: ``python -m sgcn_tpu_torch.serve``.
"""

from .batcher import MicroBatcher, Pending, default_buckets, pad_pow2
from .engine import SERVE_STAGES, InFlightBatch, ServeEngine
from .loadgen import ServeResult, run_loadgen, synthetic_query_ids
from .router import SERVE_ROUTER_FIELDS, VertexRouter
from .subgraph import SubgraphBatch, SubgraphIndex, build_batch

__all__ = [
    "InFlightBatch", "MicroBatcher", "Pending", "SERVE_ROUTER_FIELDS",
    "SERVE_STAGES", "ServeEngine", "ServeResult", "SubgraphBatch",
    "SubgraphIndex", "VertexRouter", "build_batch", "default_buckets",
    "pad_pow2", "run_loadgen", "synthetic_query_ids",
]
