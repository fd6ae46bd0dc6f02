"""Serving subsystem of the port: full-forward partitioned inference.

``ServeEngine`` runs the stacked partitioned GCN forward per micro-batch,
``VertexRouter`` maps query vertex ids to owning parts, ``MicroBatcher``
batches against a latency budget, and ``loadgen`` drives synthetic
open/closed-loop traffic.  CLI: ``python -m sgcn_tpu_torch.serve``.
"""

from .batcher import MicroBatcher, Pending, default_buckets
from .engine import SERVE_STAGES, InFlightBatch, ServeEngine
from .loadgen import ServeResult, run_loadgen, synthetic_query_ids
from .router import SERVE_ROUTER_FIELDS, VertexRouter

__all__ = [
    "InFlightBatch", "MicroBatcher", "Pending", "SERVE_ROUTER_FIELDS",
    "SERVE_STAGES", "ServeEngine", "ServeResult", "VertexRouter",
    "default_buckets", "run_loadgen", "synthetic_query_ids",
]
