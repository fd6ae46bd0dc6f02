"""Stochastic hypergraph partitioning (port of ``sgcn_tpu/shp``)."""

from .model import (
    communication_volume,
    generate_stochastic_hypergraph,
    run_shp,
    sample_sparse_submatrix,
    simulate,
)

__all__ = [
    "communication_volume", "generate_stochastic_hypergraph", "run_shp",
    "sample_sparse_submatrix", "simulate",
]
