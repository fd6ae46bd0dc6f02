from .emit import (
    read_buff, read_conn, read_partvec, read_partvec_pickle,
    write_partvec, write_partvec_pickle, write_rank_files,
)
from .native import (cache_aware_km1, partition_graph,
                     partition_hypergraph_colnet,
                     partition_hypergraph_colnet_cache)
from .random_part import balanced_random_partition, random_partition

__all__ = [
    "random_partition", "balanced_random_partition",
    "partition_graph", "partition_hypergraph_colnet",
    "partition_hypergraph_colnet_cache", "cache_aware_km1",
    "read_buff", "read_conn", "read_partvec", "read_partvec_pickle",
    "write_partvec", "write_partvec_pickle", "write_rank_files",
]
