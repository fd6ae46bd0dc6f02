from .launch import (DistributedContext, global_mesh_1d, init_distributed,
                     slurm_rendezvous_env)
from .mesh import RankGroup, init_rank_group
from .plan import (CommPlan, build_comm_plan, relabel_plan,
                   resolve_comm_schedule)
from .proxy import shard_proxy_data, shard_proxy_plan

__all__ = ["CommPlan", "DistributedContext", "RankGroup", "build_comm_plan",
           "global_mesh_1d", "init_distributed", "init_rank_group",
           "relabel_plan", "resolve_comm_schedule", "shard_proxy_data",
           "shard_proxy_plan", "slurm_rendezvous_env"]
