from .mesh import RankGroup, init_rank_group
from .plan import (CommPlan, build_comm_plan, relabel_plan,
                   resolve_comm_schedule)
from .proxy import shard_proxy_data, shard_proxy_plan

__all__ = ["CommPlan", "RankGroup", "build_comm_plan", "init_rank_group",
           "relabel_plan", "resolve_comm_schedule", "shard_proxy_data",
           "shard_proxy_plan"]
