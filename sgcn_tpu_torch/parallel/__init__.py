from .plan import CommPlan, build_comm_plan

__all__ = ["CommPlan", "build_comm_plan"]
