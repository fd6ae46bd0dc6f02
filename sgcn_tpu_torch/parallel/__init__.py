from .plan import CommPlan, build_comm_plan, resolve_comm_schedule

__all__ = ["CommPlan", "build_comm_plan", "resolve_comm_schedule"]
