from .backend import resolve_device
from .timers import PhaseTimer, SpanTimer

__all__ = ["PhaseTimer", "SpanTimer", "resolve_device"]
