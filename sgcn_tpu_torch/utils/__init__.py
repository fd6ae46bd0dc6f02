from .backend import resolve_device
from .timers import PhaseTimer

__all__ = ["PhaseTimer", "resolve_device"]
