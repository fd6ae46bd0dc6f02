from .fullbatch import ForwardSetup, resolve_forward_setup

__all__ = ["ForwardSetup", "resolve_forward_setup"]
