from .normalize import normalize_adjacency

__all__ = ["normalize_adjacency"]
