from .oracle import DenseOracle

__all__ = ["DenseOracle"]
