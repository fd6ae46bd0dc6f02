from .gat_oracle import DenseGATOracle
from .oracle import DenseOracle

__all__ = ["DenseGATOracle", "DenseOracle"]
