from .emit import read_partvec, read_partvec_pickle
from .random_part import balanced_random_partition

__all__ = ["balanced_random_partition", "read_partvec", "read_partvec_pickle"]
