from .config import ModelConfig, read_config, write_config
from .mtx import read_dense_features, read_mtx, read_onehot_labels, write_mtx

__all__ = ["ModelConfig", "read_config", "read_dense_features", "read_mtx",
           "read_onehot_labels", "write_config", "write_mtx"]
