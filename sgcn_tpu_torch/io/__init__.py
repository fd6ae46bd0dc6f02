from .mtx import read_dense_features, read_mtx, read_onehot_labels

__all__ = ["read_dense_features", "read_mtx", "read_onehot_labels"]
