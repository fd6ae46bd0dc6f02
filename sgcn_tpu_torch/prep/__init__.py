from .normalize import (normalize_adjacency, preprocess, synthetic_features,
                        synthetic_labels)

__all__ = ["normalize_adjacency", "preprocess", "synthetic_features",
           "synthetic_labels"]
