from .fullbatch import (LOSSES, ForwardSetup, FullBatchTrainer, TrainData,
                        make_train_data, make_train_data_multihost,
                        resolve_forward_setup)

__all__ = ["LOSSES", "ForwardSetup", "FullBatchTrainer", "TrainData",
           "make_train_data", "make_train_data_multihost",
           "resolve_forward_setup"]
