from .gcn import (GCN, exchange_widths, gcn_forward_local, init_gcn_params,
                  masked_accuracy_local, masked_err_local,
                  masked_sigmoid_bce_local, masked_softmax_xent_local,
                  params_from_jax)

__all__ = ["GCN", "exchange_widths", "gcn_forward_local", "init_gcn_params",
           "masked_accuracy_local", "masked_err_local",
           "masked_sigmoid_bce_local", "masked_softmax_xent_local",
           "params_from_jax"]
