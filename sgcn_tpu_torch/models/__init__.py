from .gat import (GAT, GatLayerSym, gat_exchange_lane_widths,
                  gat_forward_local, gat_table_form, init_gat_params)
from .gcn import (GCN, exchange_widths, gcn_forward_local, init_gcn_params,
                  masked_accuracy_local, masked_err_local,
                  masked_sigmoid_bce_local, masked_softmax_xent_local,
                  params_from_jax)

__all__ = ["GAT", "GCN", "GatLayerSym", "exchange_widths",
           "gat_exchange_lane_widths", "gat_forward_local", "gat_table_form",
           "gcn_forward_local", "init_gat_params", "init_gcn_params",
           "masked_accuracy_local", "masked_err_local",
           "masked_sigmoid_bce_local", "masked_softmax_xent_local",
           "params_from_jax"]
