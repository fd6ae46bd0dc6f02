from .gcn import (GCN, exchange_widths, gcn_forward_local, init_gcn_params,
                  params_from_jax)

__all__ = ["GCN", "exchange_widths", "gcn_forward_local", "init_gcn_params",
           "params_from_jax"]
