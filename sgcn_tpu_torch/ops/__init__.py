from .pspmm import (exchange_recv, halo_exchange, ragged_live_rounds,
                    ring_concat)
from .row_shuffle import row_pack
from .tile_spmm import (PspmmTilesRagged, PspmmTilesSym, gat_tiles_pass,
                        pspmm_tiles_ragged, pspmm_tiles_sym, spmm_tiles,
                        spmm_tiles_classes, spmm_tiles_fused,
                        spmm_tiles_plain)

__all__ = ["PspmmTilesRagged", "PspmmTilesSym", "exchange_recv",
           "gat_tiles_pass", "halo_exchange", "pspmm_tiles_ragged",
           "pspmm_tiles_sym", "ragged_live_rounds", "ring_concat",
           "row_pack", "spmm_tiles", "spmm_tiles_classes",
           "spmm_tiles_fused", "spmm_tiles_plain"]
