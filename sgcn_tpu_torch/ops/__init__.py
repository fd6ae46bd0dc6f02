from .pspmm import halo_exchange, ragged_live_rounds, ring_concat
from .tile_spmm import (PspmmTilesRagged, PspmmTilesSym, gat_tiles_pass,
                        pspmm_tiles_ragged, pspmm_tiles_sym, spmm_tiles,
                        spmm_tiles_classes, spmm_tiles_plain)

__all__ = ["PspmmTilesRagged", "PspmmTilesSym", "gat_tiles_pass",
           "halo_exchange", "pspmm_tiles_ragged", "pspmm_tiles_sym",
           "ragged_live_rounds", "ring_concat", "spmm_tiles",
           "spmm_tiles_classes", "spmm_tiles_plain"]
