from .pspmm import halo_exchange
from .tile_spmm import (PspmmTilesSym, pspmm_tiles_sym, spmm_tiles,
                        spmm_tiles_classes, spmm_tiles_plain)

__all__ = ["PspmmTilesSym", "halo_exchange", "pspmm_tiles_sym", "spmm_tiles",
           "spmm_tiles_classes", "spmm_tiles_plain"]
