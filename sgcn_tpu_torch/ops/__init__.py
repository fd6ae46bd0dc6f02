from .pspmm import halo_exchange
from .tile_spmm import (PspmmTilesSym, gat_tiles_pass, pspmm_tiles_sym,
                        spmm_tiles, spmm_tiles_classes, spmm_tiles_plain)

__all__ = ["PspmmTilesSym", "gat_tiles_pass", "halo_exchange",
           "pspmm_tiles_sym", "spmm_tiles", "spmm_tiles_classes",
           "spmm_tiles_plain"]
