from .spmm_tiled import spmm_tiled, spmm_tiled_plain
from .tile_dense import spmm_tile_dense, tile_block_adj
