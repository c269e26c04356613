from .batch import (CSR_KEYS, GraphBatch, batch_np, edge_csr, from_arrays,
                    len_nodes, tile_first_fit)
from . import segment

__all__ = ["CSR_KEYS", "GraphBatch", "batch_np", "edge_csr",
           "from_arrays", "len_nodes", "tile_first_fit", "segment"]
