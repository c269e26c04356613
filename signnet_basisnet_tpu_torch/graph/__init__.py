from .batch import (CSR_KEYS, GraphBatch, batch_np, dense_node_index,
                    edge_csr, from_arrays, from_dense_nodes, len_nodes,
                    tile_first_fit, to_dense_nodes)
from .dense import (DenseGraphBatch, dense_batch_np, dense_from_arrays,
                    dense_neighbor_sum, dense_pool)
from . import segment

__all__ = ["CSR_KEYS", "DenseGraphBatch", "GraphBatch", "batch_np",
           "dense_batch_np", "dense_from_arrays", "dense_neighbor_sum",
           "dense_node_index", "dense_pool", "edge_csr", "from_arrays",
           "from_dense_nodes", "len_nodes", "tile_first_fit",
           "to_dense_nodes", "segment"]
