from .mesh import make_mesh, dp_sharding, replicated, init_distributed
from .data_parallel import build_dp_steps
from .edge_partition import (edge_sharded_aggregate, pad_edges_for,
                             partition_edges_by_dst, halo_edge_aggregate,
                             tile_aligned_aggregate)
from .gspmd import build_gspmd_steps, graphbatch_shardings
from .mp_halo import (build_mp_steps, device_arrays_mp, mp_budgets,
                      mp_exchange, mp_neighbor_sum, mp_pool_nodes,
                      partition_batch_mp, shard_arrays_mp)
