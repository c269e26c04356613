from .edge_attention import (edge_attention_bwd_plain,
                             edge_softmax_attention_plain,
                             edge_softmax_attention_reference,
                             edge_softmax_attention_tiled,
                             edge_softmax_den_plain)
from .gatedgcn_gate import (gatedgcn_gate_bwd_plain, gatedgcn_gate_plain,
                            gatedgcn_gate_reference, gatedgcn_gate_tiled)
from .segment_matmul import gather_onehot, segment_sum_onehot, spmm_onehot
from .spmm_flat import (pad_edges_to, spmm_flat, spmm_flat_plain,
                        spmm_reference, tile_edge_ranges)
from .spmm_tiled import spmm_tiled, spmm_tiled_plain
from .timer_stamp import timer_stamp
from .tile_dense import spmm_tile_dense, tile_block_adj
