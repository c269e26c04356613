from .laplacian import (adjacency_dense_np, dense_adjacency_from_graph,
                        sym_laplacian_dense, sym_laplacian_np,
                        unnormalized_laplacian_dense,
                        unnormalized_laplacian_np)
from .projectors import (EigenspaceLayout, eigenspace_layout,
                         projectors_by_multiplicity, prop_higher_mult,
                         round_eigvals)
from .eigh import (PAD_EIGVAL, batched_masked_eigh, canonical_sign,
                   canonical_sign_np, eigh_np, full_evd_np, lap_pe_np,
                   masked_eigh, rwpe_np)
