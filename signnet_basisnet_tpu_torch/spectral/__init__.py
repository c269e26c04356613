from .laplacian import (adjacency_dense_np, sym_laplacian_np,
                        unnormalized_laplacian_np)
from .projectors import (EigenspaceLayout, eigenspace_layout,
                         projectors_by_multiplicity, prop_higher_mult,
                         round_eigvals)
from .eigh import (canonical_sign_np, eigh_np, full_evd_np, lap_pe_np,
                   rwpe_np)
