from .conv import (GATConv, GCNConv, GatedGCNLSPELayer, GINConv,
                   GraphTransformerAttention, GraphTransformerLayer,
                   PNALayer, PNANoTowersLayer, PNATower, neighbor_sum,
                   node_mask_like, pna_aggregate, pna_scale, pool_any)
from .pe import apply_lap_method
from .signnet import (GINDeepSigns, KChannelGNN, MaskedGINDeepSigns,
                      sign_fuse, sign_unfuse)
from .zinc_models import (GATNet, GINNet, PNANet, TransformerNet, ZincNet,
                          gnn_model, lapeig_loss, normalize_p,
                          sign_inv_module)
