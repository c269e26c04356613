from .conv import (GatedGCNLSPELayer, GINConv, GraphTransformerAttention,
                   GraphTransformerLayer, neighbor_sum, node_mask_like,
                   pool_any)
from .pe import apply_lap_method
from .signnet import (GINDeepSigns, KChannelGNN, MaskedGINDeepSigns,
                      sign_fuse, sign_unfuse)
from .zinc_models import (GINNet, TransformerNet, ZincNet, gnn_model,
                          lapeig_loss, normalize_p, sign_inv_module)
