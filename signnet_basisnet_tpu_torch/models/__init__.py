from .baselines import GINEBondConv, NetGINE
from .basisnet import IGNBasisInv, IGNShared, basis_features
from .conv import (GATConv, GCNConv, GatedGCNLSPELayer, GINConv, GINEConv,
                   GraphTransformerAttention, GraphTransformerLayer,
                   MaskedGINConv, MaskedGINEConv, PNALayer,
                   PNANoTowersLayer, PNATower, SimplifiedPNAConv,
                   neighbor_sum, node_mask_like, pna_aggregate, pna_scale,
                   pool_any)
from .gnn import GNN, SignNetGNN, make_conv, set_attention_dropout
from .pe import apply_lap_method
from .signnet import (GNN3d, GINDeepSigns, KChannelGNN, MaskedGINDeepSigns,
                      SignNet, SignPlus, TransformerDeepSigns, sign_fuse,
                      sign_unfuse)
from .zinc_models import (GATNet, GINNet, PNANet, TransformerNet, ZincNet,
                          gnn_model, lapeig_loss, normalize_p,
                          sign_inv_module)
from . import spectral_filters
from .spectral_filters import FILTER_MODEL_REGISTRY
