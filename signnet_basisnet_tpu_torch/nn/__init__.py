from .init import Embedding, Linear, init_parameters
from .mlp import MLP, MLPReadout
from .norm import MaskedBatchNorm, MaskedLayerNorm
from .set2set import GRUStep
