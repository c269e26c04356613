from .init import Embedding, Linear, init_parameters
from .deepsets import EqDeepSetsEncoder
from .encoders import DiscreteEncoder
from .ign import (BasicEquivariantLayer, EquivariantLayer, IGN2to1,
                  contractions_1_to_1, contractions_1_to_2,
                  contractions_2_to_1, contractions_2_to_2)
from .mlp import MLP, ElementsMLP, MaskedMLP, MLPReadout, MLPReadout2
from .norm import MaskedBatchNorm, MaskedLayerNorm
from .set2set import GRUStep, LSTMCell, S2SReadout, Set2Set
from .set_transformer import (MultiHeadAttention, PositionalEncoding,
                              PositionwiseFeedForward, SetTransformer,
                              TransformerEncoderLayer)
