from .init import Embedding, Linear, init_parameters
from .encoders import DiscreteEncoder
from .mlp import MLP, ElementsMLP, MaskedMLP, MLPReadout
from .norm import MaskedBatchNorm, MaskedLayerNorm
from .set2set import GRUStep, LSTMCell, S2SReadout, Set2Set
from .set_transformer import (MultiHeadAttention, PositionalEncoding,
                              PositionwiseFeedForward, SetTransformer,
                              TransformerEncoderLayer)
