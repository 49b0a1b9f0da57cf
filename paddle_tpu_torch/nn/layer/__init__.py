from .common import Dropout, Embedding, Linear  # noqa: F401
from .norm import LayerNorm  # noqa: F401
from .transformer import (LayerList, MultiHeadAttention,  # noqa: F401
                          Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)
