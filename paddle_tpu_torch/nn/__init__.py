from . import clip  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import (Dropout, Embedding, LayerList,  # noqa: F401
                    LayerNorm, Linear, MultiHeadAttention, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)
