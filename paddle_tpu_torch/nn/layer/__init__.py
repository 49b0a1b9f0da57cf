from .activation import (CELU, ELU, GELU, SELU, Hardshrink,  # noqa: F401
                         Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                         LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU,
                         ReLU6, Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .common import (Dropout, Embedding, Flatten, Identity,  # noqa: F401
                     Linear)
from .container import LayerList, Sequential  # noqa: F401
from .conv import Conv2D  # noqa: F401
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, LayerNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool2D, AdaptiveMaxPool2D,  # noqa: F401
                      AvgPool2D, MaxPool2D)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
