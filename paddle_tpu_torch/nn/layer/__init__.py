from .activation import (CELU, ELU, GELU, SELU, Hardshrink,  # noqa: F401
                         Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                         LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU,
                         ReLU6, Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .common import (Dropout, Embedding, Flatten, Identity,  # noqa: F401
                     Linear, ParamAttr)
from .container import LayerList, Sequential  # noqa: F401
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,  # noqa: F401
                   CrossEntropyLoss, CTCLoss, KLDivLoss, L1Loss,
                   MarginRankingLoss, MSELoss, MultiMarginLoss, NLLLoss,
                   SmoothL1Loss, SoftMarginLoss, TripletMarginLoss)
from .conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                   Conv2DTranspose, Conv3D, Conv3DTranspose)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, LayerNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool2D, AdaptiveMaxPool2D,  # noqa: F401
                      AvgPool2D, MaxPool2D)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,  # noqa: F401
                  RNNCellBase, SimpleRNN, SimpleRNNCell)
