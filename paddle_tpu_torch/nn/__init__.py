from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import *  # noqa: F401,F403
from .decode import (BasicDecoder, BeamSearchDecoder,  # noqa: F401
                     DecodeHelper, Decoder, GreedyEmbeddingHelper,
                     SampleEmbeddingHelper, TrainingHelper, dynamic_decode)
