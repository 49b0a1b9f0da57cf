from . import clip  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import Dropout, Embedding, LayerNorm, Linear  # noqa: F401
