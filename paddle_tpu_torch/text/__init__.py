"""paddle.text — counterpart of `paddle_tpu/text`: the datasets and the
text models (`LSTMSentiment`, `BoWClassifier`). The `ops.sequence` names
the reference re-exports here (`viterbi_decode`, `ViterbiDecoder`,
`linear_chain_crf`, `crf_decoding`, `beam_search`) are not ported yet
(Queue 1 item 9c): asking for one raises."""
from . import datasets, models  # noqa: F401
from .datasets import (Conll05st, Imdb, Imikolov, Movielens,  # noqa: F401
                       UCIHousing, WMT14, WMT16)
from .models import BoWClassifier, LSTMSentiment  # noqa: F401

_SEQUENCE = ('viterbi_decode', 'ViterbiDecoder', 'linear_chain_crf',
             'crf_decoding', 'beam_search')


def __getattr__(name):
    if name in _SEQUENCE:
        raise NotImplementedError(
            f'paddle_tpu_torch.text.{name} is not ported yet: it comes '
            f'with ops/sequence.py in item 9c (ROADMAP Queue 1)')
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
