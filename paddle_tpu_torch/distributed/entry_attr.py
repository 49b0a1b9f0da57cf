"""Sparse-table entry policies — the port's copy of
`paddle_tpu/distributed/entry_attr.py` (reference:
python/paddle/distributed/entry_attr.py:20-150) — admission rules for
paddle.static.nn.sparse_embedding rows under the parameter server:
ProbabilityEntry admits a new feature id with probability p,
CountFilterEntry admits once an id has been seen `count` times. The PS
runtime consumes `_to_attr()` strings in its table configs
(ps/ps_runtime.py TableParameter analogue)."""


class EntryAttr:
    def __init__(self):
        self._name = None

    def _to_attr(self):
        raise NotImplementedError("EntryAttr is base class")

    def __repr__(self):
        return self._to_attr()


class ProbabilityEntry(EntryAttr):
    def __init__(self, probability):
        super().__init__()
        if not isinstance(probability, float):
            raise ValueError("probability must be a float in (0, 1]")
        if probability <= 0 or probability > 1:
            raise ValueError("probability must be in (0, 1]")
        self._name = 'probability_entry'
        self._probability = probability

    def _to_attr(self):
        return ':'.join([self._name, str(self._probability)])


class CountFilterEntry(EntryAttr):
    def __init__(self, count_filter):
        super().__init__()
        if not isinstance(count_filter, int):
            raise ValueError("count_filter must be a non-negative int")
        if count_filter < 0:
            raise ValueError("count_filter must be a non-negative int")
        self._name = 'count_filter_entry'
        self._count_filter = count_filter

    def _to_attr(self):
        return ':'.join([self._name, str(self._count_filter)])
