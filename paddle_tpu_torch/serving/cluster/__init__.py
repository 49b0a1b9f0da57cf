"""The serving cluster on one host — counterpart of
`paddle_tpu/serving/cluster`: the prefix-affinity router (`router.py`:
placement, backpressure, drain, metrics federation) over in-process
replicas (`replica.py`: `LocalReplica`, each over its own
`ServingEngine`; several may share one card).

Not ported yet, each raising NotImplementedError when named:
  * the worker-process replicas (`ReplicaWorker`, `RemoteReplica` and
    their TCP control channel): ROADMAP Queue 1 item 8c;
  * prefill/decode disaggregation (`DisaggregatedEngine`,
    `build_engine`, `stream_kv_pages`): item 8b.
"""
from .replica import LocalReplica
from .router import (ClusterRouter, RouterRejected, RoutedRequest,
                     cluster_snapshot)

# the router's descriptive name; ClusterRouter stays its other name
PrefixAffinityRouter = ClusterRouter

_NOT_PORTED = {
    'RemoteReplica': 'item 8c (worker replicas)',
    'ReplicaWorker': 'item 8c (worker replicas)',
    'DisaggregatedEngine': 'item 8b (prefill/decode disaggregation)',
    'build_engine': 'item 8b (prefill/decode disaggregation)',
    'stream_kv_pages': 'item 8b (prefill/decode disaggregation)',
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f'serving.cluster.{name} is not ported yet (ROADMAP Queue 1 '
            f'{_NOT_PORTED[name]})')
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


__all__ = ['ClusterRouter', 'PrefixAffinityRouter', 'RouterRejected',
           'RoutedRequest', 'cluster_snapshot', 'LocalReplica']
