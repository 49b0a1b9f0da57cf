"""The serving cluster on one host — counterpart of
`paddle_tpu/serving/cluster`:

  * `router.py`      — the prefix-affinity router: placement,
    backpressure, drain, metrics federation;
  * `replica.py`     — replicas behind it, in-process (`LocalReplica`,
    pumped by the router) or worker processes (`ReplicaWorker`, reached
    through `RemoteReplica` over the TCP control channel of
    `channel.py`), with the hang watchdog and its report;
  * `disagg.py`      — prefill/decode disaggregation
    (`DisaggregatedEngine`, `build_engine`): prefill on one engine, the
    finished KV pages streamed into the decode engine's pool
    (`page_stream.py`, int8 scales with their pages) and the request
    adopted into a decode slot.

Every replica and both engines of a disaggregated one may share one
card. The mp-sharded engine is not ported (ROADMAP Queue 1 item 7).
"""
from .disagg import DisaggregatedEngine, build_engine
from .page_stream import stream_kv_pages
from .replica import LocalReplica, RemoteReplica, ReplicaWorker
from .router import (ClusterRouter, RouterRejected, RoutedRequest,
                     cluster_snapshot)

# the router's descriptive name; ClusterRouter stays its other name
PrefixAffinityRouter = ClusterRouter

__all__ = ['ClusterRouter', 'PrefixAffinityRouter', 'RouterRejected',
           'RoutedRequest', 'cluster_snapshot', 'LocalReplica',
           'RemoteReplica', 'ReplicaWorker', 'DisaggregatedEngine',
           'build_engine', 'stream_kv_pages']
