"""paddle_tpu_torch.serving — the serving engine of the port: a paged KV
pool (`kv_pool.py`) with a host-RAM tier (`host_tier.py`), the
continuous-batching scheduler with tenancy and the degradation ladder
(`scheduler.py`), the engine (`engine.py`), request tracing
(`request_trace.py`), the serving ledger (`ledger.py`) and the
ptpu_serve_* metrics (`metrics.py`) — counterpart of
`paddle_tpu/serving`.
"""
from . import metrics
from .engine import ServingConfig, ServingEngine
from .kv_pool import KVPagePool, PoolExhausted, chain_hash, chain_hashes
from .request_trace import (RequestTracer, load_trace, reconstruct,
                            render_serve_report)
from .scheduler import (AdmissionRejected, DegradeLadder, Request,
                        RequestState, Scheduler, SchedulerTimeline,
                        TenantTable, TokenBucket)

__all__ = [
    'KVPagePool', 'PoolExhausted', 'Request', 'RequestState',
    'Scheduler', 'SchedulerTimeline', 'ServingConfig', 'ServingEngine',
    'AdmissionRejected', 'DegradeLadder', 'TenantTable', 'TokenBucket',
    'RequestTracer', 'load_trace', 'reconstruct',
    'render_serve_report', 'metrics', 'chain_hash', 'chain_hashes',
]
