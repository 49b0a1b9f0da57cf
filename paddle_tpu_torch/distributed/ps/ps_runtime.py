"""PS server runtime and table configs — the port's copy of
`paddle_tpu/distributed/ps/ps_runtime.py`.

Reference parity: TheOnePSRuntime's server lifecycle over the service tier
(BrpcPsServer -> `service.py`). Table configs come from
`set_table_configs` (a list of TableParameter or dicts, the
`strategy.sparse_table_configs` analogue), else from the environment:
PADDLE_PS_TABLES is either the legacy "id:dim:opt,..." or a JSON list of
TableParameter dicts, "0:16:adagrad" by default. The server's endpoint
comes from PADDLE_CURRENT_ENDPOINT, and its durable push-dedup state
from PADDLE_PS_STATE_DIR, namespaced by endpoint.

Not ported yet: the worker side (`_Worker`, `get_or_create_worker`),
which needs the fleet object's server endpoints and role maker, and
`fleet/runtime/the_one_ps.py` (ROADMAP Queue 1 item 7, the fleet base).
"""
import dataclasses
import json
import os

# programmatic table configs (a list of TableParameter); they take
# precedence over the environment, the launch-time channel
_TABLE_CONFIGS = None

_OPTIMIZERS = ('sgd', 'adagrad', 'adam')


@dataclasses.dataclass
class TableParameter:
    """Typed table config (parity: ps.proto TableParameter and the
    CtrCommonAccessor hypers): a misspelled key or an out-of-range hyper
    fails here, at configuration time, not as a garbage table on the
    server."""
    table_id: int
    embedx_dim: int
    optimizer: str = 'adagrad'
    init_range: float = 0.05
    shard_num: int = 16
    seed: int = 0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    ssd_path: str = None
    mem_budget_rows: int = 1 << 20

    def __post_init__(self):
        if not isinstance(self.table_id, int) or self.table_id < 0:
            raise ValueError(f'table_id must be a non-negative int, got '
                             f'{self.table_id!r}')
        if not isinstance(self.embedx_dim, int) or self.embedx_dim <= 0:
            raise ValueError(f'embedx_dim must be a positive int, got '
                             f'{self.embedx_dim!r}')
        if self.optimizer not in _OPTIMIZERS:
            raise ValueError(f'optimizer must be one of {_OPTIMIZERS}, '
                             f'got {self.optimizer!r}')
        if not (0.0 <= self.init_range <= 10.0):
            raise ValueError(f'init_range out of range: {self.init_range}')
        if self.shard_num <= 0:
            raise ValueError(f'shard_num must be positive: '
                             f'{self.shard_num}')
        for name in ('beta1', 'beta2'):
            v = getattr(self, name)
            if not (0.0 <= v < 1.0):
                raise ValueError(f'{name} must be in [0, 1): {v}')
        if self.eps <= 0:
            raise ValueError(f'eps must be positive: {self.eps}')
        if self.mem_budget_rows <= 0:
            raise ValueError(f'mem_budget_rows must be positive: '
                             f'{self.mem_budget_rows}')
        if self.ssd_path is not None and not isinstance(self.ssd_path,
                                                        str):
            raise ValueError('ssd_path must be a path string')

    @classmethod
    def from_dict(cls, d):
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(
                f'unknown table config keys: {sorted(unknown)}; '
                f'known: {sorted(fields)}')
        missing = {'table_id', 'embedx_dim'} - set(d)
        if missing:
            raise ValueError(f'table config needs {sorted(missing)}')
        return cls(**d)

    def to_dict(self):
        out = dataclasses.asdict(self)
        if out['ssd_path'] is None:
            out.pop('ssd_path')
        return out


def set_table_configs(configs):
    """configs: a list of TableParameter instances or dicts (validated
    through TableParameter); None or empty goes back to the
    environment."""
    global _TABLE_CONFIGS
    if not configs:
        _TABLE_CONFIGS = None
        return
    parsed = [c if isinstance(c, TableParameter)
              else TableParameter.from_dict(c) for c in configs]
    ids = [c.table_id for c in parsed]
    if len(set(ids)) != len(ids):
        raise ValueError(f'duplicate table_id in configs: {ids}')
    _TABLE_CONFIGS = parsed


def _table_configs():
    """The validated table-config dicts."""
    if _TABLE_CONFIGS is not None:
        return [c.to_dict() for c in _TABLE_CONFIGS]
    spec = os.environ.get('PADDLE_PS_TABLES', '0:16:adagrad')
    if spec.lstrip().startswith('['):
        # validated on every call: the env is a launch-time channel
        return [TableParameter.from_dict(c).to_dict()
                for c in json.loads(spec)]
    out = []
    for part in spec.split(','):
        tid, dim, opt = part.split(':')
        out.append(TableParameter(table_id=int(tid), embedx_dim=int(dim),
                                  optimizer=opt).to_dict())
    return out


class _Server:
    def __init__(self, fleet_obj):
        from .service import PsServer
        ep = os.environ.get('PADDLE_CURRENT_ENDPOINT', '0.0.0.0:0')
        port = int(ep.rsplit(':', 1)[1]) if ':' in ep else 0
        # the durable push-dedup high-water mark (at most once across a
        # server restart), namespaced by endpoint: launchers export one env
        # to every rank, and shard servers must not share dedup marks (a
        # mark recovered from a co-hosted peer would drop this shard's
        # legitimate replay)
        state = os.environ.get('PADDLE_PS_STATE_DIR')
        if state:
            state = os.path.join(state, ep.replace(':', '_'))
        self.server = PsServer(port=port, state_dir=state)
        for cfg in _table_configs():
            c = dict(cfg)
            tid = c.pop('table_id')
            dim = c.pop('embedx_dim')
            self.server.add_table(tid, dim, **c)

    def run(self):
        self.server.run()


def get_or_create_worker(fleet_obj):
    raise NotImplementedError(
        'the PS worker runtime needs the fleet base (server endpoints, role '
        'maker), not ported yet (ROADMAP Queue 1 item 7); build a '
        'PsClient over the endpoints directly')


def get_or_create_server(fleet_obj):
    return _Server(fleet_obj)
