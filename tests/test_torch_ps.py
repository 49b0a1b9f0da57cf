"""The port's parameter server on the CPU: the reference's wire, table,
runtime and communicator cases (`tests/test_ps.py`, `tests/test_native.py`
TestSparseTable) run on `paddle_tpu_torch`, plus the port's own: the
retry across an outage, torch inputs, the server runtime's environment
and the refusals. Every server binds port 0 and every client socket has a
timeout, so no case can hang."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.native import (NativeDenseTable,
                                          NativeSparseTable,
                                          NativeSsdSparseTable)
from paddle_tpu_torch.distributed.ps import ps_runtime
from paddle_tpu_torch.distributed.ps.communicator import AsyncCommunicator
from paddle_tpu_torch.distributed.ps.service import (PsClient, PsError,
                                                     PsServer)

TIMEOUT = 10          # every client socket's connect / read bound, seconds


def _client(*servers, **kw):
    kw.setdefault('timeout', TIMEOUT)
    return PsClient([f'127.0.0.1:{s.port}' for s in servers], **kw)


def test_ps_service_remote_pull_push():
    """BrpcPsClient/Server pattern: 2 servers, sharded ids, remote grads."""
    s1 = PsServer().start()
    s2 = PsServer().start()
    for s in (s1, s2):
        s.add_table(0, dim=8, optimizer='sgd', seed=1)
    client = _client(s1, s2)
    ids = np.arange(100, dtype=np.int64)
    rows = client.pull(0, ids, 8)
    assert rows.shape == (100, 8)
    np.testing.assert_allclose(client.pull(0, ids, 8), rows)
    # push grads of ones with lr 0.5: rows drop by 0.5
    client.push(0, ids, np.ones((100, 8), np.float32), lr=0.5)
    after = client.pull(0, ids, 8)
    np.testing.assert_allclose(after, rows - 0.5, rtol=1e-5)
    assert client.table_size(0) == 100
    # both servers hold rows: the ids were sharded
    assert 0 < len(s1.tables[0]) < 100
    client.shutdown()
    client.close()


def test_pull_push_take_torch_tensors():
    """Torch tensors (a gradient that requires grad too) go over the wire
    as the same numpy arrays would."""
    srv = PsServer().start()
    srv.add_table(0, dim=4, optimizer='sgd', seed=2)
    client = _client(srv)
    ids = np.arange(10, dtype=np.int64)
    rows = client.pull(0, torch.from_numpy(ids), 4)
    np.testing.assert_array_equal(rows, client.pull(0, ids, 4))
    g = torch.ones(10, 4, dtype=torch.float64, requires_grad=True)
    client.push(0, torch.from_numpy(ids), g, lr=0.25)
    np.testing.assert_allclose(client.pull(0, ids, 4), rows - 0.25,
                               rtol=1e-6)
    srv.add_dense_table(1, size=3)
    client.dense_init(1, torch.arange(3.0))
    client.dense_push(1, torch.ones(3, requires_grad=True), lr=0.5)
    np.testing.assert_array_equal(client.dense_pull(1),
                                  np.arange(3.0, dtype=np.float32) - 0.5)
    client.shutdown()
    client.close()


def test_sparse_adam_accessor():
    """Sparse adam (row layout [w, m, v, t]) converges on a toy pull
    target (parity: the reference sparse-adam accessor)."""
    t = NativeSparseTable(4, optimizer='adam', seed=1)
    ids = np.arange(10, dtype=np.int64)
    for _ in range(200):
        w = t.pull(ids)
        t.push(ids, w - 1.0, lr=0.05)
    assert np.abs(t.pull(ids) - 1.0).max() < 0.05


def test_dense_table_remote(tmp_path):
    """Server-side dense table (CommonDenseTable parity): init, pull,
    optimizer-applied push, save through the service."""
    server = PsServer().start()
    server.add_dense_table(3, size=16, optimizer='adam')
    client = _client(server)
    client.dense_init(3, np.zeros(16, np.float32))
    for _ in range(100):
        w = client.dense_pull(3)
        client.dense_push(3, w - 2.0, lr=0.1)
    w = client.dense_pull(3)
    assert np.abs(w - 2.0).max() < 0.1, w
    path = str(tmp_path / 'dense')
    client.dense_save(3, path)
    assert os.path.exists(path + '.part0')
    fresh = NativeDenseTable(16, optimizer='adam')
    fresh.load(path + '.part0')
    np.testing.assert_array_equal(fresh.pull(), w)
    client.shutdown()
    client.close()


def test_application_errors_surface_not_retry():
    """Bad path, missing table, dim mismatch, wrong table kind and a dense
    push of the wrong size raise PsError at once (application errors),
    not after a 30 s transport retry."""
    server = PsServer().start()
    server.add_table(0, dim=4, optimizer='sgd')
    server.add_dense_table(1, size=4)
    client = _client(server, retry_timeout=30)
    ids = np.arange(4, dtype=np.int64)
    t0 = time.time()
    with pytest.raises(PsError):
        client.save(0, '/nonexistent_dir_xyz/snap')
    with pytest.raises(PsError, match='no table 7'):
        client.pull(7, ids, 4)          # missing table
    with pytest.raises(PsError, match='dim 4 != 8'):
        client.pull(0, ids, 8)          # dim mismatch
    with pytest.raises(PsError, match='is dense'):
        client.pull(1, ids, 4)          # wrong table kind
    with pytest.raises(PsError, match='5 values'):
        client.dense_push(1, np.ones(5, np.float32), lr=0.1)
    assert time.time() - t0 < 5        # no retry storm
    # the connection is still healthy afterwards (stream not desynced)
    assert client.pull(0, ids, 4).shape == (4, 4)
    client.shutdown()
    client.close()


def _relaunch(port, snap, delay, started):
    """A relaunched server: bind, add and load its table, then listen."""
    time.sleep(delay)                   # the client sees the outage first
    s2 = PsServer(port=port)
    s2.add_table(0, dim=4, optimizer='sgd', seed=7)
    s2.tables[0].load(snap + '.part0')
    started['server'] = s2.start()


def test_kill_one_server_recovers(tmp_path):
    """Fault tolerance: kill a server, relaunch it on the same port from
    its snapshot; the client's reconnect-with-retry resumes pulls and
    pushes transparently. The relaunched server adds and loads its table
    before it listens (the reference's copy listens first,
    tests/test_ps.py:190-192, so a retried pull can meet a server without
    the table or with fresh rows)."""
    snap = str(tmp_path / 'snap')
    server = PsServer().start()
    port = server.port
    server.add_table(0, dim=4, optimizer='sgd', seed=7)
    client = _client(server, retry_timeout=20)
    ids = np.arange(20, dtype=np.int64)
    rows = client.pull(0, ids, 4)
    client.push(0, ids, np.ones((20, 4), np.float32), lr=0.5)
    client.save(0, snap)

    server.stop()                       # "kill": connections drop
    started = {}
    t = threading.Thread(target=_relaunch, args=(port, snap, 1.0, started))
    t.start()
    # issued during the outage: retried until the relaunched server is up
    after = client.pull(0, ids, 4)
    t.join(timeout=30)
    assert not t.is_alive()
    np.testing.assert_allclose(after, rows - 0.5, rtol=1e-5)
    client.push(0, ids, np.ones((20, 4), np.float32), lr=0.5)
    np.testing.assert_allclose(client.pull(0, ids, 4), rows - 1.0,
                               rtol=1e-5)
    client.close()
    started['server'].stop()


@pytest.mark.parametrize('relaunch', [True, False],
                         ids=['covers_outage', 'deadline'])
def test_rpc_retry_across_outage(tmp_path, relaunch):
    """`_rpc` retries a request through an outage: the request sent while
    the server is down blocks, the client marks the server dead, and the
    answer comes from the relaunched server. Without a relaunch the
    transport error surfaces once `retry_timeout` has passed."""
    snap = str(tmp_path / 'snap')
    server = PsServer().start()
    server.add_table(0, dim=4, optimizer='sgd', seed=7)
    client = _client(server, retry_timeout=20 if relaunch else 0.5)
    ids = np.arange(8, dtype=np.int64)
    rows = client.pull(0, ids, 4)
    client.save(0, snap)
    server.stop()
    started = {}
    t = threading.Thread(target=_relaunch,
                         args=(server.port, snap, 0.3, started))
    seen_dead = []

    def watch():
        for _ in range(10):
            seen_dead.append(client.alive[0] is False)
            time.sleep(0.02)
    watcher = threading.Thread(target=watch)
    t0 = time.monotonic()
    if relaunch:
        t.start()
        watcher.start()
        np.testing.assert_array_equal(client.pull(0, ids, 4), rows)
        t.join(timeout=30)
        watcher.join(timeout=5)
        assert time.monotonic() - t0 >= 0.3     # it waited out the outage
        assert any(seen_dead) and client.alive == [True]
        started['server'].stop()
    else:
        with pytest.raises(OSError):
            client.pull(0, ids, 4)
        assert 0.5 <= time.monotonic() - t0 < 5
        assert client.alive == [False]
    client.close()


def test_listening_before_the_table_fails_a_retried_pull():
    """The window the reference's relaunch leaves open: a server that
    listens before it adds its table answers a retried pull with an
    application error, which is not retried."""
    server = PsServer().start()
    server.add_table(0, dim=4, optimizer='sgd', seed=7)
    client = _client(server, retry_timeout=20)
    ids = np.arange(8, dtype=np.int64)
    client.pull(0, ids, 4)
    server.stop()
    relaunched = PsServer(port=server.port).start()    # listens, no table
    with pytest.raises(PsError, match='no table 0'):
        client.pull(0, ids, 4)
    client.close()
    relaunched.stop()


def test_heartbeat_tracks_liveness():
    server = PsServer().start()
    server.add_table(0, dim=4)
    client = _client(server, retry_timeout=5)
    client.start_heartbeat(interval=0.2)
    time.sleep(0.6)
    assert client.alive == [True]
    server.stop()
    time.sleep(1.0)
    assert client.alive == [False]
    client.stop_heartbeat()
    client.close()


def test_ssd_table_spill_and_kill_restart(tmp_path):
    """SSD spill tier: a table bigger than the RAM budget pulls and pushes
    correctly through spill, and a killed server's table recovers from the
    spill logs alone (parity: ssd_sparse_table.h + rocksdb recovery)."""
    d = str(tmp_path)
    kw = dict(num_shards=4, optimizer='adam', mem_budget_rows=128,
              beta1=0.9, beta2=0.999, eps=1e-8, init_range=0.05, seed=3)
    t = NativeSsdSparseTable(8, d, **kw)
    ids = np.arange(2000, dtype=np.int64)
    rows0 = t.pull(ids)
    assert t.mem_rows() <= 256          # far below 2000: spill engaged
    assert t.total_rows() == 2000
    t.push(ids, np.ones((2000, 8), np.float32), lr=0.1)
    expected = t.pull(ids)
    assert not np.allclose(expected, rows0)
    t.flush()
    del t                                # "kill" the process's table
    t2 = NativeSsdSparseTable(8, d, **kw)
    t2.recover()
    np.testing.assert_allclose(t2.pull(ids), expected, atol=1e-6)


def test_per_table_accessor_hypers():
    """Adam hypers are per-table accessor config, not constants (parity:
    ps.proto TableParameter)."""
    ids = np.array([7], np.int64)
    g = np.full((1, 4), 0.5, np.float32)
    g2 = np.full((1, 4), -0.25, np.float32)

    def second_step(beta1):
        t = NativeSparseTable(4, optimizer='adam', seed=11, beta1=beta1)
        t.push(ids, g, lr=0.1)    # bias correction hides beta1 at t=1;
        w1 = t.pull(ids).copy()   # a second, different gradient shows it
        t.push(ids, g2, lr=0.1)
        return t.pull(ids) - w1

    d_a = second_step(0.9)
    d_b = second_step(0.0)
    assert not np.allclose(d_a, d_b)
    assert np.all(d_b > 0)        # beta1=0 at t=2: m = g2 < 0, step > 0
    assert np.all(d_a < 0)        # m2 = 0.9*0.05 + 0.1*(-0.25) > 0


@pytest.fixture
def table_env(monkeypatch):
    ps_runtime.set_table_configs(None)
    for k in ('PADDLE_PS_TABLES', 'PADDLE_CURRENT_ENDPOINT',
              'PADDLE_PS_STATE_DIR'):
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    ps_runtime.set_table_configs(None)


def test_server_table_config_json_env(table_env, tmp_path):
    """JSON TableParameter configs through PADDLE_PS_TABLES reach
    add_table (the the_one_ps _get_fleet_proto analogue)."""
    cfgs = [{'table_id': 0, 'embedx_dim': 8, 'optimizer': 'adam',
             'beta1': 0.8, 'shard_num': 4},
            {'table_id': 1, 'embedx_dim': 4, 'optimizer': 'adagrad',
             'ssd_path': str(tmp_path), 'mem_budget_rows': 64}]
    table_env.setenv('PADDLE_PS_TABLES', json.dumps(cfgs))
    srv = PsServer(port=0)
    for cfg in ps_runtime._table_configs():
        c = dict(cfg)
        srv.add_table(c.pop('table_id'), c.pop('embedx_dim'), **c)
    assert srv.tables[0].dim == 8
    assert isinstance(srv.tables[1], NativeSsdSparseTable)
    with pytest.raises(ValueError, match='unknown table config'):
        ps_runtime.set_table_configs([{'table_id': 2, 'embedx_dim': 4,
                                       'bogus': 1}])
    srv.stop()


@pytest.mark.parametrize('source', ['legacy_env', 'set_table_configs'])
def test_server_runtime_tables_endpoint_and_state_dir(table_env, tmp_path,
                                                      source):
    """`get_or_create_server` builds the tables of the configs (the set
    ones before the environment's), binds PADDLE_CURRENT_ENDPOINT's port
    and keeps its dedup marks under PADDLE_PS_STATE_DIR/<endpoint>."""
    table_env.setenv('PADDLE_PS_TABLES', '0:8:sgd,3:4:adam')
    table_env.setenv('PADDLE_CURRENT_ENDPOINT', '127.0.0.1:0')
    table_env.setenv('PADDLE_PS_STATE_DIR', str(tmp_path))
    want = {0: 8, 3: 4}
    if source == 'set_table_configs':
        ps_runtime.set_table_configs([ps_runtime.TableParameter(5, 2)])
        want = {5: 2}
    runtime = ps_runtime.get_or_create_server(object())
    srv = runtime.server
    assert {t: tbl.dim for t, tbl in srv.tables.items()} == want
    assert os.path.exists(tmp_path / '127.0.0.1_0' / 'applied.log')
    th = threading.Thread(target=runtime.run, daemon=True)
    th.start()
    deadline = time.monotonic() + TIMEOUT
    while True:                          # run() listens on its thread
        try:
            client = PsClient([f'127.0.0.1:{srv.port}'], timeout=TIMEOUT)
            break
        except ConnectionRefusedError:
            assert time.monotonic() < deadline
            time.sleep(0.02)
    tid, dim = next(iter(want.items()))
    assert client.pull(tid, np.arange(3), dim).shape == (3, dim)
    client.shutdown()                    # the 'Q' op ends run()
    th.join(timeout=10)
    assert not th.is_alive()
    client.close()


def test_worker_runtime_waits_for_the_fleet_base():
    with pytest.raises(NotImplementedError, match='item 7'):
        ps_runtime.get_or_create_worker(object())


def test_unknown_optimizer_is_refused():
    """The reference's tables take an unknown optimizer name as SGD
    (paddle_tpu/core/native.py:314); the port's refuse it."""
    for make in (lambda: NativeSparseTable(4, optimizer='rmsprop'),
                 lambda: NativeDenseTable(4, optimizer='momentum')):
        with pytest.raises(ValueError, match='optimizer'):
            make()


def test_ssd_table_snapshot_includes_cold_rows(tmp_path):
    """SaveAll/LoadAll carry the spilled rows: the base save would
    snapshot only the hot set."""
    d1, d2 = str(tmp_path / 'a'), str(tmp_path / 'b')
    kw = dict(num_shards=4, optimizer='adagrad', mem_budget_rows=64,
              seed=5)
    t = NativeSsdSparseTable(8, d1, **kw)
    ids = np.arange(1000, dtype=np.int64)
    t.push(ids, np.ones((1000, 8), np.float32), lr=0.05)
    expected = t.pull(ids)
    assert t.mem_rows() < 1000
    snap = os.path.join(d1, 'snap.bin')
    t.save(snap)
    t2 = NativeSsdSparseTable(8, d2, **kw)
    t2.load(snap)
    assert len(t2) == 1000
    assert t2.mem_rows() == 0          # restored straight to the logs
    np.testing.assert_allclose(t2.pull(ids), expected, atol=1e-6)


def test_push_at_most_once_across_server_restart(tmp_path):
    """A push applied and made durable just before a crash does not
    re-apply when the reconnecting client replays it against the restarted
    server: the uuid -> seq high-water mark persists to
    <state_dir>/applied.log and is recovered on construction."""
    state = str(tmp_path)
    ssd = str(tmp_path / 'tbl')
    os.makedirs(ssd, exist_ok=True)
    kw = dict(optimizer='sgd', seed=1, num_shards=2, ssd_path=ssd)
    srv1 = PsServer(state_dir=state).start()
    srv1.add_table(0, dim=4, **kw)
    port = srv1.port
    client = PsClient([f'127.0.0.1:{port}'], timeout=TIMEOUT,
                      retry_timeout=60)
    ids = np.arange(10, dtype=np.int64)
    rows0 = client.pull(0, ids, 4).copy()
    srv1.tables[0].flush()          # row creation durable before the crash

    srv1._die_after_apply = 1       # apply + persist, then die before ack
    g = np.ones((10, 4), np.float32)
    err = []

    def do_push():
        try:
            client.push(0, ids, g, lr=0.5)   # blocks, retrying
        except Exception as e:               # noqa: BLE001
            err.append(e)

    th = threading.Thread(target=do_push)
    th.start()
    deadline = time.time() + 30
    while srv1._running and time.time() < deadline:
        time.sleep(0.05)
    assert not srv1._running        # the hook fired: applied, died, no ack

    # restart on the same port and state dir: the table recovers from its
    # spill logs, the dedup map from applied.log
    srv2 = PsServer(port=port, state_dir=state)
    srv2.add_table(0, dim=4, **kw).recover()
    srv2.start()
    th.join(timeout=60)
    assert not th.is_alive() and not err, err

    after = client.pull(0, ids, 4)
    np.testing.assert_allclose(after, rows0 - 0.5, atol=1e-6)  # once
    client.shutdown()
    client.close()


def test_table_parameter_typed_validation():
    """Table configs are typed TableParameter analogues: bad keys,
    optimizers and hyper ranges fail at configuration time."""
    t = ps_runtime.TableParameter.from_dict(
        {'table_id': 0, 'embedx_dim': 8, 'optimizer': 'adam', 'beta1': 0.95})
    assert t.to_dict()['beta1'] == 0.95
    for bad in (
        {'table_id': 0, 'embedx_dim': 8, 'optimzer': 'adam'},   # typo
        {'table_id': 0},                                        # missing
        {'table_id': 0, 'embedx_dim': -4},
        {'table_id': 0, 'embedx_dim': 8, 'optimizer': 'rmsprop'},
        {'table_id': 0, 'embedx_dim': 8, 'beta1': 1.5},
        {'table_id': 0, 'embedx_dim': 8, 'shard_num': 0},
    ):
        with pytest.raises(ValueError):
            ps_runtime.TableParameter.from_dict(bad)
    with pytest.raises(ValueError, match='duplicate'):
        ps_runtime.set_table_configs([{'table_id': 1, 'embedx_dim': 4},
                                      {'table_id': 1, 'embedx_dim': 8}])
    ps_runtime.set_table_configs(None)


class _ZeroClient:
    """pull gives zero rows (after `delay` seconds), push does nothing."""

    def __init__(self, delay=0.0):
        self.delay = delay

    def pull(self, tid, ids, dim):
        if self.delay:
            time.sleep(self.delay)
        return np.zeros((len(ids), dim), np.float32)

    def push(self, tid, ids, grads, lr):
        pass


class TestAsyncCommunicator:
    """reference communicator.h:197: pull-ahead / push-behind."""

    def test_pull_ahead_order_and_push_flush(self):
        calls = {'pull': [], 'push': []}
        gate = threading.Event()

        class FakeClient:
            def pull(self, tid, ids, dim):
                calls['pull'].append(np.array(ids))
                return np.tile(np.asarray(ids, np.float32)[:, None],
                               (1, dim))

            def push(self, tid, ids, grads, lr):
                gate.wait(5)                 # prove push never blocks
                calls['push'].append((np.array(ids), np.array(grads)))

        comm = AsyncCommunicator(FakeClient(), 0, 4, depth=2)
        batches = [np.arange(i, i + 3, dtype=np.int64) for i in range(5)]
        out = list(comm.pull_ahead(batches))
        assert len(out) == 5
        for (ids, rows), want in zip(out, batches):
            np.testing.assert_array_equal(ids, want)
            np.testing.assert_allclose(rows[:, 0], want.astype(np.float32))
        # pushes queue without blocking while the wire is stuck
        t0 = time.time()
        comm.push_async(batches[0], np.ones((3, 4), np.float32), 0.1)
        comm.push_async(batches[1], np.ones((3, 4), np.float32), 0.1)
        assert time.time() - t0 < 1.0
        assert not calls['push']
        gate.set()
        comm.flush()                         # the barrier drains the queue
        assert len(calls['push']) == 2
        comm.stop()

    def test_push_error_surfaces(self):
        class BadClient(_ZeroClient):
            def push(self, tid, ids, grads, lr):
                raise ConnectionError('wire down')

        comm = AsyncCommunicator(BadClient(), 0, 4, depth=2)
        comm.push_async(np.arange(2, dtype=np.int64),
                        np.ones((2, 4), np.float32), 0.1)
        with pytest.raises(ConnectionError, match='wire down'):
            comm.flush()
        # a queued push error must not wedge shutdown: stop() re-raises
        # after releasing the worker threads
        comm.push_async(np.arange(2, dtype=np.int64),
                        np.ones((2, 4), np.float32), 0.1)
        with pytest.raises(ConnectionError, match='wire down'):
            comm.stop()
        assert not comm._push_thread.is_alive()

    def test_abandoned_pull_iterator_releases_producer(self):
        comm = AsyncCommunicator(_ZeroClient(), 0, 4, depth=1)
        it = comm.pull_ahead([np.arange(3, dtype=np.int64)] * 50)
        next(it)                      # consume one, abandon the rest
        it.close()                    # GeneratorExit -> cancel
        t0 = time.time()
        while comm._pull_thread is not None and time.time() - t0 < 5:
            time.sleep(0.01)
        assert comm._pull_thread is None
        # the communicator is reusable after the cancellation
        out = list(comm.pull_ahead([np.arange(2, dtype=np.int64)]))
        assert len(out) == 1
        comm.stop()

    def test_stale_iterator_close_spares_newer_pull(self):
        comm = AsyncCommunicator(_ZeroClient(), 0, 4, depth=1)
        it1 = comm.pull_ahead([np.arange(3, dtype=np.int64)] * 20)
        next(it1)
        comm.cancel_pull()            # explicit cancel of generation 1
        it2 = comm.pull_ahead([np.arange(2, dtype=np.int64)] * 5)
        it1.close()                   # the stale finalizer fires late
        out = list(it2)               # generation 2 completes, no hang
        assert len(out) == 5
        comm.stop()

    def test_stop_cancels_inflight_pull(self):
        comm = AsyncCommunicator(_ZeroClient(delay=0.01), 0, 4, depth=1)
        comm.pull_ahead([np.arange(3, dtype=np.int64)] * 200)
        t0 = time.time()
        comm.stop()                   # must not hang on the full queue
        assert time.time() - t0 < 5
        assert comm._pull_thread is None

    def test_tensors_over_a_real_server(self):
        """Over a real server: device_put runs on each pulled batch, and a
        torch gradient that requires grad lands on the table as its numpy
        copy would (on the CPU; the card's streams are chip_smoke.py's
        deepfm_ps checks)."""
        srv = PsServer().start()
        srv.add_table(0, dim=4, optimizer='sgd', seed=4)
        client = _client(srv)
        ids = np.arange(6, dtype=np.int64)
        want = client.pull(0, ids, 4)
        comm = AsyncCommunicator(client, 0, 4, depth=2,
                                 device_put=torch.from_numpy)
        (got_ids, rows), = list(comm.pull_ahead([ids]))
        assert isinstance(rows, torch.Tensor)
        np.testing.assert_array_equal(rows.numpy(), want)
        g = torch.full((6, 4), 2.0, requires_grad=True)
        comm.push_async(torch.from_numpy(got_ids), g * 1.0, 0.5)
        comm.flush()
        np.testing.assert_allclose(client.pull(0, ids, 4), want - 1.0,
                                   rtol=1e-6)
        comm.stop()
        client.shutdown()
        client.close()


class TestSparseTable:
    def test_pull_push_adagrad(self):
        table = NativeSparseTable(dim=8, optimizer='adagrad', seed=42)
        ids = np.array([1, 5, 9, 5])
        rows = table.pull(ids)
        assert rows.shape == (4, 8)
        np.testing.assert_allclose(rows[1], rows[3])  # same id, same row
        assert len(table) == 3
        # deterministic on-miss init by (seed, id)
        table2 = NativeSparseTable(dim=8, optimizer='adagrad', seed=42)
        np.testing.assert_allclose(table2.pull(np.array([1]))[0], rows[0])
        grads = np.ones((4, 8), np.float32)
        table.push(ids, grads, lr=0.1)
        after = table.pull(ids)
        assert np.all(after < rows)  # positive grads decrease weights

    def test_save_load_shrink(self, tmp_path):
        t = NativeSparseTable(dim=4, optimizer='sgd')
        ids = np.arange(100)
        rows = t.pull(ids)
        path = str(tmp_path / 'table.bin')
        t.save(path)
        t2 = NativeSparseTable(dim=4, optimizer='sgd')
        t2.load(path)
        assert len(t2) == 100
        np.testing.assert_allclose(t2.pull(ids), rows)
        dropped = t2.shrink(threshold=1e9)
        assert dropped == 100 and len(t2) == 0

    def test_scale_1m_ids(self):
        """Throughput sanity on 100k-id pulls over a 10M id space."""
        t = NativeSparseTable(dim=16, optimizer='adagrad')
        ids = np.random.RandomState(0).randint(0, 10_000_000, 100_000)
        t0 = time.time()
        out = t.pull(ids)
        dt = time.time() - t0
        assert out.shape == (100_000, 16)
        assert dt < 5.0, f'pull too slow: {dt}s'
