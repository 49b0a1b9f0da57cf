"""The port's parameter-server wire against the JAX package's, both ways,
over localhost TCP on the CPU: a port client against a JAX server and a
JAX client against a port server exchange the same bytes as JAX against
JAX on sparse, SSD and dense tables; the shard hash agrees across two
servers; a snapshot and an `applied.log` written by one package load into
the other's server; error frames reach the other side's caller as its
PsError. Pushes stay under 1024 rows, so the host table applies duplicate
ids in order and every run is bit-reproducible."""
import os
import socket
import struct

import numpy as np
import pytest

import paddle_tpu.distributed.ps.service as jax_ps
from paddle_tpu_torch.distributed.ps import service as torch_ps

SIDES = {'jax': jax_ps, 'torch': torch_ps}
TIMEOUT = 10
PAIRS = [('torch', 'jax'), ('jax', 'torch'), ('torch', 'torch')]


def _pair_id(pair):
    return f'{pair[0]}_client-{pair[1]}_server'


def _server(pkg, state_dir=None):
    return SIDES[pkg].PsServer(host='127.0.0.1', state_dir=state_dir)


def _client(pkg, *servers, **kw):
    return SIDES[pkg].PsClient([f'127.0.0.1:{s.port}' for s in servers],
                               timeout=TIMEOUT, **kw)


def _add(srv, kind, path):
    if kind == 'dense':
        srv.add_dense_table(2, size=24, optimizer='adam')
    elif kind == 'ssd':
        srv.add_table(0, dim=8, optimizer='adagrad', seed=5, num_shards=4,
                      ssd_path=str(path), mem_budget_rows=32)
    else:
        srv.add_table(0, dim=8, optimizer='adam', seed=5, num_shards=4)


def _sequence(kind, client_pkg, server_pkg, path):
    """The bytes of every answer to a fixed sequence of requests."""
    srv = _server(server_pkg)
    _add(srv, kind, path)
    srv.start()
    client = _client(client_pkg, srv)
    rng = np.random.RandomState(0)
    out = []
    if kind == 'dense':
        client.dense_init(2, rng.randn(24).astype(np.float32))
        for _ in range(3):
            client.dense_push(2, rng.randn(24).astype(np.float32), lr=0.1)
            out.append(client.dense_pull(2))
    else:
        for _ in range(3):
            ids = rng.randint(0, 300, 200).astype(np.int64)  # duplicates
            out.append(client.pull(0, ids, 8))
            client.push(0, ids, rng.randn(200, 8).astype(np.float32),
                        lr=0.05)
        out.append(client.pull(0, np.arange(300, dtype=np.int64), 8))
        out.append(np.array([client.table_size(0)]))
        if kind == 'sparse':
            out.append(np.array([client.shrink(0, 0.05)]))
            out.append(np.array([client.table_size(0)]))
    client.shutdown()
    client.close()
    return b''.join(np.ascontiguousarray(a).tobytes() for a in out)


@pytest.mark.parametrize('pair', PAIRS, ids=_pair_id)
@pytest.mark.parametrize('kind', ['sparse', 'ssd', 'dense'])
def test_answers_byte_equal_to_jax_against_jax(tmp_path, kind, pair):
    want = _sequence(kind, 'jax', 'jax', tmp_path / 'ref')
    got = _sequence(kind, *pair, tmp_path / 'got')
    assert len(got) == len(want) > 0
    assert got == want


def test_shard_hash_agrees_over_two_servers():
    """A port client pushes through two servers (one of each package) and
    a JAX client pulls the pushed rows back: each id went to the server
    the JAX hash names."""
    ids = np.random.RandomState(1).randint(-2**62, 2**62, 4096)
    for n in (1, 2, 3, 7):
        t = torch_ps.PsClient.__new__(torch_ps.PsClient)
        j = jax_ps.PsClient.__new__(jax_ps.PsClient)
        t.n_servers = j.n_servers = n
        np.testing.assert_array_equal(t._shard(ids), j._shard(ids))
    servers = [_server('jax'), _server('torch')]
    for s in servers:
        s.add_table(0, dim=4, optimizer='sgd', seed=9)
        s.start()
    pusher = _client('torch', *servers)
    puller = _client('jax', *servers)
    ids = np.arange(1000, dtype=np.int64)
    rows = pusher.pull(0, ids, 4)
    pusher.push(0, ids, np.ones((1000, 4), np.float32), lr=0.5)
    np.testing.assert_array_equal(puller.pull(0, ids, 4),
                                  pusher.pull(0, ids, 4))
    np.testing.assert_allclose(puller.pull(0, ids, 4), rows - 0.5,
                               rtol=1e-6)
    shard = pusher._shard(ids)
    assert [len(s.tables[0]) for s in servers] == [
        int((shard == k).sum()) for k in range(2)]
    pusher.shutdown()
    pusher.close()
    puller.close()


def _raw_load(port, table_id, path):
    """The 'L' op from a bare socket: load a snapshot on the server."""
    with socket.create_connection(('127.0.0.1', port),
                                  timeout=TIMEOUT) as sock:
        p = path.encode()
        sock.sendall(b'L' + struct.pack('<II', table_id, len(p)) + p)
        assert sock.recv(1) == b'\x01'


@pytest.mark.parametrize('kind', ['sparse', 'ssd', 'dense'])
def test_jax_snapshot_loads_into_a_port_server(tmp_path, kind):
    src = _server('jax')
    _add(src, kind, tmp_path / 'src')
    src.start()
    writer = _client('jax', src)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 500, 600).astype(np.int64)
    snap = str(tmp_path / 'snap')
    if kind == 'dense':
        writer.dense_init(2, rng.randn(24).astype(np.float32))
        writer.dense_push(2, rng.randn(24).astype(np.float32), lr=0.1)
        want = writer.dense_pull(2)
        writer.dense_save(2, snap)
    else:
        writer.pull(0, ids, 8)
        writer.push(0, ids, rng.randn(600, 8).astype(np.float32), lr=0.05)
        want = writer.pull(0, ids, 8)
        writer.save(0, snap)
    writer.shutdown()
    writer.close()

    dst = _server('torch')
    _add(dst, kind, tmp_path / 'dst')
    dst.start()
    _raw_load(dst.port, 2 if kind == 'dense' else 0, snap + '.part0')
    reader = _client('torch', dst)
    got = reader.dense_pull(2) if kind == 'dense' else reader.pull(0, ids, 8)
    assert got.tobytes() == want.tobytes()
    reader.shutdown()
    reader.close()


@pytest.mark.parametrize('pair', [('jax', 'torch'), ('torch', 'jax')],
                         ids=lambda p: f'{p[0]}_log-{p[1]}_server')
def test_applied_log_dedups_a_replay_across_packages(tmp_path, pair):
    """A push applied and checkpointed by one package's server is not
    applied again when the other package's server, restarted on the same
    state dir and spill logs, gets the same (uuid, seq) tag replayed."""
    writer_pkg, reader_pkg = pair
    state, ssd = str(tmp_path / 'state'), str(tmp_path / 'tbl')
    kw = dict(optimizer='sgd', seed=1, num_shards=2, ssd_path=ssd)
    srv1 = _server(writer_pkg, state_dir=state)
    srv1.add_table(0, dim=4, **kw)
    srv1.start()
    first = _client(writer_pkg, srv1)
    ids = np.arange(10, dtype=np.int64)
    rows0 = first.pull(0, ids, 4)
    g = np.ones((10, 4), np.float32)
    first.push(0, ids, g, lr=0.5)
    srv1.checkpoint()              # table data first, then the marks
    first.close()
    srv1.stop()
    assert os.path.getsize(os.path.join(state, 'applied.log')) == 24

    srv2 = _server(reader_pkg, state_dir=state)
    srv2.add_table(0, dim=4, **kw).recover()
    srv2.start()
    replay = _client(reader_pkg, srv2)
    replay._uuid, replay._seq = first._uuid, first._seq - 1
    replay.push(0, ids, g, lr=0.5)          # the same tag: skipped
    np.testing.assert_allclose(replay.pull(0, ids, 4), rows0 - 0.5,
                               atol=1e-6)
    replay.push(0, ids, g, lr=0.5)          # the next seq: applied
    np.testing.assert_allclose(replay.pull(0, ids, 4), rows0 - 1.0,
                               atol=1e-6)
    replay.shutdown()
    replay.close()


@pytest.mark.parametrize('pair', [('torch', 'jax'), ('jax', 'torch')],
                         ids=_pair_id)
def test_error_frames_reach_the_other_side_as_ps_error(pair):
    client_pkg, server_pkg = pair
    srv = _server(server_pkg)
    srv.add_table(0, dim=4, optimizer='sgd')
    srv.add_dense_table(1, size=4)
    srv.start()
    client = _client(client_pkg, srv)
    err = SIDES[client_pkg].PsError
    ids = np.arange(4, dtype=np.int64)
    with pytest.raises(err, match='no table 7'):
        client.pull(7, ids, 4)
    with pytest.raises(err, match='dim 4 != 8'):
        client.pull(0, ids, 8)
    with pytest.raises(err, match='is dense'):
        client.pull(1, ids, 4)
    with pytest.raises(err):
        client.save(0, '/nonexistent_dir_xyz/snap')
    assert client.pull(0, ids, 4).shape == (4, 4)     # stream in step
    client.shutdown()
    client.close()


# ---------------------------------------------------------------------------
# the deepfm_ps leg's dense chunk and one whole chunk, JAX against the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_dense_chunk(embs, params, labels, lr=0.05):
    """bench.py:449-476: K merged DeepFM steps under lax.scan, jitted."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    K, rows, dim = embs.shape
    B = labels.shape[0]
    fields = rows // B
    labels = jnp.asarray(labels)

    def one_step(emb, w1, b1, w2):
        def loss_of(emb, w1, b1, w2):
            e = emb.reshape(B, fields, dim)
            s = e.sum(1)
            fm = 0.5 * (s * s - (e * e).sum(1)).sum(-1, keepdims=True)
            h = jax.nn.relu(e.reshape(B, -1) @ w1 + b1)
            logit = h @ w2 + fm
            return jnp.mean(jnp.clip(logit, 0) - logit * labels
                            + jnp.log1p(jnp.exp(-jnp.abs(logit))))
        loss, (ge, gw1, gb1, gw2) = jax.value_and_grad(
            loss_of, argnums=(0, 1, 2, 3))(emb, w1, b1, w2)
        return loss, ge, w1 - lr * gw1, b1 - lr * gb1, w2 - lr * gw2

    @jax.jit
    def dense_chunk(embs, w1, b1, w2):
        def body(carry, emb):
            loss, ge, *carry = one_step(emb, *carry)
            return tuple(carry), (loss, ge)
        ws, (losses, ges) = lax.scan(body, (w1, b1, w2), embs)
        return losses.mean(), ges, ws

    loss, ges, ws = dense_chunk(jnp.asarray(embs), *map(jnp.asarray, params))
    return float(loss), np.asarray(ges), [np.asarray(w) for w in ws]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_deepfm_dense_chunk_matches_jax(smoke):
    """The port's dense chunk (torch autograd, SGD carried through K
    batches) against the bench's JAX one on the same inputs, fp32."""
    import torch
    _, _, params, labels = smoke.deepfm_data(B=16, K=3)
    embs = (np.random.RandomState(1).randn(3, 16 * 26, 8) * 0.05).astype(
        np.float32)
    loss, ges, ws = _jax_dense_chunk(embs, params, labels)
    t_loss, t_ges, t_ws = smoke.deepfm_dense_chunk(
        torch, torch.from_numpy(embs), [torch.from_numpy(p) for p in params],
        torch.from_numpy(labels))
    assert abs(float(t_loss) - loss) <= 1e-6 * abs(loss)
    assert _rel(t_ges.numpy(), ges) <= 1e-5
    for t, w in zip(t_ws, ws):
        assert _rel(t.numpy(), w) <= 1e-6


def test_deepfm_chunk_through_both_packages(smoke):
    """One chunk of the leg (pull K id sets, the dense chunk, push the K
    row-gradient sets in ordered pieces, pull the chunk's ids back)
    through the JAX server, client and dense step, and through the
    port's (`chip_smoke.deepfm_chunk` on the CPU): the rows agree within
    the smoke's PS_ROWS_ATOL, the weights within 1e-6."""
    import torch
    distinct, _, params, labels = smoke.deepfm_data(B=64, K=4)
    ids = distinct[0]
    rows, _loss, _ges, ws = smoke.deepfm_chunk(torch, 'cpu', ids, params,
                                               labels)
    srv = _server('jax')
    srv.add_table(0, dim=8, optimizer='adagrad', seed=3)
    srv.start()
    client = _client('jax', srv)
    embs = np.stack([client.pull(0, f, 8) for f in ids])
    _, ges, jws = _jax_dense_chunk(embs, params, labels)
    step = smoke.PS_ORDERED_PUSH
    for f, g in zip(ids, ges):
        for lo in range(0, len(f), step):
            client.push(0, f[lo:lo + step], g[lo:lo + step], lr=0.05)
    want = client.pull(0, np.unique(ids), 8)
    client.shutdown()
    client.close()
    assert np.abs(rows - want).max() <= smoke.PS_ROWS_ATOL
    for t, w in zip(ws, jws):
        assert _rel(t, w) <= 1e-6


def test_deepfm_chunk_fp32_against_fp64(smoke):
    """The grounding of PS_ROWS_ATOL: the leg's first chunk at full size
    (B = 512, K = 16) with the dense step in fp32 against float64 moves no
    row by more than a tenth of the bar."""
    import torch
    distinct, _, params, labels = smoke.deepfm_data()
    ids = distinct[0]
    f32 = smoke.deepfm_chunk(torch, 'cpu', ids, params, labels)
    f64 = smoke.deepfm_chunk(torch, 'cpu', ids, params, labels,
                             dtype=torch.float64)
    assert np.abs(f32[0] - f64[0]).max() <= smoke.PS_ROWS_ATOL / 10
