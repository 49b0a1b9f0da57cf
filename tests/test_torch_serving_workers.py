"""The port's worker replicas and control channel against the JAX
package's (tests/test_serving_cluster.py::TestControlChannel and
::TestSubprocessCluster): the channel's wire against the JAX channel in
both directions, what each channel error makes the router do, a
ReplicaWorker in this process behind a RemoteReplica, and two worker
processes spawned on the CPU (`--device cpu`) behind the router: tokens
equal to an in-process engine over the same seed's weights, affinity
above round-robin, and a forced hang that writes its report, drains and
finishes on the peer. Every wait has its own deadline, so a wedged
worker fails a test instead of hanging the suite."""
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving.cluster import channel as jchannel
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving import chain_hashes
from paddle_tpu_torch.serving.cluster import (ClusterRouter, LocalReplica,
                                              RemoteReplica, ReplicaWorker,
                                              channel)
from paddle_tpu_torch.serving.cluster import replica as treplica

MODEL_KW = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                max_seq_len=128, hidden_dropout=0.0, attn_dropout=0.0,
                use_flash_attention=False)
ENGINE_KW = dict(page_size=8, max_batch_size=3, prefill_chunk=16)
SEED = 0


@pytest.fixture(scope='module')
def model():
    return treplica.worker_model(MODEL_KW, SEED, device='cpu')


def _mixed_prompts():
    rng = np.random.RandomState(1)
    fam = [list(rng.randint(1, 128, 24)) for _ in range(2)]
    order = [0, 1, 0, 1, 1, 0, 0, 1, 0, 1]
    return [fam[f] + list(rng.randint(1, 128, int(rng.randint(2, 10))))
            for f in order]


def _single(model, prompts, max_new=8):
    eng = ServingEngine(model, ServingConfig(**ENGINE_KW), device='cpu')
    out = eng.generate(prompts, max_new_tokens=max_new, top_k=0)
    eng.shutdown()
    return out


def _round_robin_affinity_hits(prompts, n_replicas, page_size):
    digests = [set() for _ in range(n_replicas)]
    hits = 0
    for i, p in enumerate(prompts):
        h = chain_hashes(p, page_size, limit=len(p) - 1)
        if h and h[0] in digests[i % n_replicas]:
            hits += 1
        digests[i % n_replicas].update(h)
    return hits


# ---------------------------------------------------------------------------
# the control channel
# ---------------------------------------------------------------------------
def test_timeout_drops_connection_no_stale_replies():
    """The reference's TestControlChannel case on the port: a call that
    timed out drops its connection, so the late reply never answers the
    next call."""
    def handler(msg):
        if msg.get('op') == 'slow':
            time.sleep(1.0)
            return {'which': 'slow'}
        return {'which': 'fast'}

    server = channel.ControlServer(handler).start()
    try:
        client = channel.ControlClient('127.0.0.1', server.port, timeout=5.0)
        with pytest.raises((socket.timeout, OSError)):
            client.call({'op': 'slow'}, timeout=0.2)
        for _ in range(3):
            assert client.call({'op': 'fast'}, timeout=5.0) == {
                'which': 'fast'}
        client.close()
    finally:
        server.close()


FRAMES = [{'op': 'submit', 'prompt': [1, 2, 3], 'opts': {'top_k': 0},
           'route': None},
          {'op': 'poll'},
          {'reqs': {'7': {'generated': [5, 9], 'state': 'running',
                          'done': False}}},
          {'note': 'utf-8 ✓', 'x': 1.5, 'nested': [[], {}]}]


@pytest.mark.parametrize('frame', FRAMES, ids=['submit', 'poll', 'reply',
                                               'mixed'])
def test_frames_equal_reference_bytes(frame):
    """The same message is the same bytes on both wires, and each side
    reads the other's frame back."""
    a, b = socket.socketpair()
    try:
        channel.send_msg(a, frame)
        jchannel.send_msg(a, frame)
        mine = b.recv(1 << 16)
        assert len(mine) % 2 == 0
        assert mine[:len(mine) // 2] == mine[len(mine) // 2:]
        channel.send_msg(a, frame)
        assert jchannel.recv_msg(b) == frame
        jchannel.send_msg(a, frame)
        assert channel.recv_msg(b) == frame
    finally:
        a.close()
        b.close()


def _echo(msg):
    if msg.get('op') == 'boom':
        raise KeyError('engine fault')
    if msg.get('op') == 'big':
        return {'pad': 'x' * 1000}
    return {'echo': msg, 'n': len(msg.get('prompt', []))}


@pytest.mark.parametrize('direction', ['port_client', 'jax_client'])
def test_channel_talks_to_reference_channel(direction):
    """A port ControlClient against a JAX ControlServer and the reverse:
    replies, a handler error as RuntimeError, and the connection still in
    step after it."""
    Server, Client = ((jchannel.ControlServer, channel.ControlClient)
                      if direction == 'port_client'
                      else (channel.ControlServer, jchannel.ControlClient))
    server = Server(_echo).start()
    try:
        client = Client('127.0.0.1', server.port, timeout=5.0)
        for frame in FRAMES[:2]:
            assert client.call(frame) == {'echo': frame,
                                          'n': len(frame.get('prompt', []))}
        with pytest.raises(RuntimeError, match='engine fault'):
            client.call({'op': 'boom'})
        assert client.call({'op': 'poll'})['echo'] == {'op': 'poll'}
        client.close()
    finally:
        server.close()


def test_oversized_reply_raises_value_error_and_redials(monkeypatch):
    """A reply frame over the cap raises ValueError and drops the
    connection; the next call dials afresh and is answered in step."""
    server = jchannel.ControlServer(_echo).start()
    try:
        client = channel.ControlClient('127.0.0.1', server.port, timeout=5.0)
        monkeypatch.setattr(channel, 'MAX_MSG', 256)
        with pytest.raises(ValueError, match='exceeds cap'):
            client.call({'op': 'big'})
        assert client._sock is None
        assert client.call({'op': 'poll'})['echo'] == {'op': 'poll'}
        client.close()
    finally:
        server.close()


# ---------------------------------------------------------------------------
# what each channel error makes the router do
# ---------------------------------------------------------------------------
def _fault_cluster(model, fault, monkeypatch):
    """Replica 'a' a worker in this process behind its channel, replica
    'b' in-process; `fault` breaks a's channel or a's engine."""
    worker = ReplicaWorker(ServingEngine(model, ServingConfig(**ENGINE_KW),
                                         device='cpu'), 'a').start()
    remote = RemoteReplica('a', '127.0.0.1', worker.port,
                           timeout=0.5 if fault == 'slow' else 10.0)
    peer = LocalReplica(ServingEngine(model, ServingConfig(**ENGINE_KW),
                                      device='cpu'), 'b')
    router = ClusterRouter([remote, peer], page_size=8, max_queue=8)
    router.refresh()
    prompt = list(range(1, 13))
    if fault == 'dead':
        worker.stop()
    elif fault == 'slow':
        real = worker.submit

        def slow(*a, **k):
            time.sleep(1.5)
            return real(*a, **k)
        monkeypatch.setattr(worker, 'submit', slow)
    elif fault == 'oversize':
        monkeypatch.setattr(channel, 'MAX_MSG', 16 * 1024)
        prompt = list(range(10000, 14000))
    else:                                   # the worker's engine raises
        prompt = list(range(1, 200))        # past max_seq_len 128
    return worker, remote, peer, router, prompt


@pytest.mark.parametrize('fault,exc', [
    ('dead', None), ('slow', None), ('oversize', ValueError),
    ('engine', RuntimeError)])
def test_channel_errors_drain_only_when_the_replica_is_at_fault(
        model, fault, exc, monkeypatch):
    """ConnectionError (a worker gone) and socket.timeout (a worker too
    slow) drain the replica and the request lands on the peer; a frame
    over the cap (ValueError) and the worker's engine error (RuntimeError)
    reach the caller with nothing drained."""
    worker, remote, peer, router, prompt = _fault_cluster(model, fault,
                                                          monkeypatch)
    try:
        if exc is None:
            req = router.submit(prompt, max_new_tokens=4, top_k=0)
            assert [e['replica_id'] for e in router.drain_events] == ['a']
            assert req.replica_id == 'b' and router.healthy_replicas() == [
                'b']
            router.run(timeout_s=60)
            assert req.done and len(req.tokens) == 4
        else:
            with pytest.raises(exc):
                router.submit(prompt, max_new_tokens=4, top_k=0)
            assert router.drain_events == []
            assert router.healthy_replicas() == ['a', 'b']
    finally:
        worker.stop()
        remote.client.close()
        peer.shutdown()


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------
def test_in_process_worker_equals_local_replica(model):
    """A ReplicaWorker on a thread of this process behind a RemoteReplica
    serves the stream with a LocalReplica's tokens, and its control ops
    answer over the channel."""
    prompts = _mixed_prompts()
    local = ClusterRouter([LocalReplica(ServingEngine(
        model, ServingConfig(**ENGINE_KW), device='cpu'), 'l0')],
        page_size=8, max_queue=32)
    want = local.serve(prompts, max_new_tokens=8, top_k=0, timeout_s=120)
    local.shutdown()
    worker = ReplicaWorker(ServingEngine(model, ServingConfig(**ENGINE_KW),
                                         device='cpu'), 'w0').start()
    remote = RemoteReplica('w0', '127.0.0.1', worker.port, timeout=10.0)
    try:
        router = ClusterRouter([remote], page_size=8, max_queue=32)
        assert router.serve(prompts, max_new_tokens=8, top_k=0,
                            timeout_s=120) == want
        st = remote.status()
        assert st['replica_id'] == 'w0' and not st['hung']
        assert st['prefix_digest'] and st['goodput']['emitted_tokens'] > 0
        assert remote.metrics()['series'][
            'ptpu_serve_requests_completed_total'] == len(prompts)
        assert remote.prefetch([1, 2, 3]) == {'warmed_pages': 0}
        assert remote.drain() == []
        with pytest.raises(RuntimeError, match='draining'):
            remote.submit([1, 2, 3], {'max_new_tokens': 2})
        rec = worker.exit_record()
        assert rec['device'] == 'cpu' and rec['engines'][0][
            'requests_completed_total'] == len(prompts)
    finally:
        remote.shutdown()
        worker.stop()
    assert not worker.server._thread.is_alive()
    assert not worker._loop_thread.is_alive()


def test_worker_refuses_mp_above_one():
    with pytest.raises(SystemExit, match='item 7'):
        treplica.main(['--mp', '2', '--device', 'cpu'])


def _spawn(rid, tmp_path):
    return RemoteReplica.spawn(
        rid, MODEL_KW, ENGINE_KW, seed=SEED, hang_timeout_s=2.0,
        device='cpu', ready_timeout_s=120.0,
        env={'PTPU_SERVE_REPORT_DIR': str(tmp_path),
             'OMP_NUM_THREADS': '1'})


def test_subprocess_cluster_end_to_end(model, tmp_path):
    """The reference's TestSubprocessCluster on the port: two workers
    spawned with --device cpu serve the stream with the tokens of an
    engine over the same seed's weights, affinity beats round-robin; a
    hang injected into one worker's step loop writes its report (stacks
    and the flight recorder), the router drains it, and its requests
    finish on the peer with the reference tokens. Both workers then exit
    with code 0 and report their launch counts (none on the CPU)."""
    prompts = _mixed_prompts()
    rng = np.random.RandomState(9)
    long_prompts = [prompts[0][:24] + list(rng.randint(1, 128, 4))
                    for _ in range(4)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the workers' thread count
    try:
        want = _single(model, prompts)
        want_long = _single(model, long_prompts, max_new=16)
    finally:
        torch.set_num_threads(threads)
    reps = [None, None]

    def spawn(i):
        reps[i] = _spawn(f'w{i}', tmp_path)
    spawners = [threading.Thread(target=spawn, args=(i,)) for i in (0, 1)]
    for t in spawners:
        t.start()
    for t in spawners:
        t.join(timeout=150)
    try:
        assert all(reps), 'a worker did not become ready'
        router = ClusterRouter(reps, page_size=8, max_queue=32,
                               hang_timeout_s=5.0)
        assert router.serve(prompts, max_new_tokens=8, top_k=0,
                            timeout_s=120) == want
        snap = router.snapshot()
        assert snap['placements']['affinity'] > \
            _round_robin_affinity_hits(prompts, 2, 8), snap
        assert snap['placements']['drain'] == 0

        reqs = [router.submit(p, max_new_tokens=16, top_k=0)
                for p in long_prompts]
        hung = router._replicas[reqs[0].replica_id]
        hung.inject_hang()
        router.run(timeout_s=120)
        assert [r.output_ids() for r in reqs] == want_long
        snap = router.snapshot()
        assert snap['placements']['drain'] >= 1, snap
        moved = [r for r in reqs if r.resubmits]
        assert moved and sum(e['resubmitted'] for e in
                             snap['drain_events']) == len(moved)
        assert all(r.replica_id != hung.replica_id for r in moved)
        report = tmp_path / f'replica_hang.{hung.replica_id}.json'
        deadline = time.time() + 10
        while time.time() < deadline and not report.exists():
            time.sleep(0.1)
        doc = json.loads(report.read_text())
        assert doc['kind'] == 'replica_hang_report'
        assert doc['stacks'] and doc['flight_recorder']['kind'] == \
            'flight_recorder'
        router.shutdown()
    finally:
        for r in reps:
            if r is not None:
                r.shutdown(timeout=30)
    assert [r.returncode for r in reps] == [0, 0], \
        [list(r.output)[-20:] for r in reps]
    for r in reps:
        rec = r.exit_record
        assert rec['replica_id'] == r.replica_id and rec['device'] == 'cpu'
        assert not any(rec['launches'].values())
        assert rec['engines'][0]['decode_steps_total'] > 0
