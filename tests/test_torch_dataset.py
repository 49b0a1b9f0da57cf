"""The port's CTR data side against the JAX package's: the MultiSlot
generators' wire text byte for byte, the datasets' batches through the
same pipe_command over the same files (in order at thread_num 1, as a
multiset of rows at 2), the width-mismatch refusal, FileInstantDataset
and BoxPSDataset, and NativeDataFeed over the port's own build of
csrc/data_feed.cc. The pipe script imports the port's generator, which
starts without torch."""
import io
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.core import native as jnative
from paddle_tpu_torch.core import native as tnative
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch import distributed as tdist

REPO = Path(__file__).resolve().parents[1]
FIELDS, DENSE = 3, 2

GEN_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.distributed.fleet.data_generator import (
    MultiSlotDataGenerator)


class CtrGen(MultiSlotDataGenerator):
    def generate_sample(self, line):
        def it():
            parts = line.split()
            yield [('dense', [float(x) for x in parts[1:{d1}]]),
                   ('ids', [int(x) for x in parts[{d1}:]]),
                   ('label', [int(parts[0])])]
        return it


if __name__ == '__main__':
    assert 'torch' not in sys.modules
    CtrGen().run_from_stdin()
"""


def _slots():
    return [types.SimpleNamespace(shape=[DENSE], dtype='float32'),
            types.SimpleNamespace(shape=[FIELDS], dtype='int64'),
            types.SimpleNamespace(shape=[1], dtype='int64')]


@pytest.fixture(scope='module')
def ctr_files(tmp_path_factory):
    """2 raw files of 30 lines (label, dense floats, ids), the pipe, and
    the same rows in the native feed's layout (for the cases that need
    no pipe)."""
    d = tmp_path_factory.mktemp('ctr')
    rng = np.random.RandomState(0)
    files, dense_files = [], []
    for k in range(2):
        p, q = d / f'part-{k}.txt', d / f'dense-{k}.txt'
        with open(p, 'w') as f, open(q, 'w') as g:
            for _ in range(30):
                dense = ' '.join(f'{x:.5f}' for x in rng.rand(DENSE))
                ids = ' '.join(str(i) for i in rng.randint(0, 10 ** 7,
                                                           FIELDS))
                label = rng.randint(0, 2)
                f.write(f'{label} {dense} {ids}\n')
                g.write(f'{dense} | {ids} | {label}\n')
        files.append(str(p))
        dense_files.append(str(q))
    script = d / 'gen.py'
    script.write_text(GEN_SCRIPT.format(repo=str(REPO), d1=1 + DENSE))
    return files, f'{sys.executable} {script}', dense_files


def _host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t.data)


def _batches(ds):
    return [[_host(t) for t in b] for b in ds]


def _rows(batches):
    return sorted(tuple(np.concatenate([s[r].astype(np.float64)
                                        for s in b]))
                  for b in batches for r in range(len(b[0])))


def _dataset(mod, cls, files, pipe, threads, batch=8):
    ds = getattr(mod, cls)()
    ds.init(batch_size=batch, thread_num=threads, use_var=_slots(),
            pipe_command=pipe)
    ds.set_filelist(files)
    return ds


@pytest.mark.parametrize('cls', ['DataGenerator', 'StringDataGenerator'])
def test_generators_wire_text_is_byte_equal(cls):
    samples = [[('words', [1926, 8, 17]), ('label', [1])],
               [('words', [1.5, 2, 3.25]), ('label', [0])],
               [('words', [-4, 0.1, 7]), ('label', [1])]]
    outs = []
    for mod in (jfleet, tfleet):
        base = getattr(mod, f'MultiSlot{cls}')

        class G(base):
            def generate_sample(self, line):
                def it():
                    yield samples[int(line)]
                return it

        g = G()
        g.set_batch(2)
        out = io.StringIO()
        g._run([str(i) for i in range(len(samples))], out)
        outs.append((out.getvalue(), g._proto_info))
    assert outs[0] == outs[1]
    assert outs[1][0].splitlines()[0] == '3 1926 8 17 1 1'


def test_generator_refusals_match():
    for mod in (jfleet, tfleet):
        g = mod.MultiSlotDataGenerator()
        g._gen_str([('a', [1]), ('b', [2])])
        with pytest.raises(ValueError, match='inconsistent'):
            g._gen_str([('a', [1])])
        with pytest.raises(ValueError, match='non-empty'):
            g._gen_str([('a', []), ('b', [2])])
        with pytest.raises(ValueError, match='name mismatch'):
            g._gen_str([('b', [1]), ('a', [2])])
        with pytest.raises(NotImplementedError):
            mod.data_generator.DataGenerator().generate_sample('x')


def test_queue_dataset_equals_reference_in_order(ctr_files):
    files, pipe, _ = ctr_files
    want = _batches(_dataset(jfleet, 'QueueDataset', files, pipe, 1))
    got = list(_dataset(tfleet, 'QueueDataset', files, pipe, 1))
    assert len(got) == len(want) == 8           # 60 lines, batch 8
    for g, w in zip(got, want):
        for gs, ws in zip(g, w):
            np.testing.assert_array_equal(gs.numpy(), ws)
    first = got[0]
    assert [t.dtype for t in first] == [torch.float32, torch.int64,
                                        torch.int64]
    assert [tuple(t.shape) for t in first] == [(8, DENSE), (8, FIELDS),
                                               (8, 1)]


def test_threaded_datasets_equal_reference_as_multisets(ctr_files):
    files, pipe, dense_files = ctr_files
    for cls in ('QueueDataset', 'InMemoryDataset'):
        sets = []
        for mod in (jfleet, tdist):
            ds = _dataset(mod, cls, dense_files, None, 2)
            if cls == 'InMemoryDataset':
                ds.load_into_memory()
                ds.local_shuffle()
                assert ds.get_memory_data_size() == 60
            sets.append(_rows(_batches(ds)))
        assert sets[0] == sets[1] and len(sets[1]) == 60
    piped = _rows(_batches(_dataset(tfleet, 'QueueDataset', files, pipe,
                                    2)))
    assert piped == sets[1]


def test_in_memory_shuffle_equals_reference(ctr_files):
    dense_files = ctr_files[2]
    orders = []
    for mod in (jfleet, tfleet):
        ds = _dataset(mod, 'InMemoryDataset', dense_files, None, 1,
                      batch=60)
        with pytest.raises(RuntimeError, match='load_into_memory'):
            next(iter(ds))
        ds.load_into_memory()
        ds.local_shuffle()
        ds.global_shuffle()
        orders.append(_batches(ds))
        ds.release_memory()
        assert ds.get_memory_data_size() == 0
    for g, w in zip(orders[1][0], orders[0][0]):
        np.testing.assert_array_equal(g, w)


def test_width_mismatch_and_failing_pipe_are_loud(tmp_path, ctr_files):
    ds = tfleet.QueueDataset()
    ds.init(batch_size=4, use_var=_slots())
    with pytest.raises(ValueError, match='fixed width'):
        ds._multislot_to_dense(['1 1.0 3 1 2 3 1 1'], tmp_path / 'o')
    with pytest.raises(ValueError, match='ran out'):
        ds._multislot_to_dense(['2 1.0 2.0'], tmp_path / 'o')
    with pytest.raises(ValueError, match='trailing'):
        ds._multislot_to_dense(['2 1.0 2.0 3 1 2 3 1 1 9'], tmp_path / 'o')
    files = ctr_files[0]
    bad = _dataset(tfleet, 'QueueDataset', files[:1],
                   f'{sys.executable} -c "import sys; sys.exit(3)"', 1)
    with pytest.raises(RuntimeError, match='rc=3'):
        list(bad)


def test_file_instant_and_boxps_datasets(tmp_path):
    p = tmp_path / 'd.txt'
    with open(p, 'w') as f:
        for i in range(8):
            f.write(f'{i}.0 {i}.5 | 1 2 3 | {i % 2}\n')
    fi = tfleet.FileInstantDataset()
    fi.init(batch_size=4, thread_num=4, use_var=_slots())
    assert fi._thread_num == 1
    fi.set_filelist([str(p)])
    feats = np.concatenate([f.numpy() for f, _, _ in fi])
    np.testing.assert_array_equal(feats[:, 0], np.arange(8))

    bx = tfleet.BoxPSDataset()
    bx.init(batch_size=4, use_var=_slots())
    bx.set_filelist([str(p)])
    bx.begin_pass()
    bx.preload_into_memory()
    bx.wait_preload_done()
    assert bx.get_memory_data_size() == 8
    assert sum(f.shape[0] for f, _, _ in bx) == 8
    bx.end_pass()
    with pytest.raises(NotImplementedError, match='slots_shuffle'):
        bx.slots_shuffle(['feat'])


def test_native_data_feed_equals_reference(tmp_path):
    p = tmp_path / 'd.txt'
    rng = np.random.RandomState(1)
    with open(p, 'w') as f:
        for _ in range(37):
            f.write(' '.join(f'{x:.4f}' for x in rng.rand(2)) + ' | '
                    + ' '.join(str(i) for i in rng.randint(0, 99, 3))
                    + '\n')
    slots = [(2, 'float'), (3, 'int64')]
    feeds = []
    for mod in (jnative, tnative):
        feed = mod.NativeDataFeed(slots, 8, num_threads=1)
        feed.set_filelist([str(p)])
        feeds.append(feed)
    got = [[], []]
    for k, feed in enumerate(feeds):
        feed.load_into_memory(seed=5)
        assert feed.memory_size() == 37
        got[k].append(list(feed.iter_memory()))
        feed.rewind(reshuffle=True, seed=6)
        got[k].append(list(feed.iter_memory()))
    for pass_t, pass_j in zip(got[1], got[0]):
        assert [len(f) for f, _ in pass_t] == [8, 8, 8, 8, 5]
        for (ft, it), (fj, ij) in zip(pass_t, pass_j):
            np.testing.assert_array_equal(ft, fj)
            np.testing.assert_array_equal(it, ij)
    stream = tnative.NativeDataFeed(slots, 16, num_threads=1)
    stream.set_filelist([str(p)])
    stream.start()
    assert sum(len(f) for f, _ in stream) == 37


def test_native_digest_covers_the_included_header(tmp_path, monkeypatch):
    """An edited csrc/channel.h (included by data_feed.cc) names another
    library, so it rebuilds."""
    import shutil
    for name in tnative.SOURCES + tnative.HEADERS:
        shutil.copy(tnative.CSRC / name, tmp_path / name)
    monkeypatch.setattr(tnative, 'CSRC', tmp_path)
    before = tnative._digest('g++')
    with open(tmp_path / 'channel.h', 'a') as f:
        f.write('\n// edited\n')
    assert tnative._digest('g++') != before
    assert '#include "channel.h"' in (tmp_path / 'data_feed.cc').read_text()
