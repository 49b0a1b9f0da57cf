"""paddle.io — counterpart of `paddle_tpu/io/__init__.py`: the datasets,
the samplers, `default_collate_fn`, `DataLoader` with worker processes,
`get_worker_info`, and `DeviceLoader` (device_loader.py), the background
prefetch of host batches onto the card.

The samplers draw from numpy's global generator, as the reference's do
(`RandomSampler`'s `generator=` is accepted and ignored there too), so
one `np.random.seed` gives both packages the same batches. A batch is a
tuple of CPU torch tensors (numpy samples are stacked, ints become
int64, floats fp32); the caller moves it to the card (`hapi.Model` does,
or a `DeviceLoader` around the loader).

Workers (`num_workers > 0` over a map-style dataset) are processes that
read index batches from a queue and send back raw samples, which the
parent collates, reordered to the sampler's order; a worker exits when
its parent dies, and the parent raises when every worker has died. A
worker never touches the device. The start method is 'spawn' whenever
the dataset and `worker_init_fn` pickle, as the reference chooses it:
a fresh interpreter inherits neither the parent's CUDA context nor the
locks its threads hold. When they do not pickle the reference forks
with a warning; the port does too while CUDA is not initialized in this
process, and raises once it is: a child forked from a process with a
live CUDA context may not use that context, and the threads of torch
and of the CUDA runtime can leave a lock held in the child.
"""
import itertools
import os
import queue as _queue
import threading
import time as _time

import numpy as np

from .device_loader import DeviceLoader


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of a permutation drawn from numpy's global generator
    (`generator` is ignored, as the reference ignores it)."""
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(f'random_split: lengths sum to {total}, the '
                         f'dataset holds {len(dataset)}')
    perm = np.random.permutation(total)
    out, off = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[off:off + ln].tolist()))
        off += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """The index space padded to a multiple of the ranks and dealt round
    robin; `shuffle` permutes it with `RandomState(epoch)` first, the
    epoch advancing once a pass."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            world, me = _world()
            num_replicas = num_replicas or world
            rank = rank if rank is not None else me
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(indices)
            self.epoch += 1
        indices = np.concatenate([indices, indices[:self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """A list of samples as one batch of CPU tensors, field by field:
    numpy arrays and tensors stacked, ints int64, floats fp32, tuples
    and dicts per field; anything else is left a list."""
    import torch
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, torch.Tensor):
        return torch.stack([s.cpu() for s in batch])
    if isinstance(sample, (bool, np.bool_)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(items))
                     for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


class WorkerInfo:
    """What `get_worker_info()` returns inside a worker process."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_WORKER_INFO = None


def get_worker_info():
    """The `WorkerInfo` of the worker this runs in; None in the main
    process."""
    return _WORKER_INFO


def _worker_loop(setup_q, index_q, result_q, parent_pid, worker_id,
                 num_workers):
    """A worker: its dataset and init function from `setup_q`, then
    index batches in, raw samples out; exits on None, when its parent
    has died, or after sending an error."""
    global _WORKER_INFO
    dataset, worker_init_fn = setup_q.get()
    _WORKER_INFO = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        try:
            worker_init_fn(worker_id)
        except Exception as e:      # sent to the parent, which raises
            result_q.put((-1, None, f"worker_init_fn: {e!r}"))
            return
    while True:
        if os.getppid() != parent_pid:
            return
        try:
            item = index_q.get(timeout=1.0)
        except _queue.Empty:
            continue
        if item is None:
            return
        idx, indices = item
        try:
            result_q.put((idx, [dataset[i] for i in indices], None))
        except Exception as e:      # sent to the parent, which raises
            result_q.put((idx, None, repr(e)))
            return


def _cuda_initialized():
    import torch
    return torch.cuda.is_initialized()


class DataLoader:
    """Batches of a dataset through a `BatchSampler` (or `batch_sampler`),
    collated by `collate_fn`; `num_workers > 0` reads a map-style
    dataset in worker processes and an iterable one on a background
    thread. `feed_list`, `places`, `return_list`, `use_buffer_reader`
    and `use_shared_memory` are accepted for the reference's signature;
    the loader yields CPU tensors whatever they say."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch = max(2, prefetch_factor)
        self._worker_init_fn = worker_init_fn
        self._timeout = timeout
        self._iterable_ds = isinstance(dataset, IterableDataset)
        self._mp_method = None
        self.batch_size = batch_size
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif not self._iterable_ds and batch_size is not None:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
        else:
            self.batch_sampler = None

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("DataLoader over IterableDataset has no len()")

    def _gen(self):
        from .. import profiler as _prof
        from ..core.monitor import histogram
        produce_h = histogram('ptpu_dataloader_produce_seconds',
                              help='time to read+collate one batch')
        if self._iterable_ds:
            it = iter(self.dataset)
            bs = self.batch_size or 1
            while True:
                t0 = _time.perf_counter()
                with _prof.RecordEvent('dataloader::produce',
                                       event_type='dataloader'):
                    batch = list(itertools.islice(it, bs))
                    if not batch or (len(batch) < bs and self.drop_last):
                        return
                    out = self.collate_fn(batch)
                produce_h.observe(_time.perf_counter() - t0)
                yield out
        else:
            for indices in self.batch_sampler:
                t0 = _time.perf_counter()
                with _prof.RecordEvent('dataloader::produce',
                                       event_type='dataloader'):
                    out = self.collate_fn(
                        [self.dataset[i] for i in indices])
                produce_h.observe(_time.perf_counter() - t0)
                yield out

    def __iter__(self):
        """The batches; `dataloader::next` spans (and the wait histogram)
        time how long the consumer waits for each, `dataloader::produce`
        how long a batch takes to read and collate."""
        from .. import profiler as _prof
        from ..core.monitor import counter, histogram
        wait_h = histogram('ptpu_dataloader_wait_seconds',
                           help='time the consumer waits for the next batch')
        batches = counter('ptpu_dataloader_batches_total',
                          help='batches yielded to the consumer')
        if self.num_workers == 0:
            inner = self._gen()
        elif self._iterable_ds or self.batch_sampler is None:
            inner = self._thread_iter()
        else:
            inner = self._multiprocess_iter()
        while True:
            t0 = _time.perf_counter()
            with _prof.RecordEvent('dataloader::next',
                                   event_type='dataloader'):
                try:
                    batch = next(inner)
                except StopIteration:
                    return
            wait_h.observe(_time.perf_counter() - t0)
            batches.inc(1)
            yield batch

    def _thread_iter(self):
        """Background-thread prefetch (the iterable-dataset route)."""
        q = _queue.Queue(maxsize=self.prefetch)
        done = object()

        def producer():
            try:
                for item in self._gen():
                    q.put(item)
            finally:
                q.put(done)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item

    def _mp_start_method(self):
        """'spawn' when the dataset and worker_init_fn pickle; else 'fork'
        with a warning, unless CUDA is initialized here (then raises).
        Decided once; the probe pickles into a null sink."""
        if self._mp_method is not None:
            return self._mp_method
        import pickle
        import warnings

        class _Null:
            def write(self, _):
                return 0
        try:
            pickle.Pickler(_Null()).dump(self.dataset)
            pickle.Pickler(_Null()).dump(self._worker_init_fn)
            self._mp_method = 'spawn'
        except Exception as e:
            if _cuda_initialized():
                raise RuntimeError(
                    'DataLoader: the dataset or worker_init_fn does not '
                    'pickle, so the workers would have to fork, and CUDA '
                    'is initialized in this process; make them picklable '
                    '(a module-level class) or use num_workers=0') from e
            warnings.warn(
                "DataLoader dataset/worker_init_fn is not picklable; "
                "falling back to the 'fork' start method.", RuntimeWarning)
            self._mp_method = 'fork'
        return self._mp_method

    def _multiprocess_iter(self):
        """Worker processes over an index queue, results reordered to
        the sampler's order and collated here. `timeout` > 0 bounds the
        wait for one batch. The dataset goes to each worker through a
        queue, not the process's arguments: a spawned child that dies
        before reading its arguments would leave the parent blocked in
        `start()` on a payload larger than the pipe holds."""
        import multiprocessing as mp
        ctx = mp.get_context(self._mp_start_method())
        window = self.prefetch * self.num_workers
        setup_q = ctx.Queue()
        index_q = ctx.Queue(maxsize=window)
        result_q = ctx.Queue(maxsize=window)
        total = {}

        def feeder():
            n = 0
            for item in enumerate(self.batch_sampler):
                index_q.put(item)
                n += 1
            total['n'] = n
            for _ in range(self.num_workers):
                index_q.put(None)

        workers = [
            ctx.Process(target=_worker_loop,
                        args=(setup_q, index_q, result_q, os.getpid(), wid,
                              self.num_workers),
                        daemon=True)
            for wid in range(self.num_workers)]
        for w in workers:
            w.start()
            setup_q.put((self.dataset, self._worker_init_fn))
        threading.Thread(target=feeder, daemon=True).start()
        per_batch = self._timeout or None
        pending = {}
        want = 0
        try:
            while not ('n' in total and want >= total['n']):
                waited = 0.0
                while want not in pending:
                    try:
                        idx, samples, err = result_q.get(timeout=1.0)
                    except _queue.Empty:
                        if 'n' in total and want >= total['n']:
                            break
                        if not any(w.is_alive() for w in workers):
                            raise RuntimeError(
                                'DataLoader workers died (see worker '
                                'stderr)')
                        waited += 1.0
                        if per_batch is not None and waited >= per_batch:
                            raise RuntimeError(
                                'DataLoader worker timeout '
                                f'({per_batch}s for one batch)')
                        continue
                    if err is not None:
                        raise RuntimeError(f'DataLoader worker: {err}')
                    pending[idx] = samples
                if want in pending:
                    yield self.collate_fn(pending.pop(want))
                    want += 1
        finally:
            for w in workers:
                if w.is_alive():
                    w.terminate()
            for w in workers:
                w.join(timeout=5)
            for q in (setup_q, index_q, result_q):
                q.cancel_join_thread()
                q.close()


__all__ = ['Dataset', 'IterableDataset', 'TensorDataset', 'ComposeDataset',
           'ChainDataset', 'Subset', 'random_split', 'Sampler',
           'SequenceSampler', 'RandomSampler', 'WeightedRandomSampler',
           'BatchSampler', 'DistributedBatchSampler', 'default_collate_fn',
           'DataLoader', 'get_worker_info', 'WorkerInfo', 'DeviceLoader']
