"""The host C++ tables of the parameter server and the MultiSlot data
feed, through ctypes — the port's copy of the table and feed subset of
`paddle_tpu/core/native.py`.

Build: at first use (never at import) the sparse/SSD/dense table source
and the data feed of the repository's host library,
`csrc/sparse_table.cc` and `csrc/data_feed.cc`, are compiled
with `csrc/Makefile`'s flags (`g++ -O2 -std=c++17 -fPIC -Wall -pthread
-shared`; `$CXX` names another compiler, as in the Makefile) into the
port's build directory: `native/libpaddle_tpu_native-<digest>.so` under
`ops/kernels/_build.build_dir()` (`build/paddle_tpu_torch/` at the
repository root, or `$PADDLE_TPU_TORCH_BUILD_DIR`). The digest covers
the sources, the header they include (`csrc/channel.h`) and the flags,
so an edited source or header rebuilds. Several
processes may ask at once: the build runs under an `fcntl.flock` on the
directory's lock file, into a temporary name that `os.replace` makes
the library. Nothing is written into `csrc/`, where the JAX package
builds and loads its own copy of the same library.

There is no fallback: a failed build or `dlopen` raises, where the
reference's `load_native(required=False)` returns None.

The TCP store and the host profiler of the same library are not bound
here (ROADMAP Queue 1 item 7).
"""
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..ops.kernels import _build

CSRC = _build.REPO / 'csrc'
SOURCES = ('sparse_table.cc', 'data_feed.cc')
HEADERS = ('channel.h',)          # included by data_feed.cc
CXXFLAGS = ('-O2', '-std=c++17', '-fPIC', '-Wall', '-pthread', '-shared')

_LIB = None
_LIB_LOCK = threading.Lock()


def _digest(cxx):
    h = hashlib.sha256(' '.join((cxx,) + CXXFLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the table library unless this source's build is there;
    returns its path. Raises RuntimeError when the compiler fails."""
    cxx = os.environ.get('CXX') or 'g++'
    out_dir = _build.build_dir() / 'native'
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f'libpaddle_tpu_native-{_digest(cxx)}.so'
    with open(out_dir / 'lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path
        tmp = out_dir / f'.{lib_path.name}.{os.getpid()}'
        cmd = [cxx, *CXXFLAGS, *[str(CSRC / s) for s in SOURCES],
               '-o', str(tmp)]
        try:
            res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
        except OSError as e:
            raise RuntimeError(f'native build failed: $ {" ".join(cmd)}: '
                               f'{e}') from e
        if res.returncode:
            raise RuntimeError(f'native build failed:\n$ {" ".join(cmd)}\n'
                               + res.stdout.decode(errors='replace'))
        os.replace(tmp, lib_path)
    return lib_path


_P, _I, _I64, _U64, _F, _S = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                              ctypes.c_uint64, ctypes.c_float,
                              ctypes.c_char_p)
# the symbols of csrc/sparse_table.cc and csrc/data_feed.cc, each
# `ptpu_<name>`: name: (restype, argtypes)
_SIGNATURES = {
    'datafeed_create': (_P, (_P, _P, _I, _I, _I, _I)),
    'datafeed_set_files': (None, (_P, _P, _I)),
    'datafeed_start': (None, (_P,)),
    'datafeed_next': (_I, (_P, _P, _P)),
    'datafeed_load_shuffle': (None, (_P, _U64)),
    'datafeed_next_mem': (_I, (_P, _P, _P)),
    'datafeed_rewind': (None, (_P, _I, _U64)),
    'datafeed_memory_size': (_I64, (_P,)),
    'datafeed_destroy': (None, (_P,)),
    'table_create2': (_P, (_I, _I, _I, _F, _U64, _F, _F, _F)),
    'ssd_table_create': (_P, (_I, _I, _I, _F, _U64, _F, _F, _F, _I64, _S)),
    'ssd_mem_rows': (_I64, (_P,)),
    'ssd_total_rows': (_I64, (_P,)),
    'ssd_flush': (None, (_P,)),
    'ssd_recover': (_I, (_P,)),
    'ssd_save': (_I, (_P, _S)),
    'ssd_load': (_I, (_P, _S)),
    'table_pull': (None, (_P, _P, _I, _P)),
    'table_push': (None, (_P, _P, _I, _P, _F)),
    'table_set': (None, (_P, _P, _I, _P)),
    'table_size': (_I64, (_P,)),
    'table_shrink': (_I64, (_P, _F)),
    'table_save': (_I, (_P, _S)),
    'table_load': (_I, (_P, _S)),
    'table_destroy': (None, (_P,)),
    'dense_create': (_P, (_I64, _I)),
    'dense_set': (None, (_P, _P)),
    'dense_pull': (None, (_P, _P)),
    'dense_push': (None, (_P, _P, _F)),
    'dense_size': (_I64, (_P,)),
    'dense_save': (_I, (_P, _S)),
    'dense_load': (_I, (_P, _S)),
    'dense_destroy': (None, (_P,)),
}


def load_native():
    """The host library, built at first use and loaded once; raises
    when it cannot be built or loaded."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, 'ptpu_' + name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _LIB = lib
        return _LIB


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


_OPTS = {'sgd': 0, 'adagrad': 1, 'adam': 2}


def _opt_code(optimizer):
    if optimizer not in _OPTS:
        raise ValueError(f'optimizer must be one of {tuple(_OPTS)}, got '
                         f'{optimizer!r}')
    return _OPTS[optimizer]


class NativeSparseTable:
    """Parity: distributed/table CommonSparseTable — id -> embedding row
    with the optimizer state inline, rows made on first pull from
    (seed, id), host numpy buffers in and out."""

    def __init__(self, dim, num_shards=16, optimizer='adagrad',
                 init_range=0.05, seed=0, beta1=0.9, beta2=0.999,
                 eps=1e-8):
        self.lib = load_native()
        self.dim = dim
        self.h = self.lib.ptpu_table_create2(
            dim, num_shards, _opt_code(optimizer), init_range, seed, beta1,
            beta2, eps)

    def _rows(self, ids, rows):
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.size != len(ids) * self.dim:
            raise ValueError(f'{rows.shape} rows for {len(ids)} ids of dim '
                             f'{self.dim}')
        return rows

    def pull(self, ids):
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        out = np.empty((len(ids), self.dim), np.float32)
        self.lib.ptpu_table_pull(self.h, _ptr(ids), len(ids), _ptr(out))
        return out

    def push(self, ids, grads, lr=0.01):
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        grads = self._rows(ids, grads)
        self.lib.ptpu_table_push(self.h, _ptr(ids), len(ids), _ptr(grads),
                                 lr)

    def set(self, ids, rows):
        """Assign embedding values (optimizer state untouched)."""
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        rows = self._rows(ids, rows)
        self.lib.ptpu_table_set(self.h, _ptr(ids), len(ids), _ptr(rows))

    def __len__(self):
        return self.lib.ptpu_table_size(self.h)

    def shrink(self, threshold):
        """Drop rows whose L2 norm is below threshold; returns how many."""
        return self.lib.ptpu_table_shrink(self.h, threshold)

    def save(self, path):
        if not self.lib.ptpu_table_save(self.h, path.encode()):
            raise IOError(f'table save failed: {path}')

    def load(self, path):
        if not self.lib.ptpu_table_load(self.h, path.encode()):
            raise IOError(f'table load failed: {path}')

    def __del__(self):
        if getattr(self, 'h', None) and getattr(self, 'lib', None):
            self.lib.ptpu_table_destroy(self.h)
            self.h = None


class NativeSsdSparseTable(NativeSparseTable):
    """Parity: distributed/table/ssd_sparse_table.h — hot rows in memory
    under a row budget, cold rows spilled to per-shard append-only logs
    under `path`; `recover()` rebuilds the index after a restart."""

    def __init__(self, dim, path, num_shards=16, optimizer='adagrad',
                 init_range=0.05, seed=0, beta1=0.9, beta2=0.999,
                 eps=1e-8, mem_budget_rows=1 << 20):
        self.lib = load_native()
        self.dim = dim
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.h = self.lib.ptpu_ssd_table_create(
            dim, num_shards, _opt_code(optimizer), init_range, seed, beta1,
            beta2, eps, mem_budget_rows, path.encode())

    def mem_rows(self):
        return self.lib.ptpu_ssd_mem_rows(self.h)

    def total_rows(self):
        return self.lib.ptpu_ssd_total_rows(self.h)

    def flush(self):
        """Spill all hot rows to the logs (checkpoint, shutdown)."""
        self.lib.ptpu_ssd_flush(self.h)

    def recover(self):
        """Rebuild the id -> offset index from the logs after a restart."""
        if not self.lib.ptpu_ssd_recover(self.h):
            raise IOError(f'ssd table recover failed: {self.path}')

    def __len__(self):
        return self.total_rows()      # the base size counts hot rows only

    def save(self, path):
        """A full snapshot, cold rows included (streamed from the logs)."""
        if not self.lib.ptpu_ssd_save(self.h, path.encode()):
            raise IOError(f'ssd table save failed: {path}')

    def load(self, path):
        """Restore a snapshot straight into the spill logs."""
        if not self.lib.ptpu_ssd_load(self.h, path.encode()):
            raise IOError(f'ssd table load failed: {path}')


class NativeDenseTable:
    """Parity: distributed/table/common_dense_table.h — a fixed-size
    parameter block with the optimizer applied on the server."""

    def __init__(self, size, optimizer='sgd'):
        self.lib = load_native()
        self.size = int(size)
        self.h = self.lib.ptpu_dense_create(self.size, _opt_code(optimizer))

    def _values(self, values):
        v = np.ascontiguousarray(values, np.float32).reshape(-1)
        if len(v) != self.size:
            raise ValueError(f'{len(v)} values for a dense table of '
                             f'{self.size}')
        return v

    def set(self, values):
        self.lib.ptpu_dense_set(self.h, _ptr(self._values(values)))

    def pull(self):
        out = np.empty(self.size, np.float32)
        self.lib.ptpu_dense_pull(self.h, _ptr(out))
        return out

    def push(self, grad, lr=0.01):
        self.lib.ptpu_dense_push(self.h, _ptr(self._values(grad)), lr)

    def save(self, path):
        if not self.lib.ptpu_dense_save(self.h, path.encode()):
            raise IOError(f'dense table save failed: {path}')

    def load(self, path):
        if not self.lib.ptpu_dense_load(self.h, path.encode()):
            raise IOError(f'dense table load failed: {path}')

    def __len__(self):
        return self.size

    def __del__(self):
        if getattr(self, 'h', None) and getattr(self, 'lib', None):
            self.lib.ptpu_dense_destroy(self.h)
            self.h = None


class NativeDataFeed:
    """Parity: framework/data_feed.cc MultiSlotDataFeed — reader threads
    parse fixed-width dense lines (`v1 .. vn | u1 .. um`, a slot a
    field) from the file list into a bounded channel; batches come out
    as host numpy arrays: the float slots side by side [n, fwidth]
    float32, the int64 slots [n, iwidth] int64 (None where there are
    none)."""

    def __init__(self, slots, batch_size, num_threads=2,
                 channel_capacity=4096):
        """slots: list of (width, kind) with kind in {'float', 'int64'}."""
        self.lib = load_native()
        self._widths = np.asarray([w for w, _ in slots], np.int32)
        self._is_float = np.asarray([1 if k == 'float' else 0
                                     for _, k in slots], np.int32)
        self.h = self.lib.ptpu_datafeed_create(
            _ptr(self._widths), _ptr(self._is_float), len(slots),
            batch_size, num_threads, channel_capacity)
        self.batch_size = batch_size
        self.fwidth = sum(w for w, k in slots if k == 'float')
        self.iwidth = sum(w for w, k in slots if k == 'int64')

    def set_filelist(self, files):
        arr = (ctypes.c_char_p * len(files))(*[str(f).encode()
                                               for f in files])
        self.lib.ptpu_datafeed_set_files(self.h, arr, len(files))

    def start(self):
        self.lib.ptpu_datafeed_start(self.h)

    def _batches(self, next_fn):
        while True:
            f = np.empty((self.batch_size, self.fwidth), np.float32) \
                if self.fwidth else None
            i = np.empty((self.batch_size, self.iwidth), np.int64) \
                if self.iwidth else None
            n = next_fn(self.h, None if f is None else _ptr(f),
                        None if i is None else _ptr(i))
            if n == 0:
                return
            yield (None if f is None else f[:n],
                   None if i is None else i[:n])

    def __iter__(self):
        return self._batches(self.lib.ptpu_datafeed_next)

    def load_into_memory(self, seed=0):
        self.lib.ptpu_datafeed_load_shuffle(self.h, seed)

    def memory_size(self):
        return self.lib.ptpu_datafeed_memory_size(self.h)

    def iter_memory(self):
        return self._batches(self.lib.ptpu_datafeed_next_mem)

    def rewind(self, reshuffle=False, seed=0):
        self.lib.ptpu_datafeed_rewind(self.h, 1 if reshuffle else 0, seed)

    def __del__(self):
        if getattr(self, 'h', None) and getattr(self, 'lib', None):
            self.lib.ptpu_datafeed_destroy(self.h)
            self.h = None
