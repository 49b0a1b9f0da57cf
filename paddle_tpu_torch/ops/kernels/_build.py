"""Kernel build, loading and routing — the port's counterpart of
`paddle_tpu/ops/pallas/scaffold.py`.

Build: at first use every CUDA source of the package (`csrc/*.cu`, and
nothing else) is compiled by nvcc for `sm_90a`, one nvcc per source
started together, and linked into ONE shared library with a plain C
interface that `ctypes` loads. The library's name carries a digest of
the sources and flags, so an edited source rebuilds and an unchanged
tree reuses the library already in the build directory
(`build/paddle_tpu_torch/` at the repository root, listed in
.gitignore; `$PADDLE_TPU_TORCH_BUILD_DIR` overrides it).

Binding: each C entry point takes raw device pointers, ints, the device
index and the current CUDA stream (`c_void_p`/`c_int`) and returns
`cudaGetLastError()`; `check()` raises when that is not 0.

Routing is by tensor device alone: a wrapper given CPU tensors runs its
kernel's plain PyTorch version; given CUDA tensors it launches the
kernel or raises. There is no flag that sends CUDA tensors to the plain
version and no `try` that falls back to it.

Launch counters: each wrapper adds one to its kernel's counter where it
launches the kernel, and nowhere else; `routes_snapshot()` reads them
all (the counterpart of `scaffold.routes_snapshot`, which counted
routing decisions).
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / 'csrc'
REPO = PACKAGE.parent
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC')
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh

_LAUNCHES = {}
_LIB = None


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------
def register(name):
    """Declare a kernel's launch counter (at module import)."""
    _LAUNCHES.setdefault(name, 0)


def count_launch(name, n=1):
    _LAUNCHES[name] += n


def routes_snapshot():
    """{kernel name: launches since the last reset}."""
    return dict(_LAUNCHES)


def reset_launches():
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------
def build_dir():
    return Path(os.environ.get('PADDLE_TPU_TORCH_BUILD_DIR')
                or REPO / 'build' / 'paddle_tpu_torch')


def sources():
    return sorted(CSRC.glob('*.cu'))


def _nvcc():
    cands = [os.path.join(os.environ[k], 'bin', 'nvcc')
             for k in ('CUDA_HOME', 'CUDA_PATH') if os.environ.get(k)]
    cands += ['/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or '']
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME): the port\'s '
                       'kernels are built from paddle_tpu_torch/csrc at '
                       'first use on a CUDA machine')


def _digest():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob('*.cu*')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile and link the kernels (if this source tree's library is not
    already built); returns the library path."""
    out_dir = build_dir()
    lib_path = out_dir / f'libpaddle_tpu_torch_{_digest()}.so'
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    obj_dir = out_dir / f'obj_{os.getpid()}'
    obj_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources():
        obj = obj_dir / (src.stem + '.o')
        cmd = [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for cmd, _obj, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f'$ {" ".join(cmd)}\n{log.decode(errors="replace")}')
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    tmp = out_dir / f'.{lib_path.name}.{os.getpid()}'
    link = [nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp),
            *[str(obj) for _c, obj, _p in jobs]]
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
    if res.returncode:
        raise RuntimeError(f'nvcc link failed:\n$ {" ".join(link)}\n'
                           + res.stdout.decode(errors='replace'))
    os.replace(tmp, lib_path)          # atomic: a reader never sees half
    shutil.rmtree(obj_dir, ignore_errors=True)
    _count_build(time.perf_counter() - t0)
    return lib_path


def _count_build(seconds):
    """The library's nvcc build as the port's one compile:
    ptpu_compiles_total / ptpu_compile_seconds_total{site='kernels'}
    (StepTelemetry's compile totals)."""
    from ...core import monitor as _m
    _m.counter('ptpu_compile_seconds_total',
               help='cumulative compile seconds (the kernel library\'s '
                    'nvcc build)', labelnames=('site',)).inc(
                        seconds, site='kernels')
    _m.counter('ptpu_compiles_total',
               help='compilations (the kernel library\'s nvcc build)',
               labelnames=('site',)).inc(1, site='kernels')


_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
_SIGNATURES = {
    # x, w, b, y, mean (or None), rstd (or None), rows, n, eps, warps,
    # vecs, ctas, dtype, device, stream
    'ptt_layer_norm_fwd': (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I,
                           _I, _I, _P),
    # x, w, dy, mean, rstd, dx, part, dw_db, rows, n, chunks,
    # rows_per_chunk, dtype, device, stream
    'ptt_layer_norm_bwd': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _P),
    # x, b, y, rows, n, chunks, rows_per_chunk, approximate, dtype, device,
    # stream
    'ptt_bias_gelu_fwd': (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, b, dy, dx, part, db, rows, n, chunks, rows_per_chunk, approximate,
    # dtype, device, stream
    'ptt_bias_gelu_bwd': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _P),
    # q, k_pages, v_pages, page_tables, seq_lens, q_lens, out, part (or
    # None), B, T, H, D, N, page_size, pages_per_seq, qb, splits,
    # tiles_per_split, dtype, device, stream
    'ptt_ragged_paged_attention': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _P),
    # q, k_pages, v_pages (int8), k_scales, v_scales, page_tables,
    # seq_lens, q_lens, out, part (or None), B, T, H, D, N, page_size,
    # pages_per_seq, qb, splits, tiles_per_split, dtype (q's), device,
    # stream
    'ptt_ragged_paged_attention_int8': (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _P),
    # q, k, v, bias (or None), o, lse, B, L, H, D, scale, causal, dtype,
    # device, stream
    'ptt_flash_fwd': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                      _I, _P),
    # q, k, v, bias, dout, lse, delta, dq, B, L, H, D, scale, causal, dtype,
    # device, stream
    'ptt_flash_bwd_dq': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                         _I, _I, _I, _P),
    # q, k, v, bias, dout, lse, delta, dk, dv, B, L, H, D, scale, causal,
    # dtype, device, stream
    'ptt_flash_bwd_dkv': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _F, _I, _I, _I, _P),
    # q, k, v, bias (or None), mask (or None), o, lse, B, L, H, D, scale,
    # inv_keep, causal, dtype, device, stream
    'ptt_flash_bhld_fwd': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                           _F, _I, _I, _I, _P),
    # q, k, v, bias, mask, dout, lse, delta, dq, B, L, H, D, scale,
    # inv_keep, causal, dtype, device, stream
    'ptt_flash_bhld_bwd_dq': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _F, _F, _I, _I, _I, _P),
    # q, k, v, bias, mask, dout, lse, delta, dk, dv, B, L, H, D, scale,
    # inv_keep, causal, dtype, device, stream
    'ptt_flash_bhld_bwd_dkv': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _I, _I, _I, _F, _F, _I, _I, _I, _P),
    # x, residual, keep, y, n, keep_prob, dtype, device, stream
    'ptt_dropout_add_fwd': (_P, _P, _P, _P, _L, _F, _I, _I, _P),
    # keep, dy, dx, n, keep_prob, dtype, device, stream
    'ptt_dropout_add_bwd': (_P, _P, _P, _L, _F, _I, _I, _P),
    # x, part, ticket, out, n, ctas, dtype, device, stream
    'ptt_grad_stats': (_P, _P, _P, _P, _L, _I, _I, _I, _P),
    # table, count, sc, pw_out, rule, p_dtype, g_dtype, m_dtype, master,
    # coeff, b1, b2, omb1, omb2, eps, momentum, rho, omr, nesterov,
    # decoupled, centered, use_pref, round_pref, use_fi, device, stream
    'ptt_multi_update': (_P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F,
                         _F, _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _I,
                         _P),
    # out: [5] int32 (the update table's capacity, size, wd and start
    # offsets, and a chunk's elements); called directly, no device or
    # stream
    'ptt_update_table_layout': (_P,),
}


def lib():
    """The loaded kernel library (built at first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.ptt_error_string.argtypes = [ctypes.c_int]
        handle.ptt_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


# ---------------------------------------------------------------------------
# wrapper helpers
# ---------------------------------------------------------------------------
def on_cpu(*tensors):
    """True when every tensor lies on the CPU (plain route); False when
    every one lies on one CUDA device (kernel route); raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f'tensors on different devices: {sorted(map(str, devs))}')
    dev = devs.pop()
    if dev.type == 'cpu':
        return True
    if dev.type != 'cuda':
        raise ValueError(f'no kernel for device {dev}')
    return False


def dtype_code(t, name):
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f'{name}: no kernel for dtype {t.dtype} '
                        f'(supported: float32, bfloat16)')
    return code


def require_contiguous(name, **tensors):
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f'{name}: {arg} must be contiguous')


def ptr(t):
    """A tensor's device pointer, or None (a C null) for None."""
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


# fp32 partial bytes a row-chunked reduction may allocate (the backward
# kernels' [chunks, width] scratch), unless one partial row is larger
SCRATCH_CAP = 32 << 20


def row_chunks(rows, want, row_bytes):
    """(chunks, rows_per_chunk): `rows` cut into at most `want` chunks of
    contiguous rows (at least one, at most one a row, and few enough that
    chunks x row_bytes stays under SCRATCH_CAP), sized so none is empty:
    chunk i holds rows [i * rows_per_chunk, min(rows, (i+1) *
    rows_per_chunk))."""
    chunks = max(1, min(rows, want, SCRATCH_CAP // max(row_bytes, 1)))
    per = -(-rows // chunks)
    return -(-rows // per), per


def launch(fn_name, kernel, device, *args, launches=1):
    """Call C entry `fn_name` on `device`'s current stream, raise on a
    non-zero cudaError, and count `launches` launches of `kernel` (an
    entry point that runs a second reduction pass launches twice)."""
    index = device.index or 0
    # the current stream's handle without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(index)
    rc = getattr(lib(), fn_name)(*args, index, stream)
    if rc:
        msg = lib().ptt_error_string(rc).decode(errors='replace')
        raise RuntimeError(f'{kernel}: CUDA error {rc} ({msg})')
    count_launch(kernel, launches)
