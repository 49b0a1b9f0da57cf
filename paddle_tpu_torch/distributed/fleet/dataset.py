"""fleet datasets — the port's copy of
`paddle_tpu/distributed/fleet/dataset.py` (reference:
python/paddle/distributed/fleet/dataset/dataset.py InMemoryDataset:259 /
QueueDataset / FileInstantDataset:1112 / BoxPSDataset:1142) — the
MultiSlot file-feed path for PS/CTR training, backed by the native C++
feed (csrc/data_feed.cc via core/native.NativeDataFeed): QueueDataset
streams batches straight from the file channel; InMemoryDataset loads +
shuffles in RAM first (the reference's load_into_memory /
local_shuffle pair).

pipe_command is real: like the reference trainer, the dataset spawns
the command once per input file, streams the raw file through its
stdin, and parses count-prefixed MultiSlot text (the DataGenerator
wire protocol) off its stdout — bridged to the native feed's dense
fixed-width layout (`_multislot_to_dense`).

Batches are host tensors, one a slot (float32 or int64, [batch, width]):
pinned when a card is present, so the model's `.to(device,
non_blocking=True)` overlaps; ids stay on the host for the parameter
server's pulls. torch is imported where batches are made, so a
generator script that imports the fleet package starts without it.
"""
import os
import subprocess
import tempfile
import threading

import numpy as np


class DatasetBase:
    def __init__(self):
        self._slots = []
        self._batch_size = 1
        self._thread_num = 1
        self._filelist = []
        self._feed = None
        self._pipe_command = None
        self._pipe_tmpdir = None

    def init(self, batch_size=1, thread_num=1, use_var=None,
             pipe_command=None, input_type=0, fs_name=None,
             fs_ugi=None, **kwargs):
        """Configure like the reference's dataset.init(**kwargs):
        `use_var` gives the slot layout (static data Variables — dtype
        decides the float/int64 slot kind, shape[-1] the width)."""
        self._batch_size = int(batch_size)
        self._thread_num = int(thread_num)
        if pipe_command:
            self._pipe_command = pipe_command
        if use_var:
            self._slots = []
            for v in use_var:
                width = int(np.prod([d for d in v.shape if d and d > 0])
                            or 1)
                kind = 'int64' if 'int' in str(v.dtype) else 'float'
                self._slots.append((width, kind))
        return self

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_pipe_command(self, pipe_command):
        """Reference parity: each input file is streamed through this
        shell command (usually `python my_generator_script.py` running
        a DataGenerator subclass); the command's stdout must be
        count-prefixed MultiSlot text."""
        self._pipe_command = pipe_command

    def _multislot_to_dense(self, text_lines, out_path):
        """Bridge the DataGenerator wire protocol to the native feed's
        dense pipe-separated layout: '<n> v1..vn <m> u1..um' ->
        'v1..vn | u1..um'. Every slot's count must
        equal its declared fixed width (no LoD) — mismatch is a loud
        error, not a silent pad."""
        widths = [w for w, _ in self._slots]
        with open(out_path, 'w') as out:
            for ln, line in enumerate(text_lines, 1):
                toks = line.split()
                if not toks:
                    continue
                pos, fields = 0, []
                for si, w in enumerate(widths):
                    if pos >= len(toks):
                        raise ValueError(
                            f"pipe output line {ln}: expected "
                            f"{len(widths)} slots, ran out at {si}")
                    n = int(toks[pos])
                    if n != w:
                        raise ValueError(
                            f"pipe output line {ln} slot {si}: count "
                            f"{n} != declared fixed width {w} (the "
                            "native feed is dense/no-LoD; pad in "
                            "generate_sample)")
                    fields.append(' '.join(toks[pos + 1:pos + 1 + n]))
                    pos += 1 + n
                if pos != len(toks):
                    raise ValueError(
                        f"pipe output line {ln}: {len(toks) - pos} "
                        "trailing tokens after the declared slots")
                out.write(' | '.join(fields) + '\n')

    def _run_pipe(self):
        """Run pipe_command over each input file (the reference
        trainer's per-file pipe), writing native-format temp files.

        Streams the command's stdout line-by-line into the converter
        instead of buffering the whole shard in RAM (capture_output
        would hold stdout AND the decoded split simultaneously — a
        multi-GB CTR shard exhausts the host). stderr drains in a side
        thread (only the tail is kept) so a chatty generator can't
        deadlock the pipe; the returncode check happens after EOF."""
        self._pipe_tmpdir = tempfile.TemporaryDirectory(
            prefix='paddle_tpu_torch_pipe_')
        converted = []
        for i, path in enumerate(self._filelist):
            dst = os.path.join(self._pipe_tmpdir.name, f'part-{i}')
            with open(path, 'rb') as src:
                proc = subprocess.Popen(
                    self._pipe_command, shell=True, stdin=src,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                stderr_tail = []

                def drain(stream=proc.stderr, tail=stderr_tail):
                    while True:
                        chunk = stream.read(65536)
                        if not chunk:
                            return
                        tail.append(chunk)
                        del tail[:-16]       # keep ~1MB of tail
                t = threading.Thread(target=drain, daemon=True)
                t.start()
                parse_err = None
                try:
                    lines = (ln.decode(errors='replace')
                             for ln in proc.stdout)
                    self._multislot_to_dense(lines, dst)
                except ValueError as e:
                    # a command that crashed mid-stream also produces
                    # garbage/truncated lines — report the rc + stderr
                    # (below), not the downstream parse symptom
                    parse_err = e
                finally:
                    proc.stdout.close()
                    rc = proc.wait()
                    t.join(timeout=10)
            if rc != 0:
                err = b''.join(stderr_tail).decode(errors='replace')
                raise RuntimeError(
                    f"pipe_command failed on {path} (rc={rc}): "
                    f"{err[-1000:]}") from parse_err
            if parse_err is not None:
                raise parse_err
            converted.append(dst)
        return converted

    def _build(self):
        from ...core.native import NativeDataFeed
        files = self._run_pipe() if self._pipe_command \
            else self._filelist
        self._feed = NativeDataFeed(self._slots, self._batch_size,
                                    num_threads=self._thread_num)
        self._feed.set_filelist(files)
        return self._feed

    def _as_tensors(self, f, i):
        """One host tensor a slot, in the declared order; pinned when a
        card is present."""
        import torch
        pin = torch.cuda.is_available()
        out = []
        fo = io_ = 0
        for w, kind in self._slots:
            if kind == 'float':
                a = f[:, fo:fo + w]
                fo += w
            else:
                a = i[:, io_:io_ + w]
                io_ += w
            t = torch.from_numpy(np.ascontiguousarray(a))
            out.append(t.pin_memory() if pin else t)
        return out


class QueueDataset(DatasetBase):
    """Streaming dataset: batches come off the multi-thread file
    channel in arrival order (reference QueueDataset)."""

    def __iter__(self):
        feed = self._build()
        feed.start()
        for f, i in feed:
            yield self._as_tensors(f, i)


class InMemoryDataset(DatasetBase):
    """Load-then-shuffle dataset (reference InMemoryDataset:
    load_into_memory + local/global_shuffle + release_memory)."""

    def __init__(self):
        super().__init__()
        self._loaded = False
        self._seed = 0

    def load_into_memory(self):
        self._build()
        self._feed.load_into_memory(seed=self._seed)
        self._loaded = True

    def local_shuffle(self):
        self._shuffle(seed=self._seed + 1)

    def global_shuffle(self, fleet=None, thread_num=None):
        # one-process global == local; under fleetrun each rank holds
        # its file shard and shuffles it (the reference's semantics
        # reduce to this when the shard is per-rank disjoint)
        self._shuffle(seed=self._seed + 1)

    def _shuffle(self, seed):
        if not self._loaded:
            raise RuntimeError("call load_into_memory() first")
        self._seed = seed
        self._feed.load_into_memory(seed=seed)

    def get_memory_data_size(self, fleet=None):
        if not self._loaded:
            return 0
        return int(self._feed.memory_size())

    def release_memory(self):
        self._feed = None
        self._loaded = False

    def __iter__(self):
        if not self._loaded:
            raise RuntimeError(
                "InMemoryDataset: call load_into_memory() before "
                "iterating (QueueDataset streams directly)")
        for f, i in self._feed.iter_memory():
            yield self._as_tensors(f, i)


class FileInstantDataset(QueueDataset):
    """Single-pass instant file feed (reference FileInstantDataset:
    dataset.py:1112 over InstantDataFeed): batches stream in strict
    file order with no memory stage and no shuffle. The native channel
    already preserves arrival order at thread_num=1; init() pins that
    so ported scripts get the reference's deterministic pass."""

    def init(self, **kwargs):
        kwargs.setdefault('thread_num', 1)
        super().init(**kwargs)
        if self._thread_num != 1:
            self._thread_num = 1       # instant feed is one ordered pass
        return self


class BoxPSDataset(InMemoryDataset):
    """BoxPS dataset surface (reference BoxPSDataset: dataset.py:1142).
    The reference pairs it with the GPU BoxPS embedding cache;
    this build has no box cache to warm or flush — the PS embedding
    store is csrc/sparse_table (SSD-spill tier), which serves pulls
    directly — so the pass-boundary hooks are genuine no-ops here and
    preload maps onto the in-memory load path."""

    def begin_pass(self):
        return None

    def end_pass(self, need_save_delta=False):
        return None

    def preload_into_memory(self, file_num=None):
        self.load_into_memory()

    def wait_preload_done(self):
        return None

    def slots_shuffle(self, slots):
        # reference: shuffles chosen sparse slots' feasigns for feature
        # ablation; dense fixed-width rows have no per-slot feasign
        # lists to permute independently, so this stays a loud raiser
        raise NotImplementedError(
            "BoxPSDataset.slots_shuffle: per-slot feasign shuffling "
            "assumes LoD sparse slots; the native feed is dense "
            "fixed-width. Shuffle in generate_sample, or use "
            "local_shuffle() for whole-row permutation.")
