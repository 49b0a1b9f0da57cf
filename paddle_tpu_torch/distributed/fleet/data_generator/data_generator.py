"""fleet data generators — the user-side half of the PS ingestion pipe;
the port's copy of `paddle_tpu/distributed/fleet/data_generator/
data_generator.py`.

Reference parity: fleet/data_generator/data_generator.py:20 (DataGenerator,
MultiSlotDataGenerator:282, MultiSlotStringDataGenerator:240). A user
subclasses `generate_sample(line)` (and optionally `generate_batch`), then
the trainer runs the subclass as the dataset's `pipe_command`: raw file
lines stream in on stdin, and count-prefixed MultiSlot text
(`<n> v1 .. vn  <m> u1 .. um ...`, one sample per line) streams out on
stdout — byte-compatible with the reference wire protocol, so existing
pipe scripts port unchanged.

The native feed (csrc/data_feed.cc) assembles FIXED-width dense batches
(no LoD); the dataset layer bridges the count-prefixed pipe output to
that layout and enforces that each slot's count matches the declared
width (dataset.py `_multislot_to_dense`).
"""
import sys

__all__ = []


class DataGenerator:
    """Base class: subclass and override `generate_sample` (per raw
    line) and optionally `generate_batch` (whole-batch post-processing,
    e.g. padding). Both must return a zero-arg callable yielding
    `[(slot_name, [values...]), ...]` samples."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        """Batch size used to group samples before `generate_batch`."""
        self.batch_size_ = int(batch_size)

    # -- pipe entry points ---------------------------------------------------
    def run_from_stdin(self):
        """The pipe_command role: raw lines on stdin -> protocol lines
        on stdout (reference run_from_stdin)."""
        self._run(sys.stdin, sys.stdout)

    def run_from_memory(self):
        """Debug/bench entry: generate_sample(None) drives the stream
        (reference run_from_memory)."""
        batch = []
        for sample in self.generate_sample(None)():
            if sample is None:
                continue
            batch.append(sample)
            if len(batch) == self.batch_size_:
                self._flush(batch, sys.stdout)
                batch = []
        if batch:
            self._flush(batch, sys.stdout)

    def _run(self, lines, out):
        batch = []
        for line in lines:
            for sample in self.generate_sample(line)():
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size_:
                    self._flush(batch, out)
                    batch = []
        if batch:
            self._flush(batch, out)

    def _flush(self, batch, out):
        for sample in self.generate_batch(batch)():
            out.write(self._gen_str(sample))

    # -- user hooks ----------------------------------------------------------
    def generate_sample(self, line):
        raise NotImplementedError(
            "override generate_sample(line) to return a zero-arg "
            "callable yielding [(slot_name, [values...]), ...] "
            "(reference data_generator.py:173)")

    def generate_batch(self, samples):
        def passthrough():
            for s in samples:
                yield s
        return passthrough

    def _gen_str(self, sample):
        raise NotImplementedError(
            "use MultiSlotDataGenerator (int/float slots) or "
            "MultiSlotStringDataGenerator (string feasigns)")

    # shared serializer: "<count> v1 .. vn" per slot, space-joined
    def _serialize(self, sample, to_str):
        if isinstance(sample, zip):
            sample = list(sample)
        if not isinstance(sample, (list, tuple)):
            raise ValueError(
                "a generated sample must be a list/tuple of "
                "(name, [values...]) pairs, got %r" % type(sample))
        parts = []
        for name, values in sample:
            if not isinstance(values, (list, tuple)) or not values:
                raise ValueError(
                    f"slot '{name}': values must be a non-empty list "
                    "(pad in generate_sample/generate_batch)")
            parts.append(str(len(values)))
            parts.extend(to_str(name, v) for v in values)
        return ' '.join(parts) + '\n'


class MultiSlotDataGenerator(DataGenerator):
    """Numeric slots: values are int (uint64 slot) or float (float
    slot); the slot kind is latched per name across the stream, like
    the reference's running _proto_info."""

    def _gen_str(self, sample):
        if isinstance(sample, zip):
            sample = list(sample)
        if not isinstance(sample, (list, tuple)):
            raise ValueError(
                "a generated sample must be a list/tuple of "
                "(name, [values...]) pairs")
        if self._proto_info is None:
            self._proto_info = [(name, 'uint64') for name, _ in sample]
        elif len(sample) != len(self._proto_info):
            raise ValueError(
                f"inconsistent slot count: expected "
                f"{len(self._proto_info)}, got {len(sample)}")

        def to_str(name, v):
            idx = next(i for i, (n, _) in enumerate(self._proto_info)
                       if n == name)
            if isinstance(v, float):
                self._proto_info[idx] = (name, 'float')
            elif not isinstance(v, int):
                raise ValueError(
                    f"slot '{name}': values must be int or float, "
                    f"got {type(v)}")
            return str(v)
        for i, (name, _) in enumerate(sample):
            if name != self._proto_info[i][0]:
                raise ValueError(
                    f"slot name mismatch at {i}: expected "
                    f"'{self._proto_info[i][0]}', got '{name}'")
        return self._serialize(sample, to_str)


class MultiSlotStringDataGenerator(DataGenerator):
    """String feasigns: values pass through verbatim (reference
    MultiSlotStringDataGenerator — no proto typing)."""

    def _gen_str(self, sample):
        return self._serialize(sample, lambda name, v: str(v))
