"""The train engines' shared diagnostics — counterpart of `EngineTeardown`
in `paddle_tpu/distributed/fleet/meta_parallel/meta_parallel_base.py`
(:8-84): the per-dispatch bracket and the telemetry half of `shutdown`."""
import contextlib
import gc

from ....core import async_step as A_
from ....core import memory as _mem
from ... import flight_recorder as _fr


class EngineTeardown:
    """Mixed into SpmdPipelineEngine, HybridParallelTrainStep and
    TrainStep."""

    @contextlib.contextmanager
    def _step_guard(self, first, site, phase):
        """One dispatch's bracket: on warm steps (`first` marks the one
        that builds the kernel library and warms the allocator) the
        env-gated watchdog, the step heartbeat and a flight-recorder
        span; on every step the OOM guard and the memory phase."""
        if not first:
            _fr.start_watchdog()   # a no-op unless PADDLE_HANG_TIMEOUT
            _fr.heartbeat()
        span = contextlib.nullcontext() if first else \
            _fr.record_span(site, mode='exec')
        with span, _mem.oom_guard(site), _mem.phase(phase):
            yield

    def _teardown(self, release):
        """Disarm the heartbeat and the env-gated watchdog, stop the gap
        monitor reporting, run `release()` (drop the engine's device
        state) inside an `engine.shutdown` census phase, and return the
        post-release memory sample."""
        _fr.engine_teardown()
        gap = getattr(self, '_gap', None)
        if gap is not None:
            A_.unregister_monitor(gap)
        with _mem.phase('engine.shutdown'):
            release()
            gc.collect()
        return _mem.sample(count_buffers=True)
