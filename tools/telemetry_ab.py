#!/usr/bin/env python3
"""Splits the telemetry's cost on the headline leg's windowed step into
its parts, on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/telemetry_ab.py

Builds gpt_1p3b's pipeline engine as chip_smoke.py's `pipeline` phase
does (24 layers, A = 4 x 2 x 2048, 'full' remat, AdamW with bf16
moments), takes a warm-up step, then times trials of 5 `train_step`
calls, a flush and one fetch (chip_smoke.py's `telemetry_ab` loop) in
four arms, in turns (off, on, loader, hist, hist, loader, on, off; three
rounds):

  off     the host batch fed to train_step;
  on      through a DeviceLoader, with the metric history and the
          default alert pack on and a history tick, export and ledger
          account after the trial (chip_smoke.py's 'on');
  loader  through a DeviceLoader only;
  hist    the history, the alerts and the ledger account only.

Each trial records its ms a step and, from `gc.callbacks`, the garbage
collections of each generation it ran and their seconds. The rounds run
four times: with the process's own heap and with 3,000,000 small dicts
added to it (a larger Python heap, as in chip_smoke.py's later phases),
each without and with a full collection before every trial (outside the
timed region: Python's gen-2 collections otherwise fall at a fixed
cadence of trials, which this order can alias onto one arm). Prints one
JSON line per case, after the card's name and power limit.
"""
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ORDER = ('off', 'on', 'loader', 'hist', 'hist', 'loader', 'on', 'off')
ROUNDS = 3
STEPS = 5
# (heap ballast, a full collection before each trial)
CASES = ((0, False), (0, True), (3_000_000, False), (3_000_000, True))


def main():
    import torch
    if not torch.cuda.is_available():
        print('telemetry_ab: no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.core import alerts as alerts_mod
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline as sp)
    from paddle_tpu_torch.io import DeviceLoader
    from paddle_tpu_torch.models import build_gpt_pipeline, gpt_1p3b
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW

    print(cs.nvidia_smi_line(), flush=True)
    _build.build()
    _build.lib()
    cfg = gpt_1p3b(hidden_dropout=0.0, attn_dropout=0.0,
                   use_flash_attention=True)
    L = cfg.max_seq_len
    gen = torch.Generator(device='cuda').manual_seed(4321)
    triple = build_gpt_pipeline(cfg, device='cuda', dtype=torch.bfloat16,
                                generator=gen)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                multi_precision=False, moment_dtype='bfloat16')
    eng = sp.SpmdPipelineEngine(*triple, opt, accumulate_steps=cs.PIPE_A,
                                use_remat=True, schedule='1F1B',
                                grad_accum_dtype='param')
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size,
                      (cs.PIPE_A * cs.PIPE_MB, L)).astype('int32')
    labels = np.roll(ids, -1, 1).astype('int32')
    float(eng.train_batch((ids, labels)))          # warm-up
    reg = monitor.metrics()
    stat = {'n': [0, 0, 0], 's': 0.0, 't0': 0.0}

    def on_gc(phase, info):
        if phase == 'start':
            stat['t0'] = time.perf_counter()
        else:
            stat['n'][info['generation']] += 1
            stat['s'] += time.perf_counter() - stat['t0']
    gc.callbacks.append(on_gc)

    def trial(mode, collect):
        eng.flush()
        torch.cuda.synchronize()
        if collect:
            gc.collect()
        hist = alerts = None
        if mode in ('on', 'hist'):
            hist = reg.enable_history(capacity=240)
            alerts = alerts_mod.AlertManager(
                hist, rules=alerts_mod.default_rules(), source='ab')
        stat['n'], stat['s'] = [0, 0, 0], 0.0
        t0 = time.perf_counter()
        feed = DeviceLoader([(ids, labels)] * STEPS, engine=eng) \
            if mode in ('on', 'loader') else [(ids, labels)] * STEPS
        last = None
        for b in feed:
            last = eng.train_step(b)
        eng.flush()
        last.result()
        if hist is not None:
            reg.history_tick()
            hist.export(max_points=24)
            eng._ledger.account()
        wall = time.perf_counter() - t0
        if alerts is not None:
            alerts.detach()
        reg.history = None
        return 1e3 * wall / STEPS, list(stat['n']), stat['s']

    ballast = []
    try:
        for size, collect in CASES:
            while len(ballast) < size:
                ballast.append({'a': len(ballast)})
            runs = {}
            for _ in range(ROUNDS):
                for mode in ORDER:
                    runs.setdefault(mode, []).append(trial(mode, collect))
            print(json.dumps({'ballast': size, 'collect': collect,
                              'steps': STEPS, 'res': {
                mode: {'ms': [r[0] for r in v],
                       'median': float(np.median([r[0] for r in v])),
                       'gc_n': [r[1] for r in v],
                       'gc_s': [r[2] for r in v]}
                for mode, v in runs.items()}}), flush=True)
            gc.collect()
    finally:
        gc.callbacks.remove(on_gc)
        eng.shutdown()
    return 0


if __name__ == '__main__':
    sys.exit(main())
