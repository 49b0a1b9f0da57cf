#!/usr/bin/env python3
"""Runs both packages' kill-and-relaunch PS test under thread load, on the
CPU, and counts the failures by message.

Run from the repository root (JAX on the CPU):

    JAX_PLATFORMS=cpu python3 tools/ps_relaunch_stress.py [--threads 12]
        [--rounds 4]

`--threads` threads each run `--rounds` times, at once, the reference's
`tests/test_ps.py::test_kill_one_server_recovers` (its relaunched server
listens before it adds and loads its table), then the same number of
runs of the port's `tests/test_torch_ps.py::test_kill_one_server_recovers`
(it adds and loads before it listens). The threads share one interpreter,
so each run's relaunch thread competes for the interpreter lock as under
a loaded test worker. Prints one JSON line a package: runs and failures
by exception and first line of message.
"""
import argparse
import collections
import json
import os
import pathlib
import sys
import tempfile
import threading


def stress(test, threads, rounds):
    fails = collections.Counter()
    runs = [0]
    lock = threading.Lock()

    def worker():
        for _ in range(rounds):
            try:
                test()
                failure = None
            except Exception as e:          # noqa: BLE001 — counted
                failure = f'{type(e).__name__}: {str(e).splitlines()[0]}' \
                    if str(e) else type(e).__name__
            with lock:
                runs[0] += 1
                if failure:
                    fails[failure[:160]] += 1
    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return {'runs': runs[0], 'failed': sum(fails.values()),
            'failures': dict(fails)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--threads', type=int, default=12)
    ap.add_argument('--rounds', type=int, default=4)
    args = ap.parse_args()
    repo = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(repo), str(repo / 'tests')]
    import test_ps
    import test_torch_ps
    for name, test in (
            ('paddle_tpu', test_ps.test_kill_one_server_recovers),
            ('paddle_tpu_torch', lambda: test_torch_ps
             .test_kill_one_server_recovers(pathlib.Path(
                 tempfile.mkdtemp())))):
        out = stress(test, args.threads, args.rounds)
        print(json.dumps({'package': name, 'threads': args.threads,
                          'rounds': args.rounds, 'cpus': os.cpu_count(),
                          **out}), flush=True)


if __name__ == '__main__':
    main()
