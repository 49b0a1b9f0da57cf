#!/usr/bin/env python3
"""Times the serving router's periodic refresh on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/cluster_refresh_ab.py [--rounds 3]

Builds the kernels and gpt_1p3b (bf16, random weights from a seed), then
serves the gpt_serve_cluster stream (chip_smoke.py's `serve_cluster`: 24
requests over two 128-token system prompts, 48 greedy tokens, batch 8)
through two LocalReplicas behind ClusterRouter(max_queue=48), in two
arms taken in turns (once, every, every, once; `--rounds` rounds), each
pass over two fresh replicas with the leg's warm-up:

  once    the router refreshes once a pass (refresh_interval_s=3600, as
          chip_smoke.py's timed cluster pass);
  every   the router's default interval, 0.25 s (the leg's).

For each pass: the wall, tokens/s, the refreshes that ran, the host
seconds inside them and inside the replicas' status() calls, and the
placements. One JSON line a pass, then a summary line with each arm's
medians and the card's name and power limit.
"""
import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = {'once': 3600.0, 'every': 0.25}


def _smoke():
    """chip_smoke.py of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location(
        'ab_chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def one_pass(torch, smoke, model, prompts, interval):
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.serving.cluster import ClusterRouter, LocalReplica

    reps = []
    for rid in ('r0', 'r1'):
        eng = ServingEngine(model, ServingConfig(**smoke.CLUSTER_PAGES),
                            device='cuda')
        eng.generate([prompts[0]], max_new_tokens=2, top_k=0)   # warm-up
        eng.reset_stats()
        reps.append(LocalReplica(eng, rid))
    spent = {'status_s': 0.0, 'status_calls': 0}
    for r in reps:
        def timed_status(real=r.status):
            t0 = time.perf_counter()
            try:
                return real()
            finally:
                spent['status_s'] += time.perf_counter() - t0
                spent['status_calls'] += 1
        r.status = timed_status
    router = ClusterRouter(reps, page_size=smoke.CLUSTER_PAGES['page_size'],
                           max_queue=2 * smoke.CLUSTER_N,
                           refresh_interval_s=interval)
    real_refresh = router.refresh
    spent.update(refresh_s=0.0, refreshes=0)

    def timed_refresh(max_age_s=0.0):
        before = router._last_refresh
        t0 = time.perf_counter()
        real_refresh(max_age_s=max_age_s)
        if router._last_refresh != before:          # it ran, not skipped
            spent['refresh_s'] += time.perf_counter() - t0
            spent['refreshes'] += 1
    router.refresh = timed_refresh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = router.serve(prompts, max_new_tokens=smoke.CLUSTER_NEW, top_k=0,
                        timeout_s=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + smoke.CLUSTER_NEW or o[:len(p)] != p:
            raise AssertionError(f'a request of {len(p)} tokens returned '
                                 f'{len(o)}')
    placements = router.snapshot()['placements']
    for r in reps:
        r.shutdown()
    smoke.free_cuda(torch)
    gen = len(prompts) * smoke.CLUSTER_NEW
    return dict(wall_s=wall, tokens_per_sec=gen / wall,
                refresh_share=spent['refresh_s'] / wall,
                placements=placements, **spent)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--rounds', type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('cluster_refresh_ab: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.ops.kernels import _build

    smoke = _smoke()
    _build.build()
    _build.lib()
    cfg = gpt_1p3b()
    gen = torch.Generator(device='cuda').manual_seed(1234)
    model = GPTForCausalLM(cfg, device='cuda', dtype=torch.bfloat16,
                           generator=gen)
    prompts = smoke.cluster_stream(cfg.vocab_size)
    runs = {arm: [] for arm in ARMS}
    for rnd in range(args.rounds):
        for arm in ('once', 'every', 'every', 'once'):
            rec = one_pass(torch, smoke, model, prompts, ARMS[arm])
            runs[arm].append(rec)
            print(json.dumps({'round': rnd, 'arm': arm,
                              'refresh_interval_s': ARMS[arm], **rec}),
                  flush=True)
    summary = {'card': torch.cuda.get_device_name(0),
               'nvidia_smi': smoke.nvidia_smi_line(),
               'passes_per_arm': 2 * args.rounds}
    for arm, recs in runs.items():
        summary[arm] = {k: statistics.median(r[k] for r in recs) for k in (
            'wall_s', 'tokens_per_sec', 'refreshes', 'refresh_s',
            'status_calls', 'status_s', 'refresh_share')}
        summary[arm]['tokens_per_sec_range'] = [
            min(r['tokens_per_sec'] for r in recs),
            max(r['tokens_per_sec'] for r in recs)]
    summary['every_over_once'] = (summary['every']['tokens_per_sec']
                                  / summary['once']['tokens_per_sec'])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
