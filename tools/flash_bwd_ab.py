#!/usr/bin/env python3
"""Times paddle_tpu_torch's hand-written kernels on the card,
for one tree or several in turns.

Modes (rows of PERF.md's kernel table):
  (default) the bf16 flash backward at the gpt_1p3b train step's shapes
            (B=8, L=2048, H=16, D=128, causal): the packed dQ and dK/dV
            kernels (rows 9, 10) and the BHLD ones with a keep mask at
            p = 0.1 (rows 12, 13), each pair against SDPA's one backward
            call (dropout_p=0.1 for BHLD) and the pair's gradients
            against the plain fp32 backward;
  --fwd     the bf16 flash forward at the same shapes: packed causal
            (row 8) and BHLD with the keep mask (row 11), each against
            SDPA's forward (dropout_p=0.1 for BHLD), o and lse against
            the plain fp32 forward;
  --paged   the ragged paged attention over bf16 pages (row 1) and over
            int8 pages (row 1q) at the serve's decode and prefill shapes
            and a long-context decode, timed cold beside SDPA over the
            pages gathered dense, each checked against its plain version
            (chip_smoke.py's `paged_rows`, from this checkout, drives
            every tree);
  --norm    the LayerNorm backward at [16384, 2048] (row 4) and the
            bias+GELU backward at [16384, 8192] (row 5), bf16, the
            gpt_1p3b train step's shapes, each beside its library call
            (`native_layer_norm_backward`; `gelu_backward` and the
            dbias sum) and checked against its plain version at
            chip_smoke.py's bars; each call is a CUDA-graph replay of
            back-to-back launches, cold (the 200-800 MB working sets
            exceed the 50 MB L2);
  --stats   the gradient statistics (row 14) over gpt_1p3b's word-
            embedding bucket (103 M bf16, 206 MB: cold by size) and its
            first fc1 bucket (16.8 M bf16, cold over chip_smoke.py's
            COLD_COPIES copies), each beside `torch.linalg.vector_norm`
            (dtype float32, which counts no nonfinite values) and checked
            against its plain version;
  --norm-fwd the LayerNorm forward (row 2) with mean and rstd at the
            train step's [16384, 2048] bf16 (134 MB of x and y: cold) and
            without them at the serve's decode [8, 2048], beside
            `native_layer_norm` and `F.layer_norm`, checked against its
            plain version at chip_smoke.py's bars;
  --bias-gelu the bias+GELU forward (row 3, tanh form) at the train step's
            [16384, 8192] bf16 (537 MB of x and y: cold) and at the serve's
            decode [8, 8192], beside `F.gelu(x + b, approximate='tanh')`,
            checked against its plain version at chip_smoke.py's bar, and
            beside a copy of x (`copy_`) and `torch.neg(x, out=y)` (the
            same bytes read and written by PyTorch's elementwise
            kernel); at
            decode also the host microseconds a call of the wrapper and of
            the library call under no_grad (chip_smoke.py's `host_us`) and
            the floor of any launch (`floor_ms`); and the kernel's fp32
            error against the float64 formula over 2.2 M points (u in
            [-12, 12] and randn x 3).
  --steps   the two per-parameter training legs whole: gpt_1p3b through
            SpmdPipelineEngine in the bench's headline configuration
            (chip_smoke.py's `pipeline`: bf16, AdamW with bf16 moments and
            no master, A = 4 x 2 x 2048, 'full' remat) and through
            TrainStep(use_buckets=False) at 8 x 2048 (chip_smoke.py's
            `train`): a warm-up and 5 timed steps each (ms/step, MFU, peak
            memory), and one profiled pipeline step (device busy, the
            update's device time under the engine's UPDATE_RANGE beside
            its 5.93 ms bytes bound, by this checkout's chip_smoke.py).
  --update  the fused update (row 15) over a whole step's tensors: the
            pipeline leg's 293 (bf16 p, g and moments) and the BERT
            leg's 205 (bf16 p and g, fp32 master and moments), at their
            shapes with random values: the kernels alone (a CUDA graph),
            the route with its host work, its host microseconds a call
            and launches, beside one `torch._fused_adamw_` and the bytes
            bound; with the list form also one call a tensor; and one
            103 M-element AdamW bucket. A tree without the list form
            updates one tensor a call.
  --serve   the serve's stream whole (chip_smoke.py's `serve`: gpt_1p3b,
            16 requests, 64 greedy tokens, batch 8), 3 timed streams with
            request tracing on and 3 with it off (a tree that refuses
            trace=True runs off only): decode step ms, decode tok/s,
            wall.
Errors are the relative L2 error and the max |diff| over the RMS. One
JSON line per tree.

    python3 tools/flash_bwd_ab.py                    # this checkout
    python3 tools/flash_bwd_ab.py --fwd A B B A      # trees in turns
    python3 tools/flash_bwd_ab.py --paged A B B A
    python3 tools/flash_bwd_ab.py --norm A B B A
    python3 tools/flash_bwd_ab.py --stats A B B A
    python3 tools/flash_bwd_ab.py --norm-fwd A B B A
    python3 tools/flash_bwd_ab.py --bias-gelu A B B A
    python3 tools/flash_bwd_ab.py --steps A B B A
    python3 tools/flash_bwd_ab.py --update A B B A
    python3 tools/flash_bwd_ab.py --serve A B B A

Each tree is a checkout root holding paddle_tpu_torch/; it runs in its
own process and builds its kernels into <tree>/build/paddle_tpu_torch.
Needs one CUDA card and nvcc.
"""
import json
import os
import subprocess
import sys


def loop_ms(torch, fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def errors(got, want):
    out = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        rms = float(w.norm()) / w.numel() ** 0.5
        out.append(dict(rel_l2=float((g - w).norm() / w.norm()),
                        max_err_over_rms=float((g - w).abs().max()) / rms))
    return out


def measure_bwd(tree):
    sys.path.insert(0, tree)
    import torch
    from torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(0)
    B, L, H, D = 8, 2048, 16, 128

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device='cuda').bfloat16()

    def sdpa_bwd_ms(q, k, v, do, **kw):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, **kw)
        return loop_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), iters=10)

    res = {'tree': tree}
    q, k, v, do = (randn(B, L, H * D) for _ in range(4))
    kw = dict(num_heads=H, head_dim=D, bias=None, causal=True)
    o, lse = fa.flash_attention_packed_fwd(q, k, v, **kw)
    args = fa._bwd_args(q, k, v, do, H, D, None, True)
    delta = fa.attention_delta(o, do, H, D).contiguous()
    dq = lambda: fa._dq_kernel(q, k, v, None, do, lse, delta, args)
    dkv = lambda: fa._dkv_kernel(q, k, v, None, do, lse, delta, args)
    res['packed_errors'] = errors((dq(),) + dkv(),
                                  fa.flash_attention_packed_bwd_plain(
                                      q, k, v, o, lse, do, **kw))
    res['packed_ms'] = [loop_ms(torch, dq), loop_ms(torch, dkv)]
    heads = (t.reshape(B, L, H, D).transpose(1, 2).contiguous()
             for t in (q, k, v, do))
    res['packed_sdpa_bwd_ms'] = sdpa_bwd_ms(*heads)
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()

    q, k, v, do = (randn(B * H, L, D) for _ in range(4))
    mask = torch.rand(B * H, L, L, generator=gen, device='cuda') >= 0.1
    kw = dict(num_heads=1, causal=True, dropout_mask=mask, dropout=0.1)
    o, lse = fa._flash_forward(q, k, v, **kw)
    args = fa._bhld_bwd_args(q, k, v, do, None, mask, 1, True, 0.1)
    delta = fa.bhld_delta(o, do)
    dq = lambda: fa._bhld_dq_kernel(q, k, v, None, mask, do, lse, delta,
                                    args)
    dkv = lambda: fa._bhld_dkv_kernel(q, k, v, None, mask, do, lse, delta,
                                      args)
    res['bhld_errors'] = errors((dq(),) + dkv(), fa.flash_backward_plain(
        q, k, v, o, lse, do, **kw))
    res['bhld_ms'] = [loop_ms(torch, dq), loop_ms(torch, dkv)]
    res['bhld_sdpa_bwd_ms'] = sdpa_bwd_ms(
        *(t.view(B, H, L, D) for t in (q, k, v, do)), dropout_p=0.1)
    for lay in ('packed', 'bhld'):
        res[f'{lay}_pair_over_sdpa'] = (sum(res[f'{lay}_ms'])
                                        / res[f'{lay}_sdpa_bwd_ms'])
    res['card'] = torch.cuda.get_device_name(0)
    return res


def measure_fwd(tree):
    sys.path.insert(0, tree)
    import torch
    from torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(0)
    B, L, H, D = 8, 2048, 16, 128

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device='cuda').bfloat16()

    res = {'tree': tree}
    q, k, v = (randn(B, L, H * D) for _ in range(3))
    kw = dict(num_heads=H, head_dim=D, bias=None, causal=True)
    fwd = lambda: fa.flash_attention_packed_fwd(q, k, v, **kw)
    res['packed_errors'] = errors(fwd(), fa.flash_attention_packed_plain(
        q.float(), k.float(), v.float(), **kw))
    res['packed_ms'] = loop_ms(torch, fwd, iters=10)
    heads = [t.reshape(B, L, H, D).transpose(1, 2).contiguous()
             for t in (q, k, v)]
    res['packed_sdpa_ms'] = loop_ms(torch, lambda: F.scaled_dot_product_attention(
        *heads, is_causal=True), iters=10)
    del q, k, v, heads
    torch.cuda.empty_cache()

    q, k, v = (randn(B * H, L, D) for _ in range(3))
    mask = torch.rand(B * H, L, L, generator=gen, device='cuda') >= 0.1
    kw = dict(num_heads=1, causal=True, dropout_mask=mask, dropout=0.1)
    fwd = lambda: fa._flash_forward(q, k, v, **kw)
    res['bhld_errors'] = errors(fwd(), fa.flash_forward_plain(
        q.float(), k.float(), v.float(), **kw))
    res['bhld_ms'] = loop_ms(torch, fwd, iters=10)
    res['bhld_sdpa_ms'] = loop_ms(torch, lambda: F.scaled_dot_product_attention(
        *(t.view(B, H, L, D) for t in (q, k, v)), dropout_p=0.1,
        is_causal=True), iters=10)
    for lay in ('packed', 'bhld'):
        res[f'{lay}_over_sdpa'] = res[f'{lay}_ms'] / res[f'{lay}_sdpa_ms']
    res['card'] = torch.cuda.get_device_name(0)
    return res


def measure_paged(tree):
    sys.path.insert(0, tree)
    import torch
    from torch.nn import functional as F

    smoke = _smoke()
    res = {'tree': tree}
    rows = smoke.paged_rows(torch, F, smoke.make_randn(torch, 0))
    for label, (dense, int8) in rows.items():
        res[label] = dict(
            dense_ms=dense['ms'], int8_ms=int8['ms'],
            sdpa_ms=dense['library_ms'], dense_bound_ms=dense['bound_ms'],
            int8_bound_ms=int8['bound_ms'],
            dense_max_abs_err=dense['max_abs_err'],
            int8_max_abs_err=int8['max_abs_err'],
            qb_splits_tiles_per_split=dense['qb_splits_tiles_per_split'])
    res['card'] = torch.cuda.get_device_name(0)
    return res


def _smoke():
    """chip_smoke.py of this checkout, as a module."""
    import importlib.util
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py')
    spec = importlib.util.spec_from_file_location('ab_chip_smoke', here)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def measure_norm(tree):
    sys.path.insert(0, tree)
    import torch
    from paddle_tpu_torch.ops.kernels import fused_elementwise as fe
    from paddle_tpu_torch.ops.kernels import fused_norm as fn

    smoke = _smoke()
    randn = smoke.make_randn(torch, 0)
    aten = torch.ops.aten
    rows, hidden, ffn = 16384, 2048, 8192
    res = {'tree': tree}

    x, dy = randn(rows, hidden), randn(rows, hidden)
    w, b = 1.0 + randn(hidden, scale=0.1), randn(hidden, scale=0.1)
    _y, mean, rstd = fn.layer_norm_fwd_plain(x, w, b, 1e-5)
    got = fn.layer_norm_bwd(x, w, dy, mean, rstd)
    want = fn.layer_norm_bwd_plain(x, w, dy, mean, rstd)
    res['ln_max_abs_err'] = max(
        smoke.check_close('layer_norm_bwd', got[0], want[0]),
        smoke.check_close('fp32_sum', got[1], want[1]),
        smoke.check_close('fp32_sum', got[2], want[2]))
    res['ln_ms'] = smoke.device_ms(
        torch, lambda: fn.layer_norm_bwd(x, w, dy, mean, rstd), iters=20)
    _y, lmean, lrstd = aten.native_layer_norm(x, [hidden], w, b, 1e-5)
    res['ln_library_ms'] = smoke.device_ms(
        torch, lambda: aten.native_layer_norm_backward(
            dy, x, [hidden], lmean, lrstd, w, b, [True, True, True]),
        iters=20)
    del x, dy, got, want, _y
    torch.cuda.empty_cache()

    x, dy = randn(rows, ffn), randn(rows, ffn)
    b = randn(ffn, scale=0.1)
    got = fe.bias_gelu_bwd(x, b, dy, True)
    want = fe.bias_gelu_bwd_plain(x, b, dy, True)
    res['gelu_max_abs_err'] = max(
        smoke.check_close('bias_gelu_bwd', got[0], want[0]),
        smoke.check_close('fp32_sum', got[1], want[1]))
    res['gelu_ms'] = smoke.device_ms(
        torch, lambda: fe.bias_gelu_bwd(x, b, dy, True), iters=20)
    u = x + b

    def library():
        du = aten.gelu_backward(dy, u, approximate='tanh')
        return du, du.sum(0, dtype=torch.float32)

    res['gelu_library_ms'] = smoke.device_ms(torch, library, iters=20)
    for k in ('ln', 'gelu'):
        res[f'{k}_over_library'] = res[f'{k}_ms'] / res[f'{k}_library_ms']
    res['card'] = torch.cuda.get_device_name(0)
    return res


def measure_stats(tree):
    sys.path.insert(0, tree)
    import torch
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO

    smoke = _smoke()
    n = smoke.BIG_BUCKET
    gen = torch.Generator(device='cuda').manual_seed(0)
    x = (1e-3 * torch.randn(n, generator=gen, device='cuda')).to(
        torch.bfloat16)
    res = {'tree': tree, 'n': n}
    res['max_abs_err'] = smoke.check_close(
        'grad_stats', FO.grad_stats(x)[0], FO.grad_stats_plain(x)[0])
    res['ms'] = smoke.device_ms(torch, lambda: FO.grad_stats(x), iters=20)
    res['library_ms'] = smoke.device_ms(
        torch, lambda: torch.linalg.vector_norm(x, dtype=torch.float32),
        iters=20)
    res['bound_ms'] = smoke.bound_ms(2 * n + 8, 3 * n, smoke.FP32_FLOPS)[0]
    del x
    torch.cuda.empty_cache()
    fc1 = smoke.typical_stats_row(torch, FO, smoke.fc1_bucket_size(torch))
    res['fc1'] = {k: fc1[k] for k in ('shape', 'max_abs_err', 'ms',
                                      'library_ms', 'bound_ms')}
    for row in (res, res['fc1']):
        row['over_library'] = row['ms'] / row['library_ms']
        row['share_of_bound'] = row['bound_ms'] / row['ms']
    res['card'] = torch.cuda.get_device_name(0)
    return res


def measure_norm_fwd(tree):
    sys.path.insert(0, tree)
    import torch
    from torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import fused_norm as fn

    smoke = _smoke()
    randn = smoke.make_randn(torch, 0)
    aten = torch.ops.aten
    res = {'tree': tree}
    for label, rows, stats in (('train', 16384, True), ('decode', 8, False)):
        n = 2048
        x = randn(rows, n)
        w, b = 1.0 + randn(n, scale=0.1), randn(n, scale=0.1)
        y, mean, rstd = fn._fwd_kernel(x, w, b, 1e-5, stats)
        y_p, mean_p, rstd_p = fn.layer_norm_fwd_plain(x, w, b, 1e-5)
        err = smoke.check_close('layer_norm', y, y_p)
        if stats:
            err = max(err, smoke.check_close('fp32_sum', mean, mean_p),
                      smoke.check_close('fp32_sum', rstd, rstd_p))
            library = lambda: aten.native_layer_norm(x, [n], w, b, 1e-5)
        else:
            library = lambda: F.layer_norm(x, (n,), w, b, 1e-5)
        iters = 20 if stats else smoke.ITERS
        ms = smoke.device_ms(
            torch, lambda: fn._fwd_kernel(x, w, b, 1e-5, stats), iters=iters)
        lib_ms = smoke.device_ms(torch, library, iters=iters)
        bound = smoke.bound_ms(2 * rows * n * 2 + 2 * n * 2
                               + (rows * 8 if stats else 0),
                               8 * rows * n, smoke.FP32_FLOPS)[0]
        res[label] = dict(shape=[rows, n], stats=stats, max_abs_err=err,
                          ms=ms, library_ms=lib_ms, bound_ms=bound,
                          over_library=ms / lib_ms, share_of_bound=bound / ms)
        del x, y, y_p
        torch.cuda.empty_cache()
    res['card'] = torch.cuda.get_device_name(0)
    return res


def measure_bias_gelu(tree):
    sys.path.insert(0, tree)
    import torch
    from torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import fused_elementwise as fe

    smoke = _smoke()
    randn = smoke.make_randn(torch, 0)
    res = {'tree': tree, 'floor_ms': smoke.floor_ms(torch)}
    for label, rows in (('train', 16384), ('decode', 8)):
        n = 8192
        x, b = randn(rows, n), randn(n, scale=0.1)
        run = lambda: fe.bias_gelu(x, b, True)
        library = lambda: F.gelu(x + b, approximate='tanh')
        err = smoke.check_close('bias_gelu', run(),
                                fe.bias_gelu_plain(x, b, True))
        iters = 20 if label == 'train' else smoke.ITERS
        ms = smoke.device_ms(torch, run, iters=iters)
        lib_ms = smoke.device_ms(torch, library, iters=iters)
        bound = smoke.bound_ms(2 * rows * n * 2 + n * 2, 12 * rows * n,
                               smoke.FP32_FLOPS)[0]
        res[label] = dict(shape=[rows, n], max_abs_err=err, ms=ms,
                          library_ms=lib_ms, bound_ms=bound,
                          over_library=ms / lib_ms, share_of_bound=bound / ms)
        if label == 'decode':
            with torch.no_grad():
                res[label].update(host_us=smoke.host_us(torch, run),
                                  library_host_us=smoke.host_us(torch, library))
        else:
            # the same bytes read and written by a copy and by PyTorch's
            # vectorized elementwise kernel (a negation: no bias, no GELU)
            y = torch.empty_like(x)
            res[label]['copy_ms'] = smoke.device_ms(
                torch, lambda: y.copy_(x), iters=iters)
            res[label]['neg_ms'] = smoke.device_ms(
                torch, lambda: torch.neg(x, out=y), iters=iters)
            del y
        del x, b
        torch.cuda.empty_cache()
    # fp32: the kernel against the float64 formula, written without the
    # cancellation of 1 + tanh z: u / (1 + e^(-2z))
    gen = torch.Generator(device='cuda').manual_seed(1)
    u = torch.cat([3 * torch.randn(2_000_000, generator=gen, device='cuda'),
                   torch.linspace(-12, 12, 200_000, device='cuda')])
    got = fe.bias_gelu(u.view(1100, 2000), torch.zeros(2000, device='cuda'),
                       True).double().flatten()
    ud = u.double()
    z = (2 / torch.pi) ** 0.5 * (ud + 0.044715 * ud ** 3)
    want = ud / (1 + torch.exp(-2 * z))
    err = (got - want).abs()
    normal = want.abs() > 1e-30
    res['fp32_vs_float64'] = dict(
        points=u.numel(), max_abs=float(err.max()),
        max_rel=float((err[normal] / want[normal].abs()).max()))
    res['card'] = torch.cuda.get_device_name(0)
    return res


def _timed_steps(torch, step, steps=5):
    """(warm-up seconds, [seconds of each timed step]); each step ends in
    a host fetch of its loss."""
    import time
    t0 = time.perf_counter()
    float(step())
    warm = time.perf_counter() - t0
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        float(step())
        walls.append(time.perf_counter() - t0)
    return warm, walls


def measure_steps(tree):
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline as sp)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         build_gpt_pipeline, gpt_1p3b)
    from paddle_tpu_torch.optimizer import AdamW

    smoke = _smoke()
    res = {'tree': tree, 'card': torch.cuda.get_device_name(0)}
    cfg = gpt_1p3b(hidden_dropout=0.0, attn_dropout=0.0,
                   use_flash_attention=True)
    L, layers, A, mb = cfg.max_seq_len, cfg.num_layers, 4, 2

    def adamw():
        return AdamW(learning_rate=1e-4, weight_decay=0.01,
                     multi_precision=False, moment_dtype='bfloat16')

    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (A * mb, L)).astype('int32')
    labels = np.roll(ids, -1, 1).astype('int32')
    ids_t, labels_t = (torch.from_numpy(ids).cuda(),
                       torch.from_numpy(labels).cuda())
    gen = torch.Generator(device='cuda').manual_seed(4321)
    triple = build_gpt_pipeline(cfg, device='cuda', dtype=torch.bfloat16,
                                generator=gen)
    n = sum(p.numel() for m in [triple[0], triple[2]] + triple[1]
            for p in m.parameters())
    eng = sp.SpmdPipelineEngine(*triple, adamw(), accumulate_steps=A,
                                use_remat=True, schedule='1F1B',
                                grad_accum_dtype='param')
    torch.cuda.reset_peak_memory_stats()
    warm, walls = _timed_steps(
        torch, lambda: eng.train_batch((ids_t, labels_t)))
    step_s = float(np.mean(walls))
    flops = 6 * n * A * mb * L + 12 * layers * cfg.hidden_size * L * A * mb * L
    prof = smoke.profile_train_step(
        torch, lambda i, lab: eng.train_batch((i, lab)), ids_t, labels_t,
        ranges=(sp.UPDATE_RANGE, sp.HEAD_RANGE))
    res['pipeline'] = dict(
        warmup_s=warm, step_s=walls, ms_per_step=1e3 * step_s,
        mfu=flops / step_s / 1e12 / smoke.PEAK_BF16_TFLOPS,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        device_busy_s=prof['device_busy_s'],
        profiled_step_wall_s=prof['profiled_step_wall_s'],
        device_s_by_group=prof['device_s_by_group'],
        device_s_other_split=prof['device_s_other_split'],
        update_device_s=smoke.update_device_s(prof),
        update_device_span_s=prof['device_span_s_of_range'].get(
            sp.UPDATE_RANGE),
        update_bound_ms=1e3 * n * smoke.UPDATE_BYTES
        / smoke.HBM_BYTES_PER_S)
    eng.shutdown()
    del eng, triple
    smoke.free_cuda(torch)

    model = GPTForCausalLM(cfg, device='cuda', dtype=torch.bfloat16,
                           generator=gen)
    step = TrainStep(model, lambda m, i, lab: GPTPretrainingCriterion()(
        m(i), lab), adamw(), use_buckets=False)
    B = A * mb
    n = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    warm, walls = _timed_steps(torch, lambda: step(ids_t, labels_t))
    step_s = float(np.mean(walls))
    flops = 6 * n * B * L + 12 * layers * cfg.hidden_size * L * B * L
    res['train'] = dict(
        warmup_s=warm, step_s=walls, ms_per_step=1e3 * step_s,
        mfu=flops / step_s / 1e12 / smoke.PEAK_BF16_TFLOPS,
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    return res


def measure_serve(tree):
    """The serve's stream (chip_smoke.py's `serve`: gpt_1p3b bf16, 16
    prompts of 32-384 tokens, 64 greedy tokens, batch 8) through the
    tree's ServingEngine: a warm-up request, then 3 timed streams, with
    request tracing on and off where the tree takes each (a tree before
    the journals refuses trace=True). Decode step ms is the engine's
    decode seconds over its decode steps."""
    sys.path.insert(0, tree)
    import time
    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    smoke = _smoke()
    res = {'tree': tree, 'card': torch.cuda.get_device_name(0)}
    cfg = gpt_1p3b()
    gen = torch.Generator(device='cuda').manual_seed(1234)
    model = GPTForCausalLM(cfg, device='cuda', dtype=torch.bfloat16,
                           generator=gen)
    rng = np.random.RandomState(0)
    lens = rng.randint(32, 384 + 1, 16)
    prompts = [list(rng.randint(1, cfg.vocab_size, int(n))) for n in lens]
    for trace in (True, False):
        try:
            eng = ServingEngine(model, ServingConfig(
                trace=trace, **smoke.SERVE_PAGES), device='cuda')
        except NotImplementedError:
            res[f'trace_{trace}'] = None
            continue
        eng.generate([prompts[0]], max_new_tokens=2)
        runs = []
        for _ in range(3):
            eng.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(prompts, max_new_tokens=smoke.SERVE_MAX_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = eng.stats()
            runs.append(dict(
                wall_s=wall, decode_tokens_per_sec=st[
                    'decode_tokens_per_sec'],
                decode_step_ms=1e3 * st['decode_seconds_total']
                / max(st['decode_steps_total'], 1)))
        res[f'trace_{trace}'] = runs
        eng.shutdown()
        smoke.free_cuda(torch)
    return res


def _update_lists(torch, smoke):
    """{leg: (optimizer, [(p, g, state)], bytes an element)}: the tensors
    a step of each per-parameter leg updates, at their shapes (the
    models built on the meta device), random values on the card: the
    pipeline's 293 (bf16 p, g and moments, no master) and BERT's 205
    (bf16 p and g, fp32 master and moments), states a few steps in."""
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         build_gpt_pipeline, gpt_1p3b)
    from paddle_tpu_torch.optimizer import AdamW

    triple = build_gpt_pipeline(gpt_1p3b(hidden_dropout=0.0,
                                         attn_dropout=0.0), device='meta')
    bert = BertForPretraining(BertConfig(
        vocab_size=smoke.BERT_VOCAB, hidden_size=smoke.BERT_HIDDEN,
        num_layers=smoke.BERT_LAYERS, num_heads=smoke.BERT_HEADS,
        intermediate_size=smoke.BERT_FFN, max_seq_len=smoke.BERT_L),
        device='meta')
    gen = torch.Generator(device='cuda').manual_seed(5)
    legs = {'pipeline': ([p.shape for m in [triple[0], *triple[1], triple[2]]
                          for p in m.parameters()],
                         AdamW(1e-4, weight_decay=0.01, multi_precision=False,
                               moment_dtype='bfloat16'), smoke.UPDATE_BYTES),
            'bert': ([p.shape for p in bert.parameters()],
                     AdamW(1e-4, weight_decay=0.01), smoke.BERT_UPDATE_BYTES)}
    out = {}
    for leg, (shapes, opt, per_elem) in legs.items():
        entries = []
        for shape in shapes:
            p = (0.02 * torch.randn(shape, generator=gen, device='cuda')).to(
                torch.bfloat16)
            g = (1e-3 * torch.randn(shape, generator=gen, device='cuda')).to(
                torch.bfloat16)
            st = opt.init_state(p)
            for k, v in st.items():
                if v.dim():
                    v.copy_(1e-6 * torch.rand(shape, generator=gen,
                                              device='cuda'))
                else:
                    v.fill_(0.9 ** 10 if k == 'beta1_pow' else 0.999 ** 10)
            if opt._multi_precision:
                st['master'] = p.float()
            entries.append((p, g, st))
        out[leg] = (opt, entries, per_elem)
    return out


def measure_update(tree):
    """Row 15 over a whole step's tensors: the pipeline's 293 and BERT's
    205 (`_update_lists`), and one 103 M-element AdamW bucket. For each
    list: the update's kernels alone (`kernels_ms`: `device_ms`, a CUDA
    graph of the calls), the route with its host work (`route_ms`: CUDA
    events around calls), the host microseconds a call (`host_us`,
    median, not synchronized), its launches a call, one
    `torch._fused_adamw_` over the same tensors (`library_ms`) and the
    bytes bound; with the list form, the route as one call a tensor
    (`per_param_ms`: one-entry launches, host included). A tree without
    the list form runs one call a tensor."""
    sys.path.insert(0, tree)
    import torch
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO

    smoke = _smoke()
    multi = hasattr(FO.ParamUpdates, 'apply')
    res = {'tree': tree, 'card': torch.cuda.get_device_name(0),
           'list_form': multi}
    lr = torch.tensor(1e-4, device='cuda')
    for leg, (opt, entries, per_elem) in _update_lists(torch, smoke).items():
        sts = [st for _p, _g, st in entries]

        def route():
            if multi:
                out = FO.ParamUpdates(opt, lr).apply(
                    [(p, g, st) for (p, g, _s), st in zip(entries, sts)])
                sts[:] = [st for _p, st in out]
            else:
                upd = FO.ParamUpdates(opt, lr)
                for j, (p, g, _s) in enumerate(entries):
                    _p, sts[j] = upd(p, g, sts[j])

        n = sum(p.numel() for p, _g, _s in entries)
        route()
        _build.reset_launches()
        route()
        row = {'tensors': len(entries), 'elements': n,
               'launches': _build.routes_snapshot()[FO.STEP],
               'bound_ms': 1e3 * n * per_elem / smoke.HBM_BYTES_PER_S,
               'kernels_ms': smoke.device_ms(torch, route, iters=5),
               'route_ms': loop_ms(torch, route, iters=10),
               'host_us': smoke.host_call_us(torch, route)}
        if multi:
            def per_param():
                upd = FO.ParamUpdates(opt, lr)
                for j, (p, g, _s) in enumerate(entries):
                    _p, sts[j] = upd(p, g, sts[j])
            row['per_param_ms'] = loop_ms(torch, per_param, iters=10)
        ps = [st.get('master', p) for (p, _g, _s), st in zip(entries, sts)]
        gs = [g.to(p.dtype) for p, (_p, g, _s) in zip(ps, entries)]
        steps = [torch.full((), 10.0, device='cuda') for _ in ps]
        row['library_ms'] = loop_ms(torch, lambda: torch._fused_adamw_(
            ps, gs, [st['moment1'] for st in sts],
            [st['moment2'] for st in sts], [], steps, lr=1e-4, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False), iters=10)
        res[leg] = row
        del entries, sts, ps, gs
        smoke.free_cuda(torch)
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=2e-4, weight_decay=0.01, multi_precision=False,
                moment_dtype='bfloat16')
    p, g, st = smoke.update_inputs(torch, opt, smoke.BIG_BUCKET,
                                   torch.bfloat16, False, seed=3)
    pref = torch.tensor(0.37, device='cuda')
    res['bucket'] = {
        'elements': smoke.BIG_BUCKET,
        'bound_ms': 1e3 * smoke.BIG_BUCKET * smoke.UPDATE_BYTES
        / smoke.HBM_BYTES_PER_S,
        'ms': smoke.device_ms(torch, lambda: FO.fused_shard_update(
            opt, p, g, st, lr, prefactor=pref), iters=10)}
    return res


MODES = {'--bwd': measure_bwd, '--fwd': measure_fwd,
         '--paged': measure_paged, '--norm': measure_norm,
         '--stats': measure_stats, '--norm-fwd': measure_norm_fwd,
         '--bias-gelu': measure_bias_gelu, '--steps': measure_steps,
         '--update': measure_update, '--serve': measure_serve}


def main(argv):
    if argv[:1] == ['--child']:
        mode, tree = argv[1], os.path.abspath(argv[2])
        print(json.dumps(MODES[mode](tree)), flush=True)
        return 0
    mode = argv[0] if argv[:1] and argv[0] in MODES else '--bwd'
    trees = [a for a in argv if a not in MODES] or [
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    for tree in trees:
        env = dict(os.environ, PADDLE_TPU_TORCH_BUILD_DIR=os.path.join(
            os.path.abspath(tree), 'build', 'paddle_tpu_torch'))
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        '--child', mode, tree], env=env, check=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
