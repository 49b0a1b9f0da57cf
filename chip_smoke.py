#!/usr/bin/env python3
"""On-card smoke test of paddle_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU (Hopper,
sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. device  — requires CUDA; the card's name and power limit.
2. build   — compiles the port's CUDA sources (paddle_tpu_torch/csrc) with
             nvcc for sm_90a, one nvcc per source started together, into
             build/paddle_tpu_torch/ and loads them.
3. kernel  — each kernel at its main path's shapes (the serve's decode
             step for the paged attention, LayerNorm and bias+GELU
             forwards; the gpt_1p3b train step, B=8 L=2048, for the
             flash forward, dQ, dK/dV and the LayerNorm and bias+GELU
             backwards, plus the two forwards at that step's shapes),
             held against its plain PyTorch version on the same bf16
             inputs at the tolerance stated in TOLERANCES, and timed
             beside its bound, its plain version and one PyTorch
             library call. The flash wrapper, forward and backward
             through its autograd Function, is held against the plain
             versions at the train shape in bf16 and fp32, and at a
             ragged L=1000 and L=129 (bf16 outputs from the tensor-core
             forward at flash_bf16, gradients from the tensor-core
             backward at flash_bf16_tc); each forward row
             carries its time over SDPA's forward (over_library), each
             pair of backward rows its two kernels' time over SDPA's one
             backward call (pair_over_library). The BHLD flash forward,
             dQ and dK/dV (the attention-dropout route) at the train
             step's [B*H, L, D] = [128, 2048, 128] and at L=129 with a
             keep mask at p = 0.1, and with a key bias, full and causal,
             at B=8 H=12 L=512 D=64, each through its autograd Function
             against the plain versions; the
             attention keep mask's draw (core.rng.keep_mask) at the train
             step's [B, H, L, L], its keep share and time. The paged
             attention over bf16 pages (row 1) and over int8 pages (row
             1q) on the same queries and contexts, at the serve's decode
             and prefill shapes and at a decode over 8 rows of 1024-4096
             tokens whose keys span several splits, each against its
             plain version at the paged_attention bar (row 1q at the
             flash bf16 bar too), timed cold; and row 1 at the
             degradation ladder's halved 64-token prefill window.
4. serve   — gpt_1p3b at full width and depth (random weights from a
             fixed torch.Generator seed, bf16 weights and KV) serves 16
             greedy requests of 32-384 prompt tokens and 64 new tokens
             through ServingEngine; every request must complete, the
             pool must drain, every serving kernel's launch counter must
             rise during the serve (the int8 kernel's must not), and the
             engine's prefill logits for two short prompts must match the
             port's CPU fp32 run on the same weights. The stream runs
             with the metric history and the default alert pack on (as
             bench.py:676-700 does): its record carries `series` and
             `alerts`, and no critical rule may fire. Then a profiled
             serve.
   serve_int8 — the same stream over an int8 KV pool: completes,
             drains, attention only on the int8 kernel, 101,376 bytes a
             token against bf16's 196,608, prefill logits within
             LOGITS_RTOL of the CPU fp32 engine over an int8 pool.
   serve_modes — (a) int8 weights and int8 KV: the stream completes, 96
             weights quantized, logits against the CPU fp32 engine with
             the same quantized weights; (b) greedy and (c) sampled
             (top_k 40, temperature 0.8) fused windows of 8 against 1 on
             4 requests: tokens identical, one host fetch a window;
             (d) spec_k 4 against 0 on a shared-prefix stream (8
             requests, 256-token system prompt): acceptance rate, decode
             tok/s, the share of equal tokens. Every serve phase runs
             with request tracing, the ledger and the watchdog's sweep
             on (trace=True, the reference's default).
   serve_tenants — the gpt_serve_tenants leg: 12 heavy requests (256 +
             128 tokens) and 12 light ones (24 + 16) 3 steps later, batch
             8, chunk 128; solo (light only), FCFS and the SLO tenant
             map. The SLO run's ladder reaches stage 2+, a halved 64-token
             chunk runs, per-tenant counts, the goodput identity, exact
             launches and host fetches, and a CPU replay's ladder
             transitions and preemptions equal the card's; light p99 e2e
             over solo, aggregate decode over FCFS, the ladder's
             timeline, the ledger's account, goodput and roofline.
   serve_tiered — the serve's stream sized to fit (224 pages) and
             oversubscribed (112 pages over a 448-page pinned host tier):
             spills and fetches happen, everything completes and drains,
             bit-exact bf16 and int8 round trips through the pinned tier
             with their GB/s, and the resurrect-vs-recompute TTFT on a
             257-token prompt.
   serve_cluster — the gpt_serve_cluster leg: 24 requests (two 128-token
             system prompts in turns, tails of 16-256 tokens, 48 greedy
             tokens; batch 8, chunk 128) through one engine, then two
             LocalReplicas on the card behind the prefix-affinity
             ClusterRouter, the retry-hint probe at max_queue 2, and a
             second pass with r0 drained mid-stream. Every request
             completes and the pools drain; both replicas take traffic
             and affinity beats round-robin; the drained requests finish
             on r1; the federated scrape holds both replicas; rows 1-3
             launch exactly once a layer a forward; a CPU replay makes
             the same placements and its tokens equal its own single
             engine's. Wall tok/s against the single engine, SLO
             percentiles per replica, placements, the hint's accuracy.
   serve_disagg — the same stream through one unified engine, one
             DisaggregatedEngine (prefill_slots 2: prefill on its own
             engine, KV pages streamed into the decode pool) and two
             disaggregated LocalReplicas behind the router. Every request
             completes and every pool drains; 24 handoffs stream fewer
             pages than the prompts hold (the decode side shares the
             system prompts); rows 1-3 launch exactly once a layer a
             forward of the engines; a bf16 and an int8 arm hold the
             decode pool's pages byte for byte against the unified
             engine's (int8 scales too, row 1q exact); a CPU replay's
             tokens equal its unified engine's and its placements the
             card's. Wall tok/s, TTFT/TPOT/e2e against the unified
             engine, the stream's GB/s against its bound.
   serve_workers — two worker processes (serving.cluster.replica) on the
             card behind the router, their gpt_1p3b weights from a seeded
             generator on the card, against a reference engine built the
             same way: a clean pass (every request done, affinity at or
             above round-robin's, no drain, the token share) and a
             forced hang (the watchdog's report, a drain, the moved
             requests finished on the peer). Both workers exit 0 with
             rows 1-3 launched exactly for their forwards. Wall and
             per-replica decode tok/s, TTFT/TPOT beside serve_cluster's
             in-process replicas.
5. train   — gpt_1p3b at full width and depth (bf16, dropout 0, flash
             attention) trains through jit.TrainStep(use_buckets=False)
             with AdamW (lr 1e-4, decay 0.01, bf16 moments, no master
             weights — bench.py:139-142) on one batch of 8 x 2048 tokens:
             a warm-up step, then 5 timed steps. Every loss must be
             finite, the 5th timed loss below the 1st, every training
             kernel's counter must rise during the timed steps, the
             update kernel's exactly once a step (one launch for all the
             parameters), and the paged kernel's must not. Prints
             ms/step, tokens/s, model TFLOP/s and MFU (bench.py's FLOP
             formula), peak memory, one profiled step's device busy
             share, time by group and the flash kernels' share of busy
             time (all, and backward), and the update (292 tensors, one
             launch) timed on copies beside `torch._fused_adamw_`.
6. optimizer kernels — the fused-optimizer kernels (gradient statistics,
             bucket update) over gpt_1p3b's largest bucket (the word
             embedding, 103 M elements) and a ragged one (the
             statistics also over the layout's first fc1 bucket, 16.8 M
             elements, timed cold over COLD_COPIES copies), and the
             dropout+residual kernels forward and backward at the train
             step's [16384, 2048], each against its plain version and
             timed; the update as the path's AdamW (bf16 params and
             moments, no master) and with fp32 moments and a master, and
             as Adagrad, RMSProp (plain and centered), Adamax, Adadelta
             and DecayedAdagrad over the same bucket (bf16 params with
             the fp32 master those classes always keep, fp32 states) and
             a ragged fp32 bucket with a master, each bit-equal to its
             plain chain, and each rule's list of the two buckets and a
             misaligned odd-sized view in one call (one launch a dtype
             group), bit-equal; a found-inf step on NaN
             gradients must leave every output bit-equal; a NaN must
             poison the statistics and be counted.
7. rules   — three default-route TrainSteps per rule of the five at
             gpt_1p3b's width with 2 layers (GPTConfig's default dropouts,
             B=2 L=512, global-norm clip): finite losses and exact launch
             counts of the update and statistics kernels.
8. train_bucketed — gpt_1p3b at full width and depth pretrains through
             jit.TrainStep's default (bucketed) route in GPTConfig's
             default configuration: hidden and attention dropout 0.1
             (the attention on the BHLD flash kernels, its keep masks
             drawn from TrainStep's generator), AdamW with bf16 moments
             and no master,
             ClipGradByGlobalNorm(1.0), LinearWarmup(2 steps, 0 -> 2e-4)
             into CosineAnnealingDecay (lr 2e-4, GPT-3 1.3B's), stepped
             once a step; a warm-up step and 5 timed steps. Losses must be
             finite and fall, every kernel of the path must launch (the
             statistics once a bucket a step, the update once a step for
             all 123 buckets, dropout+residual 48
             times a step, the BHLD flash kernels 24 times a step), the
             packed flash and paged kernels never, and the lr each step
             fed must equal the schedule's. Prints the statistics'
             bound a step (every gradient bucket read once at 3.35
             TB/s). Then a profiled step, the statistics' device time a
             group of its own.
9. check   — the whole path on the card against the CPU, at gpt_1p3b's
             width with 2 layers in fp32 (TF32 off), from the same
             weights: one per-parameter TrainStep (SGD) at B=1, L=512
             (the flash route), and two default (bucketed) TrainSteps with
             AdamW, the global-norm clip, the warm-up schedule and hidden
             and attention dropout 0.1 on the card's masks, replayed on
             the CPU. The
             losses, every parameter's gradient and every updated
             parameter must agree within WHOLE_PATH_RTOL (relative L2
             error per tensor).
10. pipeline — the bench's headline leg (bench.py:120-149): gpt_1p3b at
             full width and depth through SpmdPipelineEngine at pp = 1
             (build_gpt_pipeline: bf16, untied head, dropouts 0, flash
             on; AdamW lr 1e-4, decay 0.01, bf16 moments, no master; A =
             4 micro-batches of 2 x 2048, use_remat=True, '1F1B',
             grad_accum_dtype='param') on the bench's seeded batch: a
             warm-up and 5 timed train_batch calls. Losses finite and
             falling; every training kernel's launches exactly
             `pipeline_launches` a step (the recompute included, the
             update kernel once a step), every other kernel's 0;
             the boundary tags counted exactly. Prints ms/step,
             tokens/s, model TFLOP/s and MFU (bench.py's formula, the
             untied head counted), peak memory, the remat record, and a
             profiled step whose "other" device time is split into the
             per-parameter update, the cross-entropy, casts and copies,
             and the rest; the update's device time and span beside its
             bytes bound, and the whole update timed on copies by its
             route (one launch), one call a parameter, its plain chain
             and `torch._fused_adamw_`, with the route's host time. The
             bench's telemetry loop (bench.py:160-197): the step ledger
             configured and the memory census taken around the warm-up;
             then, with the metric history and the default alert pack on,
             the host-gap record (3 synchronous steps twice, then 5 steps
             through a DeviceLoader in the dispatch window 3 times, one
             fetch at each trial's end), the ledger's account, the
             history's export and the alerts' summary, and
             StepTelemetry's snapshot (`telemetry`, with `comm_overlap`
             and `remat`) and the memory accountant's sample and phases
             (`memory`). The windowed gap must fall below the synchronous
             one, the ledger reconcile within 0.95-1.05 with MFU against
             989 TFLOP/s, and no critical rule fire. The telemetry's cost
             (`telemetry_ab`): the windowed loop with history, alerts,
             ledger account and DeviceLoader on against the same loop
             with them off, in turns (off, on, on, off, twice), with the
             loop thread's host syncs a step. Then 3 timed steps each
             under remat_policy 'none', 'dots' and
             'attn_mlp_boundaries'.
11. pipeline_check — the engine on the card against the CPU at
             gpt_1p3b's width with 2 layers in fp32 (TF32 off), A = 2 x 1
             x 512, remat 'full', SGD and AdamW, 2 train_batch calls from
             the same weights: losses, gradients and parameters within
             WHOLE_PATH_RTOL; train_step x2 + flush bit-equal to
             train_batch x2 on the card.
12. update_route — the per-parameter update route (one update kernel
             launch for the list of parameters) against its plain chain
             on the card, bit-equal, over the leg's 29 tensors at 2
             layers: AdamW
             bf16, the same under a loss scale (the unscale rounded back
             to bf16) and with found_inf set, Adam with a master, SGD
             fp32.
13. pipeline_amp — the leg at 4 layers through train_step(scaler=
             GradScaler(2^15)), 3 steps through the dispatch window
             against the per-step path (scaler state equal, parameters
             bit-equal, the statistics kernel once a parameter a step,
             the update kernel once a step), a profiled scaled step, then
             a step at
             scale=inf that must leave every parameter and state
             bit-equal.
   telemetry — the numerics, memory and hang diagnostics on the leg at
             4 layers: under FLAGS_tensor_stats a step publishes the
             ptpu_num_* gauges with one host fetch for its taps, and its
             global norm agrees with the global-norm clip's over the same
             gradients; under FLAGS_check_nan_inf a gradient made
             non-finite on purpose raises NumericsError naming that
             parameter; a loss-scaled step whose gradient overflowed is
             skipped and the next clean one does not raise (the engine,
             and the eager guard with a GradScaler as the reference's
             test_amp_skip_step_resets_guard drives it); an allocation
             of twice the card's memory inside oom_guard raises
             DeviceOOMError with its report; a HangWatchdog with a short
             timeout over a stalled heartbeat writes its local dump.
14. linear_xent — fused_linear_cross_entropy at [4096, 2048] x 50304 bf16
             against the plain product and hard cross-entropy, forward
             and backward (XENT_LOSS_RTOL, XENT_GRAD_REL_L2), with both
             times and peak memories.
15. bert    — the bench's BERT leg (bench.py:264-329): BERT-base
             (vocab 30522, 12 x 768, 12 heads of 64, FFN 3072) at B = 64
             x L = 512, bf16 with fp32 masters and moments, AdamW lr 1e-4
             decay 0.01, dropouts 0, FLAGS_flash_min_seq 512, through
             HybridParallelTrainStep on a ['dp', 'sharding'] = [1, 1]
             mesh with the fused MLM loss. First the kernels at its
             shapes (path 'bert'): the LayerNorm forward and backward at
             [32768, 768], the bias+GELU forward and backward in the erf
             form at [32768, 3072], the packed flash forward, dQ and
             dK/dV at [64, 512, 12 x 64] non-causal (checked with and
             without a key bias). Then a warm-up step and the bench's
             windowed loop (10 train_step calls and a flush, 2 trials)
             with exact launch counts a step (`bert_launches`), finite
             falling losses; ms/step, samples/s, MFU, peak memory, a
             profiled step's busy time split into GEMMs, port kernels,
             the update and other, and the update (205 tensors, one
             launch) checked bit-equal to its plain chain and timed on
             copies.
16. bert_check — the engine on the card against the CPU at BERT-base's
             width with 2 layers in fp32, B = 2 x L = 512 (the flash
             route), 3 steps: SGD with a 2-D attention mask (the key-bias
             route) and AdamW with the global-norm clip; losses,
             gradients and parameters within WHOLE_PATH_RTOL.
17. dense_decode — gpt_1p3b at full width and depth in bf16 through
             generate(use_cache=True): 8 prompts of 64 tokens, 64 greedy
             tokens, with exact LayerNorm and bias+GELU launch counts at
             the decode step's shapes; ms a forward step, new tokens/s.
             At 2 layers in fp32 the cached tokens must equal
             generate(use_cache=False)'s and generate_scan's.
18. lenet   — the lenet_mnist leg (bench.py:333-360): LeNet(10), Adam at
             its defaults, TrainStep on its bucketed route, B = 256 random
             fp32 [256, 1, 28, 28] images made once on the card; a
             warm-up step, then 3 trials of 20 steps, the best kept:
             ms/step and images/s; losses finite and falling; row 15
             exactly once a step and no other kernel.
19. resnet50 — the resnet50_dp_bf16 leg (bench.py:362-411): a degree-1
             ['dp'] mesh, resnet50(1000) with every fp32 parameter cast
             to bf16 (running statistics fp32), Momentum(0.1, 0.9) with
             fp32 masters, HybridParallelTrainStep, B = 128 random bf16
             [128, 3, 224, 224]; warm-up, 3 trials of 20 steps: ms/step,
             images/s, MFU as 3 * 4.1e9 * B / t over 989 TFLOP/s, peak
             memory; finite losses; row 15 exactly once a step; every
             batch norm's running statistics moved off (0, 1) and finite;
             a profiled step's device time by group (convolution, batch
             norm, GEMM, the update, other) and the card's busy share.
20. vision_check — a net with ResNet's stem, a basic block and two
             bottleneck blocks, fp32 with TF32 off, B = 8 at 64 x 64,
             Momentum(1e-3, 0.9), 3 steps on HybridParallelTrainStep and
             on TrainStep, on the card and on the CPU from the same
             weights: losses, the parameters and the running statistics
             (each set together), then an eval-mode forward, within
             WHOLE_PATH_RTOL relative L2.
21. deepfm_ps — the deepfm_ps leg (bench.py:412-548), no cut: a
             PsServer with an adagrad table (dim 8, seed 3) and a PsClient
             over localhost TCP; 26 fields, B = 512, Pareto ids mod 10^7
             in 3 distinct chunks of K = 16 steps, warmed, then cycled
             through 12; the dense chunk (the FM term, a 32-unit ReLU
             tower, SGD on w1, b1, w2 carried through K batches) on the
             card in fp32 with torch autograd; the un-overlapped pull,
             dense and push times a step (best of 2), then the chunks
             through AsyncCommunicator(depth=2) over the bench's chunk
             adapter, the push thread reading each chunk's gradients back
             from the card (best of 2): ms/step, the overlap speedup,
             rows/s. Then `deepfm_ps_check`: one chunk from a fresh table
             with the dense step on the card against the CPU (rows within
             PS_ROWS_ATOL, weights within WHOLE_PATH_RTOL); a device_put
             through pinned memory on the communicator's copy stream
             lands the host rows; a card gradient made on a side stream
             behind a spin and handed to push_async lands bit-equal to
             the host one.
22. ps_scale_ssd — the ps_scale_ssd leg (bench.py:550-609), no cut, host
             only: 2 M rows through the wire into an SSD table with a
             256 k-row budget (spill logs under build/), then 15 uniform
             batches of 13,312 ids: the spilled share (at least
             PS_MIN_SPILLED), build rows/s, pull and push ms.
23. ctr_ps  — the CTR training path through its entry points, at the
             DeepFM leg's sizes (bench.py:429-441): a
             MultiSlotDataGenerator script under build/ctr_ps and 4 files
             of 64 x 512 Criteo-shaped lines (a label, 13 dense floats,
             26 Pareto(1.2) x 1000 ids mod 10^7) from a seeded numpy
             generator; QueueDataset (2 threads, batch 512) through that
             pipe_command into DeepFM(fields=26, embed_dim=8, hidden=(32,
             16), use_ps=True) on the card with Adam(5e-3): 64 steps in
             sync mode, then its tables saved and loaded into async
             layers for 64 more, then flush; Wide&Deep in geo mode
             (geo_k=10) for 40 steps from an InMemoryDataset of the same
             files. ms/step split into pull, dense and push, table rows,
             first and last losses (DeepFM's finite and falling,
             Wide&Deep's finite), the AUC of
             metric.Auc's buckets through fleet.metrics.auc, the rows
             geo synced; exactly one row-15 launch an Adam step and none
             of any other kernel, or it raises.
   ctr_ps_check — one DeepFM step (32 rows: 832 ids a push, pushed in
             order) on the card and on the CPU from the trained dense
             weights and the same table files (saved once, loaded
             twice): logits and weights within WHOLE_PATH_RTOL, the
             pushed rows within PS_ROWS_ATOL.
24. surface — the op surface (ops/{creation,math,manip,linalg,fft}.py,
             the losses, ParamAttr, the convolution layouts), in three
             parts. surface_sweep: every function of the port's registry
             (ops/common.py OP_REGISTRY; it fails if one has no case)
             and every loss on the card, forward and, where
             differentiable, the VJP with a seeded cotangent, against
             the same op on CPU copies of the same inputs at
             SWEEP_BARS: elementwise, comparison, reduction, cumulative
             and sorting ops at [8, 2048, 2048] in fp32 and bf16 (the
             CPU recomputes a row block, listed in the record), gather
             and index_select over the [50304, 2048] vocabulary with
             16384 ids, linalg at [64, 512, 512] (two matrices on the
             CPU; decompositions held by reconstruction), fft at
             [16384, 2048], cross-entropy and nll_loss at [4096, 50304]
             with ignored rows, the other losses at [16384, 2048],
             ctc_loss at T=256, B=64, 32 classes, labels up to 64; every
             result on the card; the random ops' moments over 2^24
             draws, reproducibility under seed() and a generator, and
             torch's default CUDA generator untouched. surface_train:
             resnet50 in fp32, its fc a Linear with ParamAttrs (Normal
             init, learning rate x10, L2Decay; the bias x10 and out of
             the clip), CrossEntropyLoss, Momentum(0.01, 0.9) with a
             global-norm clip, 8 eager steps at B = 128, 224² from
             randn/randint after seed(2021): the loss falls, row 15
             launches exactly twice a step and nothing else launches,
             the first step moves the head's bias by its unclipped
             gradient and the rest by the clipped one, and one step at
             B = 4, 64² matches the CPU within 1e-3 relative L2 on every
             parameter; ms/step, images/s, peak memory. conv_layouts:
             ResNet-50's 3x3 64->64 and 1x1 256->64 convolutions, its
             3x3/2 max pool and a 4x4/2 grouped transposed convolution,
             bf16 and fp32 (TF32 off), forward and backward in NHWC
             against NCHW (relative L2 CONV_LAYOUT_BARS) and the device
             ms of both layouts.
25. hapi    — the high-level API (after surface). hapi_lenet:
             Model(LeNet()) with Adam(1e-3), CrossEntropyLoss and
             Accuracy fits one epoch of MNIST(mode='train') at batch 64
             (32 steps) on the jit route and the eager one, each with 0
             and 2 loader workers (spawned): row 15 launches once a step
             and nothing else does; evaluate, predict, save, and load into
             a fresh Model that evaluates to the same loss; ms/step and
             images/s beside a bare TrainStep over the same batches and
             the lenet phase's. hapi_text: LSTMSentiment (vocabulary
             10000, embed 64, hidden 64, bidirectional) and BoWClassifier
             fit Imdb(mode='train') at batch 64 through Model; the loss
             falls, and the card's first steps match the CPU's. rnn:
             LSTM, GRU and SimpleRNN at B = 64, T = 128, 512 wide, 2
             layers, bidirectional: forward and backward device ms and
             host ms, and the card against the CPU with
             sequence_length. beam: BeamSearchDecoder over an LSTMCell
             (hidden 512, vocabulary 10000), beam 4, batch 16, up to 64
             steps: ms a step, ids equal to the CPU's.
26. summary — the `kernels` line (all 16 kernels; rows 2-5, 8-10 and 15
             with `launches_bert` and their `bert_shape` times, rows 2
             and 3 with `launches_dense_decode`, every row with
             `launches_lenet`, `launches_resnet50`, `launches_cluster`
             (serve_cluster's cluster pass), `launches_deepfm_ps`,
             `launches_ctr_ps`, `launches_surface` and `launches_hapi`),
             the nvidia-smi line, and as the last line {"ok": true,
             "device": {...}}.

Any failure raises, so the script exits non-zero and prints no final
line; it also fails when torch.cuda.is_available() is false and when
the paddle_tpu_torch package is not beside it.

Timing: a short kernel's time is the device time of CUDA-graph replays
of ITERS launches, measured with CUDA events and divided by ITERS, so
host launch overhead is excluded on every side. LayerNorm and bias+GELU
run on L2-warm inputs (on their paths they consume the output of the
matmul just before them); decode attention cycles through COLD_COPIES
copies of the KV pool (more than the 50 MB L2 holds), as a decode step
finds each layer's pages cold. The flash kernels, their plain versions
and SDPA (each a millisecond or more at the train shape) are timed with
CUDA events around a loop of launches. bound_ms is the larger of the
bytes the function must move over 3.35 TB/s and its operations over the
peak rate for their type (989 TFLOP/s bf16 tensor, 67 TFLOP/s fp32).
Each decode-shape line (rows 1, 1q, 2, 3) carries floor_ms, a
one-element in-place add timed the same way: what any launch costs in a
graph replay. A decode step is host bound, so row 3's decode line also
carries host_us and library_host_us: host microseconds a call of the
wrapper and of F.gelu(x + b) under no_grad (a host clock around 1000
calls, then a synchronize).
"""
import functools
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
ITERS = 50
COLD_COPIES = 4
# |kernel - plain| <= atol + rtol * |plain| per element:
#  layer_norm / bias_gelu (bf16): the two compute in fp32 with different
#    summation order or libm, which can flip one bf16 rounding (2^-8
#    relative) of an output of magnitude up to ~4;
#  paged_attention (bf16): fp32 online softmax in another key order than
#    the dense plain version, then one bf16 rounding.
# For SCALED names atol is a multiple of the plain tensor's RMS, since
# attention outputs and gradients and the fp32 dw/db sums have no fixed
# magnitude, and the tensor's relative L2 error must stay under REL_L2:
#  flash_bf16: both sides compute in fp32 (agreeing to ~1e-6 of a row's
#    scale) and round once to bf16, which differs by at most one bf16
#    spacing, 2^-7 of the value; atol 2^-6 of the RMS then catches a
#    kernel that drops or misplaces even a few keys of a row (the
#    forwards, rows 8 and 11: the bf16 forward on the tensor cores takes
#    P keep as two bf16 terms, 16 significant bits, so its o stays within
#    this bar; grounded on the CPU in tests/test_torch_flash.py);
#  flash_bf16_tc: the bf16 backward on the tensor cores (rows 9, 10, 12,
#    13) rounds P keep and dS to bf16 before the products that consume
#    them (2^-9 of each term). Each row of dS sums to zero, so dQ, dK and
#    dV are sums with cancellation, and an element small beside its terms
#    gets an error of a few percent of the RMS: atol 2^-3 of the RMS,
#    relative L2 1e-2 as flash_bf16. Grounded on the CPU
#    (tests/test_torch_flash.py, the same rounding against the Pallas
#    bodies: at most 0.041 of the RMS beyond rtol, relative L2 2.4e-3 to
#    2.7e-3; 0.055 at L=2048), held there with a margin of 2;
#  flash_fp32, fp32_sum: summation order over up to 2048 keys or 16384
#    rows.
#  update_fp32: the fused update's fp32 outputs (master, moments) — the
#    reference test's bar (tests/test_fused_primitives.py:177): the same op
#    order, each op rounded;
#  grad_stats: the sum of squares, fp32 summation order over up to 10^8
#    terms (the nonfinite count must be exact).
# UPDATE_BF16_EQUAL: the share of the fused update's bf16 outputs that must
# be bit-equal to the plain version's; the rest must lie within one bf16 ulp
# (the same fp32 value rounds once, unless an fp32 ulp of difference crosses
# a bf16 rounding boundary). The dropout+residual kernels must be bit-equal.
TOLERANCES = {'layer_norm': (2e-2, 1e-2), 'bias_gelu': (2e-2, 1e-2),
              'paged_attention': (1e-2, 2e-2),
              'layer_norm_bwd': (2e-2, 1e-2), 'bias_gelu_bwd': (2e-2, 1e-2),
              'flash_bf16': (2.0 ** -6, 2.0 ** -7),
              'flash_bf16_tc': (2.0 ** -3, 2.0 ** -7),
              'flash_fp32': (1e-3, 1e-3),
              'fp32_sum': (1e-4, 1e-3), 'update_fp32': (5e-7, 2e-6),
              'grad_stats': (0.0, 1e-5)}
UPDATE_BF16_EQUAL = 0.999
SCALED = {'flash_bf16', 'flash_bf16_tc', 'flash_fp32', 'fp32_sum'}
REL_L2 = {'flash_bf16': 1e-2, 'flash_bf16_tc': 1e-2, 'flash_fp32': 1e-4,
          'fp32_sum': 1e-4}
# the whole-path check: relative L2 error per tensor, card vs CPU, fp32
WHOLE_PATH_RTOL = 1e-3
FLASH_ITERS = 5
# engine bf16 logits vs the port's CPU fp32 run: max |diff| over the
# vocab <= LOGITS_RTOL * max |fp32 logits| (bf16 rounds at 2^-9; a 24-
# layer residual stream accumulates a few percent of relative error)
LOGITS_RTOL = 5e-2


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    res = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=60,
        check=True)
    return res.stdout.decode().strip().splitlines()[0]


def device_ms(torch, fn, iters=ITERS):
    """Device milliseconds per call of fn: capture `iters` calls into
    one CUDA graph, replay it once to warm up, then time one replay."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, calls=1000):
    """Host microseconds per call of fn: a host clock around `calls`
    calls, then a synchronize (for calls whose host time exceeds their
    device time, as a decode step's small kernels)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def host_call_us(torch, fn, calls=20):
    """Median host microseconds of one call of fn, no synchronize inside
    (for calls whose device work outlasts their host work: the host's
    own cost, the queued launches not waited on)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def floor_ms(torch):
    """device_ms of a one-element in-place add: what any launch costs in
    a graph replay, the floor beside a decode-shape kernel's time."""
    one = torch.zeros(1, device='cuda')
    return device_ms(torch, lambda: one.add_(1))


def bound_ms(nbytes, ops, peak):
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / peak
    return (1e3 * max(by_bytes, by_ops),
            'bytes' if by_bytes >= by_ops else 'operations')


def loop_ms(torch, fn, iters=FLASH_ITERS):
    """Device milliseconds per call of fn, for calls of a millisecond or
    more: CUDA events around a loop of `iters` calls after one warm-up
    call (the host queues the next call while the card runs this one)."""
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


def check_close(name, got, want):
    """Max |got - want| after the TOLERANCES check; raises outside it."""
    atol, rtol = TOLERANCES[name]
    g, w = got.detach().float(), want.detach().float()
    if g.shape != w.shape:
        raise AssertionError(f'{name}: shape {tuple(g.shape)} != '
                             f'{tuple(w.shape)}')
    if not bool(g.isfinite().all()):
        raise AssertionError(f'{name}: non-finite kernel output')
    err = (g - w).abs()
    if name in SCALED:
        norm = float(w.norm())
        atol *= norm / w.numel() ** 0.5
        rel = float(err.norm()) / norm if norm else float(err.norm())
        if rel > REL_L2[name]:
            raise AssertionError(f'{name}: relative L2 error {rel:.3g} > '
                                 f'{REL_L2[name]}')
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(
            f'{name}: {int(bad.sum())} elements outside atol={atol} '
            f'rtol={rtol}; max |diff| {float(err.max()):.3g}')
    return float(err.max())


def make_randn(torch, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=gen, device='cuda')
                ).to(dtype)
    return randn


# the gpt_1p3b train step: B=8, L=2048, H=16, D=128, hidden 2048, ffn 8192
TRAIN_B, TRAIN_L, HEADS, HEAD_DIM = 8, 2048, 16, 128
TRAIN_ROWS = TRAIN_B * TRAIN_L
# the bench's headline leg (bench.py:120-149): gpt_1p3b through
# SpmdPipelineEngine at pp = 1, A = 4 micro-batches of 2 x 2048 tokens
PIPE_A, PIPE_MB = 4, 2
PIPE_ROWS = PIPE_MB * TRAIN_L
# LayerNorm and bias+GELU shapes: (rows, n) -> the path whose step gives
# that kernel that shape (a decode step, the train step, the pipeline
# leg's micro-batch, or neither)
ROW_SHAPES = ((8, 2048), (128, 2048), (8, 8192), (128, 8192),
              (TRAIN_ROWS, 2048), (TRAIN_ROWS, 8192),
              (PIPE_ROWS, 2048), (PIPE_ROWS, 8192))
ROW_PATHS = {'layer_norm': {(8, 2048): 'decode', (TRAIN_ROWS, 2048): 'train',
                            (PIPE_ROWS, 2048): 'pipeline'},
             'bias_gelu': {(8, 8192): 'decode', (TRAIN_ROWS, 8192): 'train',
                           (PIPE_ROWS, 8192): 'pipeline'}}


# the paged attention's cases: gpt_1p3b heads, page_size 16; the serve's
# decode (8 rows of 32-448 tokens, 28 pages a row) and prefill (a 128-token
# window at position 256) shapes, and a decode over long contexts (8 rows
# of 1024-4096 tokens, 256 pages a row) that spans several splits
PAGED_H, PAGED_D, PAGED_PS = 16, 128, 16


def paged_cases(rng):
    """(label, seq_lens, q_lens, T, pages a row) of each timed case;
    'prefill64' is the prefill window at the degradation ladder's stage 2
    (serve_tenants: the chunk halved to 64, 24 pages a row)."""
    return (('decode', rng.randint(32, 449, 8), np.ones(8, np.int64), 1, 28),
            ('prefill', np.asarray([384]), np.asarray([128]), 128, 28),
            ('long', rng.randint(1024, 4097, 8), np.ones(8, np.int64), 1,
             256),
            ('prefill64', np.asarray([320]), np.asarray([64]), 64, 24))


def paged_rows(torch, F, randn):
    """Rows 1 and 1q at each paged case: the kernel over bf16 pages and
    over int8 pages (the same rows quantized as the engine writes them)
    on the same queries and contexts, each held against its plain
    version at the paged_attention bar (the int8 kernel at flash_bf16
    too), and timed cold: each call reads the next of COLD_COPIES pools
    (more than the 50 MB L2 holds), as a decode step finds each layer's
    pages. Returns {label: (dense row, int8 row)}."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    H, D, ps = PAGED_H, PAGED_D, PAGED_PS
    HD = H * D
    rng = np.random.RandomState(0)
    out = {}
    for label, seq_lens, q_lens, T, P in paged_cases(rng):
        B = len(seq_lens)
        N = B * P
        pools = [(randn(N, ps, HD), randn(N, ps, HD))
                 for _ in range(COLD_COPIES)]

        def quantized(pages):
            codes, scales = pa.quantize_kv_rows(
                pages.reshape(1, N * ps, HD), H)
            return codes.reshape(N, ps, HD), scales.reshape(N, ps, H)

        pools8 = []
        for kp, vp in pools:
            (kq, ks), (vq, vs) = quantized(kp), quantized(vp)
            pools8.append((kq, vq, ks, vs))
        tables = rng.permutation(N)[:B * P].reshape(B, P)
        q = randn(B, T, HD)
        pt = torch.as_tensor(tables, dtype=torch.int32, device='cuda')
        sl = torch.as_tensor(seq_lens, dtype=torch.int32, device='cuda')
        ql = torch.as_tensor(q_lens, dtype=torch.int32, device='cuda')
        kw = dict(num_heads=H, head_dim=D)
        k0, v0 = pools[0]
        err = check_close(
            'paged_attention',
            pa.ragged_paged_attention(q, k0, v0, pt, sl, ql, **kw),
            pa.ragged_paged_attention_plain(q, k0, v0, pt, sl, ql, **kw))
        # library yardstick: SDPA over the pages gathered dense (the
        # gather itself is not timed), causal-ragged boolean mask
        key = torch.arange(P * ps, device='cuda')
        qpos = (sl - ql)[:, None] + torch.arange(T, device='cuda')[None]
        mask = ((key[None, None] < sl[:, None, None].long())
                & (key[None, None] <= qpos[:, :, None]))[:, None]
        dense = [tuple(p[pt.long()].reshape(B, P * ps, H, D).transpose(1, 2)
                       .contiguous() for p in kv) for kv in pools]
        qh = q.reshape(B, T, H, D).transpose(1, 2).contiguous()
        step = dict.fromkeys(('kernel', 'plain', 'library', 'int8',
                              'plain8'), 0)

        def rot(which):
            i = step[which] % COLD_COPIES
            step[which] += 1
            return i

        def run_kernel():
            kp, vp = pools[rot('kernel')]
            return pa.ragged_paged_attention(q, kp, vp, pt, sl, ql, **kw)

        def run_plain():
            kp, vp = pools[rot('plain')]
            return pa.ragged_paged_attention_plain(q, kp, vp, pt, sl, ql,
                                                   **kw)

        def run_library():
            kd, vd = dense[rot('library')]
            return F.scaled_dot_product_attention(qh, kd, vd,
                                                  attn_mask=mask)

        def run_int8(plain=False):
            kq, vq, ks, vs = pools8[rot('plain8' if plain else 'int8')]
            fn = (pa.ragged_paged_attention_plain if plain
                  else pa.ragged_paged_attention)
            return fn(q, kq, vq, pt, sl, ql, k_scales=ks, v_scales=vs, **kw)

        visible = [int(min(s, s - qlen + t + 1))
                   for s, qlen in zip(seq_lens, q_lens)
                   for t in range(int(qlen))]
        kv_bytes = int(sum(seq_lens)) * HD * 2 * 2
        io_bytes = 2 * B * T * HD * 2 + tables.size * 4 + 2 * B * 4
        bms, by = bound_ms(kv_bytes + io_bytes, 4 * sum(visible) * HD,
                           BF16_FLOPS)
        shape = (f'{label}: B={B} T={T} H={H} D={D} ps={ps} P={P} '
                 f'context={[int(s) for s in seq_lens]}')
        # (tools/flash_bwd_ab.py also runs this on trees whose kernel
        # did not split)
        splits = list(pa.paged_splits(
            B, T, H, P, ps,
            torch.cuda.get_device_properties(0).multi_processor_count)
        ) if hasattr(pa, 'paged_splits') else None
        dense_ms = device_ms(torch, run_kernel)
        dense_row = dict(
            shape=shape, path=label, max_abs_err=err, ms=dense_ms,
            plain_ms=device_ms(torch, run_plain),
            library_ms=device_ms(torch, run_library),
            bound_ms=bms, bound_by=by,
            qb_splits_tiles_per_split=splits)
        over_library(dense_row)

        # row 1q: the same queries and contexts over int8 pages
        kq0, vq0, ks0, vs0 = pools8[0]
        kw8 = dict(kw, k_scales=ks0, v_scales=vs0)
        got8 = pa.ragged_paged_attention(q, kq0, vq0, pt, sl, ql, **kw8)
        want8 = pa.ragged_paged_attention_plain(q, kq0, vq0, pt, sl, ql,
                                                **kw8)
        err8 = max(check_close('paged_attention', got8, want8),
                   check_close('flash_bf16', got8, want8))
        # K and V rows of H*D codes and H fp32 scales, each read once
        kv8_bytes = int(sum(seq_lens)) * (HD + 4 * H) * 2
        bms8, by8 = bound_ms(kv8_bytes + io_bytes, 4 * sum(visible) * HD,
                             BF16_FLOPS)
        int8_row = dict(
            shape=shape + ' int8 pages', path=label, max_abs_err=err8,
            ms=device_ms(torch, run_int8),
            plain_ms=device_ms(torch, lambda: run_int8(plain=True)),
            library_ms=None,
            library_note='no single PyTorch call attends over int8 pages',
            dense_ms=dense_ms, bound_ms=bms8, bound_by=by8,
            qb_splits_tiles_per_split=splits)
        out[label] = (dense_row, int8_row)
        del pools, pools8, dense
        free_cuda(torch)
    return out


def kernel_phase(torch, F):
    """The paged attention at the serve's shapes, and the LayerNorm and
    bias+GELU forwards at the serve's, the train step's and the pipeline
    micro-batch's shapes, each vs its plain version. At the training rows
    the LayerNorm runs the forward that writes mean and rstd, as
    LayerNormFunction does, and the plain versions (fp32 temporaries of
    the whole input) are timed with loop_ms, not inside a CUDA graph."""
    from paddle_tpu_torch.ops.kernels import fused_elementwise as fe
    from paddle_tpu_torch.ops.kernels import fused_norm as fn
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    randn = make_randn(torch, 0)
    gen = torch.Generator(device='cuda').manual_seed(1)
    bf16 = torch.bfloat16
    aten = torch.ops.aten

    results = {'layer_norm': [], 'bias_gelu': [], 'paged_attention': [],
               'paged_attention_int8': []}
    floor = floor_ms(torch)
    for rows, n in ROW_SHAPES:
        train = rows in (TRAIN_ROWS, PIPE_ROWS)
        iters = 20 if train else ITERS
        x = randn(rows, n)
        w = (1.0 + 0.1 * torch.randn(n, generator=gen, device='cuda')
             ).to(bf16)
        b = randn(n, scale=0.1)
        if train:
            y, mean, rstd = fn._fwd_kernel(x, w, b, 1e-5, True)
            y_p, mean_p, rstd_p = fn.layer_norm_fwd_plain(x, w, b, 1e-5)
            err = max(check_close('layer_norm', y, y_p),
                      check_close('fp32_sum', mean, mean_p),
                      check_close('fp32_sum', rstd, rstd_p))
            del y, y_p, mean, rstd, mean_p, rstd_p
            run = lambda: fn._fwd_kernel(x, w, b, 1e-5, True)
            plain_ms = loop_ms(torch, lambda: fn.layer_norm_fwd_plain(
                x, w, b, 1e-5))
            library = lambda: aten.native_layer_norm(x, [n], w, b, 1e-5)
            stats = rows * 8
        else:
            err = check_close('layer_norm', fn.layer_norm(x, w, b, 1e-5),
                              fn.layer_norm_plain(x, w, b, 1e-5))
            run = lambda: fn.layer_norm(x, w, b, 1e-5)
            plain_ms = device_ms(
                torch, lambda: fn.layer_norm_plain(x, w, b, 1e-5))
            library = lambda: F.layer_norm(x, (n,), w, b, 1e-5)
            stats = 0
        bms, by = bound_ms(2 * rows * n * 2 + 2 * n * 2 + stats,
                           8 * rows * n, FP32_FLOPS)
        results['layer_norm'].append(dict(
            shape=f'x[{rows},{n}] bf16' + (', mean/rstd out' if train else ''),
            path=ROW_PATHS['layer_norm'].get((rows, n)), max_abs_err=err,
            ms=device_ms(torch, run, iters=iters), plain_ms=plain_ms,
            library_ms=device_ms(torch, library, iters=iters),
            bound_ms=bms, bound_by=by))
        err = check_close('bias_gelu', fe.bias_gelu(x, b, True),
                          fe.bias_gelu_plain(x, b, True))
        plain = lambda: fe.bias_gelu_plain(x, b, True)
        bms, by = bound_ms(2 * rows * n * 2 + n * 2, 12 * rows * n,
                           FP32_FLOPS)
        library = lambda: F.gelu(x + b, approximate='tanh')
        results['bias_gelu'].append(dict(
            shape=f'x[{rows},{n}] bf16',
            path=ROW_PATHS['bias_gelu'].get((rows, n)), max_abs_err=err,
            ms=device_ms(torch, lambda: fe.bias_gelu(x, b, True),
                         iters=iters),
            plain_ms=(loop_ms(torch, plain) if train
                      else device_ms(torch, plain)),
            library_ms=device_ms(torch, library, iters=iters),
            bound_ms=bms, bound_by=by))
        if ROW_PATHS['bias_gelu'].get((rows, n)) == 'decode':
            # a decode step is host bound: the wrapper's host time a call
            # beside the library call's, as the serve calls them
            with torch.no_grad():
                results['bias_gelu'][-1].update(
                    host_us=host_us(torch, lambda: fe.bias_gelu(x, b, True)),
                    library_host_us=host_us(torch, library))
        del x, w, b

    for dense, int8 in paged_rows(torch, F, randn).values():
        results['paged_attention'].append(dense)
        results['paged_attention_int8'].append(int8)
    for name, rows in results.items():
        for r in rows:
            if r['path'] == 'decode':
                r['floor_ms'] = floor
            emit({'phase': 'kernel', 'name': name, **r})
    return results


def grad_tol(tol):
    """The flash gradients' bar: bf16 ones come from the tensor-core
    backward (flash_bf16_tc), fp32 ones at flash_fp32."""
    return 'flash_bf16_tc' if tol == 'flash_bf16' else tol


def over_library(row):
    """A row's kernel time over its library call's in the same run."""
    row['over_library'] = row['ms'] / row['library_ms']


def pair_over_library(rows, dq, dkv):
    """The backward's two kernels (one function, dQ, dK and dV) against
    SDPA's one backward call, timed in the same run: the sum of the two
    `ms` over `library_ms`, put on both rows."""
    ratio = (rows[dq]['ms'] + rows[dkv]['ms']) / rows[dq]['library_ms']
    for name in (dq, dkv):
        rows[name]['pair_over_library'] = ratio


def key_bias(torch, B, L, seed):
    """A BERT padding mask's key bias [B, L] fp32: 0 on each row's kept
    tokens, -1e9 on its last 0-127 (the attention_mask route)."""
    pad = np.random.RandomState(seed).randint(0, 128, B)
    keep = np.arange(L)[None, :] < (L - pad)[:, None]
    return torch.from_numpy(np.where(keep, 0.0, -1e9).astype(
        np.float32)).cuda()


def flash_check(torch, fa, randn, B, L, dtype, tol, H=None, D=None,
                causal=True, bias=None):
    """flash_attention_packed, forward and backward through its autograd
    Function, on [B, L, H*D] inputs of `dtype` (gpt_1p3b's heads unless
    given; causal, or not with an optional [B, L] key bias), against the
    plain forward and backward on the same inputs; the lse through the
    forward's dispatching entry. Returns {tensor: max |diff|}."""
    H, D = H or HEADS, D or HEAD_DIM
    q, k, v, do = (randn(B, L, H * D, dtype=dtype) for _ in range(4))
    kw = dict(num_heads=H, head_dim=D, bias=bias, causal=causal)
    _o, lse = fa.flash_attention_packed_fwd(q, k, v, **kw)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention_packed(*leaves, H, D, bias=bias, causal=causal)
    if o.grad_fn is None:
        raise AssertionError('flash_attention_packed: no grad_fn')
    o.backward(do)
    o_p, lse_p = fa.flash_attention_packed_plain(q, k, v, **kw)
    errs = {'o': check_close(tol, o, o_p),
            'lse': check_close('flash_fp32', lse, lse_p)}
    want = fa.flash_attention_packed_bwd_plain(q, k, v, o_p, lse_p, do, **kw)
    for name, leaf, w in zip(('dq', 'dk', 'dv'), leaves, want):
        errs[name] = check_close(grad_tol(tol), leaf.grad, w)
    return errs


def norm_bwd_rows(torch, randn, rows, hidden, ffn, approximate=True):
    """The LayerNorm backward over the hidden size and the bias+GELU
    backward over the ffn size at `rows` bf16 rows (GELU's tanh form, or
    its erf form with approximate=False), each against its plain
    version, timed beside its library call."""
    from paddle_tpu_torch.ops.kernels import fused_elementwise as fe
    from paddle_tpu_torch.ops.kernels import fused_norm as fn

    aten = torch.ops.aten
    out = {}
    x, dy = randn(rows, hidden), randn(rows, hidden)
    w = 1.0 + randn(hidden, scale=0.1)
    b = randn(hidden, scale=0.1)
    _y, mean, rstd = fn._fwd_kernel(x, w, b, 1e-5, True)
    got = fn.layer_norm_bwd(x, w, dy, mean, rstd)
    want = fn.layer_norm_bwd_plain(x, w, dy, mean, rstd)
    err = max(check_close('layer_norm_bwd', got[0], want[0]),
              check_close('fp32_sum', got[1], want[1]),
              check_close('fp32_sum', got[2], want[2]))
    # x, dy read and dx written (bf16), mean and rstd, w read, dw and db
    # written (fp32): no scratch, which is the design's and not the work's
    bms, by = bound_ms(3 * rows * hidden * 2 + rows * 8 + hidden * 2
                       + 2 * hidden * 4, 14 * rows * hidden, FP32_FLOPS)
    _y, lmean, lrstd = aten.native_layer_norm(x, [hidden], w, b, 1e-5)
    out['layer_norm_bwd'] = dict(
        shape=f'x, dy [{rows},{hidden}] bf16', max_abs_err=err,
        ms=device_ms(torch, lambda: fn.layer_norm_bwd(x, w, dy, mean, rstd),
                     iters=20),
        plain_ms=loop_ms(torch, lambda: fn.layer_norm_bwd_plain(
            x, w, dy, mean, rstd)),
        library_ms=device_ms(torch, lambda: aten.native_layer_norm_backward(
            dy, x, [hidden], lmean, lrstd, w, b, [True, True, True]),
            iters=20),
        bound_ms=bms, bound_by=by)
    del x, dy, _y, got, want

    x, dy = randn(rows, ffn), randn(rows, ffn)
    b = randn(ffn, scale=0.1)
    dx, db = fe.bias_gelu_bwd(x, b, dy, approximate)
    dx_p, db_p = fe.bias_gelu_bwd_plain(x, b, dy, approximate)
    err = max(check_close('bias_gelu_bwd', dx, dx_p),
              check_close('fp32_sum', db, db_p))
    # x, dy read and dx written (bf16), b read, db written (fp32)
    bms, by = bound_ms(3 * rows * ffn * 2 + ffn * 2 + ffn * 4,
                       25 * rows * ffn, FP32_FLOPS)
    u = x + b

    def library_bias_gelu_bwd():
        du = aten.gelu_backward(dy, u, approximate=(
            'tanh' if approximate else 'none'))
        return du, du.sum(0, dtype=torch.float32)

    out['bias_gelu_bwd'] = dict(
        shape=f'x, dy [{rows},{ffn}] bf16'
              + ('' if approximate else ', erf form'), max_abs_err=err,
        ms=device_ms(torch, lambda: fe.bias_gelu_bwd(x, b, dy, approximate),
                     iters=20),
        plain_ms=loop_ms(torch, lambda: fe.bias_gelu_bwd_plain(
            x, b, dy, approximate)),
        library_ms=device_ms(torch, library_bias_gelu_bwd, iters=20),
        bound_ms=bms, bound_by=by)
    del x, dy, u, dx, dx_p
    return out


def flash_rows(torch, F, randn, B, L, errs, H=None, D=None, causal=True):
    """The packed flash forward, dQ and dK/dV kernels at [B, L, H*D] bf16
    (gpt_1p3b's heads, causal, unless given), timed beside their plain
    versions and SDPA; `errs` is flash_check's result at that shape."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    H, D = H or HEADS, D or HEAD_DIM
    HD = H * D
    out = {}
    q, k, v, do = (randn(B, L, HD) for _ in range(4))
    kw = dict(num_heads=H, head_dim=D, bias=None, causal=causal)
    o, lse = fa.flash_attention_packed_fwd(q, k, v, **kw)
    # one product's multiply-adds: the causal half, or all of them
    mac = B * H * L * L * D / (2 if causal else 1)
    io = 4 * B * L * HD * 2 + B * L * H * 4
    bms, by = bound_ms(io, 4 * mac, BF16_FLOPS)
    qh, kh, vh, doh = (t.reshape(B, L, H, D).transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    form = 'causal' if causal else 'non-causal'
    out['flash_fwd'] = dict(
        shape=f'q, k, v [{B},{L},{HD}] bf16, H={H} D={D}, {form}',
        max_abs_err=max(errs['o'], errs['lse']),
        ms=loop_ms(torch, lambda: fa.flash_attention_packed_fwd(q, k, v,
                                                                **kw)),
        plain_ms=loop_ms(torch, lambda: fa.flash_attention_packed_plain(
            q, k, v, **kw), iters=2),
        library_ms=loop_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), iters=10),
        library=f'SDPA is_causal={causal} on [B,H,L,D] copies',
        bound_ms=bms, bound_by=by)
    over_library(out['flash_fwd'])
    # the two backward kernels timed apart (the Function's backward runs
    # both, after delta)
    args = fa._bwd_args(q, k, v, do, H, D, None, causal)
    delta = fa.attention_delta(o, do, H, D).contiguous()
    plain_bwd_ms = loop_ms(torch, lambda: fa.flash_attention_packed_bwd_plain(
        q, k, v, o, lse, do, **kw), iters=2)
    qs, ks, vs = (t.detach().requires_grad_() for t in (qh, kh, vh))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    sdpa_bwd_ms = loop_ms(torch, lambda: torch.autograd.grad(
        sdpa, (qs, ks, vs), doh, retain_graph=True), iters=10)
    for name, err, n_products, fn_ in (
            ('flash_bwd_dq', errs['dq'], 6,
             lambda: fa._dq_kernel(q, k, v, None, do, lse, delta, args)),
            ('flash_bwd_dkv', max(errs['dk'], errs['dv']), 8,
             lambda: fa._dkv_kernel(q, k, v, None, do, lse, delta, args))):
        bms, by = bound_ms(io + B * L * HD * 2 + 2 * B * L * H * 4,
                           n_products * mac, BF16_FLOPS)
        out[name] = dict(
            shape=f'q, k, v, dO [{B},{L},{HD}] bf16, H={H} D={D}, {form}',
            max_abs_err=err, ms=loop_ms(torch, fn_),
            plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            plain='one plain backward computes dQ, dK and dV',
            library='SDPA backward (dQ, dK, dV together): compare with '
                    'the sum of the two kernels',
            bound_ms=bms, bound_by=by)
    pair_over_library(out, 'flash_bwd_dq', 'flash_bwd_dkv')
    del q, k, v, do, o, lse, delta, qh, kh, vh, doh, qs, ks, vs, sdpa
    torch.cuda.synchronize()
    return out


def train_kernel_phase(torch, F):
    """Each training kernel not checked in kernel_phase, vs its plain
    version and timed, at the shapes of the gpt_1p3b train step (B = 8)
    and of the pipeline leg's micro-batch (B = 2): the LayerNorm and
    bias+GELU backwards and the three flash kernels. The flash wrapper is
    checked forward and backward at both shapes in bf16, at the train
    step's in fp32, and at a ragged L=1000. The plain versions, which
    allocate fp32 temporaries of the whole input, are timed with
    loop_ms, not inside a CUDA graph. Returns ({kernel: row} at the
    train step's shapes, the same at the pipeline's)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    randn = make_randn(torch, 5)
    B, L = TRAIN_B, TRAIN_L
    checks = {}
    for dtype, tol, shape in ((torch.bfloat16, 'flash_bf16', (B, L)),
                              (torch.bfloat16, 'flash_bf16', (PIPE_MB, L)),
                              (torch.float32, 'flash_fp32', (B, L)),
                              (torch.bfloat16, 'flash_bf16', (1, 1000)),
                              (torch.bfloat16, 'flash_bf16', (1, 129)),
                              (torch.float32, 'flash_fp32', (1, 1000))):
        label = f'{str(dtype).split(".")[-1]} B={shape[0]} L={shape[1]}'
        checks[label] = flash_check(torch, fa, randn, *shape, dtype, tol)
        free_cuda(torch)
    rows = {}
    for path, b, n_rows in (('train', B, TRAIN_ROWS),
                            ('pipeline', PIPE_MB, PIPE_ROWS)):
        rows[path] = norm_bwd_rows(torch, randn, n_rows, 2048, 8192)
        free_cuda(torch)
        rows[path].update(flash_rows(torch, F, randn, b, L,
                                     checks[f'bfloat16 B={b} L={L}']))
        free_cuda(torch)
        for name, r in rows[path].items():
            emit({'phase': 'kernel', 'name': name, 'path': path, **r})
    emit({'phase': 'kernel', 'name': 'flash_wrapper_checks',
          'tolerances': {t: dict(atol_x_rms=TOLERANCES[t][0],
                                 rtol=TOLERANCES[t][1], rel_l2=REL_L2[t])
                         for t in ('flash_bf16', 'flash_bf16_tc',
                                   'flash_fp32')},
          'max_abs_err': checks})
    return rows['train'], rows['pipeline']


# the biased BHLD route's shape: nn.MultiHeadAttention with BERT-base's 12
# heads of 64 over 512 tokens, 8 rows
BIAS_B, BIAS_H, BIAS_L, BIAS_D = 8, 12, 512, 64


def bhld_check(torch, fa, randn, gen, B, H, L, D, dtype, tol, causal,
               with_bias, mask_p):
    """The BHLD route through the entry a caller uses (`_flash_attn_dropout`
    with a keep mask, `_flash_attn_biased` with a key bias), forward and
    backward through its autograd Function, on [B*H, L, D] inputs of
    `dtype`, against the plain forward and backward on the same inputs;
    the lse through `_flash_forward`. Returns {tensor: max |diff|}."""
    q, k, v, do = (randn(B * H, L, D, dtype=dtype) for _ in range(4))
    bias = mask = None
    if with_bias:
        bias = torch.where(torch.rand(B, L, generator=gen, device='cuda')
                           > 0.2, 0.0, -1e4)
    if mask_p:
        mask = torch.rand(B * H, L, L, generator=gen, device='cuda') >= mask_p
    heads = H if with_bias else 1
    kw = dict(bias=bias, num_heads=heads, causal=causal, dropout_mask=mask,
              dropout=mask_p)
    _o, lse = fa._flash_forward(q, k, v, **kw)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    if mask is not None:
        o = fa._flash_attn_dropout(mask_p, *leaves, mask)
    else:
        o = fa._flash_attn_biased(causal, heads, *leaves, bias)
    if o.grad_fn is None:
        raise AssertionError('BHLD flash: no grad_fn')
    o.backward(do)
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    errs = {'o': check_close(tol, o, o_p),
            'lse': check_close('flash_fp32', lse, lse_p)}
    want = fa.flash_backward_plain(q, k, v, o_p, lse_p, do, **kw)
    for name, leaf, w in zip(('dq', 'dk', 'dv'), leaves, want):
        errs[name] = check_close(grad_tol(tol), leaf.grad, w)
    return errs


def keep_mask_draw(torch, shape):
    """The attention keep mask as the path draws it (core.rng.keep_mask,
    one bool draw from the bound generator) at `shape`: a bool tensor of
    that shape keeping 1 - DROPOUT_P of its elements, the same mask from
    the same seed; timed beside uniforms and a compare (`torch.rand <
    keep`, a 4-byte transient an element). The bound is the mask's bytes
    written once."""
    from paddle_tpu_torch.core import rng as port_rng

    keep_prob, n = 1 - DROPOUT_P, int(np.prod(shape))

    def draw(seed):
        gen = torch.Generator(device='cuda').manual_seed(seed)
        with port_rng.rng_guard(gen):
            return port_rng.keep_mask(shape, keep_prob, 'cuda')

    keep = draw(23)
    share = float(keep.sum(dtype=torch.int64)) / n
    # a binomial share's standard deviation is ~1.3e-5 at this size
    if keep.dtype != torch.bool or tuple(keep.shape) != shape or \
            abs(share - keep_prob) > 1e-3 or not torch.equal(keep, draw(23)):
        raise AssertionError(f'keep_mask: {keep.dtype} {tuple(keep.shape)}, '
                             f'keep share {share}')
    del keep
    gen = torch.Generator(device='cuda').manual_seed(24)
    with port_rng.rng_guard(gen):
        ms = loop_ms(torch, lambda: port_rng.keep_mask(shape, keep_prob,
                                                       'cuda'))
    rand_lt_ms = loop_ms(torch, lambda: torch.rand(
        shape, generator=gen, device='cuda') < keep_prob)
    free_cuda(torch)
    emit({'phase': 'kernel', 'name': 'attention_keep_mask_draw',
          'shape': f'{list(shape)} bool, keep {keep_prob}',
          'keep_share': share, 'ms': ms, 'rand_lt_ms': rand_lt_ms,
          'bound_ms': bound_ms(n, 0, FP32_FLOPS)[0], 'bound_by': 'bytes'})


def bhld_kernel_phase(torch, F):
    """Rows 11-13, the BHLD flash forward, dQ and dK/dV, each checked
    through its autograd Function against the plain versions: at the
    gpt_1p3b train step's attention-dropout shape ([B*H, L, D] = [128,
    2048, 128], causal, keep mask at p = 0.1) in bf16; with a key bias,
    full and causal, at the multi-head attention shape in bf16; causal
    with a mask in fp32 there. Timed at the train step's shape beside
    SDPA with dropout_p=0.1 (which cannot take the mask: a timing
    yardstick only)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    randn = make_randn(torch, 21)
    gen = torch.Generator(device='cuda').manual_seed(22)
    B, L, H, D = TRAIN_B, TRAIN_L, HEADS, HEAD_DIM
    small = (BIAS_B, BIAS_H, BIAS_L, BIAS_D)
    checks = {}
    for label, shape, dtype, tol, causal, with_bias, mask_p in (
            ('train: causal, mask p=0.1, bf16', (B, H, L, D),
             torch.bfloat16, 'flash_bf16', True, False, DROPOUT_P),
            ('mha: full, key bias, bf16', small, torch.bfloat16,
             'flash_bf16', False, True, 0.0),
            ('mha: causal, key bias, bf16', small, torch.bfloat16,
             'flash_bf16', True, True, 0.0),
            ('mha: causal, mask p=0.1, fp32', small, torch.float32,
             'flash_fp32', True, False, DROPOUT_P),
            ('ragged: causal, mask p=0.1, L=129, bf16', (2, 3, 129, HEAD_DIM),
             torch.bfloat16, 'flash_bf16', True, False, DROPOUT_P)):
        checks[label] = bhld_check(torch, fa, randn, gen, *shape, dtype, tol,
                                   causal, with_bias, mask_p)
        free_cuda(torch)
    main = checks['train: causal, mask p=0.1, bf16']

    BH = B * H
    q, k, v, do = (randn(BH, L, D) for _ in range(4))
    mask = torch.rand(BH, L, L, generator=gen, device='cuda') >= DROPOUT_P
    kw = dict(num_heads=1, causal=True, dropout_mask=mask, dropout=DROPOUT_P)
    o, lse = fa._flash_forward(q, k, v, **kw)
    causal_mac = BH * L * L * D / 2             # one product, causal half
    mask_bytes = BH * L * (L + 1) // 2          # the causal half it reads
    tensor = BH * L * D * 2                     # one bf16 [B*H, L, D]
    stat = BH * L * 4                           # one fp32 [B*H, L]
    qh, kh, vh, doh = (t.view(B, H, L, D) for t in (q, k, v, do))
    rows = {}
    bms, by = bound_ms(4 * tensor + stat + mask_bytes, 4 * causal_mac,
                       BF16_FLOPS)
    shape = (f'q, k, v [{BH},{L},{D}] bf16 (B={B} H={H}), causal, bool '
             f'keep mask [{BH},{L},{L}] p={DROPOUT_P}')
    rows['flash_bhld_fwd'] = dict(
        shape=shape, max_abs_err=max(main['o'], main['lse']),
        ms=loop_ms(torch, lambda: fa._flash_forward(q, k, v, **kw)),
        plain_ms=loop_ms(torch, lambda: fa.flash_forward_plain(
            q, k, v, **kw), iters=2),
        library_ms=loop_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, dropout_p=DROPOUT_P, is_causal=True), iters=10),
        library='SDPA dropout_p=0.1 is_causal (its own mask): timing only',
        bound_ms=bms, bound_by=by, mask_bytes=BH * L * L)
    over_library(rows['flash_bhld_fwd'])
    args = fa._bhld_bwd_args(q, k, v, do, None, mask, 1, True, DROPOUT_P)
    delta = fa.bhld_delta(o, do)
    plain_bwd_ms = loop_ms(torch, lambda: fa.flash_backward_plain(
        q, k, v, o, lse, do, **kw), iters=2)
    qs, ks, vs = (t.detach().requires_grad_() for t in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qs, ks, vs, dropout_p=DROPOUT_P,
                                         is_causal=True)
    sdpa_bwd_ms = loop_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), doh, retain_graph=True), iters=10)
    for name, err, n_products, outs, fn_ in (
            ('flash_bhld_bwd_dq', main['dq'], 3, 1,
             lambda: fa._bhld_dq_kernel(q, k, v, None, mask, do, lse, delta,
                                        args)),
            ('flash_bhld_bwd_dkv', max(main['dk'], main['dv']), 4, 2,
             lambda: fa._bhld_dkv_kernel(q, k, v, None, mask, do, lse,
                                         delta, args))):
        bms, by = bound_ms((4 + outs) * tensor + 2 * stat + mask_bytes,
                           2 * n_products * causal_mac, BF16_FLOPS)
        rows[name] = dict(
            shape=shape + ', dO', max_abs_err=err, ms=loop_ms(torch, fn_),
            plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
            plain='one plain backward computes dQ, dK and dV',
            library='SDPA dropout_p=0.1 backward (dQ, dK, dV together): '
                    'compare with the sum of the two kernels',
            bound_ms=bms, bound_by=by)
    pair_over_library(rows, 'flash_bhld_bwd_dq', 'flash_bhld_bwd_dkv')
    del q, k, v, do, o, lse, delta, mask, qh, kh, vh, doh, qs, ks, vs, out
    free_cuda(torch)
    keep_mask_draw(torch, (B, H, L, L))
    for name, r in rows.items():
        emit({'phase': 'kernel', 'name': name, 'path': 'train_bucketed', **r})
    emit({'phase': 'kernel', 'name': 'flash_bhld_checks',
          'tolerances': {t: dict(atol_x_rms=TOLERANCES[t][0],
                                 rtol=TOLERANCES[t][1], rel_l2=REL_L2[t])
                         for t in ('flash_bf16', 'flash_bf16_tc',
                                   'flash_fp32')},
          'max_abs_err': checks})
    return rows


SERVE_PAGES = dict(page_size=16, max_batch_size=8, prefill_chunk=128,
                   max_pages_per_seq=28)
SERVE_MAX_NEW = 64


def timed_stream(torch, eng, prompts, max_new, before=None, **gen):
    """A warm-up request, then `prompts` through `eng` with every launch
    counter set to 0 just before and read just after (and `before()`
    called just before). Returns (outputs, wall seconds, launches,
    stats)."""
    from paddle_tpu_torch.ops.kernels import _build

    eng.generate([prompts[0]], max_new_tokens=2, **gen)      # warm-up
    eng.reset_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    if before is not None:
        before()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=max_new, **gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.routes_snapshot()
    return outs, wall, launches, eng.stats()


def check_served(eng, prompts, outs, max_new, vocab):
    """Every request completed with max_new in-vocabulary tokens after
    its prompt, and the pool drained."""
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + max_new or o[:len(p)] != p:
            raise AssertionError(f'request of {len(p)} tokens returned '
                                 f'{len(o)} tokens')
        if not all(0 <= t < vocab for t in o[len(p):]):
            raise AssertionError('generated token id out of range')
    if eng.pool.pages_in_use != 0:
        raise AssertionError(f'pool did not drain: '
                             f'{eng.pool.pages_in_use} pages in use')


def check_launches(launches, used, unused=()):
    idle = [k for k in used if launches[k] <= 0]
    if idle:
        raise AssertionError(f'kernels never launched by the serve: {idle}')
    stray = [k for k in TRAIN_KERNELS + BHLD_KERNELS + BUCKETED_KERNELS
             + tuple(unused) if k not in used and launches[k]]
    if stray:
        raise AssertionError(f'kernels the serve must not launch: {stray}')


def logits_check(torch, eng, cpu_eng, prompts):
    """The engine's prefill logits on the card against the CPU fp32
    engine's: max |diff| over the vocab within LOGITS_RTOL of the
    largest fp32 logit."""
    checks = []
    for p in prompts:
        g = eng.prompt_logits(p)
        ref = cpu_eng.prompt_logits(p)
        diff = float((g - ref).abs().max())
        scale = float(ref.abs().max())
        if not bool(torch.isfinite(g).all()) or g.shape != ref.shape \
                or diff > LOGITS_RTOL * scale:
            raise AssertionError(
                f'prefill logits of a {len(p)}-token prompt: max |diff| '
                f'{diff:.4g} vs fp32 max |logit| {scale:.4g} '
                f'(rtol {LOGITS_RTOL})')
        checks.append(dict(
            prompt_tokens=len(p), max_abs_diff=diff, max_abs_logit=scale,
            argmax_equal=bool(int(g.argmax()) == int(ref.argmax()))))
    return checks


def stream_line(st, wall):
    return {'wall_s': wall,
            'decode_tokens_per_sec': st['decode_tokens_per_sec'],
            'decode_step_ms': (1e3 * st['decode_seconds_total']
                               / max(st['decode_steps_total'], 1)),
            'ttft_ms_p50': st['ttft_ms_p50'],
            'ttft_ms_p99': st['ttft_ms_p99'],
            'decode_steps': st['decode_steps_total'],
            'prefill_chunks': st['prefill_chunks_total'],
            'preemptions': st['preemptions_total'],
            'prefix_hits': st['prefix_hits_total']}


def serve_phase(torch, card):
    """gpt_1p3b through the port's serving engine on the card. Returns
    the serve's launches and what the later serve phases reuse: the
    model, its fp32 copy on the CPU, the stream and two short prompts."""
    from paddle_tpu_torch.core import alerts as alerts_mod
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = gpt_1p3b()
    gen = torch.Generator(device='cuda').manual_seed(1234)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device='cuda', dtype=torch.bfloat16,
                           generator=gen)
    eng = ServingEngine(model, ServingConfig(**SERVE_PAGES), device='cuda')
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the stream of the JAX package's bench_gpt_serve (bench.py:632-636,
    # 675-685) on gpt_1p3b: 16 prompts of 32-384 tokens, 64 new tokens
    rng = np.random.RandomState(0)
    lens = rng.randint(32, 384 + 1, 16)
    prompts = [list(rng.randint(1, cfg.vocab_size, int(n))) for n in lens]
    # the metric history and the engine alert pack ride the stream
    # (bench.py:676-700): the publish cadence samples the rings
    reg = monitor.metrics()
    hist = reg.enable_history(capacity=240)
    alerts = alerts_mod.AlertManager(hist, rules=alerts_mod.default_rules(),
                                     source='chip_smoke')
    try:
        outs, wall, launches, st = timed_stream(torch, eng, prompts,
                                                SERVE_MAX_NEW)
        eng.publish_metrics()
        series = hist.export(max_points=24)
        alerts_rec = alerts.summary()
    finally:
        alerts.detach()
        reg.history = None
    if alerts_rec['fired_critical']:
        raise AssertionError(f'serve: critical alert fired: {alerts_rec}')
    check_served(eng, prompts, outs, SERVE_MAX_NEW, cfg.vocab_size)
    check_launches(launches, SERVE_KERNELS, ('paged_attention_int8',))

    # the engine's prefill logits vs the port's CPU fp32 run
    short = [list(rng.randint(1, cfg.vocab_size, n)) for n in (7, 19)]
    with torch.device('meta'):
        cpu_model = GPTForCausalLM(cfg)
    cpu_model = cpu_model.to_empty(device='cpu')
    cpu_model.load_state_dict({k: v.float().cpu()
                               for k, v in model.state_dict().items()})
    cpu_eng = ServingEngine(cpu_model, ServingConfig(
        page_size=16, max_batch_size=1, prefill_chunk=32,
        max_pages_per_seq=28, num_pages=4), device='cpu')
    logit_checks = logits_check(torch, eng, cpu_eng, short)
    emit({'phase': 'serve', 'card': card, 'model': 'gpt_1p3b',
          'layers': cfg.num_layers, 'hidden': cfg.hidden_size,
          'requests': len(prompts), 'max_new_tokens': SERVE_MAX_NEW,
          'model_build_s': build_s, **stream_line(st, wall),
          'bytes_per_token': st['pool']['bytes_per_token'],
          'launches': launches, 'logits_vs_cpu_fp32': logit_checks,
          'logits_rtol': LOGITS_RTOL, 'series': series,
          'alerts': alerts_rec})
    profile_phase(torch, eng, prompts[:8])
    served = dict(cfg=cfg, model=model, cpu_model=cpu_model, prompts=prompts,
                  outs=outs, short=short,
                  bytes_per_token=st['pool']['bytes_per_token'])
    eng.shutdown()
    return launches, served


INT8_BYTES_PER_TOKEN = 2 * (2048 + 4 * 16) * 24     # 101,376
BF16_BYTES_PER_TOKEN = 2 * 2048 * 2 * 24            # 196,608


def serve_int8_phase(torch, card, served):
    """The serve's stream with bf16 weights over an int8 KV pool: every
    request completes, the pool drains, attention runs on the int8
    paged kernel only, the pool costs 101,376 bytes a token against the
    bf16 pool's 196,608, and the prefill logits agree with the CPU fp32
    engine's over an int8 pool on the same weights."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg, prompts = served['cfg'], served['prompts']
    eng = ServingEngine(served['model'], ServingConfig(
        kv_dtype='int8', **SERVE_PAGES), device='cuda')
    outs, wall, launches, st = timed_stream(torch, eng, prompts,
                                            SERVE_MAX_NEW)
    check_served(eng, prompts, outs, SERVE_MAX_NEW, cfg.vocab_size)
    check_launches(launches, ('paged_attention_int8', 'layer_norm',
                              'bias_gelu'), ('paged_attention',))
    if (st['pool']['bytes_per_token'], served['bytes_per_token']) != (
            INT8_BYTES_PER_TOKEN, BF16_BYTES_PER_TOKEN):
        raise AssertionError(
            f"bytes per token: int8 {st['pool']['bytes_per_token']}, bf16 "
            f"{served['bytes_per_token']}; want {INT8_BYTES_PER_TOKEN}, "
            f"{BF16_BYTES_PER_TOKEN}")
    cpu_eng = ServingEngine(served['cpu_model'], ServingConfig(
        page_size=16, max_batch_size=1, prefill_chunk=32,
        max_pages_per_seq=28, num_pages=4, kv_dtype='int8'), device='cpu')
    checks = logits_check(torch, eng, cpu_eng, served['short'])
    same = token_share(outs, served['outs'], prompts)
    emit({'phase': 'serve_int8', 'card': card, 'model': 'gpt_1p3b',
          'kv_dtype': 'int8', 'requests': len(prompts),
          'max_new_tokens': SERVE_MAX_NEW, **stream_line(st, wall),
          'bytes_per_token': st['pool']['bytes_per_token'],
          'bf16_bytes_per_token': served['bytes_per_token'],
          'tokens_equal_to_bf16_serve': same, 'launches': launches,
          'logits_vs_cpu_fp32_int8_kv': checks, 'logits_rtol': LOGITS_RTOL})
    eng.shutdown()
    return launches


def token_share(outs, ref, prompts):
    """The share of generated tokens equal to the reference run's, token
    by token."""
    pairs = [(a, b) for o, r, p in zip(outs, ref, prompts)
             for a, b in zip(o[len(p):], r[len(p):])]
    return sum(a == b for a, b in pairs) / max(len(pairs), 1)


class counting_fetches:
    """Counts every fetch of chosen ids from the card (the engine's
    _host_fetch) while entered; `count[0]` is the tally."""

    def __enter__(self):
        from paddle_tpu_torch.serving import engine as engine_mod
        self.mod, self.real = engine_mod, engine_mod._host_fetch
        self.count = [0]

        def counting(x):
            self.count[0] += 1
            return self.real(x)
        engine_mod._host_fetch = counting
        return self.count

    def __exit__(self, *exc):
        self.mod._host_fetch = self.real
        return False


def want_fetches(st, eng):
    """The fetches a stream makes: one per prefill that completes and
    samples (its last chunk; the earlier chunks of a long prompt stay
    queued on the card), per serial decode step and per fused window,
    and no other."""
    return (eng.prefill_fetches + st['decode_steps_total']
            - st['fused_iterations_total'] + st['fused_windows_total'])


def counted_stream(torch, eng, prompts, max_new, **gen):
    """timed_stream with every fetch of chosen ids from the card during
    the stream counted, and held to want_fetches."""
    with counting_fetches() as count:
        outs, wall, launches, st = timed_stream(
            torch, eng, prompts, max_new,
            before=lambda: count.__setitem__(0, 0), **gen)
    if count[0] != want_fetches(st, eng):
        raise AssertionError(f'{count[0]} host fetches, want '
                             f'{want_fetches(st, eng)}')
    return outs, wall, launches, st, count[0]


def serve_modes_phase(torch, card, served):
    """The other serving modes at gpt_1p3b's full width and depth:
    (a) int8 weights over an int8 KV pool: the stream completes, 96
        weights quantized, the prefill logits within LOGITS_RTOL of the
        CPU fp32 engine with the same quantized weights;
    (b) greedy fused windows of 8 against 1 on the serve's first 4
        requests (bench.py:797-803): identical tokens, decode tok/s,
        host fetches;
    (c) the same sampled (top_k 40, temperature 0.8, seed 5): identical;
    (d) spec_k 4 on bench.py's shared-prefix stream (8 requests, a
        256-token system prompt; bench.py:727-795) against spec_k 0:
        acceptance rate, decode tok/s, the share of equal tokens.
    (b), (c) and (d) run their two engines in turns (k, k', k', k), so
    the two are compared within one call on one card."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg, model, prompts = served['cfg'], served['model'], served['prompts']
    line = {'phase': 'serve_modes', 'card': card, 'model': 'gpt_1p3b'}

    # (a)
    eng = ServingEngine(model, ServingConfig(
        kv_dtype='int8', weight_dtype='int8', **SERVE_PAGES), device='cuda')
    outs, wall, launches, st = timed_stream(torch, eng, prompts,
                                            SERVE_MAX_NEW)
    check_served(eng, prompts, outs, SERVE_MAX_NEW, cfg.vocab_size)
    check_launches(launches, ('paged_attention_int8', 'layer_norm',
                              'bias_gelu'), ('paged_attention',))
    if st['quantized_params'] != 4 * cfg.num_layers:
        raise AssertionError(f"quantized_params {st['quantized_params']}")
    cpu_eng = ServingEngine(served['cpu_model'], ServingConfig(
        page_size=16, max_batch_size=1, prefill_chunk=32,
        max_pages_per_seq=28, num_pages=4, kv_dtype='int8',
        weight_dtype='int8'), device='cpu')
    line['a_int8_weights_int8_kv'] = dict(
        stream_line(st, wall), quantized_params=st['quantized_params'],
        tokens_equal_to_bf16_serve=token_share(outs, served['outs'],
                                               prompts),
        logits_vs_cpu_fp32_same_quantized_weights=logits_check(
            torch, eng, cpu_eng, served['short']))
    eng.shutdown()
    del cpu_eng

    # (b), (c): each pair in turns, k, k', k', k (one card, one call)
    sb = prompts[:4]
    sb_pages = -(-(384 + SERVE_MAX_NEW) // 16)
    for key, gen in (('b_fused_greedy', {}),
                     ('c_fused_sampled', dict(top_k=40, temperature=0.8))):
        runs = {1: [], 8: []}
        for k in (1, 8, 8, 1):
            eng = ServingEngine(model, ServingConfig(
                page_size=16, max_batch_size=4, prefill_chunk=128,
                max_pages_per_seq=sb_pages, fused_k=k, seed=5),
                device='cuda')
            outs, wall, _l, st, fetches = counted_stream(
                torch, eng, sb, SERVE_MAX_NEW, **gen)
            check_served(eng, sb, outs, SERVE_MAX_NEW, cfg.vocab_size)
            if k > 1 and not st['fused_windows_total']:
                raise AssertionError(f'{key}: no fused window ran')
            runs[k].append((outs, dict(
                stream_line(st, wall), fused_windows=st['fused_windows_total'],
                fused_iterations=st['fused_iterations_total'],
                host_fetches=fetches, tokens_generated=sum(
                    len(o) - len(p) for o, p in zip(outs, sb)))))
            eng.shutdown()
        ref = runs[1][0][0]
        for k, turns in runs.items():
            for outs, _rec in turns:
                if outs != ref:
                    raise AssertionError(
                        f'{key}: fused_k={k} tokens differ from fused_k=1 '
                        f'(equal share {token_share(outs, ref, sb)})')
        line[key] = {'requests': len(sb), 'identical': True,
                     'order': [1, 8, 8, 1],
                     'fused_k_1': [r for _o, r in runs[1]],
                     'fused_k_8': [r for _o, r in runs[8]]}

    # (d), in turns as well
    rng = np.random.RandomState(1)
    system = list(rng.randint(1, cfg.vocab_size, 256))
    shared = [system + list(rng.randint(1, cfg.vocab_size, int(n)))
              for n in rng.randint(32, 384 + 1, 8)]
    pages = -(-(256 + 384 + SERVE_MAX_NEW) // 16)
    runs = {0: [], 4: []}
    for k in (0, 4, 4, 0):
        eng = ServingEngine(model, ServingConfig(
            page_size=16, max_batch_size=8, prefill_chunk=128,
            max_pages_per_seq=pages, spec_k=k), device='cuda')
        if k:
            # the verify step's shape, on a prompt the proposer fires on
            eng.generate([[7, 8, 9] * 4], max_new_tokens=4)
        outs, wall, _l, st = timed_stream(torch, eng, shared, SERVE_MAX_NEW)
        check_served(eng, shared, outs, SERVE_MAX_NEW, cfg.vocab_size)
        runs[k].append((outs, dict(
            stream_line(st, wall),
            spec_proposed=st['spec_proposed_tokens_total'],
            spec_accepted=st['spec_accepted_tokens_total'],
            spec_acceptance_rate=st['spec_acceptance_rate'],
            decode_tokens=st['decode_tokens_total'])))
        eng.shutdown()
    line['d_spec_shared_prefix'] = {
        'requests': len(shared), 'system_prompt_tokens': 256, 'spec_k': 4,
        'order': [0, 4, 4, 0],
        'spec_k_0': [r for _o, r in runs[0]],
        'spec_k_4': [r for _o, r in runs[4]],
        'tokens_equal_to_spec_k_0': token_share(runs[4][0][0], runs[0][0][0],
                                                shared)}
    emit(line)


# the gpt_serve_tenants leg's stream (bench.py:1230-1240, 1343-1362) on
# gpt_1p3b: heavy requests flood 8 slots, light ones arrive 3 steps later
TENANT_PAGES = dict(page_size=16, max_batch_size=8, prefill_chunk=128,
                    max_pages_per_seq=24)
HEAVY_N, HEAVY_LEN, HEAVY_NEW = 12, 256, 128
LIGHT_N, LIGHT_LEN, LIGHT_NEW = 12, 24, 16
H100_NAME = 'NVIDIA H100 80GB HBM3'


def tenant_stream(vocab):
    rng = np.random.RandomState(0)
    heavy = [list(rng.randint(1, vocab, HEAVY_LEN)) for _ in range(HEAVY_N)]
    light = [list(rng.randint(1, vocab, LIGHT_LEN)) for _ in range(LIGHT_N)]
    return heavy, light


def tenant_map():
    """The leg's SLO map: the heavy quota bills every admit but is sized
    not to bind (its burst holds the whole heavy bill), so the run
    compares schedulers, not a rate limit (bench.py:1352-1362)."""
    bill = float(HEAVY_N * (HEAVY_LEN + HEAVY_NEW))
    light = {'priority': 1, 'weight': 1.0}
    return {'heavy': {'priority': 0, 'quota_tokens_per_s': bill,
                      'burst_tokens': bill, 'weight': 0.2},
            'light0': light, 'light1': light, 'light2': light}


def tenant_engine(model, device, tenants, heavy):
    """The leg's engine and warm-up: one short request, and with a ladder
    one more at stage 2 (the halved chunk); the ladder then starts over
    at stage 0 with no history."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    eng = ServingEngine(model, ServingConfig(**TENANT_PAGES,
                                             tenants=tenants), device=device)
    eng.generate([heavy[0][:4]], max_new_tokens=2)
    lad = eng._ladder
    if lad is not None:
        lad.stage = 2
        eng.generate([heavy[0][:4]], max_new_tokens=2)
        lad.stage = lad._calm = lad.transitions = 0
        lad._ring.clear()
        lad.history.clear()
        eng.pool.set_eviction_weights(None)
    eng.reset_stats()
    return eng


def tenant_run(eng, heavy, light):
    """Heavy requests, 3 steps, then the light ones; drained. Returns
    (heavy requests, light requests)."""
    hreqs = [eng.submit(p, max_new_tokens=HEAVY_NEW, tenant_id='heavy')
             for p in heavy]
    for _ in range(3):
        eng.step()
    lreqs = [eng.submit(p, max_new_tokens=LIGHT_NEW,
                        tenant_id=f'light{i % 3}')
             for i, p in enumerate(light)]
    while eng.scheduler.has_work:
        eng.step()
    return hreqs, lreqs


def ladder_line(eng):
    return [(h['from'], h['to'], h['pressure'])
            for h in eng.ladder_history()]


def e2e_p99(reqs):
    from paddle_tpu_torch.serving.request_trace import percentile_of
    return percentile_of([r.finish_time - r.submit_time for r in reqs], 99)


def halved_chunks(eng):
    """(non-final prefill chunks of 64 tokens, of any other size than 64
    or 128): a chunk that is not the last of its prefill always has the
    chunk's full size, so a 64 proves the ladder's halved chunk ran."""
    by_req = {}
    for e in eng.tracer.events():
        if e['req'] >= 0:
            by_req.setdefault(e['req'], []).append(e)
    sizes = []
    for evs in by_req.values():
        for e, nxt in zip(evs, evs[1:]):
            if e['event'] == 'prefill_chunk' and \
                    nxt['event'] == 'prefill_chunk':
                sizes.append(e['tokens'])
    return (sum(1 for n in sizes if n == 64),
            sorted({n for n in sizes if n not in (64, 128)}))


def serve_tenants_phase(torch, card, served):
    """The gpt_serve_tenants leg (bench.py:1207-1389) on gpt_1p3b at full
    width and depth: the light stream alone (solo), the adversarial
    stream under FCFS (no tenants) and under the SLO map, each with the
    leg's warm-up. Hard checks on the SLO run: every request gets its
    tokens and the pool drains; the ladder reaches stage 2 or more and a
    64-token (halved) chunk ran; per-tenant submitted and completed
    counts are the stream's; delivered + wasted = emitted; only the
    serve's three kernels launch; host fetches are exact; and a CPU
    replay (a 2-layer, hidden-64 model, the same stream, knobs and
    warm-up) makes the same ladder transitions and preemptions, which
    depend on lengths, pages and slots only. Returns the SLO run's
    launches."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops.kernels import _build

    cfg, model = served['cfg'], served['model']
    heavy, light = tenant_stream(cfg.vocab_size)
    ten = tenant_map()
    line = {'phase': 'serve_tenants', 'card': card, 'model': 'gpt_1p3b',
            'heavy': [HEAVY_N, HEAVY_LEN, HEAVY_NEW],
            'light': [LIGHT_N, LIGHT_LEN, LIGHT_NEW], **TENANT_PAGES}

    solo = tenant_engine(model, 'cuda', None, heavy)
    torch.cuda.synchronize()
    sreqs = [solo.submit(p, max_new_tokens=LIGHT_NEW,
                         tenant_id=f'light{i % 3}')
             for i, p in enumerate(light)]
    while solo.scheduler.has_work:
        solo.step()
    solo_p99 = e2e_p99(sreqs)
    solo.shutdown()

    runs = {}
    for name, tenants in (('fcfs', None), ('slo', ten)):
        eng = tenant_engine(model, 'cuda', tenants, heavy)
        torch.cuda.synchronize()
        _build.reset_launches()
        with counting_fetches() as count:
            t0 = time.perf_counter()
            hreqs, lreqs = tenant_run(eng, heavy, light)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = _build.routes_snapshot()
        st = eng.stats()
        check_served(eng, heavy, [r.output_ids() for r in hreqs], HEAVY_NEW,
                     cfg.vocab_size)
        check_served(eng, light, [r.output_ids() for r in lreqs], LIGHT_NEW,
                     cfg.vocab_size)
        check_launches(launches, SERVE_KERNELS, ('paged_attention_int8',))
        if count[0] != want_fetches(st, eng):
            raise AssertionError(f'{name}: {count[0]} host fetches, want '
                                 f'{want_fetches(st, eng)}')
        good = eng.ledger.goodput()
        if good['delivered_tokens'] + good['wasted_tokens'] != \
                good['emitted_tokens']:
            raise AssertionError(f'{name}: goodput identity broken {good}')
        rows = st['tenancy']['tenants']
        if tenants is not None:
            want = {'heavy': HEAVY_N, 'light0': LIGHT_N // 3,
                    'light1': LIGHT_N // 3, 'light2': LIGHT_N // 3}
            got = {t: (rows[t]['submitted'], rows[t]['completed'])
                   for t in want}
            if got != {t: (n, n) for t, n in want.items()}:
                raise AssertionError(f'per-tenant counts {got}')
            if max([h['to'] for h in eng.ladder_history()] or [0]) < 2:
                raise AssertionError(f'ladder {ladder_line(eng)}')
            n64, odd = halved_chunks(eng)
            if not n64 or odd:
                raise AssertionError(f'halved chunks {n64}, other {odd}')
            line['halved_chunks'] = n64
        outs = [r.output_ids() for r in hreqs + lreqs]
        runs[name] = dict(
            outs=outs, preemptions=[r.preemptions for r in hreqs + lreqs],
            ladder=ladder_line(eng), launches=launches, rec=dict(
                stream_line(st, wall), host_fetches=count[0],
                tokens_per_sec=sum(len(r.generated) for r in hreqs + lreqs)
                / wall,
                light_p99_e2e_s=e2e_p99(lreqs), heavy_p99_e2e_s=e2e_p99(hreqs),
                quota_deferrals=st['quota_deferrals_total'],
                preemptions_charged=st['preemptions_charged_total'],
                per_tenant={t: {k: r.get(k) for k in (
                    'priority', 'submitted', 'completed',
                    'preemptions_charged', 'charge_tokens', 'tokens_billed')}
                    for t, r in rows.items()},
                ladder=[dict(zip(('from', 'to', 'pressure'), h))
                        for h in ladder_line(eng)],
                account=eng.ledger.account(), goodput=good,
                roofline=eng.ledger.roofline()))
        eng.shutdown()
        free_cuda(torch)

    # the CPU replay of the SLO run's decisions
    small = GPTConfig(vocab_size=cfg.vocab_size, hidden_size=64,
                      num_layers=2, num_heads=2, max_seq_len=512,
                      hidden_dropout=0.0, attn_dropout=0.0)
    cpu = tenant_engine(GPTForCausalLM(small, generator=torch.Generator()
                                       .manual_seed(3)), 'cpu', ten, heavy)
    ch, cl = tenant_run(cpu, heavy, light)
    replay = dict(ladder=ladder_line(cpu),
                  preemptions=[r.preemptions for r in ch + cl])
    cpu.shutdown()
    slo, fcfs = runs['slo'], runs['fcfs']
    if (replay['ladder'], replay['preemptions']) != (slo['ladder'],
                                                    slo['preemptions']):
        raise AssertionError(f"CPU replay {replay} vs card "
                             f"{slo['ladder']}, {slo['preemptions']}")
    roof = slo['rec']['roofline'] or {}
    line.update(
        solo_light_p99_e2e_s=solo_p99,
        light_p99_vs_solo=slo['rec']['light_p99_e2e_s'] / solo_p99,
        aggregate_decode_vs_fcfs=(slo['rec']['decode_tokens_per_sec']
                                  / fcfs['rec']['decode_tokens_per_sec']),
        light_p99_fcfs_over_slo=(fcfs['rec']['light_p99_e2e_s']
                                 / slo['rec']['light_p99_e2e_s']),
        tokens_equal_fcfs_slo=token_share(slo['outs'], fcfs['outs'],
                                          heavy + light),
        mbu_peak=(roof.get('peak_hbm_gbps'), H100_NAME),
        cpu_replay_equal=True, cpu_replay_preemptions=sum(
            replay['preemptions']),
        fcfs=fcfs['rec'], slo=slo['rec'])
    emit(line)
    return slo['launches']


TIERED_HOST_PAGES = 448
TIERED_DEVICE_PAGES = 112


def tier_round_trip(torch, dtype, pages=48):
    """A bit-exact round trip on the card at gpt_1p3b's layer shapes:
    `pages` written pages spill to the pinned tier, their device pages
    are overwritten and taken, and a prefix match fetches the chain back
    into other pages; every layer's K and V (and an int8 pool's scales)
    must equal what was spilled. Returns the sizes and the spill and
    fetch times (synchronised) with their GB/s."""
    from paddle_tpu_torch.serving import KVPagePool
    from paddle_tpu_torch.serving.host_tier import HostTier

    pool = KVPagePool(num_pages=3 * pages, page_size=16, num_layers=24,
                      num_heads=16, head_dim=128, dtype=dtype,
                      prefix_cache=True)
    pool.materialize('cuda')
    gen = torch.Generator(device='cuda').manual_seed(21)
    for layer in pool.kv:
        for b in layer:
            if b.dtype == torch.int8:
                b.copy_(torch.randint(-128, 128, b.shape, device='cuda',
                                      generator=gen, dtype=torch.int8))
            else:
                b.copy_(torch.randn(b.shape, device='cuda', generator=gen)
                        .to(b.dtype))
    pool.attach_host_tier(HostTier(pages))
    out = {}
    for rnd, base in enumerate((7000, 9000)):       # the first warms up
        toks = list(range(base, base + pages * 16))
        pool.ensure_capacity('w', len(toks))
        pool.register_prefix('w', toks, written=len(toks))
        src = pool.page_table('w')
        want = [[b[src].clone() for b in layer] for layer in pool.kv]
        pool.release('w')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if pool.spill_lru(sync=True) != pages:
            raise AssertionError('round trip: spill')
        spill_s = time.perf_counter() - t0
        idx = torch.as_tensor(src, device='cuda')
        for layer in pool.kv:
            for b in layer:
                b.index_fill_(0, idx, 0)
        pool.ensure_capacity('hold', len(toks))     # takes the freed pages
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pool.match_and_map('b', toks + [1], limit=len(toks))
        torch.cuda.synchronize()
        fetch_s = time.perf_counter() - t0
        dst = pool.page_table('b')
        if got != len(toks) or set(dst) & set(src):
            raise AssertionError(f'round trip: fetched {got} tokens into '
                                 f'{len(set(dst) & set(src))} spilled pages')
        for lw, layer in zip(want, pool.kv):
            for w, b in zip(lw, layer):
                if not torch.equal(b[dst], w):
                    raise AssertionError(f'round trip {dtype}: rows differ')
        nbytes = pages * sum(b[0].numel() * b.element_size()
                             for layer in pool.kv for b in layer)
        out = dict(pages=pages, bytes=nbytes, spill_s=spill_s,
                   fetch_s=fetch_s, spill_gb_s=nbytes / spill_s / 1e9,
                   fetch_gb_s=nbytes / fetch_s / 1e9, bit_exact=True,
                   host_pinned=all(b.is_pinned() for layer in
                                   pool.host_tier._buffers for b in layer))
        pool.release('b')
        pool.release('hold')
        pool.reset()
    pool.host_tier.shutdown()
    pool.drop_arrays()
    return out


def serve_tiered_phase(torch, card, served):
    """The oversubscribed record of gpt_serve_throughput (bench.py:
    851-952) on the serve's 16-request stream at gpt_1p3b: sized to fit
    (224 device pages) and oversubscribed (112 device pages, a 448-page
    pinned host tier, spill watermark 0.7). Hard checks: pages spilled
    and fetched back; every request completes, the pool drains and no
    spill is in flight; only the serve's three kernels launch; host
    fetches are exact; bit-exact round trips on the card for a bf16 and
    an int8 pool. Also the resurrect-vs-recompute TTFT on a 257-token
    prompt, best of 3. Returns the oversubscribed run's launches."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.serving.request_trace import percentile_of

    cfg, model, prompts = served['cfg'], served['model'], served['prompts']
    line = {'phase': 'serve_tiered', 'card': card, 'model': 'gpt_1p3b',
            'requests': len(prompts), 'max_new_tokens': SERVE_MAX_NEW}
    runs = {}
    for name, num_pages, host in (('sized_to_fit', 224, 0),
                                  ('oversubscribed', TIERED_DEVICE_PAGES,
                                   TIERED_HOST_PAGES)):
        eng = ServingEngine(model, ServingConfig(
            **SERVE_PAGES, num_pages=num_pages, host_tier_pages=host,
            spill_watermark=0.7), device='cuda')
        outs, wall, launches, st, fetches = counted_stream(
            torch, eng, prompts, SERVE_MAX_NEW)
        check_served(eng, prompts, outs, SERVE_MAX_NEW, cfg.vocab_size)
        check_launches(launches, SERVE_KERNELS, ('paged_attention_int8',))
        pst = st['pool']
        if host:
            eng._host_tier.drain()
            if eng.pool._spilling:
                raise AssertionError('spills still in flight')
            if not pst['tier_spilled_pages_total'] or not (
                    pst['tier_fetched_pages_total']
                    or pst['tier_resurrected_pages_total']):
                raise AssertionError(f'tier idle: {pst}')
        table = eng.request_table()
        pct = {label: {f'p{q}': percentile_of(
            [r[key] for r in table.values()], q) for q in (50, 90, 99)}
            for key, label in (('ttft_s', 'ttft_s'), ('e2e_s', 'e2e_s'))}
        runs[name] = (outs, launches, dict(
            device_pages=num_pages, host_pages=host,
            tokens_per_sec=sum(len(o) - len(p)
                               for o, p in zip(outs, prompts)) / wall,
            **stream_line(st, wall), slo=pct, host_fetches=fetches,
            spilled_pages=pst.get('tier_spilled_pages_total', 0),
            spilled_gb=pst.get('tier_spilled_bytes_total', 0) / 1e9,
            fetched_pages=pst.get('tier_fetched_pages_total', 0),
            fetched_gb=pst.get('tier_fetched_bytes_total', 0) / 1e9,
            resurrected_pages=pst.get('tier_resurrected_pages_total', 0),
            page_stream_s=(eng.ledger.account() or {}).get(
                'components', {}).get('page_stream')))
        eng.shutdown()
        free_cuda(torch)
    fit_outs = runs['sized_to_fit'][0]
    line.update({name: rec for name, (_o, _l, rec) in runs.items()})
    line['tokens_equal_to_sized_to_fit'] = token_share(
        runs['oversubscribed'][0], fit_outs, prompts)

    line['round_trip'] = {'bf16': tier_round_trip(torch, torch.bfloat16),
                          'int8': tier_round_trip(torch, 'int8')}
    free_cuda(torch)

    # resurrect vs recompute TTFT (bench.py:904-936): a 16-page prompt
    rng = np.random.RandomState(2)
    long_prompt = list(rng.randint(1, cfg.vocab_size, 16 * 16 + 1))
    eng = ServingEngine(model, ServingConfig(
        page_size=16, max_batch_size=2, prefill_chunk=128,
        max_pages_per_seq=20, host_tier_pages=36), device='cuda')
    eng.generate([long_prompt], max_new_tokens=2)
    recompute, resurrect, outs = [], [], {}
    for _ in range(3):
        eng.pool.reset()
        eng.reset_stats()
        outs['recompute'] = eng.generate([long_prompt], max_new_tokens=2)
        (r,) = eng.request_table().values()
        recompute.append(r['ttft_s'])
        if eng.pool.spill_lru(sync=True) < 16:
            raise AssertionError('the long prompt did not spill')
        eng.reset_stats()
        outs['resurrect'] = eng.generate([long_prompt], max_new_tokens=2)
        (r,) = eng.request_table().values()
        resurrect.append(r['ttft_s'])
    if eng.pool.stats()['tier_resurrected_pages_total'] < 3 * 16:
        raise AssertionError('the resurrect path did not fetch')
    eng.shutdown()
    line['resurrect_vs_recompute'] = dict(
        prompt_tokens=len(long_prompt), recompute_ttft_s=recompute,
        resurrect_ttft_s=resurrect,
        speedup=min(recompute) / min(resurrect),
        outputs_equal=outs['resurrect'] == outs['recompute'])
    emit(line)
    return runs['oversubscribed'][1]


# ---------------------------------------------------------------------------
# the serving cluster on one card (bench.py:1017-1180, gpt_serve_cluster)
# ---------------------------------------------------------------------------
CLUSTER_N, CLUSTER_NEW, CLUSTER_SYS, CLUSTER_TAIL = 24, 48, 128, (16, 256)
CLUSTER_PAGES = dict(page_size=16, max_batch_size=8, prefill_chunk=128,
                     max_pages_per_seq=27)
# the routers refresh once a pass: the router's default 0.25 s interval
# (the leg's, bench.py:1109) ties a refresh, and so the ageing of its
# optimistic digest overlay, to the wall clock, and the CPU replay must
# make the card's placements. One more pass at the default interval
# times the periodic refresh, its placements unchecked.
CLUSTER_ROUTER = dict(page_size=16, refresh_interval_s=3600.0)
CLUSTER_DRAIN_PUMPS = 8
CLUSTER_PASSES = ('single', 'cluster', 'drain', 'live_refresh')
SLO_KEYS = (('ttft_s', 'ttft_ms'), ('tpot_s', 'tpot_ms'),
            ('queue_wait_s', 'queue_wait_ms'), ('e2e_s', 'e2e_ms'))


def cluster_stream(vocab):
    """The leg's stream (bench.py:1052-1057): two 128-token system
    prompts, each request one of them (in turns) and a random tail of
    16-256 tokens."""
    rng = np.random.RandomState(0)
    families = [list(rng.randint(1, vocab, CLUSTER_SYS)) for _ in range(2)]
    lo, hi = CLUSTER_TAIL
    return [families[i % 2]
            + list(rng.randint(1, vocab, int(rng.randint(lo, hi + 1))))
            for i in range(CLUSTER_N)]


def serve_launches(layers, forwards):
    """The serving kernels' launches over `forwards` forward_paged calls
    of GPT: one paged attention and one bias+GELU a block, two
    LayerNorms a block and the final one."""
    return {'paged_attention': forwards * layers,
            'layer_norm': forwards * (2 * layers + 1),
            'bias_gelu': forwards * layers}


def engine_forwards(st, fused_k):
    """forward_paged calls behind an engine's stats: one a prefill chunk,
    one a serial decode step, fused_k a fused window."""
    return (st['prefill_chunks_total'] + st['decode_steps_total']
            - st['fused_iterations_total']
            + fused_k * st['fused_windows_total'])


def slo_of(table):
    from paddle_tpu_torch.serving.request_trace import percentile_of
    out = {}
    for key, label in SLO_KEYS:
        vals = [r[key] for r in table.values()]
        out[label] = {f'p{q}': (None if (p := percentile_of(vals, q)) is None
                                else 1e3 * p) for q in (50, 90, 99)}
    return out


def cluster_passes(torch, model, device, prompts, sync, calls=None):
    """gpt_serve_cluster on `model`: (1) one engine over the stream; (2)
    two LocalReplicas behind ClusterRouter(max_queue=48); (3) the retry
    hint probe over the same replicas (bench.py:1141-1170, max_queue=2);
    (4) a second pass of the stream with router.drain('r0') after
    CLUSTER_DRAIN_PUMPS pumps; (5) the cluster pass over two fresh
    replicas behind a router at its default refresh interval (status,
    federation and alert evaluation every 0.25 s, as the leg runs it),
    whose placements follow the wall clock. Every engine gets the leg's
    warm-up.
    Returns what each pass decided and measured; with `calls` (a
    one-element count of forward_paged calls) each pass also records the
    calls it made."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.serving.cluster import (ClusterRouter,
                                                  LocalReplica,
                                                  RouterRejected)

    def engine():
        eng = ServingEngine(model, ServingConfig(**CLUSTER_PAGES),
                            device=device)
        eng.generate([prompts[0]], max_new_tokens=2, top_k=0)   # warm-up
        eng.reset_stats()
        return eng

    def forwards(engines):
        return sum(engine_forwards(e.stats(), e.config.fused_k)
                   for e in engines)

    def run_pass(fn, engines):
        sync()
        _build.reset_launches()
        before = calls[0] if calls is not None else None
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
        made = calls[0] - before if calls is not None else None
        return out, wall, _build.routes_snapshot(), (forwards(engines), made)

    rec = {}
    single = engine()
    outs, wall, launches, fwd = run_pass(
        lambda: single.generate(prompts, max_new_tokens=CLUSTER_NEW,
                                top_k=0), [single])
    rec['single'] = dict(outs=outs, wall=wall, launches=launches,
                         forwards=fwd, stats=single.stats(),
                         slo=slo_of(single.request_table()),
                         drained=single.pool.pages_in_use == 0)
    single.shutdown()

    reps = [LocalReplica(engine(), rid) for rid in ('r0', 'r1')]
    engines = [r.engine for r in reps]
    router = ClusterRouter(reps, max_queue=2 * CLUSTER_N, **CLUSTER_ROUTER)
    outs, wall, launches, fwd = run_pass(
        lambda: router.serve(prompts, max_new_tokens=CLUSTER_NEW, top_k=0,
                             timeout_s=600), engines)
    router.refresh()
    tables = {r.replica_id: r.engine.request_table() for r in reps}
    rec['cluster'] = dict(
        outs=outs, wall=wall, launches=launches, forwards=fwd,
        snapshot=router.snapshot(), router_e2e=router_e2e_ms(router),
        decisions=route_decisions(router),
        scrape=router.cluster_prometheus_text(),
        replicas={r.replica_id: dict(
            stats=r.engine.stats(), slo=slo_of(tables[r.replica_id]),
            requests=len(tables[r.replica_id]),
            drained=r.engine.pool.pages_in_use == 0) for r in reps},
        slo=slo_of({f'{rid}:{k}': v for rid, t in tables.items()
                    for k, v in t.items()}))

    # the retry hint against the time a retry actually took
    hint_router = ClusterRouter(reps, page_size=CLUSTER_ROUTER['page_size'],
                                max_queue=2, refresh_interval_s=0.0)
    hinted = actual = None
    for p in prompts * 4:
        try:
            hint_router.submit(p, max_new_tokens=CLUSTER_NEW, top_k=0)
        except RouterRejected as rej:
            hinted, t_rej = rej.retry_after_s, time.perf_counter()
            break
    pumps = 0
    while hinted is not None and actual is None:
        hint_router.pump()
        pumps += 1
        try:
            hint_router.submit(prompts[0], max_new_tokens=CLUSTER_NEW,
                               top_k=0)
            actual = time.perf_counter() - t_rej
        except RouterRejected:
            if pumps > 4096:
                raise
    hint_router.run(timeout_s=600)
    rec['hint'] = dict(
        hinted_s=hinted, actual_s=actual, pumps=pumps,
        hint_over_actual=(hinted / actual if hinted is not None and actual
                          else None),
        decisions=route_decisions(hint_router),
        placements=hint_router.snapshot()['placements'],
        drain_events=hint_router.snapshot()['drain_events'],
        rejects=hint_router.rejects)

    # a second pass of the stream with r0 drained mid-stream
    for e in engines:
        e.reset_stats()
    drain_router = ClusterRouter(reps, max_queue=2 * CLUSTER_N,
                                 **CLUSTER_ROUTER)

    def drained_pass():
        reqs = [drain_router.submit(p, max_new_tokens=CLUSTER_NEW, top_k=0)
                for p in prompts]
        for _ in range(CLUSTER_DRAIN_PUMPS):
            drain_router.pump()
        on_r0 = [r for r in reqs if r.replica_id == 'r0' and not r.done]
        moved = drain_router.drain('r0', reason='operator drain')
        drain_router.run(timeout_s=600)
        return reqs, on_r0, moved
    (reqs, on_r0, moved), wall, launches, fwd = run_pass(drained_pass,
                                                         engines)
    drain_router.refresh()
    rec['drain'] = dict(
        outs=[r.output_ids() for r in reqs], wall=wall, launches=launches,
        forwards=fwd, snapshot=drain_router.snapshot(),
        decisions=[(str(r.replica_id), r.decision, r.resubmits)
                   for r in reqs],
        moved=[r.id for r in moved], on_r0=[r.id for r in on_r0],
        moved_done=[(r.done, str(r.replica_id)) for r in moved],
        drained=[e.pool.pages_in_use == 0 for e in engines])
    for r in reps:
        r.shutdown()

    # the cluster pass at the router's default refresh interval
    reps = [LocalReplica(engine(), rid) for rid in ('r0', 'r1')]
    engines = [r.engine for r in reps]
    status_calls = [0]
    for r in reps:
        def counted(real=r.status):
            status_calls[0] += 1
            return real()
        r.status = counted
    live_router = ClusterRouter(reps, page_size=CLUSTER_ROUTER['page_size'],
                                max_queue=2 * CLUSTER_N)
    outs, wall, launches, fwd = run_pass(
        lambda: live_router.serve(prompts, max_new_tokens=CLUSTER_NEW,
                                  top_k=0, timeout_s=600), engines)
    rec['live_refresh'] = dict(
        outs=outs, wall=wall, launches=launches, forwards=fwd,
        status_calls=status_calls[0], snapshot=live_router.snapshot(),
        drained=[e.pool.pages_in_use == 0 for e in engines])
    for r in reps:
        r.shutdown()
    return rec


def route_decisions(router):
    """(replica, decision) of every request the router placed, in
    submission order."""
    return [(v['replica_id'], v['router_decision'])
            for _k, v in sorted(router.request_slo().items())]


def check_cluster(rec, prompts, vocab, where):
    """The hard checks every run of cluster_passes must pass."""
    def served(outs, what):
        for p, o in zip(prompts, outs):
            if len(o) != len(p) + CLUSTER_NEW or o[:len(p)] != p or not all(
                    0 <= t < vocab for t in o[len(p):]):
                raise AssertionError(f'{where} {what}: a request of '
                                     f'{len(p)} tokens returned {len(o)}')
        if len(outs) != len(prompts):
            raise AssertionError(f'{where} {what}: {len(outs)} outputs')
    served(rec['single']['outs'], 'single engine')
    served(rec['cluster']['outs'], 'cluster')
    served(rec['drain']['outs'], 'drain pass')
    served(rec['live_refresh']['outs'], 'default-refresh pass')
    if not (rec['single']['drained']
            and all(r['drained'] for r in rec['cluster']['replicas'].values())
            and all(rec['drain']['drained'])
            and all(rec['live_refresh']['drained'])):
        raise AssertionError(f'{where}: a pool did not drain')
    live = rec['live_refresh']['snapshot']
    if live['placements']['drain'] or live['drain_events'] or live['rejects']:
        raise AssertionError(f'{where}: the default-refresh pass drained '
                             f'or rejected: {live}')
    snap = rec['cluster']['snapshot']
    routed = [v['requests_routed'] for v in snap['replicas'].values()]
    rr = round_robin_hits(prompts, 2, CLUSTER_PAGES['page_size'])
    pl = snap['placements']
    if min(routed) <= 0 or pl['affinity'] <= rr:
        raise AssertionError(f'{where}: routed {routed}, affinity hits '
                             f"{pl['affinity']} vs round-robin's {rr}")
    if pl['drain'] or snap['drain_events'] or snap['rejects'] \
            or pl['prefetch_hint'] != pl['affinity']:
        raise AssertionError(f'{where}: the cluster pass drained, '
                             f'rejected or lost a hint: {snap}')
    for rid in ('r0', 'r1'):
        if f'ptpu_serve_decode_tokens_total{{replica="{rid}"}}' \
                not in rec['cluster']['scrape']:
            raise AssertionError(f'{where}: the federated scrape lacks '
                                 f'{rid}')
    dr = rec['drain']
    dsnap = dr['snapshot']
    events = [(e['replica_id'], e['reason']) for e in dsnap['drain_events']]
    if dsnap['placements']['drain'] != 1 or events != [
            ('r0', 'operator drain')] or not dr['on_r0'] \
            or sorted(dr['moved']) != sorted(dr['on_r0']) \
            or dr['moved_done'] != [(True, 'r1')] * len(dr['moved']):
        raise AssertionError(f'{where}: drain pass {events}, on r0 '
                             f"{dr['on_r0']}, moved {dr['moved_done']}")
    if rec['hint']['hinted_s'] is None or rec['hint']['actual_s'] is None:
        raise AssertionError(f"{where}: no retry hint {rec['hint']}")
    if rec['hint']['drain_events'] or rec['hint']['placements']['drain']:
        raise AssertionError(f"{where}: the hint pass drained "
                             f"{rec['hint']['drain_events']}")


def round_robin_hits(prompts, n_replicas, page_size):
    """Affinity hits pure round-robin placement would get
    (tests/test_serving_cluster.py `_round_robin_affinity_hits`)."""
    from paddle_tpu_torch.serving import chain_hashes
    digests = [set() for _ in range(n_replicas)]
    hits = 0
    for i, p in enumerate(prompts):
        h = chain_hashes(p, page_size, limit=len(p) - 1)
        if h and h[0] in digests[i % n_replicas]:
            hits += 1
        digests[i % n_replicas].update(h)
    return hits


def cluster_replay(torch, vocab, prompts):
    """cluster_passes on the CPU over a 2-layer, hidden-64 model with the
    stream's vocabulary, each pass's forward_paged calls counted: the
    placements to hold the card's against, and the launch formula's
    input checked against the count."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    small = GPTConfig(vocab_size=vocab, hidden_size=64, num_layers=2,
                      num_heads=2, max_seq_len=512, hidden_dropout=0.0,
                      attn_dropout=0.0)
    model = GPTForCausalLM(small, generator=torch.Generator().manual_seed(3))
    calls = [0]
    real = model.gpt.forward_paged

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    model.gpt.forward_paged = counted
    rec = cluster_passes(torch, model, 'cpu', prompts, lambda: None, calls)
    for what in CLUSTER_PASSES:
        want, made = rec[what]['forwards']
        if made != want:
            raise AssertionError(f'CPU replay {what}: {made} forward_paged '
                                 f'calls, the engines count {want}')
    return rec


def serve_cluster_phase(torch, card, served):
    """gpt_serve_cluster (bench.py:1017-1180) on gpt_1p3b at full width and
    depth, bf16, both replicas on the one card: the single engine, the
    two-replica cluster, the retry-hint probe, the drain pass and the
    cluster at the default refresh interval (cluster_passes). Hard checks
    (check_cluster): every request returns its prompt and 48 tokens and
    every pool drains; both replicas took traffic and the affinity hits
    beat round-robin's; the drained requests finish on r1 with one drain
    recorded, and no other pass drains; the federated scrape holds both
    replicas' decode counters; the single, cluster, drain and
    default-refresh passes launch rows 1-3 exactly serve_launches times
    and nothing else; and a CPU replay (cluster_replay) makes the same
    placement
    decision for every request of the cluster, hint and drain passes,
    with outputs token-identical to its own single engine. Recorded:
    wall tokens/s against the single engine, and the default-refresh
    pass's against the once-a-pass cluster's, per-replica decode tok/s
    over each replica's own decode time, TTFT/TPOT/queue/e2e p50/p90/p99
    per replica and over the cluster, the placements, the hint over the
    actual retry time, and the share of tokens equal to the single
    engine's. Returns the cluster pass's launches and the line."""
    cfg, model = served['cfg'], served['model']
    prompts = cluster_stream(cfg.vocab_size)
    rec = cluster_passes(torch, model, 'cuda', prompts,
                         torch.cuda.synchronize)
    check_cluster(rec, prompts, cfg.vocab_size, 'card')
    if rec['live_refresh']['status_calls'] <= 2:        # the first refresh
        raise AssertionError('serve_cluster: the default-refresh router '
                             'never refreshed after its first status')
    for what in CLUSTER_PASSES:
        check_exact_launches(f'serve_cluster {what}', rec[what]['launches'],
                             serve_launches(cfg.num_layers,
                                            rec[what]['forwards'][0]))
    free_cuda(torch)

    replay = cluster_replay(torch, cfg.vocab_size, prompts)
    check_cluster(replay, prompts, cfg.vocab_size, 'CPU replay')
    for what in ('cluster', 'drain'):
        if replay[what]['outs'] != replay['single']['outs']:
            raise AssertionError(f'CPU replay: the {what} pass tokens differ '
                                 f"from the single engine's")
    for what in ('cluster', 'hint', 'drain'):
        if replay[what]['decisions'] != rec[what]['decisions']:
            raise AssertionError(
                f"CPU replay {what} placements {replay[what]['decisions']} "
                f"vs card {rec[what]['decisions']}")

    line = cluster_line(card, nvidia_smi_line(), cfg, rec, replay, prompts)
    emit(line)
    return rec['cluster']['launches'], line


def cluster_line(card, smi, cfg, rec, replay, prompts):
    """serve_cluster's record from cluster_passes' runs on the card
    (`rec`) and on the CPU (`replay`). A replica's decode tok/s is over
    its own decode seconds; wall_s and tokens_per_sec over the pass."""
    single, cluster, drain = rec['single'], rec['cluster'], rec['drain']
    live = rec['live_refresh']
    gen = CLUSTER_N * CLUSTER_NEW
    snap = cluster['snapshot']
    per_replica = {rid: dict(
        requests=r['requests'], **stream_line(r['stats'], cluster['wall']),
        batch_occupancy=r['stats']['batch_occupancy'], slo=r['slo'])
        for rid, r in cluster['replicas'].items()}
    return {
        'phase': 'serve_cluster', 'card': card, 'nvidia_smi': smi,
        'model': 'gpt_1p3b', 'layers': cfg.num_layers, 'replicas': 2,
        'requests': CLUSTER_N, 'max_new_tokens': CLUSTER_NEW,
        **CLUSTER_PAGES,
        'single': dict(tokens_per_sec=gen / single['wall'],
                       **stream_line(single['stats'], single['wall']),
                       slo=single['slo'], launches=single['launches']),
        'cluster': dict(
            wall_s=cluster['wall'], tokens_per_sec=gen / cluster['wall'],
            tokens_per_sec_over_single=single['wall'] / cluster['wall'],
            slo=cluster['slo'], router_e2e_ms=cluster['router_e2e'],
            launches=cluster['launches'],
            placements=snap['placements'], rejects=snap['rejects'],
            affinity_hit_rate=snap['affinity_hit_rate'],
            round_robin_hits=round_robin_hits(
                prompts, 2, CLUSTER_PAGES['page_size']),
            goodput=snap['goodput'],
            token_share_vs_single=token_share(cluster['outs'],
                                              single['outs'], prompts),
            per_replica=per_replica),
        'retry_hint': {k: rec['hint'][k] for k in (
            'hinted_s', 'actual_s', 'hint_over_actual', 'pumps',
            'placements', 'rejects')},
        'live_refresh': dict(
            refresh_interval_s=0.25, wall_s=live['wall'],
            tokens_per_sec=gen / live['wall'],
            tokens_per_sec_over_cluster=cluster['wall'] / live['wall'],
            status_calls=live['status_calls'],
            placements=live['snapshot']['placements'],
            token_share_vs_single=token_share(live['outs'], single['outs'],
                                              prompts),
            launches=live['launches']),
        'drain': dict(
            wall_s=drain['wall'], moved=len(drain['moved']),
            placements=drain['snapshot']['placements'],
            goodput=drain['snapshot']['goodput'],
            token_share_vs_single=token_share(drain['outs'], single['outs'],
                                              prompts),
            launches=drain['launches']),
        'cpu_replay': dict(placements_equal=True, tokens_equal=True,
                           forwards={w: replay[w]['forwards'][0]
                                     for w in CLUSTER_PASSES})}


# ---------------------------------------------------------------------------
# prefill/decode disaggregation and worker replicas on one card
# ---------------------------------------------------------------------------
DISAGG_PAGES = dict(CLUSTER_PAGES, disaggregate=True, prefill_slots=2)
DISAGG_PASSES = ('single', 'disagg', 'cluster')
DISAGG_PAGE_CHECKS = 3          # requests whose pages are held byte for byte
# the workers' weights: serve_phase's seed and construction, so the
# in-process cluster of serve_cluster ran on the same weights
WORKER_SEED = 1234
WORKER_HANG_S = 3.0
WORKER_READY_S = 300.0
HANG_REQUESTS = 8


def engines_of(eng):
    """The ServingEngines behind an engine: (prefill, decode) for a
    disaggregated one."""
    return (eng.prefill, eng.decode) if hasattr(eng, 'decode') else (eng,)


def forwards_of(engines):
    return sum(engine_forwards(e.stats(), e.config.fused_k) for e in engines)


def disagg_passes(torch, model, device, prompts, sync, calls=None):
    """serve_disagg's passes on `model` over the stream: (1) one unified
    engine; (2) one DisaggregatedEngine (prefill_slots 2); (3) two
    disaggregated LocalReplicas behind ClusterRouter (refreshed once a
    pass). Every engine gets the leg's warm-up. Returns what each pass
    decided and measured; with `calls` (a one-element count of
    forward_paged calls) each pass also records the calls it made."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.serving.cluster import (ClusterRouter,
                                                  DisaggregatedEngine,
                                                  LocalReplica, build_engine)

    def warm(eng):
        eng.generate([prompts[0]], max_new_tokens=2, top_k=0)
        eng.reset_stats()
        return eng

    def run_pass(fn, engines):
        sync()
        _build.reset_launches()
        before = calls[0] if calls is not None else None
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
        made = calls[0] - before if calls is not None else None
        return out, wall, _build.routes_snapshot(), (forwards_of(engines),
                                                     made)

    def generate(eng):
        return lambda: eng.generate(prompts, max_new_tokens=CLUSTER_NEW,
                                    top_k=0)
    rec = {}
    uni = warm(ServingEngine(model, ServingConfig(**CLUSTER_PAGES),
                             device=device))
    outs, wall, launches, fwd = run_pass(generate(uni), [uni])
    rec['single'] = dict(outs=outs, wall=wall, launches=launches,
                         forwards=fwd, stats=uni.stats(),
                         slo=slo_of(uni.request_table()),
                         drained=uni.pool.pages_in_use == 0)
    uni.shutdown()

    dis = warm(DisaggregatedEngine(model, ServingConfig(**DISAGG_PAGES),
                                   device=device))
    # the facade's handoff counts are lifetime counts (the warm-up's too)
    before = dis.stats()
    outs, wall, launches, fwd = run_pass(generate(dis), engines_of(dis))
    st = dis.stats()
    rec['disagg'] = dict(
        outs=outs, wall=wall, launches=launches, forwards=fwd, stats=st,
        prefill_stats=dis.prefill.stats(), slo=slo_of(dis.request_table()),
        handoffs=st['pd_handoffs_total'] - before['pd_handoffs_total'],
        streamed_pages=(st['pd_streamed_pages_total']
                        - before['pd_streamed_pages_total']),
        full_pages=sum(len(p) // CLUSTER_PAGES['page_size']
                       for p in prompts),
        drained=all(e.pool.pages_in_use == 0 for e in engines_of(dis)))
    dis.shutdown()

    reps = [LocalReplica(warm(build_engine(
        model, ServingConfig(**DISAGG_PAGES), device=device)), rid)
        for rid in ('d0', 'd1')]
    engines = [e for r in reps for e in engines_of(r.engine)]
    router = ClusterRouter(reps, max_queue=2 * CLUSTER_N, **CLUSTER_ROUTER)
    outs, wall, launches, fwd = run_pass(
        lambda: router.serve(prompts, max_new_tokens=CLUSTER_NEW, top_k=0,
                             timeout_s=600), engines)
    router.refresh()
    rec['cluster'] = dict(outs=outs, wall=wall, launches=launches,
                          forwards=fwd, snapshot=router.snapshot(),
                          decisions=route_decisions(router),
                          drained=[e.pool.pages_in_use == 0
                                   for e in engines])
    router.shutdown()
    return rec


def check_disagg(rec, prompts, vocab, where):
    """The hard checks every run of disagg_passes must pass."""
    for what in DISAGG_PASSES:
        check_served_outs(prompts, rec[what]['outs'], vocab,
                          f'{where} {what}')
    if not (rec['single']['drained'] and rec['disagg']['drained']
            and all(rec['cluster']['drained'])):
        raise AssertionError(f'{where}: a pool did not drain')
    dis = rec['disagg']
    if dis['handoffs'] != CLUSTER_N or not \
            0 < dis['streamed_pages'] < dis['full_pages']:
        raise AssertionError(
            f"{where}: {dis['handoffs']} handoffs, {dis['streamed_pages']} "
            f"pages streamed of {dis['full_pages']} full prompt pages")
    snap = rec['cluster']['snapshot']
    if snap['requests_done'] != CLUSTER_N \
            or snap['placements']['affinity'] <= 0 \
            or snap['placements']['drain'] or snap['rejects']:
        raise AssertionError(f'{where}: the disaggregated cluster pass '
                             f'{snap}')


def disagg_replay(torch, vocab, prompts):
    """disagg_passes on the CPU over a 2-layer, hidden-64 fp32 model with
    the stream's vocabulary, each pass's forward_paged calls counted: the
    launch formula's input checked against the count, the tokens of the
    disaggregated engine and cluster against the unified engine's, and
    the placements to hold the card's against."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    small = GPTConfig(vocab_size=vocab, hidden_size=64, num_layers=2,
                      num_heads=2, max_seq_len=512, hidden_dropout=0.0,
                      attn_dropout=0.0)
    model = GPTForCausalLM(small, generator=torch.Generator().manual_seed(3))
    calls = [0]
    real = model.gpt.forward_paged

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    model.gpt.forward_paged = counted
    rec = disagg_passes(torch, model, 'cpu', prompts, lambda: None, calls)
    for what in DISAGG_PASSES:
        want, made = rec[what]['forwards']
        if made != want:
            raise AssertionError(f'CPU replay {what}: {made} forward_paged '
                                 f'calls, the engines count {want}')
    for what in ('disagg', 'cluster'):
        if rec[what]['outs'] != rec['single']['outs']:
            raise AssertionError(f"CPU replay: the {what} pass's tokens "
                                 f"differ from the unified engine's")
    return rec


def disagg_page_check(torch, model, prompts, kv_dtype, layers):
    """One unified and one disaggregated engine take the first
    DISAGG_PAGE_CHECKS requests of the stream (two share a system
    prompt, so the decode side maps one request's prefix pages where it
    streams the other's). Once every request decodes on the decode
    engine, its full prompt pages there equal byte for byte the pages
    the unified engine wrote: the K/V rows, and for kv_dtype 'int8' the
    int8 rows and their fp32 scales. Then both drain, and rows 1-3 (1q
    for the int8 pool) must have launched exactly once a layer a forward
    of the two engines. Returns the pages compared and the launches."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.serving import (RequestState, ServingConfig,
                                          ServingEngine)
    from paddle_tpu_torch.serving.cluster import DisaggregatedEngine

    kw = dict(CLUSTER_PAGES, kv_dtype=kv_dtype)
    uni = ServingEngine(model, ServingConfig(**kw), device='cuda')
    dis = DisaggregatedEngine(model, ServingConfig(disaggregate=True, **kw),
                              device='cuda')
    picks = prompts[:DISAGG_PAGE_CHECKS]
    torch.cuda.synchronize()
    _build.reset_launches()
    ru = [uni.submit(p, max_new_tokens=CLUSTER_NEW, top_k=0) for p in picks]
    rd = [dis.submit(p, max_new_tokens=CLUSTER_NEW, top_k=0) for p in picks]
    for _ in range(64):
        if all(r.state == RequestState.RUNNING for r in ru):
            break
        uni.step()
    for _ in range(64):
        if all(r in dis.decode.scheduler.slots for r in rd):
            break
        dis.step()
    ps = CLUSTER_PAGES['page_size']
    pages = bufs = 0
    for p, a, b in zip(picks, ru, rd):
        n = len(p) // ps
        upages = uni.pool.page_table(a.id)[:n]
        dpages = dis.decode.pool.page_table(b.id)[:n]
        if len(upages) != n or len(dpages) != n:
            raise AssertionError(f'serve_disagg {kv_dtype}: a request is '
                                 f'not resident on both sides')
        ui = torch.tensor(upages, device='cuda')
        di = torch.tensor(dpages, device='cuda')
        for lu, ld in zip(uni.pool.kv, dis.decode.pool.kv):
            for bu, bd in zip(lu, ld):
                if not torch.equal(bu.index_select(0, ui),
                                   bd.index_select(0, di)):
                    raise AssertionError(
                        f'serve_disagg {kv_dtype}: a decode-pool page '
                        f'differs from the page the unified engine wrote')
                bufs += 1
        pages += n
    while uni.scheduler.has_work:
        uni.step()
    while dis.has_work:
        dis.step()
    torch.cuda.synchronize()
    launches = _build.routes_snapshot()
    fwd = forwards_of((uni,) + engines_of(dis))
    want = serve_launches(layers, fwd)
    if kv_dtype == 'int8':
        want['paged_attention_int8'] = want.pop('paged_attention')
    check_exact_launches(f'serve_disagg {kv_dtype} arm', launches, want)
    uni.shutdown()
    dis.shutdown()
    return dict(kv_dtype=kv_dtype or 'bfloat16', requests=len(picks),
                pages_equal=pages, buffers_compared=bufs, forwards=fwd,
                launches={k: launches[k] for k in want})


def stream_rate(torch, model, n_pages):
    """stream_kv_pages of `n_pages` pages between two bf16 pools of the
    serve's shape on the card: device ms a call (CUDA events around a
    loop), GB/s of the rows moved, and the bound (each moved row read
    once and written once at 3.35 TB/s)."""
    from paddle_tpu_torch.serving import KVPagePool
    from paddle_tpu_torch.serving.cluster import stream_kv_pages

    attn = model.gpt.layers[0].attn
    pools = []
    for _ in range(2):
        pool = KVPagePool(2 * n_pages, CLUSTER_PAGES['page_size'],
                          num_layers=model.config.num_layers,
                          num_heads=attn.local_heads,
                          head_dim=attn.head_dim, dtype=torch.bfloat16)
        pool.materialize('cuda')
        pools.append(pool)
    src = list(range(n_pages))
    dst = list(range(n_pages, 2 * n_pages))
    ms = loop_ms(torch, lambda: stream_kv_pages(pools[0].kv, pools[1].kv,
                                                src, dst), iters=20)
    moved = n_pages * CLUSTER_PAGES['page_size'] * pools[0].bytes_per_token()
    bound, _by = bound_ms(2 * moved, 0, 1.0)
    return dict(pages=n_pages, bytes_moved=moved, ms=ms,
                gb_per_s=moved / ms / 1e6, bound_ms=bound,
                share_of_bound=bound / ms)


def serve_disagg_phase(torch, card, served):
    """Prefill/decode disaggregation on the card over serve_cluster's
    stream at gpt_1p3b full width and depth, bf16 (disagg_passes): the
    unified engine, one DisaggregatedEngine (prefill_slots 2) and two
    disaggregated LocalReplicas behind ClusterRouter. Hard checks
    (check_disagg): every request returns its prompt and 48 tokens and
    every pool drains; 24 handoffs, and fewer pages streamed than the
    prompts' full pages (the decode side shares the system prompts); the
    cluster serves every request with affinity hits and no drain; each
    pass launches rows 1-3 exactly once a layer a forward of its engines
    (serve_launches) and nothing else; a CPU replay's tokens of the
    disaggregated engine and cluster equal its unified engine's, its
    forward_paged calls equal the engines' count, and its cluster makes
    the card's placements; the bf16 and int8 arms' decode-pool pages
    equal the unified engine's byte for byte (disagg_page_check).
    Recorded: wall tok/s, TTFT/TPOT/e2e p50/p99 against the unified
    engine, the tokens equal to its, the stream's GB/s against its bound.
    Returns the disaggregated pass's launches."""
    cfg, model = served['cfg'], served['model']
    prompts = cluster_stream(cfg.vocab_size)
    rec = disagg_passes(torch, model, 'cuda', prompts, torch.cuda.synchronize)
    check_disagg(rec, prompts, cfg.vocab_size, 'card')
    for what in DISAGG_PASSES:
        check_exact_launches(f'serve_disagg {what}', rec[what]['launches'],
                             serve_launches(cfg.num_layers,
                                            rec[what]['forwards'][0]))
    arms = [disagg_page_check(torch, model, prompts, kv, cfg.num_layers)
            for kv in (None, 'int8')]
    per_handoff = max(1, round(rec['disagg']['streamed_pages'] / CLUSTER_N))
    rates = [stream_rate(torch, model, n) for n in (per_handoff, 24)]
    free_cuda(torch)
    replay = disagg_replay(torch, cfg.vocab_size, prompts)
    check_disagg(replay, prompts, cfg.vocab_size, 'CPU replay')
    if replay['cluster']['decisions'] != rec['cluster']['decisions']:
        raise AssertionError(
            f"CPU replay disaggregated cluster placements "
            f"{replay['cluster']['decisions']} vs card "
            f"{rec['cluster']['decisions']}")
    single, dis, clu = rec['single'], rec['disagg'], rec['cluster']
    gen = CLUSTER_N * CLUSTER_NEW
    emit({'phase': 'serve_disagg', 'card': card,
          'nvidia_smi': nvidia_smi_line(), 'model': 'gpt_1p3b',
          'layers': cfg.num_layers, 'requests': CLUSTER_N,
          'max_new_tokens': CLUSTER_NEW, **DISAGG_PAGES,
          'single': dict(tokens_per_sec=gen / single['wall'],
                         **stream_line(single['stats'], single['wall']),
                         slo=single['slo'], launches=single['launches']),
          'disagg': dict(
              tokens_per_sec=gen / dis['wall'],
              tokens_per_sec_over_single=single['wall'] / dis['wall'],
              **stream_line(dis['stats'], dis['wall']),
              prefill_decode_steps=dis['prefill_stats'][
                  'decode_steps_total'],
              handoffs=dis['handoffs'], streamed_pages=dis['streamed_pages'],
              full_prompt_pages=dis['full_pages'],
              prefill_pool=dis['stats']['pd_prefill_pool'],
              slo=dis['slo'],
              token_share_vs_single=token_share(dis['outs'], single['outs'],
                                                prompts),
              launches=dis['launches'], forwards=dis['forwards'][0]),
          'cluster': dict(
              tokens_per_sec=gen / clu['wall'],
              tokens_per_sec_over_single=single['wall'] / clu['wall'],
              placements=clu['snapshot']['placements'],
              round_robin_hits=round_robin_hits(
                  prompts, 2, CLUSTER_PAGES['page_size']),
              goodput=clu['snapshot']['goodput'],
              token_share_vs_single=token_share(clu['outs'], single['outs'],
                                                prompts),
              launches=clu['launches'], forwards=clu['forwards'][0]),
          'page_checks': arms, 'stream': rates,
          'cpu_replay': dict(tokens_equal=True, placements_equal=True,
                             forwards={w: replay[w]['forwards'][0]
                                       for w in DISAGG_PASSES})})
    return dis['launches']


def trace_table(remote, path):
    """A worker's request table, read back from its journal exported over
    the channel (export_trace)."""
    from paddle_tpu_torch.serving import load_trace, reconstruct
    remote.export_trace(path)
    _header, events = load_trace(path)
    return reconstruct(events)


def spawn_workers(model_config, out_dir, errors):
    """Start both worker replicas at once (each builds gpt_1p3b from
    WORKER_SEED on the card and warms up before it reports ready);
    returns the threads and the {replica id: RemoteReplica} they fill."""
    from paddle_tpu_torch.serving.cluster import RemoteReplica

    reps = {}

    def spawn(rid):
        try:
            reps[rid] = RemoteReplica.spawn(
                rid, model_config, CLUSTER_PAGES, seed=WORKER_SEED,
                hang_timeout_s=WORKER_HANG_S, device='cuda',
                dtype='bfloat16', ready_timeout_s=WORKER_READY_S,
                env={'PTPU_SERVE_REPORT_DIR': out_dir})
        except Exception as e:          # re-raised by the caller
            errors.append(e)
    threads = [threading.Thread(target=spawn, args=(rid,))
               for rid in ('w0', 'w1')]
    for t in threads:
        t.start()
    return threads, reps


def worker_launch_checks(reps, layers):
    """Each worker exited with code 0 and reported its launches: rows 1-3
    exactly once a layer a forward of its engine since its warm-up, on
    the card, and nothing else."""
    out = {}
    for rid, r in sorted(reps.items()):
        rec = r.exit_record
        if r.returncode != 0 or rec is None:
            raise AssertionError(
                f'worker {rid} exited with {r.returncode}, record {rec}: '
                + '\n'.join(list(r.output)[-20:]))
        if not rec['device'].startswith('cuda'):
            raise AssertionError(f"worker {rid} served on {rec['device']}")
        fwd = sum(engine_forwards(e, e['fused_k']) for e in rec['engines'])
        want = check_exact_launches(f'worker {rid}', rec['launches'],
                                    serve_launches(layers, fwd))
        if not all(want.values()):
            raise AssertionError(f'worker {rid} launched no serving kernel')
        out[rid] = dict(forwards=fwd, launches=want,
                        engine=rec['engines'][0])
    return out


def serve_workers_phase(torch, card, cluster_line_rec):
    """Two worker replicas (`python -m
    paddle_tpu_torch.serving.cluster.replica`, each its own process and
    host thread) on the one card behind ClusterRouter, over serve_cluster's
    stream at gpt_1p3b full width and depth, bf16, without MPS. Their
    weights come from worker_model(WORKER_SEED) on the card, and the
    reference engine is built by that function from that seed on the
    card. A clean pass (the router refreshed once a pass): every request
    done, its tokens against the reference engine's (the share), affinity
    hits at or above round-robin's, no drain. A forced-hang pass
    (inject_hang on the worker holding the first request, the router at
    its 0.25 s refresh): the watchdog's report with `stacks` and
    `flight_recorder`, a drain, every request finished, the moved ones on
    the peer. Both workers exit with code 0 and report launches exact to
    their engines' forwards (worker_launch_checks). Recorded beside the
    in-process cluster of serve_cluster (one host thread pumping both
    replicas): wall tok/s, per-replica decode tok/s, TTFT/TPOT p50/p99.
    Returns the workers' summed launches."""
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.serving.cluster import ClusterRouter
    from paddle_tpu_torch.serving.cluster.replica import worker_model

    cfg = gpt_1p3b()
    model_config = dict(vars(cfg))
    prompts = cluster_stream(cfg.vocab_size)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'build', 'serve_workers')
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    errors = []
    t_spawn = time.perf_counter()
    threads, reps = spawn_workers(model_config, out_dir, errors)

    # the reference engine while the workers build theirs
    ref_model = worker_model(model_config, WORKER_SEED, device='cuda',
                             dtype='bfloat16')
    eng = ServingEngine(ref_model, ServingConfig(**CLUSTER_PAGES),
                        device='cuda')
    ref_outs, ref_wall, ref_launches, ref_st = timed_stream(
        torch, eng, prompts, CLUSTER_NEW, top_k=0)
    check_exact_launches('serve_workers reference', ref_launches,
                         serve_launches(cfg.num_layers, engine_forwards(
                             ref_st, eng.config.fused_k)))
    ref_slo = slo_of(eng.request_table())
    eng.shutdown()
    del eng, ref_model
    free_cuda(torch)
    for t in threads:
        t.join(timeout=WORKER_READY_S + 60)
    ready_s = time.perf_counter() - t_spawn
    try:
        if errors or len(reps) != 2:
            raise AssertionError(f'serve_workers: workers not ready: '
                                 f'{errors}')
        order = [reps['w0'], reps['w1']]
        router = ClusterRouter(order, max_queue=2 * CLUSTER_N,
                               **CLUSTER_ROUTER)
        t0 = time.perf_counter()
        outs = router.serve(prompts, max_new_tokens=CLUSTER_NEW, top_k=0,
                            timeout_s=600)
        wall = time.perf_counter() - t0
        snap = router.snapshot()
        router_e2e = router_e2e_ms(router)
        statuses = {r.replica_id: r.status() for r in order}
        tables = {r.replica_id: trace_table(r, os.path.join(
            out_dir, f'trace.{r.replica_id}.jsonl')) for r in order}
        rr = round_robin_hits(prompts, 2, CLUSTER_PAGES['page_size'])
        check_served_outs(prompts, outs, cfg.vocab_size, 'serve_workers')
        if snap['requests_done'] != CLUSTER_N \
                or snap['placements']['drain'] or snap['drain_events'] \
                or snap['rejects'] or snap['placements']['affinity'] < rr:
            raise AssertionError(f'serve_workers clean pass: {snap} '
                                 f'(round-robin hits {rr})')
        if any(s['hung'] for s in statuses.values()):
            raise AssertionError(f'serve_workers: a worker reports hung '
                                 f'after the clean pass: {statuses}')

        hang_router = ClusterRouter(order, page_size=16,
                                    max_queue=2 * CLUSTER_N)
        hprompts = prompts[:HANG_REQUESTS]
        t0 = time.perf_counter()
        reqs = [hang_router.submit(p, max_new_tokens=CLUSTER_NEW, top_k=0)
                for p in hprompts]
        hung = hang_router._replicas[reqs[0].replica_id]
        hung.inject_hang()
        hang_router.run(timeout_s=300)
        hang_wall = time.perf_counter() - t0
        hsnap = hang_router.snapshot()
        hang_outs = [r.output_ids() for r in reqs]
        check_served_outs(hprompts, hang_outs, cfg.vocab_size,
                          'serve_workers hang pass')
        moved = [r for r in reqs if r.resubmits]
        if hsnap['placements']['drain'] < 1 or not moved or any(
                str(r.replica_id) == hung.replica_id for r in moved):
            raise AssertionError(f'serve_workers hang pass: {hsnap}')
        report = os.path.join(out_dir, f'replica_hang.{hung.replica_id}.json')
        deadline = time.time() + 30
        while time.time() < deadline and not os.path.exists(report):
            time.sleep(0.2)
        with open(report) as f:
            doc = json.load(f)
        if doc.get('kind') != 'replica_hang_report' or not doc.get(
                'stacks') or doc.get('flight_recorder', {}).get(
                    'kind') != 'flight_recorder':
            raise AssertionError(f'serve_workers: hang report {sorted(doc)}')
        hang_router.shutdown()
    finally:
        for r in reps.values():
            r.shutdown(timeout=60)
    launches = worker_launch_checks(reps, cfg.num_layers)

    gen = CLUSTER_N * CLUSTER_NEW
    in_proc = cluster_line_rec['cluster']
    emit({'phase': 'serve_workers', 'card': card,
          'nvidia_smi': nvidia_smi_line(), 'model': 'gpt_1p3b',
          'layers': cfg.num_layers, 'replicas': 2, 'requests': CLUSTER_N,
          'max_new_tokens': CLUSTER_NEW, **CLUSTER_PAGES,
          'spawn_to_ready_s': ready_s,
          'reference': dict(tokens_per_sec=gen / ref_wall,
                            **stream_line(ref_st, ref_wall), slo=ref_slo),
          'workers': dict(
              wall_s=wall, tokens_per_sec=gen / wall,
              tokens_per_sec_over_reference=ref_wall / wall,
              placements=snap['placements'], round_robin_hits=rr,
              token_share_vs_reference=token_share(outs, ref_outs, prompts),
              # the journals' clocks start at the worker's submit op,
              # which waits for the worker's step to release its lock;
              # the router's e2e runs from the router's submit
              router_e2e_ms=router_e2e,
              slo=slo_of({f'{rid}:{k}': v for rid, t in tables.items()
                          for k, v in t.items()}),
              per_replica={rid: dict(
                  decode_tokens_per_sec=statuses[rid][
                      'decode_tokens_per_sec'],
                  requests=len(tables[rid]), slo=slo_of(tables[rid]))
                  for rid in tables}),
          'in_process_cluster': dict(
              tokens_per_sec=in_proc['tokens_per_sec'],
              slo=in_proc['slo'], router_e2e_ms=in_proc['router_e2e_ms'],
              per_replica={rid: dict(
                  decode_tokens_per_sec=v['decode_tokens_per_sec'],
                  slo=v['slo']) for rid, v in in_proc['per_replica'].items()}),
          'hang': dict(
              requests=HANG_REQUESTS, wall_s=hang_wall,
              hung=hung.replica_id, moved=len(moved),
              placements=hsnap['placements'],
              drain_events=[{k: v for k, v in e.items() if k != 't'}
                            for e in hsnap['drain_events']],
              report_keys=sorted(doc), report_reason=doc['reason'],
              token_share_vs_reference=token_share(
                  hang_outs, ref_outs[:HANG_REQUESTS], hprompts)),
          'worker_launches': launches})
    total = {}
    for rec in launches.values():
        for k, n in rec['launches'].items():
            total[k] = total.get(k, 0) + n
    return total


def router_e2e_ms(router):
    """p50/p90/p99 of the router's own submit-to-finish time."""
    from paddle_tpu_torch.serving.request_trace import percentile_of
    vals = [v['e2e_s'] for v in router.request_slo().values()]
    return {f'p{q}': (None if (p := percentile_of(vals, q)) is None
                      else 1e3 * p) for q in (50, 90, 99)}


def check_served_outs(prompts, outs, vocab, where):
    if len(outs) != len(prompts):
        raise AssertionError(f'{where}: {len(outs)} outputs')
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + CLUSTER_NEW or o[:len(p)] != p or not all(
                0 <= t < vocab for t in o[len(p):]):
            raise AssertionError(f'{where}: a request of {len(p)} tokens '
                                 f'returned {len(o)}')


TRAIN_KERNELS = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv', 'layer_norm',
                 'layer_norm_bwd', 'bias_gelu', 'bias_gelu_bwd')
PACKED_FLASH = TRAIN_KERNELS[:3]
BHLD_KERNELS = ('flash_bhld_fwd', 'flash_bhld_bwd_dq', 'flash_bhld_bwd_dkv')
PEAK_BF16_TFLOPS = 989.0
TIMED_STEPS = 5


def _train_loss(model, ids, labels):
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    return GPTPretrainingCriterion()(model(ids), labels)


def train_phase(torch, card):
    """gpt_1p3b through the port's TrainStep on the card: bench.py's
    bench_gpt_1p3b('adamw') configuration, one batch of 8 x 2048 tokens
    (the bench's 4 micro-batches of 2, folded into one: TrainStep does
    not accumulate)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_1p3b(hidden_dropout=0.0, attn_dropout=0.0,
                   use_flash_attention=True)
    B, L = 8, cfg.max_seq_len
    gen = torch.Generator(device='cuda').manual_seed(4321)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device='cuda', dtype=torch.bfloat16,
                           generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                multi_precision=False, moment_dtype='bfloat16')
    step = TrainStep(model, _train_loss, opt, use_buckets=False)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (B, L)).astype('int32')
    labels = np.roll(ids, -1, 1).astype('int32')
    ids_t = torch.from_numpy(ids).cuda()
    labels_t = torch.from_numpy(labels).cuda()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = float(step(ids_t, labels_t))                 # warm-up
    warm_s = time.perf_counter() - t0
    _build.reset_launches()
    losses, walls = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(ids_t, labels_t)))     # float() syncs
        walls.append(time.perf_counter() - t0)
    launches = _build.routes_snapshot()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f'non-finite training loss: {[warm] + losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'loss did not fall over the timed steps: '
                             f'{losses}')
    idle = [k for k in TRAIN_KERNELS if launches[k] <= 0]
    if idle:
        raise AssertionError(f'training kernels never launched: {idle}')
    if launches['paged_attention']:
        raise AssertionError('the paged kernel launched during training')
    # the per-parameter update: one fused update launch a step for all
    # the parameters (one dtype group: bf16 p, g and moments)
    n_tensors = len(list(model.parameters()))
    if launches['optimizer_step'] != TIMED_STEPS * UPDATE_GROUPS:
        raise AssertionError(f'{launches["optimizer_step"]} update launches '
                             f'in {TIMED_STEPS} steps of {n_tensors} '
                             f'parameters')
    tokens = B * L
    flops = 6 * n_params * tokens + \
        12 * cfg.num_layers * cfg.hidden_size * L * tokens   # bench.py:200
    step_s = float(np.mean(walls))
    prof = profile_train_step(torch, step, ids_t, labels_t)
    # the update: its kernel's device time in the profiled step against
    # its bytes bound (AdamW, bf16 p, g and moments, no master) and timed
    # on copies beside one torch._fused_adamw_ over the same tensors
    named = list(model.named_parameters())
    update = {'device_s': prof['device_s_by_port_kernel'].get(
                  'optimizer_step', 0.0),
              'bytes': n_params * UPDATE_BYTES,
              'bound_ms': 1e3 * n_params * UPDATE_BYTES / HBM_BYTES_PER_S,
              'bound_by': 'bytes', 'tensors': n_tensors,
              'launches_per_step': UPDATE_GROUPS,
              **update_timings(torch, opt, named,
                               [step._opt_states[n] for n, _ in named])}
    emit({'phase': 'train', 'card': card, 'model': 'gpt_1p3b',
          'layers': cfg.num_layers, 'hidden': cfg.hidden_size,
          'params': n_params, 'batch': B, 'seq_len': L,
          'optimizer': 'AdamW lr 1e-4 wd 0.01 bf16 moments, no master',
          'model_build_s': build_s, 'warmup_step_s': warm_s,
          'warmup_loss': warm, 'losses': losses, 'step_s': walls,
          'ms_per_step': 1e3 * step_s, 'tokens_per_sec': tokens / step_s,
          'model_flops_per_step': flops,
          'model_tflops': flops / step_s / 1e12,
          'mfu': flops / step_s / 1e12 / PEAK_BF16_TFLOPS,
          'peak_memory_bytes': peak,
          'launches': launches,
          'launches_per_step': {k: launches[k] / TIMED_STEPS
                                for k in TRAIN_KERNELS + ('optimizer_step',)},
          'update': update, **prof})
    return launches, peak


def pipeline_launches(A, layers, policy):
    """Each training kernel's launches in one SpmdPipelineEngine step at
    pp = 1 (GPT, dropout 0, the flash route, AdamW), as the wrappers
    count them; the update launches the fused update kernel once a step
    for all the parameters (one dtype group).
    A micro-batch's forward runs 2 LayerNorms, one flash forward and one
    bias+GELU a block and the head's final LayerNorm; under any remat
    policy the backward runs each block's kernels forward again (no
    policy keeps a kernel's output: the kernels are not dispatcher ops,
    and 'attn_mlp_boundaries' keeps the tagged tensors but re-runs the
    LayerNorms, the flash forward and the bias+GELU, whose saved outputs
    are not tagged); the embedding and the head are not checkpointed.
    The backward runs one dQ, one dK/dV and one bias+GELU backward a
    block and one LayerNorm backward a LayerNorm; the two row reductions
    count 2 launches a call (the kernel and its column sum)."""
    again = layers if policy != 'none' else 0
    ln_calls = 2 * layers + 1
    return {'layer_norm': A * (ln_calls + 2 * again),
            'bias_gelu': A * (layers + again),
            'flash_fwd': A * (layers + again),
            'flash_bwd_dq': A * layers, 'flash_bwd_dkv': A * layers,
            'layer_norm_bwd': 2 * A * ln_calls,
            'bias_gelu_bwd': 2 * A * layers,
            'optimizer_step': UPDATE_GROUPS}


# the update kernel's launches a step on every leg: one list of tensors of
# one dtype group (fewer than TABLE_CAP), one launch
UPDATE_GROUPS = 1


def pipeline_params(layers):
    """The pipeline triple's parameter tensors (each one entry of the
    step's update list, and one found-inf count when loss-scaled): the
    embedding's 2, a block's 12 (two LayerNorms, qkv, out,
    fc1 and fc2, each a weight and a bias) and the head's 3 (its
    LayerNorm and the untied weight)."""
    return 2 + 12 * layers + 3


def pipeline_tags(A, layers, policy):
    """Each remat boundary tag's calls in one SpmdPipelineEngine step at
    pp = 1: embed_out once a micro-batch, a block's five once in its
    forward. 'full' and 'dots' re-run the block in the backward and tag
    again up to fc2's product, the last op whose inputs the backward
    needs, where the checkpoint stops (its early stop), so mlp_out is
    not tagged again. 'attn_mlp_boundaries' re-runs each stretch between
    two tags alone, and each stretch stops before its tag (a product, or
    the flash Function, saves last), so no tag runs again."""
    again = layers if policy in ('full', 'dots') else 0
    return {name: A * (1 if name == 'embed_out' else
                       layers if name == 'mlp_out' else layers + again)
            for name in ('attn_qkv', 'attn_ctx', 'attn_out', 'mlp_fc1',
                         'mlp_out', 'embed_out')}


# gpt_1p3b's largest bucket: the word embedding, 50304 x 2048, larger than
# the 32 MiB cap and so a bucket of its own; and a ragged length, no
# multiple of the kernels' 2048-element block nor of their 8-element vector
BIG_BUCKET = 50304 * 2048
RAGGED_BUCKET = 16 * 2 ** 20 + 1005
DROPOUT_P = 0.1
# the path's AdamW update moves, per element: p and g read, the two bf16
# moments read and written, p written (the fp32 scalar block is ~nothing)
UPDATE_BYTES = 2 + 2 + 2 * 2 + 2 * 2 + 2


def check_update(torch, got, want):
    """The fused update's outputs ({name: tensor}) against the plain
    version's: fp32 within `update_fp32`; bf16 at least UPDATE_BF16_EQUAL
    bit-equal and every element within one bf16 ulp. Max |diff|."""
    errs = []
    for key, w in want.items():
        g = got[key]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f'update {key}: {g.dtype} {tuple(g.shape)} '
                                 f'!= {w.dtype} {tuple(w.shape)}')
        if g.dtype == torch.float32:
            errs.append(check_close('update_fp32', g, w))
            continue
        gf, wf = g.float(), w.float()
        if not bool(gf.isfinite().all()):
            raise AssertionError(f'update {key}: non-finite kernel output')
        equal = float((g == w).float().mean())
        ulp = torch.exp2(torch.floor(torch.log2(
            wf.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        diff = (gf - wf).abs()
        if equal < UPDATE_BF16_EQUAL or bool((diff > ulp).any()):
            raise AssertionError(
                f'update {key}: {equal:.6f} bit-equal (>= '
                f'{UPDATE_BF16_EQUAL}), {int((diff > ulp).sum())} elements '
                f'beyond one bf16 ulp')
        errs.append(float(diff.max()))
    return max(errs)


def update_inputs(torch, opt, n, dtype, master, seed, nan=False):
    """A bucket's params, gradients (in the bucket's dtype) and a state a
    few steps in, on the card."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    p = (0.02 * torch.randn(n, generator=gen, device='cuda')).to(dtype)
    g = (1e-3 * torch.randn(n, generator=gen, device='cuda')).to(dtype)
    if nan:
        g.fill_(float('nan'))
    st = opt.init_state(torch.empty(n, device='cuda'))
    st['moment1'].copy_(1e-4 * torch.randn(n, generator=gen, device='cuda'))
    st['moment2'].copy_(1e-8 * torch.rand(n, generator=gen, device='cuda'))
    st['beta1_pow'].fill_(0.9 ** 10)
    st['beta2_pow'].fill_(0.999 ** 10)
    if master:
        st['master'] = p.float() + 1e-5 * torch.randn(
            n, generator=gen, device='cuda')
    return p, g, st


def run_update(FO, opt, p, g, st, lr, pref, found_inf=None):
    """The kernel on copies of (p, state): {name: output}."""
    kp, ks = p.clone(), {k: v.clone() for k, v in st.items()}
    _p, ns = FO.fused_shard_update(opt, kp, g, ks, lr, prefactor=pref,
                                   found_inf=found_inf)
    return {'param': kp, **ns}


def optimizer_kernel_phase(torch):
    """The fused-optimizer kernels over gpt_1p3b's largest bucket and a
    ragged one, and the dropout+residual kernels at the train step's
    shape, each against its plain version, timed."""
    from paddle_tpu_torch.ops.kernels import fused_elementwise as fe
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO
    from paddle_tpu_torch.optimizer import AdamW

    rows_out, checks = {}, {}
    lr = torch.tensor(2e-4, device='cuda')
    pref = torch.tensor(0.37, device='cuda')      # a global-clip factor
    path_opt = AdamW(learning_rate=2e-4, weight_decay=0.01,
                     multi_precision=False, moment_dtype='bfloat16')
    master_opt = AdamW(learning_rate=2e-4, weight_decay=0.01,
                       multi_precision=True)

    # -- grad_stats --------------------------------------------------------
    fc1 = fc1_bucket_size(torch)
    for n in (BIG_BUCKET, RAGGED_BUCKET):
        gen = torch.Generator(device='cuda').manual_seed(n % 97)
        x = (1e-3 * torch.randn(n, generator=gen, device='cuda')).to(
            torch.bfloat16)
        s, c = FO.grad_stats(x)
        ps, pc = FO.grad_stats_plain(x)
        err = check_close('grad_stats', s, ps)
        if float(c) != float(pc) or float(c) != 0.0:
            raise AssertionError(f'grad_stats count {float(c)} != '
                                 f'{float(pc)}')
        x[n // 3] = float('nan')
        x[n - 1] = float('inf')
        s2, c2 = FO.grad_stats(x)
        if bool(torch.isfinite(s2)) or float(c2) != 2.0:
            raise AssertionError(f'grad_stats: NaN and inf gave sum '
                                 f'{float(s2)}, count {float(c2)}')
        checks[f'grad_stats n={n}'] = dict(sum_rel_err=abs(
            float(s) - float(ps)) / float(ps), nonfinite_poisons=True)
        if n == BIG_BUCKET:
            x[n // 3], x[n - 1] = 0.0, 0.0
            bms, by = bound_ms(2 * n + 8, 3 * n, FP32_FLOPS)
            rows_out['grad_stats'] = dict(
                shape=f'flat [{n}] bf16 (the word embedding bucket)',
                max_abs_err=err,
                ms=device_ms(torch, lambda: FO.grad_stats(x), iters=20),
                plain_ms=loop_ms(torch, lambda: FO.grad_stats_plain(x)),
                library_ms=device_ms(torch, lambda: torch.linalg.vector_norm(
                    x, dtype=torch.float32), iters=20),
                library='torch.linalg.vector_norm(dtype=float32), no count',
                bound_ms=bms, bound_by=by,
                typical_bucket=typical_stats_row(torch, FO, fc1))
        del x
        free_cuda(torch)

    # -- the update ----------------------------------------------------------
    for n in (BIG_BUCKET, RAGGED_BUCKET):
        for label, opt, dtype, master in (
                ('path: bf16 p and moments, no master', path_opt,
                 torch.bfloat16, False),
                ('fp32 moments and master', master_opt, torch.bfloat16,
                 True)):
            if master and n == BIG_BUCKET:
                continue
            p, g, st = update_inputs(torch, opt, n, dtype, master, seed=3)
            want_p, want_s = FO.fused_shard_update_plain(
                opt, p, g, st, lr, prefactor=pref)
            got = run_update(FO, opt, p, g, st, lr, pref)
            err = check_update(torch, got, {'param': want_p, **want_s})
            checks[f'update {label} n={n}'] = err
            del want_p, want_s, got
            if n == BIG_BUCKET:
                bms, by = bound_ms(n * UPDATE_BYTES + 5 * 4 + 2 * 4,
                                   20 * n, FP32_FLOPS)
                kp, ks = p.clone(), {k: v.clone() for k, v in st.items()}
                ms = device_ms(torch, lambda: FO.fused_shard_update(
                    opt, kp, g, ks, lr, prefactor=pref), iters=10)
                plain_ms = loop_ms(torch, lambda: FO.fused_shard_update_plain(
                    opt, p, g, st, lr, prefactor=pref), iters=3)
                m1, m2 = ks['moment1'], ks['moment2']
                steps = [torch.tensor(10.0, device='cuda')]
                library_ms = loop_ms(torch, lambda: torch._fused_adamw_(
                    [kp], [g], [m1], [m2], [], steps, amsgrad=False,
                    lr=2e-4, beta1=0.9, beta2=0.999, weight_decay=0.01,
                    eps=1e-8, maximize=False), iters=10)
                rows_out['optimizer_step'] = dict(
                    shape=f'AdamW, p, g, m1, m2 [{n}] bf16, no master '
                          f'(the word embedding bucket)',
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms,
                    library='torch._fused_adamw_ (eps after the bias '
                            'correction: a timing yardstick only)',
                    bytes_per_element=UPDATE_BYTES, bound_ms=bms,
                    bound_by=by)
                del kp, ks, m1, m2
            del p, g, st
            free_cuda(torch)
    # found_inf on NaN gradients: every output keeps its input's bits
    for label, opt, master in (('path', path_opt, False),
                               ('master', master_opt, True)):
        p, g, st = update_inputs(torch, opt, RAGGED_BUCKET, torch.bfloat16,
                                 master, seed=4, nan=True)
        got = run_update(FO, opt, p, g, st, lr, pref,
                         found_inf=torch.tensor(True, device='cuda'))
        for key, before in [('param', p)] + list(st.items()):
            after = got[key]
            same = torch.equal(after.view(torch.int16), before.view(
                torch.int16)) if after.dtype == torch.bfloat16 \
                else torch.equal(after.view(torch.int32),
                                 before.view(torch.int32))
            if not same:
                raise AssertionError(f'found_inf ({label}): {key} changed')
        checks[f'found_inf noop {label}'] = True
        del p, g, st, got
    free_cuda(torch)

    rows_out['optimizer_step']['rules'] = rule_kernel_checks(torch, FO, lr,
                                                             pref, checks)

    # -- dropout + residual, forward and backward ----------------------------
    rows, n = TRAIN_ROWS, 2048
    randn = make_randn(torch, 11)
    x, r, dy = randn(rows, n), randn(rows, n), randn(rows, n)
    gen = torch.Generator(device='cuda').manual_seed(12)
    keep = torch.rand(rows, n, generator=gen, device='cuda') < 1 - DROPOUT_P
    leaves = [t.detach().requires_grad_() for t in (x, r)]
    y = fe.dropout_add(*leaves, keep, DROPOUT_P)
    if y.grad_fn is None:
        raise AssertionError('dropout_add: no grad_fn')
    y.backward(dy)
    want_y = fe.dropout_add_plain(x, r, keep, DROPOUT_P)
    want_dx = fe.dropout_add_bwd_plain(keep, dy, DROPOUT_P)
    for name, got, want in (('dropout_add', y, want_y),
                            ('dropout_add_bwd', leaves[0].grad, want_dx),
                            ('residual grad', leaves[1].grad, dy)):
        if not torch.equal(got, want):
            raise AssertionError(
                f'{name}: not bit-equal to the plain version '
                f'(max |diff| {float((got.float() - want.float()).abs().max())})')
    del y, leaves, want_y, want_dx
    mask_b = keep.to(torch.bfloat16)
    scaled = mask_b / (1 - DROPOUT_P)
    N = rows * n
    bms, by = bound_ms(7 * N, 2 * N, FP32_FLOPS)
    rows_out['dropout_add'] = dict(
        shape=f'x, residual [{rows},{n}] bf16, bool mask, p={DROPOUT_P}',
        max_abs_err=0.0,
        ms=device_ms(torch, lambda: fe.dropout_add_fwd(x, r, keep,
                                                       DROPOUT_P), iters=20),
        plain_ms=loop_ms(torch, lambda: fe.dropout_add_plain(x, r, keep,
                                                             DROPOUT_P)),
        library_ms=device_ms(torch, lambda: torch.addcmul(
            r, x, mask_b, value=1 / (1 - DROPOUT_P)), iters=20),
        library='torch.addcmul(residual, x, bf16 mask, value=1/(1-p))',
        bound_ms=bms, bound_by=by)
    bms, by = bound_ms(5 * N, N, FP32_FLOPS)
    rows_out['dropout_add_bwd'] = dict(
        shape=f'dy [{rows},{n}] bf16, bool mask, p={DROPOUT_P}',
        max_abs_err=0.0,
        ms=device_ms(torch, lambda: fe.dropout_add_bwd(keep, dy, DROPOUT_P),
                     iters=20),
        plain_ms=loop_ms(torch, lambda: fe.dropout_add_bwd_plain(
            keep, dy, DROPOUT_P)),
        library_ms=device_ms(torch, lambda: torch.mul(dy, scaled), iters=20),
        library='torch.mul(dy, bf16 mask / (1-p))',
        bound_ms=bms, bound_by=by)
    del x, r, dy, keep, mask_b, scaled
    torch.cuda.synchronize()
    for name, row in rows_out.items():
        emit({'phase': 'kernel', 'name': name, 'path': 'train_bucketed',
              **row})
    emit({'phase': 'kernel', 'name': 'optimizer_kernel_checks',
          'tolerances': {'update_fp32': TOLERANCES['update_fp32'],
                         'update_bf16_bit_equal': UPDATE_BF16_EQUAL,
                         'grad_stats_rtol': TOLERANCES['grad_stats'][1],
                         'dropout_add': 'bit-equal'},
          'checks': checks})
    return rows_out


def rule_optimizers(**kw):
    """The update kernel's rules added with their optimizer classes
    (RMSProp twice: plain and centered, both with momentum), each at a
    learning rate whose first steps move an element by about 2e-4 to
    5e-4, as AdamW's 2e-4 does at gpt_1p3b's width (Adadelta at its
    customary 1.0)."""
    from paddle_tpu_torch import optimizer as O
    return {'adagrad': O.Adagrad(1e-2, initial_accumulator_value=0.1, **kw),
            'rmsprop': O.RMSProp(1e-4, momentum=0.9, **kw),
            'rmsprop_centered': O.RMSProp(1e-4, momentum=0.9, centered=True,
                                          **kw),
            'adamax': O.Adamax(2e-4, **kw),
            'adadelta': O.Adadelta(1.0, **kw),
            'decayed_adagrad': O.DecayedAdagrad(1e-4, **kw)}


def rule_inputs(torch, opt, n, dtype, master, seed):
    """A bucket's params, gradients and a state a few steps in, for any
    rule: vector states positive and small, |mean_grad| <= half the root
    of mean_square, beta powers ten steps in."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    p = (0.02 * torch.randn(n, generator=gen, device='cuda')).to(dtype)
    g = (1e-3 * torch.randn(n, generator=gen, device='cuda')).to(dtype)
    st = opt.init_state(torch.empty(n, device='cuda'))
    for k, v in st.items():
        if k == 'mean_grad':
            v.copy_((torch.rand(n, generator=gen, device='cuda') - 0.5)
                    * st['mean_square'].sqrt())
        elif v.dim():
            v.copy_(1e-6 * torch.rand(n, generator=gen, device='cuda'))
        else:
            v.fill_(0.9 ** 10)
    if master:
        st['master'] = p.float() + 1e-5 * torch.randn(
            n, generator=gen, device='cuda')
    return p, g, st


def rule_kernel_checks(torch, FO, lr, pref, checks):
    """The five rules added with their classes over gpt_1p3b's largest
    bucket (bf16 params and gradients with the fp32 master those classes
    always keep, as the reference's do; fp32 states) and a ragged fp32
    bucket with a master: every output bit-equal to the plain chain's;
    timed over the largest bucket. Returns {rule: timing row}."""
    out = {}
    for n, dtype in ((BIG_BUCKET, torch.bfloat16),
                     (RAGGED_BUCKET, torch.float32)):
        for name, opt in rule_optimizers().items():
            p, g, st = rule_inputs(torch, opt, n, dtype, True, seed=5)
            want_p, want_s = FO.fused_shard_update_plain(
                opt, p, g, st, lr, prefactor=pref)
            got = run_update(FO, opt, p, g, st, lr, pref)
            for key, w in {'param': want_p, **want_s}.items():
                if got[key].dtype != w.dtype or not torch.equal(got[key], w):
                    raise AssertionError(
                        f'update {name} {key} n={n}: '
                        f'{int((got[key] != w).sum())} elements differ from '
                        f'the plain chain')
            checks[f'update {name} {str(dtype)[6:]} n={n}'] = 'bit-equal'
            del want_p, want_s, got
            if n == BIG_BUCKET:
                vecs = sum(1 for k, v in st.items()
                           if v.dim() and k != 'master')
                # p written, g read, the master and the states read and
                # written
                per_elem = 2 + 2 + 2 * 4 + 2 * 4 * vecs
                bms, by = bound_ms(n * per_elem, 20 * n, FP32_FLOPS)
                kp, ks = p.clone(), {k: v.clone() for k, v in st.items()}
                out[name] = dict(
                    ms=device_ms(torch, lambda: FO.fused_shard_update(
                        opt, kp, g, ks, lr, prefactor=pref), iters=10),
                    plain_ms=loop_ms(torch, lambda: FO.fused_shard_update_plain(
                        opt, p, g, st, lr, prefactor=pref), iters=3),
                    library_ms=None, bytes_per_element=per_elem,
                    bound_ms=bms, bound_by=by)
                del kp, ks
            del p, g, st
            free_cuda(torch)
    for name, opt in rule_optimizers().items():
        checks[f'update {name} list'] = rule_list_check(torch, FO, opt, lr,
                                                        pref)
    return out


def rule_list_check(torch, FO, opt, lr, pref):
    """One rule's list form over three buckets in one call (the bucketed
    route's `fused_shard_updates`): a ragged fp32 bucket and a bf16
    bucket of 2^20 + 3 elements, both with the fp32 master, and a bf16
    view of 1001 elements at an offset of one element (off 16-byte
    alignment): two dtype groups, two launches, every output bit-equal
    to the plain chain's."""
    from paddle_tpu_torch.ops.kernels import _build

    ins = [rule_inputs(torch, opt, n, dtype, True, seed=6 + j)
           for j, (n, dtype) in enumerate((
               (RAGGED_BUCKET, torch.float32),
               (2 ** 20 + 3, torch.bfloat16), (1001, torch.bfloat16)))]
    p, g, st = ins[2]
    ins[2] = (clone_at_offset(torch, torch.cat([p[:1], p])[1:]), g, st)
    want = [FO.fused_shard_update_plain(opt, p, g, st, lr, prefactor=pref)
            for p, g, st in ins]
    kps = [clone_at_offset(torch, p) for p, _g, _st in ins]
    kss = [{k: v.clone() for k, v in st.items()} for _p, _g, st in ins]
    _build.reset_launches()
    got = FO.fused_shard_updates(opt, kps, [g for _p, g, _st in ins], kss,
                                 lr, prefactor=pref)
    launches = _build.routes_snapshot()[FO.STEP]
    for j, ((kp, ns), (want_p, want_s)) in enumerate(zip(got, want)):
        for key, w in {'param': want_p, **want_s}.items():
            v = kp if key == 'param' else ns[key]
            if v.dtype != w.dtype or not torch.equal(v, w):
                raise AssertionError(
                    f'update {type(opt).__name__} list entry {j} {key}: '
                    f'{int((v != w).sum())} elements differ from the '
                    f'plain chain')
    if launches != 2 or kps[2].data_ptr() % 16 == 0:
        raise AssertionError(f'update {type(opt).__name__} list: '
                             f'{launches} launches for 2 groups')
    del ins, want, kps, kss, got
    free_cuda(torch)
    return {'bit_equal': True, 'launches': launches}


RULE_STEPS = 3


def fc1_bucket_size(torch):
    """Elements of the first fc1 bucket of TrainStep's gpt_1p3b layout
    (the layout built from the parameters' shapes on the meta device)."""
    from paddle_tpu_torch.core import bucketing as B
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_1p3b

    model = GPTForCausalLM(gpt_1p3b(use_flash_attention=True),
                           device='meta', dtype=torch.bfloat16)
    layout = B.BucketLayout.build(
        {n: (p.shape, p.dtype) for n, p in model.named_parameters()},
        bucket_bytes=B.resolve_comm_config()[1], pad_to=8)
    return next(b.size for b in layout.buckets
                if any('mlp.fc1.weight' in sl.name for sl in b.slots))


def typical_stats_row(torch, FO, n):
    """grad_stats over a typical bucket (n bf16 elements), checked and
    timed cold: each call reads the next of COLD_COPIES copies (more than
    the 50 MB L2 holds), as a step finds most buckets."""
    gen = torch.Generator(device='cuda').manual_seed(5)
    xs = [(1e-3 * torch.randn(n, generator=gen, device='cuda')).to(
        torch.bfloat16) for _ in range(COLD_COPIES)]
    err = check_close('grad_stats', FO.grad_stats(xs[0])[0],
                      FO.grad_stats_plain(xs[0])[0])
    turn = [0]

    def cold(fn):
        def call():
            turn[0] += 1
            return fn(xs[turn[0] % COLD_COPIES])
        return call

    bms, by = bound_ms(2 * n + 8, 3 * n, FP32_FLOPS)
    return dict(
        shape=f'flat [{n}] bf16 (the first fc1 bucket), cold',
        max_abs_err=err, ms=device_ms(torch, cold(FO.grad_stats)),
        plain_ms=loop_ms(torch, cold(FO.grad_stats_plain)),
        library_ms=device_ms(torch, cold(lambda x: torch.linalg.vector_norm(
            x, dtype=torch.float32))),
        bound_ms=bms, bound_by=by)


def rules_phase(torch):
    """Three default-route TrainSteps per rule at gpt_1p3b's width with 2
    layers, each rule from the same seeded weights, in GPTConfig's default
    configuration (hidden and attention dropout 0.1; L = 512 takes the
    BHLD flash route), bf16 params with fp32 masters and states,
    ClipGradByGlobalNorm(1.0)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import _build

    cfg = gpt_1p3b(use_flash_attention=True)
    cfg.num_layers = 2
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 512))).cuda()
    labels = torch.roll(ids, -1, 1)
    results = {}
    for name, opt in rule_optimizers(
            grad_clip=ClipGradByGlobalNorm(1.0)).items():
        gen = torch.Generator(device='cuda').manual_seed(31)
        model = GPTForCausalLM(cfg, device='cuda', dtype=torch.bfloat16,
                               generator=gen)
        step = TrainStep(model, _train_loss, opt, seed=7)
        if not step.use_buckets:
            raise AssertionError(f'{name}: TrainStep did not bucket')
        nb = len(step.layout.buckets)
        _build.reset_launches()
        losses = [float(step(ids, labels)) for _ in range(RULE_STEPS)]
        launches = _build.routes_snapshot()
        want = {'optimizer_step': UPDATE_GROUPS * RULE_STEPS,
                'grad_stats': nb * RULE_STEPS,
                **{k: cfg.num_layers * RULE_STEPS for k in BHLD_KERNELS}}
        wrong = {k: (launches[k], v) for k, v in want.items()
                 if launches[k] != v}
        if wrong or not all(np.isfinite(losses)):
            raise AssertionError(f'{name}: launches (got, want) {wrong}, '
                                 f'losses {losses}')
        results[name] = dict(losses=losses, falls=losses[-1] < losses[0],
                             buckets=nb,
                             optimizer_step=launches['optimizer_step'])
        del step, model
        free_cuda(torch)
    emit({'phase': 'rules', 'model': 'gpt_1p3b width, 2 layers',
          'batch': 2, 'seq_len': 512, 'steps': RULE_STEPS,
          'states': 'fp32, bf16 params with fp32 masters',
          'results': results})
    return results


BUCKETED_KERNELS = ('grad_stats', 'optimizer_step', 'dropout_add',
                    'dropout_add_bwd')
# the kernels train_bucketed's path launches: GPTConfig's default dropouts
# take the BHLD flash route
BUCKETED_PATH = TRAIN_KERNELS[3:] + BHLD_KERNELS + BUCKETED_KERNELS
LR_PEAK = 2e-4                 # GPT-3 1.3B (GPT-3 paper, Table 2.1)
WARMUP_STEPS, T_MAX = 2, 100


def pretrain_optimizer(sched_mod, AdamW, clip, **kw):
    """The pretraining recipe: AdamW, global-norm clip 1.0, linear
    warm-up into cosine decay (GPT-3 paper §2.3, App. B)."""
    sched = sched_mod.LinearWarmup(
        sched_mod.CosineAnnealingDecay(LR_PEAK, T_max=T_MAX),
        warmup_steps=WARMUP_STEPS, start_lr=0.0, end_lr=LR_PEAK)
    return AdamW(learning_rate=sched, weight_decay=0.01, grad_clip=clip(1.0),
                 **kw), sched


def train_bucketed_phase(torch, card):
    """gpt_1p3b pretraining through TrainStep's default (bucketed) route
    in GPTConfig's default configuration (hidden and attention dropout
    0.1), on the card."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as sched_mod

    cfg = gpt_1p3b(use_flash_attention=True)     # dropouts: the defaults
    if (cfg.hidden_dropout, cfg.attn_dropout) != (DROPOUT_P, DROPOUT_P):
        raise AssertionError('GPTConfig\'s default dropouts changed')
    B, L = 8, cfg.max_seq_len
    gen = torch.Generator(device='cuda').manual_seed(4321)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device='cuda', dtype=torch.bfloat16,
                           generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    opt, sched = pretrain_optimizer(sched_mod, AdamW, ClipGradByGlobalNorm,
                                    multi_precision=False,
                                    moment_dtype='bfloat16')
    step = TrainStep(model, _train_loss, opt, seed=2024)   # the default route
    if not step.use_buckets:
        raise AssertionError('TrainStep did not take the bucketed route')
    n_buckets = len(step.layout.buckets)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (B, L)).astype('int32')
    labels = np.roll(ids, -1, 1).astype('int32')
    ids_t = torch.from_numpy(ids).cuda()
    labels_t = torch.from_numpy(labels).cuda()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fed = []

    def one_step():
        want = float(np.float32(opt.get_lr()))
        loss = float(step(ids_t, labels_t))              # float() syncs
        fed.append((float(step._lr), want))
        sched.step()
        return loss

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = one_step()
    warm_s = time.perf_counter() - t0
    _build.reset_launches()
    losses, walls = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(one_step())
        walls.append(time.perf_counter() - t0)
    launches = _build.routes_snapshot()
    peak = torch.cuda.max_memory_allocated()
    clip_factor = float(step.last_clip_factor)
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f'non-finite training loss: {[warm] + losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'loss did not fall over the timed steps: '
                             f'{losses}')
    idle = [k for k in BUCKETED_PATH if launches[k] <= 0]
    if idle:
        raise AssertionError(f'training kernels never launched: {idle}')
    want = {'grad_stats': n_buckets * TIMED_STEPS,
            'optimizer_step': UPDATE_GROUPS * TIMED_STEPS,
            'dropout_add': 2 * cfg.num_layers * TIMED_STEPS,
            'dropout_add_bwd': 2 * cfg.num_layers * TIMED_STEPS,
            **{k: cfg.num_layers * TIMED_STEPS for k in BHLD_KERNELS},
            **dict.fromkeys(PACKED_FLASH + ('paged_attention',), 0)}
    wrong = {k: (launches[k], v) for k, v in want.items()
             if launches[k] != v}
    if wrong:
        raise AssertionError(f'launches (got, want): {wrong}')
    if any(got != w for got, w in fed):
        raise AssertionError(f'fed lr != the schedule: {fed}')
    tokens = B * L
    flops = 6 * n_params * tokens + \
        12 * cfg.num_layers * cfg.hidden_size * L * tokens   # bench.py:200
    step_s = float(np.mean(walls))
    prof = profile_train_step(torch, step, ids_t, labels_t)
    emit({'phase': 'train_bucketed', 'card': card, 'model': 'gpt_1p3b',
          'layers': cfg.num_layers, 'hidden': cfg.hidden_size,
          'params': n_params, 'batch': B, 'seq_len': L,
          'hidden_dropout': cfg.hidden_dropout,
          'attn_dropout': cfg.attn_dropout,
          'attention_mask_bytes_per_layer': B * cfg.num_heads * L * L,
          'attention_mask_bytes_saved': B * cfg.num_heads * L * L
          * cfg.num_layers,
          'optimizer': f'AdamW wd 0.01 bf16 moments, no master, '
                       f'ClipGradByGlobalNorm(1.0), LinearWarmup('
                       f'{WARMUP_STEPS} steps, 0 -> {LR_PEAK}) into '
                       f'CosineAnnealingDecay(T_max={T_MAX})',
          'buckets': n_buckets,
          'bucket_sizes': sorted({b.size for b in step.layout.buckets}),
          # every gradient bucket read once over 3.35 TB/s: the least
          # device time of a step's grad_stats launches
          'stats_bound_ms_per_step': 1e3 * step.layout.nbytes()
                                     / HBM_BYTES_PER_S,
          'model_build_s': build_s, 'warmup_step_s': warm_s,
          'warmup_loss': warm, 'losses': losses, 'step_s': walls,
          'lr_fed': [f for f, _w in fed],
          'last_clip_factor': clip_factor,
          'ms_per_step': 1e3 * step_s, 'tokens_per_sec': tokens / step_s,
          'model_flops_per_step': flops,
          'model_tflops': flops / step_s / 1e12,
          'mfu': flops / step_s / 1e12 / PEAK_BF16_TFLOPS,
          'peak_memory_bytes': peak,
          'launches': launches,
          'launches_per_step': {k: launches[k] / TIMED_STEPS
                                for k in BUCKETED_PATH},
          **prof})
    return launches, peak


def profile_train_step(torch, step, ids, labels, ranges=()):
    """One train step under torch.profiler: device busy time (the CUDA
    kernels' self time) against the step's wall, and that time by
    group and by port kernel. `ranges` = (update range, head range), the
    record_function ranges of SpmdPipelineEngine: the trace shows each
    as a device-side annotation spanning its kernels, which is left out
    of the kernels, and the "other" group is split by them
    (`device_s_other_split`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(ids, labels))
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    groups, port = _group_device_time(kernels)
    flash = {k: t for k, t in port.items() if k.startswith('flash')}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = {'profiled_step_wall_s': wall,
            'device_busy_s': busy if kernels else None,
            'busy_share_of_profiled_wall': busy / wall if kernels else None,
            'device_s_by_group': groups, 'device_s_by_port_kernel': port,
            'flash_share_of_busy': sum(flash.values()) / busy
                                   if kernels else None,
            'flash_bwd_share_of_busy': sum(
                t for k, t in flash.items() if '_bwd_' in k) / busy
                                       if kernels else None,
            'top_kernels': [dict(name=e.key[:90],
                                 device_ms=e.self_device_time_total / 1e3,
                                 calls=e.count) for e in top]}
    if ranges:
        out['device_s_other_split'] = _split_other(prof.events(), *ranges)
        # the ranges' device-side annotations: each one's span on the card,
        # from its first kernel's start to its last one's end
        out['device_span_s_of_range'] = {
            e.key: e.device_time_total / 1e6 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key in ranges}
    return out


def _card_and_cpu_models(torch, cfg, seed):
    """A model at `cfg` in fp32 on the card and its copy on the CPU."""
    from paddle_tpu_torch.models import GPTForCausalLM

    gen = torch.Generator(device='cuda').manual_seed(seed)
    card_model = GPTForCausalLM(cfg, device='cuda', dtype=torch.float32,
                                generator=gen)
    with torch.device('meta'):
        cpu_model = GPTForCausalLM(cfg)
    cpu_model = cpu_model.to_empty(device='cpu')
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in card_model.state_dict().items()})
    return card_model, cpu_model


def _rel(a, b, where=None):
    """Relative L2 error of a (card) against b (CPU), over `where`."""
    a, b = a.detach().double().cpu(), b.detach().double()
    if where is not None:
        a, b = a[where], b[where]
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float(a.norm())


def _compare(card_model, cpu_model, card_losses, cpu_losses, adam=False,
             zero_grad=()):
    """Per-tensor relative L2 errors of the gradients and the updated
    parameters, card vs CPU. Under Adam every element steps by about lr
    whatever its gradient's size, so an element whose gradient is below
    the gradient check's own bar (WHOLE_PATH_RTOL of its tensor's RMS:
    rounding noise, e.g. the key part of the qkv bias, whose exact
    gradient is 0) may step either way; those elements are left out of
    the parameter comparison and counted. A tensor named in `zero_grad`
    has an exact gradient of 0 (nn.MultiHeadAttention's key bias shifts
    every score of a query alike, which the softmax cancels), so both
    sides hold rounding noise: its gradient must stay under
    WHOLE_PATH_RTOL of the largest gradient norm on each side, and it is
    left out of the relative comparisons."""
    cpu_params = dict(cpu_model.named_parameters())
    scale = max(float(p.grad.double().norm())
                for p in cpu_params.values())
    noise = {}
    for n, p in card_model.named_parameters():
        if n in zero_grad:
            noise[n] = max(float(p.grad.double().norm()),
                           float(cpu_params[n].grad.double().norm()))
            if noise[n] > WHOLE_PATH_RTOL * scale:
                raise AssertionError(f'{n}: gradient {noise[n]:.3g} is no '
                                     f'rounding noise (scale {scale:.3g})')
    grad_err, param_err, skipped, total = {}, {}, 0, 0
    for n, p in card_model.named_parameters():
        if n in zero_grad:
            continue
        g_cpu = cpu_params[n].grad
        grad_err[n] = _rel(p.grad, g_cpu)
        where = None
        if adam:
            rms = float(g_cpu.double().square().mean().sqrt())
            where = g_cpu.abs() > WHOLE_PATH_RTOL * rms
            skipped += int((~where).sum())
        total += p.numel()
        param_err[n] = _rel(p, cpu_params[n], where)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                        cpu_losses))
    worst_g = max(grad_err, key=grad_err.get)
    worst_p = max(param_err, key=param_err.get)
    out = {'card_losses': card_losses, 'cpu_losses': cpu_losses,
           'loss_rel_err': loss_err,
           'max_grad_rel_l2': grad_err[worst_g], 'worst_grad': worst_g,
           'max_param_rel_l2': param_err[worst_p], 'worst_param': worst_p,
           'rtol': WHOLE_PATH_RTOL}
    if adam:
        out['param_elements_left_out'] = skipped
        out['param_elements'] = total
    if zero_grad:
        out['zero_grad_tensors_max_norm'] = max(noise.values())
        out['largest_grad_norm'] = scale
    if not all(np.isfinite(card_losses)) or loss_err > WHOLE_PATH_RTOL \
            or grad_err[worst_g] > WHOLE_PATH_RTOL \
            or param_err[worst_p] > WHOLE_PATH_RTOL:
        raise AssertionError(
            f'card step differs from the CPU step: losses {card_losses} vs '
            f'{cpu_losses}; grad {worst_g} {grad_err[worst_g]:.3g}; param '
            f'{worst_p} {param_err[worst_p]:.3g} (rtol {WHOLE_PATH_RTOL})')
    return out


def whole_path_check(torch):
    """One per-parameter TrainStep (SGD) of a 2-layer fp32 model at
    gpt_1p3b's width on the card and on the CPU from the same weights
    (L=512: the flash route); then two default (bucketed) TrainSteps of
    the pretraining recipe with hidden and attention dropout (the BHLD
    flash route), the card's masks replayed on the CPU."""
    from paddle_tpu_torch.core import rng as port_rng
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import SGD, AdamW
    from paddle_tpu_torch.optimizer import lr as sched_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt_1p3b(hidden_dropout=0.0, attn_dropout=0.0,
                   use_flash_attention=True)
    cfg.num_layers = 2
    card_model, cpu_model = _card_and_cpu_models(torch, cfg, 99)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, cfg.vocab_size, (1, 512)).astype('int32')
    labels = np.roll(ids, -1, 1).astype('int32')
    _build.reset_launches()
    card_step = TrainStep(card_model, _train_loss, SGD(learning_rate=1e-3),
                          use_buckets=False)
    card_loss = float(card_step(ids, labels))
    launches = _build.routes_snapshot()
    cpu_step = TrainStep(cpu_model, _train_loss, SGD(learning_rate=1e-3),
                         use_buckets=False, device='cpu')
    cpu_loss = float(cpu_step(ids, labels))
    idle = [k for k in TRAIN_KERNELS if launches[k] <= 0]
    if idle:
        raise AssertionError(f'whole-path check: kernels not launched: '
                             f'{idle}')
    emit({'phase': 'check', 'what': 'one fp32 TrainStep (SGD lr 1e-3, '
          'per-parameter route), 2 layers at gpt_1p3b width, B=1 L=512, '
          'card vs CPU', 'launches': launches,
          **_compare(card_model, cpu_model, [card_loss], [cpu_loss])})
    del card_model, cpu_model, card_step, cpu_step
    free_cuda(torch)

    # the default (bucketed) route, GPTConfig's default dropouts (hidden
    # and attention) on the card's masks
    cfg = gpt_1p3b(use_flash_attention=True)
    cfg.num_layers = 2
    card_model, cpu_model = _card_and_cpu_models(torch, cfg, 98)
    draw = port_rng.keep_mask
    recorded, replayed = [], []

    def record(shape, keep_prob, device):
        m = draw(shape, keep_prob, device)
        recorded.append(m.cpu())
        return m

    def replay(shape, keep_prob, device):
        m = recorded[len(replayed)]
        replayed.append(m)
        if tuple(m.shape) != tuple(shape):
            raise AssertionError(f'mask replay: {tuple(m.shape)} != {shape}')
        return m.to(device)

    losses = {}
    try:
        for where, draw_fn in (('card', record), ('cpu', replay)):
            port_rng.keep_mask = draw_fn
            opt, sched = pretrain_optimizer(sched_mod, AdamW,
                                            ClipGradByGlobalNorm)
            model = card_model if where == 'card' else cpu_model
            _build.reset_launches()
            step = TrainStep(model, _train_loss, opt,
                             device=None if where == 'card' else 'cpu')
            if not step.use_buckets:
                raise AssertionError('whole-path check: not bucketed')
            losses[where] = []
            for _ in range(2):
                losses[where].append(float(step(ids, labels)))
                sched.step()
            if where == 'card':
                launches = _build.routes_snapshot()
                n_buckets = len(step.layout.buckets)
    finally:
        port_rng.keep_mask = draw
    idle = [k for k in BUCKETED_PATH if launches[k] <= 0]
    if idle:
        raise AssertionError(f'whole-path check (bucketed): kernels not '
                             f'launched: {idle}')
    if len(replayed) != len(recorded) or not recorded:
        raise AssertionError(f'masks: {len(recorded)} drawn on the card, '
                             f'{len(replayed)} replayed on the CPU')
    emit({'phase': 'check', 'what': 'two fp32 TrainSteps on the default '
          '(bucketed) route: AdamW, ClipGradByGlobalNorm(1.0), warm-up '
          f'into cosine, hidden and attention dropout {DROPOUT_P} (the '
          'card\'s masks replayed on the CPU), 2 layers at gpt_1p3b width, '
          'B=1 L=512, card vs CPU', 'buckets': n_buckets,
          'masks': len(recorded),
          'launches': launches,
          **_compare(card_model, cpu_model, losses['card'], losses['cpu'],
                     adam=True)})


PIPE_POLICY_STEPS = 3
def check_exact_launches(what, launches, want):
    """Raises unless each kernel of `want` launched exactly that often
    and every other kernel never; returns `want`."""
    wrong = {k: (launches[k], n) for k, n in want.items()
             if launches[k] != n}
    stray = {k: n for k, n in launches.items() if k not in want and n}
    if wrong or stray:
        raise AssertionError(f'{what} launches (got, want) {wrong}; '
                             f'kernels off the path launched {stray}')
    return want


def check_pipeline_launches(launches, steps, A, layers, policy):
    """Raises unless every training kernel launched exactly
    `pipeline_launches` a step and every other kernel never (dropout 0:
    the packed flash route and no dropout+residual; no loss scale: no
    found-inf count)."""
    return check_exact_launches('pipeline', launches, {
        k: steps * n
        for k, n in pipeline_launches(A, layers, policy).items()})


def check_pipeline_tags(tags, steps, layers, policy):
    """Raises unless the boundary tags counted over `steps` steps are
    `pipeline_tags`'s."""
    want = {n: steps * c
            for n, c in pipeline_tags(PIPE_A, layers, policy).items()}
    if tags != want:
        raise AssertionError(f'{policy}: boundary tags {tags} != {want}')


def windowed_steps(torch, eng, host_batch):
    """The bench's timed loop (bench.py:185-191): TIMED_STEPS train_step
    calls on a host (numpy) batch through the engine's dispatch window,
    then flush. Each call's host time is kept: a call that returns before
    the card has run its step shows that the batch copy did not block."""
    eng.flush()
    torch.cuda.synchronize()
    calls, results = [], []
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        t1 = time.perf_counter()
        results.append(eng.train_step(host_batch))
        calls.append(time.perf_counter() - t1)
    eng.flush()
    wall = time.perf_counter() - t0
    losses = [float(r) for r in results]
    if not all(np.isfinite(losses)):
        raise AssertionError(f'train_step: non-finite loss {losses}')
    return {'ms_per_step': 1e3 * wall / TIMED_STEPS, 'call_s': calls,
            'losses': losses, 'dispatch_window': eng._inflight.size}


class SyncCounter:
    """Counts the calling thread's host syncs while entered: waits on a
    CUDA event, a stream or the device, and reads of a card tensor's
    value to the host. `count[0]` is the tally."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        torch = self.torch
        me = threading.get_ident()
        count = self.count = [0]
        self.saved = []

        def wrap(owner, name, on_cuda_only=False):
            real = getattr(owner, name)
            self.saved.append((owner, name, real))

            def counted(*a, **kw):
                if threading.get_ident() == me and (
                        not on_cuda_only or a[0].is_cuda):
                    count[0] += 1
                return real(*a, **kw)
            setattr(owner, name, counted)
        wrap(torch.cuda.Event, 'synchronize')
        wrap(torch.cuda.Stream, 'synchronize')
        wrap(torch.cuda, 'synchronize')
        for name in ('item', '__float__', 'cpu', 'tolist'):
            wrap(torch.Tensor, name, on_cuda_only=True)
        return count

    def __exit__(self, *exc):
        for owner, name, real in reversed(self.saved):
            setattr(owner, name, real)
        return False


def host_gap_record(torch, eng, ids, labels, n_sync=3, sync_trials=2, n=5,
                    trials=3):
    """bench.py's `_host_gap_record` (:53-103) on the port: the
    synchronous discipline (a train_batch and its loss read, n_sync steps,
    best of sync_trials) and then the windowed one (n steps through a
    DeviceLoader into train_step, one fetch at the trial's end, best of
    trials) on the same engine. Returns (the `host` record, the windowed
    seconds a step)."""
    from paddle_tpu_torch.io import DeviceLoader
    eng.flush()
    torch.cuda.synchronize()
    eng._gap.reset()
    sync_dt = float('inf')
    for _ in range(sync_trials):
        t0 = time.perf_counter()
        for _ in range(n_sync):
            float(eng.train_batch((ids, labels)))
        sync_dt = min(sync_dt, (time.perf_counter() - t0) / n_sync)
    sync_gap = eng.host_gap_snapshot()
    eng._gap.reset()
    dt, loader_stats = float('inf'), None
    for _ in range(trials):
        loader = DeviceLoader([(ids, labels)] * n, engine=eng)
        t0 = time.perf_counter()
        last = None
        for b in loader:
            last = eng.train_step(b)
        eng.flush()
        last.result()                          # ONE fetch, at trial end
        dt = min(dt, (time.perf_counter() - t0) / n)
        loader_stats = loader.stats()
    win_gap = eng.host_gap_snapshot()
    host = {
        'dispatch_window': eng._inflight.size,
        'prefetch': loader_stats,
        'device_lr': eng._lr_feed.fn is not None,
        'windowed': {k: win_gap.get(k) for k in
                     ('steps', 'host_gap_seconds', 'host_residue_seconds',
                      'host_bound_fraction', 'dispatch_depth_mean',
                      'dispatch_depth_max')},
        'sync_loop': dict(
            {k: sync_gap.get(k) for k in
             ('steps', 'host_gap_seconds', 'host_residue_seconds',
              'host_bound_fraction')},
            ms_per_step=sync_dt * 1000),
        'host_gap_reduced':
            win_gap['host_gap_seconds'] < sync_gap['host_gap_seconds'],
    }
    return host, dt


def telemetry_record(torch, eng, ids, labels, census):
    """The bench's telemetry loop around the windowed step on `eng`
    (bench.py:177-197, :1434-1497): the metric history and the default
    alert pack on, the host-gap record, the history tick and export, the
    alerts' summary, the ledger's account; StepTelemetry's snapshot and
    the memory accountant's sample and phases. Holds the record to the
    bench's contract."""
    from paddle_tpu_torch import profiler as prof_mod
    from paddle_tpu_torch.core import alerts as alerts_mod
    from paddle_tpu_torch.core import memory as mem
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.distributed.fleet.utils import recompute as remat

    reg = monitor.metrics()
    hist = reg.enable_history(capacity=240)
    alerts = alerts_mod.AlertManager(hist, rules=alerts_mod.default_rules(),
                                     source='chip_smoke')
    try:
        host, dt = host_gap_record(torch, eng, ids, labels)
        ledger = eng._ledger.account()
        reg.history_tick()
        series = hist.export(max_points=24)
        alerts_rec = alerts.summary()
    finally:
        alerts.detach()
        reg.history = None
    snap = prof_mod.StepTelemetry(publish=False).snapshot()
    acct = mem.accountant()
    record = {
        'windowed_ms_per_step': 1e3 * dt, 'host': host, 'ledger': ledger,
        'series': series, 'alerts': alerts_rec,
        'remat': {'policy': 'full', 'boundaries': remat.boundary_counts(),
                  'census_before': {k: census[0].get(k) for k in (
                      'bytes_in_use', 'live_bytes', 'live_buffers')},
                  'census_after': {k: census[1].get(k) for k in (
                      'bytes_in_use', 'live_bytes', 'live_buffers')},
                  'activation_bytes': census[1].get('activation_bytes')},
        'telemetry': {
            'compile_seconds_total': snap['compile_seconds_total'],
            'compiles_total': int(snap['compiles_total']),
            'device_memory': snap['device_memory'],
            'numerics': snap['numerics'], 'comm': snap['comm'],
            'comm_overlap': (snap['comm'] or {}).get('comm_overlap'),
            'pallas': snap['pallas'], 'remat': snap['remat'],
            'host': snap['host'], 'pipeline': snap['pipeline'],
            'ledger': snap['ledger']},
        'memory': {'sample': acct.sample(count_buffers=True),
                   'phases': {k: {f: v.get(f) for f in
                                  ('high_water', 'max_delta', 'calls')}
                              for k, v in acct.phases().items()}},
    }
    if not host['host_gap_reduced']:
        raise AssertionError(f'windowed host gap not below the '
                             f'synchronous one: {host}')
    if ledger is None or not 0.95 <= ledger['reconciled_fraction'] <= 1.05:
        raise AssertionError(f'ledger does not reconcile: {ledger}')
    if ledger['peak_tflops'] != PEAK_BF16_TFLOPS or ledger['mfu'] is None:
        raise AssertionError(f'ledger MFU not against the H100 peak: '
                             f'{ledger}')
    if alerts_rec['fired_critical']:
        raise AssertionError(f'critical alert fired: {alerts_rec}')
    if not record['telemetry']['comm_overlap'] or \
            not record['telemetry']['remat']:
        raise AssertionError('telemetry lacks comm_overlap or remat')
    if 'pipeline.step' not in record['memory']['phases']:
        raise AssertionError('memory phases lack the step')
    return record


def telemetry_ab(torch, eng, ids, labels, n=5):
    """The telemetry's cost on the windowed loop, in turns: 'off' is n
    train_step calls on the host batch, a flush and one fetch; 'on' the
    same through a DeviceLoader with the metric history and the default
    alert pack on, and a history tick, export and ledger account after
    the trial. Order off, on, on, off, twice, each trial after a full
    garbage collection; each trial's ms a step and the loop thread's host
    syncs a step."""
    from paddle_tpu_torch.core import alerts as alerts_mod
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.io import DeviceLoader

    reg = monitor.metrics()
    trials = {'off': [], 'on': []}
    syncs = {'off': [], 'on': []}
    for mode in ('off', 'on', 'on', 'off') * 2:
        eng.flush()
        torch.cuda.synchronize()
        # each trial starts from a full collection: Python's gen-2
        # collections (0.2-0.3 s on this heap) otherwise fall about every
        # 4th trial, always on the same arm of this order
        gc.collect()
        hist = alerts = None
        if mode == 'on':
            hist = reg.enable_history(capacity=240)
            alerts = alerts_mod.AlertManager(
                hist, rules=alerts_mod.default_rules(), source='ab')
        try:
            with SyncCounter(torch) as count:
                t0 = time.perf_counter()
                last = None
                feed = DeviceLoader([(ids, labels)] * n, engine=eng) \
                    if mode == 'on' else [(ids, labels)] * n
                for b in feed:
                    last = eng.train_step(b)
                eng.flush()
                last.result()
                if mode == 'on':
                    reg.history_tick()
                    hist.export(max_points=24)
                    eng._ledger.account()
                wall = time.perf_counter() - t0
        finally:
            if alerts is not None:
                alerts.detach()
            reg.history = None
        trials[mode].append(1e3 * wall / n)
        syncs[mode].append(count[0] / n)
    out = {mode: {'ms_per_step': v, 'median_ms':
                  float(np.median(v)), 'syncs_per_step': syncs[mode]}
           for mode, v in trials.items()}
    out['order'] = "off, on, on, off, twice"
    out['median_on_minus_off_ms'] = out['on']['median_ms'] - \
        out['off']['median_ms']
    if syncs['on'] != syncs['off']:
        raise AssertionError(f'telemetry changed the host syncs: {syncs}')
    return out


def pipeline_phase(torch, card, train_peaks):
    """gpt_1p3b through SpmdPipelineEngine on the card in the bench's
    headline configuration (bench.py:120-149): bf16 parameters, untied
    head, dropouts 0, flash on; AdamW lr 1e-4, decay 0.01, bf16 moments,
    no master; A = 4 x mb = 2 x L = 2048, use_remat=True ('full' per
    block at pp = 1), '1F1B', grad_accum_dtype='param'. A warm-up step,
    5 timed steps with exact launch counts, a profiled step; then 3
    timed steps each under remat_policy 'none' and
    'attn_mlp_boundaries'. `train_peaks`: this run's peak bytes of the
    train and train_bucketed phases, printed beside the leg's."""
    from paddle_tpu_torch.core import ledger as ledger_mod
    from paddle_tpu_torch.core import memory as mem
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline as sp)
    from paddle_tpu_torch.distributed.fleet.utils import recompute as remat
    from paddle_tpu_torch.models import build_gpt_pipeline, gpt_1p3b
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_1p3b(hidden_dropout=0.0, attn_dropout=0.0,
                   use_flash_attention=True)
    L, layers = cfg.max_seq_len, cfg.num_layers
    gen = torch.Generator(device='cuda').manual_seed(4321)
    t0 = time.perf_counter()
    triple = build_gpt_pipeline(cfg, device='cuda', dtype=torch.bfloat16,
                                generator=gen)
    modules = [triple[0], triple[2]] + triple[1]
    n_params = sum(p.numel() for m in modules for p in m.parameters())

    def engine(**kw):
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    multi_precision=False, moment_dtype='bfloat16')
        return sp.SpmdPipelineEngine(*triple, opt, accumulate_steps=PIPE_A,
                                     use_remat=True, schedule='1F1B',
                                     grad_accum_dtype='param', **kw)

    eng = engine()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (PIPE_A * PIPE_MB, L)).astype(
        'int32')
    labels = np.roll(ids, -1, 1).astype('int32')
    data = (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the ledger's arch hints (bench.py:183-189) and the memory census
    # around the warm-up (:168-171)
    ledger_mod.configure('pipeline', layers=layers, hidden=cfg.hidden_size,
                         seq_len=L, n_params=n_params, arch='gpt')
    census_before = mem.sample(count_buffers=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = float(eng.train_batch(data))
    warm_s = time.perf_counter() - t0
    census_after = mem.sample(count_buffers=True)
    tags_before = remat.boundary_counts()
    _build.reset_launches()
    losses, walls = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(data)))     # float() syncs
        walls.append(time.perf_counter() - t0)
    launches = _build.routes_snapshot()
    peak = torch.cuda.max_memory_allocated()
    tags = {k: v - tags_before.get(k, 0)
            for k, v in remat.boundary_counts().items()}
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f'non-finite pipeline loss: {[warm] + losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'pipeline loss did not fall: {losses}')
    want = check_pipeline_launches(launches, TIMED_STEPS, PIPE_A, layers,
                                   'full')
    check_pipeline_tags(tags, TIMED_STEPS, layers, 'full')
    tokens = PIPE_A * PIPE_MB * L
    flops = 6 * n_params * tokens + \
        12 * layers * cfg.hidden_size * L * tokens     # bench.py:200-202
    step_s = float(np.mean(walls))
    window = windowed_steps(torch, eng, (ids, labels))
    prof = profile_train_step(
        torch, lambda i, lab: eng.train_batch((i, lab)), *data,
        ranges=(sp.UPDATE_RANGE, sp.HEAD_RANGE))
    # the per-parameter update: its device time (the update kernel's, which
    # only the update launches, and any other kernel under its range)
    # against the bytes it must move (AdamW, bf16 p, g and moments, no
    # master: UPDATE_BYTES an element)
    update_bytes = n_params * UPDATE_BYTES
    update = {'device_s': update_device_s(prof),
              'device_span_s': prof['device_span_s_of_range'].get(
                  sp.UPDATE_RANGE),
              'bytes': update_bytes,
              'bound_ms': 1e3 * update_bytes / HBM_BYTES_PER_S,
              'bound_by': 'bytes',
              'tensors': pipeline_params(layers),
              'launches_per_step': UPDATE_GROUPS,
              **update_timings(torch, eng.optimizer, eng._named,
                               [eng._states[n] for n, _ in eng._named])}
    t0 = time.perf_counter()
    tele = telemetry_record(torch, eng, ids, labels,
                            (census_before, census_after))
    tele['telemetry_ab'] = telemetry_ab(torch, eng, ids, labels)
    tele['seconds'] = time.perf_counter() - t0
    eng.shutdown()
    del eng
    free_cuda(torch)

    policies = {}
    for policy in ('none', 'dots', 'attn_mlp_boundaries'):
        eng = engine(remat_policy=policy)
        torch.cuda.reset_peak_memory_stats()
        p_losses = [float(eng.train_batch(data))]            # warm-up
        _build.reset_launches()
        tags_before = remat.boundary_counts()
        p_walls = []
        for _ in range(PIPE_POLICY_STEPS):
            t0 = time.perf_counter()
            p_losses.append(float(eng.train_batch(data)))
            p_walls.append(time.perf_counter() - t0)
        p_launches = _build.routes_snapshot()
        if not all(np.isfinite(p_losses)):
            raise AssertionError(f'{policy}: non-finite loss {p_losses}')
        check_pipeline_launches(p_launches, PIPE_POLICY_STEPS, PIPE_A,
                                layers, policy)
        check_pipeline_tags(
            {k: v - tags_before.get(k, 0)
             for k, v in remat.boundary_counts().items()},
            PIPE_POLICY_STEPS, layers, policy)
        peak_p = torch.cuda.max_memory_allocated()
        # the card's busy time a step apart from the host's: a policy's
        # recompute costs device time, its checkpoints host time
        busy = profile_train_step(
            torch, lambda i, lab: eng.train_batch((i, lab)), *data,
            ranges=(sp.UPDATE_RANGE, sp.HEAD_RANGE))
        policies[policy] = {
            'ms_per_step': 1e3 * float(np.mean(p_walls)), 'step_s': p_walls,
            'losses': p_losses, 'peak_memory_bytes': peak_p,
            'device_busy_s': busy['device_busy_s'],
            'profiled_step_wall_s': busy['profiled_step_wall_s'],
            'flash_launches_per_step': {
                k: p_launches[k] / PIPE_POLICY_STEPS for k in PACKED_FLASH}}
        eng.shutdown()
        del eng
        free_cuda(torch)
    emit({'phase': 'pipeline', 'card': card, 'model': 'gpt_1p3b',
          'layers': layers, 'hidden': cfg.hidden_size, 'params': n_params,
          'head': 'untied', 'accumulate_steps': PIPE_A,
          'micro_batch': PIPE_MB, 'seq_len': L,
          'engine': "SpmdPipelineEngine pp=1 '1F1B' use_remat=True "
                    "grad_accum_dtype='param'",
          'optimizer': 'AdamW lr 1e-4 wd 0.01 bf16 moments, no master',
          'model_build_s': build_s, 'warmup_step_s': warm_s,
          'warmup_loss': warm, 'losses': losses, 'step_s': walls,
          'ms_per_step': 1e3 * step_s, 'tokens_per_sec': tokens / step_s,
          'model_flops_per_step': flops,
          'model_tflops': flops / step_s / 1e12,
          'mfu': flops / step_s / 1e12 / PEAK_BF16_TFLOPS,
          'peak_memory_bytes': peak,
          'train_peak_memory_bytes': train_peaks,
          'remat': dict(tele.pop('remat'), boundary_counts=tags,
                        snapshot=remat.snapshot()),
          'launches': launches,
          'launches_per_step': {k: n / TIMED_STEPS for k, n in want.items()},
          'train_step_window': window, 'update': update,
          'policies': policies, **tele, **prof})
    return launches


def _pipeline_copies(torch, cfg, seed):
    """The pipeline triple at `cfg` in fp32 on the card and its copy on
    the CPU."""
    from paddle_tpu_torch.models import build_gpt_pipeline

    gen = torch.Generator(device='cuda').manual_seed(seed)
    card = build_gpt_pipeline(cfg, device='cuda', dtype=torch.float32,
                              generator=gen)
    with torch.device('meta'):
        cpu = build_gpt_pipeline(cfg)
    card_list = torch.nn.ModuleList([card[0], *card[1], card[2]])
    cpu_list = torch.nn.ModuleList([cpu[0], *cpu[1], cpu[2]]).to_empty(
        device='cpu')
    cpu_list.load_state_dict({k: v.cpu()
                              for k, v in card_list.state_dict().items()})
    n = len(card[1])
    return ((card_list[0], list(card_list[1:1 + n]), card_list[-1]),
            (cpu_list[0], list(cpu_list[1:1 + n]), cpu_list[-1]),
            card_list, cpu_list)


PIPE_CHECK_A, PIPE_CHECK_L = 2, 512


def pipeline_check(torch):
    """SpmdPipelineEngine on the card against the CPU at gpt_1p3b's width
    with 2 layers in fp32 (TF32 off): A = 2 micro-batches of 1 x 512
    (the flash route), remat 'full', SGD and AdamW, 2 train_batch calls
    each from the same weights; losses, gradients and updated parameters
    within WHOLE_PATH_RTOL. Then train_step + flush on the card against
    train_batch from the same weights: bit-equal; and the four remat
    policies against each other (`policy_check`)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.spmd_pipeline \
        import SpmdPipelineEngine
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import SGD, AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt_1p3b(hidden_dropout=0.0, attn_dropout=0.0,
                   use_flash_attention=True)
    cfg.num_layers = 2
    rng = np.random.RandomState(2)
    ids = rng.randint(0, cfg.vocab_size, (PIPE_CHECK_A, PIPE_CHECK_L)
                      ).astype('int32')
    labels = np.roll(ids, -1, 1).astype('int32')
    optimizers = {'sgd': lambda: SGD(learning_rate=1e-3),
                  'adamw': lambda: AdamW(learning_rate=1e-4,
                                         weight_decay=0.01)}

    def engine(triple, opt, device=None):
        return SpmdPipelineEngine(*triple, opt, accumulate_steps=PIPE_CHECK_A,
                                  use_remat=True, remat_policy='full',
                                  grad_accum_dtype='param', device=device)

    for seed, (kind, make_opt) in enumerate(optimizers.items(), 95):
        card, cpu, card_list, cpu_list = _pipeline_copies(torch, cfg, seed)
        _build.reset_launches()
        eng = engine(card, make_opt())
        card_losses = [float(eng.train_batch((ids, labels)))
                       for _ in range(2)]
        launches = _build.routes_snapshot()
        check_pipeline_launches(launches, 2, PIPE_CHECK_A, cfg.num_layers,
                                'full')
        eng_cpu = engine(cpu, make_opt(), device='cpu')
        cpu_losses = [float(eng_cpu.train_batch((ids, labels)))
                      for _ in range(2)]
        emit({'phase': 'pipeline_check', 'what': f'two fp32 train_batch '
              f'calls ({kind}), SpmdPipelineEngine A={PIPE_CHECK_A} mb=1 '
              f'L={PIPE_CHECK_L}, remat full, 2 layers at gpt_1p3b width, '
              'card vs CPU', 'launches': launches,
              **_compare(card_list, cpu_list, card_losses, cpu_losses,
                         adam=kind == 'adamw')})
        del eng, eng_cpu, card, cpu, card_list, cpu_list
        free_cuda(torch)

    runs = {}
    for how in ('train_batch', 'train_step'):
        card, _, card_list, _ = _pipeline_copies(torch, cfg, 94)
        eng = engine(card, optimizers['adamw']())
        if how == 'train_batch':
            losses = [eng.train_batch((ids, labels)) for _ in range(2)]
        else:
            results = [eng.train_step((ids, labels)) for _ in range(2)]
            eng.flush()
            losses = [r.loss for r in results]
        runs[how] = ([float(x) for x in losses],
                     [p.detach().clone() for p in card_list.parameters()])
        del eng, card, card_list
    (want_l, want_p), (got_l, got_p) = runs['train_batch'], \
        runs['train_step']
    equal = got_l == want_l and all(torch.equal(a, b)
                                    for a, b in zip(got_p, want_p))
    if not equal:
        raise AssertionError(f'train_step + flush differs from train_batch: '
                             f'losses {got_l} vs {want_l}')
    emit({'phase': 'pipeline_check', 'what': 'train_step x2 + flush vs '
          'train_batch x2 on the card, AdamW, from the same weights',
          'losses': want_l, 'bit_equal': equal})
    del runs, got_p, want_p
    free_cuda(torch)
    policy_check(torch, cfg, ids, labels)


def update_timings(torch, opt, named, states):
    """A step's whole update (`named` [(name, param)] with their `.grad`
    and `states` in that order, `opt` the optimizer) timed on copies of
    the parameters and states, with the last step's gradients, by CUDA
    events around
    repeated calls: `route_ms` the list form (`ParamUpdates.apply`: one
    update kernel launch for every parameter, host included),
    `per_param_ms` one call a parameter (a one-entry launch each, no
    cached table: the host path of a per-parameter loop),
    `plain_ms` the plain chain over the same parameters, and `library_ms`
    one `torch._fused_adamw_` call over all of them (a yardstick only: it
    adds eps after the bias correction). `host_us`: the list form's host
    microseconds a call (its Python, the table checks and the launch),
    and `launches` its launches a call."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO

    lr = torch.tensor(1e-4, device='cuda')
    ps = [p.detach().clone() for _, p in named]
    gs = [p.grad for _, p in named]
    sts = [{k: v.clone() for k, v in st.items()} for st in states]
    # the library call updates the fp32 masters where the states keep
    # them (with fp32 copies of the gradients), else the parameters
    lib_ps = [st.get('master', p) for p, st in zip(ps, sts)]
    lib_gs = [g.to(p.dtype) for p, g in zip(lib_ps, gs)]

    def route():
        out = FO.ParamUpdates(opt, lr).apply(list(zip(ps, gs, sts)))
        sts[:] = [st for _p, st in out]

    def per_param():
        upd = FO.ParamUpdates(opt, lr)
        for j, (p, g, st) in enumerate(zip(ps, gs, sts)):
            _p, sts[j] = upd(p, g, st)

    def plain():
        for p, g, st in zip(ps, gs, sts):
            FO.fused_shard_update_plain(opt, p, g, st, lr)

    m1 = [st['moment1'] for st in sts]
    m2 = [st['moment2'] for st in sts]
    steps = [torch.full((), 10.0, device='cuda') for _ in ps]

    def library():
        torch._fused_adamw_(lib_ps, lib_gs, m1, m2, [], steps, lr=1e-4,
                            beta1=0.9, beta2=0.999, weight_decay=0.01,
                            eps=1e-8, amsgrad=False, maximize=False)

    route()
    _build.reset_launches()
    route()
    launches = _build.routes_snapshot()[FO.STEP]
    out = {'route_ms': loop_ms(torch, route),
           'per_param_ms': loop_ms(torch, per_param),
           'plain_ms': loop_ms(torch, plain, iters=2),
           'library_ms': loop_ms(torch, library),
           'host_us': host_call_us(torch, route),
           'launches': launches}
    del ps, sts, m1, m2, lib_ps, lib_gs
    return out


def update_device_s(prof):
    """The pipeline update's device seconds in a profiled step: the update
    kernel's time (the ctypes launches carry no CPU op of their own to
    attribute them to a range by) and the other kernels launched under
    UPDATE_RANGE."""
    return prof['device_s_by_port_kernel'].get('optimizer_step', 0.0) + \
        prof['device_s_other_split']['optimizer']


def clone_at_offset(torch, t):
    """A copy of a 1-D or contiguous tensor at its storage offset, so a
    view off 16-byte alignment stays off it."""
    off = t.storage_offset()
    base = torch.empty(off + t.numel(), dtype=t.dtype, device=t.device)
    view = base[off:].view(t.shape)
    view.copy_(t)
    return view


def param_route_check(torch):
    """The per-parameter update route (`ParamUpdates.apply`: one launch of
    the fused update kernel for the list, one a dtype group) against its
    plain chain (`fused_shard_update_plain`, the engine's `_update_one`
    op for op) on the card, on the same inputs: the pipeline leg's 29
    parameter tensors at 2 layers of gpt_1p3b (the embedding and the
    untied head's [2048, 50304] among them) and a view of 1001 elements
    at an offset of one element (off 16-byte alignment: the scalar
    path). Every parameter and state must be bit-equal: AdamW with bf16
    parameters, gradients and moments and no master (the leg's); the
    same under a loss scale of 2^10 (gradients scaled, unscaled in the
    kernel and rounded back to bf16) and with found_inf set (every
    output bit-equal to its input); Adam with an fp32 master, fp32
    moments and decay into the gradient, with an fp32 tensor of 4099
    elements besides (a second dtype group: two launches); SGD in
    fp32."""
    from paddle_tpu_torch.models import build_gpt_pipeline, gpt_1p3b
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO
    from paddle_tpu_torch.optimizer import SGD, Adam, AdamW

    cfg = gpt_1p3b(hidden_dropout=0.0, attn_dropout=0.0)
    cfg.num_layers = 2
    gen = torch.Generator(device='cuda').manual_seed(77)
    triple = build_gpt_pipeline(cfg, device='cuda', dtype=torch.bfloat16,
                                generator=gen)
    params = [p.detach() for m in [triple[0], *triple[1], triple[2]]
              for p in m.parameters()]
    odd = torch.randn(1002, generator=gen, device='cuda')
    lr = torch.tensor(1e-4, device='cuda')
    cases = {
        'adamw_bf16': (lambda: AdamW(1e-4, weight_decay=0.01,
                                     multi_precision=False,
                                     moment_dtype='bfloat16'),
                       torch.bfloat16, None, False, 1),
        'adamw_bf16_scaled': (lambda: AdamW(1e-4, weight_decay=0.01,
                                            multi_precision=False,
                                            moment_dtype='bfloat16'),
                              torch.bfloat16, 2.0 ** 10, False, 1),
        'adamw_bf16_found_inf': (lambda: AdamW(1e-4, weight_decay=0.01,
                                               multi_precision=False,
                                               moment_dtype='bfloat16'),
                                 torch.bfloat16, 2.0 ** 10, True, 1),
        'adam_master': (lambda: Adam(1e-4, weight_decay=0.01),
                        torch.bfloat16, None, False, 2),
        'sgd_fp32': (lambda: SGD(1e-3, weight_decay=1e-4), torch.float32,
                     None, False, 1)}
    out = {}
    for case, (make, dtype, scale, inf, groups) in cases.items():
        opt = make()
        ps = [p.to(dtype) for p in params] + [odd.to(dtype)[1:]]
        if groups == 2:
            ps.append(torch.randn(4099, generator=gen, device='cuda'))
        states, grads = [], []
        for p in ps:
            st = opt.init_state(p)
            for k, v in st.items():
                if v.dim():
                    v.copy_(1e-4 * torch.randn(v.shape, generator=gen,
                                               device='cuda').abs())
            if p.dtype != torch.float32 and opt._multi_precision:
                st['master'] = p.float()
            states.append(st)
            g = 1e-3 * torch.randn(p.shape, generator=gen, device='cuda')
            grads.append((g * (scale or 1.0)).to(p.dtype))
        if inf:
            grads[3].view(-1)[7] = float('nan')
        pref = None if scale is None else 1.0 / torch.tensor(
            scale, device='cuda')
        found = None
        if scale is not None:
            found = torch.stack([FO.grad_stats(g)[1]
                                 for g in grads]).sum() > 0
        kps = [clone_at_offset(torch, p) for p in ps]
        kss = [{k: v.clone() for k, v in st.items()} for st in states]
        _build.reset_launches()
        got = FO.ParamUpdates(opt, lr, prefactor=pref, found_inf=found
                              ).apply(list(zip(kps, grads, kss)))
        launches = _build.routes_snapshot()['optimizer_step']
        if launches != groups:
            raise AssertionError(f'{case}: {launches} update launches for '
                                 f'{len(ps)} tensors in {groups} groups')
        equal = True
        for p, g, st, (kp, ns) in zip(ps, grads, states, got):
            want_p, want_s = FO.fused_shard_update_plain(
                opt, p, g, st, lr, prefactor=pref, found_inf=found,
                round_prefactor=True)
            equal &= torch.equal(kp, want_p) and set(ns) == set(want_s) \
                and all(torch.equal(ns[k], want_s[k]) for k in want_s)
            if inf:
                equal &= torch.equal(kp, p) and all(
                    torch.equal(ns[k], st[k]) for k in st)
        if not equal:
            raise AssertionError(f'{case}: the list form differs from its '
                                 f'plain chain on the card')
        out[case] = {'bit_equal': equal, 'launches': launches,
                     'tensors': len(ps),
                     'found_inf': None if found is None else bool(found)}
    emit({'phase': 'update_route', 'what': 'ParamUpdates.apply (one update '
          'kernel launch a dtype group) vs the plain chain on the card, the '
          'pipeline leg\'s 29 parameter tensors at 2 layers of gpt_1p3b, a '
          'misaligned 1001-element view and (adam_master) an fp32 tensor',
          'cases': out})


PIPE_AMP_LAYERS = 4
PIPE_AMP_STEPS = 3


def pipeline_amp_phase(torch, card):
    """The headline leg's loss-scaling path (bench.py:120-149 at 4 of its
    24 layers, full width): SpmdPipelineEngine.train_step(scaler=
    GradScaler(init_loss_scaling=2^15)) for 3 steps through the dispatch
    window, against the per-step path (train_batch(scale=the scaler's
    scale), found_inf read and the scaler updated after each step) from
    the same weights: the scalers' states equal and the parameters
    bit-equal. Every step launches the statistics kernel and the update
    kernel once a parameter. A profiled scaled step (the found-inf
    count's and the update's device time). Then a step at scale=inf:
    last_found_inf is set and every parameter and state is bit-equal to
    before it."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline as sp)
    from paddle_tpu_torch.models import build_gpt_pipeline, gpt_1p3b
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_1p3b(hidden_dropout=0.0, attn_dropout=0.0,
                   use_flash_attention=True)
    cfg.num_layers = PIPE_AMP_LAYERS
    L = cfg.max_seq_len
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (PIPE_A * PIPE_MB, L)).astype(
        'int32')
    labels = np.roll(ids, -1, 1).astype('int32')

    def engine(**kw):
        gen = torch.Generator(device='cuda').manual_seed(4321)
        triple = build_gpt_pipeline(cfg, device='cuda', dtype=torch.bfloat16,
                                    generator=gen)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    multi_precision=False, moment_dtype='bfloat16')
        return sp.SpmdPipelineEngine(*triple, opt, accumulate_steps=PIPE_A,
                                     use_remat=True, schedule='1F1B',
                                     grad_accum_dtype='param', **kw)

    def params_of(eng):
        return [p.detach().clone() for _, p in eng._named]

    def scaler_state(scaler):
        return (scaler._scale, scaler._good_steps, scaler._bad_steps)

    eng_s = engine()
    scaler_s = GradScaler(init_loss_scaling=2.0 ** 15)
    found_s = []
    for _ in range(PIPE_AMP_STEPS):
        eng_s.train_batch((ids, labels), scale=scaler_s._scale)
        found_s.append(bool(eng_s.last_found_inf))
        scaler_s._found_inf = found_s[-1]
        scaler_s._update()
    want = params_of(eng_s)
    eng_s.shutdown()
    del eng_s
    free_cuda(torch)

    eng = engine(dispatch_window=2)
    scaler = GradScaler(init_loss_scaling=2.0 ** 15)
    data = (ids, labels)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    results = [eng.train_step(data, scaler=scaler)
               for _ in range(PIPE_AMP_STEPS)]
    eng.flush()
    wall = time.perf_counter() - t0
    launches = _build.routes_snapshot()
    n = pipeline_params(PIPE_AMP_LAYERS)
    want_launches = {'grad_stats': PIPE_AMP_STEPS * n,
                     'optimizer_step': PIPE_AMP_STEPS * UPDATE_GROUPS}
    wrong = {k: (launches[k], v) for k, v in want_launches.items()
             if launches[k] != v}
    if wrong:
        raise AssertionError(f'pipeline_amp launches (got, want): {wrong}')
    found = [bool(r.found_inf) for r in results]
    losses = [float(r) for r in results]
    got = params_of(eng)
    same_params = all(torch.equal(a, b) for a, b in zip(got, want))
    if found != found_s or scaler_state(scaler) != scaler_state(scaler_s) \
            or not same_params:
        raise AssertionError(
            f'the windowed scaler path differs from the per-step path: '
            f'found {found} vs {found_s}, scaler {scaler_state(scaler)} vs '
            f'{scaler_state(scaler_s)}, parameters equal {same_params}')
    if not all(np.isfinite(losses)) or any(found):
        raise AssertionError(f'scaled steps: losses {losses}, found_inf '
                             f'{found}')
    del want, got
    # one profiled scaled step: the found-inf count's and the update's
    # device time
    ids_t, labels_t = (torch.from_numpy(ids).cuda(),
                       torch.from_numpy(labels).cuda())
    prof = profile_train_step(
        torch, lambda i, lab: eng.train_batch((i, lab), scale=2.0 ** 15),
        ids_t, labels_t, ranges=(sp.UPDATE_RANGE, sp.HEAD_RANGE))
    before_p = params_of(eng)
    before_s = {n_: {k: v.clone() for k, v in st.items()}
                for n_, st in eng._states.items()}
    inf_loss = float(eng.train_batch(data, scale=float('inf')))
    skipped = bool(eng.last_found_inf)
    kept = all(torch.equal(a, b) for a, b in zip(params_of(eng), before_p))
    kept_states = all(torch.equal(eng._states[n_][k], v)
                      for n_, st in before_s.items() for k, v in st.items())
    if not (skipped and kept and kept_states):
        raise AssertionError(f'the inf step: found_inf {skipped}, '
                             f'parameters kept {kept}, states kept '
                             f'{kept_states}')
    eng.shutdown()
    del eng, before_p, before_s
    free_cuda(torch)
    emit({'phase': 'pipeline_amp', 'card': card, 'model': 'gpt_1p3b',
          'layers': PIPE_AMP_LAYERS, 'hidden': cfg.hidden_size,
          'accumulate_steps': PIPE_A, 'micro_batch': PIPE_MB, 'seq_len': L,
          'scaler': 'GradScaler(init_loss_scaling=2^15)',
          'steps': PIPE_AMP_STEPS, 'losses': losses, 'found_inf': found,
          'ms_per_step': 1e3 * wall / PIPE_AMP_STEPS,
          'scaler_state': scaler_state(scaler),
          'per_step_path_scaler_state': scaler_state(scaler_s),
          'params_bit_equal_to_per_step_path': same_params,
          'launches': launches, 'launches_want': want_launches,
          'inf_step': {'loss': inf_loss, 'found_inf': skipped,
                       'params_bit_equal': kept,
                       'states_bit_equal': kept_states},
          'profiled_scaled_step': {
              'wall_s': prof['profiled_step_wall_s'],
              'device_busy_s': prof['device_busy_s'],
              'found_inf_count_device_s': prof['device_s_by_group'][
                  'grad_stats'],
              'update_device_s': update_device_s(prof),
              'update_device_span_s': prof['device_span_s_of_range'].get(
                  sp.UPDATE_RANGE)}})
    return launches


def telemetry_phase(torch, card):
    """The numerics, memory and hang diagnostics on the leg at
    PIPE_AMP_LAYERS layers (pipeline_amp's engine), each in a few steps:
    (1) FLAGS_tensor_stats: a step's taps in one host fetch, the
    ptpu_num_* gauges, its global norm against ClipGradByGlobalNorm's over
    the step's gradients; (2) FLAGS_check_nan_inf: a gradient made
    non-finite on purpose raises NumericsError naming its parameter; (3)
    a loss-scaled step whose gradient overflowed is skipped and the next
    clean step does not raise, on the engine and through the eager guard
    with a GradScaler (the reference's test_amp_skip_step_resets_guard
    on the card); (4) an allocation of twice the card's memory inside
    oom_guard raises DeviceOOMError with its report; (5) a HangWatchdog
    with a short timeout over a stalled heartbeat writes its local
    dump."""
    import shutil
    import tempfile
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.core import memory as mem
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.core import numerics as num
    from paddle_tpu_torch.distributed import flight_recorder as fr
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline as sp)
    from paddle_tpu_torch.models import build_gpt_pipeline, gpt_1p3b
    from paddle_tpu_torch.optimizer import SGD, AdamW

    cfg = gpt_1p3b(hidden_dropout=0.0, attn_dropout=0.0,
                   use_flash_attention=True)
    cfg.num_layers = PIPE_AMP_LAYERS
    L = cfg.max_seq_len
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (PIPE_A * PIPE_MB, L)).astype(
        'int32')
    data = (ids, np.roll(ids, -1, 1).astype('int32'))
    report_dir = tempfile.mkdtemp(prefix='chip_smoke_reports_')
    saved_dir = os.environ.get('FLEET_LOG_DIR')
    os.environ['FLEET_LOG_DIR'] = report_dir

    def engine():
        gen = torch.Generator(device='cuda').manual_seed(4321)
        triple = build_gpt_pipeline(cfg, device='cuda', dtype=torch.bfloat16,
                                    generator=gen)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    multi_precision=False, moment_dtype='bfloat16')
        return sp.SpmdPipelineEngine(*triple, opt, accumulate_steps=PIPE_A,
                                     use_remat=True, schedule='1F1B',
                                     grad_accum_dtype='param')

    def poison(eng, value):
        """The step's gradient of the engine's fourth parameter holds one
        `value`; returns its name."""
        name = eng._named[3][0]
        real = eng._grads

        def poisoned():
            for (n, _p), g in zip(eng._named, real()):
                if n == name:
                    g = g.clone()
                    g.view(-1)[0] = value
                yield g
        eng._grads = poisoned
        return name

    out = {}
    fetches = [0]
    real_fetch = num._host_fetch

    def counting(tree):
        fetches[0] += 1
        return real_fetch(tree)
    try:
        # (1) the stats taps
        flags.set_flags({'FLAGS_tensor_stats': True})
        eng = engine()
        eng.train_batch(data)                          # warm-up
        num._host_fetch = counting
        t0 = time.perf_counter()
        eng.train_batch(data)
        step_s = time.perf_counter() - t0
        num._host_fetch = real_fetch
        gauge = monitor.metrics().get('ptpu_num_grad_norm_global').value()
        clip_norm = float(pnn.ClipGradByGlobalNorm(1.0).global_norm(
            [(p, p.grad) for _, p in eng._named]))
        rel = abs(gauge - clip_norm) / clip_norm
        if fetches[0] != 1 or rel > 1e-5:
            raise AssertionError(f'taps: {fetches[0]} fetches, norm '
                                 f'{gauge} vs the clip\'s {clip_norm}')
        out['tensor_stats'] = {
            'fetches_a_step': fetches[0], 'grad_norm_global': gauge,
            'clip_global_norm': clip_norm, 'rel_diff': rel,
            'tensors': len(eng.last_numerics['grads']),
            'step_s_with_taps': step_s,
            'nonfinite_total': num.snapshot()['nonfinite_total']}
        eng.shutdown()
        del eng
        free_cuda(torch)
        flags.set_flags({'FLAGS_tensor_stats': False})

        # (2) a planted NaN under FLAGS_check_nan_inf
        flags.set_flags({'FLAGS_check_nan_inf': True})
        eng = engine()
        name = poison(eng, float('nan'))
        try:
            eng.train_batch(data)
            raise AssertionError('a NaN gradient did not raise')
        except num.NumericsError as e:
            if e.report.get('first_bad') != name:
                raise AssertionError(f'NumericsError names '
                                     f'{e.report.get("first_bad")}, not '
                                     f'{name}')
            out['nan_planted'] = {'parameter': name,
                                  'named': e.report['first_bad'],
                                  'report_written': bool(e.report_path)}
        eng.shutdown()
        del eng
        free_cuda(torch)

        # (3) a loss-scaled overflow is skipped; the next step is clean
        eng = engine()
        poison(eng, float('inf'))
        scaler = GradScaler(init_loss_scaling=2.0 ** 15,
                            decr_every_n_nan_or_inf=1)
        eng.train_step(data, scaler=scaler)
        eng.flush()
        skipped = eng.last_numerics is None and scaler._scale == 2.0 ** 14
        del eng._grads                     # the clean step's gradients
        eng.train_step(data, scaler=scaler)
        eng.flush()
        clean = eng.last_numerics is not None
        eng.shutdown()
        del eng
        free_cuda(torch)
        flags.set_flags({'FLAGS_check_nan_inf_deferred': True})
        net = pnn.Linear(2, 2, device='cuda')
        with torch.no_grad():
            net.weight.uniform_(0.1, 1.0)
            net.bias.fill_(0.1)
        opt = SGD(learning_rate=0.1, parameters=net.parameters())
        x = torch.ones(2, 2, device='cuda')
        with num.guard():
            torch.exp(net(x).sum() * 1e9).backward()
        eager = GradScaler(init_loss_scaling=2.0, decr_every_n_nan_or_inf=1)
        eager.step(opt)
        eager_skipped = eager._found_inf and \
            num.guard().pending_ops() == 0
        opt.clear_grad()
        with num.guard():
            (net(x) ** 2).mean().backward()
        eager.step(opt)                    # must not raise
        if not (skipped and clean and eager_skipped
                and not eager._found_inf):
            raise AssertionError(
                f'overflow skip: engine skipped {skipped}, next clean '
                f'{clean}; eager skipped {eager_skipped}, next found_inf '
                f'{eager._found_inf}')
        out['overflow_skip'] = {'engine_skipped': skipped,
                                'engine_next_clean': clean,
                                'eager_skipped_and_reset': eager_skipped,
                                'eager_next_clean': not eager._found_inf}
        flags.set_flags({'FLAGS_check_nan_inf': False,
                         'FLAGS_check_nan_inf_deferred': False})

        # (4) an allocation of twice the card inside oom_guard
        total = torch.cuda.get_device_properties(0).total_memory
        try:
            with mem.oom_guard('chip_smoke.oom'):
                torch.empty(2 * total, dtype=torch.uint8, device='cuda')
            raise AssertionError('twice the card allocated')
        except mem.DeviceOOMError as e:
            rep = e.report
            if rep.get('kind') != 'oom_report' or \
                    rep.get('bytes_limit') != total:
                raise AssertionError(f'OOM report: {rep}')
            out['oom'] = {'site': rep['site'], 'bytes_limit': total,
                          'bytes_in_use': rep['bytes_in_use'],
                          'suspect_phase': rep['suspect_phase'],
                          'top_buffers': len(rep['top_buffers']),
                          'report_written': bool(e.report_path)}

        # (5) a stalled heartbeat under a short watchdog
        rec = fr.FlightRecorder(capacity=16)
        rec.heartbeat()
        dog = fr.HangWatchdog(timeout=0.2, interval=0.05, recorder=rec,
                              dump_dir=report_dir)
        t0 = time.perf_counter()
        with dog:
            fired = dog.fired.wait(10.0)
        if not fired or not dog.report_path or \
                not os.path.exists(dog.report_path):
            raise AssertionError('the watchdog wrote no dump')
        with open(dog.report_path) as f:
            dump = json.load(f)
        out['watchdog'] = {'fired_after_s': time.perf_counter() - t0,
                           'reason': dump['reason'],
                           'stacks': len(dump['ranks']['0']['stacks'])}
    finally:
        num._host_fetch = real_fetch
        flags.set_flags({'FLAGS_tensor_stats': False,
                         'FLAGS_check_nan_inf': False,
                         'FLAGS_check_nan_inf_deferred': False})
        num.reset()
        if saved_dir is None:
            os.environ.pop('FLEET_LOG_DIR', None)
        else:
            os.environ['FLEET_LOG_DIR'] = saved_dir
        shutil.rmtree(report_dir, ignore_errors=True)
    free_cuda(torch)
    emit({'phase': 'telemetry', 'card': card, 'model': 'gpt_1p3b',
          'layers': PIPE_AMP_LAYERS, **out})


def _rel_on_card(a, b):
    """Relative L2 error of a against b, both on the card."""
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float(a.norm())


def policy_check(torch, cfg, ids, labels):
    """The four remat policies on the card from the same weights (the
    pipeline_check model, SGD, 2 train_batch calls each): losses, the
    last step's gradients and the updated parameters against 'none's,
    within WHOLE_PATH_RTOL (relative L2 a tensor), and whether bit-equal.
    The kernels run inside the policies' recomputes here, where the CPU
    tests see only their plain versions."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.spmd_pipeline \
        import SpmdPipelineEngine
    from paddle_tpu_torch.distributed.fleet.utils import recompute as remat
    from paddle_tpu_torch.models import build_gpt_pipeline
    from paddle_tpu_torch.optimizer import SGD

    want, out = None, {}
    for policy in remat.POLICY_NAMES:
        gen = torch.Generator(device='cuda').manual_seed(93)
        triple = build_gpt_pipeline(cfg, device='cuda', dtype=torch.float32,
                                    generator=gen)
        eng = SpmdPipelineEngine(*triple, SGD(learning_rate=1e-3),
                                 accumulate_steps=PIPE_CHECK_A,
                                 remat_policy=policy,
                                 grad_accum_dtype='param')
        losses = [float(eng.train_batch((ids, labels))) for _ in range(2)]
        grads = [p.grad.detach().clone() for _, p in eng._named]
        params = [p.detach().clone() for _, p in eng._named]
        eng.shutdown()
        del eng, triple
        if want is None:
            want = (losses, grads, params)
            out[policy] = {'losses': losses}
            continue
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want[0]))
        grad_err = max(_rel_on_card(a, b) for a, b in zip(grads, want[1]))
        param_err = max(_rel_on_card(a, b)
                        for a, b in zip(params, want[2]))
        bit_equal = losses == want[0] and all(
            torch.equal(a, b) for a, b in zip(grads + params,
                                               want[1] + want[2]))
        out[policy] = {'losses': losses, 'loss_rel_err': loss_err,
                       'max_grad_rel_l2': grad_err,
                       'max_param_rel_l2': param_err,
                       'bit_equal': bit_equal}
        if not bit_equal and max(loss_err, grad_err, param_err) > \
                WHOLE_PATH_RTOL:
            raise AssertionError(f"remat {policy!r} differs from 'none' on "
                                 f'the card: {out[policy]}')
        del grads, params
        free_cuda(torch)
    emit({'phase': 'pipeline_check', 'what': 'the four remat policies '
          "against 'none' on the card, SGD, 2 train_batch calls from the "
          'same weights, fp32, 2 layers at gpt_1p3b width',
          'rtol': WHOLE_PATH_RTOL, 'policies': out})
    del want
    free_cuda(torch)


# the LM head at a micro-batch of 4096 tokens (the headline's mb = 2 at
# L = 2048) and of 8192 (mb = 4, above GPTLMHead's 2^28-logit switch,
# where the head takes this route), vocab 50304: the fused chunked
# projection + cross-entropy against the plain product and hard
# cross-entropy, both bf16. The plain loss is one bf16 rounding of the
# mean (2^-8) from bf16 logits, the fused one fp32 from fp32 logits: the
# loss within 2^-7 relative. Both round dx and dw to bf16 (2^-9 an
# element, 1.6e-3 relative L2 against float64 on the CPU at [512-1024,
# 1024-2048] x 8192-16384, where the two agreed to 5e-4): relative L2
# within 4e-3.
XENT_SHAPES = ((4096, 2048, 50304), (8192, 2048, 50304))
XENT_LOSS_RTOL, XENT_GRAD_REL_L2 = 2.0 ** -7, 4e-3


def linear_xent_check(torch):
    """fused_linear_cross_entropy on the card against the plain head,
    forward and backward, with their times and peak memory, at each of
    XENT_SHAPES."""
    for shape in XENT_SHAPES:
        linear_xent_row(torch, *shape)
        free_cuda(torch)


def linear_xent_row(torch, N, H, V):
    from paddle_tpu_torch.models.gpt import FUSED_HEAD_MIN_LOGITS
    from paddle_tpu_torch.ops import nn_ops as F

    randn = make_randn(torch, 77)
    x, w = randn(N, H), randn(H, V, scale=0.02)
    gen = torch.Generator(device='cuda').manual_seed(78)
    labels = torch.randint(0, V, (N,), generator=gen, device='cuda')

    def fused(xx, ww):
        return F.fused_linear_cross_entropy(xx, ww, labels,
                                            transpose_y=False)

    def plain(xx, ww):
        rows = F.softmax_with_cross_entropy(torch.matmul(xx, ww), labels)
        return rows.float().mean().to(rows.dtype)

    out = {}
    for name, fn in (('fused', fused), ('plain', plain)):
        xx, ww = (t.clone().requires_grad_() for t in (x, w))
        free_cuda(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = fn(xx, ww)
        loss.backward()
        torch.cuda.synchronize()
        out[name] = dict(loss=float(loss.detach()), dx=xx.grad, dw=ww.grad,
                         peak_bytes=torch.cuda.max_memory_allocated() - base)

        def step(fn=fn, xx=xx, ww=ww):
            xx.grad = ww.grad = None
            fn(xx, ww).backward()
        out[name]['ms'] = loop_ms(torch, step)
    f, p = out['fused'], out['plain']
    loss_err = abs(f['loss'] - p['loss']) / abs(p['loss'])
    dx_err = _rel_on_card(f['dx'], p['dx'])
    dw_err = _rel_on_card(f['dw'], p['dw'])
    if not np.isfinite(f['loss']) or loss_err > XENT_LOSS_RTOL or \
            dx_err > XENT_GRAD_REL_L2 or dw_err > XENT_GRAD_REL_L2:
        raise AssertionError(f'fused_linear_cross_entropy vs plain at '
                             f'{(N, H, V)}: loss {loss_err:.3g}, dx '
                             f'{dx_err:.3g}, dw {dw_err:.3g}')
    emit({'phase': 'linear_xent', 'shape': [N, H, V],
          'gpt_lm_head_route': 'fused' if N * V > FUSED_HEAD_MIN_LOGITS
                               else 'plain',
          'dtype': 'bfloat16', 'transpose_y': False, 'chunks': 8,
          'fused_loss': f['loss'], 'plain_loss': p['loss'],
          'loss_rel_err': loss_err, 'dx_rel_l2': dx_err,
          'dw_rel_l2': dw_err, 'loss_rtol': XENT_LOSS_RTOL,
          'grad_rel_l2_bar': XENT_GRAD_REL_L2,
          'fwd_bwd_ms': f['ms'], 'plain_fwd_bwd_ms': p['ms'],
          'peak_bytes': f['peak_bytes'],
          'plain_peak_bytes': p['peak_bytes'],
          'note': 'bf16 products with fp32 results on the tensor cores; '
                  'the plain head multiplies in bf16 with bf16 logits'})
    del out, f, p


# ---------------------------------------------------------------------------
# the BERT leg (bench.py:264-329, `bert_base_zero2_bf16`): BERT-base through
# HybridParallelTrainStep on a ['dp', 'sharding'] = [1, 1] mesh
# ---------------------------------------------------------------------------
BERT_B, BERT_L, BERT_HEADS, BERT_HEAD_DIM = 64, 512, 12, 64
BERT_HIDDEN, BERT_FFN, BERT_LAYERS, BERT_VOCAB = 768, 3072, 12, 30522
BERT_ROWS = BERT_B * BERT_L
BERT_TIMED, BERT_TRIALS = 10, 2          # bench.py:318-323: n = 10
# the leg's update: bf16 p and g, fp32 master and moments (the kernel
# reads g, master, m1, m2 and writes p, master, m1, m2)
BERT_UPDATE_BYTES = 2 + 4 * 3 + 2 + 4 * 3
BERT_KERNELS = TRAIN_KERNELS + ('optimizer_step',)


def bert_params(layers):
    """BertForPretraining's parameter tensors, each one entry of the
    step's update list: the embeddings' 5 (three tables and a
    LayerNorm), a block's 16 (q, k, v, out, linear1, linear2, norm1,
    norm2, each a weight and a bias), the pooler's, the MLM transform's
    and its LayerNorm's, and the NSP head's 2 each."""
    return 5 + 16 * layers + 8


def bert_launches(layers):
    """Each kernel's launches in one HybridParallelTrainStep step of
    BertForPretraining at hidden dropout 0 on the packed flash route
    (L >= FLAGS_flash_min_seq, no mask), as the wrappers count them: a
    LayerNorm forward each for the embeddings, two a block and the MLM
    head's norm, and one backward each (2 launches a call: the kernel and
    its column sum); a block's attention one packed flash forward, dQ and
    dK/dV, its FFN one bias+GELU forward (erf form) and backward (2
    launches a call); the MLM transform's GELU is the plain `F.gelu`, no
    kernel; no remat; the update one launch for all the parameters (one
    dtype group: bf16 p and g, fp32 masters and moments). Every other
    kernel launches 0 times."""
    ln_calls = 2 * layers + 2
    return {'layer_norm': ln_calls, 'bias_gelu': layers,
            'flash_fwd': layers, 'flash_bwd_dq': layers,
            'flash_bwd_dkv': layers, 'layer_norm_bwd': 2 * ln_calls,
            'bias_gelu_bwd': 2 * layers,
            'optimizer_step': UPDATE_GROUPS}


def bert_kernel_rows(torch, F):
    """Rows 2-5 and 8-10 at the BERT leg's shapes, each against its plain
    version and timed beside its bound and library call: the LayerNorm
    forward (with mean and rstd) and backward at [32768, 768], the
    bias+GELU forward and backward in the erf form at [32768, 3072]
    (beside F.gelu(x + b) and gelu_backward + the bias sum), and the
    packed flash forward, dQ and dK/dV at [64, 512, 12 x 64], non-causal,
    checked with and without a key bias. Returns {kernel: row}."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_elementwise as fe
    from paddle_tpu_torch.ops.kernels import fused_norm as fn

    randn = make_randn(torch, 13)
    aten = torch.ops.aten
    rows = {}
    n = BERT_HIDDEN
    x = randn(BERT_ROWS, n)
    w = 1.0 + randn(n, scale=0.1)
    b = randn(n, scale=0.1)
    y, mean, rstd = fn._fwd_kernel(x, w, b, 1e-12, True)
    y_p, mean_p, rstd_p = fn.layer_norm_fwd_plain(x, w, b, 1e-12)
    err = max(check_close('layer_norm', y, y_p),
              check_close('fp32_sum', mean, mean_p),
              check_close('fp32_sum', rstd, rstd_p))
    bms, by = bound_ms(2 * BERT_ROWS * n * 2 + 2 * n * 2 + BERT_ROWS * 8,
                       8 * BERT_ROWS * n, FP32_FLOPS)
    rows['layer_norm'] = dict(
        shape=f'x[{BERT_ROWS},{n}] bf16, mean/rstd out', max_abs_err=err,
        ms=device_ms(torch, lambda: fn._fwd_kernel(x, w, b, 1e-12, True),
                     iters=20),
        plain_ms=loop_ms(torch, lambda: fn.layer_norm_fwd_plain(
            x, w, b, 1e-12)),
        library_ms=device_ms(torch, lambda: aten.native_layer_norm(
            x, [n], w, b, 1e-12), iters=20),
        bound_ms=bms, bound_by=by)
    del x, y, y_p, mean, rstd, mean_p, rstd_p
    x = randn(BERT_ROWS, BERT_FFN)
    b = randn(BERT_FFN, scale=0.1)
    err = check_close('bias_gelu', fe.bias_gelu(x, b, False),
                      fe.bias_gelu_plain(x, b, False))
    bms, by = bound_ms(2 * BERT_ROWS * BERT_FFN * 2 + BERT_FFN * 2,
                       12 * BERT_ROWS * BERT_FFN, FP32_FLOPS)
    rows['bias_gelu'] = dict(
        shape=f'x[{BERT_ROWS},{BERT_FFN}] bf16, erf form', max_abs_err=err,
        ms=device_ms(torch, lambda: fe.bias_gelu(x, b, False), iters=20),
        plain_ms=loop_ms(torch, lambda: fe.bias_gelu_plain(x, b, False)),
        library_ms=device_ms(torch, lambda: F.gelu(x + b), iters=20),
        library='F.gelu(x + b), erf', bound_ms=bms, bound_by=by)
    del x, b
    free_cuda(torch)
    rows.update(norm_bwd_rows(torch, randn, BERT_ROWS, BERT_HIDDEN,
                              BERT_FFN, approximate=False))
    free_cuda(torch)
    B, L, H, D = BERT_B, BERT_L, BERT_HEADS, BERT_HEAD_DIM
    checks = {'no bias': flash_check(torch, fa, randn, B, L, torch.bfloat16,
                                     'flash_bf16', H, D, causal=False),
              'key bias': flash_check(torch, fa, randn, B, L, torch.bfloat16,
                                      'flash_bf16', H, D, causal=False,
                                      bias=key_bias(torch, B, L, 3))}
    free_cuda(torch)
    rows.update(flash_rows(torch, F, randn, B, L, checks['no bias'], H, D,
                           causal=False))
    for name in PACKED_FLASH:
        rows[name]['key_bias_check'] = checks['key bias']
    free_cuda(torch)
    for name, r in rows.items():
        emit({'phase': 'kernel', 'name': name, 'path': 'bert', **r})
    return rows


def bert_model(torch, cfg, dtype, seed):
    from paddle_tpu_torch.models import BertForPretraining

    gen = torch.Generator(device='cuda').manual_seed(seed)
    return BertForPretraining(cfg, device='cuda', dtype=dtype, generator=gen)


def bert_loss(model, ids, mlm_labels, nsp_labels, attention_mask=None):
    """bench.py:295-298: the fused MLM loss and the NSP loss."""
    return model(ids, attention_mask=attention_mask,
                 masked_lm_labels=mlm_labels,
                 next_sentence_label=nsp_labels)


def bert_update_check(torch, eng, lr):
    """The leg's update on copies of the engine's 205 parameters and
    states with the last step's gradients: the list form
    (`ParamUpdates.apply`, one launch for all of them) bit-equal to its
    plain chain on the card."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO

    opt = eng.optimizer
    kps = [p.detach().clone() for _, p in eng._named]
    entries = [(kp, p.grad, {k: v.clone()
                             for k, v in eng._states[n].items()})
               for kp, (n, p) in zip(kps, eng._named)]
    _build.reset_launches()
    got = FO.ParamUpdates(opt, lr).apply(entries)
    launches = _build.routes_snapshot()[FO.STEP]
    differ = []
    for (n, p), kp, (_kp, ks) in zip(eng._named, kps, got):
        st = eng._states[n]
        want_p, want_s = FO.fused_shard_update_plain(
            opt, p.detach(), p.grad, st, lr, round_prefactor=True)
        differ += [f'{n}:p'] if not torch.equal(kp, want_p) else []
        differ += [f'{n}:{k}' for k in want_s
                   if not torch.equal(ks[k], want_s[k])]
    if differ or launches != UPDATE_GROUPS:
        raise AssertionError(f'bert: the update ({launches} launches) '
                             f'differs from its plain chain on the card: '
                             f'{differ[:8]}')
    return {'bit_equal': True, 'tensors': len(eng._named),
            'check_launches': launches}


def bert_phase(torch, card):
    """BERT-base pretraining in the bench's configuration (bench.py:276-
    303): vocab 30522, hidden 768, 12 layers of 12 heads, FFN 3072, B = 64
    x L = 512, bf16 parameters with fp32 masters and moments, AdamW lr
    1e-4 decay 0.01, dropouts 0, FLAGS_flash_min_seq 512, on a ['dp',
    'sharding'] = [1, 1] mesh through HybridParallelTrainStep with the
    fused MLM loss; labels = ids, NSP labels from RandomState(0). A
    warm-up step, then the bench's windowed loop (train_step x 10, then
    flush; 2 trials, the best kept) with exact launch counts; a profiled
    step; the update checked and timed on copies."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.distributed import topology_runtime
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        hybrid_engine as he)
    from paddle_tpu_torch.models import BertConfig
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW

    min_seq = flags.get_flags('FLAGS_flash_min_seq')
    flags.set_flags({'FLAGS_flash_min_seq': 512})
    topology_runtime.build_mesh(['dp', 'sharding'], [1, 1])
    cfg = BertConfig(vocab_size=BERT_VOCAB, hidden_size=BERT_HIDDEN,
                     num_layers=BERT_LAYERS, num_heads=BERT_HEADS,
                     intermediate_size=BERT_FFN, max_seq_len=BERT_L,
                     hidden_dropout=0.0, attn_dropout=0.0)
    t0 = time.perf_counter()
    model = bert_model(torch, cfg, torch.bfloat16, 4321)
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01)
    eng = he.HybridParallelTrainStep(model, bert_loss, opt)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (BERT_B, BERT_L)).astype('int32')
    mlm = ids.astype('int64')
    nsp = rng.randint(0, 2, (BERT_B,)).astype('int64')
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = float(eng(ids, mlm, nsp))
    warm_s = time.perf_counter() - t0
    _build.reset_launches()
    trials, losses = [], []
    for _ in range(BERT_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = [eng.train_step(ids, mlm, nsp) for _ in range(BERT_TIMED)]
        eng.flush()
        trials.append((time.perf_counter() - t0) / BERT_TIMED)
        losses += [float(r) for r in results]
    launches = _build.routes_snapshot()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f'bert: non-finite loss {[warm] + losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'bert: loss did not fall: {losses}')
    if n_tensors != bert_params(BERT_LAYERS):
        raise AssertionError(f'bert: {n_tensors} parameter tensors')
    want = check_exact_launches('bert', launches, {
        k: BERT_TIMED * BERT_TRIALS * n
        for k, n in bert_launches(BERT_LAYERS).items()})
    step_s = min(trials)
    tokens = BERT_B * BERT_L
    flops = 6 * n_params * tokens + \
        12 * cfg.num_layers * cfg.hidden_size * BERT_L * tokens
    nsp_t = torch.from_numpy(nsp).cuda()
    prof = profile_train_step(
        torch, lambda i, lab: eng(i, lab, nsp_t),
        torch.from_numpy(ids).cuda(), torch.from_numpy(mlm).cuda(),
        ranges=(he.UPDATE_RANGE, 'no head range'))
    update_bytes = n_params * BERT_UPDATE_BYTES
    update = {'device_s': update_device_s(prof),
              'device_span_s': prof['device_span_s_of_range'].get(
                  he.UPDATE_RANGE),
              'bytes': update_bytes,
              'bound_ms': 1e3 * update_bytes / HBM_BYTES_PER_S,
              'bound_by': 'bytes', 'tensors': n_tensors,
              'launches_per_step': UPDATE_GROUPS,
              **bert_update_check(torch, eng, torch.tensor(
                  1e-4, device='cuda')),
              **update_timings(torch, eng.optimizer, eng._named,
                               [eng._states[n] for n, _ in eng._named])}
    groups = prof['device_s_by_group']
    emit({'phase': 'bert', 'card': card, 'model': 'BERT-base',
          'layers': cfg.num_layers, 'hidden': cfg.hidden_size,
          'heads': cfg.num_heads, 'ffn': cfg.intermediate_size,
          'vocab': cfg.vocab_size, 'params': n_params,
          'param_tensors': n_tensors, 'batch': BERT_B, 'seq_len': BERT_L,
          'engine': "HybridParallelTrainStep, mesh ['dp', 'sharding'] = "
                    "[1, 1]",
          'optimizer': 'AdamW lr 1e-4 wd 0.01, fp32 master and moments',
          'model_build_s': build_s, 'warmup_step_s': warm_s,
          'warmup_loss': warm, 'losses': losses, 'trial_step_s': trials,
          'ms_per_step': 1e3 * step_s, 'samples_per_sec': BERT_B / step_s,
          'tokens_per_sec': tokens / step_s,
          'model_flops_per_step': flops,
          'model_tflops': flops / step_s / 1e12,
          'mfu': flops / step_s / 1e12 / PEAK_BF16_TFLOPS,
          'peak_memory_bytes': peak, 'launches': launches,
          'launches_per_step': {k: n / (BERT_TIMED * BERT_TRIALS)
                                for k, n in want.items()},
          'busy_split': {
              'gemm': groups['gemm'], 'port_kernels': groups['port_kernels'],
              'update': update['device_s'],
              'other': groups['other'] + groups['grad_stats']
              - prof['device_s_other_split']['optimizer']},
          'update': update, **prof})
    eng.shutdown()
    flags.set_flags(min_seq)
    # row 15 at the leg's shapes: its kernels' device time in the
    # profiled step, bit-equal to the plain chain (max_abs_err 0)
    row = dict(shape=f'{n_tensors} tensors, {n_params} elements, bf16 p '
                     f'and g, fp32 master and moments',
               max_abs_err=0.0, ms=1e3 * update['device_s'],
               plain_ms=update['plain_ms'], bound_ms=update['bound_ms'],
               bound_by='bytes', library_ms=update['library_ms'])
    return launches, row


BERT_CHECK_LAYERS, BERT_CHECK_B, BERT_CHECK_STEPS = 2, 2, 3


def bert_check(torch):
    """HybridParallelTrainStep on the card against the CPU: BERT-base's
    width with 2 layers in fp32 (TF32 off), B = 2 x L = 512 (the flash
    route at FLAGS_flash_min_seq 512: the fp32 CUDA-core bodies), 3 steps
    from the same weights: (a) SGD with a 2-D attention_mask that pads
    each row's last tokens (the key-bias route); (b) AdamW with
    ClipGradByGlobalNorm(1.0), no mask. Losses, the last step's gradients
    and the parameters within WHOLE_PATH_RTOL."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.distributed import topology_runtime
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        hybrid_engine as he)
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import SGD, AdamW

    min_seq = flags.get_flags('FLAGS_flash_min_seq')
    flags.set_flags({'FLAGS_flash_min_seq': 512})
    topology_runtime.build_mesh(['dp', 'sharding'], [1, 1])
    cfg = BertConfig(vocab_size=BERT_VOCAB, hidden_size=BERT_HIDDEN,
                     num_layers=BERT_CHECK_LAYERS, num_heads=BERT_HEADS,
                     intermediate_size=BERT_FFN, max_seq_len=BERT_L,
                     hidden_dropout=0.0, attn_dropout=0.0)
    rng = np.random.RandomState(1)
    B, L = BERT_CHECK_B, BERT_L
    ids = rng.randint(0, cfg.vocab_size, (B, L)).astype('int64')
    nsp = rng.randint(0, 2, (B,)).astype('int64')
    mask = (np.arange(L)[None, :] < np.array([L - 37, L - 100])[:, None]
            ).astype('int64')
    out = {}
    for case, make, with_mask, adam in (
            ('sgd_attention_mask', lambda: SGD(learning_rate=1e-2), True,
             False),
            ('adamw_global_norm_clip', lambda: AdamW(
                learning_rate=1e-4, weight_decay=0.01,
                grad_clip=pnn.ClipGradByGlobalNorm(1.0)), False, True)):
        card_model = bert_model(torch, cfg, torch.float32, 99)
        with torch.device('meta'):
            cpu_model = BertForPretraining(cfg)
        cpu_model = cpu_model.to_empty(device='cpu')
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   card_model.state_dict().items()})
        batch = (ids, ids, nsp) + ((mask,) if with_mask else ())
        losses = {}
        _build.reset_launches()
        for label, model, dev in (('card', card_model, None),
                                  ('cpu', cpu_model, 'cpu')):
            eng = he.HybridParallelTrainStep(model, bert_loss, make(),
                                             device=dev)
            losses[label] = [float(eng(*batch))
                             for _ in range(BERT_CHECK_STEPS)]
            eng.shutdown()
        check_exact_launches(f'bert_check {case}',
                             _build.routes_snapshot(), {
                                 k: BERT_CHECK_STEPS * n for k, n in
                                 bert_launches(BERT_CHECK_LAYERS).items()})
        out[case] = _compare(
            card_model, cpu_model, losses['card'], losses['cpu'], adam=adam,
            zero_grad={n for n, _ in card_model.named_parameters()
                       if n.endswith('self_attn.k_proj.bias')})
        del card_model, cpu_model
        free_cuda(torch)
    flags.set_flags(min_seq)
    emit({'phase': 'bert_check', 'layers': BERT_CHECK_LAYERS,
          'hidden': BERT_HIDDEN, 'batch': B, 'seq_len': L,
          'dtype': 'float32', 'steps': BERT_CHECK_STEPS, 'cases': out})


DECODE_B, DECODE_PROMPT, DECODE_NEW = 8, 64, 64


def decode_launches(layers, steps):
    """The LayerNorm and bias+GELU forwards of `steps` dense-cache decode
    steps of GPT: two LayerNorms a block and the final one, one bias+GELU
    (tanh form) a block."""
    return {'layer_norm': steps * (2 * layers + 1),
            'bias_gelu': steps * layers}


def dense_decode_phase(torch, card):
    """GPT's dense-cache decode. (a) gpt_1p3b at full width and depth,
    bf16: generate(use_cache=True) of 8 prompts of 64 tokens, 64 greedy
    tokens, timed, with exact LayerNorm and bias+GELU launch counts at the
    decode step's shapes ([8, 2048], [8, 8192]). (b) 2 layers at the same
    width in fp32: the cached tokens equal generate(use_cache=False)'s and
    generate_scan's."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.ops.kernels import _build

    cfg = gpt_1p3b(hidden_dropout=0.0, attn_dropout=0.0)
    gen = torch.Generator(device='cuda').manual_seed(4321)
    model = GPTForCausalLM(cfg, device='cuda', dtype=torch.bfloat16,
                           generator=gen)
    prompts = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (DECODE_B, DECODE_PROMPT))
    model.generate(prompts[:, :8], max_new_tokens=4)          # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    toks = model.generate(prompts, max_new_tokens=DECODE_NEW)
    wall = time.perf_counter() - t0
    launches = _build.routes_snapshot()
    steps = DECODE_PROMPT + DECODE_NEW            # one forward a position
    check_exact_launches('dense_decode', launches,
                         decode_launches(cfg.num_layers, steps))
    if tuple(toks.shape) != (DECODE_B, DECODE_PROMPT + DECODE_NEW) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f'dense_decode: bad tokens {toks.shape}')
    del model
    free_cuda(torch)

    cfg.num_layers = 2
    gen = torch.Generator(device='cuda').manual_seed(5)
    small = GPTForCausalLM(cfg, device='cuda', dtype=torch.float32,
                           generator=gen)
    cached = small.generate(prompts, max_new_tokens=DECODE_NEW)
    uncached = small.generate(prompts, max_new_tokens=DECODE_NEW,
                              use_cache=False)
    scan = small.generate_scan(prompts, max_new_tokens=DECODE_NEW)
    same = {'uncached': bool(torch.equal(cached.long(), uncached.long())),
            'generate_scan': bool(torch.equal(cached.long(), scan.long()))}
    if not all(same.values()):
        raise AssertionError(f'dense_decode: cached tokens differ {same}')
    del small
    free_cuda(torch)
    emit({'phase': 'dense_decode', 'card': card, 'model': 'gpt_1p3b',
          'layers': 24, 'batch': DECODE_B, 'prompt': DECODE_PROMPT,
          'new_tokens': DECODE_NEW, 'dtype': 'bfloat16', 'wall_s': wall,
          'forward_steps': steps, 'ms_per_step': 1e3 * wall / steps,
          'new_tokens_per_sec': DECODE_B * DECODE_NEW / wall,
          'launches': launches,
          'fp32_2_layers_tokens_equal': same})
    return launches


# ---------------------------------------------------------------------------
# the vision legs (bench.py:333-411)
# ---------------------------------------------------------------------------
LENET_B, RESNET_B = 256, 128
VISION_STEPS, VISION_TRIALS = 20, 3
# bench.py:404-405: ~4.1 GFLOPs a 224 x 224 image forward, training ~3x
RESNET_FWD_FLOPS = 4.1e9
# Momentum with an fp32 master, bytes an element: the bf16 gradient and
# the master and velocity read, the bf16 parameter and both written
RESNET_UPDATE_BYTES = 2 + 4 * 2 + 2 + 4 * 2


def xent_loss(model, x, y):
    """bench.py:343-344, :387-388."""
    from paddle_tpu_torch import nn as pnn

    return pnn.functional.cross_entropy(model(x), y)


def cudnn_settings(torch):
    return {'cudnn_benchmark': torch.backends.cudnn.benchmark,
            'cudnn_allow_tf32': torch.backends.cudnn.allow_tf32,
            'matmul_allow_tf32': torch.backends.cuda.matmul.allow_tf32}


def timed_trials(torch, step, batch):
    """bench.py:350-357 / :396-403: VISION_TRIALS trials of VISION_STEPS
    steps, each ended by a host fetch of the last loss; (best s a step,
    every trial's s a step, the trials' last losses)."""
    trials, losses = [], []
    for _ in range(VISION_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VISION_STEPS):
            loss = step(*batch)
        losses.append(float(loss))
        trials.append((time.perf_counter() - t0) / VISION_STEPS)
    return min(trials), trials, losses


def lenet_phase(torch, card):
    """The lenet_mnist leg (bench.py:333-360): LeNet(10) from a seeded
    generator on the card, Adam at its defaults, TrainStep on its default
    (bucketed) route, B = 256 random fp32 images [256, 1, 28, 28] and
    int64 labels made once on the card; a warm-up step, then 3 trials of
    20 steps, the best kept. Row 15 launches once a step and nothing
    else does (no clip: no statistics pass)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet

    model = LeNet(10, device='cuda',
                  generator=torch.Generator(device='cuda').manual_seed(0))
    step = TrainStep(model, xent_loss, Adam())
    data = torch.Generator(device='cuda').manual_seed(1)
    imgs = torch.rand(LENET_B, 1, 28, 28, device='cuda', generator=data)
    labels = torch.randint(0, 10, (LENET_B,), device='cuda', generator=data)
    warm = float(step(imgs, labels))
    _build.reset_launches()
    step_s, trials, losses = timed_trials(torch, step, (imgs, labels))
    launches = _build.routes_snapshot()
    check_exact_launches('lenet', launches, {
        FO.STEP: VISION_STEPS * VISION_TRIALS})
    if not np.isfinite([warm] + losses).all() or not losses[-1] < warm:
        raise AssertionError(f'lenet: losses {warm} then {losses}')
    emit({'phase': 'lenet', 'card': card, 'model': 'LeNet(10)',
          'batch': LENET_B, 'dtype': 'float32', 'engine': 'TrainStep',
          'route': 'bucketed' if step.use_buckets else 'per-parameter',
          'buckets': len(step.layout.buckets), 'optimizer': 'Adam',
          'params': sum(p.numel() for p in model.parameters()),
          'warmup_loss': warm, 'trial_last_losses': losses,
          'trial_step_s': trials, 'ms_per_step': 1e3 * step_s,
          'images_per_sec': LENET_B / step_s, 'launches': launches,
          'optimizer_step_launches_per_step':
              launches[FO.STEP] / (VISION_STEPS * VISION_TRIALS),
          **cudnn_settings(torch)})
    return launches, 1e3 * step_s


def _vision_group(kernel, ops, update_range):
    """A device kernel's group in a vision step, from the ops around its
    launch (`ops`: the launching op and its parents' names): the port's
    update, a convolution (cuDNN's kernels and the GEMMs and layout
    transforms it runs them as), batch norm (forward or backward), any
    other GEMM (the classifier), or other."""
    names = ' '.join(ops).lower()
    if update_range in ops or any(
            part in kernel for part in KERNEL_NAMES['optimizer_step']):
        return 'update'
    if 'conv' in names:
        return 'convolution'
    if 'batch_norm' in names or 'batchnorm' in names:
        return 'batch_norm'
    if any(k in kernel.lower() for k in ('gemm', 'xmma', 'cutlass', 'nvjet',
                                         'sm90')):
        return 'gemm'
    return 'other'


def profile_vision_step(torch, step, batch, update_range):
    """One step under torch.profiler: device time by `_vision_group`, the
    card's busy share of the step's wall (unprofiled and profiled), the
    update range's device span, and the largest kernels with their
    groups."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(step(*batch))
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(*batch))
        wall = time.perf_counter() - t0
    groups = dict.fromkeys(('convolution', 'batch_norm', 'gemm', 'update',
                            'other'), 0.0)
    by_kernel, attributed = {}, {}
    for e in prof.events():
        if not e.kernels:
            continue
        ops, p = [], e
        while p is not None:
            ops.append(p.name)
            p = p.cpu_parent
        for k in e.kernels:
            group = _vision_group(k.name, ops, update_range)
            groups[group] += k.duration / 1e6
            attributed[k.name] = attributed.get(k.name, 0.0) + k.duration
            row = by_kernel.setdefault(k.name[:100], [group, 0.0, 0])
            row[1] += k.duration / 1e3
            row[2] += 1
    averages = prof.key_averages()
    # kernels no op launched (the port's, through ctypes) by name alone;
    # a range's device-side annotation bears its CPU range's name
    ranges = {e.name for e in prof.events()
              if e.device_type == DeviceType.CPU}
    for e in averages:
        if e.device_type != DeviceType.CUDA or e.key in ranges:
            continue
        rest = e.self_device_time_total - attributed.get(e.key, 0.0)
        if rest > 0:
            group = _vision_group(e.key, (), update_range)
            groups[group] += rest / 1e6
            row = by_kernel.setdefault(e.key[:100], [group, 0.0, 0])
            row[1] += rest / 1e3
            row[2] += e.count
    busy = sum(groups.values())
    if not busy:
        raise AssertionError('the profiler saw no device kernels')
    span = [e.device_time_total / 1e6 for e in averages
            if e.device_type == DeviceType.CUDA and e.key == update_range]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:14]
    return {'step_wall_s': wall_plain, 'profiled_step_wall_s': wall,
            'device_busy_s': busy, 'busy_share_of_wall': busy / wall_plain,
            'busy_share_of_profiled_wall': busy / wall,
            'device_s_by_group': groups,
            'share_of_busy': {k: v / busy for k, v in groups.items()},
            'update_device_span_s': span[0] if span else None,
            'top_kernels': [dict(name=n, group=g, device_ms=ms, calls=c)
                            for n, (g, ms, c) in top]}


def batch_norm_yardstick(torch, model, x):
    """The leg's batch norms (their input shapes, from an eval-mode
    forward) timed forward + backward in training, one shape at a time:
    the port's `batch_norm` (ATen's native kernels, NCHW, and the
    running update) against one `F.batch_norm` call without running
    buffers (the library's own pick, cuDNN where it takes the inputs),
    on NCHW and on channels-last inputs; ms a step, each shape's time
    times its count."""
    import collections

    from torch.nn import functional as TF
    from paddle_tpu_torch.nn.layer.norm import _BatchNormBase
    from paddle_tpu_torch.ops import nn_ops

    shapes = collections.Counter()
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.update([tuple(inp[0].shape)]))
        for m in model.modules() if isinstance(m, _BatchNormBase)]
    model.eval()
    with torch.no_grad():
        model(x)
    model.train()
    for h in hooks:
        h.remove()
    totals = dict.fromkeys(('port', 'library', 'library_channels_last'),
                           0.0)
    rows = []
    for shape, n in sorted(shapes.items()):
        c = shape[1]
        a = torch.randn(shape, device='cuda', dtype=torch.bfloat16)
        g = torch.randn_like(a)
        w = torch.ones(c, device='cuda', dtype=torch.bfloat16,
                       requires_grad=True)
        b = torch.zeros(c, device='cuda', dtype=torch.bfloat16,
                        requires_grad=True)
        rm = torch.zeros(c, device='cuda')
        rv = torch.ones(c, device='cuda')

        def run(fn, inp):
            inp = inp.detach().requires_grad_()
            fn(inp).backward(g)
        port = loop_ms(torch, lambda: run(lambda t: nn_ops.batch_norm(
            t, rm, rv, w, b, training=True), a), iters=10)
        lib = loop_ms(torch, lambda: run(lambda t: TF.batch_norm(
            t, None, None, w.float(), b.float(), True, 0.1, 1e-5), a),
            iters=10)
        cl = a.contiguous(memory_format=torch.channels_last)
        lib_cl = loop_ms(torch, lambda: run(lambda t: TF.batch_norm(
            t, None, None, w.float(), b.float(), True, 0.1, 1e-5), cl),
            iters=10)
        totals['port'] += n * port
        totals['library'] += n * lib
        totals['library_channels_last'] += n * lib_cl
        rows.append(dict(shape=list(shape), count=n, port_ms=port,
                         library_ms=lib, library_channels_last_ms=lib_cl))
    return {'ms_per_step': totals, 'shapes': rows}


def running_stats_record(model):
    """The batch norms' running statistics: all finite, and how many
    layers' means and variances moved off their initial 0 and 1."""
    means = [b for n, b in model.named_buffers() if n.endswith('_mean')]
    variances = [b for n, b in model.named_buffers()
                 if n.endswith('_variance')]
    finite = all(bool(b.isfinite().all()) for b in means + variances)
    return {'layers': len(means), 'finite': finite,
            'dtypes': sorted({str(b.dtype) for b in means + variances}),
            'means_moved': sum(bool(b.ne(0).any()) for b in means),
            'variances_moved': sum(bool(b.ne(1).any()) for b in variances),
            'first_mean_abs_mean': float(means[0].abs().mean()),
            'first_variance_mean': float(variances[0].mean())}


def resnet50_phase(torch, card):
    """The resnet50_dp_bf16 leg (bench.py:362-411): a degree-1 ['dp']
    mesh, resnet50(num_classes=1000) from a seeded generator on the
    card, every fp32 parameter cast to bf16 (the batch norms' running
    statistics stay fp32), Momentum(0.1, 0.9) with fp32 masters,
    HybridParallelTrainStep; B = 128 random bf16 [128, 3, 224, 224] and
    labels made once on the card; a warm-up step, then 3 trials of 20
    steps. ms/step, images/s, MFU as 3 * 4.1e9 * B / t over 989 TFLOP/s,
    peak memory; row 15 once a step and nothing else; the running
    statistics moved and finite; a profiled step split into convolution,
    batch norm, GEMM, the update and other."""
    from paddle_tpu_torch.distributed import topology_runtime
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        hybrid_engine as he)
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    topology_runtime.build_mesh(['dp'], [1])
    t0 = time.perf_counter()
    model = resnet50(num_classes=1000, device='cuda',
                     generator=torch.Generator(device='cuda').manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    eng = he.HybridParallelTrainStep(
        model, xent_loss, Momentum(learning_rate=0.1, momentum=0.9))
    data = torch.Generator(device='cuda').manual_seed(1)
    x = torch.rand(RESNET_B, 3, 224, 224, device='cuda',
                   generator=data).to(torch.bfloat16)
    y = torch.randint(0, 1000, (RESNET_B,), device='cuda', generator=data)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = float(eng(x, y))
    warm_s = time.perf_counter() - t0
    _build.reset_launches()
    step_s, trials, losses = timed_trials(torch, eng, (x, y))
    launches = _build.routes_snapshot()
    peak = torch.cuda.max_memory_allocated()
    check_exact_launches('resnet50', launches, {
        FO.STEP: VISION_STEPS * VISION_TRIALS})
    if not np.isfinite([warm] + losses).all():
        raise AssertionError(f'resnet50: losses {warm} then {losses}')
    stats = running_stats_record(model)
    if not stats['finite'] or stats['means_moved'] != stats['layers'] \
            or stats['variances_moved'] != stats['layers'] \
            or stats['dtypes'] != ['torch.float32']:
        raise AssertionError(f'resnet50: running statistics {stats}')
    flops = 3 * RESNET_FWD_FLOPS * RESNET_B
    prof = profile_vision_step(torch, eng, (x, y), he.UPDATE_RANGE)
    bn_yard = batch_norm_yardstick(torch, model, x)
    update_bytes = n_params * RESNET_UPDATE_BYTES
    emit({'phase': 'resnet50', 'card': card, 'model': 'resnet50(1000)',
          'params': n_params, 'param_tensors': n_tensors,
          'batch': RESNET_B, 'image': [3, 224, 224],
          'dtype': 'bf16 parameters, fp32 running statistics',
          'engine': "HybridParallelTrainStep, mesh ['dp'] = [1]",
          'optimizer': 'Momentum(0.1, 0.9), fp32 masters',
          'model_build_s': build_s, 'warmup_step_s': warm_s,
          'warmup_loss': warm, 'trial_last_losses': losses,
          'trial_step_s': trials, 'ms_per_step': 1e3 * step_s,
          'images_per_sec': RESNET_B / step_s,
          'model_flops_per_step': flops,
          'model_tflops': flops / step_s / 1e12,
          'mfu': flops / step_s / 1e12 / PEAK_BF16_TFLOPS,
          'peak_memory_bytes': peak, 'launches': launches,
          'optimizer_step_launches_per_step':
              launches[FO.STEP] / (VISION_STEPS * VISION_TRIALS),
          'running_stats': stats,
          'update': {'device_s': prof['device_s_by_group']['update'],
                     'device_span_s': prof['update_device_span_s'],
                     'bytes': update_bytes,
                     'bound_ms': 1e3 * update_bytes / HBM_BYTES_PER_S,
                     'bound_by': 'bytes'},
          'profile': prof, 'batch_norm_yardstick': bn_yard,
          **cudnn_settings(torch)})
    eng.shutdown()
    return launches


VISION_CHECK_B, VISION_CHECK_HW, VISION_CHECK_STEPS = 8, 64, 3


def block_net(pnn, models, **kw):
    """ResNet's stem (conv, batch norm, ReLU, 3x3 stride-2 max pool), a
    basic block, two bottleneck blocks (the first strided, with its
    downsample), the global pool and a linear."""
    norm = {k: v for k, v in kw.items() if k != 'generator'}
    return pnn.Sequential(
        pnn.Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False, **kw),
        pnn.BatchNorm2D(64, **norm), pnn.ReLU(), pnn.MaxPool2D(3, 2, 1),
        models.BasicBlock(64, 64, **kw),
        models.BottleneckBlock(64, 32, stride=2, downsample=pnn.Sequential(
            pnn.Conv2D(64, 128, 1, stride=2, bias_attr=False, **kw),
            pnn.BatchNorm2D(128, **norm)), **kw),
        models.BottleneckBlock(128, 32, **kw),
        pnn.AdaptiveAvgPool2D(1), pnn.Flatten(), pnn.Linear(128, 10, **kw))


def vision_check(torch):
    """The vision path on the card against the CPU: `block_net` (both
    of ResNet's block kinds) in fp32 with TF32 off, B = 8 at 64 x 64,
    Momentum(1e-3, 0.9), 3 steps from the same weights and batch on
    HybridParallelTrainStep and on TrainStep's bucketed route. The
    losses, all parameters together, all running statistics together
    and an eval-mode forward must each agree within WHOLE_PATH_RTOL
    relative L2. Each tensor's own error and the parameters' steps are
    reported, not held: ReLU and max-pool decisions near a tie flip
    under any rounding difference, and a batch norm's bias or weight
    feeding ReLU, a convolution and another batch norm has a gradient
    that nearly cancels. On the CPU a 1e-6 perturbation of the input
    moves single such biases by up to 0.9 % and the steps by 0.6 % at lr
    0.01 (eval logits 9.8e-4), 0.3 % and 0.19 % at lr 1e-3 (losses,
    parameters, statistics and logits within 3e-5 there). cuDNN picks
    its algorithms as in the timed phases (`cudnn_benchmark` in the
    line)."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.distributed import topology_runtime
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        hybrid_engine as he)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    topology_runtime.build_mesh(['dp'], [1])
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.rand(VISION_CHECK_B, 3, VISION_CHECK_HW,
                                  VISION_CHECK_HW).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (VISION_CHECK_B,)))
    out = {}
    for case, engine in (('hybrid', he.HybridParallelTrainStep),
                         ('trainstep', TrainStep)):
        card_model = block_net(pnn, models, device='cuda',
                               generator=torch.Generator(
                                   device='cuda').manual_seed(11))
        cpu_model = block_net(pnn, models, device='cpu')
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   card_model.state_dict().items()})
        init = {n: t.detach().double().cpu().clone()
                for n, t in cpu_model.named_parameters()}
        losses = {}
        for label, model, dev in (('card', card_model, None),
                                  ('cpu', cpu_model, 'cpu')):
            eng = engine(model, xent_loss,
                         Momentum(learning_rate=1e-3, momentum=0.9),
                         device=dev)
            losses[label] = [float(eng(x, y))
                             for _ in range(VISION_CHECK_STEPS)]
        card_state = card_model.state_dict()
        cpu_state = {n: t.detach().double()
                     for n, t in cpu_model.state_dict().items()}
        diff = {n: card_state[n].detach().double().cpu() - t
                for n, t in cpu_state.items()}
        errs = {n: _rel(card_state[n], t) for n, t in cpu_state.items()}

        def together(names, base=None):
            num = sum(float(diff[n].square().sum()) for n in names)
            den = sum(float((cpu_state[n] - (0 if base is None else
                                             base[n])).square().sum())
                      for n in names)
            return (num / den) ** 0.5
        stats = [n for n in cpu_state if n.endswith(('_mean', '_variance'))]
        card_model.eval()
        cpu_model.eval()
        with torch.no_grad():
            logits = _rel(card_model(x.cuda()), cpu_model(x))
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(losses['card'], losses['cpu']))
        worst = max(errs, key=errs.get)
        out[case] = {'card_losses': losses['card'],
                     'cpu_losses': losses['cpu'], 'loss_rel_err': loss_err,
                     'params_rel_l2': together(list(init)),
                     'running_stats_rel_l2': together(stats),
                     'eval_logits_rel_l2': logits,
                     'param_steps_rel_l2': together(list(init), init),
                     'max_tensor_rel_l2': errs[worst], 'worst_tensor': worst}
        held = ('loss_rel_err', 'params_rel_l2', 'running_stats_rel_l2',
                'eval_logits_rel_l2')
        if not np.isfinite(losses['card']).all() or max(
                out[case][k] for k in held) > WHOLE_PATH_RTOL:
            raise AssertionError(f'vision_check {case}: {out[case]}')
        del card_model, cpu_model
        free_cuda(torch)
    torch.backends.cudnn.allow_tf32 = tf32
    emit({'phase': 'vision_check', 'model': 'block_net', 'batch':
          VISION_CHECK_B, 'image': [3, VISION_CHECK_HW, VISION_CHECK_HW],
          'dtype': 'float32', 'optimizer': 'Momentum(1e-3, 0.9)',
          'steps': VISION_CHECK_STEPS, 'rtol': WHOLE_PATH_RTOL,
          'cases': out, **cudnn_settings(torch),
          'cudnn_allow_tf32_in_check': False})


# ---------------------------------------------------------------------------
# the parameter-server legs (bench.py:412-609)
# ---------------------------------------------------------------------------
# deepfm_ps: fields, embedding dim, batch, merged steps (K) a chunk, the
# timed chunks, the dense SGD and table lr (bench.py:432, :442, :463)
PS_FIELDS, PS_DIM, PS_B, PS_K, PS_CHUNKS, PS_LR = 26, 8, 512, 16, 12, 0.05
# The host table applies the rows of one push on up to 8 threads when
# they are 1024 or more, so a duplicated id's updates land in a racing
# order (csrc/sparse_table.cc ParallelOver); the chunk check pushes in
# pieces below that, in order, so its two tables see the same sequence.
PS_ORDERED_PUSH = 1000
# card vs CPU after one chunk, both fp32 (TF32 off): |row diff| over the
# chunk's distinct ids. Adagrad divides each gradient element by the root
# of its running sum of squares (+ 1e-8), so an element near 1e-8, where
# summation order moves it by a few ulps of its terms, moves its row by a
# sizeable share of lr; a wrong gradient moves rows by about lr = 0.05.
# On the CPU the leg's first chunk in fp32 against float64 stays under a
# tenth of this bar (tests/test_torch_ps_wire.py
# test_deepfm_chunk_fp32_against_fp64).
PS_ROWS_ATOL = 1e-3
PS_SCALE = dict(total_rows=2_000_000, mem_budget_rows=1 << 18, dim=8,
                batch_rows=13312, batches=15)
PS_MIN_SPILLED = 0.85


def deepfm_data(B=PS_B, K=PS_K, fields=PS_FIELDS, dim=PS_DIM,
                n_chunks=PS_CHUNKS):
    """The bench's draws, in its order from RandomState(0)
    (bench.py:432-448): 3 distinct chunks of Pareto ids [K, B * fields]
    mod 10^7, the stream cycling through them (n_chunks + 1), the dense
    weights w1 [fields * dim, 32], b1, w2 [32, 1] and the labels."""
    rng = np.random.RandomState(0)
    distinct = [(rng.pareto(1.2, (K, B, fields)) * 1000)
                .astype(np.int64).reshape(K, -1) % (10 ** 7)
                for _ in range(3)]
    stream = [distinct[i % 3] for i in range(n_chunks + 1)]
    w1 = (rng.randn(fields * dim, 32) * 0.05).astype(np.float32)
    b1 = np.zeros((32,), np.float32)
    w2 = (rng.randn(32, 1) * 0.05).astype(np.float32)
    labels = rng.randint(0, 2, (B, 1)).astype(np.float32)
    return distinct, stream, (w1, b1, w2), labels


def deepfm_dense_chunk(torch, embs, params, labels, lr=PS_LR):
    """K merged DeepFM train steps on embs [K, B * fields, dim] (the
    device of embs): the FM term over the fields' sum, a 32-unit ReLU
    tower, the logistic loss, torch autograd, SGD on w1, b1, w2 carried
    through the K batches (bench.py:450-478). Returns the mean loss, the
    K row-gradient sets [K, B * fields, dim] and the new weights."""
    w1, b1, w2 = params
    K, rows, dim = embs.shape
    B = labels.shape[0]
    losses, ges = [], []
    for k in range(K):
        emb = embs[k].detach().requires_grad_(True)
        ws = [t.detach().requires_grad_(True) for t in (w1, b1, w2)]
        e = emb.reshape(B, rows // B, dim)
        s = e.sum(1)
        fm = 0.5 * (s * s - (e * e).sum(1)).sum(-1, keepdim=True)
        h = torch.relu(e.reshape(B, -1) @ ws[0] + ws[1])
        logit = h @ ws[2] + fm
        loss = (logit.clamp(min=0) - logit * labels
                + torch.log1p(torch.exp(-logit.abs()))).mean()
        ge, gw1, gb1, gw2 = torch.autograd.grad(loss, [emb, *ws])
        with torch.no_grad():
            w1, b1, w2 = w1 - lr * gw1, b1 - lr * gb1, w2 - lr * gw2
        losses.append(loss.detach())
        ges.append(ge)
    return torch.stack(losses).mean(), torch.stack(ges), (w1, b1, w2)


def deepfm_chunk(torch, device, ids, params, labels, dtype=None):
    """One chunk from a fresh table (adagrad, seed 3, as the leg's): pull
    the K id sets, the dense chunk on `device` (in `dtype`, fp32 by
    default), push the K row-gradient sets in ordered pieces, pull the
    chunk's distinct ids back. Returns (rows after, loss, ges, weights)
    on the host."""
    from paddle_tpu_torch.distributed.ps.service import PsClient, PsServer
    dtype = dtype or torch.float32
    srv = PsServer(host='127.0.0.1')
    srv.add_table(0, dim=PS_DIM, optimizer='adagrad', seed=3)
    srv.start()
    client = PsClient([f'127.0.0.1:{srv.port}'], timeout=60)
    try:
        embs = np.stack([client.pull(0, f, PS_DIM) for f in ids])
        to = dict(device=device, dtype=dtype)
        loss, ges, ws = deepfm_dense_chunk(
            torch, torch.from_numpy(embs).to(**to),
            [torch.from_numpy(p).to(**to) for p in params],
            torch.from_numpy(labels).to(**to))
        ges_np = ges.float().cpu().numpy()
        for f, g in zip(ids, ges_np):
            for lo in range(0, len(f), PS_ORDERED_PUSH):
                client.push(0, f[lo:lo + PS_ORDERED_PUSH],
                            g[lo:lo + PS_ORDERED_PUSH], lr=PS_LR)
        after = client.pull(0, np.unique(ids), PS_DIM)
    finally:
        client.shutdown()
        client.close()
    return (after, float(loss), ges_np,
            [w.float().cpu().numpy() for w in ws])


def deepfm_ps_phase(torch, card, smi):
    """bench.py:412-548 with no cut: DeepFM over the real PS wire
    (PsServer, PsClient over localhost TCP, the adagrad table of seed 3),
    the dense chunk of K = 16 merged steps on the card in fp32 with
    torch autograd, overlapped through AsyncCommunicator(depth=2) over
    the bench's chunk adapter: 12 chunks cycling through 3 warmed
    distinct ones, best of 2, beside the un-overlapped pull, dense and
    push times a step (best of 2). The push thread reads each chunk's
    row gradients back from the card (the communicator's event path)."""
    import types
    from paddle_tpu_torch.distributed.ps.communicator import \
        AsyncCommunicator
    from paddle_tpu_torch.distributed.ps.service import PsClient, PsServer
    from paddle_tpu_torch.ops.kernels import _build

    dev = torch.device('cuda')
    K, dim = PS_K, PS_DIM
    distinct, stream, params, labels_np = deepfm_data()
    labels = torch.from_numpy(labels_np).to(dev)
    ws = [torch.from_numpy(p).to(dev) for p in params]
    _build.reset_launches()
    srv = PsServer().start()
    srv.add_table(0, dim=dim, optimizer='adagrad', seed=3)
    client = PsClient([f'127.0.0.1:{srv.port}'])

    def up(rows):
        return torch.from_numpy(rows).to(dev)

    # warm every distinct chunk's rows, then the un-overlapped parts
    for ch in distinct:
        for f in ch:
            client.pull(0, f, dim)
    flat0 = stream[-1]
    loss, ges, ws = deepfm_dense_chunk(
        torch, up(np.stack([client.pull(0, f, dim) for f in flat0])), ws,
        labels)
    ges.cpu()
    pull_ms = push_ms = dense_ms = float('inf')
    for _ in range(2):
        tp = time.perf_counter()
        pulled = [client.pull(0, f, dim) for f in flat0]
        pull_ms = min(pull_ms, (time.perf_counter() - tp) * 1e3 / K)
        td = time.perf_counter()
        loss, ges, ws = deepfm_dense_chunk(torch, up(np.stack(pulled)), ws,
                                           labels)
        ges_np = ges.cpu().numpy()
        dense_ms = min(dense_ms, (time.perf_counter() - td) * 1e3 / K)
        tu = time.perf_counter()
        for f, g in zip(flat0, ges_np):
            client.push(0, f, g, lr=PS_LR)
        push_ms = min(push_ms, (time.perf_counter() - tu) * 1e3 / K)

    chunk_client = types.SimpleNamespace(
        pull=lambda tid, ids, d: np.stack(
            [client.pull(tid, f, d) for f in ids]),
        push=lambda tid, ids, grads, lr: [
            client.push(tid, f, g, lr) for f, g in zip(ids, grads)])
    dt, losses = float('inf'), []
    for _ in range(2):
        comm = AsyncCommunicator(chunk_client, 0, dim, depth=2)
        batches = comm.pull_ahead(stream[:PS_CHUNKS])
        ids0, emb0 = next(batches)           # prime the pipeline
        t0 = time.perf_counter()
        done = 0
        for ids_t, emb_t in batches:
            loss, ges, ws = deepfm_dense_chunk(torch, up(emb0), ws, labels)
            comm.push_async(ids0, ges, lr=PS_LR)
            done += K
            ids0, emb0 = ids_t, emb_t
        loss, ges, ws = deepfm_dense_chunk(torch, up(emb0), ws, labels)
        comm.push_async(ids0, ges, lr=PS_LR)
        done += K
        comm.flush()
        losses.append(float(loss))
        dt = min(dt, (time.perf_counter() - t0) / done)
        comm.stop()
    launches = _build.routes_snapshot()
    rows = PS_B * PS_FIELDS
    out = {'steps_per_sec': 1.0 / dt, 'ms_per_step': dt * 1e3,
           'pull_ms': pull_ms, 'push_ms': push_ms, 'dense_ms': dense_ms,
           'merged_steps': K,
           'overlap_speedup': (pull_ms + push_ms + dense_ms) / (dt * 1e3),
           'rows_per_pull': rows,
           'pull_rows_per_sec': rows / (pull_ms / 1e3),
           'push_rows_per_sec': rows / (push_ms / 1e3),
           'table_rows': int(client.table_size(0))}
    client.shutdown()
    client.close()
    if not np.isfinite(losses).all() or out['table_rows'] <= 0:
        raise AssertionError(f'deepfm_ps: losses {losses}, {out}')
    emit({'phase': 'deepfm_ps', 'card': card, 'nvidia_smi': smi,
          'fields': PS_FIELDS, 'dim': dim, 'batch': PS_B,
          'chunks': PS_CHUNKS, 'depth': 2, 'dense': 'fp32 on the card',
          'last_losses': losses, **out})
    return launches


def deepfm_ps_check(torch):
    """What the CPU tests cannot see of deepfm_ps: (1) one chunk (pull,
    dense chunk, push) from a fresh table with the dense step on the card
    against the same chunk with it on the CPU, both fp32, over a second
    fresh table of the same seed: the rows pulled back within
    PS_ROWS_ATOL, the weights within WHOLE_PATH_RTOL; (2) a device_put
    through pinned memory on the communicator's copy stream lands rows
    equal to the host rows; (3) a gradient made on the card on a side
    stream behind a 20 ms spin, handed to push_async, lands on its table
    bit-equal to the same gradient pushed from the host."""
    from paddle_tpu_torch.distributed.ps.communicator import \
        AsyncCommunicator
    from paddle_tpu_torch.distributed.ps.service import PsClient, PsServer

    distinct, _stream, params, labels = deepfm_data()
    ids = distinct[0]
    card = deepfm_chunk(torch, 'cuda', ids, params, labels)
    cpu = deepfm_chunk(torch, 'cpu', ids, params, labels)
    rows_err = float(np.abs(card[0] - cpu[0]).max())
    w_err = max(_rel_np(a, b) for a, b in zip(card[3], cpu[3]))
    ges_err = _rel_np(card[2], cpu[2])
    chunk = {'distinct_ids': int(len(card[0])), 'rows_max_abs_err': rows_err,
             'rows_atol': PS_ROWS_ATOL, 'weights_rel_l2': w_err,
             'ges_rel_l2': ges_err, 'loss_card': card[1], 'loss_cpu': cpu[1]}
    if not (rows_err <= PS_ROWS_ATOL and w_err <= WHOLE_PATH_RTOL):
        raise AssertionError(f'deepfm_ps_check chunk: {chunk}')

    servers = []
    for _ in range(2):
        srv = PsServer(host='127.0.0.1')
        srv.add_table(0, dim=PS_DIM, optimizer='adagrad', seed=3)
        servers.append(srv.start())
    a, b = (PsClient([f'127.0.0.1:{s.port}'], timeout=60) for s in servers)
    try:
        comm = AsyncCommunicator(
            a, 0, PS_DIM, depth=2, device_put=lambda r: torch.from_numpy(
                r).pin_memory().to('cuda', non_blocking=True))
        uploads = 0
        for f, rows in comm.pull_ahead(list(ids[:4])):
            if not (rows.is_cuda and torch.equal(
                    (rows * 1).cpu(), torch.from_numpy(a.pull(0, f,
                                                              PS_DIM)))):
                raise AssertionError('deepfm_ps_check: device_put rows '
                                     'differ from the host rows')
            uploads += 1
        pieces = ids[:4, :PS_ORDERED_PUSH]
        g = np.random.RandomState(5).randn(*pieces.shape,
                                           PS_DIM).astype(np.float32)
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            g_dev = torch.empty(g.shape, device='cuda')
            torch.cuda._sleep(40_000_000)
            g_dev.copy_(torch.from_numpy(g).to('cuda'))
            for f, gf in zip(pieces, g_dev):
                comm.push_async(f, gf, lr=PS_LR)
        for f, gf in zip(pieces, g):
            b.push(0, f, gf, lr=PS_LR)
        comm.flush()
        comm.stop()
        flat = np.unique(pieces)
        pushed_equal = a.pull(0, flat, PS_DIM).tobytes() == b.pull(
            0, flat, PS_DIM).tobytes()
    finally:
        for c in (a, b):
            c.shutdown()
            c.close()
    if not pushed_equal:
        raise AssertionError('deepfm_ps_check: the card gradient handed to '
                             'push_async did not land as the host one')
    emit({'phase': 'deepfm_ps_check', 'chunk': chunk,
          'device_put_batches_equal': uploads,
          'cuda_push_rows_equal': int(len(flat))})


def _rel_np(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def ps_scale_ssd_phase(card, smi, total_rows, mem_budget_rows, dim,
                       batch_rows, batches):
    """bench.py:550-609 with no cut, host only by design: 2 M distinct
    rows over the wire against a 256 k-row budget of the SSD table (the
    spill logs under build/, removed after), then pull and push times of
    15 uniform batches of 13,312 ids over the whole id space, so most
    touches hit spilled rows. Fails when less than PS_MIN_SPILLED of the
    rows spilled."""
    import tempfile
    from paddle_tpu_torch.distributed.ps.service import PsClient, PsServer

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build')
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix='ps_scale_', dir=root)
    srv = PsServer().start()
    srv.add_table(0, dim=dim, optimizer='adagrad', seed=3,
                  ssd_path=tmp.name, mem_budget_rows=mem_budget_rows)
    client = PsClient([f'127.0.0.1:{srv.port}'])
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    seen, chunk = 0, 1 << 17
    while seen < total_rows:       # first-touch pulls insert; budget spills
        ids = np.arange(seen, min(seen + chunk, total_rows), dtype=np.int64)
        client.pull(0, ids, dim)
        seen += len(ids)
    build_s = time.perf_counter() - t0
    tbl = srv.tables[0]
    resident, total = int(tbl.mem_rows()), int(tbl.total_rows())
    t_pull = t_push = 0.0
    for _ in range(batches):
        ids = rng.randint(0, total_rows, batch_rows).astype(np.int64)
        tp = time.perf_counter()
        client.pull(0, ids, dim)
        t_pull += time.perf_counter() - tp
        g = rng.rand(batch_rows, dim).astype(np.float32) * 0.01
        tu = time.perf_counter()
        client.push(0, ids, g, lr=0.05)
        t_push += time.perf_counter() - tu
    out = {'table_rows': total, 'resident_rows': resident,
           'spilled_rows': total - resident,
           'spilled_frac': round(1 - resident / max(total, 1), 4),
           'mem_budget_rows': mem_budget_rows,
           'build_rows_per_sec': total_rows / build_s,
           'pull_ms': t_pull / batches * 1e3,
           'push_ms': t_push / batches * 1e3,
           'rows_per_batch': batch_rows,
           'pull_rows_per_sec': batch_rows / (t_pull / batches),
           'push_rows_per_sec': batch_rows / (t_push / batches)}
    client.shutdown()
    client.close()
    tmp.cleanup()
    if total != total_rows or out['spilled_frac'] < PS_MIN_SPILLED:
        raise AssertionError(f'ps_scale_ssd: {out}')
    emit({'phase': 'ps_scale_ssd', 'card': card, 'nvidia_smi': smi,
          'host_only': True, **out})


# ---------------------------------------------------------------------------
# the CTR training path (ROADMAP Queue 1 item 9b-2)
# ---------------------------------------------------------------------------
# the DeepFM leg's sizes (bench.py:429-441): 26 sparse fields, dim 8, batch
# 512, Pareto(1.2) x 1000 ids mod 10^7; Criteo's 13 dense floats a line;
# 64 steps a mode from 4 files; Wide&Deep's 40 geo steps
CTR_FIELDS, CTR_DIM, CTR_DENSE, CTR_B = 26, 8, 13, 512
CTR_STEPS, CTR_FILES, CTR_WD_STEPS, CTR_LR = 64, 4, 40, 5e-3
# the card-vs-CPU step: 32 rows, 832 ids a push, under the 1024 at which
# the table applies a push on 8 threads (PS_ORDERED_PUSH)
CTR_CHECK_B = 32
CTR_GEN = """import sys
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.distributed.fleet.data_generator import (
    MultiSlotDataGenerator)


class CriteoGen(MultiSlotDataGenerator):
    def generate_sample(self, line):
        def it():
            v = line.split()
            yield [('dense', [float(x) for x in v[1:{ids}]]),
                   ('ids', [int(x) for x in v[{ids}:]]),
                   ('label', [int(v[0])])]
        return it


if __name__ == '__main__':
    CriteoGen().run_from_stdin()
"""


def ctr_data(root, seed=0):
    """The generator script and CTR_FILES raw files of CTR_STEPS * CTR_B
    lines in all under `root`; a label is 1 when 15 or more of the 26
    ids are below 1000 (about half the lines), so the models can learn
    it. Returns (script, files, (ids, labels) of the first file)."""
    os.makedirs(root, exist_ok=True)
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(root, 'criteo_gen.py')
    with open(script, 'w') as f:
        f.write(CTR_GEN.format(repo=repo, ids=1 + CTR_DENSE))
    rng = np.random.RandomState(seed)
    n = CTR_STEPS * CTR_B // CTR_FILES
    fmt = ['%d'] + ['%.6f'] * CTR_DENSE + ['%d'] * CTR_FIELDS
    files, first = [], None
    for k in range(CTR_FILES):
        ids = (rng.pareto(1.2, (n, CTR_FIELDS)) * 1000).astype(
            np.int64) % (10 ** 7)
        dense = rng.rand(n, CTR_DENSE)
        labels = ((ids < 1000).sum(1) >= 15).astype(np.int64)
        path = os.path.join(root, f'part-{k}.txt')
        np.savetxt(path, np.column_stack([labels, dense, ids]), fmt=fmt)
        files.append(path)
        first = first or (ids, labels)
    return script, files, first


def ctr_slots():
    import types
    return [types.SimpleNamespace(shape=[CTR_DENSE], dtype='float32'),
            types.SimpleNamespace(shape=[CTR_FIELDS], dtype='int64'),
            types.SimpleNamespace(shape=[1], dtype='int64')]


class TimedTable:
    """A table that adds up the seconds and rows of its pulls and pushes
    (a push may run on the communicator's thread)."""

    def __init__(self, table):
        self.table = table
        self.pull_s = self.push_s = 0.0
        self.pulled = self.pushed = 0

    def pull(self, ids):
        t = time.perf_counter()
        out = self.table.pull(ids)
        self.pull_s += time.perf_counter() - t
        self.pulled += len(ids)
        return out

    def push(self, ids, grads, lr):
        t = time.perf_counter()
        self.table.push(ids, grads, lr)
        self.push_s += time.perf_counter() - t
        self.pushed += len(ids)

    def save(self, path):
        self.table.save(path)

    def __len__(self):
        return len(self.table)


def ctr_steps(torch, model, loss_fn, opt, batches, steps, tables, auc,
              sync_push):
    """`steps` train steps over `batches` (dense, ids, label host
    tensors), each timed from its batch in hand to its loss on the host.
    Returns the losses and the ms a step split into pull, push (on the
    step's clock when `sync_push`) and the rest (dense)."""
    losses, wall = [], 0.0
    marks = [(t.pull_s, t.push_s) for t in tables]
    for dense, ids, label in batches:
        t0 = time.perf_counter()
        logits = model(ids) if dense is None else model(ids, dense)
        loss = loss_fn(logits, label)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        wall += time.perf_counter() - t0
        auc.update(torch.sigmoid(logits.detach()).cpu().numpy()[:, 0],
                   label.numpy())
        if len(losses) == steps:
            break
    if len(losses) != steps:
        raise AssertionError(f'ctr_ps: {len(losses)} batches, want {steps}')
    pull = sum(t.pull_s - m[0] for t, m in zip(tables, marks))
    push = sum(t.push_s - m[1] for t, m in zip(tables, marks))
    dense_s = wall - pull - (push if sync_push else 0.0)
    return losses, {'steps': steps, 'ms_per_step': wall * 1e3 / steps,
                    'pull_ms': pull * 1e3 / steps,
                    'push_ms': push * 1e3 / steps,
                    'push_on_step_clock': sync_push,
                    'dense_ms': dense_s * 1e3 / steps,
                    'loss_first': losses[0], 'loss_last': losses[-1]}


def ctr_ps_phase(torch, card, smi):
    """The CTR path through its entry points (see the module docstring):
    DeepFM sync then async from a QueueDataset, Wide&Deep geo from an
    InMemoryDataset, the AUC, and the exact launch count. Returns (the
    launches, what ctr_ps_check needs)."""
    from paddle_tpu_torch import metric
    from paddle_tpu_torch.distributed import InMemoryDataset, QueueDataset
    from paddle_tpu_torch.distributed.fleet import metrics as fleet_metrics
    from paddle_tpu_torch.distributed.ps.embedding import \
        DistributedEmbedding
    from paddle_tpu_torch.models import DeepFM, WideDeep, deepfm_loss
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import Adam

    dev = torch.device('cuda')
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                        'ctr_ps')
    t0 = time.perf_counter()
    script, files, first = ctr_data(root)
    data_s = time.perf_counter() - t0
    pipe = f'{sys.executable} {script}'

    def dataset(cls):
        ds = cls()
        ds.init(batch_size=CTR_B, thread_num=2, use_var=ctr_slots(),
                pipe_command=pipe)
        ds.set_filelist(files)
        return ds

    def no_dense(batches):
        for _dense, ids, label in batches:
            yield None, ids, label

    def label_loss(logits, label):
        return deepfm_loss(logits, label.to(dev, non_blocking=True))

    _build.reset_launches()
    model = DeepFM(fields=CTR_FIELDS, embed_dim=CTR_DIM, hidden=(32, 16),
                   use_ps=True, generator=torch.Generator(
                       device='cuda').manual_seed(22))
    opt = Adam(learning_rate=CTR_LR, parameters=model.parameters())
    auc = metric.Auc()
    timed = {}
    for name in ('embedding', 'linear_embedding'):
        layer = getattr(model, name)
        layer.table = timed[name] = TimedTable(layer.table)
    t0 = time.perf_counter()
    losses, sync = ctr_steps(torch, model, label_loss, opt,
                             no_dense(dataset(QueueDataset)), CTR_STEPS,
                             list(timed.values()), auc, sync_push=True)
    sync['wall_s'] = time.perf_counter() - t0
    sync['table_rows'] = {n: len(t) for n, t in timed.items()}
    # the same tables, saved and loaded into async layers
    tables = {}
    for name, table in timed.items():
        tables[name] = os.path.join(root, f'{name}.table')
        table.save(tables[name])
        layer = DistributedEmbedding(getattr(model, name).embedding_dim,
                                     a_sync=True)
        layer.load(tables[name])
        layer.table = timed[name] = TimedTable(layer.table)
        setattr(model, name, layer)
    t0 = time.perf_counter()
    more, a_sync = ctr_steps(torch, model, label_loss, opt,
                             no_dense(dataset(QueueDataset)), CTR_STEPS,
                             list(timed.values()), auc, sync_push=False)
    model.embedding.flush()
    a_sync['wall_s'] = time.perf_counter() - t0
    a_sync['table_rows'] = {n: len(t) for n, t in timed.items()}
    losses += more
    auc_buckets = fleet_metrics.auc(auc._stat_pos, auc._stat_neg)

    wd = WideDeep(sparse_feature_dim=16, num_sparse_slots=CTR_FIELDS,
                  dense_dim=CTR_DENSE, hidden_sizes=(64, 32), mode='geo',
                  geo_k=10, generator=torch.Generator(
                      device='cuda').manual_seed(23))
    wd_opt = Adam(learning_rate=CTR_LR, parameters=wd.parameters())
    t0 = time.perf_counter()
    mem = dataset(InMemoryDataset)
    mem.load_into_memory()
    mem.local_shuffle()
    load_s = time.perf_counter() - t0
    geo, remote = [], []
    for layer in (wd.embedding, wd.wide_embedding):
        layer.table.remote = TimedTable(layer.table.remote)
        remote.append(layer.table.remote)
        layer.table = TimedTable(layer.table)
        geo.append(layer.table)
    wd_losses, geo_rec = ctr_steps(
        torch, wd, lambda lg, y: wd.loss(lg, y.to(dev, non_blocking=True)),
        wd_opt, iter(mem), CTR_WD_STEPS, geo, metric.Auc(), sync_push=True)
    geo_rec.update(load_into_memory_s=load_s,
                   memory_lines=mem.get_memory_data_size(),
                   rows_synced=[r.pushed for r in remote],
                   syncs=CTR_WD_STEPS // 10,
                   base_rows=[len(r) for r in remote])
    torch.cuda.synchronize()
    launches = _build.routes_snapshot()
    adam_steps = 2 * CTR_STEPS + CTR_WD_STEPS
    want = {n: adam_steps if n == 'optimizer_step' else 0 for n in launches}
    emit({'phase': 'ctr_ps', 'card': card, 'nvidia_smi': smi,
          'fields': CTR_FIELDS, 'dim': CTR_DIM, 'dense': CTR_DENSE,
          'batch': CTR_B, 'files': CTR_FILES,
          'lines': CTR_STEPS * CTR_B, 'write_data_s': data_s,
          'deepfm': {'sync': sync, 'async': a_sync,
                     'auc_fleet_metrics': auc_buckets,
                     'auc_metric': auc.accumulate()},
          'wide_deep_geo': geo_rec, 'adam_steps': adam_steps,
          'launches': {n: c for n, c in launches.items() if c}})
    check_exact_launches('ctr_ps', launches, want)
    # DeepFM learns the ids' rule within its 128 steps; Wide&Deep's 40
    # (sgd wide weights, adagrad rows at the mean loss's small
    # gradients) barely move its loss, so it is held finite only
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and np.isfinite(wd_losses).all()):
        raise AssertionError(f'ctr_ps: deepfm losses {losses[0]} .. '
                             f'{losses[-1]}, wide_deep {wd_losses[0]} .. '
                             f'{wd_losses[-1]}')
    if not 0.5 < auc_buckets <= 1.0 or min(sync['table_rows'].values()) <= 0:
        raise AssertionError(f'ctr_ps: auc {auc_buckets}, {sync}')
    dense = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return launches, dict(dense=dense, tables=tables, batch=first)


def ctr_ps_check(torch, state):
    """One DeepFM step (CTR_CHECK_B rows of the first file) on the card
    and on the CPU from ctr_ps's trained dense weights and table files,
    both fp32 (TF32 off): the logits and the weights after the Adam step
    within WHOLE_PATH_RTOL relative L2, the pushed rows of both tables
    within PS_ROWS_ATOL."""
    from paddle_tpu_torch.models import DeepFM, deepfm_loss
    from paddle_tpu_torch.optimizer import Adam

    ids, labels = state['batch']
    ids = torch.from_numpy(ids[:CTR_CHECK_B].copy())
    labels = torch.from_numpy(labels[:CTR_CHECK_B, None].copy())
    flat = np.unique(ids.numpy())
    out = {}
    for device in ('cuda', 'cpu'):
        m = DeepFM(fields=CTR_FIELDS, embed_dim=CTR_DIM, hidden=(32, 16),
                   use_ps=True, device=device)
        m.load_state_dict(state['dense'])
        for name, path in state['tables'].items():
            getattr(m, name).load(path)
        opt = Adam(learning_rate=CTR_LR, parameters=m.parameters())
        logits = m(ids)
        deepfm_loss(logits, labels.to(device)).backward()
        opt.step()
        out[device] = dict(
            logits=logits.detach().cpu().numpy(),
            weights={k: v.detach().cpu().numpy()
                     for k, v in m.state_dict().items()},
            rows={n: getattr(m, n).table.pull(flat)
                  for n in state['tables']})
    card, cpu = out['cuda'], out['cpu']
    rec = {'batch': CTR_CHECK_B, 'distinct_ids': int(len(flat)),
           'logits_rel_l2': _rel_np(card['logits'], cpu['logits']),
           'weights_rel_l2': max(_rel_np(card['weights'][k], v)
                                 for k, v in cpu['weights'].items()),
           'rows_max_abs_err': {n: float(np.abs(card['rows'][n]
                                                - cpu['rows'][n]).max())
                                for n in cpu['rows']},
           'rtol': WHOLE_PATH_RTOL, 'rows_atol': PS_ROWS_ATOL}
    if not (rec['logits_rel_l2'] <= WHOLE_PATH_RTOL
            and rec['weights_rel_l2'] <= WHOLE_PATH_RTOL
            and max(rec['rows_max_abs_err'].values()) <= PS_ROWS_ATOL):
        raise AssertionError(f'ctr_ps_check: {rec}')
    emit({'phase': 'ctr_ps_check', **rec})


# the port's kernels by the device-side names the profiler shows (a name
# holds one of the row's strings); the column sum is the second pass of
# both backward reductions, the merge kernel the paged attention's; the
# LayerNorm forward has a register body and a shared-memory one
KERNEL_NAMES = {'paged_attention_int8': (
                    'ragged_paged_attention_kernel<__nv_bfloat16, signed char',
                    'ragged_paged_attention_merge_kernel<__nv_bfloat16, '
                    'signed char'),
                'paged_attention': ('ragged_paged_attention_kernel',
                                    'ragged_paged_attention_merge_kernel'),
                'layer_norm': ('layer_norm_fwd_',),
                'bias_gelu': ('bias_gelu_fwd_kernel',),
                'layer_norm_bwd': ('layer_norm_bwd_kernel',),
                'bias_gelu_bwd': ('bias_gelu_bwd_kernel',),
                'column_sum': ('column_sum_kernel',),
                'flash_fwd': ('flash_fwd_kernel',),
                'flash_bwd_dq': ('flash_bwd_dq_kernel',),
                'flash_bwd_dkv': ('flash_bwd_dkv_kernel',),
                'flash_bhld_fwd': ('flash_bhld_fwd_kernel',),
                'flash_bhld_bwd_dq': ('flash_bhld_bwd_dq_kernel',),
                'flash_bhld_bwd_dkv': ('flash_bhld_bwd_dkv_kernel',),
                'dropout_add': ('dropout_add_fwd_kernel',),
                'dropout_add_bwd': ('dropout_add_bwd_kernel',),
                'grad_stats': ('grad_stats_kernel',),
                'optimizer_step': ('update_kernel',)}


def _kernel_group(key):
    """(group, port kernel or None) of a device kernel's name: a port
    kernel (the gradient statistics a group of their own), a GEMM, or
    other."""
    name = next((n for n, parts in KERNEL_NAMES.items()
                 if any(part in key for part in parts)), None)
    if name is not None:
        return ('grad_stats' if name == 'grad_stats' else 'port_kernels',
                name)
    if any(k in key.lower() for k in ('gemm', 'xmma', 'cutlass', 'nvjet',
                                      'sm90')):
        return 'gemm', None
    return 'other', None


def _group_device_time(kernels):
    """Device seconds of profiler events by group (the port's kernels,
    the gradient statistics apart from them, GEMMs, other) and by port
    kernel."""
    groups = {'port_kernels': 0.0, 'grad_stats': 0.0, 'gemm': 0.0,
              'other': 0.0}
    port = {}
    for e in kernels:
        t = e.self_device_time_total / 1e6
        group, name = _kernel_group(e.key)
        groups[group] += t
        if name is not None:
            port[name] = port.get(name, 0.0) + t
    return groups, port


def _split_other(events, update_range, head_range):
    """The "other" group's device seconds split by where each kernel was
    launched: inside the per-parameter update (optimizer elementwise),
    the LM head's cross-entropy (its forward, under the head's range
    less its GEMM and LayerNorm, and its backward `_HardXentBackward`),
    a copy or cast anywhere else, or the rest. Each CPU op event carries
    the kernels it launched; its parents name the ranges around it."""
    split = dict.fromkeys(('optimizer', 'cross_entropy', 'casts_copies',
                           'rest'), 0.0)
    for e in events:
        if not e.kernels:
            continue
        names, p = [], e
        while p is not None:
            names.append(p.name)
            p = p.cpu_parent
        where = 'optimizer' if update_range in names else (
            'cross_entropy' if head_range in names
            or any('_HardXentBackward' in n or '_LinearXentBackward' in n
                   for n in names) else None)
        for k in e.kernels:
            if _kernel_group(k.name)[0] != 'other':
                continue
            low = k.name.lower()
            group = where or ('casts_copies' if 'copy' in low
                              or 'cast' in low else 'rest')
            split[group] += k.duration / 1e6
    return split


def profile_phase(torch, eng, prompts):
    """Where the serve's time goes: the same 8-request stream (16 new
    tokens each) once unprofiled and once under torch.profiler; device
    busy time is the sum of the CUDA kernels' self time in the trace.
    The profiler slows the host, so the busy share is given against
    both walls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    # the engine's serve::* ranges also show as device-side annotations
    # spanning their kernels: they are no kernels of their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith('serve::')]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    groups, port = _group_device_time(kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # the engine's serve::* RecordEvent ranges, host ms by phase
    ranges = {}
    for e in prof.events():
        if e.name.startswith('serve::') and e.device_type == DeviceType.CPU:
            r = ranges.setdefault(e.name, dict(calls=0, cpu_ms=0.0))
            r['calls'] += 1
            r['cpu_ms'] += e.cpu_time_total / 1e3
    emit({'phase': 'profile', 'requests': len(prompts), 'max_new_tokens': 16,
          'serve_ranges': ranges,
          'wall_s': wall_plain, 'wall_profiled_s': wall_prof,
          'device_busy_s': busy if kernels else None,
          'busy_share_of_wall': busy / wall_plain if kernels else None,
          'busy_share_of_profiled_wall':
              busy / wall_prof if kernels else None,
          'device_s_by_group': groups, 'device_s_by_port_kernel': port,
          'top_kernels': [dict(name=e.key[:90],
                               device_ms=e.self_device_time_total / 1e3,
                               calls=e.count) for e in top]})


# ---------------------------------------------------------------------------
# the op surface: the registry sweep, surface_train and
# conv_layouts
# ---------------------------------------------------------------------------
# the sweep's bars: |card - cpu| <= atol + rtol * |cpu| per element, atol a
# multiple of the CPU block's largest |value| (sums and products of
# thousands of terms have no fixed magnitude). fp32: the round's bar
# (summation order); bf16: the card's bf16 result against the CPU's fp32
# op on the same bf16 inputs (rounded once on the card, a few times in a
# bf16 backward); linalg: fp32 factorisations of 512 x 512 matrices, whose
# conditioning sets the error. torch's bf16 scans (cumsum, cumprod,
# logcumsumexp) round every partial result to bf16: over a row of 2048 that
# is a random walk of 2048 roundings of 2^-9 (3.8 % of a row's largest
# |sum|, 25 % of a product on an H100), so in bf16 they scan the 8-long
# axis, bf16_scan bounding 8 roundings; bf16_exp: a bf16 backward that
# takes exp of a bf16-rounded difference x - lse (logsumexp,
# logcumsumexp), 2^-9 of |x - lse| up to ~8 in the exponent
SWEEP_BARS = {'fp32': (2e-4, 2e-5), 'bf16': (2.0 ** -6, 2.0 ** -6),
              'linalg': (2e-3, 2e-4), 'fft': (2e-4, 2e-5),
              'bf16_scan': (2.0 ** -4, 2.0 ** -4),
              'bf16_exp': (2.0 ** -4, 2.0 ** -4)}
SWEEP_BIG = (8, 2048, 2048)          # one gpt_1p3b activation, B=8 L=2048
SWEEP_BLOCK = 64                     # rows of the CPU's row block
SWEEP_VOCAB, SWEEP_IDS = (50304, 2048), 16384
SWEEP_LINALG = (64, 512, 512)
SWEEP_FFT = (16384, 2048)
SWEEP_XENT = (4096, 50304)
SWEEP_LOSS = (16384, 2048)
SWEEP_CTC = dict(T=256, B=64, C=32, S=64)
# where the sweep's "card" side runs: the card; a CPU dry run of the sweep
# at small shapes (a throwaway driver) sets 'cpu'
SURFACE_DEVICE = 'cuda'
SURFACE_TRAIN = dict(B=128, hw=224, steps=8, check_B=4, check_hw=64,
                     check_rtol=1e-3, check_zero_rtol=1e-3)
# the conv_layouts shapes: ResNet-50's first-stage 3x3 and 1x1 convolutions,
# its stem pool, and a grouped 4x4/2 transposed convolution
CONV_LAYOUTS = {
    'conv3x3_64': dict(x=(128, 64, 56, 56), w=(64, 64, 3, 3), stride=1,
                       padding=1),
    'conv1x1_256_64': dict(x=(128, 256, 56, 56), w=(64, 256, 1, 1),
                           stride=1, padding=0),
    'max_pool_3x3_s2': dict(x=(128, 64, 112, 112), kernel=3, stride=2,
                            padding=1),
    'conv_transpose_4x4_s2_g2': dict(x=(128, 64, 28, 28), w=(64, 32, 4, 4),
                                     stride=2, padding=1, groups=2),
}
CONV_LAYOUT_BARS = {'bf16': 1e-2, 'fp32': 1e-5}


def _flat_tensors(torch, out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat_tensors(torch, o)]
    return []


def _sweep_close(torch, got, want, bar, what):
    """Max |got - want| over (atol·max|want| + rtol·|want|), exact for
    bool and integer results; raises when a result is off the bar."""
    if got.shape != want.shape:
        raise AssertionError(f'surface {what}: shape {tuple(got.shape)} '
                             f'against {tuple(want.shape)}')
    if not (got.is_floating_point() or got.is_complex()):
        if not torch.equal(got, want.to(got.dtype)):
            raise AssertionError(f'surface {what}: not equal')
        return 0.0
    got = got.to(torch.complex128 if got.is_complex() else torch.float64)
    want = want.to(got.dtype)
    if not want.numel():
        return 0.0
    rtol, atol = bar
    scale = float(want.abs().max()) or 1.0
    err = (got - want).abs()
    ratio = float((err / (atol * scale + rtol * want.abs())).max())
    if not ratio <= 1.0:
        raise AssertionError(f'surface {what}: max err {float(err.max())} '
                             f'beyond the bar ({ratio:.3g} of it)')
    return float(err.max()) / scale


class SurfaceCase:
    """One registry op on the card against the CPU: `make(gen)` builds
    the card inputs (positional, any kind) from a card generator; `grad`
    lists the inputs the VJP differentiates; `block` cuts a row block of
    every tensor (inputs, outputs, gradients) for a row-wise op, which
    the CPU then recomputes alone (None: the CPU runs the whole op);
    `dtypes` the float dtypes it runs in; `compare` picks the results
    compared (all by default; a decomposition compares reconstructions)."""

    def __init__(self, name, fn, make, kw=None, grad=(), block=None,
                 dtypes=('fp32',), family='elementwise', compare=None,
                 bar=None, values_only_bf16=False):
        self.name, self.fn, self.make, self.kw = name, fn, make, kw or {}
        self.grad, self.block, self.dtypes = tuple(grad), block, dtypes
        self.family, self.compare, self.bar = family, compare, bar
        self.values_only_bf16 = values_only_bf16


def _rows(t):
    """The CPU's row block of a [8, L, N] tensor (or of a result that
    keeps its two leading axes): the first sequence's first rows."""
    return t[:1, :SWEEP_BLOCK] if t.dim() >= 2 else t


def _cols(t):
    """The row block of a [8, L, N] tensor across all 8 sequences (for a
    scan along the first axis)."""
    return t[:, :SWEEP_BLOCK] if t.dim() >= 2 else t


def _lead_rows(t):
    return t[:SWEEP_BLOCK] if t.dim() >= 1 else t


def _two(t):
    """The first two matrices of the linalg batch (and of every result
    that keeps its batch axis)."""
    return t[:2] if t.dim() >= 1 and t.shape[0] == SWEEP_LINALG[0] else t


def _cut(torch, v, block):
    if isinstance(v, torch.Tensor):
        return block(v)
    if isinstance(v, (tuple, list)):
        return type(v)(_cut(torch, x, block) for x in v)
    return v


def _to(torch, v, dev, dtype=None):
    if isinstance(v, torch.Tensor):
        out = v.detach().to(dev)
        if dtype is not None and out.is_floating_point():
            out = out.to(dtype)
        return out
    if isinstance(v, (tuple, list)):
        return type(v)(_to(torch, x, dev, dtype) for x in v)
    return v


def run_surface_case(torch, case, dtype_name, gen):
    """The case's forward and VJP on the card, the same on CPU copies
    (of its row block when it has one); returns the largest relative
    error."""
    dtype = torch.bfloat16 if dtype_name == 'bf16' else torch.float32
    inputs = _to(torch, case.make(gen), SURFACE_DEVICE, dtype)
    grads = case.grad
    if grads == ('all',):
        grads = tuple(i for i, t in enumerate(inputs)
                      if isinstance(t, torch.Tensor) and t.is_floating_point())
    if dtype_name == 'bf16' and case.values_only_bf16:
        grads = ()      # ties: the two sides may pick different elements
    for i in grads:
        inputs[i] = inputs[i].detach().requires_grad_(True)
    out = case.fn(*inputs, **case.kw)
    outs = _flat_tensors(torch, out)
    for t in outs:
        if t.device.type != torch.device(SURFACE_DEVICE).type:
            raise AssertionError(f'surface {case.name}: a result on '
                                 f'{t.device}')
    cot = None
    if grads:
        cot = torch.randn(outs[0].shape, device=SURFACE_DEVICE, generator=gen,
                          dtype=torch.float32).to(outs[0].dtype)
        outs[0].backward(cot)
    block = case.block or (lambda t: t)
    cpu_in = _to(torch, _cut(torch, inputs, block), 'cpu')
    if dtype_name == 'bf16':
        cpu_in = _to(torch, cpu_in, 'cpu', torch.float32)
    for i in grads:
        cpu_in[i] = cpu_in[i].detach().requires_grad_(True)
    cpu_out = case.fn(*cpu_in, **case.kw)
    bar = case.bar.get(dtype_name) if isinstance(case.bar, dict) \
        else case.bar
    bar = bar or SWEEP_BARS[dtype_name]
    pick = case.compare or (lambda r, ins: _flat_tensors(torch, r))
    got = [block(t) for t in pick(out, inputs)]
    want = pick(cpu_out, cpu_in)
    if dtype_name == 'bf16' and case.values_only_bf16:
        got = [t for t in got if t.is_floating_point()]
        want = [t for t in want if t.is_floating_point()]
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        err = max(err, _sweep_close(torch, g.detach().cpu(), w.detach(), bar,
                                    f'{case.name} {dtype_name} out {k}'))
    if grads:
        cpu_outs = _flat_tensors(torch, cpu_out)
        cpu_outs[0].backward(block(cot).cpu().to(cpu_outs[0].dtype))
        for i in grads:
            err = max(err, _sweep_close(
                torch, block(inputs[i].grad).cpu(), cpu_in[i].grad, bar,
                f'{case.name} {dtype_name} grad {i}'))
    return err


def surface_cases(torch):
    """Every op of the port's registry (ops/common.py OP_REGISTRY) and
    every loss, with its inputs at the sweep's shapes."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import creation as C
    from paddle_tpu_torch.ops import fft as FF
    from paddle_tpu_torch.ops import linalg as LA
    from paddle_tpu_torch.ops import manip as MA
    from paddle_tpu_torch.ops import math as M
    from paddle_tpu_torch.ops import nn_ops as NN

    def big(gen, low=None):
        x = torch.randn(SWEEP_BIG, device=SURFACE_DEVICE, generator=gen)
        return x if low is None else low(x)

    def pos(x):
        return x.abs() + 0.5

    def unit(x):
        return torch.tanh(x) * 0.9

    def near_one(x):
        return 1.0 + 0.01 * torch.tanh(x)

    def ints(gen, shape, high):
        return torch.randint(0, high, shape, device=SURFACE_DEVICE, generator=gen,
                             dtype=torch.int32)

    cases = []
    add = cases.append
    both = ('fp32', 'bf16')
    domains = {'log': pos, 'log2': pos, 'log10': pos, 'log1p': pos,
               'sqrt': pos, 'rsqrt': pos, 'reciprocal': pos, 'lgamma': pos,
               'digamma': pos, 'tan': unit, 'asin': unit, 'acos': unit,
               'atanh': unit, 'acosh': lambda x: x.abs() + 1.5}
    for n in ('exp', 'expm1', 'log', 'log2', 'log10', 'log1p', 'sqrt',
              'rsqrt', 'square', 'abs', 'sign', 'floor', 'ceil', 'round',
              'trunc', 'reciprocal', 'neg', 'sin', 'cos', 'tan', 'asin',
              'acos', 'atan', 'sinh', 'cosh', 'tanh', 'asinh', 'acosh',
              'atanh', 'sigmoid', 'erf', 'lgamma', 'digamma', 'frac',
              'rad2deg', 'deg2rad', 'stanh', 'nan_to_num', 'assign'):
        low = domains.get(n)
        add(SurfaceCase(n, getattr(M, n),
                        lambda g, low=low: [big(g, low)], grad=(0,),
                        block=_rows, dtypes=both))
    for n, kw in (('scale', dict(scale=2.5, bias=0.5)),
                  ('clip', dict(min=-0.5, max=0.7)),
                  ('increment', dict(value=2.0))):
        add(SurfaceCase(n, getattr(M, n), lambda g: [big(g)], kw, grad=(0,),
                        block=_rows, dtypes=both))
    for n in ('add', 'subtract', 'multiply', 'maximum', 'minimum', 'fmax',
              'fmin', 'atan2', 'hypot', 'remainder', 'multiply_', 'divide',
              'pow', 'floor_divide', 'heaviside'):
        grad = () if n in ('floor_divide', 'heaviside') else (0, 1)
        low = pos if n in ('divide', 'pow', 'floor_divide') else None
        add(SurfaceCase(n, getattr(M, n),
                        lambda g, low=low: [big(g, low), big(g, low)],
                        grad=grad, block=_rows, dtypes=both))
    add(SurfaceCase('lerp', M.lerp, lambda g: [big(g), big(g), 0.3],
                    grad=(0, 1), block=_rows, dtypes=both))
    for n in ('equal', 'not_equal', 'less_than', 'less_equal',
              'greater_than', 'greater_equal', 'isclose'):
        add(SurfaceCase(n, getattr(M, n),
                        lambda g: [big(g), big(g).round()], block=_rows,
                        dtypes=both, family='comparison'))
    for n in ('isnan', 'isinf', 'isfinite'):
        add(SurfaceCase(n, getattr(M, n), lambda g: [big(g).log()],
                        block=_rows, dtypes=both, family='comparison'))
    for n in ('logical_and', 'logical_or', 'logical_xor'):
        add(SurfaceCase(n, getattr(M, n),
                        lambda g: [big(g) > 0, big(g) > 0.5], block=_rows,
                        family='comparison'))
    add(SurfaceCase('logical_not', M.logical_not, lambda g: [big(g) > 0],
                    block=_rows, family='comparison'))
    for n in ('bitwise_and', 'bitwise_or', 'bitwise_xor', 'gcd', 'lcm'):
        add(SurfaceCase(n, getattr(M, n),
                        lambda g: [ints(g, SWEEP_BIG, 1024),
                                   ints(g, SWEEP_BIG, 1024)],
                        block=_rows, family='comparison'))
    add(SurfaceCase('bitwise_not', M.bitwise_not,
                    lambda g: [ints(g, SWEEP_BIG, 1024)], block=_rows,
                    family='comparison'))
    for n in ('equal_all', 'allclose'):
        add(SurfaceCase(n, getattr(M, n), lambda g: [big(g)[0]] * 2,
                        family='comparison'))
    # reductions and cumulative ops along the last axis (row-wise)
    for n in ('sum', 'mean', 'max', 'min', 'amax', 'amin', 'nansum',
              'nanmean', 'logsumexp', 'std', 'var'):
        add(SurfaceCase(n, getattr(M, n), lambda g: [big(g)],
                        dict(axis=-1), grad=(0,), block=_rows, dtypes=both,
                        family='reduction', bar={
                            'bf16': SWEEP_BARS['bf16_exp']}
                        if n == 'logsumexp' else None))
    add(SurfaceCase('prod', M.prod, lambda g: [big(g, near_one)],
                    dict(axis=-1), grad=(0,), block=_rows, dtypes=both,
                    family='reduction'))
    for n, low, ax in (('cumprod', near_one, 'dim'), ('cumsum', None, 'axis'),
                       ('cumsum_', None, 'axis'),
                       ('logcumsumexp', None, 'axis')):
        add(SurfaceCase(n, getattr(M, n), lambda g, low=low: [big(g, low)],
                        {ax: -1}, grad=(0,), block=_rows,
                        family='cumulative'))
        add(SurfaceCase(f'{n}-axis0', getattr(M, n),
                        lambda g, low=low: [big(g, low)], {ax: 0},
                        grad=(0,), block=_cols, dtypes=('bf16',),
                        family='cumulative', bar={'bf16': SWEEP_BARS[
                            'bf16_exp' if n == 'logcumsumexp'
                            else 'bf16_scan']}))
    for n in ('all', 'any'):
        add(SurfaceCase(n, getattr(M, n), lambda g: [big(g) > -2.5],
                        dict(axis=-1), block=_rows, family='reduction'))
    add(SurfaceCase('count_nonzero', M.count_nonzero,
                    lambda g: [big(g).round()], dict(axis=-1), block=_rows,
                    family='reduction'))
    add(SurfaceCase('norm', M.norm, lambda g: [big(g)],
                    dict(p=2, axis=-1), grad=(0,), block=_rows,
                    dtypes=both, family='reduction'))
    # sorting along the last axis (distinct fp32 values; bf16 has ties,
    # so its index results are not compared)
    for n, kw, grad in (('sort', {}, (0,)), ('argsort', {}, ()),
                        ('topk', dict(k=8), (0,)),
                        ('median', dict(axis=-1), (0,)),
                        ('quantile', dict(q=0.3, axis=-1), (0,)),
                        ('argmax', dict(axis=-1), ()),
                        ('argmin', dict(axis=-1), ())):
        add(SurfaceCase(n, getattr(M, n), lambda g: [big(g)], kw,
                        grad=grad, block=_rows,
                        dtypes=('fp32',) if n.startswith('arg') else both,
                        family='sort', values_only_bf16=True))
    add(SurfaceCase('mode', M.mode, lambda g: [ints(g, SWEEP_BIG, 64)
                                               .float()],
                    block=_rows, family='sort'))
    add(SurfaceCase('unique', MA.unique,
                    lambda g: [ints(g, (1 << 22,), 1 << 16)],
                    dict(return_index=True, return_inverse=True,
                         return_counts=True), family='sort'))
    add(SurfaceCase('unique_consecutive', MA.unique_consecutive,
                    lambda g: [ints(g, (1 << 22,), 4).sort().values],
                    dict(return_inverse=True, return_counts=True),
                    family='sort'))
    # gather and scatter over the GPT vocabulary table
    vocab = lambda g: torch.randn(SWEEP_VOCAB, device=SURFACE_DEVICE, generator=g)
    ids = lambda g: torch.randint(0, SWEEP_VOCAB[0], (SWEEP_IDS,),
                                  device=SURFACE_DEVICE, generator=g)
    uniq = lambda g: torch.randperm(SWEEP_VOCAB[0], device=SURFACE_DEVICE,
                                    generator=g)[:SWEEP_IDS]
    for n in ('gather', 'index_select'):
        add(SurfaceCase(n, getattr(MA, n), lambda g: [vocab(g), ids(g)],
                        grad=(0,), family='index'))
    add(SurfaceCase('scatter', MA.scatter,
                    lambda g: [vocab(g), uniq(g),
                               torch.randn(SWEEP_IDS, SWEEP_VOCAB[1],
                                           device=SURFACE_DEVICE, generator=g)],
                    grad=(0, 2), family='index'))
    add(SurfaceCase('scatter-add', MA.scatter,
                    lambda g: [vocab(g), ids(g),
                               torch.randn(SWEEP_IDS, SWEEP_VOCAB[1],
                                           device=SURFACE_DEVICE, generator=g)],
                    dict(overwrite=False), grad=(0, 2), family='index'))
    mid = lambda g: torch.randn(512, 2048, device=SURFACE_DEVICE, generator=g)
    add(SurfaceCase('take_along_axis', MA.take_along_axis,
                    lambda g: [mid(g), torch.randint(0, 2048, (512, 64),
                                                     device=SURFACE_DEVICE,
                                                     generator=g)],
                    dict(axis=1), grad=(0,), family='index'))
    add(SurfaceCase('put_along_axis', MA.put_along_axis,
                    lambda g: [mid(g), torch.randperm(2048, device=SURFACE_DEVICE,
                                                      generator=g)[:64]
                               .expand(512, 64),
                               torch.randn(512, 64, device=SURFACE_DEVICE,
                                           generator=g)],
                    dict(axis=1), grad=(0,), family='index'))
    add(SurfaceCase('index_sample', MA.index_sample,
                    lambda g: [mid(g), torch.randint(0, 2048, (512, 64),
                                                     device=SURFACE_DEVICE,
                                                     generator=g)],
                    grad=(0,), family='index'))
    add(SurfaceCase('gather_nd', MA.gather_nd,
                    lambda g: [mid(g), torch.randint(0, 512, (4096, 1),
                                                     device=SURFACE_DEVICE,
                                                     generator=g)],
                    grad=(0,), family='index'))
    add(SurfaceCase('scatter_nd_add', MA.scatter_nd_add,
                    lambda g: [mid(g), torch.randint(0, 512, (4096, 1),
                                                     device=SURFACE_DEVICE,
                                                     generator=g),
                               torch.randn(4096, 2048, device=SURFACE_DEVICE,
                                           generator=g)],
                    grad=(0, 2), family='index'))
    add(SurfaceCase('scatter_nd', MA.scatter_nd,
                    lambda g: [torch.randint(0, 512, (4096, 1),
                                             device=SURFACE_DEVICE, generator=g),
                               torch.randn(4096, 2048, device=SURFACE_DEVICE,
                                           generator=g), [512, 2048]],
                    grad=(1,), family='index'))
    add(SurfaceCase('masked_select', MA.masked_select,
                    lambda g: [mid(g), mid(g) > 0], grad=(0,),
                    family='index'))
    add(SurfaceCase('masked_fill', MA.masked_fill,
                    lambda g: [mid(g), mid(g) > 0], dict(value=2.5),
                    grad=(0,), family='index'))
    add(SurfaceCase('take', M.take, lambda g: [mid(g), torch.randint(
        0, 512 * 2048, (8192,), device=SURFACE_DEVICE, generator=g)], grad=(0,),
        family='index'))
    add(SurfaceCase('nonzero', M.nonzero, lambda g: [mid(g).round()],
                    family='index'))
    add(SurfaceCase('where', M.where, lambda g: [mid(g) > 0, mid(g),
                                                 mid(g)], grad=(1, 2),
                    family='index'))
    add(SurfaceCase('multiplex', M.multiplex,
                    lambda g: [[mid(g), mid(g)],
                               torch.randint(0, 2, (512, 1), device=SURFACE_DEVICE,
                                             generator=g)],
                    family='index'))
    add(SurfaceCase('bincount', M.bincount, lambda g: [ints(
        g, (1 << 22,), 4096)], family='index'))
    add(SurfaceCase('histogram', M.histogram, lambda g: [mid(g)],
                    dict(bins=64, min=-4, max=4), family='index'))
    add(SurfaceCase('bucketize', M.bucketize,
                    lambda g: [mid(g), torch.linspace(-3, 3, 256,
                                                      device=SURFACE_DEVICE)],
                    family='index'))
    add(SurfaceCase('searchsorted', M.searchsorted,
                    lambda g: [torch.linspace(-3, 3, 256, device=SURFACE_DEVICE),
                               mid(g)], family='index'))
    # shape and layout ops on a [8, 512, 512] tensor
    cube = lambda g: torch.randn(8, 512, 512, device=SURFACE_DEVICE, generator=g)
    for n, kw in (('reshape', dict(shape=[0, -1])),
                  ('transpose', dict(perm=[2, 0, 1])),
                  ('transpose_', dict(perm=[1, 0, 2])),
                  ('moveaxis', dict(source=0, destination=2)),
                  ('swapaxes', dict(axis0=0, axis1=2)),
                  ('unsqueeze', dict(axis=[0, 2])),
                  ('flatten', dict(start_axis=1)),
                  ('tile', dict(repeat_times=[1, 2, 1])),
                  ('flip', dict(axis=[0, 2])),
                  ('roll', dict(shifts=3, axis=1)),
                  ('rot90', dict(k=1, axes=[1, 2])),
                  ('slice', dict(axes=[1, 2], starts=[3, -100],
                                 ends=[400, -1])),
                  ('strided_slice', dict(axes=[1], starts=[0], ends=[512],
                                         strides=[3])),
                  ('tril', dict(diagonal=-1)), ('triu', dict(diagonal=2)),
                  ('diagonal', dict(offset=1, axis1=1, axis2=2)),
                  ('pad', dict(pad=[1, 2, 3, 4], value=0.5)),
                  ('repeat_interleave', dict(repeats=2, axis=0)),
                  ('cast', dict(dtype='float64')),
                  ('split', dict(num_or_sections=[100, -1], axis=1)),
                  ('chunk', dict(chunks=4, axis=2)),
                  ('unstack', dict(axis=0)), ('unbind', dict(axis=1)),
                  ('space_to_depth', dict(blocksize=2)),
                  ('pixel_shuffle', dict(upscale_factor=2)),
                  ('crop', dict(shape=[4, -1, 100], offsets=[1, 0, 7])),
                  ('expand', dict(shape=[2, -1, -1, -1])),
                  ('broadcast_to', dict(shape=[2, 8, 512, 512])),
                  ('getitem', dict(idx=(slice(1, 5), 7)))):
        fn = getattr(M, n) if n == 'crop' else getattr(MA, n)
        four = n in ('space_to_depth', 'pixel_shuffle')
        add(SurfaceCase(n, fn, lambda g, four=four: [
            cube(g)[None] if four else cube(g)], kw, grad=(0,),
            family='shape'))
    add(SurfaceCase('squeeze', MA.squeeze, lambda g: [cube(g)[:, None]],
                    dict(axis=1), grad=(0,), family='shape'))
    add(SurfaceCase('expand_as', MA.expand_as, lambda g: [
        cube(g)[:1], cube(g)], grad=(0,), family='shape'))
    for n in ('concat', 'stack', 'broadcast_tensors', 'meshgrid'):
        make = (lambda g: [[torch.randn(512, device=SURFACE_DEVICE, generator=g),
                            torch.randn(256, device=SURFACE_DEVICE, generator=g)]]) \
            if n == 'meshgrid' else (lambda g: [[cube(g), cube(g)]])
        add(SurfaceCase(n, getattr(MA, n), make, family='shape'))
    add(SurfaceCase('one_hot', MA.one_hot, lambda g: [ints(
        g, (4096,), 1000)], dict(num_classes=1000), family='shape'))
    add(SurfaceCase('shard_index', MA.shard_index, lambda g: [ints(
        g, (4096, 1), 50304)], dict(index_num=50304, nshards=4,
                                    shard_id=1), family='shape'))
    cplx = lambda g: torch.complex(cube(g), cube(g))
    for n in ('as_real', 'real', 'imag'):
        add(SurfaceCase(n, getattr(MA, n), lambda g: [cplx(g)],
                        family='shape'))
    add(SurfaceCase('as_complex', MA.as_complex,
                    lambda g: [torch.randn(8, 512, 2, device=SURFACE_DEVICE,
                                           generator=g)], family='shape'))
    for n in ('numel', 'shape'):
        add(SurfaceCase(n, getattr(MA, n), lambda g: [cube(g)],
                        family='shape'))
    # products
    for n, make, kw in (
            ('matmul', lambda g: [cube(g), cube(g)], {}),
            ('matmul-transposed', lambda g: [cube(g), cube(g)],
             dict(transpose_x=True, transpose_y=True)),
            ('bmm', lambda g: [cube(g), cube(g)], {}),
            ('mm', lambda g: [cube(g)[0], cube(g)[0]], {}),
            ('dot', lambda g: [cube(g), cube(g)], {}),
            ('inner', lambda g: [cube(g)[0], cube(g)[1]], {}),
            ('outer', lambda g: [cube(g)[0, 0], cube(g)[0, 1]], {}),
            ('kron', lambda g: [cube(g)[0, :32, :32], cube(g)[1, :16, :16]],
             {}),
            ('cross', lambda g: [cube(g)[..., :3], cube(g)[..., :3]], {}),
            ('mv', lambda g: [cube(g)[0], cube(g)[0, 0]], {}),
            ('addmm', lambda g: [cube(g)[0], cube(g)[1], cube(g)[2]],
             dict(beta=0.5, alpha=2.0)),
            ('tensordot', lambda g: [cube(g), torch.randn(
                512, 512, 16, device=SURFACE_DEVICE, generator=g)], dict(axes=2)),
            ('trace', lambda g: [cube(g)[0]], dict(offset=1)),
            ('diag', lambda g: [cube(g)[0, 0]], dict(offset=1,
                                                     padding_value=2.0)),
            ('diag_embed', lambda g: [cube(g)[:, 0]], {}),
            ('clip_by_norm', lambda g: [cube(g)], dict(max_norm=1.0)),
            ('renorm', lambda g: [cube(g)], dict(p=2, axis=0,
                                                 max_norm=100.0)),
            ('diff', lambda g: [cube(g)], dict(axis=-1)),
            ('trapezoid', lambda g: [cube(g)], {}),
            ('vander', lambda g: [torch.tanh(cube(g)[0, 0])], dict(n=8)),
            ('dist', lambda g: [cube(g), cube(g)], dict(p=2)),
            ('conj', lambda g: [cube(g)], {})):
        add(SurfaceCase(n, getattr(M, n.split('-')[0]), make, kw,
                        grad=('all',), family='product'))
    add(SurfaceCase('angle', M.angle, lambda g: [cplx(g)], family='product'))
    add(SurfaceCase('polar', M.polar, lambda g: [cube(g).abs(), cube(g)],
                    family='product'))
    add(SurfaceCase('einsum', lambda a, b: LA.einsum('bij,bjk->bik', a, b),
                    lambda g: [cube(g), cube(g)], grad=(0, 1),
                    family='product'))
    add(SurfaceCase('bilinear_tensor_product', LA.bilinear_tensor_product,
                    lambda g: [cube(g)[0], cube(g)[1],
                               torch.randn(16, 512, 512, device=SURFACE_DEVICE,
                                           generator=g),
                               torch.randn(16, device=SURFACE_DEVICE, generator=g)],
                    grad=(0, 1, 2, 3), family='product'))
    # linear algebra at [64, 512, 512]: the CPU recomputes two matrices
    def spd(g):
        """I + a·aᵀ/(4n) with a [b, n, 4n]: eigenvalues spread over
        [1.25, 3.25] with no cluster (a square a's would crowd 1, where
        eigenvectors, and eigvalsh's gradient, are ill-conditioned)."""
        b, n, _ = SWEEP_LINALG
        a = torch.randn(b, n, 4 * n, device=SURFACE_DEVICE, generator=g)
        return a @ a.mT / (4 * n) + torch.eye(n, device=SURFACE_DEVICE)

    def gen_mat(g, spread=0.5):
        """I + spread·G/sqrt(n): eigenvalues within `spread` of 1, a
        well-conditioned general matrix."""
        n = SWEEP_LINALG[-1]
        return torch.eye(n, device=SURFACE_DEVICE) + spread / n ** 0.5 * \
            torch.randn(SWEEP_LINALG, device=SURFACE_DEVICE, generator=g)

    rhs = lambda g: torch.randn(SWEEP_LINALG[0], SWEEP_LINALG[1], 16,
                                device=SURFACE_DEVICE, generator=g)

    def rebuild(name):
        def pick(res, ins):
            a = ins[0]
            # the rebuilt matrices (each side's equals its input), and
            # the factors that are unique
            if name == 'qr':
                return [res[0] @ res[1]]
            if name == 'svd':
                return [(res[0] * res[1][..., None, :]) @ res[2].mT, res[1]]
            if name == 'eigh':
                return [(res[1] * res[0][..., None, :]) @ res[1].mT, res[0]]
            if name == 'eig':
                v, w = res[1], res[0]
                return [(v * w[..., None, :]) @ torch.linalg.inv(v)]
            if name == 'lu':
                p, low, up = torch.lu_unpack(*res)
                return [p @ low @ up]
            if name == 'cholesky':
                return [res @ res.mT, res]
        return pick

    for n, make, kw, grad in (
            ('cholesky', spd, {}, (0,)), ('inverse', spd, {}, (0,)),
            ('inv', spd, {}, ()), ('matrix_power', gen_mat, dict(n=2),
                                   (0,)),
            ('det', lambda g: gen_mat(g, 0.05), {}, (0,)),
            ('slogdet', gen_mat, {}, ()),
            ('matrix_rank', spd, {}, ()), ('pinv', gen_mat, {}, ()),
            ('solve', lambda g: [spd(g), rhs(g)], {}, (0, 1)),
            ('triangular_solve', lambda g: [torch.linalg.cholesky(
                spd(g)).mT.contiguous(), rhs(g)], {}, (0, 1)),
            ('cholesky_solve', lambda g: [rhs(g), torch.linalg.cholesky(
                spd(g))], {}, (0,)),
            ('lstsq', lambda g: [gen_mat(g), rhs(g)], {}, ()),
            ('cond', gen_mat, {}, ()), ('eigvalsh', spd, {}, ()),
            ('qr', gen_mat, {}, ()), ('svd', gen_mat, {}, ()),
            ('eigh', spd, {}, ()), ('lu', gen_mat, {}, ())):
        wrap = make if n in ('solve', 'triangular_solve', 'cholesky_solve',
                             'lstsq') else (lambda g, make=make: [make(g)])
        add(SurfaceCase(n, getattr(LA, n), wrap, kw, grad=grad, block=_two,
                        family='linalg', bar=SWEEP_BARS['linalg'],
                        compare=rebuild(n) if n in (
                            'qr', 'svd', 'eigh', 'lu', 'cholesky')
                        else (lambda r, ins: [r.mT]) if n == 'slogdet'
                        else None))
    def spread(g, n=64):
        """Q diag(linspace(1, 5, n)) Qᵀ: eigenvalues 4/(n-1) apart, so
        fp32 eigenvectors, and eigvalsh's gradient V diag(g) Vᵀ, are
        well conditioned (at n = 512 a random spectrum's closest pair
        moves the gradient by ~1e-3 between two fp32 solvers)."""
        q = torch.linalg.qr(torch.randn(SWEEP_LINALG[0], n, n,
                                        device=SURFACE_DEVICE,
                                        generator=g)).Q
        lam = torch.linspace(1.0, 5.0, n, device=SURFACE_DEVICE)
        return (q * lam) @ q.mT

    add(SurfaceCase('eigvalsh-vjp', LA.eigvalsh, lambda g: [spread(g)],
                    grad=(0,), block=_two, family='linalg',
                    bar=SWEEP_BARS['linalg']))
    small = lambda g: torch.eye(256, device=SURFACE_DEVICE) + 0.5 / 16 * \
        torch.randn(4, 256, 256, device=SURFACE_DEVICE, generator=g)
    add(SurfaceCase('eig', LA.eig, lambda g: [small(g)], block=_two,
                    family='linalg', bar=SWEEP_BARS['linalg'],
                    compare=rebuild('eig')))
    add(SurfaceCase('eigvals', lambda a: LA.eigvals(a).abs().sort(-1)
                    .values, lambda g: [small(g)], block=_two,
                    family='linalg', bar=SWEEP_BARS['linalg']))
    for n in ('cov', 'corrcoef'):
        add(SurfaceCase(n, getattr(LA, n), lambda g: [torch.randn(
            512, 2048, device=SURFACE_DEVICE, generator=g)], family='linalg',
            bar=SWEEP_BARS['linalg']))
    # fft at [16384, 2048]: the 1-D transforms along the last axis on a
    # row block, the 2-D and n-D ones whole
    sig = lambda g: torch.randn(SWEEP_FFT, device=SURFACE_DEVICE, generator=g)
    csig = lambda g: torch.complex(sig(g), sig(g))
    for n in ('fft', 'ifft', 'rfft', 'ihfft'):
        add(SurfaceCase(n, lambda a, n=n: torch.real(getattr(FF, n)(a)),
                        lambda g: [sig(g)], grad=(0,), block=_lead_rows,
                        family='fft'))
        add(SurfaceCase(f'{n}-complex', getattr(FF, n),
                        lambda g: [sig(g)], block=_lead_rows,
                        family='fft'))
    for n in ('irfft', 'hfft'):
        add(SurfaceCase(n, getattr(FF, n), lambda g: [csig(g)],
                        block=_lead_rows, family='fft'))
    for n in ('fft2', 'ifft2', 'rfft2', 'fftn', 'ifftn', 'rfftn'):
        add(SurfaceCase(n, getattr(FF, n), lambda g: [sig(g)],
                        family='fft', bar=(1e-4, 1e-5)))
    for n in ('irfft2', 'irfftn'):
        add(SurfaceCase(n, getattr(FF, n), lambda g: [csig(g)[:, :1025]],
                        family='fft', bar=(1e-4, 1e-5)))
    for n in ('fftshift', 'ifftshift'):
        add(SurfaceCase(n, getattr(FF, n), lambda g: [sig(g)],
                        family='fft'))
    # creation on the card against the same op on the CPU
    for n, args, kw in (('zeros', ([64, 2048],), {}),
                        ('ones', ([64, 2048],), dict(dtype='int32')),
                        ('full', ([64, 2048], 1.5), {}),
                        ('empty', ([64, 2048],), {}),
                        ('arange', (0, 1 << 20), {}),
                        ('linspace', (0, 1, 4097), {}),
                        ('logspace', (0, 2, 4097), {}),
                        ('eye', (2048, 1024), {}),
                        ('to_tensor', (np.arange(4096.0),), {})):
        add(SurfaceCase(n, lambda *a, n=n, kw=kw, **k: getattr(C, n)(
            *a, device=k.pop('_device'), **kw), lambda g, args=args:
            list(args), family='creation'))
    for n, args in (('zeros_like', ()), ('ones_like', ()),
                    ('empty_like', ()), ('full_like', (2.5,)),
                    ('assign', ()), ('clone', ()), ('tril_', ()),
                    ('diagflat', ()), ('complex', ())):
        def make(g, n=n, args=args):
            t = torch.randn(512, 512, device=SURFACE_DEVICE, generator=g)
            if n == 'diagflat':
                return [t[0]]
            return [t, t] if n == 'complex' else [t, *args]
        add(SurfaceCase(n, getattr(C, n), make, family='creation'))
    add(SurfaceCase('broadcast_shape', lambda a, b, _device: torch.tensor(
        M.broadcast_shape(a, b), device=_device), lambda g: [
            [8, 1, 2048], [2048, 1]], family='creation'))
    for n in ('fftfreq', 'rfftfreq'):
        add(SurfaceCase(n, lambda m, n=n, **k: getattr(FF, n)(
            m, 0.5, device=k.pop('_device')), lambda g: [4096],
            family='creation'))
    # losses
    add_losses(torch, cases, NN)
    return cases


def add_losses(torch, cases, NN):
    """Every loss: cross-entropy and nll_loss at the GPT head's [4096,
    50304] fp32 logits with ignored rows, the others at [16384, 2048],
    ctc_loss at T=256, B=64, 32 classes, labels up to 64; row-wise ones
    ('none') on a row block, the reduced ones whole."""
    add = cases.append
    V = SWEEP_XENT

    def logits(g):
        return torch.randn(V, device=SURFACE_DEVICE, generator=g)

    def labels(g, n, c, ignore=None):
        lab = torch.randint(0, c, (n,), device=SURFACE_DEVICE, generator=g)
        if ignore is not None:
            lab[::7] = ignore
        return lab

    for red in ('none', 'mean'):
        block = _lead_rows if red == 'none' else None
        add(SurfaceCase(f'cross_entropy-{red}', NN.cross_entropy,
                        lambda g: [logits(g), labels(g, V[0], V[1], -100)],
                        dict(reduction=red, ignore_index=-100), grad=(0,),
                        block=block, family='loss'))
        add(SurfaceCase(f'nll_loss-{red}', NN.nll_loss,
                        lambda g: [torch.log_softmax(logits(g), -1),
                                   labels(g, V[0], V[1], -100)],
                        dict(reduction=red, weight=None), grad=(0,),
                        block=block, family='loss'))
    add(SurfaceCase('softmax_with_cross_entropy',
                    NN.softmax_with_cross_entropy,
                    lambda g: [logits(g), labels(g, V[0], V[1])[:, None]],
                    grad=(0,), block=_lead_rows, family='loss'))
    L = SWEEP_LOSS
    x = lambda g: torch.randn(L, device=SURFACE_DEVICE, generator=g)
    prob = lambda g: torch.rand(L, device=SURFACE_DEVICE, generator=g) * 0.9 + 0.05
    sign = lambda g: torch.randn(L, device=SURFACE_DEVICE, generator=g).sign()
    for name, make, kw, grad, red in (
            ('mse_loss', lambda g: [x(g), x(g)], {}, (0, 1), True),
            ('l1_loss', lambda g: [x(g), x(g)], {}, (0, 1), True),
            ('smooth_l1_loss', lambda g: [x(g), x(g)], dict(delta=0.7),
             (0, 1), True),
            ('kl_div', lambda g: [x(g), prob(g)], {}, (0, 1), True),
            ('soft_margin_loss', lambda g: [x(g), sign(g)], {}, (0,), True),
            ('binary_cross_entropy', lambda g: [prob(g), prob(g)], {},
             (0,), True),
            ('binary_cross_entropy_with_logits', lambda g: [x(g), prob(g)],
             dict(pos_weight=2.0), (0,), True),
            ('sigmoid_focal_loss', lambda g: [x(g), (x(g) > 0).float()],
             {}, (0,), True),
            ('margin_ranking_loss', lambda g: [x(g)[:, 0], x(g)[:, 0],
                                               sign(g)[:, 0]],
             dict(margin=0.1), (0, 1), True),
            ('triplet_margin_loss', lambda g: [x(g), x(g), x(g)], {},
             (0, 1, 2), True),
            ('cosine_embedding_loss', lambda g: [x(g), x(g), sign(g)[:, 0]],
             dict(margin=0.2), (0, 1), True),
            ('multi_margin_loss', lambda g: [x(g), torch.randint(
                0, L[1], (L[0],), device=SURFACE_DEVICE, generator=g)], {}, (0,),
             True),
            ('hinge_loss', lambda g: [x(g), (x(g) > 0).float()], {}, (0,),
             False),
            ('log_loss', lambda g: [prob(g), (x(g) > 0).float()], {}, (0,),
             False),
            ('square_error_cost', lambda g: [x(g), x(g)], {}, (0, 1),
             False),
            ('label_smooth', lambda g: [prob(g)], dict(epsilon=0.1), (0,),
             False),
            ('npair_loss', lambda g: [x(g)[:2048] / 8, x(g)[:2048] / 8,
                                      torch.randint(0, 64, (min(
                                          2048, L[0]),),
                                          device=SURFACE_DEVICE,
                                          generator=g)], {},
             (0, 1), False),
            ('dice_loss', lambda g: [torch.softmax(torch.randn(
                64, 256, 512, device=SURFACE_DEVICE, generator=g), -1),
                                     torch.randint(0, 512, (64, 256, 1),
                                                   device=SURFACE_DEVICE,
                                                   generator=g)], {},
             (0,), False)):
        if red:
            add(SurfaceCase(f'{name}-none', getattr(NN, name), make,
                            dict(kw, reduction='none'), grad=grad,
                            block=_lead_rows, family='loss'))
            add(SurfaceCase(f'{name}-mean', getattr(NN, name), make,
                            dict(kw, reduction='mean'), grad=grad,
                            family='loss'))
        else:
            add(SurfaceCase(name, getattr(NN, name), make, kw, grad=grad,
                            block=_lead_rows if name in (
                                'hinge_loss', 'log_loss',
                                'square_error_cost', 'label_smooth')
                            else None, family='loss'))
    c = SWEEP_CTC

    def ctc_inputs(g):
        lp = torch.log_softmax(torch.randn(c['T'], c['B'], c['C'],
                                           device=SURFACE_DEVICE, generator=g), -1)
        lab = torch.randint(1, c['C'], (c['B'], c['S']), device=SURFACE_DEVICE,
                            generator=g)
        il = torch.full((c['B'],), c['T'], device=SURFACE_DEVICE, dtype=torch.long)
        ll = torch.randint(c['S'] // 2, c['S'] + 1, (c['B'],),
                           device=SURFACE_DEVICE, generator=g)
        return [lp, lab, il, ll]
    for red in ('none', 'mean', 'sum'):
        add(SurfaceCase(f'ctc_loss-{red}', NN.ctc_loss, ctc_inputs,
                        dict(reduction=red), grad=(0,), family='loss',
                        bar=(1e-4, 1e-5)))


def _default_state(torch):
    """The state of torch's default generator of the sweep's device."""
    if torch.device(SURFACE_DEVICE).type == 'cuda':
        return torch.cuda.default_generators[0].get_state()
    return torch.default_generator.get_state()


def surface_random(torch, card):
    """The random ops on the card: moments of 2^24 draws (within 6
    standard errors), reproducibility under `seed()` and a passed
    generator, and torch's default CUDA generator untouched."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import creation as C

    n = 1 << 24
    default = _default_state(torch)
    on_device = ('uniform', 'rand', 'randn', 'standard_normal', 'normal',
                 'gaussian', 'randint', 'truncated_gaussian_random',
                 'randperm')
    draws = {
        'uniform': (lambda **g: C.uniform([n], min=-2.0, max=4.0, **g),
                    1.0, 3.0),
        'rand': (lambda **g: C.rand([n], **g), 0.5, 1 / 12),
        'randn': (lambda **g: C.randn([n], **g), 0.0, 1.0),
        'standard_normal': (lambda **g: C.standard_normal([n], **g), 0.0,
                            1.0),
        'normal': (lambda **g: C.normal(2.0, 3.0, [n], **g), 2.0, 9.0),
        'gaussian': (lambda **g: C.gaussian([n], 1.0, 2.0, **g), 1.0, 4.0),
        'randint': (lambda **g: C.randint(0, 10, [n], **g).float(), 4.5,
                    99 / 12),
        'randint_like': (lambda **g: C.randint_like(
            torch.zeros(n, device=SURFACE_DEVICE), 0, 4, **g).float(), 1.5,
            15 / 12),
        'bernoulli': (lambda **g: C.bernoulli(torch.full(
            (n,), 0.3, device=SURFACE_DEVICE), **g), 0.3, 0.21),
        'poisson': (lambda **g: C.poisson(torch.full(
            (n,), 3.0, device=SURFACE_DEVICE), **g), 3.0, 3.0),
        'multinomial': (lambda **g: C.multinomial(torch.tensor(
            [1.0, 3.0], device=SURFACE_DEVICE), n, replacement=True, **g).float(),
            0.75, 0.1875),
        'truncated_gaussian_random': (lambda **g:
                                      C.truncated_gaussian_random([n], **g),
                                      0.0, 0.7737413),
        'randperm': (lambda **g: C.randperm(n, **g).float(), (n - 1) / 2,
                     (n * n - 1) / 12),
        'shuffle': (lambda **g: C.shuffle(torch.arange(
            n, device=SURFACE_DEVICE, dtype=torch.float32), **g), (n - 1) / 2,
            (n * n - 1) / 12),
    }
    rec = {}
    for name, (draw, mean, var) in draws.items():
        if name in on_device:
            draw = functools.partial(draw, device=SURFACE_DEVICE)
        rng.seed(2023)
        a = draw()
        b = draw()
        rng.seed(2023)
        again = draw()
        g1 = draw(generator=torch.Generator(device=SURFACE_DEVICE).manual_seed(9))
        g2 = draw(generator=torch.Generator(device=SURFACE_DEVICE).manual_seed(9))
        if a.device.type != torch.device(SURFACE_DEVICE).type or \
                not torch.equal(a, again) or \
                torch.equal(a, b) or not torch.equal(g1, g2):
            raise AssertionError(f'surface random {name}: not reproducible')
        m, v = float(a.double().mean()), float(a.double().var())
        if name in ('randperm', 'shuffle'):
            ok = torch.equal(a.sort().values, torch.arange(
                n, device=SURFACE_DEVICE, dtype=torch.float32))
        else:
            ok = abs(m - mean) < 6 * (var / n) ** 0.5 and \
                abs(v - var) < 0.01 * var
        if not ok:
            raise AssertionError(f'surface random {name}: mean {m} var {v} '
                                 f'against {mean} {var}')
        rec[name] = {'mean': m, 'var': v}
    if not torch.equal(_default_state(torch),
                       default):
        raise AssertionError('surface random: the default CUDA generator '
                             'moved')
    return rec


def surface_sweep(torch, card, smi):
    """(a) Every registry op and every loss on the card against the CPU
    (`surface_cases`), fp32 and bf16 where the op takes floats; every
    result on the card; the random ops (`surface_random`)."""
    from paddle_tpu_torch.ops import common
    from paddle_tpu_torch.ops import nn_ops  # noqa: F401  the losses

    t0 = time.perf_counter()
    default = _default_state(torch)
    cases = surface_cases(torch)
    names = {c.name.split('-')[0] for c in cases}
    registry = {}
    for name, fn in common.OP_REGISTRY.items():
        registry.setdefault(id(fn), set()).add(name)
    random_ops = {'uniform', 'rand', 'randn', 'normal', 'gaussian',
                  'standard_normal', 'randint', 'randint_like', 'randperm',
                  'shuffle', 'bernoulli', 'poisson', 'multinomial',
                  'truncated_gaussian_random'}
    missing = sorted(min(ns) for ns in registry.values()
                     if not ns & (names | random_ops))
    if missing:
        raise AssertionError(f'surface: registry ops without a case: '
                             f'{missing}')
    gen = torch.Generator(device=SURFACE_DEVICE)
    errs, blocks, per_family, failed = {}, [], {}, []
    for i, case in enumerate(cases):
        for dt in case.dtypes:
            gen.manual_seed(1000 + i)
            try:
                if case.family == 'creation':
                    err = creation_case(torch, case, gen)
                else:
                    err = run_surface_case(torch, case, dt, gen)
            except Exception as e:      # every case runs; all are reported
                failed.append(f'{case.name}/{dt}: {type(e).__name__}: {e}')
                continue
            key = f'{case.family}/{dt}'
            per_family[key] = max(per_family.get(key, 0.0), err)
            errs[f'{case.name}/{dt}'] = err
        if case.block is not None:
            blocks.append(case.name)
    if failed:
        raise AssertionError(f'surface: {len(failed)} case runs failed: '
                             + '; '.join(failed))
    free_cuda(torch)
    random_rec = surface_random(torch, card)
    if not torch.equal(_default_state(torch),
                       default):
        raise AssertionError('surface: the default CUDA generator moved')
    rec = {'phase': 'surface_sweep', 'card': card, 'nvidia_smi': smi,
           'registry_functions': len(registry),
           'registry_names': len(common.OP_REGISTRY),
           'registry_functions_held': len(registry),
           'cases': len(cases), 'case_runs': len(errs),
           'random_ops': sorted(random_ops),
           'max_rel_err_by_family': per_family,
           'cpu_row_block_cases': blocks,
           'cpu_row_block': f'[:1, :{SWEEP_BLOCK}] of [8, L, N], '
                            f'[:{SWEEP_BLOCK}] of 2-D, [:2] of batched '
                            'matrices',
           'shapes': {'big': SWEEP_BIG, 'vocab': SWEEP_VOCAB,
                      'ids': SWEEP_IDS, 'linalg': SWEEP_LINALG,
                      'fft': SWEEP_FFT, 'xent': SWEEP_XENT,
                      'loss': SWEEP_LOSS, 'ctc': SWEEP_CTC},
           'random': random_rec, 'seconds': time.perf_counter() - t0}
    emit(rec)
    return rec


def creation_case(torch, case, gen):
    """A creation op made on the card and on the CPU from the same
    arguments (ops on tensors: from the card's tensor and its copy)."""
    args = case.make(gen)
    on_tensor = any(isinstance(a, torch.Tensor) for a in args)
    if on_tensor:
        card = case.fn(*args, **case.kw)
        cpu = case.fn(*_to(torch, args, 'cpu'), **case.kw)
    else:
        card = case.fn(*args, _device=SURFACE_DEVICE, **case.kw)
        cpu = case.fn(*args, _device='cpu', **case.kw)
    if card.device.type != torch.device(SURFACE_DEVICE).type:
        raise AssertionError(f'surface {case.name}: made on {card.device}')
    return _sweep_close(torch, card.cpu(), cpu, SWEEP_BARS['fp32'],
                        f'{case.name} creation')


def surface_model(torch, device, B, hw, gen):
    """The surface_train recipe at one size: resnet50 from the package
    generator, its fc replaced by the ParamAttr head, CrossEntropyLoss,
    Momentum with a global-norm clip; inputs from `randn`/`randint`."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn.initializer import Normal
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.regularizer import L2Decay
    from paddle_tpu_torch.vision.models import resnet50

    paddle.seed(2021)
    x = paddle.randn([B, 3, hw, hw], device=device)
    y = paddle.randint(0, 1000, [B], device=device)
    model = resnet50(device=device)
    model.fc = nn.Linear(2048, 1000, weight_attr=paddle.ParamAttr(
        initializer=Normal(0.0, 0.01), learning_rate=10.0,
        regularizer=L2Decay(1e-4)), bias_attr=paddle.ParamAttr(
            learning_rate=10.0, need_clip=False), device=device)
    opt = Momentum(learning_rate=0.01, momentum=0.9,
                   parameters=model.parameters(),
                   grad_clip=nn.ClipGradByGlobalNorm(1.0))
    return model, nn.CrossEntropyLoss(), opt, x, y


def surface_train_phase(torch, card, smi):
    """(b) surface_train: the eager fine-tuning loop written against the
    new surface, fp32, at the resnet50_dp_bf16 leg's width (B = 128,
    224²): 8 steps of loss.backward(); opt.step(); opt.clear_grad() on
    the fixed batch. The loss is finite and falls; row 15 launches twice
    a step (the head's multiplier group and the rest) and nothing else
    launches; the head's bias takes its unclipped gradient at 10x the
    rate while the others take the clipped one; then the same recipe at
    B = 4, 64², one step on the card and on the CPU from the same
    weights, every parameter within 1e-3 relative L2."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO

    cfg = SURFACE_TRAIN
    model, loss_fn, opt, x, y = surface_model(torch, 'cuda', cfg['B'],
                                              cfg['hw'], None)
    params = list(model.parameters())
    named = dict(model.named_parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, step_s = [], []
    clip_rec = None
    for step in range(cfg['steps']):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(model(x), y)
        loss.backward()
        if step == 0:
            before = {n: (p.detach().clone(), p.grad.detach().clone())
                      for n, p in named.items()}
            sq = sum(float((p.grad.double() ** 2).sum()) for n, p in
                     named.items() if n != 'fc.bias')
            factor = min(1.0, 1.0 / sq ** 0.5)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        step_s.append(time.perf_counter() - t0)
        if step == 0:
            clip_rec = clip_check(torch, named, before, factor)
    launches = _build.routes_snapshot()
    peak = torch.cuda.max_memory_allocated()
    check_exact_launches('surface_train', launches,
                         {FO.STEP: 2 * cfg['steps']})
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f'surface_train: losses {losses}')
    timed = step_s[1:]
    ms = 1e3 * sum(timed) / len(timed)
    del model, opt, x, y, before, named, params
    free_cuda(torch)
    check = surface_train_check(torch)
    rec = {'phase': 'surface_train', 'card': card, 'nvidia_smi': smi,
           'model': 'resnet50(1000), fc: Linear(2048, 1000) with '
                    'ParamAttr(Normal(0, 0.01), lr x10, L2Decay(1e-4)), '
                    'bias ParamAttr(lr x10, need_clip=False)',
           'batch': cfg['B'], 'image': [3, cfg['hw'], cfg['hw']],
           'dtype': 'float32', 'optimizer': 'Momentum(0.01, 0.9), '
           'ClipGradByGlobalNorm(1.0)', 'steps': cfg['steps'],
           'losses': losses, 'step_s': step_s,
           'ms_per_step': ms, 'images_per_sec': cfg['B'] / (ms / 1e3),
           'peak_memory_bytes': peak, 'launches': launches,
           'clip': clip_rec, 'cpu_check': check, **cudnn_settings(torch)}
    emit(rec)
    return rec


def clip_check(torch, named, before, factor):
    """After the first Momentum step (velocity = gradient): the head's
    bias moved by 0.01·10·g (no clip), a convolution by 0.01·factor·g,
    the head's weight by 0.01·10·(factor·g + 1e-4·w)."""
    def moved(n):
        p0, _ = before[n]
        return (p0 - named[n].detach()).double()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    g = {n: before[n][1].double() for n in before}
    conv = next(n for n in named if n.endswith('weight') and
                named[n].dim() == 4)
    errs = {
        'fc.bias': rel(moved('fc.bias'), 0.1 * g['fc.bias']),
        conv: rel(moved(conv), 0.01 * factor * g[conv]),
        'fc.weight': rel(moved('fc.weight'), 0.1 * (
            factor * g['fc.weight'] + 1e-4 * before['fc.weight'][0]
            .double()))}
    # a step read back as the difference of two fp32 parameters keeps
    # ~eps·|p|/|step| of itself: ~6e-4 for the head's weight, which moves
    # ~1e-4 of its size; a clip applied where it should not be (or not
    # where it should) is off by 1 - factor
    if not factor < 0.5 or max(errs.values()) > 1e-2:
        raise AssertionError(f'surface_train: clip factor {factor}, the '
                             f'step against the expected one {errs}')
    return {'global_norm_factor': factor, 'rel_err': errs}


def surface_train_check(torch):
    """One step of the recipe at B = 4, 64² on the card and on the CPU
    from the same weights and inputs, with TF32 off as vision_check
    runs (TF32 convolutions moved the stem's weight 2.5e-3 away from the
    CPU's on an H100: batch norm over 4 images amplifies their
    rounding): every parameter within 1e-3 relative L2, and the
    losses."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _surface_train_check(torch)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _surface_train_check(torch):
    cfg = SURFACE_TRAIN
    card = surface_model(torch, 'cuda', cfg['check_B'], cfg['check_hw'],
                         None)
    cpu = surface_model(torch, 'cpu', cfg['check_B'], cfg['check_hw'],
                        None)
    with torch.no_grad():
        cpu[0].load_state_dict({k: v.cpu() for k, v in
                                card[0].state_dict().items()})
    x, y = card[3], card[4]
    start = {n: p.detach().clone() for n, p in card[0].named_parameters()}
    out = {}
    for where, (model, loss_fn, opt, _x, _y) in (('card', card),
                                                  ('cpu', cpu)):
        xi, yi = x.to(_x.device), y.to(_y.device)
        loss = loss_fn(model(xi), yi)
        loss.backward()
        opt.step()
        opt.clear_grad()
        out[where] = float(loss.detach())
    # a parameter that starts at zero (the batch norms' and the head's
    # biases) is its step, whose gradient in a batch norm's bias nearly
    # cancels (vision_check's note): those are held together by their
    # steps, each reported
    errs, zero_diff, zero_norm = {}, 0.0, 0.0
    for (n, a), (_, b) in zip(card[0].named_parameters(),
                              cpu[0].named_parameters()):
        a, b = a.detach().cpu().double(), b.detach().double()
        d = float((a - b).norm())
        if not start[n].any():
            zero_diff += d * d
            zero_norm += float(b.norm()) ** 2
            errs[n] = d / max(float(b.norm()), 1e-30)
            continue
        errs[n] = d / max(float(b.norm()), 1e-30)
        if errs[n] > cfg['check_rtol']:
            raise AssertionError(f'surface_train check: {n} {errs[n]}')
    zero_rel = (zero_diff / max(zero_norm, 1e-60)) ** 0.5
    if zero_rel > cfg['check_zero_rtol']:
        raise AssertionError(f'surface_train check: the zero-initialized '
                             f'parameters\' steps {zero_rel}; {errs}')
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    return {'batch': cfg['check_B'], 'image': cfg['check_hw'],
            'losses': out, 'bar': cfg['check_rtol'],
            'max_rel_l2_initialized': max(
                v for k, v in errs.items() if start[k].any()),
            'zero_initialized_steps_rel_l2': zero_rel,
            'zero_initialized_bar': cfg['check_zero_rtol'],
            'worst_five': worst, 'cudnn_allow_tf32': False}


def event_ms(torch, fn, iters=10):
    """Device ms per call of fn from CUDA events around `iters` calls
    (fn may run autograd, which a graph capture would not take)."""
    for _ in range(2):
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


def conv_layouts_phase(torch, card, smi):
    """(c) conv_layouts: ResNet-50's shapes in bf16 (and an fp32 pass
    with TF32 off), each op forward and backward in NHWC (an NHWC tensor
    permuted to NCHW: channels_last memory, no copy) against NCHW:
    outputs and input/weight gradients within CONV_LAYOUT_BARS relative
    L2; the device ms of a forward and of a forward + backward in each
    layout. cudnn.benchmark is left as it is."""
    from paddle_tpu_torch.ops import nn_ops as F

    gen = torch.Generator(device='cuda').manual_seed(23)
    rec = {}
    tf32 = torch.backends.cudnn.allow_tf32
    for dt_name, dt in (('bf16', torch.bfloat16), ('fp32', torch.float32)):
        torch.backends.cudnn.allow_tf32 = dt_name != 'fp32' and tf32
        for name, c in CONV_LAYOUTS.items():
            x = torch.randn(c['x'], device='cuda', generator=gen).to(dt)
            w = None if 'w' not in c else (torch.randn(
                c['w'], device='cuda', generator=gen) * 0.05).to(dt)

            def run(xin, fmt, w=w, c=c, name=name):
                if name.startswith('max_pool'):
                    return F.max_pool2d(xin, c['kernel'], c['stride'],
                                        c['padding'], data_format=fmt)
                if 'transpose' in name:
                    return F.conv2d_transpose(
                        xin, w, None, c['stride'], c['padding'],
                        groups=c['groups'], data_format=fmt)
                return F.conv2d(xin, w, None, c['stride'], c['padding'],
                                data_format=fmt)
            res, cot = {}, None
            for fmt in ('NCHW', 'NHWC'):
                xin = x if fmt == 'NCHW' else \
                    x.permute(0, 2, 3, 1).contiguous()
                xin = xin.detach().requires_grad_(True)
                wi = None if w is None else w.detach().requires_grad_(True)
                out = run(xin, fmt, wi)
                if cot is None:
                    cot = torch.randn(out.shape, device='cuda',
                                      generator=gen).to(dt)
                # NHWC's cotangent is the NCHW one in its own layout
                c_fmt = cot if fmt == 'NCHW' else \
                    cot.permute(0, 2, 3, 1).contiguous()
                out.backward(c_fmt)
                outs = [out, xin.grad] + ([] if wi is None else [wi.grad])
                if fmt == 'NHWC':
                    outs[0] = outs[0].permute(0, 3, 1, 2)
                    outs[1] = outs[1].permute(0, 3, 1, 2)
                fwd = event_ms(torch, lambda: run(xin.detach(), fmt,
                                                  None if wi is None
                                                  else wi.detach()))

                def step(xin=xin, wi=wi, fmt=fmt, c_fmt=c_fmt):
                    run(xin, fmt, wi).backward(c_fmt)
                both = event_ms(torch, step)
                res[fmt] = {'outs': outs, 'fwd_ms': fwd,
                            'fwd_bwd_ms': both}
            errs = []
            for a, b in zip(res['NHWC']['outs'], res['NCHW']['outs']):
                errs.append(float((a.float() - b.float()).norm()
                                  / b.float().norm()))
            if max(errs) > CONV_LAYOUT_BARS[dt_name]:
                raise AssertionError(f'conv_layouts {name} {dt_name}: '
                                     f'rel L2 {errs}')
            rec[f'{name}/{dt_name}'] = {
                'shape': c, 'rel_l2_out_dx_dw': errs,
                'nchw_fwd_ms': res['NCHW']['fwd_ms'],
                'nhwc_fwd_ms': res['NHWC']['fwd_ms'],
                'nchw_fwd_bwd_ms': res['NCHW']['fwd_bwd_ms'],
                'nhwc_fwd_bwd_ms': res['NHWC']['fwd_bwd_ms']}
            del res, x, w
        free_cuda(torch)
    torch.backends.cudnn.allow_tf32 = tf32
    out = {'phase': 'conv_layouts', 'card': card, 'nvidia_smi': smi,
           'rows': rec, 'bars_rel_l2': CONV_LAYOUT_BARS,
           **cudnn_settings(torch)}
    emit(out)
    return out


def surface_phase(torch, card, smi):
    """The op surface's three parts; returns the port kernels' launches
    over all of them (row 15: surface_train's 16 and its check's 2)."""
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.reset_launches()
    sweep = surface_sweep(torch, card, smi)
    free_cuda(torch)
    train = surface_train_phase(torch, card, smi)
    free_cuda(torch)
    layouts = conv_layouts_phase(torch, card, smi)
    free_cuda(torch)
    launches = _build.routes_snapshot()
    return launches, {'sweep_s': sweep['seconds'],
                      'train_ms_per_step': train['ms_per_step'],
                      'seconds': time.perf_counter() - t0,
                      'layouts': len(layouts['rows'])}


HAPI_B = 64
HAPI_RUNS = ((True, 0), (True, 2), (False, 0), (False, 2))
HAPI_TEXT = dict(epochs=3, B=64, lr=1e-2, check_steps=3, check_rtol=1e-3)
RNN_SHAPE = dict(B=64, T=128, C=512, H=512, layers=2, iters=10)
RNN_CHECK = dict(B=4, T=12, C=16, H=16, layers=2, lens=(12, 5, 9, 1),
                 rtol=1e-4)
BEAM = dict(V=10000, H=512, W=4, B=16, steps=64, start=1, end=2,
            emb_scale=40.0, proj_scale=150.0, margin=1e-3)


def step_clock():
    """A hapi callback: host seconds of each train batch (its loss read,
    one sync, included) and each batch's loss, recovered from the
    running mean the loop logs, which restarts at each epoch's step 0:
    loss = mean_step (step + 1) - mean_(step-1) step."""
    from paddle_tpu_torch.hapi import Callback

    class Clock(Callback):
        def __init__(self):
            super().__init__()
            self.step_s, self.losses = [], []

        def on_batch_begin(self, mode, step, logs=None):
            self._t0 = time.perf_counter()

        def on_batch_end(self, mode, step, logs=None):
            self.step_s.append(time.perf_counter() - self._t0)
            prev = self._mean if step else 0.0
            self.losses.append(logs['loss'] * (step + 1) - prev * step)
            self._mean = logs['loss']
    return Clock()


def lenet_hapi_model(torch, device, jit):
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet

    net = LeNet(10, device=device,
                generator=torch.Generator(device=device).manual_seed(0))
    model = Model(net, device=device)
    model.prepare(Adam(learning_rate=1e-3, parameters=net.parameters()),
                  pnn.CrossEntropyLoss(), Accuracy(), jit=jit)
    return model


def _hapi_fit(torch, model, data, **kw):
    """Fit one epoch; (the fit's kernel launches, its clock, wall s)."""
    from paddle_tpu_torch.ops.kernels import _build

    clock = step_clock()
    np.random.seed(0)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    model.fit(data, verbose=0, callbacks=[clock], **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return _build.routes_snapshot(), clock, wall


def _add_launches(total, launches):
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def hapi_lenet_phase(torch, card, smi, lenet_ms):
    """hapi_lenet: the reference's canonical hapi flow (tests/
    test_e2e_train.py:58-73 with LeNet): Model(LeNet()) on the card,
    Adam(1e-3), CrossEntropyLoss, Accuracy, one epoch of MNIST(mode=
    'train') at batch 64 (2048 synthetic images: 32 steps), on the jit
    route and the eager one, each with 0 and 2 loader workers. Row 15
    launches once a step on both (one jit step; one learning-rate group
    an eager step) and nothing else launches. Then evaluate on
    MNIST(mode='test'), predict, save, load into a fresh Model: its
    evaluation loss equals the saved model's; evaluation, prediction
    and loading launch nothing. Beside: a bare TrainStep over the same
    64-image batches, before and after the fits (the hapi loop's own
    cost is the difference), and the lenet phase's TrainStep at B =
    256."""
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO
    from paddle_tpu_torch.vision.datasets import MNIST

    train, test = MNIST(mode='train'), MNIST(mode='test')
    steps = len(train) // HAPI_B
    np.random.seed(0)
    batches = [(x.to('cuda'), y.to('cuda')) for x, y in
               DataLoader(train, batch_size=HAPI_B, shuffle=True)]
    bare_ms = [bare_trainstep_ms(torch, batches)]
    total, runs = {}, []
    for jit, workers in HAPI_RUNS:
        model = lenet_hapi_model(torch, 'cuda', jit)
        launches, clock, wall = _hapi_fit(
            torch, model, train, batch_size=HAPI_B, epochs=1,
            num_workers=workers)
        check_exact_launches(f'hapi_lenet jit={jit} workers={workers}',
                             launches, {FO.STEP: steps})
        _add_launches(total, launches)
        losses = clock.losses
        if len(losses) != steps or not np.isfinite(losses).all() or \
                not np.mean(losses[-4:]) < np.mean(losses[:4]):
            raise AssertionError(f'hapi_lenet jit={jit}: losses {losses}')
        timed = clock.step_s[1:]
        ms = 1e3 * float(np.mean(timed))
        runs.append({'jit': jit, 'num_workers': workers, 'steps': steps,
                     'fit_s': wall, 'first_step_s': clock.step_s[0],
                     'ms_per_step': ms, 'ms_per_step_median':
                         1e3 * float(np.median(timed)),
                     'images_per_sec': HAPI_B / (ms / 1e3),
                     'losses': losses, 'launches': launches})
        if (jit, workers) == (True, 0):
            kept = model
        del model
    # evaluate, predict, save, load into a fresh Model
    _build.reset_launches()
    ev = {k: float(v) for k, v in kept.evaluate(
        test, batch_size=HAPI_B, verbose=0).items()}
    images = TensorDataset([test.images.astype(np.float32)[:, None]
                            / 255.0])
    pred = kept.predict(images, batch_size=HAPI_B, stack_outputs=True)
    path = os.path.join('build', 'hapi', 'lenet')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    kept.save(path)
    fresh = lenet_hapi_model(torch, 'cuda', True)
    fresh.load(path)
    ev2 = {k: float(v) for k, v in fresh.evaluate(
        test, batch_size=HAPI_B, verbose=0).items()}
    check_exact_launches('hapi_lenet evaluate/predict/load',
                         _build.routes_snapshot(), {})
    if pred[0].shape != (len(test), 10) or not np.isfinite(pred[0]).all() \
            or not np.isfinite([ev['loss'], ev['acc']]).all():
        raise AssertionError(f'hapi_lenet: evaluate {ev}, predict '
                             f'{pred[0].shape}')
    if abs(ev2['loss'] - ev['loss']) > 1e-6 * abs(ev['loss']) or \
            ev2['acc'] != ev['acc']:
        raise AssertionError(f'hapi_lenet: loaded model evaluates {ev2}, '
                             f'the saved one {ev}')
    bare_ms.append(bare_trainstep_ms(torch, batches))
    del batches, kept, fresh
    free_cuda(torch)
    jit0 = runs[0]['ms_per_step']
    rec = {'phase': 'hapi_lenet', 'card': card, 'nvidia_smi': smi,
           'model': 'LeNet(10)', 'dataset': 'MNIST(mode=train), 2048 '
           'images', 'batch': HAPI_B, 'optimizer': 'Adam(1e-3)',
           'runs': runs, 'evaluate': ev, 'evaluate_loaded': ev2,
           'predict_shape': list(pred[0].shape),
           'bare_trainstep_b64_ms_per_step': bare_ms,
           'hapi_loop_ms_per_step': jit0 - float(np.mean(bare_ms)),
           'lenet_phase_trainstep_b256_ms_per_step': lenet_ms,
           'launches': total, **cudnn_settings(torch)}
    emit(rec)
    return total, rec


def bare_trainstep_ms(torch, batches):
    """ms a step of a bare TrainStep (LeNet, Adam 1e-3, one loss read a
    step, as the hapi loop reads it) over pre-collated card batches."""
    from paddle_tpu_torch.jit import TrainStep

    model = lenet_hapi_model(torch, 'cuda', True)
    step = TrainStep(model.network, xent_hapi, model._optimizer,
                     device='cuda')
    step_s = []
    for x, y in batches:
        t0 = time.perf_counter()
        float(step(x, y))
        step_s.append(time.perf_counter() - t0)
    return 1e3 * float(np.mean(step_s[1:]))


def xent_hapi(model, x, y):
    from paddle_tpu_torch import nn as pnn
    return pnn.functional.cross_entropy(model(x), y)


def pad_collate(batch):
    """An Imdb batch: docs right-padded with 0 to the longest; labels
    [N, 1] int64."""
    import torch
    n = max(len(d) for d, _ in batch)
    ids = np.zeros((len(batch), n), np.int64)
    for i, (d, _) in enumerate(batch):
        ids[i, :len(d)] = d
    return (torch.from_numpy(ids),
            torch.from_numpy(np.asarray([[y] for _, y in batch], np.int64)))


def text_model(torch, name, device):
    from paddle_tpu_torch import text

    gen = torch.Generator(device=device).manual_seed(3)
    if name == 'LSTMSentiment':
        return text.LSTMSentiment(direction='bidirect', device=device,
                                  generator=gen)
    return text.BoWClassifier(device=device, generator=gen)


def text_hapi_model(torch, net, device):
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import Adam

    model = Model(net, device=device)
    model.prepare(Adam(learning_rate=HAPI_TEXT['lr'],
                       parameters=net.parameters()), pnn.CrossEntropyLoss())
    return model


def hapi_text_phase(torch, card, smi):
    """hapi_text: LSTMSentiment at its class defaults (vocabulary 10000,
    embed 64, hidden 64) with direction='bidirect', and BoWClassifier,
    each fit through Model (eager, Adam 1e-2) for HAPI_TEXT['epochs']
    epochs of Imdb(mode='train') (512 synthetic docs of 8-63 words) at
    batch 64, padded per batch. Row 15 launches once a step and nothing
    else launches; the last epoch's mean loss is below the first's. Then
    the same weights on the card and on the CPU take the same first
    HAPI_TEXT['check_steps'] steps: losses within check_rtol."""
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.ops.kernels import fused_optimizer as FO
    from paddle_tpu_torch.text import Imdb

    cfg = HAPI_TEXT
    data = Imdb(mode='train')
    steps = -(-len(data) // cfg['B'])
    total, rows = {}, []
    for name in ('LSTMSentiment', 'BoWClassifier'):
        net = text_model(torch, name, 'cuda')
        start = {k: v.detach().cpu().clone()
                 for k, v in net.state_dict().items()}
        model = text_hapi_model(torch, net, 'cuda')
        loader = DataLoader(data, batch_size=cfg['B'], shuffle=True,
                            collate_fn=pad_collate)
        launches, clock, wall = _hapi_fit(torch, model, loader,
                                          epochs=cfg['epochs'])
        check_exact_launches(f'hapi_text {name}', launches,
                             {FO.STEP: steps * cfg['epochs']})
        _add_launches(total, launches)
        losses = clock.losses
        first, last = np.mean(losses[:steps]), np.mean(losses[-steps:])
        if not np.isfinite(losses).all() or not last < first:
            raise AssertionError(f'hapi_text {name}: losses {losses}')
        # card against CPU from the same weights on the same batches
        check = []
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        for device in ('cuda', 'cpu'):
            net = text_model(torch, name, device)
            net.load_state_dict(start)
            m = text_hapi_model(torch, net, device)
            np.random.seed(0)
            got = []
            for i, (x, y) in enumerate(loader):
                if i == cfg['check_steps']:
                    break
                got.append(m.train_batch([x], [y])[0][0])
            check.append(got)
        torch.backends.cudnn.allow_tf32 = saved
        rel = float(np.max(np.abs(np.subtract(*check)) /
                           np.abs(check[1])))
        if rel > cfg['check_rtol']:
            raise AssertionError(f'hapi_text {name}: card {check[0]} CPU '
                                 f'{check[1]}')
        timed = clock.step_s[1:]
        rows.append({'model': name, 'params': sum(
            p.numel() for p in model.network.parameters()),
            'steps': len(losses), 'fit_s': wall,
            'ms_per_step': 1e3 * float(np.mean(timed)),
            'first_epoch_loss': first, 'last_epoch_loss': last,
            'losses': losses, 'card_vs_cpu_losses': check,
            'card_vs_cpu_max_rel': rel, 'launches': launches})
        del model, net, m
        free_cuda(torch)
    rec = {'phase': 'hapi_text', 'card': card, 'nvidia_smi': smi,
           'dataset': 'Imdb(mode=train), 512 docs', 'batch': cfg['B'],
           'optimizer': f"Adam({cfg['lr']})", 'epochs': cfg['epochs'],
           'models': rows, 'launches': total, **cudnn_settings(torch)}
    emit(rec)
    return total, rec


def _rnn_layer(torch, mode, device, gen, **shape):
    from paddle_tpu_torch import nn as pnn

    cls = {'LSTM': pnn.LSTM, 'GRU': pnn.GRU, 'SimpleRNN': pnn.SimpleRNN}[mode]
    return cls(shape['C'], shape['H'], num_layers=shape['layers'],
               direction='bidirect', device=device, generator=gen)


def rnn_flops(mode, B, T, C, H, layers):
    """Multiply-add FLOPs of a bidirectional stack's forward: the input
    and recurrent products of every gate, both directions."""
    g = {'LSTM': 4, 'GRU': 3, 'SimpleRNN': 1}[mode]
    total = 0
    for layer in range(layers):
        inp = C if layer == 0 else 2 * H
        total += 2 * 2 * B * T * (inp + H) * g * H
    return total


def library_rnn(torch, mode, layer, x, iters):
    """The yardstick: torch.nn's own module of the mode on the same
    weights (its parameters flattened into one cuDNN buffer): forward
    and forward+backward device ms, host ms a call on an idle queue."""
    cls = {'LSTM': torch.nn.LSTM, 'GRU': torch.nn.GRU,
           'SimpleRNN': torch.nn.RNN}[mode]
    lib = cls(layer.input_size, layer.hidden_size, layer.num_layers,
              batch_first=True, bidirectional=True).to(x.device)
    lib.load_state_dict(layer.state_dict())
    host = []
    with torch.no_grad():
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lib(x)
            host.append(time.perf_counter() - t0)
        fwd = event_ms(torch, lambda: lib(x), iters=iters)
    both = event_ms(torch, lambda: lib(x)[0].sum().backward(), iters=iters)
    return {'library_fwd_ms': fwd, 'library_fwd_bwd_ms': both,
            'library_host_ms_per_call': 1e3 * float(np.median(host)),
            'library': f'torch.nn.{cls.__name__}'}


def rnn_phase(torch, card, smi):
    """rnn: LSTM, GRU and SimpleRNN at B = 64, T = 128, input and hidden
    512, 2 layers, bidirectional, fp32, each ONE call of torch's
    recurrent op (cuDNN): forward and forward+backward device ms (CUDA
    events over RNN_SHAPE['iters'] calls) and host ms a call (the
    enqueue of one call on an idle queue); then at a small size with
    sequence_length, the card's outputs and final states against the
    CPU's on the same weights (max relative error under
    RNN_CHECK['rtol'], cuDNN TF32 off). Beside each, torch.nn's module
    on the same weights (library_rnn). No port kernel launches."""
    from paddle_tpu_torch.ops.kernels import _build

    s = RNN_SHAPE
    _build.reset_launches()
    rows = []
    for mode in ('LSTM', 'GRU', 'SimpleRNN'):
        gen = torch.Generator(device='cuda').manual_seed(5)
        layer = _rnn_layer(torch, mode, 'cuda', gen, **s)
        x = torch.randn(s['B'], s['T'], s['C'], device='cuda',
                        generator=gen, requires_grad=True)
        for _ in range(2):
            layer(x)[0].sum().backward()
        torch.cuda.synchronize()
        host = []
        with torch.no_grad():
            for _ in range(s['iters']):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                layer(x)
                host.append(time.perf_counter() - t0)
        with torch.no_grad():
            fwd = event_ms(torch, lambda: layer(x), iters=s['iters'])
        both = event_ms(torch, lambda: layer(x)[0].sum().backward(),
                        iters=s['iters'])
        flops = rnn_flops(mode, s['B'], s['T'], s['C'], s['H'],
                          s['layers'])
        lib = library_rnn(torch, mode, layer, x, s['iters'])
        rows.append({'mode': mode, 'fwd_ms': fwd, 'fwd_bwd_ms': both,
                     'host_ms_per_call': 1e3 * float(np.median(host)),
                     'fwd_flops': flops,
                     'fwd_tflops_per_s': flops / (fwd / 1e3) / 1e12,
                     **lib})
        del layer, x
    free_cuda(torch)
    c = RNN_CHECK
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for mode in ('LSTM', 'GRU', 'SimpleRNN'):
            gen = torch.Generator().manual_seed(6)
            cpu = _rnn_layer(torch, mode, 'cpu', gen, **c)
            card_layer = _rnn_layer(torch, mode, 'cuda', None, **c)
            card_layer.load_state_dict(cpu.state_dict())
            x = torch.randn(c['B'], c['T'], c['C'], generator=gen)
            lens = torch.tensor(c['lens'])
            with torch.no_grad():
                want = cpu(x, sequence_length=lens)
                got = card_layer(x.to('cuda'), sequence_length=lens)
            pairs = [(got[0], want[0])] + list(zip(
                got[1] if mode == 'LSTM' else [got[1]],
                want[1] if mode == 'LSTM' else [want[1]]))
            err = max(float(((g.cpu() - w).abs().max()) /
                            w.abs().max()) for g, w in pairs)
            if err > c['rtol'] or got[0].cpu()[3, 1:].abs().max() != 0:
                raise AssertionError(f'rnn check {mode}: {err}')
            next(r for r in rows if r['mode'] == mode)[
                'card_vs_cpu_max_rel'] = err
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    launches = _build.routes_snapshot()
    check_exact_launches('rnn', launches, {})
    rec = {'phase': 'rnn', 'card': card, 'nvidia_smi': smi,
           'shape': s, 'check': {k: list(v) if isinstance(v, tuple) else v
                                 for k, v in c.items()},
           'direction': 'bidirect', 'dtype': 'float32',
           'route': 'torch._VF (cuDNN), one call a stack', 'rows': rows,
           **cudnn_settings(torch)}
    emit(rec)
    return rec


def beam_parts(torch, device, gen=None):
    from paddle_tpu_torch import nn as pnn

    b = BEAM
    kw = dict(device=device, generator=gen)
    emb = pnn.Embedding(b['V'], b['H'], **kw)
    cell = pnn.LSTMCell(b['H'], b['H'], **kw)
    proj = pnn.Linear(b['H'], b['V'], **kw)
    return emb, cell, proj


def _raw_decoder():
    """The port's BeamSearchDecoder, keeping the raw per-step token and
    parent ids that finalize backtraces (its steps are the port's own)."""
    from paddle_tpu_torch import nn as pnn

    class RawDecoder(pnn.BeamSearchDecoder):
        def finalize(self, outputs, final_states, sequence_lengths):
            self.raw = (outputs['predicted_ids'], outputs['parent_ids'])
            return super().finalize(outputs, final_states,
                                    sequence_lengths)
    return RawDecoder


def _margin_decoder(torch):
    """A _raw_decoder that also records, each step, each batch row's
    least gap between adjacent candidates among its W + 1 best (from the
    same ops on the same values as the step's own: it runs the cell and
    the projection a second time, so it serves the CPU reference, not
    the timed decode)."""
    import torch.nn.functional as F

    class MarginDecoder(_raw_decoder()):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.margins = []

        def step(self, time, inputs, states, **kwargs):
            B, W = self._batch, self.beam_size
            logits = self.output_fn(self.cell(inputs, states['cell'])[0])
            V = logits.shape[-1]
            lp = F.log_softmax(logits.float(), dim=-1).reshape(B, W, V)
            frozen = torch.full((V,), -1e9, dtype=lp.dtype,
                                device=lp.device)
            frozen[self.end_token] = 0.0
            lp = torch.where(states['finished'][..., None], frozen, lp)
            top = (states['log_probs'][..., None] + lp).reshape(
                B, W * V).topk(W + 1).values
            self.margins.append((top[:, :-1] - top[:, 1:]).min(1).values)
            return super().step(time, inputs, states, **kwargs)
    return MarginDecoder


def _beam_decode(torch, cls, emb, cell, proj, h0):
    from paddle_tpu_torch import nn as pnn

    b = BEAM
    dec = cls(cell, start_token=b['start'], end_token=b['end'],
              beam_size=b['W'], embedding_fn=emb, output_fn=proj)
    with torch.no_grad():
        out, final = pnn.dynamic_decode(dec, inits=(h0, h0.clone()),
                                        max_step_num=b['steps'])
    return out, final, dec


def beam_phase(torch, card, smi):
    """beam: BeamSearchDecoder over an LSTMCell at hidden 512 and a
    vocabulary of 10000 (Embedding, LSTMCell, Linear from a seeded
    generator; the embedding and projection scaled by BEAM['emb_scale']
    and ['proj_scale'], since at their initial scales the hidden state
    shrinks to ~0.01 and the next-token distribution is near uniform),
    beam 4, batch 16, at most 64 steps, on the card through the port's
    BeamSearchDecoder: ms a step (one host read of the all-finished flag
    a step); then the
    same fp32 decode on the CPU on the same weights gives the same token
    and parent ids at every step of every row up to that row's first
    near-tie (two of its W + 1 best candidates within BEAM['margin'] on
    the CPU, where fp32 rounding may order them either way), and the
    same backtraced ids and scores for the rows without one. No port
    kernel launches."""
    from paddle_tpu_torch.ops.kernels import _build

    b = BEAM
    gen = torch.Generator(device='cuda').manual_seed(11)
    card_parts = beam_parts(torch, 'cuda', gen)
    with torch.no_grad():
        card_parts[0].weight.mul_(b['emb_scale'])
        card_parts[2].weight.mul_(b['proj_scale'])
    h0 = torch.randn(b['B'], b['H'], device='cuda', generator=gen)
    timed = []
    for _ in range(2):                          # a warm-up, then timed
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out, final, dec = _beam_decode(torch, _raw_decoder(),
                                       *card_parts, h0)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
    wall = timed[-1]
    check_exact_launches('beam', _build.routes_snapshot(), {})
    steps = out['predicted_ids'].shape[1]
    cpu_parts = beam_parts(torch, 'cpu')
    for c, g in zip(cpu_parts, card_parts):
        c.load_state_dict(g.state_dict())
    want, _, cdec = _beam_decode(torch, _margin_decoder(torch),
                                 *cpu_parts, h0.cpu())
    # each row is compared up to its first step whose CPU candidates lie
    # within BEAM['margin'] of each other (fp32 rounding may order them
    # either way there); in full when it has none
    margins = torch.stack(cdec.margins)                      # [T, B]
    tied = margins < b['margin']
    first = torch.where(tied.any(0), tied.float().argmax(0),
                        torch.full((b['B'],), steps)).tolist()
    raw_card = [t.cpu() for t in dec.raw]
    bad = []
    for row, t in enumerate(first):
        for got, ref in zip(raw_card, cdec.raw):
            if not torch.equal(got[:t, row], ref[:t, row]):
                bad.append(row)
        if t == steps and not torch.equal(
                out['predicted_ids'][row].cpu(), want['predicted_ids'][row]):
            bad.append(row)
    if bad or want['predicted_ids'].shape[1] != steps:
        raise AssertionError(f'beam: ids differ from the CPU in rows '
                             f'{sorted(set(bad))} before any near-tie')
    whole = [r for r, t in enumerate(first) if t == steps]
    score_err = float((out['scores'][whole].cpu() -
                       want['scores'][whole]).abs().max()) if whole else None
    rec = {'phase': 'beam', 'card': card, 'nvidia_smi': smi,
           'config': b, 'steps': steps,
           'finished': int(final['finished'].sum()),
           'ms_per_step': 1e3 * wall / steps, 'decode_s': wall,
           'warmup_s': timed[0], 'host_reads': steps,
           'rows_equal_cpu_whole': len(whole),
           'rows_cut_at_near_tie': {r: t for r, t in enumerate(first)
                                    if t < steps},
           'min_margin_cpu': float(margins.min()),
           'max_score_diff_cpu_whole_rows': score_err,
           'best_scores': out['scores'][:, -1, 0].tolist()}
    del card_parts, cpu_parts, out, want
    free_cuda(torch)
    emit(rec)
    return rec


def hapi_phase(torch, card, smi, lenet_ms):
    """The high-level API on the card: hapi_lenet, hapi_text, rnn, beam;
    returns the port kernels' launches over the two hapi fits' main
    paths (row 15 only) and the phase's seconds."""
    t0 = time.perf_counter()
    lenet_launches, _ = hapi_lenet_phase(torch, card, smi, lenet_ms)
    text_launches, _ = hapi_text_phase(torch, card, smi)
    rnn_phase(torch, card, smi)
    beam_phase(torch, card, smi)
    total = {}
    for launches in (lenet_launches, text_launches):
        _add_launches(total, launches)
    return total, time.perf_counter() - t0


SOURCES = {
    'paged_attention': ('paddle_tpu_torch/csrc/paged_attention.cu',
                        'paddle_tpu/ops/pallas/paged_attention.py:78'),
    'paged_attention_int8': ('paddle_tpu_torch/csrc/paged_attention.cu',
                             'paddle_tpu/ops/pallas/paged_attention.py:93'),
    'layer_norm': ('paddle_tpu_torch/csrc/fused_norm.cu',
                   'paddle_tpu/ops/pallas/fused_norm.py:52'),
    'bias_gelu': ('paddle_tpu_torch/csrc/fused_elementwise.cu',
                  'paddle_tpu/ops/pallas/fused_elementwise.py:64'),
    'layer_norm_bwd': ('paddle_tpu_torch/csrc/fused_norm.cu',
                       'paddle_tpu/ops/pallas/fused_norm.py:63'),
    'bias_gelu_bwd': ('paddle_tpu_torch/csrc/fused_elementwise.cu',
                      'paddle_tpu/ops/pallas/fused_elementwise.py:69'),
    'flash_fwd': ('paddle_tpu_torch/csrc/flash_attention.cu',
                  'paddle_tpu/ops/pallas/flash_attention.py:278'),
    'flash_bwd_dq': ('paddle_tpu_torch/csrc/flash_attention.cu',
                     'paddle_tpu/ops/pallas/flash_attention.py:336'),
    'flash_bwd_dkv': ('paddle_tpu_torch/csrc/flash_attention.cu',
                      'paddle_tpu/ops/pallas/flash_attention.py:390'),
    'flash_bhld_fwd': ('paddle_tpu_torch/csrc/flash_attention.cu',
                       'paddle_tpu/ops/pallas/flash_attention.py:68'),
    'flash_bhld_bwd_dq': ('paddle_tpu_torch/csrc/flash_attention.cu',
                          'paddle_tpu/ops/pallas/flash_attention.py:137'),
    'flash_bhld_bwd_dkv': ('paddle_tpu_torch/csrc/flash_attention.cu',
                           'paddle_tpu/ops/pallas/flash_attention.py:191'),
    'dropout_add': ('paddle_tpu_torch/csrc/fused_elementwise.cu',
                    'paddle_tpu/ops/pallas/fused_elementwise.py:149'),
    'dropout_add_bwd': ('paddle_tpu_torch/csrc/fused_elementwise.cu',
                        'paddle_tpu/ops/pallas/fused_elementwise.py:156'),
    'grad_stats': ('paddle_tpu_torch/csrc/fused_optimizer.cu',
                   'paddle_tpu/ops/pallas/fused_optimizer.py:81'),
    'optimizer_step': ('paddle_tpu_torch/csrc/fused_optimizer.cu',
                       'paddle_tpu/ops/pallas/fused_optimizer.py:117'),
}
SERVE_KERNELS = ('paged_attention', 'layer_norm', 'bias_gelu')
PAGED_KERNELS = ('paged_attention', 'paged_attention_int8')


def free_cuda(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 LM head in fp32
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({'phase': 'device', 'card': card, 'nvidia_smi': smi,
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda})

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'library': os.path.relpath(lib_path),
          'sources': [os.path.relpath(s) for s in _build.sources()]})

    t0 = time.perf_counter()
    results = kernel_phase(torch, F)
    train_rows, pipe_rows = train_kernel_phase(torch, F)
    free_cuda(torch)
    bhld_rows = bhld_kernel_phase(torch, F)
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_launches, served = serve_phase(torch, card)
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    int8_launches = serve_int8_phase(torch, card, served)
    serve_int8_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_modes_phase(torch, card, served)
    free_cuda(torch)
    serve_modes_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tenants_launches = serve_tenants_phase(torch, card, served)
    serve_tenants_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiered_launches = serve_tiered_phase(torch, card, served)
    free_cuda(torch)
    serve_tiered_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cluster_launches, cluster_rec = serve_cluster_phase(torch, card, served)
    free_cuda(torch)
    serve_cluster_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    disagg_launches = serve_disagg_phase(torch, card, served)
    del served
    free_cuda(torch)
    serve_disagg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    workers_launches = serve_workers_phase(torch, card, cluster_rec)
    free_cuda(torch)
    serve_workers_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_launches, train_peak = train_phase(torch, card)
    free_cuda(torch)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    opt_rows = optimizer_kernel_phase(torch)
    free_cuda(torch)
    opt_kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rules_phase(torch)
    free_cuda(torch)
    rules_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bucketed_launches, bucketed_peak = train_bucketed_phase(torch, card)
    free_cuda(torch)
    bucketed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole_path_check(torch)
    free_cuda(torch)
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipeline_launches_run = pipeline_phase(
        torch, card, {'train': train_peak, 'train_bucketed': bucketed_peak})
    pipeline_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipeline_check(torch)
    pipeline_check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    param_route_check(torch)
    free_cuda(torch)
    update_route_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    amp_launches = pipeline_amp_phase(torch, card)
    pipeline_amp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    telemetry_phase(torch, card)
    telemetry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    linear_xent_check(torch)
    free_cuda(torch)
    linear_xent_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bert_rows = bert_kernel_rows(torch, F)
    bert_launches_run, bert_rows['optimizer_step'] = bert_phase(torch, card)
    free_cuda(torch)
    bert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bert_check(torch)
    bert_check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode_launches_run = dense_decode_phase(torch, card)
    free_cuda(torch)
    dense_decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lenet_launches, lenet_ms = lenet_phase(torch, card)
    free_cuda(torch)
    lenet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resnet50_launches = resnet50_phase(torch, card)
    free_cuda(torch)
    resnet50_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vision_check(torch)
    free_cuda(torch)
    vision_check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    deepfm_launches = deepfm_ps_phase(torch, card, smi)
    deepfm_ps_check(torch)
    free_cuda(torch)
    deepfm_ps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ps_scale_ssd_phase(card, smi, **PS_SCALE)
    ps_scale_ssd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctr_launches, ctr_state = ctr_ps_phase(torch, card, smi)
    ctr_ps_check(torch, ctr_state)
    free_cuda(torch)
    ctr_ps_s = time.perf_counter() - t0
    surface_launches, surface_rec = surface_phase(torch, card, smi)
    free_cuda(torch)
    hapi_launches, hapi_s = hapi_phase(torch, card, smi, lenet_ms)
    emit({'phase': 'seconds', 'kernel': kernel_s, 'serve': serve_s,
          'serve_int8': serve_int8_s, 'serve_modes': serve_modes_s,
          'serve_tenants': serve_tenants_s, 'serve_tiered': serve_tiered_s,
          'serve_cluster': serve_cluster_s, 'serve_disagg': serve_disagg_s,
          'serve_workers': serve_workers_s,
          'train': train_s, 'optimizer_kernels': opt_kernel_s,
          'rules': rules_s, 'train_bucketed': bucketed_s,
          'check': check_s, 'pipeline': pipeline_s,
          'pipeline_check': pipeline_check_s,
          'update_route': update_route_s, 'pipeline_amp': pipeline_amp_s,
          'telemetry': telemetry_s,
          'linear_xent': linear_xent_s, 'bert': bert_s,
          'bert_check': bert_check_s, 'dense_decode': dense_decode_s,
          'lenet': lenet_s, 'resnet50': resnet50_s,
          'vision_check': vision_check_s, 'deepfm_ps': deepfm_ps_s,
          'ps_scale_ssd': ps_scale_ssd_s, 'ctr_ps': ctr_ps_s,
          'surface': surface_rec['seconds'],
          'surface_sweep': surface_rec['sweep_s'], 'hapi': hapi_s})

    def row_of(name, path):
        (row,) = [r for r in results[name] if r['path'] == path]
        return row

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        if name in SERVE_KERNELS:
            # the shape a gpt_1p3b decode step gives the kernel: LayerNorm
            # over hidden 2048, bias+GELU over ffn 8192, attention at B=8
            row = row_of(name, 'decode')
            launches = serve_launches[name]
        elif name == 'paged_attention_int8':
            # the serve over int8 pages (serve_int8), at its decode shape
            row = row_of(name, 'decode')
            launches = int8_launches[name]
        elif name in BUCKETED_KERNELS:
            row = opt_rows[name]
            launches = bucketed_launches[name]
        elif name in BHLD_KERNELS:
            row = bhld_rows[name]
            launches = bucketed_launches[name]
        else:
            row = train_rows[name]
            launches = train_launches[name]
        entry = {
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches,
            'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
            'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
            'bound_by': row['bound_by'], 'library_ms': row['library_ms'],
            'shape': row['shape']}
        if name in ROW_PATHS:
            # on both paths: the train step's launches and shape too
            train = row_of(name, 'train')
            entry['launches_train'] = train_launches[name]
            entry['train_shape'] = {k: train[k] for k in (
                'shape', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                'library_ms')}
        if name in TRAIN_KERNELS:
            entry['launches_train_bucketed'] = bucketed_launches[name]
            # at the pipeline leg's micro-batch (B = 2): its shape
            pipe = row_of(name, 'pipeline') if name in ROW_PATHS \
                else pipe_rows[name]
            entry['pipeline_shape'] = {k: pipe[k] for k in (
                'shape', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                'library_ms')}
        # the pipeline leg's 5 timed steps (0 for the kernels off its path)
        entry['launches_pipeline'] = pipeline_launches_run[name]
        if name in BUCKETED_KERNELS[:2]:
            # the per-parameter routes: the train step's update, and the
            # loss-scaled pipeline steps' found-inf counts and updates
            entry['launches_train'] = train_launches[name]
            entry['launches_pipeline_amp'] = amp_launches[name]
        if name in BERT_KERNELS:
            # the BERT leg's timed steps, and the kernel at its shapes
            entry['launches_bert'] = bert_launches_run[name]
            if name in bert_rows:
                bert = bert_rows[name]
                entry['bert_shape'] = {k: bert[k] for k in (
                    'shape', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                    'bound_by', 'library_ms')}
        if name in ('layer_norm', 'bias_gelu'):
            entry['launches_dense_decode'] = decode_launches_run[name]
        # the vision legs' timed steps (row 15 alone runs there)
        entry['launches_lenet'] = lenet_launches[name]
        entry['launches_resnet50'] = resnet50_launches[name]
        # the serving cluster's pass: both replicas on the one card
        entry['launches_cluster'] = cluster_launches[name]
        # one disaggregated engine's pass, and the two worker processes'
        # launches over their clean and forced-hang passes
        entry['launches_serve_disagg'] = disagg_launches[name]
        entry['launches_serve_workers'] = workers_launches.get(name, 0)
        # the DeepFM PS leg's run (its dense step is torch's own ops)
        entry['launches_deepfm_ps'] = deepfm_launches[name]
        # the CTR path's run: row 15 once an Adam step, 0 elsewhere
        entry['launches_ctr_ps'] = ctr_launches[name]
        # the op surface: row 15 twice a surface_train step (two
        # learning-rate groups) and twice in its CPU check, 0 elsewhere
        entry['launches_surface'] = surface_launches[name]
        # the high-level API: row 15 once a hapi jit step and once a
        # learning-rate group an eager step (hapi_lenet's four fits and
        # hapi_text's two), 0 elsewhere
        entry['launches_hapi'] = hapi_launches.get(name, 0)
        if name in SERVE_KERNELS:
            # the tenants leg's SLO run and the oversubscribed serve
            entry['launches_serve_tenants'] = tenants_launches[name]
            entry['launches_serve_tiered'] = tiered_launches[name]
        if name == 'optimizer_step':
            entry['rules'] = row['rules']
        if name == 'grad_stats':
            entry['typical_bucket'] = row['typical_bucket']
        for key in ('pair_over_library', 'over_library', 'floor_ms',
                    'host_us', 'library_host_us'):
            if key in row:
                entry[key] = row[key]
        if name in PAGED_KERNELS:
            # the serve's prefill window and the long-context decode
            entry['qb_splits_tiles_per_split'] = row[
                'qb_splits_tiles_per_split']
            for label in ('prefill', 'long', 'prefill64'):
                other = row_of(name, label)
                entry[f'{label}_shape'] = {k: other.get(k) for k in (
                    'shape', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                    'library_ms', 'dense_ms', 'qb_splits_tiles_per_split')
                    if k in other}
        if name == 'paged_attention_int8':
            entry.update(
                library_note=row['library_note'], dense_ms=row['dense_ms'],
                launches_bf16_serve=serve_launches[name])
        kernels.append(entry)
    emit({'kernels': kernels})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': card,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
