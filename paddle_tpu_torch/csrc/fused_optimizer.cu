// Fused optimizer step, for Hopper (sm_90a): the gradient statistics pass
// over a flat bucket, and the one-pass update of a list of tensors (buckets
// or parameters) in one launch.
//
// Replaces: paddle_tpu/ops/pallas/fused_optimizer.py:81 `_stats_kernel`
// (launched by `grad_stats_pallas`, :96, from core/bucketing.grad_stats:565)
// and :117 `_update_kernel` (launched by `fused_shard_update`, :164, from
// core/bucketing.shard_update:581) on jit.TrainStep's bucketed route, and
// the per-parameter updates that XLA fuses into a pass a parameter
// (spmd_pipeline.py:2113 `_update_one`, optimizer.py:103 `functional_apply`).
//
// What bounds them on this card: bytes. grad_stats reads each gradient once
// (2 bytes an element in bf16) and does 3 operations an element; the update
// reads p and g and the states and writes p and the states once each (AdamW
// with bf16 p, g and moments and no master: 14 bytes an element) with ~20
// fp32 operations an element, far below the ~295 operations a byte at which
// the H100's compute would bound them.
//
// grad_stats design: ONE launch of `ctas` CTAs of 256 threads (the wrapper's
// `grad_stats_grid`: up to 8 an SM, fewer when the bucket is small). Bytes
// in flight are what a streaming read needs on this card (3.35 TB/s x ~1 us
// / 132 SMs is ~25 KB an SM, more under load): on each trip a thread issues
// kStatsUnroll = 4 independent 16-byte loads, so an SM has 4 x 16 B x 2048
// threads = 128 KB in flight (4 CTAs an SM, 64 KB, measured 6 % slower on
// the largest bucket; a ring of 8 KB cp.async.bulk stages level with it
// there and slower on a typical bucket: PERF.md). The Pallas body accumulates across a SEQUENTIAL grid into (1, 1)
// outputs; CTAs have no order, so each CTA writes its (sum, count) partial,
// fences it (__threadfence) and draws a ticket with one integer atomicAdd;
// the CTA that draws the last ticket sums every partial in a fixed order,
// writes `out` and resets the ticket to 0 for the next call. No float
// atomics: the result is the same bits on every call.
// Summation order (tests/test_torch_reduce.py emulates it on the CPU). With
// S = ctas x 256 threads, g a thread's global index, V = 16 bytes of
// elements (8 bf16, 4 fp32) and nvec = n / V vectors when x is 16-byte
// aligned (else 0):
//   1. thread g adds, from s = 0, the vectors g + (4 i + k) S (i = 0, 1, ...;
//      k = 0..3; each below nvec) in that order, each vector's squares summed
//      pairwise first, ((q0 + q1) + (q2 + q3)) [+ ((q4 + q5) + (q6 + q7))];
//      then the elements nvec V + g + j S, one square at a time;
//   2. a warp's 32 sums by the xor-shuffle tree (offsets 16, 8, 4, 2, 1);
//   3. a CTA's 8 warp sums in warp order, from 0: the CTA's partial;
//   4. the last CTA: thread t adds the partials t, t + 256, ... in order from
//      0, then steps 2 and 3 again, into out[0].
// Nonfinite counts are integers, exact in any order; out[1] is their total
// as fp32. Every multiply and add is an explicitly rounded intrinsic, so
// nvcc contracts nothing and the emulation's fp32 ops round where these do.
// The sum is not masked, so a NaN or an inf poisons it as the jnp
// reference's jnp.sum(g * g) does; that needs IEEE semantics, so this file is
// never built with fast math.
//
// Update design. What bounds it is bytes: the update streams each operand
// once (AdamW with bf16 p, g and moments and no master: 14 bytes an element;
// bf16 p and g with an fp32 master and moments: 28) at ~20 fp32 operations an
// element. A training step updates hundreds of tensors (293 on the GPT-1.3B
// pipeline, 205 on BERT-base, 123 buckets on the bucketed route), from
// 768-element LayerNorm biases to a 103 M-element embedding, and one launch a
// tensor pays a launch, a grid of its own and a tail for each; the small ones
// are latency-bound, and the host's launches outrun the card. So ONE launch
// updates a list of tensors (`multi_update_kernel`):
//   * the list rides in the kernel's parameters as a table (`Table`, by value,
//     __grid_constant__, up to kTableCap entries: CUDA >= 12.1 takes 32,764
//     bytes of parameters), one column a field: each entry's pointers (p, g,
//     master, the vector states, its old beta powers), its element count, its
//     own decay into the gradient and its first chunk. Nothing is copied to
//     the device and nothing outlives the launch, so the caller reuses its
//     host table for the next step while this launch is still queued. A list
//     longer than the table, or of tensors of other dtypes, takes more
//     launches (the wrapper splits it in a fixed order);
//   * the grid is one CTA a chunk of kChunk = 256 threads x 8 elements of one
//     entry, each thread one 8-element vector (sum over entries of
//     ceil(n / kChunk) CTAs, at least one an entry; chunks of 1, 2, 4 and 8
//     such trips were timed over the training legs' lists on the card, and
//     one trip was the fastest). A CTA finds
//     its entry by a binary search over the first-chunk column (uniform across
//     the CTA, read from the parameter bank), takes its slice in one pass
//     (one-trip CTAs stream at `copy_`'s rate, where resident CTAs walking a
//     tensor reach 82-84 % of it), 16- or 32-byte vectors of every operand
//     where the entry is 16-byte aligned, and the scalar path on the entry's
//     ragged end or where it is not aligned;
//   * every CTA reads its entry's OLD beta powers (Adam's, Adamax's); the CTA
//     holding the entry's first chunk writes the new ones (the old ones on a
//     found-inf skip) into the entry's row of the launch's [entries, 2] fp32
//     output, never over the powers the other CTAs are still reading.
// Each element is updated in the reference's operation order: the prefactor
// multiply, decay into the gradient, the rule in fp32, the found-inf no-op,
// and the parameter write in its dtype beside the fp32 master write. The
// Pallas body traces any elementwise `optimizer.update` into itself; here each
// rule is written out (`apply_rule`): SGD, Momentum (with Nesterov),
// Adam/AdamW, Adagrad, RMSProp (centered or not, with momentum), Adamax,
// Adadelta and DecayedAdagrad (paddle_tpu/optimizer/optimizer.py :398, :415,
// :546, :589, :489, :511, :626, :699, :730), with up to three vector states
// (centered RMSProp's mean square, momentum and mean gradient). The scalars
// that change per step come through a pointer to the step's fp32 block (lr,
// prefactor, found_inf), as the Pallas body's `sc_ref` does, so no step reads
// them back to the host. The same kernel serves the bucketed route (a list of
// buckets) and the per-parameter routes (a list of parameters: the pipeline
// and hybrid engines' updates and `Optimizer.functional_apply`). Where the
// reference rounds the unscaled gradient back to its dtype before the update
// (the pipeline engine's loss-scaling path, spmd_pipeline.py:923-926),
// `round_pref` rounds the prefactored gradient to the gradient's dtype. Vector
// states are updated IN PLACE (each thread reads and writes only its own
// elements), where the JAX step donates its buffers. The found-inf no-op is a
// select: a skipped step writes nothing, so every output stays bit-equal to
// its input even when the gradient is NaN.
//
// Numerics: every multiply, add, divide and square root is an explicitly
// rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc
// contracts nothing into an FMA and each fp32 result rounds where the
// reference's op chain rounds; bf16 gradients widen exactly to fp32.
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a thread takes per step
// elements a CTA of the update takes: one vector a thread
constexpr long long kChunk = static_cast<long long>(kThreads) * kVec;

// rule codes shared with ops/kernels/fused_optimizer.py
enum Rule : int {
  kSGD = 0, kMomentum = 1, kAdam = 2, kAdagrad = 3, kRMSProp = 4,
  kAdamax = 5, kAdadelta = 6, kDecayedAdagrad = 7
};

// Constants of the rule (fixed for a run, so passed by value); the scalars
// that change per step are in device blocks: the step's `sc` and each
// entry's beta powers `pw`:
//   sc[0] lr, sc[1] prefactor, sc[2] found_inf (> 0.5: skip);
//   pw[0] beta1_pow (Adam, Adamax), pw[1] beta2_pow (Adam).
// Each 1 - x constant is the Python double 1 - x rounded once to fp32, as a
// weakly typed scalar is in jnp.
// (each entry's decay into the gradient is in the table)
struct Hyper {
  float coeff;     // AdamW's decoupled decay coefficient
  float b1, b2, omb1, omb2, eps;
  float momentum;
  float rho, omr;  // RMSProp's and Adadelta's rho, DecayedAdagrad's decay
  int nesterov, decoupled, centered, use_pref, round_pref, use_fi;
};

// jnp.maximum: NaN if either side is NaN (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// lr * g / (sqrt(m) + eps): the Adagrad family's step
__device__ __forceinline__ float adagrad_step(float p32, float g32, float m,
                                              float lr, float eps) {
  return __fsub_rn(p32, __fdiv_rn(__fmul_rn(lr, g32),
                                  __fadd_rn(__fsqrt_rn(m), eps)));
}

// ---------------------------------------------------------------------------
// grad_stats
// ---------------------------------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kStatsUnroll = 4;  // independent 16-byte loads a thread a trip

// Σ x² over one 16-byte vector, pairwise (see the order above), and its
// nonfinite elements added to `cnt`
template <typename T>
__device__ __forceinline__ float vec_sq_sum(uint4 raw, unsigned& cnt) {
  constexpr int V = ptt::kVec16<T>;
  float f[V], q[V];
  ptt::unpack(raw, f, T{});
#pragma unroll
  for (int j = 0; j < V; ++j) {
    q[j] = __fmul_rn(f[j], f[j]);
    cnt += !isfinite(f[j]);
  }
  return ptt::pairwise_sum(q);
}

__device__ __forceinline__ unsigned long long warp_sum_u64(
    unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// steps 2 and 3 of the order: the CTA's (sum, count), valid in thread 0.
// `ws`/`wc` are the CTA's 8-slot scratch; the caller keeps a barrier between
// two calls' reads and writes of it.
__device__ __forceinline__ void cta_sum(float s, unsigned long long c,
                                        float* ws, unsigned long long* wc,
                                        float& t, unsigned long long& ct) {
  s = ptt::warp_sum(s);
  c = warp_sum_u64(c);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ws[warp] = s;
    wc[warp] = c;
  }
  __syncthreads();
  t = 0.f;
  ct = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      t = __fadd_rn(t, ws[w]);
      ct += wc[w];
    }
  }
}

// part: [ctas] fp32 sums, then [ctas] uint32 counts; ticket: a zeroed
// uint32 that the last CTA resets
template <typename T>
__global__ void __launch_bounds__(kThreads, 8)  // 8 CTAs an SM: 32 registers
    grad_stats_kernel(const T* __restrict__ x, float* __restrict__ part_sum,
                      unsigned* __restrict__ part_cnt,
                      unsigned* __restrict__ ticket, float* __restrict__ out,
                      long long n, bool vec) {
  constexpr int V = ptt::kVec16<T>;
  __shared__ float ws[kWarps];
  __shared__ unsigned long long wc[kWarps];
  __shared__ bool last;
  const long long S = static_cast<long long>(gridDim.x) * kThreads;
  const long long g =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nvec = vec ? n / V : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  float s = 0.f;
  unsigned cnt = 0;
  for (long long base = g; base < nvec; base += kStatsUnroll * S) {
    uint4 raw[kStatsUnroll];
#pragma unroll
    for (int k = 0; k < kStatsUnroll; ++k) {
      const long long c = base + k * S;
      // a vector past the end adds +0 to s (s >= +0 or NaN): the same bits
      // as skipping it
      raw[k] = c < nvec ? __ldg(xv + c) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kStatsUnroll; ++k)
      s = __fadd_rn(s, vec_sq_sum<T>(raw[k], cnt));
  }
  for (long long i = nvec * V + g; i < n; i += S) {
    const float v = ptt::to_f32(x[i]);
    s = __fadd_rn(s, __fmul_rn(v, v));
    cnt += !isfinite(v);
  }
  float t;
  unsigned long long ct;
  cta_sum(s, cnt, ws, wc, t, ct);
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = t;
    part_cnt[blockIdx.x] = static_cast<unsigned>(ct);
    __threadfence();  // the partial is visible before the ticket is drawn
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last CTA: every other CTA fenced its partial before its ticket;
  // read them from L2 (__ldcg), past this SM's L1
  __threadfence();
  s = 0.f;
  unsigned long long c = 0;
  for (int p = threadIdx.x; p < static_cast<int>(gridDim.x); p += kThreads) {
    s = __fadd_rn(s, __ldcg(part_sum + p));
    c += __ldcg(part_cnt + p);
  }
  cta_sum(s, c, ws, wc, t, ct);
  if (threadIdx.x == 0) {
    out[0] = t;
    out[1] = static_cast<float>(ct);
    *ticket = 0u;  // calls on one device are ordered on its stream
  }
}

template <typename T>
int launch_stats(const void* x, void* part, void* ticket, float* out,
                 long long n, int ctas, cudaStream_t stream) {
  const bool vec = ptt::aligned16(x);
  float* part_sum = static_cast<float*>(part);
  grad_stats_kernel<T><<<ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(x), part_sum,
      reinterpret_cast<unsigned*>(part_sum + ctas),
      static_cast<unsigned*>(ticket), out, n, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the update
// ---------------------------------------------------------------------------
// The rule on one element, in fp32, op for op as optimizer.py's `update`.
// The vector states m1, m2, m3 are, by rule: Momentum's velocity; Adam's
// moment1 and moment2; Adagrad's and DecayedAdagrad's moment; RMSProp's
// mean_square, momentum and (centered) mean_grad; Adamax's moment and
// inf_norm; Adadelta's avg_squared_grad and avg_squared_update. lr_t is
// Adam's bias-corrected lr or Adamax's lr / (1 - beta1_pow).
template <int kRule>
__device__ __forceinline__ float apply_rule(float p32, float g32, float& m1,
                                            float& m2, float& m3,
                                            const Hyper& h, float lr,
                                            float lr_t, float decay) {
  if constexpr (kRule == kSGD) {
    return __fsub_rn(p32, __fmul_rn(lr, g32));
  } else if constexpr (kRule == kMomentum) {
    const float v = __fadd_rn(__fmul_rn(h.momentum, m1), g32);
    m1 = v;
    if (h.nesterov)
      return __fsub_rn(p32,
                       __fmul_rn(lr, __fadd_rn(g32, __fmul_rn(h.momentum, v))));
    return __fsub_rn(p32, __fmul_rn(lr, v));
  } else if constexpr (kRule == kAdagrad) {
    m1 = __fadd_rn(m1, __fmul_rn(g32, g32));
    return adagrad_step(p32, g32, m1, lr, h.eps);
  } else if constexpr (kRule == kDecayedAdagrad) {
    // decay * m + (1 - decay) * g * g
    m1 = __fadd_rn(__fmul_rn(h.rho, m1), __fmul_rn(__fmul_rn(h.omr, g32), g32));
    return adagrad_step(p32, g32, m1, lr, h.eps);
  } else if constexpr (kRule == kRMSProp) {
    m1 = __fadd_rn(__fmul_rn(h.rho, m1), __fmul_rn(__fmul_rn(h.omr, g32), g32));
    float denom;
    if (h.centered) {
      m3 = __fadd_rn(__fmul_rn(h.rho, m3), __fmul_rn(h.omr, g32));
      // sqrt(ms - mg * mg + eps)
      denom = __fsqrt_rn(__fadd_rn(__fsub_rn(m1, __fmul_rn(m3, m3)), h.eps));
    } else {
      denom = __fsqrt_rn(__fadd_rn(m1, h.eps));
    }
    // momentum * mom + lr * g / denom; param - mom
    m2 = __fadd_rn(__fmul_rn(h.momentum, m2),
                   __fdiv_rn(__fmul_rn(lr, g32), denom));
    return __fsub_rn(p32, m2);
  } else if constexpr (kRule == kAdamax) {
    m1 = __fadd_rn(__fmul_rn(h.b1, m1), __fmul_rn(h.omb1, g32));
    m2 = nan_max(__fmul_rn(h.b2, m2), fabsf(g32));
    // param - lr / (1 - b1p) * m / (u + eps)
    return __fsub_rn(p32, __fdiv_rn(__fmul_rn(lr_t, m1), __fadd_rn(m2, h.eps)));
  } else if constexpr (kRule == kAdadelta) {
    m1 = __fadd_rn(__fmul_rn(h.rho, m1), __fmul_rn(__fmul_rn(h.omr, g32), g32));
    // g * sqrt(avg_squared_update + eps) / sqrt(g2 + eps), with the OLD
    // avg_squared_update
    const float upd =
        __fdiv_rn(__fmul_rn(g32, __fsqrt_rn(__fadd_rn(m2, h.eps))),
                  __fsqrt_rn(__fadd_rn(m1, h.eps)));
    m2 = __fadd_rn(__fmul_rn(h.rho, m2), __fmul_rn(__fmul_rn(h.omr, upd), upd));
    return __fsub_rn(p32, __fmul_rn(lr, upd));
  } else {
    // AdamW decays the param before the Adam rule: param * (1 - lr * coeff)
    const float pp = h.decoupled ? __fmul_rn(p32, decay) : p32;
    m1 = __fadd_rn(__fmul_rn(h.b1, m1), __fmul_rn(h.omb1, g32));
    m2 = __fadd_rn(__fmul_rn(h.b2, m2),
                   __fmul_rn(__fmul_rn(h.omb2, g32), g32));
    // param - lr_t * m1 / (sqrt(m2) + eps)
    return __fsub_rn(pp, __fdiv_rn(__fmul_rn(lr_t, m1),
                                   __fadd_rn(__fsqrt_rn(m2), h.eps)));
  }
}

// the gradient as the rule sees it: prefactor multiply (rounded to the
// gradient's dtype under round_pref), then decay into it
template <typename G>
__device__ __forceinline__ float prep_grad(float g32, float p32, float pref,
                                           float wd, const Hyper& h) {
  if (h.use_pref) {
    g32 = __fmul_rn(g32, pref);
    if (h.round_pref) g32 = ptt::to_f32(ptt::from_f32<G>(g32));
  }
  if (wd != 0.f) g32 = __fadd_rn(g32, __fmul_rn(wd, p32));
  return g32;
}

// A launch's list of tensors, one column a field (the layout that
// ops/kernels/fused_optimizer.py fills; `ptt_update_table_layout` reports
// it): entry i updates n[i] elements of p[i] with g[i], its fp32 master
// (kMaster) and its vector states s1..s3 (as apply_rule names them), reads
// its old beta powers at pw[i] (Adam's two, Adamax's one; null for the
// other rules), folds wd[i] * p into its gradient, and owns the chunks
// start[i] .. start[i + 1] - 1 of the grid (start[0] = 0, start[count] the
// grid's size).
constexpr int kTableCap = 384;

struct Table {
  const void* g[kTableCap];
  const float* pw[kTableCap];
  void* p[kTableCap];
  float* master[kTableCap];
  void* s1[kTableCap];
  void* s2[kTableCap];
  void* s3[kTableCap];
  long long n[kTableCap];
  float wd[kTableCap];
  int start[kTableCap + 1];
};
static_assert(sizeof(Table) + 128 <= 32764,
              "a kernel's parameters: the table, the hypers and the rest");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the vector path's loads and stores: global space, the default cache policy
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&out)[kVec]) {
  constexpr int N = kVec * sizeof(T) / 16;
  uint4 raw[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    raw[k] = __ldca(reinterpret_cast<const uint4*>(p) + k);
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) out[j] = ptt::to_f32(e[j]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&in)[kVec]) {
  constexpr int N = kVec * sizeof(T) / 16;
  uint4 raw[N];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) e[j] = ptt::from_f32<T>(in[j]);
#pragma unroll
  for (int k = 0; k < N; ++k) __stwb(reinterpret_cast<uint4*>(p) + k, raw[k]);
}

// One CTA a chunk of kChunk elements of one entry.
template <int kRule, typename T, typename G, typename M, bool kMaster>
__global__ void __launch_bounds__(kThreads)
    multi_update_kernel(const __grid_constant__ Table tab, const int count,
                        const Hyper h, const float* __restrict__ sc,
                        float* __restrict__ pw_out) {
  constexpr bool kS1 = kRule != kSGD;
  constexpr bool kS2 = kRule == kAdam || kRule == kRMSProp ||
                       kRule == kAdamax || kRule == kAdadelta;
  const bool s3_on = kRule == kRMSProp && h.centered;
  // the entry: the last whose first chunk is at or before this one
  const int c = blockIdx.x;
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.start[mid] <= c) lo = mid;
    else hi = mid - 1;
  }
  const int e = lo;
  const long long n = tab.n[e];
  const long long first = (c - tab.start[e]) * kChunk;
  const long long end = first + kChunk < n ? first + kChunk : n;
  const bool head = c == tab.start[e] && threadIdx.x == 0;
  const float lr = sc[0];
  const float pref = sc[1];
  const bool skip = h.use_fi && sc[2] > 0.5f;
  float lr_t = 0.f, decay = 1.f;
  if constexpr (kRule == kAdam) {
    const float* pw = tab.pw[e];
    const float b1p = __fmul_rn(pw[0], h.b1), b2p = __fmul_rn(pw[1], h.b2);
    // lr * sqrt(1 - b2p) / (1 - b1p)
    lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, b2p))),
                     __fsub_rn(1.f, b1p));
    decay = __fsub_rn(1.f, __fmul_rn(lr, h.coeff));
    if (head) {
      pw_out[2 * e] = skip ? pw[0] : b1p;
      pw_out[2 * e + 1] = skip ? pw[1] : b2p;
    }
  } else if constexpr (kRule == kAdamax) {
    const float* pw = tab.pw[e];
    const float b1p = __fmul_rn(pw[0], h.b1);
    lr_t = __fdiv_rn(lr, __fsub_rn(1.f, b1p));
    if (head) pw_out[2 * e] = skip ? pw[0] : b1p;
  }
  if (skip) return;  // found_inf: every vector output keeps its input's bits
  T* p = static_cast<T*>(tab.p[e]);
  const G* g = static_cast<const G*>(tab.g[e]);
  float* master = tab.master[e];
  M* s1 = static_cast<M*>(tab.s1[e]);
  M* s2 = static_cast<M*>(tab.s2[e]);
  M* s3 = static_cast<M*>(tab.s3[e]);
  const float wd = tab.wd[e];
  const bool vec = aligned16(p) && aligned16(g) &&
                   (!kMaster || aligned16(master)) &&
                   (!kS1 || aligned16(s1)) && (!kS2 || aligned16(s2)) &&
                   (!s3_on || aligned16(s3));
  long long tail = first + threadIdx.x;   // this thread's scalar elements
  long long step = kThreads;
  if (vec) {
    // this thread's vector; the one that holds the entry's ragged end takes
    // it on the scalar path
    const long long i = first + static_cast<long long>(threadIdx.x) * kVec;
    step = 1;
    tail = i < end ? i : end;
    if (i + kVec <= end) {
      tail = end;
      float pv[kVec], gv[kVec], m1[kVec], m2[kVec], m3[kVec], out[kVec];
      if constexpr (kMaster) {
        load8(master + i, pv);
      } else {
        load8(p + i, pv);
      }
      load8(g + i, gv);
      if constexpr (kS1) load8(s1 + i, m1);
      if constexpr (kS2) load8(s2 + i, m2);
      if (s3_on) load8(s3 + i, m3);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float g32 = prep_grad<G>(gv[j], pv[j], pref, wd, h);
        out[j] = apply_rule<kRule>(pv[j], g32, m1[j], m2[j], m3[j], h, lr,
                                   lr_t, decay);
      }
      store8(p + i, out);
      if constexpr (kMaster) store8(master + i, out);
      if constexpr (kS1) store8(s1 + i, m1);
      if constexpr (kS2) store8(s2 + i, m2);
      if (s3_on) store8(s3 + i, m3);
    }
  }
  for (long long i = tail; i < end; i += step) {
    const float p32 = kMaster ? master[i] : ptt::to_f32(p[i]);
    const float g32 = prep_grad<G>(ptt::to_f32(g[i]), p32, pref, wd, h);
    float m1 = 0.f, m2 = 0.f, m3 = 0.f;
    if constexpr (kS1) m1 = ptt::to_f32(s1[i]);
    if constexpr (kS2) m2 = ptt::to_f32(s2[i]);
    if (s3_on) m3 = ptt::to_f32(s3[i]);
    const float out =
        apply_rule<kRule>(p32, g32, m1, m2, m3, h, lr, lr_t, decay);
    p[i] = ptt::from_f32<T>(out);
    if constexpr (kMaster) master[i] = out;
    if constexpr (kS1) s1[i] = ptt::from_f32<M>(m1);
    if constexpr (kS2) s2[i] = ptt::from_f32<M>(m2);
    if (s3_on) s3[i] = ptt::from_f32<M>(m3);
  }
}

struct UpdateArgs {
  const Table* tab;
  int count, master;
  const float* sc;
  float* pw_out;
  Hyper h;
  cudaStream_t stream;
};

template <int R, typename T, typename G, typename M, bool kMaster>
int launch_update(const UpdateArgs& a) {
  multi_update_kernel<R, T, G, M, kMaster>
      <<<a.tab->start[a.count], kThreads, 0, a.stream>>>(
          *a.tab, a.count, a.h, a.sc, a.pw_out);
  return static_cast<int>(cudaGetLastError());
}

template <int R, typename T, typename G, typename M>
int launch_master(const UpdateArgs& a) {
  return a.master ? launch_update<R, T, G, M, true>(a)
                  : launch_update<R, T, G, M, false>(a);
}

// vector states in fp32, or in bf16 for Momentum and Adam (moment_dtype); the
// other rules' states are fp32, as the reference's are
template <int R, typename T, typename G>
int launch_moments(const UpdateArgs& a, int m_dtype) {
  if (m_dtype == ptt::kFloat32) return launch_master<R, T, G, float>(a);
  if constexpr (R == kMomentum || R == kAdam) {
    if (m_dtype == ptt::kBFloat16)
      return launch_master<R, T, G, __nv_bfloat16>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// (param dtype, gradient dtype): the tensor's own dtype for both, or a bf16
// tensor with fp32 gradients (clipped by value in fp32 before the update)
template <int R>
int launch_rule(const UpdateArgs& a, int p_dtype, int g_dtype, int m_dtype) {
  if (p_dtype == ptt::kFloat32 && g_dtype == ptt::kFloat32)
    return launch_moments<R, float, float>(a, m_dtype);
  if (p_dtype == ptt::kBFloat16 && g_dtype == ptt::kBFloat16)
    return launch_moments<R, __nv_bfloat16, __nv_bfloat16>(a, m_dtype);
  if (p_dtype == ptt::kBFloat16 && g_dtype == ptt::kFloat32)
    return launch_moments<R, __nv_bfloat16, float>(a, m_dtype);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [n] contiguous gradient bucket (fp32 or bf16). part: [2 ctas] 32-bit
// scratch (the CTAs' fp32 sums, then their uint32 counts); ticket: one
// uint32 on the device, 0 before the call and reset to 0 by it (the caller
// keeps one a device and orders the calls on one stream); out: [2] fp32
// (sum of squares, nonfinite count). One launch.
extern "C" int ptt_grad_stats(const void* x, void* part, void* ticket,
                              void* out, long long n, int ctas, int dtype,
                              int device, void* stream) {
  if (n <= 0 || ctas <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T,
                     return launch_stats<T>(x, part, ticket,
                                            static_cast<float*>(out), n, ctas,
                                            s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The table's layout for the wrapper to check its own against: out[0] its
// capacity, out[1] its size in bytes, out[2] and out[3] the byte offsets of
// the wd and start columns, out[4] the elements of a chunk.
extern "C" int ptt_update_table_layout(int* out) {
  out[0] = kTableCap;
  out[1] = static_cast<int>(sizeof(Table));
  out[2] = static_cast<int>(offsetof(Table, wd));
  out[3] = static_cast<int>(offsetof(Table, start));
  out[4] = static_cast<int>(kChunk);
  return 0;
}

// One launch updating `count` (1 .. kTableCap) tensors in place, all of one
// (rule, p dtype, g dtype, moment dtype, master or not) group. table: a host
// `Table` (copied into the launch's parameters, so the caller may reuse it as
// soon as this returns); a CTA takes kChunk elements of one entry. sc:
// the step's fp32 block above; pw_out: [count, 2] fp32, the entries' new beta
// powers (Adam, Adamax; else null); m_dtype: fp32, or bf16 for Momentum's and
// Adam's states.
extern "C" int ptt_multi_update(const void* table, int count,
                                const void* sc, void* pw_out, int rule,
                                int p_dtype, int g_dtype, int m_dtype,
                                int master, float coeff, float b1, float b2,
                                float omb1, float omb2, float eps,
                                float momentum, float rho, float omr,
                                int nesterov, int decoupled, int centered,
                                int use_pref, int round_pref, int use_fi,
                                int device, void* stream) {
  const Table* tab = static_cast<const Table*>(table);
  if (count <= 0 || count > kTableCap || tab->start[0] != 0 ||
      tab->start[count] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((rule == kAdam || rule == kAdamax) && pw_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  UpdateArgs a;
  a.tab = tab;
  a.count = count;
  a.master = master;
  a.sc = static_cast<const float*>(sc);
  a.pw_out = static_cast<float*>(pw_out);
  a.h = Hyper{coeff,    b1,        b2,       omb1,     omb2,
              eps,      momentum,  rho,      omr,      nesterov,
              decoupled, centered, use_pref, round_pref, use_fi};
  a.stream = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case kSGD:
      return launch_rule<kSGD>(a, p_dtype, g_dtype, ptt::kFloat32);
    case kMomentum:
      return launch_rule<kMomentum>(a, p_dtype, g_dtype, m_dtype);
    case kAdam:
      return launch_rule<kAdam>(a, p_dtype, g_dtype, m_dtype);
    case kAdagrad:
      return launch_rule<kAdagrad>(a, p_dtype, g_dtype, m_dtype);
    case kRMSProp:
      return launch_rule<kRMSProp>(a, p_dtype, g_dtype, m_dtype);
    case kAdamax:
      return launch_rule<kAdamax>(a, p_dtype, g_dtype, m_dtype);
    case kAdadelta:
      return launch_rule<kAdadelta>(a, p_dtype, g_dtype, m_dtype);
    case kDecayedAdagrad:
      return launch_rule<kDecayedAdagrad>(a, p_dtype, g_dtype, m_dtype);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
