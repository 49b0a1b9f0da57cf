// Flash attention on the packed [B, L, H*D] layout: forward, dQ and dK/dV,
// for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py
//   :278 `_flash_fwd_kernel_packed`     (launched by `_flash_forward_packed`, :504)
//   :336 `_flash_bwd_dq_kernel_packed`  (launched by `_flash_backward_packed`, :546)
//   :390 `_flash_bwd_dkv_kernel_packed` (same launcher)
// reached from GPTAttention (paddle_tpu/models/gpt.py:202) through
// `causal_attention` (:865) and `_flash_attn_packed` (:797).
//
// What bounds them on this card: operations. At GPT's shapes (L = 2048,
// D = 128) the forward does 4 L^2 D / 2 multiply-adds per head under the
// causal mask and reads only 3 L D elements: hundreds of operations per byte.
// These first kernels run the products on the CUDA cores in fp32 FMAs (67
// TFLOP/s peak), not on the tensor cores (989 TFLOP/s bf16), so they sit far
// above their bound; wgmma and TMA come in a later change.
//
// Design: one CTA of 256 threads per (64-query block, head, batch row) for
// the forward and dQ, per (64-key block, head, batch row) for dK/dV. A grid of
// independent heads replaces the Pallas body's unrolled head loop (:294); a
// loop inside the CTA over 64-row tiles of the other operand replaces the
// `fori_loop` over key (or query) blocks and stops at the diagonal when causal
// (:290-292, :404). Tiles are staged in shared memory as fp32, transposed and
// padded to a row of 65 floats ([d][row]), so both the row-wise and the
// column-wise reads of every product are free of bank conflicts. A thread owns
// 4 rows x 4 columns of each 64 x 64 score tile (rows ty + 16 i, columns
// tx + 16 j) and 4 rows x D/16 columns of each 64 x D accumulator; the running
// max, sum and accumulators stay in fp32 registers. A ragged L is masked here,
// where JAX shrinks its blocks to divide L instead (scaffold.fit_block): keys
// past L get probability 0, rows past L are never written.
//
// Numerics, as in the Pallas bodies:
//   forward: q is upcast and multiplied by the scale BEFORE the dot (:295);
//     the key bias is added, then causal entries are set to -1e30 (:314-319);
//     online softmax; l_safe = max(l, 1e-30); o = acc / l_safe in q's dtype,
//     lse = m + log(l_safe) in fp32 (:331-333).
//   backward: the scale is applied AFTER the dot, s = (q k^T) scale (:364-366);
//     p = exp(s - lse), ds = p (dO v^T - delta), dq += scale (ds k),
//     dv += p^T dO, dk += scale (ds^T q), each tile's product scaled before it
//     is added, as the bodies do per block. delta = rowsum(dO O) per head is
//     computed outside the kernels, as in JAX (:560-561).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 64;             // query and key tile rows
constexpr int kPad = kBlock + 1;       // padded row of a transposed tile
constexpr int kTY = 16, kTX = 16;      // thread grid over a 64 x 64 tile
constexpr int kR = kBlock / kTY;       // rows a thread owns
constexpr int kC = kBlock / kTX;       // score columns a thread owns
constexpr float kNegInf = -1e30f;      // flash_attention.py:40

// Stage rows [row0, row0 + 64) of head h of one batch row of a packed
// [B, L, H*D] tensor into dst[d * kPad + r] as fp32 times `mul`; rows past L
// are zeros. Consecutive threads read consecutive d (coalesced).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long base, int row0, int L,
                                          int HD, float mul) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    float val = 0.f;
    if (row < L)
      val = ptt::to_f32(src[base + static_cast<long long>(row) * HD + d]) * mul;
    dst[d * kPad + r] = val;
  }
}

// 16 lanes of a half-warp share one tile row; reduce across them
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the key bias and the masks on one score; `s` already holds the product
__device__ __forceinline__ float mask_score(float s, const float* bias_row,
                                            int row, int col, int L,
                                            bool causal) {
  if (col >= L) return -INFINITY;          // ragged edge: probability 0
  if (bias_row != nullptr) s += bias_row[col];
  if (causal && row < col) s = kNegInf;
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int L, int H,
                     float scale, bool causal) {
  constexpr int kO = D / kTX;
  extern __shared__ float smem[];
  float* qs = smem;                 // [D][kPad], q * scale
  float* kv = qs + D * kPad;        // [D][kPad], the K tile, then the V tile
  float* ps = kv + D * kPad;        // [kBlock][kPad], p stored [key][query]
  // heaviest causal blocks (the last queries) start first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const int q0 = qb * kBlock;
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const long long base = static_cast<long long>(b) * L * HD + h * D;
  const float* bias_row =
      bias != nullptr ? bias + static_cast<long long>(b) * L : nullptr;

  load_tile<T, D>(qs, q, base, q0, L, HD, scale);
  float m[kR], l[kR], acc[kR][kO];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kO; ++c) acc[i][c] = 0.f;
  }
  const int n_tiles = causal ? qb + 1 : (L + kBlock - 1) / kBlock;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's V and p are no longer read
    load_tile<T, D>(kv, k, base, k0, L, HD, 1.f);
    __syncthreads();
    float s[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qr[kR], kc[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) qr[i] = qs[d * kPad + ty + kTY * i];
#pragma unroll
      for (int j = 0; j < kC; ++j) kc[j] = kv[d * kPad + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty + kTY * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        s[i][j] = mask_score(s[i][j], bias_row, row, k0 + tx + kTX * j, L,
                             causal);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(tx + kTX * j) * kPad + ty + kTY * i] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K is no longer read, p is complete
    load_tile<T, D>(kv, v, base, k0, L, HD, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float pr[kR], vc[kO];
#pragma unroll
      for (int i = 0; i < kR; ++i) pr[i] = ps[c * kPad + ty + kTY * i];
#pragma unroll
      for (int e = 0; e < kO; ++e) vc[e] = kv[(tx + kTX * e) * kPad + c];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int e = 0; e < kO; ++e) acc[i][e] = fmaf(pr[i], vc[e], acc[i][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + kTY * i;
    if (row >= L) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + base + static_cast<long long>(row) * HD;
#pragma unroll
    for (int e = 0; e < kO; ++e)
      orow[tx + kTX * e] = ptt::from_f32<T>(acc[i][e] / l_safe);
    if (tx == 0)
      lse[(static_cast<long long>(b) * L + row) * H + h] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int L, int H, float scale, bool causal) {
  constexpr int kO = D / kTX;
  extern __shared__ float smem[];
  float* qs = smem;                 // [D][kPad]
  float* dos = qs + D * kPad;       // [D][kPad]
  float* ks = dos + D * kPad;       // [D][kPad]
  float* vs = ks + D * kPad;        // [D][kPad]
  float* dss = vs + D * kPad;       // [kBlock][kPad], ds stored [key][query]
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const int q0 = qb * kBlock;
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const long long base = static_cast<long long>(b) * L * HD + h * D;
  const float* bias_row =
      bias != nullptr ? bias + static_cast<long long>(b) * L : nullptr;

  load_tile<T, D>(qs, q, base, q0, L, HD, 1.f);
  load_tile<T, D>(dos, dout, base, q0, L, HD, 1.f);
  float lse_r[kR], delta_r[kR], dqa[kR][kO];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + kTY * i;
    const long long st = (static_cast<long long>(b) * L + row) * H + h;
    lse_r[i] = row < L ? lse[st] : 0.f;
    delta_r[i] = row < L ? delta[st] : 0.f;
#pragma unroll
    for (int e = 0; e < kO; ++e) dqa[i][e] = 0.f;
  }
  const int n_tiles = causal ? qb + 1 : (L + kBlock - 1) / kBlock;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's K and ds are no longer read
    load_tile<T, D>(ks, k, base, k0, L, HD, 1.f);
    load_tile<T, D>(vs, v, base, k0, L, HD, 1.f);
    __syncthreads();
    float s[kR][kC], dp[kR][kC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[kR], dor[kR], kc[kC], vc[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        qr[i] = qs[d * kPad + ty + kTY * i];
        dor[i] = dos[d * kPad + ty + kTY * i];
      }
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        kc[j] = ks[d * kPad + tx + kTX * j];
        vc[j] = vs[d * kPad + tx + kTX * j];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(dor[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty + kTY * i;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int col = k0 + tx + kTX * j;
        const float sc =
            mask_score(s[i][j] * scale, bias_row, row, col, L, causal);
        const float p = expf(sc - lse_r[i]);
        dss[(tx + kTX * j) * kPad + ty + kTY * i] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    float t[kR][kO];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int e = 0; e < kO; ++e) t[i][e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float dsr[kR], kc[kO];
#pragma unroll
      for (int i = 0; i < kR; ++i) dsr[i] = dss[c * kPad + ty + kTY * i];
#pragma unroll
      for (int e = 0; e < kO; ++e) kc[e] = ks[(tx + kTX * e) * kPad + c];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int e = 0; e < kO; ++e) t[i][e] = fmaf(dsr[i], kc[e], t[i][e]);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int e = 0; e < kO; ++e) dqa[i][e] += scale * t[i][e];
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + kTY * i;
    if (row >= L) continue;
    T* out = dq + base + static_cast<long long>(row) * HD;
#pragma unroll
    for (int e = 0; e < kO; ++e) out[tx + kTX * e] = ptt::from_f32<T>(dqa[i][e]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int L, int H, float scale,
                         bool causal) {
  constexpr int kO = D / kTX;
  extern __shared__ float smem[];
  float* ks = smem;                 // [D][kPad]
  float* vs = ks + D * kPad;        // [D][kPad]
  float* qs = vs + D * kPad;        // [D][kPad]
  float* dos = qs + D * kPad;       // [D][kPad]
  float* pss = dos + D * kPad;      // [kBlock][kPad], p stored [query][key]
  float* dss = pss + kBlock * kPad; // [kBlock][kPad], ds stored [query][key]
  float* lse_s = dss + kBlock * kPad;   // [kBlock]
  float* delta_s = lse_s + kBlock;      // [kBlock]
  const int kb = blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const int k0 = kb * kBlock;
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const long long base = static_cast<long long>(b) * L * HD + h * D;
  const float* bias_row =
      bias != nullptr ? bias + static_cast<long long>(b) * L : nullptr;

  load_tile<T, D>(ks, k, base, k0, L, HD, 1.f);
  load_tile<T, D>(vs, v, base, k0, L, HD, 1.f);
  // this thread's keys are k0 + ty + 16 i, its queries in a tile tx + 16 j
  float dka[kR][kO], dva[kR][kO];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int e = 0; e < kO; ++e) dka[i][e] = dva[i][e] = 0.f;
  const int n_q = (L + kBlock - 1) / kBlock;
  for (int qt = causal ? kb : 0; qt < n_q; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // the previous tile's q, dO, p and ds are no longer read
    load_tile<T, D>(qs, q, base, q0, L, HD, 1.f);
    load_tile<T, D>(dos, dout, base, q0, L, HD, 1.f);
    for (int r = threadIdx.x; r < kBlock; r += kThreads) {
      const int row = q0 + r;
      const long long st = (static_cast<long long>(b) * L + row) * H + h;
      lse_s[r] = row < L ? lse[st] : 0.f;
      delta_s[r] = row < L ? delta[st] : 0.f;
    }
    __syncthreads();
    float s[kR][kC], dp[kR][kC];  // [key i][query j]
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kr[kR], vr[kR], qc[kC], doc[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        kr[i] = ks[d * kPad + ty + kTY * i];
        vr[i] = vs[d * kPad + ty + kTY * i];
      }
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        qc[j] = qs[d * kPad + tx + kTX * j];
        doc[j] = dos[d * kPad + tx + kTX * j];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
          dp[i][j] = fmaf(vr[i], doc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int col = k0 + ty + kTY * i;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int r = tx + kTX * j;
        const int row = q0 + r;
        const float sc =
            mask_score(s[i][j] * scale, bias_row, row, col, L, causal);
        const float p = row < L ? expf(sc - lse_s[r]) : 0.f;
        pss[r * kPad + ty + kTY * i] = p;
        dss[r * kPad + ty + kTY * i] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    float t[kR][kO];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int e = 0; e < kO; ++e) t[i][e] = 0.f;
#pragma unroll 2
    for (int r = 0; r < kBlock; ++r) {
      float pr[kR], dsr[kR], doc[kO], qc[kO];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        pr[i] = pss[r * kPad + ty + kTY * i];
        dsr[i] = dss[r * kPad + ty + kTY * i];
      }
#pragma unroll
      for (int e = 0; e < kO; ++e) {
        doc[e] = dos[(tx + kTX * e) * kPad + r];
        qc[e] = qs[(tx + kTX * e) * kPad + r];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int e = 0; e < kO; ++e) {
          dva[i][e] = fmaf(pr[i], doc[e], dva[i][e]);
          t[i][e] = fmaf(dsr[i], qc[e], t[i][e]);
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int e = 0; e < kO; ++e) dka[i][e] += scale * t[i][e];
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int key = k0 + ty + kTY * i;
    if (key >= L) continue;
    const long long off = base + static_cast<long long>(key) * HD;
#pragma unroll
    for (int e = 0; e < kO; ++e) {
      dk[off + tx + kTX * e] = ptt::from_f32<T>(dka[i][e]);
      dv[off + tx + kTX * e] = ptt::from_f32<T>(dva[i][e]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
constexpr size_t fwd_smem() {
  return (2 * D * kPad + kBlock * kPad) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (4 * D * kPad + kBlock * kPad) * sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  return (4 * D * kPad + 2 * kBlock * kPad + 2 * kBlock) * sizeof(float);
}

dim3 grid_of(int B, int L, int H) {
  return dim3((L + kBlock - 1) / kBlock, H, B);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias,
               void* o, float* lse, int B, int L, int H, float scale,
               bool causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<T, D><<<grid_of(B, L, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), lse, L, H, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const float* bias,
              const void* dout, const float* lse, const float* delta,
              void* dq, int B, int L, int H, float scale, bool causal,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, D><<<grid_of(B, L, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), L, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int L, int H, float scale,
               bool causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<T, D><<<grid_of(B, L, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dispatch a head_dim to a compile-time D (the kernels' register tiles are
// sized by it); any other head_dim returns cudaErrorInvalidValue.
#define PTT_DISPATCH_HEAD_DIM(head_dim, D, ...)        \
  switch (head_dim) {                                  \
    case 32: {                                         \
      constexpr int D = 32;                            \
      __VA_ARGS__;                                     \
      break;                                           \
    }                                                  \
    case 64: {                                         \
      constexpr int D = 64;                            \
      __VA_ARGS__;                                     \
      break;                                           \
    }                                                  \
    case 128: {                                        \
      constexpr int D = 128;                           \
      __VA_ARGS__;                                     \
      break;                                           \
    }                                                  \
    default:                                           \
      return static_cast<int>(cudaErrorInvalidValue);  \
  }

#define PTT_FLASH_PROLOGUE()                                          \
  if (B <= 0 || L <= 0 || H <= 0)                                     \
    return static_cast<int>(cudaErrorInvalidValue);                   \
  const ptt::DeviceGuard guard(device);                               \
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error()); \
  cudaStream_t s = static_cast<cudaStream_t>(stream)

// q, k, v, o: [B, L, H*D] contiguous, one dtype; bias: [B, L] fp32 or null;
// lse: [B, L, H] fp32 out.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, void* o, void* lse, int B,
                             int L, int H, int D, float scale, int causal,
                             int dtype, int device, void* stream) {
  PTT_FLASH_PROLOGUE();
  PTT_DISPATCH_DTYPE(
      dtype, T,
      PTT_DISPATCH_HEAD_DIM(
          D, kD,
          return launch_fwd<T, kD>(q, k, v, static_cast<const float*>(bias),
                                   o, static_cast<float*>(lse), B, L, H,
                                   scale, causal != 0, s)));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dout, dq: [B, L, H*D] like q; lse, delta: [B, L, H] fp32.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                int B, int L, int H, int D, float scale,
                                int causal, int dtype, int device,
                                void* stream) {
  PTT_FLASH_PROLOGUE();
  PTT_DISPATCH_DTYPE(
      dtype, T,
      PTT_DISPATCH_HEAD_DIM(
          D, kD,
          return launch_dq<T, kD>(q, k, v, static_cast<const float*>(bias),
                                  dout, static_cast<const float*>(lse),
                                  static_cast<const float*>(delta), dq, B, L,
                                  H, scale, causal != 0, s)));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk, dv: [B, L, H*D] like k and v.
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* bias, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, int B, int L, int H, int D,
                                 float scale, int causal, int dtype,
                                 int device, void* stream) {
  PTT_FLASH_PROLOGUE();
  PTT_DISPATCH_DTYPE(
      dtype, T,
      PTT_DISPATCH_HEAD_DIM(
          D, kD,
          return launch_dkv<T, kD>(q, k, v, static_cast<const float*>(bias),
                                   dout, static_cast<const float*>(lse),
                                   static_cast<const float*>(delta), dk, dv,
                                   B, L, H, scale, causal != 0, s)));
  return static_cast<int>(cudaErrorInvalidValue);
}
