// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV, on two
// layouts: packed [B, L, H*D] and BHLD [B*H, L, D], the latter with an
// optional 1-byte attention-dropout keep mask.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py
//   :278 `_flash_fwd_kernel_packed`     (launched by `_flash_forward_packed`, :504)
//   :336 `_flash_bwd_dq_kernel_packed`  (launched by `_flash_backward_packed`, :546)
//   :390 `_flash_bwd_dkv_kernel_packed` (same launcher)
// reached from GPTAttention (paddle_tpu/models/gpt.py:202) through
// `causal_attention` (:865) and `_flash_attn_packed` (:797); and
//   :68  `_flash_fwd_kernel`      (launched by `_flash_forward`, :455)
//   :137 `_flash_bwd_dq_kernel`   (launched by `_flash_backward`, :614)
//   :191 `_flash_bwd_dkv_kernel`  (same launcher)
// reached through `_flash_attn_dropout` (:748, GPT training with attention
// dropout), `flash_attention_bhld` (:723) and `_flash_attn_biased` (:773,
// `flash_attention` :852 and `mha_flash_attention` :933).
//
// What bounds them on this card: operations. At GPT's shapes (L = 2048,
// D = 128) the forward does 4 L^2 D / 2 multiply-adds per head under the
// causal mask and reads only 3 L D elements (and L^2 / 2 mask bytes):
// hundreds of operations per byte. These first kernels run the products on
// the CUDA cores in fp32 FMAs (67 TFLOP/s peak), not on the tensor cores
// (989 TFLOP/s bf16), so they sit far above their bound; wgmma and TMA come
// in a later change.
//
// Design: one CTA of 256 threads per (64-query block, head, batch row) for
// the forward and dQ, per (64-key block, head, batch row) for dK/dV. A grid of
// independent heads replaces the packed Pallas body's unrolled head loop
// (:294) and the BHLD body's (batch*head) grid axis; a loop inside the CTA
// over 64-row tiles of the other operand replaces the `fori_loop` over key
// (or query) blocks and stops at the diagonal when causal (:290-292, :404;
// :97-99, :212). Packed against BHLD is only where a head's rows start and
// how far apart they lie (`Geom`); the bodies are shared, each layout has its
// own __global__ entry (so a profile tells them apart). Tiles are staged in
// shared memory as fp32, transposed and padded to a row of 65 floats
// ([d][row]), so both the row-wise and the column-wise reads of every product
// are free of bank conflicts. A thread owns 4 rows x 4 columns of each 64 x 64
// score tile (rows ty + 16 i, columns tx + 16 j) and 4 rows x D/16 columns of
// each 64 x D accumulator; the running max, sum and accumulators stay in fp32
// registers. A ragged L is masked here, where JAX shrinks its blocks to divide
// L instead (scaffold.fit_block): keys past L get probability 0, rows past L
// are never written.
//
// The keep mask ([B*H, L, L], nonzero = kept, the caller's draw): the forward
// reads it straight from device memory (16 lanes of a half-warp read 16
// neighbouring bytes of one query row); dQ and dK/dV first stage each 64 x 64
// tile in shared memory as keep factors, neighbouring threads on neighbouring
// bytes, beside the tiles of K and V (dQ) or Q and dO (dK/dV), so no byte
// load waits inside the score loop.
//
// Numerics, as in the Pallas bodies:
//   forward: q is upcast and multiplied by the scale BEFORE the dot (:295,
//     :90); the key bias is added, then causal entries are set to -1e30
//     (:314-319, :109-117); online softmax; the normalizer l sums the
//     UNdropped p, and only the p that multiplies V is scaled by the keep
//     factor where(mask != 0, inv_keep, 0) (:119-127); l_safe = max(l, 1e-30);
//     o = acc / l_safe in q's dtype, lse = m + log(l_safe) in fp32.
//   backward: the scale is applied AFTER the dot, s = (q k^T) scale (:364-366,
//     :164-165); p = exp(s - lse); dP = dO v^T times the keep factor;
//     ds = p (dP - delta), dq += scale (ds k), dv += (p keep)^T dO,
//     dk += scale (ds^T q), each tile's product scaled before it is added, as
//     the bodies do per block. delta = rowsum(dO O) per head (which already
//     carries the dropped probabilities) is computed outside the kernels, as
//     in JAX (:560-561, :631-632).
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

// Where the tensors of one (batch row b, head h) start, in elements.
struct Geom {
  long long base;     // row 0 of q, k, v, o, dO, dq, dk, dv
  int row_stride;     // elements from one row to the next
  long long stat;     // row 0 of lse and delta
  int stat_stride;
  long long mask;     // query row 0 of the keep mask (BHLD)
};

template <bool kBHLD, int D>
__device__ __forceinline__ Geom geom(int b, int h, int L, int H) {
  Geom g;
  if constexpr (kBHLD) {  // [B*H, L, D]; lse/delta [B*H, L]; mask [B*H, L, L]
    const long long bh = static_cast<long long>(b) * H + h;
    g.base = bh * L * D;
    g.row_stride = D;
    g.stat = bh * L;
    g.stat_stride = 1;
    g.mask = bh * L * L;
  } else {                // [B, L, H*D]; lse/delta [B, L, H]
    g.base = static_cast<long long>(b) * L * H * D + h * D;
    g.row_stride = H * D;
    g.stat = static_cast<long long>(b) * L * H + h;
    g.stat_stride = H;
    g.mask = 0;
  }
  return g;
}

// Stage rows [row0, row0 + 64) of one head into dst[d * kPad + r] as fp32
// times `mul`; rows past L are zeros. Consecutive threads read consecutive d
// (coalesced).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long base, int row0, int L,
                                          int row_stride, float mul) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    float val = 0.f;
    if (row < L)
      val = ptt::to_f32(src[base + static_cast<long long>(row) * row_stride +
                            d]) * mul;
    dst[d * kPad + r] = val;
  }
}

// the dropout factor of (query row, key col): inv_keep where kept, else 0
__device__ __forceinline__ float keep_of(const unsigned char* __restrict__ mask,
                                         long long mrow0, int row, int col,
                                         int L, float inv_keep) {
  if (row >= L || col >= L) return 0.f;
  return mask[mrow0 + static_cast<long long>(row) * L + col] != 0 ? inv_keep
                                                                  : 0.f;
}

// Stage the keep factors of queries [q0, q0 + 64) x keys [k0, k0 + 64) into
// dst[r * kPad + c] ([query][key]); neighbouring threads, neighbouring bytes.
__device__ __forceinline__ void stage_keep(float* dst,
                                           const unsigned char* __restrict__ mask,
                                           long long mrow0, int q0, int k0,
                                           int L, float inv_keep) {
  for (int i = threadIdx.x; i < kBlock * kBlock; i += kThreads) {
    const int r = i / kBlock, c = i % kBlock;
    dst[r * kPad + c] = keep_of(mask, mrow0, q0 + r, k0 + c, L, inv_keep);
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

// Everything a launch takes; the pointers a pass does not use are null.
struct FlashArgs {
  const void *q, *k, *v, *dout;
  const float* bias;           // [B, L] fp32 key bias or null
  const unsigned char* mask;   // BHLD keep mask or null
  const float *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float* lse;
  int B, L, H;
  float scale, inv_keep;
  bool causal;
  cudaStream_t stream;
};

#define PTT_FLASH_PARAMS                                                   \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v, \
      const T *__restrict__ dout, const float *__restrict__ bias,          \
      const unsigned char *__restrict__ mask,                              \
      const float *__restrict__ lse_in, const float *__restrict__ delta,   \
      T *__restrict__ o, T *__restrict__ dq, T *__restrict__ dk,           \
      T *__restrict__ dv, float *__restrict__ lse, int L, int H,           \
      float scale, float inv_keep, bool causal
#define PTT_FLASH_ARGS \
  q, k, v, dout, bias, mask, lse_in, delta, o, dq, dk, dv, lse, L, H, scale, \
      inv_keep, causal

template <typename T, int D, bool kBHLD, bool kMask>
__device__ __forceinline__ void flash_fwd_body(PTT_FLASH_PARAMS) {
  constexpr int kO = D / kTX;
  extern __shared__ float smem[];
  float* qs = smem;                 // [D][kPad], q * scale
  float* kv = qs + D * kPad;        // [D][kPad], the K tile, then the V tile
  float* ps = kv + D * kPad;        // [kBlock][kPad], p stored [key][query]
  // heaviest causal blocks (the last queries) start first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * kBlock;
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const Geom g = geom<kBHLD, D>(b, h, L, H);
  const float* bias_row =
      bias != nullptr ? bias + static_cast<long long>(b) * L : nullptr;

  load_tile<T, D>(qs, q, g.base, q0, L, g.row_stride, scale);
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
    load_tile<T, D>(kv, k, g.base, k0, L, g.row_stride, 1.f);
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
        rs += p;                       // the normalizer: undropped p
        float pv = p;
        if constexpr (kMask)
          pv = p * keep_of(mask, g.mask, row, k0 + tx + kTX * j, L, inv_keep);
        ps[(tx + kTX * j) * kPad + ty + kTY * i] = pv;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K is no longer read, p is complete
    load_tile<T, D>(kv, v, g.base, k0, L, g.row_stride, 1.f);
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
    T* orow = o + g.base + static_cast<long long>(row) * g.row_stride;
#pragma unroll
    for (int e = 0; e < kO; ++e)
      orow[tx + kTX * e] = ptt::from_f32<T>(acc[i][e] / l_safe);
    if (tx == 0)
      lse[g.stat + static_cast<long long>(row) * g.stat_stride] =
          m[i] + logf(l_safe);
  }
}

template <typename T, int D, bool kBHLD, bool kMask>
__device__ __forceinline__ void flash_dq_body(PTT_FLASH_PARAMS) {
  constexpr int kO = D / kTX;
  extern __shared__ float smem[];
  float* qs = smem;                 // [D][kPad]
  float* dos = qs + D * kPad;       // [D][kPad]
  float* ks = dos + D * kPad;       // [D][kPad]
  float* vs = ks + D * kPad;        // [D][kPad]
  float* dss = vs + D * kPad;       // [kBlock][kPad], ds stored [key][query]
  float* keep_s = dss + kBlock * kPad;  // [kBlock][kPad] [query][key] (kMask)
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * kBlock;
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const Geom g = geom<kBHLD, D>(b, h, L, H);
  const float* bias_row =
      bias != nullptr ? bias + static_cast<long long>(b) * L : nullptr;

  load_tile<T, D>(qs, q, g.base, q0, L, g.row_stride, 1.f);
  load_tile<T, D>(dos, dout, g.base, q0, L, g.row_stride, 1.f);
  float lse_r[kR], delta_r[kR], dqa[kR][kO];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + kTY * i;
    const long long st = g.stat + static_cast<long long>(row) * g.stat_stride;
    lse_r[i] = row < L ? lse_in[st] : 0.f;
    delta_r[i] = row < L ? delta[st] : 0.f;
#pragma unroll
    for (int e = 0; e < kO; ++e) dqa[i][e] = 0.f;
  }
  const int n_tiles = causal ? qb + 1 : (L + kBlock - 1) / kBlock;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's K and ds are no longer read
    load_tile<T, D>(ks, k, g.base, k0, L, g.row_stride, 1.f);
    load_tile<T, D>(vs, v, g.base, k0, L, g.row_stride, 1.f);
    if constexpr (kMask) stage_keep(keep_s, mask, g.mask, q0, k0, L, inv_keep);
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
        float dpk = dp[i][j];
        if constexpr (kMask)
          dpk = dpk * keep_s[(ty + kTY * i) * kPad + tx + kTX * j];
        dss[(tx + kTX * j) * kPad + ty + kTY * i] = p * (dpk - delta_r[i]);
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
    T* out = dq + g.base + static_cast<long long>(row) * g.row_stride;
#pragma unroll
    for (int e = 0; e < kO; ++e) out[tx + kTX * e] = ptt::from_f32<T>(dqa[i][e]);
  }
}

template <typename T, int D, bool kBHLD, bool kMask>
__device__ __forceinline__ void flash_dkv_body(PTT_FLASH_PARAMS) {
  constexpr int kO = D / kTX;
  extern __shared__ float smem[];
  float* ks = smem;                 // [D][kPad]
  float* vs = ks + D * kPad;        // [D][kPad]
  float* qs = vs + D * kPad;        // [D][kPad]
  float* dos = qs + D * kPad;       // [D][kPad]
  float* pss = dos + D * kPad;      // [kBlock][kPad], p keep stored [query][key]
  float* dss = pss + kBlock * kPad; // [kBlock][kPad], ds stored [query][key]
  float* lse_s = dss + kBlock * kPad;   // [kBlock]
  float* delta_s = lse_s + kBlock;      // [kBlock]
  float* keep_s = delta_s + kBlock;     // [kBlock][kPad] [query][key] (kMask)
  const int kb = blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * kBlock;
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const Geom g = geom<kBHLD, D>(b, h, L, H);
  const float* bias_row =
      bias != nullptr ? bias + static_cast<long long>(b) * L : nullptr;

  load_tile<T, D>(ks, k, g.base, k0, L, g.row_stride, 1.f);
  load_tile<T, D>(vs, v, g.base, k0, L, g.row_stride, 1.f);
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
    load_tile<T, D>(qs, q, g.base, q0, L, g.row_stride, 1.f);
    load_tile<T, D>(dos, dout, g.base, q0, L, g.row_stride, 1.f);
    for (int r = threadIdx.x; r < kBlock; r += kThreads) {
      const int row = q0 + r;
      const long long st = g.stat + static_cast<long long>(row) * g.stat_stride;
      lse_s[r] = row < L ? lse_in[st] : 0.f;
      delta_s[r] = row < L ? delta[st] : 0.f;
    }
    if constexpr (kMask) stage_keep(keep_s, mask, g.mask, q0, k0, L, inv_keep);
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
        if constexpr (kMask) {
          const float kf = keep_s[r * kPad + ty + kTY * i];
          pss[r * kPad + ty + kTY * i] = p * kf;
          dss[r * kPad + ty + kTY * i] = p * (dp[i][j] * kf - delta_s[r]);
        } else {
          pss[r * kPad + ty + kTY * i] = p;
          dss[r * kPad + ty + kTY * i] = p * (dp[i][j] - delta_s[r]);
        }
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
    const long long off = g.base + static_cast<long long>(key) * g.row_stride;
#pragma unroll
    for (int e = 0; e < kO; ++e) {
      dk[off + tx + kTX * e] = ptt::from_f32<T>(dka[i][e]);
      dv[off + tx + kTX * e] = ptt::from_f32<T>(dva[i][e]);
    }
  }
}

// The __global__ entries: the packed layout's (rows 8-10 of PERF.md's kernel
// table) and the BHLD layout's (rows 11-13), one name each.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(PTT_FLASH_PARAMS) {
  flash_fwd_body<T, D, false, false>(PTT_FLASH_ARGS);
}
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(PTT_FLASH_PARAMS) {
  flash_dq_body<T, D, false, false>(PTT_FLASH_ARGS);
}
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(PTT_FLASH_PARAMS) {
  flash_dkv_body<T, D, false, false>(PTT_FLASH_ARGS);
}
template <typename T, int D, bool kMask>
__global__ void __launch_bounds__(kThreads)
    flash_bhld_fwd_kernel(PTT_FLASH_PARAMS) {
  flash_fwd_body<T, D, true, kMask>(PTT_FLASH_ARGS);
}
template <typename T, int D, bool kMask>
__global__ void __launch_bounds__(kThreads)
    flash_bhld_bwd_dq_kernel(PTT_FLASH_PARAMS) {
  flash_dq_body<T, D, true, kMask>(PTT_FLASH_ARGS);
}
template <typename T, int D, bool kMask>
__global__ void __launch_bounds__(kThreads)
    flash_bhld_bwd_dkv_kernel(PTT_FLASH_PARAMS) {
  flash_dkv_body<T, D, true, kMask>(PTT_FLASH_ARGS);
}

enum Pass : int { kFwd = 0, kDQ = 1, kDKV = 2 };

template <int kPass, typename T, int D, bool kBHLD, bool kMask>
auto kernel_of() {
  if constexpr (kPass == kFwd) {
    if constexpr (kBHLD) return &flash_bhld_fwd_kernel<T, D, kMask>;
    else return &flash_fwd_kernel<T, D>;
  } else if constexpr (kPass == kDQ) {
    if constexpr (kBHLD) return &flash_bhld_bwd_dq_kernel<T, D, kMask>;
    else return &flash_bwd_dq_kernel<T, D>;
  } else {
    if constexpr (kBHLD) return &flash_bhld_bwd_dkv_kernel<T, D, kMask>;
    else return &flash_bwd_dkv_kernel<T, D>;
  }
}

template <int kPass, int D, bool kMask>
constexpr size_t smem_of() {
  if constexpr (kPass == kFwd)
    return (2 * D * kPad + kBlock * kPad) * sizeof(float);
  else if constexpr (kPass == kDQ)
    return (4 * D * kPad + (kMask ? 2 : 1) * kBlock * kPad) * sizeof(float);
  else
    return (4 * D * kPad + (kMask ? 3 : 2) * kBlock * kPad + 2 * kBlock) *
           sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int kPass, typename T, int D, bool kBHLD, bool kMask>
int launch(const FlashArgs& a) {
  const auto kernel = kernel_of<kPass, T, D, kBHLD, kMask>();
  constexpr size_t smem = smem_of<kPass, D, kMask>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.L + kBlock - 1) / kBlock, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.bias,
      a.mask, a.lse_in, a.delta, static_cast<T*>(a.o), static_cast<T*>(a.dq),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.lse, a.L, a.H, a.scale,
      a.inv_keep, a.causal);
  return static_cast<int>(cudaGetLastError());
}

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

// one pass on one layout: the dtype, the head dim and (BHLD) the mask to
// compile-time parameters
template <int kPass, bool kBHLD>
int dispatch(const FlashArgs& a, int head_dim, int dtype, int device) {
  // a grid's y and z extents are at most 65535
  if (a.B <= 0 || a.L <= 0 || a.H <= 0 || a.B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!kBHLD && a.mask != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  PTT_DISPATCH_DTYPE(
      dtype, T,
      PTT_DISPATCH_HEAD_DIM(
          head_dim, kD,
          if (a.mask != nullptr) return launch<kPass, T, kD, kBHLD, kBHLD>(a);
          return launch<kPass, T, kD, kBHLD, false>(a)));
  return static_cast<int>(cudaErrorInvalidValue);
}

FlashArgs make_args(const void* q, const void* k, const void* v,
                    const void* dout, const void* bias, const void* mask,
                    const void* lse_in, const void* delta, void* o, void* dq,
                    void* dk, void* dv, void* lse, int B, int L, int H,
                    float scale, float inv_keep, int causal, void* stream) {
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const unsigned char*>(mask);
  a.lse_in = static_cast<const float*>(lse_in);
  a.delta = static_cast<const float*>(delta);
  a.o = o;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.L = L;
  a.H = H;
  a.scale = scale;
  a.inv_keep = inv_keep;
  a.causal = causal != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// ---------------------------------------------------------------------------
// packed [B, L, H*D]
// ---------------------------------------------------------------------------
// q, k, v, o: [B, L, H*D] contiguous, one dtype; bias: [B, L] fp32 or null;
// lse: [B, L, H] fp32 out.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, void* o, void* lse, int B,
                             int L, int H, int D, float scale, int causal,
                             int dtype, int device, void* stream) {
  const FlashArgs a =
      make_args(q, k, v, nullptr, bias, nullptr, nullptr, nullptr, o, nullptr,
                nullptr, nullptr, lse, B, L, H, scale, 1.f, causal, stream);
  return dispatch<kFwd, false>(a, D, dtype, device);
}

// dout, dq: [B, L, H*D] like q; lse, delta: [B, L, H] fp32.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                int B, int L, int H, int D, float scale,
                                int causal, int dtype, int device,
                                void* stream) {
  const FlashArgs a =
      make_args(q, k, v, dout, bias, nullptr, lse, delta, nullptr, dq,
                nullptr, nullptr, nullptr, B, L, H, scale, 1.f, causal, stream);
  return dispatch<kDQ, false>(a, D, dtype, device);
}

// dk, dv: [B, L, H*D] like k and v.
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* bias, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, int B, int L, int H, int D,
                                 float scale, int causal, int dtype,
                                 int device, void* stream) {
  const FlashArgs a =
      make_args(q, k, v, dout, bias, nullptr, lse, delta, nullptr, nullptr,
                dk, dv, nullptr, B, L, H, scale, 1.f, causal, stream);
  return dispatch<kDKV, false>(a, D, dtype, device);
}

// ---------------------------------------------------------------------------
// BHLD [B*H, L, D]
// ---------------------------------------------------------------------------
// q, k, v, o: [B*H, L, D] contiguous, one dtype (program b*H + h reads bias
// row b); bias: [B, L] fp32 or null; mask: [B*H, L, L] one byte an element
// (nonzero: kept) or null, each kept p scaled by inv_keep; lse: [B*H, L] fp32
// out.
extern "C" int ptt_flash_bhld_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, const void* mask, void* o,
                                  void* lse, int B, int L, int H, int D,
                                  float scale, float inv_keep, int causal,
                                  int dtype, int device, void* stream) {
  const FlashArgs a =
      make_args(q, k, v, nullptr, bias, mask, nullptr, nullptr, o, nullptr,
                nullptr, nullptr, lse, B, L, H, scale, inv_keep, causal,
                stream);
  return dispatch<kFwd, true>(a, D, dtype, device);
}

// dout, dq: [B*H, L, D] like q; lse, delta: [B*H, L] fp32.
extern "C" int ptt_flash_bhld_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* mask, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int B, int L, int H, int D,
                                     float scale, float inv_keep, int causal,
                                     int dtype, int device, void* stream) {
  const FlashArgs a =
      make_args(q, k, v, dout, bias, mask, lse, delta, nullptr, dq, nullptr,
                nullptr, nullptr, B, L, H, scale, inv_keep, causal, stream);
  return dispatch<kDQ, true>(a, D, dtype, device);
}

// dk, dv: [B*H, L, D] like k and v.
extern "C" int ptt_flash_bhld_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* mask, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int L, int H,
                                      int D, float scale, float inv_keep,
                                      int causal, int dtype, int device,
                                      void* stream) {
  const FlashArgs a =
      make_args(q, k, v, dout, bias, mask, lse, delta, nullptr, nullptr, dk,
                dv, nullptr, B, L, H, scale, inv_keep, causal, stream);
  return dispatch<kDKV, true>(a, D, dtype, device);
}
