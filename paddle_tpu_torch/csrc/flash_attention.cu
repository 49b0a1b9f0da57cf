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
// D = 128) each pass does two to four products of L^2 D / 2 multiply-adds
// per head under the causal mask and reads only a few L D elements (and
// L^2 / 2 mask bytes): hundreds of operations per byte, so the tensor
// cores' rate (989 TFLOP/s bf16) is the bound.
//
// The bf16 passes (forward, dQ and dK/dV; the `tc` namespace below) run
// their products on the tensor cores with mma.sync.m16n8k16 (bf16 operands,
// fp32 sums). One CTA of 4 warps per (64-row block of its output, head,
// batch row); warp w owns rows 16w..16w+15, the M dimension of every product
// it issues:
//   forward: S = Q K^T, then O += (P keep) V, P keep as hi + lo;
//   dQ:      S = Q K^T, dP = dO V^T, then dQ += dS K;
//   dK/dV:   S^T = K Q^T, dP^T = V dO^T, then dV += (P keep)^T dO and
//            dK += dS^T Q.
// The first products of a tile leave S (and dP) in accumulator fragments
// (fp32, 16 x 64 a warp); P, the keep factor and dS are formed there,
// rounded to bf16 and repacked in registers as the A operand of the next
// products (the C fragments of two neighbouring n8 tiles are the A fragment
// of one k16 tile), so no score tile goes through shared memory. The forward
// keeps its Q tile in registers as A fragments (read once through ldmatrix)
// and runs the online softmax in the fragments: a row's 16 scores a thread
// holds, then the four lanes of its quad (two shuffles). Every other
// operand comes from bf16 tiles in shared memory through ldmatrix (.trans
// where a product sums over the tile's rows), each row padded by 16 bytes so
// the eight rows of an 8 x 8 matrix fall in distinct banks. The streamed
// operand (K and V, and the forward's 64 key-bias floats, in the forward and
// dQ; Q, dO, lse and delta in dK/dV) and the keep mask's 64 x 64 bytes are
// double-buffered and loaded with cp.async (16 bytes a thread, zero-filled
// past L), so the next tile loads while this one is multiplied. Shared memory
// at D = 128: 87,040 B of tiles in the forward, 104,448 B in dQ and dK/dV
// (+1,024 of lse and delta in dK/dV, +512 of bias in the forward, +8,192
// with a mask), so two CTAs fit on an SM, as do their registers (at most 255
// a thread at 128 threads), which hold the forward's 16 x 128 fp32 output
// accumulator, Q's fragments and S, or dK/dV's two 16 x 128 accumulators
// and the S and dP fragments. The keep bytes a thread needs in a tile are
// read into one 32-bit mask before the products, so they hold one register
// while S (and dP) are live.
//
// The fp32 passes run on the CUDA-core bodies (fp32 FMAs, 67 TFLOP/s peak),
// on purpose: the tensor cores take fp32 only as TF32 (10 mantissa bits),
// which would not hold the fp32 bars (1e-3 elementwise, 1e-3 relative L2 on
// the whole training path).
//
// CUDA-core design: one CTA of 256 threads per (64-query block, head, batch
// row) for the forward and dQ, per (64-key block, head, batch row) for dK/dV.
// A grid of independent heads replaces the packed Pallas body's unrolled head
// loop (:294) and the BHLD body's (batch*head) grid axis; a loop inside the
// CTA over 64-row tiles of the other operand replaces the `fori_loop` over
// key (or query) blocks and stops at the diagonal when causal (:290-292,
// :404; :97-99, :212); the tensor-core bodies share that grid. Packed against
// BHLD is only where a head's rows start and how far apart they lie
// (`Geom`); the bodies are shared, each layout has its own __global__ entry
// (so a profile tells them apart). Tiles are staged in shared memory as fp32,
// transposed and padded to a row of 65 floats ([d][row]), so both the
// row-wise and the column-wise reads of every product are free of bank
// conflicts. A thread owns 4 rows x 4 columns of each 64 x 64 score tile
// (rows ty + 16 i, columns tx + 16 j) and 4 rows x D/16 columns of each
// 64 x D accumulator; the running max, sum and accumulators stay in fp32
// registers. A ragged L is masked here, where JAX shrinks its blocks to
// divide L instead (scaffold.fit_block): keys past L get probability 0, rows
// past L are never written.
//
// The keep mask ([B*H, L, L], nonzero = kept, the caller's draw): the
// CUDA-core forward reads it straight from device memory (16 lanes of a
// half-warp read 16 neighbouring bytes of one query row); the CUDA-core dQ
// and dK/dV first stage each 64 x 64 tile in shared memory beside the tiles
// of K and V (dQ) or Q and dO (dK/dV), so no byte load waits inside the score
// loop, as fp32 keep factors; the tensor-core bodies stage the bytes
// themselves (16-byte chunks XOR-swizzled by row, so the row-wise and the
// column-wise reads are both free of bank conflicts), expanded to inv_keep
// or 0 in the fragment's own positions.
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
//   bf16 on the tensor cores: S and dP are exact products of the bf16
//     inputs summed in fp32. The backward rounds P keep and dS to bf16 before
//     the products that consume them (the only rounding the CUDA-core bodies
//     do not do; chip_smoke.py holds the gradients at `flash_bf16_tc`). The
//     forward does not round P keep once: it splits it into hi = P keep
//     rounded to bf16 and lo = the rest rounded, and adds hi V + lo V (16
//     significant bits, at the price of a third product a tile). One
//     rounding (2^-9 of each term) moved o by up to 0.025 of its RMS, and
//     through delta = rowsum(dO O) it doubled the worst dQ error of the
//     backward at the train shape (0.05 -> 0.105 of the RMS) and took one
//     element past flash_bf16_tc; with the split, o keeps the CUDA-core
//     forward's bar, `flash_bf16` (tests/test_torch_flash.py grounds both
//     on the CPU). The normalizer l sums the fp32 p. The forward's scale
//     multiplies S after the dot, where the Pallas bodies scale q before it
//     (:90, :295): the same value up to fp32 rounding. The backward's scale
//     multiplies dQ and dK once, after the last tile (likewise).
#include <math.h>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores (see the note at the top)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 128;        // 4 warps, 16 output rows each
constexpr int kMaskRow = kBlock;     // a staged keep-mask row: 64 bytes
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// a bf16 tile row in shared memory: D elements and 16 bytes of pad
template <int D>
__host__ __device__ constexpr int row_of() { return D + 8; }
template <int D>
__host__ __device__ constexpr int tile_of() { return kBlock * row_of<D>(); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared without the registers; zero-filled (no global read)
// when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), c 16 x 8 fp32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to nearest-even bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two fp32 values as the sums hi + lo of two bf16 pairs: hi rounded to
// nearest-even, lo the rest rounded (16 significant bits between them)
__device__ __forceinline__ void pack_bf16_split(float x, float y,
                                                uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The fp32 accumulator fragments of n8 tiles 2 kk and 2 kk + 1 as the A
// fragment of k16 tile kk, split into hi + lo.
__device__ __forceinline__ void to_a_frag_split(const float (&c)[8][4],
                                                int kk, uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
  pack_bf16_split(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  pack_bf16_split(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  pack_bf16_split(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  pack_bf16_split(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// The fp32 accumulator fragments of a 16 x 64 tile (n8 tiles 0..7) as the
// bf16 A fragments of its four k16 tiles.
__device__ __forceinline__ void to_a_frags(const float (&c)[8][4],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Rows [row0, row0 + 64) of one head into dst[r * (D + 8) + d], 16 bytes a
// cp.async; rows past L are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          long long base, int row0, int L,
                                          int row_stride) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < L;
    const bf16* g =
        src + base +
        static_cast<long long>(valid ? row0 + r : 0) * row_stride + c * 8;
    cp_async16(dst + r * row_of<D>() + c * 8, g, valid);
  }
}

// Where byte (query r, key c) of a staged 64 x 64 keep tile lies: 64-byte
// rows whose 16-byte chunks are XOR-swizzled by (r / 2) % 4, so the dQ
// body's reads (8 rows, one chunk) and the dK/dV body's (4 rows of one
// parity, one chunk) fall in distinct banks.
__device__ __forceinline__ int keep_at(int r, int c) {
  return r * kMaskRow + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15);
}

// The keep bytes of queries [q0, q0 + 64) x keys [k0, k0 + 64); bytes past
// L are 0. 16 bytes a cp.async where every mask row starts 16-byte aligned
// (`vec`: L % 16 == 0 and an aligned mask), else one byte load each.
__device__ __forceinline__ void load_keep(
    unsigned char* dst, const unsigned char* __restrict__ mask,
    long long mrow0, int q0, int k0, int L, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kBlock * 4; i += kThreads) {
      const int r = i >> 2, c = (i & 3) << 4;
      const bool valid = q0 + r < L && k0 + c < L;
      const long long off =
          valid ? static_cast<long long>(q0 + r) * L + k0 + c : 0;
      cp_async16(dst + keep_at(r, c), mask + mrow0 + off, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kBlock * kBlock; i += kThreads) {
      const int r = i >> 6, c = i & (kBlock - 1);
      const bool valid = q0 + r < L && k0 + c < L;
      dst[keep_at(r, c)] =
          valid ? mask[mrow0 + static_cast<long long>(q0 + r) * L + k0 + c]
                : 0;
    }
  }
}

// The keep bytes of this thread's 32 fragment positions of a staged tile
// as bits: bit 4 j + e for element e of n8 tile j, whose (row, column) in
// the fragment is (r_local + 8 (e / 2), 8 j + 2 t + e % 2). `kTransposed`:
// the tile's rows are the fragment's columns (dK/dV: fragments are
// [key][query], the tile [query][key]).
template <bool kTransposed>
__device__ __forceinline__ uint32_t keep_bits(const unsigned char* tile,
                                              int r_local, int t) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r_local + 8 * (e >> 1), c = j * 8 + 2 * t + (e & 1);
      const int at = kTransposed ? keep_at(c, r) : keep_at(r, c);
      bits |= static_cast<uint32_t>(tile[at] != 0) << (4 * j + e);
    }
  return bits;
}

__device__ __forceinline__ bool vec_mask(const unsigned char* mask, int L) {
  return L % 16 == 0 && (reinterpret_cast<uintptr_t>(mask) & 15u) == 0;
}

template <int D, bool kMask>
constexpr size_t fwd_smem() {
  return 5 * tile_of<D>() * sizeof(bf16) + 2 * kBlock * sizeof(float) +
         (kMask ? 2 * kBlock * kMaskRow : 0);
}
template <int D, bool kMask>
constexpr size_t dq_smem() {
  return 6 * tile_of<D>() * sizeof(bf16) +
         (kMask ? 2 * kBlock * kMaskRow : 0);
}
template <int D, bool kMask>
constexpr size_t dkv_smem() {
  return 6 * tile_of<D>() * sizeof(bf16) + 4 * kBlock * sizeof(float) +
         (kMask ? 2 * kBlock * kMaskRow : 0);
}

// dQ for one (64-query block, head, batch row): streams K/V tiles.
template <typename T, int D, bool kBHLD, bool kMask>
__device__ __forceinline__ void flash_dq_tc(PTT_FLASH_PARAMS) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core body is bf16");
  constexpr int kRow = row_of<D>(), kTile = tile_of<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [64][kRow]
  bf16* dos = qs + kTile;                        // [64][kRow]
  bf16* ks = dos + kTile;                        // [2][64][kRow]
  bf16* vs = ks + 2 * kTile;                     // [2][64][kRow]
  unsigned char* keep_s =
      reinterpret_cast<unsigned char*>(vs + 2 * kTile);  // [2][64][64]
  // heaviest causal blocks (the last queries) start first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const Geom gm = geom<kBHLD, D>(b, h, L, H);
  const float* bias_row =
      bias != nullptr ? bias + static_cast<long long>(b) * L : nullptr;
  const bool vec = kMask && vec_mask(mask, L);
  const int n_tiles = causal ? qb + 1 : (L + kBlock - 1) / kBlock;

  auto load_kv = [&](int kt, int buf) {
    load_tile<D>(ks + buf * kTile, k, gm.base, kt * kBlock, L,
                 gm.row_stride);
    load_tile<D>(vs + buf * kTile, v, gm.base, kt * kBlock, L,
                 gm.row_stride);
    if constexpr (kMask)
      load_keep(keep_s + buf * kBlock * kMaskRow, mask, gm.mask, q0,
                kt * kBlock, L, vec);
  };
  load_tile<D>(qs, q, gm.base, q0, L, gm.row_stride);
  load_tile<D>(dos, dout, gm.base, q0, L, gm.row_stride);
  load_kv(0, 0);
  cp_async_commit();

  // this thread's rows of the block: r_local and r_local + 8
  const int r_local = warp * 16 + (lane >> 2);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + r_local + 8 * hi;
    const long long st =
        gm.stat + static_cast<long long>(row) * gm.stat_stride;
    lse_r[hi] = row < L ? lse_in[st] : 0.f;
    delta_r[hi] = row < L ? delta[st] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // each lane's ldmatrix row address within a tile: A fragments (16 rows
  // x 16), B fragments of two n8 tiles (rows = n), and the same transposed
  // (rows = k)
  const int a_off = (warp * 16 + (lane & 15)) * kRow + ((lane >> 4) << 3);
  const int b_off =
      ((lane & 7) + ((lane >> 4) << 3)) * kRow + (((lane >> 3) & 1) << 3);
  const int bt_off =
      ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRow + ((lane >> 4) << 3);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kst = ks + buf * kTile;
    const bf16* vst = vs + buf * kTile;
    uint32_t keep = 0;
    if constexpr (kMask)
      keep = keep_bits<false>(keep_s + buf * kBlock * kMaskRow, r_local, t);
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(aq, qs + a_off + kk * 16);
      ldsm_x4(ado, dos + a_off + kk * 16);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, kst + b_off + jn * 16 * kRow + kk * 16);
        ldsm_x4(bv, vst + b_off + jn * 16 * kRow + kk * 16);
        mma(s[2 * jn], aq, bk[0], bk[1]);
        mma(s[2 * jn + 1], aq, bk[2], bk[3]);
        mma(dp[2 * jn], ado, bv[0], bv[1]);
        mma(dp[2 * jn + 1], ado, bv[2], bv[3]);
      }
    }
    // P and dS in the fragments' own positions: element e of n8 tile j is
    // (query r_local + 8 (e / 2), key 8 j + 2 t + e % 2) of the tile
    const int k0 = kt * kBlock;
    const bool edge = (causal && kt == qb) || k0 + kBlock > L;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const int c = j * 8 + 2 * t + (e & 1);
        const int col = k0 + c;
        float x = s[j][e] * scale;
        if (bias_row != nullptr) x += col < L ? bias_row[col] : 0.f;
        if (edge) {
          if (col >= L) x = -INFINITY;     // ragged edge: probability 0
          else if (causal && q0 + r_local + 8 * hi < col) x = kNegInf;
        }
        const float p = exp2f((x - lse_r[hi]) * kLog2e);
        float dpk = dp[j][e];
        if constexpr (kMask)
          dpk *= (keep >> (4 * j + e)) & 1u ? inv_keep : 0.f;
        s[j][e] = p * (dpk - delta_r[hi]);   // dS
      }
    }
    uint32_t ads[4][4];
    to_a_frags(s, ads);
    // dQ += dS K: the product sums over K's rows, so its B fragments come
    // transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bk[4];
        ldsm_x4_t(bk, kst + bt_off + kk * 16 * kRow + nd * 16);
        mma(acc[2 * nd], ads[kk], bk[0], bk[1]);
        mma(acc[2 * nd + 1], ads[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // this tile's buffers are free for tile kt + 2
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + r_local + 8 * hi;
    if (row >= L) continue;
    bf16* out = dq + gm.base + static_cast<long long>(row) * gm.row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) =
          pack_bf16(scale * acc[n][2 * hi], scale * acc[n][2 * hi + 1]);
  }
}

// dK and dV for one (64-key block, head, batch row): streams Q/dO tiles.
template <typename T, int D, bool kBHLD, bool kMask>
__device__ __forceinline__ void flash_dkv_tc(PTT_FLASH_PARAMS) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core body is bf16");
  constexpr int kRow = row_of<D>(), kTile = tile_of<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);  // [64][kRow]
  bf16* vs = ks + kTile;                         // [64][kRow]
  bf16* qs = vs + kTile;                         // [2][64][kRow]
  bf16* dos = qs + 2 * kTile;                    // [2][64][kRow]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile);  // [2][64]
  float* delta_s = lse_s + 2 * kBlock;                       // [2][64]
  unsigned char* keep_s =
      reinterpret_cast<unsigned char*>(delta_s + 2 * kBlock);  // [2][64][64]
  // blockIdx.x = 0 (the first keys) meets the most causal queries
  const int kb = blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const Geom gm = geom<kBHLD, D>(b, h, L, H);
  const bool vec = kMask && vec_mask(mask, L);
  const int first = causal ? kb : 0;
  const int n_q = (L + kBlock - 1) / kBlock;

  auto load_q = [&](int qt, int buf) {
    const int q0 = qt * kBlock;
    load_tile<D>(qs + buf * kTile, q, gm.base, q0, L, gm.row_stride);
    load_tile<D>(dos + buf * kTile, dout, gm.base, q0, L, gm.row_stride);
    // threads 0-63 stage lse, 64-127 delta
    const int r = threadIdx.x & (kBlock - 1);
    const bool valid = q0 + r < L;
    const long long st =
        gm.stat + static_cast<long long>(valid ? q0 + r : 0) * gm.stat_stride;
    if (threadIdx.x < kBlock)
      cp_async4(lse_s + buf * kBlock + r, lse_in + st, valid);
    else
      cp_async4(delta_s + buf * kBlock + r, delta + st, valid);
    if constexpr (kMask)
      load_keep(keep_s + buf * kBlock * kMaskRow, mask, gm.mask, q0, k0, L,
                vec);
  };
  load_tile<D>(ks, k, gm.base, k0, L, gm.row_stride);
  load_tile<D>(vs, v, gm.base, k0, L, gm.row_stride);
  load_q(first, 0);
  cp_async_commit();

  // this thread's keys of the block: r_local and r_local + 8
  const int r_local = warp * 16 + (lane >> 2);
  float bias_k[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = k0 + r_local + 8 * hi;
    bias_k[hi] = bias != nullptr && key < L
                     ? bias[static_cast<long long>(b) * L + key]
                     : 0.f;
  }
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int a_off = (warp * 16 + (lane & 15)) * kRow + ((lane >> 4) << 3);
  const int b_off =
      ((lane & 7) + ((lane >> 4) << 3)) * kRow + (((lane >> 3) & 1) << 3);
  const int bt_off =
      ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRow + ((lane >> 4) << 3);

  for (int qt = first; qt < n_q; ++qt) {
    const int buf = (qt - first) & 1;
    if (qt + 1 < n_q) {
      load_q(qt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qst = qs + buf * kTile;
    const bf16* dost = dos + buf * kTile;
    uint32_t keep = 0;
    if constexpr (kMask)
      keep = keep_bits<true>(keep_s + buf * kBlock * kMaskRow, r_local, t);
    float s[8][4], dp[8][4];  // S^T and dP^T: [key][query]
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, ks + a_off + kk * 16);
      ldsm_x4(av, vs + a_off + kk * 16);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        uint32_t bq[4], bd[4];
        ldsm_x4(bq, qst + b_off + jn * 16 * kRow + kk * 16);
        ldsm_x4(bd, dost + b_off + jn * 16 * kRow + kk * 16);
        mma(s[2 * jn], ak, bq[0], bq[1]);
        mma(s[2 * jn + 1], ak, bq[2], bq[3]);
        mma(dp[2 * jn], av, bd[0], bd[1]);
        mma(dp[2 * jn + 1], av, bd[2], bd[3]);
      }
    }
    // element e of n8 tile j is (key r_local + 8 (e / 2), query
    // 8 j + 2 t + e % 2) of the tile
    const int q0 = qt * kBlock;
    const bool edge =
        (causal && qt == kb) || q0 + kBlock > L || k0 + kBlock > L;
    const float* lse_t = lse_s + buf * kBlock;
    const float* delta_t = delta_s + buf * kBlock;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lse2 =
          *reinterpret_cast<const float2*>(lse_t + j * 8 + 2 * t);
      const float2 delta2 =
          *reinterpret_cast<const float2*>(delta_t + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const int c = j * 8 + 2 * t + (e & 1);
        const int key = k0 + r_local + 8 * hi;
        float x = s[j][e] * scale + bias_k[hi];
        if (edge) {
          if (key >= L || q0 + c >= L) x = -INFINITY;
          else if (causal && q0 + c < key) x = kNegInf;
        }
        const float p = exp2f((x - ((e & 1) ? lse2.y : lse2.x)) * kLog2e);
        const float dl = (e & 1) ? delta2.y : delta2.x;
        if constexpr (kMask) {
          const float kf = (keep >> (4 * j + e)) & 1u ? inv_keep : 0.f;
          s[j][e] = p * kf;                      // P keep
          dp[j][e] = p * (dp[j][e] * kf - dl);   // dS
        } else {
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl);
        }
      }
    }
    uint32_t ap[4][4], ads[4][4];
    to_a_frags(s, ap);
    to_a_frags(dp, ads);
    // dV += (P keep)^T dO and dK += dS^T Q sum over the tile's queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bd[4], bq[4];
        ldsm_x4_t(bd, dost + bt_off + kk * 16 * kRow + nd * 16);
        ldsm_x4_t(bq, qst + bt_off + kk * 16 * kRow + nd * 16);
        mma(dva[2 * nd], ap[kk], bd[0], bd[1]);
        mma(dva[2 * nd + 1], ap[kk], bd[2], bd[3]);
        mma(dka[2 * nd], ads[kk], bq[0], bq[1]);
        mma(dka[2 * nd + 1], ads[kk], bq[2], bq[3]);
      }
    }
    __syncthreads();  // this tile's buffers are free for tile qt + 2
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = k0 + r_local + 8 * hi;
    if (key >= L) continue;
    const long long off =
        gm.base + static_cast<long long>(key) * gm.row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t) =
          pack_bf16(scale * dka[n][2 * hi], scale * dka[n][2 * hi + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t) =
          pack_bf16(dva[n][2 * hi], dva[n][2 * hi + 1]);
    }
  }
}

// The forward for one (64-query block, head, batch row): Q held in
// registers as A fragments, K/V tiles (and the key bias and keep-mask
// tiles) streamed; S and P never leave the registers.
template <typename T, int D, bool kBHLD, bool kMask>
__device__ __forceinline__ void flash_fwd_tc(PTT_FLASH_PARAMS) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core body is bf16");
  constexpr int kRow = row_of<D>(), kTile = tile_of<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [64][kRow]
  bf16* ks = qs + kTile;                         // [2][64][kRow]
  bf16* vs = ks + 2 * kTile;                     // [2][64][kRow]
  float* bias_s = reinterpret_cast<float*>(vs + 2 * kTile);  // [2][64]
  unsigned char* keep_s =
      reinterpret_cast<unsigned char*>(bias_s + 2 * kBlock);  // [2][64][64]
  // heaviest causal blocks (the last queries) start first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const Geom gm = geom<kBHLD, D>(b, h, L, H);
  const float* bias_row =
      bias != nullptr ? bias + static_cast<long long>(b) * L : nullptr;
  const bool vec = kMask && vec_mask(mask, L);
  const int n_tiles = causal ? qb + 1 : (L + kBlock - 1) / kBlock;

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kBlock;
    load_tile<D>(ks + buf * kTile, k, gm.base, k0, L, gm.row_stride);
    load_tile<D>(vs + buf * kTile, v, gm.base, k0, L, gm.row_stride);
    if (bias_row != nullptr && threadIdx.x < kBlock) {
      const int c = threadIdx.x;
      const bool valid = k0 + c < L;
      cp_async4(bias_s + buf * kBlock + c, bias_row + (valid ? k0 + c : 0),
                valid);
    }
    if constexpr (kMask)
      load_keep(keep_s + buf * kBlock * kMaskRow, mask, gm.mask, q0, k0, L,
                vec);
  };
  load_tile<D>(qs, q, gm.base, q0, L, gm.row_stride);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();

  const int a_off = (warp * 16 + (lane & 15)) * kRow + ((lane >> 4) << 3);
  const int b_off =
      ((lane & 7) + ((lane >> 4) << 3)) * kRow + (((lane >> 3) & 1) << 3);
  const int bt_off =
      ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRow + ((lane >> 4) << 3);

  // this warp's 16 query rows of Q as the A fragments of every k16 step,
  // read once
  cp_async_wait<1>();
  __syncthreads();
  uint32_t aq[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(aq[kk], qs + a_off + kk * 16);

  // this thread's rows of the block: r_local and r_local + 8
  const int r_local = warp * 16 + (lane >> 2);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kst = ks + buf * kTile;
    const bf16* vst = vs + buf * kTile;
    const float* bias_t = bias_s + buf * kBlock;
    uint32_t keep = 0;
    if constexpr (kMask)
      keep = keep_bits<false>(keep_s + buf * kBlock * kMaskRow, r_local, t);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        uint32_t bk[4];
        ldsm_x4(bk, kst + b_off + jn * 16 * kRow + kk * 16);
        mma(s[2 * jn], aq[kk], bk[0], bk[1]);
        mma(s[2 * jn + 1], aq[kk], bk[2], bk[3]);
      }
    }
    // element e of n8 tile j is (query r_local + 8 (e / 2), key
    // 8 j + 2 t + e % 2) of the tile: the scale, the key bias, the masks
    const int k0 = kt * kBlock;
    const bool edge = (causal && kt == qb) || k0 + kBlock > L;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const int c = j * 8 + 2 * t + (e & 1);
        const int col = k0 + c;
        float x = s[j][e] * scale;
        if (bias_row != nullptr) x += bias_t[c];
        if (edge) {
          if (col >= L) x = -INFINITY;     // ragged edge: probability 0
          else if (causal && q0 + r_local + 8 * hi < col) x = kNegInf;
        }
        s[j][e] = x;
        mx[hi] = fmaxf(mx[hi], x);
      }
    }
    // the online softmax; the four lanes of a quad share a row
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      const float m_new = fmaxf(m[hi], mx[hi]);
      alpha[hi] = exp2f((m[hi] - m_new) * kLog2e);
      m[hi] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const float p = exp2f((s[j][e] - m[hi]) * kLog2e);
        rs[hi] += p;                       // the normalizer: undropped p
        if constexpr (kMask)
          s[j][e] = (keep >> (4 * j + e)) & 1u ? p * inv_keep : 0.f;
        else
          s[j][e] = p;
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      rs[hi] += __shfl_xor_sync(0xffffffffu, rs[hi], 1);
      rs[hi] += __shfl_xor_sync(0xffffffffu, rs[hi], 2);
      l[hi] = alpha[hi] * l[hi] + rs[hi];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += (P keep) V, with P keep as hi + lo (see the note at the top):
    // the product sums over V's rows, so its B fragments come transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      to_a_frag_split(s, kk, hi, lo);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vst + bt_off + kk * 16 * kRow + nd * 16);
        mma(acc[2 * nd], hi, bv[0], bv[1]);
        mma(acc[2 * nd + 1], hi, bv[2], bv[3]);
        mma(acc[2 * nd], lo, bv[0], bv[1]);
        mma(acc[2 * nd + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this tile's buffers are free for tile kt + 2
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + r_local + 8 * hi;
    if (row >= L) continue;
    const float l_safe = fmaxf(l[hi], 1e-30f);
    bf16* out = o + gm.base + static_cast<long long>(row) * gm.row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) = pack_bf16(
          acc[n][2 * hi] / l_safe, acc[n][2 * hi + 1] / l_safe);
    if (t == 0)
      lse[gm.stat + static_cast<long long>(row) * gm.stat_stride] =
          m[hi] + logf(l_safe);
  }
}

}  // namespace tc

// The __global__ entries: the packed layout's (rows 8-10 of PERF.md's kernel
// table) and the BHLD layout's (rows 11-13), one name each. Every entry runs
// the tensor-core body for bf16 and the CUDA-core body for fp32 (on purpose:
// see the note at the top), each at its own block size.
template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
template <typename T>
constexpr int kEntryThreads = kTensorCores<T> ? tc::kThreads : kThreads;

template <typename T, int D>
__global__ void __launch_bounds__(kEntryThreads<T>)
    flash_fwd_kernel(PTT_FLASH_PARAMS) {
  if constexpr (kTensorCores<T>)
    tc::flash_fwd_tc<T, D, false, false>(PTT_FLASH_ARGS);
  else
    flash_fwd_body<T, D, false, false>(PTT_FLASH_ARGS);
}
template <typename T, int D>
__global__ void __launch_bounds__(kEntryThreads<T>)
    flash_bwd_dq_kernel(PTT_FLASH_PARAMS) {
  if constexpr (kTensorCores<T>)
    tc::flash_dq_tc<T, D, false, false>(PTT_FLASH_ARGS);
  else
    flash_dq_body<T, D, false, false>(PTT_FLASH_ARGS);
}
template <typename T, int D>
__global__ void __launch_bounds__(kEntryThreads<T>)
    flash_bwd_dkv_kernel(PTT_FLASH_PARAMS) {
  if constexpr (kTensorCores<T>)
    tc::flash_dkv_tc<T, D, false, false>(PTT_FLASH_ARGS);
  else
    flash_dkv_body<T, D, false, false>(PTT_FLASH_ARGS);
}
template <typename T, int D, bool kMask>
__global__ void __launch_bounds__(kEntryThreads<T>)
    flash_bhld_fwd_kernel(PTT_FLASH_PARAMS) {
  if constexpr (kTensorCores<T>)
    tc::flash_fwd_tc<T, D, true, kMask>(PTT_FLASH_ARGS);
  else
    flash_fwd_body<T, D, true, kMask>(PTT_FLASH_ARGS);
}
template <typename T, int D, bool kMask>
__global__ void __launch_bounds__(kEntryThreads<T>)
    flash_bhld_bwd_dq_kernel(PTT_FLASH_PARAMS) {
  if constexpr (kTensorCores<T>)
    tc::flash_dq_tc<T, D, true, kMask>(PTT_FLASH_ARGS);
  else
    flash_dq_body<T, D, true, kMask>(PTT_FLASH_ARGS);
}
template <typename T, int D, bool kMask>
__global__ void __launch_bounds__(kEntryThreads<T>)
    flash_bhld_bwd_dkv_kernel(PTT_FLASH_PARAMS) {
  if constexpr (kTensorCores<T>)
    tc::flash_dkv_tc<T, D, true, kMask>(PTT_FLASH_ARGS);
  else
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
  constexpr bool kTC = kTensorCores<T>;
  constexpr size_t smem =
      !kTC ? smem_of<kPass, D, kMask>()
           : (kPass == kFwd ? tc::fwd_smem<D, kMask>()
              : kPass == kDQ ? tc::dq_smem<D, kMask>()
                             : tc::dkv_smem<D, kMask>());
  if constexpr (kTC) {
    // cp.async moves 16 bytes a thread: every row must start aligned (the
    // forward has no dout)
    for (const void* p : {a.q, a.k, a.v, a.dout})
      if (!ptt::aligned16(p))
        return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = allow_smem(kernel, smem);
  if (kTC && err == cudaSuccess)  // room for two CTAs an SM
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.L + kBlock - 1) / kBlock, a.H, a.B);
  kernel<<<grid, kTC ? tc::kThreads : kThreads, smem, a.stream>>>(
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
