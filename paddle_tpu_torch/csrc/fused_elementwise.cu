// Bias + GELU forward y = gelu(x + b) and its backward, and the dropout +
// residual join forward and backward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused_elementwise.py:64 `_bg_fwd_kernel`
// (launched by `_bg_fwd_impl`, :92) and :69 `_bg_bwd_kernel` (launched by
// `_bg_bwd`, :114), reached through `nn_ops.bias_gelu`
// (paddle_tpu/ops/nn_ops.py:53) from GPTMLP (paddle_tpu/models/gpt.py:339).
//
// What bounds them on this card: bytes, and for the backward instruction
// issue too. The forward reads x and writes y, the backward reads x and dy
// and writes dx (4 and 6 bytes an element in bf16): at 3.35 TB/s the gpt_1p3b
// step's [16384, 8192] is 0.160 ms forward and 0.240 ms backward. The
// backward issues ~50 instructions an element (conversions, the accurate
// tanhf, a dozen multiplies), ~0.2 ms at 132 SMs x 128 lanes x 1.755 GHz:
// close to its bytes bound. Far below the ~295 operations a byte ridge, so
// neither is tensor-core work. At a decode step's [8, 8192] the forward moves
// 256 KB, under a tenth of a microsecond at full rate: the launch and one
// memory round trip bound it there.
//
// Forward design: a 2-D grid of column tiles x chunks of rows (the
// wrapper's `bias_gelu_fwd_grid`). A thread owns one 16-byte vector of
// columns (32-bit index, no modulo) and loads its bias vector once. A chunk
// is kFwdLoads rows whose loads are all issued before the first is used: one
// trip, after which the CTA ends, so the CTAs, launched in order, sweep
// memory as a copy does. At [16384, 8192] bf16 that runs at the rate of a
// copy of the same bytes (`copy_`, `torch.neg`), 89 % of the bytes bound;
// CTAs that walked 125- or 16-row chunks with the same body reached 82 % and
// 87 %, a row a CTA 81 %. Rows too few to fill the card (decode) get a chunk
// each: one vector a thread, no row loop. The tanh form runs as
// u / (1 + e^(-2z)), the same function (0.5 (1 + tanh z) = 1 / (1 + e^(-2z)))
// without the cancellation of 1 + tanh z at negative u, in one `ex2.approx`
// and one reciprocal where tanhf takes ~20 dependent instructions. Its
// argument is rounded once in fp32, so its relative error grows with |z| as
// |2z| 2^-24: on the card, over 2.2 M points (u in [-12, 12] and randn x 3),
// at most 8.4e-6 relative (outputs above 1e-30) and 5.2e-7 absolute
// (tools/flash_bwd_ab.py --bias-gelu). The erf form keeps erfcf. A row that
// is not 16-byte aligned, or n not a multiple of the vector, takes the same
// partition element by element.
//
// Backward design: du = dy * gelu'(u) with u = x + b added in x's dtype and
// upcast (:76), dx = du rounded to x's dtype, and db = the fp32 sum of du over
// rows. The Pallas body accumulates db over its SEQUENTIAL row grid in VMEM;
// CTAs run in no order, so the grid is 2-D: column tiles of one warp's width
// of 16-byte vectors x chunks of contiguous rows (the wrapper's
// `bias_gelu_bwd_grid` picks the chunks: about kBwdCtasPerSm CTAs an SM,
// each resident at once). A thread owns 8 contiguous bf16 (4 fp32) columns,
// moves them with one 16-byte load or store an array, loads its bias vector
// once, forms u with packed bf16 adds (the same single rounding as the
// scalar add) and converts in pairs, keeps its dbias in registers over its
// rows, and issues the next row's loads before it computes the current one
// (32 bytes a thread in flight, ~32 KB an SM at 1024 resident threads). The
// CTA adds its warps' sums in shared memory once, in warp order, into one
// row of `part` [chunks, n]; pass 2 (ptt::launch_column_sum, a second launch
// from the same entry point) sums those rows in chunk order: deterministic,
// no atomics. A row that is not 16-byte aligned, or n not a multiple of the
// vector, takes the same partition element by element (ptt::load_vec).
// The partials' order (rows 8 apart within a warp, warps, chunks, then the
// column sum's groups) is emulated on the CPU in tests/test_torch_reduce.py.
//
// Numerics: the bias is cast to x's dtype and added in x's dtype, as in
// fused_elementwise.py:105 and :143. The GELU and its derivative run in fp32
// (the derivative op for op as `_gelu_grad`, :48-58; the forward's tanh form
// by the identity above). The forward rounds once to x's dtype; JAX
// evaluates jax.nn.gelu inside bf16 arithmetic instead, rounding after each
// op, so bf16 outputs may differ from the JAX route by a few bf16 ulps; fp32
// agrees to float rounding.
//
// Dropout + residual join. Replaces :149 `_da_fwd_kernel` (launched by
// `_da_fwd_impl`, :184) and :156 `_da_bwd_kernel` (launched by `_da_bwd`,
// :199), reached through `nn_ops.dropout_add` (paddle_tpu/ops/nn_ops.py:
// 101-109) from both residual joins of each GPT decoder layer
// (paddle_tpu/models/gpt.py:378). Forward: y = where(keep, x / (1 - p), 0),
// rounded to x's dtype, + residual; backward: dx = where(keep, dy / (1 - p),
// 0) (the residual's gradient is dy itself and needs no kernel). The keep
// mask is drawn by the caller and read here as one byte an element (a torch
// bool tensor), where the reference streams an fp32 0/1 mask; "keep iff
// nonzero" reads as the reference's "keep iff > 0.5".
//
// What bounds them: bytes. The forward reads x, the residual and the mask and
// writes y (7 bytes an element in bf16), the backward reads the mask and dy
// and writes dx (5 bytes); one divide and one add an element. Design: a
// grid-stride loop over 16-byte vectors of x (with the matching 8- or 4-byte
// slice of the mask), a scalar loop over the ragged tail.
//
// Numerics: jnp divides a bf16 x by a Python float in bf16, so the divisor is
// 1 - p rounded to x's dtype first (0.9 becomes 0.8984375 in bf16); the
// quotient is rounded to x's dtype BEFORE the residual add, as `.astype(
// x.dtype)` does at fused_elementwise.py:151-153, and the add rounds again.
// Adding in fp32 and rounding once would give other bf16 bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTanh>
__device__ __forceinline__ float gelu(float u) {
  if constexpr (kTanh) {
    // jax.nn.gelu(approximate=True): u * 0.5 * (1 + tanh z), z = sqrt(2/pi)
    // (u + 0.044715 u^3), as u / (1 + e^(-2z)) = u / (1 + 2^w), w = -2 z
    // log2(e): one ex2 and one reciprocal (`__fdividef`) where the accurate
    // tanhf costs ~20 dependent instructions. z << 0 gives 2^w = +inf and
    // u * rcp(inf) = -0, not NaN; 2^w in (2^126, 2^128) gives 0 where the
    // true value is below 1e-36.
    float w;
    asm("ex2.approx.ftz.f32 %0, %1;"
        : "=f"(w)
        : "f"(u * fmaf(-0.10294324f, u * u, -2.3022082f)));
    return __fdividef(u, 1.0f + w);
  }
  // jax.nn.gelu(approximate=False): 0.5 * u * erfc(-u * sqrt(1/2))
  return 0.5f * u * erfcf(-u * 0.7071067811865476f);
}

// Forward geometry (mirrored by ops/kernels/fused_elementwise.py
// `bias_gelu_fwd_grid`): a CTA's kThreads threads take kThreads neighbouring
// 16-byte vectors of columns (a column tile, gridDim.x of them) over one
// chunk of contiguous rows (gridDim.y), kFwdLoads rows at a time with their
// loads all issued before the first is used: one trip a chunk, but for more
// rows than 65535 chunks hold; a row a chunk at decode.
constexpr int kFwdLoads = 4;
constexpr int kFwdCtasPerSm = 4;

// gelu(x + b) of one 16-byte vector: packed adds in T, fp32 GELU, one
// rounding to T
template <typename T, bool kTanh>
__device__ __forceinline__ uint4 bias_gelu_vec(uint4 xv, uint4 bv) {
  float u[ptt::kVec16<T>];
  ptt::unpack(ptt::add_vec(xv, bv, T{}), u, T{});
#pragma unroll
  for (int j = 0; j < ptt::kVec16<T>; ++j) u[j] = gelu<kTanh>(u[j]);
  return ptt::pack(u, T{});
}

template <typename T, bool kTanh, bool kVec>
__global__ void __launch_bounds__(kThreads, kFwdCtasPerSm)
    bias_gelu_fwd_kernel(const T* __restrict__ x, const T* __restrict__ b,
                         T* __restrict__ y, int rows, int n,
                         int rows_per_chunk) {
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * ptt::kVec16<T>;
  if (c0 >= n) return;
  const int r0 = static_cast<int>(blockIdx.y) * rows_per_chunk;
  const int r_end = rows - r0 < rows_per_chunk ? rows : r0 + rows_per_chunk;
  const uint4 bv = ptt::load_vec(b, c0, n, kVec);
  const long long off = static_cast<long long>(r0) * n;
  const T* xr = x + off;
  T* yr = y + off;
  int r = r0;
  for (; r_end - r >= kFwdLoads; r += kFwdLoads) {
    uint4 v[kFwdLoads];
#pragma unroll
    for (int k = 0; k < kFwdLoads; ++k)
      v[k] = ptt::load_vec(xr + static_cast<long long>(k) * n, c0, n, kVec);
#pragma unroll
    for (int k = 0; k < kFwdLoads; ++k)
      ptt::store_vec(yr + static_cast<long long>(k) * n, c0, n, kVec,
                     bias_gelu_vec<T, kTanh>(v[k], bv));
    xr += static_cast<long long>(kFwdLoads) * n;
    yr += static_cast<long long>(kFwdLoads) * n;
  }
  for (; r < r_end; ++r, xr += n, yr += n) {
    const uint4 v = ptt::load_vec(xr, c0, n, kVec);
    ptt::store_vec(yr, c0, n, kVec, bias_gelu_vec<T, kTanh>(v, bv));
  }
}

// d gelu(u) / du, op for op as fused_elementwise.py:48-58 `_gelu_grad`
template <bool kTanh>
__device__ __forceinline__ float gelu_grad(float u) {
  if constexpr (kTanh) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    const float inner = c * (u + 0.044715f * (u * u * u));
    const float t = tanhf(inner);
    // 0.5 (1 + t) + 0.5 u (1 - t^2) c (1 + 3 * 0.044715 u^2)
    return 0.5f * (1.0f + t) +
           0.5f * u * (1.0f - t * t) * c * (1.0f + 0.134145f * (u * u));
  }
  const float phi = expf(-0.5f * u * u) * 0.3989422804014327f;  // 1/sqrt(2pi)
  const float cdf = 0.5f * (1.0f + erff(u * 0.7071067811865476f));
  return cdf + u * phi;
}

// Backward geometry (mirrored by ops/kernels/fused_elementwise.py
// `bias_gelu_bwd_grid`): a CTA of kThreads takes a column tile of one
// warp's width of 16-byte vectors (kTileCols: 256 bf16 or 128 fp32
// columns) over one chunk of rows; its 8 warps walk the chunk's rows 8
// apart, so a warp reads 512 contiguous bytes of a row.
constexpr int kBwdWarps = kThreads / 32;
constexpr int kBwdCtasPerSm = 4;

template <typename T, bool kTanh>
__device__ __forceinline__ void bias_gelu_bwd_row(uint4 xv, uint4 dv, uint4 bv,
                                                  T* __restrict__ dx_row,
                                                  int c0, int n, bool vec,
                                                  float (&acc)[ptt::kVec16<T>]) {
  constexpr int V = ptt::kVec16<T>;
  float u[V], g[V], du[V];
  ptt::unpack(ptt::add_vec(xv, bv, T{}), u, T{});
  ptt::unpack(dv, g, T{});
#pragma unroll
  for (int j = 0; j < V; ++j) {
    du[j] = g[j] * gelu_grad<kTanh>(u[j]);
    acc[j] += du[j];
  }
  ptt::store_vec(dx_row, c0, n, vec, ptt::pack(du, T{}));
}

// Pass 1: dx for the tile's rows of the chunk, and the chunk's dbias
// partial. Each thread keeps its 8 (4) columns' sum in registers over the
// rows it walks, in row order, with the next row's x and dy already in
// flight; the CTA adds its 8 warps' sums in warp order in shared memory
// once, at the end, into row blockIdx.y of `part` [chunks, n].
template <typename T, bool kTanh>
__global__ void __launch_bounds__(kThreads, kBwdCtasPerSm)
    bias_gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ b,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ part, int rows, int n,
                         int rows_per_chunk, bool vec) {
  constexpr int V = ptt::kVec16<T>;
  constexpr int kTileCols = 32 * V;
  __shared__ float comb[kBwdWarps][kTileCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kTileCols + lane * V;
  const int r0 = static_cast<int>(blockIdx.y) * rows_per_chunk;
  const int r_end = rows - r0 < rows_per_chunk ? rows : r0 + rows_per_chunk;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  int r = r0 + warp;
  if (c0 < n && r < r_end) {
    const uint4 bv = ptt::load_vec(b, c0, n, vec);
    const long long step = static_cast<long long>(kBwdWarps) * n;
    long long off = static_cast<long long>(r) * n;
    uint4 xv = ptt::load_vec(x + off, c0, n, vec);
    uint4 dv = ptt::load_vec(dy + off, c0, n, vec);
    for (; r < r_end; r += kBwdWarps, off += step) {
      uint4 xn = xv, dn = dv;
      if (r + kBwdWarps < r_end) {  // the next row's loads, issued first
        xn = ptt::load_vec(x + off + step, c0, n, vec);
        dn = ptt::load_vec(dy + off + step, c0, n, vec);
      }
      bias_gelu_bwd_row<T, kTanh>(xv, dv, bv, dx + off, c0, n, vec, acc);
      xv = xn;
      dv = dn;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) comb[warp][lane * V + j] = acc[j];
  __syncthreads();
  const int c = blockIdx.x * kTileCols + threadIdx.x;
  if (threadIdx.x < kTileCols && c < n) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += comb[w][threadIdx.x];
    part[static_cast<long long>(blockIdx.y) * n + c] = s;
  }
}

template <typename T, bool kTanh>
int launch_bwd_t(const void* x, const void* b, const void* dy, void* dx,
                 float* part, float* db, int rows, int n, int chunks,
                 int rows_per_chunk, cudaStream_t stream) {
  constexpr int kTileCols = 32 * ptt::kVec16<T>;
  const bool vec = n % ptt::kVec16<T> == 0 && ptt::aligned16(x) &&
                   ptt::aligned16(b) && ptt::aligned16(dy) &&
                   ptt::aligned16(dx);
  const dim3 grid((n + kTileCols - 1) / kTileCols, chunks);
  bias_gelu_bwd_kernel<T, kTanh><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, n,
      rows_per_chunk, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ptt::launch_column_sum(part, db, chunks, n, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* b, const void* dy, void* dx,
               float* part, float* db, int rows, int n, int chunks,
               int rows_per_chunk, bool approximate, cudaStream_t stream) {
  return approximate
             ? launch_bwd_t<T, true>(x, b, dy, dx, part, db, rows, n, chunks,
                                     rows_per_chunk, stream)
             : launch_bwd_t<T, false>(x, b, dy, dx, part, db, rows, n, chunks,
                                      rows_per_chunk, stream);
}

template <typename T, bool kTanh, bool kVec>
int launch_fwd_t(const void* x, const void* b, void* y, int rows, int n,
                 int chunks, int rows_per_chunk, cudaStream_t stream) {
  constexpr int kTileCols = kThreads * ptt::kVec16<T>;
  const dim3 grid((n + kTileCols - 1) / kTileCols, chunks);
  bias_gelu_fwd_kernel<T, kTanh, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(y),
      rows, n, rows_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* b, void* y, int rows, int n, int chunks,
           int rows_per_chunk, bool approximate, cudaStream_t stream) {
  const bool vec = n % ptt::kVec16<T> == 0 && ptt::aligned16(x) &&
                   ptt::aligned16(b) && ptt::aligned16(y);
  if (approximate)
    return vec ? launch_fwd_t<T, true, true>(x, b, y, rows, n, chunks,
                                             rows_per_chunk, stream)
               : launch_fwd_t<T, true, false>(x, b, y, rows, n, chunks,
                                              rows_per_chunk, stream);
  return vec ? launch_fwd_t<T, false, true>(x, b, y, rows, n, chunks,
                                            rows_per_chunk, stream)
             : launch_fwd_t<T, false, false>(x, b, y, rows, n, chunks,
                                             rows_per_chunk, stream);
}

// the mask bytes that go with one 16-byte vector of T
template <int V>
struct MaskBytes;
template <>
struct MaskBytes<8> {
  using type = uint2;
};
template <>
struct MaskBytes<4> {
  using type = unsigned int;
};

// where(keep, v / keep_prob, 0) rounded to T, with keep_prob already in T
template <typename T>
__device__ __forceinline__ T dropped(T v, bool keep, float kp) {
  return ptt::from_f32<T>(keep ? __fdiv_rn(ptt::to_f32(v), kp) : 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_add_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                           const uint8_t* __restrict__ keep,
                           T* __restrict__ y, long long n, float keep_prob,
                           bool vec) {
  constexpr int V = ptt::kVec16<T>;
  using MB = typename MaskBytes<V>::type;
  const float kp = ptt::to_f32(ptt::from_f32<T>(keep_prob));
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    for (long long i = first; i < n / V; i += stride) {
      const uint4 rx = reinterpret_cast<const uint4*>(x)[i];
      const uint4 rr = reinterpret_cast<const uint4*>(r)[i];
      const MB rm = reinterpret_cast<const MB*>(keep)[i];
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* er = reinterpret_cast<const T*>(&rr);
      const uint8_t* em = reinterpret_cast<const uint8_t*>(&rm);
      uint4 out;
      T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        eo[j] = ptt::add_t(dropped(ex[j], em[j] != 0, kp), er[j]);
      reinterpret_cast<uint4*>(y)[i] = out;
    }
    done = n / V * V;
  }
  for (long long i = done + first; i < n; i += stride)
    y[i] = ptt::add_t(dropped(x[i], keep[i] != 0, kp), r[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_add_bwd_kernel(const uint8_t* __restrict__ keep,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           long long n, float keep_prob, bool vec) {
  constexpr int V = ptt::kVec16<T>;
  using MB = typename MaskBytes<V>::type;
  const float kp = ptt::to_f32(ptt::from_f32<T>(keep_prob));
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    for (long long i = first; i < n / V; i += stride) {
      const uint4 rd = reinterpret_cast<const uint4*>(dy)[i];
      const MB rm = reinterpret_cast<const MB*>(keep)[i];
      const T* ed = reinterpret_cast<const T*>(&rd);
      const uint8_t* em = reinterpret_cast<const uint8_t*>(&rm);
      uint4 out;
      T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) eo[j] = dropped(ed[j], em[j] != 0, kp);
      reinterpret_cast<uint4*>(dx)[i] = out;
    }
    done = n / V * V;
  }
  for (long long i = done + first; i < n; i += stride)
    dx[i] = dropped(dy[i], keep[i] != 0, kp);
}

// one 16-byte vector a thread per step, enough CTAs to fill the SMs several
// times over; the grid-stride loop does the rest
template <typename T>
int elementwise_grid(long long n, bool vec) {
  const long long work = vec ? n / ptt::kVec16<T> : n;
  const long long want = (work + kThreads - 1) / kThreads;
  return static_cast<int>(want < 1 ? 1 : (want < 132 * 16 ? want : 132 * 16));
}

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T>
int launch_dropout_fwd(const void* x, const void* r, const void* keep,
                       void* y, long long n, float keep_prob,
                       cudaStream_t stream) {
  const bool vec = ptt::aligned16(x) && ptt::aligned16(r) &&
                   ptt::aligned16(y) && aligned(keep, ptt::kVec16<T>);
  dropout_add_fwd_kernel<T><<<elementwise_grid<T>(n, vec), kThreads, 0,
                              stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const uint8_t*>(keep), static_cast<T*>(y), n, keep_prob,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dropout_bwd(const void* keep, const void* dy, void* dx,
                       long long n, float keep_prob, cudaStream_t stream) {
  const bool vec = ptt::aligned16(dy) && ptt::aligned16(dx) &&
                   aligned(keep, ptt::kVec16<T>);
  dropout_add_bwd_kernel<T><<<elementwise_grid<T>(n, vec), kThreads, 0,
                              stream>>>(
      static_cast<const uint8_t*>(keep), static_cast<const T*>(dy),
      static_cast<T*>(dx), n, keep_prob, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, residual, y: [n] contiguous, one dtype; keep: [n] bytes (0: dropped).
extern "C" int ptt_dropout_add_fwd(const void* x, const void* residual,
                                   const void* keep, void* y, long long n,
                                   float keep_prob, int dtype, int device,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T,
                     return launch_dropout_fwd<T>(x, residual, keep, y, n,
                                                  keep_prob, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// keep: [n] bytes; dy, dx: [n] contiguous, one dtype.
extern "C" int ptt_dropout_add_bwd(const void* keep, const void* dy, void* dx,
                                   long long n, float keep_prob, int dtype,
                                   int device, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T,
                     return launch_dropout_bwd<T>(keep, dy, dx, n, keep_prob,
                                                  s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y: [rows, n] contiguous; b: [n] in x's dtype. Rows are cut into
// `chunks` chunks of `rows_per_chunk` (the last may be shorter, none empty;
// at most 65535 chunks), each a row of the grid. Any n up to 2^31 - 1 - 2048
// (32-bit column index inside a row, 64-bit row offsets).
extern "C" int ptt_bias_gelu_fwd(const void* x, const void* b, void* y,
                                 int rows, int n, int chunks,
                                 int rows_per_chunk, int approximate,
                                 int dtype, int device, void* stream) {
  if (rows <= 0 || n <= 0 || n > 2147483647 - 2048 || chunks <= 0 ||
      chunks > 65535 || rows_per_chunk <= 0 ||
      static_cast<long long>(chunks) * rows_per_chunk < rows ||
      static_cast<long long>(chunks - 1) * rows_per_chunk >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T,
                     return launch<T>(x, b, y, rows, n, chunks, rows_per_chunk,
                                      approximate != 0, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, dy, dx: [rows, n] contiguous; b: [n] in x's dtype. Rows are cut into
// `chunks` chunks of `rows_per_chunk` (the last may be shorter, none
// empty); part: [chunks, n] fp32 scratch; db: [n] fp32 out, every element
// written. Two launches: pass 1, then the column sum. Any n up to 2^31 - 1
// (32-bit column index inside a row, 64-bit row offsets).
extern "C" int ptt_bias_gelu_bwd(const void* x, const void* b, const void* dy,
                                 void* dx, void* part, void* db, int rows,
                                 int n, int chunks, int rows_per_chunk,
                                 int approximate, int dtype, int device,
                                 void* stream) {
  if (rows <= 0 || n <= 0 || chunks <= 0 || chunks > 65535 ||
      rows_per_chunk <= 0 ||
      static_cast<long long>(chunks) * rows_per_chunk < rows ||
      static_cast<long long>(chunks - 1) * rows_per_chunk >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(
      dtype, T,
      return launch_bwd<T>(x, b, dy, dx, static_cast<float*>(part),
                           static_cast<float*>(db), rows, n, chunks,
                           rows_per_chunk, approximate != 0, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
