// LayerNorm forward and backward over the last axis, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused_norm.py:52 `_fwd_kernel` (launched by
// `_fwd_pallas`, :92) and :63 `_bwd_kernel` (launched by `_bwd_pallas`, :112),
// reached through `nn_ops.layer_norm` (paddle_tpu/ops/nn_ops.py:247).
//
// What bounds them on this card: bytes. The forward reads x and writes y; the
// backward reads x and dy and writes dx; both do about 10 fp32 operations per
// element, far below the ~295 operations per byte at which an H100 stops being
// memory bound. The best either can do is one pass over its rows, with w/b
// and the per-row statistics from L2.
//
// Forward design: one CTA of 256 threads per row. The row is read once with
// 16-byte loads into shared memory as fp32, so the two reductions (mean, then
// the mean of squared deviations: the Pallas body's two-pass variance) and the
// epilogue re-read shared memory, not device memory. Cast points follow
// fused_norm.py:53-58: normalise in fp32, cast to x's dtype, then `* w` and
// `+ b` each rounded in x's dtype. mean and rstd ([rows] fp32, the Pallas
// body's residuals) are written only when the caller passes their pointers:
// training does, serving does not and pays nothing for them.
//
// Backward design: the Pallas body sums dw and db over its SEQUENTIAL row grid
// in VMEM scratch; CTAs have no order. So pass 1 gives each CTA a fixed,
// strided set of rows (row r goes to CTA r % parts) and a private fp32 [2, n]
// accumulator in shared memory (dw, then db; each thread owns the columns
// c = tid + 256 k, so no two threads touch one slot), writes dx per row, and
// stores its accumulator as one row of `part` [parts, 2n]. Pass 2
// (ptt::launch_column_sum, a second launch from the same entry point) sums
// the partials column by column in CTA order: deterministic, no atomics.
// dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) with
// dxhat = dy * w in fp32 (:71-79); dw accumulates dy * xhat with xhat cast to
// x's dtype and back, as the forward multiplies w by that cast (:82-83).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// block-wide fp32 sum; `red` holds kWarps + 1 floats
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = ptt::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? red[lane] : 0.f;
    t = ptt::warp_sum(t);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  const float total = red[kWarps];
  __syncthreads();  // red is reused by the next call
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ b, T* __restrict__ y,
                          float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int n, float eps,
                          bool vec) {
  extern __shared__ float row[];  // n floats
  __shared__ float red[kWarps + 1];
  constexpr int V = ptt::kVec16<T>;
  const T* xr = x + static_cast<long long>(blockIdx.x) * n;
  T* yr = y + static_cast<long long>(blockIdx.x) * n;

  float s = 0.f;
  if (vec) {
    for (int i = threadIdx.x; i < n / V; i += kThreads) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = ptt::to_f32(e[j]);
        row[i * V + j] = f;
        s += f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float f = ptt::to_f32(xr[i]);
      row[i] = f;
      s += f;
    }
  }
  const float mean = block_sum(s, red) / static_cast<float>(n);

  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float d = row[i] - mean;
    ss += d * d;
  }
  const float var = block_sum(ss, red) / static_cast<float>(n);
  const float rstd = 1.0f / sqrtf(var + eps);
  if (threadIdx.x == 0 && mean_out != nullptr) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }

  if (vec) {
    for (int i = threadIdx.x; i < n / V; i += kThreads) {
      const uint4 rw = reinterpret_cast<const uint4*>(w)[i];
      const uint4 rb = reinterpret_cast<const uint4*>(b)[i];
      const T* ew = reinterpret_cast<const T*>(&rw);
      const T* eb = reinterpret_cast<const T*>(&rb);
      uint4 out;
      T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T o = ptt::from_f32<T>((row[i * V + j] - mean) * rstd);
        eo[j] = ptt::add_t(ptt::mul_t(o, ew[j]), eb[j]);
      }
      reinterpret_cast<uint4*>(yr)[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const T o = ptt::from_f32<T>((row[i] - mean) * rstd);
      yr[i] = ptt::add_t(ptt::mul_t(o, w[i]), b[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ dy,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd, T* __restrict__ dx,
                          float* __restrict__ part, int rows, int n) {
  extern __shared__ float acc[];  // dw [n], then db [n]
  __shared__ float red[kWarps + 1];
  float* dw = acc;
  float* db = acc + n;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    dw[c] = 0.f;
    db[c] = 0.f;
  }
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long off = static_cast<long long>(r) * n;
    const float mu = mean[r];
    const float rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const float xhat = (ptt::to_f32(x[off + c]) - mu) * rs;
      const float g = ptt::to_f32(dy[off + c]);
      const float dxhat = g * ptt::to_f32(w[c]);
      s1 += dxhat;
      s2 += dxhat * xhat;
      dw[c] += g * ptt::to_f32(ptt::from_f32<T>(xhat));
      db[c] += g;
    }
    // jnp.mean divides the sum by n
    const float m1 = block_sum(s1, red) / static_cast<float>(n);
    const float m2 = block_sum(s2, red) / static_cast<float>(n);
    // second sweep over the row: its bytes were just read, so they come
    // from L1/L2, not device memory
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const float xhat = (ptt::to_f32(x[off + c]) - mu) * rs;
      const float dxhat = ptt::to_f32(dy[off + c]) * ptt::to_f32(w[c]);
      dx[off + c] = ptt::from_f32<T>(rs * (dxhat - m1 - xhat * m2));
    }
  }
  float* out = part + static_cast<long long>(blockIdx.x) * 2 * n;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    out[c] = dw[c];
    out[n + c] = db[c];
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

template <typename T>
int launch_fwd(const void* x, const void* w, const void* b, void* y,
               float* mean, float* rstd, int rows, int n, float eps,
               cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const cudaError_t err = allow_smem(layer_norm_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = n % ptt::kVec16<T> == 0 && ptt::aligned16(x) &&
                   ptt::aligned16(w) && ptt::aligned16(b) &&
                   ptt::aligned16(y);
  layer_norm_fwd_kernel<T><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), mean, rstd, n, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* dy,
               const float* mean, const float* rstd, void* dx, float* part,
               float* dw_db, int rows, int n, int parts,
               cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = allow_smem(layer_norm_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_bwd_kernel<T><<<parts, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), mean, rstd, static_cast<T*>(dx), part, rows,
      n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ptt::launch_column_sum(part, dw_db, parts, 2 * n, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [rows, n] contiguous; w, b: [n]; all of one dtype. mean, rstd: [rows]
// fp32, or both null to skip them.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, void* mean, void* rstd, int rows,
                                  int n, float eps, int dtype, int device,
                                  void* stream) {
  if (rows <= 0 || n <= 0 || (mean == nullptr) != (rstd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, T,
                     return launch_fwd<T>(x, w, b, y,
                                          static_cast<float*>(mean),
                                          static_cast<float*>(rstd), rows, n,
                                          eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, dy, dx: [rows, n] contiguous, one dtype; w: [n] of that dtype; mean,
// rstd: [rows] fp32 from the forward. part: [parts, 2n] fp32 scratch;
// dw_db: [2n] fp32 out (dw, then db). Two launches: pass 1, then the
// column sum.
extern "C" int ptt_layer_norm_bwd(const void* x, const void* w, const void* dy,
                                  const void* mean, const void* rstd,
                                  void* dx, void* part, void* dw_db, int rows,
                                  int n, int parts, int dtype, int device,
                                  void* stream) {
  if (rows <= 0 || n <= 0 || parts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(
      dtype, T,
      return launch_bwd<T>(x, w, dy, static_cast<const float*>(mean),
                           static_cast<const float*>(rstd), dx,
                           static_cast<float*>(part),
                           static_cast<float*>(dw_db), rows, n, parts, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
