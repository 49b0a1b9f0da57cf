// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel in this directory is compiled by nvcc for sm_90a into one
// shared library with a plain C interface (ops/kernels/_build.py loads it
// with ctypes). Each C entry point takes raw device pointers, ints, the
// device index and the caller's CUDA stream, launches on that stream
// without synchronising, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch. The error of a launch is read
// before the DeviceGuard's destructor switches the device back.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// dtype codes shared with ops/kernels/_build.py:DTYPE_CODES
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// int8_t is `signed char`: the conversion sign-extends, so -127..127 stay
// what they are (a plain `char` may be unsigned and must not reach here)
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// round-to-nearest-even, the rounding torch and XLA use for a cast
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one rounded op in the storage type T: fp32 arithmetic, then a single
// cast. For T=float the _rn intrinsics keep nvcc from contracting a
// multiply and an add into one FMA, which would round once where the
// plain version rounds twice.
template <typename T>
__device__ __forceinline__ T mul_t(T a, T b) {
  return from_f32<T>(__fmul_rn(to_f32(a), to_f32(b)));
}
template <typename T>
__device__ __forceinline__ T add_t(T a, T b) {
  return from_f32<T>(__fadd_rn(to_f32(a), to_f32(b)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// elements of T in one 16-byte load or store (uint4)
template <typename T>
constexpr int kVec16 = 16 / sizeof(T);

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// One 16-byte vector of T at columns c0 .. c0 + kVec16<T> - 1 of a row:
// a single uint4 access when `vec` (n a multiple of the vector and the row
// 16-byte aligned), else element by element, columns past n read as 0 and
// not written (the scalar path: correct, not fast).
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ row, int c0,
                                          int n, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(row + c0);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int j = 0; j < kVec16<T>; ++j)
    if (c0 + j < n) e[j] = row[c0 + j];
  return r;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ row, int c0, int n,
                                          bool vec, uint4 v) {
  if (vec) {
    *reinterpret_cast<uint4*>(row + c0) = v;
    return;
  }
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int j = 0; j < kVec16<T>; ++j)
    if (c0 + j < n) row[c0 + j] = e[j];
}

// a vector's elements as fp32 (bf16 converted in pairs)
__device__ __forceinline__ void unpack(uint4 v, float (&f)[4], float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8],
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

// Σ of a vector's fp32 values, pairwise: ((f0 + f1) + (f2 + f3)) [+ ((f4 +
// f5) + (f6 + f7))], each add rounded (the order the reductions' CPU
// emulations follow)
__device__ __forceinline__ float pairwise_sum(const float (&f)[4]) {
  return __fadd_rn(__fadd_rn(f[0], f[1]), __fadd_rn(f[2], f[3]));
}
__device__ __forceinline__ float pairwise_sum(const float (&f)[8]) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(f[0], f[1]), __fadd_rn(f[2], f[3])),
      __fadd_rn(__fadd_rn(f[4], f[5]), __fadd_rn(f[6], f[7])));
}

// fp32 values rounded (to nearest even) into one vector of T
__device__ __forceinline__ uint4 pack(const float (&f)[4], float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], __nv_bfloat16) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return v;
}

// a + b element by element, one rounding to T each: add_t's result. For
// bf16 the packed add (one add.rn.bf16x2 a pair) rounds the exact sum
// once, as the fp32 add and the cast do (fp32's 24 bits hold two 8-bit
// significands' sum closely enough that the second rounding never moves).
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b, float) {
  return make_uint4(
      __float_as_uint(__fadd_rn(__uint_as_float(a.x), __uint_as_float(b.x))),
      __float_as_uint(__fadd_rn(__uint_as_float(a.y), __uint_as_float(b.y))),
      __float_as_uint(__fadd_rn(__uint_as_float(a.z), __uint_as_float(b.z))),
      __float_as_uint(__fadd_rn(__uint_as_float(a.w), __uint_as_float(b.w))));
}
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b, __nv_bfloat16) {
  uint4 r;
  const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* hr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) hr[j] = __hadd2(ha[j], hb[j]);
  return r;
}

// Makes `device` current for a launch and gives the caller's thread its
// own current device back afterwards, as torch's device guards do: torch
// reads the current device from the runtime, so a device left switched
// would move the caller's later allocations on a multi-GPU host.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_ = cudaSuccess;
};

// Second pass of a cross-row reduction: out[c] = sum over p of
// part[p * n + c], for c < n, summed in p order so the result does not
// depend on how CTAs were scheduled (no float atomics). The backward
// kernels write one row of fp32 partials per chunk of rows of their first
// pass; this pass replaces the Pallas bodies' VMEM accumulation across their
// sequential row grid. (Internal linkage: every source that includes this
// header gets its own copy, so the link sees no duplicate symbol.)
// A CTA of 32 x 8 threads takes 32 neighbouring columns; thread (x, y) sums
// the partials p = y, y + 8, ... of column x in order, and the 8 sums are then
// added in y order: a fixed order, whatever the schedule.
namespace {
constexpr int kSumCols = 32, kSumGroups = 8;

__global__ void __launch_bounds__(kSumCols * kSumGroups)
    column_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int parts, int n) {
  __shared__ float sums[kSumGroups][kSumCols];
  const int c = blockIdx.x * kSumCols + threadIdx.x;
  float s = 0.f;
  if (c < n)
    for (int p = threadIdx.y; p < parts; p += kSumGroups)
      s += part[static_cast<long long>(p) * n + c];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < kSumGroups; ++g) t += sums[g][threadIdx.x];
    out[c] = t;
  }
}

void launch_column_sum(const float* part, float* out, int parts, int n,
                       cudaStream_t stream) {
  column_sum_kernel<<<(n + kSumCols - 1) / kSumCols,
                      dim3(kSumCols, kSumGroups), 0, stream>>>(part, out,
                                                               parts, n);
}
}  // namespace

}  // namespace ptt

// Dispatch a dtype code to a type alias T; an unknown code returns
// cudaErrorInvalidValue from the enclosing C entry point.
#define PTT_DISPATCH_DTYPE(code, T, ...)            \
  switch (code) {                                   \
    case ptt::kFloat32: {                           \
      using T = float;                              \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case ptt::kBFloat16: {                          \
      using T = __nv_bfloat16;                      \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    default:                                        \
      return static_cast<int>(cudaErrorInvalidValue); \
  }
