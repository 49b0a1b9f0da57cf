// Ragged paged attention for the serving engine, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py:78 `_ragged_paged_kernel`,
// launched by `ragged_paged_attention_pallas` (:155) from
// GPTAttention.forward_paged (paddle_tpu/models/gpt.py:307), in both of its
// forms: dense pages in q's dtype (entry `ptt_ragged_paged_attention`), and
// the `quantized=True` branch (:93, :126-128) over int8 pages with one fp32
// abs-max scale per (slot, head) (entry `ptt_ragged_paged_attention_int8`,
// the engine's kv_dtype='int8'). The two share one body, a template on the
// page type; each entry has its own launch counter in the Python wrapper.
//
// Layouts (as in the Pallas kernel):
//   q            [B, T, H*D]          new-token queries, right-padded per row
//   k/v pages    [N, ps, H*D]         the pool, q's dtype or int8
//   k/v scales   fp32 [N, ps, H]      int8 pages only
//   page_tables  int32 [B, P]         entries clamped to [0, N-1]
//   seq_lens     int32 [B]            context length incl. this step's tokens
//   q_lens       int32 [B]            valid new tokens this step
//   out          [B, T, H*D]          in q's dtype
// Query t of row b sits at position seq_len - q_len + t and sees key k when
// k < seq_len and k <= its position.
//
// What bounds it on this card: bytes. A decode step reads every visible K/V row
// once (sum of context x H*D x 2 bytes x 2; with int8 pages H*D + 4*H bytes a
// row, about half) for ~4 operations per K/V element, far below the H100's
// ~295 bf16 operations per byte; chunked prefill reuses each K/V row for up
// to T queries and is still under the ridge at T=128.
//
// Design: one CTA per (row b, head h, block of QB queries). The TPU kernel
// walks a sequential (row, page) grid and carries the online-softmax state in
// VMEM between page steps; here the loop over the row's keys runs inside the
// CTA instead. The keys are cut into tiles of 32 (lane j of a warp owns key j of
// the tile), and the CTA's NW warps take tiles round-robin, each warp keeping
// its own running max, normaliser and fp32 accumulator in registers for every
// query of the block; at the end the warps' states are merged through shared
// memory. Splitting the keys over warps is what fills the CTA at decode
// (QB = 1). A K/V row is read by one warp with each lane holding D/32
// contiguous elements (8- or 16-byte loads, 256 contiguous bytes per warp at
// D=128 bf16; one 4-byte load a lane, 128 bytes a warp, for int8 pages), so
// every load is coalesced. An int8 row's scale is one fp32 that every lane
// of the warp reads from the same address (a broadcast). No tensor cores, TMA
// or shared-memory staging yet: this is the simple kernel that is right first.
//
// Numerics match the Pallas body: q is upcast to fp32 and scaled by 1/sqrt(D)
// before the dot (:123); int8 K and V are converted to fp32 (sign-extended)
// and multiplied by their (slot, head) scale, the K scale applied to the
// dot's sum and the V scale to the probability (the Pallas body scales each
// element first: the same products in another rounding order); masked scores
// are -1e30 (:72, :131); keys are visited only in pages whose start is below
// seq_len, so a query with no visible key averages those pages' V with weight
// exp(0) exactly as the Pallas loop does (int8 slots never written hold code 0
// and scale 0, and dequantize to 0); the normaliser is max(l, 1e-30) (:148),
// so a row of a seq_len-0 slot writes zeros. Tile boundaries differ from the
// Pallas page boundaries, which changes only the fp32 summation order.
#include <math_constants.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kMask = -1e30f;  // paged_attention.py:72 NEG_INF

// DV elements of a row starting at p (lane-contiguous layout) as fp32.
// `vec` (host-checked alignment and D == 32 * DV) selects vector loads.
template <typename T, int DV>
__device__ __forceinline__ void load_lane(const T* __restrict__ p, int d0,
                                          int D, bool vec, float (&o)[DV]) {
  constexpr int kBytes = DV * static_cast<int>(sizeof(T));
  if (vec) {
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int c = 0; c < kBytes / 16; ++c) {
        const uint4 raw = reinterpret_cast<const uint4*>(p + d0)[c];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < ptt::kVec16<T>; ++j)
          o[c * ptt::kVec16<T> + j] = ptt::to_f32(e[j]);
      }
      return;
    } else if constexpr (kBytes == 8) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p + d0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < DV; ++j) o[j] = ptt::to_f32(e[j]);
      return;
    } else if constexpr (kBytes == 4) {
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(p + d0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < DV; ++j) o[j] = ptt::to_f32(e[j]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < DV; ++j) o[j] = d0 + j < D ? ptt::to_f32(p[d0 + j]) : 0.f;
}

// T: q's and out's dtype; KT: the pages' (T, or int8_t with fp32 scales)
template <typename T, typename KT, int DV, int QB, int NW>
__global__ void __launch_bounds__(NW * 32)
    ragged_paged_attention_kernel(
        const T* __restrict__ q, const KT* __restrict__ k_pages,
        const KT* __restrict__ v_pages, const float* __restrict__ k_scales,
        const float* __restrict__ v_scales, const int* __restrict__ page_tables,
        const int* __restrict__ seq_lens, const int* __restrict__ q_lens,
        T* __restrict__ out, int Tq, int H, int D, int N, int ps, int P,
        float scale, bool vec_q, bool vec_kv) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  extern __shared__ float merge[];  // [NW][QB][2 + 32*DV]
  constexpr int kRow = 2 + 32 * DV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * QB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int HD = H * D;
  const int d0 = lane * DV;
  const int nq = min(QB, Tq - t0);
  const int seq_len = seq_lens[b];
  const int q_len = q_lens[b];
  const int qpos0 = seq_len - q_len + t0;  // position of the block's first query
  const int* __restrict__ pt = page_tables + static_cast<long long>(b) * P;

  // queries, upcast and pre-scaled in fp32 (paged_attention.py:123)
  float qr[QB][DV];
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    if (r < nq) {
      load_lane<T, DV>(q + (static_cast<long long>(b) * Tq + t0 + r) * HD + h * D,
                       d0, D, vec_q, qr[r]);
#pragma unroll
      for (int i = 0; i < DV; ++i) qr[r][i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < DV; ++i) qr[r][i] = 0.f;
    }
  }

  // the keys the Pallas grid visits: every page whose start is below
  // seq_len, up to the table width
  const int npages = seq_len > 0 ? min((seq_len + ps - 1) / ps, P) : 0;
  int nkeys = npages * ps;
  // causal trim: when every query of the block sees key 0 (position >= 0),
  // keys past the block's last position are masked for all of them and
  // weigh exp(-1e30 - m) == 0 exactly, so they need not be visited
  if (qpos0 >= 0) nkeys = min(nkeys, qpos0 + nq);

  float m[QB], l[QB], acc[QB][DV];
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    m[r] = kMask;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = warp * 32; k0 < nkeys; k0 += NW * 32) {
    const int kn = min(32, nkeys - k0);
    // scores: after this loop lane j holds the scores of key k0 + j;
    // lanes past the tile's end hold -inf (outside every visited page)
    float s[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) s[r] = -CUDART_INF_F;
    for (int j = 0; j < kn; ++j) {
      const int key = k0 + j;
      const int page = min(max(pt[key / ps], 0), N - 1);
      const long long slot = static_cast<long long>(page) * ps + key % ps;
      float kv[DV];
      load_lane<KT, DV>(k_pages + slot * HD + h * D, d0, D, vec_kv, kv);
      float ksc = 1.f;
      if constexpr (kQuant) ksc = k_scales[slot * H + h];  // paged_attention.py:127
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DV; ++i) part += qr[r][i] * kv[i];
        float full = ptt::warp_sum(part);
        if constexpr (kQuant) full *= ksc;
        if (lane == j) s[r] = full;
      }
    }
    // mask, then one online-softmax update per query for the whole tile
    const int key = k0 + lane;
    float p[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) {
      if (lane < kn) {
        const bool valid = key < seq_len && key <= qpos0 + r;
        if (!valid) s[r] = kMask;
      }
      const float m_new = fmaxf(m[r], ptt::warp_max(s[r]));
      p[r] = expf(s[r] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + ptt::warp_sum(p[r]);
#pragma unroll
      for (int i = 0; i < DV; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
    }
    for (int j = 0; j < kn; ++j) {
      const int kj = k0 + j;
      const int page = min(max(pt[kj / ps], 0), N - 1);
      const long long slot = static_cast<long long>(page) * ps + kj % ps;
      float vv[DV];
      load_lane<KT, DV>(v_pages + slot * HD + h * D, d0, D, vec_kv, vv);
      float vsc = 1.f;
      if constexpr (kQuant) vsc = v_scales[slot * H + h];  // paged_attention.py:128
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        float pj = __shfl_sync(0xffffffffu, p[r], j);
        if constexpr (kQuant) pj *= vsc;
#pragma unroll
        for (int i = 0; i < DV; ++i) acc[r][i] += pj * vv[i];
      }
    }
  }

  // merge the warps' partial states
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    float* e = merge + (warp * QB + r) * kRow;
    if (lane == 0) {
      e[0] = m[r];
      e[1] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DV; ++i) e[2 + d0 + i] = acc[r][i];
  }
  __syncthreads();
  for (int r = warp; r < nq; r += NW) {
    float mx = kMask;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, merge[(w * QB + r) * kRow]);
    float lsum = 0.f;
    float o[DV];
#pragma unroll
    for (int i = 0; i < DV; ++i) o[i] = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float* e = merge + (w * QB + r) * kRow;
      const float f = expf(e[0] - mx);
      lsum += f * e[1];
#pragma unroll
      for (int i = 0; i < DV; ++i) o[i] += f * e[2 + d0 + i];
    }
    const float inv_den = 1.0f / fmaxf(lsum, 1e-30f);  // paged_attention.py:148
    T* orow = out + (static_cast<long long>(b) * Tq + t0 + r) * HD + h * D;
#pragma unroll
    for (int i = 0; i < DV; ++i)
      if (d0 + i < D) orow[d0 + i] = ptt::from_f32<T>(o[i] * inv_den);
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *pt, *sl, *ql;
  void* out;
  int B, Tq, H, D, N, ps, P;
  float scale;
  bool vec_q, vec_kv;
  cudaStream_t stream;
};

template <typename T, typename KT, int DV, int QB, int NW>
int launch(const Args& a) {
  const dim3 grid((a.Tq + QB - 1) / QB, a.H, a.B);
  const size_t smem = sizeof(float) * NW * QB * (2 + 32 * DV);
  ragged_paged_attention_kernel<T, KT, DV, QB, NW>
      <<<grid, NW * 32, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KT*>(a.kp),
          static_cast<const KT*>(a.vp), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.pt),
          static_cast<const int*>(a.sl), static_cast<const int*>(a.ql),
          static_cast<T*>(a.out), a.Tq, a.H, a.D, a.N, a.ps, a.P, a.scale,
          a.vec_q, a.vec_kv);
  return static_cast<int>(cudaGetLastError());
}

// decode (one query a row) spreads the keys over 8 warps; wider query
// blocks use 4 warps and 8 queries a CTA
template <typename T, typename KT, int DV>
int launch_q(const Args& a) {
  if (a.Tq == 1) return launch<T, KT, DV, 1, 8>(a);
  return launch<T, KT, DV, 8, 4>(a);
}

bool aligned(const void* p, int align) {
  return (reinterpret_cast<uintptr_t>(p) % align) == 0;
}

// vector loads of DV elements of type E a lane: D must fill the 32 lanes
// exactly and every row start must sit on the load's alignment
template <typename E>
bool vector_ok(int D, int dv, const void* a, const void* b, const void* c) {
  const int vbytes = dv * static_cast<int>(sizeof(E));
  const int align = vbytes >= 16 ? 16 : vbytes;
  return D == 32 * dv && vbytes >= 4 && aligned(a, align) &&
         aligned(b, align) && aligned(c, align);
}

template <typename T, typename KT>
int run(Args a) {
  const int dv = a.D <= 32 ? 1 : a.D <= 64 ? 2 : a.D <= 128 ? 4 : 8;
  a.vec_q = vector_ok<T>(a.D, dv, a.q, a.q, a.out);
  a.vec_kv = vector_ok<KT>(a.D, dv, a.kp, a.vp, a.kp);
  switch (dv) {
    case 1:
      return launch_q<T, KT, 1>(a);
    case 2:
      return launch_q<T, KT, 2>(a);
    case 4:
      return launch_q<T, KT, 4>(a);
    default:
      return launch_q<T, KT, 8>(a);
  }
}

// refuses what no launch takes; sets the softmax scale
int checked(Args& a) {
  if (a.B <= 0 || a.Tq <= 0 || a.H <= 0 || a.D <= 0 || a.D > 256 ||
      a.N <= 0 || a.ps <= 0 || a.P <= 0 || a.H > 65535 || a.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 1/sqrt(D) rounded to fp32, as the Pallas body's Python float scale is
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(a.D)));
  return 0;
}

}  // namespace

extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* seq_lens, const void* q_lens,
    void* out, int B, int Tq, int H, int D, int N, int ps, int P, int dtype,
    int device, void* stream) {
  Args a{q, k_pages, v_pages, nullptr, nullptr, page_tables, seq_lens, q_lens,
         out, B, Tq, H, D, N, ps, P, 0.f, false, false,
         static_cast<cudaStream_t>(stream)};
  if (const int rc = checked(a)) return rc;
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  PTT_DISPATCH_DTYPE(dtype, T, { return run<T, T>(a); });
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 pages with fp32 scales [N, ps, H]; q and out in `dtype`
extern "C" int ptt_ragged_paged_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_tables,
    const void* seq_lens, const void* q_lens, void* out, int B, int Tq, int H,
    int D, int N, int ps, int P, int dtype, int device, void* stream) {
  if (k_scales == nullptr || v_scales == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k_pages, v_pages, k_scales, v_scales, page_tables, seq_lens,
         q_lens, out, B, Tq, H, D, N, ps, P, 0.f, false, false,
         static_cast<cudaStream_t>(stream)};
  if (const int rc = checked(a)) return rc;
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  PTT_DISPATCH_DTYPE(dtype, T, { return run<T, int8_t>(a); });
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
