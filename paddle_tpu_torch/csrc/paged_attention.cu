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
//   part         fp32 [B, T, H, S, D + 2]  the splits' partial states (m, l,
//                                     acc), scratch from the wrapper; unused
//                                     when S = 1
// Query t of row b sits at position seq_len - q_len + t and sees key k when
// k < seq_len and k <= its position.
//
// What bounds it on this card: bytes. A decode step reads every visible K/V row
// once (sum of context x H*D x 2 bytes x 2; with int8 pages H*D + 4*H bytes a
// row, about half) for ~4 operations per K/V element, far below the H100's
// ~295 bf16 operations per byte; chunked prefill reuses each K/V row for up
// to T queries and is still under the ridge at T=128. To come near the bytes
// bound the card needs tens of KB in flight on every SM, and the first design
// (one CTA per (row, head, query block), each key a dependent page-table read
// before its row load, a 5-step warp sum per key and query) had about one row
// in flight a warp: 13x its bound at decode.
//
// Design:
// (a) Split the context. A CTA takes (row b, head h, block of QB queries,
//     split s): the keys [s KS, (s + 1) KS) of the block's keys, KS = a whole
//     number of 64-key tiles chosen by the wrapper so that the grid holds
//     about eight CTAs an SM (decode at the serve's shapes: 7 splits of 64
//     keys, 896 CTAs where the first design had 128). A split leaves its
//     (m, l, acc) in fp32; ragged_paged_attention_merge_kernel, a second
//     small pass, merges a block's splits (exp(m_s - M) weights, in split
//     order) and writes the output. A block whose keys fit one split writes
//     its output itself, and the merge pass skips it.
// (b) Stream whole tiles. A CTA reads its split's page ids once (one load a
//     page, into shared memory), then copies each 64-key tile of K and V
//     rows (4 pages at page_size 16: 16 KB of K and 16 KB of V a head in bf16,
//     and the int8 pages' scales beside them) into shared memory with
//     cp.async, 16 bytes a thread, every load independent of the others;
//     tiles are double-buffered when a split has more than one, so the next
//     tile loads while this one is used. A staged row is padded by 16 bytes,
//     so the eight rows that eight lanes read at one column fall in eight
//     distinct 4-bank groups.
// (c) No warp-wide sum per key. Warp w takes keys 32 w .. 32 w + 31 of a
//     tile, lane j key j: the lane computes its key's QB scores over the
//     staged row (the queries, pre-scaled in fp32, are read from shared
//     memory as broadcasts), then each query pays one warp max and one warp
//     sum a tile for its online-softmax update; P·V reads the tile's V rows
//     (lane l holds D/32 contiguous elements of each) and the probabilities
//     from shared memory.
// (d) One body for both page types: int8 rows are staged as codes, the K
//     scale multiplies the dot's sum and the V scale the probability.
// Prefill (T > 1) runs the same body with QB = 8 queries a CTA.
//
// Numerics match the Pallas body: q is upcast to fp32 and scaled by 1/sqrt(D)
// before the dot (:123); int8 K and V are converted to fp32 (sign-extended)
// and multiplied by their (slot, head) scale, the K scale applied to the
// dot's sum and the V scale to the probability (the Pallas body scales each
// element first: the same products in another rounding order); masked scores
// are -1e30 (:72, :131); keys are visited only in pages whose start is below
// seq_len, so a query with no visible key averages those pages' V with weight
// exp(0) exactly as the Pallas loop does, in each split and then across the
// splits, whose maxima are all -1e30 (int8 slots never written hold code 0
// and scale 0, and dequantize to 0); the normaliser is max(l, 1e-30) (:148),
// so a row of a seq_len-0 slot writes zeros. When every query of a block
// sees key 0, keys past the block's last position are not visited: they
// would weigh exp(-1e30 - m) = 0 exactly, as would a split whose keys a
// query cannot see (weight exp(-1e30 - M) = 0 in the merge). Tile and split
// boundaries differ from the Pallas page boundaries, which changes only the
// fp32 summation order.
#include <algorithm>
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kMask = -1e30f;  // paged_attention.py:72 NEG_INF
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileKeys = 32 * kWarps;  // a tile: one key a lane
constexpr int kMergeWarps = 4;
// a split's tiles are double-buffered while two buffers fit in this much
constexpr int kDoubleBufferBytes = 100 * 1024;

// a staged K or V row: 32 DV elements of KT and 16 bytes of pad
template <typename KT, int DV>
__host__ __device__ constexpr int row_bytes() {
  return 32 * DV * static_cast<int>(sizeof(KT)) + 16;
}
// one tile buffer: K rows, V rows, and the int8 pages' K and V scales
template <typename KT, int DV>
__host__ __device__ constexpr int tile_bytes() {
  return 2 * kTileKeys * row_bytes<KT, DV>() +
         (std::is_same<KT, int8_t>::value ? 2 * kTileKeys * 4 : 0);
}

// The keys a block of queries visits: every page whose start is below
// seq_len, up to the table width; when every query of the block sees key 0
// (position >= 0), only up to the block's last position (causal trim).
__device__ __forceinline__ int block_keys(int seq_len, int qpos0, int nq,
                                          int ps, int P) {
  const int npages = seq_len > 0 ? min((seq_len + ps - 1) / ps, P) : 0;
  int nkeys = npages * ps;
  if (qpos0 >= 0) nkeys = min(nkeys, qpos0 + nq);
  return nkeys;
}

// DV elements of type KT at `row` + DV * lane elements (shared memory,
// aligned to the load) as fp32
template <typename KT, int DV>
__device__ __forceinline__ void load_smem(const unsigned char* row, int lane,
                                          float (&o)[DV]) {
  constexpr int kBytes = DV * static_cast<int>(sizeof(KT));
  const unsigned char* p = row + lane * kBytes;
  if constexpr (kBytes >= 16) {
    constexpr int kE = 16 / static_cast<int>(sizeof(KT));
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
      for (int j = 0; j < kE; ++j) o[c * kE + j] = ptt::to_f32(e[j]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
    for (int j = 0; j < DV; ++j) o[j] = ptt::to_f32(e[j]);
  } else if constexpr (kBytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
    for (int j = 0; j < DV; ++j) o[j] = ptt::to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < DV; ++j)
      o[j] = ptt::to_f32(reinterpret_cast<const KT*>(p)[j]);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared, zero-filled (no global read) when !valid
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

// T: q's and out's dtype; KT: the pages' (T, or int8_t with fp32 scales);
// DV: elements of a row a lane holds (D <= 32 DV); QB: queries a CTA.
template <typename T, typename KT, int DV, int QB>
__global__ void __launch_bounds__(kThreads)
    ragged_paged_attention_kernel(
        const T* __restrict__ q, const KT* __restrict__ k_pages,
        const KT* __restrict__ v_pages, const float* __restrict__ k_scales,
        const float* __restrict__ v_scales, const int* __restrict__ page_tables,
        const int* __restrict__ seq_lens, const int* __restrict__ q_lens,
        T* __restrict__ out, float* __restrict__ part, int Tq, int H, int D,
        int N, int ps, int P, int S, int KS, int nbuf, float scale,
        bool vec_kv) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kDP = 32 * DV;                // a staged row's elements
  constexpr int kRB = row_bytes<KT, DV>();
  constexpr int kTB = tile_bytes<KT, DV>();
  constexpr int kE = 16 / static_cast<int>(sizeof(KT));  // elements a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.x % S;
  const int t0 = (blockIdx.x / S) * QB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int HD = H * D;
  const int nq = min(QB, Tq - t0);
  const int seq_len = seq_lens[b];
  const int qpos0 = seq_len - q_lens[b] + t0;  // the block's first position
  const int nkeys = block_keys(seq_len, qpos0, nq, ps, P);
  const int ns = (nkeys + KS - 1) / KS;        // splits that hold keys
  T* __restrict__ out0 =
      out + (static_cast<long long>(b) * Tq + t0) * HD + h * D;
  if (ns == 0) {  // no page visited (seq_len 0): the normaliser gives zeros
    if (split == 0)
      for (int i = threadIdx.x; i < nq * D; i += kThreads)
        out0[static_cast<long long>(i / D) * HD + i % D] = ptt::from_f32<T>(0.f);
    return;
  }
  if (split >= ns) return;
  const int kbeg = split * KS;
  const int kend = min(kbeg + KS, nkeys);
  const int first_page = kbeg / ps;
  const int npg = (kend - 1) / ps - first_page + 1;

  // shared memory: nbuf tiles (later the warps' merge area), the queries,
  // each warp's probabilities, the split's page ids
  float* q_s = reinterpret_cast<float*>(smem + nbuf * kTB);   // [QB][kDP]
  float* p_s = q_s + QB * kDP;                        // [kWarps][32][QB]
  int* pid_s = reinterpret_cast<int*>(p_s + kWarps * 32 * QB);
  const int* __restrict__ pt = page_tables + static_cast<long long>(b) * P;
  for (int i = threadIdx.x; i < npg; i += kThreads)
    pid_s[i] = min(max(pt[first_page + i], 0), N - 1);
  // queries, upcast and pre-scaled in fp32 (paged_attention.py:123); zeros
  // past D and past the block's last query
  for (int i = threadIdx.x; i < QB * kDP; i += kThreads) {
    const int r = i / kDP, d = i % kDP;
    q_s[i] = r < nq && d < D
                 ? ptt::to_f32(q[(static_cast<long long>(b) * Tq + t0 + r) *
                                     HD + h * D + d]) * scale
                 : 0.f;
  }
  __syncthreads();

  // a row of a tile is key k0 + r; keys from kend on are zero-filled
  const int nchunks = (D * static_cast<int>(sizeof(KT)) + 15) / 16;
  auto stage = [&](int k0, int buf) {
    unsigned char* ks_t = smem + buf * kTB;
    unsigned char* vs_t = ks_t + kTileKeys * kRB;
    if (vec_kv) {
      for (int i = threadIdx.x; i < kTileKeys * nchunks; i += kThreads) {
        const int r = i / nchunks, c = i % nchunks;
        const int key = k0 + r;
        const bool valid = key < kend;
        const long long slot =
            valid ? static_cast<long long>(pid_s[key / ps - first_page]) *
                            ps + key % ps
                  : 0;
        const long long off = slot * HD + h * D;
        cp_async16(ks_t + r * kRB + c * 16,
                   reinterpret_cast<const unsigned char*>(k_pages + off) +
                       c * 16, valid);
        cp_async16(vs_t + r * kRB + c * 16,
                   reinterpret_cast<const unsigned char*>(v_pages + off) +
                       c * 16, valid);
      }
    } else {  // rows not 16-byte aligned: one element a load, zeros past D
      const int width = nchunks * kE;
      for (int i = threadIdx.x; i < kTileKeys * width; i += kThreads) {
        const int r = i / width, e = i % width;
        const int key = k0 + r;
        const bool valid = key < kend && e < D;
        const long long slot =
            key < kend ? static_cast<long long>(
                             pid_s[key / ps - first_page]) * ps + key % ps
                       : 0;
        const long long off = slot * HD + h * D + e;
        reinterpret_cast<KT*>(ks_t + r * kRB)[e] = valid ? k_pages[off] : KT{};
        reinterpret_cast<KT*>(vs_t + r * kRB)[e] = valid ? v_pages[off] : KT{};
      }
    }
    if constexpr (kQuant) {
      float* ksc_t = reinterpret_cast<float*>(vs_t + kTileKeys * kRB);
      for (int r = threadIdx.x; r < kTileKeys; r += kThreads) {
        const int key = k0 + r;
        const bool valid = key < kend;
        const long long at =
            valid ? (static_cast<long long>(pid_s[key / ps - first_page]) *
                         ps + key % ps) * H + h
                  : 0;
        cp_async4(ksc_t + r, k_scales + at, valid);
        cp_async4(ksc_t + kTileKeys + r, v_scales + at, valid);
      }
    }
  };

  float m[QB], l[QB], acc[QB][DV];
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    m[r] = kMask;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[r][i] = 0.f;
  }

  const int ntiles = (kend - kbeg + kTileKeys - 1) / kTileKeys;
  stage(kbeg, 0);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = nbuf == 2 ? tile & 1 : 0;
    const int k0 = kbeg + tile * kTileKeys;
    if (nbuf == 2 && tile + 1 < ntiles) {
      stage(k0 + kTileKeys, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* ks_t = smem + buf * kTB;
    const unsigned char* vs_t = ks_t + kTileKeys * kRB;
    const float* ksc_t = reinterpret_cast<const float*>(vs_t + kTileKeys * kRB);
    const int row = warp * 32 + lane;  // this lane's key in the tile
    const int key = k0 + row;

    // scores of this lane's key for every query of the block
    float s[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) s[r] = 0.f;
    const unsigned char* krow = ks_t + row * kRB;
#pragma unroll 4
    for (int c = 0; c < nchunks; ++c) {
      float kf[kE];
      {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 16);
        const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
        for (int j = 0; j < kE; ++j) kf[j] = ptt::to_f32(e[j]);
      }
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + r * kDP +
                                                           c * kE);
#pragma unroll
        for (int j = 0; j < kE / 4; ++j) {
          const float4 qq = qv[j];
          s[r] = fmaf(qq.x, kf[4 * j], s[r]);
          s[r] = fmaf(qq.y, kf[4 * j + 1], s[r]);
          s[r] = fmaf(qq.z, kf[4 * j + 2], s[r]);
          s[r] = fmaf(qq.w, kf[4 * j + 3], s[r]);
        }
      }
    }
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = ksc_t[row];               // paged_attention.py:127
      vsc = ksc_t[kTileKeys + row];   // paged_attention.py:128
    }
    // mask, then one online-softmax update per query for the warp's keys:
    // keys past the split weigh exactly 0, masked keys -1e30
    float* pw = p_s + warp * 32 * QB;
#pragma unroll
    for (int r = 0; r < QB; ++r) {
      if (key >= kend)
        s[r] = -INFINITY;
      else if (key < seq_len && key <= qpos0 + r)
        s[r] *= ksc;
      else
        s[r] = kMask;
      const float m_new = fmaxf(m[r], ptt::warp_max(s[r]));
      const float p = expf(s[r] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + ptt::warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DV; ++i) acc[r][i] *= alpha;
      pw[lane * QB + r] = p * vsc;
    }
    __syncwarp();
    // P·V over the warp's keys: lane l holds elements DV l .. DV l + DV - 1
    const int kn = min(32, kend - (k0 + warp * 32));
#pragma unroll 4
    for (int j = 0; j < kn; ++j) {
      float vv[DV];
      load_smem<KT, DV>(vs_t + (warp * 32 + j) * kRB, lane, vv);
      float pj[QB];
      if constexpr (QB % 4 == 0) {
#pragma unroll
        for (int r = 0; r < QB; r += 4)
          *reinterpret_cast<float4*>(pj + r) =
              *reinterpret_cast<const float4*>(pw + j * QB + r);
      } else {
#pragma unroll
        for (int r = 0; r < QB; ++r) pj[r] = pw[j * QB + r];
      }
#pragma unroll
      for (int r = 0; r < QB; ++r)
#pragma unroll
        for (int i = 0; i < DV; ++i) acc[r][i] = fmaf(pj[r], vv[i], acc[r][i]);
    }
    __syncthreads();  // the tile and the probabilities are free again
    if (nbuf == 1 && tile + 1 < ntiles) {
      stage(k0 + kTileKeys, 0);
      cp_async_commit();
    }
  }

  // merge the warps' states (in the tiles' room), then write the block's
  // output, or this split's partial state
  constexpr int kME = 2 + kDP;
  float* mg = reinterpret_cast<float*>(smem);  // [kWarps][QB][kME]
  const int d0 = lane * DV;
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    float* e = mg + (warp * QB + r) * kME;
    if (lane == 0) {
      e[0] = m[r];
      e[1] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DV; ++i) e[2 + d0 + i] = acc[r][i];
  }
  __syncthreads();
  for (int r = warp; r < nq; r += kWarps) {
    float mx = kMask;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mg[(w * QB + r) * kME]);
    float lsum = 0.f;
    float o[DV];
#pragma unroll
    for (int i = 0; i < DV; ++i) o[i] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* e = mg + (w * QB + r) * kME;
      const float f = expf(e[0] - mx);
      lsum += f * e[1];
#pragma unroll
      for (int i = 0; i < DV; ++i) o[i] += f * e[2 + d0 + i];
    }
    if (ns == 1) {
      const float inv_den = 1.0f / fmaxf(lsum, 1e-30f);  // paged_attention.py:148
      T* orow = out0 + static_cast<long long>(r) * HD;
#pragma unroll
      for (int i = 0; i < DV; ++i)
        if (d0 + i < D) orow[d0 + i] = ptt::from_f32<T>(o[i] * inv_den);
    } else {
      float* pr = part + ((((static_cast<long long>(b) * Tq + t0 + r) * H + h) *
                               S + split) * (D + 2));
      if (lane == 0) {
        pr[0] = mx;
        pr[1] = lsum;
      }
#pragma unroll
      for (int i = 0; i < DV; ++i)
        if (d0 + i < D) pr[2 + d0 + i] = o[i];
    }
  }
}

// The second pass: one warp per (row, query, head) whose block has two or
// more splits merges their states: the lanes take the splits' maxima and
// normalisers (lane j splits j, j + 32, ...), the weights exp(m_s - M) go
// to shared memory, then each lane sums its elements of acc over the splits
// in split order. KT only names the instantiation (a profile tells the int8
// pool's pass from the dense one's).
template <typename T, typename KT>
__global__ void __launch_bounds__(32 * kMergeWarps)
    ragged_paged_attention_merge_kernel(const float* __restrict__ part,
                                        const int* __restrict__ seq_lens,
                                        const int* __restrict__ q_lens,
                                        T* __restrict__ out, int B, int Tq,
                                        int H, int D, int ps, int P, int QB,
                                        int S, int KS) {
  extern __shared__ float weights[];  // [kMergeWarps][S]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long item =
      static_cast<long long>(blockIdx.x) * kMergeWarps + warp;
  if (item >= static_cast<long long>(B) * Tq * H) return;
  const int h = static_cast<int>(item % H);
  const int t = static_cast<int>((item / H) % Tq);
  const int b = static_cast<int>(item / (static_cast<long long>(H) * Tq));
  const int t0 = t / QB * QB;
  const int seq_len = seq_lens[b];
  const int nkeys = block_keys(seq_len, seq_len - q_lens[b] + t0,
                               min(QB, Tq - t0), ps, P);
  const int ns = (nkeys + KS - 1) / KS;
  if (ns <= 1) return;  // written by the split pass
  const int stride = D + 2;
  const float* pr = part + item * S * stride;
  float* f = weights + warp * S;
  float mx = kMask;
  for (int s = lane; s < ns; s += 32) mx = fmaxf(mx, pr[s * stride]);
  mx = ptt::warp_max(mx);
  float lsum = 0.f;
  for (int s = lane; s < ns; s += 32) {
    f[s] = expf(pr[s * stride] - mx);
    lsum += f[s] * pr[s * stride + 1];
  }
  lsum = ptt::warp_sum(lsum);
  __syncwarp();
  const float inv_den = 1.0f / fmaxf(lsum, 1e-30f);  // paged_attention.py:148
  T* orow = out + (static_cast<long long>(b) * Tq + t) * H * D + h * D;
  for (int d = lane; d < D; d += 32) {
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) o += f[s] * pr[s * stride + 2 + d];
    orow[d] = ptt::from_f32<T>(o * inv_den);
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *pt, *sl, *ql;
  void *out, *part;
  int B, Tq, H, D, N, ps, P, qb, splits, tiles_per_split;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KT, int DV, int QB>
int launch(const Args& a) {
  constexpr int kDP = 32 * DV;
  const int KS = a.tiles_per_split * kTileKeys;
  const int nbuf =
      a.tiles_per_split > 1 && 2 * tile_bytes<KT, DV>() <= kDoubleBufferBytes
          ? 2
          : 1;
  // the tiles, queries, probabilities and page ids; after the key loop
  // the warps' merge area overlays them from the start
  const size_t smem = std::max<size_t>(
      static_cast<size_t>(nbuf) * tile_bytes<KT, DV>() +
          sizeof(float) * (QB * kDP + kWarps * 32 * QB) +
          sizeof(int) * (KS / a.ps + 2),
      sizeof(float) * kWarps * QB * (2 + kDP));
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = &ragged_paged_attention_kernel<T, KT, DV, QB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec_kv = a.D * static_cast<int>(sizeof(KT)) % 16 == 0 &&
                      ptt::aligned16(a.kp) && ptt::aligned16(a.vp);
  const int nqb = (a.Tq + QB - 1) / QB;
  const dim3 grid(nqb * a.splits, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.kp),
      static_cast<const KT*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pt),
      static_cast<const int*>(a.sl), static_cast<const int*>(a.ql),
      static_cast<T*>(a.out), static_cast<float*>(a.part), a.Tq, a.H, a.D,
      a.N, a.ps, a.P, a.splits, KS, nbuf, a.scale, vec_kv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const long long items = static_cast<long long>(a.B) * a.Tq * a.H;
  ragged_paged_attention_merge_kernel<T, KT>
      <<<static_cast<unsigned>((items + kMergeWarps - 1) / kMergeWarps),
         32 * kMergeWarps, sizeof(float) * kMergeWarps * a.splits,
         a.stream>>>(
          static_cast<const float*>(a.part), static_cast<const int*>(a.sl),
          static_cast<const int*>(a.ql), static_cast<T*>(a.out), a.B, a.Tq,
          a.H, a.D, a.ps, a.P, QB, a.splits, KS);
  return static_cast<int>(cudaGetLastError());
}

// decode (one query a row) takes one query a CTA, wider blocks 8
template <typename T, typename KT, int DV>
int launch_q(const Args& a) {
  if (a.qb == 1) return launch<T, KT, DV, 1>(a);
  return launch<T, KT, DV, 8>(a);
}

template <typename T, typename KT>
int run(const Args& a) {
  const int dv = a.D <= 32 ? 1 : a.D <= 64 ? 2 : a.D <= 128 ? 4 : 8;
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
      a.N <= 0 || a.ps <= 0 || a.P <= 0 || a.H > 65535 || a.B > 65535 ||
      (a.qb != 1 && a.qb != 8) || a.splits <= 0 || a.tiles_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the splits must cover the longest row's keys, a grid's x extent must
  // hold them, and the merge pass's weights fit in 48 KB of shared memory
  const long long nqb = (a.Tq + a.qb - 1) / a.qb;
  if (static_cast<long long>(a.splits) * a.tiles_per_split * kTileKeys <
          static_cast<long long>(a.P) * a.ps ||
      nqb * a.splits > 0x7fffffffLL ||
      a.splits * kMergeWarps * 4 > 48 * 1024 ||
      (a.splits > 1 && a.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // 1/sqrt(D) rounded to fp32, as the Pallas body's Python float scale is
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(a.D)));
  return 0;
}

}  // namespace

// part: fp32 scratch of B*T*H*splits*(D + 2) floats (null when splits = 1);
// qb: queries a CTA (1 or 8); splits x tiles_per_split x 64 keys must cover
// pages_per_seq x page_size.
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* seq_lens, const void* q_lens,
    void* out, void* part, int B, int Tq, int H, int D, int N, int ps, int P,
    int qb, int splits, int tiles_per_split, int dtype, int device,
    void* stream) {
  Args a{q,     k_pages, v_pages, nullptr, nullptr, page_tables,
         seq_lens, q_lens, out,   part,    B,       Tq,
         H,     D,       N,       ps,      P,       qb,
         splits, tiles_per_split, 0.f, static_cast<cudaStream_t>(stream)};
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
    const void* seq_lens, const void* q_lens, void* out, void* part, int B,
    int Tq, int H, int D, int N, int ps, int P, int qb, int splits,
    int tiles_per_split, int dtype, int device, void* stream) {
  if (k_scales == nullptr || v_scales == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,     k_pages, v_pages, k_scales, v_scales, page_tables,
         seq_lens, q_lens, out,   part,     B,        Tq,
         H,     D,       N,       ps,       P,        qb,
         splits, tiles_per_split, 0.f, static_cast<cudaStream_t>(stream)};
  if (const int rc = checked(a)) return rc;
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  PTT_DISPATCH_DTYPE(dtype, T, { return run<T, int8_t>(a); });
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
