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
// and the per-row statistics from L2. Reaching the bytes rate takes ~20 KB in
// flight an SM (3.35 TB/s x ~0.8 us of latency / 132 SMs).
//
// Forward design: a row's two sums need all its columns, so a row belongs to
// a group of W warps of a CTA, and the card's width comes from rows in
// flight. The wrapper's `layer_norm_fwd_plan` picks W (warps a row: 1, 2, 4,
// 8) and K (16-byte vectors a lane): when the rows give every SM 4 CTAs (a
// train step), two vectors a lane over the fewest warps that hold the row
// (4 warps at n = 2048 in bf16); with fewer rows (a decode step's 8), one
// vector a lane over more warps, so each row finishes sooner; rows wider
// than 8 warps of two take 8 warps of up to 64 values a lane (n up to
// 16384). CTAs of 256 threads hold 8 / W groups and walk blocks of 8 / W
// rows, as many CTAs as stay resident (4 an SM at K = 2, 6 at K = 1) or one
// a block when there are fewer. Lane l of a row takes the vectors l + 32 W
// k (k < K), so neighbouring lanes read neighbouring 16 bytes. A CTA issues
// the loads of its next block before it reduces this one, so its loads
// stay in flight through its barriers and epilogue: one row a CTA that only
// loaded, reduced and stored left the memory idle while it reduced. The
// rows sit in registers as loaded and x is read from device memory once.
// The two sums (the mean, then Σ(x - mean)²: the Pallas body's two-pass
// variance) are xor-shuffle trees, with no shared memory or barrier at W =
// 1; at W > 1 the warp sums cross shared memory behind one barrier a sum.
// The epilogue comes from the registers, w and b from L1. Measured slower at
// the train step (PERF.md): 8 warps of one vector a lane (the barriers of
// twice the rows), a warp of 8 vectors a lane, 2 warps of 4, two blocks of
// loads ahead, and a per-thread cp.async ring three blocks ahead. Cast
// points follow fused_norm.py:53-58: normalise in fp32, cast to x's dtype,
// then `* w` and `+ b` each rounded in x's dtype. Rows wider than 16384
// keep the shared-memory body (one CTA of 256 threads a row, the row staged
// in shared memory as fp32; n up to ~58,000). A row that is not 16-byte
// aligned, or n not a multiple of the vector, takes the same partition
// element by element (ptt::load_vec). mean and rstd ([rows] fp32, the
// Pallas body's residuals) are written only when the caller passes their
// pointers: training does, serving does not and pays nothing for them.
// Summation order of the register body (tests/test_torch_reduce.py emulates
// it on the CPU): each lane sums each of its vectors pairwise
// (ptt::pairwise_sum; for the variance, the rounded squares of the rounded
// differences) and adds the vector sums in k order from 0, every add and
// multiply rounded (no FMA); a warp's 32 lane sums by the xor-shuffle tree
// (offsets 16, 8, 4, 2, 1); at W > 1 the row's W warp sums in warp order
// from 0. mean = Σx / n; var = Σ(x - mean)² / n; rstd = 1 / sqrt(var +
// eps), each rounded once.
//
// Backward design: the Pallas body sums dw and db over its SEQUENTIAL row grid
// in VMEM scratch; CTAs run in no order. A row's two sums span all its
// columns, so a CTA takes whole rows: the grid is one column tile x chunks
// of contiguous rows (the wrapper's `layer_norm_bwd_grid` picks them, about
// as many CTAs as fit on the card at once). Each thread owns 8 contiguous
// bf16 (4 fp32) columns a vector, moves them with one 16-byte load or store
// an array, keeps the row in registers between the two row sums and the dx
// epilogue (one read of each row), reduces Σdxhat and Σdxhat·xhat together
// as one float2 behind ONE barrier a row, and has the next four rows' x
// and dy in flight while it waits: each thread copies its own vectors into
// a ring of row buffers in shared memory with cp.async (64 KB an SM in
// flight at n = 2048 in bf16). Its dw and db sum in registers over the
// chunk's rows, in
// row order, and are stored once as row blockIdx.x of `part` [chunks, 2n];
// pass 2 (ptt::launch_column_sum, a second launch from the same entry
// point) sums those rows in chunk order: deterministic, no atomics. A row
// that is not 16-byte aligned, or n not a multiple of the vector, takes the
// same partition element by element (ptt::load_vec). Rows wider than the
// registers hold stream twice through the CTA (see layer_norm_bwd_kernel).
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

// A row's sum over its group of W warps: the xor-shuffle tree, then (W > 1)
// the warp sums in warp order through `red` [kWarps] behind one barrier.
// Each of a row's two sums has its own `red`; the next row's write of a slot
// comes after the barrier of the other sum, which every reader of the slot
// has passed, so no further barrier guards the reuse.
template <int W>
__device__ __forceinline__ float row_total(float v, float* red) {
  v = ptt::warp_sum(v);
  if constexpr (W == 1) {
    return v;
  } else {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = warp / W * W;
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < W; ++j) t = __fadd_rn(t, red[first + j]);
    return t;
  }
}

// CTAs resident an SM that the register body's launch bounds guarantee,
// by vectors a lane (two rows of them live in registers); the wrapper's
// plan launches no more CTAs than that times the SMs
template <int K>
constexpr int kFwdCtas = K == 1 ? 6 : (K == 2 ? 4 : (K == 4 ? 2 : 1));

// The register body: W warps a row, K vectors a lane (see the header). A CTA
// of kWarps / W groups walks the blocks of kWarps / W rows blockIdx.x,
// blockIdx.x + gridDim.x, ..., group g taking row g of each block, and
// issues the loads of its next block's rows before it reduces this one's.
// A row past the last runs the sums on zeros (every thread meets the
// barriers) and writes nothing. w and b are read at the epilogue (L1 and L2
// hits: every row reads them), so no registers hold them across the walk.
template <typename T, int W, int K>
__global__ void __launch_bounds__(kThreads, kFwdCtas<K>)
    layer_norm_fwd_warp_kernel(const T* __restrict__ x,
                               const T* __restrict__ w,
                               const T* __restrict__ b, T* __restrict__ y,
                               float* __restrict__ mean_out,
                               float* __restrict__ rstd_out, int rows, int n,
                               float eps, bool vec) {
  constexpr int V = ptt::kVec16<T>;
  constexpr int kLanes = 32 * W;
  constexpr int kGroups = kWarps / W;
  __shared__ float red[2][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = (warp % W) * 32 + (threadIdx.x & 31);
  const int group = warp / W;
  const int nv = (n + V - 1) / V;
  const long long blocks = (static_cast<long long>(rows) + kGroups - 1) /
                           kGroups;
  const float nf = static_cast<float>(n);

  auto load = [&](uint4 (&raw)[K], long long blk) {
    const long long r = blk * kGroups + group;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = lane + kLanes * k;
      raw[k] = r < rows && v < nv ? ptt::load_vec(x + r * n, v * V, n, vec)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 cur[K], nxt[K];
  load(cur, blockIdx.x);
  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    if (blk + gridDim.x < blocks) load(nxt, blk + gridDim.x);
    // Σx: zeros past the row add +0, which leaves the sum's bits alone
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float f[V];
      ptt::unpack(cur[k], f, T{});
      s = __fadd_rn(s, ptt::pairwise_sum(f));
    }
    const float mean = row_total<W>(s, red[0]) / nf;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c0 = (lane + kLanes * k) * V;
      float f[V], q[V];
      ptt::unpack(cur[k], f, T{});
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = c0 + j < n ? __fsub_rn(f[j], mean) : 0.f;
        q[j] = __fmul_rn(d, d);
      }
      ss = __fadd_rn(ss, ptt::pairwise_sum(q));
    }
    const float rstd = 1.0f / sqrtf(row_total<W>(ss, red[1]) / nf + eps);
    const long long r = blk * kGroups + group;
    if (r < rows) {
      if (lane == 0 && mean_out != nullptr) {
        mean_out[r] = mean;
        rstd_out[r] = rstd;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = lane + kLanes * k;
        if (v >= nv) continue;
        float f[V], wf[V], bf[V], o[V];
        ptt::unpack(cur[k], f, T{});
        ptt::unpack(ptt::load_vec(w, v * V, n, vec), wf, T{});
        ptt::unpack(ptt::load_vec(b, v * V, n, vec), bf, T{});
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xn = ptt::to_f32(
              ptt::from_f32<T>(__fmul_rn(__fsub_rn(f[j], mean), rstd)));
          const float t =
              ptt::to_f32(ptt::from_f32<T>(__fmul_rn(xn, wf[j])));
          o[j] = __fadd_rn(t, bf[j]);
        }
        ptt::store_vec(y + r * n, v * V, n, vec, ptt::pack(o, T{}));
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) cur[k] = nxt[k];
  }
}

// The shared-memory body, for rows wider than the register body takes: one
// CTA a row, the row staged in shared memory as fp32 (n floats)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd_smem_kernel(const T* __restrict__ x,
                               const T* __restrict__ w,
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// A thread owns the 16-byte vectors v = tid + 256 k of every row (8 bf16 or
// 4 fp32 columns each), k < K. Rows of up to 256 K vectors are held in
// registers (K = 1, 2, 4: n <= 2048 / 4096 / 8192 in bf16, half that in
// fp32); the launch bounds cap their registers (K = 1, the gpt_1p3b
// step's n = 2048 in bf16: 64) and ops/kernels/fused_norm.py
// `layer_norm_bwd_grid` launches as many CTAs as fit an SM (K = 1: 2). Wider rows take the streaming body (K = 0), which
// reads each row twice and sums dw and db in the CTA's own row of `part`
// (each slot owned by one thread): any n below 2^30, where the parent's
// shared-memory sums stopped at 227 KB / 8 B.
// Rows of the register body pass through a ring of kStages row buffers in
// shared memory, each thread copying its own 16-byte vectors of x and dy
// with cp.async and reading back only those: a thread waits for its own
// copies (cp.async.wait_group) and no barrier guards the ring. kStages - 1
// rows are in flight while a row is used: 32 KB a CTA at n = 2048 in
// bf16, 64 KB an SM at 2 CTAs. Two CTAs an SM with four rows ahead each
// measured 7 % faster than four with two ahead (one H100 at 700 W,
// tools/flash_bwd_ab.py --norm): half the partial rows to write and sum.
constexpr int kStages = 5;

// unlike flash_attention.cu's copy, ordered ("memory") against this
// thread's earlier reads of the slot it refills
__device__ __forceinline__ void cp_async16(uint4* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's vectors k of x and dy for row r into ring slot `slot`
// (stage [kStages][2][K][kThreads] uint4): cp.async when `vec`, else
// element by element through registers (the scalar path), zeros past n
template <typename T, int K>
__device__ __forceinline__ void stage_row(uint4* stage, int slot, const T* x,
                                          const T* dy, int r, int n,
                                          bool vec) {
  constexpr int V = ptt::kVec16<T>;
  const long long off = static_cast<long long>(r) * n;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c0 = (threadIdx.x + kThreads * k) * V;
    uint4* sx = stage + ((slot * 2) * K + k) * kThreads + threadIdx.x;
    uint4* sd = sx + K * kThreads;
    if (c0 >= n) continue;
    if (vec) {
      cp_async16(sx, x + off + c0);
      cp_async16(sd, dy + off + c0);
    } else {
      *sx = ptt::load_vec(x + off, c0, n, false);
      *sd = ptt::load_vec(dy + off, c0, n, false);
    }
  }
}

// Σ dxhat and Σ dxhat * xhat over the row, as one float2: warp sums, one
// barrier, then every thread adds the 8 warps' pairs in warp order itself.
// `red` alternates between two slots by row, so the next row's write never
// meets this row's reads and one barrier a row suffices.
__device__ __forceinline__ float2 row_sums(float s1, float s2,
                                           float2 (*red)[kWarps], int slot) {
  s1 = ptt::warp_sum(s1);
  s2 = ptt::warp_sum(s2);
  if ((threadIdx.x & 31) == 0) red[slot][threadIdx.x >> 5] = make_float2(s1, s2);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    t.x += red[slot][w].x;
    t.y += red[slot][w].y;
  }
  return t;
}

// Pass 1 over the rows [r0, r_end) of chunk blockIdx.x: dx for each row, and
// the chunk's dw and db as one row of `part` [chunks, 2n] (dw, then db).
// Register body (K > 0): one read of each row, through the ring; the next
// kStages - 1 rows are in flight while this row's sums cross the barrier;
// dw and db sum in registers in row order and are stored once. Streaming body (K = 0):
// the row is read for the sums and again (from L2) for dx.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, K == 1 ? 4 : (K == 2 ? 2 : 1))
    layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ dy,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd, T* __restrict__ dx,
                          float* __restrict__ part, int rows, int n,
                          int rows_per_chunk, bool vec) {
  constexpr int V = ptt::kVec16<T>;
  __shared__ float2 red[2][kWarps];
  const float nf = static_cast<float>(n);
  const int r0 = static_cast<int>(blockIdx.x) * rows_per_chunk;
  const int r_end = rows - r0 < rows_per_chunk ? rows : r0 + rows_per_chunk;
  float* out = part + static_cast<long long>(blockIdx.x) * 2 * n;
  if constexpr (K > 0) {
    extern __shared__ uint4 stage[];  // [kStages][2][K][kThreads]
    uint4 wv[K];  // packed: converted at each use, to spare registers
    float dw[K][V], db[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c0 = (threadIdx.x + kThreads * k) * V;
      wv[k] = c0 < n ? ptt::load_vec(w, c0, n, vec)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < V; ++j) dw[k][j] = db[k][j] = 0.f;
    }
    // one commit group a row, empty past the chunk, so that wait_group
    // counts rows
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (r0 + i < r_end) stage_row<T, K>(stage, i, x, dy, r0 + i, n, vec);
      cp_async_commit();
    }
    for (int r = r0, slot = 0; r < r_end; ++r) {
      const int ahead = r + kStages - 1;
      if (ahead < r_end)
        stage_row<T, K>(stage, (slot + kStages - 1) % kStages, x, dy, ahead,
                        n, vec);
      cp_async_commit();
      const float mu = mean[r], rs = rstd[r];
      cp_async_wait<kStages - 1>();  // row r's copies have landed
      const uint4* sx = stage + (slot * 2) * K * kThreads + threadIdx.x;
      const uint4* sd = sx + K * kThreads;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if ((threadIdx.x + kThreads * k) * V >= n) continue;
        float xf[V], g[V], wf[V];
        ptt::unpack(sx[k * kThreads], xf, T{});
        ptt::unpack(sd[k * kThreads], g, T{});
        ptt::unpack(wv[k], wf, T{});
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xhat = (xf[j] - mu) * rs;
          const float dxhat = g[j] * wf[j];
          s1 += dxhat;
          s2 += dxhat * xhat;
          dw[k][j] += g[j] * ptt::to_f32(ptt::from_f32<T>(xhat));
          db[k][j] += g[j];
        }
      }
      // jnp.mean divides the sum by n
      const float2 t = row_sums(s1, s2, red, r & 1);
      const float m1 = t.x / nf, m2 = t.y / nf;
      const long long off = static_cast<long long>(r) * n;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c0 = (threadIdx.x + kThreads * k) * V;
        if (c0 >= n) continue;
        float xf[V], g[V], wf[V], o[V];
        ptt::unpack(sx[k * kThreads], xf, T{});
        ptt::unpack(sd[k * kThreads], g, T{});
        ptt::unpack(wv[k], wf, T{});
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xhat = (xf[j] - mu) * rs;
          o[j] = rs * (g[j] * wf[j] - m1 - xhat * m2);
        }
        ptt::store_vec(dx + off, c0, n, vec, ptt::pack(o, T{}));
      }
      slot = slot + 1 == kStages ? 0 : slot + 1;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c0 = (threadIdx.x + kThreads * k) * V;
      if (c0 >= n) continue;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (c0 + j < n) {
          out[c0 + j] = dw[k][j];
          out[n + c0 + j] = db[k][j];
        }
      }
    }
  } else {
    // dw [n], then db [n] in this CTA's row of `part`: thread tid owns the
    // slots of its own vectors, so no two threads touch one slot and no
    // barrier guards them (they stay in L1/L2 between rows)
    const int nv = (n + V - 1) / V;
    for (int v = threadIdx.x; v < nv; v += kThreads) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (v * V + j < n) out[v * V + j] = out[n + v * V + j] = 0.f;
      }
    }
    for (int r = r0; r < r_end; ++r) {
      const long long off = static_cast<long long>(r) * n;
      const float mu = mean[r], rs = rstd[r];
      float s1 = 0.f, s2 = 0.f;
      for (int v = threadIdx.x; v < nv; v += kThreads) {
        float xf[V], g[V], wf[V];
        ptt::unpack(ptt::load_vec(x + off, v * V, n, vec), xf, T{});
        ptt::unpack(ptt::load_vec(dy + off, v * V, n, vec), g, T{});
        ptt::unpack(ptt::load_vec(w, v * V, n, vec), wf, T{});
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xhat = (xf[j] - mu) * rs;
          const float dxhat = g[j] * wf[j];
          s1 += dxhat;
          s2 += dxhat * xhat;
          if (v * V + j < n) {
            out[v * V + j] += g[j] * ptt::to_f32(ptt::from_f32<T>(xhat));
            out[n + v * V + j] += g[j];
          }
        }
      }
      const float2 t = row_sums(s1, s2, red, r & 1);
      const float m1 = t.x / nf, m2 = t.y / nf;
      for (int v = threadIdx.x; v < nv; v += kThreads) {
        float xf[V], g[V], wf[V], o[V];
        ptt::unpack(ptt::load_vec(x + off, v * V, n, vec), xf, T{});
        ptt::unpack(ptt::load_vec(dy + off, v * V, n, vec), g, T{});
        ptt::unpack(ptt::load_vec(w, v * V, n, vec), wf, T{});
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xhat = (xf[j] - mu) * rs;
          o[j] = rs * (g[j] * wf[j] - m1 - xhat * m2);
        }
        ptt::store_vec(dx + off, v * V, n, vec, ptt::pack(o, T{}));
      }
    }
  }
}

// Opts `kernel` in to `smem` bytes of dynamic shared memory where its
// static and dynamic bytes together pass the 48 KB a launch gets without
// the opt-in; refuses more than the 227 KB a CTA can have.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= 46 * 1024) return cudaSuccess;  // these kernels' static < 2 KB
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t total = smem + attr.sharedSizeBytes;
  if (total > 227 * 1024) return cudaErrorInvalidValue;
  if (total <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int W, int K>
int launch_fwd_warp(const void* x, const void* w, const void* b, void* y,
                    float* mean, float* rstd, int rows, int n, float eps,
                    int ctas, bool vec, cudaStream_t stream) {
  layer_norm_fwd_warp_kernel<T, W, K><<<ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), mean, rstd, rows, n, eps,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// K vectors a lane at W = 1, 2, 4, 8 warps a row
template <typename T, int K>
int launch_fwd_k(const void* x, const void* w, const void* b, void* y,
                 float* mean, float* rstd, int rows, int n, float eps,
                 int warps, int ctas, bool vec, cudaStream_t stream) {
  switch (warps) {
    case 1:
      return launch_fwd_warp<T, 1, K>(x, w, b, y, mean, rstd, rows, n, eps,
                                      ctas, vec, stream);
    case 2:
      return launch_fwd_warp<T, 2, K>(x, w, b, y, mean, rstd, rows, n, eps,
                                      ctas, vec, stream);
    case 4:
      return launch_fwd_warp<T, 4, K>(x, w, b, y, mean, rstd, rows, n, eps,
                                      ctas, vec, stream);
    case 8:
      return launch_fwd_warp<T, 8, K>(x, w, b, y, mean, rstd, rows, n, eps,
                                      ctas, vec, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// W warps a row, K vectors a lane and `ctas` CTAs, as the wrapper's
// layer_norm_fwd_plan chose them: K = 1 or 2 with W = 1, 2, 4, 8; K = 4, 8
// (and 16 in fp32: up to 64 values a lane) with W = 8. W = 0 is the
// shared-memory body. A plan whose lanes do not cover the row is refused.
template <typename T>
int launch_fwd(const void* x, const void* w, const void* b, void* y,
               float* mean, float* rstd, int rows, int n, float eps,
               int warps, int vecs, int ctas, cudaStream_t stream) {
  constexpr int V = ptt::kVec16<T>;
  const bool vec = n % V == 0 && ptt::aligned16(x) && ptt::aligned16(w) &&
                   ptt::aligned16(b) && ptt::aligned16(y);
  if (warps == 0) {
    const size_t smem = static_cast<size_t>(n) * sizeof(float);
    const cudaError_t err = allow_smem(layer_norm_fwd_smem_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    layer_norm_fwd_smem_kernel<T><<<rows, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(y), mean, rstd, n, eps,
        vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (ctas <= 0 || static_cast<long long>(vecs) * 32 * warps < (n + V - 1) / V)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vecs == 1)
    return launch_fwd_k<T, 1>(x, w, b, y, mean, rstd, rows, n, eps, warps,
                              ctas, vec, stream);
  if (vecs == 2)
    return launch_fwd_k<T, 2>(x, w, b, y, mean, rstd, rows, n, eps, warps,
                              ctas, vec, stream);
  if (warps != 8) return static_cast<int>(cudaErrorInvalidValue);
  switch (vecs) {
    case 4:
      return launch_fwd_warp<T, 8, 4>(x, w, b, y, mean, rstd, rows, n, eps,
                                      ctas, vec, stream);
    case 8:
      return launch_fwd_warp<T, 8, 8>(x, w, b, y, mean, rstd, rows, n, eps,
                                      ctas, vec, stream);
    case 16:  // fp32 only: 64 values a lane
      if constexpr (sizeof(T) == 4)
        return launch_fwd_warp<T, 8, 16>(x, w, b, y, mean, rstd, rows, n,
                                         eps, ctas, vec, stream);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int K>
int launch_bwd_k(const void* x, const void* w, const void* dy,
                 const float* mean, const float* rstd, void* dx, float* part,
                 int rows, int n, int chunks, int rows_per_chunk, bool vec,
                 cudaStream_t stream) {
  // the register body's ring of row buffers (the streaming body has none)
  const size_t smem =
      K > 0 ? static_cast<size_t>(kStages) * 2 * K * kThreads * sizeof(uint4)
            : 0;
  const cudaError_t err = allow_smem(layer_norm_bwd_kernel<T, K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_bwd_kernel<T, K><<<chunks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), mean, rstd, static_cast<T*>(dx), part, rows,
      n, rows_per_chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* dy,
               const float* mean, const float* rstd, void* dx, float* part,
               float* dw_db, int rows, int n, int chunks, int rows_per_chunk,
               cudaStream_t stream) {
  constexpr int V = ptt::kVec16<T>;
  const bool vec = n % V == 0 && ptt::aligned16(x) && ptt::aligned16(w) &&
                   ptt::aligned16(dy) && ptt::aligned16(dx);
  const int per_thread = ((n + V - 1) / V + kThreads - 1) / kThreads;
  int rc;
  if (per_thread <= 1)
    rc = launch_bwd_k<T, 1>(x, w, dy, mean, rstd, dx, part, rows, n, chunks,
                            rows_per_chunk, vec, stream);
  else if (per_thread <= 2)
    rc = launch_bwd_k<T, 2>(x, w, dy, mean, rstd, dx, part, rows, n, chunks,
                            rows_per_chunk, vec, stream);
  else if (per_thread <= 4)
    rc = launch_bwd_k<T, 4>(x, w, dy, mean, rstd, dx, part, rows, n, chunks,
                            rows_per_chunk, vec, stream);
  else
    rc = launch_bwd_k<T, 0>(x, w, dy, mean, rstd, dx, part, rows, n, chunks,
                            rows_per_chunk, vec, stream);
  if (rc) return rc;
  ptt::launch_column_sum(part, dw_db, chunks, 2 * n, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [rows, n] contiguous; w, b: [n]; all of one dtype. mean, rstd: [rows]
// fp32, or both null to skip them. warps, vecs, ctas: the wrapper's plan
// (warps a row, 16-byte vectors a lane, CTAs to launch; warps 0: the
// shared-memory body, one CTA a row).
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, void* mean, void* rstd, int rows,
                                  int n, float eps, int warps, int vecs,
                                  int ctas, int dtype, int device,
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
                                          eps, warps, vecs, ctas, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, dy, dx: [rows, n] contiguous, one dtype; w: [n] of that dtype; mean,
// rstd: [rows] fp32 from the forward. Rows are cut into `chunks` chunks of
// `rows_per_chunk` (the last may be shorter, none empty); part: [chunks,
// 2n] fp32 scratch; dw_db: [2n] fp32 out (dw, then db), every element
// written. n below 2^30 (2n partial columns indexed in 32 bits). Two
// launches: pass 1, then the column sum.
extern "C" int ptt_layer_norm_bwd(const void* x, const void* w, const void* dy,
                                  const void* mean, const void* rstd,
                                  void* dx, void* part, void* dw_db, int rows,
                                  int n, int chunks, int rows_per_chunk,
                                  int dtype, int device, void* stream) {
  if (rows <= 0 || n <= 0 || n >= (1 << 30) || chunks <= 0 ||
      rows_per_chunk <= 0 ||
      static_cast<long long>(chunks) * rows_per_chunk < rows ||
      static_cast<long long>(chunks - 1) * rows_per_chunk >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(
      dtype, T,
      return launch_bwd<T>(x, w, dy, static_cast<const float*>(mean),
                           static_cast<const float*>(rstd), dx,
                           static_cast<float*>(part),
                           static_cast<float*>(dw_db), rows, n, chunks,
                           rows_per_chunk, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
