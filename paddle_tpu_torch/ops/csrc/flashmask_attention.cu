// FlashMask attention for Hopper (sm_90a): the forward (output and f32
// log-sum-exp) and the FA2 backward (dK/dV, dQ) under a mask given as
// per-column row intervals.
//
// Replaces: paddle_tpu/ops/pallas/flashmask_attention.py `_fwd_kernel`,
// `_bwd_dkv_kernel` and `_bwd_dq_kernel` (launched by
// `flashmask_attention_forward` and `flashmask_attention_backward`, under
// the custom_vjp `flashmask_attention_fused`).  Same contract: column j
// masks the rows of its bands (1 interval column: [start, sq); 2:
// [start, end); 4: [s0, s1) and [s2, s3)); `causal` masks rows < cols,
// top-left, with no sk - sq offset; masked scores take the finite
// DEFAULT_MASK_VALUE and their probabilities are zeroed by the mask, not
// left to underflow (a row whose tiles so far are all masked has
// m = DEFAULT_MASK_VALUE, where exp(s - m) of a masked score is 1); a row
// that every column masks writes out 0 and lse DEFAULT_MASK_VALUE; the
// backward never takes exp(s - lse) where the mask drops the pair (a
// masked row's lse would make it inf, and inf * 0 NaN), sums dK/dV in f32
// over the GQA group before one cast and casts dQ to q's type.  Unlike
// the Pallas kernels these take GQA (kv head = q head / group, as the
// JAX package's dense path repeats K/V) and any number of mask heads
// that divides the q heads (mask head = q head / (heads / mask heads)).
//
// What bounds them on the H100: per (q, k) pair the mask keeps, the
// forward does 4d operations (q.k, p.v), the dK/dV pass 8d (s, dp, dv,
// dk) and the dQ pass 6d (s, dp, dq), against (sq + sk) * d elements
// per head moved and ncol ints per column, so all three are bound by
// operations, counted over the pairs the mask keeps.  This first version
// computes the products in f32 on the CUDA cores, not the tensor cores
// (moving them onto wgmma is later work), so it runs far below the bf16
// tensor-core peak.  What its design does about that:
//
// - Tile skip.  A (batch, mask head, q tile, kv tile) int32 table, made
//   beside the kernels by torch ops on the device at these kernels' own
//   64 x 64 tiles (`flashmask_skip_table`, the port of `_skip_table`),
//   marks the tiles that the mask covers whole and, under `causal`, the
//   tiles wholly above the diagonal.  A block reads one int of it and
//   skips the tile before loading K/V or Q/dO, so a banded mask
//   (documents, a sliding window) costs about its kept pairs, not
//   sq * sk.  The forward's 32-column kv tiles read the entry of the
//   64-column tile they lie in.
// - The mask of a tile that runs is built per element from its columns'
//   bands, staged once per tile in shared memory as (lo1, hi1, lo2, hi2):
//   two compares per band, no dense mask in memory.
// - The products as in the port's flash kernels: the forward keeps a
//   64-row query tile resident and streams 32-column K/V tiles, every
//   thread accumulating a 4x4 score tile and a 4x(d/8) output tile in
//   registers; dK/dV keeps a 64-row kv tile and its dK, dV sums resident
//   while it walks the q tiles of every q head of its GQA group (the
//   group summed in registers, no atomics); dQ keeps a 64-row q tile with
//   its dO, lse and delta and streams the kv tiles.  Shared rows are
//   padded by one float, so no warp's column read hits one bank twice.
// - q, k, v, dO, the output and the gradients are read and written
//   through (batch, head, seq) strides, so the (b, s, h, d) buffers of
//   the Paddle layout need no transposed copies.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// DEFAULT_MASK_VALUE of the JAX package: finite (-0.7 * f32 max)
constexpr float kMaskValue = -0.7f * 3.40282346638528859812e+38f;

constexpr int kTile = 64;        // q and kv tile of the skip table

// forward
constexpr int kFQ = 64;          // query rows per block
constexpr int kFK = 32;          // kv columns per tile
constexpr int kFThreads = 128;   // tx = tid % 8, ty = tid / 8
constexpr int kFR = 4;           // query rows per thread: ty * 4 + i
constexpr int kFC = kFK / 8;     // score columns per thread: tx + 8 * j

// backward
constexpr int kB = 64;           // rows of a q tile and of a kv tile
constexpr int kThreads = 256;    // tx = tid % 16, ty = tid / 16
constexpr int kR = 4;            // tile rows per thread: ty * 4 + i
constexpr int kC = kB / 16;      // tile columns per thread: tx + 16 * j
constexpr int kPP = kB + 1;      // padded row of a score tile

static_assert(kFQ == kTile && kB == kTile && kTile % kFK == 0,
              "the skip table's tiles are the kernels' tiles");

struct Dims {
  int heads, kv_heads, mask_heads, sq, sk, ncol;
};

struct Strides {
  // elements, (batch, head, seq) of q, k, v, then the forward's out or
  // the backward's dout, then dq (dQ) or dk and dv (dK/dV)
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
  int64_t gb, gh, gs, hb, hh, hs;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T from global memory into consecutive floats
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  constexpr int kN = 16 / sizeof(T);
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kN; ++i) dst[i] = to_float(e[i]);
}

// rows row0 .. row0 + ROWS of a (s, D) slab with row stride `stride` into
// shared floats [ROWS][D + 1]; rows at or past `valid` read as zeros
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(const T* base, int64_t stride,
                                          int row0, int valid, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  for (int i = threadIdx.x; i < ROWS * (D / VEC); i += THREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    const int row = row0 + r;
    float tmp[VEC];
    if (row < valid) {
      load16(base + row * stride + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * (D + 1) + c + e] = tmp[e];
  }
}

// column `col`'s masked rows as two bands [x, y) and [z, w), from its
// ncol intervals in the (sk, ncol) slab `se`; a column at or past sk
// masks nothing here (the kernels drop it by its index)
__device__ __forceinline__ int4 load_band(const int* se, int col,
                                          const Dims& dm) {
  if (col >= dm.sk) return make_int4(0, 0, 0, 0);
  const int* c = se + (int64_t)col * dm.ncol;
  if (dm.ncol == 1) return make_int4(__ldg(c), dm.sq, 0, 0);
  if (dm.ncol == 2) return make_int4(__ldg(c), __ldg(c + 1), 0, 0);
  return make_int4(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3));
}

// `_keep_mask` for one (row, col): in no band, and not above the
// top-left diagonal under causal
__device__ __forceinline__ bool kept(int row, int col, int4 bd, int causal) {
  return !((row >= bd.x && row < bd.y) || (row >= bd.z && row < bd.w)
           || (causal && row < col));
}

// acc[i][j] = sum_e a[ty*4+i][e] * b[tx+16j][e] over two [kB][D+1] tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int tx, int ty, float acc[kR][kC]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int e = 0; e < D; ++e) {
    float av[kR], bv[kC];
#pragma unroll
    for (int i = 0; i < kR; ++i) av[i] = a[(ty * kR + i) * DP + e];
#pragma unroll
    for (int j = 0; j < kC; ++j) bv[j] = b[(tx + 16 * j) * DP + e];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// ------------------------------------------------------------- forward
template <typename T, int D>
__global__ void __launch_bounds__(kFThreads)
flashmask_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ se,
                     const int* __restrict__ skip, Dims dm, Strides st,
                     float scale, int causal) {
  constexpr int DP = D + 1;      // padded shared row: conflict-free reads
  constexpr int DM = D / 8;      // output dims per thread: tx + 8 * m
  constexpr int PP = kFK + 1;
  extern __shared__ float smem[];
  float* qs = smem;              // [kFQ][DP]
  float* ks = qs + kFQ * DP;     // [kFK][DP]
  float* vs = ks + kFK * DP;     // [kFK][DP]
  float* ps = vs + kFK * DP;     // [kFQ][PP]
  __shared__ int4 bands[kFK];

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int q0 = blockIdx.x * kFQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (dm.heads / dm.kv_heads);
  const int mh = hq / (dm.heads / dm.mask_heads);
  const int n_q = (dm.sq + kTile - 1) / kTile;
  const int n_kv = (dm.sk + kTile - 1) / kTile;
  const int64_t bm = (int64_t)b * dm.mask_heads + mh;
  const int* skip_row = skip + (bm * n_q + blockIdx.x) * n_kv;
  const int* se_bm = se + bm * dm.sk * dm.ncol;

  const T* kb = k + b * st.kb + hk * st.kh;
  const T* vb = v + b * st.vb + hk * st.vh;
  load_tile<T, D, kFQ, kFThreads>(q + b * st.qb + hq * st.qh, st.qs, q0,
                                  dm.sq, qs);

  float m[kFR], l[kFR], acc[kFR][DM];
#pragma unroll
  for (int i = 0; i < kFR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DM; ++d) acc[i][d] = 0.f;
  }

  for (int k0 = 0; k0 < dm.sk; k0 += kFK) {
    if (skip_row[k0 / kTile]) continue;   // the same for every thread
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D, kFK, kFThreads>(kb, st.ks, k0, dm.sk, ks);
    load_tile<T, D, kFK, kFThreads>(vb, st.vs, k0, dm.sk, vs);
    if (tid < kFK) bands[tid] = load_band(se_bm, k0 + tid, dm);
    __syncthreads();

    float s[kFR][kFC];
#pragma unroll
    for (int i = 0; i < kFR; ++i)
#pragma unroll
      for (int j = 0; j < kFC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float qv[kFR], kv[kFC];
#pragma unroll
      for (int i = 0; i < kFR; ++i) qv[i] = qs[(ty * kFR + i) * DP + e];
#pragma unroll
      for (int j = 0; j < kFC; ++j) kv[j] = ks[(tx + 8 * j) * DP + e];
#pragma unroll
      for (int i = 0; i < kFR; ++i)
#pragma unroll
        for (int j = 0; j < kFC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    int4 bd[kFC];
#pragma unroll
    for (int j = 0; j < kFC; ++j) bd[j] = bands[tx + 8 * j];
#pragma unroll
    for (int i = 0; i < kFR; ++i) {
      const int row = q0 + ty * kFR + i;
      bool kp[kFC];
      float tmax = kMaskValue;
#pragma unroll
      for (int j = 0; j < kFC; ++j) {
        const int col = k0 + tx + 8 * j;
        kp[j] = col < dm.sk && kept(row, col, bd[j], causal);
        s[i][j] = kp[j] ? s[i][j] * scale : kMaskValue;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 8 threads of a row are neighbouring lanes of one warp
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kFC; ++j) {
        // zeroed by the mask: with m_new = DEFAULT_MASK_VALUE a masked
        // score would give exp(0) = 1
        const float p = kp[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        // p meets V in the working type, as the JAX kernel casts it
        ps[(ty * kFR + i) * PP + tx + 8 * j] = to_float(from_float<T>(p));
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DM; ++d) acc[i][d] *= alpha;
    }
    __syncwarp();   // a row's probabilities come from lanes of this warp

#pragma unroll 4
    for (int c = 0; c < kFK; ++c) {
      float pv[kFR];
#pragma unroll
      for (int i = 0; i < kFR; ++i) pv[i] = ps[(ty * kFR + i) * PP + c];
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        const float vv = vs[c * DP + tx + 8 * d];
#pragma unroll
        for (int i = 0; i < kFR; ++i) acc[i][d] = fmaf(pv[i], vv, acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kFR; ++i) {
    const int row = q0 + ty * kFR + i;
    if (row >= dm.sq) continue;
    // a fully masked row (l == 0) writes zeros and lse = -big, so the
    // backward's exp(s - lse) is never taken there
    const float ls = l[i] == 0.f ? 1.f : l[i];
    T* ob = o + b * st.ob + hq * st.oh + row * st.os;
#pragma unroll
    for (int d = 0; d < DM; ++d) ob[tx + 8 * d] = from_float<T>(acc[i][d] / ls);
    if (tx == 0)
      lse[((int64_t)b * dm.heads + hq) * dm.sq + row] =
          l[i] > 0.f ? m[i] + logf(ls) : kMaskValue;
  }
}

// ------------------------------------------------------------ backward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flashmask_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ se,
                         const int* __restrict__ skip, T* __restrict__ dk,
                         T* __restrict__ dv, Dims dm, Strides st, float scale,
                         int causal) {
  constexpr int DP = D + 1;
  constexpr int DM = D / 16;     // accumulator dims per thread: tx + 16 * m
  extern __shared__ float smem[];
  float* ks = smem;              // [kB][DP]
  float* vs = ks + kB * DP;      // [kB][DP]
  float* qs = vs + kB * DP;      // [kB][DP]
  float* dos = qs + kB * DP;     // [kB][DP]
  float* ps = dos + kB * DP;     // [kB][kPP]: p, then ds
  float* ls = ps + kB * kPP;     // [kB] lse of the q tile
  float* dls = ls + kB;          // [kB] delta of the q tile
  __shared__ int4 bands[kB];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int kt = blockIdx.x, k0 = kt * kB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = dm.heads / dm.kv_heads;
  const int per_mask = dm.heads / dm.mask_heads;
  const int n_q = (dm.sq + kB - 1) / kB;
  const int n_kv = (dm.sk + kB - 1) / kB;

  load_tile<T, D, kB, kThreads>(k + b * st.kb + hk * st.kh, st.ks, k0,
                                dm.sk, ks);
  load_tile<T, D, kB, kThreads>(v + b * st.vb + hk * st.vh, st.vs, k0,
                                dm.sk, vs);

  float dka[kR][DM], dva[kR][DM];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int m = 0; m < DM; ++m) dka[i][m] = dva[i][m] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int hq = hk * group + g;
    const int64_t bm = (int64_t)b * dm.mask_heads + hq / per_mask;
    const int* skip_col = skip + bm * n_q * n_kv + kt;
    const int* se_bm = se + bm * dm.sk * dm.ncol;
    const T* qb = q + b * st.qb + hq * st.qh;
    const T* ob = dout + b * st.ob + hq * st.oh;
    const float* lb = lse + ((int64_t)b * dm.heads + hq) * dm.sq;
    const float* db = delta + ((int64_t)b * dm.heads + hq) * dm.sq;
    for (int qt = 0; qt < n_q; ++qt) {
      if (skip_col[(int64_t)qt * n_kv]) continue;   // uniform
      const int q0 = qt * kB;
      __syncthreads();   // the previous tile's readers are done
      load_tile<T, D, kB, kThreads>(qb, st.qs, q0, dm.sq, qs);
      load_tile<T, D, kB, kThreads>(ob, st.os, q0, dm.sq, dos);
      if (tid < kB) {
        const int row = q0 + tid;
        ls[tid] = row < dm.sq ? lb[row] : 0.f;
        dls[tid] = row < dm.sq ? db[row] : 0.f;
        bands[tid] = load_band(se_bm, k0 + tid, dm);
      }
      __syncthreads();

      float p[kR][kC], dp[kR][kC];
      tile_dot<D>(qs, ks, tx, ty, p);
      int4 bd[kC];
#pragma unroll
      for (int j = 0; j < kC; ++j) bd[j] = bands[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int row = q0 + ty * kR + i;
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const int col = k0 + tx + 16 * j;
          const bool ok = row < dm.sq && col < dm.sk
                          && kept(row, col, bd[j], causal);
          p[i][j] = ok ? expf(p[i][j] * scale - ls[ty * kR + i]) : 0.f;
          ps[(ty * kR + i) * kPP + tx + 16 * j] = p[i][j];
        }
      }
      tile_dot<D>(dos, vs, tx, ty, dp);
      __syncthreads();   // p complete

      // dV += P^T dO: kv rows ty*4+i, dims tx+16m
#pragma unroll 4
      for (int r = 0; r < kB; ++r) {
        float pv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) pv[i] = ps[r * kPP + ty * kR + i];
#pragma unroll
        for (int m = 0; m < DM; ++m) {
          const float o = dos[r * DP + tx + 16 * m];
#pragma unroll
          for (int i = 0; i < kR; ++i) dva[i][m] = fmaf(pv[i], o, dva[i][m]);
        }
      }
      __syncthreads();   // p read; ds takes its place

#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j)
          ps[(ty * kR + i) * kPP + tx + 16 * j] =
              p[i][j] * (dp[i][j] - dls[ty * kR + i]) * scale;
      __syncthreads();

      // dK += dS^T Q
#pragma unroll 4
      for (int r = 0; r < kB; ++r) {
        float dsv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) dsv[i] = ps[r * kPP + ty * kR + i];
#pragma unroll
        for (int m = 0; m < DM; ++m) {
          const float qv = qs[r * DP + tx + 16 * m];
#pragma unroll
          for (int i = 0; i < kR; ++i) dka[i][m] = fmaf(dsv[i], qv, dka[i][m]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = k0 + ty * kR + i;
    if (row >= dm.sk) continue;
    T* kout = dk + b * st.gb + hk * st.gh + row * st.gs;
    T* vout = dv + b * st.hb + hk * st.hh + row * st.hs;
#pragma unroll
    for (int m = 0; m < DM; ++m) {
      kout[tx + 16 * m] = from_float<T>(dka[i][m]);
      vout[tx + 16 * m] = from_float<T>(dva[i][m]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flashmask_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ se,
                        const int* __restrict__ skip, T* __restrict__ dq,
                        Dims dm, Strides st, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DM = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [kB][DP]
  float* dos = qs + kB * DP;     // [kB][DP]
  float* ks = dos + kB * DP;     // [kB][DP]
  float* vs = ks + kB * DP;      // [kB][DP]
  float* ps = vs + kB * DP;      // [kB][kPP]: ds
  float* ls = ps + kB * kPP;
  float* dls = ls + kB;
  __shared__ int4 bands[kB];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qt = blockIdx.x, q0 = qt * kB;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (dm.heads / dm.kv_heads);
  const int n_q = (dm.sq + kB - 1) / kB;
  const int n_kv = (dm.sk + kB - 1) / kB;
  const int64_t bm = (int64_t)b * dm.mask_heads
                     + hq / (dm.heads / dm.mask_heads);
  const int* skip_row = skip + (bm * n_q + qt) * n_kv;
  const int* se_bm = se + bm * dm.sk * dm.ncol;

  load_tile<T, D, kB, kThreads>(q + b * st.qb + hq * st.qh, st.qs, q0,
                                dm.sq, qs);
  load_tile<T, D, kB, kThreads>(dout + b * st.ob + hq * st.oh, st.os, q0,
                                dm.sq, dos);
  if (tid < kB) {
    const int row = q0 + tid;
    const int64_t at = ((int64_t)b * dm.heads + hq) * dm.sq + row;
    ls[tid] = row < dm.sq ? lse[at] : 0.f;
    dls[tid] = row < dm.sq ? delta[at] : 0.f;
  }
  const T* kb = k + b * st.kb + hk * st.kh;
  const T* vb = v + b * st.vb + hk * st.vh;

  float dqa[kR][DM];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int m = 0; m < DM; ++m) dqa[i][m] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    if (skip_row[kt]) continue;   // the same for every thread
    const int k0 = kt * kB;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D, kB, kThreads>(kb, st.ks, k0, dm.sk, ks);
    load_tile<T, D, kB, kThreads>(vb, st.vs, k0, dm.sk, vs);
    if (tid < kB) bands[tid] = load_band(se_bm, k0 + tid, dm);
    __syncthreads();

    float p[kR][kC], dp[kR][kC];
    tile_dot<D>(qs, ks, tx, ty, p);
    tile_dot<D>(dos, vs, tx, ty, dp);
    int4 bd[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) bd[j] = bands[tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty * kR + i;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < dm.sq && col < dm.sk
                        && kept(row, col, bd[j], causal);
        const float pij = ok ? expf(p[i][j] * scale - ls[ty * kR + i]) : 0.f;
        ps[(ty * kR + i) * kPP + tx + 16 * j] =
            pij * (dp[i][j] - dls[ty * kR + i]) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K: q rows ty*4+i, dims tx+16m
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float dsv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) dsv[i] = ps[(ty * kR + i) * kPP + c];
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const float kv = ks[c * DP + tx + 16 * m];
#pragma unroll
        for (int i = 0; i < kR; ++i) dqa[i][m] = fmaf(dsv[i], kv, dqa[i][m]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
    if (row >= dm.sq) continue;
    T* out = dq + b * st.gb + hq * st.gh + row * st.gs;
#pragma unroll
    for (int m = 0; m < DM; ++m) out[tx + 16 * m] = from_float<T>(dqa[i][m]);
  }
}

// ------------------------------------------------------------- launches
Strides unpack(const int64_t* s, int n) {
  int64_t a[18] = {0};
  for (int i = 0; i < n; ++i) a[i] = s[i];
  return Strides{a[0],  a[1],  a[2],  a[3],  a[4],  a[5],
                 a[6],  a[7],  a[8],  a[9],  a[10], a[11],
                 a[12], a[13], a[14], a[15], a[16], a[17]};
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, const int* se, const int* skip, int batch,
                       Dims dm, const int64_t* st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int smem = ((kFQ + 2 * kFK) * (D + 1) + kFQ * (kFK + 1))
                       * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flashmask_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((dm.sq + kFQ - 1) / kFQ, dm.heads, batch);
  flashmask_fwd_kernel<T, D><<<grid, kFThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, se, skip, dm,
      unpack(st, 12), scale, causal);
  return cudaGetLastError();
}

template <int D>
constexpr int bwd_smem_bytes() {
  return (4 * kB * (D + 1) + kB * kPP + 2 * kB) * (int)sizeof(float);
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const int* se, const int* skip,
                       void* dk, void* dv, int batch, Dims dm,
                       const int64_t* st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flashmask_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((dm.sk + kB - 1) / kB, dm.kv_heads, batch);
  flashmask_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, se,
      skip, static_cast<T*>(dk), static_cast<T*>(dv), dm, unpack(st, 18),
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* se, const int* skip, void* dq, int batch,
                      Dims dm, const int64_t* st, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flashmask_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((dm.sq + kB - 1) / kB, dm.heads, batch);
  flashmask_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, se,
      skip, static_cast<T*>(dq), dm, unpack(st, 15), scale, causal);
  return cudaGetLastError();
}

}  // namespace

// one of the four (dtype, head_dim) instances, or cudaErrorInvalidValue
#define FLASHMASK_DISPATCH(LAUNCH, ...)                                  \
  if (dtype == 1 && head_dim == 128)                                     \
    return (int)LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);                 \
  if (dtype == 1 && head_dim == 64)                                      \
    return (int)LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);                  \
  if (dtype == 0 && head_dim == 128)                                     \
    return (int)LAUNCH<float, 128>(__VA_ARGS__);                         \
  if (dtype == 0 && head_dim == 64)                                      \
    return (int)LAUNCH<float, 64>(__VA_ARGS__);                          \
  return (int)cudaErrorInvalidValue

extern "C" {

// q, out, dout, dq (b, h, sq, d); k, v, dk, dv (b, kv_h, sk, d): any
// strides whose last dimension is contiguous, given in elements as
// [tensor] x [batch, head, seq] in the order of each function's
// tensor arguments (forward: q, k, v, o; dK/dV: q, k, v, dout, dk, dv;
// dQ: q, k, v, dout, dq).  lse and delta: contiguous (b, h, sq) f32.
// se: contiguous (b, hm, sk, ncol) int32; skip: contiguous (b, hm,
// ceil(sq / 64), ceil(sk / 64)) int32, 1 = skip the tile.  dtype 0 =
// f32, 1 = bf16.  Each returns cudaGetLastError() after its launch
// (0 = launched).
int flashmask_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const void* se, const void* skip, int batch,
                  int heads, int kv_heads, int mask_heads, int sq, int sk,
                  int head_dim, int ncol, const int64_t* strides, int causal,
                  float scale, int dtype, void* stream) {
  const Dims dm{heads, kv_heads, mask_heads, sq, sk, ncol};
  FLASHMASK_DISPATCH(launch_fwd, q, k, v, o, static_cast<float*>(lse),
                     static_cast<const int*>(se),
                     static_cast<const int*>(skip), batch, dm, strides,
                     causal, scale, static_cast<cudaStream_t>(stream));
}

int flashmask_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* se, const void* skip, void* dk, void* dv,
                      int batch, int heads, int kv_heads, int mask_heads,
                      int sq, int sk, int head_dim, int ncol,
                      const int64_t* strides, int causal, float scale,
                      int dtype, void* stream) {
  const Dims dm{heads, kv_heads, mask_heads, sq, sk, ncol};
  FLASHMASK_DISPATCH(launch_dkv, q, k, v, dout,
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<const int*>(se),
                     static_cast<const int*>(skip), dk, dv, batch, dm,
                     strides, causal, scale,
                     static_cast<cudaStream_t>(stream));
}

int flashmask_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* se, const void* skip, void* dq, int batch,
                     int heads, int kv_heads, int mask_heads, int sq, int sk,
                     int head_dim, int ncol, const int64_t* strides,
                     int causal, float scale, int dtype, void* stream) {
  const Dims dm{heads, kv_heads, mask_heads, sq, sk, ncol};
  FLASHMASK_DISPATCH(launch_dq, q, k, v, dout,
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<const int*>(se),
                     static_cast<const int*>(skip), dq, batch, dm, strides,
                     causal, scale, static_cast<cudaStream_t>(stream));
}

const char* flashmask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
