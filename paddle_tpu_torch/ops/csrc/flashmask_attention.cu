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
// operations, counted over the pairs the mask keeps, and only the
// tensor cores come near that bound.  Every bf16 call runs on them:
// `flashmask_fwd_wgmma_kernel`, `flashmask_bwd_dkv_wgmma_kernel` and
// `flashmask_bwd_dq_wgmma_kernel` (below the CUDA-core kernels: the
// flash kernels' wgmma designs with the tile skip and the interval
// mask).  They round P (forward: as the JAX kernel casts it before it
// meets V; dK/dV) and dS (dK/dV, dQ) to bf16 before those products; the
// JAX backward kernels take them in f32.  Every f32 call runs the
// CUDA-core kernels (`flashmask_fwd_kernel`, `flashmask_bwd_dkv_kernel`,
// `flashmask_bwd_dq_kernel`): wgmma has no f32 product, and TF32 would
// not hold the f32 limit.  What the design does about the bound:
//
// - Tile skip.  A (batch, mask head, q tile, kv tile) int32 table, made
//   beside the kernels by torch ops on the device at these kernels' own
//   64 x 64 tiles (`flashmask_skip_table`, the port of `_skip_table`),
//   marks the tiles that the mask covers whole and, under `causal`, the
//   tiles wholly above the diagonal.  A block skips such a tile before
//   loading its operands, so a banded mask (documents, a sliding window)
//   costs about its kept pairs, not sq * sk: the wgmma kernels list the
//   tiles that run before their ring starts; the CUDA-core kernels read
//   one int per tile (the forward's 32-column kv tiles the entry of the
//   64-column tile they lie in).
// - The mask of a tile that runs is built from its columns' bands, no
//   dense mask in memory: the wgmma kernels as one 64-bit keep word per
//   kv column over the tile's 64 q rows; the CUDA-core kernels per
//   element, from bands staged in shared memory as (lo1, hi1, lo2, hi2).
// - The CUDA-core products as in the port's f32 flash kernels: the
//   forward keeps a 64-row query tile resident and streams 32-column K/V
//   tiles, every thread accumulating a 4x4 score tile and a 4x(d/8)
//   output tile in registers; dK/dV keeps a 64-row kv tile and its dK, dV
//   sums resident while it walks the q tiles of every q head of its GQA
//   group (the group summed in registers, no atomics); dQ keeps a 64-row
//   q tile with its dO, lse and delta and streams the kv tiles.  Shared
//   rows are padded by one float, so no warp's column read hits one bank
//   twice.
// - q, k, v, dO, the output and the gradients are read and written
//   through (batch, head, seq) strides, so the (b, s, h, d) buffers of
//   the Paddle layout need no transposed copies.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_wgmma.cuh"
#include "hopper_wgmma.cuh"

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
constexpr int kB = hopper::kAttnRows;   // q and kv tile rows
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

// the CUDA-core kernels run f32 only (bf16 takes the wgmma kernels)
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
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

// ---------------------------------------------------------- bf16, wgmma
// The tensor-core kernels: one warpgroup (128 threads) a block, 64-row
// q and kv tiles in the 128-byte-swizzled layout of hopper_wgmma.cuh,
// streamed through a cp.async ring, with FlashMask's tile skip and mask:
// - before the ring starts, the block lists the tiles of its walk whose
//   skip-table entry is 0 (`list_runs`, a ballot compaction in shared
//   memory; kList entries a pass, longer walks in passes), so the ring
//   carries only tiles that run;
// - the intervals of a tile's 64 kv columns (under its mask head) are
//   staged by cp.async beside its operands, and become one 64-bit keep
//   word per kv column over the tile's 64 q rows (`keep_bits`: not in a
//   band, below sq, and under `causal` not above the top-left diagonal);
// - a masked score never reaches exp: the forward sets it to -inf before
//   the row max (whose running value starts at DEFAULT_MASK_VALUE, so a
//   row that sees no kept column stays exact: out 0, lse
//   DEFAULT_MASK_VALUE), the backward selects -inf as exp's argument, so
//   a fully masked row's lse gives p = 0, not inf * 0;
// - two ring stages: at d128 a block then takes 93.7 KB (forward),
//   110.1 KB (dQ) or 110.6 KB (dK/dV) of shared memory, so two blocks
//   share an SM and one's loads, list, mask and epilogue overlap the
//   other's products.  A block runs about ten tiles under doc_causal;
//   on an H100 two stages were 1.4-1.5x faster than three at s8192,
//   under doc_causal and causal_full, on each of the three kernels.
constexpr int kStages = 2;       // ring depth: two blocks an SM at d128
constexpr int kList = 4096;      // listed tiles (or pairs) per pass

// bits [0, n) of 64, n clamped to [0, 64]
__device__ __forceinline__ uint64_t below64(int n) {
  return n <= 0 ? 0ull : n >= 64 ? ~0ull : (1ull << n) - 1ull;
}

// the rows q0 .. q0 + 63 that column `col` keeps, as bits, from its ncol
// intervals `c`: outside its bands, below sq, and with `causal` not above
// the top-left diagonal (row >= col); no row of a column at or past sk
__device__ __forceinline__ uint64_t keep_bits(const int* c, int col, int q0,
                                              const Dims& dm, int causal) {
  if (col >= dm.sk) return 0ull;
  uint64_t masked = ~below64(dm.sq - q0);
  if (dm.ncol == 1)
    masked |= ~below64(c[0] - q0);
  else
    masked |= below64(c[1] - q0) & ~below64(c[0] - q0);
  if (dm.ncol == 4) masked |= below64(c[3] - q0) & ~below64(c[2] - q0);
  if (causal) masked |= below64(col - q0);
  return ~masked;
}

// the entries e of [w0, w1) for which `skipped(e)` is false, in order, as
// e - w0 into `list`; returns their count.  Every thread of the block
// (128) calls it; it ends on a barrier
template <typename Skipped>
__device__ __forceinline__ int list_runs(int w0, int w1, Skipped skipped,
                                         uint16_t* list, int* warp_n) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int n_run = 0;
  for (int c0 = w0; c0 < w1; c0 += 128) {
    const int e = c0 + tid;
    const bool run = e < w1 && !skipped(e);
    const unsigned ballot = __ballot_sync(0xffffffffu, run);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int at = n_run;
    for (int w = 0; w < warp; ++w) at += warp_n[w];
    if (run) list[at + __popc(ballot & ((1u << lane) - 1u))] = e - w0;
    n_run += warp_n[0] + warp_n[1] + warp_n[2] + warp_n[3];
    __syncthreads();    // warp_n is read; the list is complete
  }
  return n_run;
}

// the intervals of kv columns k0 .. k0 + 63 from the (sk, ncol) slab
// `se_bm` into shared `dst` (64 x ncol ints) by cp.async; zeros past sk
__device__ __forceinline__ void cp_cols64(int* dst, const int* se_bm, int k0,
                                          const Dims& dm, int tid) {
  const int* src = se_bm + (int64_t)k0 * dm.ncol;
  const int valid = min(kB, dm.sk - k0) * dm.ncol;
  for (int i = tid; i < kB * dm.ncol; i += 128)
    hopper::cp_async4(hopper::smem_u32(dst + i), src + (i < valid ? i : 0),
                      i < valid);
}

// forward and dQ, whose accumulator rows are q rows and columns kv
// columns: thread c < 64 writes column k0 + c's keep word over rows
// q0 .. q0 + 63 into words[c], from its staged intervals at cl + c * ncol;
// then a barrier.  Returns whether every word is all ones (nothing in the
// tile is masked), the same for every thread
__device__ __forceinline__ bool stage_keep_words(const int* cl,
                                                 uint64_t* words, int k0,
                                                 int q0, const Dims& dm,
                                                 int causal) {
  const int c = threadIdx.x;
  uint64_t w = ~0ull;
  if (c < kB) {
    w = keep_bits(cl + c * dm.ncol, k0 + c, q0, dm, causal);
    words[c] = w;
  }
  return __syncthreads_and(w == ~0ull);
}

// this thread's keep bits of the 64 x 64 score tile, from the words:
// bit x is accumulator element x (row 16 warp + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e, x = 4 j + 2 h + e)
__device__ __forceinline__ uint32_t keep_fragment(const uint64_t* words,
                                                  int warp, int lane) {
  // rows r and r + 8 lie in one 32-bit half of a word
  const bool hi = warp >= 2;
  const int sh = (16 * warp + lane / 4) % 32;
  uint32_t f = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 w = *reinterpret_cast<const uint4*>(words + 8 * j
                                                    + 2 * (lane % 4));
    const uint32_t a = (hi ? w.y : w.x) >> sh, c = (hi ? w.w : w.z) >> sh;
    f |= (a & 1u) << (4 * j) | (c & 1u) << (4 * j + 1)
         | ((a >> 8) & 1u) << (4 * j + 2) | ((c >> 8) & 1u) << (4 * j + 3);
  }
  return f;
}

// Forward on the tensor cores: flash_fwd_wgmma_kernel's design
// (flash_attention.cu: S = Q K^T from two swizzled shared tiles, the
// online softmax on the f32 accumulators in registers, P rounded to bf16
// as the register A operand of O += P V, V read MN-major) with one
// warpgroup per (batch, q head, 64-row q tile), the skip table's tile:
// FlashMask runs at sq = sk and its mask head can differ across a GQA
// group, so the flash kernel's packing of (query, head) rows buys
// nothing here.  Q stays resident; the run list holds the q tile's kv
// tiles that run, and the ring carries their K, V and intervals.  While
// S = Q K^T runs, the tile's keep words are built; a tile whose words
// are all ones skips reading them (3-4% faster on an H100 at causal_full
// s8192, where most tiles that run keep everything; even at doc_causal).
// Under `causal` the q tiles that see the most columns go first.
template <int D>
__global__ void __launch_bounds__(128, 1)
flashmask_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, const int* __restrict__ se,
                           const int* __restrict__ skip, Dims dm, Strides st,
                           float scale, int causal) {
  using namespace hopper;
  constexpr int TILE = kB * D * 2;        // one 64-row bf16 tile
  constexpr int CH = D / 8;               // 16-byte chunks per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  const uint32_t qs = base;
  const uint32_t ring = base + TILE;      // stage s: K, then V
  // per stage the kv columns' intervals, 64 x ncol; the keep words; the
  // run list and its per-warp counts
  int* const cols = reinterpret_cast<int*>(
      smem_raw + (ring + kStages * 2 * TILE - raw0));
  uint64_t* const words = reinterpret_cast<uint64_t*>(cols + kStages * kB * 4);
  uint16_t* const list = reinterpret_cast<uint16_t*>(words + kB);
  int* const warp_n = reinterpret_cast<int*>(list + kList);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_q = (dm.sq + kB - 1) / kB;
  const int n_kv = (dm.sk + kB - 1) / kB;
  const int qt = causal ? n_q - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kB;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (dm.heads / dm.kv_heads);
  const int64_t bm = (int64_t)b * dm.mask_heads
                     + hq / (dm.heads / dm.mask_heads);
  const int* skip_row = skip + (bm * n_q + qt) * n_kv;
  const int* se_bm = se + bm * dm.sk * dm.ncol;
  const __nv_bfloat16* kb = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + hk * st.vh;

  // Q joins the ring's first group
  const __nv_bfloat16* qb = q + b * st.qb + hq * st.qh;
  for (int idx = tid; idx < kB * CH; idx += 128) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = q0 + r < dm.sq;
    cp_async16(qs + swizzled(r, c, kB),
               qb + (int64_t)(ok ? q0 + r : 0) * st.qs + c * 8, ok);
  }

  auto load_kv = [&](int kt, int stage) {
    const uint32_t ks = ring + stage * 2 * TILE, vs = ks + TILE;
    cp_tiles64<D>(ks, kb, st.ks, vs, vb, st.vs, kt * kB, dm.sk, tid);
    cp_cols64(cols + stage * kB * 4, se_bm, kt * kB, dm, tid);
  };

  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  // the running max starts at the mask value, so a row that sees no
  // kept column keeps it, l stays 0, and the row writes 0
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  for (int w0 = 0; w0 < n_kv; w0 += kList) {
    const int w1 = min(n_kv, w0 + kList);
    const int n_run = list_runs(
        w0, w1, [&](int kt) { return skip_row[kt] != 0; }, list, warp_n);
    // groups in flight: run tiles 0 .. kStages - 2 (each may be empty;
    // the first carries Q on the first pass)
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_run) load_kv(w0 + list[i], i);
      cp_async_commit();
    }
    for (int t = 0; t < n_run; ++t) {
      cp_async_wait<kStages - 2>();   // Q and run tile t have landed
      fence_proxy_async();
      __syncthreads();      // ... for every thread; run tile t - 1 is read
      const int ahead = t + kStages - 1;   // into run tile t - 1's stage
      if (ahead < n_run) load_kv(w0 + list[ahead], ahead % kStages);
      cp_async_commit();
      const int k0 = (w0 + list[t]) * kB;
      const int stage = t % kStages;
      const uint32_t ks = ring + stage * 2 * TILE, vs = ks + TILE;

      // S = Q K^T
      float s[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk / 4) * kB * 128 + (kk % 4) * 32;
        wgmma_ss_n64(s, desc_sw128(qs + at, 16, 1024),
                     desc_sw128(ks + at, 16, 1024), 1);
      }
      wgmma_commit();
      // the keep words while the product runs
      const bool all_kept = stage_keep_words(cols + stage * kB * 4, words,
                                             k0, q0, dm, causal);
      const uint32_t keep = all_kept ? ~0u : keep_fragment(words, warp, lane);
      wgmma_wait<0>();
      fence_operand(s);

      // masked scores become -inf, which adds exactly 0 to the row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kMaskValue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * h + e;
            s[x] = (keep >> x) & 1u ? s[x] * scale : -INFINITY;
            mx = fmaxf(mx, s[x]);
          }
        // the 4 threads of a row are neighbouring lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float alpha = ex2((m[h] - m_new) * kLog2e);
        // finite even for a row that has kept nothing yet (m_new is then
        // the mask value), so exp of a masked -inf is 0, never NaN
        const float mb = fmaxf(m_new * kLog2e, -3.0e38f);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * h + e];
            x = ex2(fmaf(x, kLog2e, -mb));
            rs += x;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[h] = alpha * l[h] + rs;
        m[h] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 2 * h] *= alpha;
          acc[4 * j + 2 * h + 1] *= alpha;
        }
      }

      // O += P V: p in bf16 as the A operand, as the JAX kernel casts it;
      // V MN-major
      uint32_t pa[kB / 16][4];
#pragma unroll
      for (int kc = 0; kc < kB / 16; ++kc) a_slice(s, kc, pa[kc]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kB / 16; ++kc)
        wgmma_rs<D>(acc, pa[kc],
                    desc_sw128(vs + kc * 16 * 128, kB * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
    }
    cp_async_wait<0>();
    __syncthreads();      // the pass's list and ring are no longer read
  }
  cp_async_wait<0>();     // Q, where no kv tile ran

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= dm.sq) continue;
    // a fully masked row (l == 0) writes zeros and lse = -big, so the
    // backward's exp(s - lse) is never taken there
    const float ls = l[h] == 0.f ? 1.f : l[h];
    const float inv = 1.f / ls;
    __nv_bfloat16* ob = o + b * st.ob + hq * st.oh + (int64_t)row * st.os;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                acc[4 * j + 2 * h + 1] * inv);
    if (lane % 4 == 0)
      lse[((int64_t)b * dm.heads + hq) * dm.sq + row] =
          l[h] > 0.f ? m[h] + logf(ls) : kMaskValue;
  }
}

// dK/dV on the tensor cores: flash_bwd_dkv_wgmma_kernel's design
// (attention_bwd_wgmma.cuh: one warpgroup per (batch, kv head, 64-row kv
// tile), K and V resident, the four products on wgmma with P^T and dS^T
// rounded to bf16, dK and dV summed over the GQA group in registers)
// with the skip and mask above: the block walks the (q head of its
// group, q tile) pairs, q head major, and lists those whose skip-table
// entry (under the pair's mask head) is 0; each stage carries Q, dO,
// lse, delta and the kv columns' intervals under the pair's mask head.
// Each thread's accumulator rows are two kv columns, so it builds their
// two keep words itself, over the tile's q rows.
template <int D>
__global__ void __launch_bounds__(128, 1)
flashmask_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ se,
                               const int* __restrict__ skip,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, Dims dm,
                               Strides st, float scale, int causal) {
  using namespace hopper;
  constexpr int TILE = kB * D * 2;        // one 64-row bf16 tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  const uint32_t ks = base, vs = base + TILE;
  const uint32_t ring = base + 2 * TILE;  // stage s: Q, then dO
  // per stage: lse 64, delta 64; the kv columns' intervals, 64 x ncol
  float* const rows_f32 = reinterpret_cast<float*>(
      smem_raw + (ring + kStages * 2 * TILE - raw0));
  int* const cols = reinterpret_cast<int*>(rows_f32 + kStages * 2 * kB);
  uint16_t* const list = reinterpret_cast<uint16_t*>(cols + kStages * kB * 4);
  int* const warp_n = reinterpret_cast<int*>(list + kList);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kt = blockIdx.x, k0 = kt * kB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = dm.heads / dm.kv_heads;
  const int per_mask = dm.heads / dm.mask_heads;
  const int n_q = (dm.sq + kB - 1) / kB;
  const int n_kv = (dm.sk + kB - 1) / kB;
  // pair e: q head hk * group + e / n_q, q tile e % n_q
  const int total = group * n_q;

  cp_tiles64<D>(ks, k + b * st.kb + hk * st.kh, st.ks, vs,
                v + b * st.vb + hk * st.vh, st.vs, k0, dm.sk, tid);
  cp_async_commit();

  auto mask_head = [&](int e) {
    return (int64_t)b * dm.mask_heads + (hk * group + e / n_q) / per_mask;
  };
  auto load_q = [&](int e, int stage) {
    const int hq = hk * group + e / n_q, q0 = (e % n_q) * kB;
    const uint32_t qs = ring + stage * 2 * TILE, dos = qs + TILE;
    cp_tiles64<D>(qs, q + b * st.qb + hq * st.qh, st.qs, dos,
                  dout + b * st.ob + hq * st.oh, st.os, q0, dm.sq, tid);
    const int r = tid % kB;
    const bool ok = q0 + r < dm.sq;
    const int64_t at = ((int64_t)b * dm.heads + hq) * dm.sq
                       + (ok ? q0 + r : 0);
    float* dst = rows_f32 + stage * 2 * kB + (tid / kB) * kB + r;
    cp_async4(smem_u32(dst), (tid < kB ? lse : delta) + at, ok);
    cp_cols64(cols + stage * kB * 4, se + mask_head(e) * dm.sk * dm.ncol,
              k0, dm, tid);
  };

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dka[x] = dva[x] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int w0 = 0; w0 < total; w0 += kList) {
    const int w1 = min(total, w0 + kList);
    const int n_run = list_runs(
        w0, w1,
        [&](int e) { return skip[(mask_head(e) * n_q + e % n_q) * n_kv + kt]
                            != 0; },
        list, warp_n);

    // groups in flight: (K, V,) run tiles 0 .. kStages - 2 (each may be
    // empty)
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_run) load_q(w0 + list[i], i);
      cp_async_commit();
    }
    for (int t = 0; t < n_run; ++t) {
      cp_async_wait<kStages - 2>();   // K, V and run tile t have landed
      fence_proxy_async();
      __syncthreads();      // ... for every thread; run tile t - 1 is read
      const int ahead = t + kStages - 1;   // into run tile t - 1's stage
      if (ahead < n_run) load_q(w0 + list[ahead], ahead % kStages);
      cp_async_commit();
      const int q0 = ((w0 + list[t]) % n_q) * kB;
      const int stage = t % kStages;
      const uint32_t qs = ring + stage * 2 * TILE, dos = qs + TILE;
      const float* ls = rows_f32 + stage * 2 * kB;
      const float* dls = ls + kB;
      const int* cl = cols + stage * kB * 4;

      // this thread's kv columns r, r + 8: keep bits of the tile's rows,
      // shifted so that bit 8 j + e is its element column 8 j + 2 q + e
      uint32_t keep[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 16 * warp + lane / 4 + 8 * h;
        const uint64_t bits = keep_bits(cl + c * dm.ncol, k0 + c, q0, dm,
                                        causal) >> (2 * (lane % 4));
        keep[h][0] = static_cast<uint32_t>(bits);
        keep[h][1] = static_cast<uint32_t>(bits >> 32);
      }

      float p[32], ds[32];
      dkv_scores<D>(p, ds, ks, vs, qs, dos);
      // p = where(keep, exp(s * scale - lse), 0); ds = p (dp - delta) scale
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * (lane % 4) + e;
            const int x = 4 * j + 2 * h + e;
            const bool kp = (keep[h][j / 4] >> (8 * (j % 4) + e)) & 1u;
            p[x] = ex2(kp ? fmaf(p[x], sl2, -ls[c] * kLog2e) : -INFINITY);
            ds[x] = p[x] * (ds[x] - dls[c]) * scale;
          }
      dkv_accumulate<D>(dva, dka, p, ds, qs, dos);
    }
    cp_async_wait<0>();
    __syncthreads();      // the pass's list and ring are no longer read
  }

  dkv_store<D>(dka, dva, dk + b * st.gb + hk * st.gh, st.gs,
               dv + b * st.hb + hk * st.hh, st.hs, k0, dm.sk, tid);
}

// dQ on the tensor cores: flash_bwd_dq_wgmma_kernel's design
// (flash_attention_bwd.cu: one warpgroup per (batch, q head, 64-row q
// tile), Q and dO resident, each row's lse * log2(e) and delta in
// registers, S = Q K^T and dP = dO V^T from shared memory, dS rounded to
// bf16 as the register A operand of dQ += dS K, K read MN-major from the
// tile that gave S; the JAX kernel takes that product in f32) with the
// forward's run list, staged intervals and keep words.  Under `causal`
// the q tiles that see the most columns go first.  dQ is written once
// per element, in q's type.
template <int D>
__global__ void __launch_bounds__(128, 1)
flashmask_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ se,
                              const int* __restrict__ skip,
                              __nv_bfloat16* __restrict__ dq, Dims dm,
                              Strides st, float scale, int causal) {
  using namespace hopper;
  constexpr int TILE = kB * D * 2;        // one 64-row bf16 tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  const uint32_t qs = base, dos = base + TILE;
  const uint32_t ring = base + 2 * TILE;  // stage s: K, then V
  int* const cols = reinterpret_cast<int*>(
      smem_raw + (ring + kStages * 2 * TILE - raw0));
  uint64_t* const words = reinterpret_cast<uint64_t*>(cols + kStages * kB * 4);
  uint16_t* const list = reinterpret_cast<uint16_t*>(words + kB);
  int* const warp_n = reinterpret_cast<int*>(list + kList);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_q = (dm.sq + kB - 1) / kB;
  const int n_kv = (dm.sk + kB - 1) / kB;
  const int qt = causal ? n_q - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kB;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (dm.heads / dm.kv_heads);
  const int64_t bm = (int64_t)b * dm.mask_heads
                     + hq / (dm.heads / dm.mask_heads);
  const int* skip_row = skip + (bm * n_q + qt) * n_kv;
  const int* se_bm = se + bm * dm.sk * dm.ncol;
  const __nv_bfloat16* kb = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + hk * st.vh;

  // Q and dO join the ring's first group
  cp_tiles64<D>(qs, q + b * st.qb + hq * st.qh, st.qs, dos,
                dout + b * st.ob + hq * st.oh, st.os, q0, dm.sq, tid);
  // this thread's two accumulator rows: lse * log2(e) and delta (rows
  // past sq keep nothing, so their zeros are never used)
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    const int64_t at = ((int64_t)b * dm.heads + hq) * dm.sq + row;
    lr[h] = row < dm.sq ? lse[at] * kLog2e : 0.f;
    dr[h] = row < dm.sq ? delta[at] : 0.f;
  }

  auto load_kv = [&](int kt, int stage) {
    const uint32_t ks = ring + stage * 2 * TILE, vs = ks + TILE;
    cp_tiles64<D>(ks, kb, st.ks, vs, vb, st.vs, kt * kB, dm.sk, tid);
    cp_cols64(cols + stage * kB * 4, se_bm, kt * kB, dm, tid);
  };

  float dqa[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dqa[x] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int w0 = 0; w0 < n_kv; w0 += kList) {
    const int w1 = min(n_kv, w0 + kList);
    const int n_run = list_runs(
        w0, w1, [&](int kt) { return skip_row[kt] != 0; }, list, warp_n);
    // groups in flight: run tiles 0 .. kStages - 2 (each may be empty;
    // the first carries Q and dO on the first pass)
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_run) load_kv(w0 + list[i], i);
      cp_async_commit();
    }
    for (int t = 0; t < n_run; ++t) {
      cp_async_wait<kStages - 2>();   // Q, dO and run tile t have landed
      fence_proxy_async();
      __syncthreads();      // ... for every thread; run tile t - 1 is read
      const int ahead = t + kStages - 1;   // into run tile t - 1's stage
      if (ahead < n_run) load_kv(w0 + list[ahead], ahead % kStages);
      cp_async_commit();
      const int k0 = (w0 + list[t]) * kB;
      const int stage = t % kStages;
      const uint32_t ks = ring + stage * 2 * TILE, vs = ks + TILE;

      // S = Q K^T and dP = dO V^T: q rows x kv columns
      float s[32], dp[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk / 4) * kB * 128 + (kk % 4) * 32;
        wgmma_ss_n64(s, desc_sw128(qs + at, 16, 1024),
                     desc_sw128(ks + at, 16, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk / 4) * kB * 128 + (kk % 4) * 32;
        wgmma_ss_n64(dp, desc_sw128(dos + at, 16, 1024),
                     desc_sw128(vs + at, 16, 1024), 1);
      }
      wgmma_commit();
      // the keep words while the products run
      const bool all_kept = stage_keep_words(cols + stage * kB * 4, words,
                                             k0, q0, dm, causal);
      const uint32_t keep = all_kept ? ~0u : keep_fragment(words, warp, lane);
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);

      // p = where(keep, exp(s * scale - lse), 0); ds = p (dp - delta)
      // scale, into s
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * h + e;
            const float p = ex2((keep >> x) & 1u ? fmaf(s[x], sl2, -lr[h])
                                                 : -INFINITY);
            s[x] = p * (dp[x] - dr[h]) * scale;
          }
      uint32_t dsa[kB / 16][4];
#pragma unroll
      for (int kc = 0; kc < kB / 16; ++kc) a_slice(s, kc, dsa[kc]);

      // dQ += dS K, K MN-major
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kB / 16; ++kc)
        wgmma_rs<D>(dqa, dsa[kc],
                    desc_sw128(ks + kc * 16 * 128, kB * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dqa);
    }
    cp_async_wait<0>();
    __syncthreads();      // the pass's list and ring are no longer read
  }
  cp_async_wait<0>();     // Q and dO, where no kv tile ran

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= dm.sq) continue;
    __nv_bfloat16* out = dq + b * st.gb + hq * st.gh + (int64_t)row * st.gs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * h], dqa[4 * j + 2 * h + 1]);
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

// the wgmma kernels' shared bytes beside their tiles: per stage 64 x 4
// intervals, the run list and its per-warp counts
constexpr int kListSmem = kStages * kB * 4 * 4 + kList * 2 + 16;

template <int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* o, float* lse, const int* se,
                             const int* skip, int batch, Dims dm,
                             const int64_t* st, int causal, float scale,
                             cudaStream_t stream) {
  // Q, a ring of K and V, the keep words
  constexpr int smem = 1024 + (1 + 2 * kStages) * kB * D * 2 + kB * 8
                       + kListSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flashmask_fwd_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((dm.sq + kB - 1) / kB, dm.heads, batch);
  flashmask_fwd_wgmma_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, se, skip, dm, unpack(st, 12), scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int* se,
                             const int* skip, void* dk, void* dv, int batch,
                             Dims dm, const int64_t* st, int causal,
                             float scale, cudaStream_t stream) {
  // K, V, a ring of Q and dO, per stage lse and delta
  constexpr int smem = 1024 + (2 + 2 * kStages) * kB * D * 2
                       + kStages * 2 * kB * 4 + kListSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flashmask_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((dm.sk + kB - 1) / kB, dm.kv_heads, batch);
  flashmask_bwd_dkv_wgmma_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, se, skip,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), dm,
      unpack(st, 18), scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const int* se,
                            const int* skip, void* dq, int batch, Dims dm,
                            const int64_t* st, int causal, float scale,
                            cudaStream_t stream) {
  // Q, dO, a ring of K and V, the keep words
  constexpr int smem = 1024 + (2 + 2 * kStages) * kB * D * 2 + kB * 8
                       + kListSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flashmask_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((dm.sq + kB - 1) / kB, dm.heads, batch);
  flashmask_bwd_dq_wgmma_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, se, skip,
      static_cast<__nv_bfloat16*>(dq), dm, unpack(st, 15), scale, causal);
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

// bf16 on the tensor cores (WGMMA<D>), f32 on the CUDA cores
// (CORES<float, D>), D = 64 or 128; otherwise cudaErrorInvalidValue
#define FLASHMASK_DISPATCH(WGMMA, CORES, ...)                            \
  if (dtype == 1 && head_dim == 128)                                     \
    return (int)WGMMA<128>(__VA_ARGS__);                                 \
  if (dtype == 1 && head_dim == 64)                                      \
    return (int)WGMMA<64>(__VA_ARGS__);                                  \
  if (dtype == 0 && head_dim == 128)                                     \
    return (int)CORES<float, 128>(__VA_ARGS__);                          \
  if (dtype == 0 && head_dim == 64)                                      \
    return (int)CORES<float, 64>(__VA_ARGS__);                           \
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
  FLASHMASK_DISPATCH(launch_fwd_wgmma, launch_fwd, q, k, v, o,
                     static_cast<float*>(lse), static_cast<const int*>(se),
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
  FLASHMASK_DISPATCH(launch_dkv_wgmma, launch_dkv, q, k, v, dout,
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
  FLASHMASK_DISPATCH(launch_dq_wgmma, launch_dq, q, k, v, dout,
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
