// Flash-attention forward for Hopper (sm_90a): tiled online softmax,
// returning the output and the f32 log-sum-exp.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (launched by `flash_attention_forward`).  Same contract: causal mask
// bottom-right aligned at offset sk - sq, kv columns past sk masked with
// the finite DEFAULT_MASK_VALUE, GQA through kv head h / group, a row
// whose softmax sum is zero writes zeros, p rounded to the working type
// before it meets V, as the JAX kernel casts it.
//
// What bounds it on the H100: at prefill lengths the work is
// 4 * sq * sk * d operations per head (halved under the causal mask)
// against (2 * sq + 2 * sk) * d elements moved, so it is bound by
// operations, and only the tensor cores come near that bound.  At decode
// (sq = 1) it is bound by the bytes of K and V.  Two kernels:
//
// - bf16: `flash_fwd_wgmma_kernel`, both products on the tensor cores
//   (wgmma.mma_async).  Its rows are (query, head of the GQA group)
//   pairs of one kv head, so each K/V tile is read once per kv head, not
//   once per q head, and a decode step (one query, a group of 4) fills 4
//   rows of one block instead of 1 row of each of 4 blocks.  One or two
//   consumer warpgroups of 64 rows; Q stays in shared memory, and K/V
//   tiles of 64 columns stream through a three-stage ring filled by
//   16-byte cp.async copies two tiles ahead of the one multiplied (one
//   barrier per tile).  Under the causal mask the row tiles that see the
//   most columns are scheduled first.  cp.async
//   rather than TMA because every operand is a strided view (the (b, s,
//   h, d) serving and training buffers), the ragged edges are zero-filled
//   per row, and a tensor map would have to be encoded on the host at
//   every launch of a decode loop whose cost is already the host's.
//   S = Q K^T reads Q and K from the 128-byte-swizzled tiles; the softmax
//   runs on the f32 accumulators in registers, which are rounded to bf16
//   and fed straight back as the A operand of O += P V (V read MN-major
//   from the same tiles).  Tiles right of the causal diagonal are never
//   loaded.  A masked score adds exactly 0 to its row, so a row that
//   sees no column writes zeros and lse DEFAULT_MASK_VALUE whatever the
//   tiling.
// - f32: `flash_fwd_kernel`, the products in f32 on the CUDA cores (wgmma
//   has no f32 product, and TF32 would not hold the f32 checks).  Each
//   block keeps a 64-row query tile resident in shared memory and streams
//   32-column K/V tiles past it, every thread accumulates a 4x4 score tile
//   and a 4x(d/8) output tile in registers (8 shared loads feed 16 FMAs),
//   tiles right of the causal diagonal are never loaded, and shared rows
//   are padded by one float so no warp's column read hits one bank twice.
//   Under the causal mask with sq > sk a row that sees no column still
//   takes exp(0) for each masked column of the tiles its block visits
//   (as the JAX kernel does), so it writes the average of v over those
//   columns (zeros past sk) where the bf16 kernel writes zeros, and the
//   plain version the average over all sk columns; lse is
//   DEFAULT_MASK_VALUE in all three, and the backward adds nothing from
//   such a row in either dtype.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

// DEFAULT_MASK_VALUE of the JAX package: finite, so exp(mask - max)
// underflows to an exact zero instead of producing NaN
constexpr float kMaskValue = -0.7f * 3.40282346638528859812e+38f;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // kv columns per tile
constexpr int kThreads = 128;  // tx = tid % 8, ty = tid / 8
constexpr int kRM = 4;         // query rows per thread: ty * 4 + i
constexpr int kCN = kBK / 8;   // score columns per thread: tx + 8 * j

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int heads, int group, int sq,
                 int sk, int64_t qsb, int64_t qsh, int64_t qss,
                 int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
                 int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
                 int64_t oss, int causal, float scale) {
  constexpr int DP = D + 1;      // padded shared row: conflict-free reads
  constexpr int DM = D / 8;      // output dims per thread: tx + 8 * m
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][DP]
  float* ks = qs + kBQ * DP;     // [kBK][DP]
  float* vs = ks + kBK * DP;     // [kBK][DP]
  float* ps = vs + kBK * DP;     // [kBQ][PP]

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / group;
  const int offset = sk - sq;

  const T* qb = q + b * qsb + hq * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int i = tid; i < kBQ * (D / VEC); i += kThreads) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    const int row = q0 + r;
    float tmp[VEC];
    if (row < sq) {
      load16(qb + row * qss + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) qs[r * DP + c + e] = tmp[e];
  }

  float m[kRM], l[kRM], acc[kRM][DM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DM; ++d) acc[i][d] = 0.f;
  }

  // tiles strictly right of the (offset) diagonal contribute nothing
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kBQ + offset);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * (D / VEC); i += kThreads) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      const int col = k0 + r;
      float tk[VEC], tv[VEC];
      if (col < sk) {
        load16(kb + col * kss + c, tk);
        load16(vb + col * vss + c, tv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[r * DP + c + e] = tk[e];
        vs[r * DP + c + e] = tv[e];
      }
    }
    __syncthreads();

    float s[kRM][kCN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float qv[kRM], kv[kCN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qv[i] = qs[(ty * kRM + i) * DP + e];
#pragma unroll
      for (int j = 0; j < kCN; ++j) kv[j] = ks[(tx + 8 * j) * DP + e];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kCN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int row = q0 + ty * kRM + i;
      float tmax = kMaskValue;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool ok = col < sk && (!causal || row + offset >= col);
        s[i][j] = ok ? s[i][j] * scale : kMaskValue;
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
      for (int j = 0; j < kCN; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        // p meets V in the working type, as the JAX kernel casts it
        ps[(ty * kRM + i) * PP + tx + 8 * j] = to_float(from_float<T>(p));
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
    for (int c = 0; c < kBK; ++c) {
      float pv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) pv[i] = ps[(ty * kRM + i) * PP + c];
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        const float vv = vs[c * DP + tx + 8 * d];
#pragma unroll
        for (int i = 0; i < kRM; ++i) acc[i][d] = fmaf(pv[i], vv, acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q0 + ty * kRM + i;
    if (row >= sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / ls;
    T* ob = o + b * osb + hq * osh + row * oss;
#pragma unroll
    for (int d = 0; d < DM; ++d) ob[tx + 8 * d] = from_float<T>(acc[i][d] * inv);
    if (tx == 0) lse[((int64_t)b * heads + hq) * sq + row] = m[i] + logf(ls);
  }
}

// ---------------------------------------------------------------- wgmma
// Rows of a block: NWG warpgroups x 64 (query, head) pairs of kv head
// blockIdx.y, pair rho = query * group + head-in-group.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int heads, int group, int sq, int sk, int64_t qsb,
                       int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                       int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
                       int64_t osb, int64_t osh, int64_t oss, int causal,
                       float scale) {
  using namespace hopper;
  constexpr int BQ = 64 * NWG;          // rows per block
  constexpr int BK = 64;                // kv columns per tile
  constexpr int STAGES = 3;             // K/V ring
  constexpr int THREADS = 128 * NWG;
  constexpr int CH = D / 8;             // 16-byte chunks per row
  constexpr int KV_BYTES = BK * D * 2;  // one K (or V) tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qs = base;                       // [BQ x D] swizzled
  const uint32_t kv0 = qs + BQ * D * 2;           // stage s: K, then V

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rows = group * sq;
  // under the causal mask the last row tiles see the most columns: they
  // go first, so the short ones fill the tail of the grid
  const int row0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int offset = sk - sq;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;

  for (int idx = tid; idx < BQ * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const int rho = row0 + r;
    const bool ok = rho < rows;
    const int i = ok ? rho / group : 0, g = ok ? rho % group : 0;
    cp_async16(qs + swizzled(r, c, BQ),
               q + b * qsb + (hk * group + g) * qsh + i * qss + c * 8, ok);
  }

  // tiles strictly right of the (offset) diagonal contribute nothing
  int kv_end = sk;
  if (causal) {
    const int last = (min(row0 + BQ, rows) - 1) / group;
    kv_end = min(sk, last + 1 + offset);
  }
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  auto load_kv = [&](int tile) {
    const uint32_t ks = kv0 + (tile % STAGES) * 2 * KV_BYTES;
    const uint32_t vs = ks + KV_BYTES;
    for (int idx = tid; idx < BK * CH; idx += THREADS) {
      const int r = idx / CH, c = idx % CH;
      const int col = tile * BK + r;
      const bool ok = col < sk;
      const int64_t at = ok ? col : 0;
      cp_async16(ks + swizzled(r, c, BK), kb + at * kss + c * 8, ok);
      cp_async16(vs + swizzled(r, c, BK), vb + at * vss + c * 8, ok);
    }
  };

  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  // running max starts at the mask value, so a row that sees no column
  // keeps it and ends with lse = DEFAULT_MASK_VALUE, tiles run or not
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  int qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qi[h] = (row0 + wg * 64 + 16 * warp + lane / 4 + 8 * h) / group;
  const int q_lo = (row0 + wg * 64) / group;   // this warpgroup's first

  // groups in flight: Q with tile 0, then tile 1 (each may be empty)
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();   // Q and tile t have landed
    fence_proxy_async();
    __syncthreads();      // ... for every thread; tile t - 1 is read
    if (t + 2 < n_tiles) load_kv(t + 2);   // into tile t - 1's stage
    cp_async_commit();
    const uint32_t ks = kv0 + (t % STAGES) * 2 * KV_BYTES;
    const uint32_t vs = ks + KV_BYTES;

    // S = Q K^T over this warpgroup's 64 rows
    float s[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t in_panel = (kk % 4) * 32;   // 16 columns = 32 bytes
      wgmma_ss_n64(s,
                   desc_sw128(qs + (kk / 4) * BQ * 128 + wg * 64 * 128
                              + in_panel, 16, 1024),
                   desc_sw128(ks + (kk / 4) * BK * 128 + in_panel, 16, 1024),
                   1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);

    // masked scores become -inf, which adds exactly 0 to the row; only
    // tiles on the ragged edge or the causal diagonal need the compares
    const int k0 = t * BK;
    if (k0 + BK > sk || (causal && k0 + BK - 1 > q_lo + offset)) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * (lane % 4) + e;
            if (col >= sk || (causal && qi[h] + offset < col))
              s[4 * j + 2 * h + e] = -INFINITY;
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x *= scale;
          mx = fmaxf(mx, x);
        }
      // the 4 threads of a row are neighbouring lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = ex2((m[h] - m_new) * kLog2e);
      // finite even for a row that has seen no column (m_new is then the
      // mask value), so exp of a masked -inf is 0, never NaN
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

    // O += P V: p in bf16 as the A operand, V MN-major
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) a_slice(s, kc, pa[kc]);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
      wgmma_rs<D>(acc, pa[kc], desc_sw128(vs + kc * 16 * 128, BK * 128, 1024),
                  1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = row0 + wg * 64 + 16 * warp + lane / 4 + 8 * h;
    if (rho >= rows) continue;
    const int hq = hk * group + rho % group;
    const float ls = l[h] == 0.f ? 1.f : l[h];
    const float inv = 1.f / ls;
    __nv_bfloat16* ob = o + b * osb + hq * osh + (int64_t)qi[h] * oss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                acc[4 * j + 2 * h + 1] * inv);
    if (lane % 4 == 0)
      lse[((int64_t)b * heads + hq) * sq + qi[h]] = m[h] + logf(ls);
  }
}

template <int D, int NWG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int batch, int heads,
                         int kv_heads, int sq, int sk, const int64_t* st,
                         int causal, float scale, cudaStream_t stream) {
  constexpr int smem = 1024 + 64 * NWG * D * 2 + 3 * 2 * 64 * D * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int group = heads / kv_heads;
  const long long rows = (long long)group * sq;
  dim3 grid((unsigned)((rows + 64 * NWG - 1) / (64 * NWG)), kv_heads, batch);
  flash_fwd_wgmma_kernel<D, NWG><<<grid, NWG * 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, heads, group, sq, sk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal, scale);
  return cudaGetLastError();
}

// the bf16 tensor-core forward: two warpgroups (128 rows) per block, one
// where the (query, head) rows of a kv head fill no more than 64
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int batch, int heads, int kv_heads,
                        int sq, int sk, const int64_t* st, int causal,
                        float scale, cudaStream_t stream) {
  if ((long long)(heads / kv_heads) * sq <= 64)
    return launch_wgmma<D, 1>(q, k, v, o, lse, batch, heads, kv_heads, sq,
                              sk, st, causal, scale, stream);
  return launch_wgmma<D, 2>(q, k, v, o, lse, batch, heads, kv_heads, sq, sk,
                            st, causal, scale, stream);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int heads, int kv_heads, int sq,
                   int sk, const int64_t* st, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int smem = ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1))
                       * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, heads,
      heads / kv_heads, sq, sk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (b, h, sq, d), k/v (b, kv_h, sk, d), o like q: any strides whose
// last dimension is contiguous, given in elements as
// [q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s].
// lse: contiguous (b, h, sq) f32.  dtype 0 = f32 (the CUDA-core kernel),
// 1 = bf16 (the tensor-core kernel).  Returns cudaGetLastError() after
// the launch (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, int batch, int heads,
                        int kv_heads, int sq, int sk, int head_dim,
                        const int64_t* strides, int causal, float scale,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1 && head_dim == 128)
    return launch_bf16<128>(q, k, v, o, l, batch, heads, kv_heads, sq, sk,
                            strides, causal, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_bf16<64>(q, k, v, o, l, batch, heads, kv_heads, sq, sk,
                           strides, causal, scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, o, l, batch, heads, kv_heads, sq, sk,
                              strides, causal, scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, o, l, batch, heads, kv_heads, sq, sk,
                             strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
