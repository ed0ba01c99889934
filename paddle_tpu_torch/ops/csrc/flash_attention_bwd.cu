// Flash-attention backward for Hopper (sm_90a): the FA2 dK/dV and dQ
// passes, from the forward's f32 log-sum-exp and delta = rowsum(out * dO).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_bwd_dkv_kernel`
// and `_bwd_dq_kernel` (launched by `flash_attention_backward`).  Same
// contract: causal mask bottom-right aligned at offset sk - sq;
// p = where(mask, exp(s * scale - lse), 0), never exp of a mask value, so
// a row that sees no column (sq > sk) gets zero gradients; q rows past sq
// add nothing to dK/dV and kv columns past sk nothing to dQ; dK/dV sum
// in f32 over the GQA group before one cast to k's type; dQ is cast to
// q's type.
//
// What bounds it on the H100: per (q, kv) pair the dK/dV pass does four
// d-long products (s, dp, dv, dk) and the dQ pass three (s, dp, dq),
// against (sq + sk) * d elements per head moved, so both are bound by
// operations, and only the tensor cores come near that bound.  The
// kernels:
//
// - dK/dV, bf16: `flash_bwd_dkv_wgmma_kernel`, the four products on the
//   tensor cores (wgmma.mma_async).  One block (one warpgroup) per
//   (batch, kv head, 64-row kv tile) keeps K and V resident in
//   128-byte-swizzled shared tiles and its dK, dV accumulators in
//   registers while it walks the q tiles of every q head of its GQA
//   group, so the group sum happens in those registers with no atomics.
//   The q tiles (Q, dO, lse, delta) stream through a three-stage ring
//   filled by cp.async two tiles ahead of the one multiplied (cp.async,
//   not TMA, for the reasons the forward's header gives: strided views,
//   per-row zero fill).  S^T = K Q^T and dP^T = V dO^T read both operands
//   from shared memory; P^T and dS^T are computed in f32 on their
//   accumulators, rounded to bf16 and fed straight back as the A operands
//   of dV += P^T dO and dK += dS^T Q (dO and Q read MN-major from the same
//   tiles).  Rounding P and dS to bf16 is this kernel's one divergence
//   from the JAX kernel, which takes those two products in f32 (so do
//   FlashAttention-2 and -3).  At head dim 128 the two 64 x 128 f32
//   accumulators take 128 registers a thread; the products are ordered so
//   that S^T and dP^T (64 more) are dead before P^T and dS^T are packed.
//   q tiles wholly above the causal diagonal are never loaded.
// - dK/dV, f32: `flash_bwd_dkv_kernel`, the same blocking with the
//   products in f32 on the CUDA cores (wgmma has no f32 product).
// - dQ, bf16: `flash_bwd_dq_wgmma_kernel`, the three products on the
//   tensor cores.  One warpgroup per (batch, q head, 64-row q tile) keeps
//   Q and dO resident in swizzled tiles, its rows' lse and delta in
//   registers and dQ's 64 x d f32 accumulator in registers, while the K
//   and V tiles of its kv head (q head h reads kv head h / group) stream
//   through the same three-stage cp.async ring up to the causal limit;
//   tiles right of the diagonal are never loaded.  S = Q K^T and
//   dP = dO V^T read both operands from shared memory; dS, rounded to
//   bf16 (the JAX kernel takes dQ += dS K in f32; FlashAttention-2 and -3
//   round as here), is the register A operand of dQ += dS K, K read
//   MN-major from the tile that gave S.  dQ is its own pass, not summed
//   with f32 atomics inside the dK/dV kernel (FA2's and FA3's fused
//   form): each dQ element is written once, so dQ is deterministic, and
//   the pass mirrors the JAX kernel's.
// - dQ, f32: `flash_bwd_dq_kernel`, the same blocking with the products in
//   f32 on the CUDA cores.
// - The CUDA-core kernels: every thread owns a 4x4 micro-tile of each
//   64x64 score tile and a 4x(d/16) slice of each accumulator: 8 shared
//   loads feed 16 FMAs.  Shared rows are padded by one float, so no
//   warp's column read hits one bank twice.
// - q, k, v, out, dO and the three gradients are read and written
//   through (b, h, s) strides, so the (b, s, h, d) training buffers need
//   no transposed copies.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_wgmma.cuh"
#include "hopper_wgmma.cuh"

namespace {

constexpr int kB = hopper::kAttnRows;   // rows of a q tile and of a kv tile
constexpr int kThreads = 256;   // tx = tid % 16, ty = tid / 16
constexpr int kR = 4;           // tile rows per thread: ty * 4 + i
constexpr int kC = kB / 16;     // tile columns per thread: tx + 16 * j
constexpr int kPP = kB + 1;     // padded row of a score tile
constexpr int kStages = 3;      // ring of the wgmma kernels' streamed tiles

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

// rows row0 .. row0 + kB of a (s, D) slab with row stride `stride` into
// shared floats [kB][D + 1]; rows at or past `valid` read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* base, int64_t stride,
                                          int row0, int valid, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  for (int i = threadIdx.x; i < kB * (D / VEC); i += kThreads) {
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

struct Strides {
  // elements, (batch, head, seq) of q, k, v, dout, dq, dk, dv
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
  int64_t dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int group, int sq,
                     int sk, Strides st, int causal, float scale) {
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

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int offset = sk - sq;

  load_tile<T, D>(k + b * st.kb + hk * st.kh, st.ks, k0, sk, ks);
  load_tile<T, D>(v + b * st.vb + hk * st.vh, st.vs, k0, sk, vs);

  float dka[kR][DM], dva[kR][DM];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int m = 0; m < DM; ++m) dka[i][m] = dva[i][m] = 0.f;

  // q tiles wholly above the diagonal see none of this kv tile
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / kB * kB;

  for (int g = 0; g < group; ++g) {
    const int hq = hk * group + g;
    const T* qb = q + b * st.qb + hq * st.qh;
    const T* ob = dout + b * st.ob + hq * st.oh;
    const float* lb = lse + ((int64_t)b * heads + hq) * sq;
    const float* db = delta + ((int64_t)b * heads + hq) * sq;
    for (int q0 = q_begin; q0 < sq; q0 += kB) {
      __syncthreads();   // the previous tile's readers are done
      load_tile<T, D>(qb, st.qs, q0, sq, qs);
      load_tile<T, D>(ob, st.os, q0, sq, dos);
      if (tid < kB) {
        const int row = q0 + tid;
        ls[tid] = row < sq ? lb[row] : 0.f;
        dls[tid] = row < sq ? db[row] : 0.f;
      }
      __syncthreads();

      float p[kR][kC], dp[kR][kC];
      tile_dot<D>(qs, ks, tx, ty, p);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int row = q0 + ty * kR + i;
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const int col = k0 + tx + 16 * j;
          const bool ok = row < sq && col < sk
                          && (!causal || row + offset >= col);
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
    if (row >= sk) continue;
    T* kout = dk + b * st.dkb + hk * st.dkh + row * st.dks;
    T* vout = dv + b * st.dvb + hk * st.dvh + row * st.dvs;
#pragma unroll
    for (int m = 0; m < DM; ++m) {
      kout[tx + 16 * m] = from_float<T>(dka[i][m]);
      vout[tx + 16 * m] = from_float<T>(dva[i][m]);
    }
  }
}

// ---------------------------------------------------------------- wgmma
// the products, the tile loads and the store are attention_bwd_wgmma.cuh's
// (shared with FlashMask's dK/dV kernel; dQ below uses its tile loads)
template <int D>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int heads,
                           int group, int sq, int sk, Strides st, int causal,
                           float scale) {
  using namespace hopper;
  constexpr int TILE = kB * D * 2;        // one 64-row bf16 tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ks = base, vs = base + TILE;
  const uint32_t ring = base + 2 * TILE;  // stage s: Q, then dO
  // [stage][lse 64, delta 64]
  float* rows_f32 = reinterpret_cast<float*>(
      smem_raw + (ring + kStages * 2 * TILE - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int offset = sk - sq;

  cp_tiles64<D>(ks, k + b * st.kb + hk * st.kh, st.ks, vs,
                v + b * st.vb + hk * st.vh, st.vs, k0, sk, tid);

  // q tiles wholly above the diagonal see none of this kv tile
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / kB * kB;
  const int n_qt = q_begin < sq ? (sq - q_begin + kB - 1) / kB : 0;
  const int total = group * n_qt;

  auto load_q = [&](int t) {
    const int stage = t % kStages;
    const int hq = hk * group + t / n_qt;
    const int q0 = q_begin + (t % n_qt) * kB;
    const uint32_t qs = ring + stage * 2 * TILE, dos = qs + TILE;
    cp_tiles64<D>(qs, q + b * st.qb + hq * st.qh, st.qs, dos,
                  dout + b * st.ob + hq * st.oh, st.os, q0, sq, tid);
    const int r = tid % kB;
    const bool ok = q0 + r < sq;
    const int64_t at = ((int64_t)b * heads + hq) * sq + (ok ? q0 + r : 0);
    float* dst = rows_f32 + stage * 2 * kB + (tid / kB) * kB + r;
    cp_async4(smem_u32(dst), (tid < kB ? lse : delta) + at, ok);
  };

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dka[x] = dva[x] = 0.f;

  // groups in flight: K, V with q tile 0, then q tile 1 (each may be empty)
  if (total > 0) load_q(0);
  cp_async_commit();
  if (total > 1) load_q(1);
  cp_async_commit();
  for (int t = 0; t < total; ++t) {
    cp_async_wait<1>();   // K, V and q tile t have landed
    fence_proxy_async();
    __syncthreads();      // ... for every thread; q tile t - 1 is read
    if (t + 2 < total) load_q(t + 2);   // into q tile t - 1's stage
    cp_async_commit();
    const int q0 = q_begin + (t % n_qt) * kB;
    const uint32_t qs = ring + (t % kStages) * 2 * TILE, dos = qs + TILE;
    const float* ls = rows_f32 + (t % kStages) * 2 * kB;
    const float* dls = ls + kB;

    // S^T = K Q^T and dP^T = V dO^T: kv rows x q columns
    float p[32], ds[32];
    dkv_scores<D>(p, ds, ks, vs, qs, dos);

    // p = where(mask, exp(s * scale - lse), 0); ds = p (dp - delta) scale.
    // Only tiles on a ragged edge or the causal diagonal need the compares
    const bool edge = q0 + kB > sq || k0 + kB > sk
                      || (causal && q0 + offset < k0 + kB - 1);
    const float sl2 = scale * kLog2e;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kv = k0 + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + e;
          const int row = q0 + c;
          const int x = 4 * j + 2 * h + e;
          p[x] = ex2(fmaf(p[x], sl2, -ls[c] * kLog2e));
          if (edge && !(row < sq && kv < sk
                        && (!causal || row + offset >= kv)))
            p[x] = 0.f;
          ds[x] = p[x] * (ds[x] - dls[c]) * scale;
        }
    }

    // dV += P^T dO and dK += dS^T Q, dO and Q MN-major
    dkv_accumulate<D>(dva, dka, p, ds, qs, dos);
  }
  cp_async_wait<0>();

  dkv_store<D>(dka, dva, dk + b * st.dkb + hk * st.dkh, st.dks,
               dv + b * st.dvb + hk * st.dvh, st.dvs, k0, sk, tid);
}

// dQ on the tensor cores: the dK/dV kernel above with the roles of the q
// and kv tiles swapped.  One warpgroup per (batch, q head, 64-row q tile)
// keeps Q and dO resident and its rows' lse and delta in registers; the
// K and V tiles of the q head's kv head stream through the ring up to
// the causal limit.  dS is rounded to bf16 and fed back as the A operand
// of dQ += dS K, K read MN-major from the tile that gave S.
template <int D>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int heads,
                          int group, int sq, int sk, Strides st, int causal,
                          float scale) {
  using namespace hopper;
  constexpr int TILE = kB * D * 2;        // one 64-row bf16 tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qs = base, dos = base + TILE;
  const uint32_t ring = base + 2 * TILE;  // stage s: K, then V

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kB;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / group;
  const int offset = sk - sq;

  cp_tiles64<D>(qs, q + b * st.qb + hq * st.qh, st.qs, dos,
                dout + b * st.ob + hq * st.oh, st.os, q0, sq, tid);
  // this thread's two accumulator rows: lse * log2(e) and delta
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    const int64_t at = ((int64_t)b * heads + hq) * sq + row;
    lr[h] = row < sq ? lse[at] * kLog2e : 0.f;
    dr[h] = row < sq ? delta[at] : 0.f;
  }

  // kv tiles strictly right of the (offset) diagonal contribute nothing
  const int kv_end = causal ? min(sk, q0 + kB + offset) : sk;
  const int n_kt = kv_end > 0 ? (kv_end + kB - 1) / kB : 0;

  auto load_kv = [&](int t) {
    const uint32_t ks = ring + (t % kStages) * 2 * TILE, vs = ks + TILE;
    cp_tiles64<D>(ks, k + b * st.kb + hk * st.kh, st.ks, vs,
                  v + b * st.vb + hk * st.vh, st.vs, t * kB, sk, tid);
  };

  float dqa[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dqa[x] = 0.f;

  // groups in flight: Q, dO with kv tile 0, then kv tile 1 (each may be
  // empty)
  if (n_kt > 0) load_kv(0);
  cp_async_commit();
  if (n_kt > 1) load_kv(1);
  cp_async_commit();
  const float sl2 = scale * kLog2e;
  for (int t = 0; t < n_kt; ++t) {
    cp_async_wait<1>();   // Q, dO and kv tile t have landed
    fence_proxy_async();
    __syncthreads();      // ... for every thread; kv tile t - 1 is read
    if (t + 2 < n_kt) load_kv(t + 2);   // into kv tile t - 1's stage
    cp_async_commit();
    const int k0 = t * kB;
    const uint32_t ks = ring + (t % kStages) * 2 * TILE, vs = ks + TILE;

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
    wgmma_wait<0>();
    fence_operand(s);
    fence_operand(dp);

    // p = where(mask, exp(s * scale - lse), 0); ds = p (dp - delta) scale,
    // into s.  Only tiles on a ragged edge or the causal diagonal need the
    // compares
    const bool edge = q0 + kB > sq || k0 + kB > sk
                      || (causal && q0 + offset < k0 + kB - 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * (lane % 4) + e;
          const int x = 4 * j + 2 * h + e;
          float p = ex2(fmaf(s[x], sl2, -lr[h]));
          if (edge && !(row < sq && col < sk
                        && (!causal || row + offset >= col)))
            p = 0.f;
          s[x] = p * (dp[x] - dr[h]) * scale;
        }
    }
    uint32_t dsa[kB / 16][4];
#pragma unroll
    for (int kc = 0; kc < kB / 16; ++kc) a_slice(s, kc, dsa[kc]);

    // dQ += dS K, K MN-major
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kB / 16; ++kc)
      wgmma_rs<D>(dqa, dsa[kc], desc_sw128(ks + kc * 16 * 128, kB * 128,
                                           1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(dqa);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= sq) continue;
    __nv_bfloat16* out = dq + b * st.dqb + hq * st.dqh + row * st.dqs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + c) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * h], dqa[4 * j + 2 * h + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int heads, int group, int sq, int sk, Strides st,
                    int causal, float scale) {
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

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kB;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / group;
  const int offset = sk - sq;

  load_tile<T, D>(q + b * st.qb + hq * st.qh, st.qs, q0, sq, qs);
  load_tile<T, D>(dout + b * st.ob + hq * st.oh, st.os, q0, sq, dos);
  if (tid < kB) {
    const int row = q0 + tid;
    const int64_t at = ((int64_t)b * heads + hq) * sq + row;
    ls[tid] = row < sq ? lse[at] : 0.f;
    dls[tid] = row < sq ? delta[at] : 0.f;
  }
  const T* kb = k + b * st.kb + hk * st.kh;
  const T* vb = v + b * st.vb + hk * st.vh;

  float dqa[kR][DM];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int m = 0; m < DM; ++m) dqa[i][m] = 0.f;

  // kv tiles strictly right of the (offset) diagonal contribute nothing
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kB + offset);

  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D>(kb, st.ks, k0, sk, ks);
    load_tile<T, D>(vb, st.vs, k0, sk, vs);
    __syncthreads();

    float p[kR][kC], dp[kR][kC];
    tile_dot<D>(qs, ks, tx, ty, p);
    tile_dot<D>(dos, vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty * kR + i;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < sq && col < sk
                        && (!causal || row + offset >= col);
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
    if (row >= sq) continue;
    T* out = dq + b * st.dqb + hq * st.dqh + row * st.dqs;
#pragma unroll
    for (int m = 0; m < DM; ++m) out[tx + 16 * m] = from_float<T>(dqa[i][m]);
  }
}

template <int D>
constexpr int smem_bytes() {
  return (4 * kB * (D + 1) + kB * kPP + 2 * kB) * (int)sizeof(float);
}

Strides unpack(const int64_t* s) {
  return Strides{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],
                 s[7],  s[8],  s[9],  s[10], s[11], s[12], s[13],
                 s[14], s[15], s[16], s[17], s[18], s[19], s[20]};
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int batch,
                       int heads, int kv_heads, int sq, int sk,
                       const int64_t* st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + kB - 1) / kB, kv_heads, batch);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), heads, heads / kv_heads, sq,
      sk, unpack(st), causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             int batch, int heads, int kv_heads, int sq,
                             int sk, const int64_t* st, int causal,
                             float scale, cudaStream_t stream) {
  // K, V, a ring of Q and dO, lse and delta of every stage
  constexpr int smem = 1024 + (2 + 2 * kStages) * kB * D * 2
                       + kStages * 2 * kB * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + kB - 1) / kB, kv_heads, batch);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      heads, heads / kv_heads, sq, sk, unpack(st), causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int batch,
                            int heads, int kv_heads, int sq, int sk,
                            const int64_t* st, int causal, float scale,
                            cudaStream_t stream) {
  // Q, dO, a ring of K and V
  constexpr int smem = 1024 + (2 + 2 * kStages) * kB * D * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kB - 1) / kB, heads, batch);
  flash_bwd_dq_wgmma_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), heads, heads / kv_heads, sq, sk,
      unpack(st), causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int batch, int heads, int kv_heads, int sq,
                      int sk, const int64_t* st, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kB - 1) / kB, heads, batch);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), heads, heads / kv_heads, sq, sk, unpack(st),
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dout, dq (b, h, sq, d); k, v, dk, dv (b, kv_h, sk, d): any strides
// whose last dimension is contiguous, given in elements as
// [q, k, v, dout, dq, dk, dv] x [batch, head, seq].  lse and delta:
// contiguous (b, h, sq) f32.  dtype 0 = f32, 1 = bf16; dK/dV and dQ each
// take the tensor-core kernel for bf16 and the CUDA-core one for f32.
// Each returns cudaGetLastError() after its launch (0 = launched).
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            int batch, int heads, int kv_heads, int sq,
                            int sk, int head_dim, const int64_t* strides,
                            int causal, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1 && head_dim == 128)
    return launch_dkv_wgmma<128>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                                 kv_heads, sq, sk, strides, causal, scale,
                                 s);
  if (dtype == 1 && head_dim == 64)
    return launch_dkv_wgmma<64>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                                kv_heads, sq, sk, strides, causal, scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dkv<float, 128>(q, k, v, dout, l, dl, dk, dv, batch,
                                  heads, kv_heads, sq, sk, strides, causal,
                                  scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch_dkv<float, 64>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                                 kv_heads, sq, sk, strides, causal, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int batch, int heads,
                           int kv_heads, int sq, int sk, int head_dim,
                           const int64_t* strides, int causal, float scale,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1 && head_dim == 128)
    return launch_dq_wgmma<128>(q, k, v, dout, l, dl, dq, batch, heads,
                                kv_heads, sq, sk, strides, causal, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dq_wgmma<64>(q, k, v, dout, l, dl, dq, batch, heads,
                               kv_heads, sq, sk, strides, causal, scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dq<float, 128>(q, k, v, dout, l, dl, dq, batch, heads,
                                 kv_heads, sq, sk, strides, causal, scale,
                                 s);
  if (dtype == 0 && head_dim == 64)
    return launch_dq<float, 64>(q, k, v, dout, l, dl, dq, batch, heads,
                                kv_heads, sq, sk, strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
