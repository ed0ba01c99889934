// The tensor-core dK/dV pass of an FA2 attention backward, in pieces that
// the flash (flash_attention_bwd.cu) and FlashMask
// (flashmask_attention.cu) dK/dV kernels share; only the mask and the
// walk over q tiles differ between them.  One warpgroup (128 threads)
// owns a 64-row kv tile: K and V resident in shared memory, its dK and
// dV sums in registers (64 x D f32 each, the accumulator layout of
// hopper_wgmma.cuh), while 64-row q tiles (Q, dO) stream through a ring.
// Per q tile:
//   S^T = K Q^T, dP^T = V dO^T          dkv_scores (both operands shared)
//   P^T, dS^T from S^T, dP^T            the kernel's own mask and softmax
//   dV += P^T dO, dK += dS^T Q          dkv_accumulate (P^T, dS^T rounded
//                                       to bf16 as register A operands,
//                                       dO and Q read MN-major)
// Tiles are bf16, 64 rows x D (64 or 128), in the swizzled layout of
// hopper_wgmma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace hopper {

constexpr int kAttnRows = 64;   // rows of a q tile and of a kv tile

// rows row0 .. row0 + 63 of two (s, D) bf16 slabs at `a` and `b` (row
// strides `sa`, `sb` elements: K and V, or Q and dO, which share their
// rows) into the swizzled tiles at shared addresses `da` and `db`, by
// cp.async from the warpgroup's thread `tid`, one loop for both; rows at
// or past `valid` are written as zeros and read nothing
template <int D>
__device__ __forceinline__ void cp_tiles64(uint32_t da,
                                           const __nv_bfloat16* a,
                                           int64_t sa, uint32_t db,
                                           const __nv_bfloat16* b,
                                           int64_t sb, int row0, int valid,
                                           int tid) {
  constexpr int CH = D / 8;               // 16-byte chunks per row
  for (int idx = tid; idx < kAttnRows * CH; idx += 128) {
    const int r = idx / CH, c = idx % CH;
    const int row = row0 + r;
    const bool ok = row < valid;
    const int64_t at = ok ? row : 0;
    cp_async16(da + swizzled(r, c, kAttnRows), a + at * sa + c * 8, ok);
    cp_async16(db + swizzled(r, c, kAttnRows), b + at * sb + c * 8, ok);
  }
}

// S^T = K Q^T into p and dP^T = V dO^T into ds: kv rows x q columns, f32
template <int D>
__device__ __forceinline__ void dkv_scores(float (&p)[32], float (&ds)[32],
                                           uint32_t ks, uint32_t vs,
                                           uint32_t qs, uint32_t dos) {
#pragma unroll
  for (int x = 0; x < 32; ++x) p[x] = ds[x] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t at = (kk / 4) * kAttnRows * 128 + (kk % 4) * 32;
    wgmma_ss_n64(p, desc_sw128(ks + at, 16, 1024),
                 desc_sw128(qs + at, 16, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t at = (kk / 4) * kAttnRows * 128 + (kk % 4) * 32;
    wgmma_ss_n64(ds, desc_sw128(vs + at, 16, 1024),
                 desc_sw128(dos + at, 16, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(p);
  fence_operand(ds);
}

// dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 and fed as
// the register A operands, dO and Q read MN-major from their tiles
template <int D>
__device__ __forceinline__ void dkv_accumulate(float (&dva)[D / 2],
                                               float (&dka)[D / 2],
                                               const float (&p)[32],
                                               const float (&ds)[32],
                                               uint32_t qs, uint32_t dos) {
  uint32_t pa[kAttnRows / 16][4], dsa[kAttnRows / 16][4];
#pragma unroll
  for (int kc = 0; kc < kAttnRows / 16; ++kc) {
    a_slice(p, kc, pa[kc]);
    a_slice(ds, kc, dsa[kc]);
  }
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kAttnRows / 16; ++kc) {
    wgmma_rs<D>(dva, pa[kc], desc_sw128(dos + kc * 16 * 128,
                                        kAttnRows * 128, 1024), 1);
    wgmma_rs<D>(dka, dsa[kc], desc_sw128(qs + kc * 16 * 128,
                                         kAttnRows * 128, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(dva);
  fence_operand(dka);
}

// this thread's rows of dK and dV (kv rows k0 + 16 warp + lane / 4 +
// {0, 8} below sk), each cast once to bf16; dk and dv point at the
// (batch, kv head) slab, dks and dvs their row strides
template <int D>
__device__ __forceinline__ void dkv_store(const float (&dka)[D / 2],
                                          const float (&dva)[D / 2],
                                          __nv_bfloat16* dk, int64_t dks,
                                          __nv_bfloat16* dv, int64_t dvs,
                                          int k0, int sk, int tid) {
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= sk) continue;
    __nv_bfloat16* kout = dk + row * dks;
    __nv_bfloat16* vout = dv + row * dvs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(kout + c) =
          __floats2bfloat162_rn(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vout + c) =
          __floats2bfloat162_rn(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

}  // namespace hopper
