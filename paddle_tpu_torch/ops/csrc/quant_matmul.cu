// Int8 quantized matmuls for Hopper (sm_90a): weight-only (w8) and w8a8.
//
// Replaces: paddle_tpu/ops/pallas/quant_matmul.py `_wo_kernel` (launched
// by `weight_only_matmul_pallas`) and `_w8a8_kernel` (launched by
// `w8a8_matmul_pallas`).  The weight keeps the port's Linear layout
// [N, K], K contiguous (the JAX twin is its transpose, [K, N]).
//
//   w8:    y[m, n] = T((sum_k x[m, k] * T(w[n, k])) * scale[n]), the sum in
//          f32, the per-column scale applied once after the last k.
//   w8a8:  y[m, n] = T(float(sum_k xq[m, k] * w[n, k]) * xs[m] * scale[n]),
//          the sum exact in s32, the epilogue in that order of products,
//          so the result is bit-equal to any exact s32 sum.
//
// What bounds them on the H100: at decode (M = the ragged step's rows, a
// handful) each weight byte feeds M multiply-adds, so both are bound by
// the bytes of the int8 weight (half of bf16's); at prefill (M in the
// thousands) by operations.  What the design does about that, per regime
// and type:
//
//   w8 with bf16 x (the serving path) runs on the tensor cores, the int8
//   weight converted exactly to bf16 (integer/float bit tricks, no I2F),
//   and the kernel is chosen by shape (`launch_wo_bf16`):
//   - M <= 16 (decode): mma.sync m16n8k16, bound by the weight's bytes.
//     A block owns 16 output columns, its 8 warps split K and meet in
//     shared memory, every lane streams 16-byte weight loads with the
//     next block's loads issued before the current block's products.
//   - M > 16 and K % 16 == 0 (prefill, chunked prefill, ragged steps
//     above 16 rows; every Linear of llama_7b): wgmma, `wo_wgmma_kernel`,
//     bound by operations.  256-feature x 128-token output tiles; x and
//     the raw int8 weight tiles arrive by TMA in a ring, and four
//     warpgroups convert their weight rows in registers and multiply
//     them as wgmma's register A operand against x from shared memory.
//   - M > 16 and K % 16 != 0 (weight rows TMA cannot copy: its rows must
//     be 16-byte aligned): mma.sync 128 x 128 tiles staged element by
//     element.
//   w8a8 (either output type: it changes only the epilogue) runs on the
//   tensor cores with no conversion, chosen by shape (`launch_w8a8`):
//   - M <= 16: mma.sync m16n8k32 s8 -> s32, the skinny blocking above
//     (the int8 bytes are the fragments), bound by the weight's bytes;
//   - M > 16 and K % 16 == 0: wgmma m64nTk32 s8 -> s32,
//     `w8a8_wgmma_kernel`, bound by operations at prefill: 128-feature x
//     T-token tiles, T by M, both int8 operands by TMA through a ring
//     that a producer warp keeps full, one product group in flight, K
//     split over blocks where the tiles are few;
//   - M > 16 and K % 16 != 0: mma.sync 128 x 128 tiles staged element by
//     element.
//
//   w8 with f32 x runs on the CUDA cores (the tensor cores have no f32
//   product), 128 x 128 tiles of f32 FMAs, 8 x 8 outputs per thread, at
//   every M: no serving workload runs f32, so its decode is not tuned.
#include <cuda.h>            // CUtensorMap (the encoder comes from the runtime)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;    // tiled: output tile edge

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

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float byte_to_float(uint32_t word, int b) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * b)) & 0xffu));
}

// 16 int8 of a K-contiguous row from column k; bytes past K read as 0.
// VEC: K % 16 == 0 and the row 16-byte aligned, so k < K means k + 16 <= K.
template <bool VEC>
__device__ __forceinline__ uint4 load_i8x16(const int8_t* row, int k, int K) {
  if (VEC) {
    if (k < K) return __ldg(reinterpret_cast<const uint4*>(row + k));
    return make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (k + e < K)
      w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[k + e]))
                  << (8 * (e % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 floats of a K-contiguous row from column k; past K read as 0.
template <bool VEC>
__device__ __forceinline__ void load_row8(const float* row, int k, int K,
                                          float* dst) {
  if (VEC && k < K) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + k));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + k) + 1);
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = (k + e < K) ? row[k + e] : 0.f;
}

// ------------------------------------------------- w8, skinny, bf16 mma
// bf16 x at M <= 16 on the tensor cores: mma.sync m16n8k16 (bf16 in,
// f32 accumulate; int8 -> bf16 is exact, so are the products).  Warp w of
// the block takes the 64-k blocks w, w + 8, ... of the block's 16 output
// columns (two n8 tiles); the 8 warps' partial sums meet in shared memory.
// Lane (g, t) = (lane / 4, lane % 4) loads 16 bytes of weight row g of
// each tile at k = kb + 16 t, and the 16 x values of rows g and g + 8 at
// the same k.  The k order inside a 64-block is permuted identically for
// both operands — mma step j gives lane (g, t) the k pairs kb + 16 t + 4 j
// + {0, 1} and {2, 3} — so each lane's fragments come from its own loads.
constexpr int kMmaTiles = 2;               // n8 tiles per block

// four int8 (one word) -> two bf16x2, exactly: the biased byte becomes the
// low mantissa bits of 2^23, subtracting 2^23 + 128 leaves the integer
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t word, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440))
                   - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441))
                   - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442))
                   - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443))
                   - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bf16 of x row m from column k as 8 words (bf16 pairs); zeros past M/K
template <bool VEC>
__device__ __forceinline__ void load_x16(const __nv_bfloat16* x, int m,
                                         int M, int k, int K, uint32_t* w) {
  if (m >= M || k >= K) {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0u;
    return;
  }
  const __nv_bfloat16* row = x + (size_t)m * K;
  if (VEC) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + k));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(row + k) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    return;
  }
  const uint16_t* r16 = reinterpret_cast<const uint16_t*>(row);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t lo = k + 2 * i < K ? r16[k + 2 * i] : 0u;
    const uint32_t hi = k + 2 * i + 1 < K ? r16[k + 2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
wo_mma_skinny_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  __shared__ float part[kWarps][kMmaTiles][32][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kMmaTiles * 8;

  float d[kMmaTiles][4];
#pragma unroll
  for (int i = 0; i < kMmaTiles; ++i)
    d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;

  auto load_w = [&](int kb, uint4* dst) {
#pragma unroll
    for (int i = 0; i < kMmaTiles; ++i) {
      const int n = n0 + 8 * i + g;
      dst[i] = n < N ? load_i8x16<VEC>(w + (size_t)n * K, kb + 16 * t, K)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  uint4 cur[kMmaTiles], nxt[kMmaTiles];
  load_w(warp * 64, cur);
  for (int kb = warp * 64; kb < K; kb += kWarps * 64) {
    load_w(kb + kWarps * 64, nxt);        // the next block's weights
    uint32_t xa[8], xb[8];                // rows g and g + 8
    load_x16<VEC>(x, g, M, kb + 16 * t, K, xa);
    load_x16<VEC>(x, g + 8, M, kb + 16 * t, K, xb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < kMmaTiles; ++i) {
        uint32_t b0, b1;
        i8x4_to_bf16x2(word_of(cur[i], j), b0, b1);
        mma_bf16(d[i], xa[2 * j], xb[2 * j], xa[2 * j + 1], xb[2 * j + 1],
                 b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < kMmaTiles; ++i) cur[i] = nxt[i];
  }

  // d[i][0..1]: row g, columns 2t, 2t + 1 of tile i; d[i][2..3]: row g + 8
#pragma unroll
  for (int i = 0; i < kMmaTiles; ++i) {
    part[warp][i][lane][0] = d[i][0];
    part[warp][i][lane][1] = d[i][1];
  }
  float hi[kMmaTiles][2];
#pragma unroll
  for (int i = 0; i < kMmaTiles; ++i) hi[i][0] = d[i][2], hi[i][1] = d[i][3];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kMmaTiles; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) v += part[ww][i][lane][c];
        const int n = n0 + 8 * i + 2 * t + c;
        if (g < M && n < N)
          y[(size_t)g * N + n] = from_float<__nv_bfloat16>(v * scale[n]);
      }
  }
  if (M <= 8) return;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMmaTiles; ++i) {
    part[warp][i][lane][0] = hi[i][0];
    part[warp][i][lane][1] = hi[i][1];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kMmaTiles; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) v += part[ww][i][lane][c];
        const int n = n0 + 8 * i + 2 * t + c;
        if (g + 8 < M && n < N)
          y[(size_t)(g + 8) * N + n] =
              from_float<__nv_bfloat16>(v * scale[n]);
      }
  }
}

// -------------------------------------------------------- w8, f32, tiled
// Thread (tx, ty) of 16 x 16 owns rows ty*4 + {0..3, 64..67} and columns
// tx*4 + {0..3, 64..67} of the tile: float4 reads of the staged tiles.
__device__ __forceinline__ int tile_idx(int t, int i) {
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
wo_tiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ y,
                int M, int N, int K) {
  constexpr int BK = 16;
  __shared__ __align__(16) float as[BK][kTile + 4];
  __shared__ __align__(16) float bs[BK][kTile + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int r = tid >> 1, kb = (tid & 1) * 8;   // staging: row r, k kb..+8
  const int m = m0 + r, n = n0 + r;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    float xv[8], wv[8];
    if (m < M) {
      load_row8<VEC>(x + (size_t)m * K, k0 + kb, K, xv);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) xv[e] = 0.f;
    }
    if (n < N) {
      const int8_t* row = w + (size_t)n * K;
      const int k = k0 + kb;
      if (VEC && k < K) {
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row + k));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          wv[e] = byte_to_float(raw.x, e);
          wv[4 + e] = byte_to_float(raw.y, e);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wv[e] = (k + e < K) ? static_cast<float>(row[k + e]) : 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) wv[e] = 0.f;
    }
    __syncthreads();   // the previous tile's readers are done
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      as[kb + e][r] = xv[e];
      bs[kb + e][r] = wv[e];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int mm = m0 + tile_idx(ty, i);
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nn = n0 + tile_idx(tx, j);
      if (nn < N) y[(size_t)mm * N + nn] = acc[i][j] * scale[nn];
    }
  }
}

// -------------------------------------------------- w8, tiled, bf16 mma
// bf16 x at M > 16 with K % 16 != 0 (weight rows that TMA cannot copy;
// every other bf16 call above 16 rows takes wo_wgmma_kernel): a
// 128 x 128 output tile per block, 8 warps of 64 x 32 (4 m16 x 4 n8
// mma.sync tiles each), k tiles of 32 staged in shared memory as bf16 (the
// weight converted exactly while staged), element by element.  Rows of 40
// bf16 (80 bytes) make the fragment reads conflict-free.
constexpr int kMmaBK = 32;
constexpr int kMmaLd = kMmaBK + 8;

__global__ void __launch_bounds__(kThreads)
wo_mma_tiled_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) uint16_t xs[kTile][kMmaLd];
  __shared__ __align__(16) uint16_t ws[kTile][kMmaLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // warp tile
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;

  float d[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[i][j][0] = d[i][j][1] = d[i][j][2] = d[i][j][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    // x: 128 rows x 32 k = 512 pieces of 8 bf16, two per thread
    uint4 xr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = tid + h * kThreads, r = p >> 2, c = (p & 3) * 8;
      const int m = m0 + r, k = k0 + c;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (m < M) {
        const uint16_t* r16 =
            reinterpret_cast<const uint16_t*>(x + (size_t)m * K);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (k + e < K)
            v[e / 2] |= static_cast<uint32_t>(r16[k + e]) << (16 * (e & 1));
      }
      xr[h] = make_uint4(v[0], v[1], v[2], v[3]);
    }
    // w: 128 rows x 32 k = 256 pieces of 16 int8, one per thread
    const int wr = tid >> 1, wc = (tid & 1) * 16;
    const uint4 wraw = n0 + wr < N
        ? load_i8x16<false>(w + (size_t)(n0 + wr) * K, k0 + wc, K)
        : make_uint4(0u, 0u, 0u, 0u);
    uint32_t wb[8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      i8x4_to_bf16x2(word_of(wraw, q), wb[2 * q], wb[2 * q + 1]);
    __syncthreads();   // the previous tile's readers are done
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = tid + h * kThreads, r = p >> 2, c = (p & 3) * 8;
      *reinterpret_cast<uint4*>(&xs[r][c]) = xr[h];
    }
    *reinterpret_cast<uint4*>(&ws[wr][wc]) =
        make_uint4(wb[0], wb[1], wb[2], wb[3]);
    *reinterpret_cast<uint4*>(&ws[wr][wc + 8]) =
        make_uint4(wb[4], wb[5], wb[6], wb[7]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + 16 * i + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 2 * t]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 2 * t]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 8 + 2 * t]);
        a[i][3] =
            *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 8 + 2 * t]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + 8 * j + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&ws[c][kk + 2 * t]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&ws[c][kk + 8 + 2 * t]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(d[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0],
                   b[j][1]);
    }
  }

  // d[i][j][0..1]: row wm + 16 i + g, columns wn + 8 j + 2 t + {0, 1};
  // d[i][j][2..3]: the same columns of row + 8
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn + 8 * j + 2 * t + c;
          if (n < N)
            y[(size_t)m * N + n] =
                from_float<__nv_bfloat16>(d[i][j][2 * h + c] * scale[n]);
        }
    }
}

// ------------------------------------------------------ w8, bf16 wgmma
// bf16 x at M > 16 with K % 16 == 0, on wgmma: a block computes a
// 256-feature x 128-token output tile in K steps of 64 as Y^T += W X^T,
// the weight the A operand from registers and x the B operand from
// shared memory, as CUTLASS's mixed-input GEMMs do:
// - TMA copies each step's x tile (128 tokens x 64 k, 128-byte swizzle,
//   straight into wgmma's K-major layout) and raw int8 weight tile (256
//   features x 64 bytes) into a ring of kWoStages stages; thread 0
//   refills a stage once every warpgroup has released it, kWoStages - 1
//   steps ahead of its own warpgroup;
// - each of the four warpgroups owns 64 features: per 16-k slice every
//   thread reads the 4 weight bytes of its A fragment for each of its two
//   rows (one 16-byte shared load per row, shared by four lanes),
//   converts them exactly to bf16 in registers (i8x4_to_bf16x2) and
//   issues wgmma m64 x n128 x k16 with A from registers, B K-major.  The
//   converted weight never goes through shared memory, and the
//   conversion is spread over all 512 threads;
// - the 64 x 128 f32 accumulator (features x tokens) stays in registers;
//   a warpgroup waits for its own products before it converts the next
//   step (the A registers must not change under an issued wgmma), while
//   the other three keep the tensor cores busy.
// TMA zero-fills tokens past M, features past N and k past K; it needs
// 16-byte weight rows (K % 16 == 0).  The epilogue multiplies by
// scale[n] in f32 and rounds to bf16 once, as the plain version does.
// Where the output tiles would fill less than half of the SMs (short
// prompts: 16 tiles at 128 tokens x 4096 features), K is split over
// gridDim.z blocks (`wo_splits`); each writes f32 partial sums and
// wo_splitk_reduce_kernel adds them in split order (deterministic), then
// scales and rounds.
constexpr int kWoBF = 256;                 // features of a block
constexpr int kWoBT = 128;                 // tokens of a block
constexpr int kWoBK = 64;                  // k of a step
constexpr int kWoStages = 6;
constexpr int kWoXT = kWoBT * 128;         // x stage, bytes
constexpr int kWoWR = kWoBF * kWoBK;       // raw int8 weight stage, bytes
// the ring, and a full and an empty barrier per stage
constexpr int kWoSmem = 1024 + kWoStages * (kWoXT + kWoWR)
                        + 2 * kWoStages * 8;

__global__ void __launch_bounds__(512, 1)
wo_wgmma_kernel(__grid_constant__ const CUtensorMap x_map,
                __grid_constant__ const CUtensorMap w_map,
                const float* __restrict__ scale,
                __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                int M, int N, int K) {
  using namespace hopper;
  constexpr int S = kWoStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t xs = (raw0 + 1023) & ~1023u;
  const uint32_t wr = xs + S * kWoXT;
  const uint32_t bars = wr + S * kWoWR;
  const uint8_t* const wr_ptr = smem_raw + (wr - raw0);
  // full[s]: stage s landed; empty[s]: every warpgroup multiplied it
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kWoBF, m0 = blockIdx.y * kWoBT;
  // this block's K steps (all of them unless K is split over blockIdx.z);
  // t counts them from 0
  const int steps = (K + kWoBK - 1) / kWoBK;
  const int k0 = blockIdx.z * steps / gridDim.z * kWoBK;
  const int nk = (blockIdx.z + 1) * steps / gridDim.z - k0 / kWoBK;
  const void* const xm = &x_map;   // the maps stay in parameter space
  const void* const wm = &w_map;
  auto issue = [&](int t) {
    const int s = t % S;
    mbar_arrive_expect_tx(full(s), kWoXT + kWoWR);
    tma_load_2d(xs + s * kWoXT, xm, full(s), k0 + t * kWoBK, m0);
    tma_load_2d(wr + s * kWoWR, wm, full(s), k0 + t * kWoBK, n0);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    fence_mbar_init();
    for (int t = 0; t < S && t < nk; ++t) issue(t);
  }
  __syncthreads();

  // this thread's A fragment: weight rows r and r + 8 of the warpgroup's
  // 64, k bytes 2q, 2q + 1 (-> a[0], a[1]) and 2q + 8, 2q + 9 (-> a[2],
  // a[3]) of each 16-byte slice
  const int r = 64 * wg + 16 * warp + lane / 4, q = lane % 4;
  const uint32_t pick = (q & 1) ? 0x7632u : 0x5410u;
  float acc[kWoBT / 2];
#pragma unroll
  for (int i = 0; i < kWoBT / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < nk; ++t) {
    const int s = t % S;
    mbar_wait(full(s), (t / S) & 1);
    const uint8_t* wrow = wr_ptr + s * kWoWR + r * kWoBK;
    uint32_t a[kWoBK / 16][4];
#pragma unroll
    for (int kc = 0; kc < kWoBK / 16; ++kc) {
      const uint4 v0 = *reinterpret_cast<const uint4*>(wrow + 16 * kc);
      const uint4 v1 = *reinterpret_cast<const uint4*>(wrow + 8 * kWoBK
                                                       + 16 * kc);
      i8x4_to_bf16x2(__byte_perm(q < 2 ? v0.x : v0.y, q < 2 ? v0.z : v0.w,
                                 pick), a[kc][0], a[kc][2]);
      i8x4_to_bf16x2(__byte_perm(q < 2 ? v1.x : v1.y, q < 2 ? v1.z : v1.w,
                                 pick), a[kc][1], a[kc][3]);
    }
    const uint32_t xb = xs + s * kWoXT;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kWoBK / 16; ++kc)
      wgmma_rs_n128<0>(acc, a[kc], desc_sw128(xb + 32 * kc, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    // stage s is read: released by each warpgroup.  Thread 0 refills the
    // stage of step t - 1, which the other warpgroups have most likely
    // released by now, with step t - 1 + S
    if (tid % 128 == 0) mbar_arrive(empty(s));
    if (tid == 0 && t >= 1 && t - 1 + S < nk) {
      mbar_wait(empty((t - 1) % S), ((t - 1) / S) & 1);
      issue(t - 1 + S);
    }
    __syncwarp();
  }

  // acc[4 j + 2 h + e]: feature r + 8 h, token 8 j + 2 q + e.  A split
  // block writes its f32 partial sums, which wo_splitk_reduce_kernel adds
  float* const out = part ? part + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + r + 8 * h;
    if (n >= N) continue;
    const float sc = scale[n];
#pragma unroll
    for (int j = 0; j < kWoBT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * q + e;
        if (m >= M) continue;
        const float v = acc[4 * j + 2 * h + e];
        if (out)
          out[(size_t)m * N + n] = v;
        else
          y[(size_t)m * N + n] = __float2bfloat16(v * sc);
      }
  }
}

// y = bf16(scale[n] * sum of the splits' partial sums, in split order)
__global__ void __launch_bounds__(kThreads)
wo_splitk_reduce_kernel(const float* __restrict__ part,
                        const float* __restrict__ scale,
                        __nv_bfloat16* __restrict__ y, int M, int N,
                        int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += part[z * total + i];
    y[i] = __float2bfloat16(v * scale[i % N]);
  }
}

// ---------------------------------------------------- w8a8, s8 mma.sync
// mma.sync m16n8k32 s8 x s8 -> s32 on the tensor cores, the same block
// shapes as the bf16 w8 kernels and no conversion: the fragments are the
// int8 bytes themselves.  Skinny (M <= 16): lane (g, t) loads 16 bytes of
// weight row g of each n8 tile and of x rows g, g + 8 at k = kb + 16 t;
// step j of a 64-block takes words 2 j and 2 j + 1 of them, the same k
// permutation for both operands.  Tiled (M > 16 with K % 16 != 0, rows
// that TMA cannot copy; every other call above 16 rows takes
// w8a8_wgmma_kernel): 128 x 128 tiles, k tiles of 64 bytes staged
// element by element in shared memory (rows of 80 bytes: conflict-free).
__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
w8a8_mma_skinny_kernel(const int8_t* __restrict__ xq,
                       const float* __restrict__ xscale,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale, T* __restrict__ y,
                       int M, int N, int K) {
  __shared__ int part[kWarps][kMmaTiles][32][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kMmaTiles * 8;

  int d[kMmaTiles][4];
#pragma unroll
  for (int i = 0; i < kMmaTiles; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0;

  auto load_w = [&](int kb, uint4* dst) {
#pragma unroll
    for (int i = 0; i < kMmaTiles; ++i) {
      const int n = n0 + 8 * i + g;
      dst[i] = n < N ? load_i8x16<VEC>(w + (size_t)n * K, kb + 16 * t, K)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  uint4 cur[kMmaTiles], nxt[kMmaTiles];
  load_w(warp * 64, cur);
  for (int kb = warp * 64; kb < K; kb += kWarps * 64) {
    load_w(kb + kWarps * 64, nxt);
    const int k = kb + 16 * t;
    const uint4 xa = g < M ? load_i8x16<VEC>(xq + (size_t)g * K, k, K)
                           : make_uint4(0u, 0u, 0u, 0u);
    const uint4 xb = g + 8 < M
        ? load_i8x16<VEC>(xq + (size_t)(g + 8) * K, k, K)
        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < kMmaTiles; ++i)
        mma_s8(d[i], word_of(xa, 2 * j), word_of(xb, 2 * j),
               word_of(xa, 2 * j + 1), word_of(xb, 2 * j + 1),
               word_of(cur[i], 2 * j), word_of(cur[i], 2 * j + 1));
#pragma unroll
    for (int i = 0; i < kMmaTiles; ++i) cur[i] = nxt[i];
  }

#pragma unroll
  for (int i = 0; i < kMmaTiles; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[warp][i][lane][c] = d[i][c];
  __syncthreads();
  if (warp != 0) return;
  // d[i][0..1]: row g, columns 2t, 2t + 1 of tile i; d[i][2..3]: row g + 8
#pragma unroll
  for (int i = 0; i < kMmaTiles; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int v = 0;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) v += part[ww][i][lane][c];
      const int m = g + 8 * (c >> 1), n = n0 + 8 * i + 2 * t + (c & 1);
      if (m < M && n < N)
        y[(size_t)m * N + n] =
            from_float<T>(static_cast<float>(v) * xscale[m] * scale[n]);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
w8a8_mma_tiled_kernel(const int8_t* __restrict__ xq,
                      const float* __restrict__ xscale,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale, T* __restrict__ y,
                      int M, int N, int K) {
  constexpr int BK = 64, LD = BK + 16;
  __shared__ __align__(16) int8_t xs[kTile][LD];
  __shared__ __align__(16) int8_t ws[kTile][LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;

  int d[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[i][j][0] = d[i][j][1] = d[i][j][2] = d[i][j][3] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 128 rows x 64 bytes of each operand: two 16-byte pieces per thread
    uint4 xr[2], wr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = tid + h * kThreads, r = p >> 2, c = (p & 3) * 16;
      xr[h] = m0 + r < M
          ? load_i8x16<false>(xq + (size_t)(m0 + r) * K, k0 + c, K)
          : make_uint4(0u, 0u, 0u, 0u);
      wr[h] = n0 + r < N
          ? load_i8x16<false>(w + (size_t)(n0 + r) * K, k0 + c, K)
          : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();   // the previous tile's readers are done
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = tid + h * kThreads, r = p >> 2, c = (p & 3) * 16;
      *reinterpret_cast<uint4*>(&xs[r][c]) = xr[h];
      *reinterpret_cast<uint4*>(&ws[r][c]) = wr[h];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + 16 * i + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 4 * t]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 4 * t]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 16 + 4 * t]);
        a[i][3] =
            *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + 8 * j + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&ws[c][kk + 4 * t]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&ws[c][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(d[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0],
                 b[j][1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      const float xsm = xscale[m];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn + 8 * j + 2 * t + c;
          if (n < N)
            y[(size_t)m * N + n] = from_float<T>(
                static_cast<float>(d[i][j][2 * h + c]) * xsm * scale[n]);
        }
    }
}

// ------------------------------------------------------ w8a8, s8 wgmma
// M > 16 with K % 16 == 0 (every Linear of a prefill, a chunked prefill
// or a ragged step above 16 rows): wgmma m64 x nT x k32 s8 x s8 -> s32,
// computing Y^T = W X^T as wo_wgmma_kernel does, the weight's features
// wgmma's M (the A operand) and the tokens its N (the B operand), both
// K-major straight from TMA's 128-byte-swizzled tiles; no conversion and
// no register operand:
// - a block owns 128 features x T tokens, T = 32, 64, 128 or 256 by M
//   (`w8a8_tile`), so 17-64-row calls do not multiply padding and 1024-row
//   prefill takes the widest product (m64n256k32 reads 80 bytes of shared
//   memory per 128 cycles of the tensor cores, m64n128k32 96);
// - a producer warp (warp 8; one lane issues) keeps a ring of S stages of
//   128 k (128 bytes of every weight and token row) in flight by TMA,
//   each stage guarded by a full and an empty mbarrier; S as deep as 227
//   KB of shared memory allows (4 at T = 256, 8 at T <= 64);
// - two consumer warpgroups each own 64 features and a 64 x T s32
//   accumulator in registers; per stage they issue four k32 products,
//   commit them, and wait only for the previous stage's group
//   (wgmma_wait<1>), then release that stage: no register changes under
//   an issued product, so one group stays in flight across the loop;
// - where the output tiles fill less than half of the SMs (short prompts
//   at N 4096), K is split over gridDim.z (`w8a8_splits`); each split
//   writes its exact s32 sums to a workspace and
//   w8a8_splitk_reduce_kernel adds them (integer sums: any order is
//   exact) and applies the one epilogue.
// TMA zero-fills tokens past M, features past N and k past K (zeros add
// nothing to an integer sum); it needs 16-byte rows (K % 16 == 0).  The
// epilogue is float(acc) * xs[m] * scale[n] in that order, as the plain
// version, so the result is bit-equal to it split or not.
constexpr int kQF = 128;                   // features of a block
constexpr int kQK = 128;                   // k (bytes) of a stage
constexpr int kQThreads = 288;             // two consumer warpgroups + a warp

template <int T>
struct W8a8Tile {
  static constexpr int kStages = T == 256 ? 4 : T == 128 ? 6 : 8;
  static constexpr int kW = kQF * kQK;      // weight stage, bytes
  static constexpr int kX = T * kQK;        // token stage, bytes
  static constexpr int kSmem = 1024 + kStages * (kW + kX) + 2 * kStages * 8;
};

template <typename T, int TT>
__global__ void __launch_bounds__(kQThreads, 1)
w8a8_wgmma_kernel(__grid_constant__ const CUtensorMap x_map,
                  __grid_constant__ const CUtensorMap w_map,
                  const float* __restrict__ xscale,
                  const float* __restrict__ scale, T* __restrict__ y,
                  int* __restrict__ part, int M, int N, int K) {
  using namespace hopper;
  using C = W8a8Tile<TT>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ws = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t xs = ws + S * C::kW;
  const uint32_t bars = xs + S * C::kX;
  // full[s]: stage s landed; empty[s]: both warpgroups multiplied it
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };

  const int tid = threadIdx.x, wg = tid / 128;
  // token tiles along x: the blocks that share a weight tile run side by
  // side, so the weight (the bytes that bound the call at small M) comes
  // from device memory once and the few-MB activations stay in L2
  const int m0 = blockIdx.x * TT, n0 = blockIdx.y * kQF;
  // this block's K steps (all of them unless K is split over blockIdx.z)
  const int steps = (K + kQK - 1) / kQK;
  const int kt0 = blockIdx.z * steps / gridDim.z;
  const int nk = (blockIdx.z + 1) * steps / gridDim.z - kt0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {                 // the producer warp
    if (tid == 2 * 128) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty(s), (t / S - 1) & 1);
        mbar_arrive_expect_tx(full(s), C::kW + C::kX);
        const int k = (kt0 + t) * kQK;
        tma_load_2d(ws + s * C::kW, &w_map, full(s), k, n0);
        tma_load_2d(xs + s * C::kX, &x_map, full(s), k, m0);
      }
    }
    return;
  }

  uint32_t acc[TT / 2];
#pragma unroll
  for (int i = 0; i < TT / 2; ++i) acc[i] = 0u;
  fence_operand(acc);
  const uint32_t wa = ws + wg * 64 * kQK;   // this warpgroup's 64 features
  for (int t = 0; t < nk; ++t) {
    const int s = t % S;
    mbar_wait(full(s), (t / S) & 1);
    const uint32_t a = wa + s * C::kW, b = xs + s * C::kX;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kQK / 32; ++kc)
      wgmma_ss_s8<TT>(acc, desc_sw128(a + 32 * kc, 16, 1024),
                      desc_sw128(b + 32 * kc, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();             // the products of step t - 1 are done
    if (t > 0 && tid % 128 == 0) mbar_arrive(empty((t - 1) % S));
  }
  wgmma_wait<0>();
  fence_operand(acc);

  // acc[4 j + 2 h + e]: feature r + 8 h, token 8 j + 2 q + e.  A split
  // block writes its s32 sums, which w8a8_splitk_reduce_kernel adds
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r = 64 * wg + 16 * warp + lane / 4, q = lane % 4;
  int* const out = part ? part + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + r + 8 * h;
    if (n >= N) continue;
    const float sc = scale[n];
#pragma unroll
    for (int j = 0; j < TT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * q + e;
        if (m >= M) continue;
        const int v = static_cast<int>(acc[4 * j + 2 * h + e]);
        if (out)
          out[(size_t)m * N + n] = v;
        else
          y[(size_t)m * N + n] =
              from_float<T>(static_cast<float>(v) * xscale[m] * sc);
      }
  }
}

// y = T(float(sum of the splits' s32 sums) * xs[m] * scale[n]); the
// integer sum is exact in any order
template <typename T>
__global__ void __launch_bounds__(kThreads)
w8a8_splitk_reduce_kernel(const int* __restrict__ part,
                          const float* __restrict__ xscale,
                          const float* __restrict__ scale, T* __restrict__ y,
                          int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    int v = 0;
    for (int z = 0; z < splits; ++z) v += part[z * total + i];
    y[i] = from_float<T>(static_cast<float>(v) * xscale[i / N]
                         * scale[i % N]);
  }
}

// ------------------------------------------------------- activation quant
// dynamic_act_quant (XLA ops in the JAX package, quant_matmul.py:159: the
// prologue of w8a8 and the KV pages' quantizer).  Per row of K elements:
// scale = max(absmax, 1e-30) / 127 and q = clamp(rint(x / scale), -127,
// 127), IEEE division and round half to even, bit-equal to the torch ops
// of `dynamic_act_quant_plain` in f32 and bf16.
//
// What bounds it on the H100: bytes.  Each element is read once and its
// code written once (3 bytes in bf16, 5 in f32), microseconds at most.
// The design moves exactly those bytes: a row is read from device memory
// once, in 16-byte vectors, and kept in registers between the absmax and
// the quantize steps; the codes go out a vector's worth at a time (8 bytes
// for bf16, 4 for f32).  The kernel is chosen by row shape, from the plan
// the wrapper passes (`act_quant_plan` in ops/quant_matmul.py):
//   - rows of at most 1024 elements (the K/V rows' 128): a group of G
//     lanes per row, G a power of two <= 32 giving each lane one vector,
//     or two where one would ask for more blocks than the card holds at
//     once (a prefill's K/V rows), so several rows share a warp and
//     128 / G rows a block; the absmax by xor shuffles inside the group
//     (`act_quant_group_kernel`);
//   - longer rows (the activations' 4096 and 11008): one block per row,
//     each thread VPT = 1, 2 or 4 vectors, the fewest that keep the block
//     at 256 threads or less where 4 allow it (4096: 256 x 2; 11008:
//     352 x 4); the absmax by shuffles and one pass over the warps'
//     maxima in shared memory (`act_quant_row_kernel<T, VPT>`).  The
//     block shapes are the plan's constants, timed beside other values
//     by chip_smoke.py (`act_quant_plan_sweep`);
//   - rows that are not 16-byte aligned, or too long for a block's
//     registers: a scalar edge, a block per row that reads its row twice,
//     the second time from L2 (`act_quant_edge_kernel`).
// Row r of x starts at (r / inner) * s_outer + (r % inner) * s_inner
// elements, so a strided view of (outer, inner, K) — the v slice of a
// fused q|k|v output — quantizes without a copy; codes and scales are
// written contiguously, row r at r * K and r.
constexpr int kActGroupThreads = 128;   // act_quant_group_kernel's block
constexpr int kActMaxVecs = 4;          // vectors a thread of the row kernel
constexpr int kActMaxThreads = 1024;

__device__ __forceinline__ int64_t act_row_offset(int r, int inner,
                                                  int64_t s_outer,
                                                  int64_t s_inner) {
  if (inner == 1) return static_cast<int64_t>(r) * s_outer;  // no division
  return static_cast<int64_t>(r / inner) * s_outer
         + static_cast<int64_t>(r % inner) * s_inner;
}

// the elements of one 16-byte vector as floats (bf16 -> f32 is exact)
template <typename T> struct ActVec;
template <> struct ActVec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
};
template <> struct ActVec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& v, float* f) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t w = word_of(v, q);
      f[2 * q] = __uint_as_float(w << 16);
      f[2 * q + 1] = __uint_as_float(w & 0xffff0000u);
    }
  }
};

template <typename T>
__device__ __forceinline__ float vec_absmax(const uint4& v, float amax) {
  float f[ActVec<T>::N];
  ActVec<T>::unpack(v, f);
#pragma unroll
  for (int e = 0; e < ActVec<T>::N; ++e) amax = fmaxf(amax, fabsf(f[e]));
  return amax;
}

__device__ __forceinline__ uint32_t act_code(float x, float scale) {
  const float q = fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

// one vector's codes, stored at once (dst aligned to their size)
template <typename T>
__device__ __forceinline__ void vec_quantize_store(const uint4& v,
                                                   float scale,
                                                   int8_t* dst) {
  constexpr int N = ActVec<T>::N;
  float f[N];
  ActVec<T>::unpack(v, f);
  uint32_t w[N / 4];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) w[i] = 0u;
#pragma unroll
  for (int e = 0; e < N; ++e)
    w[e / 4] |= act_code(f[e], scale) << (8 * (e % 4));
  if constexpr (N == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = w[0];
}

template <typename T>
__global__ void __launch_bounds__(kActGroupThreads)
act_quant_group_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                       float* __restrict__ xs, int rows, int K, int G,
                       int inner, int64_t s_outer, int64_t s_inner) {
  constexpr int N = ActVec<T>::N;
  constexpr int VPT = 1024 / N / 32;      // a 1024-element row over 32 lanes
  const int tid = threadIdx.x;
  const int gl = tid & (G - 1);
  const int row = blockIdx.x * (kActGroupThreads / G) + tid / G;
  const bool valid = row < rows;
  const int nvec = K / N;
  const uint4* src = reinterpret_cast<const uint4*>(
      x + (valid ? act_row_offset(row, inner, s_outer, s_inner) : 0));
  uint4 v[VPT];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = gl + i * G;
    if (valid && c < nvec) {
      v[i] = __ldg(src + c);
      amax = vec_absmax<T>(v[i], amax);
    }
  }
  // the group's lanes are adjacent: xor offsets below G stay inside it
  for (int o = G >> 1; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!valid) return;
  const float scale = fmaxf(amax, 1e-30f) / 127.f;
  int8_t* dst = xq + static_cast<int64_t>(row) * K;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = gl + i * G;
    if (c < nvec) vec_quantize_store<T>(v[i], scale, dst + c * N);
  }
  if (gl == 0) xs[row] = scale;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kActMaxThreads)
act_quant_row_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int K, int inner,
                     int64_t s_outer, int64_t s_inner) {
  constexpr int N = ActVec<T>::N;
  __shared__ float red[kActMaxThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x;
  const int row = blockIdx.x;
  const int nvec = K / N;
  const uint4* src = reinterpret_cast<const uint4*>(
      x + act_row_offset(row, inner, s_outer, s_inner));
  uint4 v[VPT];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * threads;
    if (c < nvec) {
      v[i] = __ldg(src + c);
      amax = vec_absmax<T>(v[i], amax);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = lane < (threads >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = fmaxf(amax, 1e-30f) / 127.f;
  int8_t* dst = xq + static_cast<int64_t>(row) * K;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * threads;
    if (c < nvec) vec_quantize_store<T>(v[i], scale, dst + c * N);
  }
  if (tid == 0) xs[row] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
act_quant_edge_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                      float* __restrict__ xs, int K, int inner,
                      int64_t s_outer, int64_t s_inner) {
  __shared__ float red[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* row = x + act_row_offset(blockIdx.x, inner, s_outer, s_inner);
  float amax = 0.f;
  for (int k = tid; k < K; k += kThreads)
    amax = fmaxf(amax, fabsf(to_float(row[k])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) amax = fmaxf(amax, red[i]);
  const float scale = fmaxf(amax, 1e-30f) / 127.f;
  int8_t* out = xq + static_cast<int64_t>(blockIdx.x) * K;
  for (int k = tid; k < K; k += kThreads)
    out[k] = static_cast<int8_t>(act_code(to_float(row[k]), scale));
  if (tid == 0) xs[blockIdx.x] = scale;
}

template <typename T>
cudaError_t launch_act_quant(const T* x, int8_t* q, float* xs, int rows,
                             int K, int inner, int64_t s_outer,
                             int64_t s_inner, int path, int param,
                             cudaStream_t s) {
  constexpr int N = ActVec<T>::N;
  if (rows < 1 || K < 1 || inner < 1) return cudaErrorInvalidValue;
  if (path == 2) {                                   // scalar edge
    act_quant_edge_kernel<T><<<rows, kThreads, 0, s>>>(x, q, xs, K, inner,
                                                       s_outer, s_inner);
    return cudaGetLastError();
  }
  // the vector paths read 16-byte vectors: the rows must be aligned
  if (reinterpret_cast<uintptr_t>(x) % 16 || K % N || s_outer % N
      || s_inner % N)
    return cudaErrorMisalignedAddress;
  if (path == 0) {                                   // a group per row
    const int G = param;
    if (G < 1 || G > 32 || (G & (G - 1)) || K > 1024
        || K / N > G * (1024 / N / 32))
      return cudaErrorInvalidValue;
    const int per_block = kActGroupThreads / G;
    act_quant_group_kernel<T><<<(rows + per_block - 1) / per_block,
                                kActGroupThreads, 0, s>>>(
        x, q, xs, rows, K, G, inner, s_outer, s_inner);
    return cudaGetLastError();
  }
  if (path == 1) {                                   // a block per row
    const int threads = param;
    if (threads < 32 || threads > kActMaxThreads || threads % 32
        || K / N > threads * kActMaxVecs)
      return cudaErrorInvalidValue;
    const int vpt = (K / N + threads - 1) / threads;
    if (vpt == 1)
      act_quant_row_kernel<T, 1><<<rows, threads, 0, s>>>(
          x, q, xs, K, inner, s_outer, s_inner);
    else if (vpt == 2)
      act_quant_row_kernel<T, 2><<<rows, threads, 0, s>>>(
          x, q, xs, K, inner, s_outer, s_inner);
    else
      act_quant_row_kernel<T, 4><<<rows, threads, 0, s>>>(
          x, q, xs, K, inner, s_outer, s_inner);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- launch
// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, uint64_t cols, uint64_t rows,
                          uint64_t row_bytes, uint32_t box_cols,
                          uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// K splits of wo_wgmma_kernel: enough to give about every SM a block
// where the output tiles fill less than half of them, each split at least
// 4 K steps; 1 otherwise
cudaError_t wo_splits(int M, int N, int K, int* splits) {
  *splits = 1;
  if (M <= 16 || K % 16 != 0 || K == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (N + kWoBF - 1) / kWoBF * ((M + kWoBT - 1) / kWoBT);
  const int most = K / kWoBK / 4;
  if (2 * tiles <= sms && most > 1)
    *splits = sms / tiles < most ? sms / tiles : most;
  return cudaSuccess;
}

cudaError_t launch_wo_wgmma(const __nv_bfloat16* x, const int8_t* w,
                            const float* scale, __nv_bfloat16* y,
                            float* part, int M, int N, int K,
                            cudaStream_t s) {
  int splits = 1;
  cudaError_t err = wo_splits(M, N, K, &splits);
  if (err != cudaSuccess) return err;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  err = tensor_map_2d(
      &x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2,
      kWoBK, kWoBT, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, K,
                        kWoBK, kWoBF, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wo_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWoSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kWoBF - 1) / kWoBF, (M + kWoBT - 1) / kWoBT, splits);
  wo_wgmma_kernel<<<grid, 512, kWoSmem, s>>>(
      x_map, w_map, scale, y, splits > 1 ? part : nullptr, M, N, K);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t blocks = ((size_t)M * N + kThreads - 1) / kThreads;
  wo_splitk_reduce_kernel<<<blocks < 1024 ? (int)blocks : 1024, kThreads, 0,
                            s>>>(part, scale, y, M, N, splits);
  return cudaGetLastError();
}

// bf16 x, on the tensor cores; the kernel is chosen by shape alone:
//   M <= 16               wo_mma_skinny_kernel (decode: split K, bytes)
//   M > 16, K % 16 == 0   wo_wgmma_kernel (TMA needs 16-byte weight rows),
//                         K split over blocks where the tiles are few
//   M > 16, K % 16 != 0   wo_mma_tiled_kernel (element-wise staging)
cudaError_t launch_wo_bf16(const __nv_bfloat16* x, const int8_t* w,
                           const float* scale, __nv_bfloat16* y, float* part,
                           int M, int N, int K, cudaStream_t s) {
  if (M <= 16) {
    dim3 grid((N + kMmaTiles * 8 - 1) / (kMmaTiles * 8));
    if (K % 16 == 0)
      wo_mma_skinny_kernel<true><<<grid, kThreads, 0, s>>>(x, w, scale, y, M,
                                                           N, K);
    else
      wo_mma_skinny_kernel<false><<<grid, kThreads, 0, s>>>(x, w, scale, y,
                                                            M, N, K);
    return cudaGetLastError();
  }
  if (K % 16 == 0 && K > 0)
    return launch_wo_wgmma(x, w, scale, y, part, M, N, K, s);
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  wo_mma_tiled_kernel<<<grid, kThreads, 0, s>>>(x, w, scale, y, M, N, K);
  return cudaGetLastError();
}

// f32 x: f32 FMAs on the CUDA cores (the tensor cores have no f32
// product), the tiled kernel at every M (it bounds-checks the rows)
cudaError_t launch_wo_f32(const float* x, const int8_t* w, const float* scale,
                          float* y, int M, int N, int K, cudaStream_t s) {
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  if (K % 16 == 0)
    wo_tiled_kernel<true><<<grid, kThreads, 0, s>>>(x, w, scale, y, M, N, K);
  else
    wo_tiled_kernel<false><<<grid, kThreads, 0, s>>>(x, w, scale, y, M, N, K);
  return cudaGetLastError();
}

// token tile of w8a8_wgmma_kernel: the narrowest that holds M, up to 256
int w8a8_tile(int M) {
  return M <= 32 ? 32 : M <= 64 ? 64 : M <= 128 ? 128 : 256;
}

// K splits of w8a8_wgmma_kernel, by wo_splits' rule: enough to give about
// every SM a block where the output tiles fill less than half of them,
// each split at least 4 K steps; 1 otherwise
cudaError_t w8a8_splits(int M, int N, int K, int* splits) {
  *splits = 1;
  if (M <= 16 || K % 16 != 0 || K == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tt = w8a8_tile(M);
  const int tiles = (N + kQF - 1) / kQF * ((M + tt - 1) / tt);
  const int most = (K + kQK - 1) / kQK / 4;
  if (2 * tiles <= sms && most > 1)
    *splits = sms / tiles < most ? sms / tiles : most;
  return cudaSuccess;
}

template <typename T, int TT>
cudaError_t launch_w8a8_wgmma(const int8_t* xq, const float* xscale,
                              const int8_t* w, const float* scale, T* y,
                              int* part, int M, int N, int K, int splits,
                              cudaStream_t s) {
  using C = W8a8Tile<TT>;
  CUtensorMap x_map, w_map;
  cudaError_t err = tensor_map_2d(
      &x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, K, M, K, kQK, TT,
      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, K,
                        kQK, kQF, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(w8a8_wgmma_kernel<T, TT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + TT - 1) / TT, (N + kQF - 1) / kQF, splits);
  w8a8_wgmma_kernel<T, TT><<<grid, kQThreads, C::kSmem, s>>>(
      x_map, w_map, xscale, scale, y, splits > 1 ? part : nullptr, M, N, K);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t blocks = ((size_t)M * N + kThreads - 1) / kThreads;
  w8a8_splitk_reduce_kernel<T><<<blocks < 1024 ? (int)blocks : 1024,
                                 kThreads, 0, s>>>(part, xscale, scale, y,
                                                   M, N, splits);
  return cudaGetLastError();
}

// the kernel is chosen by shape alone:
//   M <= 16               w8a8_mma_skinny_kernel (decode: split K, bytes)
//   M > 16, K % 16 == 0   w8a8_wgmma_kernel (TMA needs 16-byte rows), K
//                         split over blocks where the tiles are few
//   M > 16, K % 16 != 0   w8a8_mma_tiled_kernel (element-wise staging)
template <typename T>
cudaError_t launch_w8a8(const int8_t* xq, const float* xscale,
                        const int8_t* w, const float* scale, void* y,
                        int* part, int M, int N, int K, cudaStream_t s) {
  T* yt = static_cast<T*>(y);
  const bool vec = K % 16 == 0;
  if (M <= 16) {
    dim3 grid((N + kMmaTiles * 8 - 1) / (kMmaTiles * 8));
    if (vec)
      w8a8_mma_skinny_kernel<T, true><<<grid, kThreads, 0, s>>>(
          xq, xscale, w, scale, yt, M, N, K);
    else
      w8a8_mma_skinny_kernel<T, false><<<grid, kThreads, 0, s>>>(
          xq, xscale, w, scale, yt, M, N, K);
    return cudaGetLastError();
  }
  if (vec && K > 0) {
    int splits = 1;
    cudaError_t err = w8a8_splits(M, N, K, &splits);
    if (err != cudaSuccess) return err;
    if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
    switch (w8a8_tile(M)) {
      case 32:
        return launch_w8a8_wgmma<T, 32>(xq, xscale, w, scale, yt, part, M,
                                        N, K, splits, s);
      case 64:
        return launch_w8a8_wgmma<T, 64>(xq, xscale, w, scale, yt, part, M,
                                        N, K, splits, s);
      case 128:
        return launch_w8a8_wgmma<T, 128>(xq, xscale, w, scale, yt, part, M,
                                         N, K, splits, s);
      default:
        return launch_w8a8_wgmma<T, 256>(xq, xscale, w, scale, yt, part, M,
                                         N, K, splits, s);
    }
  }
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  w8a8_mma_tiled_kernel<T><<<grid, kThreads, 0, s>>>(
      xq, xscale, w, scale, yt, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 elements of scratch that weight_only_matmul_fwd needs for these
// shapes (the K splits' partial sums; 0: none), or -1 on a CUDA error
long long weight_only_matmul_workspace(int M, int N, int K, int dtype) {
  if (dtype != 1) return 0;
  int splits = 1;
  if (wo_splits(M, N, K, &splits) != cudaSuccess) return -1;
  return splits > 1 ? (long long)splits * M * N : 0;
}

// dtype 0 = f32, 1 = bf16 (of x and y).  x (M, K), w (N, K) int8,
// scale (N,) f32, y (M, N); every tensor contiguous, 16-byte aligned;
// `workspace` f32 of weight_only_matmul_workspace's size (NULL if 0).
// Returns cudaGetLastError() after the launch (0 = launched).
int weight_only_matmul_fwd(const void* x, const void* w, const void* scale,
                           void* y, int M, int N, int K, int dtype,
                           void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    return (int)launch_wo_f32(static_cast<const float*>(x), wq, sc,
                              static_cast<float*>(y), M, N, K, s);
  if (dtype == 1)
    return (int)launch_wo_bf16(static_cast<const __nv_bfloat16*>(x), wq, sc,
                               static_cast<__nv_bfloat16*>(y),
                               static_cast<float*>(workspace), M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

// s32 elements of scratch that w8a8_matmul_fwd needs for these shapes
// (the K splits' sums; 0: none), or -1 on a CUDA error
long long w8a8_matmul_workspace(int M, int N, int K) {
  int splits = 1;
  if (w8a8_splits(M, N, K, &splits) != cudaSuccess) return -1;
  return splits > 1 ? (long long)splits * M * N : 0;
}

// dtype 0 = f32, 1 = bf16 (of y).  xq (M, K) int8, xscale (M,) f32,
// w (N, K) int8, scale (N,) f32, y (M, N); every tensor contiguous,
// 16-byte aligned; `workspace` s32 of w8a8_matmul_workspace's size (NULL
// if 0).
int w8a8_matmul_fwd(const void* xq, const void* xscale, const void* w,
                    const void* scale, void* y, int M, int N, int K,
                    int dtype, void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(xq);
  const float* xs = static_cast<const float*>(xscale);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  int* part = static_cast<int*>(workspace);
  if (dtype == 0)
    return (int)launch_w8a8<float>(xi, xs, wq, sc, y, part, M, N, K, s);
  if (dtype == 1)
    return (int)launch_w8a8<__nv_bfloat16>(xi, xs, wq, sc, y, part, M, N, K,
                                           s);
  return (int)cudaErrorInvalidValue;
}

// dtype 0 = f32, 1 = bf16 (of x).  Row r of x (rows of K elements, the
// last dim contiguous) starts at (r / inner) * s_outer + (r % inner) *
// s_inner elements; xq (rows, K) int8 and xscale (rows,) f32 contiguous.
// path 0: act_quant_group_kernel, param = lanes per row (a power of two
// <= 32, K <= 1024); 1: act_quant_row_kernel, param = threads; 2: the
// scalar edge (param unused).  The vector paths need x 16-byte aligned
// and K and both strides multiples of a 16-byte vector.
int dynamic_act_quant_fwd(const void* x, void* xq, void* xscale, int rows,
                          int K, int inner, long long s_outer,
                          long long s_inner, int dtype, int path, int param,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* xs = static_cast<float*>(xscale);
  if (dtype == 0)
    return (int)launch_act_quant<float>(static_cast<const float*>(x), q, xs,
                                        rows, K, inner, s_outer, s_inner,
                                        path, param, s);
  if (dtype == 1)
    return (int)launch_act_quant<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), q, xs, rows, K, inner, s_outer,
        s_inner, path, param, s);
  return (int)cudaErrorInvalidValue;
}

const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
