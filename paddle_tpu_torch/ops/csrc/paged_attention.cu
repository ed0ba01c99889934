// Ragged paged attention for Hopper (sm_90a): every row of the batch
// attends its own left-aligned query span over K/V held in fixed-size
// pages, reached through the row's page table.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_decode_kernel`
// (launched by `_decode_pallas`) in its decode, verify and ragged forms.
// Ragged is the general case here: query j of row b attends
// cols < min(len, len - q_len + 1 + j).  Decode is q_len = 1 and a verify
// block is q_len = max_q, where the limit reduces to the verify mask
// len - (max_q - 1 - j).  A row with len == 0 writes zeros.  Query
// positions j >= q_len are the bucket's padding: the JAX kernel computes
// discarded garbage there, this one writes zeros and skips their work.
//
// What bounds it on the H100: each K/V element read from the pages
// feeds only (q_len * group) dot products, so at decode it is bound by
// the bytes of the pages it reads (the whole context of every row, once
// per kv head).  What its design does about that:
//   - Split-KV (flash-decoding).  The grid is (query-row tile, context
//     split, row x kv head); a split is `split_tokens` columns (a
//     multiple of page_size, 256 or more), planned on the host from
//     shapes alone (`plan_splits` in ops/paged_attention.py), so a
//     decode batch of a few rows still fills the card and no length is
//     read back.  A block whose split starts past its rows' last visible
//     column writes an empty partial (m = -inf, l = 0) and exits.  Each
//     block writes its rows' f32 partial (m, l, acc), and
//     `paged_attention_combine_kernel` merges them split by split in a
//     fixed order with max rescaling (no atomics: a call is
//     bit-identical to a repeat of itself).  A one-split plan writes the
//     output directly and launches no combine.
//   - An asynchronous page ring.  The split's page-table entries, the
//     lengths and q are requested together at the start and the
//     entries kept in shared memory, so no K/V address waits on a table
//     load.  K/V tiles are gathered page by page with 16-byte cp.async
//     into a three-stage ring in their storage type (bf16, f32 or int8
//     plus the slot scales): the next two tiles are in flight while one
//     is computed.
//   - 1 to 4 rows (decode, GQA groups up to 4): the CUDA cores, eight
//     lanes a token (each lane 16-byte chunks of the row, so a group's
//     loads hit eight bank groups), four tokens a warp step, every warp
//     its own quarter of each 32-token tile; a score is reduced over
//     eight lanes, and the softmax rescales only when the row's maximum
//     moves.  The four warps' states merge in shared memory at the end
//     (`paged_attention_decode_kernel<.., 1 or 4>`; also the tensor-core
//     kernel's blocks of 1 to 4 real rows, e.g. decode rows beside a
//     chunk span).
//   - 5 to 16 rows, and every f32 call: the CUDA cores, a lane per D/32
//     dimensions, 64-token tiles (`paged_attention_decode_kernel<.., 16>`).
//   - 16 or more rows a (row, kv head) pair, bf16 (chunk spans, verify
//     blocks, GQA groups): `paged_attention_mma_kernel`, 64 rows a
//     block, 16 per warp, S = Q K^T and O += P V on the tensor cores with
//     mma.sync.m16n8k16 bf16 -> f32 (ldmatrix from tiles whose 16-byte
//     chunks are XOR-swizzled by row; P, rounded to bf16, feeds P V from
//     registers).  A block holds 1 to 256 x group rows over 16-token
//     pages, which m16 fits; moving it to wgmma is later work.  f32
//     calls keep CUDA-core products (no TF32).
// Softmax state, scores and the output accumulate in f32; p is rounded
// to the compute type before it meets V, as the JAX kernel casts
// `pexp.astype(v.dtype)`.
//
// int8 mode (`_decode_kernel(quantized=True)`): pages hold int8 values
// with one f32 scale per slot and head (scale pools (kv_heads,
// total_pages, page_size, 1)).  The ring holds the int8 tile and its
// scales; each element is dequantized as T(float(q8) * s), rounded
// through the compute type before any dot, as `dequantize_kv` does for
// every other consumer, so attention sees bit-identical K/V to prefill's
// round trip (the tensor-core path converts the tile to a bf16 tile in
// shared memory first).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_wgmma.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::pack_bf16;
using hopper::smem_u32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDecRows = 16;      // rows of the lane-per-D/32 path
constexpr int kMmaRows = 16 * kWarps;   // rows of a tensor-core block
constexpr int kStages = 3;        // ring depth, in tiles
constexpr int kCombineWarps = 8;  // output rows per combine block

extern __shared__ __align__(128) unsigned char paged_smem[];

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16-byte chunk c of token row r of a tile whose rows hold `CPR` chunks:
// XOR-swizzled by r % 8 where a row has 8 or more, so ldmatrix's eight
// rows of one chunk column fall in eight different bank groups
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  return CPR >= 8 ? (c ^ (r & 7)) : c;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// D[16 x 8] += A[16 x 16] * B[16 x 8], bf16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Params {
  const void* q;         // (batch, max_q, q_heads, D) of T
  const void* kp;        // (kv_heads, total_pages, page_size, D) of P
  const void* vp;
  const float* ks;       // (kv_heads, total_pages, page_size) int8 mode
  const float* vs;
  const int* lens;       // (batch,)
  const int* q_lens;     // (batch,)
  const int* tables;     // (batch, table_width)
  void* out;             // like q
  float* part_acc;       // (n_split, batch, kv_heads, rows, D) f32
  float* part_ml;        // m, then l: each (n_split, batch, kv_heads, rows)
  int batch, max_q, q_heads, kv_heads;
  int page_size, page_shift, total_pages, table_width;
  int split_tokens, n_split;
  float scale_log2;      // softmax scale * log2(e): scores in base 2
};

// shared memory of one block: the ring, the bf16 tile of the int8
// tensor-core path, q of the CUDA-core paths, the split's table entries.
// ROWS: the CUDA-core path's rows (1 or 4: eight lanes a token; 16: a
// lane per D / 32 dimensions); MMA: the tensor-core kernel.
template <typename P, int D, int ROWS, bool MMA>
struct Layout {
  static constexpr bool I8 = std::is_same<P, int8_t>::value;
  static constexpr bool FEW = ROWS <= 4;
  // tokens a tile: the eight-lanes-a-token path takes 32 (two 16-token
  // pages), so a block holds half the ring and twice as many fit an SM
  static constexpr int TT = (FEW ? 32 : 64) / (sizeof(P) == 4 ? 2 : 1);
  static constexpr int ROW = D * (int)sizeof(P);        // bytes a token
  static constexpr int CPR = ROW / 16;
  static constexpr int TILE = TT * ROW;
  static constexpr int STAGE = 2 * TILE + (I8 ? 2 * TT * 4 : 0);
  static constexpr int RING = kStages * STAGE;
  static constexpr int CONV = (MMA && I8) ? 2 * TT * D * 2 : 0;
  static constexpr int QS = ROWS * D * 4;
  // the CUDA-core warps' states, merged through the ring once it is idle
  static constexpr int MERGE = kWarps * ROWS * (D + 2) * 4;
  static_assert(MERGE <= RING, "the merge buffer must fit in the ring");
  static size_t bytes(int n_tab) {
    return (size_t)RING + CONV + QS + (size_t)n_tab * 4;
  }
};

// 4 int8 codes of `w` dequantized as T(float(q8) * s): each byte, offset
// to b + 128, is placed in the mantissa of 2^23 and the offset taken
// back off (exact, and cheaper than an int-to-float conversion each)
template <typename T>
__device__ __forceinline__ void dequant4(uint32_t w, float s, float* x) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i))
            - 8388736.f) * s;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const uint32_t h = pack_bf16(x[i], x[i + 1]);
      x[i] = __uint_as_float(h << 16);
      x[i + 1] = __uint_as_float(h & 0xffff0000u);
    }
  }
}

// 16 bytes of a page row (8 bf16, 4 f32 or 16 int8) as floats; int8
// dequantized with the slot scale s
template <typename T, typename P>
__device__ __forceinline__ void chunk_to_float(const uint4& raw, float s,
                                               float* x) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same<P, int8_t>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dequant4<T>(w[i], s, x + 4 * i);
  } else if constexpr (std::is_same<P, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Eight lanes a token row: lane group member dg holds DPG = D / 8
// elements, 16-byte chunks dg, dg + 8, ... of the row (chunk by chunk
// the eight lanes read eight bank groups), or half a chunk where a row
// is only 64 bytes (int8 at d64)
template <typename T, typename P, int D>
struct Group8 {
  static constexpr int DPG = D / 8;
  static constexpr int BYTES = DPG * (int)sizeof(P);
  static constexpr int CPR = D * (int)sizeof(P) / 16;
  static constexpr int EPC = 16 / (int)sizeof(P);       // elements a chunk
  // the row dimension of the lane's element i
  static __device__ __forceinline__ int dim(int dg, int i) {
    if constexpr (BYTES >= 16)
      return (dg + 8 * (i / EPC)) * EPC + i % EPC;
    else
      return dg * DPG + i;
  }
  static __device__ __forceinline__ void load(const unsigned char* tile,
                                              int tt, int dg, float s,
                                              float (&x)[DPG]) {
    const unsigned char* row = tile + tt * D * (int)sizeof(P);
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int k = 0; k < BYTES / 16; ++k)
        chunk_to_float<T, P>(*reinterpret_cast<const uint4*>(
                                 row + swz<CPR>(tt, dg + 8 * k) * 16),
                             s, x + k * EPC);
    } else {     // int8, d64: 8 bytes
      const uint2 raw = *reinterpret_cast<const uint2*>(row + dg * 8);
      dequant4<T>(raw.x, s, x);
      dequant4<T>(raw.y, s, x + 4);
    }
  }
};

// DPL = D / 32 elements of token row tt of a ring tile, this lane's
// dimensions, as float (int8: dequantized with the slot scale s)
template <typename T, typename P, int D>
__device__ __forceinline__ void lane_row(const unsigned char* tile, int tt,
                                         int lane, float s,
                                         float (&x)[D / 32]) {
  constexpr int DPL = D / 32;
  constexpr int BYTES = DPL * (int)sizeof(P);
  constexpr int CPR = D * (int)sizeof(P) / 16;
  const int byte = lane * BYTES;
  const unsigned char* src = tile + tt * D * (int)sizeof(P)
                             + swz<CPR>(tt, byte >> 4) * 16 + (byte & 15);
  if constexpr (std::is_same<P, int8_t>::value) {
    if constexpr (BYTES == 4) {
      dequant4<T>(*reinterpret_cast<const uint32_t*>(src), s, x);
    } else {
      const uint16_t h = *reinterpret_cast<const uint16_t*>(src);
      float y[4];
      dequant4<T>(h, s, y);
      x[0] = y[0];
      x[1] = y[1];
    }
  } else {
    alignas(16) P e[DPL];
    if constexpr (BYTES == 16) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(src);
    } else if constexpr (BYTES == 8) {
      *reinterpret_cast<uint2*>(e) = *reinterpret_cast<const uint2*>(src);
    } else {
      *reinterpret_cast<uint32_t*>(e) =
          *reinterpret_cast<const uint32_t*>(src);
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) x[i] = to_float(e[i]);
  }
}

// Merge the kWarps CUDA-core warps' softmax states of rows < n_real
// (mm, ll: [warp][row] in shared memory, aa: [warp][row][D]) in warp
// order; write the output (one split) or this split's partials.
template <typename T, int D, int ROWS, typename OutRow>
__device__ __forceinline__ void merge_warps(const float* mm, const float* ll,
                                            const float* aa, int n_real,
                                            bool direct, const Params& p,
                                            T* ob, OutRow row_off,
                                            size_t slot0, size_t l_off) {
  for (int i = threadIdx.x; i < n_real * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mm[w * ROWS + r]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = mm[w * ROWS + r];
        if (mw == -INFINITY) continue;
        const float f = exp2f(mw - mx);
        lsum = fmaf(f, ll[w * ROWS + r], lsum);
        a = fmaf(f, aa[(w * ROWS + r) * D + d], a);
      }
    }
    if (direct) {
      ob[row_off(r) + d] = from_float<T>(lsum == 0.f ? 0.f : a / lsum);
    } else {
      p.part_acc[(slot0 + r) * D + d] = a;
      if (d == 0) {
        p.part_ml[slot0 + r] = mx;
        p.part_ml[l_off + slot0 + r] = lsum;
      }
    }
  }
}

// Block (x, y, z): query rows x * R .. of row b = z / kv_heads, kv head
// h = z % kv_heads, context split y; query row r is span position
// r / group of q head h * group + r % group.  R = ROWS, or 64 rows on
// the tensor-core kernel (MMA).  A block of 1 to 4 real rows in a larger
// bf16 bucket takes the four-row CUDA-core path, one of 5 to 15 real
// rows on the tensor-core kernel the 16-row path.
template <typename T, typename P, int D, int ROWS, bool MMA>
__device__ __forceinline__ void paged_body(const Params& p) {
  using L = Layout<P, D, ROWS, MMA>;
  constexpr int TT = L::TT, DPL = D / 32;
  constexpr int R = MMA ? kMmaRows : ROWS;
  constexpr bool I8 = L::I8;
  unsigned char* ring = paged_smem;
  unsigned char* conv = paged_smem + L::RING;
  float* qs = reinterpret_cast<float*>(paged_smem + L::RING + L::CONV);
  int* tab_s = reinterpret_cast<int*>(paged_smem + L::RING + L::CONV
                                      + L::QS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.z % p.kv_heads, b = blockIdx.z / p.kv_heads;
  const int split = blockIdx.y;
  const int group = p.q_heads / p.kv_heads;
  const int rows_bh = p.max_q * group;
  const int r0 = blockIdx.x * R;
  const int n_rows = min(R, rows_bh - r0);            // rows in the bucket
  const int t_begin = split * p.split_tokens;
  const bool direct = p.n_split == 1;
  // the lengths, the split's page-table entries (t_begin is
  // page-aligned; entries past a row's pages are never used) and, for
  // the CUDA-core kernel, q are requested together, before any of them
  // is needed
  const int len = p.lens[b], qlen = p.q_lens[b];
  {
    const int pg0 = t_begin / p.page_size;
    const int n_tab = min(p.split_tokens / p.page_size,
                          p.table_width - pg0);
    const int* tab = p.tables + (size_t)b * p.table_width + pg0;
    for (int i = tid; i < n_tab; i += kThreads) tab_s[i] = tab[i];
  }
  const size_t row_stride = (size_t)p.q_heads * D;
  const T* qb = static_cast<const T*>(p.q) + (size_t)b * p.max_q * row_stride;
  T* ob = static_cast<T*>(p.out) + (size_t)b * p.max_q * row_stride;
  auto row_off = [&](int r) -> size_t {
    const int rr = r0 + r;
    return (size_t)(rr / group) * row_stride
           + (size_t)(hk * group + rr % group) * D;
  };
  // q of the CUDA-core paths (the tensor-core kernel's blocks of fewer
  // than 16 real rows load theirs below); pad rows' q is read too (it is
  // the bucket's memory) and never used
  auto load_q = [&]() {
    for (int i = tid; i < ROWS * D; i += kThreads) {
      const int r = i / D;
      qs[i] = r < n_rows ? to_float(qb[row_off(r) + i % D]) : 0.f;
    }
  };
  if (!MMA) load_q();
  const int n_real = min(n_rows, qlen * group - r0);  // rows of real queries
  // this split's partial of block row r: slot0 + r
  const size_t slot0 =
      (((size_t)split * p.batch + b) * p.kv_heads + hk) * rows_bh + r0;
  const size_t l_off = (size_t)p.n_split * p.batch * p.kv_heads * rows_bh;
  auto zero_rows = [&](int from) {
    for (int i = from * D + tid; i < n_rows * D; i += kThreads)
      ob[row_off(i / D) + i % D] = from_float<T>(0.f);
  };

  if (n_real <= 0 || len <= 0) {     // pad rows or an empty row
    if (direct) zero_rows(0);
    return;
  }
  // the block's last real query sees the most columns
  const int j_last = (r0 + n_real - 1) / group;
  const int kv_end = min(min(len, len - qlen + 1 + j_last),
                         p.table_width * p.page_size);
  const int t_end = min(kv_end, t_begin + p.split_tokens);
  if (t_begin >= t_end) {            // the split sees no column
    if (direct) {
      zero_rows(0);
    } else {
      for (int r = tid; r < n_real; r += kThreads) {
        p.part_ml[slot0 + r] = -INFINITY;
        p.part_ml[l_off + slot0 + r] = 0.f;
      }
    }
    return;
  }
  // columns block row r (real) sees in this split: cols < limit_of(r)
  auto limit_of = [&](int r) -> int {
    const int j = (r0 + r) / group;
    return min(min(len, len - qlen + 1 + j), t_end);
  };
  const bool use_mma = MMA && n_real >= 16;
  if (MMA && !use_mma) load_q();
  __syncthreads();

  const size_t head_slot = (size_t)hk * p.total_pages * p.page_size;
  const int n_tiles = (t_end - t_begin + TT - 1) / TT;
  auto slot_of = [&](int t) -> size_t {     // t_begin <= t < t_end
    const int rel = t - t_begin;
    const int pi = p.page_shift >= 0 ? rel >> p.page_shift
                                     : rel / p.page_size;
    return head_slot + (size_t)tab_s[pi] * p.page_size
           + (rel - pi * p.page_size);
  };
  // tile `it` of the split into its ring stage; columns past t_end are
  // zero-filled (masked scores meet zeros, never stale values)
  auto issue = [&](int it) {
    unsigned char* st = ring + (it % kStages) * L::STAGE;
    const int tb = t_begin + it * TT;
    const char* kg = static_cast<const char*>(p.kp);
    const char* vg = static_cast<const char*>(p.vp);
    for (int i = tid; i < TT * L::CPR; i += kThreads) {
      const int tt = i / L::CPR, c = i % L::CPR, t = tb + tt;
      const bool valid = t < t_end;
      const size_t off = valid ? slot_of(t) * L::ROW + c * 16 : 0;
      const uint32_t dst =
          smem_u32(st + tt * L::ROW + swz<L::CPR>(tt, c) * 16);
      cp_async16(dst, kg + off, valid);
      cp_async16(dst + L::TILE, vg + off, valid);
    }
    if constexpr (I8) {
      for (int i = tid; i < 2 * TT; i += kThreads) {
        const int t = tb + i % TT;
        const bool valid = t < t_end;
        const float* src = (i < TT ? p.ks : p.vs) + (valid ? slot_of(t) : 0);
        cp_async4(smem_u32(st + 2 * L::TILE + i * 4), src, valid);
      }
    }
  };
  // wait for tile `it`, with the ring's later tiles in flight
  auto arrive = [&](int it) -> const unsigned char* {
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    return ring + (it % kStages) * L::STAGE;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }
  // ---- CUDA cores, FR <= 4 rows: eight lanes a token (group tg = lane /
  // 8, member dg), four tokens a warp step; warp w takes tokens
  // [w * TT / 4, (w + 1) * TT / 4) of every tile for all rows.  The merge
  // goes through the idle ring after the loop.
  auto few_rows = [&](auto rows_c) {
    constexpr int FR = decltype(rows_c)::value;
    float* mm = reinterpret_cast<float*>(ring);
    float* ll = mm + kWarps * FR;
    float* aa = ll + kWarps * FR;
    using G = Group8<T, P, D>;
    constexpr int DPG = G::DPG, TPW = TT / kWarps;
    const int tg = lane >> 3, dg = lane & 7;
    float m[FR], l[FR], acc[FR][DPG];
    int lim[FR];
#pragma unroll
    for (int r = 0; r < FR; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
      lim[r] = r < n_real ? limit_of(r) : 0;
#pragma unroll
      for (int e = 0; e < DPG; ++e) acc[r][e] = 0.f;
    }
    for (int it = 0; it < n_tiles; ++it) {
      const unsigned char* st = arrive(it);
      const float* sc = reinterpret_cast<const float*>(st + 2 * L::TILE);
      const int tb = t_begin + it * TT;
#pragma unroll
      for (int g0 = 0; g0 < TPW; g0 += 4) {
        if (tb + warp * TPW + g0 >= t_end) break;   // uniform in the warp
        const int tt = warp * TPW + g0 + tg, col = tb + tt;
        float ksc = 1.f, vsc = 1.f;
        if constexpr (I8) {
          ksc = sc[tt];
          vsc = sc[TT + tt];
        }
        float kf[DPG], vf[DPG];
        G::load(st, tt, dg, ksc, kf);
        G::load(st + L::TILE, tt, dg, vsc, vf);
#pragma unroll
        for (int r = 0; r < FR; ++r) {
          if (r >= n_real) break;             // uniform across the block
          // the lane's dimensions run in aligned fours
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int e = 0; e < DPG; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + r * D + G::dim(dg, e));
            a0 = fmaf(qv.x, kf[e], a0);
            a1 = fmaf(qv.y, kf[e + 1], a1);
            a0 = fmaf(qv.z, kf[e + 2], a0);
            a1 = fmaf(qv.w, kf[e + 3], a1);
          }
          float sv = a0 + a1;
#pragma unroll
          for (int o = 1; o < 8; o <<= 1)
            sv += __shfl_xor_sync(0xffffffffu, sv, o);
          sv = col < lim[r] ? sv * p.scale_log2 : -INFINITY;
          float mx = fmaxf(sv, __shfl_xor_sync(0xffffffffu, sv, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          if (mx > m[r]) {                    // uniform in the warp
            const float alpha = exp2f(m[r] - mx);
            l[r] *= alpha;
#pragma unroll
            for (int e = 0; e < DPG; ++e) acc[r][e] *= alpha;
            m[r] = mx;
          }
          if (m[r] == -INFINITY) continue;    // nothing visible yet
          const float pk = exp2f(sv - m[r]);
          l[r] += pk;
          // p meets V in the working type, as the JAX kernel casts it
          const float pr = to_float(from_float<T>(pk));
#pragma unroll
          for (int e = 0; e < DPG; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
        }
      }
      __syncthreads();   // the stage is read before it is refilled
    }
    // the warp's four token groups share m: sum their l and acc
    cp_async_wait<0>();
#pragma unroll
    for (int r = 0; r < FR; ++r) {
      if (r >= n_real) break;
#pragma unroll
      for (int o = 8; o < 32; o <<= 1) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
        for (int e = 0; e < DPG; ++e)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
      }
      const int wr = warp * FR + r;
      if (lane == 0) {
        mm[wr] = m[r];
        ll[wr] = l[r];
      }
      if (tg == 0) {
#pragma unroll
        for (int e = 0; e < DPG; ++e) aa[wr * D + G::dim(dg, e)] = acc[r][e];
      }
    }
    __syncthreads();
    merge_warps<T, D, FR>(mm, ll, aa, n_real, direct, p, ob, row_off, slot0,
                          l_off);
    if (direct) zero_rows(n_real);
  };

  if constexpr (L::FEW) {
    few_rows(std::integral_constant<int, ROWS>());
    return;
  } else {
    // bf16 blocks of a larger bucket with 1 to 4 real rows (decode rows
    // beside chunk or verify spans) take the four-row path too
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (n_real <= 4) {
        few_rows(std::integral_constant<int, 4>());
        return;
      }
    }
    if (!use_mma) {
      // ---- CUDA cores, up to 16 rows: warp w takes tokens [w * TT / 4,
      // (w + 1) * TT / 4) of every tile for all rows; lane = dims
      // lane * DPL ..
      constexpr int TPW = TT / kWarps;
      float m[ROWS], l[ROWS], acc[ROWS][DPL];
      int lim[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
        lim[r] = r < n_real ? limit_of(r) : 0;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
      }
      for (int it = 0; it < n_tiles; ++it) {
        const unsigned char* st = arrive(it);
        const float* sc = reinterpret_cast<const float*>(st + 2 * L::TILE);
        const int tb = t_begin + it * TT;
#pragma unroll 1
        for (int g0 = 0; g0 < TPW; g0 += 4) {
          const int tt0 = warp * TPW + g0;
          if (tb + tt0 >= t_end) break;         // uniform across the warp
          float kf[4][DPL], vf[4][DPL];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float ksc = 1.f, vsc = 1.f;
            if constexpr (I8) {
              ksc = sc[tt0 + k];
              vsc = sc[TT + tt0 + k];
            }
            lane_row<T, P, D>(st, tt0 + k, lane, ksc, kf[k]);
            lane_row<T, P, D>(st + L::TILE, tt0 + k, lane, vsc, vf[k]);
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r >= n_real) break;             // uniform across the block
            float qv[DPL];
#pragma unroll
            for (int e = 0; e < DPL; ++e) qv[e] = qs[r * D + lane * DPL + e];
            float sv[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float a = 0.f;
#pragma unroll
              for (int e = 0; e < DPL; ++e) a = fmaf(qv[e], kf[k][e], a);
              sv[k] = a;
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                sv[k] += __shfl_xor_sync(0xffffffffu, sv[k], o);
            }
            float mx = -INFINITY;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              sv[k] = tb + tt0 + k < lim[r] ? sv[k] * p.scale_log2
                                            : -INFINITY;
              mx = fmaxf(mx, sv[k]);
            }
            const float m_new = fmaxf(m[r], mx);
            if (m_new == -INFINITY) continue;   // nothing visible yet
            const float alpha = exp2f(m[r] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float pk = exp2f(sv[k] - m_new);
              ps += pk;
              // p meets V in the working type, as the JAX kernel casts it
              const float pr = to_float(from_float<T>(pk));
#pragma unroll
              for (int e = 0; e < DPL; ++e)
                acc[r][e] = fmaf(pr, vf[k][e], acc[r][e]);
            }
            l[r] = l[r] * alpha + ps;
            m[r] = m_new;
          }
        }
        __syncthreads();   // the stage is read before it is refilled
      }
      cp_async_wait<0>();
      float* mm = reinterpret_cast<float*>(ring);   // [warp][row]
      float* ll = mm + kWarps * ROWS;
      float* aa = ll + kWarps * ROWS;                // [warp][row][D]
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= n_real) break;
        const int wr = warp * ROWS + r;
        if (lane == 0) {
          mm[wr] = m[r];
          ll[wr] = l[r];
        }
#pragma unroll
        for (int e = 0; e < DPL; ++e) aa[wr * D + lane * DPL + e] = acc[r][e];
      }
      __syncthreads();
      merge_warps<T, D, ROWS>(mm, ll, aa, n_real, direct, p, ob, row_off,
                              slot0, l_off);
      if (direct) zero_rows(n_real);
      return;
    }
  }

  if constexpr (MMA) {
    // ---- tensor cores: warp w holds rows 16 w .. 16 w + 15; a thread
    // the rows g and g + 8 of its warp's slice (the m16n8 layouts)
    const int g = lane >> 2, t4 = lane & 3;
    const int ra = warp * 16 + g, rb = ra + 8;
    const bool live = warp * 16 < n_real;           // uniform in the warp
    const __nv_bfloat16* qh = reinterpret_cast<const __nv_bfloat16*>(qb);
    auto qword = [&](int r, int col) -> uint32_t {
      return r < n_real ? *reinterpret_cast<const uint32_t*>(
                              qh + row_off(r) + col)
                        : 0u;
    };
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = qword(ra, kk * 16 + 2 * t4);
      qa[kk][1] = qword(rb, kk * 16 + 2 * t4);
      qa[kk][2] = qword(ra, kk * 16 + 8 + 2 * t4);
      qa[kk][3] = qword(rb, kk * 16 + 8 + 2 * t4);
    }
    const int lim_a = ra < n_real ? limit_of(ra) : 0;
    const int lim_b = rb < n_real ? limit_of(rb) : 0;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    float o[D / 8][4];
#pragma unroll
    for (int db = 0; db < D / 8; ++db)
      o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const unsigned char* st = arrive(it);
      const unsigned char* kt = st;
      const unsigned char* vt = st + L::TILE;
      if constexpr (I8) {
        // dequantize the int8 tile into a bf16 tile, T(float(q8) * s)
        const float* sc = reinterpret_cast<const float*>(st + 2 * L::TILE);
        constexpr int C8 = D / 8;               // 8-element groups a row
        for (int i = tid; i < 2 * TT * C8; i += kThreads) {
          const int w = i / (TT * C8), rem = i % (TT * C8);
          const int tt = rem / C8, c8 = rem % C8;
          const uint2 raw = *reinterpret_cast<const uint2*>(
              st + w * L::TILE + tt * D + swz<L::CPR>(tt, c8 >> 1) * 16
              + (c8 & 1) * 8);
          float x[8];
          const float s = sc[w * TT + tt];
          dequant4<__nv_bfloat16>(raw.x, s, x);
          dequant4<__nv_bfloat16>(raw.y, s, x + 4);
          const uint4 pk = {pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                            pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7])};
          *reinterpret_cast<uint4*>(conv + w * TT * D * 2 + tt * D * 2
                                    + (swz<C8>(tt, c8) << 4)) = pk;
        }
        __syncthreads();
        kt = conv;
        vt = conv + TT * D * 2;
      }
      const int tb = t_begin + it * TT;
      if (live) {
        // S = Q K^T over the tile's TT tokens
        float s[TT / 8][4];
#pragma unroll
        for (int nb = 0; nb < TT / 8; ++nb)
          s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
        const uint32_t kbase = smem_u32(kt);
#pragma unroll
        for (int nb = 0; nb < TT / 8; ++nb) {
          const int row = nb * 8 + (lane & 7);
#pragma unroll
          for (int kp = 0; kp < D / 32; ++kp) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(kbase + row * (D * 2)
                        + (swz<D / 8>(row, kp * 4 + (lane >> 3)) << 4),
                    b0, b1, b2, b3);
            mma16816(s[nb], qa[2 * kp], b0, b1);
            mma16816(s[nb], qa[2 * kp + 1], b2, b3);
          }
        }
        // mask, then the online softmax of rows ra and rb
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < TT / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = tb + nb * 8 + 2 * t4 + e;
            s[nb][e] = col < lim_a ? s[nb][e] * p.scale_log2 : -INFINITY;
            s[nb][2 + e] =
                col < lim_b ? s[nb][2 + e] * p.scale_log2 : -INFINITY;
            mx_a = fmaxf(mx_a, s[nb][e]);
            mx_b = fmaxf(mx_b, s[nb][2 + e]);
          }
        }
#pragma unroll
        for (int o2 = 1; o2 < 4; o2 <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
        }
        const float n_a = fmaxf(m_a, mx_a), n_b = fmaxf(m_b, mx_b);
        // a row that has seen nothing yet keeps p = 0 (never -inf - -inf)
        const float u_a = n_a == -INFINITY ? 0.f : n_a;
        const float u_b = n_b == -INFINITY ? 0.f : n_b;
        const float al_a = exp2f(m_a - u_a), al_b = exp2f(m_b - u_b);
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int nb = 0; nb < TT / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[nb][e] = exp2f(s[nb][e] - u_a);
            s[nb][2 + e] = exp2f(s[nb][2 + e] - u_b);
            sum_a += s[nb][e];
            sum_b += s[nb][2 + e];
          }
        }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
        m_a = n_a;
        m_b = n_b;
#pragma unroll
        for (int db = 0; db < D / 8; ++db) {
          o[db][0] *= al_a;
          o[db][1] *= al_a;
          o[db][2] *= al_b;
          o[db][3] *= al_b;
        }
        // O += P V, P rounded to bf16 as the A operand from registers
        const uint32_t vbase = smem_u32(vt);
#pragma unroll
        for (int kk = 0; kk < TT / 16; ++kk) {
          const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                 pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                 pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                 pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_trans(vbase + row * (D * 2)
                              + (swz<D / 8>(row, dp * 2 + (lane >> 4)) << 4),
                          b0, b1, b2, b3);
            mma16816(o[2 * dp], a, b0, b1);
            mma16816(o[2 * dp + 1], a, b2, b3);
          }
        }
      }
      __syncthreads();   // the stage (and bf16 tile) before they refill
    }
    // each thread summed its own columns: the row's l over the quad
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      const float lr = h ? l_b : l_a, mr = h ? m_b : m_a;
      if (direct) {
        if (r >= n_rows) continue;
        __nv_bfloat16* dst =
            reinterpret_cast<__nv_bfloat16*>(ob) + row_off(r) + 2 * t4;
#pragma unroll
        for (int db = 0; db < D / 8; ++db) {
          const float x0 = lr == 0.f ? 0.f : o[db][2 * h] / lr;
          const float x1 = lr == 0.f ? 0.f : o[db][2 * h + 1] / lr;
          *reinterpret_cast<uint32_t*>(dst + db * 8) = pack_bf16(x0, x1);
        }
      } else {
        if (r >= n_real) continue;
        float* dst = p.part_acc + (slot0 + r) * D + 2 * t4;
#pragma unroll
        for (int db = 0; db < D / 8; ++db)
          *reinterpret_cast<float2*>(dst + db * 8) =
              make_float2(o[db][2 * h], o[db][2 * h + 1]);
        if (t4 == 0) {
          p.part_ml[slot0 + r] = mr;
          p.part_ml[l_off + slot0 + r] = lr;
        }
      }
    }
  }
}

template <typename T, typename P, int D, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_attention_decode_kernel(const __grid_constant__ Params p) {
  paged_body<T, P, D, ROWS, false>(p);
}

template <typename P, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_mma_kernel(const __grid_constant__ Params p) {
  paged_body<__nv_bfloat16, P, D, kDecRows, true>(p);
}

// One warp per output row (b, j, q head): merge the row's split
// partials in split order, each weighted by 2^(m_s - max m); splits that
// saw no column (m = -inf) are skipped.  Pad queries, rows with len == 0
// and rows that saw no column anywhere are written as zeros.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kCombineWarps)
paged_attention_combine_kernel(const __grid_constant__ Params p) {
  constexpr int DPL = D / 32;
  const int lane = threadIdx.x & 31;
  const size_t o = (size_t)blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (o >= (size_t)p.batch * p.max_q * p.q_heads) return;
  const int h = (int)(o % p.q_heads);
  const int j = (int)((o / p.q_heads) % p.max_q);
  const int b = (int)(o / ((size_t)p.q_heads * p.max_q));
  const int len = p.lens[b], qlen = p.q_lens[b];
  float acc[DPL], lsum = 0.f;
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
  if (j < qlen && len > 0) {
    const int group = p.q_heads / p.kv_heads;
    const int rows_bh = p.max_q * group;
    const size_t stride = (size_t)p.batch * p.kv_heads * rows_bh;
    const size_t slot = ((size_t)b * p.kv_heads + h / group) * rows_bh
                        + (size_t)j * group + h % group;
    const float* pm = p.part_ml + slot;
    const float* pl = pm + stride * p.n_split;
    float mx = -INFINITY;
    for (int s = lane; s < p.n_split; s += 32)
      mx = fmaxf(mx, pm[s * stride]);
    mx = warp_max(mx);
    if (mx != -INFINITY) {
      for (int s = 0; s < p.n_split; ++s) {
        const float ms = pm[s * stride];
        if (ms == -INFINITY) continue;
        const float f = exp2f(ms - mx);
        lsum = fmaf(f, pl[s * stride], lsum);
        const float* a = p.part_acc + (s * stride + slot) * D + lane * DPL;
        float v[DPL];
        if constexpr (DPL == 4) {
          const float4 x = *reinterpret_cast<const float4*>(a);
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(a);
          v[0] = x.x; v[1] = x.y;
        }
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[e] = fmaf(f, v[e], acc[e]);
      }
    }
  }
  T* dst = static_cast<T*>(p.out) + o * D + lane * DPL;
#pragma unroll
  for (int e = 0; e < DPL; ++e)
    dst[e] = from_float<T>(lsum == 0.f ? 0.f : acc[e] / lsum);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// ROWS: 1, 4 or 16 (the CUDA-core kernel's rows a block); MMA: the
// tensor-core kernel, 64 rows a block
template <typename T, typename P, int D, int ROWS, bool MMA>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<P, D, ROWS, MMA>;
  constexpr int R = MMA ? kMmaRows : ROWS;
  const size_t smem = L::bytes(p.split_tokens / p.page_size);
  const int rows = p.max_q * (p.q_heads / p.kv_heads);
  const dim3 grid((rows + R - 1) / R, p.n_split, p.batch * p.kv_heads);
  static size_t allowed = 48 << 10;   // per instantiation
  cudaError_t err;
  if constexpr (MMA) {
    err = allow_smem(paged_attention_mma_kernel<P, D>, smem, allowed);
    if (err != cudaSuccess) return err;
    paged_attention_mma_kernel<P, D><<<grid, kThreads, smem, stream>>>(p);
  } else {
    err = allow_smem(paged_attention_decode_kernel<T, P, D, ROWS>, smem,
                     allowed);
    if (err != cudaSuccess) return err;
    paged_attention_decode_kernel<T, P, D, ROWS>
        <<<grid, kThreads, smem, stream>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  const size_t n_out = (size_t)p.batch * p.max_q * p.q_heads;
  paged_attention_combine_kernel<T, D>
      <<<(unsigned)((n_out + kCombineWarps - 1) / kCombineWarps),
         32 * kCombineWarps, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_rows(const Params& p, int head_dim, int rows_per_block,
                        cudaStream_t s) {
#define PAGED_LAUNCH(D, ROWS, M)                                           \
  if (head_dim == D && rows_per_block == (M ? kMmaRows : ROWS))            \
    return launch<T, P, D, ROWS, M>(p, s)
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    PAGED_LAUNCH(128, 1, false);
    PAGED_LAUNCH(64, 1, false);
    PAGED_LAUNCH(128, 4, false);
    PAGED_LAUNCH(64, 4, false);
    PAGED_LAUNCH(128, kDecRows, true);
    PAGED_LAUNCH(64, kDecRows, true);
  }
  PAGED_LAUNCH(128, kDecRows, false);
  PAGED_LAUNCH(64, kDecRows, false);
#undef PAGED_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype 0 = f32, 1 = bf16; head_dim 64 or 128.  Every tensor contiguous.
// kv_int8: the pages are int8 and k_scales/v_scales their f32 scale
// pools (else both are ignored).  The plan: `split_tokens` (a multiple
// of page_size) columns a split, `n_split` splits covering table_width *
// page_size; with n_split > 1, part_acc (n_split * batch * kv_heads *
// max_q * group * head_dim f32) and part_ml (twice n_split * batch *
// kv_heads * max_q * group f32) are the partials' workspace.
// rows_per_block: 1, 4 or 16 (bf16: all three; f32: 16) selects the
// CUDA-core kernel, 64 (bf16 only) the tensor-core kernel.  Returns
// cudaGetLastError() after the launches (0 = launched).
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* lens,
                        const void* q_lens, const void* tables, void* out,
                        void* part_acc, void* part_ml, int batch, int max_q,
                        int q_heads, int kv_heads, int head_dim,
                        int page_size, int total_pages, int table_width,
                        int split_tokens, int n_split, float scale,
                        int dtype, int kv_int8, int rows_per_block,
                        void* stream) {
  if (page_size <= 0 || split_tokens <= 0 || split_tokens % page_size
      || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kp = k_pages;
  p.vp = v_pages;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lens = static_cast<const int*>(lens);
  p.q_lens = static_cast<const int*>(q_lens);
  p.tables = static_cast<const int*>(tables);
  p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.batch = batch;
  p.max_q = max_q;
  p.q_heads = q_heads;
  p.kv_heads = kv_heads;
  p.page_size = page_size;
  p.page_shift = (page_size & (page_size - 1)) ? -1 : __builtin_ctz(page_size);
  p.total_pages = total_pages;
  p.table_width = table_width;
  p.split_tokens = split_tokens;
  p.n_split = n_split;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1)
    err = kv_int8 ? launch_rows<bf16, int8_t>(p, head_dim, rows_per_block, s)
                  : launch_rows<bf16, bf16>(p, head_dim, rows_per_block, s);
  if (dtype == 0)
    err = kv_int8 ? launch_rows<float, int8_t>(p, head_dim, rows_per_block, s)
                  : launch_rows<float, float>(p, head_dim, rows_per_block, s);
  return (int)err;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
