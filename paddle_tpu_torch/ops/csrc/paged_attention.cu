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
// per kv head).  What its design does about that: one block per
// (query tile, kv head, row) streams the row's pages through shared
// memory in 32-token tiles with 16-byte loads, every query of the GQA
// group and of the span reuses each tile while it is resident (the JAX
// kernel's group x span fold), tiles past the last visible column of
// the block's queries are never read, and scores, softmax state and the
// output accumulate in f32.  Splitting long contexts across blocks
// (split-KV) and tensor-core products are later work.
//
// int8 mode (`_decode_kernel(quantized=True)`): pages hold int8 values
// with one f32 scale per slot and head (scale pools (kv_heads,
// total_pages, page_size, 1)).  Each element is dequantized while its tile
// is staged as T(float(q8) * s), rounded through the compute type before
// any dot, as `dequantize_kv` does for every other consumer, so attention
// sees bit-identical K/V to prefill's round trip.  The tile reads a
// quarter (f32) or half (bf16) of the page bytes plus the scales.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMaskValue = -0.7f * 3.40282346638528859812e+38f;

constexpr int kRows = 16;      // query rows (span position x group) per block
constexpr int kTile = 32;      // kv tokens per tile: one lane per token
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  constexpr int kN = 16 / sizeof(T);
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kN; ++i) dst[i] = to_float(e[i]);
}

// 16 int8 page elements dequantized with their slot's scale, each
// rounded through the compute type T
template <typename T>
__device__ __forceinline__ void load16_int8(const int8_t* src, float s,
                                            float* dst) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    dst[i] = to_float(from_float<T>(static_cast<float>(e[i]) * s));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q/out (batch, max_q, q_heads, D); pages (kv_heads, total_pages,
// page_size, D) of type P (T, or int8 with k/v_scales pools
// (kv_heads, total_pages, page_size)); lens/q_lens (batch,); tables
// (batch, table_width).  Block (x, h, b): query rows x*kRows .. of row b,
// kv head h, where query row r is span position r / group of q head
// h * group + r % group.
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                       const P* __restrict__ vp,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ lens,
                       const int* __restrict__ q_lens,
                       const int* __restrict__ tables, T* __restrict__ out,
                       int max_q, int q_heads, int kv_heads, int page_size,
                       int total_pages, int table_width, float scale) {
  constexpr int DP = D + 1;              // padded rows: conflict-free reads
  constexpr int VEC = 16 / sizeof(T);     // q elements per 16-byte load
  constexpr int PVEC = 16 / sizeof(P);    // page elements per 16-byte load
  constexpr int TPD = kThreads / D;      // threads sharing one output dim
  constexpr int RPT = kRows / TPD;       // output rows per thread
  __shared__ float qs[kRows][DP];
  __shared__ float ks[kTile][DP];
  __shared__ float vs[kTile][DP];
  __shared__ float ps[kRows][kTile + 1];
  __shared__ float row_scale[kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = q_heads / kv_heads;
  const int r0 = blockIdx.x * kRows;
  const int len = lens[b], qlen = q_lens[b];
  const int n_rows = min(kRows, max_q * group - r0);  // rows in the bucket
  const int n_real = min(n_rows, qlen * group - r0);  // rows of real queries

  const size_t row_stride = (size_t)q_heads * D;
  const T* qb = q + (size_t)b * max_q * row_stride;
  T* ob = out + (size_t)b * max_q * row_stride;
  auto row_off = [&](int r) -> size_t {
    const int rr = r0 + r;
    return (size_t)(rr / group) * row_stride
           + (size_t)(hk * group + rr % group) * D;
  };

  if (n_real <= 0 || len <= 0) {
    for (int i = tid; i < n_rows * D; i += kThreads)
      ob[row_off(i / D) + i % D] = from_float<T>(0.f);
    return;
  }

  for (int i = tid; i < kRows * (D / VEC); i += kThreads) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    float tmp[VEC];
    if (r < n_real) {
      load16(qb + row_off(r) + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) qs[r][c + e] = tmp[e];
  }

  // the block's last real query sees the most columns
  const int j_last = (r0 + n_real - 1) / group;
  const int kv_end = min(len, len - qlen + 1 + j_last);

  // softmax state of rows warp + kWarps * i, replicated across the lanes
  float m[kRows / kWarps], l[kRows / kWarps];
#pragma unroll
  for (int i = 0; i < kRows / kWarps; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int dim = tid % D, rsub = tid / D;   // output rows rsub + TPD * i
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  const int* tab = tables + (size_t)b * table_width;
  const size_t head_slot = (size_t)hk * total_pages * page_size;

  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kTile * (D / PVEC); i += kThreads) {
      const int tt = i / (D / PVEC), c = (i % (D / PVEC)) * PVEC;
      const int t = t0 + tt;
      float tk[PVEC], tv[PVEC];
      if (t < kv_end) {
        const int page = tab[t / page_size];
        const size_t slot = head_slot + (size_t)page * page_size
                            + t % page_size;
        const size_t off = slot * D + c;
        if constexpr (std::is_same<P, int8_t>::value) {
          load16_int8<T>(kp + off, k_scales[slot], tk);
          load16_int8<T>(vp + off, v_scales[slot], tv);
        } else {
          load16(kp + off, tk);
          load16(vp + off, tv);
        }
      } else {
#pragma unroll
        for (int e = 0; e < PVEC; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < PVEC; ++e) {
        ks[tt][c + e] = tk[e];
        vs[tt][c + e] = tv[e];
      }
    }
    __syncthreads();

    // scores: warp w takes rows w, w + kWarps, ...; lane = kv token
#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) {
      const int r = warp + kWarps * i;
      if (r >= n_real) break;               // uniform across the warp
      float s = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) s = fmaf(qs[r][e], ks[lane][e], s);
      const int j = (r0 + r) / group;
      const int limit = min(len, len - qlen + 1 + j);
      s = (t0 + lane < limit) ? s * scale : kMaskValue;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float alpha = expf(m[i] - m_new);
      const float p = expf(s - m_new);
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
      // p meets V in the working type, as the JAX kernel casts it
      ps[r][lane] = to_float(from_float<T>(p));
      if (lane == 0) row_scale[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rsub + TPD * i;
      if (r >= n_real) break;
      float a = acc[i] * row_scale[r];
#pragma unroll 8
      for (int c = 0; c < kTile; ++c) a = fmaf(ps[r][c], vs[c][dim], a);
      acc[i] = a;
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRows / kWarps; ++i) {
    const int r = warp + kWarps * i;
    if (r < n_real && lane == 0) row_scale[r] = l[i] == 0.f ? 1.f : l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rsub + TPD * i;
    if (r >= n_rows) break;
    const float val = r < n_real ? acc[i] / row_scale[r] : 0.f;
    ob[row_off(r) + dim] = from_float<T>(val);
  }
}

template <typename T, typename P, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* lens,
                   const int* q_lens, const int* tables, void* out,
                   int batch, int max_q, int q_heads, int kv_heads,
                   int page_size, int total_pages, int table_width,
                   float scale, cudaStream_t stream) {
  const int group = q_heads / kv_heads;
  dim3 grid((max_q * group + kRows - 1) / kRows, kv_heads, batch);
  paged_attention_kernel<T, P, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), ks, vs, lens, q_lens, tables,
      static_cast<T*>(out), max_q, q_heads, kv_heads, page_size, total_pages,
      table_width, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = f32, 1 = bf16; head_dim 64 or 128.  Every tensor contiguous.
// kv_int8: the pages are int8 and k_scales/v_scales their f32 scale
// pools (else both are ignored).  Returns cudaGetLastError() after the
// launch (0 = launched).
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* lens,
                        const void* q_lens, const void* tables, void* out,
                        int batch, int max_q, int q_heads, int kv_heads,
                        int head_dim, int page_size, int total_pages,
                        int table_width, float scale, int dtype, int kv_int8,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* ln = static_cast<const int*>(lens);
  const int* ql = static_cast<const int*>(q_lens);
  const int* tb = static_cast<const int*>(tables);
#define PAGED_LAUNCH(T, P, D)                                              \
  return (int)launch<T, P, D>(q, k_pages, v_pages, ks, vs, ln, ql, tb,     \
                              out, batch, max_q, q_heads, kv_heads,        \
                              page_size, total_pages, table_width, scale, s)
#define PAGED_DTYPE(T)                                                     \
  if (kv_int8 && head_dim == 128) PAGED_LAUNCH(T, int8_t, 128);            \
  if (kv_int8 && head_dim == 64) PAGED_LAUNCH(T, int8_t, 64);              \
  if (!kv_int8 && head_dim == 128) PAGED_LAUNCH(T, T, 128);                \
  if (!kv_int8 && head_dim == 64) PAGED_LAUNCH(T, T, 64)
  if (dtype == 1) { PAGED_DTYPE(__nv_bfloat16); }
  if (dtype == 0) { PAGED_DTYPE(float); }
#undef PAGED_DTYPE
#undef PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
