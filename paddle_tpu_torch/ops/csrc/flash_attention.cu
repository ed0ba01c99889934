// Flash-attention forward for Hopper (sm_90a): tiled online softmax,
// returning the output and the f32 log-sum-exp.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (launched by `flash_attention_forward`).  Same contract: causal mask
// bottom-right aligned at offset sk - sq, kv columns past sk masked with
// the finite DEFAULT_MASK_VALUE, GQA through kv head h / group, a row
// whose softmax sum is zero writes zeros.
//
// What bounds it on the H100: at prefill lengths the work is
// 4 * sq * sk * d operations per head (halved under the causal mask)
// against (2 * sq + 2 * sk) * d elements moved, so it is bound by
// operations.  This first version computes its products in f32 on the
// CUDA cores, not the tensor cores, so it runs far below the bf16
// tensor-core peak.  What its design does about that: each block keeps a
// 64-row query tile resident in shared memory and streams 32-column K/V
// tiles past it (each K/V element is read once per query tile, not once
// per query), every thread accumulates a 4x4 score tile and a 4x(d/8)
// output tile in registers (8 shared loads feed 16 FMAs), tiles right of
// the causal diagonal are never loaded, and shared rows are padded by
// one float so no warp's column read hits one bank twice.  Moving the
// two products onto wgmma is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
// lse: contiguous (b, h, sq) f32.  dtype 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, int batch, int heads,
                        int kv_heads, int sq, int sk, int head_dim,
                        const int64_t* strides, int causal, float scale,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, l, batch, heads, kv_heads,
                                      sq, sk, strides, causal, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, l, batch, heads, kv_heads,
                                     sq, sk, strides, causal, scale, s);
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
