// Top-k MoE gating for Hopper (sm_90a): softmax, top_k masked-argmax
// rounds, round-major capacity slots, keep mask and raw weights, the
// round-0 fill and the per-expert gate mass, in one launch.
//
// Replaces: paddle_tpu/ops/pallas/moe_gating.py `_round_kernel`, which
// `topk_gating_pallas` launches once per round.  Same contract as the
// routing oracle (`_topk_routing`): gates = softmax(logits); in round j
// each token takes the first index of the largest remaining gate, a
// chosen gate being masked by multiplying it by 0 (so where every other
// gate has underflowed to 0 the first expert is picked again, with its
// unmasked gate as the weight); an assignment's slot counts every earlier
// assignment to its expert, earlier rounds first, then earlier tokens;
// it is kept when the slot is below the capacity.
//
// What bounds it on the H100: bytes, by far.  The function reads T * E
// f32 logits and writes 16 bytes per assignment, kilobytes at E = 8 and
// T <= 8192, which the card moves in well under a microsecond.  But each
// slot depends on every earlier token's choice in every earlier round:
// the work is a scan across tokens.  What the design does about that,
// by the number of tokens (the wrapper picks, `gating_plan` in
// ops/moe_gating.py):
//
//   - T <= 32 (decode): ONE warp, no __syncthreads.  Each lane is a
//     token and computes every round's choice at once (the gates never
//     leave registers).  Per round and expert one __ballot_sync: __popc
//     of the lanes below gives a token's exclusive count, of all lanes
//     the expert's count, which lane e adds to the expert's fill held in
//     its registers (lane e & 31: experts e and e + 32); a token's slot
//     is its expert's fill, shuffled from that lane, plus its count.
//     The gate mass is one xor-shuffle sum per expert.
//     (`topk_gating_warp_kernel`)
//   - T > 32 (prefill): many blocks, a chunk of kChunk tokens each, a
//     token a thread (`topk_gating_chunk_kernel`).  Phase 1: each block
//     computes its tokens' choices in every round, their exclusive
//     counts within the chunk (ballots per warp, the warps' counts
//     scanned in shared memory; kept in `pos` for now), the chunk's
//     count per (round, expert) and gate mass per expert, both to a
//     workspace.  One grid-wide barrier.  Phase 2: a (round, expert)'s
//     base for chunk c is the totals of every earlier round plus the
//     counts of chunks before c in its round; each token adds its base,
//     takes keep and masks its weight.  Block 0 writes the round-0 fill
//     and the gate mass, the chunks' partial sums added in chunk order
//     (each a fixed warp-shuffle and warp order), so two calls are
//     bit-identical.  The grid is at most the blocks the card holds at
//     once and strides over the chunks, so every block is resident and
//     the barrier cannot deadlock.  The barrier's two words (arrivals,
//     generation) persist between calls: the last block to arrive sets
//     the arrivals back to 0, so no launch ever zeroes them.
//
// Softmax order: the exp sum is a pairwise tree over the experts padded
// to a power of two, the order of PyTorch's warp softmax for rows of up
// to 64 entries, and each gate is exp(x - max) / sum with IEEE division,
// so the plain version on the card (torch.softmax) usually gives the same
// gate bits; the routing depends only on the gates' order, which a
// different sum order cannot change except between gates an ulp apart.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpTokens = 32;   // the warp kernel's most tokens
constexpr int kChunk = 256;       // tokens of a chunk, a thread each

// softmax of one token's E logits into g[EP] (padded entries exactly 0)
template <int EP>
__device__ __forceinline__ void token_gates(const float* __restrict__ x,
                                            int E, float* g) {
  float m = -INFINITY;
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    g[e] = e < E ? x[e] : -INFINITY;
    m = fmaxf(m, g[e]);
  }
  float s[EP];
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    g[e] = expf(g[e] - m);
    s[e] = g[e];
  }
#pragma unroll
  for (int o = EP / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < o; ++i) s[i] += s[i + o];
  }
#pragma unroll
  for (int e = 0; e < EP; ++e) g[e] = g[e] / s[0];
}

// every round's choice of token t: masked argmax, ties to the first
// index, a chosen gate counting as 0; eidx and the raw gate w written
// at [j, t]
template <int EP>
__device__ __forceinline__ void token_choices(const float* g, int E,
                                              int top_k, int T, int t,
                                              int* __restrict__ eidx,
                                              float* __restrict__ w) {
  uint64_t chosen = 0;
  for (int j = 0; j < top_k; ++j) {
    float best = (chosen & 1ull) ? 0.f : g[0];
    float best_gate = g[0];
    int bi = 0;
#pragma unroll
    for (int e = 1; e < EP; ++e) {
      if (e < E) {
        const float v = (chosen >> e) & 1ull ? 0.f : g[e];
        if (v > best) {
          best = v;
          best_gate = g[e];
          bi = e;
        }
      }
    }
    chosen |= 1ull << bi;
    eidx[static_cast<int64_t>(j) * T + t] = bi;
    w[static_cast<int64_t>(j) * T + t] = best_gate;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int EP>
__global__ void __launch_bounds__(kWarpTokens)
topk_gating_warp_kernel(const float* __restrict__ logits, int T, int E,
                        int top_k, int capacity, int* __restrict__ eidx,
                        int* __restrict__ pos, int* __restrict__ keep,
                        float* __restrict__ w, int* __restrict__ fill0,
                        float* __restrict__ gsum) {
  const int lane = threadIdx.x;
  const bool valid = lane < T;
  const unsigned lanes_below = (1u << lane) - 1u;
  float g[EP];
  if (valid) {
    token_gates<EP>(logits + static_cast<int64_t>(lane) * E, E, g);
    token_choices<EP>(g, E, top_k, T, lane, eidx, w);
  } else {
#pragma unroll
    for (int e = 0; e < EP; ++e) g[e] = 0.f;
  }
  // gate mass: one fixed shuffle tree per expert
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    if (e < E) {
      const float v = warp_sum(g[e]);
      if (lane == 0) gsum[e] = v;
    }
  }
  // lane e holds the slots taken so far of expert e (fill_lo) and e + 32
  int fill_lo = 0, fill_hi = 0;
  for (int j = 0; j < top_k; ++j) {
    const int64_t o = static_cast<int64_t>(j) * T + lane;
    const int idx = valid ? eidx[o] : -1;
    // the expert's fill before this round, from the lane that holds it
    const int lo = __shfl_sync(kFull, fill_lo, idx & 31);
    const int hi = EP > 32 ? __shfl_sync(kFull, fill_hi, idx & 31) : 0;
    int below = 0;
    for (int e = 0; e < E; ++e) {
      const unsigned m = __ballot_sync(kFull, idx == e);
      if (idx == e) below = __popc(m & lanes_below);
      if (lane == (e & 31)) {
        if (e < 32)
          fill_lo += __popc(m);
        else
          fill_hi += __popc(m);
      }
    }
    if (valid) {
      const int p = (idx >= 32 ? hi : lo) + below;
      const int kept = p < capacity;
      pos[o] = p;
      keep[o] = kept;
      w[o] = w[o] * static_cast<float>(kept);
    }
    if (j == 0) {
      if (lane < E) fill0[lane] = fill_lo;
      if (lane + 32 < E) fill0[lane + 32] = fill_hi;
    }
  }
}

// grid-wide barrier over resident blocks.  bar[0] counts arrivals and
// is 0 between calls (the last block to arrive resets it); bar[1] is a
// generation the waiting blocks watch.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __threadfence();               // this thread's writes, device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();             // read the generation before arriving
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// workspace: cnt [nchunks][top_k][E] int32, then gpart [nchunks][E] f32;
// dynamic shared memory: the chunk's slot bases [top_k][E] int32
template <int EP>
__global__ void __launch_bounds__(kChunk)
topk_gating_chunk_kernel(const float* __restrict__ logits, int T, int E,
                         int top_k, int capacity, int* __restrict__ eidx,
                         int* __restrict__ pos, int* __restrict__ keep,
                         float* __restrict__ w, int* __restrict__ fill0,
                         float* __restrict__ gsum, int* __restrict__ cnt,
                         float* __restrict__ gpart, unsigned* bar) {
  constexpr int W = kChunk / 32;
  extern __shared__ int sbase[];
  __shared__ int wcnt[W][EP];     // a round's assignments per warp, expert
  __shared__ int wbase[W][EP];    // exclusive prefix over the warps
  __shared__ float wg[W][EP];     // gate mass per warp, expert
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int nchunks = (T + kChunk - 1) / kChunk;

  // phase 1: choices, in-chunk counts, the chunk's counts and gate mass
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int t = c * kChunk + tid;
    const bool valid = t < T;
    float g[EP];
    if (valid) {
      token_gates<EP>(logits + static_cast<int64_t>(t) * E, E, g);
      token_choices<EP>(g, E, top_k, T, t, eidx, w);
    } else {
#pragma unroll
      for (int e = 0; e < EP; ++e) g[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EP; ++e) {
      if (e < E) {
        const float v = warp_sum(g[e]);
        if (lane == 0) wg[warp][e] = v;
      }
    }
    for (int j = 0; j < top_k; ++j) {
      const int64_t o = static_cast<int64_t>(j) * T + t;
      const int idx = valid ? eidx[o] : -1;
      int below = 0;
      for (int e = 0; e < E; ++e) {
        const unsigned m = __ballot_sync(kFull, idx == e);
        if (idx == e) below = __popc(m & lanes_below);
        if (lane == 0) wcnt[warp][e] = __popc(m);
      }
      __syncthreads();
      if (tid < E) {
        int run = 0;
        for (int i = 0; i < W; ++i) {
          wbase[i][tid] = run;
          run += wcnt[i][tid];
        }
        cnt[(static_cast<int64_t>(c) * top_k + j) * E + tid] = run;
        if (j == 0) {
          float s = 0.f;
          for (int i = 0; i < W; ++i) s += wg[i][tid];
          gpart[static_cast<int64_t>(c) * E + tid] = s;
        }
      }
      __syncthreads();
      if (valid) pos[o] = wbase[warp][idx] + below;
    }
  }

  grid_barrier(bar);

  // phase 2: every chunk's counts are in; add each slot's base
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    for (int i = tid; i < top_k * E; i += kChunk) {
      const int j = i / E, e = i - (i / E) * E;
      int b = 0;
      for (int r = 0; r < j; ++r)
        for (int cc = 0; cc < nchunks; ++cc)
          b += __ldcg(cnt + (static_cast<int64_t>(cc) * top_k + r) * E + e);
      for (int cc = 0; cc < c; ++cc)
        b += __ldcg(cnt + (static_cast<int64_t>(cc) * top_k + j) * E + e);
      sbase[i] = b;
    }
    __syncthreads();
    const int t = c * kChunk + tid;
    if (t < T) {
      for (int j = 0; j < top_k; ++j) {
        const int64_t o = static_cast<int64_t>(j) * T + t;
        const int p = sbase[j * E + eidx[o]] + pos[o];
        const int kept = p < capacity;
        pos[o] = p;
        keep[o] = kept;
        w[o] = w[o] * static_cast<float>(kept);
      }
    }
    __syncthreads();              // sbase is the next chunk's
  }
  if (blockIdx.x == 0 && tid < E) {
    int f = 0;
    float s = 0.f;
    for (int cc = 0; cc < nchunks; ++cc) {
      f += __ldcg(cnt + static_cast<int64_t>(cc) * top_k * E + tid);
      s += __ldcg(gpart + static_cast<int64_t>(cc) * E + tid);
    }
    fill0[tid] = f;
    gsum[tid] = s;
  }
}

template <int EP>
cudaError_t chunk_grid(int T, int top_k, int E, int* grid, size_t* smem) {
  *smem = static_cast<size_t>(top_k) * E * sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, topk_gating_chunk_kernel<EP>, kChunk, *smem);
  if (err != cudaSuccess) return err;
  const int nchunks = (T + kChunk - 1) / kChunk;
  const int resident = per_sm * sms;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  *grid = nchunks < resident ? nchunks : resident;
  return cudaSuccess;
}

template <int EP>
int launch(const float* logits, int T, int E, int top_k, int capacity,
           int* eidx, int* pos, int* keep, float* w, int* fill0, float* gsum,
           void* workspace, unsigned* bar, cudaStream_t stream) {
  if (T <= kWarpTokens) {
    topk_gating_warp_kernel<EP><<<1, kWarpTokens, 0, stream>>>(
        logits, T, E, top_k, capacity, eidx, pos, keep, w, fill0, gsum);
    return static_cast<int>(cudaGetLastError());
  }
  if (workspace == nullptr || bar == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  size_t smem = 0;
  cudaError_t err = chunk_grid<EP>(T, top_k, E, &grid, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunks = (T + kChunk - 1) / kChunk;
  int* cnt = static_cast<int*>(workspace);
  float* gpart = reinterpret_cast<float*>(
      cnt + static_cast<int64_t>(nchunks) * top_k * E);
  topk_gating_chunk_kernel<EP><<<grid, kChunk, smem, stream>>>(
      logits, T, E, top_k, capacity, eidx, pos, keep, w, fill0, gsum, cnt,
      gpart, bar);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// logits: contiguous [T, E] f32, 1 <= E <= 64.  eidx, pos, keep:
// contiguous [top_k, T] int32; w: [top_k, T] f32 (capacity-masked, not
// normalized); fill0: [E] int32; gsum: [E] f32.  T > 32 also needs
// `workspace`, nchunks * (top_k + 1) * E 32-bit words (nchunks = T / 256
// rounded up; no initial value), and `barrier`, two 32-bit words that
// are 0 before the first call on the device and that only this function
// writes afterwards.  Calls sharing a barrier must not run at once.
// Returns cudaGetLastError() after the launch (0 = launched).
int moe_topk_gating_fwd(const void* logits, int T, int E, int top_k,
                        int capacity, void* eidx, void* pos, void* keep,
                        void* w, void* fill0, void* gsum, void* workspace,
                        void* barrier, void* stream) {
  const float* x = static_cast<const float*>(logits);
  int* ei = static_cast<int*>(eidx);
  int* po = static_cast<int*>(pos);
  int* ke = static_cast<int*>(keep);
  float* wt = static_cast<float*>(w);
  int* f0 = static_cast<int*>(fill0);
  float* gs = static_cast<float*>(gsum);
  unsigned* bar = static_cast<unsigned*>(barrier);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || E < 1 || top_k < 1) return (int)cudaErrorInvalidValue;
  if (E <= 8)
    return launch<8>(x, T, E, top_k, capacity, ei, po, ke, wt, f0, gs,
                     workspace, bar, s);
  if (E <= 16)
    return launch<16>(x, T, E, top_k, capacity, ei, po, ke, wt, f0, gs,
                      workspace, bar, s);
  if (E <= 32)
    return launch<32>(x, T, E, top_k, capacity, ei, po, ke, wt, f0, gs,
                      workspace, bar, s);
  if (E <= 64)
    return launch<64>(x, T, E, top_k, capacity, ei, po, ke, wt, f0, gs,
                      workspace, bar, s);
  return (int)cudaErrorInvalidValue;
}

// The chunk kernel's grid for T tokens (T > 32): the chunks, at most
// the blocks the card holds at once.  Negative: a cudaError_t.
int moe_topk_gating_grid(int T, int E, int top_k) {
  int grid = 0;
  size_t smem = 0;
  cudaError_t err = E <= 8 ? chunk_grid<8>(T, top_k, E, &grid, &smem)
                    : E <= 16 ? chunk_grid<16>(T, top_k, E, &grid, &smem)
                    : E <= 32 ? chunk_grid<32>(T, top_k, E, &grid, &smem)
                              : chunk_grid<64>(T, top_k, E, &grid, &smem);
  return err == cudaSuccess ? grid : -static_cast<int>(err);
}

const char* moe_gating_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
