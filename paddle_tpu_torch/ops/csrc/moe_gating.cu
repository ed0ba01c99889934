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
// the work is a scan across tokens in order.  This first version runs it
// as ONE block that walks token chunks of THREADS tokens in order, one
// token per thread, so it is bound by the chunk loop's barriers (two per
// chunk and round), not by bytes.  What its design does about that: round
// 0 computes every round's choice of its token at once (the gates never
// leave registers and later rounds read back their two words), the
// chunk's exclusive prefix count per expert is one __ballot_sync and
// __popc per expert and warp plus a scan over the warps' counts by one
// thread per expert, and the per-expert fill lives in shared memory
// across chunks and rounds.  A multi-block decoupled look-back scan is
// later work.
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

// EP: experts padded to a power of two (registers per token);
// THREADS: tokens per chunk
template <int EP, int THREADS>
__global__ void __launch_bounds__(THREADS)
topk_gating_kernel(const float* __restrict__ logits, int T, int E, int top_k,
                   int capacity, int* __restrict__ eidx,
                   int* __restrict__ pos, int* __restrict__ keep,
                   float* __restrict__ w, int* __restrict__ fill0,
                   float* __restrict__ gsum) {
  constexpr int W = THREADS / 32;
  __shared__ int cnt[W][EP];      // the chunk's assignments per warp, expert
  __shared__ int base[W][EP];     // first slot of each warp's assignments
  __shared__ int fill[EP];        // slots taken so far per expert
  __shared__ float gacc[W][EP];   // round 0: gate mass per warp, expert
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int i = tid; i < W * EP; i += THREADS) (&gacc[0][0])[i] = 0.f;
  if (tid < EP) fill[tid] = 0;
  __syncthreads();

  for (int r = 0; r < top_k; ++r) {
    const int64_t row = static_cast<int64_t>(r) * T;
    for (int chunk = 0; chunk < T; chunk += THREADS) {
      const int t = chunk + tid;
      const bool valid = t < T;
      int idx = 0;
      float val = 0.f;
      if (r == 0) {
        float g[EP];
        if (valid) {
          const float* x = logits + static_cast<int64_t>(t) * E;
          float m = -INFINITY;
#pragma unroll
          for (int e = 0; e < EP; ++e) {
            g[e] = e < E ? x[e] : -INFINITY;
            m = fmaxf(m, g[e]);
          }
          float s[EP];
#pragma unroll
          for (int e = 0; e < EP; ++e) {
            g[e] = expf(g[e] - m);          // padded entries: exactly 0
            s[e] = g[e];
          }
#pragma unroll
          for (int o = EP / 2; o > 0; o >>= 1) {
#pragma unroll
            for (int i = 0; i < o; ++i) s[i] += s[i + o];
          }
#pragma unroll
          for (int e = 0; e < EP; ++e) g[e] = g[e] / s[0];
          // every round's choice of this token: masked argmax, ties to
          // the first index, a chosen gate counting as 0
          uint64_t chosen = 0;
          for (int j = 0; j < top_k; ++j) {
            float best = g[0];
            float best_gate = g[0];
            int bi = 0;
            if (chosen & 1ull) best = 0.f;
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
            if (j == 0) {
              idx = bi;
              val = best_gate;
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < EP; ++e) g[e] = 0.f;
        }
        // gate mass of the chunk's valid tokens, per warp and expert, in
        // a fixed order (the same sum on every run)
#pragma unroll
        for (int e = 0; e < EP; ++e) {
          if (e < E) {
            float v = g[e];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              v += __shfl_xor_sync(kFull, v, o);
            if (lane == 0) gacc[warp][e] += v;
          }
        }
      } else if (valid) {
        idx = eidx[row + t];
        val = w[row + t];
      }

      // exclusive prefix count of this round's choices within the chunk
      int below = 0;
      for (int e = 0; e < E; ++e) {
        const bool mine = valid && idx == e;
        const unsigned m = __ballot_sync(kFull, mine);
        if (mine) below = __popc(m & lanes_below);
        if (lane == 0) cnt[warp][e] = __popc(m);
      }
      __syncthreads();
      if (tid < E) {
        int run = fill[tid];
        for (int i = 0; i < W; ++i) {
          base[i][tid] = run;
          run += cnt[i][tid];
        }
        fill[tid] = run;
      }
      __syncthreads();
      if (valid) {
        const int p = base[warp][idx] + below;
        const int kept = p < capacity;
        pos[row + t] = p;
        keep[row + t] = kept;
        w[row + t] = val * static_cast<float>(kept);
      }
    }
    // fill[] is written only by its own thread, which wrote it last
    if (r == 0 && tid < E) fill0[tid] = fill[tid];
  }
  __syncthreads();
  if (tid < E) {
    float s = 0.f;
    for (int i = 0; i < W; ++i) s += gacc[i][tid];
    gsum[tid] = s;
  }
}

template <int EP, int THREADS>
int launch(const float* logits, int T, int E, int top_k, int capacity,
           int* eidx, int* pos, int* keep, float* w, int* fill0, float* gsum,
           cudaStream_t stream) {
  topk_gating_kernel<EP, THREADS><<<1, THREADS, 0, stream>>>(
      logits, T, E, top_k, capacity, eidx, pos, keep, w, fill0, gsum);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// logits: contiguous [T, E] f32, 1 <= E <= 64.  eidx, pos, keep:
// contiguous [top_k, T] int32; w: [top_k, T] f32 (capacity-masked, not
// normalized); fill0: [E] int32; gsum: [E] f32.
// Returns cudaGetLastError() after the launch (0 = launched).
int moe_topk_gating_fwd(const void* logits, int T, int E, int top_k,
                        int capacity, void* eidx, void* pos, void* keep,
                        void* w, void* fill0, void* gsum, void* stream) {
  const float* x = static_cast<const float*>(logits);
  int* ei = static_cast<int*>(eidx);
  int* po = static_cast<int*>(pos);
  int* ke = static_cast<int*>(keep);
  float* wt = static_cast<float*>(w);
  int* f0 = static_cast<int*>(fill0);
  float* gs = static_cast<float*>(gsum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || E < 1 || top_k < 1) return (int)cudaErrorInvalidValue;
  if (E <= 8)
    return launch<8, 1024>(x, T, E, top_k, capacity, ei, po, ke, wt, f0, gs,
                           s);
  if (E <= 16)
    return launch<16, 512>(x, T, E, top_k, capacity, ei, po, ke, wt, f0, gs,
                           s);
  if (E <= 32)
    return launch<32, 256>(x, T, E, top_k, capacity, ei, po, ke, wt, f0, gs,
                           s);
  if (E <= 64)
    return launch<64, 256>(x, T, E, top_k, capacity, ei, po, ke, wt, f0, gs,
                           s);
  return (int)cudaErrorInvalidValue;
}

const char* moe_gating_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
