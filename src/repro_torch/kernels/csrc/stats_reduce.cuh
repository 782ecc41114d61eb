// Block and grid reductions of the wire statistics kernels
// (round_stats_q.cu; round_stats.cu takes warp_sum only, its header says
// why). Stage 1 of each kernel leaves one partial per (column block,
// statistic) in a (blocks, 2K+1) scratch buffer; stats_stage2 sums those
// over blocks in a fixed order. Nothing here uses atomics, so the
// statistics are the same bits from run to run.
#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum one value over the block (every thread must call it) and write the
// sum to *out from thread 0. red holds at least Threads / 32 floats.
template <int Threads>
__device__ __forceinline__ void block_sum_to(float v, float* red,
                                             float* out) {
  constexpr int kWarps = Threads / 32;
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w];
    *out = s;
  }
  __syncthreads();
}

// The block's sums of KC per-thread dots and square sums, for clients
// k0 .. k0+KC-1 (those below K), written to out[k] and out[K + k]. red
// holds Threads / 32 rows of 2 * KC floats. Every thread must call it.
template <int Threads, int KC>
__device__ __forceinline__ void block_store_partials(float (&dot)[KC],
                                                     float (&sq)[KC],
                                                     float (*red)[2 * KC],
                                                     float* out, int k0,
                                                     int K) {
  constexpr int kWarps = Threads / 32;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    dot[j] = warp_sum(dot[j]);
    sq[j] = warp_sum(sq[j]);
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      red[threadIdx.x / 32][j] = dot[j];
      red[threadIdx.x / 32][KC + j] = sq[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * KC) {
    const int j = threadIdx.x;
    const int k = k0 + j % KC;
    if (k < K) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][j];
      out[j < KC ? k : K + k] = s;
    }
  }
  __syncthreads();
}

// One block per statistic: a strided sum over the blocks' partials in a
// fixed order, then a fixed shared-memory tree.
template <int Threads>
__global__ void __launch_bounds__(Threads)
stats_stage2(const float* __restrict__ part, float* __restrict__ out, int S,
             long long nblocks) {
  __shared__ float s[Threads];
  const int j = blockIdx.x;
  float acc = 0.f;
  for (long long b = threadIdx.x; b < nblocks; b += Threads)
    acc += part[b * S + j];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int off = Threads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = s[0];
}

}  // namespace repro
