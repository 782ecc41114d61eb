// Reductions shared by the port's reduction kernels. Nothing here uses
// atomics, so each kernel's sums are the same bits from run to run.
//
// * warp_sum: a warp's sum by xor shuffles, every lane left with the same
//   value. Used by round_stats.cu, round_stats_q.cu, batched_dot.cu and
//   grad_dot.cu.
// * stats_stage2: the second launch of a two-stage reduction. Stage 1
//   leaves one partial per (column block, sum) in a (blocks, S) scratch
//   buffer; stats_stage2 sums those over blocks in a fixed order. Used by
//   batched_dot.cu and grad_dot.cu (round_stats.cu has its own second
//   stage, its header says why; round_stats_q.cu sums its blocks in the
//   same launch).
#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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
