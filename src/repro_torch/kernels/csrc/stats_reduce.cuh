// Reductions shared by the port's reduction kernels. Nothing here uses
// atomics, so each kernel's sums are the same bits from run to run.
//
// * warp_sum: a warp's sum by xor shuffles, every lane left with the same
//   value. Used by round_stats.cu, round_stats_q.cu, batched_dot.cu and
//   grad_dot.cu.
// * butterfly: two rows' (d, q) sums of a warp in 6 xor shuffles. Used by
//   the statistics kernels that keep two rows of a warp in flight:
//   round_stats.cu's f32 and bf16 kernels and round_stats_q.cu.
// * stats_stage2: the second launch of a two-stage reduction. Stage 1
//   leaves one partial per (column block, sum) in a (blocks, S) scratch
//   buffer; stats_stage2 sums those over blocks in a fixed order. Used by
//   batched_dot.cu.
// * stats_sum_kernel, launched by launch_stats_sum (or with the first
//   kernel by launch_stats): the second launch over
//   statistic-major partials, (S, blocks), each statistic's one
//   contiguous run. It is a programmatic dependent launch: its blocks
//   start while the first grid still runs (that grid executes
//   griddepcontrol.launch_dependents) and wait in griddepcontrol.wait
//   until it has finished and its writes are visible, which hides most of
//   a second launch's start. Used by round_stats.cu (f32 and bf16 x),
//   round_stats_q.cu and grad_dot.cu.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kSumThreads = 256;  // stats_sum_kernel's block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The warp's sums of two rows' (d, q) pairs by a butterfly in a fixed
// order, 6 shuffles: lane l ends with row (l >> 4) & 1's d (bit 3 clear)
// or q (bit 3 set).
__device__ __forceinline__ float butterfly(float d0, float q0, float d1,
                                           float q1, int lane) {
  const bool up = lane & 16, mid = lane & 8;
  const float a = (up ? d1 : d0) +
                  __shfl_xor_sync(0xffffffffu, up ? d0 : d1, 16);
  const float b = (up ? q1 : q0) +
                  __shfl_xor_sync(0xffffffffu, up ? q0 : q1, 16);
  float c = (mid ? b : a) + __shfl_xor_sync(0xffffffffu, mid ? a : b, 8);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    c += __shfl_xor_sync(0xffffffffu, c, off);
  return c;
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

// out[j] = the sum of part[j, 0..blocks), one block a statistic: thread t
// adds blocks t, t + 256, .. in order (their loads 8 at a time), then the
// warps' sums by shuffles and the 8 warps' in order. It waits for the
// first grid's writes.
template <int Threads>
__global__ void __launch_bounds__(Threads)
stats_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                 long long blocks) {
  __shared__ float warps[Threads / 32];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float* p = part + blockIdx.x * blocks;
  float acc = 0.f;
  for (long long b0 = threadIdx.x; b0 < blocks; b0 += 8 * Threads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long b = b0 + u * Threads;
      v[u] = b < blocks ? p[b] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < Threads / 32; ++w) t += warps[w];
    out[blockIdx.x] = t;
  }
}

// stats_sum_kernel over part (S, blocks) into out (S,), as a programmatic
// dependent launch behind the kernel just launched on `stream`.
inline cudaError_t launch_stats_sum(const float* part, float* out, int S,
                                    long long blocks, cudaStream_t stream) {
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(S));
  cfg.blockDim = dim3(kSumThreads);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, stats_sum_kernel<kSumThreads>, part, out, blocks);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// A statistics kernel, kernel(a), over a.blocks blocks of 32 * warps
// threads, each with (warps, 2 a.K + 1) floats of dynamic shared memory,
// then stats_sum_kernel over its statistic-major partials a.part into
// out. Used by round_stats.cu and round_stats_q.cu.
template <typename Args>
cudaError_t launch_stats(void (*kernel)(Args), const Args& a, int warps,
                         float* out, cudaStream_t stream) {
  const long long smem = static_cast<long long>(warps) * (2 * a.K + 1) *
                         static_cast<long long>(sizeof(float));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(a.blocks), 32 * warps,
           static_cast<size_t>(smem), stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_stats_sum(a.part, out, 2 * a.K + 1, a.blocks, stream);
}

}  // namespace repro
