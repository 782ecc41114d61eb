// Gradient statistics (<a, b>, ||a||^2, ||b||^2) of two equally shaped
// arrays, read as flat contiguous vectors of n elements, f32 or bf16
// (both the same type). Sums are f32 whatever the inputs' type.
//
// Replaces the Pallas kernel repro/kernels/grad_dot.py::grad_dot_stats
// (_kernel), which views the inputs as (M, 128) zero-padded rows and adds
// each 512 x 128 block into three (1, 1) accumulators along a sequential
// TPU grid. Here there is no padded copy, and two stages instead of the
// sequential grid:
//
//   Stage 1: every block owns a fixed span of kSpan consecutive elements
//   (the split depends on n alone). Each thread keeps the three sums of
//   its elements in registers; the block reduces them (warp shuffles,
//   then shared memory in a fixed order) and writes three partials.
//   Stage 2: stats_stage2 (stats_reduce.cuh) sums the partials over
//   blocks, one block per statistic, in a fixed order.
//
// No atomics, so the result is the same from run to run.
//
// What bounds it on Hopper: bytes. One read of a and of b (8 bytes per
// element pair in f32), 6 flops per pair: far below the f32 ridge. Loads
// are 16 bytes of f32 (8 of bf16) where both pointers allow it.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "load.cuh"
#include "stats_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;    // consecutive elements per thread and step
// steps per block: 2 gives 813 blocks over the CNN's 1,663,370 params
// and took 13.06 us there against 13.78 with 8 (chip_ab.py, both builds
// in one process, H100 80GB HBM3 at 700 W)
constexpr int kSteps = 2;
constexpr long long kSpan = static_cast<long long>(kThreads) * kCols * kSteps;

template <int VW, typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ base,
                                          long long col, int ncols,
                                          float (&v)[kCols]) {
  const T* p = base + col;
  if (ncols == kCols) {
    repro::load4<VW>(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      v[i] = i < ncols ? repro::load1(p + i) : 0.f;
  }
}

template <int VW, typename T>
__global__ void __launch_bounds__(kThreads)
gdot_stage1(const T* __restrict__ a, const T* __restrict__ b,
            float* __restrict__ part, long long n) {
  __shared__ float red[kWarps][3];
  float dot = 0.f, sa = 0.f, sb = 0.f;
  const long long base = static_cast<long long>(blockIdx.x) * kSpan;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long col =
        base + (static_cast<long long>(s) * kThreads + threadIdx.x) * kCols;
    const int ncols =
        col >= n ? 0 : static_cast<int>(n - col < kCols ? n - col : kCols);
    float av[kCols], bv[kCols];
    load_cols<VW>(a, col, ncols, av);
    load_cols<VW>(b, col, ncols, bv);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      dot = fmaf(av[i], bv[i], dot);
      sa = fmaf(av[i], av[i], sa);
      sb = fmaf(bv[i], bv[i], sb);
    }
  }
  dot = repro::warp_sum(dot);
  sa = repro::warp_sum(sa);
  sb = repro::warp_sum(sb);
  if (threadIdx.x % 32 == 0) {
    red[threadIdx.x / 32][0] = dot;
    red[threadIdx.x / 32][1] = sa;
    red[threadIdx.x / 32][2] = sb;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    part[static_cast<long long>(blockIdx.x) * 3 + threadIdx.x] = s;
  }
}

template <int VW, typename T>
cudaError_t launch(const T* a, const T* b, float* part, float* out,
                   long long n, long long nblocks, cudaStream_t stream) {
  gdot_stage1<VW><<<static_cast<unsigned>(nblocks), kThreads, 0, stream>>>(
      a, b, part, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  repro::stats_stage2<kThreads><<<3, kThreads, 0, stream>>>(part, out, 3,
                                                            nblocks);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* av, const void* bv, float* part, float* out,
             long long n, long long nblocks, cudaStream_t stream) {
  if (n < 1 || nblocks != (n + kSpan - 1) / kSpan || nblocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* a = static_cast<const T*>(av);
  const T* b = static_cast<const T*>(bv);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  int vw = 4;
  while (vw > 1 && addr % (vw * sizeof(T)) != 0) vw /= 2;
  cudaError_t e;
  switch (vw) {
    case 4: e = launch<4>(a, b, part, out, n, nblocks, stream); break;
    case 2: e = launch<2>(a, b, part, out, n, nblocks, stream); break;
    default: e = launch<1>(a, b, part, out, n, nblocks, stream);
  }
  return static_cast<int>(e);
}

}  // namespace

// Stage-1 blocks for n elements; the caller sizes the partials buffer as
// blocks * 3 floats.
extern "C" long long repro_grad_dot_blocks(long long n) {
  return (n + kSpan - 1) / kSpan;
}

// a, b (n,) contiguous, part (blocks * 3,) scratch, out (3,) =
// [<a,b>, ||a||^2, ||b||^2]. bf16 != 0: a and b are bf16 (raw 16-bit
// words), else f32. Returns a cudaError_t: 0 when both launches were
// accepted. Never synchronises.
extern "C" int repro_grad_dot(const void* a, const void* b, float* part,
                              float* out, long long n, int bf16,
                              long long nblocks, cudaStream_t stream) {
  return bf16 ? dispatch<uint16_t>(a, b, part, out, n, nblocks, stream)
              : dispatch<float>(a, b, part, out, n, nblocks, stream);
}
