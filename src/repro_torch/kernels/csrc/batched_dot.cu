// Batched dot products u[k] = <x_k, g> for x (K, N) with row stride ld
// (a view of the rows of a wider buffer is read in place), f32 or bf16,
// and g (N,) f32 or bf16. Sums are f32 whatever the inputs' type.
//
// Replaces the Pallas kernel repro/kernels/weighted_agg.py::batched_dot
// (_bdot_kernel), which accumulates into (tile, 1) output blocks revisited
// along a sequential TPU grid. Here, as in round_stats.cu:
//
//   Stage 1: a grid of column blocks. A block loads its g tile into
//   registers once, then walks the rows in compile-time chunks of KC.
//   Each thread keeps one dot per row of the chunk in registers; the block
//   reduces them (warp shuffles, then shared memory) and writes one
//   partial per (block, row) to scratch.
//   Stage 2: stats_stage2 (stats_reduce.cuh) sums the partials over
//   blocks, one block per row, in a fixed order.
//
// No atomics, so the result is the same from run to run. Any K and any N
// (the ragged column edge is masked); no padded copy of x.
//
// What bounds it on Hopper: bytes. It reads K*N*sizeof(x) + N*sizeof(g)
// bytes and does 2 flops per element of x, far below the f32 ridge. The
// design streams x once with the widest loads that the row stride and
// the pointers allow (16, 8 or 4 bytes of f32; 8, 4 or 2 bytes of bf16)
// and keeps KC rows' loads in flight per thread.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "load.cuh"
#include "stats_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // consecutive columns owned by one thread
constexpr int kTile = kThreads * kCols;
// rows per chunk: KC dots live in registers. 4 took the same time as 8
// at K = 10 (chip_ab.py, H100 80GB HBM3 at 700 W).
constexpr int KC = 8;

// kCols consecutive elements at base + col widened to f32, zeros past the
// ragged edge (ncols < kCols); base + col is aligned to VW elements.
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

template <int VW, typename TX, typename TG>
__global__ void __launch_bounds__(kThreads)
bdot_stage1(const TX* __restrict__ x, const TG* __restrict__ g,
            float* __restrict__ part, int K, long long N, long long ld) {
  __shared__ float red[kWarps][KC];
  float* out = part + static_cast<long long>(blockIdx.x) * K;

  // threads past the edge keep ncols = 0 and contribute zeros: every
  // thread must reach the shuffles and barriers below
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  const int ncols =
      col >= N ? 0 : static_cast<int>(N - col < kCols ? N - col : kCols);
  float gv[kCols];
  load_cols<VW>(g, col, ncols, gv);

  for (int k0 = 0; k0 < K; k0 += KC) {
    float dot[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      dot[j] = 0.f;
      if (k0 + j < K) {  // uniform across the block
        float v[kCols];
        load_cols<VW>(x + static_cast<long long>(k0 + j) * ld, col, ncols, v);
#pragma unroll
        for (int i = 0; i < kCols; ++i) dot[j] = fmaf(v[i], gv[i], dot[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) dot[j] = repro::warp_sum(dot[j]);
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int j = 0; j < KC; ++j) red[threadIdx.x / 32][j] = dot[j];
    }
    __syncthreads();
    if (threadIdx.x < KC && k0 + threadIdx.x < K) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
      out[k0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

template <int VW, typename TX, typename TG>
cudaError_t launch(const TX* x, const TG* g, float* part, float* out, int K,
                   long long N, long long ld, long long nblocks,
                   cudaStream_t stream) {
  bdot_stage1<VW><<<static_cast<unsigned>(nblocks), kThreads, 0, stream>>>(
      x, g, part, K, N, ld);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  repro::stats_stage2<kThreads><<<K, kThreads, 0, stream>>>(part, out, K,
                                                            nblocks);
  return cudaGetLastError();
}

template <typename TX, typename TG>
int dispatch(const void* xv, const void* gv, float* part, float* out, int K,
             long long N, long long ld, long long nblocks,
             cudaStream_t stream) {
  if (K < 1 || N < 1 || ld < N || nblocks != (N + kTile - 1) / kTile ||
      nblocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const TX* x = static_cast<const TX*>(xv);
  const TG* g = static_cast<const TG*>(gv);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  int vw = 4;
  while (vw > 1 && (ld % vw != 0 || xa % (vw * sizeof(TX)) != 0 ||
                    ga % (vw * sizeof(TG)) != 0))
    vw /= 2;
  cudaError_t e;
  switch (vw) {
    case 4: e = launch<4>(x, g, part, out, K, N, ld, nblocks, stream); break;
    case 2: e = launch<2>(x, g, part, out, K, N, ld, nblocks, stream); break;
    default: e = launch<1>(x, g, part, out, K, N, ld, nblocks, stream);
  }
  return static_cast<int>(e);
}

}  // namespace

// Stage-1 blocks for rows of N columns; the caller sizes the partials
// buffer as blocks * K floats.
extern "C" long long repro_batched_dot_blocks(long long N) {
  return (N + kTile - 1) / kTile;
}

// x (K, N) with row stride ld, g (N,), part (blocks * K,) scratch, out
// (K,). x_bf16 / g_bf16 != 0: that array is bf16 (raw 16-bit words), else
// f32. Returns a cudaError_t: 0 when both launches were accepted. Never
// synchronises.
extern "C" int repro_batched_dot(const void* x, const void* g, float* part,
                                 float* out, int K, long long N, long long ld,
                                 int x_bf16, int g_bf16, long long nblocks,
                                 cudaStream_t stream) {
  if (x_bf16)
    return g_bf16 ? dispatch<uint16_t, uint16_t>(x, g, part, out, K, N, ld,
                                                 nblocks, stream)
                  : dispatch<uint16_t, float>(x, g, part, out, K, N, ld,
                                              nblocks, stream);
  return g_bf16 ? dispatch<float, uint16_t>(x, g, part, out, K, N, ld,
                                            nblocks, stream)
                : dispatch<float, float>(x, g, part, out, K, N, ld, nblocks,
                                         stream);
}
