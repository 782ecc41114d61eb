// Per-round angle statistics over the round's flat client-delta buffer:
//   dots[k] = <x_k, g>,  sqs[k] = ||x_k||^2,  sqg = ||g||^2
// for x (K, N) row-major, f32 or bf16 (the bf16 wire), and the f32 global
// delta g (N,), optionally restricted to the f32 0/1 segment mask m (N,)
// (angle_filter="dense_only"): then x_k and g are both multiplied by m
// first, as the reference does. Sums are f32 whatever x's type. These 2K+1
// numbers feed the FedAdp angles (paper Eq. 8).
//
// Replaces the Pallas kernels repro/kernels/round_stats.py::round_stats
// (_stats_kernel and _stats_kernel_masked). Those accumulate into output
// blocks revisited along a sequential TPU grid. Here:
//
//   Stage 1: a grid of column blocks. A block loads its g tile (and mask
//   tile) into registers once, computes its share of sqg once, then walks
//   the clients in compile-time chunks of KC rows. Each thread keeps a dot
//   and a square sum per client of the chunk in registers; the block
//   reduces them (warp shuffles, then shared memory) and writes one
//   partial per (block, statistic) to scratch.
//   Stage 2: one small launch reduces the partials over blocks, one block
//   per statistic, in a fixed order.
//
// The f32 path is that of this file's f32-only version, written out: its
// block reductions and second stage are not the shared ones that the
// wire statistics once used (stats_reduce.cuh's block_sum_to, since
// removed, and stats_stage2), nor its f32 loads load.cuh's (used here for
// bf16 x only). Built on those, the f32 kernel of the main path needed 38
// registers instead of 32 (6 blocks of 256 threads per SM instead of 8)
// and took 40.5 us instead of 35.6 at the main path's shape;
// block_sum_to, with its own shared array, cost most of that (chip_ab.py,
// both builds in one process, H100 80GB HBM3 at 700 W).
//
// No atomics anywhere, so the result is the same from run to run. Any K
// (the chunk loop guards the ragged last chunk) and any N (the ragged
// column edge is masked); no padded copy of x.
//
// What bounds it on Hopper: bytes. It reads K*N*sizeof(x) bytes of x plus
// N*4 of g (and N*4 of the mask) and does 4 flops per element of x, far
// below the f32 ridge. The design streams x once with the widest loads the
// row stride allows (16, 8 or 4 bytes of f32; 8, 4 or 2 bytes of bf16),
// keeps KC rows' loads in flight per thread, and reads g once per block
// rather than once per client chunk. The partials are (blocks, 2K+1)
// floats, 0.14 MB at the main path's shape (K = 10, N = 1.66M), so the
// second launch is short. A bf16 row of the main path is 3,326,740 bytes
// (4 mod 16), so bf16 x streams with 4-byte loads there.

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
// clients per chunk: 2*KC sums live in registers. 4 measured a little
// faster than 8 on an H100 at K = 10 and K = 37.
constexpr int KC = 4;

// kCols consecutive elements at base + col, zeros past the ragged edge
// (ncols < kCols). Full tiles load VW elements at a time; base + col is
// then aligned to VW elements (the launcher picks VW so that it is).
template <int VW>
__device__ __forceinline__ void load_cols(const float* __restrict__ base,
                                          long long col, int ncols,
                                          float (&v)[kCols]) {
  const float* p = base + col;
  if (ncols == kCols) {
    if constexpr (VW == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else if constexpr (VW == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i) v[i] = __ldg(p + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) v[i] = i < ncols ? __ldg(p + i) : 0.f;
  }
}

// The same for bf16 x.
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

template <int VW, bool MASKED, typename T>
__global__ void __launch_bounds__(kThreads)
stats_stage1(const T* __restrict__ x, const float* __restrict__ g,
             const float* __restrict__ mask, float* __restrict__ part,
             int K, long long N) {
  __shared__ float red[kWarps][2 * KC];
  float* out = part + static_cast<long long>(blockIdx.x) * (2 * K + 1);

  // Threads past the edge keep ncols = 0 and contribute zeros: every
  // thread must reach the shuffles and barriers below.
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  const int ncols =
      col >= N ? 0 : static_cast<int>(N - col < kCols ? N - col : kCols);

  float gv[kCols], mv[kCols] = {1.f, 1.f, 1.f, 1.f};
  load_cols<VW>(g, col, ncols, gv);
  if constexpr (MASKED) {
    load_cols<VW>(mask, col, ncols, mv);
#pragma unroll
    for (int i = 0; i < kCols; ++i) gv[i] *= mv[i];
  }

  // sqg: counted once per block, not once per client chunk
  float sg = 0.f;
#pragma unroll
  for (int i = 0; i < kCols; ++i) sg = fmaf(gv[i], gv[i], sg);
  sg = repro::warp_sum(sg);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32][0] = sg;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][0];
    out[2 * K] = s;
  }
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += KC) {
    float dot[KC], sq[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      dot[j] = 0.f;
      sq[j] = 0.f;
      if (k0 + j < K) {  // uniform across the block
        float v[kCols];
        load_cols<VW>(x + static_cast<long long>(k0 + j) * N, col, ncols, v);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const float xv = MASKED ? v[i] * mv[i] : v[i];
          dot[j] = fmaf(xv, gv[i], dot[j]);
          sq[j] = fmaf(xv, xv, sq[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      dot[j] = repro::warp_sum(dot[j]);
      sq[j] = repro::warp_sum(sq[j]);
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
}

// One block per statistic: a strided sum over the blocks' partials in a
// fixed order, then a fixed shared-memory tree.
__global__ void __launch_bounds__(kThreads)
stats_stage2(const float* __restrict__ part, float* __restrict__ out, int S,
             long long nblocks) {
  __shared__ float s[kThreads];
  const int j = blockIdx.x;
  float acc = 0.f;
  for (long long b = threadIdx.x; b < nblocks; b += kThreads)
    acc += part[b * S + j];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = s[0];
}

template <int VW, typename T>
cudaError_t launch(const T* x, const float* g, const float* mask,
                   float* part, float* out, int K, long long N,
                   long long nblocks, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(nblocks);
  if (mask != nullptr)
    stats_stage1<VW, true><<<grid, kThreads, 0, stream>>>(x, g, mask, part,
                                                          K, N);
  else
    stats_stage1<VW, false><<<grid, kThreads, 0, stream>>>(x, g, mask, part,
                                                           K, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  stats_stage2<<<2 * K + 1, kThreads, 0, stream>>>(part, out, 2 * K + 1,
                                                  nblocks);
  return cudaGetLastError();
}

// The widest load (in elements) that every row of x, g and mask allows.
template <typename T>
int load_width(const T* x, const float* g, const float* mask, long long N) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t fa = reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(mask);
  for (int vw = 4; vw > 1; vw /= 2)
    if (N % vw == 0 && xa % (vw * sizeof(T)) == 0 &&
        fa % (vw * sizeof(float)) == 0)
      return vw;
  return 1;
}

template <typename T>
int dispatch(const T* x, const float* g, const float* mask, float* part,
             float* out, int K, long long N, long long nblocks,
             cudaStream_t stream) {
  if (K < 1 || N < 1 || K > (INT_MAX - 1) / 2 ||
      nblocks != (N + kTile - 1) / kTile || nblocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (load_width(x, g, mask, N)) {
    case 4: e = launch<4>(x, g, mask, part, out, K, N, nblocks, stream); break;
    case 2: e = launch<2>(x, g, mask, part, out, K, N, nblocks, stream); break;
    default: e = launch<1>(x, g, mask, part, out, K, N, nblocks, stream);
  }
  return static_cast<int>(e);
}

}  // namespace

// Stage-1 blocks for a row of N columns; the caller sizes the partials
// buffer as blocks * (2K + 1) floats.
extern "C" long long repro_round_stats_blocks(long long N) {
  return (N + kTile - 1) / kTile;
}

// x (K, N), g (N,), mask (N,) or NULL, part (blocks * (2K+1),) scratch,
// out (2K+1,) = [dots | sqs | sqg]. Returns a cudaError_t: 0 when both
// launches were accepted. Never synchronises.
extern "C" int repro_round_stats_f32(const float* x, const float* g,
                                     const float* mask, float* part,
                                     float* out, int K, long long N,
                                     long long nblocks, cudaStream_t stream) {
  return dispatch(x, g, mask, part, out, K, N, nblocks, stream);
}

// The same with x in bf16 (its raw 16-bit patterns); g and mask stay f32.
extern "C" int repro_round_stats_bf16(const void* x, const float* g,
                                      const float* mask, float* part,
                                      float* out, int K, long long N,
                                      long long nblocks, cudaStream_t stream) {
  return dispatch(static_cast<const uint16_t*>(x), g, mask, part, out, K, N,
                  nblocks, stream);
}
