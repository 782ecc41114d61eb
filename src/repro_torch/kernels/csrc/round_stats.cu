// Per-round angle statistics over the round's flat client-delta buffer:
//   dots[k] = <x_k, g>,  sqs[k] = ||x_k||^2,  sqg = ||g||^2
// for x (K, N) row-major, f32 or bf16 (the bf16 wire), and the f32 global
// delta g (N,), optionally restricted to the f32 segment mask m (N,)
// (angle_filter="dense_only"): then x_k and g are both multiplied by m
// first, as the reference does. Sums are f32 whatever x's type. These 2K+1
// numbers feed the FedAdp angles (paper Eq. 8).
//
// Replaces the Pallas kernels repro/kernels/round_stats.py::round_stats
// (_stats_kernel and _stats_kernel_masked). Those accumulate into output
// blocks revisited along a sequential TPU grid. Both kernels here are
// bound by bytes: one read of x plus N*4 bytes of g (and of the mask),
// and 4 flops per element of x, far below the f32 ridge. No atomics
// anywhere, so the result is the same from run to run; any K and any N,
// no padded copy of x.
//
// ---- f32 x: stats_stage1 + stats_stage2
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
// Its block reductions and second stage are not the shared ones
// (stats_reduce.cuh's block_sum_to, since removed, and stats_stage2).
// Built on those, the f32 kernel of the main path needed 38 registers
// instead of 32 (6 blocks of 256 threads per SM instead of 8) and took
// 40.5 us instead of 35.6 at the main path's shape; block_sum_to, with
// its own shared array, cost most of that (chip_ab.py, both builds in one
// process, H100 80GB HBM3 at 700 W). It streams x with the widest loads
// the row stride allows (16, 8 or 4 bytes), keeps KC rows' loads in
// flight per thread, and reads g once per block.
//
// ---- bf16 x: stats_bf16_kernel + stats_sum_kernel
//
// The bf16 wire read as round_stats_q.cu reads the int8 wire, two bytes
// an element:
//
// * 16-byte loads at any row offset. A bf16 row of the main path is
//   3,326,740 bytes (4 mod 16), so no single load width fits every row.
//   Lane l of a warp owns the 32-byte tile l of the warp's span of every
//   row (16 columns): the two aligned 16-byte words of the tile, and the
//   first word of lane l + 1 borrowed by shuffles (wire.cuh's load_row2 /
//   row_bytes2). Lane 31 only lends, so a warp covers 31 tiles.
// * g (and the mask) loaded once a lane, as float4 where aligned; the
//   lane's share of ||g||^2 added once. With a mask the lane holds m^2 g
//   and m^2 in place of g and 1: (x m)(g m) = x (m^2 g), (x m)^2 = x^2 m^2.
// * The bytes past the row's end (the next row's, or whatever follows the
//   buffer) are zeroed in the lane's words by a mask fixed for the lane; a
//   zero bf16 widens to exactly 0.f. bf16 widens to f32 by a 16-bit shift
//   (load.cuh's bf16_lo / bf16_hi); v g and v^2 are summed by FFMA.
// * No block barrier in the client loop. A warp takes its rows two at a
//   time, and the next two rows' loads go out before the current ones are
//   summed. The two rows' 2 x 2 per-lane sums leave the warp by
//   stats_reduce.cuh's butterfly, and lanes 0, 8, 16, 24 write them to
//   shared memory; at the end each block adds its warps' sums in warp
//   order and writes its (2K + 1) partials once, statistic-major.
//   Blocks of two warps and a register cap keep the main shape's grid
//   (1,677 blocks) in one wave.
// * Two launches a call: stats_sum_kernel adds each statistic's block
//   partials in a fixed order, as a programmatic dependent launch
//   (stats_reduce.cuh).
//
// bf16 x once took the f32 kernel's path: one load width for the whole
// buffer (4 bytes at the main shape), 8 block barriers a block at K = 10
// and a plain second launch over block-major partials; PERF.md has the
// times of both designs.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "load.cuh"
#include "stats_reduce.cuh"
#include "wire.cuh"

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

template <int VW, bool MASKED>
__global__ void __launch_bounds__(kThreads)
stats_stage1(const float* __restrict__ x, const float* __restrict__ g,
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

template <int VW>
cudaError_t launch(const float* x, const float* g, const float* mask,
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
int load_width(const float* x, const float* g, const float* mask,
               long long N) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(g) |
                      reinterpret_cast<uintptr_t>(mask);
  for (int vw = 4; vw > 1; vw /= 2)
    if (N % vw == 0 && a % (vw * sizeof(float)) == 0) return vw;
  return 1;
}

// ---- bf16 x

namespace bf16 {

constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 31;  // 32-byte tiles of a warp: lane 31 only lends
constexpr int kRows = 2;    // rows of a warp in flight: the butterfly's two
constexpr int kCols = 16;   // bf16 columns of a tile
// Blocks an SM must hold, which caps the registers a thread: unmasked,
// 72 registers fit 14 blocks of two warps an SM, and the main shape's
// 1,677 blocks are one wave on 132 SMs. The masked kernel holds 16 more
// values a lane (m^2) and is not on the round's path: 96 registers,
// 10 blocks an SM.
template <bool MASKED>
constexpr int kMinBlocksOf = 65536 / ((MASKED ? 96 : 72) * kThreads);

struct Args {
  const int8_t* x;    // (K, n) bf16 rows, as bytes
  const float* g;     // (n,)
  const float* mask;  // (n,) or null
  float* part;        // (S, blocks) block partials
  int K;
  long long n;   // columns
  long long nb;  // bytes a row: 2n
  bool vec;      // g and mask 16-byte aligned
  long long blocks;
};

// Blocks for rows of n columns: 32-byte tiles, kTiles a warp.
long long blocks_for(long long n) {
  const long long spans = ((n + kCols - 1) / kCols + kTiles - 1) / kTiles;
  return (spans + kWarps - 1) / kWarps;
}

// The 16-bit halves of a lane's 32 bytes that hold one of its nv
// columns, as and-masks of 8 words.
__device__ __forceinline__ void keep_mask(int nv, uint4& lo, uint4& hi) {
  unsigned int w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j] = (2 * j < nv ? 0x0000FFFFu : 0u) |
           (2 * j + 1 < nv ? 0xFFFF0000u : 0u);
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ uint4 and4(const uint4& a, const uint4& b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// One row's sums of a lane over its 16 bf16 values v, in column order:
// d = sum v G, q = sum v^2 M (unmasked: sum v^2).
template <bool MASKED>
__device__ __forceinline__ void sums(const uint4& lo, const uint4& hi,
                                     const float* gw, const float* mw,
                                     float& d, float& q) {
  const unsigned int words[8] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float v0 = repro::bf16_lo(words[j]), v1 = repro::bf16_hi(words[j]);
    d = fmaf(v0, gw[2 * j], d);
    q = fmaf(MASKED ? v0 * mw[2 * j] : v0, v0, q);
    d = fmaf(v1, gw[2 * j + 1], d);
    q = fmaf(MASKED ? v1 * mw[2 * j + 1] : v1, v1, q);
  }
}

// The rows k0 + u (u < kRows) of the lane's tile that exist.
__device__ __forceinline__ void load_rows(const Args& a, int k0,
                                          long long tile,
                                          repro::RowLoad2 (&ld)[kRows]) {
#pragma unroll
  for (int u = 0; u < kRows; ++u)
    if (k0 + u < a.K) ld[u] = repro::load_row2(a.x, k0 + u, a.nb, tile);
}

// Each block's partials: kCols columns a lane, two rows of a warp at a
// time.
template <bool MASKED>
__global__ void __launch_bounds__(kThreads, kMinBlocksOf<MASKED>)
stats_bf16_kernel(Args a) {
  // stats_sum_kernel may launch now: it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ float red[];  // (kWarps, S): each warp's row sums
  const int K = a.K, S = 2 * K + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const long long tile =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kTiles + lane;
  const long long col = kCols * tile;
  const int nv = lane == kTiles ? 0 : static_cast<int>(
      max(0LL, min(static_cast<long long>(kCols), a.n - col)));

  float gw[kCols], mw[kCols];  // mw: masked only
  repro::lane_cols<kCols>(a.g + col, nv, a.vec, gw);
  float sg = 0.f;
  if constexpr (MASKED) {
    repro::lane_cols<kCols>(a.mask + col, nv, a.vec, mw);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const float gm = gw[i] * mw[i];
      sg = fmaf(gm, gm, sg);
      gw[i] = mw[i] * gm;
      mw[i] *= mw[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) sg = fmaf(gw[i], gw[i], sg);
  }
  uint4 keep_lo, keep_hi;
  keep_mask(nv, keep_lo, keep_hi);
  float* mine = red + warp * S;

  repro::RowLoad2 next[kRows];
  load_rows(a, 0, tile, next);
  for (int k0 = 0; k0 < K; k0 += kRows) {
    repro::RowLoad2 ld[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) ld[u] = next[u];
    // the next rows' loads go out before these rows are summed
    if (k0 + kRows < K) load_rows(a, k0 + kRows, tile, next);
    float dq[2 * kRows];  // row u: d at 2u, q at 2u + 1
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      float& d = dq[2 * u];
      float& q = dq[2 * u + 1];
      d = q = 0.f;
      if (k0 + u < K) {  // the same for the whole warp
        uint4 lo, hi;
        repro::row_bytes2(ld[u], lo, hi);
        sums<MASKED>(and4(lo, keep_lo), and4(hi, keep_hi), gw, mw, d, q);
      }
    }
    const float v = repro::butterfly(dq[0], dq[1], dq[2], dq[3], lane);
    const int k = k0 + (lane >> 4);
    if ((lane & 7) == 0 && k < K) mine[(lane & 8) ? K + k : k] = v;
  }
  sg = repro::warp_sum(sg);
  if (lane == 0) mine[2 * K] = sg;
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += kThreads) {
    float acc = red[j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc += red[w * S + j];
    a.part[j * a.blocks + blockIdx.x] = acc;
  }
}

template <bool MASKED>
cudaError_t launch(const Args& a, float* out, cudaStream_t stream) {
  return repro::launch_stats(stats_bf16_kernel<MASKED>, a, kWarps, out,
                             stream);
}

}  // namespace bf16

}  // namespace

// Stage-1 blocks of the f32 kernel for a row of N columns; the caller
// sizes the partials buffer as blocks * (2K + 1) floats.
extern "C" long long repro_round_stats_blocks(long long N) {
  return (N + kTile - 1) / kTile;
}

// x (K, N) f32, g (N,), mask (N,) or NULL, part (blocks * (2K+1),)
// scratch, out (2K+1,) = [dots | sqs | sqg]. Returns a cudaError_t: 0
// when both launches were accepted. Never synchronises.
extern "C" int repro_round_stats_f32(const float* x, const float* g,
                                     const float* mask, float* part,
                                     float* out, int K, long long N,
                                     long long nblocks, cudaStream_t stream) {
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

// The floats of one bf16 call's `part` scratch: (2K + 1) * blocks.
extern "C" long long repro_wire_stats_bf16_floats(int K, long long N) {
  return (2LL * K + 1) * bf16::blocks_for(N);
}

// bf16 x (K, N) (raw 16-bit patterns, rows at any even byte address), g
// (N,) and mask (N,) or NULL in f32, part as above, out (2K+1,) = [dots |
// sqs | sqg]. Returns a cudaError_t: 0 when both launches were accepted.
// Never synchronises.
extern "C" int repro_wire_stats_bf16(const void* x, const float* g,
                                     const float* mask, float* part,
                                     float* out, int K, long long N,
                                     cudaStream_t stream) {
  const bf16::Args a{static_cast<const int8_t*>(x), g, mask, part, K, N,
                     2 * N,
                     (reinterpret_cast<uintptr_t>(g) |
                      reinterpret_cast<uintptr_t>(mask)) % 16 == 0,
                     bf16::blocks_for(N)};
  if (K < 1 || N < 1 || K > (INT_MAX - 1) / 2 || a.blocks > INT_MAX ||
      reinterpret_cast<uintptr_t>(x) % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mask != nullptr
                              ? bf16::launch<true>(a, out, stream)
                              : bf16::launch<false>(a, out, stream));
}
