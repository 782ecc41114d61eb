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
// One design for both types, stats_f32_kernel and stats_bf16_kernel
// (stats_body<T>), read as round_stats_q.cu reads the int8 wire:
//
// * 32 bytes a lane, 16-byte loads at any row offset. A row of the main
//   path (N = 1,663,370) is 6,653,480 bytes in f32 (8 mod 16) and
//   3,326,740 in bf16 (4 mod 16), so no single load width fits every row.
//   Lane l of a warp owns the 32-byte tile l of the warp's span of every
//   row (8 f32 or 16 bf16 columns): the two aligned 16-byte words of the
//   tile, and the first word of lane l + 1 borrowed by shuffles
//   (wire.cuh's load_row2 / row_bytes2), realigned for the row's offset.
//   Lane 31 only lends, so a warp covers 31 tiles.
// * g (and the mask) loaded once a lane, as float4 where aligned; the
//   lane's share of ||g||^2 added once. With a mask the lane holds m^2 g
//   and m^2 in place of g and 1: (x m)(g m) = x (m^2 g), (x m)^2 = x^2 m^2.
// * The values past the row's end (the next row's, or whatever follows
//   the buffer) are dropped before any product by a mask fixed for the
//   lane: a select on each f32 column, an and-mask on the bf16 halves (a
//   zero bf16 widens to exactly 0.f). bf16 widens to f32 by a 16-bit
//   shift (load.cuh's bf16_lo / bf16_hi); v g and v^2 are summed by FFMA
//   in column order.
// * No block barrier in the client loop. A warp takes its rows two at a
//   time, and the next two rows' loads go out before the current ones are
//   summed. The two rows' 2 x 2 per-lane sums leave the warp by
//   stats_reduce.cuh's butterfly, and lanes 0, 8, 16, 24 write them to
//   shared memory; at the end each block adds its warps' sums in warp
//   order and writes its (2K + 1) partials once, statistic-major.
//   Blocks of two warps; a register cap keeps the bf16 main shape's grid
//   (1,677 blocks) in one wave. The f32 grid (3,354 blocks) needs two
//   waves at any register count that holds two rows in flight; 16 f32
//   columns a lane would make it one wave but spill (PERF.md has both).
// * Two launches a call: stats_sum_kernel adds each statistic's block
//   partials in a fixed order, as a programmatic dependent launch
//   (stats_reduce.cuh).
//
// Both types once took a simpler path (stats_stage1 / stats_stage2): one
// load width for the whole buffer (8 bytes for f32 and 4 for bf16 at the
// main shape), 8 block barriers a block at K = 10 and a plain second
// launch over block-major partials; PERF.md has the times of both designs.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "load.cuh"
#include "stats_reduce.cuh"
#include "wire.cuh"

namespace {

constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 31;  // 32-byte tiles of a warp: lane 31 only lends
constexpr int kRows = 2;    // rows of a warp in flight: the butterfly's two
// x's columns in a lane's 32 bytes: T is float, or uint16_t for bf16
template <typename T>
constexpr int kColsOf = 32 / static_cast<int>(sizeof(T));
// Blocks an SM must hold, which caps the registers a thread: unmasked,
// 72 registers fit 14 blocks of two warps an SM, and the bf16 main
// shape's 1,677 blocks are one wave on 132 SMs. A masked kernel holds
// more values a lane (m^2) and is not on the round's path: 96 registers,
// 10 blocks an SM.
template <bool MASKED>
constexpr int kMinBlocksOf = 65536 / ((MASKED ? 96 : 72) * kThreads);

struct Args {
  const int8_t* x;    // (K, n) f32 or bf16 rows, as bytes
  const float* g;     // (n,)
  const float* mask;  // (n,) or null
  float* part;        // (S, blocks) block partials
  int K;
  long long n;   // columns
  long long nb;  // bytes a row
  bool vec;      // g and mask 16-byte aligned
  long long blocks;
};

// Blocks for rows of n columns, `cols` a lane, kTiles lanes a warp.
long long blocks_for(long long n, int cols) {
  const long long spans = ((n + cols - 1) / cols + kTiles - 1) / kTiles;
  return (spans + kWarps - 1) / kWarps;
}

// The 16-bit halves of a lane's 32 bytes that hold one of its nv bf16
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

// One row's sums of a lane over its 32 bytes (lo, hi) of T, in column
// order: d = sum v G, q = sum v^2 M (unmasked: sum v^2). The columns past
// nv are dropped first: f32 by a select, bf16 by the and-masks keep.
template <typename T, bool MASKED>
__device__ __forceinline__ void sums(const uint4& lo, const uint4& hi,
                                     int nv, const uint4 (&keep)[2],
                                     const float* gw, const float* mw,
                                     float& d, float& q) {
  if constexpr (sizeof(T) == 4) {
    const unsigned int words[8] = {lo.x, lo.y, lo.z, lo.w,
                                   hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = j < nv ? __uint_as_float(words[j]) : 0.f;
      d = fmaf(v, gw[j], d);
      q = fmaf(MASKED ? v * mw[j] : v, v, q);
    }
  } else {
    const uint4 a = and4(lo, keep[0]), b = and4(hi, keep[1]);
    const unsigned int words[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v0 = repro::bf16_lo(words[j]);
      const float v1 = repro::bf16_hi(words[j]);
      d = fmaf(v0, gw[2 * j], d);
      q = fmaf(MASKED ? v0 * mw[2 * j] : v0, v0, q);
      d = fmaf(v1, gw[2 * j + 1], d);
      q = fmaf(MASKED ? v1 * mw[2 * j + 1] : v1, v1, q);
    }
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

// Each block's partials: kColsOf<T> columns a lane, two rows of a warp at
// a time.
template <typename T, bool MASKED>
__device__ __forceinline__ void stats_body(const Args& a) {
  constexpr int C = kColsOf<T>;
  // stats_sum_kernel may launch now: it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ float red[];  // (kWarps, S): each warp's row sums
  const int K = a.K, S = 2 * K + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const long long tile =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kTiles + lane;
  const long long col = C * tile;
  const int nv = lane == kTiles ? 0 : static_cast<int>(
      max(0LL, min(static_cast<long long>(C), a.n - col)));

  float gw[C], mw[C];  // mw: masked only
  repro::lane_cols<C>(a.g + col, nv, a.vec, gw);
  float sg = 0.f;
  if constexpr (MASKED) {
    repro::lane_cols<C>(a.mask + col, nv, a.vec, mw);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const float gm = gw[i] * mw[i];
      sg = fmaf(gm, gm, sg);
      gw[i] = mw[i] * gm;
      mw[i] *= mw[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) sg = fmaf(gw[i], gw[i], sg);
  }
  uint4 keep[2];  // bf16 only
  if constexpr (sizeof(T) == 2) keep_mask(nv, keep[0], keep[1]);
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
        sums<T, MASKED>(lo, hi, nv, keep, gw, mw, d, q);
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
__global__ void __launch_bounds__(kThreads, kMinBlocksOf<MASKED>)
stats_f32_kernel(Args a) {
  stats_body<float, MASKED>(a);
}

template <bool MASKED>
__global__ void __launch_bounds__(kThreads, kMinBlocksOf<MASKED>)
stats_bf16_kernel(Args a) {
  stats_body<uint16_t, MASKED>(a);
}

// Checks the sizes, then launches `kernel` over T rows and
// stats_sum_kernel.
template <typename T>
cudaError_t launch(void (*kernel)(Args), const void* x, const float* g,
                   const float* mask, float* part, float* out, int K,
                   long long N, cudaStream_t stream) {
  const Args a{static_cast<const int8_t*>(x), g, mask, part, K, N,
               static_cast<long long>(sizeof(T)) * N,
               (reinterpret_cast<uintptr_t>(g) |
                reinterpret_cast<uintptr_t>(mask)) % 16 == 0,
               blocks_for(N, kColsOf<T>)};
  if (K < 1 || N < 1 || K > (INT_MAX - 1) / 2 || a.blocks > INT_MAX ||
      reinterpret_cast<uintptr_t>(x) % sizeof(T) != 0)
    return cudaErrorInvalidValue;
  return repro::launch_stats(kernel, a, kWarps, out, stream);
}

}  // namespace

// The floats of one call's `part` scratch for x (K, N) of `elem` bytes
// an element (4: f32, 2: bf16): (2K + 1) * blocks.
extern "C" long long repro_round_stats_floats(int K, long long N,
                                              int elem) {
  return (2LL * K + 1) * blocks_for(N, 32 / elem);
}

// x (K, N) f32 (rows at any 4-byte address), g (N,), mask (N,) or NULL,
// part as above, out (2K+1,) = [dots | sqs | sqg]. Returns a cudaError_t:
// 0 when both launches were accepted. Never synchronises.
extern "C" int repro_wire_stats_f32(const float* x, const float* g,
                                    const float* mask, float* part,
                                    float* out, int K, long long N,
                                    cudaStream_t stream) {
  return static_cast<int>(launch<float>(
      mask != nullptr ? stats_f32_kernel<true> : stats_f32_kernel<false>, x,
      g, mask, part, out, K, N, stream));
}

// The same for bf16 x (raw 16-bit patterns, rows at any even address).
extern "C" int repro_wire_stats_bf16(const void* x, const float* g,
                                     const float* mask, float* part,
                                     float* out, int K, long long N,
                                     cudaStream_t stream) {
  return static_cast<int>(launch<uint16_t>(
      mask != nullptr ? stats_bf16_kernel<true> : stats_bf16_kernel<false>,
      x, g, mask, part, out, K, N, stream));
}
