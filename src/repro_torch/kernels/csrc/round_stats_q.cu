// Per-round angle statistics over the quantized uplink wire, dequantized
// in registers (the wire formats are described in wire.cuh):
//   dots[k] = <x_k, g>,  sqs[k] = ||x_k||^2,  sqg = ||g||^2
// with x_k the dequantized row: int8 x[k, n] = q[k, n] * s[k, n / CHUNK],
// int4 x[k, m] = nibble[k, m] * s[k, m / group_size]. g (N,) and the
// optional 0/1 segment mask (N,) are f32 server-side vectors in logical
// columns; with a mask, x_k and g are both multiplied by it first. Sums
// are f32.
//
// Replaces the Pallas kernels repro/kernels/round_stats.py::round_stats_q
// (_stats_q_kernel{,_masked}) and round_stats_q4 (_stats_q4_kernel
// {,_masked}). Those walk a sequential TPU grid, pair the int4 nibble
// planes with even/odd views of g and the mask, pad the scales with 1.0
// and select-zero the tail client chunk. Here the design is that of
// round_stats.cu:
//
//   Stage 1: a grid of column blocks; each thread owns 8 consecutive wire
//   bytes of every row (8 int8 or 16 int4 logical columns). It loads its
//   g (and mask) columns into registers once, adds its share of sqg once,
//   then walks the clients in chunks of KC rows, decoding each row's bytes
//   in registers against its own g columns, in logical order. The block
//   reduces its sums and writes one partial per (block, statistic).
//   Stage 2: one small launch sums the partials over blocks in a fixed
//   order (stats_reduce.cuh). No atomics: the same bits every run.
//
// The odd-N padding nibble (logical column N) is skipped: it never reads
// g[N] or mask[N] and adds nothing. Scale lookups are those of
// weighted_agg_q.cu: one per block and row for int8, one per thread and
// row for int4 groups of 16 and more, one per byte below that (the
// per-byte lookup for every group size measured 11% slower here at group
// size 512; weighted_agg_q.cu has the numbers).
//
// What bounds it on Hopper: bytes. It reads K*N (int8) or K*ceil(N/2)
// (int4) wire bytes, the scales, and N*4 bytes of g (and of the mask),
// with a few integer ops and 4 flops per logical element. Rows that start
// on odd or 2-byte-aligned addresses (the main path's int4 and int8 rows)
// are read through aligned words (wire.cuh's load8).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "stats_reduce.cuh"
#include "wire.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytes = 8;  // wire bytes per thread per row
constexpr long long kTile = kThreads * kBytes;
constexpr int KC = 4;  // clients per chunk, as in round_stats.cu
static_assert(repro::kChunk % kTile == 0, "a block must lie in one chunk");

template <bool MASKED>
__global__ void __launch_bounds__(kThreads)
stats_q8_stage1(const int8_t* __restrict__ q, const float* __restrict__ sc,
                const float* __restrict__ g, const float* __restrict__ mask,
                float* __restrict__ part, int K, long long N, int C,
                bool vec) {
  __shared__ float red1[kWarps];
  __shared__ float red[kWarps][2 * KC];
  float* out = part + static_cast<long long>(blockIdx.x) * (2 * K + 1);

  // Threads past the edge keep ncols <= 0 and contribute zeros: every
  // thread must reach the shuffles and barriers below.
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kBytes;
  const int ncols = col >= N ? 0 : static_cast<int>(
      N - col < kBytes ? N - col : kBytes);
  const int c = static_cast<int>(
      static_cast<long long>(blockIdx.x) * kTile / repro::kChunk);

  float gv[8], mv[8];
  repro::load8f(g + col, ncols, vec, gv);
  if constexpr (MASKED) {
    repro::load8f(mask + col, ncols, vec, mv);
#pragma unroll
    for (int i = 0; i < 8; ++i) gv[i] *= mv[i];
  }
  float sg = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) sg = fmaf(gv[i], gv[i], sg);
  repro::block_sum_to<kThreads>(sg, red1, out + 2 * K);

  for (int k0 = 0; k0 < K; k0 += KC) {
    float dot[KC], sq[KC];
#pragma unroll
    for (int jj = 0; jj < KC; ++jj) {
      dot[jj] = 0.f;
      sq[jj] = 0.f;
      const int k = k0 + jj;
      if (k < K && ncols > 0) {
        const int8_t* p = q + static_cast<long long>(k) * N + col;
        const float s = __ldg(sc + static_cast<long long>(k) * C + c);
        if (ncols == kBytes) {
          const uint2 u = repro::load8(p);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float xv = static_cast<float>(repro::byte_of(u, i)) * s;
            if constexpr (MASKED) xv *= mv[i];
            dot[jj] = fmaf(xv, gv[i], dot[jj]);
            sq[jj] = fmaf(xv, xv, sq[jj]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i < ncols) {
              float xv = static_cast<float>(__ldg(p + i)) * s;
              if constexpr (MASKED) xv *= mv[i];
              dot[jj] = fmaf(xv, gv[i], dot[jj]);
              sq[jj] = fmaf(xv, xv, sq[jj]);
            }
          }
        }
      }
    }
    repro::block_store_partials<kThreads, KC>(dot, sq, red, out, k0, K);
  }
}

// One nibble's contribution: x = v * s (* m), then dot and square sum.
template <bool MASKED>
__device__ __forceinline__ void add_elem(int v, float s, float m, float gm,
                                         float& dot, float& sq) {
  float xv = static_cast<float>(v) * s;
  if constexpr (MASKED) xv *= m;
  dot = fmaf(xv, gm, dot);
  sq = fmaf(xv, xv, sq);
}

// WIDE: group_size >= 16, one scale per thread and row. lg = log2(gs).
template <bool MASKED, bool WIDE>
__global__ void __launch_bounds__(kThreads)
stats_q4_stage1(const int8_t* __restrict__ q, const float* __restrict__ sc,
                const float* __restrict__ g, const float* __restrict__ mask,
                float* __restrict__ part, int K, long long n, long long nb,
                int G, int lg, bool vec) {
  __shared__ float red1[kWarps];
  __shared__ float red[kWarps][2 * KC];
  float* out = part + static_cast<long long>(blockIdx.x) * (2 * K + 1);

  const long long j =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kBytes;
  const long long m = 2 * j;  // first logical column of this thread
  // logical columns this thread owns: 16, fewer at the row's end (the
  // odd-N padding nibble excluded), 0 past it
  const int ncols = m >= n ? 0 : static_cast<int>(n - m < 16 ? n - m : 16);

  float gv[16], mv[16];
  repro::load16f(g + m, ncols, vec, gv);
  if constexpr (MASKED) {
    repro::load16f(mask + m, ncols, vec, mv);
#pragma unroll
    for (int i = 0; i < 16; ++i) gv[i] *= mv[i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) mv[i] = 1.f;  // unread
  }
  float sg = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) sg = fmaf(gv[i], gv[i], sg);
  repro::block_sum_to<kThreads>(sg, red1, out + 2 * K);

  for (int k0 = 0; k0 < K; k0 += KC) {
    float dot[KC], sq[KC];
#pragma unroll
    for (int jj = 0; jj < KC; ++jj) {
      dot[jj] = 0.f;
      sq[jj] = 0.f;
      const int k = k0 + jj;
      if (k < K && ncols > 0) {
        const int8_t* p = q + static_cast<long long>(k) * nb + j;
        const float* sk = sc + static_cast<long long>(k) * G;
        const float s0 = WIDE ? __ldg(sk + (m >> lg)) : 0.f;
        if (ncols == 16) {
          const uint2 u = repro::load8(p);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int b = repro::byte_of(u, i);
            const float s = WIDE ? s0 : __ldg(sk + ((m + 2 * i) >> lg));
            add_elem<MASKED>(repro::nib_lo(b), s, mv[2 * i], gv[2 * i],
                             dot[jj], sq[jj]);
            add_elem<MASKED>(repro::nib_hi(b), s, mv[2 * i + 1],
                             gv[2 * i + 1], dot[jj], sq[jj]);
          }
        } else {  // the row's end: guard each nibble by its logical column
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (2 * i < ncols) {
              const int b = __ldg(p + i);
              const float s = WIDE ? s0 : __ldg(sk + ((m + 2 * i) >> lg));
              add_elem<MASKED>(repro::nib_lo(b), s, mv[2 * i], gv[2 * i],
                               dot[jj], sq[jj]);
              if (2 * i + 1 < ncols)
                add_elem<MASKED>(repro::nib_hi(b), s, mv[2 * i + 1],
                                 gv[2 * i + 1], dot[jj], sq[jj]);
            }
          }
        }
      }
    }
    repro::block_store_partials<kThreads, KC>(dot, sq, red, out, k0, K);
  }
}

bool aligned16(const float* g, const float* mask) {
  return (reinterpret_cast<uintptr_t>(g) |
          reinterpret_cast<uintptr_t>(mask)) % 16 == 0;
}

cudaError_t stage2(const float* part, float* out, int K, long long nblocks,
                   cudaStream_t stream) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  repro::stats_stage2<kThreads><<<2 * K + 1, kThreads, 0, stream>>>(
      part, out, 2 * K + 1, nblocks);
  return cudaGetLastError();
}

}  // namespace

// Stage-1 blocks for wire rows `width` bytes wide (N for int8, ceil(N/2)
// for int4); the caller sizes the partials buffer as blocks * (2K + 1)
// floats.
extern "C" long long repro_round_stats_q_blocks(long long width) {
  return (width + kTile - 1) / kTile;
}

// int8 wire: q (K, N), scales (K, C) with C = ceil(N / CHUNK), g (N,),
// mask (N,) or NULL, part (blocks * (2K+1),) scratch, out (2K+1,) =
// [dots | sqs | sqg]. Returns a cudaError_t: 0 when both launches were
// accepted. Never synchronises.
extern "C" int repro_round_stats_q8(const int8_t* q, const float* scales,
                                    const float* g, const float* mask,
                                    float* part, float* out, int K,
                                    long long N, int C, long long nblocks,
                                    cudaStream_t stream) {
  if (K < 1 || N < 1 || K > (INT_MAX - 1) / 2 || nblocks > INT_MAX ||
      nblocks != repro_round_stats_q_blocks(N) ||
      C != (N + repro::kChunk - 1) / repro::kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(nblocks);
  const bool vec = aligned16(g, mask);
  if (mask != nullptr)
    stats_q8_stage1<true><<<grid, kThreads, 0, stream>>>(
        q, scales, g, mask, part, K, N, C, vec);
  else
    stats_q8_stage1<false><<<grid, kThreads, 0, stream>>>(
        q, scales, g, mask, part, K, N, C, vec);
  return static_cast<int>(stage2(part, out, K, nblocks, stream));
}

// int4 wire: q (K, ceil(n/2)) packed, scales (K, G) with G =
// ceil(n / 2^lg), group size 2^lg in [2, CHUNK]; g, mask, part and out as
// above, in logical columns.
extern "C" int repro_round_stats_q4(const int8_t* q, const float* scales,
                                    const float* g, const float* mask,
                                    float* part, float* out, int K,
                                    long long n, int G, int lg,
                                    long long nblocks, cudaStream_t stream) {
  const long long nb = (n + 1) / 2;
  if (K < 1 || n < 1 || K > (INT_MAX - 1) / 2 || nblocks > INT_MAX ||
      nblocks != repro_round_stats_q_blocks(nb) || lg < 1 || lg > 14 ||
      G != (n + (1LL << lg) - 1) >> lg)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(nblocks);
  const bool vec = aligned16(g, mask);
  const bool wide = lg >= 4;
  if (mask != nullptr && wide)
    stats_q4_stage1<true, true><<<grid, kThreads, 0, stream>>>(
        q, scales, g, mask, part, K, n, nb, G, lg, vec);
  else if (mask != nullptr)
    stats_q4_stage1<true, false><<<grid, kThreads, 0, stream>>>(
        q, scales, g, mask, part, K, n, nb, G, lg, vec);
  else if (wide)
    stats_q4_stage1<false, true><<<grid, kThreads, 0, stream>>>(
        q, scales, g, mask, part, K, n, nb, G, lg, vec);
  else
    stats_q4_stage1<false, false><<<grid, kThreads, 0, stream>>>(
        q, scales, g, mask, part, K, n, nb, G, lg, vec);
  return static_cast<int>(stage2(part, out, K, nblocks, stream));
}
