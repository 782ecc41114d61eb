// Per-round angle statistics over the quantized uplink wire, dequantized
// in registers (the wire formats are described in wire.cuh):
//   dots[k] = <x_k, g>,  sqs[k] = ||x_k||^2,  sqg = ||g||^2
// with x_k the dequantized row: int8 x[k, n] = q[k, n] * s[k, n / CHUNK],
// int4 x[k, m] = nibble[k, m] * s[k, m / group_size]. g (N,) and the
// optional 0/1 segment mask (N,) are f32 server-side vectors in logical
// columns; with a mask, x_k and g are both multiplied by it first. Sums
// are f32. It runs once per round, in pass 2 of the flat engine.
//
// Replaces the Pallas kernels repro/kernels/round_stats.py::round_stats_q
// (_stats_q_kernel{,_masked}) and round_stats_q4 (_stats_q4_kernel
// {,_masked}). Those walk a sequential TPU grid, pair the int4 nibble
// planes with even/odd views of g and the mask, pad the scales with 1.0
// and select-zero the tail client chunk. None of that is needed here.
//
// What bounds it on Hopper: bytes. It reads K*N (int8) or K*ceil(N/2)
// (int4) wire bytes, the scales, and N*4 bytes of g (and of the mask),
// with a few integer ops and 4 flops per logical element. The design
// reads the wire as weighted_agg_q.cu does:
//
// * 16-byte loads at any row offset. Lane l of a warp owns the 16-byte
//   tile l of the warp's span of every row (16 int8 or 32 int4 columns):
//   wire.cuh's load_row / row_bytes. Lane 31 only lends its word, so a
//   warp covers 31 tiles and lane 31 adds nothing.
// * g (and the mask) loaded once a lane, for its 16 / 32 columns, as
//   float4 where aligned; the lane's share of ||g||^2 added once. With a
//   mask the lane holds m^2 g and m^2 in place of g and 1: (x m)(g m) =
//   x (m^2 g) and (x m)^2 = x^2 m^2, exact products for a 0/1 mask.
// * No integer-to-float conversion: wire.cuh's f23 / f19. With one scale
//   a lane and row (int8; int4 from group size 32 up), the lane sums
//   v * g and v^2 over its values v and scales once: dot = s * sum(v g),
//   sq = s^2 * sum(v^2). Unmasked, sum(v^2) is an exact integer taken by
//   dp4a on the bytes (int4: on the biased nibbles) and made f32 by bits.
//   Below group size 32 each byte's two nibbles share a scale, x = v * s.
// * The bytes past the row's end (the next row's, or the odd-N padding
//   nibble) are zeroed in the lane's words by a mask fixed for the lane,
//   so they add nothing and g[N] and mask[N] are never read.
// * No block barrier in the client loop. A warp takes its rows two at a
//   time, and the next two rows' loads go out before the current ones are
//   decoded: the grid is one wave, so without that every warp would wait
//   for memory and then decode at the same moment. The two rows' 2 x 2
//   per-lane sums leave the warp by a butterfly of 6 xor shuffles in a
//   fixed order, and lanes 0, 8, 16, 24 write them to shared memory. At
//   the end each block adds its warps' sums in warp order and writes its
//   (2K + 1) partials once. Blocks of two warps and a register cap keep
//   the main shape's grid in one wave and its blocks even over the SMs.
// * Two launches a call. stats_sum_kernel (stats_reduce.cuh) adds each
//   statistic's block partials in a fixed order (they lie
//   statistic-major: one contiguous run each) and writes out. It is
//   launched as a programmatic dependent launch: its blocks start while
//   stats_q_kernel still runs and wait in griddepcontrol.wait until that
//   grid has finished and its writes are visible, which hides most of a
//   second launch's start. No atomics: the same bits every run.
//
// Tried and measured slower (PERF.md has the times): one launch whose
// last block, told by ticket counters, sums every block's partials (the
// fences, atomics and L2 round trips after the last block cost more than
// the dependent launch); a second launch without PDL; int4 rows split
// over two warps (the doubled grid needs two waves at the registers that
// 32 g values a lane take); 4 rows in flight, or the next 4; blocks of 1
// or 4 warps; the keep mask applied only on edge lanes.
//
// Chosen by chip_ab.py against other versions of this file, in turns, on
// an H100 80GB HBM3 at 700 W; PERF.md lists the designs and their times.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "stats_reduce.cuh"
#include "wire.cuh"

namespace {

constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 31;  // 16-byte tiles of a warp: lane 31 only lends
constexpr int kRows = 2;    // rows of a warp in flight: the butterfly's two
// Blocks an SM must hold, which caps the registers a thread, so that the
// main shape's grid is one wave: int8 runs 12.7 blocks an SM there (72
// registers fit 14), int4 holds 32 g values a lane in 6.4 (128 fit 8).
template <bool INT4>
constexpr int kMinBlocksOf = 65536 / ((INT4 ? 128 : 72) * kThreads);

struct Args {
  const int8_t* q;      // (K, nb) wire rows
  const float* scales;  // (K, G)
  const float* g;       // (n,)
  const float* mask;    // (n,) or null
  float* part;          // (S, blocks) block partials
  int K;
  long long n;   // logical columns
  long long nb;  // bytes a row
  int G;         // scale columns
  int lg;        // scale column = column >> lg (int8: 14, a CHUNK)
  bool vec;      // g and mask 16-byte aligned
  long long blocks;
};

// The bytes of a lane's 16 that hold one of its nv logical columns (int4:
// the nibbles), as an and-mask of 4 words.
template <bool INT4>
__device__ __forceinline__ uint4 keep_mask(int nv) {
  unsigned int w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const unsigned int m = INT4 ? (2 * b < nv ? 0x0Fu : 0u) |
                                      (2 * b + 1 < nv ? 0xF0u : 0u)
                                : (b < nv ? 0xFFu : 0u);
    w[b / 4] |= m << (8 * (b % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Exact f32 of an integer 0 <= u < 2^23, by bits (no I2F).
__device__ __forceinline__ float exact_f32(unsigned int u) {
  return __uint_as_float(0x4B000000u | u) - 8388608.0f;
}

// One row's sums of a lane over its 16 int8 values: d = sum v G, q = sum
// v^2 M; unmasked q = sum v^2 by dp4a on the bytes (at most 16 * 128^2,
// exact).
template <bool MASKED>
__device__ __forceinline__ void sums_int8(const uint4& b, const float* gw,
                                          const float* mw, float& d,
                                          float& q) {
  const unsigned int words[4] = {b.x, b.y, b.z, b.w};
  int sq = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned int x = words[j] ^ 0x80808080u;
    if (!MASKED) {
      const int w = static_cast<int>(words[j]);
      sq = __dp4a(w, w, sq);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * j + i;
      const float v = repro::f23(x, i) - repro::kS8Bias;
      d = fmaf(v, gw[e], d);
      if (MASKED) q = fmaf(v * mw[e], v, q);
    }
  }
  if (!MASKED) q = exact_f32(static_cast<unsigned int>(sq));
}

// The same over 32 int4 values (logical columns col..col+31). WIDE: one
// scale a lane, applied by the caller, and unmasked q = sum v^2 by dp4a
// on the biased nibbles u = v + 8: sum (u - 8)^2 = sum u^2 - 16 sum u +
// 64 * 32 (a zeroed nibble is u = 8, v = 0). Else x = v * s with byte i's
// scale looked up in the row's scales sk (group (col + 2i) >> lg).
template <bool WIDE, bool MASKED>
__device__ __forceinline__ void sums_int4(const uint4& b, const float* gw,
                                          const float* mw,
                                          const float* __restrict__ sk,
                                          long long col, int lg, int G,
                                          float& d, float& q) {
  constexpr bool kInt = WIDE && !MASKED;  // q by dp4a
  const unsigned int words[4] = {b.x, b.y, b.z, b.w};
  unsigned int u2 = 0u, u1 = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned int x = words[j] ^ 0x88888888u;
    const unsigned int lo = x & 0x0F0F0F0Fu, hi = x & 0xF0F0F0F0u;
    if (kInt) {
      const unsigned int hs = hi >> 4;
      u2 = __dp4a(lo, lo, __dp4a(hs, hs, u2));
      u1 = __dp4a(lo + hs, 0x01010101u, u1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 2 * (4 * j + i);  // byte 4j+i: columns e, e+1
      float v0 = repro::f23(lo, i) - repro::kLoBias;
      float v1 = repro::f19(hi, i) - repro::kHiBias;
      if (!WIDE) {
        const float s = __ldg(sk + min((col + e) >> lg,
                                       static_cast<long long>(G - 1)));
        v0 *= s;
        v1 *= s;
      }
      d = fmaf(v0, gw[e], d);
      d = fmaf(v1, gw[e + 1], d);
      if (!kInt) {
        q = fmaf(MASKED ? v0 * mw[e] : v0, v0, q);
        q = fmaf(MASKED ? v1 * mw[e + 1] : v1, v1, q);
      }
    }
  }
  if (kInt) q = exact_f32(u2 - 16u * u1 + 64u * 32u);
}

// The rows k0 + u (u < kRows) of the lane's tile that exist, and their
// scales when one covers the lane (WIDE).
template <bool WIDE>
__device__ __forceinline__ void load_rows(const Args& a, int k0,
                                          long long tile, long long sc_col,
                                          repro::RowLoad (&ld)[kRows],
                                          float (&s)[kRows]) {
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int k = k0 + u;
    if (k < a.K) {
      ld[u] = repro::load_row(a.q, k, a.nb, tile);
      if (WIDE)
        s[u] = __ldg(a.scales + static_cast<long long>(k) * a.G + sc_col);
    }
  }
}

// Each block's partials over either wire: kCols logical columns a tile,
// WIDE: one scale a lane and row (int8 always).
template <bool INT4, bool WIDE, bool MASKED>
__global__ void __launch_bounds__(kThreads, kMinBlocksOf<INT4>)
stats_q_kernel(Args a) {
  // stats_sum_kernel may launch now: it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;");
  constexpr int kCols = INT4 ? 32 : 16;
  extern __shared__ float red[];  // (kWarps, S): each warp's row sums
  const int K = a.K, S = 2 * K + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const long long tile0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kTiles;
  const long long tile = tile0 + lane, col = kCols * tile;
  const int nv = lane == kTiles ? 0 : static_cast<int>(
      max(0LL, min(static_cast<long long>(kCols), a.n - col)));
  // lanes past the edge keep a valid scale column and add zeros
  const long long sc_col = min(col >> a.lg, static_cast<long long>(a.G - 1));

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
  const uint4 keep = keep_mask<INT4>(nv);
  float* mine = red + warp * S;

  repro::RowLoad next[kRows];
  float s_next[kRows];
  load_rows<WIDE>(a, 0, tile, sc_col, next, s_next);
  for (int k0 = 0; k0 < K; k0 += kRows) {
    repro::RowLoad ld[kRows];
    float s[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      ld[u] = next[u];
      s[u] = s_next[u];
    }
    // the next rows' loads go out before these rows are decoded
    if (k0 + kRows < K)
      load_rows<WIDE>(a, k0 + kRows, tile, sc_col, next, s_next);
    float dq[2 * kRows];  // row u: d at 2u, q at 2u + 1
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int k = k0 + u;
      float& d = dq[2 * u];
      float& q = dq[2 * u + 1];
      d = q = 0.f;
      if (k < K) {  // the same for the whole warp
        uint4 b = repro::row_bytes(ld[u]);
        b.x &= keep.x;
        b.y &= keep.y;
        b.z &= keep.z;
        b.w &= keep.w;
        if constexpr (INT4)
          sums_int4<WIDE, MASKED>(b, gw, mw,
                                  a.scales + static_cast<long long>(k) * a.G,
                                  col, a.lg, a.G, d, q);
        else
          sums_int8<MASKED>(b, gw, mw, d, q);
        if (WIDE) {
          d *= s[u];
          q *= s[u] * s[u];
        }
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

// Blocks for rows of nb bytes: 16-byte tiles, kTiles a warp.
long long blocks_for(long long nb) {
  const long long spans = ((nb + 15) / 16 + kTiles - 1) / kTiles;
  return (spans + kWarps - 1) / kWarps;
}

// lg = 0: the int8 wire of n columns; else the int4 wire of n logical
// columns, ceil(n / 2) bytes a row.
long long row_bytes_of(long long n, int lg) {
  return lg == 0 ? n : (n + 1) / 2;
}

template <bool INT4, bool WIDE, bool MASKED>
cudaError_t launch(const Args& a, float* out, cudaStream_t stream) {
  return repro::launch_stats(stats_q_kernel<INT4, WIDE, MASKED>, a, kWarps,
                             out, stream);
}

Args make_args(const int8_t* q, const float* scales, const float* g,
               const float* mask, float* part, int K, long long n, int G,
               int lg) {
  const long long nb = row_bytes_of(n, lg);
  const bool vec = (reinterpret_cast<uintptr_t>(g) |
                    reinterpret_cast<uintptr_t>(mask)) % 16 == 0;
  return Args{q, scales, g, mask, part, K, n, nb, G, lg == 0 ? 14 : lg,
              vec, blocks_for(nb)};
}

bool valid(const Args& a) {
  return a.K >= 1 && a.n >= 1 && a.K <= (INT_MAX - 1) / 2 &&
         a.blocks <= INT_MAX;
}

}  // namespace

// The floats of one call's `part` scratch: (2K + 1) * blocks. lg = 0 for
// the int8 wire of n columns, log2(group size) for the int4 wire of n
// logical columns.
extern "C" long long repro_wire_stats_floats(int K, long long n, int lg) {
  return (2LL * K + 1) * blocks_for(row_bytes_of(n, lg));
}

// int8 wire: q (K, N) at any byte address, scales (K, C) with C =
// ceil(N / CHUNK), g (N,), mask (N,) or NULL, part as above, out (2K+1,) =
// [dots | sqs | sqg]. Returns a cudaError_t: 0 when both launches were
// accepted. Never synchronises.
extern "C" int repro_wire_stats_q8(const int8_t* q, const float* scales,
                                   const float* g, const float* mask,
                                   float* part, float* out, int K,
                                   long long N, int C, cudaStream_t stream) {
  static_assert(repro::kChunk == 1 << 14, "int8 scale column = col >> 14");
  const Args a = make_args(q, scales, g, mask, part, K, N, C, 0);
  if (!valid(a) || C != (N + repro::kChunk - 1) / repro::kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      mask != nullptr ? launch<false, true, true>(a, out, stream)
                      : launch<false, true, false>(a, out, stream));
}

// int4 wire: q (K, ceil(n/2)) packed, scales (K, G) with G =
// ceil(n / 2^lg), group size 2^lg in [2, CHUNK]; g, mask, part and out as
// above, in logical columns.
extern "C" int repro_wire_stats_q4(const int8_t* q, const float* scales,
                                   const float* g, const float* mask,
                                   float* part, float* out, int K,
                                   long long n, int G, int lg,
                                   cudaStream_t stream) {
  if (lg < 1 || lg > 14) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, scales, g, mask, part, K, n, G, lg);
  if (!valid(a) || G != (n + (1LL << lg) - 1) >> lg)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = lg >= 5, masked = mask != nullptr;
  cudaError_t e;
  if (wide && masked)
    e = launch<true, true, true>(a, out, stream);
  else if (wide)
    e = launch<true, true, false>(a, out, stream);
  else if (masked)
    e = launch<true, false, true>(a, out, stream);
  else
    e = launch<true, false, false>(a, out, stream);
  return static_cast<int>(e);
}
