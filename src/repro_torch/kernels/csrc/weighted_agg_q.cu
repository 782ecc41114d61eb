// Weighted aggregation over the quantized uplink wire, dequantized in
// registers (the wire formats are described in wire.cuh):
//   int8: y[n] = sum_k (w[k] * scales[k, n / CHUNK])      * q[k, n]
//   int4: y[m] = sum_k (w[k] * scales[k, m / group_size]) * nibble[k, m]
// y (N,) f32, sums in f32. It is the FedAdp global update over an int8 or
// int4 uplink, run twice per round. The fold w[k] * scale is an f32
// product rounded once (__fmul_rn), as the plain version's `_fold`, made
// in the kernel for each row and scale column a lane reads: one launch a
// call and no PyTorch op beside it.
//
// Replaces the Pallas kernels repro/kernels/weighted_agg.py::
// weighted_agg_q (_agg_q_kernel) and weighted_agg_q4 (_agg_q4_kernel).
// Those walk a sequential TPU grid over (ROWS, LANE) byte tiles and keep
// the int4 even and odd nibbles in two output planes interleaved after the
// kernel, with scales padded by 1.0 to whole tiles. None of that is needed
// here: every lane owns one 16-byte tile of every row (16 int8 or 32 int4
// columns), sums its rows in registers, and its columns of y are written
// once, in logical order. The ragged column edge and the odd-N padding
// nibble are masked at the store: the padding nibble is never written.
//
// What bounds it on Hopper: bytes. It reads K*N (int8) or K*ceil(N/2)
// (int4) wire bytes plus the scales and writes N*4 bytes of y. The design:
//
// * 16-byte loads. A row of either wire may start at any byte address (at
//   the main path's shape the int8 rows are 2-byte aligned, half the int4
//   rows odd). Lane l of a warp loads the aligned 16-byte word l of the
//   warp's span of the row, whatever the row's offset r = start % 16, and
//   takes the next word from lane l + 1 by shuffles: its 16 row bytes are
//   bytes r..15 of its word and 0..r-1 of the next (wire.cuh's
//   realign16). Lane 31 only lends its word, so a warp covers 31 tiles.
//   No access is misaligned, and every word loaded holds a byte of the
//   row. Rows with r = 0 skip the shuffles.
// * No integer-to-float conversion. A byte or nibble becomes its exact
//   f32 by bits: one permute into the mantissa of a power of two and one
//   subtraction (wire.cuh's f23 / f19), then one FFMA. The sums are those
//   of a conversion by I2F, bit for bit.
// * Loads ahead of the arithmetic: a warp issues the loads of kRows = 2
//   rows before it decodes them. The whole grid fits on the card at once,
//   so every lane's two loads are in flight together; more rows a lane
//   (3, 4, 5, 10), or the next two rows loaded while the current two are
//   decoded, cost registers and measured no faster.
// * Contiguous stores. Each warp writes its sums to shared memory and
//   reads them back four columns a lane, so every store instruction of
//   the warp covers 512 contiguous bytes of y (a lane's own 64 or 128
//   bytes, stored directly, cost int4 a third more time).
// * int4 with one scale a lane (group size >= 32) splits each tile's rows
//   over two warps (even rows, odd rows): the int4 grid has half the
//   int8 grid's lanes for the same number of columns, and its decode is
//   twice the work a byte. The two partial sums meet in shared memory and
//   are added in one fixed order (even + odd), so a launch gives the same
//   bits every time. int8 and the per-byte int4 path measured faster
//   without the split. No atomics anywhere.
//
// Scale lookups. int8: a lane's 16 columns lie in one CHUNK. int4: the
// group size is a power of two (an even divisor of CHUNK); from 32 up a
// lane's 32 columns lie in one group (one scale a row), below 32 the lane
// looks a scale up per byte (both nibbles of a byte share it).
//
// Chosen by chip_ab.py against other versions of this file, in turns, on
// an H100 80GB HBM3 at 700 W; PERF.md lists the designs and their times.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wire.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 31;  // 16-byte tiles of a warp: lane 31 only lends
constexpr int kRows = 2;    // rows of a warp whose loads go out together
constexpr unsigned kFull = 0xffffffffu;

// One row's 16-byte tile of this lane, loaded: the aligned word `tile` of
// the row's span (zero when it holds no byte of the row), and r.
struct RowLoad {
  uint4 word;
  unsigned int r;
};

__device__ __forceinline__ RowLoad load_row(const int8_t* q, int k,
                                            long long nb, long long tile) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(q) +
                      static_cast<uintptr_t>(k) * nb;
  RowLoad out;
  out.r = static_cast<unsigned int>(p & 15);
  out.word = make_uint4(0u, 0u, 0u, 0u);
  if (16 * tile < nb + out.r)
    out.word = __ldg(reinterpret_cast<const uint4*>(p & ~uintptr_t{15}) +
                     tile);
  return out;
}

// The lane's 16 row bytes: its word, realigned with its right neighbour's
// when the row is not 16-byte aligned. Every lane of the warp calls it.
__device__ __forceinline__ uint4 row_bytes(const RowLoad& l) {
  if (l.r == 0) return l.word;
  const uint4 next = make_uint4(__shfl_down_sync(kFull, l.word.x, 1),
                                __shfl_down_sync(kFull, l.word.y, 1),
                                __shfl_down_sync(kFull, l.word.z, 1),
                                __shfl_down_sync(kFull, l.word.w, 1));
  return repro::realign16(l.word, next, l.r);
}

// acc += s * value for the 16 int8 values of b.
__device__ __forceinline__ void add_int8(float (&acc)[16], const uint4& b,
                                         float s) {
  const unsigned int words[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned int x = words[j] ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[4 * j + i] = fmaf(s, repro::f23(x, i) - repro::kS8Bias,
                            acc[4 * j + i]);
  }
}

// acc += scale * nibble for the 32 nibbles of b (logical columns m..m+31).
// WIDE: s is the lane's folded scale; else s = w[k] and byte i's scale is
// looked up in the row's scales sk (group (m + 2i) >> lg, at most G - 1).
template <bool WIDE>
__device__ __forceinline__ void add_int4(float (&acc)[32], const uint4& b,
                                         float s, const float* sk,
                                         long long m, int lg, int G) {
  const unsigned int words[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned int x = words[j] ^ 0x88888888u;
    const unsigned int lo = x & 0x0F0F0F0Fu, hi = x & 0xF0F0F0F0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 2 * (4 * j + i);  // byte 4j+i: columns e, e+1
      const float sc =
          WIDE ? s
               : __fmul_rn(s, __ldg(sk + min((m + e) >> lg,
                                             static_cast<long long>(G - 1))));
      acc[e] = fmaf(sc, repro::f23(lo, i) - repro::kLoBias, acc[e]);
      acc[e + 1] = fmaf(sc, repro::f19(hi, i) - repro::kHiBias, acc[e + 1]);
    }
  }
}

// The sums of kSplit warps that share a tile to y[first..first+ncols):
// each warp puts its lanes' kCols columns in shared memory at lane *
// (kCols + 4) (16-byte aligned, conflict-free float4 writes); then the
// warps read them back four columns a lane, add the kSplit parts in order
// 0, 1, .., and store, every store instruction 512 contiguous bytes.
template <int kCols, int kSplit>
__device__ __forceinline__ void store_tile(float* parts,
                                           const float (&acc)[kCols],
                                           float* __restrict__ y,
                                           long long first, long long ncols,
                                           int lane, int part) {
  constexpr int kLd = kCols + 4;
  float* mine = parts + part * 32 * kLd;
#pragma unroll
  for (int i = 0; i < kCols; i += 4)
    *reinterpret_cast<float4*>(mine + lane * kLd + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  if (kSplit > 1)
    __syncthreads();
  else
    __syncwarp();
  for (long long j = 4 * (lane + 32 * part); j < ncols; j += 128 * kSplit) {
    const int a = static_cast<int>(j / kCols * kLd + j % kCols);
    float4 v = *reinterpret_cast<const float4*>(parts + a);
#pragma unroll
    for (int p = 1; p < kSplit; ++p) {
      const float4 o =
          *reinterpret_cast<const float4*>(parts + p * 32 * kLd + a);
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    if (j + 4 <= ncols) {
      *reinterpret_cast<float4*>(y + first + j) = v;
    } else {  // the row's end: 1 to 3 columns
      y[first + j] = v.x;
      if (j + 1 < ncols) y[first + j + 1] = v.y;
      if (j + 2 < ncols) y[first + j + 2] = v.z;
    }
  }
}

// int4 with one scale a lane splits each tile's rows over two warps
template <bool INT4, bool WIDE>
constexpr int kSplitOf = INT4 && WIDE ? 2 : 1;

// One launch of either wire. The kSplit warps of a tile take the rows
// k = part, part + kSplit, ..; rows of nb bytes, n logical columns (kCols
// a tile), scales (K, G) with scale column col >> lg (int8: lg = 14, a
// CHUNK); WIDE: one scale a lane (int8 always), else one a byte.
template <bool INT4, bool WIDE>
__device__ __forceinline__ void agg(const float* __restrict__ w,
                                    const float* __restrict__ scales,
                                    const int8_t* __restrict__ q,
                                    float* __restrict__ y, int K,
                                    long long n, long long nb, int G,
                                    int lg) {
  constexpr int kCols = INT4 ? 32 : 16;
  constexpr int kSplit = kSplitOf<INT4, WIDE>;
  __shared__ __align__(16) float parts[kWarps * 32 * (kCols + 4)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int part = warp % kSplit;
  const long long tile0 =  // the first tile of this warp's span
      (static_cast<long long>(blockIdx.x) * (kWarps / kSplit) +
       warp / kSplit) * kTiles;
  const long long tile = tile0 + lane;
  const long long col = kCols * tile;
  // lanes past the edge keep a valid scale column and store nothing
  const long long sc_col = min(col >> lg, static_cast<long long>(G - 1));
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  for (int k0 = part; k0 < K; k0 += kSplit * kRows) {
    RowLoad ld[kRows];
    float s[kRows];  // the folded scale; w[k] on the per-byte path
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int k = k0 + kSplit * u;
      if (k < K) {
        ld[u] = load_row(q, k, nb, tile);
        s[u] = __ldg(w + k);
        if (WIDE)
          s[u] = __fmul_rn(s[u], __ldg(scales + static_cast<long long>(k) *
                                                    G + sc_col));
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int k = k0 + kSplit * u;
      if (k < K) {  // the same for the whole warp
        const uint4 b = row_bytes(ld[u]);
        if constexpr (INT4)
          add_int4<WIDE>(acc, b, s[u],
                         scales + static_cast<long long>(k) * G, col, lg, G);
        else
          add_int8(acc, b, s[u]);
      }
    }
  }
  const long long first = kCols * tile0;
  store_tile<kCols, kSplit>(parts + (warp - part) * 32 * (kCols + 4), acc,
                            y, first,
                            min(static_cast<long long>(kCols) * kTiles,
                                n - first),
                            lane, part);
}

__global__ void __launch_bounds__(kThreads)
agg_q8_kernel(const float* __restrict__ w, const float* __restrict__ scales,
              const int8_t* __restrict__ q, float* __restrict__ y, int K,
              long long N, int C) {
  agg<false, true>(w, scales, q, y, K, N, N, C, 14);
}

// WIDE: group_size >= 32, one scale a lane and row. lg = log2(gs).
template <bool WIDE>
__global__ void __launch_bounds__(kThreads)
agg_q4_kernel(const float* __restrict__ w, const float* __restrict__ scales,
              const int8_t* __restrict__ q, float* __restrict__ y, int K,
              long long n, long long nb, int G, int lg) {
  agg<true, WIDE>(w, scales, q, y, K, n, nb, G, lg);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Blocks for rows of nb bytes: 16-byte tiles, kTiles a warp, kSplit warps
// a tile.
long long blocks_for(long long nb, int split) {
  const long long spans = ((nb + 15) / 16 + kTiles - 1) / kTiles;
  const long long per_block = kWarps / split;
  return (spans + per_block - 1) / per_block;
}

}  // namespace

// int8 wire: w (K,) f32, scales (K, C) f32 with C = ceil(N / CHUNK), q
// (K, N) int8 at any byte address, y (N,) f32 (16-byte aligned). Returns a
// cudaError_t: 0 when the launch was accepted. Never synchronises.
extern "C" int repro_wire_agg_q8(const float* w, const float* scales,
                                 const int8_t* q, float* y, int K,
                                 long long N, int C, cudaStream_t stream) {
  static_assert(repro::kChunk == 1 << 14, "int8 scale column = col >> 14");
  const long long blocks = blocks_for(N, kSplitOf<false, true>);
  if (K < 1 || N < 1 || blocks > INT_MAX ||
      C != (N + repro::kChunk - 1) / repro::kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(y)) return static_cast<int>(cudaErrorMisalignedAddress);
  agg_q8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      w, scales, q, y, K, N, C);
  return static_cast<int>(cudaGetLastError());
}

// int4 wire: w (K,) f32, scales (K, G) f32 with G = ceil(n / 2^lg), q
// (K, nb) packed int8 with nb = ceil(n / 2), y (n,) f32 (16-byte aligned),
// group size 2^lg in [2, CHUNK].
extern "C" int repro_wire_agg_q4(const float* w, const float* scales,
                                 const int8_t* q, float* y, int K,
                                 long long n, int G, int lg,
                                 cudaStream_t stream) {
  const long long nb = (n + 1) / 2;
  const bool wide = lg >= 5;
  const long long blocks =
      blocks_for(nb, wide ? kSplitOf<true, true> : kSplitOf<true, false>);
  if (K < 1 || n < 1 || blocks > INT_MAX || lg < 1 || lg > 14 ||
      G != (n + (1LL << lg) - 1) >> lg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(y)) return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (wide)
    agg_q4_kernel<true><<<grid, kThreads, 0, stream>>>(w, scales, q, y, K,
                                                       n, nb, G, lg);
  else
    agg_q4_kernel<false><<<grid, kThreads, 0, stream>>>(w, scales, q, y, K,
                                                        n, nb, G, lg);
  return static_cast<int>(cudaGetLastError());
}
