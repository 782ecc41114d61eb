// Reading the quantized uplink wire (repro_torch/transport/quantize.py)
// in registers. Both wire kernels use all of it: weighted_agg_q.cu (the
// aggregations) and round_stats_q.cu (the statistics). round_stats.cu's
// bf16 statistics read the bf16 wire the same way, 32 bytes a lane
// (load_row2, row_bytes2), and load g as round_stats_q.cu does
// (lane_cols).
//
// int8 wire: one signed byte per parameter; rows are N bytes apart.
// int4 wire: byte j of a row holds logical elements 2j (low nibble) and
// 2j+1 (high nibble), two's complement in [-7, 7]; rows are ceil(N/2)
// bytes apart, an odd stride whenever ceil(N/2) is odd.
//
// So a row of either wire may start at any byte address. Lane l of a warp
// owns the 16-byte tile l of the warp's span of every row: it loads the
// aligned 16-byte word l of the span (load_row), whatever the row's offset
// r = start % 16, and takes the next word from lane l + 1 by shuffles: its
// 16 row bytes are bytes r..15 of its word and 0..r-1 of the next
// (row_bytes, realign16). Lane 31 only lends its word, so a warp covers
// 31 tiles. No access is misaligned, and every word loaded holds a byte of
// the row. The bytes are then turned into exact f32 values by bits (f23,
// f19), with no integer-to-float conversion.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro {

constexpr long long kChunk = 128 * 128;  // int8 scale chunk (CHUNK)
constexpr unsigned int kFullWarp = 0xffffffffu;

// ---- 16-byte words of a row at any byte offset

// The 16 row bytes that start r (0..15) bytes into the aligned word a:
// bytes r..15 of a, then bytes 0..r-1 of the next aligned word b. r is
// the same for a whole row, so the selects below never diverge.
__device__ __forceinline__ uint4 realign16(const uint4& a, const uint4& b,
                                           unsigned int r) {
  unsigned int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 6; ++j) v[j] = (r & 8) ? v[j + 2] : v[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) v[j] = (r & 4) ? v[j + 1] : v[j];
  const unsigned int sh = (r & 3) * 8;
  return make_uint4(__funnelshift_r(v[0], v[1], sh),
                    __funnelshift_r(v[1], v[2], sh),
                    __funnelshift_r(v[2], v[3], sh),
                    __funnelshift_r(v[3], v[4], sh));
}

// One row's 16-byte tile of a lane, loaded: the aligned word `tile` of
// the row's span (zero when it holds no byte of the row), and r.
struct RowLoad {
  uint4 word;
  unsigned int r;
};

// Row k of nb bytes starting at q + k * nb.
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
  const uint4 next = make_uint4(__shfl_down_sync(kFullWarp, l.word.x, 1),
                                __shfl_down_sync(kFullWarp, l.word.y, 1),
                                __shfl_down_sync(kFullWarp, l.word.z, 1),
                                __shfl_down_sync(kFullWarp, l.word.w, 1));
  return realign16(l.word, next, l.r);
}

// The same for a lane that owns 32 row bytes: the aligned words 2 * tile
// and 2 * tile + 1 of the row's span (each zero when it holds no byte of
// the row). Its 32 row bytes are bytes r..15 of its first word, all of its
// second, and bytes 0..r-1 of its right neighbour's first word: one word
// borrowed by shuffles, as above. Lane 31 only lends its first word.
struct RowLoad2 {
  uint4 lo, hi;
  unsigned int r;
};

__device__ __forceinline__ RowLoad2 load_row2(const int8_t* q, int k,
                                              long long nb, long long tile) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(q) +
                      static_cast<uintptr_t>(k) * nb;
  const uint4* w = reinterpret_cast<const uint4*>(p & ~uintptr_t{15});
  RowLoad2 out;
  out.r = static_cast<unsigned int>(p & 15);
  out.lo = out.hi = make_uint4(0u, 0u, 0u, 0u);
  if (32 * tile < nb + out.r) out.lo = __ldg(w + 2 * tile);
  if (32 * tile + 16 < nb + out.r) out.hi = __ldg(w + 2 * tile + 1);
  return out;
}

// The lane's 32 row bytes as two words. Every lane of the warp calls it.
__device__ __forceinline__ void row_bytes2(const RowLoad2& l, uint4& lo,
                                           uint4& hi) {
  if (l.r == 0) {
    lo = l.lo;
    hi = l.hi;
    return;
  }
  const uint4 next = make_uint4(__shfl_down_sync(kFullWarp, l.lo.x, 1),
                                __shfl_down_sync(kFullWarp, l.lo.y, 1),
                                __shfl_down_sync(kFullWarp, l.lo.z, 1),
                                __shfl_down_sync(kFullWarp, l.lo.w, 1));
  lo = realign16(l.lo, l.hi, l.r);
  hi = realign16(l.hi, next, l.r);
}

// ---- a lane's share of the f32 server-side vectors (g, the mask)

// v[0..C) = p[0..nv), zeros after. vec: p 16-byte aligned.
template <int C>
__device__ __forceinline__ void lane_cols(const float* __restrict__ p,
                                          int nv, bool vec, float (&v)[C]) {
  if (nv == C && vec) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = i < nv ? __ldg(p + i) : 0.f;
  }
}

// ---- exact f32 values built from bits

// Exact f32 of a small unsigned integer u in byte i (0..3) of x, without
// an integer-to-float conversion: u copied into the low mantissa byte of
// 2^E reads as the float 2^E + u * 2^(E-23). With E = 23 that is 2^23 + u,
// with E = 19 (the byte holds u << 4) 2^19 + u; one subtraction of the
// power of two and the bias leaves the signed value exactly.
//   int8: x = word ^ 0x80808080 (b + 128), value = f(x) - (2^23 + 128)
//   int4 low nibbles:  x = (word ^ 0x88888888) & 0x0F0F0F0F,
//                      value = f(x) - (2^23 + 8)
//   int4 high nibbles: x = (word ^ 0x88888888) & 0xF0F0F0F0,
//                      value = f19(x) - (2^19 + 8)
// A byte (or nibble) of 0 decodes to 0 exactly, so zeroing the bytes of a
// word that lie past a row's end removes them from any sum.
constexpr float kS8Bias = 8388736.0f;   // 2^23 + 128
constexpr float kLoBias = 8388616.0f;   // 2^23 + 8
constexpr float kHiBias = 524296.0f;    // 2^19 + 8
__device__ __forceinline__ float f23(unsigned int x, int i) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | i));
}
__device__ __forceinline__ float f19(unsigned int x, int i) {
  return __uint_as_float(__byte_perm(x, 0x49000000u, 0x7440u | i));
}

}  // namespace repro
