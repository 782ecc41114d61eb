// Reading the quantized uplink wire (repro_torch/transport/quantize.py)
// in registers: shared by weighted_agg_q.cu and round_stats_q.cu.
//
// int8 wire: one signed byte per parameter; rows are N bytes apart.
// int4 wire: byte j of a row holds logical elements 2j (low nibble) and
// 2j+1 (high nibble), two's complement in [-7, 7]; rows are ceil(N/2)
// bytes apart, an odd stride whenever ceil(N/2) is odd.
//
// So a row of either wire may start at any byte address. load8 reads the
// 8 bytes a thread owns from any address without a misaligned access: one
// 8-byte load where the address allows it, else the aligned 4-byte words
// that cover them, joined with funnel shifts. Neighbouring threads read
// neighbouring words, so the loads coalesce all the same.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro {

constexpr long long kChunk = 128 * 128;  // int8 scale chunk (CHUNK)

__device__ __forceinline__ uint2 load8(const int8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 7) == 0) return __ldg(reinterpret_cast<const uint2*>(p));
  const unsigned int* w =
      reinterpret_cast<const unsigned int*>(a & ~static_cast<uintptr_t>(3));
  const unsigned int w0 = __ldg(w), w1 = __ldg(w + 1);
  const unsigned int sh = static_cast<unsigned int>(a & 3) * 8;
  if (sh == 0) return make_uint2(w0, w1);
  const unsigned int w2 = __ldg(w + 2);  // holds byte 7 when sh != 0
  return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
}

// Byte i (0..7, a compile-time constant in unrolled loops) of u,
// sign-extended.
__device__ __forceinline__ int byte_of(const uint2& u, int i) {
  const unsigned int w = i < 4 ? u.x : u.y;
  return static_cast<int>(w << (24 - 8 * (i & 3))) >> 24;
}

// The two nibbles of a sign-extended wire byte, each sign-extended from
// its own bit 3 (repro/kernels/weighted_agg.py::_unpack_nibbles).
__device__ __forceinline__ int nib_lo(int b) { return ((b & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int nib_hi(int b) {
  return (((b >> 4) & 0xF) ^ 8) - 8;
}

// 16 consecutive f32 values at p (logical columns), zeros from ncols on.
// vec: p is 16-byte aligned, so a full strip loads as 4 x float4.
__device__ __forceinline__ void load16f(const float* __restrict__ p,
                                        int ncols, bool vec, float (&v)[16]) {
  if (ncols == 16 && vec) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = i < ncols ? __ldg(p + i) : 0.f;
  }
}

// The same for 8 values.
__device__ __forceinline__ void load8f(const float* __restrict__ p,
                                       int ncols, bool vec, float (&v)[8]) {
  if (ncols == 8 && vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < ncols ? __ldg(p + i) : 0.f;
  }
}

}  // namespace repro
