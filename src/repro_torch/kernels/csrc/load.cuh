// Loads of the f32 and bf16 client-delta rows, widened to f32: load1 /
// load4 shared by weighted_agg.cu and batched_dot.cu, the widening by
// round_stats.cu and grad_dot.cu too. bf16 rides as its raw 16 bits
// (uint16_t), and widening it to f32 is a 16-bit shift.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// 4 consecutive elements at p, widened to f32, with loads VW elements
// wide; p is aligned to VW * sizeof(element) bytes (the launchers pick VW
// so that it is).
template <int VW>
__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      float (&v)[4]) {
  if constexpr (VW == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (VW == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldg(p + i);
  }
}

template <int VW>
__device__ __forceinline__ void load4(const uint16_t* __restrict__ p,
                                      float (&v)[4]) {
  if constexpr (VW == 4) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_lo(a.x); v[1] = bf16_hi(a.x);
    v[2] = bf16_lo(a.y); v[3] = bf16_hi(a.y);
  } else if constexpr (VW == 2) {
    const uint32_t a = __ldg(reinterpret_cast<const unsigned int*>(p));
    const uint32_t b = __ldg(reinterpret_cast<const unsigned int*>(p + 2));
    v[0] = bf16_lo(a); v[1] = bf16_hi(a); v[2] = bf16_lo(b); v[3] = bf16_hi(b);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = load1(p + i);
  }
}

}  // namespace repro
