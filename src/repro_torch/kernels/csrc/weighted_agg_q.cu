// Weighted aggregation over the quantized uplink wire, dequantized in
// registers (the wire formats are described in wire.cuh):
//   int8: y[n] = sum_k ws[k, n / CHUNK]     * q[k, n]
//   int4: y[m] = sum_k ws[k, m / group_size] * nibble[k, m]
// where ws = w[:, None] * scales is folded once on the host (the wrapper),
// as the reference does; y (N,) f32, sums in f32. It is the FedAdp global
// update over an int8 or int4 uplink, run twice per round.
//
// Replaces the Pallas kernels repro/kernels/weighted_agg.py::
// weighted_agg_q (_agg_q_kernel) and weighted_agg_q4 (_agg_q4_kernel).
// Those walk a sequential TPU grid over (ROWS, LANE) byte tiles and keep
// the int4 even and odd nibbles in two output planes interleaved after the
// kernel, with scales padded by 1.0 to whole tiles. None of that is needed
// here: every thread owns 8 consecutive wire bytes of each row (8 int8 or
// 16 int4 columns), loops over all K rows with its sums in registers, and
// writes its columns of y once, in logical order. The ragged column edge
// and the odd-N padding nibble are masked in the kernel: the padding
// nibble of the last byte is never written to y.
//
// Scale lookups. int8: a block covers 256 * 8 = 2048 columns, a divisor of
// CHUNK, so all of a block's columns share one scale column. int4: the
// group size is a power of two (an even divisor of CHUNK); from 16 up,
// a thread's 16 columns lie in one group (one scale per row), below 16 the
// thread looks a scale up per byte (both nibbles of a byte share it).
// The one-scale path earns its second instantiation: at the main path's
// shape and group size 512, the per-byte lookup alone took 16% longer
// here and 11% longer in round_stats_q.cu (chip_ab.py on an H100 80GB
// HBM3 at 700 W).
//
// What bounds it on Hopper: bytes. It reads K*N (int8) or K*ceil(N/2)
// (int4) wire bytes plus the folded scales and writes N*4 bytes of y; the
// decode is a few integer ops per byte. At the main path's shape (K = 10,
// N = 1,663,370) the int8 rows are only 2-byte aligned and every other
// int4 row starts on an odd address: load8 reads such rows through
// aligned words and funnel shifts, never a misaligned access.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wire.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBytes = 8;  // wire bytes per thread per row
constexpr long long kTile = kThreads * kBytes;
static_assert(repro::kChunk % kTile == 0, "a block must lie in one chunk");

// N consecutive floats to a 16-byte aligned p, as float4 stores.
template <int N>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__global__ void __launch_bounds__(kThreads)
agg_q8_kernel(const float* __restrict__ ws, const int8_t* __restrict__ q,
              float* __restrict__ y, int K, long long N, int C) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kBytes;
  if (col >= N) return;
  const int c = static_cast<int>(col / repro::kChunk);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (col + kBytes <= N) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const uint2 u = repro::load8(q + static_cast<long long>(k) * N + col);
      const float s = __ldg(ws + static_cast<long long>(k) * C + c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i] = fmaf(s, static_cast<float>(repro::byte_of(u, i)), acc[i]);
    }
    store_vec(y + col, acc);
  } else {  // ragged edge: fewer than 8 columns left
    const int n = static_cast<int>(N - col);
    for (int k = 0; k < K; ++k) {
      const int8_t* p = q + static_cast<long long>(k) * N + col;
      const float s = __ldg(ws + static_cast<long long>(k) * C + c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < n) acc[i] = fmaf(s, static_cast<float>(__ldg(p + i)), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) y[col + i] = acc[i];
  }
}

// WIDE: group_size >= 16, one scale per thread and row. lg = log2(gs).
template <bool WIDE>
__global__ void __launch_bounds__(kThreads)
agg_q4_kernel(const float* __restrict__ ws, const int8_t* __restrict__ q,
              float* __restrict__ y, int K, long long n, long long nb, int G,
              int lg) {
  const long long j =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kBytes;
  if (j >= nb) return;
  const long long m = 2 * j;  // first logical column of this thread
  const int nbytes = static_cast<int>(nb - j < kBytes ? nb - j : kBytes);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const int8_t* p = q + static_cast<long long>(k) * nb + j;
    const float* wk = ws + static_cast<long long>(k) * G;
    const float s0 = WIDE ? __ldg(wk + (m >> lg)) : 0.f;
    if (nbytes == kBytes) {
      const uint2 u = repro::load8(p);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = repro::byte_of(u, i);
        const float s = WIDE ? s0 : __ldg(wk + ((m + 2 * i) >> lg));
        acc[2 * i] = fmaf(s, static_cast<float>(repro::nib_lo(b)),
                          acc[2 * i]);
        acc[2 * i + 1] = fmaf(s, static_cast<float>(repro::nib_hi(b)),
                              acc[2 * i + 1]);
      }
    } else {  // ragged edge: fewer than 8 bytes left in the row
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < nbytes) {
          const int b = __ldg(p + i);
          const float s = WIDE ? s0 : __ldg(wk + ((m + 2 * i) >> lg));
          acc[2 * i] = fmaf(s, static_cast<float>(repro::nib_lo(b)),
                            acc[2 * i]);
          acc[2 * i + 1] = fmaf(s, static_cast<float>(repro::nib_hi(b)),
                                acc[2 * i + 1]);
        }
      }
    }
  }
  if (m + 16 <= n) {
    store_vec(y + m, acc);
  } else {  // the row's end, the odd-N padding nibble included: not written
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (m + i < n) y[m + i] = acc[i];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// int8 wire: ws (K, C) folded weights x scales, q (K, N) int8, y (N,) f32
// (16-byte aligned), C = ceil(N / CHUNK). Returns a cudaError_t: 0 when
// the launch was accepted. Never synchronises.
extern "C" int repro_weighted_agg_q8(const float* ws, const int8_t* q,
                                     float* y, int K, long long N, int C,
                                     cudaStream_t stream) {
  const long long blocks = (N + kTile - 1) / kTile;
  if (K < 1 || N < 1 || blocks > INT_MAX ||
      C != (N + repro::kChunk - 1) / repro::kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(y)) return static_cast<int>(cudaErrorMisalignedAddress);
  agg_q8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ws, q, y, K, N, C);
  return static_cast<int>(cudaGetLastError());
}

// int4 wire: ws (K, G) folded weights x group scales, q (K, nb) packed
// int8 with nb = ceil(n / 2), y (n,) f32 (16-byte aligned), G =
// ceil(n / 2^lg), group size 2^lg in [2, CHUNK].
extern "C" int repro_weighted_agg_q4(const float* ws, const int8_t* q,
                                     float* y, int K, long long n, int G,
                                     int lg, cudaStream_t stream) {
  const long long nb = (n + 1) / 2;
  const long long blocks = (nb + kTile - 1) / kTile;
  if (K < 1 || n < 1 || blocks > INT_MAX || lg < 1 || lg > 14 ||
      G != (n + (1LL << lg) - 1) >> lg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(y)) return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (lg >= 4)
    agg_q4_kernel<true><<<grid, kThreads, 0, stream>>>(ws, q, y, K, n, nb, G,
                                                       lg);
  else
    agg_q4_kernel<false><<<grid, kThreads, 0, stream>>>(ws, q, y, K, n, nb,
                                                        G, lg);
  return static_cast<int>(cudaGetLastError());
}
