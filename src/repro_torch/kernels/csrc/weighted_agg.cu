// Weighted aggregation over the round's flat client-delta buffer:
//   y[n] = sum_k w[k] * x[k, n],  x (K, N) row-major, f32 or bf16 (the
//   bf16 wire), w (K,) f32, y (N,) f32; sums in f32 whatever x's type.
// It is the FedAdp global update (paper Eqs. 4 and 11), run twice per
// round: once with the FedAvg weights (the global delta g) and once with
// the FedAdp weights.
//
// Replaces the Pallas kernel repro/kernels/weighted_agg.py::weighted_agg
// (_agg_kernel). That kernel walks a sequential TPU grid and revisits each
// output block as an accumulator across client chunks. Blocks here run in
// no order, so nothing is carried between them: every thread owns kCols
// consecutive columns, loops over all K rows with its sums in registers,
// and writes its columns of y once.
//
// What bounds it on Hopper: bytes. It reads K*N*sizeof(x) bytes of x,
// writes N*4 bytes of y and does 2 flops per element read (0.5 flop/byte
// of f32 against a ridge of about 20 flop/byte for f32 outside the tensor
// cores), so the design's only job is to stream x at the memory rate: the
// widest loads the row stride allows (16, 8 or 4 bytes of f32; 8, 4 or 2
// bytes of bf16), neighbouring threads on neighbouring addresses, the
// loop over clients unrolled so several rows' loads are in flight, the
// weights staged once per block in shared memory. No client tiling, no
// atomics and no padded copy of x: the ragged column edge is masked here.
// A bf16 row of the main path (N = 1,663,370) is 3,326,740 bytes, 4 mod
// 16, so bf16 x streams with 4-byte loads there.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "load.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // consecutive columns owned by one thread (load4)
constexpr int kTile = kThreads * kCols;
constexpr size_t kDefaultSmem = 48 * 1024;

// y is f32: stores VW floats wide (y + col is aligned to VW * 4 bytes).
template <int VW>
__device__ __forceinline__ void store_cols(float* __restrict__ p,
                                           const float (&v)[kCols]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VW == 2) {
    reinterpret_cast<float2*>(p)[0] = make_float2(v[0], v[1]);
    reinterpret_cast<float2*>(p)[1] = make_float2(v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) p[i] = v[i];
  }
}

template <int VW, typename T>
__global__ void __launch_bounds__(kThreads)
agg_kernel(const float* __restrict__ w, const T* __restrict__ x,
           float* __restrict__ y, int K, long long N) {
  extern __shared__ float ws[];
  for (int k = threadIdx.x; k < K; k += kThreads) ws[k] = w[k];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  if (col >= N) return;
  float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
  if (col + kCols <= N) {
    const T* p = x + col;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float v[kCols];
      repro::load4<VW>(p + static_cast<long long>(k) * N, v);
      const float wk = ws[k];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(wk, v[i], acc[i]);
    }
    store_cols<VW>(y + col, acc);
  } else {  // ragged edge: fewer than kCols columns left
    // (guarded unrolled loops keep acc in registers: no dynamic indexing)
    const int n = static_cast<int>(N - col);
    for (int k = 0; k < K; ++k) {
      const T* p = x + static_cast<long long>(k) * N + col;
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if (i < n) acc[i] = fmaf(ws[k], repro::load1(p + i), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (i < n) y[col + i] = acc[i];
  }
}

template <int VW, typename T>
cudaError_t launch(const float* w, const T* x, float* y, int K,
                   long long N, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        agg_kernel<VW, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (N + kTile - 1) / kTile;
  agg_kernel<VW, T><<<static_cast<unsigned>(blocks), kThreads, smem,
                      stream>>>(w, x, y, K, N);
  return cudaGetLastError();
}

// Picks the widest load (in elements) that every row of x and y allows.
template <typename T>
int dispatch(const float* w, const T* x, float* y, int K, long long N,
             cudaStream_t stream) {
  if (K < 1 || N < 1 || (N + kTile - 1) / kTile > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  cudaError_t e;
  if (N % 4 == 0 && xa % (4 * sizeof(T)) == 0 && ya % 16 == 0)
    e = launch<4>(w, x, y, K, N, stream);
  else if (N % 2 == 0 && xa % (2 * sizeof(T)) == 0 && ya % 8 == 0)
    e = launch<2>(w, x, y, K, N, stream);
  else
    e = launch<1>(w, x, y, K, N, stream);
  return static_cast<int>(e);
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. Never synchronises.
extern "C" int repro_weighted_agg_f32(const float* w, const float* x,
                                      float* y, int K, long long N,
                                      cudaStream_t stream) {
  return dispatch(w, x, y, K, N, stream);
}

// The same with x in bf16 (its raw 16-bit patterns).
extern "C" int repro_weighted_agg_bf16(const float* w, const void* x,
                                       float* y, int K, long long N,
                                       cudaStream_t stream) {
  return dispatch(w, static_cast<const uint16_t*>(x), y, K, N, stream);
}
