// Weighted aggregation over the round's flat client-delta buffer:
//   y[n] = sum_k w[k] * x[k, n],  x (K, N) f32 row-major, w (K,), y (N,).
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
// What bounds it on Hopper: bytes. It reads K*N*4 bytes of x, writes N*4
// bytes of y and does 2 flops per element read (0.5 flop/byte against a
// ridge of about 20 flop/byte for f32 outside the tensor cores), so the
// design's only job is to stream x at the memory rate: 16-byte loads
// where the row stride allows them (8-byte or 4-byte loads otherwise),
// neighbouring threads on neighbouring addresses, the loop over clients
// unrolled so several rows' loads are in flight, the weights staged once
// per block in shared memory. No client tiling, no atomics and no padded
// copy of x: the ragged column edge is masked here.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // consecutive columns owned by one thread
constexpr int kTile = kThreads * kCols;
constexpr size_t kDefaultSmem = 48 * 1024;

// kCols consecutive floats from p with loads VW floats wide; p is aligned
// to VW * 4 bytes (the launcher picks VW so that it is).
template <int VW>
__device__ __forceinline__ void load_cols(const float* __restrict__ p,
                                          float (&v)[kCols]) {
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
}

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

template <int VW>
__global__ void __launch_bounds__(kThreads)
agg_kernel(const float* __restrict__ w, const float* __restrict__ x,
           float* __restrict__ y, int K, long long N) {
  extern __shared__ float ws[];
  for (int k = threadIdx.x; k < K; k += kThreads) ws[k] = w[k];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  if (col >= N) return;
  float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
  if (col + kCols <= N) {
    const float* p = x + col;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float v[kCols];
      load_cols<VW>(p + static_cast<long long>(k) * N, v);
      const float wk = ws[k];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(wk, v[i], acc[i]);
    }
    store_cols<VW>(y + col, acc);
  } else {  // ragged edge: fewer than kCols columns left
    // (guarded unrolled loops keep acc in registers: no dynamic indexing)
    const int n = static_cast<int>(N - col);
    for (int k = 0; k < K; ++k) {
      const float* p = x + static_cast<long long>(k) * N + col;
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if (i < n) acc[i] = fmaf(ws[k], __ldg(p + i), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (i < n) y[col + i] = acc[i];
  }
}

template <int VW>
cudaError_t launch(const float* w, const float* x, float* y, int K,
                   long long N, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        agg_kernel<VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (N + kTile - 1) / kTile;
  agg_kernel<VW><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      w, x, y, K, N);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. Never synchronises.
extern "C" int repro_weighted_agg_f32(const float* w, const float* x,
                                      float* y, int K, long long N,
                                      cudaStream_t stream) {
  if (K < 1 || N < 1 || (N + kTile - 1) / kTile > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y);
  cudaError_t e;
  if (N % 4 == 0 && addr % 16 == 0)
    e = launch<4>(w, x, y, K, N, stream);
  else if (N % 2 == 0 && addr % 8 == 0)
    e = launch<2>(w, x, y, K, N, stream);
  else
    e = launch<1>(w, x, y, K, N, stream);
  return static_cast<int>(e);
}
