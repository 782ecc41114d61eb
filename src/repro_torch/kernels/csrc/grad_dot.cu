// Gradient statistics (<a, b>, ||a||^2, ||b||^2) of two equally shaped
// arrays, read as flat contiguous vectors of n elements, f32 or bf16
// (both the same type). Sums are f32 whatever the inputs' type.
//
// Replaces the Pallas kernel repro/kernels/grad_dot.py::grad_dot_stats
// (_kernel), which views the inputs as (M, 128) zero-padded rows and adds
// each 512 x 128 block into three (1, 1) accumulators along a sequential
// TPU grid. Here there is no padded copy, and a grid of blocks in place
// of the sequential grid:
//
// * Every block owns a fixed span of kSpan consecutive elements (the
//   split depends on n alone). Each thread keeps the three sums of its
//   elements in registers; the block reduces them (warp shuffles, then
//   shared memory in a fixed order).
// * One block (n <= kSpan, most leaves of the paper's CNN): that block
//   writes the three sums, and the call is one launch.
// * More blocks: each writes its three partials statistic-major (one
//   contiguous run a statistic), and stats_sum_kernel (stats_reduce.cuh)
//   adds them in a fixed order, started as a programmatic dependent
//   launch. No atomics, so the result is the same from run to run.
//
// What bounds it on Hopper: bytes. One read of a and of b (8 bytes per
// element pair in f32), 6 flops per pair: far below the f32 ridge. Every
// load is an aligned 16-byte word, for a and b each whatever its offset:
// an input that starts r = 4, 8 or 12 bytes into a word (bf16: any even
// r) is read as wire.cuh reads the wire, each lane taking its right
// neighbour's word by shuffles and realigning the pair (realign16). Lane
// l of warp w owns words 32 S w + 32 s + l (step s < S) of its block; the
// neighbour of step s's lane 31 is step s + 1's lane 0, in the same warp,
// and after the last step lane 31 loads one more word itself. Client k's
// row of the round's (K, N) f32 buffer starts 8k mod 16 bytes in, so an
// odd client's leaves stream as wide as an even client's. Whether an
// input is shifted is a template argument: an aligned input pays nothing
// for the realignment.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "load.cuh"
#include "stats_reduce.cuh"
#include "wire.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// elements of a block: 813 blocks over the CNN's 1,663,370 params, one
// wave. 2,048 took 13.06 us there against 13.78 with 8,192 (chip_ab.py,
// both builds in one process, H100 80GB HBM3 at 700 W)
constexpr long long kSpan = 2048;

template <typename T>
constexpr int kPer = 16 / sizeof(T);  // elements of a 16-byte word
template <typename T>
constexpr int kSteps = kSpan / kPer<T> / kThreads;  // words a lane: 2 / 1

struct Args {
  const int8_t* a;  // (n,) f32 or bf16
  const int8_t* b;
  float* part;  // (3, blocks) block partials; unused with one block
  float* out;   // (3,)
  long long n;
  long long blocks;
};

// One input as a block sees it: the aligned word that holds the block's
// first element, that element's byte offset in it, and the input's bytes
// from that element on.
struct View {
  const uint4* base;
  unsigned int r;
  long long bytes;
};

template <typename T>
__device__ __forceinline__ View view_of(const int8_t* p, long long first,
                                        long long n) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p) +
                       static_cast<uintptr_t>(first) * sizeof(T);
  return View{reinterpret_cast<const uint4*>(at & ~uintptr_t{15}),
              static_cast<unsigned int>(at & 15),
              (n - first) * static_cast<long long>(sizeof(T))};
}

// Word i of the block's span, zero when it holds no byte of the input.
__device__ __forceinline__ uint4 word(const View& v, long long i) {
  return 16 * i < v.bytes + v.r ? __ldg(v.base + i)
                                : make_uint4(0u, 0u, 0u, 0u);
}

// A lane's words of one input: its own word of each step and, shifted,
// lane 31's one more word after the last step (the next warp's first).
template <int S, bool SHIFT>
struct Words {
  uint4 w[S];
  uint4 extra;
};

template <int S, bool SHIFT>
__device__ __forceinline__ Words<S, SHIFT> load_words(const View& v,
                                                      int warp, int lane) {
  Words<S, SHIFT> out;
  const long long first = 32LL * S * warp;
#pragma unroll
  for (int s = 0; s < S; ++s) out.w[s] = word(v, first + 32 * s + lane);
  if (SHIFT)
    out.extra = lane == 31 ? word(v, first + 32 * S)
                           : make_uint4(0u, 0u, 0u, 0u);
  return out;
}

__device__ __forceinline__ uint4 shfl4(const uint4& v, int src) {
  return make_uint4(__shfl_sync(repro::kFullWarp, v.x, src),
                    __shfl_sync(repro::kFullWarp, v.y, src),
                    __shfl_sync(repro::kFullWarp, v.z, src),
                    __shfl_sync(repro::kFullWarp, v.w, src));
}

// The 16 input bytes of the lane's step s. Every lane of the warp calls
// it.
template <int S, bool SHIFT>
__device__ __forceinline__ uint4 step_bytes(const Words<S, SHIFT>& w,
                                            unsigned int r, int s,
                                            int lane) {
  if (!SHIFT) return w.w[s];
  // lane 0 lends step s + 1's word to lane 31; the others their own
  const uint4 lend = lane == 0 && s + 1 < S ? w.w[min(s + 1, S - 1)]
                                            : w.w[s];
  uint4 next = shfl4(lend, (lane + 1) & 31);
  if (s + 1 == S && lane == 31) next = w.extra;
  return repro::realign16(w.w[s], next, r);
}

// The word's elements as f32, zeros from element ne on.
__device__ __forceinline__ void widen(const uint4& w, int ne,
                                      float (&v)[4]) {
  const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < ne ? __uint_as_float(u[i]) : 0.f;
}

__device__ __forceinline__ void widen(const uint4& w, int ne,
                                      float (&v)[8]) {
  const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = 2 * j < ne ? repro::bf16_lo(u[j]) : 0.f;
    v[2 * j + 1] = 2 * j + 1 < ne ? repro::bf16_hi(u[j]) : 0.f;
  }
}

// T: float or uint16_t (bf16's raw bits). SA / SB: a / b not 16-byte
// aligned.
template <typename T, bool SA, bool SB>
__global__ void __launch_bounds__(kThreads) gdot_kernel(Args args) {
  // stats_sum_kernel may launch now: it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;");
  constexpr int S = kSteps<T>, P = kPer<T>;
  __shared__ float red[kWarps][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const long long first = static_cast<long long>(blockIdx.x) * kSpan;
  const View va = view_of<T>(args.a, first, args.n);
  const View vb = view_of<T>(args.b, first, args.n);
  const Words<S, SA> wa = load_words<S, SA>(va, warp, lane);
  const Words<S, SB> wb = load_words<S, SB>(vb, warp, lane);
  float dot = 0.f, sa = 0.f, sb = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long long e = first + (32LL * S * warp + 32 * s + lane) * P;
    const int ne = static_cast<int>(
        max(0LL, min(static_cast<long long>(P), args.n - e)));
    float av[P], bv[P];
    widen(step_bytes(wa, va.r, s, lane), ne, av);
    widen(step_bytes(wb, vb.r, s, lane), ne, bv);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      dot = fmaf(av[i], bv[i], dot);
      sa = fmaf(av[i], av[i], sa);
      sb = fmaf(bv[i], bv[i], sb);
    }
  }
  dot = repro::warp_sum(dot);
  sa = repro::warp_sum(sa);
  sb = repro::warp_sum(sb);
  if (lane == 0) {
    red[warp][0] = dot;
    red[warp][1] = sa;
    red[warp][2] = sb;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    if (args.blocks == 1)
      args.out[threadIdx.x] = s;
    else
      args.part[threadIdx.x * args.blocks + blockIdx.x] = s;
  }
}

template <typename T, bool SA, bool SB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  gdot_kernel<T, SA, SB>
      <<<static_cast<unsigned>(a.blocks), kThreads, 0, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.blocks == 1) return e;
  return repro::launch_stats_sum(a.part, a.out, 3, a.blocks, stream);
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  const bool sa = reinterpret_cast<uintptr_t>(a.a) % 16 != 0;
  const bool sb = reinterpret_cast<uintptr_t>(a.b) % 16 != 0;
  if (sa && sb) return launch<T, true, true>(a, stream);
  if (sa) return launch<T, true, false>(a, stream);
  if (sb) return launch<T, false, true>(a, stream);
  return launch<T, false, false>(a, stream);
}

}  // namespace

// Blocks for n elements; with more than one, the caller sizes the
// partials buffer as blocks * 3 floats (with one, part may be NULL).
extern "C" long long repro_grad_dot_blocks(long long n) {
  return (n + kSpan - 1) / kSpan;
}

// a, b (n,) contiguous, part as above, out (3,) = [<a,b>, ||a||^2,
// ||b||^2]. bf16 != 0: a and b are bf16 (raw 16-bit words), else f32.
// Returns a cudaError_t: 0 when every launch was accepted. Never
// synchronises.
extern "C" int repro_grad_dot(const void* a, const void* b, float* part,
                              float* out, long long n, int bf16,
                              long long nblocks, cudaStream_t stream) {
  const Args args{static_cast<const int8_t*>(a),
                  static_cast<const int8_t*>(b), part, out, n, nblocks};
  const uintptr_t elem = bf16 ? 2 : 4;
  if (n < 1 || nblocks != (n + kSpan - 1) / kSpan || nblocks > INT_MAX ||
      (nblocks > 1 && part == nullptr) ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
              elem != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bf16 ? dispatch<uint16_t>(args, stream)
                               : dispatch<float>(args, stream));
}
