// Flash-attention forward for bf16 q, k, v on Hopper's tensor cores:
// o = softmax(q k^T * scale [causal mask]) v per (batch, head), with an
// online softmax so that the (T, T) scores never leave the chip. Included
// by flash_attn.cu, whose repro_flash_attn sends bf16 inputs here (f32
// inputs go to flash_tf32_kernel there). Layout as there:
// q, k, v, o are (B, T, heads, D) given by strides, q with H heads and
// k/v with G, query head h reading KV head h / (H / G) in place.
//
// Replaces the Pallas kernel repro/kernels/flash_attn.py::flash_attention
// (_kernel via _flash_fwd_impl) and gqa_flash's jnp.repeat, for bf16.
// Numerics kept from _kernel: masked score = NEG_INF = -1e30 (not -inf),
// the running max m and sum l rescaled by exp(m - m_new), l summed from
// the f32 probabilities, output acc / max(l, 1e-30) in bf16. Where it
// departs:
//   * the scale multiplies the f32 scores after the product, not q before
//     it (q * scale would be rounded to bf16 to feed the tensor cores);
//   * exp is exp2f with scale * log2(e) folded into that multiply (m, and
//     the masked -1e30, live in the log2 domain);
//   * the probabilities are rounded to bf16 to feed the P V product (the
//     tensor cores take bf16 operands); l is summed before that rounding.
// All three stay far inside the reference test's bf16 allowance (3e-2).
//
// What bounds it on Hopper: operations. At gemma-2b's prefill (B = 4,
// T = 1024, H = 8, G = 1, D = 256, causal) it does 17.2 GFLOP for 37.7 MB
// of input and output, ~450 flop per byte against the bf16 ridge of ~295,
// so the bound is the tensor cores' 989 TFLOP/s: 17.4 us.
//
// Design. One CTA of two warpgroups (8 warps) per (batch x head, 128
// query rows); warpgroup w owns rows [64 w, 64 w + 64), each warp 16 of
// them. Both products are wgmma (bf16 operands, f32 accumulators in
// registers):
//   S = Q K^T: m64n64k16, Q and K read from shared memory (K-major), 16
//     steps over D = 256;
//   softmax: each thread holds 2 rows x 16 keys of S (the accumulator
//     layout, that of mma.sync's C per warp); the row max is a max over
//     the thread's values, then two shuffles across the quad that shares
//     the rows; the row sum stays per thread until the end (every thread
//     of a quad rescales by the same factor), then one quad reduction;
//   O += P V: m64n{D}k16 with P's A fragments in registers, packed to bf16
//     straight from the S accumulators (the C layout of two n8 tiles is
//     the A layout of one k16 step), V read from shared memory MN-major.
// The O accumulator stays in registers: D / 2 f32 per thread (128 at
// D = 256); 199 registers a thread at D = 256, no spills (ptxas).
// Tiles arrive by TMA (one thread issues them) in 64-key tiles of K and V
// through a ring of two stages, with an mbarrier per stage for "full"
// (the bytes landed) and one for "empty" (every warp is done with the
// tile); the warpgroups wait only on those, not on each other, so one's
// softmax can run beside the other's products. Shared memory holds each
// tile as D / 64 blocks of (rows x 128 bytes) with the 128-byte swizzle
// (16-byte chunk c of row r at c ^ (r % 8)), which the TMA writes and
// wgmma reads; rows past T arrive as zeros. The causal and ragged-T mask
// is applied only to tiles that cross the diagonal or T; key tiles wholly
// above the diagonal are skipped. Query tiles are issued heaviest first.
// The output goes through the warp's own rows of the Q tile so that it
// leaves in 16-byte stores. Shared memory: 64 KiB of Q and 2 x (32 + 32)
// KiB of K and V at D = 256, one CTA per SM.
//
// Measured at gemma-2b's prefill on an H100 80GB HBM3 at 700 W: 56.3 us
// (chip_smoke.py), against SDPA's 57.2 us. chip_ab.py, in turns within one
// call (medians of 10), put this kernel at 56.5-56.7 us against: the
// CUDA-core kernel it replaced for bf16, 831.4-831.7 us; mma.sync with
// ldmatrix and a cp.async ring (4 warps, 64 query rows), 85.6 us with
// 32-key tiles (2 CTAs per SM) and 140.0 us with 64-key tiles (spills, 1
// CTA per SM); wgmma fed by cp.async with a CTA barrier per tile, 67.2 us.
// Issuing tile j's S beside tile j - 1's P V (FA3's intra-warpgroup
// overlap) took 55.5 us, 2% less, for 42 more registers and was not kept;
// passing the turn to issue products between the warpgroups by named
// barriers (FA3's ping-pong) took 59.7 us.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_mma {

constexpr int kBc = 64;      // keys per K/V tile
constexpr int kStages = 2;   // K/V tiles in flight
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Config {
  static constexpr int kGroups = 2;  // warpgroups per CTA
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBr = 64 * kGroups;       // query rows per CTA
  static constexpr int kChunks = D / 8;          // 16-byte chunks per row
  static constexpr int kTileBytes = kBc * D * 2;
  static constexpr int q = 0;  // byte offsets from the 1024-aligned base
  static constexpr int k = q + kBr * D * 2;
  static constexpr int v = k + kStages * kTileBytes;
  static constexpr int bar = v + kStages * kTileBytes;  // 5 mbarriers
  static constexpr size_t bytes = bar + 64 + 1024;
};

struct Strides {  // in elements: batch, head, time; one set per tensor
  long long sb, sh, st;
};

// Byte offset of 16-byte chunk c of row r in a tile of ROWS rows, stored
// as D / 64 blocks of (ROWS x 128 bytes), each with the 128-byte swizzle
// (chunk c % 8 of row r at (c % 8) ^ (r % 8)): wgmma's canonical layout.
template <int ROWS>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(((c >> 3) * ROWS + r) * 128 +
                               (((c & 7) ^ (r & 7)) << 4));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity) : "memory");
}
// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar) : "memory");
}
// The D / 64 column blocks of rows [r0, r0 + ROWS) of head `head`, batch
// b into the tile at dst (sw128 layout: the map's 128-byte swizzle).
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int r0, int head, int b,
                                         uint32_t bar) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load(dst + c * ROWS * 128, map, c * 64, r0, head, b, bar);
}

// keeps the compiler from touching accumulators that a wgmma in flight
// owns
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// S(64 x 64) += A B: A and B both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// O(64 x 64) += A B: A (bf16 fragments) in registers, B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O(64 x 128) += A B: A (bf16 fragments) in registers, B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O(64 x 256) += A B: A (bf16 fragments) in registers, B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Two f32 as bf16x2, round to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(Config<D>::kThreads, 1)
flash_mma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 uint16_t* __restrict__ o, Strides os, int H, int G, int T_,
                 float scale_log2, int causal) {
  using C = Config<D>;
  constexpr int kThreads = C::kThreads;
  constexpr int kNT = D / 8;     // n8 tiles of the output row
  constexpr int kST = kBc / 8;   // n8 tiles of a score row
  extern __shared__ uint4 smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  char* sbase = reinterpret_cast<char*>(smem) + (sQ - raw);
  const uint32_t sK = sQ + C::k, sV = sQ + C::v;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBr;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;  // mma C layout: row, col pair
  const int wrow = warp * 16;                 // the warp's first row
  const int wg = warp / 4;                    // its warpgroup

  uint16_t* ob = o + b * os.sb + h * os.sh;

  const int q_end = min(q0 + C::kBr, T_);  // one past the tile's last row
  const int k_end = causal ? q_end : T_;
  const int ntiles = (k_end + kBc - 1) / kBc;

  // mbarriers: full[s] (the tile's bytes arrived), empty[s] (all 8 warps
  // are done with it), and Q's
  const uint32_t bars = sQ + C::bar;
  const uint32_t qbar = bars + 32;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 16 + 8 * st; };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kThreads / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  constexpr int kKV = 2 * C::kTileBytes;  // bytes of one K and one V tile
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, C::kBr * D * 2);
    tma_tile<D, C::kBr>(sQ, &tq, q0, h, b, qbar);
    mbar_expect_tx(full(0), kKV);
    tma_tile<D, kBc>(sK, &tk, 0, g, b, full(0));
    tma_tile<D, kBc>(sV, &tv, 0, g, b, full(0));
  }

  const uint32_t q_wg = sQ + wg * 64 * 128;  // the warpgroup's 64 rows
  // V is MN-major (d contiguous): LBO steps 64 columns, SBO 8 keys
  constexpr uint32_t kVLbo = kBc * 128, kVSbo = 1024;

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows gid, gid + 8

  for (int j = 0; j < ntiles; ++j) {
    const int stage = j % kStages;
    if (threadIdx.x == 0 && j + 1 < ntiles) {
      // refill the other stage with tile j + 1 once every warp is done
      // with tile j - 1
      const int nxt = (j + 1) % kStages;
      if (j + 1 >= kStages) mbar_wait(empty(nxt), ((j + 1) / kStages - 1) & 1);
      mbar_expect_tx(full(nxt), kKV);
      tma_tile<D, kBc>(sK + nxt * C::kTileBytes, &tk, (j + 1) * kBc, g, b,
                       full(nxt));
      tma_tile<D, kBc>(sV + nxt * C::kTileBytes, &tv, (j + 1) * kBc, g, b,
                       full(nxt));
    }
    if (j == 0) mbar_wait(qbar, 0);
    mbar_wait(full(stage), (j / kStages) & 1);

    // S = Q K^T for the warpgroup's 64 rows and the tile's kBc keys
    const uint32_t kt = sK + stage * C::kTileBytes;
    float s[kST][4];
#pragma unroll
    for (int n = 0; n < kST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_ss(s,
               make_desc(q_wg + (kd / 4) * (C::kBr * 128) + (kd % 4) * 32,
                         16, 1024),
               make_desc(kt + (kd / 4) * (kBc * 128) + (kd % 4) * 32, 16,
                         1024));
    wgmma_commit();
    fence_regs(s);
    wgmma_wait_all();
    fence_regs(s);

    // online softmax in the log2 domain; masked scores -1e30
    const int k0 = j * kBc;
    const bool masked =
        k0 + kBc > T_ || (causal && k0 + kBc - 1 > q0 + wrow);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int kpos = k0 + n * 8 + tig * 2 + (e & 1);
          const int qpos = q0 + wrow + gid + (e >> 1) * 8;
          if (kpos >= T_ || (causal && kpos > qpos)) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < kST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rsum[r];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: P's A fragment of keys [16 kc, 16 kc + 16) is the C
    // fragment of score tiles 2 kc and 2 kc + 1, rounded to bf16
    uint32_t pf[kBc / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBc / 16; ++kc) {
      pf[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pf[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pf[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pf[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
    const uint32_t vt = sV + stage * C::kTileBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBc / 16; ++kc)
      wgmma_rs(acc, pf[kc], make_desc(vt + kc * 16 * 128, kVLbo, kVSbo));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(stage));
  }

  // o = acc / max(l, 1e-30), through the warp's own 16 rows of the Q tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n) {  // n8 tile n is 16-byte chunk n
    *reinterpret_cast<uint32_t*>(sbase + C::q + sw128<C::kBr>(wrow + gid, n) +
                                 tig * 4) =
        pack_bf16(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(sbase + C::q +
                                 sw128<C::kBr>(wrow + gid + 8, n) + tig * 4) =
        pack_bf16(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * C::kChunks / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = idx / C::kChunks, c = idx % C::kChunks;
    const int qpos = q0 + wrow + r;
    if (qpos < T_)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(qpos) * os.st +
                                c * 8) =
          *reinterpret_cast<const uint4*>(sbase + C::q +
                                          sw128<C::kBr>(wrow + r, c));
  }
}

using EncodeFn = PFN_cuTensorMapEncodeTiled_v12000;

inline EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A 4-D TMA map (D, T, heads, B) of a bf16 array with element strides st
// (batch, head, time): boxes of 64 columns x `rows` rows, 128-byte swizzle
// (sw128's layout); rows past T read as zeros. False when the driver's
// encoder is missing or refuses the array.
inline bool make_map(CUtensorMap* map, const void* base, const long long* st,
                     int D, int T_, int heads, int B, int rows) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  // a dim of size 1 is never stepped: give it a valid stride whatever
  // the tensor's stride there is (torch's may be 0)
  auto bytes = [&](long long stride, int size) {
    return static_cast<cuuint64_t>(size > 1 ? stride * 2 : D * 2);
  };
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(T_),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {bytes(st[2], T_), bytes(st[1], heads),
                           bytes(st[0], B)};
  cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int H, int G, int T_,
                   float scale, int causal, cudaStream_t stream) {
  using C = Config<D>;
  auto kernel = flash_mma_kernel<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, st, D, T_, H, B, C::kBr) ||
      !make_map(&tk, k, st + 3, D, T_, G, B, kBc) ||
      !make_map(&tv, v, st + 6, D, T_, G, B, kBc))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::bytes));
  if (e != cudaSuccess) return e;
  const Strides os{st[9], st[10], st[11]};
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((T_ + C::kBr - 1) / C::kBr));
  kernel<<<grid, C::kThreads, C::bytes, stream>>>(tq, tk, tv,
                                                 static_cast<uint16_t*>(o),
                                                 os, H, G, T_,
                                                 scale * kLog2e, causal);
  return cudaGetLastError();
}

// The bf16 forward at head dim D (64, 128 or 256), arguments as
// repro_flash_attn's; cudaErrorInvalidValue for another D.
inline cudaError_t dispatch(const void* q, const void* k, const void* v,
                            void* o, const long long* st, int B, int H,
                            int G, int T_, int D, float scale, int causal,
                            cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, st, B, H, G, T_, scale, causal, stream);
    case 128:
      return launch<128>(q, k, v, o, st, B, H, G, T_, scale, causal, stream);
    case 256:
      return launch<256>(q, k, v, o, st, B, H, G, T_, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash_mma
