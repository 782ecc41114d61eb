// Flash-attention forward: o = softmax(q k^T * scale [causal mask]) v per
// (batch, head), computed with an online softmax so that the (T, T)
// scores never leave the chip. q, k, v and o are (B, T, heads, D) or
// (BH, T, D) arrays given by strides; q has H heads and k/v G heads,
// query head h reading KV head h / (H / G) (grouped-query attention
// without a repeated copy of k and v). bf16 inputs go to the tensor-core
// kernel of flash_mma.cuh (its design is in that header); f32 inputs to
// flash_tf32_kernel below, whose two products run on the tensor cores as
// error-compensated "3xTF32" (the f32 path's tolerance, 2e-5 against the
// reference, rules out one-pass TF32, not this).
//
// Replaces the Pallas kernel repro/kernels/flash_attn.py::flash_attention
// (_kernel, via _flash_fwd_impl) and the jnp.repeat of gqa_flash. The f32
// kernel computes what _kernel computes: q scaled in f32 before the
// product, masked scores set to NEG_INF = -1e30 (not -inf), the running
// max m and sum l rescaled by exp(m - m_new), and the output divided by
// max(l, 1e-30). Its tiles are its own; key tiles that lie wholly above
// the causal diagonal are skipped (in the reference they contribute
// exactly 0 to l and acc), and so are the key tiles that lie wholly above
// one warp's 16 rows.
//
// 3xTF32. A TF32 operand keeps 10 of f32's 23 mantissa bits, so one pass
// misses 2e-5 by 16-46x (tests/test_torch_flash.py emulates both). Every f32 operand x is split into two TF32
// parts, hi = x truncated to TF32 and lo = x - hi, and each product a b
// is accumulated in f32 as lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b,
// ~2^-20 of the product, is dropped), the small terms first, as CUTLASS's
// FastF32 (which also truncates hi). The tensor core reads the top 19
// bits of a TF32 operand, so lo enters as the f32 bits of x - hi and is
// truncated there: hi + trunc(lo) holds x to 2^-20, at two instructions
// a split (cvt.rna.tf32.f32 compiles to several). The probabilities P are
// split too. The exponentials are exp2f with log2(e) folded into one FMA.
//
// Design. One CTA per (batch x head, 96 query rows at D = 256, 64 below):
// row groups of 16 rows, each held by one warp, or at D = 256 by two,
// each with half of the output columns and half of S's sum over the head
// dim (the two halves of S are added through shared memory in one order,
// so that both warps hold the same S). Both products are
// mma.sync.m16n8k8 (tf32 operands, f32 accumulators):
//   S = Q K^T over 32-key tiles: Q's A fragment and K's B fragments come
//     by ldmatrix (an 8 x 8 b16 matrix is an 8 x 4 f32 one: lane 4 g + t
//     gets row g, column t, which is A's and B's fragment layout);
//   softmax: a thread holds rows g and g + 8 (g = lane / 4) of the tile's
//     keys 8 n + 2 t, 8 n + 2 t + 1 (t = lane % 4, n8 tile n); the row
//     max is the thread's max and two quad shuffles; l stays a per-thread
//     partial sum until the end;
//   O += P V: the S accumulator of n8 tile n is P's A fragment of k-step
//     n once the k index is permuted (A column t <-> key 2 t, column
//     t + 4 <-> key 2 t + 1), so P never leaves the registers; V's B
//     fragment is then read at keys 2 t and 2 t + 1.
// Shared memory rows are D + 4 floats apart, so every fragment read is
// free of bank conflicts: ldmatrix's eight 16-byte rows of one matrix
// fall on banks 4 r .. 4 r + 3, and V's b0 / b1 reads on bank
// 8 t + g (+ 4). Q is staged once and scaled in place. K and V tiles
// arrive by 16-byte cp.async in a ring of three one-tile buffers: phase
// 2 j computes tile j's S from K_j, phase 2 j + 1 its P V from V_j, and
// each phase's tile is loaded two phases ahead; rows past T arrive as
// zeros. The O accumulator stays in registers: 64 f32 per thread at every
// D. Shared memory: (rows + 3 x 32) (D + 4) floats (+ 24 KiB of S halves
// at D = 256): 219 KiB at D = 256 (one CTA of 12 warps per SM, 168
// registers), 82.5 KiB at 128 (two CTAs of 4 warps), 42.5 KiB at 64
// (three). Query tiles are scheduled heaviest first (the last tiles of a
// causal row see the most keys).
//
// What bounds it on Hopper: operations. At gemma-2b's prefill shape
// (B = 4, H = 8, T = 1024, D = 256, causal) attention does 17.2 GFLOP
// for 75 MB of f32 input and output; as 3xTF32 that is 51.5 GFLOP on the
// tensor cores, 104 us at TF32's 495 TFLOP/s, against 256 us for f32 on
// the CUDA cores (67 TFLOP/s). mma.sync reaches only part of that rate:
// dropping the two small products (one pass, too coarse) takes 37% off
// the time. Every split (two instructions) is repeated by each warp that
// reads the operand: dropping the Q and K splits takes 9% off, the V
// split 5%.
//
// Measured at gemma-2b's prefill (chip_smoke.py and chip_ab.py, H100
// 80GB HBM3 at 700 W): about 0.6 of SDPA's f32 time (PyTorch's
// memory-efficient kernel, itself 3xTF32 on mma.sync) and 0.45 of the
// CUDA-core kernel this one replaced; the designs tried are in PERF.md.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

constexpr int kBK = 32;  // keys per K/V tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {  // warps and shared-memory regions (in floats)
  static constexpr int kGroups = D == 256 ? 6 : 4;  // row groups of 16
  static constexpr int kBQ = 16 * kGroups;          // query rows per CTA
  // warps that share a row group, each with D / kSplit of its output
  // columns (and that part of S's sum over the head dim)
  static constexpr int kSplit = D == 256 ? 2 : 1;
  static constexpr int kWarps = kGroups * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCols = D / kSplit;
  static constexpr int kStride = D + 4;  // padded row
  static constexpr int kTile = kBK * kStride;
  static constexpr int q = 0;
  static constexpr int kv = q + kBQ * kStride;  // three K or V tiles
  static constexpr int x = kv + 3 * kTile;      // S partials, one per warp
  static constexpr int floats = x + (kSplit > 1 ? kWarps * 16 * kBK : 0);
  static constexpr size_t bytes = floats * sizeof(float);
  // CTAs per SM that the shared memory allows (the register cap follows)
  static constexpr int kMinBlocks = D == 256 ? 1 : D == 128 ? 2 : 3;
};

struct Strides {  // in elements: batch, head, time; one set per tensor
  long long sb, sh, st;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared memory at dst; zeros when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all of this thread's cp.async groups but the newest have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of a (T, D) slab with row stride st into shared
// memory at dst (row stride D + 4 floats), by cp.async; rows at or past T
// are zeros. Every thread of the CTA takes part; the caller commits.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const float* __restrict__ src,
                                          long long st, int r0, int T_) {
  constexpr int kThreads = Layout<D>::kThreads;
  constexpr int kPerRow = D / 4;  // 16-byte chunks
#pragma unroll
  for (int it = 0; it < (ROWS * kPerRow + kThreads - 1) / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    if (ROWS * kPerRow % kThreads && idx >= ROWS * kPerRow) break;
    const int r = idx / kPerRow, c = idx % kPerRow;
    const bool valid = r0 + r < T_;
    cp_async16(dst + (r * (D + 4) + c * 4) * 4,
               src + static_cast<long long>(valid ? r0 + r : 0) * st + c * 4,
               valid);
  }
}

// The chunks of the Q tile that this thread copied (load_tile), times
// scale, in place once they have landed.
template <int D>
__device__ __forceinline__ void scale_q(float* sq, float scale) {
  constexpr int kThreads = Layout<D>::kThreads;
  constexpr int kRows = Layout<D>::kBQ;
  constexpr int kPerRow = D / 4;
#pragma unroll
  for (int it = 0; it < (kRows * kPerRow + kThreads - 1) / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    if (kRows * kPerRow % kThreads && idx >= kRows * kPerRow) break;
    const int r = idx / kPerRow, c = idx % kPerRow;
    float4* p = reinterpret_cast<float4*>(sq + r * (D + 4) + c * 4);
    float4 x = *p;
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *p = x;
  }
}

// Four 8 x 4 f32 matrices (as 8 x 8 b16): lane L gives the address of
// row L % 8 of matrix L / 8; r[i] of lane 4 g + t is row g, column t of
// matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// x = hi + lo as two TF32 operands: hi is x with its low 13 bits cleared
// (truncated to TF32), lo = x - hi (exact in f32) goes to the tensor core
// as it is, and the tensor core reads the top 19 bits of a TF32 operand,
// so lo is truncated there. hi + trunc(lo) holds x to 2^-20.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two small terms, then hi hi.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, Layout<D>::kMinBlocks)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  Strides qs, Strides ks, Strides vs, Strides os, int H,
                  int G, int T_, float scale, int causal) {
  using L = Layout<D>;
  constexpr int kNT = L::kCols / 8;  // the warp's n8 tiles of an output
                                     // row, and its k-steps of S
  constexpr int kST = kBK / 8;  // n8 tiles of a score row; k-steps of P V
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const uint32_t sQ = smem_addr(smem + L::q);
  const uint32_t sKV = smem_addr(smem + L::kv);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kBQ;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row, column
  const int rg = warp / L::kSplit;     // row group
  const int part = warp % L::kSplit;   // column part
  const int wrow = rg * 16;            // the warp's first row
  const int col0 = part * L::kCols;    // ... and first column

  const float* qb = q + b * qs.sb + h * qs.sh;
  const float* kb = k + b * ks.sb + g * ks.sh;
  const float* vb = v + b * vs.sb + g * vs.sh;
  float* ob = o + b * os.sb + h * os.sh;

  const int q_end = min(q0 + L::kBQ, T_);  // one past the tile's last row
  const int k_end = causal ? q_end : T_;
  const int ntiles = (k_end + kBK - 1) / kBK;

  // Phase 2 j computes tile j's S from its K, phase 2 j + 1 its P V from
  // its V; phase i's tile lives in buffer i % 3 and is loaded two phases
  // ahead, as one cp.async group (empty past the last tile).
  auto load_phase = [&](int i) {
    if (i < 2 * ntiles)
      load_tile<D, kBK>(sKV + (i % 3) * L::kTile * 4, i & 1 ? vb : kb,
                        i & 1 ? vs.st : ks.st, (i >> 1) * kBK, T_);
    cp_async_commit();
  };
  load_tile<D, L::kBQ>(sQ, qb, qs.st, q0, T_);
  load_phase(0);
  load_phase(1);

  // ldmatrix row addresses (bytes). Q's A fragment: matrices (rows +0,
  // columns +0), (+8, +0), (+0, +4), (+8, +4) of the warp's 16 rows. K's
  // B fragments of n8 tiles 2 p and 2 p + 1: (tile 2 p, columns +0),
  // (2 p, +4), (2 p + 1, +0), (2 p + 1, +4).
  const int mat = lane >> 3, mr = lane & 7;
  const uint32_t qa = sQ + ((wrow + mr + (mat & 1) * 8) * L::kStride +
                            col0 + (mat >> 1) * 4) * 4;
  const uint32_t ka =
      sKV + (((mat >> 1) * 8 + mr) * L::kStride + col0 + (mat & 1) * 4) * 4;
  // V's B fragment of k-step n, n8 tile d: keys 8 n + 2 t and 8 n + 2 t + 1,
  // column col0 + 8 d + g
  const float* va = smem + L::kv + 2 * tig * L::kStride + col0 + gid;

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows gid, gid + 8

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_prior();  // this thread's copies of K_j (and Q) landed
    if (j == 0) scale_q<D>(smem + L::q, scale);
    __syncthreads();  // everyone's have; everyone is done with V_{j-1}
    load_phase(2 * j + 2);
    const int k0 = j * kBK;
    // tiles wholly above the warp's rows, and warps wholly past T, add
    // nothing
    const bool idle = (causal && k0 > q0 + wrow + 15) || q0 + wrow >= T_;

    // S = Q K^T for the warp's 16 rows and the tile's 32 keys, over the
    // warp's part of the head dim
    float s[kST][4];
    if (!idle) {
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const uint32_t kt = ka + (2 * j % 3) * L::kTile * 4;
#pragma unroll
      for (int kd = 0; kd < kNT; ++kd) {
        uint32_t a[4], ah[4], al[4];
        ldsm_x4(qa + kd * 32, a);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
        for (int p = 0; p < kST / 2; ++p) {
          uint32_t kf[4], kh[4], kl[4];
          ldsm_x4(kt + (p * 16 * L::kStride + kd * 8) * 4, kf);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split(__uint_as_float(kf[i]), kh[i], kl[i]);
          mma3(s[2 * p], ah, al, kh[0], kh[1], kl[0], kl[1]);
          mma3(s[2 * p + 1], ah, al, kh[2], kh[3], kl[2], kl[3]);
        }
      }
      if constexpr (L::kSplit > 1) {
        // the row group's warps add their partial sums in one order, so
        // that each holds the same S
        float4* xs = reinterpret_cast<float4*>(smem + L::x) + lane;
#pragma unroll
        for (int n = 0; n < kST; ++n)
          xs[(warp * kST + n) * 32] =
              make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "r"(32 * L::kSplit)
                     : "memory");
#pragma unroll
        for (int n = 0; n < kST; ++n) {
          float4 t = xs[(rg * L::kSplit * kST + n) * 32];
#pragma unroll
          for (int w = 1; w < L::kSplit; ++w) {
            const float4 u = xs[((rg * L::kSplit + w) * kST + n) * 32];
            t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
          }
          s[n][0] = t.x; s[n][1] = t.y; s[n][2] = t.z; s[n][3] = t.w;
        }
      }

      // online softmax; masked scores -1e30
      if (k0 + kBK > T_ || (causal && k0 + kBK - 1 > q0 + wrow)) {
#pragma unroll
        for (int n = 0; n < kST; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + n * 8 + tig * 2 + (e & 1);
            const int qpos = q0 + wrow + gid + (e >> 1) * 8;
            if (kpos >= T_ || (causal && kpos > qpos)) s[n][e] = kNegInf;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      float corr[2], ml[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        ml[r] = mx[r] * kLog2e;
      }
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[n][e], kLog2e, -ml[e >> 1]));
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
    }

    cp_async_wait_prior();  // this thread's copies of V_j landed
    __syncthreads();        // everyone's have; everyone is done with K_j
    load_phase(2 * j + 3);
    if (idle) continue;

    // O += P V, k-step n over the keys of S's n8 tile n: A slot t holds
    // key 2 t (s[n][0], s[n][2]), slot t + 4 key 2 t + 1 (s[n][1], s[n][3])
    const float* vt = va + (2 * j + 1) % 3 * L::kTile;
#pragma unroll
    for (int n = 0; n < kST; ++n) {
      uint32_t ph[4], pl[4];
      split(s[n][0], ph[0], pl[0]);
      split(s[n][2], ph[1], pl[1]);
      split(s[n][1], ph[2], pl[2]);
      split(s[n][3], ph[3], pl[3]);
      const float* vr = vt + n * 8 * L::kStride;
#pragma unroll
      for (int d = 0; d < kNT; ++d) {
        uint32_t vh0, vl0, vh1, vl1;
        split(vr[d * 8], vh0, vl0);
        split(vr[L::kStride + d * 8], vh1, vl1);
        mma3(acc[d], ph, pl, vh0, vh1, vl0, vl1);
      }
    }
  }

  // o = acc / max(l, 1e-30): rows gid and gid + 8, columns 8 d + 2 t, +1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + wrow + gid + r * 8;
    if (qpos >= T_) continue;
    float* orow = ob + static_cast<long long>(qpos) * os.st + col0 + 2 * tig;
#pragma unroll
    for (int d = 0; d < kNT; ++d)
      *reinterpret_cast<float2*>(orow + d * 8) =
          make_float2(acc[d][2 * r] / l[r], acc[d][2 * r + 1] / l[r]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int H, int G, int T_,
                   float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_tf32_kernel<D>;
  constexpr size_t bytes = Layout<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((T_ + Layout<D>::kBQ - 1) /
                                        Layout<D>::kBQ));
  kernel<<<grid, Layout<D>::kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os, H,
      G, T_, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, const long long* st, int B, int H, int G,
                         int T_, int D, float scale, int causal,
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

}  // namespace

// q (B, T, H, D), k and v (B, T, G, D), o like q, all given by
// `strides` (D one of 64, 128, 256; kernels/flash_attn.py's HEAD_DIMS):
// 12 element strides (batch, head, time) for q, k, v, o; the
// last axis is contiguous and every row 16-byte aligned. bf16 != 0: the
// four arrays are bf16 (raw 16-bit words), computed by
// flash_mma::flash_mma_kernel on the tensor cores; else f32, computed by
// flash_tf32_kernel (3xTF32 on the tensor cores). H % G == 0.
// Returns a cudaError_t: 0 when the launch was accepted. Never
// synchronises.
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v,
                                void* o, const long long* strides, int B,
                                int H, int G, int T, int D, int bf16,
                                int causal, float scale,
                                cudaStream_t stream) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || T < 1 ||
      static_cast<long long>(B) * H > INT_MAX ||
      (T + 63) / 64 > 65535)  // query tiles (64 rows or more) per grid row
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      bf16 ? flash_mma::dispatch(q, k, v, o, strides, B, H, G, T, D, scale,
                                 causal, stream)
           : dispatch_f32(q, k, v, o, strides, B, H, G, T, D, scale, causal,
                          stream);
  return static_cast<int>(e);
}
