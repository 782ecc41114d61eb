// Flash-attention forward: o = softmax(q k^T * scale [causal mask]) v per
// (batch, head), computed with an online softmax so that the (T, T)
// scores never leave the chip. q, k, v and o are (B, T, heads, D) or
// (BH, T, D) arrays given by strides; q has H heads and k/v G heads,
// query head h reading KV head h / (H / G) (grouped-query attention
// without a repeated copy of k and v). Inputs f32 or bf16; all math f32;
// o in the inputs' type.
//
// Replaces the Pallas kernel repro/kernels/flash_attn.py::flash_attention
// (_kernel, via _flash_fwd_impl) and the jnp.repeat of gqa_flash. It
// computes what _kernel computes: q scaled in f32 before the product,
// masked scores set to NEG_INF = -1e30 (not -inf), the running max m and
// sum l rescaled by exp(m - m_new), and the output divided by
// max(l, 1e-30). Its tiles are its own; key tiles that lie wholly above
// the causal diagonal are skipped (in the reference they contribute
// exactly 0 to l and acc).
//
// Design (a first, simple kernel: f32 FMAs on the CUDA cores, no tensor
// cores). One CTA of 8 warps per (batch x head, 64-row query tile). The
// query tile is staged in shared memory once, scaled and widened to f32;
// then 32-key tiles of K and V are staged in turn (K rows padded by 4
// floats, so that 32 lanes reading 32 different rows with 16-byte loads
// hit distinct banks). Each warp owns 8 query rows:
//   scores: lane j computes the 8 scores of key j (q rows broadcast from
//     shared memory, k row j from shared memory);
//   softmax: the row max and sum are warp shuffles; every lane keeps m
//     and l of the warp's 8 rows;
//   P V: the probabilities go through shared memory (the warp's own 8
//     rows, so only the warp synchronises); lane owns D/32 output
//     columns of each of the 8 rows, 8 * D/32 f32 accumulators in
//     registers (64 at D = 256, the accumulator spread over the warps).
// Shared memory: (64 D + 32 (D + 4) + 32 D + 64 * 32) floats, 137 KB at
// D = 256, so one CTA per SM there (the query tile in f32 takes half).
// Query tiles are issued heaviest first (the last tiles of a causal row
// see the most keys).
//
// What bounds it on Hopper: operations. At the serving shape (B = 4,
// H = 8, T = 1024, D = 256, causal) it does 17.2 GFLOP for 37.7 MB of
// input and output: ~450 flop per byte, above the bf16 tensor-core ridge
// (~295), so the bound is the tensor cores' 989 TFLOP/s (17 us). This
// kernel uses the f32 CUDA cores (67 TFLOP/s, 256 us): it took 830 us
// there, 14x SDPA's time (chip_smoke.py, H100 80GB HBM3 at 700 W).
// 32-row query tiles with 4 warps, two CTAs per SM, took 4% longer
// (chip_ab.py). A redesign on the tensor cores (mma / wgmma, TMA) is the
// next step (ROADMAP Queue 2).

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 32;  // keys per tile: one per lane in the score loop
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;  // query rows per warp
constexpr float kNegInf = -1e30f;

template <int D>
struct Layout {  // shared-memory regions, in floats
  static constexpr int kStride = D + 4;  // padded K row
  static constexpr int q = 0;
  static constexpr int k = q + kBQ * D;
  static constexpr int v = k + kBK * kStride;
  static constexpr int p = v + kBK * D;
  static constexpr int floats = p + kBQ * kBK;
  static constexpr size_t bytes = floats * sizeof(float);
};

struct Strides {  // in elements: batch, head, time; one set per tensor
  long long sb, sh, st;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes at p, widened to f32: 4 floats or 8 bf16 (raw 16-bit words).
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load16(const uint16_t* p, float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Rows [r0, r0 + ROWS) of a (T, D) slab with row stride st, widened to
// f32 and multiplied by mul, into dst with row stride SS (floats). Rows
// at or past T are zeros. Every thread of the CTA takes part.
template <int D, int ROWS, int SS, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long st, int r0, int T_,
                                          float mul, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    float v[kVec];
    if (r0 + r < T_) {
      load16(src + static_cast<long long>(r0 + r) * st + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      *reinterpret_cast<float4*>(dst + r * SS + c + i) =
          make_float4(v[i] * mul, v[i + 1] * mul, v[i + 2] * mul,
                      v[i + 3] * mul);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int H, int G, int T_,
                 float scale, int causal) {
  using L = Layout<D>;
  constexpr int kCPL = D / 32;                  // output columns per lane
  constexpr int kVec = kCPL < 4 ? kCPL : 4;     // ... in vectors of kVec
  constexpr int kNVec = kCPL / kVec;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::q;
  float* Ks = smem + L::k;
  float* Vs = smem + L::v;
  float* Ps = smem + L::p;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * kRows;  // the warp's first row in the tile

  const T* qb = q + b * qs.sb + h * qs.sh;
  const T* kb = k + b * ks.sb + g * ks.sh;
  const T* vb = v + b * vs.sb + g * vs.sh;
  T* ob = o + b * os.sb + h * os.sh;

  load_tile<D, kBQ, D>(qb, qs.st, q0, T_, scale, Qs);

  float m[kRows], l[kRows], acc[kRows][kCPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCPL; ++c) acc[r][c] = 0.f;
  }

  const int q_end = min(q0 + kBQ, T_);  // one past the tile's last row
  const int k_end = causal ? q_end : T_;
  const int ntiles = (k_end + kBK - 1) / kBK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kBK, L::kStride>(kb, ks.st, k0, T_, 1.f, Ks);
    load_tile<D, kBK, D>(vb, vs.st, k0, T_, 1.f, Vs);
    __syncthreads();

    // scores of key k0 + lane for the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * L::kStride;
    const float* qrow = Qs + row0 * D;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + e);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + r * D + e);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // online softmax, row by row; the probabilities go to Ps
    const int kpos = k0 + lane;
    float corr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row0 + r;
      const bool valid = kpos < T_ && (!causal || kpos <= qpos);
      const float sr = valid ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + warp_sum(p);
      m[r] = m_new;
      Ps[(row0 + r) * kBK + lane] = p;
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCPL; ++c) acc[r][c] *= corr[r];

    // acc += P V over the tile's keys, four keys at a time
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pv[r] = *reinterpret_cast<const float4*>(Ps + (row0 + r) * kBK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * D;
#pragma unroll
        for (int i = 0; i < kNVec; ++i) {
          const int col = (i * 32 + lane) * kVec;
          float vv[kVec];
          if constexpr (kVec == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + col);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else if constexpr (kVec == 2) {
            const float2 t = *reinterpret_cast<const float2*>(vrow + col);
            vv[0] = t.x; vv[1] = t.y;
          } else {
            vv[0] = vrow[col];
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float p = jj == 0 ? pv[r].x : jj == 1 ? pv[r].y
                          : jj == 2 ? pv[r].z : pv[r].w;
#pragma unroll
            for (int t = 0; t < kVec; ++t)
              acc[r][i * kVec + t] = fmaf(p, vv[t], acc[r][i * kVec + t]);
          }
        }
      }
    }
    __syncwarp();  // Ps is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= T_) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + static_cast<long long>(qpos) * os.st;
#pragma unroll
    for (int i = 0; i < kNVec; ++i)
#pragma unroll
      for (int t = 0; t < kVec; ++t)
        store1(orow + (i * 32 + lane) * kVec + t,
               acc[r][i * kVec + t] / denom);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int H, int G, int T_,
                   float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, T>;
  constexpr size_t bytes = Layout<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((T_ + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, H, G, T_,
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const long long* st, int B, int H, int G, int T_, int D,
                     float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64, T>(q, k, v, o, st, B, H, G, T_, scale, causal,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, o, st, B, H, G, T_, scale, causal,
                            stream);
    case 256:
      return launch<256, T>(q, k, v, o, st, B, H, G, T_, scale, causal,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, H, D), k and v (B, T, G, D), o like q, all given by
// `strides` (D one of 64, 128, 256; kernels/flash_attn.py's HEAD_DIMS):
// 12 element strides (batch, head, time) for q, k, v, o; the
// last axis is contiguous and every row 16-byte aligned. bf16 != 0: the
// four arrays are bf16 (raw 16-bit words), else f32. H % G == 0.
// Returns a cudaError_t: 0 when the launch was accepted. Never
// synchronises.
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v,
                                void* o, const long long* strides, int B,
                                int H, int G, int T, int D, int bf16,
                                int causal, float scale,
                                cudaStream_t stream) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || T < 1 ||
      static_cast<long long>(B) * H > INT_MAX || (T + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      bf16 ? dispatch<uint16_t>(q, k, v, o, strides, B, H, G, T, D, scale,
                                causal, stream)
           : dispatch<float>(q, k, v, o, strides, B, H, G, T, D, scale,
                             causal, stream);
  return static_cast<int>(e);
}
