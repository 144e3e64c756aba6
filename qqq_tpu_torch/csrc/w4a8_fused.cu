// W4A8 GEMM with the per-token activation quantization fused into the
// prologue, per channel and g128 exact, for Hopper (sm_90a), CUDA cores
// through __dp4a.
//
// Replaces: qqq_tpu/kernels/w4a8_gemm.py:_w4a8_fused_channel_kernel (:207)
// and _w4a8_fused_group_kernel (:239), reached through w4a8_gemm_fused
// (:700) from w4a8_linear (:1023) when FUSE_ACT_QUANT is set, M <= 64 and
// _fused_bn(K, round_up(N, 128)) is non-zero.
//
// Computes, from raw activations x (M, K) bf16 or f32, per row m:
//   s[m] = max(absmax_k |x[m, k]|, 1e-30) / 127          (IEEE division)
//   a[m, k] = clip(rint(x[m, k] / s[m]), -128, 127)      (IEEE, half even)
// which is the JAX kernels' order (core/quant.py divides first and clamps
// after; the two differ only on an all-zero row, whose outputs are 0 either
// way); then, with U the stored offset codes q + 8,
//   per channel:  D[m, n] = out( (float)((A.U)_s32 - 8 * rowsum A) * s_ch[n]
//                                * s[m] )
//   g128 exact:   D[m, n] = out( (sum_g f32((d_g - 8 * bsum_g) * s_g[g, n]))
//                                * s[m] )
// with the epilogues of the unfused kernels (the per-channel route of
// w4a8_gemm.cu and the exact g128 route of w4a8_group.cu): each product and
// sum rounded on its own, the groups summed in order.  Kernel and plain
// PyTorch version (kernels/w4a8_gemm.py) are bit-identical.
//
// What bounds it on the H100: the weight stream at decode, K * N / 2 bytes
// of codes (plus K / 128 * N * 2 of bf16 group scales) at 3.35 TB/s; the x
// rows add M * K * 2 bytes.
//
// Design: the unfused kernels' block (8 warps own 32 output columns, one
// per lane, and split the K blocks), with a prologue in which the block
// quantizes its BM <= 8 rows of x into shared memory: a first pass over x
// for each row's absmax, a second for the codes and, per channel, their row
// sums.  The main loop reads the codes from shared memory (all lanes of a
// warp read the same 16-byte vectors: a broadcast) instead of from device
// memory.  BM * K code bytes must fit a block's shared memory: 8 rows of
// K <= 24576, the largest K that _fused_bn admits.  Every column block
// quantizes its rows again, as every n-tile of the JAX kernel does; at
// K = 4096, N = 4096 that is 128 blocks re-reading the same x from L2.

#include "smem_fit.cuh"
#include "w4a8_common.cuh"

namespace {

using namespace w4a8;

constexpr int kMaxBM = 8;

template <typename TX>
struct XVec;

template <>
struct XVec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float v[4]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

template <>
struct XVec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float v[8]) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
};

template <bool kSgBf16>
__device__ __forceinline__ float group_scale(const void* sg, size_t idx) {
  if (kSgBf16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(sg)[idx]);
  return __ldg(reinterpret_cast<const float*>(sg) + idx);
}

// Quantizes rows m0 .. m0 + BM - 1 (those below M) of x into aq (BM, K)
// int8, their scales into s_sh and, with kRowSums, their code sums into
// asum_sh.  Ends with a barrier.
template <int BM, typename TX, bool kRowSums>
__device__ void quantize_rows(const TX* __restrict__ x, int M, int K, int m0,
                              int8_t* aq, float* s_sh, int* asum_sh) {
  constexpr int V = XVec<TX>::N;
  __shared__ float red[kWarps][BM];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nv = K / V;

  float amax[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) amax[i] = 0.f;
  for (int j = threadIdx.x; j < nv; j += kThreads) {
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      if (m0 + i < M) {
        float v[V];
        XVec<TX>::load(x + (size_t)(m0 + i) * K + (size_t)j * V, v);
#pragma unroll
        for (int u = 0; u < V; ++u) amax[i] = fmaxf(amax[i], fabsf(v[u]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    float a = amax[i];
    for (int o = 16; o > 0; o >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (lane == 0) red[warp][i] = a;
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaxf(a, red[w][threadIdx.x]);
    s_sh[threadIdx.x] = __fdiv_rn(fmaxf(a, 1e-30f), 127.0f);
    if (kRowSums) asum_sh[threadIdx.x] = 0;
  }
  __syncthreads();

  int rsum[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) rsum[i] = 0;
  for (int j = threadIdx.x; j < nv; j += kThreads) {
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      if (m0 + i < M) {
        float v[V];
        XVec<TX>::load(x + (size_t)(m0 + i) * K + (size_t)j * V, v);
        const float s = s_sh[i];
        unsigned packed[V / 4];
#pragma unroll
        for (int w = 0; w < V / 4; ++w) packed[w] = 0u;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float r = fminf(fmaxf(rintf(__fdiv_rn(v[u], s)), -128.f),
                                127.f);
          const int c = (int)r;
          rsum[i] += c;
          packed[u / 4] |= ((unsigned)c & 0xFFu) << (8 * (u % 4));
        }
        unsigned* dst = reinterpret_cast<unsigned*>(aq + (size_t)i * K +
                                                    (size_t)j * V);
#pragma unroll
        for (int w = 0; w < V / 4; ++w) dst[w] = packed[w];
      }
    }
  }
  if (kRowSums) {
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      int t = rsum[i];
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0 && m0 + i < M) atomicAdd(&asum_sh[i], t);
    }
  }
  __syncthreads();
}

// One 128-wide slice of quantized row i (in shared memory) as 32 words.
__device__ __forceinline__ void load_a_shared(const int8_t* aq, int K, int i,
                                              int kb, int av[32]) {
  const int4* ap = reinterpret_cast<const int4*>(aq + (size_t)i * K +
                                                 (size_t)kb * 128);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int4 v = ap[j];
    av[4 * j + 0] = v.x;
    av[4 * j + 1] = v.y;
    av[4 * j + 2] = v.z;
    av[4 * j + 3] = v.w;
  }
}

// kGroup = false: per channel, scales = s_channel (N,) f32.
// kGroup = true: g128 exact, scales = s_group (K / 128, N) bf16 or f32.
template <int BM, bool kGroup, typename TX, bool kSgBf16, bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const TX* __restrict__ x, const int32_t* __restrict__ w,
             const void* __restrict__ scales, void* __restrict__ out, int M,
             int K, int N) {
  extern __shared__ int4 aq_raw[];
  int8_t* aq = reinterpret_cast<int8_t*>(aq_raw);  // [BM][K] codes
  __shared__ float s_sh[BM];
  __shared__ int asum_sh[BM];
  // per channel: each warp's int32 partial sums; g128: each warp's group
  // term, added in group order
  __shared__ int red[kGroup ? 1 : kWarps][BM][kCols];
  __shared__ float term[kGroup ? kWarps : 1][BM][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int o = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * BM;
  const int G = K / 128;

  quantize_rows<BM, TX, !kGroup>(x, M, K, m0, aq, s_sh, asum_sh);

  if constexpr (!kGroup) {
    int acc[BM];
#pragma unroll
    for (int i = 0; i < BM; ++i) acc[i] = 0;
    if (o < N) {
      for (int kb = warp; kb < G; kb += kWarps) {
        unsigned raw[16];
        const int32_t* wp = w + (size_t)kb * 16 * N + o;
#pragma unroll
        for (int r = 0; r < 16; ++r) raw[r] = (unsigned)__ldg(wp + (size_t)r * N);
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          if (m0 + i < M) {
            int av[32];
            load_a_shared(aq, K, i, kb, av);
            int t = acc[i];
#pragma unroll
            for (int r = 0; r < 16; ++r) {
              t = __dp4a((int)(raw[r] & kNib), av[r], t);
              t = __dp4a((int)((raw[r] >> 4) & kNib), av[16 + r], t);
            }
            acc[i] = t;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BM; ++i) red[warp][i][lane] = acc[i];
    __syncthreads();
    const float* s_ch = static_cast<const float*>(scales);
    for (int idx = threadIdx.x; idx < BM * kCols; idx += kThreads) {
      const int i = idx / kCols;
      const int c = idx % kCols;
      const int m = m0 + i;
      const int oo = blockIdx.x * kCols + c;
      if (m < M && oo < N) {
        int tot = 0;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) tot += red[q][i][c];
        tot -= 8 * asum_sh[i];  // undo the +8 code offset
        float v = __fmul_rn((float)tot, s_ch[oo]);
        v = __fmul_rn(v, s_sh[i]);
        store<kBf16Out>(out, (size_t)m * N + oo, v);
      }
    }
  } else {
    constexpr int R = (BM * kCols + kThreads - 1) / kThreads;
    float facc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) facc[r] = 0.f;
    for (int g0 = 0; g0 < G; g0 += kWarps) {
      const int g = g0 + warp;
      if (g < G && o < N) {
        unsigned raw[16];
        const int32_t* wp = w + (size_t)g * 16 * N + o;
#pragma unroll
        for (int r = 0; r < 16; ++r) raw[r] = (unsigned)__ldg(wp + (size_t)r * N);
        const float sg = group_scale<kSgBf16>(scales, (size_t)g * N + o);
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          if (m0 + i < M) {
            int av[32];
            load_a_shared(aq, K, i, g, av);
            int bsum = 0;
#pragma unroll
            for (int j = 0; j < 32; ++j) bsum = __dp4a(av[j], 0x01010101, bsum);
            int d = 0;
#pragma unroll
            for (int r = 0; r < 16; ++r) {
              d = __dp4a((int)(raw[r] & kNib), av[r], d);
              d = __dp4a((int)((raw[r] >> 4) & kNib), av[16 + r], d);
            }
            term[warp][i][lane] = __fmul_rn((float)(d - 8 * bsum), sg);
          }
        }
      }
      __syncthreads();
      const int ng = min(kWarps, G - g0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = threadIdx.x + r * kThreads;
        if (p < BM * kCols) {
          const int i = p / kCols;
          const int c = p % kCols;
          if (m0 + i < M && blockIdx.x * kCols + c < N)
            for (int q = 0; q < ng; ++q)
              facc[r] = __fadd_rn(facc[r], term[q][i][c]);
        }
      }
      __syncthreads();  // terms read before the next groups overwrite them
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = threadIdx.x + r * kThreads;
      if (p < BM * kCols) {
        const int i = p / kCols;
        const int c = p % kCols;
        const int m = m0 + i;
        const int oo = blockIdx.x * kCols + c;
        if (m < M && oo < N)
          store<kBf16Out>(out, (size_t)m * N + oo, __fmul_rn(facc[r], s_sh[i]));
      }
    }
  }
}

template <int BM, bool kGroup, typename TX, bool kSgBf16, bool kBf16Out>
int launch_bm(const void* x, const int32_t* w, const void* scales, void* out,
              int M, int K, int N, cudaStream_t st) {
  auto kernel = fused_kernel<BM, kGroup, TX, kSgBf16, kBf16Out>;
  const size_t smem = (size_t)BM * K;
  const int fit = smem_fit(kernel, smem);
  if (fit != 0) return fit;
  kernel<<<grid_for(M, N, BM), kThreads, smem, st>>>(
      static_cast<const TX*>(x), w, scales, out, M, K, N);
  return (int)cudaGetLastError();
}

template <bool kGroup, typename TX, bool kSgBf16, bool kBf16Out>
int launch(const void* x, const int32_t* w, const void* scales, void* out,
           int M, int K, int N, cudaStream_t st) {
  const int bm = rows_per_block(M) < kMaxBM ? rows_per_block(M) : kMaxBM;
  switch (bm) {
    case 1: return launch_bm<1, kGroup, TX, kSgBf16, kBf16Out>(x, w, scales, out, M, K, N, st);
    case 2: return launch_bm<2, kGroup, TX, kSgBf16, kBf16Out>(x, w, scales, out, M, K, N, st);
    case 4: return launch_bm<4, kGroup, TX, kSgBf16, kBf16Out>(x, w, scales, out, M, K, N, st);
    default: return launch_bm<8, kGroup, TX, kSgBf16, kBf16Out>(x, w, scales, out, M, K, N, st);
  }
}

template <bool kGroup, bool kSgBf16>
int launch_x(const void* x, const int32_t* w, const void* scales, void* out,
             int M, int K, int N, int x_bf16, int bf16_out, cudaStream_t st) {
  if (x_bf16)
    return bf16_out
        ? launch<kGroup, __nv_bfloat16, kSgBf16, true>(x, w, scales, out, M, K, N, st)
        : launch<kGroup, __nv_bfloat16, kSgBf16, false>(x, w, scales, out, M, K, N, st);
  return bf16_out
      ? launch<kGroup, float, kSgBf16, true>(x, w, scales, out, M, K, N, st)
      : launch<kGroup, float, kSgBf16, false>(x, w, scales, out, M, K, N, st);
}

}  // namespace

// x (M, K) bf16 (x_bf16 = 1) or f32, 16-byte aligned; w (K/8, N) int32;
// scales: s_channel (N,) f32 (group = 0) or s_group (K/128, N) bf16
// (sg_bf16 = 1) or f32 (group = 1); out (M, N) bf16 (bf16_out = 1) or f32.
// K % 128 == 0 (else cudaErrorInvalidValue); kSmemTooLarge, nothing
// launched, where min(M, 8) rows of K codes exceed a block's shared memory.
extern "C" int w4a8_gemm_fused(const void* x, const void* w,
                               const void* scales, void* out, int M, int K,
                               int N, int group, int x_bf16, int sg_bf16,
                               int bf16_out, void* stream) {
  if (K % 128 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  auto W = static_cast<const int32_t*>(w);
  auto st = static_cast<cudaStream_t>(stream);
  if (!group)
    return launch_x<false, false>(x, W, scales, out, M, K, N, x_bf16,
                                  bf16_out, st);
  if (sg_bf16)
    return launch_x<true, true>(x, W, scales, out, M, K, N, x_bf16, bf16_out,
                                st);
  return launch_x<true, false>(x, W, scales, out, M, K, N, x_bf16, bf16_out,
                               st);
}
