// g128 W4A8 GEMM, exact route, for Hopper (sm_90a): one exact int32 dot per
// 128-row group, scaled and summed in f32 group by group; plain and with
// the fused GLU epilogue.
//
// Replaces: qqq_tpu/kernels/w4a8_gemm.py:_w4a8_group_kernel (:161), reached
// through w4a8_gemm (:469, call :655) with group_size = 128 and no requant
// (auto: M < 512; models/llama.py forces it for T < 64), and
// _w4a8_group_glu_kernel (:362), reached through w4a8_glu_gemm (:822,
// call :950).
//
// Computes  facc[m, n] = Σ_g f32( (d_g[m, n] − 8·bsum_g[m]) · s_group[g, n] )
//           D[m, n]    = out( facc[m, n] · s_tok[m] )
// where d_g = A_g · U_g (U the stored offset codes q + 8) and bsum_g the sum
// of row m of A over group g.  The +8 offset is undone per group in int32,
// before the scale: hoisting it out of the sum cancels two f32 sums ~100×
// larger and loses ~1% at K = 11008 (the JAX kernel's note, :173-177).
// s_group is read in its stored dtype (bf16 from the calibration pipeline,
// f32 from Marlin imports) and upcast in registers.  The f32 sum runs over
// the groups in order g = 0, 1, ..., each term and each partial sum rounded
// on its own (__fmul_rn / __fadd_rn, no FMA), which is the order of the JAX
// kernel and of the plain PyTorch version (core/quant.py:
// w4a8_matmul_reference): the kernel is bit-identical to the plain version,
// the GLU variant up to expf.
//
// What bounds it on the H100: this route serves decode and short prefill,
// where the weight stream bounds it: K·N/2 bytes of codes plus K/128·N·2
// bytes of bf16 scales (7.0 us for K=4096, N=11008 at 3.35 TB/s).
//
// Design: as the int32-dot kernels (w4a8_common.cuh), 8 warps own 32 output
// columns, one per lane, and share out the K blocks; a K block is one group.
// The warps take 8 consecutive groups at a time, one each, and write each
// group's f32 term for their BM rows to shared memory; after a barrier the
// block adds the 8 terms to the running sums in group order, so the split of
// K among warps leaves the f32 order of the sum unchanged.  bsum_g comes
// from the same A words through __dp4a against 0x01010101.

#include "w4a8_common.cuh"

namespace {

using namespace w4a8;

template <bool kSgBf16>
__device__ __forceinline__ float group_scale(const void* sg, size_t idx) {
  if (kSgBf16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(sg)[idx]);
  return __ldg(reinterpret_cast<const float*>(sg) + idx);
}

template <int BM, bool kGlu, bool kSgBf16, bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
group_kernel(const int8_t* __restrict__ a, const float* __restrict__ s_tok,
             const int32_t* __restrict__ w, const void* __restrict__ s_group,
             void* __restrict__ out, int M, int K, int Nw) {
  constexpr int NS = kGlu ? 2 : 1;
  constexpr int R = (BM * kCols + kThreads - 1) / kThreads;  // sums per thread
  __shared__ float term[kWarps][NS][BM][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int No = kGlu ? Nw / 2 : Nw;
  const int o = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * BM;
  const int G = K / 128;

  // running f32 sums: thread t owns pairs (row i, column c) p = t + r·kThreads
  float facc[NS][R];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int r = 0; r < R; ++r) facc[s][r] = 0.0f;

  for (int g0 = 0; g0 < G; g0 += kWarps) {
    const int g = g0 + warp;
    if (g < G && o < No) {
      unsigned raw[NS][16];
      float sg[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int col = weight_col<kGlu>(o, s);
        const int32_t* wp = w + (size_t)g * 16 * Nw + col;
#pragma unroll
        for (int r = 0; r < 16; ++r) raw[s][r] = (unsigned)__ldg(wp + (size_t)r * Nw);
        sg[s] = group_scale<kSgBf16>(s_group, (size_t)g * Nw + col);
      }
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (m0 + i < M) {
          int av[32];
          load_a(a, K, m0 + i, g, av);
          int bsum = 0;
#pragma unroll
          for (int j = 0; j < 32; ++j) bsum = __dp4a(av[j], 0x01010101, bsum);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            int d = 0;
#pragma unroll
            for (int r = 0; r < 16; ++r) {
              d = __dp4a((int)(raw[s][r] & kNib), av[r], d);
              d = __dp4a((int)((raw[s][r] >> 4) & kNib), av[16 + r], d);
            }
            term[warp][s][i][lane] = __fmul_rn((float)(d - 8 * bsum), sg[s]);
          }
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
        if (m0 + i < M && blockIdx.x * kCols + c < No) {
#pragma unroll
          for (int s = 0; s < NS; ++s)
            for (int q = 0; q < ng; ++q)
              facc[s][r] = __fadd_rn(facc[s][r], term[q][s][i][c]);
        }
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
      if (m < M && oo < No) {
        float v[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) v[s] = __fmul_rn(facc[s][r], s_tok[m]);
        store<kBf16Out>(out, (size_t)m * No + oo,
                        kGlu ? silu_mul(v[0], v[NS - 1]) : v[0]);
      }
    }
  }
}

template <bool kGlu, bool kSgBf16, bool kBf16Out>
void launch(int BM, const int8_t* a, const float* s_tok, const int32_t* w,
            const void* sg, void* out, int M, int K, int Nw, cudaStream_t st) {
  const int No = kGlu ? Nw / 2 : Nw;
#define GROUP_LAUNCH(bm)                                                    \
  group_kernel<bm, kGlu, kSgBf16, kBf16Out>                                  \
      <<<grid_for(M, No, bm), kThreads, 0, st>>>(a, s_tok, w, sg, out, M, K, \
                                                 Nw)
  switch (BM) {
    case 1: GROUP_LAUNCH(1); break;
    case 2: GROUP_LAUNCH(2); break;
    case 4: GROUP_LAUNCH(4); break;
    case 8: GROUP_LAUNCH(8); break;
    default: GROUP_LAUNCH(16); break;
  }
#undef GROUP_LAUNCH
}

template <bool kGlu>
void launch_sg(int BM, const int8_t* a, const float* s_tok, const int32_t* w,
               const void* sg, void* out, int M, int K, int Nw, int sg_bf16,
               int bf16_out, cudaStream_t st) {
  if (sg_bf16) {
    if (bf16_out)
      launch<kGlu, true, true>(BM, a, s_tok, w, sg, out, M, K, Nw, st);
    else
      launch<kGlu, true, false>(BM, a, s_tok, w, sg, out, M, K, Nw, st);
  } else {
    if (bf16_out)
      launch<kGlu, false, true>(BM, a, s_tok, w, sg, out, M, K, Nw, st);
    else
      launch<kGlu, false, false>(BM, a, s_tok, w, sg, out, M, K, Nw, st);
  }
}

}  // namespace

// a (M, K) int8, s_tok (M,) f32, w (K/8, N) int32, s_group (K/128, N) bf16
// (sg_bf16 = 1) or f32, out (M, N) — or, with glu = 1, (M, N/2) — bf16
// (bf16_out = 1) or f32.  K % 128 == 0, N % 512 == 0 with glu; a 16-byte
// aligned.
extern "C" int w4a8_gemm_group(const void* a, const void* s_tok, const void* w,
                               const void* s_group, void* out, int M, int K,
                               int N, int glu, int sg_bf16, int bf16_out,
                               void* stream) {
  auto A = static_cast<const int8_t*>(a);
  auto ST = static_cast<const float*>(s_tok);
  auto W = static_cast<const int32_t*>(w);
  auto st = static_cast<cudaStream_t>(stream);
  const int bm = rows_per_block(M);
  if (glu)
    launch_sg<true>(bm, A, ST, W, s_group, out, M, K, N, sg_bf16, bf16_out, st);
  else
    launch_sg<false>(bm, A, ST, W, s_group, out, M, K, N, sg_bf16, bf16_out, st);
  return (int)cudaGetLastError();
}
