// Shared pieces of the W4A8 GEMM kernels (w4a8_gemm.cu, w4a8_requant.cu,
// w4a8_group.cu, w4a8_fused.cu): the nibble-plane operand layout, the GLU
// column map and epilogue, the INT4 -> INT8 regrid of one code, and the
// CUDA-core int32-dot main loop (int_dot_kernel) of the per-channel kernels
// (plain and GLU).  The g128 requant kernels, plain and GLU, run the int8
// tensor cores instead (w4a8_requant.cu).
//
// Operand layout (core/packing.py).  Word row 16b+r of a column holds, in
// its low nibbles, the codes k = 128b+4r+{0..3} and, in its high nibbles,
// k = 128b+64+4r+{0..3}; so (w & 0x0F0F0F0F) and ((w >> 4) & 0x0F0F0F0F)
// are each four unsigned codes u = q + 8, one __dp4a against int32 word r
// (resp. 16+r) of the 128-wide slice of an activation row.
//
// GLU (the fused gate/up weight of models/llama.py:fuse_inference_params):
// the weight's 2I columns hold gate and up tile-interleaved,
// [gate_j(256) | up_j(256)], so output column o = 256j + c reads fused
// columns 512j + c (gate) and 512j + 256 + c (up).  The epilogue computes
// g·σ(g)·u in f32 from the two scaled f32 values, σ(g) = 1/(1+exp(−g)) with
// the accurate expf and an IEEE division, and rounds once; the (M, I) gate
// and up intermediates never reach global memory.
//
// int_dot_kernel's block shape: 8 warps own 32 output columns, one per lane, so every weight
// load is one coalesced 128-byte row of a column tile; the warps split the
// 128-row K blocks among themselves, and each thread keeps BM rows of
// accumulators so that a weight word loaded once serves BM rows.  Rows of A
// are read as 16-byte vectors that all lanes of a warp share (an L1
// broadcast).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w4a8 {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;
constexpr int kGluTile = 256;  // GLU_INTERLEAVE of kernels/w4a8_gemm.py
constexpr unsigned kNib = 0x0F0F0F0Fu;

// Fused weight column of output column o; s = 0 gate, 1 up.
template <bool kGlu>
__device__ __forceinline__ int weight_col(int o, int s) {
  if (!kGlu) return o;
  return (o / kGluTile) * (2 * kGluTile) + s * kGluTile + (o % kGluTile);
}

// silu(g)·u as (g·σ(g))·u, each product rounded on its own.
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sg = 1.0f / (1.0f + expf(-g));
  return __fmul_rn(__fmul_rn(g, sg), u);
}

template <bool kBf16Out>
__device__ __forceinline__ void store(void* out, size_t idx, float v) {
  if (kBf16Out)
    reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(out)[idx] = v;
}

// One 128-wide slice of activation row `row` as 32 int32 words.
__device__ __forceinline__ void load_a(const int8_t* __restrict__ a, int K,
                                       int row, int kb, int av[32]) {
  const int4* ap =
      reinterpret_cast<const int4*>(a + (size_t)row * K + (size_t)kb * 128);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int4 v = __ldg(ap + j);
    av[4 * j + 0] = v.x;
    av[4 * j + 1] = v.y;
    av[4 * j + 2] = v.z;
    av[4 * j + 3] = v.w;
  }
}

// INT4 → INT8 regrid of one code: w8 = clip(rint(q·s_frac), ±127) for q =
// u − 8, the offset removed before the multiply so that the f32 product
// rounds once, half to even (__float2int_rn).
__device__ __forceinline__ int requant1(int q, float sf) {
  const int w8 = __float2int_rn(__fmul_rn((float)q, sf));
  return min(127, max(-127, w8));
}

// The int32-dot main loop of the per-channel kernel,
//   D = ((A·U)_s32 − 8·rowsum A) · s_col[n] · s_tok[m]
// with s_col = s_channel: exact in int32 up to the two f32 multiplies of
// the epilogue, taken in the JAX kernel's order, so the result is
// bit-identical to the plain version.
template <int BM, bool kGlu, bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
int_dot_kernel(const int8_t* __restrict__ a, const float* __restrict__ s_tok,
               const int32_t* __restrict__ w, const float* __restrict__ s_col,
               void* __restrict__ out, int M, int K, int Nw) {
  constexpr int NS = kGlu ? 2 : 1;
  __shared__ int red[kWarps][NS][BM][kCols];
  __shared__ int asum[BM];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int No = kGlu ? Nw / 2 : Nw;
  const int o = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * BM;
  const int KB = K / 128;
  if (threadIdx.x < BM) asum[threadIdx.x] = 0;

  int acc[NS][BM];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < BM; ++i) acc[s][i] = 0;

  if (o < No) {
    for (int kb = warp; kb < KB; kb += kWarps) {
      unsigned raw[NS][16];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int32_t* wp = w + (size_t)kb * 16 * Nw + weight_col<kGlu>(o, s);
#pragma unroll
        for (int r = 0; r < 16; ++r) raw[s][r] = (unsigned)__ldg(wp + (size_t)r * Nw);
      }
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (m0 + i < M) {
          int av[32];
          load_a(a, K, m0 + i, kb, av);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            int t = acc[s][i];
#pragma unroll
            for (int r = 0; r < 16; ++r) {
              // the nibble planes masked where they are used; holding 32
              // unpacked words instead costs registers and ran the BM = 16
              // kernel ~40% slower on the H100
              t = __dp4a((int)(raw[s][r] & kNib), av[r], t);
              t = __dp4a((int)((raw[s][r] >> 4) & kNib), av[16 + r], t);
            }
            acc[s][i] = t;
          }
        }
      }
    }
  }
  __syncthreads();  // asum zeroed before the atomics below

  {  // full-row sums of A for this block's rows (exact)
    const int K4 = K / 4;
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      if (m0 + i < M) {
        const int* ar = reinterpret_cast<const int*>(a + (size_t)(m0 + i) * K);
        int t = 0;
        for (int j = threadIdx.x; j < K4; j += blockDim.x)
          t = __dp4a(__ldg(ar + j), 0x01010101, t);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) t += __shfl_xor_sync(0xffffffffu, t, d);
        if (lane == 0) atomicAdd(&asum[i], t);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < BM; ++i) red[warp][s][i][lane] = acc[s][i];
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * kCols; idx += blockDim.x) {
    const int i = idx / kCols;
    const int c = idx % kCols;
    const int m = m0 + i;
    const int oo = blockIdx.x * kCols + c;
    if (m < M && oo < No) {
      float v[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        int tot = 0;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) tot += red[q][s][i][c];
        tot -= 8 * asum[i];  // undo the +8 code offset
        v[s] = __fmul_rn((float)tot, s_col[weight_col<kGlu>(oo, s)]);
        v[s] = __fmul_rn(v[s], s_tok[m]);
      }
      store<kBf16Out>(out, (size_t)m * No + oo, kGlu ? silu_mul(v[0], v[NS - 1]) : v[0]);
    }
  }
}

// Grid over (output column tiles, row tiles of BM) for a kernel taking the
// rows-per-block as its first template argument.
inline dim3 grid_for(int M, int No, int BM) {
  return dim3((No + kCols - 1) / kCols, (M + BM - 1) / BM);
}

template <bool kGlu, bool kBf16Out>
void launch_int_dot(int BM, const int8_t* a, const float* s_tok,
                    const int32_t* w, const float* s_col, void* out, int M,
                    int K, int Nw, cudaStream_t st) {
  const int No = kGlu ? Nw / 2 : Nw;
#define W4A8_LAUNCH(bm)                                               \
  int_dot_kernel<bm, kGlu, kBf16Out>                                  \
      <<<grid_for(M, No, bm), kThreads, 0, st>>>(a, s_tok, w, s_col, \
                                                 out, M, K, Nw)
  switch (BM) {
    case 1: W4A8_LAUNCH(1); break;
    case 2: W4A8_LAUNCH(2); break;
    case 4: W4A8_LAUNCH(4); break;
    case 8: W4A8_LAUNCH(8); break;
    default: W4A8_LAUNCH(16); break;
  }
#undef W4A8_LAUNCH
}

// Rows per block for M rows: small tiles at decode, 16 at prefill.
inline int rows_per_block(int M) {
  if (M <= 1) return 1;
  if (M <= 2) return 2;
  if (M <= 4) return 4;
  if (M < 64) return 8;
  return 16;
}

}  // namespace w4a8
