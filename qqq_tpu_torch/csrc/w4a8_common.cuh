// Shared pieces of the W4A8 GEMM kernels (w4a8_gemm.cu, w4a8_requant.cu,
// w4a8_group.cu, w4a8_fused.cu, and the tile and stream kernels of
// w4a8_tc.cuh and w4a8_stream.cuh): the nibble-plane operand layout, the GLU
// column map and epilogue, and the INT4 -> INT8 regrid of one code.
//
// Operand layout (core/packing.py).  Word row 16b+r of a column holds, in
// its low nibbles, the codes k = 128b+4r+{0..3} and, in its high nibbles,
// k = 128b+64+4r+{0..3}; so (w & 0x0F0F0F0F) and ((w >> 4) & 0x0F0F0F0F)
// are each four unsigned codes u = q + 8, matching bytes 4r .. 4r+3 (resp.
// 64+4r ..) of the 128-wide slice of an activation row.
//
// GLU (the fused gate/up weight of models/llama.py:fuse_inference_params):
// the weight's 2I columns hold gate and up tile-interleaved,
// [gate_j(256) | up_j(256)], so output column o = 256j + c reads fused
// columns 512j + c (gate) and 512j + 256 + c (up).  The epilogue computes
// g·σ(g)·u in f32 from the two scaled f32 values, σ(g) = 1/(1+exp(−g)) with
// the accurate expf and an IEEE division, and rounds once; the (M, I) gate
// and up intermediates never reach global memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w4a8 {

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

// INT4 → INT8 regrid of one code: w8 = clip(rint(q·s_frac), ±127) for q =
// u − 8, the offset removed before the multiply so that the f32 product
// rounds once, half to even (__float2int_rn).
__device__ __forceinline__ int requant1(int q, float sf) {
  const int w8 = __float2int_rn(__fmul_rn((float)q, sf));
  return min(127, max(-127, w8));
}

}  // namespace w4a8
