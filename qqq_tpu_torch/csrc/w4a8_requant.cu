// g128 W4A8 GEMM, requant route, for Hopper (sm_90a): the INT4 codes are
// regridded to INT8 in registers and the whole K takes one int32 dot;
// plain and with the fused GLU epilogue.
//
// Replaces: qqq_tpu/kernels/w4a8_gemm.py:_w4a8_requant_group_kernel (:81),
// reached through w4a8_gemm (:469, call :606) with group_size = 128 and
// requant (auto: M >= 512), and _w4a8_requant_group_glu_kernel (:326),
// reached through w4a8_glu_gemm (:822, call :915).
//
// Computes  w8[k, n] = clip(rint((u[k, n] - 8) * s_frac[k/128, n]), ±127),
//           D[m, n]  = out( (float)(A · w8)[m, n] * s_extra[n] * s_tok[m] )
// with the double scale s_frac = s_group / s_extra and s_extra =
// 7·max_g s_group / 127, both computed by the wrapper (kernels/w4a8_gemm.py).
// The regrid rounds one f32 product half to even (the offset is removed
// before the multiply, as in the JAX kernel's _requant_w8 :60), the dot is
// exact in int32, and the epilogue multiplies in the JAX order, so the
// result is bit-identical to the plain PyTorch version (the GLU variant up
// to expf).
//
// What bounds it on the H100: this route serves prefill (M >= 512 rows),
// where the 2·M·N·K int8 products bound it (1979 TOP/s on the tensor cores);
// here they run on the CUDA cores through __dp4a.  The regrid costs about
// 30 instructions per weight word per block of BM = 16 rows, 1/16 of it
// per row.
//
// Design: the int32-dot loop of w4a8_common.cuh with the regrid applied to
// each weight word once per K block, before the BM rows use it; the
// accumulators are int32 throughout, so the 8 warps' split of K changes
// nothing in the result.

#include "w4a8_common.cuh"

// a (M, K) int8, s_tok (M,) f32, w (K/8, N) int32, s_frac (K/128, N) f32,
// s_extra (N,) f32, out (M, N) — or, with glu = 1, (M, N/2) — bf16
// (bf16_out = 1) or f32.  K % 128 == 0, N % 512 == 0 with glu; a 16-byte
// aligned.
extern "C" int w4a8_gemm_requant(const void* a, const void* s_tok,
                                 const void* w, const void* s_frac,
                                 const void* s_extra, void* out, int M, int K,
                                 int N, int glu, int bf16_out, void* stream) {
  using namespace w4a8;
  auto A = static_cast<const int8_t*>(a);
  auto ST = static_cast<const float*>(s_tok);
  auto W = static_cast<const int32_t*>(w);
  auto SF = static_cast<const float*>(s_frac);
  auto SE = static_cast<const float*>(s_extra);
  auto st = static_cast<cudaStream_t>(stream);
  const int bm = rows_per_block(M);
  if (glu) {
    if (bf16_out)
      launch_int_dot<true, true, true>(bm, A, ST, W, SE, SF, out, M, K, N, st);
    else
      launch_int_dot<true, true, false>(bm, A, ST, W, SE, SF, out, M, K, N, st);
  } else {
    if (bf16_out)
      launch_int_dot<true, false, true>(bm, A, ST, W, SE, SF, out, M, K, N, st);
    else
      launch_int_dot<true, false, false>(bm, A, ST, W, SE, SF, out, M, K, N, st);
  }
  return (int)cudaGetLastError();
}
