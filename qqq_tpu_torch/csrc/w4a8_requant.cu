// g128 W4A8 GEMM, requant route, plain and GLU-fused, for Hopper (sm_90a):
// the INT4 codes are regridded to INT8 and the whole K takes one exact int32
// dot, on the int8 tensor cores.
//
// Replaces: qqq_tpu/kernels/w4a8_gemm.py:_w4a8_requant_group_kernel (:81),
// reached through w4a8_gemm (:469, call :606) with group_size = 128 and
// requant (auto: M >= 512), and _w4a8_requant_group_glu_kernel (:326),
// reached through w4a8_glu_gemm (:822, call :915).
//
// Computes  w8[k, n] = clip(rint((u[k, n] - 8) * s_frac[k/128, n]), ±127),
//           D[m, n]  = out( (float)(A · w8)[m, n] * s_extra[n] * s_tok[m] )
// (GLU: that sum, scaled, of the gate column g and of the up column u of
// each output column, then out(silu_mul(g, u)), w4a8_common.cuh) with the
// double scale s_frac = s_group / s_extra and s_extra = 7·max_g s_group /
// 127, both computed by the wrapper (kernels/w4a8_gemm.py).
// The regrid rounds one f32 product half to even (the offset is removed
// before the multiply, as in the JAX kernel's _requant_w8 :60), the dot is
// exact in int32 in any order (|sum| <= K·127² < 2³¹), and the epilogue
// multiplies in the JAX order, so the result is bit-identical to the plain
// PyTorch version (the GLU variant up to expf).
//
// What bounds it on the H100: this route serves prefill (M >= 512 rows),
// where the 2·M·N·K int8 products bound it, 1979 TOP/s on the tensor cores
// (N = 2I weight columns for the GLU kernel).
//
// Design: the int8 wgmma tile kernel of w4a8_tc.cuh (requant_tc_kernel,
// tile_gemm with kChannel = false): each step's codes pass through a 16-entry table of w8
// per column, built from the step's s_frac row.

#include "w4a8_tc.cuh"

// The int32 workspace bytes w4a8_gemm_requant needs for these arguments on
// the current card, with or without glu (N weight columns either way): 0
// unless the kernel splits K (fewer tiles than SMs), then splits · M · N ·
// 4.  Negative: minus a CUDA error.
extern "C" long long w4a8_requant_workspace_bytes(int M, int K, int N) {
  return tc::workspace_bytes(M, K, N);
}

// a (M, K) int8, s_tok (M,) f32, w (K/8, N) int32, s_frac (K/128, N) f32,
// s_extra (N,) f32, out (M, N) — or, with glu = 1, (M, N/2) — bf16
// (bf16_out = 1) or f32; workspace: the bytes w4a8_requant_workspace_bytes
// asks for (int32), or null when it asks for none.  K % 128 == 0, N % 512
// == 0 with glu; a 16-byte aligned.
extern "C" int w4a8_gemm_requant(const void* a, const void* s_tok,
                                 const void* w, const void* s_frac,
                                 const void* s_extra, void* out,
                                 void* workspace, int M, int K, int N,
                                 int glu, int bf16_out, void* stream) {
  auto A = static_cast<const int8_t*>(a);
  auto ST = static_cast<const float*>(s_tok);
  auto W = static_cast<const int32_t*>(w);
  auto SF = static_cast<const float*>(s_frac);
  auto SE = static_cast<const float*>(s_extra);
  auto WS = static_cast<int*>(workspace);
  auto st = static_cast<cudaStream_t>(stream);
#define RQ_LAUNCH(GLU_, BF16_) \
  tc::launch_tc<false, GLU_, BF16_>(A, ST, W, SE, SF, out, WS, M, K, N, st)
  if (glu) return bf16_out ? RQ_LAUNCH(true, true) : RQ_LAUNCH(true, false);
  return bf16_out ? RQ_LAUNCH(false, true) : RQ_LAUNCH(false, false);
#undef RQ_LAUNCH
}
