// Per-channel W4A8 GEMM for Hopper (sm_90a), CUDA cores through __dp4a,
// plain and with the fused GLU epilogue.
//
// Replaces: qqq_tpu/kernels/w4a8_gemm.py:_w4a8_channel_kernel (:124), reached
// through w4a8_gemm (:469, call :567) with group_size = -1, and
// _w4a8_channel_glu_kernel (:283), reached through w4a8_glu_gemm (:822,
// call :882) with group_size = -1.
//
// Computes  D[m, n] = out( (float)(acc[m, n] - 8 * asum[m]) * s_ch[n] * s_tok[m] )
// where acc = A_i8 · U (U = the stored offset codes q + 8, in [0, 15]) and
// asum[m] = sum_k A[m, k], both exact in int32; ``out`` rounds to bf16 (or
// stores f32).  The GLU variant computes that for the gate and the up column
// of each output column and writes silu(gate)·up (w4a8_common.cuh).  The
// epilogue multiplies in the JAX kernel's order, so the plain kernel is
// bit-identical to the plain PyTorch version, and the GLU kernel differs
// from it only where expf does.
//
// What bounds it on the H100: at decode (M <= 8) the weight stream, K*N/2
// bytes at 3.35 TB/s (6.7 us for K=4096, N=11008; 13.4 us for the fused
// gate/up, N = 2I = 22016); at prefill the int8 products, which this kernel
// runs on the CUDA cores (__dp4a, 4 MACs per instruction), far below the
// int8 tensor-core rate.  The GLU variant also saves the (M, I) gate and up
// round trip through device memory.
//
// Design: the shared int32-dot loop of w4a8_common.cuh: the nibble planes
// map onto __dp4a with no re-tiling, 8 warps split the K blocks of 32
// columns, BM rows per thread.  The mma.sync / wgmma s8 tensor-core path is
// later work.

#include "w4a8_common.cuh"

// a (M, K) int8, s_tok (M,) f32, w (K/8, N) int32, s_ch (N,) f32,
// out (M, N) — or, with glu = 1, (M, N/2) of silu(gate)·up over the
// GLU-interleaved columns — bf16 (bf16_out = 1) or f32.  K % 128 == 0,
// N % 512 == 0 with glu; a 16-byte aligned.
extern "C" int w4a8_gemm_channel(const void* a, const void* s_tok,
                                 const void* w, const void* s_ch, void* out,
                                 int M, int K, int N, int glu, int bf16_out,
                                 void* stream) {
  using namespace w4a8;
  auto A = static_cast<const int8_t*>(a);
  auto ST = static_cast<const float*>(s_tok);
  auto W = static_cast<const int32_t*>(w);
  auto SC = static_cast<const float*>(s_ch);
  auto st = static_cast<cudaStream_t>(stream);
  const int bm = rows_per_block(M);
  if (glu) {
    if (bf16_out)
      launch_int_dot<true, true>(bm, A, ST, W, SC, out, M, K, N, st);
    else
      launch_int_dot<true, false>(bm, A, ST, W, SC, out, M, K, N, st);
  } else {
    if (bf16_out)
      launch_int_dot<false, true>(bm, A, ST, W, SC, out, M, K, N, st);
    else
      launch_int_dot<false, false>(bm, A, ST, W, SC, out, M, K, N, st);
  }
  return (int)cudaGetLastError();
}
