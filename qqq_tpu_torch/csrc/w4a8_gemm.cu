// Per-channel W4A8 GEMM for Hopper (sm_90a), plain and with the fused GLU
// epilogue, in two regimes behind one entry: the weight stream at decode and
// the int8 wgmma tiles at prefill.
//
// Replaces: qqq_tpu/kernels/w4a8_gemm.py:_w4a8_channel_kernel (:124), reached
// through w4a8_gemm (:469, call :567) with group_size = -1, and
// _w4a8_channel_glu_kernel (:283), reached through w4a8_glu_gemm (:822,
// call :882) with group_size = -1.
//
// Computes  D[m, n] = out( (float)(A · Q)[m, n] * s_ch[n] * s_tok[m] )
// where Q = U − 8 (U the stored offset codes, in [0, 15]); the int32 dot is
// exact in any order (|sum| <= K·128·15 < 2³¹), so either regime may split
// it across warps, MMAs and blocks.  ``out`` rounds to bf16 (or stores f32).
// The GLU variant computes that for the gate and the up column of each
// output column (weight_col) and writes silu(gate)·up (w4a8_common.cuh).
// The epilogue multiplies in the JAX kernel's order (w4a8_gemm.py:155-158,
// :317-323), so the plain kernel is bit-identical to the plain PyTorch
// version in both regimes, and the GLU kernel differs from it only where
// expf does: switching regimes never changes a result.
//
// What bounds it on the H100, and what each regime does about it:
//   - Below the switch (decode; the GLU also at 128 rows): the weight
//     stream, K·N/2 bytes at 3.35 TB/s (6.7 us for K = 11008, N = 4096;
//     13.4 us for the fused gate/up, N = 2I = 22016).
//     stream::channel_kernel (w4a8_stream.cuh): TMA boxes of codes and A
//     through a ring of stages, one group a consumer warp on int8 mma.sync,
//     the int32 sums in registers across all K and one reduction of the
//     eight warps at the end; no scales stream beside the codes.  The GLU
//     tile streams 32 gate and 32 up columns a block.
//   - From the switch on (prefill): the 2·M·N·K int8 products, 1979 TOP/s
//     on the tensor cores.  tc::channel_tc_kernel (w4a8_tc.cuh's tile_gemm
//     with kChannel = true): 256 x 128 tiles of wgmma.m64n128k32.s32.s8.s8,
//     the codes sign-extended to s8 in shared memory (no table, no s_frac),
//     split K when the tiles fill fewer blocks than the card has SMs, with
//     a second pass (channel_split_epilogue: two kernels in that call).
// The wrapper (kernels/w4a8_gemm.py) picks the regime by M
// (CHANNEL_TILES_MIN_M, GLU_CHANNEL_TILES_MIN_M: where the measured times
// cross) and passes it here.
// On the H100 (chip_smoke.py's phase 2, PERF.md) the stream runs at
// ~2.7x its byte bound at (4, 11008, 4096) and ~2.4x for the GLU at (4,
// 4096, 22016), paced by the TMA stream of 128-byte rows: a deeper ring,
// a split of K across blocks or wider column tiles did not move it
// (bring-up variants, not kept).  The tiles run at ~2.7x the int8 bound at
// (4096, 11008, 4096) and ~3.4x for the GLU, paced as the requant kernel is
// by the CUDA-core work around the wgmmas.

#include "w4a8_stream.cuh"
#include "w4a8_tc.cuh"

// The int32 workspace bytes the tile regime needs for these arguments on
// the current card (N weight columns, with or without glu): 0 unless it
// splits K.  Negative: minus a CUDA error.
extern "C" long long w4a8_channel_workspace_bytes(int M, int K, int N) {
  return tc::workspace_bytes(M, K, N);
}

// a (M, K) int8, s_tok (M,) f32, w (K/8, N) int32, s_ch (N,) f32, out (M,
// N) — or, with glu = 1, (M, N/2) of silu(gate)·up over the GLU-interleaved
// columns — bf16 (bf16_out = 1) or f32.  tiles = 1: the wgmma tiles, with
// workspace the bytes w4a8_channel_workspace_bytes asks for (int32) or null
// when it asks for none; tiles = 0: the weight stream (no workspace).  K %
// 128 == 0, N % 512 == 0 with glu; a 16-byte aligned.
extern "C" int w4a8_gemm_channel(const void* a, const void* s_tok,
                                 const void* w, const void* s_ch, void* out,
                                 void* workspace, int M, int K, int N,
                                 int glu, int bf16_out, int tiles,
                                 void* stream) {
  auto A = static_cast<const int8_t*>(a);
  auto ST = static_cast<const float*>(s_tok);
  auto W = static_cast<const int32_t*>(w);
  auto SC = static_cast<const float*>(s_ch);
  auto st = static_cast<cudaStream_t>(stream);
  if (tiles) {
    auto WS = static_cast<int*>(workspace);
#define TC_LAUNCH(GLU_, BF16_) \
  tc::launch_tc<true, GLU_, BF16_>(A, ST, W, SC, nullptr, out, WS, M, K, N, st)
    if (glu) return bf16_out ? TC_LAUNCH(true, true) : TC_LAUNCH(true, false);
    return bf16_out ? TC_LAUNCH(false, true) : TC_LAUNCH(false, false);
#undef TC_LAUNCH
  }
  const stream::Args p{A, ST, W, s_ch, out, M, K, N, false};
  if (glu)
    return bf16_out ? stream::launch_channel<true, true>(p, st)
                    : stream::launch_channel<true, false>(p, st);
  return bf16_out ? stream::launch_channel<false, true>(p, st)
                  : stream::launch_channel<false, false>(p, st);
}
