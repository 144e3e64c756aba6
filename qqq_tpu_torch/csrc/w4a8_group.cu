// g128 W4A8 GEMM, exact route, for Hopper (sm_90a): one exact int32 dot per
// 128-row group, scaled and summed in f32 group by group; plain and with the
// fused GLU epilogue, both on the TMA weight stream of w4a8_stream.cuh.
//
// Replaces: qqq_tpu/kernels/w4a8_gemm.py:_w4a8_group_kernel (:161), reached
// through w4a8_gemm (:469, call :655) with group_size = 128 and no requant
// (auto: M < 512; models/llama.py forces it for T < 64), and
// _w4a8_group_glu_kernel (:362), reached through w4a8_glu_gemm (:822,
// call :950) on the same terms.
//
// Computes  facc[m, n] = Σ_g f32( (d_g[m, n] − 8·bsum_g[m]) · s_group[g, n] )
//           D[m, n]    = out( facc[m, n] · s_tok[m] )
// where d_g = A_g · U_g (U the stored offset codes q + 8) and bsum_g the sum
// of row m of A over group g; the GLU computes that for the gate and the up
// column of each output column (weight_col) and writes
// out(silu(D_gate)·D_up) from the unrounded f32 values (w4a8_common.cuh).
// The +8 offset is undone per group in int32, before the scale: hoisting it
// out of the sum cancels two f32 sums ~100× larger and loses ~1% at K =
// 11008 (the JAX kernel's note, :173-177).  s_group is read in its stored
// dtype (bf16 from the calibration pipeline, f32 from Marlin imports) and
// upcast in registers.  The f32 sum runs over the groups in order g = 0, 1,
// ..., each term and each partial sum rounded on its own (__fmul_rn /
// __fadd_rn, no FMA), which is the order of the JAX kernels and of the
// plain PyTorch version (core/quant.py:w4a8_matmul_reference): both
// kernels are bit-identical to the plain version, the GLU one up to expf.
// So K is never split across blocks or warps in an order the chain would
// not take: every (row, column) has one owner thread that adds its groups
// in order.
//
// What bounds it on the H100: this route serves decode and short prefill,
// where the weight stream bounds it: K·N/2 bytes of codes plus K/128·N·2
// bytes of bf16 scales (7.0 us for K = 11008, N = 4096; 13.9 us for the
// fused gate/up, K = 4096, N = 2I = 22016; at 3.35 TB/s).
//
// Design: stream::group_gemm (w4a8_stream.cuh), 32 output columns and 16
// rows of A a block.  A producer warp streams TMA boxes of codes, A and
// s_group into a ring of stages of 8 groups; consumer warp w forms the
// int32 terms d_g − 8·bsum_g of group w of each stage on int8 mma.sync and
// writes them to shared memory; after a barrier of the consumer warps, the
// thread that owns a (row, column) adds the stage's f32 terms to its
// running sum in group order.
//   - stream::kernel (plain): one box of 32 columns a stage, a 4-stage
//     ring; the terms at two words a lane when the block has at most 8
//     rows.  ~2.5x its byte bound at (4, 11008, 4096) (PERF.md), paced by
//     the TMA stream of 128-byte rows.
//   - stream::glu_kernel (GLU): two boxes a stage, the 32 gate and the 32
//     up columns of the block's 32 output columns, each with its s_group
//     rows, so every owner thread keeps a gate and an up chain; the slot
//     (50 KB) and the doubled terms (2 x 32 KB) leave room for a 3-stage
//     ring at one block an SM.  The GLU is applied in registers and the
//     (M, 2I) gate/up values never reach memory.
// Both serve every M the exact route takes (M < 512), each 16-row block
// streaming its columns' weights from L2 again.

#include "w4a8_stream.cuh"

namespace {
namespace stream {

template <bool kSgBf16, bool kBf16Out>
__global__ void __launch_bounds__(kThreads + 32)
kernel(const __grid_constant__ Maps maps, Args p) {
  StreamedA src(p);
  group_gemm<1, kSgBf16, kBf16Out>(maps, p, src);
}

template <bool kSgBf16, bool kBf16Out>
__global__ void __launch_bounds__(kThreads + 32)
glu_kernel(const __grid_constant__ Maps maps, Args p) {
  StreamedA src(p);
  group_gemm<2, kSgBf16, kBf16Out>(maps, p, src);
}

template <bool kGlu, bool kSgBf16, bool kBf16Out>
int launch(const Args& p, cudaStream_t st) {
  if constexpr (kGlu)
    return launch_group<2, 1, kSgBf16>(glu_kernel<kSgBf16, kBf16Out>, p, st);
  else
    return launch_group<1, 1, kSgBf16>(kernel<kSgBf16, kBf16Out>, p, st);
}

}  // namespace stream
}  // namespace

// a (M, K) int8, s_tok (M,) f32, w (K/8, N) int32, s_group (K/128, N) bf16
// (sg_bf16 = 1) or f32, out (M, N) — or, with glu = 1, (M, N/2) — bf16
// (bf16_out = 1) or f32.  K % 128 == 0, N % 512 == 0 with glu; a 16-byte
// aligned.
extern "C" int w4a8_gemm_group(const void* a, const void* s_tok, const void* w,
                               const void* s_group, void* out, int M, int K,
                               int N, int glu, int sg_bf16, int bf16_out,
                               void* stream) {
  const stream::Args p{a,   static_cast<const float*>(s_tok),
                       static_cast<const int32_t*>(w), s_group, out, M, K, N,
                       false};
  auto st = static_cast<cudaStream_t>(stream);
#define GROUP_LAUNCH(GLU_, SG_)                              \
  (bf16_out ? stream::launch<GLU_, SG_, true>(p, st)         \
            : stream::launch<GLU_, SG_, false>(p, st))
  if (glu)
    return sg_bf16 ? GROUP_LAUNCH(true, true) : GROUP_LAUNCH(true, false);
  return sg_bf16 ? GROUP_LAUNCH(false, true) : GROUP_LAUNCH(false, false);
#undef GROUP_LAUNCH
}
