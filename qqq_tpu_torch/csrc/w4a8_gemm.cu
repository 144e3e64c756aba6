// Per-channel W4A8 GEMM for Hopper (sm_90a), CUDA cores through __dp4a.
//
// Replaces: qqq_tpu/kernels/w4a8_gemm.py:_w4a8_channel_kernel (:124), reached
// through w4a8_gemm (:469, call :567) with group_size = -1.
//
// Computes  D[m, n] = out( (float)(acc[m, n] - 8 * asum[m]) * s_ch[n] * s_tok[m] )
// where acc = A_i8 · U (U = the stored offset codes q + 8, in [0, 15]) and
// asum[m] = sum_k A[m, k], both exact in int32; ``out`` rounds to bf16 (or
// stores f32).  The epilogue multiplies in the JAX kernel's order, so the
// result is bit-identical to the plain PyTorch version.
//
// What bounds it on the H100: at decode (M <= 8) the weight stream, K*N/2
// bytes at 3.35 TB/s (6.7 us for K=4096, N=11008); at prefill the int8
// products, which this first kernel runs on the CUDA cores (__dp4a, 4 MACs
// per instruction), far below the int8 tensor-core rate.
//
// Design: the nibble-plane packing (core/packing.py) maps onto __dp4a with
// no re-tiling.  Word row 16b+r of column n holds, in its low nibbles, the
// codes k = 128b+4r+{0..3} and, in its high nibbles, k = 128b+64+4r+{0..3};
// so (w & 0x0F0F0F0F) and ((w >> 4) & 0x0F0F0F0F) are each four unsigned
// codes, one __dp4a against one aligned int32 word of A.  A block owns 32
// columns, one per lane, so every weight load is one coalesced 128-byte row.
// Its 8 warps split the 128-row K blocks among themselves (a decode GEMM
// still has 8 * N/32 warps of weight loads in flight over 132 SMs) and sum
// their partial products through shared memory.  Rows of A are read as
// 16-byte vectors that all lanes of a warp share (an L1 broadcast).  Each
// thread keeps BM rows of accumulators, so a weight word loaded once serves
// BM rows.  The mma.sync / wgmma s8 tensor-core path is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 32;
constexpr unsigned kNib = 0x0F0F0F0Fu;

template <int BM, bool kBf16Out>
__global__ void __launch_bounds__(kWarps * 32)
w4a8_channel_kernel(const int8_t* __restrict__ a,
                    const float* __restrict__ s_tok,
                    const int32_t* __restrict__ w,
                    const float* __restrict__ s_ch,
                    void* __restrict__ out, int M, int K, int N) {
  __shared__ int red[kWarps][BM][kCols];
  __shared__ int asum[BM];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * BM;
  const int KB = K / 128;
  if (threadIdx.x < BM) asum[threadIdx.x] = 0;

  int acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0;

  if (n < N) {
    for (int kb = warp; kb < KB; kb += kWarps) {
      unsigned wv[16];
      const int32_t* wp = w + (size_t)kb * 16 * N + n;
#pragma unroll
      for (int r = 0; r < 16; ++r) wv[r] = (unsigned)__ldg(wp + (size_t)r * N);
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (m0 + i < M) {
          const int4* ap = reinterpret_cast<const int4*>(
              a + (size_t)(m0 + i) * K + (size_t)kb * 128);
          int av[32];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int4 v = __ldg(ap + j);
            av[4 * j + 0] = v.x;
            av[4 * j + 1] = v.y;
            av[4 * j + 2] = v.z;
            av[4 * j + 3] = v.w;
          }
          int s = acc[i];
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            s = __dp4a((int)(wv[r] & kNib), av[r], s);
            s = __dp4a((int)((wv[r] >> 4) & kNib), av[16 + r], s);
          }
          acc[i] = s;
        }
      }
    }
  }
  __syncthreads();  // asum zeroed before the atomics below

  // full-row sums of A for this block's rows (exact in any order)
  const int K4 = K / 4;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    if (m0 + i < M) {
      const int* ar = reinterpret_cast<const int*>(a + (size_t)(m0 + i) * K);
      int s = 0;
      for (int j = threadIdx.x; j < K4; j += blockDim.x)
        s = __dp4a(__ldg(ar + j), 0x01010101, s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) atomicAdd(&asum[i], s);
    }
  }
#pragma unroll
  for (int i = 0; i < BM; ++i) red[warp][i][lane] = acc[i];
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * kCols; idx += blockDim.x) {
    const int i = idx / kCols;
    const int c = idx % kCols;
    const int m = m0 + i;
    const int nn = blockIdx.x * kCols + c;
    if (m < M && nn < N) {
      int tot = 0;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) tot += red[q][i][c];
      const int corr = tot - 8 * asum[i];  // undo the +8 code offset
      float v = (float)corr * s_ch[nn];
      v = v * s_tok[m];
      if (kBf16Out)
        reinterpret_cast<__nv_bfloat16*>(out)[(size_t)m * N + nn] =
            __float2bfloat16_rn(v);
      else
        reinterpret_cast<float*>(out)[(size_t)m * N + nn] = v;
    }
  }
}

template <int BM>
void launch(const int8_t* a, const float* s_tok, const int32_t* w,
            const float* s_ch, void* out, int M, int K, int N, int bf16_out,
            cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
  if (bf16_out)
    w4a8_channel_kernel<BM, true>
        <<<grid, kWarps * 32, 0, st>>>(a, s_tok, w, s_ch, out, M, K, N);
  else
    w4a8_channel_kernel<BM, false>
        <<<grid, kWarps * 32, 0, st>>>(a, s_tok, w, s_ch, out, M, K, N);
}

}  // namespace

// a (M, K) int8, s_tok (M,) f32, w (K/8, N) int32, s_ch (N,) f32,
// out (M, N) bf16 (bf16_out = 1) or f32.  K % 128 == 0; a 16-byte aligned.
extern "C" int w4a8_gemm_channel(const void* a, const void* s_tok,
                                 const void* w, const void* s_ch, void* out,
                                 int M, int K, int N, int bf16_out,
                                 void* stream) {
  auto A = static_cast<const int8_t*>(a);
  auto ST = static_cast<const float*>(s_tok);
  auto W = static_cast<const int32_t*>(w);
  auto SC = static_cast<const float*>(s_ch);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 1)
    launch<1>(A, ST, W, SC, out, M, K, N, bf16_out, st);
  else if (M <= 2)
    launch<2>(A, ST, W, SC, out, M, K, N, bf16_out, st);
  else if (M <= 4)
    launch<4>(A, ST, W, SC, out, M, K, N, bf16_out, st);
  else if (M < 64)
    launch<8>(A, ST, W, SC, out, M, K, N, bf16_out, st);
  else
    launch<16>(A, ST, W, SC, out, M, K, N, bf16_out, st);
  return (int)cudaGetLastError();
}
