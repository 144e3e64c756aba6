// W4A8 GEMM with the per-token activation quantization fused into the
// prologue, per channel and g128 exact, for Hopper (sm_90a).
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
// of codes (plus K / 128 * N * 2 of bf16 group scales) at 3.35 TB/s (7.0 us
// at K = 11008, N = 4096); the x rows add M * K * 2 bytes.
//
// Design: both are kernels of the weight stream (w4a8_stream.cuh), whose
// producer streams raw x in place of int8 A: a TMA box a group of the
// block's 8 (bf16) or 4 (f32) rows of 128 values, 2 KB, the size of the
// slot's A tile, so the slots and the rings stay those of the unfused
// kernels.  Their source of A, QuantizedX, takes the block's row scales
// s[m] (and their reciprocals) from one pass over its rows of x, L2-resident
// after the first column block, while the producer fills the ring.  Each
// stage, consumer warp w reads its group's x from the tile, quantizes it
// four values a lane and row (every lane busy at any row count), writes the
// codes over the tile in the TMA unit's swizzle, and runs the unfused
// kernel's MMAs on it; the group's row sums come from the same fragments.
// The quotients come from the row's correctly rounded reciprocal and two
// FMA corrections (div_rn: the IEEE quotient).  On the H100 that takes #5
// at (4, 11008, 4096) from 0.035 ms with __fdiv_rn alone to 0.030, and at
// (64, 11008, 4096) from 0.34–0.36 to 0.255 (PERF.md §6).
//   - g128 (stream::fused_kernel): the exact g128 route's group_gemm, as
//     w4a8_group.cu's stream::kernel (#2).
//   - per channel (stream::channel_kernel<false, ·, QuantizedX<TX>>): the
//     per-channel route's decode body (#1's, w4a8_gemm.cu), int32 sums in
//     registers across all K and one epilogue in #4's order.
// Bring-up showed why x rides with the stage: loaded by the consumers a
// stage ahead, x queued behind the ring's TMA traffic and doubled the time.
// Whole rows of A could not be staged beside the ring (16 x 24576 bytes is
// 393 KB), and need not be: the stream has no limit on K.  Every column
// block quantizes its rows again, as every n-tile of the JAX kernel does;
// past one block of rows (M > 8 for bf16 x) each block streams the codes
// again, from L2.

#include "w4a8_stream.cuh"

namespace {

// 16 bytes of x as floats, N of them (8 bf16 or 4 f32), converted from the
// raw bytes (cvt); and four values from their Quad of raw bytes (8 bf16 or
// 16 f32 bytes).
template <typename TX>
struct XVec;

template <>
struct XVec<float> {
  static constexpr int N = 4;
  using Quad = int4;
  __device__ static void cvt(const int4& r, float v[4]) {
    v[0] = __int_as_float(r.x);
    v[1] = __int_as_float(r.y);
    v[2] = __int_as_float(r.z);
    v[3] = __int_as_float(r.w);
  }
};

template <>
struct XVec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Quad = uint2;
  __device__ static void cvt(const uint2& r, float v[4]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    v[0] = f0.x;
    v[1] = f0.y;
    v[2] = f1.x;
    v[3] = f1.y;
  }
  __device__ static void cvt(const int4& r, float v[8]) {
    cvt(make_uint2(r.x, r.y), v);
    cvt(make_uint2(r.z, r.w), v + 4);
  }
};

// The quotient q = x / s rounded half to even and clipped to int8, as a
// byte: the JAX kernels' order (divide, round, then clip).
__device__ __forceinline__ unsigned code_byte(float q) {
  const float r = fminf(fmaxf(rintf(q), -128.f), 127.f);
  return (unsigned)(int)r & 0xFFu;
}
__device__ __forceinline__ unsigned quant_byte(float v, float s) {
  return code_byte(__fdiv_rn(v, s));
}

// x / s as the IEEE division rounds it, from rc = RN(1/s) (__frcp_rn): q =
// x·rc, then twice q += (x − s·q)·rc, each residual exact in an FMA.  The
// first correction brings q within an ulp of x / s; from there the second
// gives the correctly rounded quotient (Markstein's theorem) wherever the
// residual does not underflow, which holds for every x with |x / s| >= 1/4
// when s >= 2^-100; below that |x / s| rounds to code 0 either way.  The
// callers take __fdiv_rn for a row whose s is smaller.  Five FP operations
// against __fdiv_rn's checked sequence, whose slow path zeros also take.
__device__ __forceinline__ float div_rn(float x, float s, float rc) {
  float q = __fmul_rn(x, rc);
  q = __fmaf_rn(__fmaf_rn(-s, q, x), rc, q);
  return __fmaf_rn(__fmaf_rn(-s, q, x), rc, q);
}
constexpr float kDivRnMinS = 0x1p-100f;  // div_rn's smallest divisor

namespace stream {

// A of the fused kernels (a source of A, w4a8_stream.cuh:StreamedA): the
// producer streams the block's rows of x into the A tiles
// (block_rows(sizeof(TX)) rows of 128 values a group, 2 KB: the tile's
// size), and each consumer warp quantizes its group's tile in place.
// begin() takes the block's row scales (and their reciprocals) from one
// pass over its rows of x, each thread keeping 16 of its 16-byte loads in
// flight, while the producer fills the ring.  frags() reads this lane's
// four values of each row (k = 4·lane ..), and, once the warp has read them
// all, writes their codes over the tile in the TMA unit's swizzle (one word
// a lane and row: all 32 lanes busy at any row count); then reads the
// fragments back as a streamed tile is read.  Rows of the tile past the
// block's feed only outputs that are never stored.
template <typename TX>
struct QuantizedX {
  static constexpr int kAEs = sizeof(TX);
  static constexpr int kBR = block_rows(kAEs);  // rows a block
  const TX* x;
  int K, m0, rows;
  float* s_sh;  // [2][kRows] the rows' scales, then their reciprocals
  float* red;   // [kWarps][kRows] the warps' partial maxima

  __device__ explicit QuantizedX(const Args& p)
      : x(static_cast<const TX*>(p.a)), K(p.K) {
    __shared__ float sh[(2 + kWarps) * kRows];
    s_sh = sh;
    red = sh + 2 * kRows;
  }

  // amax[i] = max |x| over this thread's share of row m0 + i, i < rows <=
  // R, U vectors of each row in flight
  template <int R, int U>
  __device__ void row_max(float (&amax)[kBR]) const {
    constexpr int V = XVec<TX>::N;
    const int nv = K / V;
    for (int j0 = threadIdx.x; j0 < nv; j0 += U * kThreads) {
      int4 r[R][U];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i < rows && j0 + u * kThreads < nv)
            r[i][u] = __ldg(reinterpret_cast<const int4*>(
                                x + (size_t)(m0 + i) * K) + j0 + u * kThreads);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i < rows && j0 + u * kThreads < nv) {
            float v[V];
            XVec<TX>::cvt(r[i][u], v);
#pragma unroll
            for (int e = 0; e < V; ++e) amax[i] = fmaxf(amax[i], fabsf(v[e]));
          }
    }
  }

  __device__ void begin(int m0_, int rows_) {
    m0 = m0_;
    rows = rows_;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float amax[kBR];
#pragma unroll
    for (int i = 0; i < kBR; ++i) amax[i] = 0.f;
    if (rows <= 1)
      row_max<1, 16>(amax);
    else if (rows <= 2)
      row_max<2, 8>(amax);
    else if (rows <= 4)
      row_max<4, 4>(amax);
    else
      row_max<kBR, 16 / kBR>(amax);
#pragma unroll
    for (int i = 0; i < kBR; ++i) {
      float a = amax[i];
      for (int o = 16; o > 0; o >>= 1)
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      if (lane == 0) red[warp * kRows + i] = a;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    if (threadIdx.x < rows) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        a = fmaxf(a, red[w * kRows + threadIdx.x]);
      const float s = __fdiv_rn(fmaxf(a, 1e-30f), 127.0f);
      s_sh[threadIdx.x] = s;
      s_sh[kRows + threadIdx.x] = __frcp_rn(s);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  }

  __device__ void frags(char* ab, int gi, bool two, uint2 (&a)[4],
                        uint2 (&a8)[4]) const {
    const int lane = threadIdx.x & 31;
    char* tile = ab + gi * kRows * 128;
    float v[kBR][4];
#pragma unroll
    for (int r = 0; r < kBR; ++r)
      if (r < rows)
        XVec<TX>::cvt(*reinterpret_cast<const typename XVec<TX>::Quad*>(
                          tile + r * 128 * kAEs + 4 * kAEs * lane),
                      v[r]);
    __syncwarp();  // the tile's x is read before its codes overwrite it
#pragma unroll
    for (int r = 0; r < kBR; ++r)
      if (r < rows) {
        const float s = s_sh[r], rc = s_sh[kRows + r];
        unsigned word = 0;
        if (s >= kDivRnMinS)  // the same for the whole warp
#pragma unroll
          for (int u = 0; u < 4; ++u)
            word |= code_byte(div_rn(v[r][u], s, rc)) << (8 * u);
        else
#pragma unroll
          for (int u = 0; u < 4; ++u) word |= quant_byte(v[r][u], s) << (8 * u);
        *reinterpret_cast<unsigned*>(tile + swz(r, 4 * lane)) = word;
      }
    __syncwarp();
    a_frags(ab, gi, two, a, a8);
  }

  __device__ float scale(int row, int) const { return s_sh[row]; }
};

template <typename TX, bool kSgBf16, bool kBf16Out>
__global__ void __launch_bounds__(kThreads + 32)
fused_kernel(const __grid_constant__ Maps maps, Args p) {
  QuantizedX<TX> src(p);
  group_gemm<1, kSgBf16, kBf16Out>(maps, p, src);
}

template <typename TX, bool kSgBf16>
int launch_fused(const Args& p, int bf16_out, cudaStream_t st) {
  constexpr int es = sizeof(TX);
  return bf16_out ? launch_group<1, es, kSgBf16>(
                        fused_kernel<TX, kSgBf16, true>, p, st)
                  : launch_group<1, es, kSgBf16>(
                        fused_kernel<TX, kSgBf16, false>, p, st);
}

template <typename TX>
int launch_fused_channel(const Args& p, int bf16_out, cudaStream_t st) {
  return bf16_out ? launch_channel<false, true, QuantizedX<TX>>(p, st)
                  : launch_channel<false, false, QuantizedX<TX>>(p, st);
}

}  // namespace stream

}  // namespace

// x (M, K) bf16 (x_bf16 = 1) or f32, 16-byte aligned; w (K/8, N) int32;
// scales: s_channel (N,) f32 (group = 0) or s_group (K/128, N) bf16
// (sg_bf16 = 1) or f32 (group = 1); out (M, N) bf16 (bf16_out = 1) or f32.
// K % 128 == 0 (else cudaErrorInvalidValue); any K, M and N past that.
extern "C" int w4a8_gemm_fused(const void* x, const void* w,
                               const void* scales, void* out, int M, int K,
                               int N, int group, int x_bf16, int sg_bf16,
                               int bf16_out, void* stream) {
  if (K % 128 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const stream::Args p{x,   nullptr, static_cast<const int32_t*>(w),
                       scales, out,  M, K, N, false};
  auto st = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (!group)
    return x_bf16 ? stream::launch_fused_channel<BF>(p, bf16_out, st)
                  : stream::launch_fused_channel<float>(p, bf16_out, st);
  if (x_bf16)
    return sg_bf16 ? stream::launch_fused<BF, true>(p, bf16_out, st)
                   : stream::launch_fused<BF, false>(p, bf16_out, st);
  return sg_bf16 ? stream::launch_fused<float, true>(p, bf16_out, st)
                 : stream::launch_fused<float, false>(p, bf16_out, st);
}
