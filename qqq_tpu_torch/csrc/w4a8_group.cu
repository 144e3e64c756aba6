// g128 W4A8 GEMM, exact route, for Hopper (sm_90a): one exact int32 dot per
// 128-row group, scaled and summed in f32 group by group; plain (the weight
// stream kernel) and with the fused GLU epilogue.
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
// w4a8_matmul_reference): both kernels are bit-identical to the plain
// version, the GLU one up to expf.  So K is never split across blocks or
// warps in an order the chain would not take: every (row, column) has one
// owner thread that adds its groups in order.
//
// What bounds it on the H100: this route serves decode and short prefill,
// where the weight stream bounds it: K·N/2 bytes of codes plus K/128·N·2
// bytes of bf16 scales (7.0 us for K = 11008, N = 4096 at 3.35 TB/s).
//
// The weight stream kernel (stream::kernel, the plain route) is the TMA
// ring and int8 mma.sync dot of w4a8_stream.cuh, 32 columns and 16 rows a
// block, 4 stages of 8 groups.  Consumer warp w writes the int32 terms d_g −
// 8·bsum_g of group w of each stage to shared memory; after a barrier of
// the consumer warps, the thread that owns a (row, column) adds the stage's
// f32 terms to its running sum in group order.  Besides the stream, the
// consumers' shared-memory traffic sets the pace, so A is read once per
// group (not per slice) and the terms are kept at two words a lane when the
// block has at most 8 rows.  On the H100 (chip_smoke.py, PERF.md) it runs
// at ~2.5x its byte bound at (4, 11008, 4096), and with the math taken out
// the stream alone takes most of that time: the TMA stream of 128-byte
// rows, at one block per column tile, is the next lever.  The GLU variant
// would stream two boxes a stage, as the per-channel GLU does
// (stream::channel_kernel), and keep this kernel's f32 chain; it is still
// the older kernel below.
//
// The GLU kernel (glu_kernel): 8 warps own 32 output columns, one per
// lane, and share out the K blocks; a K block is one group.  The warps take
// 8 consecutive groups at a time, one each, and write each group's f32
// term for their BM rows to shared memory; after a barrier the block adds
// the 8 terms to the running sums in group order.  bsum_g comes from the
// same A words through __dp4a against 0x01010101.

#include "w4a8_stream.cuh"

namespace {

using namespace w4a8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

namespace stream {

constexpr int kStages = 4;  // ring depth
using L = Slot<1, true>;
constexpr int kEBytes = kGps * kSlices * 32 * 16;  // a stage's int32 terms
// alignment slack, the ring, two buffers of terms, and a full and an empty
// barrier a slot
constexpr int kSmem = 1024 + kStages * L::kBytes + 2 * kEBytes +
                      2 * kStages * 8;

// The int32 terms d_g − 8·bsum_g of group gi of a landed stage (its dot by
// group_mma), written to terms: per slice and lane {row q: columns 2t,
// 2t + 1; row q + 8: the same}, only row q's when `two` is false (the
// block has at most 8 rows).
__device__ __forceinline__ void dots(const char* slot, int gi, bool two,
                                     int* terms) {
  const int lane = threadIdx.x & 31;
  int d[kSlices][4];
#pragma unroll
  for (int s = 0; s < kSlices; ++s) d[s][0] = d[s][1] = d[s][2] = d[s][3] = 0;
  int bs, bs8;
  group_mma<kSlices>(slot, slot + L::kA, gi, two, d, bs, bs8);
#pragma unroll
  for (int s = 0; s < kSlices; ++s) {
    const int at = (gi * kSlices + s) * 32 + lane;
    if (two)
      reinterpret_cast<int4*>(terms)[at] =
          make_int4(d[s][0] - 8 * bs, d[s][1] - 8 * bs, d[s][2] - 8 * bs8,
                    d[s][3] - 8 * bs8);
    else
      reinterpret_cast<int2*>(terms)[at] =
          make_int2(d[s][0] - 8 * bs, d[s][1] - 8 * bs);
  }
}

// The (row, column) pairs of the tile a thread adds up: pair p = tid + j ·
// kThreads is int32 term `comp` of lane `le` of slice p / (32 · nc) of a
// stage's terms (nc = 4 terms a lane, or 2 when `two` is false), so that a
// warp reads consecutive words: one pair a thread for up to 8 rows, two
// for 16.
struct Pair {
  int slice, le, comp, row, col, at;
  __device__ Pair(int p, bool two) {
    const int lc = two ? 2 : 1;  // log2 of the terms a lane
    slice = p >> (5 + lc);
    le = (p >> lc) & 31;
    comp = p & ((1 << lc) - 1);
    row = (le >> 2) + 8 * (comp >> 1);
    col = slice * 8 + 2 * (le & 3) + (comp & 1);
    at = ((slice * 32 + le) << lc) + comp;
  }
};
constexpr int kPairs = kRows * kTile / kThreads;  // pairs a thread at most

template <bool kSgBf16, bool kBf16Out>
__global__ void __launch_bounds__(kThreads + 32)
kernel(const __grid_constant__ Maps maps, Args p) {
  using S = typename std::conditional<kSgBf16, __nv_bfloat16, float>::type;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  smem += (1024 - smem_addr(smem) % 1024) % 1024;
  int* terms = reinterpret_cast<int*>(smem + kStages * L::kBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * L::kBytes +
                                               2 * kEBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kTile;
  const int rows = min(kRows, p.M - m0);
  const int G = p.K / 128;
  const int nst = (G + kGps - 1) / kGps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 65);  // see issue()
      mbar_init(empty + s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer warp
    const int wc[1] = {n0};
    for (int st = 0; st < nst; ++st) {
      const int s = st % kStages;
      if (st >= kStages) mbar_wait(empty + s, (st / kStages - 1) & 1);
      issue<1, true, kSgBf16>(smem + s * L::kBytes, full + s, p, maps, st, G,
                              wc, m0, rows, lane);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const bool two = rows > 8;
  const int pairs = two ? kPairs : 1;
  const int gstride = kSlices * 32 * (two ? 4 : 2);  // terms a group
  float facc[kPairs];
  bool live[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    facc[j] = 0.f;
    const Pair pr(threadIdx.x + j * kThreads, two);
    live[j] = j < pairs && pr.row < rows && n0 + pr.col < p.N;
  }
  for (int st = 0; st < nst; ++st) {
    const int s = st % kStages;
    mbar_wait(full + s, (st / kStages) & 1);
    const char* slot = smem + s * L::kBytes;
    int* tb = terms + (st & 1) * (kEBytes / 4);
    // the stage's dots, group `warp` (a group past G holds zeros or a
    // stale slot and is never added)
    dots(slot, warp, two, tb);
    // the consumer warps' terms are all written (the producer goes on)
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    // then each pair's f32 terms in group order, loads first
    const int ng = min(kGps, G - st * kGps);
    const S* sgs = reinterpret_cast<const S*>(slot + L::kS);
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      if (!live[j]) continue;
      const Pair pr(threadIdx.x + j * kThreads, two);
      int e[kGps];
      float sc[kGps];
#pragma unroll
      for (int gi = 0; gi < kGps; ++gi)
        if (gi < ng) {
          e[gi] = tb[gi * gstride + pr.at];
          sc[gi] = to_f(sgs[gi * kTile + pr.col]);
        }
#pragma unroll
      for (int gi = 0; gi < kGps; ++gi)
        if (gi < ng)
          facc[j] = __fadd_rn(facc[j], __fmul_rn((float)e[gi], sc[gi]));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp is done with slot s
  }

#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    if (!live[j]) continue;
    const Pair pr(threadIdx.x + j * kThreads, two);
    const int m = m0 + pr.row;
    store<kBf16Out>(p.out, (size_t)m * p.N + n0 + pr.col,
                    __fmul_rn(facc[j], p.s_tok[m]));
  }
}

template <bool kSgBf16, bool kBf16Out>
int launch(Args p, cudaStream_t st) {
  auto k = kernel<kSgBf16, kBf16Out>;
  const int err = opt_in(k, kSmem);
  if (err != 0) return err;
  // the TMA unit takes 16-byte aligned bases and row strides
  constexpr int es = kSgBf16 ? 2 : 4;
  Maps maps;
  p.tma = (uintptr_t)p.sg % 16 == 0 && (1LL * es * p.N) % 16 == 0 &&
          map_codes_and_a(&maps, p) &&
          map2d(&maps.s,
                kSgBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                es, p.sg, p.K / 128, p.N, kGps, kTile, false);
  const dim3 grid((p.M + kRows - 1) / kRows, (p.N + kTile - 1) / kTile);
  k<<<grid, kThreads + 32, kSmem, st>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace stream

template <bool kSgBf16>
__device__ __forceinline__ float group_scale(const void* sg, size_t idx) {
  if (kSgBf16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(sg)[idx]);
  return __ldg(reinterpret_cast<const float*>(sg) + idx);
}

template <int BM, bool kSgBf16, bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
glu_kernel(const int8_t* __restrict__ a, const float* __restrict__ s_tok,
           const int32_t* __restrict__ w, const void* __restrict__ s_group,
           void* __restrict__ out, int M, int K, int Nw) {
  constexpr int NS = 2;  // gate, up
  constexpr int R = (BM * kCols + kThreads - 1) / kThreads;  // sums per thread
  __shared__ float term[kWarps][NS][BM][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int No = Nw / 2;
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
        const int col = weight_col<true>(o, s);
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
        store<kBf16Out>(out, (size_t)m * No + oo, silu_mul(v[0], v[1]));
      }
    }
  }
}

template <bool kSgBf16, bool kBf16Out>
void launch_glu(int BM, const int8_t* a, const float* s_tok, const int32_t* w,
                const void* sg, void* out, int M, int K, int Nw,
                cudaStream_t st) {
#define GLU_LAUNCH(bm)                                                \
  glu_kernel<bm, kSgBf16, kBf16Out>                                    \
      <<<grid_for(M, Nw / 2, bm), kThreads, 0, st>>>(a, s_tok, w, sg, \
                                                     out, M, K, Nw)
  switch (BM) {
    case 1: GLU_LAUNCH(1); break;
    case 2: GLU_LAUNCH(2); break;
    case 4: GLU_LAUNCH(4); break;
    case 8: GLU_LAUNCH(8); break;
    default: GLU_LAUNCH(16); break;
  }
#undef GLU_LAUNCH
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
  if (glu) {
    const int bm = rows_per_block(M);
#define GLU_SG(SG_)                                                       \
  (bf16_out ? launch_glu<SG_, true>(bm, A, ST, W, s_group, out, M, K, N, \
                                    st)                                  \
            : launch_glu<SG_, false>(bm, A, ST, W, s_group, out, M, K, N, \
                                     st))
    if (sg_bf16)
      GLU_SG(true);
    else
      GLU_SG(false);
#undef GLU_SG
    return (int)cudaGetLastError();
  }
  const stream::Args p{A, ST, W, s_group, out, M, K, N, false};
  if (sg_bf16)
    return bf16_out ? stream::launch<true, true>(p, st)
                    : stream::launch<true, false>(p, st);
  return bf16_out ? stream::launch<false, true>(p, st)
                  : stream::launch<false, false>(p, st);
}
