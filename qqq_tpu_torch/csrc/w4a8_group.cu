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
// The weight stream kernel (stream::kernel, the plain route).  A block owns
// 32 output columns (one 128-byte segment of each packed word row, 128
// blocks at N = 4096) and 16 rows of A, and walks all K/128 groups through
// a ring of kStages shared-memory stages of kGps = 8 groups each.
//   - One producer warp fills the ring.  Its lane 0 asks the TMA unit for
//     three kinds of boxes a stage: the stage's 128 word rows of the
//     codes, a box of A per group and the stage's s_group rows (the entry
//     describes the three tensors in tensor maps; the unit zero-fills past
//     their edges).  A `full` mbarrier per slot counts their bytes, an
//     `empty` one the eight consumer warps that have released the slot, so
//     the copies run up to kStages stages (64 KiB of codes) ahead of the
//     math and never wait for it.  Where N or a pointer does not suit the
//     TMA unit, the producer lanes copy word by word into the same layout.
//   - Consumer warp w forms the int32 terms of group w of the stage for all
//     four n8 slices of the tile: four int8 mma.sync.m16n8k32 a slice (rows
//     8-15 zero when at most 8 rows of A remain; outputs of rows past M are
//     never stored).  Each packed word of a column holds four codes of the
//     group's low half in its low nibbles and the matching four of its
//     high half in its high nibbles, and the masked nibble planes (codes
//     0..15) are valid s8 B operands, so each word feeds two MMAs (the k
//     order inside an MMA is permuted alike on A and B, which leaves the
//     int32 dot exact).  bsum_g comes from the same A fragments by __dp4a
//     against 0x01010101 and two shuffles; d_g − 8·bsum_g goes to shared
//     memory.
//   - After a barrier of the consumer warps, the thread that owns a (row,
//     column) adds the stage's f32 terms to its running sum in group order.
// The codes and A sit in the TMA unit's 128-byte swizzle, which with the
// lanes' choice of word rows keeps the code loads free of bank conflicts.
// Besides the stream, the consumers' shared-memory traffic sets the pace,
// so A is read once per group (not per slice) and the terms are kept at
// two words a lane when the block has at most 8 rows.  On the H100
// (chip_smoke.py, PERF.md) it runs at ~2.5x its byte bound at (4, 11008,
// 4096), and with the math taken out the stream alone takes most of that
// time: the TMA stream of 128-byte rows, at one block per column tile, is
// the next lever.  The GLU variant would be this kernel with a tile of 32
// gate and 32 up columns (weight_col) and silu_mul in the epilogue; it is
// still the older kernel below.
//
// The GLU kernel (glu_kernel): 8 warps own 32 output columns, one per
// lane, and share out the K blocks; a K block is one group.  The warps take
// 8 consecutive groups at a time, one each, and write each group's f32
// term for their BM rows to shared memory; after a barrier the block adds
// the 8 terms to the running sums in group order.  bsum_g comes from the
// same A words through __dp4a against 0x01010101.

#include <cuda.h>

#include <mutex>
#include <type_traits>
#include <vector>

#include "smem_fit.cuh"
#include "w4a8_common.cuh"

namespace {

using namespace w4a8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

namespace stream {

constexpr int kWarps = 8;              // consumers; one more warp copies
constexpr int kThreads = kWarps * 32;  // consumer threads
constexpr int kSlices = 4;             // n8 slices of the tile
constexpr int kTile = 8 * kSlices;     // output columns a block
constexpr int kRows = 16;              // rows of A a block: one m16 tile
constexpr int kGps = 8;                // groups a stage
constexpr int kStages = 4;             // ring depth
// A slot: the stage's 16·kGps word rows of codes (kTile words, 128 bytes
// each), kGps tiles of A (kRows rows of 128 bytes) and kGps s_group rows
// (kTile elements, f32 room).  The codes and A are stored as the TMA
// unit's 128-byte swizzle stores them: 16-byte chunk c of 128-byte row r
// at chunk c ^ (r % 8); so slots start 1024-byte aligned.
constexpr int kWBytes = kGps * 16 * 128;
constexpr int kABytes = kGps * kRows * 128;
constexpr int kSBytes = kGps * kTile * 4;
constexpr int kSlot = kWBytes + kABytes + kSBytes;
constexpr int kEBytes = kGps * kSlices * 32 * 16;  // a stage's int32 terms
// alignment slack, the ring, two buffers of terms, and a full and an empty
// barrier a slot
constexpr int kSmem = 1024 + kStages * kSlot + 2 * kEBytes + 2 * kStages * 8;
static_assert(kGps == kWarps, "a consumer warp a group of a stage");
static_assert(kSlot % 1024 == 0, "1024-byte aligned slots");

// byte offset of byte b of 128-byte row r in the 128-byte swizzle
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + (b ^ ((r & 7) << 4));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4 bytes from src
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// The box of tensor map `map` at (x, y) (inner coordinate first) by the TMA
// unit; its landing counts against bar's expected transaction bytes.
__device__ __forceinline__ void tma2d(void* dst, const CUtensorMap* map,
                                      int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// an arrival that also expects `bytes` more transaction bytes
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// arrives on bar once every cp.async this thread has issued has landed
__device__ __forceinline__ void mbar_arrive_cp(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// returns once the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// d (16 x 8 s32) += a (16 x 32 s8) . b (32 x 8 s8)
__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The operands of one call.  With `tma`, the entry has described the
// codes, A and s_group to the TMA unit (maps below); else (N or a pointer
// the TMA unit cannot take) the producer lanes copy them a word at a time
// (bf16 s_group: an element at a time, by plain loads).
struct Args {
  const int8_t* a;
  const float* s_tok;
  const int32_t* w;
  const void* sg;
  void* out;
  int M, K, N;
  bool tma;
};
// the codes (K/8 x N int32, boxes of 16·kGps x kTile), A (M x K int8,
// boxes of kRows x 128) and s_group (K/128 x N, boxes of kGps x kTile)
struct Maps {
  CUtensorMap w, a, s;
};

// Rows of A in a TMA box: 8 when the call has at most 8 rows.
__host__ __device__ inline int a_box_rows(int M) { return M <= 8 ? 8 : kRows; }

// The producer warp's copies of stage st (groups st·kGps ..) into ring slot
// `slot`, all counted on `full`.  Lane 0 arrives stating the stage's TMA
// bytes before any copy starts (the unit writes whole boxes, zeros past
// the tensors' edges); every lane then arrives once after its plain stores
// and once more when its cp.async copies have landed, so `full` counts 65
// arrivals and the TMA bytes.
template <bool kSgBf16>
__device__ __forceinline__ void issue(char* slot, uint64_t* full,
                                      const Args& p, const Maps& maps,
                                      int st, int G, int n0, int m0,
                                      int rows, int lane) {
  const int g0 = st * kGps;
  char* ws = slot;
  char* ab = slot + kWBytes;
  char* sb = slot + kWBytes + kABytes;
  constexpr int es = kSgBf16 ? 2 : 4;
  if (p.tma) {
    if (lane == 0) {
      mbar_arrive_tx(full, kWBytes + kGps * a_box_rows(p.M) * 128 +
                               kGps * kTile * es);
      tma2d(ws, &maps.w, n0, g0 * 16, full);
      for (int gi = 0; gi < kGps; ++gi)
        tma2d(ab + gi * kRows * 128, &maps.a, (g0 + gi) * 128, m0, full);
      tma2d(sb, &maps.s, n0, g0, full);
    }
  } else {
    if (lane == 0) mbar_arrive(full);
    const int ng = min(kGps, G - g0);
    const int cols = min(kTile, p.N - n0);
    for (int i = lane; i < 16 * ng * kTile; i += 32) {
      const int r = i / kTile, c = i % kTile;
      if (c < cols)
        cp4(ws + swz(r, 4 * c), p.w + (size_t)(g0 * 16 + r) * p.N + n0 + c);
    }
    for (int i = lane; i < ng * rows * 32; i += 32) {
      const int gi = i / (rows * 32), q = (i / 32) % rows, c = i % 32;
      cp4(ab + gi * kRows * 128 + swz(q, 4 * c),
          p.a + (size_t)(m0 + q) * p.K + (size_t)(g0 + gi) * 128 + 4 * c);
    }
    for (int i = lane; i < ng * kTile; i += 32) {
      const int gi = i / kTile, c = i % kTile;
      if (c >= cols) continue;
      const size_t src = (size_t)(g0 + gi) * p.N + n0 + c;
      if (kSgBf16)  // 2-byte elements: no cp.async this small
        reinterpret_cast<__nv_bfloat16*>(sb)[gi * kTile + c] =
            static_cast<const __nv_bfloat16*>(p.sg)[src];
      else
        cp4(reinterpret_cast<float*>(sb) + gi * kTile + c,
            static_cast<const float*>(p.sg) + src);
    }
  }
  mbar_arrive(full);
  mbar_arrive_cp(full);
}

// The int32 terms of group gi of a landed stage, for all kSlices n8 slices
// of the tile: this lane's d_g by four MMAs a slice, less 8·bsum_g of its
// rows q and q + 8 ({row q: columns 2t, 2t + 1; row q + 8: the same} of
// each slice), written to terms (only row q's when `two` is false: the
// block has at most 8 rows).  Lane (q, t) reads word rows 2t, 2t + 1, 8 +
// 2t and 9 + 2t of column 8·slice + q: their low nibbles are the codes k =
// 8t .. 8t + 7 and 32 + 8t .., their high nibbles the same + 64, which
// match the A bytes it reads; in the swizzle the four t of a load fall in
// four different bank octets.  The slices' MMAs are interleaved step by
// step, so that their latencies overlap, and A is read once for all four.
__device__ __forceinline__ void dots(const char* slot, int gi, bool two,
                                     int* terms) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3, q = lane >> 2;
  uint2 a[4], a8[4];  // rows q and q + 8: k = 8t, 32 + 8t, 64 + 8t, 96 + 8t
  const char* ar = slot + kWBytes + gi * kRows * 128;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    a[h] = *reinterpret_cast<const uint2*>(ar + swz(q, 32 * h + 8 * t));
    a8[h] = two ? *reinterpret_cast<const uint2*>(
                      ar + swz(q + 8, 32 * h + 8 * t))
                : make_uint2(0, 0);
  }
  unsigned wd[kSlices][4];
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wd[s][i] = *reinterpret_cast<const unsigned*>(
          slot + swz(gi * 16 + 2 * t + (i & 1) + 8 * (i >> 1),
                     4 * (8 * s + q)));
  int d[kSlices][4];
#pragma unroll
  for (int s = 0; s < kSlices; ++s) d[s][0] = d[s][1] = d[s][2] = d[s][3] = 0;
  // steps: k = 8t .. (words 2t, 2t + 1), 32 + 8t .. (8 + 2t, 9 + 2t), then
  // the same in the high nibbles
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      const int sh = 4 * (h >> 1), i0 = 2 * (h & 1);
      mma_s8(d[s], a[h].x, a8[h].x, a[h].y, a8[h].y,
             (wd[s][i0] >> sh) & kNib, (wd[s][i0 + 1] >> sh) & kNib);
    }
  // bsum: this lane's 32 bytes of each row, then the quad's
  int bs = 0, bs8 = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    bs = __dp4a((int)a[h].x, 0x01010101, bs);
    bs = __dp4a((int)a[h].y, 0x01010101, bs);
    bs8 = __dp4a((int)a8[h].x, 0x01010101, bs8);
    bs8 = __dp4a((int)a8[h].y, 0x01010101, bs8);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    bs += __shfl_xor_sync(0xffffffffu, bs, o);
    bs8 += __shfl_xor_sync(0xffffffffu, bs8, o);
  }
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
  int* terms = reinterpret_cast<int*>(smem + kStages * kSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kSlot +
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
    for (int st = 0; st < nst; ++st) {
      const int s = st % kStages;
      if (st >= kStages) mbar_wait(empty + s, (st / kStages - 1) & 1);
      issue<kSgBf16>(smem + s * kSlot, full + s, p, maps, st, G, n0, m0,
                     rows, lane);
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
    const char* slot = smem + s * kSlot;
    int* tb = terms + (st & 1) * (kEBytes / 4);
    // the stage's dots, group `warp` (a group past G holds zeros or a
    // stale slot and is never added)
    dots(slot, warp, two, tb);
    // the consumer warps' terms are all written (the producer goes on)
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    // then each pair's f32 terms in group order, loads first
    const int ng = min(kGps, G - st * kGps);
    const S* sgs = reinterpret_cast<const S*>(slot + kWBytes + kABytes);
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

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// the driver library), looked up once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A 2-D map of a row-major (rows, cols) tensor of `es`-byte elements, boxes
// of (box_rows, box_cols); false if the driver refuses it.
bool map2d(CUtensorMap* m, CUtensorMapDataType type, int es, const void* p,
           long long rows, long long cols, int box_rows, int box_cols,
           bool swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * es};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  return enc(m, type, 2, const_cast<void*>(p), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opts `kernel` in to kSmem bytes of dynamic shared memory once per
// device: the decode calls this route five times a layer every tick.
template <typename Kernel>
int opt_in(Kernel kernel) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == fn && d.second == dev) return 0;
  const int err = smem_fit(kernel, kSmem);
  if (err == 0) done.emplace_back(fn, dev);
  return err;
}

template <bool kSgBf16, bool kBf16Out>
int launch(Args p, cudaStream_t st) {
  auto k = kernel<kSgBf16, kBf16Out>;
  const int err = opt_in(k);
  if (err != 0) return err;
  // the TMA unit takes 16-byte aligned bases and row strides
  constexpr int es = kSgBf16 ? 2 : 4;
  Maps maps;
  p.tma = ((uintptr_t)p.w | (uintptr_t)p.sg | (uintptr_t)p.a) % 16 == 0 &&
          (4LL * p.N) % 16 == 0 && (1LL * es * p.N) % 16 == 0 &&
          map2d(&maps.w, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, p.w, p.K / 8, p.N,
                16 * kGps, kTile, true) &&
          map2d(&maps.a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.a, p.M, p.K,
                a_box_rows(p.M), 128, true) &&
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
