// The weight stream of the W4A8 GEMMs at decode and short prefill (sm_90a):
// a producer warp keeps TMA boxes of packed codes (and of A, and of the g128
// scales) in flight through a ring of shared-memory stages, and eight
// consumer warps form each 128-row group's exact int32 dot on int8
// mma.sync.  Two bodies share it, each over a source of A (StreamedA:
// int8 A streamed; w4a8_fused.cu's QuantizedX: raw activations x streamed
// into the A tiles, 8 rows of bf16 or 4 of f32 a block, which the consumers
// quantize in place with the rows' scales from a pass over x).  TPU kernels
// replaced: qqq_tpu/kernels/w4a8_gemm.py, lines as in each source's header.
//   - group_gemm, the exact g128 route: each group's int32 terms scaled by
//     s_group and summed in f32 in group order, after a barrier of the
//     consumer warps each stage, in three kernels:
//       stream::kernel (w4a8_group.cu, #2 _w4a8_group_kernel): one box of
//       32 columns a stage, StreamedA, a 4-stage ring;
//       stream::glu_kernel (w4a8_group.cu, #7 _w4a8_group_glu_kernel): two
//       boxes a stage, the 32 gate and the 32 up columns of 32 output
//       columns (weight_col), each with its own s_group rows, two f32
//       chains a (row, column) and silu_mul in the epilogue; a 3-stage
//       ring (two 50 KB slots and the doubled terms would not fit four);
//       stream::fused_kernel (w4a8_fused.cu, #5 _w4a8_fused_group_kernel):
//       #2's, from QuantizedX;
//   - channel_kernel, the per-channel route: the int32 sums stay in each
//     warp's registers across all K, the warps meet once in shared memory
//     at the end, and the epilogue out((float)(acc − 8·asum)·s_ch[n]·s[m])
//     runs once.  No scale box, no per-stage barrier.  Instantiated with
//     StreamedA for #1 and its GLU #6 (w4a8_gemm.cu, the decode regime;
//     the GLU tile streams two boxes a stage, as the g128 GLU does, and
//     applies silu_mul in the epilogue), and with QuantizedX for #4
//     (w4a8_fused.cu, _w4a8_fused_channel_kernel).
// What bounds them on the H100: the bytes of codes (K·N/2) and scales at
// 3.35 TB/s; PERF.md §6 has their times against that bound.
//
// A block owns 32 columns a box (one 128-byte segment of each packed word
// row) and block_rows(kAEs) rows of A (16 of int8 A, 8 or 4 of x), and
// walks all K/128 groups through the ring, kGps = 8 groups a stage; K has
// no limit.
//   - Lane 0 of the producer warp asks the TMA unit for the stage's boxes:
//     128 word rows of codes a box, a box of A (or of raw activations) per
//     group and (g128) the stage's s_group rows of each box (the entry
//     describes the tensors in tensor maps; the unit zero-fills past their
//     edges).  A `full` mbarrier per slot counts their bytes, an `empty`
//     one the eight consumer warps that have
//     released the slot, so the copies run up to a ring of stages ahead of
//     the math and never wait for it.  Where N or a pointer does not suit
//     the TMA unit, the producer lanes copy word by word into the same
//     layout.
//   - Consumer warp w takes group w of each stage, for all n8 slices of the
//     tile: four int8 mma.sync.m16n8k32 a slice (rows 8-15 zero when at most
//     8 rows of A remain; outputs of rows past M are never stored).  Each
//     packed word of a column holds four codes of the group's low half in
//     its low nibbles and the matching four of its high half in its high
//     nibbles, and the masked nibble planes (codes 0..15) are valid s8 B
//     operands, so each word feeds two MMAs (the k order inside an MMA is
//     permuted alike on A and B, which leaves the int32 dot exact).  The
//     group's row sums of A (for the −8 offset) come from the same A
//     fragments by __dp4a against 0x01010101 and two shuffles.
// The codes and A sit in the TMA unit's 128-byte swizzle, which with the
// lanes' choice of word rows keeps the code loads free of bank conflicts.

#pragma once

#include <cuda.h>

#include <mutex>
#include <type_traits>
#include <vector>

#include "smem_fit.cuh"
#include "w4a8_common.cuh"

namespace {
namespace stream {

constexpr int kWarps = 8;              // consumers; one more warp copies
constexpr int kThreads = kWarps * 32;  // consumer threads
constexpr int kSlices = 4;             // n8 slices of a box
constexpr int kTile = 8 * kSlices;     // columns of a box
constexpr int kRows = 16;              // rows of A a block: one m16 tile
constexpr int kGps = 8;                // groups a stage
static_assert(kGps == kWarps, "a consumer warp a group of a stage");
// A slot: NB boxes of the stage's 16·kGps word rows of codes (kTile words,
// 128 bytes each), kGps tiles of A (kRows rows of 128 bytes; streamed, or
// written by the consumer warp of each group where the consumers quantize
// x themselves) and, for g128 weights, the kGps s_group rows of each box's
// columns (kTile elements, f32 room, a box after box).  The codes and A
// are stored as the TMA unit's 128-byte swizzle stores them: 16-byte chunk
// c of 128-byte row r at chunk c ^ (r % 8); so slots start 1024-byte
// aligned.
constexpr int kWBytes = kGps * 16 * 128;
constexpr int kABytes = kGps * kRows * 128;
constexpr int kSBytes = kGps * kTile * 4;
template <int NB, bool kGroup>
struct Slot {
  static constexpr int kA = NB * kWBytes;  // after the boxes of codes
  static constexpr int kS = kA + kABytes;  // s_group rows
  static constexpr int kBytes = kS + (kGroup ? NB * kSBytes : 0);
  static_assert(kBytes % 1024 == 0, "1024-byte aligned slots");
};

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
// (bf16 s_group: an element at a time, by plain loads).  a: A (M, K) int8,
// or the raw activations x (M, K) bf16 or f32 of the fused kernel; sg:
// s_group (K/128, N) or s_channel (N,).
struct Args {
  const void* a;
  const float* s_tok;
  const int32_t* w;
  const void* sg;
  void* out;
  int M, K, N;
  bool tma;
};
// the codes (K/8 x N int32, boxes of 16·kGps x kTile), A (M x K int8,
// boxes of kRows x 128; or x, boxes of block_rows(es) x 128) and s_group
// (K/128 x N, boxes of kGps x kTile)
struct Maps {
  CUtensorMap w, a, s;
};

// Rows of A in a TMA box: 8 when the call has at most 8 rows.
__host__ __device__ inline int a_box_rows(int M) { return M <= 8 ? 8 : kRows; }
// Rows a block owns when the slot's A tiles (kRows x 128 bytes a group) are
// streamed as A (aes = 1 byte an element: kRows) or as raw activations of
// aes bytes an element (2 KB a group: 8 rows of bf16, 4 of f32).
__host__ __device__ constexpr int block_rows(int aes) {
  return aes == 1 ? kRows : 16 / aes;
}

// The producer warp's copies of stage st (groups st·kGps ..) into ring slot
// `slot`, all counted on `full`: NB boxes of codes, of the columns from
// wc[b] on, a tile of A per group (int8, swizzled; or, with kAEs > 1, the
// group's block_rows(kAEs) rows of raw activations, row-major) and, with
// kGroup, the s_group rows of each box's columns.  Lane 0 arrives stating
// the stage's TMA bytes before any copy starts (the unit writes whole
// boxes, zeros past the tensors' edges); every lane then arrives once after
// its plain stores and once more when its cp.async copies have landed, so
// `full` counts 65 arrivals and the TMA bytes.
template <int NB, bool kGroup, bool kSgBf16, int kAEs = 1>
__device__ __forceinline__ void issue(char* slot, uint64_t* full,
                                      const Args& p, const Maps& maps,
                                      int st, int G, const int (&wc)[NB],
                                      int m0, int rows, int lane) {
  using L = Slot<NB, kGroup>;
  const int g0 = st * kGps;
  char* ab = slot + L::kA;
  char* sb = slot + L::kS;
  constexpr int es = kSgBf16 ? 2 : 4;
  if (p.tma) {
    if (lane == 0) {
      mbar_arrive_tx(full, NB * kWBytes +
                               kGps * (kAEs == 1 ? a_box_rows(p.M) : 16) * 128 +
                               (kGroup ? NB * kGps * kTile * es : 0));
#pragma unroll
      for (int b = 0; b < NB; ++b)
        tma2d(slot + b * kWBytes, &maps.w, wc[b], g0 * 16, full);
      for (int gi = 0; gi < kGps; ++gi)
        tma2d(ab + gi * kRows * 128, &maps.a, (g0 + gi) * 128, m0, full);
      if (kGroup)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          tma2d(sb + b * kSBytes, &maps.s, wc[b], g0, full);
    }
  } else {
    if (lane == 0) mbar_arrive(full);
    const int ng = min(kGps, G - g0);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int cols = min(kTile, p.N - wc[b]);
      for (int i = lane; i < 16 * ng * kTile; i += 32) {
        const int r = i / kTile, c = i % kTile;
        if (c < cols)
          cp4(slot + b * kWBytes + swz(r, 4 * c),
              p.w + (size_t)(g0 * 16 + r) * p.N + wc[b] + c);
      }
    }
    // a row of a group is 32 words of int8 A (swizzled) or 32·kAEs of x
    constexpr int wr = 32 * kAEs;
    for (int i = lane; i < ng * rows * wr; i += 32) {
      const int gi = i / (rows * wr), q = (i / wr) % rows, c = i % wr;
      const size_t src = ((size_t)(m0 + q) * p.K + (size_t)(g0 + gi) * 128);
      cp4(ab + gi * kRows * 128 +
              (kAEs == 1 ? swz(q, 4 * c) : q * 4 * wr + 4 * c),
          static_cast<const char*>(p.a) + src * kAEs + 4 * c);
    }
    if (kGroup)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int cols = min(kTile, p.N - wc[b]);
        char* sbb = sb + b * kSBytes;
        for (int i = lane; i < ng * kTile; i += 32) {
          const int gi = i / kTile, c = i % kTile;
          if (c >= cols) continue;
          const size_t src = (size_t)(g0 + gi) * p.N + wc[b] + c;
          if (kSgBf16)  // 2-byte elements: no cp.async this small
            reinterpret_cast<__nv_bfloat16*>(sbb)[gi * kTile + c] =
                static_cast<const __nv_bfloat16*>(p.sg)[src];
          else
            cp4(reinterpret_cast<float*>(sbb) + gi * kTile + c,
                static_cast<const float*>(p.sg) + src);
        }
      }
  }
  mbar_arrive(full);
  mbar_arrive_cp(full);
}

// This lane's A fragments of group gi of a landed stage's A tiles `ab`:
// rows q and q + 8 (zeros when `two` is false: the block has at most 8
// rows), bytes k = 8t .., 32 + 8t .., 64 + 8t .. and 96 + 8t .. of the
// group's 128.
__device__ __forceinline__ void a_frags(const char* ab, int gi, bool two,
                                        uint2 (&a)[4], uint2 (&a8)[4]) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3, q = lane >> 2;
  const char* ar = ab + gi * kRows * 128;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    a[h] = *reinterpret_cast<const uint2*>(ar + swz(q, 32 * h + 8 * t));
    a8[h] = two ? *reinterpret_cast<const uint2*>(
                      ar + swz(q + 8, 32 * h + 8 * t))
                : make_uint2(0, 0);
  }
}

// The int32 dot of group gi of a landed stage for all NSL n8 slices of the
// tile (slice s: columns 8·(s mod kSlices) .. of box s / kSlices), added to
// d: this lane's {row q: columns 2t, 2t + 1; row q + 8: the same} of each
// slice, from this lane's A fragments (a_frags' layout).  bs and bs8 are
// set to the group's sums of A over rows q and q + 8.  Lane (q, t) reads
// word rows 2t, 2t + 1, 8 + 2t and 9 + 2t of column 8·s + q: their low
// nibbles are the codes k = 8t .. 8t + 7 and 32 + 8t .., their high
// nibbles the same + 64, which match the A bytes it holds; in the swizzle
// the four t of a load fall in four different bank octets.  The slices'
// MMAs are interleaved step by step, so that their latencies overlap, and
// A is read once for all slices.
template <int NSL>
__device__ __forceinline__ void group_mma(const char* codes,
                                          const uint2 (&a)[4],
                                          const uint2 (&a8)[4], int gi,
                                          int (&d)[NSL][4], int& bs,
                                          int& bs8) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3, q = lane >> 2;
  unsigned wd[NSL][4];
#pragma unroll
  for (int s = 0; s < NSL; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wd[s][i] = *reinterpret_cast<const unsigned*>(
          codes + (s / kSlices) * kWBytes +
          swz(gi * 16 + 2 * t + (i & 1) + 8 * (i >> 1),
              4 * (8 * (s % kSlices) + q)));
  // steps: k = 8t .. (words 2t, 2t + 1), 32 + 8t .. (8 + 2t, 9 + 2t), then
  // the same in the high nibbles
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int s = 0; s < NSL; ++s) {
      const int sh = 4 * (h >> 1), i0 = 2 * (h & 1);
      mma_s8(d[s], a[h].x, a8[h].x, a[h].y, a8[h].y,
             (wd[s][i0] >> sh) & w4a8::kNib,
             (wd[s][i0 + 1] >> sh) & w4a8::kNib);
    }
  // bsum: this lane's 32 bytes of each row, then the quad's
  bs = 0;
  bs8 = 0;
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
}

// The per-channel stream's shape: NB boxes of codes a stage (2 with the
// GLU epilogue: gate and up), NSL n8 slices, the ring's depth (a GLU block
// holds fewer stages, so that two blocks share an SM), and its shared
// memory: alignment slack, the ring, and a full and an empty barrier a
// slot.  The warps' partial sums (kRed bytes) overlay the ring at the end.
template <bool kGlu>
struct Channel {
  static constexpr int NB = kGlu ? 2 : 1;
  static constexpr int NSL = NB * kSlices;
  static constexpr int kStages = kGlu ? 2 : 4;
  using L = Slot<NB, false>;
  static constexpr int kRed = kWarps * NSL * 32 * 16;
  static constexpr int kSmem = 1024 + kStages * L::kBytes + 2 * kStages * 8;
  static_assert(kRed <= kStages * L::kBytes, "partial sums overlay the ring");
};

// A of the plain and GLU kernels: int8 tiles the producer streams into the
// slots, and the caller's per-token scales.  A source of A is made by the
// consumer threads from the call's Args and has: kAEs (the bytes of an
// element the producer streams into the A tiles: 1 for int8 A), begin(m0,
// rows) (the consumers' prologue for the block's rows), frags() (this lane's fragments of the warp's
// group of a landed stage, whose A tiles are at `ab`) and scale() (the
// token scale of row m, the block's row `row`).  (The activation-quant-fused
// kernels' source, w4a8_fused.cu:QuantizedX, streams x and quantizes it in
// the consumers.)
struct StreamedA {
  static constexpr int kAEs = 1;
  const float* s_tok;
  __device__ explicit StreamedA(const Args& p) : s_tok(p.s_tok) {}
  __device__ void begin(int, int) {}
  __device__ void frags(char* ab, int gi, bool two, uint2 (&a)[4],
                        uint2 (&a8)[4]) const {
    a_frags(ab, gi, two, a, a8);
  }
  __device__ float scale(int, int m) const { return s_tok[m]; }
};

// The per-channel GEMM of one block: block_rows(Src::kAEs) rows from m0
// (16 for int8 A; 8 / 4 for the fused kernel's bf16 / f32 x) and output
// columns o0 .. o0 + 31, all K, A from a source of type Src made from the
// call's operands.  p.sg is s_channel (N weight columns; GLU: N = 2I in the
// fused layout, out (M, I)).  A GLU block keeps to the registers that let
// two share an SM.
template <bool kGlu, bool kBf16Out, class Src = StreamedA>
__global__ void __launch_bounds__(kThreads + 32, kGlu ? 2 : 1)
channel_kernel(const __grid_constant__ Maps maps, Args p) {
  using C = Channel<kGlu>;
  constexpr int NB = C::NB, NSL = C::NSL, kStages = C::kStages;
  constexpr int kBR = block_rows(Src::kAEs);
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  smem += (1024 - smem_addr(smem) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * C::L::kBytes);
  uint64_t* empty = full + kStages;
  const int No = kGlu ? p.N / 2 : p.N;
  const int m0 = blockIdx.x * kBR;
  const int o0 = blockIdx.y * kTile;
  const int rows = min(kBR, p.M - m0);
  const int G = p.K / 128;
  const int nst = (G + kGps - 1) / kGps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int wc[NB];  // first weight column of each box (o0 % 32 == 0: one run)
#pragma unroll
  for (int b = 0; b < NB; ++b) wc[b] = w4a8::weight_col<kGlu>(o0, b);
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
      issue<NB, false, false, Src::kAEs>(smem + s * C::L::kBytes, full + s, p,
                                         maps, st, G, wc, m0, rows, lane);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  Src src(p);
  src.begin(m0, rows);
  const bool two = rows > 8;
  int d[NSL][4];
#pragma unroll
  for (int s = 0; s < NSL; ++s) d[s][0] = d[s][1] = d[s][2] = d[s][3] = 0;
  int bs = 0, bs8 = 0;  // this warp's groups' sums of A, rows q and q + 8
  for (int st = 0; st < nst; ++st) {
    const int s = st % kStages;
    mbar_wait(full + s, (st / kStages) & 1);
    if (st * kGps + warp < G) {  // a group past G is never read
      char* slot = smem + s * C::L::kBytes;
      uint2 a[4], a8[4];
      src.frags(slot + C::L::kA, warp, two, a, a8);
      int gb, gb8;
      group_mma<NSL>(slot, a, a8, warp, d, gb, gb8);
      bs += gb;
      bs8 += gb8;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp is done with slot s
  }

  // every stage has landed and been read: the warps' sums, less 8·asum of
  // their groups (exact), meet in shared memory over the ring
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  int4* red = reinterpret_cast<int4*>(smem);
#pragma unroll
  for (int s = 0; s < NSL; ++s)
    red[(warp * NSL + s) * 32 + lane] =
        make_int4(d[s][0] - 8 * bs, d[s][1] - 8 * bs, d[s][2] - 8 * bs8,
                  d[s][3] - 8 * bs8);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");

  // output (row, column) pair p of the block's 16 x 32: term `comp` of
  // lane `le` of slice p / 128, so that a warp reads consecutive words
  const int* ri = reinterpret_cast<const int*>(smem);
  for (int pr = threadIdx.x; pr < kSlices * 128; pr += kThreads) {
    const int sl = pr >> 7, le = (pr >> 2) & 31, comp = pr & 3;
    const int row = (le >> 2) + 8 * (comp >> 1);
    const int o = o0 + sl * 8 + 2 * (le & 3) + (comp & 1);
    if (row >= rows || o >= No) continue;
    const int m = m0 + row;
    const float ts = src.scale(row, m);
    float v[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      int tot = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        tot += ri[((w * NSL + b * kSlices + sl) * 32 + le) * 4 + comp];
      const float sc =
          static_cast<const float*>(p.sg)[w4a8::weight_col<kGlu>(o, b)];
      v[b] = __fmul_rn(__fmul_rn((float)tot, sc), ts);
    }
    w4a8::store<kBf16Out>(p.out, (size_t)m * No + o,
                          kGlu ? w4a8::silu_mul(v[0], v[NB - 1]) : v[0]);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The exact g128 stream's shape: NB boxes of codes a stage (2 for the GLU:
// gate and up), the ring's depth, a stage's int32 terms (kEBytes) and the
// shared memory: alignment slack, the ring, two buffers of terms, and a
// full and an empty barrier a slot.  The GLU's slot (two boxes of codes
// and their s_group rows, 50 KB) and its doubled terms leave room for three
// stages in a block's 227 KB, not four.
template <int NB>
struct Group {
  static constexpr int NSL = NB * kSlices;
  using L = Slot<NB, true>;
  static constexpr int kStages = NB == 1 ? 4 : 3;
  static constexpr int kEBytes = kGps * NSL * 32 * 16;
  static constexpr int kSmem =
      1024 + kStages * L::kBytes + 2 * kEBytes + 2 * kStages * 8;
};

// The int32 terms d_g − 8·bsum_g of group gi of a landed stage (its dot by
// group_mma), written to terms: per slice (box after box) and lane {row q:
// columns 2t, 2t + 1; row q + 8: the same}, only row q's when `two` is
// false (the block has at most 8 rows).
template <int NSL>
__device__ __forceinline__ void dots(const char* codes, const uint2 (&a)[4],
                                     const uint2 (&a8)[4], int gi, bool two,
                                     int* terms) {
  const int lane = threadIdx.x & 31;
  int d[NSL][4];
#pragma unroll
  for (int s = 0; s < NSL; ++s) d[s][0] = d[s][1] = d[s][2] = d[s][3] = 0;
  int bs, bs8;
  group_mma<NSL>(codes, a, a8, gi, d, bs, bs8);
#pragma unroll
  for (int s = 0; s < NSL; ++s) {
    const int at = (gi * NSL + s) * 32 + lane;
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
// box's terms (nc = 4 terms a lane, or 2 when `two` is false), so that a
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

// The exact g128 GEMM of one block: block_rows(Src::kAEs) rows from m0
// (16, or 8 / 4 for the fused kernel's bf16 / f32 x) and 32 output columns
// from o0, all K, A from `src`.  NB = 1: out (M, N), columns o0 ..;
// NB = 2 (GLU): the 32 gate and the 32 up columns of output columns o0 ..
// (weight_col), out (M, N/2) of silu(gate)·up.  Consumer warp w writes the
// int32 terms of group w of each stage to shared memory; after a barrier of
// the consumer warps, the thread that owns a (row, column) adds the stage's
// f32 terms to its running sum (one a box) in group order, each product and
// sum rounded on its own.
template <int NB, bool kSgBf16, bool kBf16Out, class Src>
__device__ __forceinline__ void group_gemm(const Maps& maps, const Args& p,
                                           Src& src) {
  using C = Group<NB>;
  using L = typename C::L;
  using S = typename std::conditional<kSgBf16, __nv_bfloat16, float>::type;
  constexpr int NSL = C::NSL, kStages = C::kStages;
  constexpr int kBR = block_rows(Src::kAEs);
  constexpr bool kGlu = NB == 2;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  smem += (1024 - smem_addr(smem) % 1024) % 1024;
  int* terms = reinterpret_cast<int*>(smem + kStages * L::kBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * L::kBytes +
                                               2 * C::kEBytes);
  uint64_t* empty = full + kStages;
  const int No = kGlu ? p.N / 2 : p.N;
  const int m0 = blockIdx.x * kBR;
  const int o0 = blockIdx.y * kTile;
  const int rows = min(kBR, p.M - m0);
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
    int wc[NB];  // first weight column of each box (o0 % 32 == 0: one run)
#pragma unroll
    for (int b = 0; b < NB; ++b) wc[b] = w4a8::weight_col<kGlu>(o0, b);
    for (int st = 0; st < nst; ++st) {
      const int s = st % kStages;
      if (st >= kStages) mbar_wait(empty + s, (st / kStages - 1) & 1);
      issue<NB, true, kSgBf16, Src::kAEs>(smem + s * L::kBytes, full + s, p,
                                          maps, st, G, wc, m0, rows, lane);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  src.begin(m0, rows);
  const bool two = rows > 8;
  const int pairs = two ? kPairs : 1;
  const int bstride = kSlices * 32 * (two ? 4 : 2);  // terms a box
  const int gstride = NB * bstride;                   // terms a group
  float facc[NB][kPairs];
  bool live[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
#pragma unroll
    for (int b = 0; b < NB; ++b) facc[b][j] = 0.f;
    const Pair pr(threadIdx.x + j * kThreads, two);
    live[j] = j < pairs && pr.row < rows && o0 + pr.col < No;
  }
  for (int st = 0; st < nst; ++st) {
    const int s = st % kStages;
    mbar_wait(full + s, (st / kStages) & 1);
    char* slot = smem + s * L::kBytes;
    int* tb = terms + (st & 1) * (C::kEBytes / 4);
    // the stage's dots, group `warp` (a group past G holds zeros or a
    // stale slot and is never added)
    uint2 a[4], a8[4];
    src.frags(slot + L::kA, warp, two, a, a8);
    dots<NSL>(slot, a, a8, warp, two, tb);
    // the consumer warps' terms are all written (the producer goes on)
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    // then each pair's f32 terms in group order, loads first
    const int ng = min(kGps, G - st * kGps);
    const S* sgs = reinterpret_cast<const S*>(slot + L::kS);
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      if (!live[j]) continue;
      const Pair pr(threadIdx.x + j * kThreads, two);
      int e[NB][kGps];
      float sc[NB][kGps];
#pragma unroll
      for (int gi = 0; gi < kGps; ++gi)
        if (gi < ng)
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            e[b][gi] = tb[gi * gstride + b * bstride + pr.at];
            sc[b][gi] = to_f(sgs[b * (kSBytes / (int)sizeof(S)) +
                                 gi * kTile + pr.col]);
          }
#pragma unroll
      for (int gi = 0; gi < kGps; ++gi)
        if (gi < ng)
#pragma unroll
          for (int b = 0; b < NB; ++b)
            facc[b][j] =
                __fadd_rn(facc[b][j], __fmul_rn((float)e[b][gi], sc[b][gi]));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp is done with slot s
  }

#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    if (!live[j]) continue;
    const Pair pr(threadIdx.x + j * kThreads, two);
    const int m = m0 + pr.row;
    const float ts = src.scale(pr.row, m);
    const float v = __fmul_rn(facc[0][j], ts);
    w4a8::store<kBf16Out>(
        p.out, (size_t)m * No + o0 + pr.col,
        kGlu ? w4a8::silu_mul(v, __fmul_rn(facc[NB - 1][j], ts)) : v);
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
// Opts `kernel` in to `bytes` of dynamic shared memory, with the SM's
// carveout at its most shared, once per device: the decode calls these
// routes five times a layer every tick.
template <typename Kernel>
int opt_in(Kernel kernel, int bytes) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == fn && d.second == dev) return 0;
  int err = smem_fit(kernel, bytes);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  if (err == 0) done.emplace_back(fn, dev);
  return err;
}

// The TMA maps of the codes, of A and of s_group (elements of es bytes),
// each when its pointer and N suit the unit (16-byte aligned bases and row
// strides).
inline bool map_codes(Maps* maps, const Args& p) {
  return (uintptr_t)p.w % 16 == 0 && (4LL * p.N) % 16 == 0 &&
         map2d(&maps->w, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, p.w, p.K / 8, p.N,
               16 * kGps, kTile, true);
}
inline bool map_a(Maps* maps, const Args& p) {
  return (uintptr_t)p.a % 16 == 0 &&
         map2d(&maps->a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.a, p.M, p.K,
               a_box_rows(p.M), 128, true);
}
// x (M, K) of es-byte elements as the fused kernel streams it: boxes of
// block_rows(es) x 128, row-major
inline bool map_x(Maps* maps, const Args& p, int es) {
  return (uintptr_t)p.a % 16 == 0 &&
         map2d(&maps->a,
               es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               es, p.a, p.M, p.K, block_rows(es), 128, false);
}
inline bool map_scales(Maps* maps, const Args& p, int es) {
  return (uintptr_t)p.sg % 16 == 0 && (1LL * es * p.N) % 16 == 0 &&
         map2d(&maps->s,
               es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               es, p.sg, p.K / 128, p.N, kGps, kTile, false);
}

// The per-channel stream, A from a source of type Src (its A tiles
// streamed as elements of Src::kAEs bytes), over (M / block_rows(kAEs),
// No/32) blocks: p.sg = s_channel (N,) f32; N weight columns (2I with
// kGlu).  Where a pointer or N does not suit the TMA unit, the producer
// copies.
template <bool kGlu, bool kBf16Out, class Src = StreamedA>
int launch_channel(Args p, cudaStream_t st) {
  using C = Channel<kGlu>;
  constexpr int kAEs = Src::kAEs, kBR = block_rows(kAEs);
  auto k = channel_kernel<kGlu, kBf16Out, Src>;
  const int err = opt_in(k, C::kSmem);
  if (err != 0) return err;
  Maps maps;
  p.tma = map_codes(&maps, p) &&
          (kAEs == 1 ? map_a(&maps, p) : map_x(&maps, p, kAEs));
  const int No = kGlu ? p.N / 2 : p.N;
  const dim3 grid((p.M + kBR - 1) / kBR, (No + kTile - 1) / kTile);
  k<<<grid, kThreads + 32, C::kSmem, st>>>(maps, p);
  return (int)cudaGetLastError();
}

// A g128 kernel of the stream (k: NB boxes a stage, its A tiles streamed
// as elements of kAEs bytes; s_group elements of 2 or 4 bytes), opted in
// to its shared memory, over (M / block_rows(kAEs), No/32) blocks.  Where
// a pointer or N does not suit the TMA unit, the producer copies.
template <int NB, int kAEs, bool kSgBf16, typename Kernel>
int launch_group(Kernel k, Args p, cudaStream_t st) {
  constexpr int kSmem = Group<NB>::kSmem;
  constexpr int kBR = block_rows(kAEs);
  const int err = opt_in(k, kSmem);
  if (err != 0) return err;
  Maps maps;
  p.tma = map_codes(&maps, p) &&
          (kAEs == 1 ? map_a(&maps, p) : map_x(&maps, p, kAEs)) &&
          map_scales(&maps, p, kSgBf16 ? 2 : 4);
  const int No = NB == 2 ? p.N / 2 : p.N;
  const dim3 grid((p.M + kBR - 1) / kBR, (No + kTile - 1) / kTile);
  k<<<grid, kThreads + 32, kSmem, st>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace stream
}  // namespace
