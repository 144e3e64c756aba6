// The int8 wgmma tile GEMM shared by the g128 requant route
// (w4a8_requant.cu) and the per-channel route's prefill regime
// (w4a8_gemm.cu), plain and GLU-fused: INT4 codes become s8 B tiles, one
// exact int32 dot over the whole K runs on the int8 tensor cores, and the
// epilogue takes JAX's two f32 multiplies.  kChannel picks the weights:
//   - requant (false): w8 = clip(rint((u - 8) * s_frac[k/128, n]), ±127),
//     through a 16-entry table per column and step, s_col = s_extra;
//   - per channel (true): the codes themselves, q = u - 8, sign-extended in
//     place (two integer ops a packed word plane), s_col = s_channel; no
//     s_frac ring and no table.
// Either way  D[m, n] = out( (float)(A · w)[m, n] * s_col[n] * s_tok[m] ),
// bit-identical to the plain PyTorch versions (GLU up to expf).
//
// Design (after LiquidGEMM's W4A8 kernel, PAPERS.md): a block of two
// warpgroups owns 256 rows x 128 weight columns and walks K in steps of 128,
// one g128 group: one s_frac row and one 16-word block of the nibble-plane
// packing (w4a8_common.cuh). Per step, A (256 rows x 128 int8) arrives by
// cp.async into a 128-byte-swizzled K-major tile, and the packed words (and,
// requant, the s_frac row) into a 4-stage ring (two steps ahead). The block
// then regrids the step's words once, for all 256 rows: requant through a
// 16-entry table per column that holds requant1's w8 of each code, per
// channel by the sign extension; each packed word becomes two 4-byte K-major
// chunks of the int8 B tile (word r of a column holds k = 4r..4r+3 in its
// low nibbles and 64+4r.. in its high ones, so no shuffle is needed). The
// requant regrid, not the tensor cores, sets the pace of a step, so the tall
// tile halves its cost per row (on the H100, 30% less time than a 128-row
// tile at M = 16384). B is double-buffered in the same swizzle; after a proxy
// fence each warpgroup issues eight wgmma.m64n128k32.s32.s8.s8 (two 64-row
// slabs of its 128 rows, four k32 slices), which run while the block loads
// and regrids the next step. The epilogue takes the two __fmul_rn in JAX's
// order and stages the tile through shared memory for coalesced stores; M
// and N are masked (loads clamp to the last row / column). A grid of fewer
// tiles than the card has SMs (the k/v projections at M = 512: 16 tiles)
// splits K across blocks: each split writes its exact int32 partial tile to
// a workspace the wrapper allocates (workspace_bytes) and a second kernel
// adds the splits and applies the epilogue, bit-exact in any order.
//
// GLU (kGlu): the same main loop over a tile whose 128 weight columns are
// the 64 gate columns of output columns o0 .. o0 + 63 followed by their 64
// up columns (tile_col; each run is contiguous, as 64 divides the
// interleave of 256), so the regrid costs per int8 product what the plain
// kernel's does.  In the m64n128 fragment a thread's accumulator i + 32 is
// column + 64 of its accumulator i: each thread holds the gate and the up
// sum of the same output, and the epilogue applies silu_mul in registers.
// A split-K GLU grid adds the gate and up partials in weight-column space
// in its second pass, then applies the same epilogue.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_fit.cuh"
#include "w4a8_common.cuh"

namespace {
namespace tc {

using w4a8::weight_col;

constexpr int TM = 256;              // output rows a block
constexpr int kSlabs = TM / 128;     // m64 slabs a warpgroup
constexpr int TN = 128;              // weight columns a block
constexpr int TK = 128;              // K a step: one g128 group
constexpr int kWordsK = TK / 8;      // packed words a column a step
constexpr int kStages = 4;           // ring of A, words and s_frac
constexpr int kAhead = kStages - 2;  // steps loaded ahead of the current one
constexpr int kThreads = 256;        // two warpgroups
constexpr int kWLd = TN + 8;         // word row stride: conflict-free regrid
constexpr int kOutLd = TN + 4;       // epilogue staging row stride (floats)

// Shared memory, in bytes from a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes).
constexpr int kOffA = 0;                                   // [kStages][TM][TK]
constexpr int kOffB = kOffA + kStages * TM * TK;           // [2][TN][TK]
constexpr int kOffW = kOffB + 2 * TN * TK;                 // [kStages][16][kWLd]
constexpr int kOffSf = kOffW + kStages * kWordsK * kWLd * 4;  // [kStages][TN]
constexpr int kOffLut = kOffSf + kStages * TN * 4;         // [TN][16] bytes
constexpr int kSmemBytes = kOffLut + TN * 16 + 1024;       // + alignment slack
static_assert(TM * kOutLd * 4 <= kOffW, "epilogue staging overlays A and B");
static_assert(TM % 128 == 0 && TM * 8 % kThreads == 0, "two warpgroups");

// Byte offset of 16-byte chunk `c` of K-major row `r` (128-byte rows) in the
// 128-byte swizzle that wgmma's descriptors name: chunk index ^ (r mod 8).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 128B-swizzled K-major operand descriptor: start address, LBO 16 B (unused
// by this swizzle), SBO 1024 B (8 rows of 128 B), layout 1 = 128B swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x 128, int32 fragments) = A (64 x 32 int8) . B (128 x 32 int8)^T
// (+ D unless scale_d is 0), both from 128B-swizzled K-major shared memory.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The w8 of the four codes in the low nibbles of x's bytes, from a column's
// 16-entry table t (byte u of t = w8 of code u): two byte permutes over the
// table's halves by the codes' low 3 bits, then a per-byte choice by bit 3.
__device__ __forceinline__ unsigned regrid4(unsigned x, uint4 t) {
  const unsigned i3 = x & 0x07070707u;
  const unsigned sel = __byte_perm(i3 | (i3 >> 4), 0, 0x0020);
  const unsigned lo8 = __byte_perm(t.x, t.y, sel);  // entries 0..7
  const unsigned hi8 = __byte_perm(t.z, t.w, sel);  // entries 8..15
  const unsigned hi = ((x >> 3) & 0x01010101u) * 0xFFu;  // 0xFF: code >= 8
  return (hi8 & hi) | (lo8 & ~hi);
}

// Output columns a block: 128, or 64 with the GLU epilogue.
template <bool kGlu>
constexpr int kOutCols = kGlu ? TN / 2 : TN;

// Weight column of tile column c of the block whose first output column is
// o0 (the last output column repeated past No).  GLU: c < 64 the gate, c >=
// 64 the up column of output column o0 + c % 64.
template <bool kGlu>
__device__ __forceinline__ int tile_col(int o0, int c, int No) {
  const int o = min(o0 + c % kOutCols<kGlu>, No - 1);
  return weight_col<kGlu>(o, c / kOutCols<kGlu>);
}

// Issue the cp.async copies of K step kb into ring slot s: A rows m0.. (the
// last row repeated past M), the step's 16 packed-word rows of the block's
// weight columns and (requant) their s_frac.
template <bool kChannel, bool kGlu>
__device__ __forceinline__ void load_step(uint32_t base, const int8_t* a,
                                          const int32_t* w, const float* sf,
                                          int M, int K, int Nw, int No,
                                          int m0, int o0, int kb, int s,
                                          int tid) {
  const uint32_t sa = base + kOffA + s * TM * TK;
#pragma unroll
  for (int i = 0; i < TM * 8 / kThreads; ++i) {
    const int id = tid + i * kThreads;
    const int r = id >> 3, c = id & 7;
    const int m = min(m0 + r, M - 1);
    cp16(sa + swz(r, c), a + (size_t)m * K + (size_t)kb * TK + c * 16);
  }
  const uint32_t sw = base + kOffW + s * kWordsK * kWLd * 4;
#pragma unroll
  for (int i = 0; i < kWordsK * TN / kThreads; ++i) {
    const int id = tid + i * kThreads;
    const int r = id / TN, c = id % TN;
    const int n = tile_col<kGlu>(o0, c, No);
    cp4(sw + (r * kWLd + c) * 4, w + ((size_t)kb * kWordsK + r) * Nw + n);
  }
  if (!kChannel && tid < TN) {
    const int n = tile_col<kGlu>(o0, tid, No);
    cp4(base + kOffSf + (s * TN + tid) * 4, sf + (size_t)kb * Nw + n);
  }
}

// Position (row, column) in the block tile of accumulator i of slab h of
// thread tid: warp w of warpgroup g holds rows 16 (w mod 4) .. + 15 of the
// slab's 64 rows, of all 128 columns, 4 values per 8-column slice i / 4
// (the wgmma m64nNk32 layout).
__device__ __forceinline__ void frag_pos(int h, int i, int tid, int& r,
                                         int& c) {
  const int l = tid & 31, w = tid >> 5, e = i & 3;
  r = 64 * (kSlabs * (w >> 2) + h) + 16 * (w & 3) + (l >> 2) + (e >> 1) * 8;
  c = 8 * (i >> 2) + 2 * (l & 3) + (e & 1);
}

// The epilogue's two multiplies, in the JAX kernel's order.
__device__ __forceinline__ float scaled(int acc, float s_col, float s_tok) {
  return __fmul_rn(__fmul_rn((float)acc, s_col), s_tok);
}

// The s8 B operands of the four codes in the low nibbles of x's bytes, per
// channel: q = u - 8 as a byte, u + 0x78 (no carry out of a byte, u <= 15)
// with its top bit flipped.
__device__ __forceinline__ unsigned offset4(unsigned x) {
  return ((x & w4a8::kNib) + 0x78787878u) ^ 0x80808080u;
}

// One block: tile (blockIdx.y, blockIdx.x) over K steps [z * steps, (z + 1)
// * steps) of split z = blockIdx.z.  One split: the scaled (GLU: silu_mul)
// output tile to `out`; several: the int32 partial tile to ws[z], (M, Nw) in
// weight-column space.  s_frac is read by the requant kernels only.
template <bool kChannel, bool kGlu, bool kBf16Out>
__device__ __forceinline__ void tile_gemm(
    const int8_t* __restrict__ a, const float* __restrict__ s_tok,
    const int32_t* __restrict__ w, const float* __restrict__ s_col,
    const float* __restrict__ s_frac, void* __restrict__ out,
    int* __restrict__ ws, int M, int K, int Nw, int steps) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int No = kGlu ? Nw / 2 : Nw;
  const int o0 = blockIdx.x * kOutCols<kGlu>;
  const int m0 = blockIdx.y * TM;
  const int kb0 = blockIdx.z * steps;
  const int nk = min(K / TK - kb0, steps);

  // not zeroed: the first product of the walk ignores them (scale_d 0),
  // so no other instruction writes them while wgmma runs, which would make
  // ptxas serialize the wgmmas
  int acc[kSlabs][64];

#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < nk)
      load_step<kChannel, kGlu>(base, a, w, s_frac, M, K, Nw, No, m0, o0,
                                kb0 + i, i % kStages, tid);
    cp_commit();
  }

  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    cp_wait<kAhead - 1>();  // this thread's copies of step i have landed
    __syncthreads();        // everyone's; step i - 2's buffers are free
    if (i + kAhead < nk)
      load_step<kChannel, kGlu>(base, a, w, s_frac, M, K, Nw, No, m0, o0,
                                kb0 + i + kAhead, (i + kAhead) % kStages,
                                tid);
    cp_commit();

    if (!kChannel) {  // the step's tables: thread t fills half of column
                      // t / 2's
      const int n = tid >> 1, half = tid & 1;
      const float f =
          reinterpret_cast<const float*>(smem + kOffSf)[s * TN + n];
      unsigned t0 = 0, t1 = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        t0 |= (unsigned)(w4a8::requant1(8 * half + u - 8, f) & 0xFF) << (8 * u);
        t1 |= (unsigned)(w4a8::requant1(8 * half + 4 + u - 8, f) & 0xFF)
              << (8 * u);
      }
      uint32_t* lut = reinterpret_cast<uint32_t*>(smem + kOffLut);
      lut[n * 4 + 2 * half] = t0;
      lut[n * 4 + 2 * half + 1] = t1;
      __syncthreads();
    }

    {  // regrid: warp w takes columns 16w..16w+15, lane l column
       // (l / 4) of each 8 and words r = l % 4 (mod 4): 32 banks per store
      const uint32_t* wsm = reinterpret_cast<const uint32_t*>(
          smem + kOffW + s * kWordsK * kWLd * 4);
      const uint4* lut = reinterpret_cast<const uint4*>(smem + kOffLut);
      uint8_t* bt = smem + kOffB + (i & 1) * TN * TK;
      const int wp = tid >> 5, l = tid & 31;
#pragma unroll
      for (int cg = 0; cg < 2; ++cg) {
        const int n = (2 * wp + cg) * 8 + (l >> 2);
        const uint4 t = kChannel ? uint4{} : lut[n];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned word = wsm[(4 * q + (l & 3)) * kWLd + n];
          const int off = 4 * (l & 3);
          *reinterpret_cast<unsigned*>(bt + swz(n, q) + off) =
              kChannel ? offset4(word) : regrid4(word, t);
          *reinterpret_cast<unsigned*>(bt + swz(n, 4 + q) + off) =
              kChannel ? offset4(word >> 4) : regrid4(word >> 4, t);
        }
      }
    }
    fence_async_smem();  // this thread's A copies and B stores, for wgmma
    __syncthreads();

    // warpgroup g multiplies rows 64 (kSlabs g + h) .. of the tile
    const uint32_t sa =
        base + kOffA + s * TM * TK + (tid >> 7) * kSlabs * 64 * TK;
    const uint32_t sb = base + kOffB + (i & 1) * TN * TK;
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kSlabs; ++h)
#pragma unroll
      for (int kc = 0; kc < TK / 32; ++kc)
        wgmma_m64n128k32(acc[h], desc_sw128(sa + h * 64 * TK + kc * 32),
                         desc_sw128(sb + kc * 32), i > 0 || kc > 0);
    wgmma_commit();
    wgmma_wait<1>();  // step i - 1's products are done with their tiles
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < kSlabs; ++h) fence_regs(acc[h]);
  cp_wait<0>();
  __syncthreads();  // every product done: A and B are free for staging

  // the tile staged in shared memory (int32 partial sums of all 128 weight
  // columns when K is split, else the f32 outputs), then stored row by row,
  // coalesced
  const bool split = gridDim.z > 1;
  float* stage = reinterpret_cast<float*>(smem);
  int* stage_i = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int h = 0; h < kSlabs; ++h) {
    if (split) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        int r, c;
        frag_pos(h, i, tid, r, c);
        stage_i[r * kOutLd + c] = acc[h][i];
      }
    } else {
      // GLU: accumulators 0..31 are gate columns c < 64, i + 32 the up
      // column c + 64 of the same output
#pragma unroll
      for (int i = 0; i < (kGlu ? 32 : 64); ++i) {
        int r, c;
        frag_pos(h, i, tid, r, c);
        const float st = s_tok[min(m0 + r, M - 1)];
        float v = scaled(acc[h][i], s_col[tile_col<kGlu>(o0, c, No)], st);
        if (kGlu) {
          const int cu = tile_col<kGlu>(o0, c + 64, No);
          v = w4a8::silu_mul(v, scaled(acc[h][kGlu ? i + 32 : i], s_col[cu],
                                       st));
        }
        stage[r * kOutLd + c] = v;
      }
    }
  }
  __syncthreads();
  const int cols = split ? TN : kOutCols<kGlu>;
  for (int idx = tid; idx < TM * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    const int m = m0 + r;
    if (m >= M || o0 + c % kOutCols<kGlu> >= No) continue;
    if (split)
      ws[((size_t)blockIdx.z * M + m) * Nw + tile_col<kGlu>(o0, c, No)] =
          stage_i[r * kOutLd + c];
    else
      w4a8::store<kBf16Out>(out, (size_t)m * No + o0 + c,
                            stage[r * kOutLd + c]);
  }
}

// One kernel name per route, so that a profile tells the requant GEMMs (#3,
// #8) from the per-channel ones (#1, #6): the same tile_gemm.
#define TC_ARGS                                                            \
  const int8_t *__restrict__ a, const float *__restrict__ s_tok,           \
      const int32_t *__restrict__ w, const float *__restrict__ s_col,      \
      const float *__restrict__ s_frac, void *__restrict__ out,            \
      int *__restrict__ ws, int M, int K, int Nw, int steps
template <bool kGlu, bool kBf16Out>
__global__ void __launch_bounds__(kThreads, 1) requant_tc_kernel(TC_ARGS) {
  tile_gemm<false, kGlu, kBf16Out>(a, s_tok, w, s_col, s_frac, out, ws, M, K,
                                   Nw, steps);
}
template <bool kGlu, bool kBf16Out>
__global__ void __launch_bounds__(kThreads, 1) channel_tc_kernel(TC_ARGS) {
  tile_gemm<true, kGlu, kBf16Out>(a, s_tok, w, s_col, s_frac, out, ws, M, K,
                                  Nw, steps);
}
#undef TC_ARGS

// The splits' int32 partial sums added (exact), then the epilogue: for GLU
// those of the output's gate and up weight columns.
template <bool kGlu, bool kBf16Out>
__device__ __forceinline__ void split_sum(const int* __restrict__ ws,
                                          const float* __restrict__ s_tok,
                                          const float* __restrict__ s_col,
                                          void* __restrict__ out, int M,
                                          int Nw, int splits) {
  constexpr int NS = kGlu ? 2 : 1;
  const int No = kGlu ? Nw / 2 : Nw;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * No) return;
  const int m = (int)(idx / No), o = (int)(idx % No);
  float v[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int n = weight_col<kGlu>(o, s);
    int tot = 0;
    for (int z = 0; z < splits; ++z)
      tot += ws[((size_t)z * M + m) * Nw + n];
    v[s] = scaled(tot, s_col[n], s_tok[m]);
  }
  w4a8::store<kBf16Out>(out, idx, kGlu ? w4a8::silu_mul(v[0], v[NS - 1])
                                       : v[0]);
}
#define SPLIT_ARGS                                                          \
  const int *__restrict__ ws, const float *__restrict__ s_tok,              \
      const float *__restrict__ s_col, void *__restrict__ out, int M, int Nw, \
      int splits
template <bool kGlu, bool kBf16Out>
__global__ void requant_split_epilogue(SPLIT_ARGS) {
  split_sum<kGlu, kBf16Out>(ws, s_tok, s_col, out, M, Nw, splits);
}
template <bool kGlu, bool kBf16Out>
__global__ void channel_split_epilogue(SPLIT_ARGS) {
  split_sum<kGlu, kBf16Out>(ws, s_tok, s_col, out, M, Nw, splits);
}
#undef SPLIT_ARGS

// K steps per split: the whole K unless the tiles (of N weight columns,
// GLU or not) fill fewer blocks than the card has SMs, then about SMs /
// tiles splits.
int steps_per_split(int M, int K, int N, int* err) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *err = (int)e;
  const int kb = K / TK;
  const long long tiles =
      (long long)((M + TM - 1) / TM) * ((N + TN - 1) / TN);
  if (e != cudaSuccess || tiles >= sms) return kb;
  const long long fill = sms / tiles;
  const int splits = (int)(fill < kb ? fill : kb);
  return (kb + splits - 1) / splits;
}

using TileKernel = void (*)(const int8_t*, const float*, const int32_t*,
                           const float*, const float*, void*, int*, int, int,
                           int, int);
using SplitKernel = void (*)(const int*, const float*, const float*, void*,
                             int, int, int);

// The route's tile kernel and split-K second pass, their grid sized here.
int launch_tiles(TileKernel kernel, SplitKernel epilogue, bool glu,
                 const int8_t* a, const float* s_tok, const int32_t* w,
                 const float* s_col, const float* s_frac, void* out, int* ws,
                 int M, int K, int N, cudaStream_t st) {
  int err = 0;
  const int steps = steps_per_split(M, K, N, &err);
  if (err != 0) return err;
  const int splits = (K / TK + steps - 1) / steps;
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int fit = smem_fit(kernel, kSmemBytes);
  if (fit != 0) return fit;
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
  kernel<<<grid, kThreads, kSmemBytes, st>>>(a, s_tok, w, s_col, s_frac, out,
                                             ws, M, K, N, steps);
  if (splits > 1) {
    const size_t n = (size_t)M * (glu ? N / 2 : N);
    epilogue<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(ws, s_tok, s_col,
                                                          out, M, N, splits);
  }
  return (int)cudaGetLastError();
}

// N: weight columns (2I with the GLU epilogue, a multiple of 512); s_col:
// s_extra (requant) or s_channel; s_frac: null per channel.  Only the
// route's own kernels are instantiated.
template <bool kChannel, bool kGlu, bool kBf16Out>
int launch_tc(const int8_t* a, const float* s_tok, const int32_t* w,
              const float* s_col, const float* s_frac, void* out, int* ws,
              int M, int K, int N, cudaStream_t st) {
  if constexpr (kChannel)
    return launch_tiles(channel_tc_kernel<kGlu, kBf16Out>,
                        channel_split_epilogue<kGlu, kBf16Out>, kGlu, a,
                        s_tok, w, s_col, s_frac, out, ws, M, K, N, st);
  else
    return launch_tiles(requant_tc_kernel<kGlu, kBf16Out>,
                        requant_split_epilogue<kGlu, kBf16Out>, kGlu, a,
                        s_tok, w, s_col, s_frac, out, ws, M, K, N, st);
}

// The int32 workspace bytes launch_tc needs for these arguments on the
// current card, with or without glu (N weight columns either way): 0 unless
// the kernel splits K (fewer tiles than SMs), then splits · M · N · 4.
// Negative: minus a CUDA error.
long long workspace_bytes(int M, int K, int N) {
  if (M <= 0 || K < TK) return 0;
  int err = 0;
  const int steps = steps_per_split(M, K, N, &err);
  if (err != 0) return -(long long)err;
  const long long splits = (K / TK + steps - 1) / steps;
  return splits > 1 ? splits * M * N * 4 : 0;
}

}  // namespace tc
}  // namespace
