// Decode (T = 1) GQA attention over the INT8 slot cache (whole-cache and
// S-tiled decode) and over the paged INT8 block pool (paged decode), the
// keys of each row split across blocks, for Hopper (sm_90a), CUDA cores.
//
// Replaces: qqq_tpu/kernels/attention.py:_decode_attn_kernel (:33), reached
// through decode_attention_int8 (:977, call :1021) from
// decode_attention_auto (:952) while S * (hd + 8) <= 8192 * 136;
// _flash_decode_kernel (:757), reached through flash_decode_attention_int8
// (:866) from decode_attention_auto past that; and
// _paged_decode_slab_kernel (:543), reached through
// paged_decode_attention_int8 (:665).  Two template parameters: the key
// layout (KeyRows): key p of (b, kv head h) is slot row (b * nkv + h) * S +
// p, or pool row (tab[b][p / bs] * nkv + h) * bs + p % bs; and the numerics
// (kF32): the whole-cache kernel's, or the tiled kernels'.
//
// The whole-cache kernel's numerics (kF32, slot layout), all in f32: q' =
// q / sqrt(hd); score = (q' . K_i8) * k_scale, masked at s >= cache_len;
// one softmax over the whole row, p = (e / sum(e)) * v_scale with e =
// exp(score - M), M the row's maximum; out = p . V_i8.  The split walks the
// row as one tile of S keys: pass 2's m_t is then M for every segment, e
// stays unrounded, P.V takes e * v_scale in f32, and the combine divides
// the sum of the partial P.V by the sum of the partial sums of e (each
// factor exp(m_t - M) is exp(0) = 1).  Against JAX the only differences
// are f32 reassociations: the dot products, the split sum, and (e *
// v_scale) / l against (e / l) * v_scale.
//
// The tiled kernels' numerics: per (b, h) and its g = nh / nkv query
// heads, q' = bf16(q / sqrt(hd)); the live keys 0 .. cache_len - 1 are
// walked in JAX's tiles of `tile` keys (sblk of the S-tiled kernel, picked
// by the wrapper; sub = 256 or bs of the paged one); score = (q' . K_i8) *
// k_scale in f32; per tile t an online softmax whose running maximum m_t
// decides every bf16 rounding: e = exp(score - m_t), l = l * alpha_t +
// sum(e) over the unrounded e, acc = acc * alpha_t + sum(bf16(e * v_scale)
// * V_i8), alpha_t = exp(m_{t-1} - m_t), m starting at -1e30; out = acc /
// max(l, 1e-30).
//
// The split keeps those rounding points.  A row's keys are cut into
// segments, each the part of a JAX tile inside one chunk of kChunk keys (a
// segment never straddles a tile; a chunk holds one segment of a long
// tile, or several whole tiles shorter than kChunk).  Three launches:
//   1. scores: per live chunk of (b, h), its keys scored for all g heads
//      (each K byte read once for the group) into a (B, nkv, g, Smax) f32
//      workspace, and each segment's maximum per head;
//   2. P.V: per live chunk, m_t, the maximum over the segment maxima of
//      tiles 0 .. t (a max is exact in any order, so m_t is JAX's bit for
//      bit), then e, its sum and bf16(e * v_scale) as JAX forms them, and
//      each segment's partial sum(e) and P.V;
//   3. combine: per (b, h, head, dim) JAX's chain over the live tiles, acc
//      = acc * alpha_t + acc_t, taken as the sum of every segment's partials
//      times exp(m_t - M), M the row's last running maximum (the product of
//      the later alphas as one exponential).
// What remains different from JAX's order is f32 reassociation only: the
// dot products, the in-tile sums and the chain's products of alphas.
//
// What bounds it on the H100: bytes, the K and V codes and scales of the
// live keys, B * nkv * L * (hd + 4) * 2 at 3.35 TB/s, plus the scores (g *
// 4 bytes a key, written and read back once).  The grids are sized from the
// card and from S or nbmax * bs, never from device values, so the wrapper
// reads nothing back from the card.  On the H100 (chip_smoke.py, PERF.md)
// it runs at 3-8x that bound: passes 1 and 2 do an int8 conversion and g
// FMAs a byte on the CUDA cores; tensor cores for q'.K and P.V are the next
// step.
//
// Design: 128 threads a block; a block of passes 1 and 2 is resident on
// its SM for the whole pass and walks the live chunks (Items; no block is
// spent on keys past cache_len), two stages deep: while it computes one
// chunk, the cp.async copies of its next chunk's key rows (K, or V and the
// scores), scales and q are in flight into shared memory.  A key row of hd
// bytes is copied and read by tpk = hd / 16 (rounded up to a power of two)
// threads, 16 bytes each, coalesced in either layout.  Pass 1 keeps each
// thread's 16 dims of q' in registers for a register block of HG heads and
// reduces a key's dot products over its tpk lanes by shuffles.  Pass 2 gives
// each thread keys and 16 dims of every head in a register block of HG
// heads (1, 2 or 4; larger g loops over groups of heads), reduces the key
// lanes of a warp by shuffles and the four warps in shared memory.  The
// combine reads the partials as float4 in 8 lanes of segments a block.
// The workspace is allocated by the wrapper (decode_workspace_bytes says
// how much); the kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "smem_fit.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // keys a block; kernels/attention.py mirrors it
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
// 16 int8 codes to f32, exactly: each code c, biased to c + 128, becomes
// the low byte of the float 2^23 + c + 128 (one byte permute), from which
// 2^23 + 128 is subtracted; cheaper than 16 integer conversions.
__device__ __forceinline__ void int8x16(const int4& raw, float* f) {
  const unsigned wd[4] = {(unsigned)raw.x, (unsigned)raw.y, (unsigned)raw.z,
                          (unsigned)raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned u = wd[i] ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[4 * i + k] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) -
          8388736.f;
  }
}

// The key walk of one call.  Segment j covers keys [start(j), start(j) +
// len(j)) of tile j / spt; chunk c covers segments [c * tpc, (c + 1) * tpc).
struct Geometry {
  int g, hd, tpk, smax, tile, spt, tpc, ntile, nseg, nchunk;
  __host__ __device__ int seg_tile(int j) const { return j / spt; }
  __host__ __device__ int seg_start(int j) const {
    return (j / spt) * tile + (j % spt) * kChunk;
  }
  __host__ __device__ int seg_len(int j) const {
    const int rest = tile - (j % spt) * kChunk;
    return rest < kChunk ? rest : kChunk;
  }
  // segments whose first key lies below L (they precede every other one)
  __device__ int live_segs(int L) const {
    if (L <= 0) return 0;
    const int t = (L - 1) / tile;
    return t * spt + ((L - 1) - t * tile) / kChunk + 1;
  }
};

Geometry make_geometry(int g, int hd, int smax, int tile) {
  Geometry G;
  G.g = g;
  G.hd = hd;
  G.tpk = 1;
  while (G.tpk * 16 < hd) G.tpk *= 2;
  G.smax = smax;
  G.tile = tile;
  G.spt = tile >= kChunk ? (tile + kChunk - 1) / kChunk : 1;
  G.tpc = tile >= kChunk ? 1 : kChunk / tile;
  G.ntile = (smax + tile - 1) / tile;
  G.nseg = G.ntile * G.spt;
  G.nchunk = (G.nseg + G.tpc - 1) / G.tpc;
  return G;
}

// The f32 workspace: scores, segment maxima, running maxima per tile,
// partial P.V and partial sums of e.
struct Work {
  float* sc;  // [B * nkv][g][smax]
  float* mx;  // [B * nkv][g][nseg]
  float* mt;  // [B * nkv][g][ntile]
  float* pv;  // [B * nkv][nseg][g][hd]
  float* pl;  // [B * nkv][nseg][g]
};

// Each region starts 16-byte aligned (pv is read as float4).
inline size_t pad4(size_t n) { return (n + 3) & ~(size_t)3; }

Work carve(float* ws, int B, int nkv, const Geometry& G) {
  const size_t bh = (size_t)B * nkv, g = G.g;
  Work w;
  w.sc = ws;
  w.mx = w.sc + pad4(bh * g * G.smax);
  w.mt = w.mx + pad4(bh * g * G.nseg);
  w.pv = w.mt + pad4(bh * g * G.ntile);
  w.pl = w.pv + bh * G.nseg * g * G.hd;
  return w;
}

size_t work_floats(int B, int nkv, const Geometry& G) {
  const Work w = carve(nullptr, B, nkv, G);
  return (size_t)(w.pl - w.sc) + (size_t)B * nkv * G.nseg * G.g;
}

// The cache row of key c0 + k of (b, h), for the keys of a chunk starting
// at c0.
template <bool kPaged>
struct KeyRows;

template <>
struct KeyRows<false> {
  long long base;
  static __device__ KeyRows make(const int*, int b, int h, int nkv, int S,
                                 int, int c0) {
    return {((long long)b * nkv + h) * S + c0};
  }
  __device__ long long operator()(int k) const { return base + k; }
};

template <>
struct KeyRows<true> {
  const int* tab;  // row b's table from the chunk's first block on
  int nkv, h, bs, off0;
  static __device__ KeyRows make(const int* tables, int b, int h, int nkv,
                                 int bs, int nbmax, int c0) {
    return {tables + (size_t)b * nbmax + c0 / bs, nkv, h, bs, c0 % bs};
  }
  __device__ long long operator()(int k) const {
    int off = off0 + k, blk = 0;
    if (bs >= kChunk) {  // a chunk spans at most two blocks: no division
      blk = off >= bs;
      off -= blk * bs;
    } else {
      blk = off / bs;
      off -= blk * bs;
    }
    return ((long long)__ldg(tab + blk) * nkv + h) * bs + off;
  }
};

// Chunk c: its segments [j0, j1) and live keys [c0, c0 + n) of a row with L
// live keys.
struct Chunk {
  int j0, j1, c0, n;
  __device__ Chunk(const Geometry& G, int c, int L) {
    j0 = c * G.tpc;
    j1 = min(j0 + G.tpc, G.nseg);
    c0 = G.seg_start(j0);
    n = min(G.seg_start(j1 - 1) + G.seg_len(j1 - 1), L) - c0;
  }
};

// The work of passes 1 and 2: chunk c of kv head h of row b, for every chunk
// that starts below its row's cache_len, rows in order.  Every block stages
// each row's live keys and live chunks in shared memory (`rows`, 2 B ints
// after the block's own), counts the items and takes items blockIdx.x, +
// gridDim.x, ...; the grid is sized from the card, so no block is launched
// for dead keys.
struct Items {
  const int* L;   // [B] live keys
  const int* nc;  // [B] live chunks
  int B, nkv, total;
  __device__ Items(int* rows, const int* clen, int B_, int nkv_,
                   const Geometry& G)
      : L(rows), nc(rows + B_), B(B_), nkv(nkv_), total(0) {
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      const int live = min(__ldg(clen + b), G.smax);
      rows[b] = live;
      rows[B + b] = (G.live_segs(live) + G.tpc - 1) / G.tpc;
    }
    __syncthreads();
    for (int b = 0; b < B; ++b) total += nc[b] * nkv;
  }
  __device__ void at(int w, int* b, int* h, int* c) const {
    int r = 0;
    while (w >= nc[r] * nkv) w -= nc[r++] * nkv;
    *b = r;
    *h = w / nc[r];
    *c = w % nc[r];
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every copy group of this thread but the last one has landed
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A thread's place in a chunk: key k's 16-byte column kl (of tpk) belongs
// to thread (k % kpi) * tpk + kl, kpi = kThreads / tpk keys at a time.
struct Lane {
  int tid, lane, warp, kl, slot, kpi;
  bool col_ok;
  __device__ explicit Lane(const Geometry& G)
      : tid(threadIdx.x), lane(threadIdx.x & 31), warp(threadIdx.x >> 5),
        kl(threadIdx.x % G.tpk), slot(threadIdx.x / G.tpk),
        kpi(kThreads / G.tpk), col_ok(threadIdx.x % G.tpk * 16 < G.hd) {}
};

// Starts the copies of this thread's columns of the chunk's key rows (K or
// V) into dst[k][16 tpk] and of their scales into sdst[k].
template <bool kPaged>
__device__ __forceinline__ void copy_rows(char* dst, float* sdst,
                                          const int8_t* src,
                                          const float* scale,
                                          const KeyRows<kPaged>& rows,
                                          const Chunk& ch, const Lane& t,
                                          const Geometry& G) {
#pragma unroll 4
  for (int u = 0; u < G.tpk; ++u) {
    const int k = u * t.kpi + t.slot;
    if (k < ch.n && t.col_ok)
      cp16(dst + ((size_t)k * G.tpk + t.kl) * 16,
           src + rows(k) * G.hd + t.kl * 16);
  }
  for (int k = t.tid; k < ch.n; k += kThreads)
    cp4(sdst + k, scale + rows(k));
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Pass 1's shared memory (byte offsets): two stages of K rows, k scales and
// raw q, then q' [g][16 tpk] and the chunk's scores, then Items' staging.
struct ScoresSmem {
  size_t rows, kb, ks, qb, q, qs, sc, items;
  __host__ __device__ ScoresSmem(const Geometry& G, int tsize) {
    rows = (size_t)kChunk * 16 * G.tpk;
    qb = align16((size_t)G.g * G.hd * tsize);
    kb = 0;
    ks = kb + 2 * rows;
    q = ks + 2 * 4 * kChunk;
    qs = q + 2 * qb;
    sc = qs + 4 * (size_t)G.g * 16 * G.tpk;
    items = sc + 4 * (size_t)G.g * kChunk;
  }
};

// Pass 1, stage `buf`: starts the copies of item (b, h, c).
template <typename T, bool kPaged>
__device__ __forceinline__ void scores_fetch(
    char* smem, const ScoresSmem& Y, int buf, const T* __restrict__ q,
    const int8_t* __restrict__ kc, const float* __restrict__ ks,
    const int* __restrict__ tab, const Geometry& G, int nh, int nkv,
    int span, int nbmax, int b, int h, int c, int L, const Lane& t) {
  const Chunk ch(G, c, L);
  const auto rows =
      KeyRows<kPaged>::make(tab, b, h, nkv, span, nbmax, ch.c0);
  copy_rows<kPaged>(smem + Y.kb + buf * Y.rows,
                    reinterpret_cast<float*>(smem + Y.ks) + buf * kChunk, kc,
                    ks, rows, ch, t, G);
  const char* qsrc = reinterpret_cast<const char*>(
      q + ((size_t)b * nh + (size_t)h * G.g) * G.hd);
  const int qbytes = G.g * G.hd * (int)sizeof(T);
  for (int o = t.tid * 16; o < qbytes; o += kThreads * 16)
    cp16(smem + Y.q + buf * Y.qb + o, qsrc + o);
}

// Pass 1, stage `buf` landed: scores of the chunk's live keys for the g heads
// of kv head h, and each segment's maximum per head.
template <typename T, int HG, bool kF32>
__device__ __forceinline__ void scores_chunk(char* smem,
                                             const ScoresSmem& Y, int buf,
                                             const Work& w, const Geometry& G,
                                             int nkv, int b, int h, int c,
                                             int L, const Lane& t) {
  const Chunk ch(G, c, L);
  const int g = G.g, hd = G.hd, tpk = G.tpk;
  const T* qr = reinterpret_cast<const T*>(smem + Y.q + buf * Y.qb);
  const char* kb = smem + Y.kb + buf * Y.rows;
  const float* ksb =
      reinterpret_cast<const float*>(smem + Y.ks) + buf * kChunk;
  float* qs = reinterpret_cast<float*>(smem + Y.qs);   // [g][16 tpk]
  float* scs = reinterpret_cast<float*>(smem + Y.sc);  // [g][kChunk]
  const size_t bh = (size_t)b * nkv + h;
  const float sq = sqrtf((float)hd);
  const int qw = 16 * tpk;  // a q' row, hd padded
  for (int f = t.tid; f < g * qw; f += kThreads) {
    const int j = f / qw;
    const int d = f - j * qw;
    const float x = d < hd ? to_f(qr[j * hd + d]) / sq : 0.f;
    qs[f] = kF32 ? x : bf16r(x);
  }
  __syncthreads();

  const int iters = (ch.n + t.kpi - 1) / t.kpi;  // <= tpk, uniform
  float* scg = w.sc + bh * g * G.smax + ch.c0;
  for (int jg = 0; jg < g; jg += HG) {
    // this thread's 16 dims of q' for heads jg .. jg + HG - 1
    float qv[HG][16];
#pragma unroll
    for (int jj = 0; jj < HG; ++jj)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 qq =
            jg + jj < g ? *reinterpret_cast<const float4*>(
                              qs + (jg + jj) * qw + 16 * t.kl + 4 * cc)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        qv[jj][4 * cc + 0] = qq.x;
        qv[jj][4 * cc + 1] = qq.y;
        qv[jj][4 * cc + 2] = qq.z;
        qv[jj][4 * cc + 3] = qq.w;
      }
    for (int u = 0; u < iters; ++u) {
      const int k = u * t.kpi + t.slot;
      const bool live = k < ch.n;
      int4 raw = make_int4(0, 0, 0, 0);
      if (live && t.col_ok)
        raw = *reinterpret_cast<const int4*>(kb +
                                             ((size_t)k * tpk + t.kl) * 16);
      const float ksc = live ? ksb[k] : 0.f;
      float kf[16];
      int8x16(raw, kf);
      float s[HG];
#pragma unroll
      for (int jj = 0; jj < HG; ++jj) {
        s[jj] = 0.f;
#pragma unroll
        for (int x = 0; x < 16; ++x) s[jj] = fmaf(qv[jj][x], kf[x], s[jj]);
      }
      for (int o = tpk / 2; o > 0; o >>= 1)
#pragma unroll
        for (int jj = 0; jj < HG; ++jj)
          s[jj] += __shfl_xor_sync(kFull, s[jj], o);
      if (live) {
#pragma unroll
        for (int jj = 0; jj < HG; ++jj)
          if (jg + jj < g && t.kl == jj % tpk) {
            const float v = s[jj] * ksc;
            scg[(size_t)(jg + jj) * G.smax + k] = v;
            scs[(jg + jj) * kChunk + k] = v;
          }
      }
    }
  }
  __syncthreads();

  const int nsc = ch.j1 - ch.j0;
  for (int pi = t.warp; pi < g * nsc; pi += kWarps) {
    const int j = pi / nsc;
    const int seg = ch.j0 + pi % nsc;
    const int a = G.seg_start(seg) - ch.c0;
    const int e = min(a + G.seg_len(seg), ch.n);
    float m = kNegInf;
    for (int k = a + t.lane; k < e; k += 32)
      m = fmaxf(m, scs[j * kChunk + k]);
    m = warp_max(m);
    if (t.lane == 0) w.mx[(bh * g + j) * G.nseg + seg] = m;
  }
}

// Pass 2's shared memory (byte offsets): two stages of V rows, v scales and
// the chunk's scores (overwritten by bf16(e * v_scale)), then m_t, the
// reduction of P.V over the warps and Items' staging.
struct PvSmem {
  size_t rows, vb, vs, scb, sc, mt, red, items;
  __host__ __device__ PvSmem(const Geometry& G, int hg) {
    rows = (size_t)kChunk * 16 * G.tpk;
    scb = 4 * (size_t)G.g * kChunk;
    vb = 0;
    vs = vb + 2 * rows;
    sc = vs + 2 * 4 * kChunk;
    mt = sc + 2 * scb;
    red = mt + align16(4 * (size_t)G.g * G.tpc);
    items = red + 4 * (size_t)kWarps * hg * 16 * G.tpk;
  }
};

// Pass 2, stage `buf`: starts the copies of item (b, h, c).
template <bool kPaged>
__device__ __forceinline__ void pv_fetch(
    char* smem, const PvSmem& Y, int buf, const int8_t* __restrict__ vc,
    const float* __restrict__ vs, const int* __restrict__ tab, const Work& w,
    const Geometry& G, int nkv, int span, int nbmax, int b, int h, int c,
    int L, const Lane& t) {
  const Chunk ch(G, c, L);
  const auto rows =
      KeyRows<kPaged>::make(tab, b, h, nkv, span, nbmax, ch.c0);
  copy_rows<kPaged>(smem + Y.vb + buf * Y.rows,
                    reinterpret_cast<float*>(smem + Y.vs) + buf * kChunk, vc,
                    vs, rows, ch, t, G);
  float* scd = reinterpret_cast<float*>(smem + Y.sc + buf * Y.scb);
  const float* scs = w.sc + ((size_t)b * nkv + h) * G.g * G.smax + ch.c0;
  for (int i = t.tid; i < G.g * ch.n; i += kThreads)
    cp4(scd + (i / ch.n) * kChunk + i % ch.n,
        scs + (size_t)(i / ch.n) * G.smax + i % ch.n);
}

// Pass 2, stage `buf` landed: per segment of the chunk, e = exp(score -
// m_t), its partial sum and the partial P.V of bf16(e * v_scale) (kF32: of
// e * v_scale) for the g heads of kv head h.
template <int HG, bool kF32>
__device__ __forceinline__ void pv_chunk(char* smem, const PvSmem& Y,
                                         int buf, const Work& w,
                                         const Geometry& G, int nkv, int b,
                                         int h, int c, int L, const Lane& t) {
  const Chunk ch(G, c, L);
  const int g = G.g, hd = G.hd, tpk = G.tpk;
  const char* vb = smem + Y.vb + buf * Y.rows;
  const float* vsc =
      reinterpret_cast<const float*>(smem + Y.vs) + buf * kChunk;
  // [g][kChunk], [g][tpc], [kWarps][HG][16 tpk]
  float* p = reinterpret_cast<float*>(smem + Y.sc + buf * Y.scb);
  float* mt = reinterpret_cast<float*>(smem + Y.mt);
  float* red = reinterpret_cast<float*>(smem + Y.red);
  const size_t bh = (size_t)b * nkv + h;

  // m_t through each tile the chunk touches: the running max of the segment
  // maxima of every earlier tile and of this one's live segments
  const int t0 = G.seg_tile(ch.j0);
  const int nt = G.seg_tile(ch.j1 - 1) - t0 + 1;
  for (int j = t.warp; j < g; j += kWarps) {
    const float* mxj = w.mx + (bh * g + j) * G.nseg;
    float m = kNegInf;
    for (int s = t.lane; s < t0 * G.spt; s += 32) m = fmaxf(m, mxj[s]);
    m = warp_max(m);
    for (int i = 0; i < nt; ++i) {
      const int tt = t0 + i;
      float mi = kNegInf;
      for (int s = tt * G.spt + t.lane; s < (tt + 1) * G.spt; s += 32)
        if (G.seg_start(s) < L) mi = fmaxf(mi, mxj[s]);
      m = fmaxf(m, warp_max(mi));
      if (t.lane == 0) {
        mt[j * G.tpc + i] = m;
        if (tt * G.tile >= ch.c0)  // the tile starts in this chunk
          w.mt[(bh * g + j) * G.ntile + tt] = m;
      }
    }
  }
  __syncthreads();

  for (int seg = ch.j0; seg < ch.j1; ++seg) {
    const int a = G.seg_start(seg) - ch.c0;
    if (a >= ch.n) break;
    const int e = min(a + G.seg_len(seg), ch.n);
    const int i = G.seg_tile(seg) - t0;
    for (int j = t.warp; j < g; j += kWarps) {
      const float m = mt[j * G.tpc + i];
      float sum = 0.f;
      for (int k = a + t.lane; k < e; k += 32) {
        const float ex = expf(p[j * kChunk + k] - m);
        sum += ex;
        p[j * kChunk + k] = kF32 ? ex * vsc[k] : bf16r(ex * vsc[k]);
      }
      sum = warp_sum(sum);
      if (t.lane == 0) w.pl[(bh * G.nseg + seg) * g + j] = sum;
    }
    __syncthreads();

    const int iters = (e - a + t.kpi - 1) / t.kpi;  // <= tpk
    for (int jg = 0; jg < g; jg += HG) {
      float acc[HG][16];
#pragma unroll
      for (int jj = 0; jj < HG; ++jj)
#pragma unroll
        for (int x = 0; x < 16; ++x) acc[jj][x] = 0.f;
      for (int u = 0; u < iters; ++u) {
        const int k = a + u * t.kpi + t.slot;
        if (k < e && t.col_ok) {
          float v[16];
          int8x16(*reinterpret_cast<const int4*>(
                      vb + ((size_t)k * tpk + t.kl) * 16),
                  v);
#pragma unroll
          for (int jj = 0; jj < HG; ++jj)
            if (jg + jj < g) {
              const float pj = p[(jg + jj) * kChunk + k];
#pragma unroll
              for (int x = 0; x < 16; ++x)
                acc[jj][x] = fmaf(pj, v[x], acc[jj][x]);
            }
        }
      }
      // the key slots of a warp (lanes kl, kl + tpk, ...), then the warps
      for (int o = 16; o >= tpk; o >>= 1)
#pragma unroll
        for (int jj = 0; jj < HG; ++jj)
#pragma unroll
          for (int x = 0; x < 16; ++x)
            acc[jj][x] += __shfl_xor_sync(kFull, acc[jj][x], o);
      if (t.lane < tpk && t.col_ok)
#pragma unroll
        for (int jj = 0; jj < HG; ++jj)
#pragma unroll
          for (int x = 0; x < 16; ++x)
            red[((size_t)t.warp * HG + jj) * 16 * tpk + 16 * t.kl + x] =
                acc[jj][x];
      __syncthreads();
      for (int x = t.tid; x < HG * hd; x += kThreads) {
        const int jj = x / hd;
        const int d = x % hd;
        if (jg + jj < g) {
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < kWarps; ++r)
            s += red[((size_t)r * HG + jj) * 16 * tpk + d];
          w.pv[((bh * G.nseg + seg) * g + jg + jj) * hd + d] = s;
        }
      }
      __syncthreads();  // red, then p, are rewritten
    }
  }
}

// Passes 1 and 2 walk their items two stages deep: the copies of a block's
// next item are in flight while it computes the current one.
template <typename T, bool kPaged, int HG, bool kF32>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
              const float* __restrict__ ks, const int* __restrict__ tab,
              const int* __restrict__ clen, Work w, Geometry G, int B,
              int nh, int nkv, int span, int nbmax) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const ScoresSmem Y(G, sizeof(T));
  const Items items(reinterpret_cast<int*>(smem + Y.items), clen, B, nkv, G);
  const Lane t(G);
  int b, h, c, buf = 0;
  if ((int)blockIdx.x < items.total) {
    items.at(blockIdx.x, &b, &h, &c);
    scores_fetch<T, kPaged>(smem, Y, buf, q, kc, ks, tab, G, nh, nkv, span,
                            nbmax, b, h, c, items.L[b], t);
  }
  cp_commit();
  for (int i = blockIdx.x; i < items.total; i += gridDim.x, buf ^= 1) {
    if (i + (int)gridDim.x < items.total) {
      items.at(i + gridDim.x, &b, &h, &c);
      scores_fetch<T, kPaged>(smem, Y, buf ^ 1, q, kc, ks, tab, G, nh, nkv,
                              span, nbmax, b, h, c, items.L[b], t);
    }
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    items.at(i, &b, &h, &c);
    scores_chunk<T, HG, kF32>(smem, Y, buf, w, G, nkv, b, h, c, items.L[b],
                              t);
    __syncthreads();  // stage buf and the single buffers are rewritten
  }
}

template <bool kPaged, int HG, bool kF32>
__global__ void __launch_bounds__(kThreads)
pv_kernel(const int8_t* __restrict__ vc, const float* __restrict__ vs,
          const int* __restrict__ tab, const int* __restrict__ clen, Work w,
          Geometry G, int B, int nkv, int span, int nbmax) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const PvSmem Y(G, HG);
  const Items items(reinterpret_cast<int*>(smem + Y.items), clen, B, nkv, G);
  const Lane t(G);
  int b, h, c, buf = 0;
  if ((int)blockIdx.x < items.total) {
    items.at(blockIdx.x, &b, &h, &c);
    pv_fetch<kPaged>(smem, Y, buf, vc, vs, tab, w, G, nkv, span, nbmax, b, h,
                     c, items.L[b], t);
  }
  cp_commit();
  for (int i = blockIdx.x; i < items.total; i += gridDim.x, buf ^= 1) {
    if (i + (int)gridDim.x < items.total) {
      items.at(i + gridDim.x, &b, &h, &c);
      pv_fetch<kPaged>(smem, Y, buf ^ 1, vc, vs, tab, w, G, nkv, span,
                       nbmax, b, h, c, items.L[b], t);
    }
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    items.at(i, &b, &h, &c);
    pv_chunk<HG, kF32>(smem, Y, buf, w, G, nkv, b, h, c, items.L[b], t);
    __syncthreads();  // stage buf and the single buffers are rewritten
  }
}

// Sets *blocks to the blocks of `kernel` the card holds at once with
// `smem` bytes of dynamic shared memory each, having opted the kernel in to
// them.  The runtime is asked once per (kernel, device, smem) and the answer
// kept: the decode calls this in every layer of every tick.  The opt-in is
// never lowered, so a kept answer for fewer bytes stays launchable.
// Returns smem_fit's code: 0, kSmemTooLarge or a CUDA error.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int* blocks) {
  struct Seen {
    const void* fn;
    int dev;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  size_t opted = 0;
  for (const Seen& s : seen) {
    if (s.fn != fn || s.dev != dev) continue;
    if (s.smem == smem) {
      *blocks = s.blocks;
      return 0;
    }
    opted = s.smem > opted ? s.smem : opted;
  }
  const int err = smem_fit(kernel, smem > opted ? smem : opted);
  if (err != 0) return err;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)e;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  seen.push_back({fn, dev, smem, *blocks});
  return 0;
}

// Pass 3: per (b, h) and 128 of its g * hd outputs, the sum over the live
// segments of their partial P.V and sum(e), each scaled by exp(m_t - M): m_t
// the running maximum of its tile, M the row's (its last tile's).  That is
// JAX's chain, acc = acc * alpha_t + acc_t over the tiles, with each
// partial's product of later alphas taken as one exponential; kLanes lanes
// of 32 threads take every kLanes-th segment, 4 outputs (a float4) a
// thread, and are added in lane order.
constexpr int kLanes = 8;

template <typename T>
__global__ void __launch_bounds__(kLanes * 32)
combine_kernel(const int* __restrict__ clen, Work w, Geometry G, int nh,
               int nkv, T* __restrict__ out) {
  __shared__ float4 red[kLanes][32];
  __shared__ float redl[kLanes][32];
  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x / 32;
  const int x = (blockIdx.x * 32 + lane) * 4;  // the first of 4 outputs
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = G.g, hd = G.hd;
  const bool ok = x < g * hd;
  const int j = ok ? x / hd : 0;
  const int d = x % hd;
  const int ns = G.live_segs(min(clen[b], G.smax));
  const size_t bh = (size_t)b * nkv + h;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  if (ok && ns > 0) {
    const float* mtj = w.mt + (bh * g + j) * G.ntile;
    const float M = mtj[G.seg_tile(ns - 1)];
#pragma unroll 4
    for (int s = r; s < ns; s += kLanes) {
      const float f = expf(mtj[G.seg_tile(s)] - M);
      const float4 v = *reinterpret_cast<const float4*>(
          w.pv + ((bh * G.nseg + s) * g + j) * hd + d);
      acc.x = fmaf(f, v.x, acc.x);
      acc.y = fmaf(f, v.y, acc.y);
      acc.z = fmaf(f, v.z, acc.z);
      acc.w = fmaf(f, v.w, acc.w);
      l = fmaf(f, w.pl[(bh * G.nseg + s) * g + j], l);
    }
  }
  red[r][lane] = acc;
  redl[r][lane] = l;
  __syncthreads();
  if (r != 0 || !ok) return;
  for (int i = 1; i < kLanes; ++i) {
    acc.x += red[i][lane].x;
    acc.y += red[i][lane].y;
    acc.z += red[i][lane].z;
    acc.w += red[i][lane].w;
    l += redl[i][lane];
  }
  const float den = fmaxf(l, 1e-30f);
  T* o = out + ((size_t)b * nh + (size_t)h * g + j) * hd + d;
  store(o, acc.x / den);
  store(o + 1, acc.y / den);
  store(o + 2, acc.z / den);
  store(o + 3, acc.w / den);
}

struct Call {
  const void *q, *kc, *ks, *vc, *vs, *tab, *clen;
  void* out;
  float* ws;
  int B, nh, nkv, span, nbmax;
  Geometry G;
};

template <typename T, bool kPaged, int HG, bool kF32>
int run(const Call& c, cudaStream_t st) {
  auto k1 = scores_kernel<T, kPaged, HG, kF32>;
  auto k2 = pv_kernel<kPaged, HG, kF32>;
  const size_t staging = 8 * (size_t)c.B;  // Items' two ints a row
  const size_t sm1 = ScoresSmem(c.G, sizeof(T)).items + staging;
  const size_t sm2 = PvSmem(c.G, HG).items + staging;
  int grid1 = 0, grid2 = 0;
  int err = resident_blocks(k1, sm1, &grid1);
  if (err == 0) err = resident_blocks(k2, sm2, &grid2);
  if (err != 0) return err;
  const long long items = (long long)c.B * c.nkv * c.G.nchunk;
  grid1 = (int)(grid1 < items ? grid1 : items);
  grid2 = (int)(grid2 < items ? grid2 : items);
  const Work w = carve(c.ws, c.B, c.nkv, c.G);
  auto tab = static_cast<const int*>(c.tab);
  auto cl = static_cast<const int*>(c.clen);
  k1<<<grid1, kThreads, sm1, st>>>(
      static_cast<const T*>(c.q), static_cast<const int8_t*>(c.kc),
      static_cast<const float*>(c.ks), tab, cl, w, c.G, c.B, c.nh, c.nkv,
      c.span, c.nbmax);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  k2<<<grid2, kThreads, sm2, st>>>(static_cast<const int8_t*>(c.vc),
                                   static_cast<const float*>(c.vs), tab, cl,
                                   w, c.G, c.B, c.nkv, c.span, c.nbmax);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 grid3((c.G.g * c.G.hd + 127) / 128, c.nkv, c.B);
  combine_kernel<T><<<grid3, kLanes * 32, 0, st>>>(cl, w, c.G, c.nh, c.nkv,
                                                 static_cast<T*>(c.out));
  return (int)cudaGetLastError();
}

template <bool kPaged, bool kF32>
int dispatch(const Call& c, bool bf16_io, cudaStream_t st) {
  const int g = c.G.g;
  if (bf16_io) {
    if (g == 1) return run<__nv_bfloat16, kPaged, 1, kF32>(c, st);
    if (g == 2) return run<__nv_bfloat16, kPaged, 2, kF32>(c, st);
    return run<__nv_bfloat16, kPaged, 4, kF32>(c, st);
  }
  if (g == 1) return run<float, kPaged, 1, kF32>(c, st);
  if (g == 2) return run<float, kPaged, 2, kF32>(c, st);
  return run<float, kPaged, 4, kF32>(c, st);
}

bool bad_args(int B, int nh, int nkv, int smax, int hd, int tile) {
  return B <= 0 || B > 65535 || nkv <= 0 || nkv > 65535 || nh % nkv ||
         hd % 16 || hd <= 0 || hd > 256 || tile <= 0 || smax <= 0;
}

}  // namespace

// The f32 workspace bytes both entries need for these arguments (smax: S,
// or nbmax * bs over the pool); negative: minus cudaErrorInvalidValue for
// arguments they refuse.
extern "C" long long decode_workspace_bytes(int B, int nh, int nkv, int smax,
                                            int hd, int tile) {
  if (bad_args(B, nh, nkv, smax, hd, tile))
    return -(long long)cudaErrorInvalidValue;
  return 4LL * (long long)work_floats(
                   B, nkv, make_geometry(nh / nkv, hd, smax, tile));
}

// q (B, nh, hd) bf16 (bf16_io = 1) or f32; caches (B, nkv, S, hd) int8 and
// scales (B, nkv, S) f32; cache_len (B,) int32, the live keys including the
// current one; out (B, nh, hd) like q; workspace: the bytes
// decode_workspace_bytes(B, nh, nkv, S, hd, sblk) asks for.  Any g = nh /
// nkv, hd % 16 == 0 and hd <= 256 (else cudaErrorInvalidValue).
extern "C" int flash_decode_attention_int8(
    const void* q, const void* k_cache, const void* k_scale,
    const void* v_cache, const void* v_scale, const void* cache_len,
    void* out, void* workspace, int B, int nh, int nkv, int S, int hd,
    int sblk, int bf16_io, void* stream) {
  if (bad_args(B, nh, nkv, S, hd, sblk) || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  const Call c{q, k_cache, k_scale, v_cache, v_scale, nullptr, cache_len,
               out, static_cast<float*>(workspace), B, nh, nkv, S, 0,
               make_geometry(nh / nkv, hd, S, sblk)};
  return dispatch<false, false>(c, bf16_io,
                                static_cast<cudaStream_t>(stream));
}

// The whole-cache decode: arguments as flash_decode_attention_int8's, with
// the f32 numerics over one tile of S keys; workspace: the bytes
// decode_workspace_bytes(B, nh, nkv, S, hd, S) asks for.
extern "C" int decode_attention_int8(const void* q, const void* k_cache,
                                     const void* k_scale, const void* v_cache,
                                     const void* v_scale,
                                     const void* cache_len, void* out,
                                     void* workspace, int B, int nh, int nkv,
                                     int S, int hd, int bf16_io,
                                     void* stream) {
  if (bad_args(B, nh, nkv, S, hd, S) || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  const Call c{q, k_cache, k_scale, v_cache, v_scale, nullptr, cache_len,
               out, static_cast<float*>(workspace), B, nh, nkv, S, 0,
               make_geometry(nh / nkv, hd, S, S)};
  return dispatch<false, true>(c, bf16_io,
                               static_cast<cudaStream_t>(stream));
}

// q (B, nh, hd) bf16 (bf16_io = 1) or f32; pools (nb, nkv, bs, hd) int8 and
// scales (nb, nkv, bs) f32; tables (B, nbmax) int32; cache_len (B,) int32,
// the live keys including the current one; out (B, nh, hd) like q;
// workspace: the bytes decode_workspace_bytes(B, nh, nkv, nbmax * bs, hd,
// sub) asks for.  Any g, hd % 16 == 0, hd <= 256, sub dividing bs.
extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* tables,
    const void* cache_len, void* out, void* workspace, int B, int nh,
    int nkv, int bs, int nbmax, int hd, int sub, int bf16_io, void* stream) {
  if (bad_args(B, nh, nkv, nbmax * bs, hd, sub) || bs % sub ||
      workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  const Call c{q, k_pool, k_scale, v_pool, v_scale, tables, cache_len,
               out, static_cast<float*>(workspace), B, nh, nkv, bs, nbmax,
               make_geometry(nh / nkv, hd, nbmax * bs, sub)};
  return dispatch<true, false>(c, bf16_io,
                               static_cast<cudaStream_t>(stream));
}
