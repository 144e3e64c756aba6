// Causal chunk (prefill) attention over the INT8 slot cache and over the
// paged block pool, on the bf16 tensor cores of Hopper (sm_90a).
//
// Replaces: qqq_tpu/kernels/attention.py:_flash_attn_kernel (:89), reached
// through flash_attention_int8 (:249, call :384) with qk_int8 = False; and
// _paged_flash_kernel (:404), reached through paged_flash_attention_int8
// (:422), whose body is the same kernel over K/V blocks fetched through the
// block table.
//
// Computes, for the (g * T) query rows of each (b, kv head): query row t sits
// at position clen + t (clen excludes the chunk, whose K/V are already in the
// cache); it sees keys < clen + T and, causally, keys <= clen + t.  The
// numerics are the JAX kernel's: q scaled by 1/sqrt(hd) in f32 then rounded
// to bf16 (:317-320, :345); K and V tiles dequantized as bf16(code) *
// bf16(scale) rounded to bf16 (:149-151); scores summed in f32; an online
// softmax (exp by the fast __expf, an f32 rounding away from the plain
// version's) over 32-key steps (kernels/attention.py:_FLASH_KEY_TILE, whatever
// the load stage) whose probabilities are rounded to bf16 against the
// running maximum before P.V (:198-203) while the denominator sums them
// unrounded; out = acc / max(l, 1e-30).  Over the pool, key s of row b lies
// at row (tab[b][s / bs] * nkv + h) * bs + s % bs of the (nb, nkv, bs, hd)
// pool, S = nbmax * bs; keys past the visible span are never read, so table
// entries past a row's live blocks are never looked up.
//
// What bounds it on the H100: operations, 4 * hd FLOPs (Q.K and P.V) per
// visible (query, key) pair, 4 * B * nh * hd * sum_t (clen + t + 1) in all,
// against 989 TFLOP/s of bf16 tensor cores.
//
// Design (FlashAttention-2 on mma.sync.m16n8k16 bf16), one kernel for both
// layouts:
// a block of 8 warps takes 128 query rows of one (b, kv head), rows
// flattened as (g, T) so that the g heads of a group share every K/V tile;
// warp w owns rows 16w..16w+15, whose q' fragments are loaded once
// (ldmatrix) and stay in registers for the whole walk.  Keys arrive in
// stages of 64: each stage's K/V codes and scales come by cp.async (16-byte
// copies, rows found by KeyRows, the one place the cache layout enters)
// into a 3-slot ring two stages ahead of the math, and the block
// dequantizes each stage once into bf16 K and V tiles whose rows are padded
// by 8 bf16 (16-byte aligned, conflict-free ldmatrix).  Per 32-key softmax
// step a warp forms S = Q.K^T in f32 accumulators (K by ldmatrix), masks
// only on steps that cross the diagonal or the end, reduces the row max
// and sum over the 4 lanes of a quad, rounds e to bf16 straight into the A
// fragments of P.V (the m16n8 accumulator layout is the m16n8k16 A layout),
// rescales acc by alpha and adds P.V (V by ldmatrix.trans).  A block walks
// keys only up to its last row's causal limit, and the grid launches the
// longest rows first so that the causal tail does not finish on a few SMs.
// Over the pool each copied key row is looked up on its own (a 64-key stage
// spans several blocks when bs < 64), the table entry read through the
// read-only cache.  Everything past the copies is the slot kernel's, so the
// paged kernel on a pool is bit-identical to the slot kernel on the pool
// gathered through the tables.  The head dim is a template parameter,
// instantiated at 64, 96, 128 and 256 (JAX's kernels take any); at 256 a
// thread holds 128 f32 accumulators and 64 q' registers, and a block 164
// KiB of shared memory, which smem_fit opts in to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_fit.cuh"

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

constexpr int kThreads = 256;  // 8 warps
constexpr int BQ = 128;        // query rows a block, 16 a warp
constexpr int BKS = 64;        // keys a load stage
constexpr int BK = 32;         // keys a softmax step (_FLASH_KEY_TILE)
constexpr int kRing = 3;       // cp.async stages, kRing - 1 ahead
static_assert(BKS % BK == 0 && BQ == 2 * BKS, "Q staging overlays K and V");

template <int HD>
struct TcLayout {
  static constexpr int LD = HD + 8;  // padded bf16 row of the K / V / Q tiles
  static constexpr int kCodes = 2 * BKS * HD;  // K then V codes of a stage
  static constexpr int kScales = 2 * BKS * 4;  // K then V scales
  static constexpr int kSlot = kCodes + kScales;
  static constexpr int kOffK = kRing * kSlot;  // bf16 [BKS][LD]
  static constexpr int kOffV = kOffK + BKS * LD * 2;
  static constexpr int kBytes = kOffV + BKS * LD * 2;
};

// The cache row of key s of (b, kv head h): the one place the layout enters
// the walk.  Slot: row (b * nkv + h) * S + s of the (B, nkv, S, hd) cache.
// Paged: row (tab[b][s / bs] * nkv + h) * bs + s % bs of the (nb, nkv, bs,
// hd) pool, S = nbmax * bs.
template <bool kPaged>
struct KeyRows;

template <>
struct KeyRows<false> {
  long long base;
  static __device__ KeyRows make(const int*, int b, int h, int nkv, int S,
                                 int) {
    return {((long long)b * nkv + h) * S};
  }
  __device__ long long operator()(int s) const { return base + s; }
};

template <>
struct KeyRows<true> {
  const int* tab;  // row b's table
  int nkv, h, bs;
  static __device__ KeyRows make(const int* tables, int b, int h, int nkv,
                                 int S, int bs) {
    return {tables + (size_t)b * (S / bs), nkv, h, bs};
  }
  __device__ long long operator()(int s) const {
    return ((long long)__ldg(tab + s / bs) * nkv + h) * bs + s % bs;
  }
};

__device__ __forceinline__ void cp16z(uint32_t dst, const void* src,
                                      bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4z(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm4(uint32_t addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d (16 x 8 f32) += a (16 x 16 bf16) . b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Issue the copies of load stage `st` (keys st*BKS ..) into ring slot
// st % kRing; keys at or past kend are zero-filled, never read.
template <int HD, class Rows>
__device__ __forceinline__ void load_stage(
    uint8_t* smem, const int8_t* kc, const float* ks, const int8_t* vc,
    const float* vs, const Rows& rows, int kend, int st, int tid) {
  using L = TcLayout<HD>;
  const uint32_t slot =
      (uint32_t)__cvta_generic_to_shared(smem + (st % kRing) * L::kSlot);
  constexpr int kChunks = BKS * HD / 16;  // 16-byte chunks of K (and of V)
  // each key row found once for its K and V copies (hd = 96: a last pass
  // of half the threads)
#pragma unroll
  for (int id = tid; id < kChunks; id += kThreads) {
    const int kk = id / (HD / 16), c = id % (HD / 16);
    const int s = st * BKS + kk;
    const bool ok = s < kend;
    const long long row = rows(ok ? s : 0);
    cp16z(slot + kk * HD + c * 16, kc + row * HD + c * 16, ok);
    cp16z(slot + (BKS + kk) * HD + c * 16, vc + row * HD + c * 16, ok);
  }
  if (tid < BKS) {  // K and V scales, one key a thread
    const int s = st * BKS + tid;
    const bool ok = s < kend;
    const long long row = rows(ok ? s : 0);
    cp4z(slot + L::kCodes + tid * 4, ks + row, ok);
    cp4z(slot + L::kCodes + (BKS + tid) * 4, vs + row, ok);
  }
}

// tab (B, S / bs) tables and bs: the pool's (kPaged); unused for the slot
// cache.
template <int HD, typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                const float* __restrict__ ks, const int8_t* __restrict__ vc,
                const float* __restrict__ vs, const int* __restrict__ tab,
                const int* __restrict__ cache_len, T* __restrict__ out,
                int nh, int nkv, int Tq, int S, int bs, int causal) {
  using L = TcLayout<HD>;
  constexpr int LD = L::LD;
  constexpr int KC = HD / 16;  // k16 chunks of a q' row
  constexpr int ND = HD / 8;   // n8 slices of an output row
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Kt = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffK);
  __nv_bfloat16* Vt = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffV);
  const uint32_t kt_s = (uint32_t)__cvta_generic_to_shared(Kt);
  const uint32_t vt_s = (uint32_t)__cvta_generic_to_shared(Vt);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest rows first
  const int g = nh / nkv;
  const int M = g * Tq;
  const int clen = cache_len[b];
  const auto rows = KeyRows<kPaged>::make(tab, b, h, nkv, S, bs);
  // rows r = j * T + t of heads h*g .. h*g+g-1 are contiguous in q and out
  const size_t qbase = ((size_t)b * nh + (size_t)h * g) * Tq * HD;

  // the last key any row of this block can see
  const int rlast = min(r0 + BQ, M) - 1;
  const int t_max = (r0 / Tq == rlast / Tq) ? rlast % Tq : Tq - 1;
  const int kend = min(S, causal ? clen + t_max + 1 : clen + Tq);
  const int nst = (kend + BKS - 1) / BKS;

#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < nst) load_stage<HD>(smem, kc, ks, vc, vs, rows, kend, i, tid);
    cp_commit();
  }

  // q' = bf16(q / sqrt(hd)), staged through the K and V tiles for ldmatrix
  const float sq = sqrtf((float)HD);
  for (int i = tid; i < BQ * HD / 2; i += kThreads) {
    const int rr = i / (HD / 2), d = 2 * (i % (HD / 2));
    const int r = r0 + rr;
    float x0 = 0.f, x1 = 0.f;
    if (r < M) {
      x0 = to_f(q[qbase + (size_t)r * HD + d]) / sq;
      x1 = to_f(q[qbase + (size_t)r * HD + d + 1]) / sq;
    }
    *reinterpret_cast<unsigned*>(Kt + rr * LD + d) = pack_bf16(x0, x1);
  }
  __syncthreads();
  unsigned qf[KC][4];
  {
    const int rr = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kc2 = 0; kc2 < KC; ++kc2)
      ldsm4(kt_s + (rr * LD + 16 * kc2 + 8 * (lane >> 4)) * 2, qf[kc2]);
  }

  // this lane's two rows (g and g + 8 of the warp's 16): the keys each may
  // see, and the warp's least, below which a softmax step needs no mask
  int lim[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * e;
    lim[e] = 0x7fffffff;  // padding rows: unmasked, never stored
    if (r < M) {
      const int t = r % Tq;
      lim[e] = min(S, causal ? clen + t + 1 : clen + Tq);
    }
  }
  int kfull = min(lim[0], lim[1]);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    kfull = min(kfull, __shfl_xor_sync(0xffffffffu, kfull, o));

  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int st = 0; st < nst; ++st) {
    cp_wait<kRing - 2>();  // this thread's copies of stage st have landed
    __syncthreads();  // everyone's; the K/V tiles and slot st - 1 are free
    if (st + kRing - 1 < nst)
      load_stage<HD>(smem, kc, ks, vc, vs, rows, kend, st + kRing - 1, tid);
    cp_commit();
    {  // dequantize: bf16(code * bf16(scale)), 8 codes a thread a pass
      const uint8_t* slot = smem + (st % kRing) * L::kSlot;
      const float* sc = reinterpret_cast<const float*>(slot + L::kCodes);
      for (int i = tid; i < 2 * BKS * HD / 8; i += kThreads) {
        const int v = i / (BKS * HD / 8);
        const int kk = (i % (BKS * HD / 8)) / (HD / 8);
        const int d = 8 * (i % (HD / 8));
        const uint2 raw = *reinterpret_cast<const uint2*>(
            slot + (v * BKS + kk) * HD + d);
        const float f = bf16r(sc[v * BKS + kk]);
        const int8_t* c8 = reinterpret_cast<const int8_t*>(&raw);
        uint4 o;
        o.x = pack_bf16((float)c8[0] * f, (float)c8[1] * f);
        o.y = pack_bf16((float)c8[2] * f, (float)c8[3] * f);
        o.z = pack_bf16((float)c8[4] * f, (float)c8[5] * f);
        o.w = pack_bf16((float)c8[6] * f, (float)c8[7] * f);
        *reinterpret_cast<uint4*>((v ? Vt : Kt) + kk * LD + d) = o;
      }
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < BKS / BK; ++half) {
      const int s0 = st * BKS + half * BK;
      if (s0 >= kend) break;
      // S = Q . K^T over 32 keys: 4 n8 slices
      float sc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kc2 = 0; kc2 < KC; ++kc2) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned kb[4];
          const int key = half * BK + 16 * np + (lane & 7) + 8 * (lane >> 4);
          ldsm4(kt_s + (key * LD + 16 * kc2 + 8 * ((lane >> 3) & 1)) * 2,
                kb);
          mma_bf16(sc[2 * np], qf[kc2], kb[0], kb[1]);
          mma_bf16(sc[2 * np + 1], qf[kc2], kb[2], kb[3]);
        }
      }
      if (s0 + BK > kfull) {  // the step crosses the diagonal or the end
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (s0 + 8 * j + 2 * (lane & 3) + (e & 1) >= lim[e >> 1])
              sc[j][e] = kNegInf;
      }
      // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
      float alpha[2];
      unsigned pa[2][4];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * hr], sc[j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m_i[hr], mx);
        alpha[hr] = __expf(m_i[hr] - mn);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e0 = __expf(sc[j][2 * hr] - mn);
          const float e1 = __expf(sc[j][2 * hr + 1] - mn);
          sum += e0 + e1;
          // slice j's (row, key pair) is A register hr + 2 (j % 2) of the
          // k16 chunk j / 2 of P.V
          pa[j >> 1][hr + 2 * (j & 1)] = pack_bf16(e0, e1);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_i[hr] = l_i[hr] * alpha[hr] + sum;
        m_i[hr] = mn;
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      // acc += P . V over the step's 32 keys: 2 k16 chunks
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int key = half * BK + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          unsigned vb[4];
          ldsm4t(vt_s + (key * LD + 16 * dp + 8 * (lane >> 4)) * 2, vb);
          mma_bf16(acc[2 * dp], pa[kk], vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * hr;
    if (r >= M) continue;
    const float den = fmaxf(l_i[hr], 1e-30f);
    T* o = out + qbase + (size_t)r * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store2(o + 8 * j, acc[j][2 * hr] / den, acc[j][2 * hr + 1] / den);
  }
}

template <int HD, typename T, bool kPaged>
int launch_tc(const void* q, const void* kc, const void* ks, const void* vc,
              const void* vs, const void* tab, const void* cl, void* out,
              int B, int nh, int nkv, int Tq, int S, int bs, int causal,
              cudaStream_t st) {
  auto kernel = flash_tc_kernel<HD, T, kPaged>;
  const int fit = smem_fit(kernel, TcLayout<HD>::kBytes);
  if (fit != 0) return fit;
  const int M = (nh / nkv) * Tq;
  const dim3 grid(nkv, B, (M + BQ - 1) / BQ);
  kernel<<<grid, kThreads, TcLayout<HD>::kBytes, st>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int*>(tab),
      static_cast<const int*>(cl), static_cast<T*>(out), nh, nkv, Tq, S, bs,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, nh, T, hd) bf16 (bf16_io = 1) or f32; caches (B, nkv, S, hd) int8
// and scales (B, nkv, S) f32 holding the chunk at [cache_len, cache_len + T);
// cache_len (B,) int32; out (B, nh, T, hd) like q.  hd in {64, 96, 128, 256}.
extern "C" int flash_attention_int8(const void* q, const void* k_cache,
                                    const void* k_scale, const void* v_cache,
                                    const void* v_scale, const void* cache_len,
                                    void* out, int B, int nh, int nkv, int T,
                                    int S, int hd, int causal, int bf16_io,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define FL_LAUNCH(HD_, T_)                                                   \
  launch_tc<HD_, T_, false>(q, k_cache, k_scale, v_cache, v_scale, nullptr, \
                            cache_len, out, B, nh, nkv, T, S, 1, causal, st)
  switch (hd) {
    case 64: return bf16_io ? FL_LAUNCH(64, __nv_bfloat16) : FL_LAUNCH(64, float);
    case 96: return bf16_io ? FL_LAUNCH(96, __nv_bfloat16) : FL_LAUNCH(96, float);
    case 128:
      return bf16_io ? FL_LAUNCH(128, __nv_bfloat16) : FL_LAUNCH(128, float);
    case 256:
      return bf16_io ? FL_LAUNCH(256, __nv_bfloat16) : FL_LAUNCH(256, float);
  }
#undef FL_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// q (B, nh, T, hd) bf16 (bf16_io = 1) or f32; pools (nb, nkv, bs, hd) int8
// and scales (nb, nkv, bs) f32 holding the chunk at positions [cache_len,
// cache_len + T) of each row's table; tables (B, nbmax) int32; cache_len
// (B,) int32; out (B, nh, T, hd) like q.  hd in {64, 96, 128, 256}.
extern "C" int paged_flash_attention_int8(
    const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* tables,
    const void* cache_len, void* out, int B, int nh, int nkv, int T, int bs,
    int nbmax, int hd, int causal, int bf16_io, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int S = nbmax * bs;
#define PG_LAUNCH(HD_, T_)                                                 \
  launch_tc<HD_, T_, true>(q, k_pool, k_scale, v_pool, v_scale, tables,    \
                           cache_len, out, B, nh, nkv, T, S, bs, causal, st)
  switch (hd) {
    case 64: return bf16_io ? PG_LAUNCH(64, __nv_bfloat16) : PG_LAUNCH(64, float);
    case 96: return bf16_io ? PG_LAUNCH(96, __nv_bfloat16) : PG_LAUNCH(96, float);
    case 128:
      return bf16_io ? PG_LAUNCH(128, __nv_bfloat16) : PG_LAUNCH(128, float);
    case 256:
      return bf16_io ? PG_LAUNCH(256, __nv_bfloat16) : PG_LAUNCH(256, float);
  }
#undef PG_LAUNCH
  return (int)cudaErrorInvalidValue;
}
