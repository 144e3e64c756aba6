// Causal chunk (prefill) attention over the INT8 slot cache and over the
// paged block pool, for Hopper (sm_90a), CUDA cores.
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
// softmax whose probabilities are rounded to bf16 before P.V (:198-203)
// while the denominator sums them unrounded; out = acc / max(l, 1e-30).
// Over the pool, key s of row b lies at row (tab[b][s / bs] * nkv + h) * bs
// + s % bs of the (nb, nkv, bs, hd) pool, S = nbmax * bs; keys past the
// visible span are never read, so table entries past a row's live blocks
// are never looked up.
//
// What bounds it on the H100: operations, 4 * hd FLOPs (Q.K and P.V) per
// visible (query, key) pair, 4 * B * nh * hd * sum_t (clen + t + 1) in all,
// against 989 TFLOP/s of bf16 tensor cores.  This first kernel runs
// them on the CUDA cores in f32 (67 TFLOP/s at best), so it sits far above
// that bound; mma.sync / wgmma bf16 tiles are later work.
//
// Design: a block of 128 threads takes 64 query rows of one (b, kv head)
// (rows flattened as (g, T), so the g heads of a group share every K/V tile)
// and walks the keys in tiles of 32 up to the causal limit of its last row,
// skipping the dead upper triangle.  At the start of a tile the first 32
// threads look up the pool (or cache) row of its 32 keys, the one place the
// two layouts differ.  Q, K and V tiles sit in shared memory
// as bf16, rows padded by one 4-byte word so that the 8 threads of a row
// group hit 8 different banks.  Thread (ty, tx) computes a 4 x 4 block of
// scores (rows 4ty.., keys 4tx..); the row max and sum reduce over the 8 tx
// lanes by shuffles; the thread then accumulates 4 rows x hd/8 output dims,
// its dims interleaved with the other tx lanes so that V reads do not
// conflict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;  // query rows per block: 16 row groups of 4
constexpr int BK = 32;  // keys per tile: 8 key groups of 4
constexpr float kNegInf = -1e30f;

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

// kPaged: kc/ks/vc/vs are the (nb, nkv, bs, hd) pool and its scales, tab
// the (B, nbmax) tables, S = nbmax * bs; else the (B, nkv, S, hd) cache.
template <int HD, typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                  const float* __restrict__ ks,
                  const int8_t* __restrict__ vc,
                  const float* __restrict__ vs,
                  const int* __restrict__ tab,
                  const int* __restrict__ cache_len, T* __restrict__ out,
                  int nh, int nkv, int Tq, int S, int bs, int causal) {
  constexpr int LD = HD + 2;       // padded bf16 row stride (odd word count)
  constexpr int NP = HD / 16;      // output dim pairs per thread
  __shared__ __nv_bfloat16 Qs[BQ * LD];
  __shared__ __nv_bfloat16 Ks[BK * LD];
  __shared__ __nv_bfloat16 Vs[BK * LD];
  __shared__ float Ps[BQ][BK + 1];
  __shared__ long long krow[BK];  // cache / pool row of each key, -1: none

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int g = nh / nkv;
  const int M = g * Tq;
  const int r0 = blockIdx.x * BQ;
  const int clen = cache_len[b];
  const size_t bh = (size_t)b * nkv + h;
  // rows r = j * T + t of heads h*g .. h*g+g-1 are contiguous in q and out
  const size_t qbase = ((size_t)b * nh + (size_t)h * g) * Tq * HD;
  const float sq = sqrtf((float)HD);

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    const int r = r0 + rr;
    const float v = r < M ? to_f(q[qbase + (size_t)r * HD + d]) / sq : 0.f;
    Qs[rr * LD + d] = __float2bfloat16_rn(v);
  }

  // the last key any row of this block can see
  const int rlast = min(r0 + BQ, M) - 1;
  const int t_max = (r0 / Tq == rlast / Tq) ? rlast % Tq : Tq - 1;
  const int kend = min(S, causal ? clen + t_max + 1 : clen + Tq);

  int trow[4];
  float mrow[4], lrow[4];
  float2 acc[4][NP];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    trow[i] = (r0 + ty * 4 + i) % Tq;
    mrow[i] = kNegInf;
    lrow[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) acc[i][p] = make_float2(0.f, 0.f);
  }

  for (int s0 = 0; s0 < kend; s0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < BK) {
      const int s = s0 + tid;
      long long row = -1;
      if (s < kend)
        row = kPaged ? ((long long)tab[(size_t)b * (S / bs) + s / bs] * nkv
                        + h) * bs + s % bs
                     : (long long)(bh * S + s);
      krow[tid] = row;
    }
    __syncthreads();
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int kk = i / HD, d = i % HD;
      const long long row = krow[kk];
      float kv = 0.f, vv = 0.f;
      if (row >= 0) {
        kv = (float)kc[row * HD + d] * bf16r(ks[row]);
        vv = (float)vc[row * HD + d] * bf16r(vs[row]);
      }
      Ks[kk * LD + d] = __float2bfloat16_rn(kv);
      Vs[kk * LD + d] = __float2bfloat16_rn(vv);
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    const __nv_bfloat162* Q2 = reinterpret_cast<const __nv_bfloat162*>(Qs);
    const __nv_bfloat162* K2 = reinterpret_cast<const __nv_bfloat162*>(Ks);
#pragma unroll 4
    for (int dp = 0; dp < HD / 2; ++dp) {
      float2 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = __bfloat1622float2(Q2[((ty * 4 + i) * LD) / 2 + dp]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = __bfloat1622float2(K2[((tx * 4 + j) * LD) / 2 + dp]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = s0 + tx * 4 + j;
        bool ok = key < S && key < clen + Tq;
        if (causal) ok = ok && key <= clen + trow[i];
        if (!ok) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(mrow[i], mx);
      const float alpha = expf(mrow[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(sc[i][j] - mn);
        sum += e;
        Ps[ty * 4 + i][tx * 4 + j] = bf16r(e);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      lrow[i] = lrow[i] * alpha + sum;
      mrow[i] = mn;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        acc[i][p].x *= alpha;
        acc[i][p].y *= alpha;
      }
    }
    __syncthreads();

    const __nv_bfloat162* V2 = reinterpret_cast<const __nv_bfloat162*>(Vs);
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[ty * 4 + i][kk];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float2 v = __bfloat1622float2(V2[(kk * LD) / 2 + tx + 8 * p]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][p].x = fmaf(pv[i], v.x, acc[i][p].x);
          acc[i][p].y = fmaf(pv[i], v.y, acc[i][p].y);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r < M) {
      const float den = fmaxf(lrow[i], 1e-30f);
      T* o = out + qbase + (size_t)r * HD;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int d = 2 * (tx + 8 * p);
        store(o + d, acc[i][p].x / den);
        store(o + d + 1, acc[i][p].y / den);
      }
    }
  }
}

template <int HD, typename T, bool kPaged>
void launch(const void* q, const void* kc, const void* ks, const void* vc,
            const void* vs, const void* tab, const void* cl, void* out,
            int B, int nh, int nkv, int Tq, int S, int bs, int causal,
            cudaStream_t st) {
  const int M = (nh / nkv) * Tq;
  const dim3 grid((M + BQ - 1) / BQ, nkv, B);
  flash_attn_kernel<HD, T, kPaged><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int*>(tab),
      static_cast<const int*>(cl), static_cast<T*>(out), nh, nkv, Tq, S, bs,
      causal);
}

template <bool kPaged>
int dispatch(const void* q, const void* kc, const void* ks, const void* vc,
             const void* vs, const void* tab, const void* cl, void* out,
             int B, int nh, int nkv, int Tq, int S, int bs, int hd,
             int causal, int bf16_io, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (hd == 128) {
    if (bf16_io)
      launch<128, __nv_bfloat16, kPaged>(q, kc, ks, vc, vs, tab, cl, out, B,
                                         nh, nkv, Tq, S, bs, causal, st);
    else
      launch<128, float, kPaged>(q, kc, ks, vc, vs, tab, cl, out, B, nh, nkv,
                                 Tq, S, bs, causal, st);
  } else if (hd == 64) {
    if (bf16_io)
      launch<64, __nv_bfloat16, kPaged>(q, kc, ks, vc, vs, tab, cl, out, B,
                                        nh, nkv, Tq, S, bs, causal, st);
    else
      launch<64, float, kPaged>(q, kc, ks, vc, vs, tab, cl, out, B, nh, nkv,
                                Tq, S, bs, causal, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, nh, T, hd) bf16 (bf16_io = 1) or f32; caches (B, nkv, S, hd) int8
// and scales (B, nkv, S) f32 holding the chunk at [cache_len, cache_len + T);
// cache_len (B,) int32; out (B, nh, T, hd) like q.  hd in {64, 128}.
extern "C" int flash_attention_int8(const void* q, const void* k_cache,
                                    const void* k_scale, const void* v_cache,
                                    const void* v_scale, const void* cache_len,
                                    void* out, int B, int nh, int nkv, int T,
                                    int S, int hd, int causal, int bf16_io,
                                    void* stream) {
  return dispatch<false>(q, k_cache, k_scale, v_cache, v_scale, nullptr,
                         cache_len, out, B, nh, nkv, T, S, S, hd, causal,
                         bf16_io, stream);
}

// q (B, nh, T, hd) bf16 (bf16_io = 1) or f32; pools (nb, nkv, bs, hd) int8
// and scales (nb, nkv, bs) f32 holding the chunk at positions [cache_len,
// cache_len + T) of each row's table; tables (B, nbmax) int32; cache_len
// (B,) int32; out (B, nh, T, hd) like q.  hd in {64, 128}.
extern "C" int paged_flash_attention_int8(
    const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* tables,
    const void* cache_len, void* out, int B, int nh, int nkv, int T, int bs,
    int nbmax, int hd, int causal, int bf16_io, void* stream) {
  return dispatch<true>(q, k_pool, k_scale, v_pool, v_scale, tables,
                        cache_len, out, B, nh, nkv, T, nbmax * bs, bs, hd,
                        causal, bf16_io, stream);
}
