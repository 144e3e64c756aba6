// Decode (T = 1) GQA attention over the INT8 slot cache, for Hopper (sm_90a).
//
// Replaces: qqq_tpu/kernels/attention.py:_decode_attn_kernel (:33), reached
// through decode_attention_int8 (:977, call :1021) from
// decode_attention_auto (:952) for S <= 8192.
//
// Computes, in f32, for the g = nh / nkv query heads of each kv head:
// q' = q / sqrt(hd); score[s] = (q' . K_i8[s]) * k_scale[s]; positions
// s >= cache_len (which counts the current token) are masked; p = softmax;
// out = sum_s p[s] * v_scale[s] * V_i8[s].
//
// What bounds it on the H100: bytes, the K and V codes and scales of the
// valid positions, B * nkv * L * (hd + 4) * 2 at 3.35 TB/s.
//
// Design: one block of 128 threads per (b, kv head) serves all g query
// heads, so each K/V byte is read once for the group (the TPU kernel's GQA
// trick).  The TPU kernel holds the whole (S, hd) head block in VMEM and
// takes one softmax; a block here has no room for that, so it walks the
// valid positions in tiles of 128 with an online softmax.  In a tile,
// thread t scores key t (its K row is 8 contiguous 16-byte loads; the
// scaled q sits in shared memory and is read as a broadcast), the block
// reduces the tile's max and sum, and thread d accumulates output dim d over
// the tile's keys (V is read one coalesced byte row per key).  Only tiles
// below cache_len are read.  The f32 sums are reassociated against the
// one-pass softmax of the plain version, which sets the stated tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // = key tile width = largest head_dim
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                   const float* __restrict__ ks,
                   const int8_t* __restrict__ vc,
                   const float* __restrict__ vs,
                   const int* __restrict__ clen, T* __restrict__ out, int nh,
                   int nkv, int S, int hd) {
  __shared__ float qs[kMaxG][kThreads];
  __shared__ float p[kMaxG][kThreads];
  __shared__ float red[kMaxG][kWarps];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = nh / nkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bh = (size_t)b * nkv + h;
  const size_t qrow = (size_t)b * nh + (size_t)h * g;  // first query head
  const float sq = sqrtf((float)hd);

  for (int i = tid; i < g * hd; i += kThreads)
    qs[i / hd][i % hd] = to_f(q[qrow * hd + i]) / sq;
  const int L = min(clen[b], S);

  float m[kMaxG], l[kMaxG], acc[kMaxG];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
    acc[j] = 0.f;
  }
  __syncthreads();

  for (int s0 = 0; s0 < L; s0 += kThreads) {
    const int s = s0 + tid;
    float sc[kMaxG];
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) sc[j] = 0.f;
    if (s < L) {
      const int4* kr = reinterpret_cast<const int4*>(kc + (bh * S + s) * hd);
      for (int c = 0; c < hd / 16; ++c) {
        const int4 v = __ldg(kr + c);
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const float kv = (float)k8[u];
#pragma unroll
          for (int j = 0; j < kMaxG; ++j)
            if (j < g) sc[j] = fmaf(qs[j][c * 16 + u], kv, sc[j]);
        }
      }
      const float ksc = ks[bh * S + s];
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) sc[j] *= ksc;
    } else {
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) sc[j] = kNegInf;
    }

    // tile max per query head
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      float v = sc[j];
      for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0 && j < g) red[j][warp] = v;
    }
    __syncthreads();
    float alpha[kMaxG], e[kMaxG];
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      if (j < g) {
        float mt = red[j][0];
        for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, red[j][w]);
        const float mn = fmaxf(m[j], mt);
        alpha[j] = expf(m[j] - mn);
        e[j] = s < L ? expf(sc[j] - mn) : 0.f;
        m[j] = mn;
      } else {
        alpha[j] = 0.f;
        e[j] = 0.f;
      }
    }
    __syncthreads();  // everyone has read the maxima
    // tile sum per query head; probabilities with v_scale folded in
    const float vsc = s < L ? vs[bh * S + s] : 0.f;
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      if (j < g) p[j][tid] = e[j] * vsc;
      float v = e[j];
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0 && j < g) red[j][warp] = v;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      if (j < g) {
        float ts = red[j][0];
        for (int w = 1; w < kWarps; ++w) ts += red[j][w];
        l[j] = l[j] * alpha[j] + ts;
      }
    }
    if (tid < hd) {
      const int n = min(kThreads, L - s0);
      const int8_t* vcol = vc + (bh * S + s0) * hd + tid;
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) acc[j] *= alpha[j];
      for (int t = 0; t < n; ++t) {
        const float vv = (float)vcol[(size_t)t * hd];
#pragma unroll
        for (int j = 0; j < kMaxG; ++j)
          if (j < g) acc[j] = fmaf(p[j][t], vv, acc[j]);
      }
    }
    __syncthreads();  // p and red are rewritten by the next tile
  }

  if (tid < hd) {
#pragma unroll
    for (int j = 0; j < kMaxG; ++j)
      if (j < g) store(out + (qrow + j) * hd + tid, acc[j] / l[j]);
  }
}

}  // namespace

// q (B, nh, hd) bf16 (bf16_io = 1) or f32; caches (B, nkv, S, hd) int8 and
// scales (B, nkv, S) f32; cache_len (B,) int32 >= 1; out (B, nh, hd) like q.
// nh / nkv <= 8, hd <= 128 and hd % 16 == 0.
extern "C" int decode_attention_int8(const void* q, const void* k_cache,
                                     const void* k_scale, const void* v_cache,
                                     const void* v_scale,
                                     const void* cache_len, void* out, int B,
                                     int nh, int nkv, int S, int hd,
                                     int bf16_io, void* stream) {
  const dim3 grid(B, nkv);
  auto st = static_cast<cudaStream_t>(stream);
  auto kc = static_cast<const int8_t*>(k_cache);
  auto vc = static_cast<const int8_t*>(v_cache);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto cl = static_cast<const int*>(cache_len);
  if (bf16_io)
    decode_attn_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), kc, ks, vc, vs, cl,
        static_cast<__nv_bfloat16*>(out), nh, nkv, S, hd);
  else
    decode_attn_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), kc, ks, vc, vs, cl,
        static_cast<float*>(out), nh, nkv, S, hd);
  return (int)cudaGetLastError();
}
