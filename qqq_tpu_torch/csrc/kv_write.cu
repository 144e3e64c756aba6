// INT8 KV writes into the fixed-slot cache and into the paged block pool,
// for Hopper (sm_90a).
//
// Replaces: qqq_tpu/kernels/kv_write.py:_slot_write_kernel (:36), reached
// through slot_decode_write_int8 (:74, call :136); _write_kernel (:158),
// reached through paged_decode_write_int8 (:359) / _paged_decode_write_call
// (:406); _chunk_write_kernel (:183), reached through paged_chunk_write_int8
// (:217); each together with the quantization serve/kv_cache.py:_quant
// (:42) that runs in front of it.
//
// Computes, for each token row, (b, kv head) and for K and V: s =
// max(absmax(x) / 127, FLT_MIN), q = clip(rint(x / s), -128, 127) over
// head_dim, and writes q and s in place.  IEEE division and
// round-half-even (rintf, no fast math), so codes and scales are
// bit-identical to the plain PyTorch versions.  Destinations:
// * slot: position min(cache_len[b], S - 1) of row b;
// * paged decode: position p = cache_len[b] in pool block tab[b][p / bs]
//   at p % bs, or the null block 0 when p / bs >= nbmax;
// * paged chunk: token t at position p = cache_len[b] + t, addressed the
//   same way.
//
// What bounds them on the H100: bytes, and few of them (per token row
// nkv * 2 * (hd * 2 + hd + 4)); at decode the launch itself dominates.
//
// Design: one block per (token row, kv head, K|V).  The TPU kernels stream
// whole tiles or pool blocks, select the new rows in and write them back,
// because Mosaic stores whole tiles (and the paged ones only exist behind a
// flag, for a v5e fault with data-dependent output index maps that Hopper
// does not have).  A GPU thread stores one byte, so here a block writes
// only the hd codes and the one scale of its token: the paged writes are
// plain scatters (vLLM's reshape_and_cache), and the chunk needs none of
// the TPU wrapper's pre-shift for sublane alignment.  The absmax is a
// warp-shuffle reduction followed by one pass through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Quantize the hd values at x and store codes at row[0..hd) and the scale
// at *scale; every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void quant_store(const T* __restrict__ x, int hd,
                                            int8_t* __restrict__ row,
                                            float* __restrict__ scale) {
  __shared__ float wmax[kThreads / 32];
  float amax = 0.f;
  for (int d = threadIdx.x; d < hd; d += kThreads)
    amax = fmaxf(amax, fabsf(to_f(x[d])));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = wmax[0];
  for (int i = 1; i < kThreads / 32; ++i) amax = fmaxf(amax, wmax[i]);

  const float s = fmaxf(amax / 127.0f, FLT_MIN);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    const float q = fminf(fmaxf(rintf(to_f(x[d]) / s), -128.f), 127.f);
    row[d] = (int8_t)q;
  }
  if (threadIdx.x == 0) *scale = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
slot_write_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                  int8_t* __restrict__ k_cache, float* __restrict__ k_scale,
                  int8_t* __restrict__ v_cache, float* __restrict__ v_scale,
                  const int* __restrict__ cache_len, int nkv, int S, int hd) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const bool is_v = blockIdx.z != 0;
  const size_t bh = (size_t)b * nkv + h;
  const int pos = max(0, min(cache_len[b], S - 1));
  const size_t slot = bh * S + pos;
  quant_store((is_v ? v_new : k_new) + bh * hd, hd,  // (B, 1, nkv, hd)
              (is_v ? v_cache : k_cache) + slot * hd,
              (is_v ? v_scale : k_scale) + slot);
}

// Token row r = b * T + t of a (B, T, nkv, hd) input goes to position
// cache_len[b] + t of row b's table; the decode instance has T = 1.
template <typename T, bool kDecode>
__global__ void __launch_bounds__(kThreads)
paged_write_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                   int8_t* __restrict__ k_pool, float* __restrict__ k_scale,
                   int8_t* __restrict__ v_pool, float* __restrict__ v_scale,
                   const int* __restrict__ tables,
                   const int* __restrict__ cache_len, int Tn, int nkv,
                   int bs, int nbmax, int hd) {
  const int r = blockIdx.x;
  const int b = kDecode ? r : r / Tn;
  const int h = blockIdx.y;
  const bool is_v = blockIdx.z != 0;
  const int pos = kDecode ? cache_len[b] : cache_len[b] + r % Tn;
  const int vb = pos / bs;
  const size_t phys = vb >= nbmax ? 0 : tables[(size_t)b * nbmax + vb];
  const size_t slot = (phys * nkv + h) * bs + pos % bs;
  quant_store((is_v ? v_new : k_new) + ((size_t)r * nkv + h) * hd, hd,
              (is_v ? v_pool : k_pool) + slot * hd,
              (is_v ? v_scale : k_scale) + slot);
}

}  // namespace

// k_new, v_new (B, 1, nkv, hd) bf16 (bf16_in = 1) or f32; caches
// (B, nkv, S, hd) int8 and scales (B, nkv, S) f32, written in place;
// cache_len (B,) int32.
extern "C" int slot_decode_write_int8(const void* k_new, const void* v_new,
                                      void* k_cache, void* k_scale,
                                      void* v_cache, void* v_scale,
                                      const void* cache_len, int B, int nkv,
                                      int S, int hd, int bf16_in,
                                      void* stream) {
  const dim3 grid(B, nkv, 2);
  auto st = static_cast<cudaStream_t>(stream);
  auto kc = static_cast<int8_t*>(k_cache);
  auto vc = static_cast<int8_t*>(v_cache);
  auto ks = static_cast<float*>(k_scale);
  auto vs = static_cast<float*>(v_scale);
  auto cl = static_cast<const int*>(cache_len);
  if (bf16_in)
    slot_write_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new), kc, ks, vc, vs, cl, nkv, S,
        hd);
  else
    slot_write_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(k_new), static_cast<const float*>(v_new),
        kc, ks, vc, vs, cl, nkv, S, hd);
  return (int)cudaGetLastError();
}

namespace {

template <bool kDecode>
int launch_paged(const void* k_new, const void* v_new, void* k_pool,
                 void* k_scale, void* v_pool, void* v_scale,
                 const void* tables, const void* cache_len, int B, int T,
                 int nkv, int bs, int nbmax, int hd, int bf16_in,
                 void* stream) {
  const dim3 grid(B * T, nkv, 2);
  auto st = static_cast<cudaStream_t>(stream);
  auto kp = static_cast<int8_t*>(k_pool);
  auto vp = static_cast<int8_t*>(v_pool);
  auto ks = static_cast<float*>(k_scale);
  auto vs = static_cast<float*>(v_scale);
  auto tab = static_cast<const int*>(tables);
  auto cl = static_cast<const int*>(cache_len);
  if (bf16_in)
    paged_write_kernel<__nv_bfloat16, kDecode><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new), kp, ks, vp, vs, tab, cl, T,
        nkv, bs, nbmax, hd);
  else
    paged_write_kernel<float, kDecode><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(k_new), static_cast<const float*>(v_new),
        kp, ks, vp, vs, tab, cl, T, nkv, bs, nbmax, hd);
  return (int)cudaGetLastError();
}

}  // namespace

// Both paged writes: k_new, v_new (B, T, nkv, hd) bf16 (bf16_in = 1) or
// f32, T = 1 for the decode write; pools (nb, nkv, bs, hd) int8 and scales
// (nb, nkv, bs) f32, written in place; tables (B, nbmax) int32; cache_len
// (B,) int32, the position of token 0.
extern "C" int paged_decode_write_int8(const void* k_new, const void* v_new,
                                       void* k_pool, void* k_scale,
                                       void* v_pool, void* v_scale,
                                       const void* tables,
                                       const void* cache_len, int B, int T,
                                       int nkv, int bs, int nbmax, int hd,
                                       int bf16_in, void* stream) {
  if (T != 1) return (int)cudaErrorInvalidValue;
  return launch_paged<true>(k_new, v_new, k_pool, k_scale, v_pool, v_scale,
                            tables, cache_len, B, 1, nkv, bs, nbmax, hd,
                            bf16_in, stream);
}

extern "C" int paged_chunk_write_int8(const void* k_new, const void* v_new,
                                      void* k_pool, void* k_scale,
                                      void* v_pool, void* v_scale,
                                      const void* tables,
                                      const void* cache_len, int B, int T,
                                      int nkv, int bs, int nbmax, int hd,
                                      int bf16_in, void* stream) {
  return launch_paged<false>(k_new, v_new, k_pool, k_scale, v_pool, v_scale,
                             tables, cache_len, B, T, nkv, bs, nbmax, hd,
                             bf16_in, stream);
}
