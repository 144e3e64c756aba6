// Decode-time INT8 KV write into the fixed-slot cache, for Hopper (sm_90a).
//
// Replaces: qqq_tpu/kernels/kv_write.py:_slot_write_kernel (:36), reached
// through slot_decode_write_int8 (:74, call :136), together with the
// quantization serve/kv_cache.py:_quant (:42) that runs in front of it.
//
// Computes, for each (b, kv head) and for K and V: s = max(absmax(x) / 127,
// FLT_MIN), q = clip(rint(x / s), -128, 127) over head_dim, and writes q and
// s in place at position min(cache_len[b], S - 1).  IEEE division and
// round-half-even (rintf, no fast math), so codes and scales are
// bit-identical to the plain PyTorch version.
//
// What bounds it on the H100: bytes, and few of them (B * nkv * 2 * (hd * 2
// + hd + 4) at decode); at these sizes the launch itself dominates.
//
// Design: one block per (b, kv head, K|V).  The TPU kernel streams the whole
// 128-token S-tile that holds the position, selects the new row in and
// writes the tile back, because Mosaic stores whole tiles; a GPU thread
// stores one byte, so here the block writes only the hd codes and the one
// scale of the new token.  The absmax is a warp-shuffle reduction followed
// by one pass through shared memory.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
slot_write_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                  int8_t* __restrict__ k_cache, float* __restrict__ k_scale,
                  int8_t* __restrict__ v_cache, float* __restrict__ v_scale,
                  const int* __restrict__ cache_len, int nkv, int S, int hd) {
  __shared__ float wmax[kThreads / 32];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const bool is_v = blockIdx.z != 0;
  const size_t bh = (size_t)b * nkv + h;
  const T* x = (is_v ? v_new : k_new) + bh * hd;  // (B, 1, nkv, hd)
  int8_t* cache = is_v ? v_cache : k_cache;
  float* scale = is_v ? v_scale : k_scale;
  const int pos = max(0, min(cache_len[b], S - 1));

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
  int8_t* row = cache + (bh * S + pos) * hd;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    const float q = fminf(fmaxf(rintf(to_f(x[d]) / s), -128.f), 127.f);
    row[d] = (int8_t)q;
  }
  if (threadIdx.x == 0) scale[bh * S + pos] = s;
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
