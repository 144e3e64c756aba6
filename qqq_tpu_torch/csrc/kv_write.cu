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
// * slot: position clamp(cache_len[b], 0, S - 1) of row b;
// * paged decode: position p = cache_len[b] in pool block tab[b][p / bs]
//   at p % bs, or the null block 0 when p / bs >= nbmax;
// * paged chunk: token t at position p = cache_len[b] + t, addressed the
//   same way.
//
// What bounds them on the H100: bytes, and few of them (per token row
// nkv * 2 * (hd * 2 + hd + 4)); at decode the launch itself dominates.
//
// Design.  The TPU kernels stream whole tiles or pool blocks, select the
// new rows in and write them back, because Mosaic stores whole tiles (and
// the paged ones only exist behind a flag, for a v5e fault with
// data-dependent output index maps that Hopper does not have).  A GPU
// thread stores one byte, so here only the hd codes and the one scale of
// each token are written: the paged writes are plain scatters (vLLM's
// reshape_and_cache), and the chunk needs none of the TPU wrapper's
// pre-shift for sublane alignment.
// * One kernel, write_kernel, its destination a template parameter (SlotDest,
//   PagedDest): one warp per (token row, kv head, K|V), four warps a block.
//   Where hd = 32·V for V = 2, 4 or 8 (hd 64, 128, 256), a lane holds V
//   consecutive values from one vector load (8 bytes of bf16 or 16 of f32
//   at hd = 128; two 16-byte loads for f32 at 256) and stores its V codes
//   as one word; other head_dims (96, or any other) take lane-strided
//   scalar loads and byte stores.  The absmax is a warp-shuffle reduction:
//   no shared memory, no block barrier.  Lane 0 stores the scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Where the slot write puts head h of row r of a (B, 1, nkv, hd) input:
// position clamp(cache_len[r], 0, S - 1) of row r.  slot() is the (row,
// head, position) row of the cache and of its scales.
struct SlotDest {
  const int* cache_len;
  int nkv, S;
  __device__ size_t slot(int r, int h) const {
    const int pos = max(0, min(cache_len[r], S - 1));
    return ((size_t)r * nkv + h) * S + pos;
  }
};

// Where the paged writes put head h of token row r = b * T + t of a (B,
// T, nkv, hd) input: position p = cache_len[b] + t of row b's table, in pool
// block tables[b][p / bs] at p % bs, or in the null block 0 when p / bs is
// past the table.  slot() is the (block, head, position) row of the pool
// and of its scales.
struct PagedDest {
  const int* tables;
  const int* cache_len;
  int Tn, nkv, bs, nbmax;
  __device__ size_t slot(int r, int h) const {
    const int b = r / Tn;
    const int pos = cache_len[b] + r % Tn;
    const int vb = pos / bs;
    const size_t phys = vb >= nbmax ? 0 : tables[(size_t)b * nbmax + vb];
    return (phys * nkv + h) * bs + pos % bs;
  }
};

constexpr int kRowWarps = 4;  // warps of a write_kernel block

// V consecutive values at p as floats, in one vector load (two for 8 f32)
template <int V>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[V]) {
  if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  }
}
template <int V>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float (&v)[V]) {
  unsigned w[V / 2];  // two bf16 a word, the first in the low half
  if constexpr (V == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (V == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = t.x;
    w[1] = t.y;
  } else {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = t.x;
    w[1] = t.y;
    w[2] = t.z;
    w[3] = t.w;
  }
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {  // a bf16 is the top half of its f32
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float warp_max(float a) {
  for (int o = 16; o > 0; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

// the code of x at scale s, as a byte
__device__ __forceinline__ unsigned code(float x, float s) {
  const float q = fminf(fmaxf(rintf(x / s), -128.f), 127.f);
  return (unsigned)(int)q & 0xFFu;
}

// Warp w of block x quantizes (token row, head) rh = x * kRowWarps + w of
// K (blockIdx.y = 0) or V (1), rows * nkv of them, and stores its codes
// and scale at dest.slot(r, h).  V > 0: hd = 32·V, lane l holds values V·l
// .. V·l + V − 1 (vector loads; the entry checks their alignment); V = 0:
// any hd, lane l values l, l + 32, ...
template <typename T, int V, class Dest>
__global__ void __launch_bounds__(kRowWarps * 32)
write_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
             int8_t* __restrict__ k_dst, float* __restrict__ k_scale,
             int8_t* __restrict__ v_dst, float* __restrict__ v_scale,
             Dest dest, int rows, int nkv, int hd) {
  const int lane = threadIdx.x & 31;
  const int rh = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (rh >= rows * nkv) return;
  const bool is_v = blockIdx.y != 0;
  const T* x = (is_v ? v_new : k_new) + (size_t)rh * hd;
  const size_t slot = dest.slot(rh / nkv, rh % nkv);
  int8_t* row = (is_v ? v_dst : k_dst) + slot * hd;
  float amax = 0.f;
  float s;
  if constexpr (V > 0) {
    float v[V];
    load_vals<V>(x + V * lane, v);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
    s = fmaxf(warp_max(amax) / 127.0f, FLT_MIN);
    unsigned w[(V + 3) / 4] = {};
#pragma unroll
    for (int i = 0; i < V; ++i) w[i / 4] |= code(v[i], s) << (8 * (i % 4));
    int8_t* dst = row + V * lane;
    if constexpr (V == 2)
      *reinterpret_cast<unsigned short*>(dst) = (unsigned short)w[0];
    else if constexpr (V == 4)
      *reinterpret_cast<unsigned*>(dst) = w[0];
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    for (int d = lane; d < hd; d += 32) amax = fmaxf(amax, fabsf(to_f(x[d])));
    s = fmaxf(warp_max(amax) / 127.0f, FLT_MIN);
    for (int d = lane; d < hd; d += 32) row[d] = (int8_t)code(to_f(x[d]), s);
  }
  if (lane == 0) (is_v ? v_scale : k_scale)[slot] = s;
}

// write_kernel over rows token rows of nkv heads into dest, with V = hd /
// 32 values a lane where hd and the pointers allow vector loads and word
// stores, else lane-strided.
template <typename T, class Dest>
int launch_write(const void* k_new, const void* v_new, void* k_dst,
                 void* k_scale, void* v_dst, void* v_scale, Dest dest,
                 int rows, int nkv, int hd, cudaStream_t st) {
  const dim3 grid((rows * nkv + kRowWarps - 1) / kRowWarps, 2);
  const int v = hd % 32 ? 0 : hd / 32;
  // a lane loads v·sizeof(T) bytes (in 16-byte halves for 8 f32) and
  // stores v; the alignment is tested only where v is a vector width
  const uintptr_t in_align = v * sizeof(T) < 16 ? v * sizeof(T) : 16;
  const bool vec =
      (v == 2 || v == 4 || v == 8) && (uintptr_t)k_new % in_align == 0 &&
      (uintptr_t)v_new % in_align == 0 && (uintptr_t)k_dst % v == 0 &&
      (uintptr_t)v_dst % v == 0;
  auto kn = static_cast<const T*>(k_new);
  auto vn = static_cast<const T*>(v_new);
  auto kd = static_cast<int8_t*>(k_dst);
  auto vd = static_cast<int8_t*>(v_dst);
  auto ks = static_cast<float*>(k_scale);
  auto vs = static_cast<float*>(v_scale);
#define WRITE_LAUNCH(V_)                                                 \
  write_kernel<T, V_, Dest><<<grid, kRowWarps * 32, 0, st>>>(            \
      kn, vn, kd, ks, vd, vs, dest, rows, nkv, hd)
  if (!vec)
    WRITE_LAUNCH(0);
  else if (v == 2)
    WRITE_LAUNCH(2);
  else if (v == 4)
    WRITE_LAUNCH(4);
  else
    WRITE_LAUNCH(8);
#undef WRITE_LAUNCH
  return (int)cudaGetLastError();
}

// launch_write at the input's element type (bf16_in = 1: bf16, else f32)
template <class Dest>
int launch_typed(const void* k_new, const void* v_new, void* k_dst,
                 void* k_scale, void* v_dst, void* v_scale, Dest dest,
                 int rows, int nkv, int hd, int bf16_in, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16_in ? launch_write<__nv_bfloat16>(k_new, v_new, k_dst, k_scale,
                                               v_dst, v_scale, dest, rows,
                                               nkv, hd, st)
                 : launch_write<float>(k_new, v_new, k_dst, k_scale, v_dst,
                                       v_scale, dest, rows, nkv, hd, st);
}

int launch_paged(const void* k_new, const void* v_new, void* k_pool,
                 void* k_scale, void* v_pool, void* v_scale,
                 const void* tables, const void* cache_len, int B, int T,
                 int nkv, int bs, int nbmax, int hd, int bf16_in,
                 void* stream) {
  const PagedDest dest{static_cast<const int*>(tables),
                       static_cast<const int*>(cache_len), T, nkv, bs, nbmax};
  return launch_typed(k_new, v_new, k_pool, k_scale, v_pool, v_scale, dest,
                      B * T, nkv, hd, bf16_in, stream);
}

}  // namespace

// The slot write: k_new, v_new (B, 1, nkv, hd) bf16 (bf16_in = 1) or f32;
// caches (B, nkv, S, hd) int8 and scales (B, nkv, S) f32, written in place;
// cache_len (B,) int32.
extern "C" int slot_decode_write_int8(const void* k_new, const void* v_new,
                                      void* k_cache, void* k_scale,
                                      void* v_cache, void* v_scale,
                                      const void* cache_len, int B, int nkv,
                                      int S, int hd, int bf16_in,
                                      void* stream) {
  const SlotDest dest{static_cast<const int*>(cache_len), nkv, S};
  return launch_typed(k_new, v_new, k_cache, k_scale, v_cache, v_scale, dest,
                      B, nkv, hd, bf16_in, stream);
}

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
  return launch_paged(k_new, v_new, k_pool, k_scale, v_pool, v_scale,
                      tables, cache_len, B, 1, nkv, bs, nbmax, hd, bf16_in,
                      stream);
}

extern "C" int paged_chunk_write_int8(const void* k_new, const void* v_new,
                                      void* k_pool, void* k_scale,
                                      void* v_pool, void* v_scale,
                                      const void* tables,
                                      const void* cache_len, int B, int T,
                                      int nkv, int bs, int nbmax, int hd,
                                      int bf16_in, void* stream) {
  return launch_paged(k_new, v_new, k_pool, k_scale, v_pool, v_scale,
                      tables, cache_len, B, T, nkv, bs, nbmax, hd, bf16_in,
                      stream);
}
