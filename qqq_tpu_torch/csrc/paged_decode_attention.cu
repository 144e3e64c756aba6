// Decode (T = 1) GQA attention over the paged INT8 block pool, for Hopper
// (sm_90a), CUDA cores.
//
// Replaces: qqq_tpu/kernels/attention.py:_paged_decode_slab_kernel (:543),
// reached through paged_decode_attention_int8 (:665).
//
// Computes the JAX kernel's numerics, which are not those of the slot
// decode kernel (csrc/decode_attention.cu, all f32): per (b, kv head) and
// its g = nh / nkv query heads, q' = bf16(q / sqrt(hd)) (:704-707); the
// keys 0 .. cache_len - 1 (cache_len counts the current token) are walked
// in tiles of `sub` keys, sub = 256 if bs % 256 == 0 else bs (:593), in
// block order; score = (q' . K_i8) * k_scale in f32 (K cast to bf16 is
// exact for int8); an online softmax per tile: m' = max(m, max score),
// alpha = exp(m - m'), e = exp(score - m'), l = l * alpha + sum(e) over
// the unrounded e (:642), acc = acc * alpha + sum(bf16(e * v_scale) *
// V_i8) (:629-632); out = acc / max(l, 1e-30).  Key p of row b lies at
// pool row (tab[b][p / bs] * nkv + h) * bs + p % bs.
//
// What bounds it on the H100: bytes, the K and V codes and scales of the
// live positions, B * nkv * L * (hd + 4) * 2 at 3.35 TB/s.
//
// Design: one block of 128 threads per (b, kv head) serves all g query
// heads, so each K/V byte is read once for the group (the TPU kernel reads
// a whole (nkv, bs, hd) slab per grid cell and masks a cross-head product
// instead; that trick is for the MXU and buys nothing here).  Per tile,
// thread t scores keys t, t + 128, ... (a key's K row is hd/16 loads of 16
// bytes from the pool block its table entry names; q' sits in shared memory
// and is read as a broadcast) and records the key's pool row and v_scale;
// warp w then takes heads w, w + 4 for the tile's max, exp and sum and
// keeps their running m and l in registers; finally thread d accumulates
// output dim d of every head over the tile's keys, one coalesced V byte row
// per key.  Only keys below cache_len are read, so table entries past a
// row's live blocks are never looked up.  Like the slot decode kernel it
// runs only B * nkv blocks, far from filling 132 SMs at small batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // >= the largest head_dim
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxSub = 512;
constexpr int kHeadsPerWarp = kMaxG / kWarps;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const int8_t* __restrict__ kp,
                    const float* __restrict__ ks,
                    const int8_t* __restrict__ vp,
                    const float* __restrict__ vs,
                    const int* __restrict__ tab,
                    const int* __restrict__ clen, T* __restrict__ out,
                    int nh, int nkv, int bs, int nbmax, int hd, int sub) {
  __shared__ float qs[kMaxG][kThreads];
  __shared__ float p[kMaxG][kMaxSub];  // scores, then bf16(e * v_scale)
  __shared__ float vsc[kMaxSub];
  __shared__ long long vrow[kMaxSub];
  __shared__ float alpha_sh[kMaxG];
  __shared__ float l_sh[kMaxG];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = nh / nkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t qrow = (size_t)b * nh + (size_t)h * g;  // first query head
  const int* trow = tab + (size_t)b * nbmax;
  const float sq = sqrtf((float)hd);

  for (int i = tid; i < g * hd; i += kThreads)
    qs[i / hd][i % hd] = bf16r(to_f(q[qrow * hd + i]) / sq);
  const int L = min(clen[b], nbmax * bs);

  float m[kHeadsPerWarp], l[kHeadsPerWarp];  // heads warp + kWarps * i
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < L; t0 += sub) {
    const int n = min(sub, L - t0);
    for (int kk = tid; kk < n; kk += kThreads) {
      const int pos = t0 + kk;
      const long long row =
          ((long long)trow[pos / bs] * nkv + h) * bs + pos % bs;
      float sc[kMaxG];
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) sc[j] = 0.f;
      const int4* kr = reinterpret_cast<const int4*>(kp + row * hd);
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
      const float ksc = ks[row];
#pragma unroll
      for (int j = 0; j < kMaxG; ++j)
        if (j < g) p[j][kk] = sc[j] * ksc;
      vsc[kk] = vs[row];
      vrow[kk] = row;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      const int j = warp + kWarps * i;
      if (j >= g) continue;
      float mx = -1e30f;
      for (int kk = lane; kk < n; kk += 32) mx = fmaxf(mx, p[j][kk]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
      for (int kk = lane; kk < n; kk += 32) {
        const float e = expf(p[j][kk] - mn);
        sum += e;
        p[j][kk] = bf16r(e * vsc[kk]);
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
      if (lane == 0) alpha_sh[j] = alpha;
    }
    __syncthreads();

    if (tid < hd) {
#pragma unroll
      for (int j = 0; j < kMaxG; ++j)
        if (j < g) acc[j] *= alpha_sh[j];
      for (int kk = 0; kk < n; ++kk) {
        const float vv = (float)vp[vrow[kk] * hd + tid];
#pragma unroll
        for (int j = 0; j < kMaxG; ++j)
          if (j < g) acc[j] = fmaf(p[j][kk], vv, acc[j]);
      }
    }
    __syncthreads();  // p, vsc, vrow and alpha_sh are rewritten next tile
  }

#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    const int j = warp + kWarps * i;
    if (j < g && lane == 0) l_sh[j] = l[i];
  }
  __syncthreads();
  if (tid < hd) {
#pragma unroll
    for (int j = 0; j < kMaxG; ++j)
      if (j < g)
        store(out + (qrow + j) * hd + tid, acc[j] / fmaxf(l_sh[j], 1e-30f));
  }
}

}  // namespace

// q (B, nh, hd) bf16 (bf16_io = 1) or f32; pools (nb, nkv, bs, hd) int8 and
// scales (nb, nkv, bs) f32; tables (B, nbmax) int32; cache_len (B,) int32,
// the live keys including the current one; out (B, nh, hd) like q.
// nh / nkv <= 8, hd <= 128, hd % 16 == 0, sub <= 512 and sub divides bs.
extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* tables,
    const void* cache_len, void* out, int B, int nh, int nkv, int bs,
    int nbmax, int hd, int sub, int bf16_io, void* stream) {
  if (nh % nkv || nh / nkv > kMaxG || hd > kThreads || hd % 16 ||
      sub > kMaxSub || sub <= 0 || bs % sub)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, nkv);
  auto st = static_cast<cudaStream_t>(stream);
  auto kp = static_cast<const int8_t*>(k_pool);
  auto vp = static_cast<const int8_t*>(v_pool);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto tab = static_cast<const int*>(tables);
  auto cl = static_cast<const int*>(cache_len);
  if (bf16_io)
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), kp, ks, vp, vs, tab, cl,
        static_cast<__nv_bfloat16*>(out), nh, nkv, bs, nbmax, hd, sub);
  else
    paged_decode_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), kp, ks, vp, vs, tab, cl,
        static_cast<float*>(out), nh, nkv, bs, nbmax, hd, sub);
  return (int)cudaGetLastError();
}
