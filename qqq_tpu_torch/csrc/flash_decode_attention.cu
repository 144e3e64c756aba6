// S-tiled decode (T = 1) GQA attention over the INT8 slot cache, for caches
// past the whole-cache kernel's switch (S > 8192 at hd = 128), for Hopper
// (sm_90a), CUDA cores.
//
// Replaces: qqq_tpu/kernels/attention.py:_flash_decode_kernel (:757), reached
// through flash_decode_attention_int8 (:866) from decode_attention_auto
// (:952).
//
// Computes the JAX kernel's numerics, which are those of the paged decode
// kernel (csrc/paged_decode_attention.cu) over the contiguous slot layout:
// per (b, kv head) and its g = nh / nkv query heads, q' = bf16(q / sqrt(hd))
// (:896-899); the keys 0 .. cache_len - 1 (cache_len counts the current
// token) are walked in tiles of `sblk` keys, JAX's tile
// (_pick_decode_tiles and the walk-down at :891-894, chosen by the
// wrapper); score = (q' . K_i8) * k_scale in f32 (K cast to bf16 is exact
// for int8); an online softmax per tile: m' = max(m, max score), alpha =
// exp(m - m'), e = exp(score - m'), l = l * alpha + sum(e) over the
// unrounded e (:822), acc = acc * alpha + sum(bf16(e * v_scale) * V_i8)
// (:816-823); out = acc / max(l, 1e-30).  The tile decides which running
// maximum each bf16 rounding of e * v_scale meets, so it is never changed
// here, and every tile JAX takes runs: where a tile's scores do not fit in
// shared memory (hd = 64 at S = 16384, where JAX's tile is the whole
// cache) they live in a global workspace instead, with the same arithmetic
// in the same order.
//
// What bounds it on the H100: bytes, the K and V codes and scales of the
// live keys, B * nkv * L * (hd + 4) * 2 at 3.35 TB/s.  Tiles past
// cache_len are never read (JAX's grid visits them and skips the compute;
// at S = 32768 with 200 live keys reading them would be 160x the bytes).
//
// Design: one block of 256 threads per (b, kv head) serves all g query
// heads, so each K/V byte is read once for the group.  A tile's scores for
// its g heads sit in dynamic shared memory (g * sblk * 4 bytes, 32 KB at
// g = 4 and sblk = 2048) or, where that does not fit beside the rest of the
// block, in the (b, kv head)'s slice of a (B, nkv, g, sblk) f32 workspace
// that the wrapper allocates (flash_decode_workspace_bytes says how much;
// the kernel allocates nothing).  Per tile, (1) thread t scores keys t,
// t + 256, ... (a key's K row is hd / 16 loads of 16 bytes; q' sits in
// shared memory and is read as float4 broadcasts); (2) warp j takes head j
// for the tile's max, exp and sum, keeps its running m and l in registers
// and overwrites the scores with bf16(e * v_scale); (3) the threads split
// into 256 / (hd / 4) key groups of hd / 4 threads, each thread
// accumulating 4 output dims of every head over its group's keys (one
// coalesced V row per key and group), and the groups' partial sums are
// added at the end.  Only B * nkv blocks run (32 at B = 4 on
// Llama-3.1-8B), far from filling 132 SMs; splitting the keys across
// blocks (split-K) is later work and would change the f32 order of the
// sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_fit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
static_assert(kMaxG <= kWarps, "warp j owns head j in phase 2");

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

// Dynamic shared memory in floats: q' (g, hd), the tile's scores (g, sblk)
// unless they live in the workspace, the key groups' partial outputs (kg,
// g, hd), alpha (g) and l (g).
__host__ __device__ inline int key_groups(int hd) {
  return kThreads / (hd / 4);
}
inline size_t smem_bytes(int g, int sblk, int hd, bool scores_in_smem) {
  return 4 * (size_t)g *
         ((size_t)hd + (scores_in_smem ? (size_t)sblk : 0) +
          (size_t)key_groups(hd) * hd + 2);
}

// kGlobalP: the tile's scores in ws[(b * nkv + h) * g * sblk ...], else in
// shared memory.
template <typename T, bool kGlobalP>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                    const float* __restrict__ ks,
                    const int8_t* __restrict__ vc,
                    const float* __restrict__ vs,
                    const int* __restrict__ clen, T* __restrict__ out,
                    float* __restrict__ ws, int nh, int nkv, int S, int hd,
                    int sblk) {
  extern __shared__ float4 smem4[];
  const int g = nh / nkv;
  const int nd = hd / 4;         // 4-dim column groups of a V row
  const int kg = key_groups(hd);
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const size_t bh = (size_t)b * nkv + h;
  float* qs = reinterpret_cast<float*>(smem4);  // [g][hd]
  float* p = kGlobalP ? ws + bh * g * sblk : qs + g * hd;  // [g][sblk]
  float* red = qs + g * hd + (kGlobalP ? 0 : (size_t)g * sblk);  // [kg][g][hd]
  float* alpha_sh = red + kg * g * hd;          // [g]
  float* l_sh = alpha_sh + g;                   // [g]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int8_t* kb = kc + bh * S * hd;
  const int8_t* vb = vc + bh * S * hd;
  const float* ksb = ks + bh * S;
  const float* vsb = vs + bh * S;
  const size_t qrow = (size_t)b * nh + (size_t)h * g;  // first query head
  const float sq = sqrtf((float)hd);

  for (int i = tid; i < g * hd; i += kThreads)
    qs[i] = bf16r(to_f(q[qrow * hd + i]) / sq);
  const int L = min(clen[b], S);

  float m = -1e30f, l = 0.f;  // head `warp`'s running max and sum
  const int dg = tid % nd;    // phase 3: dims 4 dg .. 4 dg + 3
  const int kgi = tid / nd;   // phase 3: key group (idle if >= kg)
  float acc[kMaxG][4];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < L; t0 += sblk) {
    const int n = min(sblk, L - t0);
    for (int kk = tid; kk < n; kk += kThreads) {
      const int4* kr =
          reinterpret_cast<const int4*>(kb + (size_t)(t0 + kk) * hd);
      float sc[kMaxG];
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) sc[j] = 0.f;
      for (int c = 0; c < hd / 16; ++c) {
        const int4 raw = __ldg(kr + c);
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&raw);
        float kf[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) kf[u] = (float)k8[u];
#pragma unroll
        for (int j = 0; j < kMaxG; ++j) {
          if (j < g) {
            const float4* q4 =
                reinterpret_cast<const float4*>(qs + j * hd + c * 16);
            float s = sc[j];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const float4 qq = q4[w];
              s = fmaf(qq.x, kf[4 * w + 0], s);
              s = fmaf(qq.y, kf[4 * w + 1], s);
              s = fmaf(qq.z, kf[4 * w + 2], s);
              s = fmaf(qq.w, kf[4 * w + 3], s);
            }
            sc[j] = s;
          }
        }
      }
      const float ksc = __ldg(ksb + t0 + kk);
#pragma unroll
      for (int j = 0; j < kMaxG; ++j)
        if (j < g) p[(size_t)j * sblk + kk] = sc[j] * ksc;
    }
    __syncthreads();

    if (warp < g) {
      float* pj = p + (size_t)warp * sblk;
      float mx = -1e30f;
      for (int kk = lane; kk < n; kk += 32) mx = fmaxf(mx, pj[kk]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m, mx);
      const float alpha = expf(m - mn);
      float sum = 0.f;
      for (int kk = lane; kk < n; kk += 32) {
        const float e = expf(pj[kk] - mn);
        sum += e;
        pj[kk] = bf16r(e * __ldg(vsb + t0 + kk));
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l = l * alpha + sum;
      m = mn;
      if (lane == 0) alpha_sh[warp] = alpha;
    }
    __syncthreads();

    if (kgi < kg) {
#pragma unroll
      for (int j = 0; j < kMaxG; ++j)
        if (j < g) {
          const float a = alpha_sh[j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] *= a;
        }
      const int8_t* vcol = vb + (size_t)t0 * hd + 4 * dg;
#pragma unroll 4
      for (int kk = kgi; kk < n; kk += kg) {
        const char4 v4 =
            __ldg(reinterpret_cast<const char4*>(vcol + (size_t)kk * hd));
        const float v[4] = {(float)v4.x, (float)v4.y, (float)v4.z,
                            (float)v4.w};
#pragma unroll
        for (int j = 0; j < kMaxG; ++j)
          if (j < g) {
            const float pw = p[(size_t)j * sblk + kk];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][c] = fmaf(pw, v[c], acc[j][c]);
          }
      }
    }
    __syncthreads();  // p and alpha_sh are rewritten by the next tile
  }

  if (kgi < kg) {
#pragma unroll
    for (int j = 0; j < kMaxG; ++j)
      if (j < g)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[((size_t)kgi * g + j) * hd + 4 * dg + c] = acc[j][c];
  }
  if (warp < g && lane == 0) l_sh[warp] = l;
  __syncthreads();
  for (int i = tid; i < g * hd; i += kThreads) {
    const int j = i / hd;
    const int d = i % hd;
    float s = 0.f;
    for (int k = 0; k < kg; ++k) s += red[((size_t)k * g + j) * hd + d];
    store(out + (qrow + j) * hd + d, s / fmaxf(l_sh[j], 1e-30f));
  }
}

// Whether a tile's scores fit in shared memory beside the rest of the block
// (*in_smem); the CUDA error of the query otherwise.  Every variant has the
// same (no) static shared memory, so one answers for all.
int scores_fit(int g, int sblk, int hd, bool* in_smem) {
  size_t room = 0;
  const int err =
      smem_room(flash_decode_kernel<float, false>, &room);
  if (err != 0) return err;
  *in_smem = smem_bytes(g, sblk, hd, true) <= room;
  return 0;
}

bool bad_args(int nh, int nkv, int hd, int sblk) {
  return nkv <= 0 || nh % nkv || nh / nkv > kMaxG || hd % 16 || hd <= 0 ||
         hd > 256 || sblk <= 0;
}

template <typename T, bool kGlobalP>
int launch(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, const void* cl, void* out, void* ws, int B, int nh,
           int nkv, int S, int hd, int sblk, cudaStream_t st) {
  auto kernel = flash_decode_kernel<T, kGlobalP>;
  const int fit = smem_fit(kernel, smem_bytes(nh / nkv, sblk, hd, !kGlobalP));
  if (fit != 0) return fit;
  kernel<<<dim3(B, nkv), kThreads, smem_bytes(nh / nkv, sblk, hd, !kGlobalP),
           st>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int*>(cl),
      static_cast<T*>(out), static_cast<float*>(ws), nh, nkv, S, hd, sblk);
  return (int)cudaGetLastError();
}

}  // namespace

// The f32 workspace bytes flash_decode_attention_int8 needs for these
// arguments: 0 when a tile's scores fit in shared memory, else B * nkv *
// (nh / nkv) * sblk * 4, the scores of every (b, kv head).  Negative: minus
// the CUDA error (cudaErrorInvalidValue for arguments the kernel refuses).
extern "C" long long flash_decode_workspace_bytes(int B, int nh, int nkv,
                                                  int hd, int sblk) {
  if (bad_args(nh, nkv, hd, sblk)) return -(long long)cudaErrorInvalidValue;
  bool in_smem = true;
  const int err = scores_fit(nh / nkv, sblk, hd, &in_smem);
  if (err != 0) return -(long long)err;
  return in_smem ? 0 : 4LL * B * nh * sblk;
}

// q (B, nh, hd) bf16 (bf16_io = 1) or f32; caches (B, nkv, S, hd) int8 and
// scales (B, nkv, S) f32; cache_len (B,) int32, the live keys including the
// current one; out (B, nh, hd) like q; workspace: the bytes
// flash_decode_workspace_bytes asks for (f32, 16-byte aligned), or null
// when it asks for none.  nh / nkv <= 8, hd % 16 == 0, hd <= 256 and
// 0 < sblk (else cudaErrorInvalidValue, as for a missing workspace).
extern "C" int flash_decode_attention_int8(
    const void* q, const void* k_cache, const void* k_scale,
    const void* v_cache, const void* v_scale, const void* cache_len,
    void* out, void* workspace, int B, int nh, int nkv, int S, int hd,
    int sblk, int bf16_io, void* stream) {
  if (bad_args(nh, nkv, hd, sblk)) return (int)cudaErrorInvalidValue;
  bool in_smem = true;
  const int err = scores_fit(nh / nkv, sblk, hd, &in_smem);
  if (err != 0) return err;
  if (!in_smem && workspace == nullptr) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define FD_LAUNCH(T, G)                                                     \
  launch<T, G>(q, k_cache, k_scale, v_cache, v_scale, cache_len, out,       \
               workspace, B, nh, nkv, S, hd, sblk, st)
  if (bf16_io)
    return in_smem ? FD_LAUNCH(__nv_bfloat16, false)
                   : FD_LAUNCH(__nv_bfloat16, true);
  return in_smem ? FD_LAUNCH(float, false) : FD_LAUNCH(float, true);
#undef FD_LAUNCH
}
