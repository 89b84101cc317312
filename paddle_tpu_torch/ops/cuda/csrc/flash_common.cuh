// Shared pieces of the flash attention kernels for Hopper (sm_90a):
// flash_attention.cu (the streaming forward and backward) and
// flash_short.cu (the short-sequence forms). Both key their dropout by
// the same Philox counter, so for one seed they drop the same elements.
//
// Tiles are 64 rows; 256 threads; thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty*4 .. ty*4+3 and columns tx, tx+16, tx+32, ... of every
// tile it computes, so a row's values sit in one half-warp and row
// max/sum are four shuffles. Operands live in shared memory as f32
// (bf16 inputs are widened on load); the "A" operand is read as float4
// along the reduction axis (a broadcast within the half-warp), the "B"
// operand as scalars that are consecutive or odd-strided across
// threads, so loads are free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 256;      // threads a block
constexpr int kTile = 64;    // q rows / kv rows a tile
constexpr int kPad = 68;     // row stride of the transposed P/dS tile
constexpr float kNegInit = -1e30f;

struct Args {
  int B, Lq, Lk, H;
  int causal;
  float scale;
  uint32_t thr;  // keep where bits >= thr
  float inv;     // 1 / (1 - p); 1 means no dropout
  uint32_t seed_lo, seed_hi;
  const float* bias;  // (B, Lk) additive key mask, or null (no mask)
};

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// keep bits of one tile row's four columns kv0 + tx + 16 j (kv0 % 64 == 0)
__device__ __forceinline__ void keep4(const Args& a, int bh, int row, int kv0,
                                      int tx, bool (&keep)[4]) {
  const uint4 w = philox(
      make_uint4((uint32_t)((kv0 / 64) * 16 + tx), (uint32_t)row,
                 (uint32_t)bh, 0u),
      a.seed_lo, a.seed_hi);
  keep[0] = w.x >= a.thr;
  keep[1] = w.y >= a.thr;
  keep[2] = w.z >= a.thr;
  keep[3] = w.w >= a.thr;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += sum_k A[(r0 + i) * lda + k] * B[k * bks + (c0 + 16 j) * bcs]
template <int R, int C, int K>
__device__ __forceinline__ void mm(float (&acc)[R][C],
                                   const float* __restrict__ A, int lda,
                                   int r0, const float* __restrict__ B,
                                   int bks, int bcs, int c0) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = ld4(A + (r0 + i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[C];
#pragma unroll
      for (int j = 0; j < C; ++j) b[j] = B[(k + kk) * bks + (c0 + 16 * j) * bcs];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float x = comp(av[i], kk);
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = fmaf(x, b[j], acc[i][j]);
      }
    }
  }
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ static float one(const float* p) { return *p; }
  __device__ static float put(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __nv_bfloat16 put(float x) { return __float2bfloat16(x); }
};

// 64 rows of one head, starting at sequence row l0, into dst[r * ld + d]
// as f32 times ``mul``; rows at or past L load as zeros.
template <typename T, int D>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                          const Args& a, int b, int h, int l0, int L,
                          float mul) {
  constexpr int V = Vec<T>::N;
  constexpr int NV = D / V;
  for (int idx = threadIdx.x; idx < kTile * NV; idx += kT) {
    const int r = idx / NV, c = (idx % NV) * V;
    float v[V];
    if (l0 + r < L) {
      const int64_t off = (((int64_t)b * L + l0 + r) * a.H + h) * D + c;
      Vec<T>::load(src + off, v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * ld + c + e] = v[e] * mul;
  }
}

template <typename T, int D>
__device__ void store_rows(T* __restrict__ dst, const float (&acc)[4][D / 16],
                           const Args& a, int b, int h, int l0, int L,
                           float mul) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    if (l >= L) continue;
    const int64_t off = (((int64_t)b * L + l) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dst[off + tx + 16 * j] = Vec<T>::put(acc[i][j] * mul);
  }
}

// the key mask's values for kv columns kv0 .. kv0 + 63 of batch b (0 past
// Lk, where dead() masks the column anyway); threads 0..63 load one each
__device__ __forceinline__ void load_bias(float* dst, const Args& a, int b,
                                          int kv0) {
  const int c = kv0 + (int)threadIdx.x;
  if (threadIdx.x < kTile)
    dst[threadIdx.x] = c < a.Lk ? a.bias[(int64_t)b * a.Lk + c] : 0.0f;
}

// S tile masking: column past Lk, or above the diagonal when causal
__device__ __forceinline__ bool dead(const Args& a, int row, int col) {
  return col >= a.Lk || (a.causal && col > row);
}

__device__ __forceinline__ int kv_tiles_for(const Args& a, int q0) {
  const int n = (a.Lk + kTile - 1) / kTile;
  if (!a.causal) return n;
  const int last = (q0 + kTile - 1) / kTile + 1;
  return last < n ? last : n;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Args make_args(int B, int Lq, int Lk, int H, int causal, float scale,
               unsigned thr, float inv, unsigned lo, unsigned hi,
               const float* bias = nullptr) {
  Args a;
  a.B = B;
  a.Lq = Lq;
  a.Lk = Lk;
  a.H = H;
  a.causal = causal;
  a.scale = scale;
  a.thr = thr;
  a.inv = inv;
  a.seed_lo = lo;
  a.seed_hi = hi;
  a.bias = bias;
  return a;
}

}  // namespace
