// Shared pieces of the flash attention kernels for Hopper (sm_90a):
// flash_attention.cu (the streaming forward and backward) and
// flash_short.cu (the short-sequence forms). Both key their dropout by
// the same Philox counter, so for one seed they drop the same elements,
// and both run the bf16 forward body fwd_mma. fused_xent.cu uses the
// tensor-core and cluster pieces, paged_attention.cu and sampling.cu the
// cp.async and cluster pieces.
//
// Two kinds of kernel use them. The tensor-core kernels (every bf16 and
// f16 form of K1: K1a, K1b, K1c and K1d; the last parts of this file)
// are described there. The f32 FMA kernels (every f32 form):
// tiles are 64 rows; 256 threads; thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty*4 .. ty*4+3 and columns tx, tx+16, tx+32, ... of every
// tile it computes, so a row's values sit in one half-warp and row
// max/sum are four shuffles. Operands live in shared memory as f32; the
// "A" operand is read as float4 along the reduction axis (a broadcast
// within the half-warp), the "B" operand as scalars that are
// consecutive or odd-strided across threads, so loads are free of bank
// conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
};

template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void load(const __half* p, float (&v)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
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

// ---------------------------------------------------------------------------
// Tensor-core pieces (2-byte operands, f32 accumulators)
// ---------------------------------------------------------------------------
// A tensor-core block is 4 warps; each warp owns 16 rows of a 64-row tile
// and multiplies with mma.sync m16n8k16 (bf16 x bf16 -> f32, or f16 x f16
// -> f32: the operand type T is a template parameter of every piece that
// rounds, packs or multiplies, bf16 by default). Operand
// tiles sit in shared memory as T, 64 rows of W elements (W = D for
// q/k/v/dO tiles, 64 for a P or dS tile), in 16-byte chunks whose index
// is XORed with row % 8, so the eight rows one ldmatrix phase reads (and
// the rows a fragment store writes) fall in eight different bank groups.
// Global -> shared copies are cp.async (16 bytes a thread, zero-filled
// past the sequence end), so the next tile's copy runs under this
// tile's products.
//
// Fragment map of one warp's 16 x 64 f32 accumulator tile s[8][4] (the
// m16n8 C layout, n-tile i of 8 columns, element e): row g + 8 (e / 2),
// column 8 i + 2 t + e % 2, with g = lane / 4 and t = lane % 4. A
// row's 64 values are spread over the 4 threads of a quad, so its max and
// sum are two shuffles. The same registers, packed in pairs, are the A
// operand of the next product (P V, dS K): no trip through memory.
constexpr int kWarps = 4;
constexpr int kMmaT = kWarps * 32;   // threads of a tensor-core block
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// two f32 values rounded to a packed pair of T, and back
template <typename T>
struct Pack2;

template <>
struct Pack2<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  __device__ static T2 rn(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  __device__ static float2 widen(T2 h) { return __bfloat1622float2(h); }
};

template <>
struct Pack2<__half> {
  using T2 = __half2;
  __device__ static T2 rn(float lo, float hi) { return __floats2half2_rn(lo, hi); }
  __device__ static float2 widen(T2 h) { return __half22float2(h); }
};

// 2^x by the MUFU unit (ex2.approx, as exp2f without its subnormal
// handling): an output below 2^-126 flushes to 0, where the f32 sums it
// would enter (l, P V, dS) cannot see it anyway; -inf gives 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int frag_row(int lane, int e) {
  return (lane >> 2) + 8 * (e >> 1);
}

__device__ __forceinline__ int frag_col(int lane, int i, int e) {
  return 8 * i + 2 * (lane & 3) + (e & 1);
}

// Dropout keep bits of one warp's 16 x 64 tile, sequence rows row0 ..
// row0 + 15 and kv columns kv0 .. kv0 + 63 (kv0 % 64 == 0), as bit
// 4 i + e of the fragment map. Column c = 8 i + 2 t + e % 2 of the tile
// has counter g = c % 16 = 8 (i % 2) + 2 t + e % 2 and word (c / 16) % 4
// = i / 2, so the four words of one Philox call are n-tiles i % 2,
// i % 2 + 2, + 4, + 6 of ONE thread: four calls a row, eight a thread,
// one call for every four elements as in keep4.
__device__ __forceinline__ uint32_t keep_frag(const Args& a, int bh,
                                              int row0, int kv0, int lane) {
  const int t = lane & 3, g = lane >> 2;
  uint32_t bits = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int hg = 0; hg < 2; ++hg)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint4 w = philox(
            make_uint4((uint32_t)((kv0 / 64) * 16 + 8 * hg + 2 * t + e),
                       (uint32_t)(row0 + g + 8 * half), (uint32_t)bh, 0u),
            a.seed_lo, a.seed_hi);
        const uint32_t wj[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (wj[j] >= a.thr) bits |= 1u << (4 * (2 * j + hg) + 2 * half + e);
      }
  return bits;
}

// Dead elements (dead()) of a warp's 16 x 64 tile, sequence rows row0 ..
// and kv columns kv0 .., set to ``value``. Only a tile that reaches past
// Lk, or above the diagonal when causal, can hold one; the test is the
// same for the whole warp, so the full tiles between skip the per-element
// compares.
__device__ __forceinline__ void mask_tile(float (&s)[8][4], const Args& a,
                                          int row0, int kv0, int lane,
                                          float value) {
  if (kv0 + kTile <= a.Lk && !(a.causal && kv0 + kTile - 1 > row0)) return;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (dead(a, row0 + frag_row(lane, e), kv0 + frag_col(lane, i, e)))
        s[i][e] = value;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of W bf16
template <int W>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * W * 2 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0));
}

// 4 bytes (cp.async.ca, the smallest copy), zero-filled where not live
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 64 rows of one head from the (B, L, H, D) layout, starting at row l0,
// into a swizzled shared tile; rows at or past L are zero-filled
template <int D, typename T>
__device__ __forceinline__ void tile_async(uint32_t dst, const T* src,
                                           const Args& a, int b, int h,
                                           int l0, int L) {
  constexpr int NC = D / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < kTile * NC; idx += kMmaT) {
    const int r = idx / NC, c = idx % NC;
    const bool live = l0 + r < L;
    const T* p =
        live ? src + (((int64_t)b * L + l0 + r) * a.H + h) * D + c * 8 : src;
    cp_async16(dst + swz<D>(r, c), p, live);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A operand (16 x 16, rows m0.., depth k0..) of a tile stored [m][k]
template <int W>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], uint32_t tile,
                                       int m0, int k0, int lane) {
  ldsm4(r, tile + swz<W>(m0 + (lane & 15), (k0 >> 3) + (lane >> 4)));
}

// A operand of a tile stored [k][m] (the transposed product, e.g. P^T)
template <int W>
__device__ __forceinline__ void frag_at(uint32_t (&r)[4], uint32_t tile,
                                        int m0, int k0, int lane) {
  ldsm4t(r, tile + swz<W>(k0 + (lane & 7) + ((lane >> 4) << 3),
                          (m0 >> 3) + ((lane >> 3) & 1)));
}

// B operands of n-tiles n0 and n0 + 8 (r[0..1] and r[2..3]), depth
// k0 .. k0 + 15, of a tile stored [n][k] (K for Q K^T)
template <int W>
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], uint32_t tile,
                                       int n0, int k0, int lane) {
  ldsm4(r, tile + swz<W>(n0 + (lane & 7) + ((lane >> 4) << 3),
                         (k0 >> 3) + ((lane >> 3) & 1)));
}

// the same of a tile stored [k][n] (V for P V, K for dS K)
template <int W>
__device__ __forceinline__ void frag_bt(uint32_t (&r)[4], uint32_t tile,
                                        int n0, int k0, int lane) {
  ldsm4t(r, tile + swz<W>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                          (n0 >> 3) + (lane >> 4)));
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (kIsHalf<T>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  typename Pack2<T>::T2 v = Pack2<T>::rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand of depth step kk (kv columns 16 kk ..) from a warp's 16 x 64
// accumulator tile, as two bf16 terms, hi + lo: hi is the rounded value,
// lo the rounding error rounded again, so hi + lo carries 16 bits of
// mantissa. dS goes in this way (where every key of a row is masked the
// saved lse is -1e30 and P is 1 across the row, the plain version's
// arithmetic, so dS grows with Lk and one bf16 rounding of it moves dQ
// and dK past the bf16 tolerance), and so does P into P V
// (flash_short.cu). In f16 hi + lo carries 22 bits, within f16's range
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void acc_to_a2(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                          const float (&s)[8][4], int kk) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x0 = s[2 * kk + (j >> 1)][2 * (j & 1)];
    const float x1 = s[2 * kk + (j >> 1)][2 * (j & 1) + 1];
    const typename Pack2<T>::T2 h = Pack2<T>::rn(x0, x1);
    const float2 hf = Pack2<T>::widen(h);
    hi[j] = *reinterpret_cast<const uint32_t*>(&h);
    lo[j] = pack_pair<T>(x0 - hf.x, x1 - hf.y);
  }
}

// acc (16 x 64) += A (16 rows m0.. of tile A, [m][k], depth D) B^T with B
// stored [n][k] (64 rows, depth D): S = Q K^T and dP = dO V^T
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], uint32_t A,
                                        int m0, uint32_t B, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    frag_a<D>(fa, A, m0, 16 * kk, lane);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t fb[4];
      frag_b<D>(fb, B, 16 * n, 16 * kk, lane);
      mma16816<T>(acc[2 * n], fa, fb[0], fb[1]);
      mma16816<T>(acc[2 * n + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc (16 x D) += A (16 x 64, from registers as hi + lo) B, with B a
// 64-row tile stored [k][n] of width D: O += P V and dQ += dS K
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_rb(float (&acc)[D / 8][4],
                                       const float (&s)[8][4], uint32_t B,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t fa[4], fl[4];
    acc_to_a2<T>(fa, fl, s, kk);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t fb[4];
      frag_bt<D>(fb, B, 16 * n, 16 * kk, lane);
      mma16816<T>(acc[2 * n], fa, fb[0], fb[1]);
      mma16816<T>(acc[2 * n + 1], fa, fb[2], fb[3]);
      mma16816<T>(acc[2 * n], fl, fb[0], fb[1]);
      mma16816<T>(acc[2 * n + 1], fl, fb[2], fb[3]);
    }
  }
}

// acc (16 x D) += A B as mma_rb, A as one term of T: P V in K1c's f16
// form (flash_short.cu's header)
template <int D, typename T>
__device__ __forceinline__ void mma_r1(float (&acc)[D / 8][4],
                                       const float (&s)[8][4], uint32_t B,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t fa[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      fa[j] = pack_pair<T>(s[2 * kk + (j >> 1)][2 * (j & 1)],
                           s[2 * kk + (j >> 1)][2 * (j & 1) + 1]);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t fb[4];
      frag_bt<D>(fb, B, 16 * n, 16 * kk, lane);
      mma16816<T>(acc[2 * n], fa, fb[0], fb[1]);
      mma16816<T>(acc[2 * n + 1], fa, fb[2], fb[3]);
    }
  }
}

// row max / sum over the quad that holds a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a warp's 16 x D accumulator, times mul, as T rows l0 + 16 w .. of
// (B, L, H, D); rows at or past L are not written
template <int D, typename T>
__device__ __forceinline__ void store_acc(T* __restrict__ dst,
                                          const float (&acc)[D / 8][4],
                                          const Args& a, int b, int h,
                                          int row0, int L, float mul,
                                          int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = row0 + frag_row(lane, 2 * half);
    if (l >= L) continue;
    const int64_t off = (((int64_t)b * L + l) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + off + frag_col(lane, j, 0)) =
          pack_pair<T>(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
  }
}

// S -> dS in place, and (WANT_P) dP -> the dropped P in place: P =
// exp(S * scale + bias - lse), zero where dead; dP dropped and scaled by
// 1/(1-p); dS = P (dP - delta) with the undropped P. Rows are the warp's
// 16 q rows from row0.
template <bool WANT_P>
__device__ __forceinline__ void grad_scores(float (&s)[8][4],
                                            float (&dp)[8][4], const Args& a,
                                            int bh, int row0, int kv0,
                                            const float (&bv)[8][2],
                                            const float (&lse_r)[2],
                                            const float (&dl_r)[2],
                                            int lane) {
  const bool drop = a.inv != 1.0f;
  const uint32_t keep = drop ? keep_frag(a, bh, row0, kv0, lane) : ~0u;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[i][e] = exp2_ftz((s[i][e] * a.scale + bv[i][e & 1] - lse_r[e >> 1]) *
                         kLog2e);
  mask_tile(s, a, row0, kv0, lane, 0.0f);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = s[i][e];
      const bool kept = (keep >> (4 * i + e)) & 1u;
      const float dpv = !drop ? dp[i][e] : kept ? dp[i][e] * a.inv : 0.0f;
      s[i][e] = p * (dpv - dl_r[r]);
      if (WANT_P) dp[i][e] = !drop ? p : kept ? p * a.inv : 0.0f;
    }
}

// a warp's 16 x 64 accumulator tile as T into a swizzled [64][64]
// shared tile, rows 16 w ..; with lo, its rounding error (acc_to_a2)
// into a second tile
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void store_frag(unsigned char* tile,
                                           unsigned char* lo,
                                           const float (&s)[8][4], int w,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * w + frag_row(lane, 2 * half);
      const uint32_t off = swz<kTile>(r, i) + 4 * (lane & 3);
      const float x0 = s[i][2 * half], x1 = s[i][2 * half + 1];
      const typename Pack2<T>::T2 h = Pack2<T>::rn(x0, x1);
      *reinterpret_cast<typename Pack2<T>::T2*>(tile + off) = h;
      if (lo) {
        const float2 hf = Pack2<T>::widen(h);
        *reinterpret_cast<uint32_t*>(lo + off) =
            pack_pair<T>(x0 - hf.x, x1 - hf.y);
      }
    }
}

// The f16 forms' dS lift (flash_attention.cu's header; K1b's dq and
// dk/dv kernels, and K1d's short_bwd_mma in flash_short.cu): dS enters
// its products as dS 2^-E (hi + lo), E a running exponent that only
// grows, and the sum is scaled back by 2^E at the store (K1d's dQ
// partials take a fresh E a row and tile and are scaled back before the
// exchange). E starts at kLiftMin; a tile whose largest |dS| is m raises
// E to lift_exp(m), so that m 2^-E < 2^14 and the rounded terms stay
// inside f16's range at any loss scale, while small dS are lifted above
// its subnormals. P, rounded once for dV += P^T dO, is lifted the same
// way (its own exponent a block): with the global lse of the
// external-lse form a block's keys may hold little of every row's mass,
// and its P then lie below f16's normals (unlifted, such a block's dv
// used 3.65 of the 2-byte check's tolerance; PERF.md). Powers of two:
// nothing else changes, so without overflow or underflow the sums are
// the unlifted ones times 2^-E exactly.
constexpr int kLiftMin = -100;
#ifdef FLASH_F16_NO_LIFT   // the unlifted variant, for the measurement only
template <typename T>
constexpr bool kLift = false;
#else
template <typename T>
constexpr bool kLift = kIsHalf<T>;
#endif

__device__ __forceinline__ float pow2i(int e) {   // 2^e, |e| <= 126
  return __int_as_float((e + 127) << 23);
}

// E with m 2^-E in [2^13, 2^14) for a normal f32 m > 0, within
// [kLiftMin, 100]; kLiftMin for m = 0
__device__ __forceinline__ int lift_exp(float m) {
  const int e = ((__float_as_int(m) >> 23) & 0xff) - 127 - 13;
  return m > 0.0f ? max(kLiftMin, min(100, e)) : kLiftMin;
}

// raise the running exponent E to e: an accumulator in units of 2^E
// (rows ``rows`` of acc) is rescaled, exactly unless it underflows
template <int N>
__device__ __forceinline__ void raise_lift(int& E, int e, float (&acc)[N][4],
                                           int half) {
  if (e <= E) return;
  const float f = E - e < -126 ? 0.0f : pow2i(E - e);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (half < 0 || (c >> 1) == half) acc[j][c] *= f;
  E = e;
}

// the largest |x| over a warp's 16 x 64 tile, rows of half r (0 or 1) or
// both (r = -1), across the quad that holds a row
__device__ __forceinline__ float tile_absmax(const float (&s)[8][4], int r) {
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (r < 0 || (e >> 1) == r) m = fmaxf(m, fabsf(s[i][e]));
  return quad_max(m);
}

// the largest |x| of two quantities (dS and P) over a block's 64-row
// tile (the four warps' 16 x 64 tiles): each warp's, ``a`` and ``b`` from
// tile_absmax(., -1), across its quads, then the warps' through ``wmax``
// [2 kWarps] in shared memory, into ``a`` and ``b``. One barrier; wmax
// may be written again only after another one.
__device__ __forceinline__ void block_absmax2(float& a, float& b,
                                              float* wmax, int w, int lane) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (lane == 0) {
    wmax[w] = a;
    wmax[kWarps + w] = b;
  }
  __syncthreads();
  a = fmaxf(fmaxf(wmax[0], wmax[1]), fmaxf(wmax[2], wmax[3]));
  b = fmaxf(fmaxf(wmax[4], wmax[5]), fmaxf(wmax[6], wmax[7]));
}

// x *= 2^-e over a warp's 16 x 64 tile
__device__ __forceinline__ void scale_tile(float (&x)[8][4], int e) {
  const float f = pow2i(-e);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] *= f;
}

// x 2^e for |e| <= 252 (two exact steps), exactly unless it over- or
// underflows
__device__ __forceinline__ float times_pow2(float x, int e) {
  return x * pow2i(e / 2) * pow2i(e - e / 2);
}

// ---------------------------------------------------------------------------
// The 2-byte forward on tensor cores: K1a's flash_fwd_mma (flash_attention.cu)
// and K1c's short_fwd_mma (flash_short.cu), bf16 and f16, run this one body;
// the design is in flash_attention.cu's header.
// ---------------------------------------------------------------------------
// Shared memory: the q tile, two k, v and bias (64 values) stages, the
// first live key and the live-tile bits (one a kv tile)
template <int D>
inline size_t fwd_mma_smem(int Lk) {
  const size_t words = ((Lk + kTile - 1) / kTile + 31) / 32;
  return (size_t)5 * kTile * D * 2 + 2 * kTile * 4 + 4 + words * 4;
}

// Dead kv-tile skipping of the masked forward (flash_attention.py's
// kv_tile_visits is the same rule): a kv tile is dead when every bias
// value in it is <= -1e30. The block of the q tile at q0 skips dead tiles
// only when each of its rows keeps a live allowed key: not causal, when
// batch entry b has a live key at all; causal, when b's first live key is
// at or before q0. Then a skipped tile would score -1e30 + s everywhere:
// after the first live tile its exp underflows to exactly 0 and m, l and
// O keep their bits; before it, the first live tile's alpha = 0 wipes
// what it left. Otherwise (an entry with no live key: the mean of V; a
// causal row whose allowed keys are all masked) every tile is visited.
// Writes bit t of ``words`` for each live tile t and returns whether to
// skip; reads b's Lk bias values once.
__device__ __forceinline__ bool scan_live_tiles(uint32_t* words, int* first,
                                                const Args& a, int b,
                                                int q0) {
  const int ntiles = (a.Lk + kTile - 1) / kTile, nw = (ntiles + 31) / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < nw; i += kMmaT) words[i] = 0u;
  if (threadIdx.x == 0) *first = a.Lk;
  __syncthreads();
  const float* row = a.bias + (int64_t)b * a.Lk;
  for (int t = w; t < ntiles; t += kWarps) {
    const int c0 = t * kTile + lane, c1 = c0 + 32;
    const uint32_t b0 = __ballot_sync(~0u, c0 < a.Lk && row[c0] > kNegInit);
    const uint32_t b1 = __ballot_sync(~0u, c1 < a.Lk && row[c1] > kNegInit);
    if (lane == 0 && (b0 | b1)) {
      atomicOr(&words[t >> 5], 1u << (t & 31));
      atomicMin(first, t * kTile + (b0 ? __ffs(b0) - 1 : 31 + __ffs(b1)));
    }
  }
  __syncthreads();
  return a.causal ? *first <= q0 : *first < a.Lk;
}

// the first live tile after t (n if none before n)
__device__ __forceinline__ int next_live(const uint32_t* words, int t,
                                         int n) {
  for (int u = t + 1; u < n; u = (u | 31) + 1) {
    const uint32_t bits = words[u >> 5] >> (u & 31);
    if (bits) return min(u + __ffs(bits) - 1, n);
  }
  return n;
}

// out and lse of the 64-row q tile qt of (b, h) = blockIdx.y; MASKED: a
// (B, Lk) key bias (a.bias) is added and dead kv tiles are skipped, else
// a.bias is ignored and none of that code is compiled in; P_ONE: P enters
// P V as one term of T (K1c's f16 form), else as hi + lo
template <int D, bool MASKED, typename T, bool P_ONE = false>
__device__ __forceinline__ void fwd_mma(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        T* __restrict__ out,
                                        float* __restrict__ lse,
                                        const Args& a, int qt) {
  extern __shared__ __align__(128) unsigned char smem_mma[];
  constexpr uint32_t TB = kTile * D * 2;          // bytes of one tile
  const uint32_t Qs = smem_u32(smem_mma), Ks = Qs + TB, Vs = Ks + 2 * TB,
                 Bs = Vs + 2 * TB;
  unsigned char* tail = smem_mma + 5 * TB;
  const float* bias_s = reinterpret_cast<const float*>(tail);
  int* first = reinterpret_cast<int*>(tail + 2 * kTile * 4);
  uint32_t* live = reinterpret_cast<uint32_t*>(first + 1);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = qt * kTile, row0 = q0 + 16 * w;
  const int nkv = kv_tiles_for(a, q0);
  const bool drop = a.inv != 1.0f;
  const bool skip = MASKED && scan_live_tiles(live, first, a, b, q0);
  // tile t's k, v and bias values into stage s
  auto stage = [&](int t, int s) {
    tile_async<D>(Ks + s * TB, k, a, b, h, t * kTile, a.Lk);
    tile_async<D>(Vs + s * TB, v, a, b, h, t * kTile, a.Lk);
    if (MASKED && threadIdx.x < kTile) {
      const int c = t * kTile + threadIdx.x;
      cp_async4(Bs + (s * kTile + threadIdx.x) * 4,
                a.bias + (c < a.Lk ? (int64_t)b * a.Lk + c : 0), c < a.Lk);
    }
  };

  auto after = [&](int t) { return skip ? next_live(live, t, nkv) : t + 1; };
  int t = after(-1);
  tile_async<D>(Qs, q, a, b, h, q0, a.Lq);
  stage(t, 0);
  cp_commit();
  float o[D / 8][4], m[2] = {kNegInit, kNegInit}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;

  for (int s = 0; t < nkv; s ^= 1) {
    const int tn = after(t);
    if (tn < nkv) {               // the next tile's copy under this one
      stage(tn, s ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int kv0 = t * kTile;
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.0f;
    mma_abt<D, T>(sc, Qs, 16 * w, Ks + s * TB, lane);
    // scale, add the key bias and mask in f32; the online softmax of the
    // thread's two rows
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] *= a.scale;
    if (MASKED) {
      const float* bt = bias_s + s * kTile;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 bb =
            *reinterpret_cast<const float2*>(bt + frag_col(lane, i, 0));
        sc[i][0] += bb.x;
        sc[i][1] += bb.y;
        sc[i][2] += bb.x;
        sc[i][3] += bb.y;
      }
    }
    mask_tile(sc, a, row0, kv0, lane, -INFINITY);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[i][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2_ftz((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
    const uint32_t keep = drop ? keep_frag(a, bh, row0, kv0, lane) : ~0u;
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz((sc[i][e] - m[e >> 1]) * kLog2e);
        rs[e >> 1] += p;
        sc[i][e] =
            !drop ? p : ((keep >> (4 * i + e)) & 1u) ? p * a.inv : 0.0f;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    if constexpr (P_ONE)
      mma_r1<D, T>(o, sc, Vs + s * TB, lane);   // O += P V, P one term
    else
      mma_rb<D, T>(o, sc, Vs + s * TB, lane);   // O += P V, P as hi + lo
    __syncthreads();                      // the stage is refilled next
    t = tn;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lc = fmaxf(quad_sum(l[r]), 1e-30f);
    const int row = row0 + frag_row(lane, 2 * r);
    if ((lane & 3) == 0 && row < a.Lq)
      lse[(int64_t)bh * a.Lq + row] = m[r] + logf(lc);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][2 * r] /= lc;
      o[j][2 * r + 1] /= lc;
    }
  }
  store_acc<D>(out, o, a, b, h, row0, a.Lq, 1.0f, lane);
}


// ---------------------------------------------------------------------------
// Cluster pieces (sm_90): the address of a shared variable in another CTA
// of the cluster, loads and stores through it, and the cluster barrier
// (arrive has release and wait acquire semantics, so shared-memory
// writes before an arrive are seen by every CTA after its wait).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(cta));
  return r;
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, const float (&x)[4]) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3])
               : "memory");
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void ld_cluster4(float (&x)[4], uint32_t addr) {
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

// arrive without release semantics: for a CTA whose reads of the others'
// shared memory before it have completed (their values are in registers)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

}  // namespace
