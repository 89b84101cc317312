// Paged decode attention for Hopper (sm_90a): f32, bf16, f16 and int8 KV
// pools.
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas/paged_attention.py:
// _paged_attention_pallas (_paged_attn_kernel, which upcasts whatever page
// type it is given, so one kernel serves the f32, bf16 and f16 pools) and
// _paged_attention_pallas_quant (_paged_attn_kernel_quant). One query
// token per sequence attends over the live pages its page table names,
// with an online softmax over pages.
//
// Bound: device-memory bytes. Each launch reads every live K/V row once
// (len rows per sequence and head, plus their scales for int8) and does
// about 4 flops per element read, far below the card's f32 balance
// point of ~20 flop/byte. At the engine's shapes (8 sequences x 16 heads
// x 128, pages of 128, 4,932 live tokens) and an H100 SXM's data-sheet
// 3.35 TB/s (700 W) that is 0.0242 ms for f32, 0.0121 ms for bf16 and
// f16, and 0.0061 ms for int8. The longest sequence holds 42 % of the
// tokens, so one block per (head, sequence) walking its pages in series
// is bound by that sequence's latency, not by the card's bandwidth.
//
// Design: the pages of one (head, sequence) are split over a thread-block
// cluster of C CTAs. C comes from the table's width T on the host
// (min(T, 8), the portable limit; paged_attention.py cluster_size), never
// from the lengths, which live on the device. CTA r takes the stripe of
// table entries [r * ceil(T / C), (r + 1) * ceil(T / C)) and keeps its own
// (m, l, acc). A stripe streams through shared memory in chunks of
// Chunk<KV>::kTokens tokens (16 for f32, 32 for bf16 and f16, 64 for int8:
// 2 KB of K row a chunk at head_dim 128 for f32, 8 KB for int8, whose
// sizes were the fastest of those timed on the card; 2-byte pages take the
// middle, not tuned; a chunk never crosses a page) through a two-stage
// cp.async ring: the next chunk's K and V rows (16-byte copies; 4-byte ones
// for an int8 head_dim that is not a multiple of 16 and a 2-byte one that
// is not a multiple of 8) and their scales arrive under this chunk's work.
// Only live rows are copied; a row past the length scores -inf and its V
// row is never read.
// - Scores: 8 lanes score one token, so one 16-byte load a lane scores 4
//   tokens a warp (int8 at D = 128; bf16 and f16 take 2 loads, f32 4),
//   and a three-shuffle sum finishes each dot product. 2-byte values are
//   unpacked to f32 in registers: a bf16 is the upper half of its f32, so
//   a shift; an f16 goes through __half2float. The int8 K scale
//   multiplies the dot product, then the softmax scale.
// - Softmax: each warp owns a quarter of every chunk's tokens and runs
//   its own online softmax (m, l, and a D-wide accumulator, a 4-value
//   slice a lane): no block reduction and no __syncthreads per token
//   group, two per chunk for the ring.
// - Values: each token's p (times its V scale for int8) weights its V
//   row; l sums the unscaled p, as in the TPU kernel.
// - Combine: the 4 warps' partials are merged in warp order into the
//   CTA's; after a cluster barrier the leader (rank 0) reads the C
//   partials through distributed shared memory and merges them in rank
//   order, then writes out = acc / l. One launch, no atomics and no
//   scratch, so two launches give the same bits. Every CTA, an empty
//   stripe's too, meets both cluster barriers: the second keeps its
//   shared memory alive until the leader has read it.
// A -1 table entry inside the live length reads page 0, as both JAX
// paths do (they clamp the table at 0 and mask by position only); pages
// past T are not read. len == 0 is outside the contract (the engine
// always attends over at least the token it just wrote); such a row
// comes out as zeros, like the Pallas kernel.
#include <cuda_fp16.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kThreads = kMmaT;     // 4 warps
constexpr int kGroup = 8;           // lanes that score one token
constexpr int kMaxD = 256;
constexpr int kMaxCluster = 8;

template <typename KV>
struct Chunk {                      // tokens a ring stage
  static constexpr int kTokens = sizeof(KV) == 4 ? 16 : sizeof(KV) == 2 ? 32
                                                                        : 64;
};

// the two 2-byte values of one 32-bit word as f32, the lower address first
template <typename KV>
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  if constexpr (std::is_same<KV, __half>::value) {
    lo = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    hi = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  } else {                          // bf16: the upper half of an f32
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xffff0000u);
  }
}

// E consecutive pool values from shared memory as f32
template <typename KV, int E>
__device__ __forceinline__ void load_vals(const unsigned char* p,
                                          float (&x)[E]) {
  if constexpr (sizeof(KV) == 4) {
    static_assert(E == 4, "f32 values come as a float4");
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else if constexpr (sizeof(KV) == 2) {
    static_assert(E == 2 || E == 4 || E == 8,
                  "2-byte values come as 4, 8 or 16 bytes");
    uint32_t w[E / 2];
    if constexpr (E == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else if constexpr (E == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < E / 2; ++i) unpack2<KV>(w[i], x[2 * i], x[2 * i + 1]);
  } else {
    static_assert(E == 4 || E == 16, "int8 values come as 4 or 16 bytes");
    int w[E / 4];
    if constexpr (E == 16) {
      const int4 v = *reinterpret_cast<const int4*>(p);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      w[0] = *reinterpret_cast<const int*>(p);
    }
#pragma unroll
    for (int i = 0; i < E / 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = (float)(int8_t)(w[i] >> (8 * j));
  }
}

template <int UB>
__device__ __forceinline__ void copy_unit(uint32_t dst, const void* src) {
  if constexpr (UB == 16) {
    cp_async16(dst, src, true);
  } else {
    cp_async4(dst, src, true);
  }
}

// bytes of one ring stage: K and V rows, then K and V scales
template <typename KV>
__host__ __device__ __forceinline__ size_t stage_bytes(int D) {
  constexpr int CH = Chunk<KV>::kTokens;
  return (size_t)2 * CH * D * sizeof(KV) + 2 * CH * sizeof(float);
}

// UB: bytes of one K copy and score load (16, or 4 for int8 pools whose
// head_dim is not a multiple of 16)
template <typename KV, bool kQuant, int UB>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const float* __restrict__ q,         // (B, H, D)
                  const KV* __restrict__ k_pages,      // (P, S, H, D)
                  const KV* __restrict__ v_pages,      // (P, S, H, D)
                  const float* __restrict__ k_scales,  // (P, S) or null
                  const float* __restrict__ v_scales,  // (P, S) or null
                  const int32_t* __restrict__ table,   // (B, T)
                  const int32_t* __restrict__ lens,    // (B,)
                  float* __restrict__ out,             // (B, H, D)
                  int H, int D, int S, int T, float sm_scale) {
  constexpr int CH = Chunk<KV>::kTokens;
  constexpr int E = UB / (int)sizeof(KV);   // values a score load
  constexpr int J = 32 / E;                 // score loads a lane, D <= 256
  constexpr int TPW = CH / kWarps;          // tokens a warp a chunk
  constexpr int NI = TPW / 4;               // 4 tokens a step
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowb = D * (int)sizeof(KV);
  const int nu = rowb / UB;                 // score loads a row
  const int nv = D / 4;                     // 4-value slices a row
  const size_t SB = stage_bytes<KV>(D);
  // the warps' and the CTA's (m, l, acc): [kWarps + 1][D + 2]
  float* part = reinterpret_cast<float*>(smem + 2 * SB);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane / kGroup, sub = lane % kGroup;
  const int rank = (int)cluster_rank(), C = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int len = lens[b];
  const int n_pages = min(len > 0 ? (len + S - 1) / S : 0, T);
  const int live_end = min(len, n_pages * S);   // tokens to attend over
  const int per = (T + C - 1) / C;
  const int j0 = rank * per, j1 = min(j0 + per, n_pages);
  const int che = min(CH, S);                   // tokens a chunk
  const int cpp = (S + che - 1) / che;          // chunks a page

  float qv[J][E];                               // loads sub + 8 j of q
  const float* qr = q + ((size_t)b * H + h) * D;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int u = sub + kGroup * j;
      qv[j][e] = u < nu ? qr[u * E + e] : 0.0f;
    }

  // chunk u of the stripe: its page, first token and live token count
  auto chunk = [&](int u, int& pg, int& first, int& cnt) -> bool {
    const int j = j0 + u / cpp;
    first = (u % cpp) * che;
    if (j >= j1 || j * S + first >= live_end) return false;
    cnt = min(min(che, S - first), live_end - j * S - first);
    pg = max(table[(size_t)b * T + j], 0);
    return true;
  };
  auto issue = [&](int pg, int first, int cnt, int s) {
    const uint32_t ks = smem_u32(smem + s * SB), vs = ks + CH * rowb,
                   sc = vs + CH * rowb;
    const size_t row0 = ((size_t)pg * S + first) * H + h;
    for (int i = tid; i < cnt * nu; i += kThreads) {
      const int r = i / nu, c = i % nu;
      const size_t off = (row0 + (size_t)r * H) * rowb + (size_t)c * UB;
      copy_unit<UB>(ks + r * rowb + c * UB,
                    reinterpret_cast<const unsigned char*>(k_pages) + off);
      copy_unit<UB>(vs + r * rowb + c * UB,
                    reinterpret_cast<const unsigned char*>(v_pages) + off);
    }
    if (kQuant) {
      for (int i = tid; i < cnt; i += kThreads) {
        const size_t off = (size_t)pg * S + first + i;
        cp_async4(sc + 4 * i, k_scales + off, true);
        cp_async4(sc + 4 * (CH + i), v_scales + off, true);
      }
    }
  };

  float m = kNegInit, l = 0.0f, acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  int page, tok0, n;
  bool live = chunk(0, page, tok0, n);
  if (live) issue(page, tok0, n, 0);
  cp_commit();
  for (int u = 0; live; ++u) {
    int pn = 0, tn = 0, nn = 0;
    const bool live_n = chunk(u + 1, pn, tn, nn);
    if (live_n) {               // the next chunk's copy under this one
      issue(pn, tn, nn, (u + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const unsigned char* Ks = smem + (u & 1) * SB;
    const unsigned char* Vs = Ks + CH * rowb;
    const float* kss = reinterpret_cast<const float*>(Vs + CH * rowb);
    const float* vss = kss + CH;
    // scores: step i, group g scores token w * TPW + 4 i + g
    float sc[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int t = w * TPW + 4 * i + g;
      float d = 0.0f;
      if (t < n) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = sub + kGroup * j;
          if (c < nu) {
            float x[E];
            load_vals<KV, E>(Ks + t * rowb + c * UB, x);
#pragma unroll
            for (int e = 0; e < E; ++e) d = fmaf(qv[j][e], x[e], d);
          }
        }
      }
      d += __shfl_xor_sync(~0u, d, 1);
      d += __shfl_xor_sync(~0u, d, 2);
      d += __shfl_xor_sync(~0u, d, 4);
      if (kQuant && t < n) d *= kss[t];
      sc[i] = t < n ? d * sm_scale : -INFINITY;
    }
    // the warp's online softmax over its tokens of this chunk
    float mx = sc[0];
#pragma unroll
    for (int i = 1; i < NI; ++i) mx = fmaxf(mx, sc[i]);
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 16));
    const float m_new = fmaxf(m, mx), alpha = expf(m - m_new);
    float ps = 0.0f, pv[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int t = w * TPW + 4 * i + g;
      const float p = expf(sc[i] - m_new);
      ps += p;
      pv[i] = kQuant ? (t < n ? p * vss[t] : 0.0f) : p;
    }
    ps += __shfl_xor_sync(~0u, ps, 8);
    ps += __shfl_xor_sync(~0u, ps, 16);
    l = alpha * l + ps;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) {
        const float pt = __shfl_sync(~0u, pv[i], kGroup * gg);
        const int t = w * TPW + 4 * i + gg;
        if (t >= n) continue;
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int c = lane + 32 * ii;
          if (c < nv) {
            float x[4];
            load_vals<KV, 4>(Vs + t * rowb + c * 4 * (int)sizeof(KV), x);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[ii][e] = fmaf(pt, x[e], acc[ii][e]);
          }
        }
      }
    __syncthreads();            // the stage is refilled next
    live = live_n;
    n = nn;
  }

  // the warps' partials, merged in warp order into the CTA's
  float* wp = part + w * (D + 2);
  if (lane == 0) {
    wp[0] = m;
    wp[1] = l;
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int c = lane + 32 * ii;
    if (c < nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) wp[2 + 4 * c + e] = acc[ii][e];
  }
  __syncthreads();
  float* cp = part + kWarps * (D + 2);
  float wm = kNegInit, wscale[kWarps];
#pragma unroll
  for (int ww = 0; ww < kWarps; ++ww) wm = fmaxf(wm, part[ww * (D + 2)]);
#pragma unroll
  for (int ww = 0; ww < kWarps; ++ww)
    wscale[ww] = expf(part[ww * (D + 2)] - wm);
  if (tid == 0) {
    float wl = 0.0f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      wl += part[ww * (D + 2) + 1] * wscale[ww];
    cp[0] = wm;
    cp[1] = wl;
  }
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.0f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      a += part[ww * (D + 2) + 2 + d] * wscale[ww];
    cp[2 + d] = a;
  }
  cluster_arrive();             // every CTA's partial is written
  cluster_wait();
  if (rank == 0) {
    // the C partials in rank order, through distributed shared memory
    const uint32_t base = smem_u32(cp);
    float cm[kMaxCluster], M = kNegInit, L = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) {
        cm[r] = ld_cluster(cluster_map(base, r));
        M = fmaxf(M, cm[r]);
      }
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) {
        cm[r] = expf(cm[r] - M);
        L += ld_cluster(cluster_map(base + 4, r)) * cm[r];
      }
    const float norm = fmaxf(L, 1e-30f);
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < C) a += ld_cluster(cluster_map(base + 4 * (2 + d), r)) * cm[r];
      out[((size_t)b * H + h) * D + d] = a / norm;
    }
  }
  cluster_arrive();             // the leader's reads are done before any
  cluster_wait();               // CTA's shared memory goes away
}

template <typename KV, bool kQuant, int UB>
int launch(const float* q, const KV* k, const KV* v, const float* ks,
           const float* vs, const int32_t* table, const int32_t* lens,
           float* out, int B, int H, int D, int S, int T, int C,
           float sm_scale, cudaStream_t stream) {
  const size_t smem =
      2 * stage_bytes<KV>(D) + (size_t)(kWarps + 1) * (D + 2) * sizeof(float);
  auto kern = paged_attn_kernel<KV, kQuant, UB>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, q, k, v, ks, vs, table, lens, out, H, D,
                         S, T, sm_scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int D, int S, int T, int C) {
  return D < 4 || D > kMaxD || D % 4 != 0 || S < 1 || T < 1 || B < 1 ||
         B > 65535 || H < 1 || H > 65535 || C < 1 || C > kMaxCluster;
}

// 2-byte pools: 16-byte K copies when a row is a multiple of 16 bytes
template <typename KV>
int launch_half(const float* q, const KV* k_pages, const KV* v_pages,
                const int32_t* table, const int32_t* lens, float* out, int B,
                int H, int D, int S, int T, int C, float sm_scale,
                void* stream) {
  if (bad_shape(B, H, D, S, T, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 8 == 0)
    return launch<KV, false, 16>(q, k_pages, v_pages, nullptr, nullptr, table,
                                 lens, out, B, H, D, S, T, C, sm_scale, st);
  return launch<KV, false, 4>(q, k_pages, v_pages, nullptr, nullptr, table,
                              lens, out, B, H, D, S, T, C, sm_scale, st);
}

}  // namespace

extern "C" {

// C: CTAs a (head, sequence), 1 .. 8
int paged_attention_f32(const float* q, const float* k_pages,
                        const float* v_pages, const int32_t* table,
                        const int32_t* lens, float* out, int B, int H, int D,
                        int S, int T, int C, float sm_scale, void* stream) {
  if (bad_shape(B, H, D, S, T, C)) return (int)cudaErrorInvalidValue;
  return launch<float, false, 16>(q, k_pages, v_pages, nullptr, nullptr,
                                  table, lens, out, B, H, D, S, T, C,
                                  sm_scale, (cudaStream_t)stream);
}

int paged_attention_bf16(const float* q, const __nv_bfloat16* k_pages,
                         const __nv_bfloat16* v_pages, const int32_t* table,
                         const int32_t* lens, float* out, int B, int H, int D,
                         int S, int T, int C, float sm_scale, void* stream) {
  return launch_half<__nv_bfloat16>(q, k_pages, v_pages, table, lens, out, B,
                                    H, D, S, T, C, sm_scale, stream);
}

int paged_attention_f16(const float* q, const __half* k_pages,
                        const __half* v_pages, const int32_t* table,
                        const int32_t* lens, float* out, int B, int H, int D,
                        int S, int T, int C, float sm_scale, void* stream) {
  return launch_half<__half>(q, k_pages, v_pages, table, lens, out, B, H, D,
                             S, T, C, sm_scale, stream);
}

int paged_attention_int8(const float* q, const int8_t* k_pages,
                         const int8_t* v_pages, const float* k_scales,
                         const float* v_scales, const int32_t* table,
                         const int32_t* lens, float* out, int B, int H, int D,
                         int S, int T, int C, float sm_scale, void* stream) {
  if (bad_shape(B, H, D, S, T, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 16 == 0)
    return launch<int8_t, true, 16>(q, k_pages, v_pages, k_scales, v_scales,
                                    table, lens, out, B, H, D, S, T, C,
                                    sm_scale, st);
  return launch<int8_t, true, 4>(q, k_pages, v_pages, k_scales, v_scales,
                                 table, lens, out, B, H, D, S, T, C, sm_scale,
                                 st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
