// Paged decode attention for Hopper (sm_90a), f32 and int8 KV pools.
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas/paged_attention.py:
// _paged_attention_pallas (_paged_attn_kernel) and
// _paged_attention_pallas_quant (_paged_attn_kernel_quant). One query
// token per sequence attends over the live pages its page table names,
// with an online softmax over pages.
//
// Bound: device-memory bytes. Each launch reads every live K/V row once
// (len rows per sequence and head, plus their scales for int8) and does
// about 4 flops per element read, far below the card's f32 balance
// point of ~20 flop/byte.
//
// Design: one block per (head, sequence), so a full-width decode step
// (8 sequences x 16 heads) is 128 blocks, about one wave on 132 SMs.
// The TPU kernel carried (m, l, acc) across sequential grid steps over
// pages; GPU blocks run in no order, so each block loops over its own
// pages j < ceil(len/S) and keeps m and l in registers and acc in the
// registers of the thread that owns each head dimension. The block
// reads its page ids from the table itself (no scalar prefetch). A -1
// table entry inside the live length reads page 0, as both JAX paths
// do (they clamp the table at 0 and mask by position only). Per page:
// each warp scores its tokens (q.k over D, lanes strided over D, a
// warp-shuffle sum), the scores go to shared memory, two block
// reductions give the page max and sum, and every thread folds
// p_t * v_t[d] into its accumulator. The int8 variant dequantises each
// row by its f32 scale as it is read: the K scale multiplies the dot
// product, the V scale multiplies p_t. Loads are one element per lane;
// vectorised loads and a TMA page pipeline are later work.
//
// len == 0 is outside the contract (the engine always attends over at
// least the token it just wrote); such a row comes out as zeros, like
// the Pallas kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kDPerLane = kMaxD / 32;        // q slice a lane holds
constexpr int kDPerThread = kMaxD / kThreads;  // acc slots a thread owns

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max or sum; every thread gets the result. ``red`` holds
// kWarps floats and is free again when this returns.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

template <typename KV, bool kQuant>
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
  extern __shared__ float smem[];
  float* p_s = smem;        // S page scores, then probabilities
  float* red = smem + S;    // kWarps reduction slots
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lens[b];
  int n_pages = len > 0 ? (len + S - 1) / S : 0;
  if (n_pages > T) n_pages = T;

  float qv[kDPerLane];
#pragma unroll
  for (int i = 0; i < kDPerLane; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? q[((size_t)b * H + h) * D + d] : 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  float acc[kDPerThread];
#pragma unroll
  for (int i = 0; i < kDPerThread; ++i) acc[i] = 0.f;

  const size_t row = (size_t)H * D;  // elements from one token to the next
  for (int j = 0; j < n_pages; ++j) {
    int page = table[(size_t)b * T + j];
    if (page < 0) page = 0;
    const int n = min(S, len - j * S);  // live tokens on this page
    const size_t base = (size_t)page * S * row + (size_t)h * D;

    for (int t = warp; t < n; t += kWarps) {
      const KV* kr = k_pages + base + (size_t)t * row;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) dot += qv[i] * static_cast<float>(kr[d]);
      }
      dot = warp_sum(dot);
      if (kQuant) dot *= k_scales[(size_t)page * S + t];
      if (lane == 0) p_s[t] = dot * sm_scale;
    }
    __syncthreads();

    float pm = -INFINITY;
    for (int t = tid; t < n; t += kThreads) pm = fmaxf(pm, p_s[t]);
    pm = block_reduce<true>(pm, red);
    const float m_new = fmaxf(m, pm);
    const float alpha = expf(m - m_new);
    float ps = 0.f;
    for (int t = tid; t < n; t += kThreads) {
      const float p = expf(p_s[t] - m_new);
      ps += p;
      p_s[t] = kQuant ? p * v_scales[(size_t)page * S + t] : p;
    }
    ps = block_reduce<false>(ps, red);  // also orders the p_s writes
    l = alpha * l + ps;
    m = m_new;

#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) {
      const int d = tid + kThreads * i;
      if (d < D) {
        const KV* vr = v_pages + base + d;
        float a = acc[i] * alpha;
        for (int t = 0; t < n; ++t)
          a += p_s[t] * static_cast<float>(vr[(size_t)t * row]);
        acc[i] = a;
      }
    }
    __syncthreads();  // p_s is rewritten by the next page
  }

  const float norm = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kDPerThread; ++i) {
    const int d = tid + kThreads * i;
    if (d < D) out[((size_t)b * H + h) * D + d] = acc[i] / norm;
  }
}

template <typename KV, bool kQuant>
int launch(const float* q, const KV* k, const KV* v, const float* ks,
           const float* vs, const int32_t* table, const int32_t* lens,
           float* out, int B, int H, int D, int S, int T, float sm_scale,
           cudaStream_t stream) {
  if (D < 1 || D > kMaxD || S < 1 || T < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(S + kWarps) * sizeof(float);
  auto kern = paged_attn_kernel<KV, kQuant>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, ks, vs, table, lens, out,
                                         H, D, S, T, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int paged_attention_f32(const float* q, const float* k_pages,
                        const float* v_pages, const int32_t* table,
                        const int32_t* lens, float* out, int B, int H, int D,
                        int S, int T, float sm_scale, void* stream) {
  return launch<float, false>(q, k_pages, v_pages, nullptr, nullptr, table,
                              lens, out, B, H, D, S, T, sm_scale,
                              (cudaStream_t)stream);
}

int paged_attention_int8(const float* q, const int8_t* k_pages,
                         const int8_t* v_pages, const float* k_scales,
                         const float* v_scales, const int32_t* table,
                         const int32_t* lens, float* out, int B, int H, int D,
                         int S, int T, float sm_scale, void* stream) {
  return launch<int8_t, true>(q, k_pages, v_pages, k_scales, v_scales, table,
                              lens, out, B, H, D, S, T, sm_scale,
                              (cudaStream_t)stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
