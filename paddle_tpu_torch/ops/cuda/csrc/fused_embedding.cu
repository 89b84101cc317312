// Fused embedding bag for Hopper (sm_90a): for each bag of S ids, gather
// the table rows, skip ids < 0, sum in f32, pool by the valid count (sum,
// mean or sqrtn) and cast to the table's type.
//
// Replaces the TPU kernel in paddle_tpu/ops/pallas/fused_embedding.py:
// _bag_pallas (_bag_kernel), with _xla_bag as its definition: an id < 0
// contributes nothing and is not counted; an id >= V reads row V - 1 (the
// clamp of _xla_bag's gather) and counts; mean divides by max(count, 1)
// and sqrtn by sqrt(max(count, 1)), both in f32 after the sum.
//
// Bound: device-memory bytes. The work is one add per gathered element,
// so the least time is the distinct rows the ids name (read once), the
// ids and the (B, D) output over the memory rate. At CTR sizes the table
// is larger than L2 and the rows are random, so a gather waits on memory
// latency unless many rows are in flight.
//
// Design: one block of 256 threads per (bag, column chunk). Threads lie
// across D, each owning VEC consecutive columns read as one 16-byte load
// (4 f32 or 8 bf16); a row takes `lanes` threads (a power of two, 8 to
// 256), and the block's 256 / lanes groups walk the bag's ids in a
// stride, each thread issuing four row loads before it adds them into f32
// registers, so a block keeps 4 x groups rows in flight. The bag's ids
// are staged in shared memory 1024 at a time, clamped once and counted
// with __syncthreads_count, so each id is read from device memory once.
// The groups' partial sums meet in shared memory; group 0 pools, casts
// (round to nearest even) and stores. Any B, S >= 1 and D >= 1 are
// taken: a D that is not a multiple of VEC, or a table or output that is
// not 16-byte aligned, runs the scalar form (VEC = 1). No fast math: the
// division and square root are IEEE, as in the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIdChunk = 1024;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "f32 rows load as float4");
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    static_assert(VEC == 8, "bf16 rows load as 8 x bf16");
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4)
      p[0] = v[0];
    else
      p[0] = __float2bfloat16(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = x;
  }
}

// combiner: 0 = sum, 1 = mean, 2 = sqrtn
template <typename T, typename I, int VEC>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, const I* __restrict__ ids,
           T* __restrict__ out, int V, int S, int D, int lanes,
           int combiner) {
  __shared__ int ids_s[kIdChunk];
  __shared__ float red[kThreads * VEC];
  const int tid = threadIdx.x;
  const int groups = kThreads / lanes;
  const int g = tid / lanes, lane = tid % lanes;
  const int64_t bag = blockIdx.x;
  const int vi = blockIdx.y * lanes + lane;
  const bool active = vi * VEC < D;
  const int c0 = vi * VEC;
  const I* bag_ids = ids + bag * S;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  int count = 0;
  for (int s0 = 0; s0 < S; s0 += kIdChunk) {
    const int n = min(kIdChunk, S - s0);
    // every thread runs kIdChunk / kThreads rounds: the count is a barrier
    for (int i = tid; i < kIdChunk; i += kThreads) {
      int row = -1;
      if (i < n) {
        const I id = bag_ids[s0 + i];
        row = id < 0 ? -1 : (id >= (I)V ? V - 1 : (int)id);
        ids_s[i] = row;
      }
      count += __syncthreads_count(row >= 0);
    }
    if (active) {
      for (int s = g; s < n; s += groups * kUnroll) {
        float v[kUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int idx = s + u * groups;
          const int row = idx < n ? ids_s[idx] : -1;
          if (row >= 0) {
            load_row<T, VEC>(table + (int64_t)row * D + c0, v[u]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[u][e] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += v[u][e];
      }
    }
    __syncthreads();  // the next chunk overwrites ids_s
  }
  if (groups > 1) {
    if (active && g > 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[((g - 1) * lanes + lane) * VEC + e] = acc[e];
    }
    __syncthreads();
    if (active && g == 0) {
      for (int h = 1; h < groups; ++h)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] += red[((h - 1) * lanes + lane) * VEC + e];
    }
  }
  if (active && g == 0) {
    const float c = fmaxf((float)count, 1.0f);
    if (combiner == 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = acc[e] / c;
    } else if (combiner == 2) {
      const float r = sqrtf(c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = acc[e] / r;
    }
    store_row<T, VEC>(out + bag * D + c0, acc);
  }
}

template <typename T, typename I, int VEC>
int launch(const void* table, const void* ids, void* out, int B, int S, int V,
           int D, int combiner, cudaStream_t st) {
  const int nvec = (D + VEC - 1) / VEC;
  int lanes = 8;
  while (lanes < nvec && lanes < kThreads) lanes *= 2;
  const dim3 grid(B, (nvec + lanes - 1) / lanes);
  bag_kernel<T, I, VEC><<<grid, kThreads, 0, st>>>(
      (const T*)table, (const I*)ids, (T*)out, V, S, D, lanes, combiner);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int dispatch_vec(const void* table, const void* ids, void* out, int B, int S,
                 int V, int D, int combiner, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)table % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0) && (D % kVec == 0);
  if (aligned)
    return launch<T, I, kVec>(table, ids, out, B, S, V, D, combiner, st);
  return launch<T, I, 1>(table, ids, out, B, S, V, D, combiner, st);
}

template <typename T>
int dispatch_ids(const void* table, const void* ids, void* out, int B, int S,
                 int V, int D, int id64, int combiner, cudaStream_t st) {
  if (id64)
    return dispatch_vec<T, int64_t>(table, ids, out, B, S, V, D, combiner,
                                    st);
  return dispatch_vec<T, int32_t>(table, ids, out, B, S, V, D, combiner, st);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16; id64: ids are int64 (else int32);
// combiner: 0 = sum, 1 = mean, 2 = sqrtn
int fused_embedding_bag(const void* table, const void* ids, void* out, int B,
                        int S, int V, int D, int dtype, int id64,
                        int combiner, void* stream) {
  if (B < 1 || S < 1 || V < 1 || D < 1 || (dtype != 0 && dtype != 1) ||
      combiner < 0 || combiner > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_ids<float>(table, ids, out, B, S, V, D, id64, combiner,
                               st);
  return dispatch_ids<__nv_bfloat16>(table, ids, out, B, S, V, D, id64,
                                     combiner, st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
