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
// is larger than L2 (tools/op_bench.py:163: 100000 x 256 f32, 102.4 MB,
// twice the H100's 50 MB) and the rows are random, so a kernel that takes
// each bag's ids in their order reads a row again from device memory
// when a later bag names it after it has left L2 (~2.4 reads a row
// there). Every gathered row also crosses from L2 to an SM, ~215 MB at
// that shape, which the L2's bandwidth bounds even when the whole table
// is in L2 (a 24,000-row table: ~0.044 ms).
//
// Design: two forms, chosen on the host by what the inputs show.
//
// The sweep (bag_sweep_kernel, f32 tables) takes the table through L2 in
// row order. Each CTA owns a run of ipc ITEMS (an item is a bag and a
// chunk of `lanes * 8` columns) with their f32 accumulators and counts in
// shared memory; the grid holds as many CTAs as the items need, and the
// host picks ipc so that the CTAs an SM can hold cover the items in as
// few waves as shared memory allows. A CTA stages its items' ids in
// shared memory (clamped once, counted once; ids < 0 as INT_MAX), sorts
// each item's staged run into ascending rows (a bitonic sort over the run
// padded to a power of two; equal rows are equal values, so the order
// among them does not matter) and adds the rows in that order, so every
// CTA of a wave walks up the table from row 0 at about the same pace and
// a row's later reads, by other bags, find it in L2. A bag longer than
// kStageIds is staged run by run. Threads lie across D, each owning 8
// consecutive columns read as two 16-byte loads; a group of `lanes`
// threads (a power of two, 8 to 256; a warp at D = 256) takes one item at
// a time with 64 bytes of rows a thread in flight. The sum is staged run
// by staged run, ascending rows within a run, a fixed order, so two
// launches give the same bits. (Sweeping the table in bands, with CTAs
// paced band by band, was slower at every band count and table size
// measured on the H100: PERF.md.)
//
// The per-bag form (bag_kernel) is one block of 256 threads per (bag,
// column chunk): the block's 256 / lanes groups walk the bag's ids in a
// stride, each thread four row loads in flight (VEC = 4 f32 or 8 bf16
// columns a 16-byte load), the ids staged 1024 at a time and counted
// with __syncthreads_count; the groups' partial sums meet in shared
// memory in group order, also a fixed order.
//
// The sweep pays only where the gathers are bound by device-memory
// bytes: f32 rows of at least 1 KB, a table larger than half the L2 (an
// L2 half is what an SM reaches nearest), and bags enough to give every
// SM a CTA of full groups. Elsewhere the per-bag form is faster on the
// H100 (small tables; bf16 tables, with 512-byte or 1 KB rows; 400-byte
// f32 rows; a few long bags: PERF.md), and it also takes what the sweep
// does not: a D that is not a multiple of 8, or a table or output that
// is not 16-byte aligned (its scalar form, VEC = 1, where D is not a
// multiple of its VEC either). Then each group pools by the count (sum,
// mean or sqrtn), casts (round to nearest even) and stores. Any B, S >= 1
// and D >= 1 are taken. No fast math: the division and square root are
// IEEE, as in the plain version.
#include <limits.h>

#include <algorithm>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the sweep
constexpr int kVec = 8;              // columns a thread owns
constexpr int kFlightBytes = 64;     // bytes of rows a thread has in flight
constexpr int kStageIds = 512;       // ids an item stages at a time
constexpr int kSmemBudget = 48 << 10;  // dynamic shared memory a CTA
constexpr int kSweepRowBytes = 1024;   // the least row the sweep takes
// the per-bag form
constexpr int kIdChunk = 1024;       // ids a block stages at a time
constexpr int kBagUnroll = 4;        // rows a thread has in flight

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC consecutive values of a row as f32: 16-byte loads (4 f32 or 8 bf16
// each) when VEC > 1 (the caller has checked the alignment), else one
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(p[0]);
  } else {
    constexpr int kPer = 16 / sizeof(T);
    static_assert(VEC % kPer == 0, "whole 16-byte loads");
#pragma unroll
    for (int c = 0; c < VEC / kPer; ++c) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + c);
      if constexpr (sizeof(T) == 4) {
        v[4 * c] = __uint_as_float(x.x);
        v[4 * c + 1] = __uint_as_float(x.y);
        v[4 * c + 2] = __uint_as_float(x.z);
        v[4 * c + 3] = __uint_as_float(x.w);
      } else {
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          v[8 * c + 2 * i] = f.x;
          v[8 * c + 2 * i + 1] = f.y;
        }
      }
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
  } else {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < VEC / kPer; ++c) {
      uint4 x;
      if constexpr (sizeof(T) == 4) {
        x = make_uint4(
            __float_as_uint(v[4 * c]), __float_as_uint(v[4 * c + 1]),
            __float_as_uint(v[4 * c + 2]), __float_as_uint(v[4 * c + 3]));
      } else {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[i] = __floats2bfloat162_rn(v[8 * c + 2 * i],
                                       v[8 * c + 2 * i + 1]);
      }
      reinterpret_cast<uint4*>(p)[c] = x;
    }
  }
}

// The per-bag form: block (bag, column chunk); lanes threads a row.
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
      for (int s = g; s < n; s += groups * kBagUnroll) {
        float v[kBagUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kBagUnroll; ++u) {
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
        for (int u = 0; u < kBagUnroll; ++u)
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
int launch_bag(const void* table, const void* ids, void* out, int B, int S,
               int V, int D, int combiner, cudaStream_t st) {
  const int nvec = (D + VEC - 1) / VEC;
  int lanes = 8;
  while (lanes < nvec && lanes < kThreads) lanes *= 2;
  const dim3 grid(B, (nvec + lanes - 1) / lanes);
  bag_kernel<T, I, VEC><<<grid, kThreads, 0, st>>>(
      (const T*)table, (const I*)ids, (T*)out, V, S, D, lanes, combiner);
  return (int)cudaGetLastError();
}

struct BagArgs {
  int V, S, D;
  int lanes;       // threads a row (an item's group)
  int chunks;      // column chunks of lanes * VEC columns a bag
  int64_t items;   // B * chunks
  int ipc;         // items a CTA holds in shared memory
  int stage;       // ids an item stages at a time: min(S, kStageIds)
  int pad;         // the staged run's length sorted: a power of two >= stage
  int combiner;    // 0 = sum, 1 = mean, 2 = sqrtn
};

// The sweep's lanes for D columns: threads a row, a power of two from 8
// to kThreads that covers D in vectors of kVec where it can.
int sweep_lanes(int D) {
  const int nvec = (D + kVec - 1) / kVec;
  int lanes = 8;
  while (lanes < nvec && lanes < kThreads) lanes *= 2;
  return lanes;
}

// First index of the ascending run rs[0, n) whose value is >= x.
__device__ __forceinline__ int first_at_least(const int* rs, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rs[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Sorts each of the n_loc runs of `pad` ints at rs ascending (bitonic;
// pad a power of two), all threads of the CTA taking part.
__device__ __forceinline__ void sort_runs(int* rs, int n_loc, int pad) {
  const int half = pad >> 1;
  for (int size = 2; size <= pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int k = threadIdx.x; k < n_loc * half; k += blockDim.x) {
        const int it = k / half, j = k - it * half;
        const int i = 2 * j - (j & (stride - 1));   // i's bit `stride` is 0
        int* r = rs + it * pad;
        const int x = r[i], y = r[i + stride];
        if ((x > y) == ((i & size) == 0)) {
          r[i] = y;
          r[i + stride] = x;
        }
      }
    }
  }
  __syncthreads();
}

// The sweep: ipc items a CTA; lanes threads a row.
template <typename T, typename I, int VEC>
__global__ void __launch_bounds__(kThreads)
bag_sweep_kernel(const T* __restrict__ table, const I* __restrict__ ids,
                 T* __restrict__ out, const BagArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.lanes * VEC;                    // columns of an item
  float* acc = reinterpret_cast<float*>(smem);    // (ipc, W)
  int* rows = reinterpret_cast<int*>(acc + (int64_t)a.ipc * W);  // (ipc, pad)
  int* cnt = rows + a.ipc * a.pad;                // (ipc,)
  const int tid = threadIdx.x;
  const int groups = kThreads / a.lanes;
  const int g = tid / a.lanes, c_item = (tid % a.lanes) * VEC;
  const int64_t base = (int64_t)blockIdx.x * a.ipc;
  const int64_t left = a.items - base;
  const int n_loc = left < a.ipc ? (int)left : a.ipc;
  for (int k = tid; k < n_loc * W; k += kThreads) acc[k] = 0.0f;
  for (int k = tid; k < n_loc; k += kThreads) cnt[k] = 0;
  for (int s0 = 0; s0 < a.S; s0 += a.stage) {
    const int n = min(a.stage, a.S - s0);
    __syncthreads();  // the zeroing, the last run's reads
    // stage the clamped rows (ids < 0 and the padding past n as INT_MAX,
    // which sort last) and count the valid ones
    for (int k = tid; k < n_loc * a.pad; k += kThreads) {
      const int it = k / a.pad, s = k - it * a.pad;
      int row = INT_MAX;
      if (s < n) {
        const int64_t bag = (base + it) / a.chunks;
        const I id = ids[bag * a.S + s0 + s];
        if (id >= 0) {
          row = id >= (I)a.V ? a.V - 1 : (int)id;
          atomicAdd(&cnt[it], 1);
        }
      }
      rows[k] = row;
    }
    sort_runs(rows, n_loc, a.pad);
    for (int it = g; it < n_loc; it += groups) {
      const int col = (int)((base + it) % a.chunks) * W + c_item;
      const bool active = col < a.D;
      const int* rs = rows + it * a.pad;
      const int end = first_at_least(rs, n, a.V);   // the valid rows
      float* x = acc + (int64_t)it * W + c_item;
      float sum[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum[e] = x[e];
      // rows in flight: 2 of f32
      constexpr int kUnroll = kFlightBytes / (VEC * (int)sizeof(T));
      for (int s = 0; s < end; s += kUnroll) {
        int r[kUnroll];
        float v[kUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          r[u] = s + u < end ? rs[s + u] : -1;
          if (active && r[u] >= 0) {
            load_row<T, VEC>(table + (int64_t)r[u] * a.D + col, v[u]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[u][e] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (r[u] >= 0)
#pragma unroll
            for (int e = 0; e < VEC; ++e) sum[e] += v[u][e];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = sum[e];
    }
  }
  for (int it = g; it < n_loc; it += groups) {
    const int col = (int)((base + it) % a.chunks) * W + c_item;
    if (col >= a.D) continue;
    const int64_t bag = (base + it) / a.chunks;
    float sum[VEC];
    const float* x = acc + (int64_t)it * W + c_item;
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum[e] = x[e];
    const float c = fmaxf((float)cnt[it], 1.0f);
    if (a.combiner == 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum[e] = sum[e] / c;
    } else if (a.combiner == 2) {
      const float r = sqrtf(c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum[e] = sum[e] / r;
    }
    store_row<T, VEC>(out + bag * a.D + col, sum);
  }
}

template <typename I>
int launch_sweep(const void* table, const void* ids, void* out, int B,
                 int S, int V, int D, int combiner, cudaStream_t st) {
  using T = float;
  constexpr int VEC = kVec;
  auto kernel = bag_sweep_kernel<T, I, VEC>;
  const int nvec = (D + VEC - 1) / VEC;
  const int lanes = sweep_lanes(D);
  BagArgs a{};
  a.V = V;
  a.S = S;
  a.D = D;
  a.lanes = lanes;
  a.chunks = (nvec + lanes - 1) / lanes;
  a.items = (int64_t)B * a.chunks;
  a.stage = std::min(S, kStageIds);
  a.pad = 1;
  while (a.pad < a.stage) a.pad *= 2;
  a.combiner = combiner;
  // the launch shape depends only on (device, items, lanes, pad): the
  // host queries the occupancy once for a shape and keeps the last one
  struct Shape {
    int dev = -1;
    int64_t items = -1;
    int lanes = 0, pad = 0, ipc = 0;
    size_t smem = 0;
  };
  static thread_local Shape last;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (last.dev != dev || last.items != a.items || last.lanes != lanes ||
      last.pad != a.pad) {
    const int groups = kThreads / lanes;
    const int64_t per_item = (int64_t)lanes * VEC * 4 + (int64_t)a.pad * 4 + 4;
    const int64_t ipc_cap = std::max<int64_t>(1, kSmemBudget / per_item);
    int sms = 0, occ = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    // the most CTAs an SM holds whose shared memory still allows that
    // many: one wave when the items fit, else waves of full CTAs
    Shape shape;
    for (int k = occ; k >= 1; --k) {
      const int64_t ctas = (int64_t)sms * k;
      const int64_t ipc = std::min(
          ipc_cap, std::max<int64_t>(groups, (a.items + ctas - 1) / ctas));
      const size_t smem = (size_t)(ipc * per_item);
      int fit = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                          kThreads, smem);
      if (err != cudaSuccess) return (int)err;
      if (fit >= k || k == 1) {
        if (fit < 1) return (int)cudaErrorInvalidConfiguration;
        shape = {dev, a.items, lanes, a.pad, (int)ipc, smem};
        break;
      }
    }
    last = shape;
  }
  a.ipc = last.ipc;
  if (a.ipc < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t grid = (a.items + a.ipc - 1) / a.ipc;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreads, last.smem, st>>>(
      (const T*)table, (const I*)ids, (T*)out, a);
  return (int)cudaGetLastError();
}

// The SMs and L2 bytes of the current device, read once a device.
cudaError_t device_shape(int* sms, int* l2) {
  static thread_local int dev = -1, n_sm = 0, l2_bytes = 0;
  int d = 0;
  cudaError_t err = cudaGetDevice(&d);
  if (err != cudaSuccess || d == dev) {
    *sms = n_sm;
    *l2 = l2_bytes;
    return err;
  }
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, d);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l2_bytes, cudaDevAttrL2CacheSize, d);
  if (err != cudaSuccess) return err;
  dev = d;
  *sms = n_sm;
  *l2 = l2_bytes;
  return cudaSuccess;
}

template <typename T, typename I>
int dispatch_vec(const void* table, const void* ids, void* out, int B,
                 int S, int V, int D, int combiner, cudaStream_t st) {
  const bool aligned = ((uintptr_t)table % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0);
  if constexpr (sizeof(T) == 4) {
    if (aligned && D % kVec == 0 && D * 4 >= kSweepRowBytes) {
      int sms = 0, l2 = 0;
      const cudaError_t err = device_shape(&sms, &l2);
      if (err != cudaSuccess) return (int)err;
      const int lanes = sweep_lanes(D);
      const int64_t chunks = (D / kVec + lanes - 1) / lanes;
      if ((int64_t)V * D * 4 > l2 / 2 &&
          (int64_t)B * chunks >= (int64_t)sms * (kThreads / lanes))
        return launch_sweep<I>(table, ids, out, B, S, V, D, combiner, st);
    }
  }
  constexpr int kBagVec = 16 / sizeof(T);   // one 16-byte load a row
  if (aligned && D % kBagVec == 0)
    return launch_bag<T, I, kBagVec>(table, ids, out, B, S, V, D, combiner,
                                     st);
  return launch_bag<T, I, 1>(table, ids, out, B, S, V, D, combiner, st);
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
