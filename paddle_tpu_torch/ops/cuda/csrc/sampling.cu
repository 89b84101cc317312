// Fused token sampling for Hopper (sm_90a): temperature scale, top-k
// threshold, Gumbel noise, first-max argmax, one logits row per
// thread-block cluster.
//
// Replaces the TPU kernel in paddle_tpu/ops/pallas/sampling.py:
// _fused_sample_pallas (_sample_kernel), and follows the function the
// JAX package computes at the engine's width, _xla_sample under jit.
//
// Bound: device-memory bytes. The logits and noise rows are read once
// each and one int32 is written per row: 2 MB at the engine's 8 x 32000,
// 0.6 us at 3.35 TB/s, so at that size a call is bound by its latency
// (launch, dependent rounds, barriers), and the design cuts the rounds.
//
// Design: a cluster of kCluster CTAs per row (grid (kCluster, B)), so
// the engine's 8 rows run on 64 SMs. CTA q takes the slice [q*L, q*L +
// L) of the row (L = ceil(V / kCluster) rounded up to a multiple of 4;
// the last slices may be short or empty) and copies its logits and noise
// ONCE into shared memory with cp.async (16 bytes where aligned, 4 at
// the ragged ends), the noise in a second group that lands while the
// threshold is found. The logits are scaled in place.
//
// The top-k threshold is the k-th largest value COUNTING DUPLICATES, as
// lax.top_k(x, k)[0][-1] and torch.sort(...).values[k-1] give it. It is
// found exactly by a radix select over the order-preserving u32 key of
// each f32 (sign flipped for positives, all bits for negatives; -0.0
// keyed as +0.0, since the two compare equal under x < thr and must not
// split a tie): 4 rounds of an 8-bit digit, from the top, whatever k is.
// In a round each CTA counts the digit of its elements whose higher
// digits match the prefix chosen so far (a shared-memory histogram of
// integer atomics); after a cluster barrier every CTA
// reads all kCluster histograms through distributed shared memory and
// adds them in rank order, scans the buckets from the top and picks the
// one that holds rank k, so every CTA chooses the same digit. The
// histograms are double-buffered: a buffer is cleared one barrier after
// the round that read it, so one barrier a round suffices. The 32-bit
// prefix is the k-th largest key; its value is the threshold. k = 0 and
// k >= V skip the select.
//
// The masked argmax then runs over the slice already in shared memory:
// x < thr becomes -1e30, y = x + noise, each thread keeps the first
// index of its maximum, the block reduces by (value, index), and rank 0
// merges the kCluster partials read through distributed shared memory.
// A slice too large for shared memory (V above 204,768 at kCluster 8)
// re-reads its part from device memory in each round and scales it
// again, through the same code, which gives the same bits. Every CTA,
// an empty slice's too, meets every cluster barrier, and the last
// barrier keeps each CTA's shared memory alive until rank 0 has read it.
//
// Bitwise agreement with the plain version rests on doing the same f32
// operations in the same order: x = logits * inv_t (inv_t = 1/T rounded
// to f32 once, which is what XLA computes for logits / T under jit),
// then x + noise, each rounded on its own. __fmul_rn and __fadd_rn keep
// nvcc from contracting the two into one fused multiply-add. The
// threshold is a value of x itself, so the mask compares like
// torch.where(x < kth, ...). The argmax takes the first index of the
// max, as jnp.argmax and torch.argmax do.
#include "flash_common.cuh"

namespace {

constexpr int kSampleThreads = 512;
constexpr int kSampleWarps = kSampleThreads / 32;
constexpr int kCluster = 8;            // CTAs a row
constexpr int kDigitBits = 8;
constexpr int kBuckets = 1 << kDigitBits;
constexpr int kRounds = 32 / kDigitBits;
// shared memory for a slice's logits and noise; a larger slice is read
// from device memory in each round
constexpr int kMaxSliceBytes = 200 * 1024;
constexpr float kNegInf = -1e30f;  // the JAX paths' mask value

static_assert(kSampleThreads % kBuckets == 0, "a bucket a thread of the "
              "first kBuckets");

struct Cand {
  float v;
  int i;
};

// a beats b: larger value, or the same value at a lower index
__device__ __forceinline__ bool beats(Cand a, Cand b) {
  return a.v > b.v || (a.v == b.v && a.i < b.i);
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Cand x;
    x.v = __shfl_xor_sync(0xffffffffu, c.v, o);
    x.i = __shfl_xor_sync(0xffffffffu, c.i, o);
    if (beats(x, c)) c = x;
  }
  return c;
}

// Block-wide best candidate; every thread gets the result.
__device__ Cand block_best(Cand c, float* sv, int* si) {
  c = warp_best(c);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = c.v;
    si[warp] = c.i;
  }
  __syncthreads();
  if (warp == 0) {
    Cand w;
    w.v = lane < kSampleWarps ? sv[lane] : -INFINITY;
    w.i = lane < kSampleWarps ? si[lane] : INT32_MAX;
    w = warp_best(w);
    if (lane == 0) {
      sv[0] = w.v;
      si[0] = w.i;
    }
  }
  __syncthreads();
  Cand r;
  r.v = sv[0];
  r.i = si[0];
  return r;
}

__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// The order-preserving key of x: key(a) < key(b) exactly when a < b,
// for every non-NaN pair; -0.0 has +0.0's key.
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Copies src[0, n) into shared memory from base + pad on, pad in 0..3
// chosen so that src's first 16-byte-aligned element lands on a 16-byte
// boundary: 16-byte cp.async for the aligned body, 4-byte ones for the
// head and the tail. Returns base + pad (element i is at [i]).
__device__ float* copy_slice(float* base, const float* src, int n) {
  const int head_want = (int)((16u - ((uint32_t)(uintptr_t)src & 15u)) & 15u)
                        >> 2;
  const int head = head_want < n ? head_want : n;
  float* dst = base + ((4 - head_want) & 3);
  const int end4 = head + ((n - head) & ~3);
  for (int i = threadIdx.x; i < head; i += kSampleThreads)
    cp_async4(smem_u32(dst + i), src + i, true);
  for (int i = head + 4 * threadIdx.x; i < end4; i += 4 * kSampleThreads)
    cp_async16(smem_u32(dst + i), src + i, true);
  for (int i = end4 + threadIdx.x; i < n; i += kSampleThreads)
    cp_async4(smem_u32(dst + i), src + i, true);
  return dst;
}

// A CTA's part of a row: elements [lo, lo + n). cached: the scaled logits
// and the noise are in shared memory (sx, sn); else each read goes to
// device memory (gl, gn) and scales again, which gives the same bits.
struct Slice {
  const float* gl;
  const float* gn;
  float* sx;
  const float* sn;
  int lo, n;
  bool cached;
  float inv_t;
  __device__ __forceinline__ float x(int i) const {
    return cached ? sx[i] : __fmul_rn(gl[i], inv_t);
  }
  __device__ __forceinline__ float noise(int i) const {
    return cached ? sn[i] : gn[i];
  }
};

__global__ void __launch_bounds__(kSampleThreads)
sample_cluster_kernel(const float* __restrict__ logits,  // (B, V)
                      const float* __restrict__ noise,   // (B, V)
                      int32_t* __restrict__ out,         // (B,)
                      int V, int L, float inv_t, int top_k, int cached) {
  extern __shared__ float4 slice_smem[];
  __shared__ uint32_t hist[2][kBuckets];
  __shared__ uint32_t warp_total[kBuckets / 32];
  __shared__ uint32_t chosen[kRounds][2];   // bucket, count above it
  __shared__ float sv[kSampleWarps];
  __shared__ int si[kSampleWarps];
  __shared__ float part_v;
  __shared__ int part_i;

  const int rank = (int)cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.y;
  Slice s;
  s.lo = rank * L < V ? rank * L : V;
  s.n = (V - s.lo < L ? V - s.lo : L);
  s.gl = logits + row * V + s.lo;
  s.gn = noise + row * V + s.lo;
  s.cached = cached != 0;
  s.inv_t = inv_t;
  s.sx = nullptr;
  s.sn = nullptr;
  if (s.cached) {
    float* base = reinterpret_cast<float*>(slice_smem);
    s.sx = copy_slice(base, s.gl, s.n);
    cp_commit();
    s.sn = copy_slice(base + L + 4, s.gn, s.n);
    cp_commit();
    cp_wait<1>();               // this thread's logits copies
  }
  if (tid < kBuckets) {
    hist[0][tid] = 0u;
    hist[1][tid] = 0u;
  }
  __syncthreads();              // every thread's logits copies

  const bool masked = top_k > 0 && top_k < V;
  // The scale (in place when cached), and the top digit's histogram.
  // Element i belongs to the same thread in every loop below. Counts are
  // integer shared-memory atomics, whose order changes no count.
#pragma unroll 4
  for (int i = tid; (s.cached || masked) && i < s.n; i += kSampleThreads) {
    const float x = __fmul_rn(s.cached ? s.sx[i] : s.gl[i], inv_t);
    if (s.cached) s.sx[i] = x;
    if (masked) atomicAdd(&hist[0][order_key(x) >> (32 - kDigitBits)], 1u);
  }

  float thr = -INFINITY;
  if (masked) {
    uint32_t prefix = 0u, want = (uint32_t)top_k;  // rank among the prefix's
    for (int r = 0; r < kRounds; ++r) {
      const int shift = 32 - kDigitBits * (r + 1);
      uint32_t* h = hist[r & 1];
      if (r > 0) {
        const uint32_t high = ~0u << (shift + kDigitBits);
#pragma unroll 4
        for (int i = tid; i < s.n; i += kSampleThreads) {
          const uint32_t k = order_key(s.x(i));
          if ((k & high) == prefix)
            atomicAdd(&h[(k >> shift) & (kBuckets - 1)], 1u);
        }
      }
      cluster_arrive();         // every CTA's histogram of this round
      cluster_wait();
      // thread tid < kBuckets owns bucket kBuckets - 1 - tid: an
      // inclusive scan over tid counts the elements from the top bucket
      // down to it
      const bool owner = tid < kBuckets;
      const int bucket = kBuckets - 1 - tid;
      uint32_t c = 0u;
      if (owner) {
        const uint32_t addr = smem_u32(&h[bucket]);
#pragma unroll
        for (int q = 0; q < kCluster; ++q)
          c += ld_cluster_u32(cluster_map(addr, q));
      }
      uint32_t incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      if (owner && lane == 31) warp_total[warp] = incl;
      __syncthreads();
      if (owner) {
        for (int w = 0; w < warp; ++w) incl += warp_total[w];
        const uint32_t above = incl - c;
        if (above < want && want <= incl) {
          chosen[r][0] = (uint32_t)bucket;
          chosen[r][1] = above;
        }
        // the other buffer was last read remotely in round r - 1, before
        // every CTA arrived at this round's barrier: clear it for r + 1
        hist[(r + 1) & 1][tid] = 0u;
      }
      __syncthreads();
      prefix |= chosen[r][0] << shift;
      want -= chosen[r][1];
    }
    thr = key_value(prefix);
  }

  if (s.cached) cp_wait<0>();   // this thread's noise copies
  __syncthreads();
  Cand best;
  best.v = -INFINITY;
  best.i = INT32_MAX;
  for (int i = tid; i < s.n; i += kSampleThreads) {
    float x = s.x(i);
    if (masked && x < thr) x = kNegInf;
    Cand c;
    c.v = __fadd_rn(x, s.noise(i));
    c.i = s.lo + i;
    if (beats(c, best)) best = c;
  }
  best = block_best(best, sv, si);
  if (tid == 0) {
    part_v = best.v;
    part_i = best.i;
  }
  cluster_arrive();             // every CTA's partial is written
  cluster_wait();
  if (rank == 0 && tid == 0) {
    Cand m;
    m.v = -INFINITY;
    m.i = INT32_MAX;
    for (int q = 0; q < kCluster; ++q) {
      Cand c;
      c.v = __uint_as_float(ld_cluster_u32(cluster_map(smem_u32(&part_v), q)));
      c.i = (int)ld_cluster_u32(cluster_map(smem_u32(&part_i), q));
      if (beats(c, m)) m = c;
    }
    out[row] = m.i;
  }
  cluster_arrive();             // rank 0's reads are done before any CTA's
  cluster_wait();               // shared memory goes away
}

}  // namespace

extern "C" {

int fused_sample_f32(const float* logits, const float* noise, int32_t* out,
                     int B, int V, float inv_t, int top_k, void* stream) {
  if (B < 1 || B > 65535 || V < 1 || top_k < 0)
    return (int)cudaErrorInvalidValue;
  const int L = (int)(((V + (long long)kCluster - 1) / kCluster + 3) & ~3LL);
  const size_t bytes = 2 * ((size_t)L + 4) * sizeof(float);
  const bool cached = bytes <= (size_t)kMaxSliceBytes;
  const size_t smem = cached ? bytes : 0;
  cudaError_t e = allow_smem(sample_cluster_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B);
  cfg.blockDim = dim3(kSampleThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, sample_cluster_kernel, logits, noise, out, V,
                         L, inv_t, top_k, (int)cached);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
