// Fused token sampling for Hopper (sm_90a): temperature scale, top-k
// threshold, Gumbel noise, first-max argmax, one logits row per block.
//
// Replaces the TPU kernel in paddle_tpu/ops/pallas/sampling.py:
// _fused_sample_pallas (_sample_kernel), and follows the function the
// JAX package computes at the engine's width, _xla_sample under jit.
//
// Bound: device-memory bytes. The logits and noise rows are read once
// each (k extra passes over the logits for the top-k threshold hit L2,
// 128 KB a row at V = 32000) and one int32 is written per row.
//
// Design: one block of 1024 threads per row; each thread walks its
// strided elements and the block reduces (value, index) pairs with warp
// shuffles and one shared-memory stage. The top-k threshold is the k-th
// largest value COUNTING DUPLICATES, as lax.top_k(x, k)[0][-1] gives it:
// round r finds the largest element that comes strictly after the one
// round r-1 found in the order (value descending, index ascending), so
// each round removes exactly one element and nothing is written back.
// (The Pallas kernel removed every element equal to the max per round,
// which differs from lax.top_k on ties.) Any k is taken; k >= V or 0
// means no threshold. The argmax takes the first index of the max, as
// jnp.argmax does.
//
// Bitwise agreement with the plain version rests on doing the same f32
// operations in the same order: x = logits * inv_t (inv_t = 1/T rounded
// to f32 once, which is what XLA computes for logits / T under jit),
// then x + noise, each rounded on its own. __fmul_rn and __fadd_rn keep
// nvcc from contracting the two into one fused multiply-add.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the JAX paths' mask value

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
    w.v = sv[lane];
    w.i = si[lane];
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
  __syncthreads();  // sv/si are free for the next reduction
  return r;
}

__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ logits,  // (B, V)
              const float* __restrict__ noise,   // (B, V)
              int32_t* __restrict__ out,         // (B,)
              int V, float inv_t, int top_k) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const size_t off = (size_t)blockIdx.x * V;
  const float* row = logits + off;
  const float* nrow = noise + off;
  const int tid = threadIdx.x;

  const bool masked = top_k > 0 && top_k < V;
  float thr = -INFINITY;
  if (masked) {
    Cand prev;
    prev.v = INFINITY;
    prev.i = -1;
    for (int r = 0; r < top_k; ++r) {
      Cand best;
      best.v = -INFINITY;
      best.i = INT32_MAX;
      for (int i = tid; i < V; i += kThreads) {
        Cand c;
        c.v = __fmul_rn(row[i], inv_t);
        c.i = i;
        const bool after = c.v < prev.v || (c.v == prev.v && i > prev.i);
        if (after && beats(c, best)) best = c;
      }
      prev = block_best(best, sv, si);
    }
    thr = prev.v;
  }

  Cand best;
  best.v = -INFINITY;
  best.i = INT32_MAX;
  for (int i = tid; i < V; i += kThreads) {
    float x = __fmul_rn(row[i], inv_t);
    if (masked && x < thr) x = kNegInf;
    Cand c;
    c.v = __fadd_rn(x, nrow[i]);
    c.i = i;
    if (beats(c, best)) best = c;
  }
  best = block_best(best, sv, si);
  if (tid == 0) out[blockIdx.x] = best.i;
}

}  // namespace

extern "C" {

int fused_sample_f32(const float* logits, const float* noise, int32_t* out,
                     int B, int V, float inv_t, int top_k, void* stream) {
  if (B < 1 || V < 1 || top_k < 0) return (int)cudaErrorInvalidValue;
  sample_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(logits, noise, out,
                                                          V, inv_t, top_k);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
