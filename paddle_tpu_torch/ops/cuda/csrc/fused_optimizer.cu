// Fused Adam(W) update for Hopper (sm_90a): every parameter of the
// model in one launch.
//
// Replaces the Adam body of the TPU kernel in
// paddle_tpu/ops/pallas/fused_optimizer.py: _run_grid with
// _adam_kernel(dygraph=True), reached from fused_try_rule, followed by
// AdamW's decoupled decay (paddle_tpu/optimizer/optimizer.py:133-134),
// which the JAX package runs as a separate XLA op.
//
// Bound: device-memory bytes. Each element reads p, g, m, v (16 bytes)
// and writes p, m, v (12 bytes) for about 15 flops; BERT-base's 110 M
// f32 parameters move about 3.1 GB a step.
//
// Design: multi-tensor. A device table holds the p/g/m/v pointers of
// every parameter ((4, n) int64) and the element offsets of their
// concatenation ((n + 1,) int64). Block b takes elements
// [b*kChunk, (b+1)*kChunk) of that concatenation, finds the first
// parameter it touches by binary search over the offsets, and walks
// the parameters its chunk spans. Each thread handles consecutive
// elements strided by the block size, so warps read coalesced runs of
// every tensor. One pass, no second read of the old state; the
// FoundInfinite skip flag is a kernel argument, as in the TPU kernel.
//
// Bit-for-bit agreement with the plain PyTorch version rests on doing
// the same f32 operations in the same order, each rounded on its own:
// the __f*_rn intrinsics keep nvcc from contracting a multiply and an
// add into one FMA, and __fsqrt_rn/__fdiv_rn are the IEEE operations
// PyTorch's sqrt and division use.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 8192;

struct AdamArgs {
  float lr, b1, omb1, b2, omb2, eps, c1, c2, lrwd;
};

__device__ __forceinline__ int find_tensor(const int64_t* offs, int n,
                                           int64_t e) {
  // largest t with offs[t] <= e (offs[0] == 0, offs[n] == total)
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offs[mid] <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const int64_t* __restrict__ ptrs,  // (4, n): p, g, m, v
            const int64_t* __restrict__ offs,  // (n + 1,)
            int n, int64_t total, AdamArgs a) {
  int64_t start = (int64_t)blockIdx.x * kChunk;
  const int64_t end = start + kChunk < total ? start + kChunk : total;
  int t = find_tensor(offs, n, start);
  while (start < end) {
    while (t < n - 1 && offs[t + 1] <= start) ++t;
    const int64_t t0 = offs[t];
    const int64_t seg_end = offs[t + 1] < end ? offs[t + 1] : end;
    float* p = reinterpret_cast<float*>(ptrs[t]);
    const float* g = reinterpret_cast<const float*>(ptrs[n + t]);
    float* m = reinterpret_cast<float*>(ptrs[2 * n + t]);
    float* v = reinterpret_cast<float*>(ptrs[3 * n + t]);
    for (int64_t e = start + threadIdx.x; e < seg_end; e += kThreads) {
      const int64_t i = e - t0;
      const float pi = p[i], gi = g[i];
      const float m2 = __fadd_rn(__fmul_rn(m[i], a.b1), __fmul_rn(gi, a.omb1));
      const float v2 = __fadd_rn(__fmul_rn(v[i], a.b2),
                                 __fmul_rn(__fmul_rn(gi, a.omb2), gi));
      const float mh = __fdiv_rn(m2, a.c1);
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, a.c2)), a.eps);
      float p2 = __fsub_rn(pi, __fdiv_rn(__fmul_rn(mh, a.lr), den));
      if (a.lrwd != 0.0f) p2 = __fsub_rn(p2, __fmul_rn(a.lrwd, pi));
      p[i] = p2;
      m[i] = m2;
      v[i] = v2;
    }
    start = seg_end;
  }
}

}  // namespace

extern "C" {

int fused_adam_f32(const int64_t* ptrs, const int64_t* offs, int n,
                   long long total, float lr, float b1, float omb1,
                   float b2, float omb2, float eps, float c1, float c2,
                   float lrwd, int skip, void* stream) {
  if (n < 1 || total < 0) return (int)cudaErrorInvalidValue;
  if (skip || total == 0) return (int)cudaSuccess;
  AdamArgs a{lr, b1, omb1, b2, omb2, eps, c1, c2, lrwd};
  const int64_t blocks = (total + kChunk - 1) / kChunk;
  adam_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ptrs, offs, n, (int64_t)total, a);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
