// Fused optimizer updates for Hopper (sm_90a): every parameter of the
// model in one launch. Five rules share one multi-tensor walker:
//
// - Adam(W): replaces the Adam body of the TPU kernel in
//   paddle_tpu/ops/pallas/fused_optimizer.py (_run_grid with
//   _adam_kernel(dygraph=True), reached from fused_try_rule), followed
//   by AdamW's decoupled decay (paddle_tpu/optimizer/optimizer.py:
//   133-134), which the JAX package runs as a separate XLA op.
// - Momentum: replaces _run_grid with _momentum_kernel, the dygraph
//   Momentum update reached from fused_try_rule.
// - SGD: replaces _run_grid with _sgd_kernel (p - lr*g).
// - Lamb, two rules: phase 1 replaces _run_grid with
//   _lamb_phase1_kernel(dygraph=True) (m, v and the trust-ratio
//   numerator r in one read of p, g, m, v); apply is the elementwise
//   p - (lr*trust)*r that the JAX package runs in XLA after its
//   per-tensor norms (fused_optimizer.py:608-613). The norms themselves
//   are torch._foreach_norm between the two launches; the apply rule
//   reads them from a device array, so nothing waits for the host.
//
// Bound: device-memory bytes. Adam reads p, g, m, v (16 bytes an
// element) and writes p, m, v (12 bytes) for about 15 flops; BERT-base's
// 110 M f32 parameters move about 3.1 GB a step. Momentum reads p, g, v
// and writes p, v (20 bytes) for 3 flops (5 with Nesterov); ResNet-50's
// 25.6 M parameters move 511 MB a step. SGD reads p, g and writes p
// (12 bytes, 2 flops). Lamb's phase 1 reads p, g, m, v and writes m, v,
// r (28 bytes); apply reads p, r and writes p (12 bytes).
//
// Design: multi-tensor. A device table holds the pointers of every
// parameter's tensors ((roles, n) int64: p, g, then the rule's state)
// and the element offsets of their concatenation ((n + 1,) int64).
// Block b takes elements [b*kChunk, (b+1)*kChunk) of that
// concatenation, finds the first parameter it touches by binary search
// over the offsets, and walks the parameters its chunk spans. Each
// thread handles consecutive elements strided by the block size, so
// warps read coalesced runs of every tensor. One pass, no second read
// of the old state; the FoundInfinite skip flag is an entry-point
// argument, as in the TPU kernel (a skipped step launches nothing).
//
// Bit-for-bit agreement with the plain PyTorch versions rests on doing
// the same f32 operations in the same order, each rounded on its own:
// the __f*_rn intrinsics keep nvcc from contracting a multiply and an
// add into one FMA, and __fsqrt_rn/__fdiv_rn are the IEEE operations
// PyTorch's sqrt and division use.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 8192;

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

// Walks this block's chunk of the concatenation; for each parameter t it
// touches, binds the rule's pointers once (Rule::bind) and applies the
// rule to each of its elements in the chunk.
template <class Rule>
__global__ void __launch_bounds__(kThreads)
multi_tensor_kernel(const int64_t* __restrict__ ptrs,
                    const int64_t* __restrict__ offs, int n, int64_t total,
                    Rule rule) {
  int64_t start = (int64_t)blockIdx.x * kChunk;
  const int64_t end = start + kChunk < total ? start + kChunk : total;
  int t = find_tensor(offs, n, start);
  while (start < end) {
    while (t < n - 1 && offs[t + 1] <= start) ++t;
    const int64_t t0 = offs[t];
    const int64_t seg_end = offs[t + 1] < end ? offs[t + 1] : end;
    const typename Rule::Ptrs q = rule.bind(ptrs, n, t);
    for (int64_t e = start + threadIdx.x; e < seg_end; e += kThreads)
      rule(q, e - t0);
    start = seg_end;
  }
}

struct AdamRule {
  float lr, b1, omb1, b2, omb2, eps, c1, c2, lrwd;
  struct Ptrs {
    float* p;
    const float* g;
    float* m;
    float* v;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<float*>(ptrs[t]),
            reinterpret_cast<const float*>(ptrs[n + t]),
            reinterpret_cast<float*>(ptrs[2 * n + t]),
            reinterpret_cast<float*>(ptrs[3 * n + t])};
  }
  __device__ __forceinline__ void operator()(const Ptrs& q,
                                             int64_t i) const {
    const float pi = q.p[i], gi = q.g[i];
    const float m2 = __fadd_rn(__fmul_rn(q.m[i], b1), __fmul_rn(gi, omb1));
    const float v2 = __fadd_rn(__fmul_rn(q.v[i], b2),
                               __fmul_rn(__fmul_rn(gi, omb2), gi));
    const float mh = __fdiv_rn(m2, c1);
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, c2)), eps);
    float p2 = __fsub_rn(pi, __fdiv_rn(__fmul_rn(mh, lr), den));
    if (lrwd != 0.0f) p2 = __fsub_rn(p2, __fmul_rn(lrwd, pi));
    q.p[i] = p2;
    q.m[i] = m2;
    q.v[i] = v2;
  }
};

// _momentum_kernel: v2 = mu*v + g; p2 = p - lr*v2, or with Nesterov
// p2 = p - (g + mu*v2)*lr.
struct MomentumRule {
  float lr, mu;
  int nesterov;
  struct Ptrs {
    float* p;
    const float* g;
    float* v;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<float*>(ptrs[t]),
            reinterpret_cast<const float*>(ptrs[n + t]),
            reinterpret_cast<float*>(ptrs[2 * n + t])};
  }
  __device__ __forceinline__ void operator()(const Ptrs& q,
                                             int64_t i) const {
    const float gi = q.g[i];
    const float v2 = __fadd_rn(__fmul_rn(mu, q.v[i]), gi);
    const float step = nesterov
        ? __fmul_rn(__fadd_rn(gi, __fmul_rn(mu, v2)), lr)
        : __fmul_rn(lr, v2);
    q.p[i] = __fsub_rn(q.p[i], step);
    q.v[i] = v2;
  }
};

// _sgd_kernel: p2 = p - lr*g.
struct SgdRule {
  float lr;
  struct Ptrs {
    float* p;
    const float* g;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<float*>(ptrs[t]),
            reinterpret_cast<const float*>(ptrs[n + t])};
  }
  __device__ __forceinline__ void operator()(const Ptrs& q,
                                             int64_t i) const {
    q.p[i] = __fsub_rn(q.p[i], __fmul_rn(lr, q.g[i]));
  }
};

// _lamb_phase1_kernel (dygraph form): m2 = b1*m + (1-b1)*g,
// v2 = b2*v + ((1-b2)*g)*g, r = (m2/c1) / (sqrt(v2/c2) + eps) + wd*p.
// Roles p, g, m, v, r; m, v and r are written, p is only read.
struct LambPhase1Rule {
  float b1, omb1, b2, omb2, eps, wd, c1, c2;
  struct Ptrs {
    const float* p;
    const float* g;
    float* m;
    float* v;
    float* r;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<const float*>(ptrs[t]),
            reinterpret_cast<const float*>(ptrs[n + t]),
            reinterpret_cast<float*>(ptrs[2 * n + t]),
            reinterpret_cast<float*>(ptrs[3 * n + t]),
            reinterpret_cast<float*>(ptrs[4 * n + t])};
  }
  __device__ __forceinline__ void operator()(const Ptrs& q,
                                             int64_t i) const {
    const float gi = q.g[i];
    const float m2 = __fadd_rn(__fmul_rn(q.m[i], b1), __fmul_rn(gi, omb1));
    const float v2 = __fadd_rn(__fmul_rn(q.v[i], b2),
                               __fmul_rn(__fmul_rn(gi, omb2), gi));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, c2)), eps);
    q.r[i] = __fadd_rn(__fdiv_rn(__fdiv_rn(m2, c1), den),
                       __fmul_rn(q.p[i], wd));
    q.m[i] = m2;
    q.v[i] = v2;
  }
};

// Lamb's update: trust = |p| / |r| where both are > 0, else 1 (a zero
// parameter, such as a bias at initialisation, or a zero r never
// divides); p2 = p - (lr*trust)*r. norms[t] is |p_t|, norms[n + t] is
// |r_t|; the per-tensor factor lr*trust is formed once when the walker
// binds tensor t. Roles p, r.
struct LambApplyRule {
  const float* norms;
  float lr;
  struct Ptrs {
    float* p;
    const float* r;
    float s;
  };
  __device__ Ptrs bind(const int64_t* ptrs, int n, int t) const {
    const float w = norms[t], q = norms[n + t];
    const float trust = (w > 0.0f && q > 0.0f) ? __fdiv_rn(w, q) : 1.0f;
    return {reinterpret_cast<float*>(ptrs[t]),
            reinterpret_cast<const float*>(ptrs[n + t]),
            __fmul_rn(trust, lr)};
  }
  __device__ __forceinline__ void operator()(const Ptrs& q,
                                             int64_t i) const {
    q.p[i] = __fsub_rn(q.p[i], __fmul_rn(q.s, q.r[i]));
  }
};

template <class Rule>
int launch(const int64_t* ptrs, const int64_t* offs, int n,
           long long total, int skip, void* stream, const Rule& rule) {
  if (n < 1 || total < 0) return (int)cudaErrorInvalidValue;
  if (skip || total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + kChunk - 1) / kChunk;
  multi_tensor_kernel<Rule><<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      ptrs, offs, n, (int64_t)total, rule);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_adam_f32(const int64_t* ptrs, const int64_t* offs, int n,
                   long long total, float lr, float b1, float omb1,
                   float b2, float omb2, float eps, float c1, float c2,
                   float lrwd, int skip, void* stream) {
  return launch(ptrs, offs, n, total, skip, stream,
                AdamRule{lr, b1, omb1, b2, omb2, eps, c1, c2, lrwd});
}

int fused_momentum_f32(const int64_t* ptrs, const int64_t* offs, int n,
                       long long total, float lr, float mu, int nesterov,
                       int skip, void* stream) {
  return launch(ptrs, offs, n, total, skip, stream,
                MomentumRule{lr, mu, nesterov});
}

int fused_sgd_f32(const int64_t* ptrs, const int64_t* offs, int n,
                  long long total, float lr, int skip, void* stream) {
  return launch(ptrs, offs, n, total, skip, stream, SgdRule{lr});
}

int fused_lamb_phase1_f32(const int64_t* ptrs, const int64_t* offs, int n,
                          long long total, float b1, float omb1, float b2,
                          float omb2, float eps, float wd, float c1, float c2,
                          void* stream) {
  return launch(ptrs, offs, n, total, 0, stream,
                LambPhase1Rule{b1, omb1, b2, omb2, eps, wd, c1, c2});
}

int fused_lamb_apply_f32(const int64_t* ptrs, const int64_t* offs, int n,
                         long long total, const float* norms, float lr,
                         void* stream) {
  return launch(ptrs, offs, n, total, 0, stream, LambApplyRule{norms, lr});
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
