// Fused optimizer updates for Hopper (sm_90a). The dygraph forms update
// every parameter of the model in one launch; the static forms every
// parameter of a run of a static program's update ops (consecutive ops
// of one type and attrs, which the executor hands over together) in one
// launch, or one launch per split when the run outgrows the table. All
// rules share one multi-tensor walker:
//
// - Adam(W): replaces the Adam body of the TPU kernel in
//   paddle_tpu/ops/pallas/fused_optimizer.py (_run_grid with
//   _adam_kernel(dygraph=True), reached from fused_try_rule), followed
//   by AdamW's decoupled decay (paddle_tpu/optimizer/optimizer.py:
//   133-134), which the JAX package runs as a separate XLA op.
// - Momentum: replaces _run_grid with _momentum_kernel, the dygraph
//   Momentum update reached from fused_try_rule.
// - SGD: replaces _run_grid with _sgd_kernel (p - lr*g), with the
//   coupled L2 term the JAX optimizer adds to the gradient before it
//   (L2Decay.grad_term, optimizer.py:102-104) folded in: p - lr*(g + wd*p).
//   Its table travels by value, as the static forms' do (below).
// - Lamb, two rules: phase 1 replaces _run_grid with
//   _lamb_phase1_kernel(dygraph=True) (m, v and the trust-ratio
//   numerator r in one read of p, g, m, v) AND the per-tensor norms the
//   JAX package takes in XLA after it: phase 1 runs one block a piece of
//   a parameter and adds the piece's p*p and r*r as it goes (see the
//   block above lamb_phase1_pieces_kernel). Apply is the elementwise
//   p - (lr*trust)*r (fused_optimizer.py:608-613); it reads the sums
//   from a device array, so nothing waits for the host.
// - The static forms of all four (StaticSgdRule, StaticMomentumRule,
//   StaticAdamRule, StaticLambPhase1Rule + StaticLambApplyRule): the
//   same _run_grid bodies with dygraph=False, reached from
//   fused_op_update (fused_optimizer.py:418) by the update ops of a
//   static program, one launch a run of ops (the TPU kernel runs one
//   grid an op). lr, the beta-pows and FoundInfinite are device
//   scalars read by the kernel;
//   static Adam uses lr_t = lr*sqrt(1-c2)/(1-c1) with eps outside the
//   sqrt, static Lamb divides by 1-c1 where the dygraph form divides by
//   c1. See the block above the static rules.
// - The master-weight forms of Adam(W), Momentum, SGD and Lamb
//   (multi_precision, amp.decorate(level="O2")): the JAX package runs
//   g.astype(f32) -> the fused rule on the f32 master ->
//   master.astype(p.dtype) (paddle_tpu/optimizer/optimizer.py:115-128,
//   fused_try_rule over the master). Here that is the same rule in one
//   launch: it reads the 2-byte (bf16 or f16) gradient and the f32 master
//   and state, writes the master and state and the round-to-nearest-even
//   cast of the new master into the 2-byte parameter. Each rule is
//   templated on the parameter type T (float: the f32 form). See the
//   block above AdamRule.
// - The 2-byte forms without masters of Adam(W), Momentum, SGD and Lamb
//   (multi_precision=False, amp.decorate(master_weight=False)): no TPU
//   kernel, since the JAX package sends every non-f32 update to XLA
//   (fused_optimizer.py:305-306), which runs the rule in the parameter's
//   type; here that rule is a kernel over every parameter, state in T,
//   each operation rounded to T. See the block above Adam2Rule.
// - K3's ZeRO chunk entry (fused_chunk_update, fused_optimizer.py:455):
//   static Lamb's phase 1 over one flat chunk of a ZeRO bucket with the
//   per-segment sums of p*p and r*r its trust ratios need, then the
//   update once those sums are summed across ranks. See the block above
//   chunk_lamb_phase1_kernel.
//
// Bound: device-memory bytes. Adam reads p, g, m, v (16 bytes an
// element) and writes p, m, v (12 bytes) for about 15 flops; BERT-base's
// 110 M f32 parameters move about 3.1 GB a step. Momentum reads p, g, v
// and writes p, v (20 bytes) for 3 flops (5 with Nesterov); ResNet-50's
// 25.6 M parameters move 511 MB a step. SGD reads p, g and writes p
// (12 bytes, 2 flops, 4 with the decay). Lamb's phase 1 reads p, g, m,
// v and writes m, v, r (28 bytes, the norms' sums included); apply
// reads p, r and writes p (12 bytes): 40 bytes an element, 4.41 GB for
// BERT-base. The static
// forms move the same bytes an element, but the static example's 25
// tensors hold 77,850 elements and LeNet's 10 hold 61,610 (0.3-2 MB a
// step in all): a launch is bound by its latency, not by the bytes, so
// the static forms launch once for a run of ops instead of once an op,
// and they and dygraph SGD size their grid to the card (static_chunk)
// instead of 8192 elements a block.
//
// Design: multi-tensor. A table holds the pointers of every parameter's
// tensors ((roles, n) int64: p, g, then the rule's state) and the element
// offsets of their concatenation ((n + 1,) int64), in device memory
// (dygraph Adam, Momentum, Lamb) or in the kernel's parameters (SGD and
// the static forms). Block b takes elements [b*chunk, (b+1)*chunk) of
// that concatenation (chunk = 8192 in the device-table forms,
// static_chunk in the others),
// finds the first parameter it touches by binary search over the
// offsets, and walks the parameters its chunk spans. Each thread takes
// 4 consecutive elements (one float4 of each array) strided by 4x the
// block size where the tensor's pointers are 16-byte aligned, else one,
// so warps read coalesced runs of every tensor. One pass, no second read
// of the old state; in the dygraph forms the FoundInfinite skip flag is
// the wrapper's (a skipped step launches nothing), in the static forms a
// device flag the kernel reads.
//
// Bit-for-bit agreement with the plain PyTorch versions rests on doing
// the same f32 operations in the same order, each rounded on its own:
// the __f*_rn intrinsics keep nvcc from contracting a multiply and an
// add into one FMA, and __fsqrt_rn/__fdiv_rn are the IEEE operations
// PyTorch's sqrt and division use.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// elements a block takes in the dygraph forms, whose lists are large
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// x rounded to T, to nearest even (float: x itself)
template <class T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(x);
  else if constexpr (std::is_same<T, __half>::value)
    return __float2half_rn(x);
  else
    return x;
}

// N consecutive values at p[i] as f32: one 16-byte (f32) or 8-byte
// (bf16, f16) access when N == 4 (the caller has checked that the
// array's base is 16-byte aligned and i is a multiple of 4), else
// scalars
template <int N, class T>
__device__ __forceinline__ void ld(const T* p, int64_t i, float (&x)[N]) {
  if constexpr (N == 4 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + i);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = to_f32(p[i + j]);
  }
}

// the f32 values x rounded to T into p[i] .. p[i + N - 1]
template <int N, class T>
__device__ __forceinline__ void st(T* p, int64_t i, const float (&x)[N]) {
  if constexpr (N == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 4) {
    uint2 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = from_f32<T>(x[j]);
    *reinterpret_cast<uint2*>(p + i) = v;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[i + j] = from_f32<T>(x[j]);
  }
}

// Whether tensor t's Rule::kArrays array pointers are all 16-byte aligned
template <class Rule>
__device__ __forceinline__ bool aligned(const int64_t* ptrs, int n, int t) {
  bool vec = true;
#pragma unroll
  for (int r = 0; r < Rule::kArrays; ++r)
    vec = vec && (ptrs[r * n + t] & 15) == 0;
  return vec;
}

// Applies the rule to local elements [a, b) of one tensor, bound as q.
// With vec, the elements at local indices that are multiples of 4 go
// four at a time (one float4 load of each array a thread, so each thread
// has 4 elements of every array in flight), with scalar heads and tails;
// else one at a time. acc: per-thread sums a rule may add to.
template <class Rule, class... Acc>
__device__ __forceinline__ void walk_range(const Rule& rule,
                                           const typename Rule::Ptrs& q,
                                           bool vec, int64_t a, int64_t b,
                                           Acc&... acc) {
  int64_t a4 = b, b4 = b;
  if (vec) {
    a4 = (a + 3) & ~(int64_t)3;
    if (a4 > b) a4 = b;
    b4 = b & ~(int64_t)3;
    if (b4 < a4) b4 = a4;
  }
  for (int64_t i = a + threadIdx.x; i < a4; i += kThreads)
    rule.template apply<1>(q, i, acc...);
  for (int64_t i = a4 + 4 * (int64_t)threadIdx.x; i < b4; i += 4 * kThreads)
    rule.template apply<4>(q, i, acc...);
  for (int64_t i = b4 + threadIdx.x; i < b; i += kThreads)
    rule.template apply<1>(q, i, acc...);
}

// Walks this block's chunk (``chunk`` elements) of the concatenation; for
// each tensor t it touches, binds the rule's pointers once (Rule::bind)
// and applies the rule to its elements in the chunk (walk_range).
template <class Rule>
__device__ __forceinline__ void walk(const int64_t* __restrict__ ptrs,
                                     const int64_t* __restrict__ offs,
                                     int n, int64_t total, int64_t chunk,
                                     const Rule& rule) {
  int64_t start = (int64_t)blockIdx.x * chunk;
  const int64_t end = start + chunk < total ? start + chunk : total;
  int t = find_tensor(offs, n, start);
  while (start < end) {
    while (t < n - 1 && offs[t + 1] <= start) ++t;
    const int64_t t0 = offs[t];
    const int64_t seg_end = offs[t + 1] < end ? offs[t + 1] : end;
    walk_range(rule, rule.bind(ptrs, n, t), aligned<Rule>(ptrs, n, t),
               start - t0, seg_end - t0);
    start = seg_end;
  }
}

// Dygraph Adam, Momentum and Lamb's apply: the table lives in device
// memory (built once and cached by the optimizer while the pointers stay
// the same).
template <class Rule>
__global__ void __launch_bounds__(kThreads)
multi_tensor_kernel(const int64_t* __restrict__ ptrs,
                    const int64_t* __restrict__ offs, int n, int64_t total,
                    Rule rule) {
  walk(ptrs, offs, n, total, kChunk, rule);
}

// The static forms and dygraph SGD: one launch per RUN of update ops of
// one type (the executor groups a program's consecutive updates), or per
// SGD step, whose gradient (and beta-pow) buffers may change every step,
// so the table travels by value in the kernel's parameter space (no
// host-to-device copy, no cache to miss) with the same (roles, n) layout.
// The parameter space is 4 KB, or 32,764 bytes from CUDA 12.1 on (nvcc's
// version decides at build time); the table takes what the launch's
// other parameters leave, so a launch holds ArgTable<R>::kCap tensors
// (45 of Adam's ten roles in 4 KB, 370 in 32 KB; 1,359 of SGD's two in
// 32 KB) and the wrapper splits a longer list into consecutive launches.
// A list that fits takes the SHORT table, sized to 4 KB of parameters
// (165 of SGD's two roles, 45 of Adam's ten): the card copies the whole
// parameter block at every launch, and a kernel whose parameters fill
// 32 KB took ~2.3 us longer to launch than one with 4 KB (LeNet's SGD
// on an H100: 0.0104 against 0.0078 ms, chip_smoke.py --sgd-variants).
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 ||     \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
constexpr int kParamBytes = 32764;
#else
constexpr int kParamBytes = 4096;
#endif
constexpr int kShortParamBytes = 4096;

// Bytes of parameters -> 8-byte words left for the table beside n,
// total, chunk and the rule
template <int R, int Bytes = kParamBytes>
struct ArgTable {
  static constexpr int kCap = ((Bytes - 128) / 8 - 1) / (R + 1);
  int64_t ptrs[R * kCap];
  int64_t offs[kCap + 1];
};

template <class Rule, class Tab>
__global__ void __launch_bounds__(kThreads)
multi_tensor_arg_kernel(const __grid_constant__ Tab tab, int n,
                        int64_t total, int64_t chunk, Rule rule) {
  walk(tab.ptrs, tab.offs, n, total, chunk, rule);
}

// The dygraph rules are templated on the parameter type T. T = float is
// the f32 form: the rule updates p in place from g (roles p, g, then the
// state). T = __nv_bfloat16 or __half is the master-weight form: roles p
// (T, written only), g (T), the f32 master, then the f32 state; the rule
// runs on the master w with g upcast (exactly) to f32, writes the master
// and state, and stores from_f32<T>(new master) into p, the
// round-to-nearest-even cast of master.astype(p.dtype). w is the f32
// weight the arithmetic sees: p itself, or the master.
template <class T>
constexpr bool kMaster = !std::is_same<T, float>::value;

template <class T>
struct AdamRule {
  static constexpr int kArrays = kMaster<T> ? 5 : 4;
  float lr, b1, omb1, b2, omb2, eps, c1, c2, lrwd;
  struct Ptrs {
    float* w;
    const T* g;
    float* m;
    float* v;
    T* p;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    const int s = kMaster<T> ? 1 : 0;   // the master's extra role
    return {reinterpret_cast<float*>(ptrs[(2 * s) * n + t]),
            reinterpret_cast<const T*>(ptrs[n + t]),
            reinterpret_cast<float*>(ptrs[(2 + s) * n + t]),
            reinterpret_cast<float*>(ptrs[(3 + s) * n + t]),
            reinterpret_cast<T*>(ptrs[t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    float p[N], g[N], m[N], v[N];
    ld(q.w, i, p);
    ld(q.g, i, g);
    ld(q.m, i, m);
    ld(q.v, i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float pi = p[j], gi = g[j];
      m[j] = __fadd_rn(__fmul_rn(m[j], b1), __fmul_rn(gi, omb1));
      v[j] = __fadd_rn(__fmul_rn(v[j], b2),
                       __fmul_rn(__fmul_rn(gi, omb2), gi));
      const float mh = __fdiv_rn(m[j], c1);
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v[j], c2)), eps);
      float p2 = __fsub_rn(pi, __fdiv_rn(__fmul_rn(mh, lr), den));
      if (lrwd != 0.0f) p2 = __fsub_rn(p2, __fmul_rn(lrwd, pi));
      p[j] = p2;
    }
    st(q.w, i, p);
    st(q.m, i, m);
    st(q.v, i, v);
    if constexpr (kMaster<T>) st(q.p, i, p);
  }
};

// _momentum_kernel: v2 = mu*v + g; p2 = p - lr*v2, or with Nesterov
// p2 = p - (g + mu*v2)*lr.
template <class T>
struct MomentumRule {
  static constexpr int kArrays = kMaster<T> ? 4 : 3;
  float lr, mu;
  int nesterov;
  struct Ptrs {
    float* w;
    const T* g;
    float* v;
    T* p;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    const int s = kMaster<T> ? 1 : 0;
    return {reinterpret_cast<float*>(ptrs[(2 * s) * n + t]),
            reinterpret_cast<const T*>(ptrs[n + t]),
            reinterpret_cast<float*>(ptrs[(2 + s) * n + t]),
            reinterpret_cast<T*>(ptrs[t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    float p[N], g[N], v[N];
    ld(q.w, i, p);
    ld(q.g, i, g);
    ld(q.v, i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[j] = __fadd_rn(__fmul_rn(mu, v[j]), g[j]);
      const float step = nesterov
          ? __fmul_rn(__fadd_rn(g[j], __fmul_rn(mu, v[j])), lr)
          : __fmul_rn(lr, v[j]);
      p[j] = __fsub_rn(p[j], step);
    }
    st(q.w, i, p);
    st(q.v, i, v);
    if constexpr (kMaster<T>) st(q.p, i, p);
  }
};

// _sgd_kernel fed the coupled L2 gradient: p2 = p - lr*(g + wd*p), each
// operation rounded on its own in that order (the optimizer's g + wd*p,
// then the update); wd = 0 leaves the decay out, p2 = p - lr*g, so its
// bits are the undecayed update's even where g + 0*p would not be g (an
// infinite p, where 0*p is NaN). Roles p, g; lr and wd by value. The
// master form (roles p, g, master) adds the decay term as the JAX
// optimizer does before it upcasts: in T, from the 2-byte parameter,
// g + wd*p with each of the two operations rounded to T (wd arrives
// already rounded to T), then master - lr*g in f32.
template <class T>
struct SgdRule {
  static constexpr int kRoles = kMaster<T> ? 3 : 2, kArrays = kRoles;
  float lr, wd;
  struct Ptrs {
    float* w;
    const T* g;
    T* p;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<float*>(ptrs[(kMaster<T> ? 2 : 0) * n + t]),
            reinterpret_cast<const T*>(ptrs[n + t]),
            reinterpret_cast<T*>(ptrs[t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    float p[N], g[N];
    ld(q.w, i, p);
    ld(q.g, i, g);
    if constexpr (kMaster<T>) {
      if (wd != 0.0f) {
        float pt[N];
        ld(q.p, i, pt);
#pragma unroll
        for (int j = 0; j < N; ++j)
          g[j] = to_f32(from_f32<T>(__fadd_rn(
              g[j], to_f32(from_f32<T>(__fmul_rn(wd, pt[j]))))));
      }
#pragma unroll
      for (int j = 0; j < N; ++j) p[j] = __fsub_rn(p[j], __fmul_rn(lr, g[j]));
      st(q.p, i, p);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float gj = wd != 0.0f ? __fadd_rn(g[j], __fmul_rn(wd, p[j]))
                                    : g[j];
        p[j] = __fsub_rn(p[j], __fmul_rn(lr, gj));
      }
    }
    st(q.w, i, p);
  }
};

// _lamb_phase1_kernel (dygraph form): m2 = b1*m + (1-b1)*g,
// v2 = b2*v + ((1-b2)*g)*g, r = (m2/c1) / (sqrt(v2/c2) + eps) + wd*p,
// and the thread's running sums sp += p*p, sr += r*r (element order).
// Roles p, g, m, v, r; m, v and r are written, p is only read. The
// master form (T 2-byte) has the same roles with the master in p's place
// and a T gradient: Lamb runs on the master, so its norms are the
// master's, as the JAX package runs it.
template <class T>
struct LambPhase1Rule {
  static constexpr int kArrays = 5;
  float b1, omb1, b2, omb2, eps, wd, c1, c2;
  struct Ptrs {
    const float* p;
    const T* g;
    float* m;
    float* v;
    float* r;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<const float*>(ptrs[t]),
            reinterpret_cast<const T*>(ptrs[n + t]),
            reinterpret_cast<float*>(ptrs[2 * n + t]),
            reinterpret_cast<float*>(ptrs[3 * n + t]),
            reinterpret_cast<float*>(ptrs[4 * n + t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i, float& sp,
                                        float& sr) const {
    float p[N], g[N], m[N], v[N], r[N];
    ld(q.p, i, p);
    ld(q.g, i, g);
    ld(q.m, i, m);
    ld(q.v, i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float gi = g[j];
      m[j] = __fadd_rn(__fmul_rn(m[j], b1), __fmul_rn(gi, omb1));
      v[j] = __fadd_rn(__fmul_rn(v[j], b2),
                       __fmul_rn(__fmul_rn(gi, omb2), gi));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v[j], c2)), eps);
      r[j] = __fadd_rn(__fdiv_rn(__fdiv_rn(m[j], c1), den),
                       __fmul_rn(p[j], wd));
      sp = __fadd_rn(sp, __fmul_rn(p[j], p[j]));
      sr = __fadd_rn(sr, __fmul_rn(r[j], r[j]));
    }
    st(q.r, i, r);
    st(q.m, i, m);
    st(q.v, i, v);
  }
};

// Lamb's update: w = sqrt(sums[2t]) = |p_t|, q = sqrt(sums[2t + 1]) =
// |r_t| (phase 1's (n, 2) sums of squares); trust = w / q where both are
// > 0, else 1 (a zero parameter, such as a bias at initialisation, or a
// zero r never divides); p2 = p - (lr*trust)*r. The per-tensor factor
// lr*trust is formed once when the walker binds tensor t. Roles p, r;
// the master form: p (T, written only), r, the master, which the rule
// updates and casts into p.
template <class T>
struct LambApplyRule {
  static constexpr int kArrays = kMaster<T> ? 3 : 2;
  const float* sums;
  float lr;
  struct Ptrs {
    float* w;
    const float* r;
    float s;
    T* p;
  };
  __device__ Ptrs bind(const int64_t* ptrs, int n, int t) const {
    const float w = __fsqrt_rn(sums[2 * t]), q = __fsqrt_rn(sums[2 * t + 1]);
    const float trust = (w > 0.0f && q > 0.0f) ? __fdiv_rn(w, q) : 1.0f;
    return {reinterpret_cast<float*>(ptrs[(kMaster<T> ? 2 : 0) * n + t]),
            reinterpret_cast<const float*>(ptrs[n + t]),
            __fmul_rn(trust, lr), reinterpret_cast<T*>(ptrs[t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    float p[N], r[N];
    ld(q.w, i, p);
    ld(q.r, i, r);
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = __fsub_rn(p[j], __fmul_rn(q.s, r[j]));
    st(q.w, i, p);
    if constexpr (kMaster<T>) st(q.p, i, p);
  }
};

// ---------------------------------------------------------------------------
// The 2-byte forms without masters (multi_precision=False,
// amp.decorate(level="O2", master_weight=False)): bf16 or f16 parameters
// whose state is of their own type. No TPU kernel covers them: the JAX
// package's gate sends every non-f32 update to XLA
// (paddle_tpu/ops/pallas/fused_optimizer.py:305-306), which runs the
// optimizer's rule in the parameter's type (paddle_tpu/optimizer/
// optimizer.py:131-134; Adam :318-327, Momentum :297-304, SGD :281, Lamb
// :476-487). These rules are kernels for that XLA route. Every operation
// of JAX's rule yields T, so each operation here is one IEEE f32
// operation on values of T (a product of two 2-byte values is exact in
// f32), rounded to T at once (rt<T>, round to nearest even); no
// intrinsic contracts two of them. The wrapper hands the scalars over
// already rounded to T, as JAX's weak types and casts make them: lr
// (jnp.asarray(lr, p.dtype)), b1, 1-b1, b2, 1-b2, eps and the decay
// coefficients, c1 = 1 - b1^t and c2 = 1 - b2^t (f32, then cast to T),
// and AdamW's lr*wd (the product of the two rounded values, rounded).
// XLA on the CPU rounds bf16 after every operation as well, so the
// plain versions and JAX agree bit for bit there; for f16 it keeps a
// fused multiply-add chain in f32 and rounds once (measured: 0.9*v + g),
// which this form does not copy: the rule's own semantics round each op.
//
// Adam(W):   m2 = rt(rt(b1*m) + rt(omb1*g))
//            v2 = rt(rt(b2*v) + rt(omb2*rt(g*g)))
//            den = rt(rt(sqrt(rt(v2/c2))) + eps)
//            p2 = rt(p - rt(rt(lr*rt(m2/c1)) / den))
//            AdamW: p3 = rt(p2 - rt(lrwd*p)), the OLD p
// Momentum:  v2 = rt(rt(mu*v) + g); p2 = rt(p - rt(lr*v2)), or with
//            Nesterov p2 = rt(p - rt(lr*rt(g + rt(mu*v2))))
// SGD:       p2 = rt(p - rt(lr*g)); with the coupled L2 term g is first
//            rt(g + rt(wd*p))
// Lamb:      phase 1: m2, v2 and den as Adam's;
//            r = rt(rt(rt(m2/c1) / den) + rt(wd*p)), and the sums of
//            rt(p*p) and rt(r*r) (JAX's jnp.sum(jnp.square(x)) over a T
//            array: the squares rounded to T, summed in f32 and the sum
//            rounded to T; here the squares are summed in f32 a thread,
//            by block_sum's tree a piece and in double across pieces,
//            and the apply rounds each sum to T);
//            apply: w = rt(sqrt(rt(sum_p))), q = rt(sqrt(rt(sum_r))),
//            trust = rt(w/q) where both > 0, else 1;
//            p2 = rt(p - rt(rt(lr*trust)*r))
// Roles (tables): p, g, then the state (m, v; v; none; m, v, r for
// Lamb's phase 1, p, r for its apply), every array in T.
// Bound: device bytes, 2 an element an array: Adam reads p, g, m, v and
// writes p, m, v (14 bytes, half the f32 form's 28), Momentum 10, SGD 6,
// Lamb 14 for the function (20 moved by the two launches, r written and
// read again).
// ---------------------------------------------------------------------------
template <class T>
__device__ __forceinline__ float rt(float x) {
  return to_f32(from_f32<T>(x));
}

template <class T>
struct Adam2Rule {
  static constexpr int kArrays = 4;
  float lr, b1, omb1, b2, omb2, eps, c1, c2, lrwd;
  struct Ptrs {
    T* p;
    const T* g;
    T* m;
    T* v;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<T*>(ptrs[t]),
            reinterpret_cast<const T*>(ptrs[n + t]),
            reinterpret_cast<T*>(ptrs[2 * n + t]),
            reinterpret_cast<T*>(ptrs[3 * n + t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    float p[N], g[N], m[N], v[N];
    ld(q.p, i, p);
    ld(q.g, i, g);
    ld(q.m, i, m);
    ld(q.v, i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float pi = p[j], gi = g[j];
      m[j] = rt<T>(__fadd_rn(rt<T>(__fmul_rn(b1, m[j])),
                             rt<T>(__fmul_rn(omb1, gi))));
      v[j] = rt<T>(__fadd_rn(rt<T>(__fmul_rn(b2, v[j])),
                             rt<T>(__fmul_rn(omb2, rt<T>(__fmul_rn(gi, gi))))));
      const float mh = rt<T>(__fdiv_rn(m[j], c1));
      const float den =
          rt<T>(__fadd_rn(rt<T>(__fsqrt_rn(rt<T>(__fdiv_rn(v[j], c2)))), eps));
      float p2 = rt<T>(__fsub_rn(
          pi, rt<T>(__fdiv_rn(rt<T>(__fmul_rn(lr, mh)), den))));
      if (lrwd != 0.0f) p2 = rt<T>(__fsub_rn(p2, rt<T>(__fmul_rn(lrwd, pi))));
      p[j] = p2;
    }
    st(q.p, i, p);
    st(q.m, i, m);
    st(q.v, i, v);
  }
};

template <class T>
struct Momentum2Rule {
  static constexpr int kArrays = 3;
  float lr, mu;
  int nesterov;
  struct Ptrs {
    T* p;
    const T* g;
    T* v;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<T*>(ptrs[t]),
            reinterpret_cast<const T*>(ptrs[n + t]),
            reinterpret_cast<T*>(ptrs[2 * n + t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    float p[N], g[N], v[N];
    ld(q.p, i, p);
    ld(q.g, i, g);
    ld(q.v, i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[j] = rt<T>(__fadd_rn(rt<T>(__fmul_rn(mu, v[j])), g[j]));
      const float d = nesterov
          ? rt<T>(__fadd_rn(g[j], rt<T>(__fmul_rn(mu, v[j]))))
          : v[j];
      p[j] = rt<T>(__fsub_rn(p[j], rt<T>(__fmul_rn(lr, d))));
    }
    st(q.p, i, p);
    st(q.v, i, v);
  }
};

template <class T>
struct Sgd2Rule {
  static constexpr int kRoles = 2, kArrays = 2;
  float lr, wd;
  struct Ptrs {
    T* p;
    const T* g;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<T*>(ptrs[t]),
            reinterpret_cast<const T*>(ptrs[n + t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    float p[N], g[N];
    ld(q.p, i, p);
    ld(q.g, i, g);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float gj =
          wd != 0.0f ? rt<T>(__fadd_rn(g[j], rt<T>(__fmul_rn(wd, p[j]))))
                     : g[j];
      p[j] = rt<T>(__fsub_rn(p[j], rt<T>(__fmul_rn(lr, gj))));
    }
    st(q.p, i, p);
  }
};

template <class T>
struct Lamb2Phase1Rule {
  static constexpr int kArrays = 5;
  float b1, omb1, b2, omb2, eps, wd, c1, c2;
  struct Ptrs {
    const T* p;
    const T* g;
    T* m;
    T* v;
    T* r;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<const T*>(ptrs[t]),
            reinterpret_cast<const T*>(ptrs[n + t]),
            reinterpret_cast<T*>(ptrs[2 * n + t]),
            reinterpret_cast<T*>(ptrs[3 * n + t]),
            reinterpret_cast<T*>(ptrs[4 * n + t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i, float& sp,
                                        float& sr) const {
    float p[N], g[N], m[N], v[N], r[N];
    ld(q.p, i, p);
    ld(q.g, i, g);
    ld(q.m, i, m);
    ld(q.v, i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float gi = g[j];
      m[j] = rt<T>(__fadd_rn(rt<T>(__fmul_rn(b1, m[j])),
                             rt<T>(__fmul_rn(omb1, gi))));
      v[j] = rt<T>(__fadd_rn(rt<T>(__fmul_rn(b2, v[j])),
                             rt<T>(__fmul_rn(omb2, rt<T>(__fmul_rn(gi, gi))))));
      const float den =
          rt<T>(__fadd_rn(rt<T>(__fsqrt_rn(rt<T>(__fdiv_rn(v[j], c2)))), eps));
      r[j] = rt<T>(__fadd_rn(rt<T>(__fdiv_rn(rt<T>(__fdiv_rn(m[j], c1)), den)),
                             rt<T>(__fmul_rn(wd, p[j]))));
      sp = __fadd_rn(sp, rt<T>(__fmul_rn(p[j], p[j])));
      sr = __fadd_rn(sr, rt<T>(__fmul_rn(r[j], r[j])));
    }
    st(q.r, i, r);
    st(q.m, i, m);
    st(q.v, i, v);
  }
};

template <class T>
struct Lamb2ApplyRule {
  static constexpr int kArrays = 2;
  const float* sums;
  float lr;
  struct Ptrs {
    T* p;
    const T* r;
    float s;
  };
  __device__ Ptrs bind(const int64_t* ptrs, int n, int t) const {
    const float w = rt<T>(__fsqrt_rn(rt<T>(sums[2 * t])));
    const float q = rt<T>(__fsqrt_rn(rt<T>(sums[2 * t + 1])));
    const float trust = (w > 0.0f && q > 0.0f) ? rt<T>(__fdiv_rn(w, q)) : 1.0f;
    return {reinterpret_cast<T*>(ptrs[t]),
            reinterpret_cast<const T*>(ptrs[n + t]),
            rt<T>(__fmul_rn(lr, trust))};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    float p[N], r[N];
    ld(q.p, i, p);
    ld(q.r, i, r);
#pragma unroll
    for (int j = 0; j < N; ++j)
      p[j] = rt<T>(__fsub_rn(p[j], rt<T>(__fmul_rn(q.s, r[j]))));
    st(q.p, i, p);
  }
};

// Sum of x over the block by a fixed tree; the result is in thread 0.
// scratch: kThreads / 32 floats of shared memory. Shared by dygraph
// Lamb's phase 1 and the chunk entry's.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = 0.0f;
  if (warp == 0) {
    x = lane < kThreads / 32 ? scratch[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  }
  return x;
}

// Segment s's pieces are rows seg_first[s] .. seg_first[s + 1] - 1 of the
// piece table (in order); their (p*p, r*r) sums are added in double into
// seg_sums (n_seg, 2) f32: a segment may span thousands of pieces (1,431
// for BERT-base's word-embedding table as a ZeRO chunk, 2,862 as a
// dygraph tensor), and an f32 running sum over them would lose up to
// ~1e-4 of the norm. A segment is a parameter (dygraph Lamb) or a
// parameter's part of a ZeRO chunk (the chunk entry). One warp a
// segment: lane l adds pieces l, l + 32, ... in order, then a fixed
// shuffle tree, so two runs give the same bits (one thread a segment
// took 0.16 ms over BERT-base's 13,561 pieces, the warp 0.01). Every
// lane of the warp calls it; lane 0 writes.
__device__ __forceinline__ void warp_segment_sum(
    const float* piece_sums, const int64_t* __restrict__ seg_first, int s,
    float* __restrict__ seg_sums) {
  const int lane = threadIdx.x & 31;
  double a = 0.0, b = 0.0;
  // unrolled so that several loads are in flight (BERT-base's 1,431
  // pieces are 45 a lane); the adds stay in order
#pragma unroll 8
  for (int64_t k = seg_first[s] + lane; k < seg_first[s + 1]; k += 32) {
    // L2, not L1: in the chunk entry other blocks wrote them this launch
    a += (double)__ldcg(piece_sums + 2 * k);
    b += (double)__ldcg(piece_sums + 2 * k + 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    seg_sums[2 * s] = (float)a;
    seg_sums[2 * s + 1] = (float)b;
  }
}

__global__ void segment_sum_kernel(const float* __restrict__ piece_sums,
                                   const int64_t* __restrict__ seg_first,
                                   int n_seg, float* __restrict__ seg_sums) {
  const int s = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (s < n_seg)        // a segment's lanes return together
    warp_segment_sum(piece_sums, seg_first, s, seg_sums);
}

// Dygraph Lamb's phase 1 with the norms folded in. The host cuts every
// parameter into PIECES, runs of at most 8192 elements inside one
// parameter starting at a multiple of 8192 of it (rows (start in the
// concatenation, length, tensor) of ``pieces``, built once per parameter
// list with the pointer table), and block b takes piece b: it applies
// LambPhase1Rule to the piece (float4 where the tensor's arrays are
// 16-byte aligned, as the walker does) and reduces the threads' running
// sums of p*p and r*r by block_sum's fixed tree into piece_sums[b].
// segment_sum_kernel then adds each parameter's pieces in a fixed
// order, in double. No float atomics: two runs give the same bits. The
// parameter is only read here, so |p| is the norm of the old p, as in
// JAX.
template <class Rule>
__global__ void __launch_bounds__(kThreads)
lamb_phase1_pieces_kernel(const int64_t* __restrict__ ptrs,
                          const int64_t* __restrict__ offs, int n,
                          const int64_t* __restrict__ pieces,
                          float* __restrict__ piece_sums, Rule rule) {
  __shared__ float scratch[2][kThreads / 32];
  const int64_t* row = pieces + 3 * (int64_t)blockIdx.x;
  const int t = (int)row[2];
  const int64_t a = row[0] - offs[t];
  float sp = 0.0f, sr = 0.0f;
  walk_range(rule, rule.bind(ptrs, n, t), aligned<Rule>(ptrs, n, t), a,
             a + row[1], sp, sr);
  sp = block_sum(sp, scratch[0]);
  sr = block_sum(sr, scratch[1]);
  if (threadIdx.x == 0) {
    piece_sums[2 * (int64_t)blockIdx.x] = sp;
    piece_sums[2 * (int64_t)blockIdx.x + 1] = sr;
  }
}

// ---------------------------------------------------------------------------
// The static (program) forms: _run_grid with the dygraph=False bodies,
// reached from fused_op_update (paddle_tpu/ops/pallas/fused_optimizer.py
// :418) by the sgd, momentum, adam and lamb ops of a static program. lr,
// the beta-pows and the optional FoundInfinite flag are (1,) device
// tensors: their pointers ride in the table beside the tensor's, bind()
// reads them once per block and tensor, and a null flag pointer means
// no gate. Nothing is read on the host. A set flag leaves p and the
// moments or the velocity as they were (_gate_update); the beta-pow
// outputs then keep the old pows (_gate_scalars).
//
// Beta-pow outputs go to SEPARATE one-element buffers: the program
// writes Beta1PowOut to the variable Beta1Pow itself, and every block of
// the launch reads Beta1Pow, so writing it in place would race with the
// blocks still reading it. The thread that owns element 0 of tensor t
// writes t's advanced pows (b1p*b1, b2p*b2, as JAX computes them outside
// _run_grid, fused_optimizer.py:370-371).
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool skip_flag(int64_t ptr) {
  return ptr != 0 && *reinterpret_cast<const uint8_t*>(ptr) != 0;
}

__device__ __forceinline__ float scalar_at(int64_t ptr) {
  return *reinterpret_cast<const float*>(ptr);
}

// _sgd_kernel: p2 = p - lr*g. Roles p, g, lr, found.
struct StaticSgdRule {
  static constexpr int kRoles = 4, kArrays = 2;
  struct Ptrs {
    float* p;
    const float* g;
    float lr;
    bool skip;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<float*>(ptrs[t]),
            reinterpret_cast<const float*>(ptrs[n + t]),
            scalar_at(ptrs[2 * n + t]), skip_flag(ptrs[3 * n + t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    if (q.skip) return;
    float p[N], g[N];
    ld(q.p, i, p);
    ld(q.g, i, g);
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = __fsub_rn(p[j], __fmul_rn(q.lr, g[j]));
    st(q.p, i, p);
  }
};

// _momentum_kernel: v2 = mu*v + g; p2 = p - lr*v2, or with Nesterov
// p2 = p - (g + mu*v2)*lr. Roles p, g, v, lr, found.
struct StaticMomentumRule {
  static constexpr int kRoles = 5, kArrays = 3;
  float mu;
  int nesterov;
  struct Ptrs {
    float* p;
    const float* g;
    float* v;
    float lr;
    bool skip;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    return {reinterpret_cast<float*>(ptrs[t]),
            reinterpret_cast<const float*>(ptrs[n + t]),
            reinterpret_cast<float*>(ptrs[2 * n + t]),
            scalar_at(ptrs[3 * n + t]), skip_flag(ptrs[4 * n + t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    if (q.skip) return;
    float p[N], g[N], v[N];
    ld(q.p, i, p);
    ld(q.g, i, g);
    ld(q.v, i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[j] = __fadd_rn(__fmul_rn(mu, v[j]), g[j]);
      const float step = nesterov
          ? __fmul_rn(__fadd_rn(g[j], __fmul_rn(mu, v[j])), q.lr)
          : __fmul_rn(q.lr, v[j]);
      p[j] = __fsub_rn(p[j], step);
    }
    st(q.p, i, p);
    st(q.v, i, v);
  }
};

// The beta-pow half shared by Adam and Lamb: the advanced pows c1 =
// b1p*b1, c2 = b2p*b2 and the flag, bound from roles 5-9 of the table
// (b1p, b2p, found, b1p_out, b2p_out).
struct Pows {
  float b1p, b2p, c1, c2;
  float* b1p_out;
  float* b2p_out;
  bool skip;
  __device__ __forceinline__ void write(int64_t i) const {
    if (i != 0) return;   // the apply call whose values start at element 0
    *b1p_out = skip ? b1p : c1;
    *b2p_out = skip ? b2p : c2;
  }
};

__device__ __forceinline__ Pows bind_pows(const int64_t* ptrs, int n, int t,
                                          float b1, float b2) {
  const float b1p = scalar_at(ptrs[5 * n + t]);
  const float b2p = scalar_at(ptrs[6 * n + t]);
  return {b1p, b2p, __fmul_rn(b1p, b1), __fmul_rn(b2p, b2),
          reinterpret_cast<float*>(ptrs[8 * n + t]),
          reinterpret_cast<float*>(ptrs[9 * n + t]),
          skip_flag(ptrs[7 * n + t])};
}

// _adam_kernel(dygraph=False): m2 = b1*m + (1-b1)*g,
// v2 = b2*v + ((1-b2)*g)*g, lr_t = lr*sqrt(1-c2)/(1-c1) (once a tensor),
// p2 = p - (lr_t*m2) / (sqrt(v2) + eps). Roles p, g, m, v, lr, b1p, b2p,
// found, b1p_out, b2p_out.
struct StaticAdamRule {
  static constexpr int kRoles = 10, kArrays = 4;
  float b1, omb1, b2, omb2, eps;
  struct Ptrs {
    float* p;
    const float* g;
    float* m;
    float* v;
    float lr_t;
    Pows pows;
  };
  __device__ Ptrs bind(const int64_t* ptrs, int n, int t) const {
    const Pows w = bind_pows(ptrs, n, t, b1, b2);
    const float lr = scalar_at(ptrs[4 * n + t]);
    const float lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.0f,
                                                                  w.c2))),
                                 __fsub_rn(1.0f, w.c1));
    return {reinterpret_cast<float*>(ptrs[t]),
            reinterpret_cast<const float*>(ptrs[n + t]),
            reinterpret_cast<float*>(ptrs[2 * n + t]),
            reinterpret_cast<float*>(ptrs[3 * n + t]), lr_t, w};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    q.pows.write(i);
    if (q.pows.skip) return;
    float p[N], g[N], m[N], v[N];
    ld(q.p, i, p);
    ld(q.g, i, g);
    ld(q.m, i, m);
    ld(q.v, i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float gi = g[j];
      m[j] = __fadd_rn(__fmul_rn(b1, m[j]), __fmul_rn(omb1, gi));
      v[j] = __fadd_rn(__fmul_rn(b2, v[j]),
                       __fmul_rn(__fmul_rn(omb2, gi), gi));
      const float den = __fadd_rn(__fsqrt_rn(v[j]), eps);
      p[j] = __fsub_rn(p[j], __fdiv_rn(__fmul_rn(q.lr_t, m[j]), den));
    }
    st(q.p, i, p);
    st(q.m, i, m);
    st(q.v, i, v);
  }
};

__device__ __forceinline__ void add_squares(float p, float r, float& sp,
                                            float& sr) {
  sp = __fadd_rn(sp, __fmul_rn(p, p));
  sr = __fadd_rn(sr, __fmul_rn(r, r));
}

// _lamb_phase1_kernel(dygraph=False): m2, v2 as Adam's,
// r = (m2/(1-c1)) / (sqrt(v2/(1-c2)) + eps) + wd*p into the scratch r.
// Roles p, g, m, v, r, b1p, b2p, found, b1p_out, b2p_out; p is only read.
struct StaticLambPhase1Rule {
  static constexpr int kRoles = 10, kArrays = 5;
  float b1, omb1, b2, omb2, eps, wd;
  struct Ptrs {
    const float* p;
    const float* g;
    float* m;
    float* v;
    float* r;
    float omc1, omc2;
    Pows pows;
  };
  __device__ Ptrs bind(const int64_t* ptrs, int n, int t) const {
    const Pows w = bind_pows(ptrs, n, t, b1, b2);
    return {reinterpret_cast<const float*>(ptrs[t]),
            reinterpret_cast<const float*>(ptrs[n + t]),
            reinterpret_cast<float*>(ptrs[2 * n + t]),
            reinterpret_cast<float*>(ptrs[3 * n + t]),
            reinterpret_cast<float*>(ptrs[4 * n + t]),
            __fsub_rn(1.0f, w.c1), __fsub_rn(1.0f, w.c2), w};
  }
  // acc: none (the static forms), or the running sums sp += p*p,
  // sr += r*r (the chunk entry; element order)
  template <int N, class... Acc>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i,
                                        Acc&... acc) const {
    q.pows.write(i);
    if (q.pows.skip) return;
    float p[N], g[N], m[N], v[N], r[N];
    ld(q.p, i, p);
    ld(q.g, i, g);
    ld(q.m, i, m);
    ld(q.v, i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float gi = g[j];
      m[j] = __fadd_rn(__fmul_rn(b1, m[j]), __fmul_rn(omb1, gi));
      v[j] = __fadd_rn(__fmul_rn(b2, v[j]),
                       __fmul_rn(__fmul_rn(omb2, gi), gi));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v[j], q.omc2)), eps);
      r[j] = __fadd_rn(__fdiv_rn(__fdiv_rn(m[j], q.omc1), den),
                       __fmul_rn(wd, p[j]));
      if constexpr (sizeof...(Acc) == 2) add_squares(p[j], r[j], acc...);
    }
    st(q.r, i, r);
    st(q.m, i, m);
    st(q.v, i, v);
  }
};

// Static Lamb's update after the norms: trust = |p|/|r| where both are
// > 0, else 1 (_xla_lamb, fused_optimizer.py:155-157); p2 = p -
// (lr*trust)*r. Roles p, r, lr, |p|, |r|, found: the norms are 0-dim
// device tensors, read when the walker binds the tensor.
struct StaticLambApplyRule {
  static constexpr int kRoles = 6, kArrays = 2;
  struct Ptrs {
    float* p;
    const float* r;
    float s;
    bool skip;
  };
  __device__ static Ptrs bind(const int64_t* ptrs, int n, int t) {
    const float w = scalar_at(ptrs[3 * n + t]);
    const float q = scalar_at(ptrs[4 * n + t]);
    const float trust = (w > 0.0f && q > 0.0f) ? __fdiv_rn(w, q) : 1.0f;
    return {reinterpret_cast<float*>(ptrs[t]),
            reinterpret_cast<const float*>(ptrs[n + t]),
            __fmul_rn(scalar_at(ptrs[2 * n + t]), trust),
            skip_flag(ptrs[5 * n + t])};
  }
  template <int N>
  __device__ __forceinline__ void apply(const Ptrs& q, int64_t i) const {
    if (q.skip) return;
    float p[N], r[N];
    ld(q.p, i, p);
    ld(q.r, i, r);
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = __fsub_rn(p[j], __fmul_rn(q.s, r[j]));
    st(q.p, i, p);
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


// Elements a block takes in a launch whose table travels by value: a
// multiple of 512 that gives at least two blocks an SM when the elements
// allow (the static example's 77,850 elements: 153 blocks of 512;
// LeNet's 61,610: 121), at most kChunk (BERT-base's 110 M: 8192).
int64_t static_chunk(int64_t total) {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      n = 132;
    return n;
  }();
  const int64_t c = (total / (2 * (int64_t)sms)) & ~(int64_t)511;
  return c < 512 ? 512 : c > kChunk ? kChunk : c;
}

// Copies the host table ((Rule::kRoles, n) pointers and the (n + 1,)
// offsets) into the parameters of a launch whose table is a Tab; the
// grid is sized by static_chunk.
template <class Tab, class Rule>
int launch_table(const int64_t* ptrs, const int64_t* offs, int n,
                 long long total, void* stream, const Rule& rule) {
  Tab tab;
  for (int i = 0; i < Rule::kRoles * n; ++i) tab.ptrs[i] = ptrs[i];
  for (int i = 0; i <= n; ++i) tab.offs[i] = offs[i];
  const int64_t chunk = static_chunk(total);
  const int64_t blocks = (total + chunk - 1) / chunk;
  multi_tensor_arg_kernel<Rule, Tab><<<(unsigned)blocks, kThreads, 0,
                                       (cudaStream_t)stream>>>(
      tab, n, (int64_t)total, chunk, rule);
  return (int)cudaGetLastError();
}

// The short table where the list fits in it, else the whole parameter
// space's.
template <class Rule>
int launch_args(const int64_t* ptrs, const int64_t* offs, int n,
                long long total, void* stream, const Rule& rule) {
  using Tab = ArgTable<Rule::kRoles>;
  using Short = ArgTable<Rule::kRoles, kShortParamBytes>;
  if (n < 1 || n > Tab::kCap || total < 0)
    return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaSuccess;
  return n <= Short::kCap
      ? launch_table<Short>(ptrs, offs, n, total, stream, rule)
      : launch_table<Tab>(ptrs, offs, n, total, stream, rule);
}

// ---------------------------------------------------------------------------
// K3's ZeRO chunk entry: Lamb on one rank's flat (c,) chunk of a ZeRO
// bucket (fused_chunk_update, paddle_tpu/ops/pallas/fused_optimizer.py:455:
// _lamb_phase1_kernel with dygraph=False through _run_grid, then XLA's
// segment sums, psum and finish). The chunk holds parts of several
// parameters: element j of parameter i is segment i, the padding tail
// the sentinel segment n_params. The trust ratio of parameter i needs
// |p_i| and |r_i| over the WHOLE parameter, which other ranks hold parts
// of, so the update is two launches around a cross-rank sum, the least
// a call can take:
//
// 1. chunk_lamb_phase1_kernel: one block per PIECE, a run of elements
//    inside one segment (the host cuts the chunk at segment ends and
//    every `piece` elements, a power of two that spreads a small chunk
//    over many SMs and streams 8192 at a time from a large one; the table
//    is built once per layout). The block walks its piece with the
//    multi-tensor walker (walk_range: float4 where the five arrays are
//    16-byte aligned, scalar heads and tails) applying
//    StaticLambPhase1Rule, which writes m, v and the scratch r and keeps
//    the thread's running sums of p*p and r*r; block_sum's fixed tree
//    reduces them into piece_sums. Then the block draws a ticket (an
//    integer atomicAdd after a __threadfence, so its sums are visible
//    first); the block that draws the last one adds each segment's
//    pieces in double, a warp a segment in a fixed order
//    (warp_segment_sum), into the (n_seg, 2) f32 buffer that the wrapper
//    sums across ranks (the psum at :522-523), and resets the ticket to
//    0 for the next call. No float atomics: two runs give the same bits.
// 2. chunk_lamb_apply_kernel: one block per piece again, float4 through
//    the same walker (LambApplyRule's arithmetic); trust = |p|/|r| of the
//    piece's segment where both are > 0, else 1; p2 = p - (lr*trust)*r.
//
// c1 = b1p*b1 and c2 = b2p*b2 are read on the device; the thread that
// owns element 0 writes the beta-pow outputs to separate buffers. A set
// FoundInfinite flag keeps p, m, v and the pows; phase 1 then still draws
// its tickets and writes zero sums. Not copied from the TPU: _run_grid's
// (8, 128)-tile padding and the n < 1024 XLA floor.
// Bound: device-memory bytes, 28 an element (p, g, m, v read; p, m, v
// written); the two launches move 40 (phase 1 reads p, g, m, v and
// writes m, v, r; the apply reads p and r and writes p). An r-free apply
// that recomputed r from p, g, m and v would move the same 40.
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
chunk_lamb_phase1_kernel(const float* p, const float* g, float* m, float* v,
                         float* r, const float* b1p_in, const float* b2p_in,
                         const uint8_t* found, float* b1p_out,
                         float* b2p_out, const int64_t* __restrict__ pieces,
                         int n_pieces, const int64_t* __restrict__ seg_first,
                         int n_seg, float* piece_sums,
                         float* __restrict__ seg_sums,
                         unsigned* __restrict__ ticket,
                         StaticLambPhase1Rule rule) {
  __shared__ float scratch[2][kThreads / 32];
  __shared__ bool last;
  const int64_t start = pieces[3 * (int64_t)blockIdx.x];
  const int64_t end = start + pieces[3 * (int64_t)blockIdx.x + 1];
  const float b1p = *b1p_in, b2p = *b2p_in;
  const Pows w{b1p, b2p, __fmul_rn(b1p, rule.b1), __fmul_rn(b2p, rule.b2),
               b1p_out, b2p_out, found != nullptr && *found != 0};
  const StaticLambPhase1Rule::Ptrs q{p, g, m, v, r, __fsub_rn(1.0f, w.c1),
                                     __fsub_rn(1.0f, w.c2), w};
  const bool vec = aligned16(p, g) && aligned16(m, v) && aligned16(r, p);
  float sp = 0.0f, sr = 0.0f;
  walk_range(rule, q, vec, start, end, sp, sr);
  sp = block_sum(sp, scratch[0]);
  sr = block_sum(sr, scratch[1]);
  if (threadIdx.x == 0) {
    piece_sums[2 * (int64_t)blockIdx.x] = sp;
    piece_sums[2 * (int64_t)blockIdx.x + 1] = sr;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)(n_pieces - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int s = threadIdx.x / 32; s < n_seg; s += kThreads / 32)
    warp_segment_sum(piece_sums, seg_first, s, seg_sums);
  if (threadIdx.x == 0) *ticket = 0u;
}

__global__ void __launch_bounds__(kThreads)
chunk_lamb_apply_kernel(float* __restrict__ p, const float* __restrict__ r,
                        const float* lr, const uint8_t* found,
                        const int64_t* __restrict__ pieces,
                        const float* __restrict__ seg_sums) {
  if (found != nullptr && *found != 0) return;
  const int64_t start = pieces[3 * (int64_t)blockIdx.x];
  const int64_t end = start + pieces[3 * (int64_t)blockIdx.x + 1];
  const int64_t seg = pieces[3 * (int64_t)blockIdx.x + 2];
  const float w = __fsqrt_rn(seg_sums[2 * seg]);
  const float q = __fsqrt_rn(seg_sums[2 * seg + 1]);
  const float trust = (w > 0.0f && q > 0.0f) ? __fdiv_rn(w, q) : 1.0f;
  walk_range(LambApplyRule<float>{},
             LambApplyRule<float>::Ptrs{p, r, __fmul_rn(*lr, trust)},
             aligned16(p, r), start, end);
}

// Dygraph Lamb's phase 1: the pieces kernel, then the segment sums
template <class Rule>
int lamb_phase1(const int64_t* ptrs, const int64_t* offs, int n,
                long long total, const int64_t* pieces, int n_pieces,
                const int64_t* tensor_first, float* piece_sums, float* sums,
                void* stream, const Rule& rule) {
  if (n < 1 || total < 0 || n_pieces < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_pieces > 0) {
    lamb_phase1_pieces_kernel<Rule><<<(unsigned)n_pieces, kThreads, 0, st>>>(
        ptrs, offs, n, pieces, piece_sums, rule);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  segment_sum_kernel<<<(unsigned)((32 * (int64_t)n + 127) / 128), 128, 0,
                       st>>>(piece_sums, tensor_first, n, sums);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define FUSED_DYGRAPH_FORMS(SUFFIX, T)                                        \
  int fused_adam_##SUFFIX(const int64_t* ptrs, const int64_t* offs, int n,    \
                          long long total, float lr, float b1, float omb1,    \
                          float b2, float omb2, float eps, float c1,          \
                          float c2, float lrwd, int skip, void* stream) {     \
    return launch(ptrs, offs, n, total, skip, stream,                         \
                  AdamRule<T>{lr, b1, omb1, b2, omb2, eps, c1, c2, lrwd});    \
  }                                                                           \
  int fused_momentum_##SUFFIX(const int64_t* ptrs, const int64_t* offs,       \
                              int n, long long total, float lr, float mu,     \
                              int nesterov, int skip, void* stream) {         \
    return launch(ptrs, offs, n, total, skip, stream,                         \
                  MomentumRule<T>{lr, mu, nesterov});                         \
  }                                                                           \
  int fused_sgd_##SUFFIX(const int64_t* ptrs, const int64_t* offs, int n,     \
                         long long total, float lr, float wd, void* stream) { \
    return launch_args(ptrs, offs, n, total, stream, SgdRule<T>{lr, wd});     \
  }                                                                           \
  int fused_lamb_phase1_##SUFFIX(                                             \
      const int64_t* ptrs, const int64_t* offs, int n, long long total,       \
      const int64_t* pieces, int n_pieces, const int64_t* tensor_first,       \
      float* piece_sums, float* sums, float b1, float omb1, float b2,         \
      float omb2, float eps, float wd, float c1, float c2, void* stream) {    \
    return lamb_phase1(ptrs, offs, n, total, pieces, n_pieces, tensor_first,  \
                       piece_sums, sums, stream,                              \
                       LambPhase1Rule<T>{b1, omb1, b2, omb2, eps, wd, c1,     \
                                         c2});                                \
  }                                                                           \
  int fused_lamb_apply_##SUFFIX(const int64_t* ptrs, const int64_t* offs,     \
                                int n, long long total, const float* sums,    \
                                float lr, void* stream) {                     \
    return launch(ptrs, offs, n, total, 0, stream,                            \
                  LambApplyRule<T>{sums, lr});                                \
  }

// The f32 forms. fused_sgd_f32's ptrs, offs: the HOST table ((2, n)
// pointers p, g; (n + 1,) offsets) of at most ArgTable<2>::kCap tensors,
// copied into the launch's parameters. fused_lamb_phase1_f32's pieces:
// (n_pieces, 3) rows (start, length, tensor); tensor_first: the (n + 1,)
// first piece of each tensor; piece_sums: (n_pieces, 2) scratch; sums:
// the (n, 2) sums of p*p and r*r of each tensor, written there.
FUSED_DYGRAPH_FORMS(f32, float)
// The master-weight forms over bf16 and f16 parameters: the tables hold
// p (2-byte), g (2-byte), the f32 master, then the rule's f32 state
// (Lamb's phase 1: master, g, m, v, r; its apply: p, r, master); SGD's
// host table has three roles.
FUSED_DYGRAPH_FORMS(bf16, __nv_bfloat16)
FUSED_DYGRAPH_FORMS(f16, __half)
#undef FUSED_DYGRAPH_FORMS

// The 2-byte forms without masters: the same arguments as the forms
// above, every table role (p, g, the state, Lamb's r) in T, the scalars
// already rounded to T; Lamb's sums stay f32 (n, 2), rounded to T by the
// apply. See the block above Adam2Rule.
#define FUSED_NOMASTER_FORMS(SUFFIX, T)                                       \
  int fused_adam_nomaster_##SUFFIX(                                           \
      const int64_t* ptrs, const int64_t* offs, int n, long long total,       \
      float lr, float b1, float omb1, float b2, float omb2, float eps,        \
      float c1, float c2, float lrwd, int skip, void* stream) {               \
    return launch(ptrs, offs, n, total, skip, stream,                         \
                  Adam2Rule<T>{lr, b1, omb1, b2, omb2, eps, c1, c2, lrwd});   \
  }                                                                           \
  int fused_momentum_nomaster_##SUFFIX(const int64_t* ptrs,                   \
                                       const int64_t* offs, int n,            \
                                       long long total, float lr, float mu,   \
                                       int nesterov, int skip,                \
                                       void* stream) {                        \
    return launch(ptrs, offs, n, total, skip, stream,                         \
                  Momentum2Rule<T>{lr, mu, nesterov});                        \
  }                                                                           \
  int fused_sgd_nomaster_##SUFFIX(const int64_t* ptrs, const int64_t* offs,   \
                                  int n, long long total, float lr, float wd, \
                                  void* stream) {                             \
    return launch_args(ptrs, offs, n, total, stream, Sgd2Rule<T>{lr, wd});    \
  }                                                                           \
  int fused_lamb_phase1_nomaster_##SUFFIX(                                    \
      const int64_t* ptrs, const int64_t* offs, int n, long long total,       \
      const int64_t* pieces, int n_pieces, const int64_t* tensor_first,       \
      float* piece_sums, float* sums, float b1, float omb1, float b2,         \
      float omb2, float eps, float wd, float c1, float c2, void* stream) {    \
    return lamb_phase1(ptrs, offs, n, total, pieces, n_pieces, tensor_first,  \
                       piece_sums, sums, stream,                              \
                       Lamb2Phase1Rule<T>{b1, omb1, b2, omb2, eps, wd, c1,    \
                                          c2});                               \
  }                                                                           \
  int fused_lamb_apply_nomaster_##SUFFIX(                                     \
      const int64_t* ptrs, const int64_t* offs, int n, long long total,       \
      const float* sums, float lr, void* stream) {                            \
    return launch(ptrs, offs, n, total, 0, stream,                            \
                  Lamb2ApplyRule<T>{sums, lr});                               \
  }

FUSED_NOMASTER_FORMS(bf16, __nv_bfloat16)
FUSED_NOMASTER_FORMS(f16, __half)
#undef FUSED_NOMASTER_FORMS

int static_sgd_f32(const int64_t* ptrs, const int64_t* offs, int n,
                   long long total, void* stream) {
  return launch_args(ptrs, offs, n, total, stream, StaticSgdRule{});
}

int static_momentum_f32(const int64_t* ptrs, const int64_t* offs, int n,
                        long long total, float mu, int nesterov,
                        void* stream) {
  return launch_args(ptrs, offs, n, total, stream,
                     StaticMomentumRule{mu, nesterov});
}

int static_adam_f32(const int64_t* ptrs, const int64_t* offs, int n,
                    long long total, float b1, float omb1, float b2,
                    float omb2, float eps, void* stream) {
  return launch_args(ptrs, offs, n, total, stream,
                     StaticAdamRule{b1, omb1, b2, omb2, eps});
}

int static_lamb_phase1_f32(const int64_t* ptrs, const int64_t* offs, int n,
                           long long total, float b1, float omb1, float b2,
                           float omb2, float eps, float wd, void* stream) {
  return launch_args(ptrs, offs, n, total, stream,
                     StaticLambPhase1Rule{b1, omb1, b2, omb2, eps, wd});
}

int static_lamb_apply_f32(const int64_t* ptrs, const int64_t* offs, int n,
                          long long total, void* stream) {
  return launch_args(ptrs, offs, n, total, stream, StaticLambApplyRule{});
}

int chunk_lamb_phase1_f32(const float* p, const float* g, float* m, float* v,
                          float* r, const float* b1p, const float* b2p,
                          const uint8_t* found, float* b1p_out,
                          float* b2p_out, const int64_t* pieces,
                          int n_pieces, const int64_t* seg_first, int n_seg,
                          float* piece_sums, float* seg_sums,
                          unsigned* ticket, float b1, float omb1, float b2,
                          float omb2, float eps, float wd, void* stream) {
  if (n_pieces < 1 || n_seg < 1) return (int)cudaErrorInvalidValue;
  chunk_lamb_phase1_kernel<<<(unsigned)n_pieces, kThreads, 0,
                             (cudaStream_t)stream>>>(
      p, g, m, v, r, b1p, b2p, found, b1p_out, b2p_out, pieces, n_pieces,
      seg_first, n_seg, piece_sums, seg_sums, ticket,
      StaticLambPhase1Rule{b1, omb1, b2, omb2, eps, wd});
  return (int)cudaGetLastError();
}

int chunk_lamb_apply_f32(float* p, const float* r, const float* lr,
                         const uint8_t* found, const int64_t* pieces,
                         int n_pieces, const float* seg_sums, void* stream) {
  if (n_pieces < 1) return (int)cudaErrorInvalidValue;
  chunk_lamb_apply_kernel<<<(unsigned)n_pieces, kThreads, 0,
                            (cudaStream_t)stream>>>(p, r, lr, found, pieces,
                                                    seg_sums);
  return (int)cudaGetLastError();
}

// Tensors one launch whose table travels by value takes for a rule of
// ``roles`` table roles (2: dygraph SGD; 3: its master form; 4: static sgd, 5: momentum, 6:
// Lamb's apply, 10: Adam and Lamb's phase 1), 0 for another count; and
// the parameter space the build assumed.
int static_table_capacity(int roles) {
  switch (roles) {
    case 2: return ArgTable<2>::kCap;
    case 3: return ArgTable<3>::kCap;
    case 4: return ArgTable<4>::kCap;
    case 5: return ArgTable<5>::kCap;
    case 6: return ArgTable<6>::kCap;
    case 10: return ArgTable<10>::kCap;
    default: return 0;
  }
}

int static_param_bytes() { return kParamBytes; }

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
