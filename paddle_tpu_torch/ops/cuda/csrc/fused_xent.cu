// Fused linear + vocabulary cross-entropy for Hopper (sm_90a), on the
// tensor cores: forward (per-row lse and label logit) and backward (dh;
// dW and db), with the logits h W^T + b never written to device memory.
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas/fused_xent.py:
// _fwd_call (_fwd_kernel) and _bwd_call (_bwd_dh_kernel,
// _bwd_dw_kernel).
//
// Two forms, one kernel body templated on the operand type T and SPLIT:
// - the f32 form (T = bf16, SPLIT): f32 inputs, every product three bf16
//   terms (below);
// - the 2-byte forms (T = bf16 or f16, not SPLIT): bf16 or f16 h, W and
//   bias, which the O2 autocast hands the MLM head (the TPU kernel upcasts
//   each tile to f32, fused_xent.py:98-167, and returns dh, dW, db in the
//   inputs' types, :256, :302). The TMA boxes read h and W as they are,
//   with no split pass and no scratch; each product is ONE wgmma term
//   (bf16.bf16 or f16.f16) with f32 accumulation, exact for S = h W^T;
//   P' is rounded to T once, after a power-of-two scaling that keeps it
//   in f16's normal range: dh's rows take P' = (exp(S + b - lse) -
//   onehot) 2^14 and the row's g 2^-14 multiplies the f32 accumulator at
//   the end; dW takes P' = P g 2^(14 - e), with 2^e the largest |g| of
//   the step's 64 rows rounded down to a power of two, and adds the
//   step's product times 2^(e - 14). So |P'| < 2^15 and a softmax term
//   down to 2^-28 is an f16 normal (unlifted, P ~ 1/V = 3e-5 at BERT's
//   vocabulary would round as an f16 subnormal). dh, dW and db are
//   rounded to T once, from the f32 accumulators. lse and the label
//   logit stay f32.
//
// Precision of the f32 form. The inputs are f32 and the plain version
// multiplies in f32.
// Every product here is three bf16 wgmma terms with f32 accumulation,
// hi*hi + hi*lo + lo*hi, where hi is the bf16 rounding of an f32 value x
// and lo the bf16 rounding of x - hi (16 significant bits together; the
// lo*lo term is dropped). One bf16 term a product misses the card check's
// bound (1e-4 of the largest value) at BERT's head; three terms meet it
// (tests/test_torch_xent_rounding.py models where these kernels round).
// dh and dW add each 64-row step's product into their accumulators with
// f32 adds: the tensor cores' own accumulation does not round to nearest,
// and 1900 k16 steps into one accumulator moved dh past the bound.
//
// Bound: operations. The 2-byte forms: one term a product, 989 TFLOP/s,
// 0.778 ms for the forward and 2.335 ms for the backward's three products
// at BERT's head (the kernel runs four: 3.11 ms). The f32 form: at BERT's MLM head (N = 16384 rows, H = 768,
// V = 30592) the forward forms S = h W^T once (2 N H V = 7.7e11 flop);
// the backward forms it again for dh and again for dW, beside dh = P' W
// and dW = P'^T h (four products, as the TPU kernel). At three bf16 terms
// a product the tensor cores give 989 / 3 TFLOP/s: 2.33 ms for the
// forward, 9.34 ms for the backward's four products (7.00 for the three
// that one recompute would need).
//
// Design.
// - A split pass (xent_split_fwd / xent_split_bwd, one body, named by the
//   pass it serves) writes h and W as bf16 hi and lo arrays into scratch
//   the caller allocates, 2 (N + V) H bf16, once an entry point.
// - One kernel body for the three passes. A CTA keeps 64 rows of a
//   resident operand R in shared memory and streams 64-row tiles of the
//   other, X, through two stages filled by TMA (forward and dh: R = h,
//   X = W; dW: R = W, X = h). Each step forms the 64 x 64 tile S = R X^T
//   (wgmma, K-major operands), then
//   forward (xent_fwd_mma): folds S + b into an online max, sum of
//     exponentials and label logit a row;
//   backward (xent_bwd_mma, one launch: dh's row tiles, then dW's vocab
//     tiles): P' = (exp(S + b - lse) - onehot) g in f32 (db sums it),
//     stored as hi + lo, and out += P' X (wgmma, X MN-major) with the X
//     tile already in shared memory.
// - H is split over a thread-block cluster of C = ceil(H / 256) CTAs (3
//   at H = 768): CTA c owns columns 256 c .. of R and X, so the R slice
//   and two X stages fit in its shared memory (226 KB), and owns those
//   columns of dh or dW, whose 64 x 256 f32 accumulator sits in the
//   registers of its two warpgroups. Each CTA forms a partial S over its
//   columns; every CTA sums the C partials through distributed shared
//   memory in rank order (0, 1, 2, ...), so all of them hold the same S,
//   formed once a step. The forward's online state is kept by one CTA a
//   16-row strip.
// - What bounds it on the card: besides the products, the partials'
//   exchange (distributed shared memory, 32 KB a CTA and step) and the
//   cluster barrier that publishes them. They wait in line with the
//   tensor cores: overlapping them with another step's products would
//   need a third X stage, which does not fit beside the R slice.
// - No float atomics: each output element has one writer, the per-thread
//   partials of db and of the forward's state are merged in a fixed order,
//   and two launches give the same bits.
// Rows past N and vocab rows past V are masked in the kernels (the JAX
// wrapper pads rows to a multiple of 256 instead). Ignored rows come in
// with label -1 and g = 0.
#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kXT = 256;                     // threads a block (8 warps)
constexpr int kBM = 64;                      // resident rows a CTA
constexpr int kBN = 64;                      // streamed rows a step
constexpr int kLiftExp = 14;                 // the 2-byte forms' P' lift
constexpr int kHS = 256;                     // H columns a CTA owns
constexpr int kMaxC = 4;                     // CTAs a cluster: H <= 1024
constexpr uint32_t kRB = kBM * kHS * 2;      // one bf16 R slice (hi or lo)
constexpr uint32_t kXB = kBN * kHS * 2;      // one bf16 X slice (hi or lo)
constexpr uint32_t kSB = kXT * 4 * 16;       // the partial S: 4 float4 a thread
constexpr uint32_t kPB = kBM * kBN * 2;      // one bf16 P' tile (hi or lo)
constexpr uint32_t kCB = 3 * kBN * 4;        // a stage's column values

enum { kFwd = 0, kDh = 1, kDw = 2 };

struct XentArgs {
  CUtensorMap rh, rl;       // resident operand, hi and lo: (nr, H)
  CUtensorMap xh, xl;       // streamed operand, hi and lo: (nx, H)
                            // (the 2-byte forms: hi is the operand, no lo)
  const void* bias;         // (V,) f32, or T in the 2-byte forms
  const int32_t* labels;    // (N,), -1 matches no class
  const float* lse;         // (N,), backward
  const float* g;           // (N,), backward
  void* out;                // lse (N,) f32, dh (N, H) or dW (V, H) (f32 or T)
  void* out2;               // the label logit (N,) f32 or db (V,) (f32 or T)
  int nr, nx, H;
};

__device__ __forceinline__ float elem_f32(float x) { return x; }
__device__ __forceinline__ float elem_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float elem_f32(f16 x) { return __half2float(x); }

// the element type of the inputs and outputs: f32 for the split form, T
// for the 2-byte forms
template <class T, bool SPLIT>
using Elem = typename std::conditional<SPLIT, float, T>::type;

// bias[j] of the form's element type, as f32
template <class T, bool SPLIT>
__device__ __forceinline__ float bias_at(const XentArgs& a, int j) {
  return elem_f32(static_cast<const Elem<T, SPLIT>*>(a.bias)[j]);
}

// two f32 values rounded to T (nearest even), packed
template <class T>
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  if constexpr (std::is_same<T, f16>::value) {
    const __half2 h = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <int MODE>
constexpr size_t mma_smem() {      // tiles, column values, 3 mbarriers
  return (size_t)2 * kRB + 4 * kXB + kSB + (MODE == kFwd ? 0 : 2 * kPB) +
         2 * kCB + 3 * 8;
}

// Operand tiles for wgmma: a [64][256] bf16 tile is four blocks of
// [64][64] (8 KB each), 128-byte rows whose 16-byte chunks are XORed with
// row % 8: the 128-byte swizzle of the TMA boxes that write them and of
// the wgmma descriptors that read them, K-major for S = R X^T (rows R or
// X, 64 columns of H a block) and MN-major for P' X (rows the k of the
// product, 64 columns of H a block).

// mbarriers: one arrival (the thread that starts the copies) plus the
// bytes the copies bring (expect_tx)
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a 64 x 64 box (columns c0 .., rows r0 ..) of a tensor map into shared
// memory; out-of-bounds elements arrive as zeros
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c0, int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}

// rows r0 .. r0 + 63 and this CTA's columns k0 .. k0 + ks - 1 of the hi
// and lo arrays into a tile pair at dst, completing on bar. The blocks
// past ks are not copied: S reads none of them, and what P' X makes of
// them lands in out columns past ks, which are not stored.
template <bool SPLIT>
__device__ __forceinline__ void tma_slices(uint32_t dst, const CUtensorMap* hi,
                                           const CUtensorMap* lo, int r0,
                                           int k0, int ks, uint32_t bar) {
  const int nb = (ks + 63) / 64;
  mbar_expect(bar, (uint32_t)((SPLIT ? 2 : 1) * nb * kBM * 128));
  for (int b = 0; b < nb; ++b) {
    tma_box(dst + b * (kBM * 128), hi, k0 + 64 * b, r0, bar);
    if constexpr (SPLIT)
      tma_box(dst + kRB + b * (kBM * 128), lo, k0 + 64 * b, r0, bar);
  }
}

// This thread's word of the column values of streamed rows x0 .. x0 + 63,
// [3][64] words a stage: the bias (forward, dh), or lse, g and the label
// (dW); 0 past nx. Loaded into a register first, stored after the loads'
// latency has passed.
template <int MODE, class T, bool SPLIT>
__device__ __forceinline__ uint32_t cols_load(const XentArgs& a, int x0) {
  const int t = threadIdx.x, arr = t / kBN, j = x0 + t % kBN;
  if (t >= (MODE == kDw ? 3 : 1) * kBN || j >= a.nx) return 0u;
  if (MODE != kDw) return __float_as_uint(bias_at<T, SPLIT>(a, j));
  return arr == 0   ? __float_as_uint(a.lse[j])
         : arr == 1 ? __float_as_uint(a.g[j])
                    : (uint32_t)a.labels[j];
}

__device__ __forceinline__ void cols_store(uint32_t* cs, int stage,
                                           uint32_t word) {
  if (threadIdx.x < 3 * kBN) cs[stage * (kCB / 4) + threadIdx.x] = word;
}

// a warp's 16 x 32 tile of P' (rows 16 wr .., columns 32 wc ..) as bf16
// hi into the swizzled [64][64] tile at ``tile`` and lo into the next one
// (SPLIT), or rounded to T into the tile (the 2-byte forms)
template <class T, bool SPLIT>
__device__ __forceinline__ void store_p(unsigned char* tile,
                                        const float (&p)[4][4], int wr,
                                        int wc, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * wr + frag_row(lane, 2 * half);
      const uint32_t off = swz<kBN>(r, 4 * wc + i) + 4 * (lane & 3);
      const float x0 = p[i][2 * half], x1 = p[i][2 * half + 1];
      if constexpr (!SPLIT) {
        *reinterpret_cast<uint32_t*>(tile + off) = pack2<T>(x0, x1);
        continue;
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      *reinterpret_cast<__nv_bfloat162*>(tile + off) = h;
      *reinterpret_cast<uint32_t*>(tile + kPB + off) =
          pack_bf16(x0 - hf.x, x1 - hf.y);
    }
}

// Phase A's arrive: this thread's partial S, written to its own CTA's
// shared memory, is released to the cluster by a fence restricted to
// those writes. A release on the arrive itself orders every memory
// operation of the thread, the copies in flight included, and on the
// card that wait was a large share of each step.
__device__ __forceinline__ void cluster_arrive_shared_release() {
  asm volatile("fence.release.sync_restrict::shared::cta.cluster;\n" ::
                   : "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// (m, l) of an online log-sum-exp merged with another's; l's terms are
// added in one order whichever side calls, so both sides get the same bits
__device__ __forceinline__ void lse_merge(float& m, float& l, float mo,
                                          float lo) {
  const float mn = fmaxf(m, mo);
  l = l * exp2_ftz((m - mn) * kLog2e) + lo * exp2_ftz((mo - mn) * kLog2e);
  m = mn;
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a): a warpgroup's D (64 x N, f32, N / 2 registers a thread,
// warp k of the group holding rows 16 k .., the m16n8 C layout for each 8
// columns) += A (64 x 16) B (16 x N), both from shared memory through
// descriptors: start address, leading and stride byte offsets (16-byte
// units), 128-byte swizzle.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins accumulator registers in place around a run of wgmma, so that the
// compiler moves none of them between two wgmma (which would serialize
// them)
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma's reads, before the barrier that publishes them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 32) += A B^T, A and B K-major (the scale-d predicate true: d
// is added to), T bf16 or f16
#define XENT_N32(TY)                                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15])                                                           \
      : "l"(a), "l"(b), "r"(1))

template <class T>
__device__ __forceinline__ void wg_n32(float (&d)[16], uint64_t a,
                                       uint64_t b) {
  if constexpr (std::is_same<T, f16>::value)
    XENT_N32("f16");
  else
    XENT_N32("bf16");
}
#undef XENT_N32

#define XENT_D8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128) += A B, A K-major, B MN-major (transposed), T bf16 or f16
#define XENT_N128T(TY)                                                        \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "   \
      "1, 0, 1;\n}\n"                                                         \
      : XENT_D8(0), XENT_D8(8), XENT_D8(16), XENT_D8(24), XENT_D8(32),        \
        XENT_D8(40), XENT_D8(48), XENT_D8(56)                                 \
      : "l"(a), "l"(b), "r"(1))

template <class T>
__device__ __forceinline__ void wg_n128t(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  if constexpr (std::is_same<T, f16>::value)
    XENT_N128T("f16");
  else
    XENT_N128T("bf16");
}
#undef XENT_N128T
#undef XENT_D8

// The CTA's partial S over its ks columns of H: warpgroup g forms columns
// 32 g .. 32 g + 31 of R X^T (all 64 rows), as hi hi + hi lo + lo hi each
// k16 step (SPLIT) or one T term; s[i][e] = d[4 i + e] in the m16n8 C
// layout of the warp's rows.
template <class T, bool SPLIT>
__device__ __forceinline__ void partial_s(float (&s)[4][4], uint32_t Rh,
                                          uint32_t Rl, uint32_t Xh,
                                          uint32_t Xl, int ks, int g) {
  float d[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) d[j] = 0.0f;
  const uint32_t xrow = (uint32_t)(32 * g * 128);
  for (int kk = 0; kk < ks / 16; ++kk) {
    const uint32_t off = (uint32_t)((kk >> 2) * (kBM * 128) + (kk & 3) * 32);
    const uint64_t rh = wg_desc(Rh + off, 16, 1024),
                   rl = wg_desc(Rl + off, 16, 1024),
                   xh = wg_desc(Xh + off + xrow, 16, 1024),
                   xl = wg_desc(Xl + off + xrow, 16, 1024);
    fence_operands(d);
    wg_fence();
    wg_n32<T>(d, rh, xh);
    if constexpr (SPLIT) {
      wg_n32<T>(d, rh, xl);
      wg_n32<T>(d, rl, xh);
    }
    wg_commit();
  }
  wg_wait();
  fence_operands(d);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = d[4 * i + e];
}

// acc += P' X for columns 128 g .. 128 g + 127 of the out slice (all 64
// rows), P' (hi at Ps, lo after it, K-major) and the X tile (hi at Xh, lo
// after it, MN-major) in shared memory. The step's product goes into its
// own accumulator and then into acc by f32 adds: the tensor cores' own
// f32 accumulation does not round to nearest, and 1900 k16 steps into one
// accumulator (dh over the 30592-row vocabulary) moved dh past the 1e-4
// bound on the card. The 2-byte forms: one term, and the step's product
// times ``unscale`` (a power of two: exact) into acc.
template <class T, bool SPLIT>
__device__ __forceinline__ void product(float (&acc)[64], uint32_t Ps,
                                        uint32_t Xh, int g, float unscale) {
  const uint32_t Pl = Ps + kPB, Xl = Xh + kXB;
  const uint32_t xcol = (uint32_t)(2 * g * (kBM * 128));
  float part[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) part[j] = 0.0f;
  fence_operands(part);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t ph = wg_desc(Ps + 32 * kk, 16, 1024),
                   pl = wg_desc(Pl + 32 * kk, 16, 1024),
                   xh = wg_desc(Xh + xcol + 16 * 128 * kk, kBM * 128, 1024),
                   xl = wg_desc(Xl + xcol + 16 * 128 * kk, kBM * 128, 1024);
    wg_n128t<T>(part, ph, xh);
    if constexpr (SPLIT) {
      wg_n128t<T>(part, ph, xl);
      wg_n128t<T>(part, pl, xh);
    }
  }
  wg_commit();
  wg_wait();
  fence_operands(part);
#pragma unroll
  for (int j = 0; j < 64; ++j)
    acc[j] += SPLIT ? part[j] : part[j] * unscale;
}

// The three passes. Warpgroup g = w / 4 forms columns 32 g .. of the S
// tile and columns 128 g .. of the out slice; warp wr = w % 4 of a group
// holds rows 16 wr .. of both (thread rows 16 wr + lane / 4 + 8 h).
template <int MODE, class T, bool SPLIT>
__device__ __forceinline__ void xent_body(const XentArgs& a, int tile) {
  extern __shared__ __align__(1024) unsigned char smem_x[];
  const uint32_t Rh = smem_u32(smem_x), Xs = Rh + 2 * kRB,
                 Ss = Xs + 4 * kXB, Ps = Ss + kSB,
                 Cs = Ps + (MODE == kFwd ? 0 : 2 * kPB), Bar = Cs + 2 * kCB;
  float* sp = reinterpret_cast<float*>(smem_x + (Ss - Rh));
  unsigned char* pp = smem_x + (Ps - Rh);
  uint32_t* cw = reinterpret_cast<uint32_t*>(smem_x + (Cs - Rh));
  const float* cs = reinterpret_cast<const float*>(cw);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int C = (a.H + kHS - 1) / kHS, rank = (int)cluster_rank();
  const int r0 = tile * kBM, k0 = rank * kHS;
  const int ks = min(kHS, a.H - k0);
  const int nsteps = (a.nx + kBN - 1) / kBN;
  const int wr = w & 3, wc = w >> 2;
  const bool mine = MODE != kFwd || wr % C == rank;

  // this thread's two rows: the n-side values (forward, dh) or the bias
  // (dW)
  float r_lse[2], r_g[2], r_b[2];
  int r_lab[2];
  bool r_live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * wr + frag_row(lane, 2 * h);
    r_live[h] = row < a.nr;
    r_lab[h] = MODE != kDw && r_live[h] ? a.labels[row] : -1;
    r_lse[h] = MODE == kDh && r_live[h] ? a.lse[row] : 0.0f;
    r_g[h] = MODE == kDh && r_live[h] ? a.g[row] : 0.0f;
    r_b[h] = MODE == kDw && r_live[h] ? bias_at<T, SPLIT>(a, row) : 0.0f;
  }

  // mbarriers: R at Bar, X stage s at Bar + 8 (1 + s)
  if (tid == 0) {
    mbar_init(Bar);
    mbar_init(Bar + 8);
    mbar_init(Bar + 16);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cols_store(cw, 0, cols_load<MODE, T, SPLIT>(a, 0));
  __syncthreads();
  if (tid == 0) {
    tma_slices<SPLIT>(Rh, &a.rh, &a.rl, r0, k0, ks, Bar);
    tma_slices<SPLIT>(Xs, &a.xh, &a.xl, 0, k0, ks, Bar + 8);
  }
  mbar_wait(Bar, 0);

  float acc[64];           // dh or dW: element (j, e) at acc[4 j + e]
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.0f, 0.0f},
        ll[2] = {0.0f, 0.0f}, dbp[2] = {0.0f, 0.0f};

  // Step t: the partial S of tile t is published (cluster barrier phase
  // A); X tile t + 1 starts loading (TMA) into the stage step t - 1 used;
  // every partial is read and summed (phase B: done reading); then the
  // softmax state, or P' and the product. One partial buffer a CTA: a CTA
  // writes the next partial only after phase B, whose wait falls after the
  // next step's S.
  for (int t = 0; t < nsteps; ++t) {
    const int st = t & 1;
    const uint32_t Xh = Xs + 2 * st * kXB, Xl = Xh + kXB;
    mbar_wait(Bar + 8 * (1 + st), (uint32_t)(t >> 1) & 1u);
    float s[4][4];
    partial_s<T, SPLIT>(s, Rh, Rh + kRB, Xh, Xl, ks, wc);
    if (t > 0) cluster_wait();      // B of t - 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(sp + (i * kXT + tid) * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    cluster_arrive_shared_release();  // A of t
    const uint32_t next_cols =
        t + 1 < nsteps ? cols_load<MODE, T, SPLIT>(a, (t + 1) * kBN) : 0u;
    cluster_wait();
    if (tid == 0 && t + 1 < nsteps)   // stage st ^ 1 is free since step t - 1
      tma_slices<SPLIT>(Xs + 2 * (st ^ 1) * kXB, &a.xh, &a.xl, (t + 1) * kBN,
                        k0, ks, Bar + 8 * (2 - st));

    float unscale = 1.0f;   // the 2-byte dW step's 2^(e - 14)
    if (mine) {
      // S: the partials of ranks 0, 1, ... added in that order, the other
      // CTAs' all loaded first, this CTA's from its registers
      float ps[kMaxC][4][4], sum[4][4];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C && c != rank) {
          const uint32_t src = cluster_map(Ss, c);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ld_cluster4(ps[c][i], src + (uint32_t)(i * kXT + tid) * 16);
        }
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = c == rank ? s[i][e] : ps[c][i][e];
              sum[i][e] = c == 0 ? v : sum[i][e] + v;
            }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = sum[i][e];
      const float* cv = cs + st * (kCB / 4);
      const int x0 = t * kBN;
      if constexpr (MODE == kFwd) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x[8], mx = -INFINITY;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cl = 32 * wc + frag_col(lane, i, e), col = x0 + cl;
              const bool in = col < a.nx;
              const float v = in ? s[i][2 * h + e] + cv[cl] : -INFINITY;
              if (in && col == r_lab[h]) ll[h] += v;
              x[2 * i + e] = v;
              mx = fmaxf(mx, v);
            }
          const float mn = fmaxf(m[h], mx);
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) sum += exp2_ftz((x[j] - mn) * kLog2e);
          l[h] = l[h] * exp2_ftz((m[h] - mn) * kLog2e) + sum;
          m[h] = mn;
        }
      } else {
        const int32_t* clab = reinterpret_cast<const int32_t*>(cv + 2 * kBN);
        // the 2-byte lift: dh's P' = P 2^14; dW's P' = P g 2^(14 - e),
        // 2^e <= the largest |g| of the step's rows < 2^(e + 1), so
        // |P'| < 2^15 (f16's range) and P' is normal down to P = 2^-28
        float pscale = !SPLIT ? ldexpf(1.0f, kLiftExp) : 1.0f;
        if constexpr (!SPLIT && MODE == kDw) {
          float gm = 0.0f;
#pragma unroll 8
          for (int j = 0; j < kBN; ++j) gm = fmaxf(gm, fabsf(cv[kBN + j]));
          if (gm > 0.0f) {
            const int e = max(ilogbf(gm), -100);
            pscale = ldexpf(1.0f, kLiftExp - e);
            unscale = ldexpf(1.0f, e - kLiftExp);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, cl = 32 * wc + frag_col(lane, i, e);
            const int col = x0 + cl;
            float p;
            if constexpr (MODE == kDh) {
              p = exp2_ftz((s[i][e] + cv[cl] - r_lse[h]) * kLog2e);
              if (col == r_lab[h]) p -= 1.0f;
              // the 2-byte forms apply the row's g to the accumulator
              if constexpr (SPLIT) p *= r_g[h];
            } else {
              const int v = r0 + 16 * wr + frag_row(lane, e);
              p = exp2_ftz((s[i][e] + r_b[h] - cv[cl]) * kLog2e);
              if (clab[cl] == v) p -= 1.0f;
              p *= cv[kBN + cl];
            }
            if (!r_live[h] || col >= a.nx) p = 0.0f;
            if constexpr (MODE == kDw) dbp[h] += p;
            s[i][e] = SPLIT ? p : p * pscale;
          }
        store_p<T, SPLIT>(pp, s, wr, wc, lane);
      }
    }
    cols_store(cw, st ^ 1, next_cols);
    // B of t: the values read are in registers already, so no release is
    // needed to keep this CTA's reads ahead of the next partial's writes
    cluster_arrive_relaxed();

    if constexpr (MODE != kFwd) {
      fence_async_smem();
      __syncthreads();     // P' is whole
      if (128 * wc < ks) product<T, SPLIT>(acc, Ps, Xh, wc, unscale);
    }
    __syncthreads();       // the stage and P' are rewritten next
  }
  cluster_wait();          // B of the last step: exit is safe

  if constexpr (MODE != kFwd) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 16 * wr + frag_row(lane, 2 * half);
      if (row >= a.nr) continue;
      const float rs =
          !SPLIT && MODE == kDh ? ldexpf(r_g[half], -kLiftExp) : 1.0f;
      const int64_t base = (int64_t)row * a.H + k0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * wc + frag_col(lane, j, 0);
        if (col >= ks) continue;
        const float x0 = acc[4 * j + 2 * half], x1 = acc[4 * j + 2 * half + 1];
        if constexpr (SPLIT)
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base +
                                     col) = make_float2(x0, x1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<T*>(a.out) + base + col) =
              pack2<T>(x0 * rs, x1 * rs);
      }
    }
  }
  // the per-thread partials: the four threads of a quad, then the two
  // warps of a strip (wc 0, then wc 1), through shared memory
  if constexpr (MODE == kFwd) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[h], o);
        ll[h] += __shfl_xor_sync(0xffffffffu, ll[h], o);
        lse_merge(m[h], l[h], mo, lo);
      }
    if (mine && wc == 1 && (lane & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* q = sp + 3 * (16 * wr + frag_row(lane, 2 * h));
        q[0] = m[h];
        q[1] = l[h];
        q[2] = ll[h];
      }
    __syncthreads();
    if (mine && wc == 0 && (lane & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * wr + frag_row(lane, 2 * h);
        const float* q = sp + 3 * rl;
        lse_merge(m[h], l[h], q[0], q[1]);
        if (r_live[h]) {
          static_cast<float*>(a.out)[r0 + rl] =
              m[h] + logf(fmaxf(l[h], 1e-30f));
          static_cast<float*>(a.out2)[r0 + rl] = ll[h] + q[2];
        }
      }
  }
  if constexpr (MODE == kDw) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dbp[h] += __shfl_xor_sync(0xffffffffu, dbp[h], 1);
      dbp[h] += __shfl_xor_sync(0xffffffffu, dbp[h], 2);
    }
    if (wc == 1 && (lane & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) sp[16 * wr + frag_row(lane, 2 * h)] = dbp[h];
    __syncthreads();
    if (rank == 0 && wc == 0 && (lane & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * wr + frag_row(lane, 2 * h);
        if (r_live[h]) {
          const float db = dbp[h] + sp[rl];
          if constexpr (SPLIT)
            static_cast<float*>(a.out2)[r0 + rl] = db;
          else {
            const uint32_t two = pack2<T>(db, 0.0f);   // db in the low half
            static_cast<T*>(a.out2)[r0 + rl] =
                *reinterpret_cast<const T*>(&two);
          }
        }
      }
  }
}

__device__ __forceinline__ int cluster_tile(const XentArgs& a) {
  return (int)blockIdx.x / ((a.H + kHS - 1) / kHS);
}

// T, SPLIT: bf16, true (the f32 form); bf16 or f16, false (2-byte)
template <class T, bool SPLIT>
__global__ void __launch_bounds__(kXT, 1)
xent_fwd_mma(const __grid_constant__ XentArgs a) {
  xent_body<kFwd, T, SPLIT>(a, cluster_tile(a));
}

// the backward's two passes in one launch: the first clusters take dh's
// row tiles, the rest dW's vocab tiles, so that the last wave of one pass
// shares the card with the other's
template <class T, bool SPLIT>
__global__ void __launch_bounds__(kXT, 1)
xent_bwd_mma(const __grid_constant__ XentArgs dh,
             const __grid_constant__ XentArgs dw) {
  const int tile = cluster_tile(dh), dh_tiles = (dh.nr + kBM - 1) / kBM;
  if (tile < dh_tiles)
    xent_body<kDh, T, SPLIT>(dh, tile);
  else
    xent_body<kDw, T, SPLIT>(dw, tile - dh_tiles);
}

// h (nh4 float4s) and W (nw4) as bf16 hi and lo into out: hi(h), lo(h),
// hi(W), lo(W), each in the source's layout
__device__ __forceinline__ void split_body(const float4* __restrict__ h,
                                           const float4* __restrict__ w,
                                           uint2* __restrict__ out,
                                           int64_t nh4, int64_t nw4) {
  const int64_t n4 = nh4 + nw4;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool is_h = i < nh4;
    const int64_t j = is_h ? i : i - nh4;
    const float4 v = is_h ? h[j] : w[j];
    uint2* hi = out + (is_h ? j : 2 * nh4 + j);
    uint2* lo = hi + (is_h ? nh4 : nw4);
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    *hi = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                     *reinterpret_cast<const uint32_t*>(&b));
    *lo = make_uint2(pack_bf16(v.x - fa.x, v.y - fa.y),
                     pack_bf16(v.z - fb.x, v.w - fb.y));
  }
}

__global__ void __launch_bounds__(kXT)
xent_split_fwd(const float4* __restrict__ h, const float4* __restrict__ w,
               uint2* __restrict__ out, int64_t nh4, int64_t nw4) {
  split_body(h, w, out, nh4, nw4);
}

__global__ void __launch_bounds__(kXT)
xent_split_bwd(const float4* __restrict__ h, const float4* __restrict__ w,
               uint2* __restrict__ out, int64_t nh4, int64_t nw4) {
  split_body(h, w, out, nh4, nw4);
}

template <typename K>
int launch_split(K kern, const float* h, const float* w, void* scratch,
                 int N, int H, int V, cudaStream_t st) {
  const int64_t nh4 = (int64_t)N * H / 4, nw4 = (int64_t)V * H / 4;
  const int64_t want = (nh4 + nw4 + kXT - 1) / kXT;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  kern<<<blocks, kXT, 0, st>>>(reinterpret_cast<const float4*>(h),
                               reinterpret_cast<const float4*>(w),
                               reinterpret_cast<uint2*>(scratch), nh4, nw4);
  return (int)cudaGetLastError();
}

// grid: ``tiles`` clusters of C = ceil(H / 256) CTAs
template <typename K, typename... Args>
int launch_mma(K kern, size_t smem, int tiles, int H, cudaStream_t st,
               const Args&... args) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int C = (H + kHS - 1) / kHS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * C));
  cfg.blockDim = dim3(kXT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (so the
// library needs no link against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static void* fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
  }
  return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
}

// a (rows, H) bf16 or f16 array read in 64 x 64 boxes with the 128-byte
// swizzle, zeros past its edges
bool box_map(CUtensorMap* map, const void* base, int rows, int H,
             bool half = false) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)H, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)H * 2};
  const cuuint32_t box[2] = {64, 64}, step[2] = {1, 1};
  return encode(map, half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the operands' hi and lo arrays in the scratch, hi(h), lo(h), hi(W),
// lo(W), as the resident and streamed tensor maps
bool operands(XentArgs& a, const void* scratch, int N, int H, int V,
              bool w_resident) {
  const bf16* s = static_cast<const bf16*>(scratch);
  const int64_t nh = (int64_t)N * H, nw = (int64_t)V * H;
  const bf16 *hh = s, *hl = s + nh, *wh = s + 2 * nh, *wl = wh + nw;
  a.nr = w_resident ? V : N;
  a.nx = w_resident ? N : V;
  a.H = H;
  return box_map(&a.rh, w_resident ? wh : hh, a.nr, H) &&
         box_map(&a.rl, w_resident ? wl : hl, a.nr, H) &&
         box_map(&a.xh, w_resident ? hh : wh, a.nx, H) &&
         box_map(&a.xl, w_resident ? hl : wl, a.nx, H);
}

// the 2-byte forms' operands: h and W themselves
template <class T>
bool operands2(XentArgs& a, const T* h, const T* w, int N, int H, int V,
               bool w_resident) {
  const bool half = std::is_same<T, f16>::value;
  a.nr = w_resident ? V : N;
  a.nx = w_resident ? N : V;
  a.H = H;
  return box_map(&a.rh, w_resident ? w : h, a.nr, H, half) &&
         box_map(&a.xh, w_resident ? h : w, a.nx, H, half);
}

// N and V at least 1; H a multiple of 16 from 16 to 1024 (a cluster of
// at most four CTAs of 256 columns)
bool bad_shape(int N, int H, int V) {
  return N < 1 || V < 1 || H < 16 || H % 16 != 0 || H > kMaxC * kHS;
}

template <class T>
int xent_fwd_2byte(const T* h, const T* w, const T* bias,
                   const int32_t* labels, float* lse, float* ll, int N, int H,
                   int V, void* stream) {
  if (bad_shape(N, H, V)) return (int)cudaErrorInvalidValue;
  XentArgs a = {};
  if (!operands2(a, h, w, N, H, V, false)) return (int)cudaErrorInvalidValue;
  a.bias = bias;
  a.labels = labels;
  a.out = lse;
  a.out2 = ll;
  return launch_mma(xent_fwd_mma<T, false>, mma_smem<kFwd>(),
                    (N + kBM - 1) / kBM, H, (cudaStream_t)stream, a);
}

template <class T>
int xent_bwd_2byte(const T* h, const T* w, const T* bias,
                   const int32_t* labels, const float* lse, const float* g,
                   T* dh, T* dw, T* db, int N, int H, int V, void* stream) {
  if (bad_shape(N, H, V)) return (int)cudaErrorInvalidValue;
  XentArgs a = {};
  a.bias = bias;
  a.labels = labels;
  a.lse = lse;
  a.g = g;
  XentArgs b = a;
  if (!operands2(a, h, w, N, H, V, false) ||
      !operands2(b, h, w, N, H, V, true))
    return (int)cudaErrorInvalidValue;
  a.out = dh;
  b.out = dw;
  b.out2 = db;
  return launch_mma(xent_bwd_mma<T, false>, mma_smem<kDh>(),
                    (N + kBM - 1) / kBM + (V + kBM - 1) / kBM, H,
                    (cudaStream_t)stream, a, b);
}

}  // namespace

extern "C" {

// scratch: 2 (N + V) H bf16, overwritten (the operands' hi and lo)
int fused_xent_fwd(const float* h, const float* w, const float* bias,
                   const int32_t* labels, float* lse, float* ll,
                   void* scratch, int N, int H, int V, void* stream) {
  if (bad_shape(N, H, V) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = launch_split(xent_split_fwd, h, w, scratch, N, H, V, st);
  if (e != 0) return e;
  XentArgs a = {};
  if (!operands(a, scratch, N, H, V, false))
    return (int)cudaErrorInvalidValue;
  a.bias = bias;
  a.labels = labels;
  a.out = lse;
  a.out2 = ll;
  return launch_mma(xent_fwd_mma<bf16, true>, mma_smem<kFwd>(),
                    (N + kBM - 1) / kBM, H, st, a);
}

int fused_xent_bwd(const float* h, const float* w, const float* bias,
                   const int32_t* labels, const float* lse, const float* g,
                   float* dh, float* dw, float* db, void* scratch, int N,
                   int H, int V, void* stream) {
  if (bad_shape(N, H, V) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = launch_split(xent_split_bwd, h, w, scratch, N, H, V, st);
  if (e != 0) return e;
  XentArgs a = {};
  a.bias = bias;
  a.labels = labels;
  a.lse = lse;
  a.g = g;
  XentArgs b = a;
  if (!operands(a, scratch, N, H, V, false) ||
      !operands(b, scratch, N, H, V, true))
    return (int)cudaErrorInvalidValue;
  a.out = dh;
  b.out = dw;
  b.out2 = db;
  return launch_mma(xent_bwd_mma<bf16, true>, mma_smem<kDh>(),
                    (N + kBM - 1) / kBM + (V + kBM - 1) / kBM, H, st, a, b);
}

// The 2-byte forms: h (N, H), w (V, H), bias (V,) and dh, dw, db of one
// type (bf16 or f16), 16-byte aligned; lse, ll, g f32. No scratch.
#define XENT_2BYTE(SUFFIX, T)                                                 \
  int fused_xent_fwd_##SUFFIX(const T* h, const T* w, const T* bias,          \
                              const int32_t* labels, float* lse, float* ll,   \
                              int N, int H, int V, void* stream) {            \
    return xent_fwd_2byte<T>(h, w, bias, labels, lse, ll, N, H, V, stream);   \
  }                                                                           \
  int fused_xent_bwd_##SUFFIX(const T* h, const T* w, const T* bias,          \
                              const int32_t* labels, const float* lse,        \
                              const float* g, T* dh, T* dw, T* db, int N,     \
                              int H, int V, void* stream) {                   \
    return xent_bwd_2byte<T>(h, w, bias, labels, lse, g, dh, dw, db, N, H, V, \
                             stream);                                         \
  }
XENT_2BYTE(bf16, bf16)
XENT_2BYTE(f16, f16)
#undef XENT_2BYTE

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
