// Fused linear + vocabulary cross-entropy for Hopper (sm_90a), on the
// tensor cores: forward (per-row lse and label logit) and backward (dh;
// dW and db), with the logits h W^T + b never written to device memory.
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas/fused_xent.py:
// _fwd_call (_fwd_kernel) and _bwd_call (_bwd_dh_kernel,
// _bwd_dw_kernel).
//
// Two forms with a design each.
//
// The 2-byte forms (xent_fwd_ws, xent_bwd_ws; T = bf16 or f16): bf16 or
// f16 h, W and bias, which the O2 autocast hands the MLM head (the TPU
// kernel upcasts each tile to f32, fused_xent.py:98-167, and returns dh,
// dW, db in the inputs' types, :256, :302). TMA reads h and W as they
// are; each product is ONE wgmma term (bf16.bf16 or f16.f16) with f32
// accumulation, exact products for S = h W^T. lse and the label logit
// are f32; dh, dW and db are rounded to T once, from f32 accumulators.
//
// Bound: operations, one term a product at 989 TFLOP/s. At BERT's MLM
// head (N = 16384 rows, H = 768, V = 30592) the forward forms S once
// (2 N H V = 7.7e11 flop, 0.778 ms); the backward forms S again for dh
// and again for dW, beside dh = P' W and dW = P'^T h: four products,
// 3.114 ms (2.335 ms for the three that one shared S would need; keeping
// it needs dh's and dW's accumulators at once, or P' in device memory).
//
// Both are CTAs of 256 threads: two warpgroups, eight warps, two on each
// of the SM's four register files, so that a thread may hold 255
// registers (a producer warp beside them would leave three warps on one
// file and 168 registers each, and spill the accumulators). Thread 0
// also issues the TMA copies; a ring stage's full mbarrier completes on
// its bytes, its empty mbarrier on one arrival from each of the eight
// warps, and thread 0 refills it once both warpgroups are done with it.
//
// Forward (xent_fwd_ws). H is only the contraction: no cluster, no
// exchange. A CTA takes 128 h rows against 256-row W tiles, streamed as
// 64-column chunks of both through a four-stage ring (48 KB a stage);
// each tile's bias comes by a 1-D TMA box with its first chunk into an
// eight-slot ring of its own. Each warpgroup owns 64 rows and one
// m64n256 accumulator; a tile's chunks run with one wgmma group in
// flight behind the next, and the online max / sum / label-logit
// epilogue runs after the tile's last chunk (two m64n128 accumulators,
// one tile's epilogue over the next tile's products, lost their overlap
// to waits that ptxas inserts before the epilogue). The grid is the row
// tiles alone (128 CTAs, one wave, at BERT's head), each CTA writing
// its rows' lse and label logit; every CTA walks the vocabulary in the
// same order, so a W tile comes from device memory once and from L2 for
// the others.
//
// Backward (xent_bwd_ws<T, C>, one launch: dh's row tiles, then dW's
// vocab tiles). dh (N x H) and dW (V x H) have H as an output axis, so
// their f32 accumulators are split over H: a thread-block cluster of C =
// ceil(H / 256) CTAs (3 at H = 768, a template parameter, so that group
// ownership and every slot offset are constants), CTA c owning columns
// 256 c .. of the resident operand R (dh: R = h, X = W; dW: R = W, X =
// h), of the streamed X tiles and of the output. A CTA holds 128 R rows
// (64 a warpgroup, whose 64 x 256 f32 accumulator is its registers) and
// streams 64-row X tiles through a three-stage ring with each tile's
// column values (1-D TMA boxes of the bias, or of lse, g and labels).
// Step t of a warpgroup:
//   a. S(t + 1) = R X(t + 1)^T over this CTA's 256 columns is issued
//      (16 m64n64k16 wgmma) behind P'X(t - 1); once P'X(t - 1) is done
//      its X stage goes back, and thread 0 refills it with X(t + 2);
//   b. the partial S sums of step t for the groups this CTA owns (groups
//      of 8 columns, owned in runs: rank r owns groups ceil(8 r / C) ..
//      ceil(8 (r + 1) / C) - 1) are in its slots; it
//      adds the C partials in rank order, forms P' there (the
//      exponentials computed once in the cluster) and pushes P' to every
//      peer's P' slot;
//   c. P'(t) is whole: its four k16 fragments are loaded as the wgmma A
//      operand, into registers;
//   d. S(t + 1) done: its partials for other ranks' groups are pushed to
//      their owners' slots;
//   e. P'X(t) is issued into the accumulator (4 m64n256k16, A from
//      registers, X MN-major), left running into step t + 1.
// The exchange is st.async into the receiver's shared memory, each store
// completing its bytes on the receiver's mbarrier, which the receiver
// arms (expect_tx) and waits on: no cluster barrier inside the loop.
// Each thread exchanges only with the threads of its index in its peers
// (the same fragment positions), so nothing crosses threads within a
// CTA, and each warp has a barrier of each kind to itself. One slot of
// each kind suffices, since the chain of sends orders every overwrite
// after the read: a peer sends partial(t + 1) only after it has received
// this CTA's P'(t), sent after this CTA read partial(t); it sends P'(t +
// 1) only after receiving this CTA's partial(t + 1), sent after this CTA
// loaded P'(t). Both kinds of slot fit beside R and the ring in 227 KB,
// and nothing more does: a second slot of either kind (to let the exchange
// run a step ahead) or a fourth X stage would not.
// P' is rounded to T once, after a power-of-two scaling into f16's
// normal range: dh's rows take P' = (exp(S + b - lse) - onehot) 2^14
// and the row's g 2^-14 multiplies the accumulator at the end; dW's
// take P' = P g 2^(14 - e), 2^e the largest |g| of the launch rounded
// down to a power of two, and the accumulator is multiplied by 2^(e -
// 14). So |P'| < 2^15 and a softmax term down to 2^-28 of the largest g
// is an f16 normal (unlifted, P ~ 1/V = 3e-5 at BERT's vocabulary would
// round as an f16 subnormal). P'X accumulates in the wgmma accumulator
// (2-byte outputs: its truncation, ~1e-4 of the largest value over 1900
// k16 steps, is far below the type's unit). db adds the f32 P g, per row
// over the quad, then the cluster's ranks in order.
//
// The f32 form (xent_fwd_mma, xent_bwd_mma and the split pass): f32
// inputs; every product is three bf16 wgmma terms with f32 accumulation,
// hi*hi + hi*lo + lo*hi, where hi is the bf16 rounding of an f32 value x
// and lo the bf16 rounding of x - hi (16 significant bits together; the
// lo*lo term is dropped). One bf16 term a product misses the card check's
// bound (1e-4 of the largest value) at BERT's head; three terms meet it
// (tests/test_torch_xent_rounding.py models where these kernels round).
// dh and dW add each 64-row step's product into their accumulators with
// f32 adds: the tensor cores' own accumulation does not round to nearest,
// and 1900 k16 steps into one accumulator moved dh past the bound. Bound:
// at three bf16 terms a product the tensor cores give 989 / 3 TFLOP/s:
// 2.33 ms for the forward, 9.34 ms for the backward's four products.
// - A split pass (xent_split_fwd / xent_split_bwd, one body, named by the
//   pass it serves) writes h and W as bf16 hi and lo arrays into scratch
//   the caller allocates, 2 (N + V) H bf16, once an entry point.
// - One kernel body for the three passes. A CTA keeps 64 rows of R in
//   shared memory and streams 64-row tiles of X through two stages
//   filled by TMA. Each step forms the 64 x 64 tile S = R X^T (wgmma,
//   K-major operands), then
//   forward (xent_fwd_mma): folds S + b into an online max, sum of
//     exponentials and label logit a row;
//   backward (xent_bwd_mma, one launch: dh's row tiles, then dW's vocab
//     tiles): P' = (exp(S + b - lse) - onehot) g in f32 (db sums it),
//     stored as hi + lo, and out += P' X (wgmma, X MN-major) with the X
//     tile already in shared memory.
// - H is split over a cluster of C = ceil(H / 256) CTAs as above; each
//   forms a partial S over its columns, and every CTA sums the C
//   partials through distributed shared memory in rank order behind
//   cluster barriers, so all of them hold the same S. The forward's
//   online state is kept by one CTA a 16-row strip.
//
// No float atomics in either form: each output element has one writer,
// partial sums are merged in a fixed order, and two launches give the
// same bits. Rows past N and vocab rows past V are masked in the kernels
// (the JAX wrapper pads rows to a multiple of 256 instead). Ignored rows
// come in with label -1 and g = 0.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kXT = 256;                     // threads a block (f32 form)
constexpr int kBM = 64;                      // resident rows a CTA (f32)
constexpr int kBN = 64;                      // streamed rows a step
constexpr int kLiftExp = 14;                 // the 2-byte forms' P' lift
constexpr int kHS = 256;                     // H columns a CTA owns
constexpr int kMaxC = 4;                     // CTAs a cluster: H <= 1024
constexpr uint32_t kRB = kBM * kHS * 2;      // one bf16 R slice (hi or lo)
constexpr uint32_t kXB = kBN * kHS * 2;      // one bf16 X slice (hi or lo)
constexpr uint32_t kSB = kXT * 4 * 16;       // the partial S: 4 float4 a thread
constexpr uint32_t kPB = kBM * kBN * 2;      // one bf16 P' tile (hi or lo)
constexpr uint32_t kCB = 3 * kBN * 4;        // a stage's column values

// the 2-byte forms: two warpgroups, 8 warps, two on each of the SM's four
// register files, so each thread may hold 255 registers (a ninth warp
// would leave three on one file: 168)
constexpr int kWsThreads = 256;
constexpr int kFwdRows = 128;                // h rows a CTA
constexpr int kFwdCols = 256;                // vocabulary rows a tile
constexpr int kFwdStages = 4;
constexpr uint32_t kFwdStage = 49152;        // h chunk 128 x 64, W 256 x 64
// a tile's bias (256 T) a slot; tile j + 8's bias is loaded only after
// chunk (j + 8) kc - 4 is done, well after tile j's epilogue even at one
// chunk a tile
constexpr int kFwdBiasSlots = 8;
constexpr uint32_t kFwdBiasOff = kFwdStages * kFwdStage;
constexpr uint32_t kFwdSmem =
    kFwdBiasOff + kFwdBiasSlots * 512 + 2 * kFwdStages * 8;
constexpr int kBwdRows = 128;                // R rows a CTA
constexpr int kBwdStages = 3;
constexpr uint32_t kBwdX = kBN * kHS * 2;            // an X stage, 32 KB
constexpr uint32_t kBwdXOff = kBwdRows * kHS * 2;    // after R, 64 KB
constexpr uint32_t kBwdPart = 18432;         // a warpgroup's partial slots
constexpr uint32_t kBwdPartOff = kBwdXOff + kBwdStages * kBwdX;
constexpr uint32_t kBwdPP = 8192;            // a warpgroup's P' slot
constexpr uint32_t kBwdPPOff = kBwdPartOff + 2 * kBwdPart;
constexpr uint32_t kBwdColsOff = kBwdPPOff + 2 * kBwdPP;
constexpr uint32_t kBwdRedOff = kBwdColsOff + kBwdStages * kCB;
constexpr uint32_t kBwdBarOff = kBwdRedOff + 576;
constexpr uint32_t kBwdSmem = kBwdBarOff + 23 * 8;
// a wait this long on one mbarrier is a hang: trap instead of holding
// the card
constexpr uint64_t kHangNs = 10000000000ull;

enum { kFwd = 0, kDh = 1, kDw = 2 };

struct XentArgs {
  CUtensorMap rh, rl;       // resident operand, hi and lo: (nr, H)
  CUtensorMap xh, xl;       // streamed operand, hi and lo: (nx, H)
  const float* bias;        // (V,)
  const int32_t* labels;    // (N,), -1 matches no class
  const float* lse;         // (N,), backward
  const float* g;           // (N,), backward
  float* out;               // lse (N,), dh (N, H) or dW (V, H)
  float* out2;              // the label logit (N,) or db (V,)
  int nr, nx, H;
};

__device__ __forceinline__ float elem_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float elem_f32(f16 x) { return __half2float(x); }

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

// two packed T values as f32
template <class T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (std::is_same<T, f16>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

template <int MODE>
constexpr size_t mma_smem() {      // tiles, column values, 3 mbarriers
  return (size_t)2 * kRB + 4 * kXB + kSB + (MODE == kFwd ? 0 : 2 * kPB) +
         2 * kCB + 3 * 8;
}

// Operand tiles for wgmma: a [rows][64] bf16 block is 128-byte rows
// whose 16-byte chunks are XORed with row % 8: the 128-byte swizzle of
// the TMA boxes that write them and of the wgmma descriptors that read
// them, K-major for S = R X^T (rows R or X, 64 columns of H a block) and
// MN-major for P' X (rows the k of the product, 64 columns of H a block).

// mbarriers: ``count`` arrivals (the f32 form: one, the thread that
// starts the copies) plus the bytes the copies bring (expect_tx)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// one try of a phase wait; CLUSTER: acquire at cluster scope, for bytes
// that peers' st.async completed on this CTA's barrier
template <bool CLUSTER>
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  if constexpr (CLUSTER)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// the 2-byte kernels' phase wait: a wait past kHangNs traps (a launch
// failure the wrapper reports) rather than hanging the card
template <bool CLUSTER = false>
__device__ __forceinline__ void ws_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try<CLUSTER>(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try<CLUSTER>(bar, parity))
    if (global_ns() - t0 > kHangNs) __trap();
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

// a box of a 1-D tensor map into shared memory (zeros past its end)
__device__ __forceinline__ void tma_row(uint32_t dst, const CUtensorMap* map,
                                        int c0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}

// a store into a peer's shared memory (``addr`` and ``bar`` mapped into
// the cluster window) whose bytes complete on the peer's mbarrier
__device__ __forceinline__ void st_async4(uint32_t addr, float4 v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async4u(uint32_t addr, uint4 v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async2(uint32_t addr, uint32_t x0,
                                          uint32_t x1, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "r"(x0), "r"(x1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr) : "memory");
  return x;
}

// this CTA's shared memory at a shared-window address
__device__ __forceinline__ void st_shared4(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_shared2(uint32_t addr, uint32_t x0,
                                           uint32_t x1) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(x0),
               "r"(x1)
               : "memory");
}

__device__ __forceinline__ void st_shared4u(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// rows r0 .. r0 + 63 and this CTA's columns k0 .. k0 + ks - 1 of the hi
// and lo arrays into a tile pair at dst, completing on bar. The blocks
// past ks are not copied: S reads none of them, and what P' X makes of
// them lands in out columns past ks, which are not stored.
__device__ __forceinline__ void tma_slices(uint32_t dst, const CUtensorMap* hi,
                                           const CUtensorMap* lo, int r0,
                                           int k0, int ks, uint32_t bar) {
  const int nb = (ks + 63) / 64;
  mbar_expect(bar, (uint32_t)(2 * nb * kBM * 128));
  for (int b = 0; b < nb; ++b) {
    tma_box(dst + b * (kBM * 128), hi, k0 + 64 * b, r0, bar);
    tma_box(dst + kRB + b * (kBM * 128), lo, k0 + 64 * b, r0, bar);
  }
}

// This thread's word of the column values of streamed rows x0 .. x0 + 63,
// [3][64] words a stage: the bias (forward, dh), or lse, g and the label
// (dW); 0 past nx. Loaded into a register first, stored after the loads'
// latency has passed.
template <int MODE>
__device__ __forceinline__ uint32_t cols_load(const XentArgs& a, int x0) {
  const int t = threadIdx.x, arr = t / kBN, j = x0 + t % kBN;
  if (t >= (MODE == kDw ? 3 : 1) * kBN || j >= a.nx) return 0u;
  if (MODE != kDw) return __float_as_uint(a.bias[j]);
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
// columns) += A (64 x 16) B (16 x N), B from shared memory through a
// descriptor (start address, leading and stride byte offsets in 16-byte
// units, 128-byte swizzle), A from shared memory the same way or from
// registers (the m16n8k16 A fragment of the warp's 16 rows).
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

// wait until at most N of this warpgroup's committed groups are pending
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

#define XENT_D8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 32) += A B^T, A and B K-major, bf16 (the f32 form's terms)
__device__ __forceinline__ void wg_n32(float (&d)[16], uint64_t a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : XENT_D8(0), XENT_D8(8)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128) += A B, A K-major, B MN-major (transposed), bf16
__device__ __forceinline__ void wg_n128t(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 1;\n}\n"
      : XENT_D8(0), XENT_D8(8), XENT_D8(16), XENT_D8(24), XENT_D8(32),
        XENT_D8(40), XENT_D8(48), XENT_D8(56)
      : "l"(a), "l"(b), "r"(1));
}

// The 2-byte forms' products, T bf16 or f16; ``scale`` 0 overwrites d.
// d (64 x 64) (+)= A B^T, A and B K-major from shared memory
#define XENT_SS64(TY)                                                         \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"                    \
      : XENT_D8(0), XENT_D8(8), XENT_D8(16), XENT_D8(24)                      \
      : "l"(a), "l"(b), "r"(scale))

template <class T>
__device__ __forceinline__ void wg_ss64(float (&d)[32], uint64_t a,
                                        uint64_t b, int scale) {
  if constexpr (std::is_same<T, f16>::value)
    XENT_SS64("f16");
  else
    XENT_SS64("bf16");
}
#undef XENT_SS64

// The first k16 step of a fresh product: d = A B^T, d's old values not
// read (write-only operands), so they are dead while the product runs
#define XENT_D8W(i)                                                 \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),       \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
#define XENT_SS64_0(TY)                                                       \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"                    \
      : XENT_D8W(0), XENT_D8W(8), XENT_D8W(16), XENT_D8W(24)                  \
      : "l"(a), "l"(b), "r"(0))

template <class T>
__device__ __forceinline__ void wg_ss64_0(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  if constexpr (std::is_same<T, f16>::value)
    XENT_SS64_0("f16");
  else
    XENT_SS64_0("bf16");
}
#undef XENT_SS64_0

// d (64 x 256) (+)= A B^T, A and B K-major from shared memory; the _0
// form overwrites d (write-only operands)
#define XENT_SS256(TY, OUTS, SCALE)                                           \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "     \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "     \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "     \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "    \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "    \
      "%127}, %128, %129, p, 1, 1, 0, 0;\n}\n"                                \
      : OUTS                                                                  \
      : "l"(a), "l"(b), "r"(SCALE))
#define XENT_OUTS_RW                                                          \
  XENT_D8(0), XENT_D8(8), XENT_D8(16), XENT_D8(24), XENT_D8(32), XENT_D8(40), \
      XENT_D8(48), XENT_D8(56), XENT_D8(64), XENT_D8(72), XENT_D8(80),        \
      XENT_D8(88), XENT_D8(96), XENT_D8(104), XENT_D8(112), XENT_D8(120)
#define XENT_OUTS_W                                                           \
  XENT_D8W(0), XENT_D8W(8), XENT_D8W(16), XENT_D8W(24), XENT_D8W(32),         \
      XENT_D8W(40), XENT_D8W(48), XENT_D8W(56), XENT_D8W(64), XENT_D8W(72),   \
      XENT_D8W(80), XENT_D8W(88), XENT_D8W(96), XENT_D8W(104),                \
      XENT_D8W(112), XENT_D8W(120)

template <class T>
__device__ __forceinline__ void wg_ss256(float (&d)[128], uint64_t a,
                                         uint64_t b) {
  if constexpr (std::is_same<T, f16>::value)
    XENT_SS256("f16", XENT_OUTS_RW, 1);
  else
    XENT_SS256("bf16", XENT_OUTS_RW, 1);
}

template <class T>
__device__ __forceinline__ void wg_ss256_0(float (&d)[128], uint64_t a,
                                           uint64_t b) {
  if constexpr (std::is_same<T, f16>::value)
    XENT_SS256("f16", XENT_OUTS_W, 0);
  else
    XENT_SS256("bf16", XENT_OUTS_W, 0);
}
#undef XENT_SS256
#undef XENT_OUTS_RW
#undef XENT_OUTS_W
#undef XENT_D8W

// d (64 x 256) += A B, A from registers (the k16 fragment: rows g and
// g + 8, columns 2 t and 2 t + 8 of the warp's 16 rows, two T a
// register), B MN-major (transposed) from shared memory
#define XENT_RS256T(TY)                                                       \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "     \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "     \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "     \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "    \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "    \
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"               \
      : XENT_D8(0), XENT_D8(8), XENT_D8(16), XENT_D8(24), XENT_D8(32),        \
        XENT_D8(40), XENT_D8(48), XENT_D8(56), XENT_D8(64), XENT_D8(72),      \
        XENT_D8(80), XENT_D8(88), XENT_D8(96), XENT_D8(104), XENT_D8(112),    \
        XENT_D8(120)                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <class T>
__device__ __forceinline__ void wg_rs256t(float (&d)[128],
                                          const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same<T, f16>::value)
    XENT_RS256T("f16");
  else
    XENT_RS256T("bf16");
}
#undef XENT_RS256T
#undef XENT_D8

// ===========================================================================
// The f32 form
// ===========================================================================

// The CTA's partial S over its ks columns of H: warpgroup g forms columns
// 32 g .. 32 g + 31 of R X^T (all 64 rows), as hi hi + hi lo + lo hi each
// k16 step; s[i][e] = d[4 i + e] in the m16n8 C layout of the warp's rows.
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
    wg_n32(d, rh, xh);
    wg_n32(d, rh, xl);
    wg_n32(d, rl, xh);
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
// bound on the card.
__device__ __forceinline__ void product(float (&acc)[64], uint32_t Ps,
                                        uint32_t Xh, int g) {
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
    wg_n128t(part, ph, xh);
    wg_n128t(part, ph, xl);
    wg_n128t(part, pl, xh);
  }
  wg_commit();
  wg_wait();
  fence_operands(part);
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] += part[j];
}

// The three passes. Warpgroup g = w / 4 forms columns 32 g .. of the S
// tile and columns 128 g .. of the out slice; warp wr = w % 4 of a group
// holds rows 16 wr .. of both (thread rows 16 wr + lane / 4 + 8 h).
template <int MODE>
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
    r_b[h] = MODE == kDw && r_live[h] ? a.bias[row] : 0.0f;
  }

  // mbarriers: R at Bar, X stage s at Bar + 8 (1 + s)
  if (tid == 0) {
    mbar_init(Bar);
    mbar_init(Bar + 8);
    mbar_init(Bar + 16);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cols_store(cw, 0, cols_load<MODE>(a, 0));
  __syncthreads();
  if (tid == 0) {
    tma_slices(Rh, &a.rh, &a.rl, r0, k0, ks, Bar);
    tma_slices(Xs, &a.xh, &a.xl, 0, k0, ks, Bar + 8);
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
    partial_s(s, Rh, Rh + kRB, Xh, Xl, ks, wc);
    if (t > 0) cluster_wait();      // B of t - 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(sp + (i * kXT + tid) * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    cluster_arrive_shared_release();  // A of t
    const uint32_t next_cols =
        t + 1 < nsteps ? cols_load<MODE>(a, (t + 1) * kBN) : 0u;
    cluster_wait();
    if (tid == 0 && t + 1 < nsteps)   // stage st ^ 1 is free since step t - 1
      tma_slices(Xs + 2 * (st ^ 1) * kXB, &a.xh, &a.xl, (t + 1) * kBN, k0,
                 ks, Bar + 8 * (2 - st));

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
              p *= r_g[h];
            } else {
              const int v = r0 + 16 * wr + frag_row(lane, e);
              p = exp2_ftz((s[i][e] + r_b[h] - cv[cl]) * kLog2e);
              if (clab[cl] == v) p -= 1.0f;
              p *= cv[kBN + cl];
            }
            if (!r_live[h] || col >= a.nx) p = 0.0f;
            if constexpr (MODE == kDw) dbp[h] += p;
            s[i][e] = p;
          }
        store_p(pp, s, wr, wc, lane);
      }
    }
    cols_store(cw, st ^ 1, next_cols);
    // B of t: the values read are in registers already, so no release is
    // needed to keep this CTA's reads ahead of the next partial's writes
    cluster_arrive_relaxed();

    if constexpr (MODE != kFwd) {
      fence_async_smem();
      __syncthreads();     // P' is whole
      if (128 * wc < ks) product(acc, Ps, Xh, wc);
    }
    __syncthreads();       // the stage and P' are rewritten next
  }
  cluster_wait();          // B of the last step: exit is safe

  if constexpr (MODE != kFwd) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 16 * wr + frag_row(lane, 2 * half);
      if (row >= a.nr) continue;
      const int64_t base = (int64_t)row * a.H + k0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * wc + frag_col(lane, j, 0);
        if (col >= ks) continue;
        *reinterpret_cast<float2*>(a.out + base + col) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
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
          a.out[r0 + rl] = m[h] + logf(fmaxf(l[h], 1e-30f));
          a.out2[r0 + rl] = ll[h] + q[2];
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
        if (r_live[h]) a.out2[r0 + rl] = dbp[h] + sp[rl];
      }
  }
}

__device__ __forceinline__ int cluster_tile(const XentArgs& a) {
  return (int)blockIdx.x / ((a.H + kHS - 1) / kHS);
}

__global__ void __launch_bounds__(kXT, 1)
xent_fwd_mma(const __grid_constant__ XentArgs a) {
  xent_body<kFwd>(a, cluster_tile(a));
}

// the backward's two passes in one launch: the first clusters take dh's
// row tiles, the rest dW's vocab tiles, so that the last wave of one pass
// shares the card with the other's
__global__ void __launch_bounds__(kXT, 1)
xent_bwd_mma(const __grid_constant__ XentArgs dh,
             const __grid_constant__ XentArgs dw) {
  const int tile = cluster_tile(dh), dh_tiles = (dh.nr + kBM - 1) / kBM;
  if (tile < dh_tiles)
    xent_body<kDh>(dh, tile);
  else
    xent_body<kDw>(dw, tile - dh_tiles);
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

// ===========================================================================
// The 2-byte forms
// ===========================================================================

struct FwdArgs {
  CUtensorMap h, w;          // (N, H), (V, H): 64 x 64 boxes
  CUtensorMap b;             // the bias (V,), a tile's kFwdCols a box
  const void* bias;          // (V,) T
  const int32_t* labels;     // (N,), -1 matches no class
  float* lse;                // (N,)
  float* ll;                 // (N,)
  int N, V, H;
};

// The online max / sum / label logit of a thread's two rows over a
// finished 64 x 256 tile (vocabulary rows v0 .., the bias at ``bslot``):
// the thread's 64 values a row, max first, then the sum of exponentials
// in column order
template <class T>
__device__ __forceinline__ void fwd_epilogue(const FwdArgs& a,
                                             const float (&acc)[128], int v0,
                                             uint32_t bslot, int lane,
                                             const int (&lab)[2],
                                             float (&m)[2], float (&l)[2],
                                             float (&ll)[2]) {
  const int c0 = v0 + 2 * (lane & 3);
  const uint32_t b0 = bslot + (uint32_t)(4 * (lane & 3));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 b = unpack2<T>(ld_shared_u32(b0 + 16 * i));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * i + e;
        const float v = col < a.V ? acc[4 * i + 2 * h + e] + (e ? b.y : b.x)
                                  : -INFINITY;
        if (col < a.V && col == lab[h]) ll[h] += v;
        mx = fmaxf(mx, v);
      }
    }
    const float mn = fmaxf(m[h], mx);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 b = unpack2<T>(ld_shared_u32(b0 + 16 * i));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = c0 + 8 * i + e < a.V
                            ? acc[4 * i + 2 * h + e] + (e ? b.y : b.x)
                            : -INFINITY;
        sum += exp2_ftz((v - mn) * kLog2e);
      }
    }
    l[h] = l[h] * exp2_ftz((m[h] - mn) * kLog2e) + sum;
    m[h] = mn;
  }
}

// The forward's pipeline state: the ring, the CTA's first row, the
// chunks a tile (``kc``), the chunk groups issued (``it``) and the chunk
// count (``total``)
struct FwdPipe {
  uint32_t ring, full, empty;
  int r0, kc, total, it;
};

// chunk q (vocabulary tile q / kc, columns 64 (q % kc) ..) of h and W
// into its stage, the tile's bias with its first chunk (thread 0)
__device__ __forceinline__ void fwd_load(const FwdArgs& a, const FwdPipe& p,
                                         int q) {
  const int s = q % kFwdStages, j = q / p.kc, k = q - j * p.kc;
  const uint32_t stg = p.ring + s * kFwdStage, bar = p.full + 8 * s;
  const int v0 = j * kFwdCols;
  mbar_expect(bar, kFwdStage + (k == 0 ? 512 : 0));
  if (k == 0)
    tma_row(p.ring + kFwdBiasOff + (j % kFwdBiasSlots) * 512, &a.b, v0, bar);
  tma_box(stg, &a.h, 64 * k, p.r0, bar);
  tma_box(stg + 8192, &a.h, 64 * k, p.r0 + 64, bar);
#pragma unroll
  for (int b = 0; b < 4; ++b)
    tma_box(stg + 16384 + 8192 * b, &a.w, 64 * k, v0 + 64 * b, bar);
}

// the stage of chunk q back (one arrival a warp); thread 0 refills it
// with chunk q + kFwdStages once every warp is done with it
__device__ __forceinline__ void fwd_release(const FwdArgs& a,
                                            const FwdPipe& p, int q,
                                            int tid) {
  const uint32_t bar = p.empty + 8 * (q % kFwdStages);
  if ((tid & 31) == 0) mbar_arrive(bar);
  if (tid == 0 && q + kFwdStages < p.total) {
    ws_wait(bar, (uint32_t)(q / kFwdStages) & 1u);
    fwd_load(a, p, q + kFwdStages);
  }
  __syncwarp();
}

// One chunk's four k16 products into ``acc`` (FRESH: the first
// overwrites it)
template <class T, bool FRESH>
__device__ __forceinline__ void fwd_chunk(FwdPipe& p, float (&acc)[128],
                                          int g) {
  const int s = p.it % kFwdStages;
  ws_wait(p.full + 8 * s, (uint32_t)(p.it / kFwdStages) & 1u);
  const uint32_t stg = p.ring + s * kFwdStage;
  wg_fence();
  if constexpr (FRESH)
    wg_ss256_0<T>(acc, wg_desc(stg + g * 8192, 16, 1024),
                  wg_desc(stg + 16384, 16, 1024));
  else
    wg_ss256<T>(acc, wg_desc(stg + g * 8192, 16, 1024),
                wg_desc(stg + 16384, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    wg_ss256<T>(acc, wg_desc(stg + g * 8192 + 32 * kk, 16, 1024),
                wg_desc(stg + 16384 + 32 * kk, 16, 1024));
  wg_commit();
  ++p.it;
}

// grid: row tiles; 256 threads, two warpgroups of 64 rows each;
// thread 0 also keeps the TMA ring filled. A tile's chunks go into the
// accumulator one group in flight behind the next; its epilogue follows
// the last.
template <class T>
__global__ void __launch_bounds__(kWsThreads, 1)
xent_fwd_ws(const __grid_constant__ FwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_f[];
  const int tid = threadIdx.x;
  FwdPipe p;
  p.ring = smem_u32(smem_f);
  p.full = p.ring + kFwdBiasOff + kFwdBiasSlots * 512;
  p.empty = p.full + 8 * kFwdStages;
  p.r0 = blockIdx.x * kFwdRows;
  const int nvt = (a.V + kFwdCols - 1) / kFwdCols;
  p.kc = (a.H + 63) / 64;
  p.total = nvt * p.kc;
  p.it = 0;
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(p.full + 8 * s, 1);
      mbar_init(p.empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < kFwdStages && q < p.total; ++q) fwd_load(a, p, q);
  }
  __syncthreads();
  const int g = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  int lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = p.r0 + 64 * g + 16 * w + frag_row(lane, 2 * h);
    lab[h] = row < a.N ? a.labels[row] : -1;
  }
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.0f, 0.0f},
        ll[2] = {0.0f, 0.0f};
  float acc[128];
  for (int j = 0; j < nvt; ++j) {
    fwd_chunk<T, true>(p, acc, g);
    for (int k = 1; k < p.kc; ++k) {
      fwd_chunk<T, false>(p, acc, g);
      wg_wait<1>();
      fwd_release(a, p, p.it - 2, tid);
    }
    wg_wait<0>();
    fwd_release(a, p, p.it - 1, tid);
    fwd_epilogue<T>(a, acc, j * kFwdCols,
                    p.ring + kFwdBiasOff + (j % kFwdBiasSlots) * 512, lane,
                    lab, m, l, ll);
  }
  // a row's four threads (a quad): xor 1, then xor 2
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[h], o);
      ll[h] += __shfl_xor_sync(0xffffffffu, ll[h], o);
      lse_merge(m[h], l[h], mo, lo);
    }
  if ((lane & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = p.r0 + 64 * g + 16 * w + frag_row(lane, 2 * h);
      if (row >= a.N) continue;
      a.lse[row] = m[h] + logf(fmaxf(l[h], 1e-30f));
      a.ll[row] = ll[h];
    }
}

struct BwdArgs {
  CUtensorMap r, x;          // resident (nr, H), streamed (nx, H): 64 x 64
  CUtensorMap cols[3];       // per streamed row, 64 a box: the bias (dh);
                             // lse, g and the label (dW)
  const void* bias;          // (V,) T
  const int32_t* labels;     // (N,), -1 matches no class
  const float* lse;          // (N,)
  const float* g;            // (N,)
  void* out;                 // dh (N, H) or dW (V, H), T
  void* out2;                // db (V,) T (the dW pass)
  int nr, nx, H;
};

// The backward's CTA-wide constants: its shared-memory layout (``part``
// and ``pp`` the thread's 16 bytes in its warpgroup's partial slots and
// P' slot), its cluster rank and tile, the step count, the pass
struct BwdCtx {
  uint32_t base, Xs, fullb, emptyb, pbar, qbar, part, pp;
  int rank, G, r0, k0, ks, nsteps, tid;
  bool dwp;
};

// The groups of 8 columns of an S tile are owned in runs: rank r of a
// cluster of C owns groups first_group(r) .. first_group(r + 1) - 1, so
// that an owner's P' halves pair into 16-byte stores; group i's owner
// is i C / 8.
__host__ __device__ constexpr int first_group(int r, int C) {
  return (8 * r + C - 1) / C;
}

__host__ __device__ constexpr int groups_of(int r, int C) {
  return first_group(r + 1, C) - first_group(r, C);
}

// X tile x (streamed rows 64 x ..) of this CTA's 256 columns and its
// column values into stage x % kBwdStages (thread 0)
__device__ __forceinline__ void bwd_load(const BwdArgs& a, const BwdCtx& c,
                                         int x) {
  const int s = x % kBwdStages;
  const uint32_t bar = c.fullb + 8 * s;
  const uint32_t cols = c.base + kBwdColsOff + s * kCB;
  mbar_expect(bar, kBwdX + (c.dwp ? 3 * 256 : 128));
  for (int b = 0; b < 4; ++b)
    tma_box(c.Xs + s * kBwdX + b * 8192, &a.x, c.k0 + 64 * b, x * kBN, bar);
  tma_row(cols, &a.cols[0], x * kBN, bar);
  if (c.dwp) {
    tma_row(cols + 256, &a.cols[1], x * kBN, bar);
    tma_row(cols + 512, &a.cols[2], x * kBN, bar);
  }
}

// S(t + 1)'s products: rows 64 g .. of R (at ``Rg``) against the 64 rows
// of the X stage at ``X``, over this CTA's 256 columns (past H the tiles
// hold TMA's zeros): 16 k16 steps, one commit group, the first
// overwriting d
template <class T>
__device__ __forceinline__ void bwd_s(float (&d)[32], uint32_t Rg,
                                      uint32_t X) {
  wg_fence();
  wg_ss64_0<T>(d, wg_desc(Rg, 16, 1024), wg_desc(X, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < kHS / 16; ++kk)
    wg_ss64<T>(d, wg_desc(Rg + (kk >> 2) * 16384 + (kk & 3) * 32, 16, 1024),
               wg_desc(X + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024), 1);
  wg_commit();
}

// S's partials pushed to their owners' slots ([sender rank][q][thread],
// 16 bytes), this rank's groups into its own
template <int C>
__device__ __forceinline__ void bwd_send_partials(const BwdCtx& c,
                                                  const float (&d)[32]) {
  constexpr int Gmax = groups_of(0, C);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = i * C / 8;
    const uint32_t at =
        c.part + (uint32_t)((c.rank * Gmax + i - first_group(o, C)) * 2048);
    const float4 v =
        make_float4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]);
    if (o == c.rank)
      st_shared4(at, v);
    else
      st_async4(cluster_map(at, o), v, cluster_map(c.pbar, o));
  }
}

// The thread's rows' values: lse (dh) or the bias (dW), the label (dh),
// the lift of P', db's partial sums
struct BwdRows {
  float v[2];
  int lab[2];
  int row0;          // the first of the thread's two rows (the second + 8)
  float pscale;
  float dbp[2];
};

// Step t of a consumer warpgroup (the header's a-e); MORE: a step t + 1
// follows, whose S is issued here
template <class T, int C, bool MORE>
__device__ __forceinline__ void bwd_step(const BwdArgs& a, const BwdCtx& c,
                                         BwdRows& r, int t, uint32_t Rg,
                                         float (&acc)[128], float (&d)[32],
                                         uint32_t (&A)[4][4]) {
  const int lane = c.tid & 31;
  const int st = t % kBwdStages;
  // a. S(t + 1) issued behind P'X(t - 1); once P'X(t - 1) is done its X
  // stage goes back, and thread 0 refills it with X(t + 2) when both
  // warpgroups are done with it
  if constexpr (MORE) {
    const int sn = (t + 1) % kBwdStages;
    ws_wait(c.fullb + 8 * sn, (uint32_t)((t + 1) / kBwdStages) & 1u);
    bwd_s<T>(d, Rg, c.Xs + sn * kBwdX);
    wg_wait<1>();
  } else {
    wg_wait<0>();
  }
  if (t > 0 && lane == 0)
    mbar_arrive(c.emptyb + 8 * ((t - 1) % kBwdStages));
  if (c.tid == 0 && t + 2 < c.nsteps) {
    if (t > 0)
      ws_wait(c.emptyb + 8 * ((t - 1) % kBwdStages),
              (uint32_t)((t - 1) / kBwdStages) & 1u);
    bwd_load(a, c, t + 2);
  }
  __syncwarp();
  // b. this rank's groups of S(t): the ranks' partials added in rank
  // order; P' formed there and pushed to every CTA's P' slot
  // ([k16 step i / 2][thread][i % 2], 8 bytes: rows g and g + 8)
  if (C > 1) {
    if (lane == 0) mbar_expect(c.pbar, (uint32_t)((C - 1) * c.G * 512));
    ws_wait<true>(c.pbar, (uint32_t)t & 1u);
  }
  {
    const unsigned char* cb = reinterpret_cast<const unsigned char*>(
        __cvta_shared_to_generic(c.base + kBwdColsOff + st * kCB));
    const T* cbias = reinterpret_cast<const T*>(cb);
    const float* clse = reinterpret_cast<const float*>(cb);
    const float* cg = reinterpret_cast<const float*>(cb + 256);
    const int32_t* clab = reinterpret_cast<const int32_t*>(cb + 512);
    const int x0 = t * kBN;
    constexpr int Gmax = groups_of(0, C);
    const int f = first_group(c.rank, C);
    uint32_t w[Gmax][2];   // P' of the owned groups, packed (rows g, g + 8)
#pragma unroll
    for (int q = 0; q < Gmax; ++q) {
      if (q >= c.G) break;
      const int i = f + q;
      float4 s = ld_shared4(c.part + (uint32_t)(q * 2048));
#pragma unroll
      for (int k = 1; k < C; ++k) {
        const float4 v =
            ld_shared4(c.part + (uint32_t)((k * Gmax + q) * 2048));
        s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
      }
      const float sv[4] = {s.x, s.y, s.z, s.w};
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, cl = 8 * i + 2 * (lane & 3) + (e & 1);
        const int x = x0 + cl, row = r.row0 + 8 * h;
        float pe;
        if (!c.dwp) {
          pe = exp2_ftz((sv[e] + elem_f32(cbias[cl]) - r.v[h]) * kLog2e);
          if (x == r.lab[h]) pe -= 1.0f;
        } else {
          pe = exp2_ftz((sv[e] + r.v[h] - clse[cl]) * kLog2e);
          if (clab[cl] == row) pe -= 1.0f;
          pe *= cg[cl];
        }
        if (row >= a.nr || x >= a.nx) pe = 0.0f;
        r.dbp[h] += pe;
        p[e] = pe * r.pscale;
      }
      w[q][0] = pack2<T>(p[0], p[1]);
      w[q][1] = pack2<T>(p[2], p[3]);
    }
    // P' into every CTA's slot ([k16 step i / 2][thread][i % 2], 8 bytes
    // a group: rows g and g + 8), two groups of one k16 step a store
#pragma unroll
    for (int q = 0; q < Gmax; ++q) {
      if (q >= c.G) break;
      const int i = f + q;
      const uint32_t at = c.pp + (uint32_t)((i >> 1) * 2048 + (i & 1) * 8);
      if ((i & 1) == 0 && q + 1 < c.G && q + 1 < Gmax) {
        const uint4 v = make_uint4(w[q][0], w[q][1], w[q + 1][0],
                                   w[q + 1][1]);
        st_shared4u(at, v);
#pragma unroll
        for (int k = 0; k < C; ++k)
          if (k != c.rank)
            st_async4u(cluster_map(at, k), v, cluster_map(c.qbar, k));
        ++q;
      } else {
        st_shared2(at, w[q][0], w[q][1]);
#pragma unroll
        for (int k = 0; k < C; ++k)
          if (k != c.rank)
            st_async2(cluster_map(at, k), w[q][0], w[q][1],
                      cluster_map(c.qbar, k));
      }
    }
  }
  // c. P'(t) whole: its four k16 fragments into registers
  if (C > 1) {
    if (lane == 0) mbar_expect(c.qbar, (uint32_t)((8 - c.G) * 256));
    ws_wait<true>(c.qbar, (uint32_t)t & 1u);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = ld_shared4(c.pp + (uint32_t)(j * 2048));
    A[j][0] = __float_as_uint(v.x);
    A[j][1] = __float_as_uint(v.y);
    A[j][2] = __float_as_uint(v.z);
    A[j][3] = __float_as_uint(v.w);
  }
  // d. S(t + 1) done: its partials out, P'X(t) ahead of step t + 1's wait
  // for them (after c, so that one slot of each kind is enough)
  if constexpr (MORE) {
    wg_wait<0>();
    bwd_send_partials<C>(c, d);
  }
  // e. P'X(t) into the accumulator (A from registers, X MN-major: LBO
  // the 64-column blocks' stride), left running into step t + 1
  const uint32_t X = c.Xs + st * kBwdX;
  wg_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wg_rs256t<T>(acc, A[j], wg_desc(X + j * 2048, 8192, 1024));
  wg_commit();
}

// The 2-byte backward's pass (dh, or dW when ``dwp``) for one 128-row R
// tile; see the header. 256 threads: two warpgroups of 64 R rows; thread
// 0 also issues the TMA copies.
template <class T, int C>
__device__ __forceinline__ void bwd_body(const BwdArgs& a, bool dwp,
                                         int tile) {
  extern __shared__ __align__(1024) unsigned char smem_b[];
  BwdCtx c;
  c.base = smem_u32(smem_b);
  c.Xs = c.base + kBwdXOff;
  const uint32_t bars = c.base + kBwdBarOff;
  const uint32_t rbar = bars;
  c.fullb = bars + 8;
  c.emptyb = bars + 32;
  c.tid = threadIdx.x;
  c.dwp = dwp;
  c.rank = (int)cluster_rank();
  c.r0 = tile * kBwdRows;
  c.k0 = c.rank * kHS;
  c.ks = min(kHS, a.H - c.k0);
  c.nsteps = (a.nx + kBN - 1) / kBN;
  const int g = c.tid >> 7, lane = c.tid & 31;
  // the thread's 16 bytes in its warpgroup's slots; their barriers
  c.part = c.base + kBwdPartOff + g * kBwdPart + (c.tid & 127) * 16;
  c.pp = c.base + kBwdPPOff + g * kBwdPP + (c.tid & 127) * 16;
  // one exchange barrier of each kind a warp: a thread exchanges only
  // with the threads of its index in its peers
  c.pbar = bars + 56 + 8 * (c.tid >> 5);
  c.qbar = bars + 120 + 8 * (c.tid >> 5);
  // the groups of 8 columns this rank owns: i = rank + q C, q < G
  c.G = groups_of(c.rank, C);
  if (c.tid == 0) {
    mbar_init(rbar, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(c.fullb + 8 * s, 1);
      mbar_init(c.emptyb + 8 * s, 8);
    }
    for (int k = 0; k < 16; ++k) mbar_init(bars + 56 + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();    // every CTA's barriers exist before any st.async
  cluster_wait();
  if (c.tid == 0) {
    mbar_expect(rbar, 2 * 4 * 8192);
    for (int b = 0; b < 4; ++b) {
      tma_box(c.base + b * 16384, &a.r, c.k0 + 64 * b, c.r0, rbar);
      tma_box(c.base + b * 16384 + 8192, &a.r, c.k0 + 64 * b, c.r0 + 64,
              rbar);
    }
    bwd_load(a, c, 0);
    if (c.nsteps > 1) bwd_load(a, c, 1);
  }
  float* red = reinterpret_cast<float*>(smem_b + kBwdRedOff);

  // this thread's rows: 64 g + 16 w + lane / 4 + 8 h of the tile
  BwdRows r;
  r.row0 = c.r0 + 64 * g + 16 * ((c.tid >> 5) & 3) + (lane >> 2);
  r.dbp[0] = r.dbp[1] = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r.row0 + 8 * h;
    const bool live = row < a.nr;
    r.lab[h] = !dwp && live ? a.labels[row] : -1;
    r.v[h] = !live ? 0.0f
             : dwp ? elem_f32(static_cast<const T*>(a.bias)[row])
                   : a.lse[row];
  }
  // the lift of P': 2^14 (dh); 2^(14 - e) with 2^e <= the launch's
  // largest |g| < 2^(e + 1) (dW)
  r.pscale = ldexpf(1.0f, kLiftExp);
  if (dwp) {
    float gm = 0.0f;
    for (int n = c.tid; n < a.nx; n += kWsThreads)
      gm = fmaxf(gm, fabsf(a.g[n]));
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, o));
    if (lane == 0) red[128 + (c.tid >> 5)] = gm;
    __syncthreads();
    gm = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) gm = fmaxf(gm, red[128 + q]);
    if (gm > 0.0f)
      r.pscale = ldexpf(1.0f, kLiftExp - max(ilogbf(gm), -100));
  }

  float acc[128];        // dh or dW: element (j, e) at acc[4 j + e]
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.0f;
  float d[32];           // S of the next step
  uint32_t A[4][4];      // P' of this step, the A operand of P'X
  const uint32_t Rg = c.base + g * 8192;
  ws_wait(rbar, 0);
  ws_wait(c.fullb, 0);
  bwd_s<T>(d, Rg, c.Xs);
  wg_wait<0>();
  bwd_send_partials<C>(c, d);
  for (int t = 0; t + 1 < c.nsteps; ++t)
    bwd_step<T, C, true>(a, c, r, t, Rg, acc, d, A);
  bwd_step<T, C, false>(a, c, r, c.nsteps - 1, Rg, acc, d, A);
  wg_wait<0>();

  // the outputs: dh = acc g 2^-14 a row, dW = acc 2^(e - 14), rounded to
  // T once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r.row0 + 8 * h;
    if (row >= a.nr) continue;
    const float rs = dwp ? 1.0f / r.pscale : ldexpf(a.g[row], -kLiftExp);
    T* out = static_cast<T*>(a.out) + (int64_t)row * a.H + c.k0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = frag_col(lane, j, 0);
      if (col < c.ks)
        *reinterpret_cast<uint32_t*>(out + col) =
            pack2<T>(acc[4 * j + 2 * h] * rs, acc[4 * j + 2 * h + 1] * rs);
    }
  }
  // db: a row's quad (xor 1, then xor 2), then the ranks in order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r.dbp[h] += __shfl_xor_sync(0xffffffffu, r.dbp[h], 1);
    r.dbp[h] += __shfl_xor_sync(0xffffffffu, r.dbp[h], 2);
  }
  const int rl0 = r.row0 - c.r0;
  if (dwp && (lane & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) red[rl0 + 8 * h] = r.dbp[h];
  __syncwarp();
  cluster_arrive();
  cluster_wait();
  if (dwp && c.rank == 0 && (lane & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = rl0 + 8 * h;
      if (c.r0 + rl >= a.nr) continue;
      float db = 0.0f;
      for (int k = 0; k < C; ++k) {
        const float v = ld_cluster(cluster_map(smem_u32(red + rl), k));
        db = k == 0 ? v : db + v;
      }
      const uint32_t two = pack2<T>(db, 0.0f);   // db in the low half
      static_cast<T*>(a.out2)[c.r0 + rl] = *reinterpret_cast<const T*>(&two);
    }
  __syncwarp();
  cluster_arrive();      // exit is safe: rank 0 has read every db
  cluster_wait();
}

// the backward's two passes in one launch: the first clusters take dh's
// row tiles, the rest dW's vocab tiles; C = ceil(H / 256) CTAs a cluster
template <class T, int C>
__global__ void __launch_bounds__(kWsThreads, 1)
xent_bwd_ws(const __grid_constant__ BwdArgs dh,
            const __grid_constant__ BwdArgs dw) {
  const int tile = (int)blockIdx.x / C;
  const int dh_tiles = (dh.nr + kBwdRows - 1) / kBwdRows;
  const bool dwp = tile >= dh_tiles;
  bwd_body<T, C>(dwp ? dw : dh, dwp, dwp ? tile - dh_tiles : tile);
}

// ===========================================================================
// Host side
// ===========================================================================

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

// grid: ``tiles`` clusters of C = ceil(H / 256) CTAs of ``threads``
template <typename K, typename... Args>
int launch_mma(K kern, size_t smem, int threads, int tiles, int H,
               cudaStream_t st, const Args&... args) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int C = (H + kHS - 1) / kHS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * C));
  cfg.blockDim = dim3((unsigned)threads);
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

// N and V at least 1; H a multiple of 16 from 16 to 1024 (a cluster of
// at most four CTAs of 256 columns)
bool bad_shape(int N, int H, int V) {
  return N < 1 || V < 1 || H < 16 || H % 16 != 0 || H > kMaxC * kHS;
}

// a 1-D array of n elements of ``type`` read in boxes of box_n, zeros
// past its end
bool row_map(CUtensorMap* map, const void* base, int n,
             CUtensorMapDataType type, int box_n = 64) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n}, strides[1] = {0};
  const cuuint32_t box[1] = {(cuuint32_t)box_n}, step[1] = {1};
  return encode(map, type, 1, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


template <class T>
int xent_fwd_2byte(const T* h, const T* w, const T* bias,
                   const int32_t* labels, float* lse, float* ll, int N,
                   int H, int V, void* stream) {
  if (bad_shape(N, H, V)) return (int)cudaErrorInvalidValue;
  const bool half = std::is_same<T, f16>::value;
  FwdArgs a = {};
  if (!box_map(&a.h, h, N, H, half) || !box_map(&a.w, w, V, H, half) ||
      !row_map(&a.b, bias, V,
               half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               kFwdCols))
    return (int)cudaErrorInvalidValue;
  a.bias = bias;
  a.labels = labels;
  a.lse = lse;
  a.ll = ll;
  a.N = N;
  a.V = V;
  a.H = H;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = allow_smem(xent_fwd_ws<T>, kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  xent_fwd_ws<T><<<(N + kFwdRows - 1) / kFwdRows, kWsThreads, kFwdSmem, st>>>(
      a);
  return (int)cudaGetLastError();
}

template <class T>
int xent_bwd_2byte(const T* h, const T* w, const T* bias,
                   const int32_t* labels, const float* lse, const float* g,
                   T* dh, T* dw, T* db, int N, int H, int V, void* stream) {
  if (bad_shape(N, H, V)) return (int)cudaErrorInvalidValue;
  const bool half = std::is_same<T, f16>::value;
  BwdArgs a = {};
  a.bias = bias;
  a.labels = labels;
  a.lse = lse;
  a.g = g;
  a.H = H;
  BwdArgs b = a;
  a.nr = b.nx = N;
  a.nx = b.nr = V;
  if (!box_map(&a.r, h, N, H, half) || !box_map(&a.x, w, V, H, half) ||
      !box_map(&b.r, w, V, H, half) || !box_map(&b.x, h, N, H, half) ||
      !row_map(&a.cols[0], bias, V,
               half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) ||
      !row_map(&b.cols[0], lse, N, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !row_map(&b.cols[1], g, N, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !row_map(&b.cols[2], labels, N, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return (int)cudaErrorInvalidValue;
  a.out = dh;
  b.out = dw;
  b.out2 = db;
  const int tiles = (N + kBwdRows - 1) / kBwdRows +
                    (V + kBwdRows - 1) / kBwdRows;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((H + kHS - 1) / kHS) {
    case 1:
      return launch_mma(xent_bwd_ws<T, 1>, kBwdSmem, kWsThreads, tiles, H, st,
                        a, b);
    case 2:
      return launch_mma(xent_bwd_ws<T, 2>, kBwdSmem, kWsThreads, tiles, H, st,
                        a, b);
    case 3:
      return launch_mma(xent_bwd_ws<T, 3>, kBwdSmem, kWsThreads, tiles, H, st,
                        a, b);
    default:
      return launch_mma(xent_bwd_ws<T, 4>, kBwdSmem, kWsThreads, tiles, H, st,
                        a, b);
  }
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
  return launch_mma(xent_fwd_mma, mma_smem<kFwd>(), kXT, (N + kBM - 1) / kBM,
                    H, st, a);
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
  return launch_mma(xent_bwd_mma, mma_smem<kDh>(), kXT,
                    (N + kBM - 1) / kBM + (V + kBM - 1) / kBM, H, st, a, b);
}

// The 2-byte forms: h (N, H), w (V, H), bias (V,) and dh, dw, db of one
// type (bf16 or f16), 16-byte aligned; lse, ll, g f32.
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
