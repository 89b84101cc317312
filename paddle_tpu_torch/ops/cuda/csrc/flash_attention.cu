// Flash attention for Hopper (sm_90a): forward, and a backward of one
// dq pass and one dk/dv pass, with dropout generated in the kernels.
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas/flash_attention.py:
// _fwd_call (_flash_fwd_kernel) and _bwd_call (_flash_bwd_dq_kernel,
// _flash_bwd_dkv_kernel), including the in-kernel dropout of
// _keep_mask and the masked form (masked=True: mask_bias, a (B, Lk)
// additive key bias).
//
// Bound: the work is about 4*L*L*D flops per (batch, head) forward and
// 10*L*L*D backward against 4*L*D and 8*L*D bf16 elements moved. At
// BERT phase 1's 128 x 128 x 12 x 64 the bytes bound both (forward
// 0.030 ms at 3.35 TB/s against 0.0065 ms of operations at the 989
// TFLOP/s bf16 tensor-core rate; backward 0.060 against 0.016); at 512
// keys the two meet, and past them (GPT-2's causal 1024) the operations
// bound it. A key-padded batch needs only its live keys' operations.
//
// Everything in bf16 or f16 runs on tensor cores (the description below
// says bf16; the f16 forms differ only as their paragraph says): 4 warps
// a block, each warp 16 rows of a 64-row tile, mma.sync m16n8k16 -> f32
// from swizzled shared tiles that a two-stage cp.async ring fills under
// the previous tile's products (pieces in flash_common.cuh).
// - Forward (flash_fwd_mma, the body fwd_mma in flash_common.cuh, which
//   K1c's short_fwd_mma shares), one block per (64-row q tile, b*H + h),
//   causal grids longest tile first: q is read with Lq as its bound, k
//   and v with Lk; per kv tile S = Q K^T, scaled in f32, plus the key
//   bias (its 64 values staged in shared memory with the tile and added
//   in the fragment layout), then -inf past Lk and above the diagonal
//   (mask_tile); m and l per row in f32, l summing the undropped
//   probabilities; P = exp(S - m), dropped by keep_frag (the plain
//   version's philox_keep_mask bit for bit) and scaled by 1/(1-p),
//   enters O += P V as two bf16 terms, hi + lo (acc_to_a2): with one
//   term BERT phase 2's first loss moved by 1.4e-3. out = O / l in bf16,
//   lse = m + log(l) in f32. With a key bias (the MASKED instantiation;
//   the other, which K1c runs too, compiles in none of the bias code: it
//   cost K1c 3 % when it was a runtime branch) the block first reads the
//   batch entry's Lk bias values and skips the kv tiles whose every value
//   is <= -1e30 when that is exact (scan_live_tiles): the padded batch
//   pays for its live keys only. At D = 64 the registers are capped at
//   128 so that 4 blocks share an SM; 8-warp blocks of 128 q rows, two
//   m16 tiles a warp and a third ring stage were each slower on the
//   card (PERF.md).
// - dq kernel, one block per 64-row q tile: delta = rowsum(dO * O) in
//   f32 under the first copies (written for the dk/dv kernel; the EXT
//   form reads the caller's), then over kv tiles (up to the diagonal when
//   causal) S = Q K^T and dP = dO V^T, P = exp(S * scale + bias - lse),
//   dS = P (dP - delta) in registers, dQ += dS K with K through
//   ldmatrix.trans.
// - dk/dv kernel, one block per 64-row kv tile, K and V resident, Q and
//   dO streamed (from the diagonal when causal): S and dP in the q-row
//   layout, so each thread's dropout words are its own (keep_frag); the
//   dropped P and dS go to shared tiles, read back transposed as the A
//   operands of dV += P^T dO and dK += dS^T Q.
// - Rounding: bf16 operands, f32 accumulators; m, lse, delta, P and dS
//   are f32 until they become operands. P enters dV as one bf16 term; dS
//   enters dQ and dK as two, hi + lo, since a fully masked row (P = 1
//   across it, lse = -1e30) makes dS Lk times its usual size and one
//   rounding of it moved dQ and dK past the bf16 tolerance. No atomics
//   and no split of a sum across blocks: two launches give the same bits.
// - f16 (AMP O1 fp16: the JAX kernel takes any input type and computes in
//   f32): the same three kernels (and the EXT form) with T = __half, the f16 mma
//   (m16n8k16.f32.f16.f16.f32) and f16 roundings of P, P' and dS; out,
//   dq, dk, dv in f16. f16 keeps 11 bits (bf16 8) but spans only 6.1e-5
//   (smallest normal) to 65504. P and P' lie in [0, 1/(1-p)]: no lift.
//   dS = P (dP - delta) does not: under a GradScaler dO carries the loss
//   scale (2^15 by default), so |dP| can pass 65504 while dQ's own sum
//   fits, and at scale 1 most of a row's dS sit below f16's normals. So
//   dS is lifted by a power of two before its rounding, as K2's f16 form
//   lifts P' (fused_xent.cu): the dq kernel keeps a running exponent per
//   q row, the dk/dv kernel one per block (dK sums over all 64 q rows of
//   a tile: the four warps' largest |dS| meet in shared memory, one more
//   barrier a tile), raised so that a tile's largest |dS| 2^-E < 2^14;
//   the accumulator is rescaled by 2^(E_old - E_new) when E grows and by
//   2^E at the store. Powers of two only: where nothing overflows or
//   underflows, the products are the unlifted ones exactly. P, rounded
//   once for dV, takes a block exponent of its own the same way (the
//   external-lse form's low-mass blocks; flash_common.cuh). Decided on
//   the card (tools/flash_f16_lift.py builds the unlifted variant with
//   FLASH_F16_NO_LIFT; figures in PERF.md): at the NMT's 64 x 128 x 8 x 64
//   with dO a unit gradient (scale 1) the unlifted dq and dk used 1.55
//   and 1.38 of the 2-byte check's tolerance (4.09 for dk with a peaked
//   softmax), the lifted ones 0.50 at most; at scales 2^15 and 2^24 the
//   two builds used the same share of it (dk overflowed f16 in both at
//   2^24 with the peaked softmax: its true value is 80,638). So the lift
//   stays. bf16 has f32's
//   range and keeps the unlifted code (no template branch reaches it).
// The f32 forms use the f32 FMA kernels below: they are the parity route
// held to 1e-4, which neither bf16 nor TF32 meets.
//
// Head widths: 64, 128, 192 and 256, the widths the JAX package's
// _pallas_ok admits (d % 64 == 0, d <= 256). At 192 and 256 two budgets
// of the 64 / 128 design break, and each kernel that hits one changes
// only what it must:
// - Registers: the dk/dv kernel's accumulators (dK and dV of 16 kv
//   rows, 2 x D / 8 x 4 f32 a thread) would be 192 and 256, the whole
//   register file before S, dP and the operands. So at D > 128 a block
//   accumulates one column chunk of dK and dV (kDkvCols: 96 at D = 192,
//   128 at D = 256, as many accumulators as at D = 128) and D /
//   kDkvCols blocks share each kv tile (grid z), each recomputing S, dP,
//   P and dS over the whole width: 40 % more products than one block, no
//   exchange between blocks, each element of dK and dV still summed by
//   one thread in one order, so two runs give the same bits. The dq
//   kernel holds 96 / 128 accumulators and keeps its design, at one block
//   a multiprocessor (its shared memory allows no more).
// - The 2-byte forward at these widths is flash_fwd_wg, on wgmma
//   warpgroups fed by TMA (flash_wide.cuh's fwd_wg, with K1c's forward):
//   a 128-row q tile over two consumer warpgroups, each holding its 64
//   x D accumulator in registers that setmaxnreg takes from the producer
//   warpgroup, which keeps K and V tiles in flight. The numerics are
//   fwd_mma's (P into P V as hi + lo).
// - Shared memory (the f32 FMA kernels): at D = 256 the dq kernel's and
//   the dk/dv kernel's f32 tiles (~280 KB) pass the 227 KB a block may
//   have, so one [64][D+1] tile takes K and V in turn (the dq kernel:
//   K for S, V for dP, K again for dS K) or V and Q in turn (the dk/dv
//   kernel, K resident: Q for S, V for dP, Q again for dS^T Q; kOneKV):
//   more loads, the same arithmetic in the same order. The 2-byte tiles
//   fit at both widths (dk/dv 221,216 bytes at D = 256).
// ptxas's registers and spills of every instantiation are in PERF.md.
//
// FMA design: q, k, v, out and their gradients keep the JAX package's
// (B, L, H, D) layout and the kernels index it directly, so no head
// merge is ever materialised. Tiles are 64 query rows by 64 key rows;
// the thread layout, the shared-memory operands and the dropout keying
// are in flash_common.cuh, shared with the short-sequence kernels.
// - Forward: one block per (q-tile, b*H + h) loops over kv-tiles with
//   an online softmax: m and l per row in registers, the 64 x D output
//   accumulator spread over the block's registers. Writes out and
//   lse = m + log(l).
// - Backward: the dq kernel (one block per q-tile) computes delta =
//   rowsum(dO * O) for its rows, writes it for the dk/dv kernel, and
//   loops over kv-tiles; the dk/dv kernel (one block per kv-tile) loops
//   over q-tiles. Both recompute P = exp(S - lse). No atomics: each
//   output element has one writer, so results are deterministic.
// - External-lse backward (_bwd_call as parallel/ring.py's
//   _ring_flash_bwd calls it, once per kv block of the ring): the caller
//   hands in lse and delta of the WHOLE sequence, so P = exp(S - lse) is
//   the true probability of this block's keys and each block's dq, dk, dv
//   is an exact share of the full gradient. The same two kernels run;
//   the dq kernel's EXT instantiation reads delta instead of computing
//   it from O (there is no O of the block), and the entry takes no
//   dropout (the ring runs at dropout 0). Over f16 (GPT-2 over
//   {"sp": 2} at O1 fp16) it keeps the dS lift below: off the diagonal
//   a block's keys may hold little of a row's mass, so its P, and dS,
//   lie far below the saved form's, which is what the lift's per-tile
//   exponent is for (tools/flash_f16_lift.py measures the ext form at
//   the SP block with and without it; PERF.md).
// - Dropout: Philox4x32-10 keyed by the 64-bit seed, counter
//   (g, query row, b*H + h, 0) with g = (col / 64) * 16 + col % 16 and
//   word (col / 16) % 4. A thread's four columns tx + 16 j of one tile
//   row are exactly one Philox call. The mask is a function of element
//   coordinates only, so every kernel (and the plain version) agrees on
//   it. l sums the undropped probabilities; the value sum, dV and dP see
//   the mask scaled by 1/(1-p), as in the TPU kernel.
// - Key mask (the masked form of _flash_fwd_kernel and both backward
//   kernels, mask_ref): an optional (B, Lk) f32 additive bias, staged in
//   shared memory a kv tile at a time next to K, added to the f32 score
//   before the online softmax and again before P = exp(S - lse). The
//   caller's key-padding bias is the finite -1e30 of _kv_mask_bias, so a
//   row whose every key is masked scores -1e30 everywhere and comes out
//   as the mean of V (never NaN); a fully masked first tile leaves m at
//   -1e30 and the next live tile rescales it away (alpha = 0). The bias
//   rides with dropout and causal too. A null pointer is the unmasked
//   path, whose arithmetic is unchanged.
// Ragged lengths are masked in the kernels (rows past L load as zeros
// and are not written; columns past L, and above the diagonal when
// causal, score -inf).
#include "flash_common.cuh"
#ifdef FLASH_WIDE
#include "flash_wide.cuh"
#endif

namespace {

// ---------------------------------------------------------------------------
// forward, f32 FMA (the parity route)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, Args a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [64][D]
  float* Ks = Qs + kTile * D;                     // [64][D+1]
  float* Vs = Ks + kTile * (D + 1);               // [64][D]
  float* Ps = Vs + kTile * D;                     // [64][64]
  float* Bs = Ps + kTile * kTile;                 // [64] key mask
  constexpr int C = D / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kTile;
  const bool drop = a.inv != 1.0f;

  load_tile<T, D>(Qs, D, q, a, b, h, q0, a.Lq, a.scale);
  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInit;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;
  }
  const int nkv = kv_tiles_for(a, q0);
  for (int t = 0; t < nkv; ++t) {
    const int kv0 = t * kTile;
    load_tile<T, D>(Ks, D + 1, k, a, b, h, kv0, a.Lk, 1.0f);
    load_tile<T, D>(Vs, D, v, a, b, h, kv0, a.Lk, 1.0f);
    if (a.bias) load_bias(Bs, a, b, kv0);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    mm<4, 4, D>(s, Qs, D, ty * 4, Ks, 1, D + 1, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (dead(a, row, kv0 + tx + 16 * j))
          s[i][j] = -INFINITY;
        else if (a.bias)
          s[i][j] += Bs[tx + 16 * j];
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
      if (drop) {
        bool keep[4];
        keep4(a, bh, row, kv0, tx, keep);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = keep[j] ? s[i][j] * a.inv : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * kTile + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    mm<4, C, kTile>(acc, Ps, kTile, ty * 4, Vs, D, 1, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lc = fmaxf(l[i], 1e-30f);
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < a.Lq) lse[(int64_t)bh * a.Lq + row] = m[i] + logf(lc);
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = acc[i][j] / lc;
  }
  store_rows<T, D>(out, acc, a, b, h, q0, a.Lq, 1.0f);
}

#ifndef FLASH_WIDE
// forward, bf16 or f16 on tensor cores (the body is flash_common.cuh's
// fwd_mma)
template <int D, bool MASKED, typename T>
__global__ void __launch_bounds__(kMmaT, D == 64 ? 4 : D == 128 ? 2 : 1)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, Args a) {
  // causal: the longest q tiles start first
  fwd_mma<D, MASKED>(q, k, v, out, lse, a,
                     a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}
#else
// forward, bf16 or f16 at D = 192 and 256 on wgmma (the body is
// flash_wide.cuh's fwd_wg): one block per (128-row q tile, b*H + h)
template <int D, bool MASKED, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wg(const __grid_constant__ WideFwd<T> p) {
  // causal: the longest q tiles start first
  fwd_wg<D, MASKED, T, false>(
      p, p.a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}
#endif

// ---------------------------------------------------------------------------
// backward: dq (+ delta)
// ---------------------------------------------------------------------------
// Shared memory of the f32 backward kernels; at D = 256 a second
// [64][D+1] operand tile does not fit (ONE_KV), so the dq kernel loads K
// and V in turn into one tile (K again for dS K) and the dk/dv kernel
// keeps K resident and loads V and Q in turn into one tile (Q again for
// dS^T Q): more loads of the same values, the same arithmetic.
template <int D>
constexpr size_t dq_smem(bool one_kv) {
  return sizeof(float) * (kTile * D * 2 + kTile * (D + 1) * (one_kv ? 1 : 2) +
                          kTile * kTile + 3 * kTile);
}
template <int D>
constexpr bool kOneKV = dq_smem<D>(false) > kSmemMax;
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (kTile * (D + 1) * 2 + kTile * D * (kOneKV<D> ? 1 : 2) +
                          kTile * kPad + 3 * kTile);
}
template <int D>
constexpr size_t dq_smem() {
  return dq_smem<D>(kOneKV<D>);
}

template <typename T, int D, bool EXT>
__global__ void __launch_bounds__(kT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, T* __restrict__ dq, Args a) {
  constexpr bool ONE = kOneKV<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [64][D], scaled
  float* dOs = Qs + kTile * D;                    // [64][D]
  float* Ks = dOs + kTile * D;                    // [64][D+1]
  float* Vs = ONE ? Ks : Ks + kTile * (D + 1);    // [64][D+1] (ONE: K's)
  float* dSs = Vs + kTile * (D + 1);              // [64][64]
  float* lse_s = dSs + kTile * kTile;             // [64]
  float* delta_s = lse_s + kTile;                 // [64]
  float* Bs = delta_s + kTile;                    // [64] key mask
  constexpr int C = D / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kTile;
  const bool drop = a.inv != 1.0f;

  load_tile<T, D>(Qs, D, q, a, b, h, q0, a.Lq, a.scale);
  load_tile<T, D>(dOs, D, dout, a, b, h, q0, a.Lq, 1.0f);
  if constexpr (EXT) {  // the caller's delta and lse (o is unused)
    if (tid < kTile) {
      const bool live = q0 + tid < a.Lq;
      delta_s[tid] = live ? delta[(int64_t)bh * a.Lq + q0 + tid] : 0.0f;
      lse_s[tid] = live ? lse[(int64_t)bh * a.Lq + q0 + tid] : INFINITY;
    }
  } else {
    __syncthreads();
    // delta = rowsum(dO * O): four threads a row
    const int r = tid >> 2, part = tid & 3;
    float d = 0.0f;
    if (q0 + r < a.Lq) {
      const int64_t off = (((int64_t)b * a.Lq + q0 + r) * a.H + h) * D;
      for (int c = part; c < D; c += 4)
        d = fmaf(dOs[r * D + c], Vec<T>::one(o + off + c), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      const bool live = q0 + r < a.Lq;
      delta_s[r] = live ? d : 0.0f;
      lse_s[r] = live ? lse[(int64_t)bh * a.Lq + q0 + r] : INFINITY;
      if (live) delta[(int64_t)bh * a.Lq + q0 + r] = d;
    }
  }
  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;
  const int nkv = kv_tiles_for(a, q0);
  for (int t = 0; t < nkv; ++t) {
    const int kv0 = t * kTile;
    load_tile<T, D>(Ks, D + 1, k, a, b, h, kv0, a.Lk, 1.0f);
    if (!ONE) load_tile<T, D>(Vs, D + 1, v, a, b, h, kv0, a.Lk, 1.0f);
    if (a.bias) load_bias(Bs, a, b, kv0);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    mm<4, 4, D>(s, Qs, D, ty * 4, Ks, 1, D + 1, tx);
    if (ONE) {
      __syncthreads();
      load_tile<T, D>(Vs, D + 1, v, a, b, h, kv0, a.Lk, 1.0f);
      __syncthreads();
    }
    mm<4, 4, D>(dp, dOs, D, ty * 4, Vs, 1, D + 1, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
      bool keep[4] = {true, true, true, true};
      if (drop) keep4(a, bh, row, kv0, tx, keep);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = a.bias ? s[i][j] + Bs[tx + 16 * j] : s[i][j];
        const float p = dead(a, row, kv0 + tx + 16 * j)
                            ? 0.0f : expf(sv - lse_s[r]);
        const float dpv = drop ? (keep[j] ? dp[i][j] * a.inv : 0.0f)
                               : dp[i][j];
        dSs[r * kTile + tx + 16 * j] = p * (dpv - delta_s[r]);
      }
    }
    __syncthreads();
    if (ONE) {
      load_tile<T, D>(Ks, D + 1, k, a, b, h, kv0, a.Lk, 1.0f);
      __syncthreads();
    }
    mm<4, C, kTile>(acc, dSs, kTile, ty * 4, Ks, D + 1, 1, tx);
    __syncthreads();
  }
  store_rows<T, D>(dq, acc, a, b, h, q0, a.Lq, a.scale);
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, Args a) {
  constexpr bool ONE = kOneKV<D>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [64][D+1]
  float* Vs = Ks + kTile * (D + 1);               // [64][D+1]
  float* Qs = ONE ? Vs : Vs + kTile * (D + 1);    // [64][D], scaled (ONE:
                                                  // V's tile)
  float* dOs = ONE ? Vs + kTile * (D + 1) : Qs + kTile * D;   // [64][D]
  float* Ts = dOs + kTile * D;                    // [64 kv][kPad]: P or dS
  float* lse_s = Ts + kTile * kPad;               // [64]
  float* delta_s = lse_s + kTile;                 // [64]
  float* Bs = delta_s + kTile;                    // [64] key mask
  constexpr int C = D / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kv0 = blockIdx.x * kTile;
  const bool drop = a.inv != 1.0f;

  load_tile<T, D>(Ks, D + 1, k, a, b, h, kv0, a.Lk, 1.0f);
  if (!ONE) load_tile<T, D>(Vs, D + 1, v, a, b, h, kv0, a.Lk, 1.0f);
  if (a.bias) load_bias(Bs, a, b, kv0);
  float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;
  const int nq = (a.Lq + kTile - 1) / kTile;
  const int first = a.causal ? kv0 / kTile : 0;
  for (int t = first; t < nq; ++t) {
    const int q0 = t * kTile;
    load_tile<T, D>(Qs, D, q, a, b, h, q0, a.Lq, a.scale);
    load_tile<T, D>(dOs, D, dout, a, b, h, q0, a.Lq, 1.0f);
    if (tid < kTile) {
      const bool live = q0 + tid < a.Lq;
      lse_s[tid] = live ? lse[(int64_t)bh * a.Lq + q0 + tid] : INFINITY;
      delta_s[tid] = live ? delta[(int64_t)bh * a.Lq + q0 + tid] : 0.0f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    mm<4, 4, D>(s, Qs, D, ty * 4, Ks, 1, D + 1, tx);
    if (ONE) {
      __syncthreads();
      load_tile<T, D>(Vs, D + 1, v, a, b, h, kv0, a.Lk, 1.0f);
      __syncthreads();
    }
    mm<4, 4, D>(dp, dOs, D, ty * 4, Vs, 1, D + 1, tx);
    // s -> P, dp -> dropped dP; T <- dropped P (transposed: [kv][q])
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
      bool keep[4] = {true, true, true, true};
      if (drop) keep4(a, bh, row, kv0, tx, keep);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float sv = a.bias ? s[i][j] + Bs[c] : s[i][j];
        const float p = dead(a, row, kv0 + c) ? 0.0f : expf(sv - lse_s[r]);
        s[i][j] = p;
        float pd = p;
        if (drop) {
          pd = keep[j] ? p * a.inv : 0.0f;
          dp[i][j] = keep[j] ? dp[i][j] * a.inv : 0.0f;
        }
        Ts[c * kPad + r] = pd;
      }
    }
    __syncthreads();
    mm<4, C, kTile>(dv_acc, Ts, kPad, ty * 4, dOs, D, 1, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ts[(tx + 16 * j) * kPad + r] = s[i][j] * (dp[i][j] - delta_s[r]);
    }
    if (ONE) load_tile<T, D>(Qs, D, q, a, b, h, q0, a.Lq, a.scale);
    __syncthreads();
    mm<4, C, kTile>(dk_acc, Ts, kPad, ty * 4, Qs, D, 1, tx);
    __syncthreads();
  }
  store_rows<T, D>(dk, dk_acc, a, b, h, kv0, a.Lk, 1.0f);
  store_rows<T, D>(dv, dv_acc, a, b, h, kv0, a.Lk, 1.0f);
}

// ---------------------------------------------------------------------------
// backward, bf16 or f16 on tensor cores: dq (+ delta), then dk, dv
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_mma_smem() {   // q, dO, 2 k, 2 v; 64 delta
  return (size_t)6 * kTile * D * 2 + kTile * 4;
}

template <int D>
constexpr size_t dkv_mma_smem() {  // k, v, 2 q, 2 dO; P, dS hi and lo;
  return (size_t)6 * kTile * D * 2 +  // the warps' largest |dS| and P (f16)
         (size_t)3 * kTile * kTile * 2 + 2 * kWarps * 4;
}

// the (B, Lk) key mask at this thread's 16 columns of a kv tile (0 past
// Lk, where dead() masks the column anyway)
__device__ __forceinline__ void bias_frag(float (&bv)[8][2], const Args& a,
                                          int b, int kv0, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = kv0 + frag_col(lane, i, e);
      bv[i][e] = a.bias && c < a.Lk ? a.bias[(int64_t)b * a.Lk + c] : 0.0f;
    }
}

template <int D, bool EXT, typename T>
__global__ void __launch_bounds__(kMmaT, D == 64 ? 3 : D == 128 ? 2 : 1)
flash_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, T* __restrict__ dq, Args a) {
  extern __shared__ __align__(128) unsigned char smem_mma[];
  constexpr uint32_t TB = kTile * D * 2;
  const uint32_t Qs = smem_u32(smem_mma), dOs = Qs + TB, Ks = dOs + TB,
                 Vs = Ks + 2 * TB;
  float* dl_s = reinterpret_cast<float*>(smem_mma + 6 * TB);   // [64]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kTile, row0 = q0 + 16 * w;
  const int nkv = kv_tiles_for(a, q0);

  tile_async<D>(Qs, q, a, b, h, q0, a.Lq);
  tile_async<D>(dOs, dout, a, b, h, q0, a.Lq);
  tile_async<D>(Ks, k, a, b, h, 0, a.Lk);
  tile_async<D>(Vs, v, a, b, h, 0, a.Lk);
  cp_commit();
  if constexpr (!EXT) {
    // delta = rowsum(dO * O) in f32 under the copies: two threads a row
    const int r = tid >> 1, part = tid & 1;
    float d = 0.0f;
    if (q0 + r < a.Lq) {
      const int64_t off = (((int64_t)b * a.Lq + q0 + r) * a.H + h) * D +
                          part * (D / 2);
      float x[8], y[8];
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        Vec<T>::load(dout + off + c, x);
        Vec<T>::load(o + off + c, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(x[e], y[e], d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (part == 0) {
      dl_s[r] = d;
      if (q0 + r < a.Lq) delta[(int64_t)bh * a.Lq + q0 + r] = d;
    }
    __syncthreads();
  }
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + frag_row(lane, 2 * r);
    const bool live = row < a.Lq;
    lse_r[r] = live ? lse[(int64_t)bh * a.Lq + row] : INFINITY;
    if constexpr (EXT)
      dl_r[r] = live ? delta[(int64_t)bh * a.Lq + row] : 0.0f;
    else
      dl_r[r] = live ? dl_s[row - q0] : 0.0f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  int lift[2] = {kLiftMin, kLiftMin};   // f16: each row's dS exponent
  for (int t = 0; t < nkv; ++t) {
    const uint32_t Kt = Ks + (t & 1) * TB, Vt = Vs + (t & 1) * TB;
    if (t + 1 < nkv) {
      const uint32_t nxt = ((t + 1) & 1) * TB;
      tile_async<D>(Ks + nxt, k, a, b, h, (t + 1) * kTile, a.Lk);
      tile_async<D>(Vs + nxt, v, a, b, h, (t + 1) * kTile, a.Lk);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int kv0 = t * kTile;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.0f;
    mma_abt<D, T>(s, Qs, 16 * w, Kt, lane);     // S = Q K^T
    mma_abt<D, T>(dp, dOs, 16 * w, Vt, lane);   // dP = dO V^T
    float bv[8][2];
    bias_frag(bv, a, b, kv0, lane);
    grad_scores<false>(s, dp, a, bh, row0, kv0, bv, lse_r, dl_r, lane);
    if constexpr (kLift<T>) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        raise_lift(lift[r], lift_exp(tile_absmax(s, r)), acc, r);
        const float f = pow2i(-lift[r]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i][2 * r] *= f;
          s[i][2 * r + 1] *= f;
        }
      }
    }
    mma_rb<D, T>(acc, s, Kt, lane);       // dQ += dS K, dS hi + lo
    __syncthreads();
  }
  if constexpr (kLift<T>) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= pow2i(lift[e >> 1]);
  }
  store_acc<D>(dq, acc, a, b, h, row0, a.Lq, a.scale, lane);
}

// one block per (64-row kv tile, b*H + h, column chunk blockIdx.z of
// dK and dV, kDkvCols<D> wide)
template <int D, typename T>
__global__ void __launch_bounds__(kMmaT)
flash_dkv_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk,
              T* __restrict__ dv, Args a) {
  constexpr int DC = kDkvCols<D>;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  constexpr uint32_t TB = kTile * D * 2;
  const uint32_t Ks = smem_u32(smem_mma), Vs = Ks + TB, Qs = Vs + TB,
                 dOs = Qs + 2 * TB, Ps = dOs + 2 * TB,
                 dSs = Ps + kTile * kTile * 2, dSl = dSs + kTile * kTile * 2;
  unsigned char* Pp = smem_mma + 6 * TB;            // [64 q][64 kv] bf16
  unsigned char* dSp = Pp + kTile * kTile * 2;      // dS, hi
  unsigned char* dLp = dSp + kTile * kTile * 2;     // dS, lo
  float* wmax = reinterpret_cast<float*>(dLp + kTile * kTile * 2);  // [8]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kv0 = blockIdx.x * kTile, col0 = blockIdx.z * DC;
  const int nq = (a.Lq + kTile - 1) / kTile;
  const int first = a.causal ? kv0 / kTile : 0;

  tile_async<D>(Ks, k, a, b, h, kv0, a.Lk);
  tile_async<D>(Vs, v, a, b, h, kv0, a.Lk);
  if (first < nq) {
    tile_async<D>(Qs, q, a, b, h, first * kTile, a.Lq);
    tile_async<D>(dOs, dout, a, b, h, first * kTile, a.Lq);
  }
  cp_commit();
  // the key mask at this thread's columns: read once where the registers
  // allow it, a q tile at a time (after S and dP) beside a column chunk's
  // accumulators
  float bv[8][2];
  if constexpr (DC == D) bias_frag(bv, a, b, kv0, lane);
  float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;
  int lift = kLiftMin, plift = kLiftMin;   // f16: the block's dS and P
                                           // exponents
  for (int t = first; t < nq; ++t) {
    const uint32_t stg = ((t - first) & 1) * TB;
    const uint32_t Qt = Qs + stg, dOt = dOs + stg;
    if (t + 1 < nq) {
      const uint32_t nxt = TB - stg;
      tile_async<D>(Qs + nxt, q, a, b, h, (t + 1) * kTile, a.Lq);
      tile_async<D>(dOs + nxt, dout, a, b, h, (t + 1) * kTile, a.Lq);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // scores in the q-row layout (warp w: q rows 16 w ..), so that each
    // thread's dropout words are its own (keep_frag)
    const int q0 = t * kTile, row0 = q0 + 16 * w;
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + frag_row(lane, 2 * r);
      const bool live = row < a.Lq;
      lse_r[r] = live ? lse[(int64_t)bh * a.Lq + row] : INFINITY;
      dl_r[r] = live ? delta[(int64_t)bh * a.Lq + row] : 0.0f;
    }
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.0f;
    mma_abt<D, T>(s, Qt, 16 * w, Ks, lane);     // S = Q K^T
    mma_abt<D, T>(dp, dOt, 16 * w, Vs, lane);   // dP = dO V^T
    if constexpr (DC < D) bias_frag(bv, a, b, kv0, lane);
    grad_scores<true>(s, dp, a, bh, row0, kv0, bv, lse_r, dl_r, lane);
    if constexpr (kLift<T>) {
      // dK and dV sum over the tile's 64 q rows (every warp's): one
      // exponent each for the block, from the four warps' largest |dS|
      // and P
      float ms = tile_absmax(s, -1), mp = tile_absmax(dp, -1);
      block_absmax2(ms, mp, wmax, w, lane);
      raise_lift(lift, lift_exp(ms), dka, -1);
      raise_lift(plift, lift_exp(mp), dva, -1);
      scale_tile(s, lift);
      scale_tile(dp, plift);
    }
    store_frag<T>(Pp, nullptr, dp, w, lane);    // dropped P, one term
    store_frag<T>(dSp, dLp, s, w, lane);        // dS, hi + lo
    __syncthreads();
    // warp w: kv rows 16 w .. of dV += P^T dO and dK += dS^T Q, the
    // block's columns
    dkv_products<D, T, DC>(dva, dka, Ps, dSs, dSl, dOt, Qt, col0, w, lane);
    __syncthreads();     // P, dS, the warps' maxima and the stage are
  }                      // rewritten next
  store_acc<D, T, DC>(dk, dka, a, b, h, kv0 + 16 * w, a.Lk,
                      kLift<T> ? a.scale * pow2i(lift) : a.scale, lane,
                      col0);
  store_acc<D, T, DC>(dv, dva, a, b, h, kv0 + 16 * w, a.Lk,
                      kLift<T> ? pow2i(plift) : 1.0f, lane, col0);
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) *
         (kTile * D * 2 + kTile * (D + 1) + kTile * kTile + kTile);
}

template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* out,
                   float* lse, const Args& a, cudaStream_t st) {
  using T = float;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = allow_smem(kern, fwd_smem<D>());
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Lq + kTile - 1) / kTile, a.B * a.H);
  kern<<<grid, kT, fwd_smem<D>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, a);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* out,
                   float* lse, const Args& a, cudaStream_t st) {
#ifdef FLASH_WIDE
  return a.bias ? launch_fwd_wg<D, T>(flash_fwd_wg<D, true, T>, q, k, v, out,
                                      lse, a, st)
                : launch_fwd_wg<D, T>(flash_fwd_wg<D, false, T>, q, k, v, out,
                                      lse, a, st);
#else
  auto kern = a.bias ? flash_fwd_mma<D, true, T> : flash_fwd_mma<D, false, T>;
  const size_t smem = fwd_mma_smem<D>(a.Lk);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Lq + kTile - 1) / kTile, a.B * a.H);
  kern<<<grid, kMmaT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                  (T*)out, lse, a);
  return (int)cudaGetLastError();
#endif
}

// EXT: delta comes from the caller (o may be null), else the dq kernel
// computes it from o and writes it
template <int D, bool EXT = false>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, const Args& a,
                   cudaStream_t st) {
  using T = float;
  auto kdq = flash_dq_kernel<T, D, EXT>;
  auto kdkv = flash_dkv_kernel<T, D>;
  cudaError_t e = allow_smem(kdq, dq_smem<D>());
  if (e == cudaSuccess) e = allow_smem(kdkv, dkv_smem<D>());
  if (e != cudaSuccess) return (int)e;
  dim3 gq((a.Lq + kTile - 1) / kTile, a.B * a.H);
  kdq<<<gq, kT, dq_smem<D>(), st>>>((const T*)q, (const T*)k, (const T*)v,
                                    (const T*)o, (const T*)dout, lse, delta,
                                    (T*)dq, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gk((a.Lk + kTile - 1) / kTile, a.B * a.H);
  kdkv<<<gk, kT, dkv_smem<D>(), st>>>((const T*)q, (const T*)k, (const T*)v,
                                      (const T*)dout, lse, delta, (T*)dk,
                                      (T*)dv, a);
  return (int)cudaGetLastError();
}

template <int D, typename T, bool EXT = false>
int launch_bwd_mma(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv,
                   const Args& a, cudaStream_t st) {
  auto kdq = flash_dq_mma<D, EXT, T>;
  auto kdkv = flash_dkv_mma<D, T>;
  cudaError_t e = allow_smem(kdq, dq_mma_smem<D>());
  if (e == cudaSuccess) e = allow_smem(kdkv, dkv_mma_smem<D>());
  if (e != cudaSuccess) return (int)e;
  dim3 gq((a.Lq + kTile - 1) / kTile, a.B * a.H);
  kdq<<<gq, kMmaT, dq_mma_smem<D>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      lse, delta, (T*)dq, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gk((a.Lk + kTile - 1) / kTile, a.B * a.H, D / kDkvCols<D>);
  kdkv<<<gk, kMmaT, dkv_mma_smem<D>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, a);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Lq, int Lk, int H, int D, int dtype) {
  return B < 1 || Lq < 1 || Lk < 1 || H < 1 || bad_width(D) || dtype < 0 ||
         dtype > 2;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16, 2 = f16
// bias: (B, Lk) f32 additive key mask, or null for none
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, float* lse, const float* bias, int B,
                        int Lq, int Lk, int H, int D, int causal, int dtype,
                        float scale, unsigned thr, float inv,
                        unsigned seed_lo, unsigned seed_hi, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, causal, scale, thr, inv, seed_lo,
                           seed_hi, bias);
  cudaStream_t st = (cudaStream_t)stream;
  return by_width(D, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if (dtype == 0) return launch_fwd_f32<W>(q, k, v, out, lse, a, st);
    if (dtype == 2) return launch_fwd_mma<W, __half>(q, k, v, out, lse, a, st);
    return launch_fwd_mma<W, __nv_bfloat16>(q, k, v, out, lse, a, st);
  });
}

int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv,
                        const float* bias, int B, int Lq, int Lk, int H,
                        int D, int causal, int dtype, float scale,
                        unsigned thr, float inv, unsigned seed_lo,
                        unsigned seed_hi, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, causal, scale, thr, inv, seed_lo,
                           seed_hi, bias);
  cudaStream_t st = (cudaStream_t)stream;
  return by_width(D, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if (dtype == 0)
      return launch_bwd_f32<W>(q, k, v, o, dout, lse, delta, dq, dk, dv, a,
                               st);
    if (dtype == 2)
      return launch_bwd_mma<W, __half>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, a, st);
    return launch_bwd_mma<W, __nv_bfloat16>(q, k, v, o, dout, lse, delta, dq,
                                            dk, dv, a, st);
  });
}

// the external-lse backward: lse and delta (B*H, Lq) f32 from the
// caller; no dropout; f32, bf16 or f16
int flash_attention_bwd_ext(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, void* dk, void* dv,
                            const float* bias, int B, int Lq, int Lk, int H,
                            int D, int causal, int dtype, float scale,
                            void* stream) {
  if (bad_shape(B, Lq, Lk, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, causal, scale, 0u, 1.0f, 0u, 0u,
                           bias);
  cudaStream_t st = (cudaStream_t)stream;
  float* dl = const_cast<float*>(delta);  // read only when EXT
  return by_width(D, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if (dtype == 0)
      return launch_bwd_f32<W, true>(q, k, v, nullptr, dout, lse, dl, dq, dk,
                                     dv, a, st);
    if (dtype == 2)
      return launch_bwd_mma<W, __half, true>(q, k, v, nullptr, dout, lse, dl,
                                             dq, dk, dv, a, st);
    return launch_bwd_mma<W, __nv_bfloat16, true>(q, k, v, nullptr, dout, lse,
                                                  dl, dq, dk, dv, a, st);
  });
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
