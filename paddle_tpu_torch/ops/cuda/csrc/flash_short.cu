// Short-sequence flash attention for Hopper (sm_90a): 128 <= L <= 512,
// L % 128 == 0, Lq == Lk, head_dim 64, 128, 192 or 256.
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas/flash_attention.py:
// _flash_attention_core_short_fwd (_short_fwd_kernel: a direct, not
// online, softmax over the whole (L, L) row; out and lse) and
// _flash_attention_core_short_bwd (_short_bwd_kernel: dq, dk and dv in
// ONE launch from lse), including the in-kernel dropout.
//
// Bound: at BERT's seq 512 (D = 64) a head is 4*L*L*D flops forward and
// 10*L*L*D backward against 4*L*D and 8*L*D 2-byte elements moved: near
// the card's balance point at the bf16 (and f16) tensor-core rate (BERT phase 2's
// forward: 0.030 ms of bytes, 0.026 of operations; its backward 0.060
// and 0.065).
//
// Forward, bf16 (short_fwd_mma, on tensor cores): the streaming
// forward's body (flash_common.cuh fwd_mma, described in
// flash_attention.cu's header), here with no key mask. The TPU kernel's
// direct softmax needs the whole score row, which at L = 512 no longer
// fits beside the operands, so the block runs the online softmax instead
// (the same function in another summation order; lse is held to 1e-4).
// P enters P V as two bf16 terms, hi + lo: with one term BERT phase 2's
// first loss lay 1.4e-3 from the f32 FMA kernel's (11.0849 against
// 11.0863), with two 7e-4.
// f16 (AMP O1 fp16, short_fwd_mma<D, __half>): the same body over the
// f16 mma, with P into P V as ONE f16 term (fwd_mma's P_ONE). P lies in
// [0, 1/(1-p)], inside f16's range, and f16 keeps 11 bits where bf16
// keeps 8, so one rounding of P moves out by about 2^-11 of its terms'
// 2-norm, inside the per-element 2-byte rule of chip_smoke.py's checks
// (one unit of the type plus four unit roundoffs of that norm): at BERT phase 2's 32 x 512 x
// 12 x 64 with dropout 0.1 one term used 0.508 of the rule's tolerance
// (0.407 with a peaked softmax, q x 8) against hi + lo's 0.328 (0.269),
// and the forward took 0.238 ms against 0.268 (tools/flash_f16_lift.py
// on an H100 at 700 W, K1a f16 being the hi + lo form of the same body;
// PERF.md). So K1c f16 takes one term. Its lse is K1a f16's bit for bit;
// its out is not.
//
// Backward, bf16 or f16 (short_bwd_mma, on tensor cores): one launch, one
// thread-block cluster of L / 64 CTAs per (b, h), each CTA owning a kv
// tile and a q tile's dQ; the partial dQ of every (kv tile, q tile) pair
// goes to its owner through distributed shared memory and is summed
// there in a fixed order, so no dQ scratch crosses device memory (the
// f32 FMA form moved 64 x 32 KB of it per head at L = 512). The
// products and the rounding are K1b's streaming pair's (flash_dq_mma +
// flash_dkv_mma: dS as hi + lo into dQ and dK, the dropped P as one
// bf16 term into dV), but S, dP and the dropout bits are computed once
// per tile pair instead of twice. Over f16 dS is lifted by a power of
// two before its rounding, as in K1b's f16 form, with one exponent a
// (row, kv tile) for dQ's partials and one a CTA for dK. Details above
// the kernel.
//
// At D = 192 and 256 (the wide library, FLASH_WIDE) both 2-byte kernels
// run on wgmma warpgroups with TMA copies: the forward is
// flash_wide.cuh's fwd_wg (short_fwd_wg, 128-row q tiles), the backward
// short_bwd_wg, one cluster of L / 64 CTAs a head whose CTAs keep the
// whole D over two consumer warpgroups (dV in one, dK in the other), S and
// dP formed once a tile pair, and dQ summed in an f32 scratch in device
// memory in short_bwd_mma's order (the inboxes do not fit beside the
// operand ring). Details above the kernel.
//
// f32 (short_fwd_kernel and short_bwd_kernel, the parity route held to
// 1e-4, which TF32 cannot meet) uses f32 FMA from shared memory, one
// block per (b, h) for the whole sequence (at D = 256 the forward takes
// k and v in column halves, and at D = 192 and 256 the backward loads V
// and Q in turn into one tile: kShortKC, kShortWide):
// - Forward: the stripe's scores S = (q * scale) k^T against every
//   kv-tile (k streamed through one [64][D+1] tile) stay in shared
//   memory as a [64][L+4] f32 stripe (128 KB at L = 512). Then one pass
//   over each stripe row takes its max and its sum of exp (the direct
//   softmax), writes lse = m + log(l), and turns S into the dropped,
//   normalised P in place; then P v, with v streamed through the same
//   tile. 165 KB at D = 64, 198 KB at D = 128: one block a multiprocessor.
// - Backward: lse and delta = rowsum(dO * O) of the whole head first go
//   to shared memory. The outer loop is over kv-tiles, whose dK and dV
//   accumulate in registers; the inner loop is over q-tiles, which
//   recompute P = exp(S - lse) and dS = P (dP - delta). dQ accumulates
//   in an f32 scratch (B*H, L, D) in device memory that only this block
//   touches (each element by one thread, written on the first kv-tile
//   and added to after), and is scaled and cast to the input type at
//   the end. No atomics, and nothing another block writes is read, so
//   results are deterministic. 104 KB at D = 64, 170 KB at D = 128.
// - Dropout: the streaming kernels' Philox keying (flash_common.cuh):
//   counter (g, query row, b*H + h, 0) by element coordinates, so the
//   short and the streaming kernels drop the same elements for one seed
//   and philox_keep_mask is the plain version's mask. As in the TPU
//   kernel, l sums the undropped probabilities; P v, dV and dP see the
//   mask scaled by 1/(1-p).
#include "flash_common.cuh"
#ifdef FLASH_WIDE
#include "flash_wide.cuh"
#endif

namespace {

constexpr int kMaxL = 512;

// The f32 forward's k / v tile holds D / kc columns: at D = 256 a whole
// [64][D+1] tile does not fit beside the [64][L+4] score stripe, so the
// block takes K and V in two column halves (kShortKC = 2), S summing the
// halves in the order of one pass.
template <int D>
constexpr size_t short_fwd_smem(int L, int kc) {
  return sizeof(float) *
         (kTile * D + kTile * (D / kc + 1) + (size_t)kTile * (L + 4));
}
template <int D>
constexpr int kShortKC = short_fwd_smem<D>(kMaxL, 1) > kSmemMax ? 2 : 1;

// The f32 backward's shared memory; where K, V, Q, dO and the two P/dS
// tiles do not fit (D = 192 and 256: kShortWide), V and Q take turns in
// one tile (Q loaded again for dS^T Q) and dS [q][kv] and dS^T [kv][q]
// take turns in the P tile.
template <int D>
constexpr size_t short_bwd_smem(int L, bool wide) {
  return sizeof(float) *
         (wide ? kTile * (D + 1) * 2 + kTile * D + kTile * kPad
               : kTile * (D + 1) * 2 + kTile * D * 2 + kTile * kPad * 2) +
         sizeof(float) * 2 * (size_t)L;
}
template <int D>
constexpr bool kShortWide = short_bwd_smem<D>(kMaxL, false) > kSmemMax;

// ---------------------------------------------------------------------------
// forward, f32: one block per b*H + h
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kT)
short_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Args a) {
  constexpr int KC = kShortKC<D>, KW = D / KC;   // k / v column chunks
  extern __shared__ float4 smem4[];
  const int L = a.Lq, ls = L + 4;
  float* Qs = reinterpret_cast<float*>(smem4);   // [64][D], scaled
  float* KVs = Qs + kTile * D;                    // [64][KW+1]: k, then v
  float* Ss = KVs + kTile * (KW + 1);             // [64][L+4]: S, then P
  constexpr int C = KW / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const bool drop = a.inv != 1.0f;

  for (int q0 = 0; q0 < L; q0 += kTile) {
    const int nkv = kv_tiles_for(a, q0);
    const int ncol = nkv * kTile;
    load_tile<T, D>(Qs, D, q, a, b, h, q0, L, a.scale);
    // 1. the stripe's scores
    for (int t = 0; t < nkv; ++t) {
      const int kv0 = t * kTile;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc) __syncthreads();
        load_tile<T, D, KW>(KVs, KW + 1, k, a, b, h, kv0, L, 1.0f, kc * KW);
        __syncthreads();
        mm<4, 4, KW>(s, Qs + kc * KW, D, ty * 4, KVs, 1, KW + 1, tx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = kv0 + tx + 16 * j;
          Ss[r * ls + col] = dead(a, q0 + r, col) ? -INFINITY : s[i][j];
        }
      }
      __syncthreads();
    }
    // 2. direct softmax of each row (one half-warp a row): max, sum,
    //    lse, then P = exp(S - m) / l with the dropout mask, in place
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
      float* srow = Ss + r * ls;
      float mx = -INFINITY;
      for (int c = tx; c < ncol; c += 16) mx = fmaxf(mx, srow[c]);
      mx = half_warp_max(mx);
      float sum = 0.0f;
      for (int c = tx; c < ncol; c += 16) {
        const float e = expf(srow[c] - mx);
        srow[c] = e;
        sum += e;
      }
      const float l = fmaxf(half_warp_sum(sum), 1e-30f);
      if (tx == 0) lse[(int64_t)bh * L + row] = mx + logf(l);
      for (int kv0 = 0; kv0 < ncol; kv0 += kTile) {
        bool keep[4] = {true, true, true, true};
        if (drop) keep4(a, bh, row, kv0, tx, keep);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = kv0 + tx + 16 * j;
          const float p = srow[c] / l;
          srow[c] = drop ? (keep[j] ? p * a.inv : 0.0f) : p;
        }
      }
    }
    __syncthreads();
    // 3. out = P v
    float acc[KC][4][C];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[kc][i][j] = 0.0f;
    for (int t = 0; t < nkv; ++t) {
      const int kv0 = t * kTile;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        load_tile<T, D, KW>(KVs, KW, v, a, b, h, kv0, L, 1.0f, kc * KW);
        __syncthreads();
        mm<4, C, kTile>(acc[kc], Ss + kv0, ls, ty * 4, KVs, KW, 1, tx);
        __syncthreads();
      }
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      store_rows<T, D, KW>(out, acc[kc], a, b, h, q0, L, 1.0f, kc * KW);
  }
}

// ---------------------------------------------------------------------------
// forward, bf16 or f16 on tensor cores: one block per (64-row q tile,
// b*H + h), the streaming forward's body (flash_common.cuh fwd_mma, no
// key mask)
// ---------------------------------------------------------------------------
#ifndef FLASH_WIDE
template <int D, typename T>
__global__ void __launch_bounds__(kMmaT, D == 64 ? 4 : D == 128 ? 2 : 1)
short_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, Args a) {
  // causal: the longest q tiles start first; f16 takes P as one term
  fwd_mma<D, false, T, kIsHalf<T>>(
      q, k, v, out, lse, a,
      a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}
#else
// at D = 192 and 256 the wgmma body (flash_wide.cuh's fwd_wg), one block
// per (128-row q tile, b*H + h)
template <int D, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
short_fwd_wg(const __grid_constant__ WideFwd<T> p) {
  // causal: the longest q tiles start first; f16 takes P as one term
  fwd_wg<D, false, T, kIsHalf<T>>(
      p, p.a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}
#endif

// ---------------------------------------------------------------------------
// backward: dq, dk, dv in one launch, one block per b*H + h
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kT)
short_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ dq_acc, T* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, Args a) {
  constexpr bool WIDE = kShortWide<D>;
  extern __shared__ float4 smem4[];
  const int L = a.Lq;
  float* Ks = reinterpret_cast<float*>(smem4);   // [64][D+1]
  float* Vs = Ks + kTile * (D + 1);               // [64][D+1]
  float* Qs = WIDE ? Vs : Vs + kTile * (D + 1);   // [64][D], scaled (WIDE:
                                                  // V's tile)
  float* dOs = WIDE ? Vs + kTile * (D + 1) : Qs + kTile * D;   // [64][D]
  float* Ts = dOs + kTile * D;                    // [64 kv][kPad]: P or dS
  float* dSs = WIDE ? Ts : Ts + kTile * kPad;     // [64 q][kPad]: dS (WIDE:
                                                  // T's tile)
  float* lse_s = dSs + kTile * kPad;              // [L]
  float* delta_s = lse_s + L;                     // [L]
  constexpr int C = D / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const bool drop = a.inv != 1.0f;
  float* dqh = dq_acc + (int64_t)bh * L * D;      // this head's scratch

  // lse and delta = rowsum(dO * O) of every row: four threads a row
  for (int r0 = 0; r0 < L; r0 += kT / 4) {
    const int r = r0 + (tid >> 2), part = tid & 3;
    const int64_t off = (((int64_t)b * L + r) * a.H + h) * D;
    float d = 0.0f;
    for (int c = part; c < D; c += 4)
      d = fmaf(Vec<T>::one(dout + off + c), Vec<T>::one(o + off + c), d);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      delta_s[r] = d;
      lse_s[r] = lse[(int64_t)bh * L + r];
    }
  }

  const int nt = L / kTile;
  for (int kt = 0; kt < nt; ++kt) {
    const int kv0 = kt * kTile;
    load_tile<T, D>(Ks, D + 1, k, a, b, h, kv0, L, 1.0f);
    if (!WIDE) load_tile<T, D>(Vs, D + 1, v, a, b, h, kv0, L, 1.0f);
    float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;
    // causal: q-tiles above this kv-tile see none of it; kv-tile 0 visits
    // every q-tile, so it is the one that writes the dQ scratch first
    for (int qt = a.causal ? kt : 0; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      load_tile<T, D>(Qs, D, q, a, b, h, q0, L, a.scale);
      load_tile<T, D>(dOs, D, dout, a, b, h, q0, L, 1.0f);
      __syncthreads();
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
      mm<4, 4, D>(s, Qs, D, ty * 4, Ks, 1, D + 1, tx);
      if (WIDE) {
        __syncthreads();
        load_tile<T, D>(Vs, D + 1, v, a, b, h, kv0, L, 1.0f);
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
          const float p = dead(a, row, kv0 + c) ? 0.0f
                                                : expf(s[i][j] - lse_s[row]);
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
      // dS = P (dP - delta), into dSs ([q][kv]) and T (transposed; WIDE:
      // after dS K, in the same tile)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float dl = delta_s[q0 + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = s[i][j] * (dp[i][j] - dl);
          dSs[r * kPad + tx + 16 * j] = s[i][j];
          if (!WIDE) Ts[(tx + 16 * j) * kPad + r] = s[i][j];
        }
      }
      __syncthreads();
      // this q tile's part of dQ = dS K, 64 columns at a time, into the
      // scratch
      for (int c0 = 0; c0 < D; c0 += 64) {
        float dq_part[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dq_part[i][j] = 0.0f;
        mm<4, 4, kTile>(dq_part, dSs, kPad, ty * 4, Ks + c0, D + 1, 1, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* dst = dqh + (int64_t)(q0 + ty * 4 + i) * D + c0 + tx;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dst[16 * j] =
                kt == 0 ? dq_part[i][j] : dst[16 * j] + dq_part[i][j];
        }
      }
      if (WIDE) {
        __syncthreads();   // dS K has read dSs
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Ts[(tx + 16 * j) * kPad + ty * 4 + i] = s[i][j];
        load_tile<T, D>(Qs, D, q, a, b, h, q0, L, a.scale);
        __syncthreads();
      }
      mm<4, C, kTile>(dk_acc, Ts, kPad, ty * 4, Qs, D, 1, tx);
      __syncthreads();   // the next q-tile overwrites Qs, dOs, T and dSs
    }
    store_rows<T, D>(dk, dk_acc, a, b, h, kv0, L, 1.0f);
    store_rows<T, D>(dv, dv_acc, a, b, h, kv0, L, 1.0f);
  }
  __syncthreads();
  // dq = scale * scratch, in the input type
  for (int idx = tid; idx < L * D; idx += kT) {
    const int r = idx / D, c = idx % D;
    dq[(((int64_t)b * L + r) * a.H + h) * D + c] =
        Vec<T>::put(dqh[idx] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// backward, bf16 or f16 on tensor cores: one thread-block cluster per
// b*H + h
// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) of the q tile a CTA owns (rows r0 ..) in f32
// into dl_s [64], two threads a row: the cluster kernels' prologue
// (short_bwd_mma, short_bwd_wg)
template <int D, typename T>
__device__ __forceinline__ void owner_delta(float* dl_s,
                                            const T* __restrict__ dout,
                                            const T* __restrict__ o,
                                            const Args& a, int b, int h,
                                            int r0) {
  const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
  const int64_t off = (((int64_t)b * a.Lq + r0 + r) * a.H + h) * D +
                      part * (D / 2);
  float d = 0.0f, x[8], y[8];
#pragma unroll
  for (int col = 0; col < D / 2; col += 8) {
    Vec<T>::load(dout + off + col, x);
    Vec<T>::load(o + off + col, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) d = fmaf(x[e], y[e], d);
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  if (part == 0) dl_s[r] = d;
}

// The dQ accumulator of the q tile a CTA owns, in the fragment map of its
// warps (warp w: rows 16 w ..): registers at D = 64; at D = 128 shared
// memory, element (j, e) of thread t at [(4 j + e) * 128 + t], since the
// dK and dV accumulators already take 128 registers a thread there.
template <int D, bool REG = (D == 64)>
struct DqAcc {
  float v[D / 8][4];
  __device__ explicit DqAcc(float*) {}
  __device__ __forceinline__ float& at(int j, int e) { return v[j][e]; }
};

template <int D>
struct DqAcc<D, false> {
  float* base;
  __device__ explicit DqAcc(float* b) : base(b + threadIdx.x) {}
  __device__ __forceinline__ float& at(int j, int e) {
    return base[(4 * j + e) * kMmaT];
  }
};

// The owner of q tile c adds step t's part, which its visitor (c - t) mod
// n left in inbox ``box``, if that visitor had work (causal: it visits
// only q tiles at or below the diagonal).
template <int D>
__device__ __forceinline__ void absorb(DqAcc<D>& acc,
                                       const unsigned char* box, int c,
                                       int t, int n, int causal) {
  if (causal && (c - t + n) % n > c) return;
  const float4* x4 = reinterpret_cast<const float4*>(box);
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const float4 x = x4[jj * kMmaT + threadIdx.x];
    acc.at(jj, 0) += x.x;
    acc.at(jj, 1) += x.y;
    acc.at(jj, 2) += x.z;
    acc.at(jj, 3) += x.w;
  }
}

template <int D, typename T>
constexpr size_t short_bwd_mma_smem() {
  // k, v; 2 q, 2 dO; P, dS hi, dS lo; 2 dQ inboxes; delta; (D = 128) acc;
  // (f16) the warps' largest |dS| and P
  return (size_t)6 * kTile * D * 2 + (size_t)3 * kTile * kTile * 2 +
         (size_t)2 * kTile * D * 4 + kTile * 4 +
         (D == 64 ? 0 : (size_t)kTile * D * 4) +
         (kLift<T> ? 2 * kWarps * 4 : 0);
}

// Replaces _short_bwd_kernel on tensor cores: dq, dk and dv in one launch
// from the saved lse. A cluster of n = L / 64 CTAs per (b, h); CTA c owns
// kv tile c (K_c, V_c resident, dK_c and dV_c in registers, warp w on kv
// rows 16 w ..) and q tile c's dQ. At step s = 0 .. n-1 it takes q tile
// j = (c + s) mod n, a permutation, so each q tile has one visitor a
// step: Q_j and dO_j stream through a two-stage cp.async ring; S and dP
// in the q-row layout (each thread's dropout words are its own), P and
// dS in registers, then
//   - the partial dQ_j = dS K_c (dS hi + lo from registers) goes, as f32,
//     into owner j's inbox in distributed shared memory (double-buffered
//     by step parity); owner j adds it to its accumulator after a cluster
//     barrier, so each dQ element sums its n terms in one fixed order
//     (s = 0, 1, ...): no atomics, no device-memory scratch, two
//     launches give the same bits;
//   - the dropped P (one 2-byte term) and dS (hi + lo) go to shared tiles,
//     read back transposed for dV_c += P^T dO_j and dK_c += dS^T Q_j.
// delta = rowsum(dO O) of q tile c is computed by its owner before the
// first step and read by the visitors from the owner's shared memory.
// Causal: CTA c visits only j >= c (steps s < n - c); every CTA still
// meets every barrier and the owner knows who visits when. The barrier
// is split: step s arrives after its inbox store and waits (then adds
// its inbox) in step s + 1, after that step's S, dP and dS, so a step's
// dV/dK products and the next step's scores hide the wait; the two
// inboxes keep a store two steps ahead of the add that empties its
// buffer. 104 KB of shared memory at D = 64 (two CTAs an SM), 216 KB at
// D = 128.
// f16 (T = __half) lifts dS as flash_attention.cu's f16 backward does
// (flash_common.cuh's lift pieces; bf16 compiles none of it): a q row's
// dS is split over the cluster, no CTA sees the whole row, so each
// partial dQ_j takes its own exponent a row (the row's largest |dS| in
// this kv tile) and is scaled back by it in f32 before it enters the
// exchange: the owner adds partials on one scale, in the bf16 form's
// order. dK_c and dV_c sum the 64 q rows of every step's tile: one
// running exponent each for the CTA, raised by the four warps' largest
// |dS| and P through shared memory (one more barrier a step), dK and dV
// scaled back at the store.
template <int D, typename T>
__global__ void __launch_bounds__(kMmaT, D == 64 ? 2 : 1)
short_bwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
              Args a) {
  extern __shared__ __align__(128) unsigned char smem_mma[];
  constexpr uint32_t TB = kTile * D * 2;           // bytes of a 2-byte tile
  constexpr uint32_t PB = kTile * kTile * 2;       // bytes of a P/dS tile
  constexpr uint32_t IB = kTile * D * 4;           // bytes of an inbox
  const uint32_t Ks = smem_u32(smem_mma), Vs = Ks + TB, Qs = Vs + TB,
                 dOs = Qs + 2 * TB, Ps = dOs + 2 * TB, dSs = Ps + PB,
                 dSl = dSs + PB;
  unsigned char* Pp = smem_mma + 6 * TB;
  unsigned char* dSp = Pp + PB;
  unsigned char* dLp = dSp + PB;
  unsigned char* inbox = dLp + PB;                 // [2][D/8][128] float4
  float* dl_s = reinterpret_cast<float*>(inbox + 2 * IB);        // [64]
  DqAcc<D> acc(dl_s + kTile);
  float* wmax = dl_s + kTile + (D == 64 ? 0 : kTile * D);       // [8], f16
  const uint32_t inbox_u = smem_u32(inbox), dl_u = smem_u32(dl_s);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int L = a.Lq, n = L / kTile;
  const int c = (int)cluster_rank(), kv0 = c * kTile;
  const int nact = a.causal ? n - c : n;           // steps with work

  tile_async<D>(Ks, k, a, b, h, kv0, L);
  tile_async<D>(Vs, v, a, b, h, kv0, L);
  tile_async<D>(Qs, q, a, b, h, kv0, L);           // step 0: j = c
  tile_async<D>(dOs, dout, a, b, h, kv0, L);
  cp_commit();
  owner_delta<D>(dl_s, dout, o, a, b, h, kv0);     // under the copies
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;
  const float bv[8][2] = {};                       // the short forms: no bias
  int lift = kLiftMin;       // f16: dK's exponent (the CTA's)
  int plift = kLiftMin;      // f16: dV's
  int row_lift[2] = {0, 0};  // f16: this step's dQ partial's, a row
  cluster_arrive();     // delta is written and every CTA has started
  cluster_wait();

  for (int st = 0; st < n; ++st) {
    const int j = (c + st) % n, q0 = j * kTile, row0 = q0 + 16 * w;
    const bool act = st < nact;
    const uint32_t stg = (st & 1) * TB, Qt = Qs + stg, dOt = dOs + stg;
    float s[8][4], dp[8][4];
    if (act) {
      if (st + 1 < nact) {
        const int nq = ((c + st + 1) % n) * kTile;
        tile_async<D>(Qs + TB - stg, q, a, b, h, nq, L);
        tile_async<D>(dOs + TB - stg, dout, a, b, h, nq, L);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      float lse_r[2], dl_r[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = 16 * w + frag_row(lane, 2 * r);
        lse_r[r] = lse[(int64_t)bh * L + q0 + rr];
        dl_r[r] = ld_cluster(cluster_map(dl_u + 4 * rr, j));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.0f;
      mma_abt<D, T>(s, Qt, 16 * w, Ks, lane);     // S = Q K^T
      mma_abt<D, T>(dp, dOt, 16 * w, Vs, lane);   // dP = dO V^T
      grad_scores<true>(s, dp, a, bh, row0, kv0, bv, lse_r, dl_r, lane);
      if constexpr (kLift<T>) {
        const float m0 = tile_absmax(s, 0), m1 = tile_absmax(s, 1);
        row_lift[0] = lift_exp(m0);
        row_lift[1] = lift_exp(m1);
        float ms = fmaxf(m0, m1), mp = tile_absmax(dp, -1);
        block_absmax2(ms, mp, wmax, w, lane);
        raise_lift(lift, lift_exp(ms), dka, -1);
        raise_lift(plift, lift_exp(mp), dva, -1);
        scale_tile(s, lift);
        scale_tile(dp, plift);
      }
      store_frag<T>(Pp, nullptr, dp, w, lane);    // dropped P, one term
      store_frag<T>(dSp, dLp, s, w, lane);        // dS, hi + lo
      if constexpr (kLift<T>) {
        // dK's scale to the dQ partial's: dS 2^-row_lift, a row
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][e] = times_pow2(s[i][e], lift - row_lift[e >> 1]);
      }
    }
    if (st > 1) {
      // the last step's barrier, then its visitor's part of q tile c
      cluster_wait();
      absorb<D>(acc, inbox + ((st - 1) & 1) * IB, c, st - 1, n, a.causal);
    }
    if (act) {
      // partial dQ_j = dS K_c, 64 columns at a time, into owner j's inbox
      // (this step's buffer), or straight into the accumulator at s = 0
      const uint32_t dst = cluster_map(inbox_u + (st & 1) * IB, j);
#pragma unroll
      for (int hh = 0; hh < D / 64; ++hh) {
        float part[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t fa[4], fl[4];
          acc_to_a2<T>(fa, fl, s, kk);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            uint32_t fb[4];
            frag_bt<D>(fb, Ks, 64 * hh + 16 * nn, 16 * kk, lane);
            mma16816<T>(part[2 * nn], fa, fb[0], fb[1]);
            mma16816<T>(part[2 * nn + 1], fa, fb[2], fb[3]);
            mma16816<T>(part[2 * nn], fl, fb[0], fb[1]);
            mma16816<T>(part[2 * nn + 1], fl, fb[2], fb[3]);
          }
        }
        if constexpr (kLift<T>) {   // back to dS's own scale, in f32
          const float f[2] = {pow2i(row_lift[0]), pow2i(row_lift[1])};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][e] *= f[e >> 1];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int jj = 8 * hh + i;
          if (st == 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc.at(jj, e) = part[i][e];
          } else {
            st_cluster4(dst + (uint32_t)(jj * kMmaT + tid) * 16, part[i]);
          }
        }
      }
    }
    if (st > 0) cluster_arrive();
    if (act) {
      __syncthreads();                          // P and dS are in place
      // warp w: kv rows 16 w .. of dV += P^T dO and dK += dS^T Q
      dkv_products<D, T>(dva, dka, Ps, dSs, dSl, dOt, Qt, 0, w, lane);
    }
    __syncthreads();     // P, dS, the warps' maxima and the stage are
  }                      // rewritten next
  cluster_wait();        // the last step's barrier (n >= 2)
  absorb<D>(acc, inbox + ((n - 1) & 1) * IB, c, n - 1, n, a.causal);
  float out[D / 8][4];
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[jj][e] = acc.at(jj, e);
  store_acc<D>(dq, out, a, b, h, kv0 + 16 * w, L, a.scale, lane);
  store_acc<D>(dk, dka, a, b, h, kv0 + 16 * w, L,
               kLift<T> ? a.scale * pow2i(lift) : a.scale, lane);
  store_acc<D>(dv, dva, a, b, h, kv0 + 16 * w, L,
               kLift<T> ? pow2i(plift) : 1.0f, lane);
}

#ifdef FLASH_WIDE
// ---------------------------------------------------------------------------
// backward, bf16 or f16 on wgmma at D = 192 and 256: one thread-block
// cluster per b*H + h
// ---------------------------------------------------------------------------
// short_bwd_mma's design does not fit these widths: its dK and dV
// accumulators (2 D / 8 x 4 f32 a thread in one 4-warp block) pass the
// register file, and its f32 dQ inboxes and accumulator put a CTA at 320
// KB (D = 192) and 418 KB (D = 256) of shared memory. short_bwd_wg keeps
// its cluster (n = L / 64 CTAs a (b, h), CTA c owning kv tile c, K_c and
// V_c resident, q tile j = (c + s) mod n at step s, causal only j >= c)
// and splits each step's products over two consumer warpgroups of one
// CTA, so the whole D stays in one CTA and S, dP, P and dS are formed
// once a tile pair (5 products of 64 x 64 x D where the parent's two
// clusters a head, one a column half, needed 7):
//   - the copies are TMA: K_c and V_c once, Q_j and dO_j a step into a
//     two-stage ring, issued by warpgroup 1's first warp, which refills a
//     stage once every warp has released it (the block is two warpgroups,
//     256 threads, so that a thread may hold 255 registers: a producer
//     warpgroup with setmaxnreg left ptxas at 168 and spilling, as
//     flash_wide.cuh's header says);
//   - warpgroup 0: S = Q_j K_c^T and dP = dO_j V_c^T (wgmma m64n64k16,
//     q rows in the accumulator's rows, so each thread's dropout words are
//     its own: keep_frag), then P, the dropped dP and dS = P (dP - delta)
//     in f32 (grad_scores, short_bwd_mma's arithmetic), stores the dropped
//     P (one 2-byte term) and dS (hi + lo) into shared tiles and runs
//     dV_c += P^T dO_j (wgmma, both operands MN-major) into its registers;
//     each q row's lse (device memory) and delta (its owner's shared
//     memory) are read under the products;
//   - warpgroup 1: dK_c += dS^T Q_j (hi + lo) into its registers. A stage
//     is released as soon as its last reader's product is done (the dQ
//     passes read only the dS tiles and K_c).
// dS and P pass between the two through the shared tiles, ordered by
// named barriers (a single set of tiles: warpgroup 0 writes step s + 1's
// once warpgroup 1 has read step s's). Only one place holds both P and dP
// in f32, so dS is formed where both are, with short_bwd_mma's rounding.
// dQ_j's partial dS K_c goes in passes of 64 columns from the dS tiles
// (warpgroup 0 the first pass, warpgroup 1 the others: the two carry
// about the same products); over f16 warpgroup 0 forms every pass from
// its registers, with dS lifted by each row's own exponent as in
// short_bwd_mma (the shared tiles carry the CTA's exponent, dK's).
// The partials are summed in the caller's f32 scratch (dq_acc, (B*H, L,
// D), each thread's 16-byte words in the fragment map) in device memory:
// two f32 inboxes of 64 x D do not fit beside the operand ring (DSMEM
// would need 64 KB more at D = 256). Step s's visitor of q tile j adds its
// part to what step s - 1's visitor, CTA c + 1, left (s = 0 writes its
// part), and the last visitor (step n - 1; causal: CTA 0) rounds the
// sum, times the scale, to q's type into dq: each dQ element sums its n
// parts in one fixed order, no atomics, two launches give the same bits.
// The order is kept without cluster barriers: each warpgroup that forms
// dQ counts in its left neighbour's shared memory (red.release.cluster,
// one a thread and step) and waits for its own count (ld.acquire.cluster)
// before it reads the scratch; the scratch is read before the pass's
// product is issued, so the load runs under it. Two cluster barriers
// remain: after every owner's delta is written and before any CTA
// leaves. Shared memory: K, V, two Q and two dO stages, P, dS hi and lo:
// 216 KB at D = 256, 168 KB at D = 192, one CTA an SM.
// f16 lifts dS and P by powers of two as short_bwd_mma does: warpgroup 0
// raises the running exponents from its four warps' largest |dS| and P
// (one more named barrier a step) and hands dK's to warpgroup 1 with the
// dS tiles.
template <typename T>
struct WideBwd {
  CUtensorMap q, k, v, dout;   // (B, L, H, D), 64 x 64 boxes
  const T* o;                  // out and dO for delta
  const T* dout_p;
  const float* lse;
  float* dq_acc;
  T *dq, *dk, *dv;
  Args a;
};

template <int D>
constexpr size_t short_bwd_wg_smem() {
  // K, V, 2 Q, 2 dO; P, dS hi, dS lo; delta of the CTA's own q tile; the
  // warps' largest |dS| and P (f16); 5 mbarriers; dK's exponent (f16);
  // the dQ counts of the two warpgroups
  return (size_t)6 * kTileBytes<D> + (size_t)3 * kBlk + kTile * 4 +
         2 * kWarps * 4 + 5 * 8 + 4 + 2 * 4;
}

// the dQ chain: wait until this CTA's count of the warpgroup reaches want
__device__ __forceinline__ void chain_wait(uint32_t cnt, uint32_t want) {
  uint32_t v;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];\n"
                 : "=r"(v) : "r"(cnt) : "memory");
    if (v >= want) return;
    if (t0 == 0)
      t0 = global_ns();
    else if (global_ns() - t0 > kHangNs)
      __trap();
  }
}

// the dQ chain: one count in a peer's shared memory (``cnt`` mapped into
// the cluster window), released after this thread's scratch stores
__device__ __forceinline__ void chain_signal(uint32_t cnt) {
  asm volatile("red.release.cluster.shared::cluster.add.u32 [%0], %1;\n" ::"r"(
                   cnt),
               "r"(1u)
               : "memory");
}

// N n-tiles from i0 of one 64-column pass (columns 64 cb ..) of q tile
// j's dQ for this thread: ``part`` (n-tiles 8 cb .. of the fragment map)
// plus ``prev``, what step st - 1's visitor left (dq_prev), into the
// scratch words ``sum``; the last visitor writes dq, times the scale,
// instead
template <int D, int N, typename T>
__device__ __forceinline__ void dq_put(const float (&part)[32],
                                       const float4 (&prev)[N], int i0,
                                       bool first, bool last, float4* sum,
                                       T* dq, const Args& a, int b, int h,
                                       int row0, int cb, int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = i0 + n;
    float4 x = make_float4(part[4 * i], part[4 * i + 1], part[4 * i + 2],
                           part[4 * i + 3]);
    if (!first)
      x = make_float4(prev[n].x + x.x, prev[n].y + x.y, prev[n].z + x.z,
                      prev[n].w + x.w);
    if (last) {
      const float xs[4] = {x.x, x.y, x.z, x.w};
      store_ntile<D>(dq, xs, a, b, h, row0, a.Lq, 64 * cb + 8 * i, a.scale,
                     lane);
    } else {
      __stcg(sum + (8 * cb + i) * kMmaT, x);
    }
  }
}

// what step st - 1's visitor left for n-tiles i0 .. i0 + N - 1 of pass
// cb, read before it is needed (the reads wait behind this thread's
// scratch stores, so they go in a batch)
template <int N>
__device__ __forceinline__ void dq_prev(float4 (&prev)[N], const float4* sum,
                                        int cb, int i0 = 0) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    prev[n] = __ldcg(sum + (8 * cb + i0 + n) * kMmaT);
}

// the largest |dS| and P over warpgroup 0's 64 x 64 tile (block_absmax2
// over its four warps, through a named barrier)
__device__ __forceinline__ void wg_absmax2(float& a, float& b, float* wmax,
                                           int w, int lane) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (lane == 0) {
    wmax[w] = a;
    wmax[kWarps + w] = b;
  }
  bar_sync(3, kMmaT);
  a = fmaxf(fmaxf(wmax[0], wmax[1]), fmaxf(wmax[2], wmax[3]));
  b = fmaxf(fmaxf(wmax[4], wmax[5]), fmaxf(wmax[6], wmax[7]));
}

// named barriers: 1 the dS tiles are written (warpgroup 0 -> 1), 2 they
// are read (1 -> 0), 3 warpgroup 0 alone
constexpr int kBarDsFull = 1, kBarDsFree = 2, kBarWg0 = 3;

template <int D, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
short_bwd_wg(const __grid_constant__ WideBwd<T> p) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  constexpr uint32_t TB = kTileBytes<D>;
  // f16: warpgroup 0 forms every dQ pass from its registers (dS by each
  // row's exponent); bf16: warpgroup 0 the first kW0 passes from the dS
  // tiles, warpgroup 1 the rest
  constexpr bool kQ0All = kLift<T>;
  constexpr int kW0 = kLift<T> ? D / 64 : 1;
  const Args& a = p.a;
  const uint32_t Ks = smem_u32(smem_wg), Vs = Ks + TB, Qs = Vs + TB,
                 dOs = Qs + 2 * TB, Ps = dOs + 2 * TB, dSh = Ps + kBlk,
                 dSl = dSh + kBlk;
  unsigned char* Pp = smem_wg + 6 * TB;
  float* dl_s = reinterpret_cast<float*>(Pp + 3 * kBlk);   // [64]
  float* wmax = dl_s + kTile;                              // [8], f16
  const uint32_t kvbar = smem_u32(wmax + 2 * kWarps), full = kvbar + 8,
                 empty = full + 16, dl_u = smem_u32(dl_s);
  int* lift_s = reinterpret_cast<int*>(wmax + 2 * kWarps + 10);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(lift_s + 1);  // [2]
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31,
            w = (tid >> 5) & 3, t128 = tid & (kMmaT - 1);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int L = a.Lq, n = L / kTile;
  const int c = (int)cluster_rank(), kv0 = c * kTile;
  const int nact = a.causal ? n - c : n;           // steps with work

  if (tid < kMmaT) owner_delta<D>(dl_s, p.dout_p, p.o, a, b, h, kv0);
  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);    // every warp
    }
    cnt[0] = cnt[1] = 0u;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();     // delta and the counts are in place, every CTA has
  cluster_wait();       // started
  // warpgroup 1's first warp issues the copies: K_c and V_c, then q tile
  // (c + st) mod n's Q and dO into stage st % 2
  const bool filler = wg == 1 && w == 0;
  auto fill = [&](int st) {
    const int s = st & 1, q0 = ((c + st) % n) * kTile;
    mbar_expect(full + 8 * s, 2 * TB);
    tma_tile<D>(Qs + s * TB, &p.q, b, h, q0, full + 8 * s);
    tma_tile<D>(dOs + s * TB, &p.dout, b, h, q0, full + 8 * s);
  };
  if (filler && lane == 0) {
    mbar_expect(kvbar, 2 * TB);
    tma_tile<D>(Ks, &p.k, b, h, kv0, kvbar);
    tma_tile<D>(Vs, &p.v, b, h, kv0, kvbar);
    for (int st = 0; st < 2 && st < nact; ++st) fill(st);
  }
  // this CTA's q tile sums: q tile j's at [j][D / 8][128] float4
  float4* sums = reinterpret_cast<float4*>(p.dq_acc) +
                 (int64_t)bh * n * (D / 8) * kMmaT + t128;
  const uint32_t cnt_u = smem_u32(cnt + wg);
  const uint32_t cnt_left = cluster_map(cnt_u, (c + n - 1) % n);
  ws_wait(kvbar, 0);

  if (wg == 0) {
    float dva[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dva[j] = 0.0f;
    auto& dv2 = reinterpret_cast<float(&)[D / 8][4]>(dva);
    int lift = kLiftMin;       // f16: dK's exponent (the CTA's)
    int plift = kLiftMin;      // f16: dV's
    const float bv[8][2] = {};                     // the short forms: no bias
    for (int st = 0; st < nact; ++st) {
      const int s = st & 1, j = (c + st) % n, q0 = j * kTile,
                row0 = q0 + 16 * w;
      const uint32_t Qt = Qs + s * TB, dOt = dOs + s * TB;
      const bool last = a.causal ? c == 0 : st == n - 1;
      float4* sum = sums + (int64_t)j * (D / 8) * kMmaT;
      float lse_r[2], dl_r[2];   // the rows' lse and delta (owner j's)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = 16 * w + frag_row(lane, 2 * r);
        lse_r[r] = p.lse[(int64_t)bh * L + q0 + rr];
        dl_r[r] = ld_cluster(cluster_map(dl_u + 4 * rr, j));
      }
      // the dropout bits, before the products' accumulators are live
      const uint32_t keep =
          a.inv != 1.0f ? keep_frag(a, bh, row0, kv0, lane) : ~0u;
      ws_wait(full + 8 * s, (uint32_t)(st >> 1) & 1u);
      float sc[8][4], dp[8][4];
      float(&sf)[32] = reinterpret_cast<float(&)[32]>(sc);
      float(&df)[32] = reinterpret_cast<float(&)[32]>(dp);
      const WgDesc dq_ = wg_k(Qt), dk_ = wg_k(Ks), ddo = wg_k(dOt),
                   dv_ = wg_k(Vs);
      wg_fence();
      wg_ss64<T, 0, 0, true>(sf, dq_.k(0), dk_.k(0));             // S
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wg_ss64<T, 0, 0, false>(sf, dq_.k(kk), dk_.k(kk));
      wg_ss64<T, 0, 0, true>(df, ddo.k(0), dv_.k(0));             // dP
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wg_ss64<T, 0, 0, false>(df, ddo.k(kk), dv_.k(kk));
      wg_commit();
      wg_wait<0>();
      fence_operands(sf);
      fence_operands(df);
      grad_scores_kept<true>(sc, dp, a, keep, row0, kv0, bv, lse_r, dl_r,
                             lane);
      int row_lift[2] = {0, 0};  // f16: this step's dQ partial's, a row
      if constexpr (kLift<T>) {
        const float m0 = tile_absmax(sc, 0), m1 = tile_absmax(sc, 1);
        row_lift[0] = lift_exp(m0);
        row_lift[1] = lift_exp(m1);
        float ms = fmaxf(m0, m1), mp = tile_absmax(dp, -1);
        wg_absmax2(ms, mp, wmax, w, lane);
        lift = max(lift, lift_exp(ms));   // warpgroup 1 rescales dK by it
        raise_lift(plift, lift_exp(mp), dv2, -1);
        scale_tile(sc, lift);
        scale_tile(dp, plift);
      }
      bar_sync(kBarDsFree, 2 * kMmaT);   // warpgroup 1 read the last tiles
      store_frag<T>(Pp, nullptr, dp, w, lane);            // dropped P
      store_frag<T>(Pp + kBlk, Pp + 2 * kBlk, sc, w, lane);  // dS, hi + lo
      if (kLift<T> && t128 == 0) *lift_s = lift;
      fence_async_smem();
      bar_arrive(kBarDsFull, 2 * kMmaT);
      bar_sync(kBarWg0, kMmaT);          // the P tile is whole
      fence_operands(dva);
      wg_fence();
      const WgDesc dp_ = wg_mn(Ps), ddo2 = wg_mn(dOt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)     // dV += P^T dO
        wg_ss_t<T, D>(dva, dp_.mn(kk), ddo2.mn(kk));
      wg_commit();
      if (kW0 > 0 && st > 0) chain_wait(cnt_u, (uint32_t)(kMmaT * st));
      if constexpr (kQ0All) {
        // dQ's partial from registers: dS 2^-row_lift, a row (dK's scale
        // to the partial's), every pass
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[i][e] = times_pow2(sc[i][e], lift - row_lift[e >> 1]);
        uint32_t fh[4][4], fl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a2<T>(fh[kk], fl[kk], sc, kk);
        const float f[2] = {pow2i(row_lift[0]), pow2i(row_lift[1])};
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          // the previous sums in two halves of four n-tiles: the registers
          // this form holds beside its operands (at D = 256) allow no more
          float part[32];
          float4 prev[4];
          const WgDesc dkc = wg_mn(Ks + cb * kBlk);
          wg_fence();
          wg_rs64<T, true>(part, fh[0], dkc.mn(0));
          wg_rs64<T, false>(part, fl[0], dkc.mn(0));
#pragma unroll
          for (int kk = 1; kk < 4; ++kk) {
            wg_rs64<T, false>(part, fh[kk], dkc.mn(kk));
            wg_rs64<T, false>(part, fl[kk], dkc.mn(kk));
          }
          wg_commit();
          if (st > 0) dq_prev(prev, sum, cb, 0);
          wg_wait<0>();
          fence_operands(part);
#pragma unroll
          for (int i = 0; i < 32; ++i) part[i] *= f[(i & 3) >> 1];
          dq_put<D>(part, prev, 0, st == 0, last, sum, p.dq, a, b, h, row0,
                    cb, lane);
          if (st > 0) dq_prev(prev, sum, cb, 4);
          dq_put<D>(part, prev, 4, st == 0, last, sum, p.dq, a, b, h, row0,
                    cb, lane);
        }
      } else {
        float4 prev[8];
        if (kW0 > 0 && st > 0) dq_prev(prev, sum, 0);
        wg_wait<0>();                    // dV is done with dO_j
        fence_operands(dva);
        if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
        for (int cb = 0; cb < kW0; ++cb) {
          float part[32];
          if (cb > 0 && st > 0) dq_prev(prev, sum, cb);
          const WgDesc dsh = wg_k(dSh), dsl = wg_k(dSl),
                       dkc = wg_mn(Ks + cb * kBlk);
          wg_fence();
          wg_ss64<T, 0, 1, true>(part, dsh.k(0), dkc.mn(0));
          wg_ss64<T, 0, 1, false>(part, dsl.k(0), dkc.mn(0));
#pragma unroll
          for (int kk = 1; kk < 4; ++kk) {
            wg_ss64<T, 0, 1, false>(part, dsh.k(kk), dkc.mn(kk));
            wg_ss64<T, 0, 1, false>(part, dsl.k(kk), dkc.mn(kk));
          }
          wg_commit();
          wg_wait<0>();
          fence_operands(part);
          dq_put<D>(part, prev, 0, st == 0, last, sum, p.dq, a, b, h, row0,
                    cb, lane);
        }
      }
      if constexpr (kQ0All) {
        wg_wait<0>();
        fence_operands(dva);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      if (kW0 > 0 && !last) chain_signal(cnt_left);
    }
    store_acc<D>(p.dv, dv2, a, b, h, kv0 + 16 * w, L,
                 kLift<T> ? pow2i(plift) : 1.0f, lane);
  } else {
    float dka[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dka[j] = 0.0f;
    auto& dk2 = reinterpret_cast<float(&)[D / 8][4]>(dka);
    int lift = kLiftMin;       // f16: dK's exponent, warpgroup 0's
    bar_arrive(kBarDsFree, 2 * kMmaT);   // no tiles to read before step 0
    for (int st = 0; st < nact; ++st) {
      const int s = st & 1, j = (c + st) % n, row0 = j * kTile + 16 * w;
      const uint32_t Qt = Qs + s * TB;
      const bool last = a.causal ? c == 0 : st == n - 1;
      float4* sum = sums + (int64_t)j * (D / 8) * kMmaT;
      ws_wait(full + 8 * s, (uint32_t)(st >> 1) & 1u);
      bar_sync(kBarDsFull, 2 * kMmaT);   // step st's P and dS are in place
      if constexpr (kLift<T>) raise_lift(lift, *lift_s, dk2, -1);
      fence_operands(dka);
      wg_fence();
      const WgDesc dsh = wg_mn(dSh), dsl = wg_mn(dSl), dq_ = wg_mn(Qt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // dK += dS^T Q, dS hi + lo
        wg_ss_t<T, D>(dka, dsh.mn(kk), dq_.mn(kk));
        wg_ss_t<T, D>(dka, dsl.mn(kk), dq_.mn(kk));
      }
      wg_commit();
      wg_wait<0>();
      fence_operands(dka);
      if (lane == 0) mbar_arrive(empty + 8 * s);   // done with Q_j
      if (filler && st + 2 < nact) {     // every warp released the stage
        if (lane == 0) {
          ws_wait(empty + 8 * s, (uint32_t)(st >> 1) & 1u);
          fill(st + 2);
        }
        __syncwarp();
      }
      if constexpr (!kQ0All && kW0 < D / 64) {
        if (st > 0) chain_wait(cnt_u, (uint32_t)(kMmaT * st));
#pragma unroll
        for (int cb = kW0; cb < D / 64; ++cb) {
          float part[32];
          float4 prev[8];
          if (st > 0) dq_prev(prev, sum, cb);
          const WgDesc dsk = wg_k(dSh), dsm = wg_k(dSl),
                       dkc = wg_mn(Ks + cb * kBlk);
          wg_fence();
          wg_ss64<T, 0, 1, true>(part, dsk.k(0), dkc.mn(0));
          wg_ss64<T, 0, 1, false>(part, dsm.k(0), dkc.mn(0));
#pragma unroll
          for (int kk = 1; kk < 4; ++kk) {
            wg_ss64<T, 0, 1, false>(part, dsk.k(kk), dkc.mn(kk));
            wg_ss64<T, 0, 1, false>(part, dsm.k(kk), dkc.mn(kk));
          }
          wg_commit();
          wg_wait<0>();
          fence_operands(part);
          dq_put<D>(part, prev, 0, st == 0, last, sum, p.dq, a, b, h, row0,
                    cb, lane);
        }
      }
      if (!kQ0All && kW0 < D / 64 && !last) chain_signal(cnt_left);
      if (st + 1 < nact) bar_arrive(kBarDsFree, 2 * kMmaT);
    }
    store_acc<D>(p.dk, dk2, a, b, h, kv0 + 16 * w, L,
                 kLift<T> ? a.scale * pow2i(lift) : a.scale, lane);
  }
  cluster_arrive();     // no CTA leaves while a peer may read its delta
  cluster_wait();
}
#endif  // FLASH_WIDE

template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* out,
                   float* lse, const Args& a, cudaStream_t st) {
  auto kern = short_fwd_kernel<float, D>;
  const size_t smem = short_fwd_smem<D>(a.Lq, kShortKC<D>);
  cudaError_t e = allow_smem(kern, short_fwd_smem<D>(kMaxL, kShortKC<D>));
  if (e != cudaSuccess) return (int)e;
  kern<<<a.B * a.H, kT, smem, st>>>((const float*)q, (const float*)k,
                                   (const float*)v, (float*)out, lse, a);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* out,
                   float* lse, const Args& a, cudaStream_t st) {
#ifdef FLASH_WIDE
  return launch_fwd_wg<D, T>(short_fwd_wg<D, T>, q, k, v, out, lse, a, st);
#else
  auto kern = short_fwd_mma<D, T>;
  const size_t smem = fwd_mma_smem<D>(a.Lk);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.Lq / kTile, a.B * a.H);
  kern<<<grid, kMmaT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, a);
  return (int)cudaGetLastError();
#endif
}

template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* dq_acc,
                   void* dq, void* dk, void* dv, const Args& a,
                   cudaStream_t st) {
  using T = float;
  auto kern = short_bwd_kernel<T, D>;
  const size_t smem = short_bwd_smem<D>(a.Lq, kShortWide<D>);
  cudaError_t e = allow_smem(kern, short_bwd_smem<D>(kMaxL, kShortWide<D>));
  if (e != cudaSuccess) return (int)e;
  kern<<<a.B * a.H, kT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                   (const T*)o, (const T*)dout, lse, dq_acc,
                                   (T*)dq, (T*)dk, (T*)dv, a);
  return (int)cudaGetLastError();
}

// the launch configuration of the 2-byte backward: grid (L / 64, B*H),
// clusters of L / 64 CTAs of ``threads``
cudaLaunchConfig_t bwd_mma_config(int L, int BH, int threads, size_t smem,
                                   cudaLaunchAttribute* attr,
                                   cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L / kTile, BH);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L / kTile;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The 2-byte backward's kernel, its shared memory and its threads at head
// width D: short_bwd_mma at D <= 128, short_bwd_wg above
template <int D, typename T>
struct BwdMma {
#ifdef FLASH_WIDE
  static constexpr int kThreads = kWgThreads;
  static auto kernel() { return short_bwd_wg<D, T>; }
  static constexpr size_t smem() { return short_bwd_wg_smem<D>(); }
#else
  static constexpr int kThreads = kMmaT;
  static auto kernel() { return short_bwd_mma<D, T>; }
  static constexpr size_t smem() { return short_bwd_mma_smem<D, T>(); }
#endif
};

// one cluster of L / 64 CTAs per b*H + h (at most 8, the portable
// limit); dq_acc: short_bwd_wg's dQ sums
template <int D, typename T>
int launch_bwd_mma(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* dq_acc, void* dq, void* dk, void* dv, const Args& a,
                   cudaStream_t st) {
  using K = BwdMma<D, T>;
  auto kern = K::kernel();
  const size_t smem = K::smem();
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      bwd_mma_config(a.Lq, a.B * a.H, K::kThreads, smem, attr, st);
#ifdef FLASH_WIDE
  WideBwd<T> p;
  const bool half = kIsHalf<T>;
  if (!bhld_map(&p.q, q, a.B, a.Lq, a.H, D, half) ||
      !bhld_map(&p.k, k, a.B, a.Lq, a.H, D, half) ||
      !bhld_map(&p.v, v, a.B, a.Lq, a.H, D, half) ||
      !bhld_map(&p.dout, dout, a.B, a.Lq, a.H, D, half))
    return (int)cudaErrorInvalidValue;
  p.o = (const T*)o;
  p.dout_p = (const T*)dout;
  p.lse = lse;
  p.dq_acc = dq_acc;
  p.dq = (T*)dq;
  p.dk = (T*)dk;
  p.dv = (T*)dv;
  p.a = a;
  e = cudaLaunchKernelEx(&cfg, kern, p);
#else
  e = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k, (const T*)v,
                         (const T*)o, (const T*)dout, lse, (T*)dq, (T*)dk,
                         (T*)dv, a);
#endif
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int L, int H, int D, int dtype) {
  return B < 1 || H < 1 || L < 128 || L > kMaxL || L % 128 != 0 ||
         bad_width(D) || dtype < 0 || dtype > 2;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16, 2 = f16
int flash_short_fwd(const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int L, int H, int D, int causal,
                    int dtype, float scale, unsigned thr, float inv,
                    unsigned seed_lo, unsigned seed_hi, void* stream) {
  if (bad_shape(B, L, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, L, L, H, causal, scale, thr, inv, seed_lo,
                           seed_hi);
  cudaStream_t st = (cudaStream_t)stream;
  return by_width(D, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if (dtype == 0) return launch_fwd_f32<W>(q, k, v, out, lse, a, st);
    if (dtype == 2) return launch_fwd_mma<W, __half>(q, k, v, out, lse, a, st);
    return launch_fwd_mma<W, __nv_bfloat16>(q, k, v, out, lse, a, st);
  });
}

// dq_acc: an f32 scratch (B*H, L, D) whose contents are overwritten, for
// the f32 form and the 2-byte forms at D > 128 (their dQ sums); null
// otherwise
int flash_short_bwd(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* dq_acc, void* dq, void* dk, void* dv, int B,
                    int L, int H, int D, int causal, int dtype, float scale,
                    unsigned thr, float inv, unsigned seed_lo,
                    unsigned seed_hi, void* stream) {
  if (bad_shape(B, L, H, D, dtype) ||
      ((dtype == 0 || D > 128) && dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, L, L, H, causal, scale, thr, inv, seed_lo,
                           seed_hi);
  cudaStream_t st = (cudaStream_t)stream;
  return by_width(D, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if (dtype == 0)
      return launch_bwd_f32<W>(q, k, v, o, dout, lse, dq_acc, dq, dk, dv, a,
                               st);
    if (dtype == 2)
      return launch_bwd_mma<W, __half>(q, k, v, o, dout, lse, dq_acc, dq, dk,
                                       dv, a, st);
    return launch_bwd_mma<W, __nv_bfloat16>(q, k, v, o, dout, lse, dq_acc, dq,
                                            dk, dv, a, st);
  });
}

// How many clusters of the bf16 backward (the f16 one's 16 more bytes
// of shared memory change no count) at sequence length L and head
// dim D the card can hold at once (cudaOccupancyMaxActiveClusters), or a
// negative cudaError_t.
int flash_short_bwd_max_clusters(int L, int D) {
  if (bad_shape(1, L, 1, D, 1)) return -(int)cudaErrorInvalidValue;
  return by_width(D, [&](auto w) {
    using K = BwdMma<decltype(w)::value, __nv_bfloat16>;
    auto kern = K::kernel();
    cudaLaunchAttribute attr[1];
    int n = 0;
    cudaError_t e = allow_smem(kern, K::smem());
    const cudaLaunchConfig_t cfg =
        bwd_mma_config(L, 1, K::kThreads, K::smem(), attr, nullptr);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg);
    return e == cudaSuccess ? n : -(int)e;
  });
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
