// Short-sequence flash attention for Hopper (sm_90a): 128 <= L <= 512,
// L % 128 == 0, Lq == Lk, head_dim 64 or 128.
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas/flash_attention.py:
// _flash_attention_core_short_fwd (_short_fwd_kernel: a direct, not
// online, softmax over the whole (L, L) row; out and lse) and
// _flash_attention_core_short_bwd (_short_bwd_kernel: dq, dk and dv in
// ONE launch from lse), including the in-kernel dropout.
//
// Bound: at BERT's seq 512 (D = 64) a head is 4*L*L*D flops forward and
// 10*L*L*D backward against 4*L*D and 8*L*D bf16 elements moved: near
// the card's balance point at the bf16 tensor-core rate (BERT phase 2's
// forward: 0.030 ms of bytes, 0.026 of operations; its backward 0.060
// and 0.065).
//
// Forward, bf16 (short_fwd_mma, on tensor cores): one block of 4 warps
// per 64-row q tile and (b, h), grid (L / 64, B*H); each warp owns 16 q
// rows. The TPU kernel's direct softmax needs the whole score row, which
// at L = 512 no longer fits beside the operands, so the block runs the
// online softmax instead (the same function in another summation
// order; lse is held to 1e-4): k and v stream through a two-stage
// cp.async ring of 64-row bf16 tiles, the next tile's copy running under
// this tile's products. S = Q K^T is mma.sync m16n8k16 (bf16 operands
// from swizzled shared tiles, f32 accumulators in registers); S is
// scaled in f32, the causal -inf applied, m and l kept per row in f32;
// P = exp(S - m) with the dropout mask scaled by 1/(1-p) becomes, in
// registers, the A operand of O += P V (v from shared memory through
// ldmatrix.trans) as two bf16 terms, hi + lo (acc_to_a2), so P V sees
// ~16 bits of P for a third product: with one term BERT phase 2's first
// loss lay 1.4e-3 from the f32 FMA kernel's (11.0849 against 11.0863),
// with two 7e-4. l sums the undropped probabilities, as in the TPU
// kernel. Epilogue: out = O / l in bf16 and lse = m + log(l) in f32.
// 40 KB of shared memory at D = 64, 80 KB at D = 128.
//
// f32 (short_fwd_kernel, the parity route held to 1e-4, which TF32
// cannot meet) and the backward (short_bwd_kernel, both types) use f32
// FMA from shared memory, one block per (b, h) for the whole sequence:
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

namespace {

constexpr int kMaxL = 512;

template <int D>
constexpr size_t short_fwd_smem(int L) {
  return sizeof(float) *
         (kTile * D + kTile * (D + 1) + (size_t)kTile * (L + 4));
}

template <int D>
constexpr size_t short_bwd_smem(int L) {
  return sizeof(float) * (kTile * (D + 1) * 2 + kTile * D * 2 +
                          kTile * kPad * 2 + 2 * (size_t)L);
}

// ---------------------------------------------------------------------------
// forward, f32: one block per b*H + h
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kT)
short_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Args a) {
  extern __shared__ float4 smem4[];
  const int L = a.Lq, ls = L + 4;
  float* Qs = reinterpret_cast<float*>(smem4);   // [64][D], scaled
  float* KVs = Qs + kTile * D;                    // [64][D+1]: k, then v
  float* Ss = KVs + kTile * (D + 1);              // [64][L+4]: S, then P
  constexpr int C = D / 16;
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
      load_tile<T, D>(KVs, D + 1, k, a, b, h, kv0, L, 1.0f);
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      mm<4, 4, D>(s, Qs, D, ty * 4, KVs, 1, D + 1, tx);
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
    float acc[4][C];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;
    for (int t = 0; t < nkv; ++t) {
      const int kv0 = t * kTile;
      load_tile<T, D>(KVs, D, v, a, b, h, kv0, L, 1.0f);
      __syncthreads();
      mm<4, C, kTile>(acc, Ss + kv0, ls, ty * 4, KVs, D, 1, tx);
      __syncthreads();
    }
    store_rows<T, D>(out, acc, a, b, h, q0, L, 1.0f);
  }
}

// ---------------------------------------------------------------------------
// forward, bf16 on tensor cores: one block per (64-row q tile, b*H + h)
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t short_fwd_mma_smem() {
  return (size_t)5 * kTile * D * sizeof(__nv_bfloat16);  // q, 2 k, 2 v
}

template <int D>
__global__ void __launch_bounds__(kMmaT)
short_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
              Args a) {
  extern __shared__ __align__(128) unsigned char smem_mma[];
  constexpr uint32_t TB = kTile * D * 2;          // bytes of one tile
  const uint32_t Qs = smem_u32(smem_mma), Ks = Qs + TB, Vs = Ks + 2 * TB;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int L = a.Lq, q0 = blockIdx.x * kTile, row0 = q0 + 16 * w;
  const int nkv = kv_tiles_for(a, q0);
  const bool drop = a.inv != 1.0f;

  tile_async<D>(Qs, q, a, b, h, q0, L);
  tile_async<D>(Ks, k, a, b, h, 0, L);
  tile_async<D>(Vs, v, a, b, h, 0, L);
  cp_commit();
  float o[D / 8][4], m[2] = {kNegInit, kNegInit}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;

  for (int t = 0; t < nkv; ++t) {
    const uint32_t Kt = Ks + (t & 1) * TB, Vt = Vs + (t & 1) * TB;
    if (t + 1 < nkv) {            // the next tile's copy under this one
      const uint32_t nxt = ((t + 1) & 1) * TB;
      tile_async<D>(Ks + nxt, k, a, b, h, (t + 1) * kTile, L);
      tile_async<D>(Vs + nxt, v, a, b, h, (t + 1) * kTile, L);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int kv0 = t * kTile;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
    mma_abt<D>(s, Qs, 16 * w, Kt, lane);
    // scale and mask in f32; the online softmax of the two rows
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] *= a.scale;
    mask_tile(s, a, row0, kv0, lane, -INFINITY);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2_ftz((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
    const uint32_t keep = drop ? keep_frag(a, bh, row0, kv0, lane) : ~0u;
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz((s[i][e] - m[e >> 1]) * kLog2e);
        rs[e >> 1] += p;
        s[i][e] = !drop ? p : ((keep >> (4 * i + e)) & 1u) ? p * a.inv : 0.0f;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    mma_rb<D>(o, s, Vt, lane);  // O += P V, P as hi + lo
    __syncthreads();                // the stage is refilled next
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lc = fmaxf(quad_sum(l[r]), 1e-30f);
    const int row = row0 + frag_row(lane, 2 * r);
    if ((lane & 3) == 0 && row < L)
      lse[(int64_t)bh * L + row] = m[r] + logf(lc);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][2 * r] /= lc;
      o[j][2 * r + 1] /= lc;
    }
  }
  store_acc<D>(out, o, a, b, h, row0, L, 1.0f, lane);
}

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
  extern __shared__ float4 smem4[];
  const int L = a.Lq;
  float* Ks = reinterpret_cast<float*>(smem4);   // [64][D+1]
  float* Vs = Ks + kTile * (D + 1);               // [64][D+1]
  float* Qs = Vs + kTile * (D + 1);               // [64][D], scaled
  float* dOs = Qs + kTile * D;                    // [64][D]
  float* Ts = dOs + kTile * D;                    // [64 kv][kPad]: P or dS
  float* dSs = Ts + kTile * kPad;                 // [64 q][kPad]: dS
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
    load_tile<T, D>(Vs, D + 1, v, a, b, h, kv0, L, 1.0f);
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
      // dS = P (dP - delta), into T (transposed) and dSs ([q][kv])
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float dl = delta_s[q0 + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float ds = s[i][j] * (dp[i][j] - dl);
          Ts[(tx + 16 * j) * kPad + r] = ds;
          dSs[r * kPad + tx + 16 * j] = ds;
        }
      }
      __syncthreads();
      mm<4, C, kTile>(dk_acc, Ts, kPad, ty * 4, Qs, D, 1, tx);
      float dq_part[4][C];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) dq_part[i][j] = 0.0f;
      mm<4, C, kTile>(dq_part, dSs, kPad, ty * 4, Ks, D + 1, 1, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* dst = dqh + (int64_t)(q0 + ty * 4 + i) * D + tx;
#pragma unroll
        for (int j = 0; j < C; ++j)
          dst[16 * j] = kt == 0 ? dq_part[i][j] : dst[16 * j] + dq_part[i][j];
      }
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

template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* out,
                   float* lse, const Args& a, cudaStream_t st) {
  auto kern = short_fwd_kernel<float, D>;
  const size_t smem = short_fwd_smem<D>(a.Lq);
  cudaError_t e = allow_smem(kern, short_fwd_smem<D>(kMaxL));
  if (e != cudaSuccess) return (int)e;
  kern<<<a.B * a.H, kT, smem, st>>>((const float*)q, (const float*)k,
                                   (const float*)v, (float*)out, lse, a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                    float* lse, const Args& a, cudaStream_t st) {
  using bf = __nv_bfloat16;
  auto kern = short_fwd_mma<D>;
  cudaError_t e = allow_smem(kern, short_fwd_mma_smem<D>());
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.Lq / kTile, a.B * a.H);
  kern<<<grid, kMmaT, short_fwd_mma_smem<D>(), st>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (bf*)out, lse, a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dq_acc, void* dq,
               void* dk, void* dv, const Args& a, cudaStream_t st) {
  auto kern = short_bwd_kernel<T, D>;
  const size_t smem = short_bwd_smem<D>(a.Lq);
  cudaError_t e = allow_smem(kern, short_bwd_smem<D>(kMaxL));
  if (e != cudaSuccess) return (int)e;
  kern<<<a.B * a.H, kT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                   (const T*)o, (const T*)dout, lse, dq_acc,
                                   (T*)dq, (T*)dk, (T*)dv, a);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int L, int H, int D, int dtype) {
  return B < 1 || H < 1 || L < 128 || L > kMaxL || L % 128 != 0 ||
         (D != 64 && D != 128) || (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16
int flash_short_fwd(const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int L, int H, int D, int causal,
                    int dtype, float scale, unsigned thr, float inv,
                    unsigned seed_lo, unsigned seed_hi, void* stream) {
  if (bad_shape(B, L, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, L, L, H, causal, scale, thr, inv, seed_lo,
                           seed_hi);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return D == 64 ? launch_fwd_f32<64>(q, k, v, out, lse, a, st)
                   : launch_fwd_f32<128>(q, k, v, out, lse, a, st);
  return D == 64 ? launch_fwd_bf16<64>(q, k, v, out, lse, a, st)
                 : launch_fwd_bf16<128>(q, k, v, out, lse, a, st);
}

// dq_acc: f32 scratch (B*H, L, D); its contents are overwritten
int flash_short_bwd(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* dq_acc, void* dq, void* dk, void* dv, int B,
                    int L, int H, int D, int causal, int dtype, float scale,
                    unsigned thr, float inv, unsigned seed_lo,
                    unsigned seed_hi, void* stream) {
  if (bad_shape(B, L, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, L, L, H, causal, scale, thr, inv, seed_lo,
                           seed_hi);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return D == 64 ? launch_bwd<float, 64>(q, k, v, o, dout, lse, dq_acc, dq,
                                           dk, dv, a, st)
                   : launch_bwd<float, 128>(q, k, v, o, dout, lse, dq_acc,
                                            dq, dk, dv, a, st);
  return D == 64 ? launch_bwd<__nv_bfloat16, 64>(q, k, v, o, dout, lse,
                                                 dq_acc, dq, dk, dv, a, st)
                 : launch_bwd<__nv_bfloat16, 128>(q, k, v, o, dout, lse,
                                                  dq_acc, dq, dk, dv, a, st);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
