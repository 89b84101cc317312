// Fused linear + vocabulary cross-entropy for Hopper (sm_90a): forward
// (per-row lse and label logit) and backward (dh; dW and db), with the
// logits h W^T + b never written to device memory.
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas/fused_xent.py:
// _fwd_call (_fwd_kernel) and _bwd_call (_bwd_dh_kernel,
// _bwd_dw_kernel).
//
// Bound: operations. At BERT's MLM head (N = 16384 rows, H = 768,
// V = 30592) each logit tile is 2*H flops per element and the forward,
// dh and dW passes (the two backward passes recompute the logits) do
// about 5 * 2*N*H*V = 3.9 TFLOP in f32 against ~200 MB of operands.
// These kernels use f32 FMA from shared memory (no tensor cores), so
// their ceiling is the f32 rate.
//
// Design. The TPU kernels carry accumulators across a sequential grid
// axis; GPU blocks run in no order, so each block loops over the axis
// itself:
// - forward: one block per 32 rows of h (kept in shared memory) loops
//   over vocab tiles of 256, streaming W through a 16-deep transposed
//   stage; each thread computes a 4 x 8 logit patch (rows ty*4+i,
//   columns tx + 32 j), so a row's 256 logits sit in one warp and the
//   online max / sum-exp and the label logit are warp reductions.
// - dh: the same block shape recomputes each logit tile, forms
//   P' = (exp(s - lse) - onehot) * g in shared memory and accumulates
//   dh += P' W_tile, with W re-staged 8 rows at a time. The 32 x H f32
//   accumulator is spread over the block's registers (each thread owns
//   columns tid + 256 c of all 32 rows), so the TPU's bn of 256-1024
//   rows, which would not fit one block's registers or shared memory at
//   H = 768, becomes 32 rows a block and 512 blocks.
// - dW/db: the roles swap: one block per 32 vocab rows of W (kept in
//   shared memory) loops over row tiles of 256, recomputing the
//   transposed logit tile, and accumulates dW += P'^T h and db += sum P'
//   in registers. No atomics: every output element has one writer.
// Rows past N and vocab rows past V are masked in the kernels (the JAX
// wrapper pads rows to a multiple of 256 instead). Ignored rows come in
// with label -1 and g = 0.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 256;         // threads a block
constexpr int kR = 32;          // resident rows a block
constexpr int kS = 256;         // streamed rows a tile
constexpr int kK = 16;          // reduction depth of one stage
constexpr int kSt = kS + 1;     // stage row stride (conflict-free stores)
constexpr int kC = 8;           // rows a chunk in the dh / dW products
constexpr int kPs = 36;         // row stride of the dW kernel's P' tile
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// rows [r0, r0 + rows) of a row-major (n, H) matrix into dst[rows][H];
// rows at or past n load as zeros
__device__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                          int rows, int n, int H) {
  const int hv = H / 4;
  for (int idx = threadIdx.x; idx < rows * hv; idx += kT) {
    const int r = idx / hv, c = (idx % hv) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      x = *reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * H + c);
    *reinterpret_cast<float4*>(dst + r * H + c) = x;
  }
}

// s[i][j] += sum_k A[(ty*4 + i) * H + k] * X[x0 + tx + 32 j][k] for the
// resident rows A (shared, [32][H]) and 256 rows of the global (n, H)
// matrix X from x0, staged transposed 16 columns at a time. Rows of X
// at or past n count as zeros.
__device__ void stream_dot(float (&s)[4][8], const float* As, int H,
                           const float* __restrict__ X, int x0, int n,
                           float* stage) {
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const bool live = x0 + tid < n;
  const float* xrow = X + (int64_t)(x0 + tid) * H;
  for (int k0 = 0; k0 < H; k0 += kK) {
#pragma unroll
    for (int kk = 0; kk < kK; kk += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) x = *reinterpret_cast<const float4*>(xrow + k0 + kk);
      stage[(kk + 0) * kSt + tid] = x.x;
      stage[(kk + 1) * kSt + tid] = x.y;
      stage[(kk + 2) * kSt + tid] = x.z;
      stage[(kk + 3) * kSt + tid] = x.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; kk += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty * 4 + i) * H + k0 +
                                                 kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = stage[(kk + e) * kSt + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = comp(a[i], e);
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av, b[j], s[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&s)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
}

// ---------------------------------------------------------------------------
// forward: per-row lse and label logit
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kT)
xent_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
           const float* __restrict__ bias, const int32_t* __restrict__ labels,
           float* __restrict__ lse, float* __restrict__ ll, int N, int H,
           int V) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [32][H]
  float* stage = hs + kR * H;                    // [16][257]
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int n0 = blockIdx.x * kR;
  load_rows(hs, h, n0, kR, N, H);
  int lab[4];
  float m[4], l[4], hit[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + ty * 4 + i;
    lab[i] = row < N ? labels[row] : -1;
    m[i] = kNegInit;
    l[i] = 0.0f;
    hit[i] = 0.0f;
  }
  for (int v0 = 0; v0 < V; v0 += kS) {
    float s[4][8];
    zero(s);
    stream_dot(s, hs, H, w, v0, V, stage);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + tx + 32 * j;
        if (col < V) {
          s[i][j] += bias[col];
          if (col == lab[i]) hit[i] += s[i][j];
        } else {
          s[i][j] = -INFINITY;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + warp_sum(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float hv = warp_sum(hit[i]);
    const int row = n0 + ty * 4 + i;
    if (tx == 0 && row < N) {
      lse[row] = m[i] + logf(fmaxf(l[i], 1e-30f));
      ll[row] = hv;
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dh = sum_v P'[n, v] W[v, :]
// ---------------------------------------------------------------------------
template <int CPT>
__global__ void __launch_bounds__(kT)
xent_dh_kernel(const float* __restrict__ h, const float* __restrict__ w,
          const float* __restrict__ bias, const int32_t* __restrict__ labels,
          const float* __restrict__ lse, const float* __restrict__ g,
          float* __restrict__ dh, int N, int H, int V) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);        // [32][H]
  float* stage = hs + kR * H;                          // max(16*257, 8*H)
  float* ps = stage + (kK * kSt > kC * H ? kK * kSt : kC * H);  // [32][256]
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int n0 = blockIdx.x * kR;
  load_rows(hs, h, n0, kR, N, H);
  int lab[4];
  float lse_r[4], g_r[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + ty * 4 + i;
    live[i] = row < N;
    lab[i] = live[i] ? labels[row] : -1;
    lse_r[i] = live[i] ? lse[row] : 0.0f;
    g_r[i] = live[i] ? g[row] : 0.0f;
  }
  float acc[kR][CPT];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;
  for (int v0 = 0; v0 < V; v0 += kS) {
    float s[4][8];
    zero(s);
    stream_dot(s, hs, H, w, v0, V, stage);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + tx + 32 * j;
        float p = 0.0f;
        if (col < V && live[i]) {
          p = expf(s[i][j] + bias[col] - lse_r[i]);
          if (col == lab[i]) p -= 1.0f;
          p *= g_r[i];
        }
        ps[(ty * 4 + i) * kS + tx + 32 * j] = p;
      }
    // (stream_dot ended in a barrier; the next one publishes ps)
    for (int vc = 0; vc < kS; vc += kC) {
      load_rows(stage, w, v0 + vc, kC, V, H);
      __syncthreads();
#pragma unroll
      for (int vv = 0; vv < kC; vv += 4) {
        float wv[4][CPT];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int col = tid + 256 * c;
            wv[e][c] = col < H ? stage[(vv + e) * H + col] : 0.0f;
          }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float4 p =
              *reinterpret_cast<const float4*>(ps + r * kS + vc + vv);
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            float a = acc[r][c];
            a = fmaf(p.x, wv[0][c], a);
            a = fmaf(p.y, wv[1][c], a);
            a = fmaf(p.z, wv[2][c], a);
            a = fmaf(p.w, wv[3][c], a);
            acc[r][c] = a;
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = n0 + r;
    if (row >= N) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + 256 * c;
      if (col < H) dh[(int64_t)row * H + col] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dW = sum_n P'[n, v] h[n, :], db = sum_n P'[n, v]
// ---------------------------------------------------------------------------
template <int CPT>
__global__ void __launch_bounds__(kT)
xent_dw_kernel(const float* __restrict__ h, const float* __restrict__ w,
          const float* __restrict__ bias, const int32_t* __restrict__ labels,
          const float* __restrict__ lse, const float* __restrict__ g,
          float* __restrict__ dw, float* __restrict__ db, int N, int H,
          int V) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);        // [32][H]
  float* stage = ws + kR * H;                          // max(16*257, 8*H)
  float* ps = stage + (kK * kSt > kC * H ? kK * kSt : kC * H);  // [256][36]
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int v0 = blockIdx.x * kR;
  load_rows(ws, w, v0, kR, V, H);
  float bias_v[4], db_part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty * 4 + i;
    bias_v[i] = v < V ? bias[v] : 0.0f;
    db_part[i] = 0.0f;
  }
  float acc[kR][CPT];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;
  for (int n0 = 0; n0 < N; n0 += kS) {
    float s[4][8];
    zero(s);
    stream_dot(s, ws, H, h, n0, N, stage);  // s[i][j]: vocab i, row j
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 32 * j;
      const bool live = n < N;
      const int lab = live ? labels[n] : -1;
      const float lse_n = live ? lse[n] : 0.0f;
      const float g_n = live ? g[n] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = v0 + ty * 4 + i;
        float p = 0.0f;
        if (v < V && live) {
          p = expf(s[i][j] + bias_v[i] - lse_n);
          if (lab == v) p -= 1.0f;
          p *= g_n;
        }
        ps[(tx + 32 * j) * kPs + ty * 4 + i] = p;
        db_part[i] += p;
      }
    }
    for (int nc = 0; nc < kS; nc += kC) {
      load_rows(stage, h, n0 + nc, kC, N, H);
      __syncthreads();
#pragma unroll
      for (int nn = 0; nn < kC; ++nn) {
        float hv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = tid + 256 * c;
          hv[c] = col < H ? stage[nn * H + col] : 0.0f;
        }
#pragma unroll
        for (int vq = 0; vq < kR; vq += 4) {
          const float4 p =
              *reinterpret_cast<const float4*>(ps + (nc + nn) * kPs + vq);
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            acc[vq + 0][c] = fmaf(p.x, hv[c], acc[vq + 0][c]);
            acc[vq + 1][c] = fmaf(p.y, hv[c], acc[vq + 1][c]);
            acc[vq + 2][c] = fmaf(p.z, hv[c], acc[vq + 2][c]);
            acc[vq + 3][c] = fmaf(p.w, hv[c], acc[vq + 3][c]);
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = warp_sum(db_part[i]);
    const int v = v0 + ty * 4 + i;
    if (tx == 0 && v < V) db[v] = d;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int v = v0 + r;
    if (v >= V) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + 256 * c;
      if (col < H) dw[(int64_t)v * H + col] = acc[r][c];
    }
  }
}

size_t fwd_smem(int H) { return sizeof(float) * (kR * H + kK * kSt); }

size_t bwd_smem(int H, int ps_floats) {
  const int stage = kK * kSt > kC * H ? kK * kSt : kC * H;
  return sizeof(float) * (kR * H + stage + ps_floats);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int CPT>
int launch_bwd(const float* h, const float* w, const float* bias,
               const int32_t* labels, const float* lse, const float* g,
               float* dh, float* dw, float* db, int N, int H, int V,
               cudaStream_t st) {
  const size_t sh = bwd_smem(H, kR * kS), sw = bwd_smem(H, kS * kPs);
  cudaError_t e = allow_smem(xent_dh_kernel<CPT>, sh);
  if (e == cudaSuccess) e = allow_smem(xent_dw_kernel<CPT>, sw);
  if (e != cudaSuccess) return (int)e;
  xent_dh_kernel<CPT><<<(N + kR - 1) / kR, kT, sh, st>>>(h, w, bias, labels, lse,
                                                    g, dh, N, H, V);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  xent_dw_kernel<CPT><<<(V + kR - 1) / kR, kT, sw, st>>>(h, w, bias, labels, lse,
                                                    g, dw, db, N, H, V);
  return (int)cudaGetLastError();
}

bool bad_shape(int N, int H, int V) {
  return N < 1 || V < 1 || H < kK || H % kK != 0 || H > 4 * kT;
}

}  // namespace

extern "C" {

int fused_xent_fwd(const float* h, const float* w, const float* bias,
                   const int32_t* labels, float* lse, float* ll, int N, int H,
                   int V, void* stream) {
  if (bad_shape(N, H, V)) return (int)cudaErrorInvalidValue;
  const size_t sm = fwd_smem(H);
  cudaError_t e = allow_smem(xent_fwd_kernel, sm);
  if (e != cudaSuccess) return (int)e;
  xent_fwd_kernel<<<(N + kR - 1) / kR, kT, sm, (cudaStream_t)stream>>>(
      h, w, bias, labels, lse, ll, N, H, V);
  return (int)cudaGetLastError();
}

int fused_xent_bwd(const float* h, const float* w, const float* bias,
                   const int32_t* labels, const float* lse, const float* g,
                   float* dh, float* dw, float* db, int N, int H, int V,
                   void* stream) {
  if (bad_shape(N, H, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((H + kT - 1) / kT) {
    case 1:
      return launch_bwd<1>(h, w, bias, labels, lse, g, dh, dw, db, N, H, V, st);
    case 2:
      return launch_bwd<2>(h, w, bias, labels, lse, g, dh, dw, db, N, H, V, st);
    case 3:
      return launch_bwd<3>(h, w, bias, labels, lse, g, dh, dw, db, N, H, V, st);
    default:
      return launch_bwd<4>(h, w, bias, labels, lse, g, dh, dw, db, N, H, V, st);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
