// FlashAttention-2 forward and backward for Hopper: three kernels.
//
// Replace the Pallas TPU kernels of
//   distributed_pytorch_training_tpu/ops/flash_attention.py
// as follows:
//   flash_fwd_kernel     <- _flash_fwd_lse (:199), body _fwd_kernel (:146)
//   flash_bwd_dkv_kernel <- _flash_bwd (:360), body _bwd_dkv_kernel (:269)
//   flash_bwd_dq_kernel  <- _flash_bwd (:360), body _bwd_dq_kernel (:317)
//
// Semantics carried over from the JAX kernels:
//   * masked logits are the float32 minimum (NEG_INF), not -inf: a row
//     whose keys are all masked gets p = 1 on every key of its live tiles
//     and emits their mean(V), with lse = NEG_INF;
//   * keys past Sk (a ragged last tile) do not exist: their logit is -inf,
//     so p = 0 even in an all-masked row;
//   * causal alignment is top-left: row >= col on absolute indices from 0,
//     also when Sq != Sk; a causal k tile is live when its first key is at
//     or before the q tile's last row (the JAX `live` test);
//   * the forward scales q before the dot (:167); the backward scales the
//     dot (:294, :341) and dS (:308, :352);
//   * the backward re-masks (causal and kv_valid), so no gradient reaches a
//     masked key through a normal row.
// Inputs are (B, S, H, D) in float32 or bfloat16, read through their batch,
// sequence and head strides (the last axis is contiguous), so q, k and v can
// be views of one fused qkv tensor. Arithmetic is float32 throughout; out,
// dq, dk and dv are written contiguous in the input dtype, lse as (B*H, Sq)
// float32. kv_valid, when given, is (B, Sk) float32: a key attends iff > 0.
//
// Bound on the card: operations. At GPT-2 124M's shape (B 8, S 1024, H 12,
// D 64, causal) the forward does 4*D flops per live (q, k) pair, dK/dV 8*D
// and dQ 6*D (the JAX module's _cost counts), about 12.9, 25.8 and 19.4
// GFLOP, against some 100 MB of traffic each: compute-bound, 0.19, 0.38 and
// 0.29 ms at the H100's 67 TFLOP/s of float32 outside the tensor cores.
//
// Design, simple and correct first (tensor cores, wgmma and TMA are later
// work): 256 threads as a 16 x 16 grid. A block owns one 64-row tile (q
// tile for the forward and dQ, k tile for dK/dV) of one (batch, head) and
// loops over the other side's 64-row tiles, staged in shared memory as
// float32 with rows padded to D + 1 floats (no bank conflicts on column
// reads). Each thread computes a 4 x 4 patch of the 64 x 64 score tile,
// rows ty + 16 i and columns tx + 16 j; row statistics reduce over the 16
// lanes of a half-warp with shuffles. The accumulators (out, dK and dV, or
// dQ) live in registers: each thread keeps 4 rows by ceil(D / 16) columns.
// Causal blocks skip the tiles past the diagonal, and the heaviest causal
// q tiles are scheduled first.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;            // rows of a q tile and of a k tile
constexpr int kThreads = 256;        // a 16 x 16 grid of threads
constexpr int kLdp = kTile + 1;      // padded row stride of score tiles
constexpr float kNegInf = -FLT_MAX;  // NEG_INF of the JAX module
constexpr unsigned kFullMask = 0xffffffffu;

struct Strides {  // element strides of a (B, S, H, D) tensor; D's is 1
  long long b, s, h;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// max / sum over the 16 lanes that hold one row (a half-warp)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

// Rows [row0, row0 + kTile) of one (batch, head) slice -- `src` points at
// its row 0, `s_stride` apart -- into a (kTile, ld) float tile, times `mul`.
// Rows at or past `n_rows` are zero.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src,
                          long long s_stride, int row0, int n_rows, int D,
                          float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = row0 + r;
    dst[r * ld + c] =
        row < n_rows ? load_f(src + row * s_stride + c) * mul : 0.0f;
  }
}

// acc[i][j] += sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two tiles
__device__ __forceinline__ void dot_4x4(float (&acc)[4][4], const float* a,
                                        const float* b, int ld, int D,
                                        int ty, int tx) {
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The logit after the JAX kernels' masks. `kvm` is this batch row of
// kv_valid, or null.
__device__ __forceinline__ float masked(float s, int row, int col, int Sk,
                                        bool causal, const float* kvm) {
  if (col >= Sk) return -INFINITY;  // past the ragged tail: no such key
  if (causal && col > row) return kNegInf;
  if (kvm != nullptr && !(kvm[col] > 0.0f)) return kNegInf;
  return s;
}

// --------------------------------------------------------------------------
// forward: out and lse
// --------------------------------------------------------------------------

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ kv_valid,
    T* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
    int D, Strides qs, Strides ks, Strides vs, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;
  float* sK = sQ + kTile * ld;
  float* sV = sK + kTile * ld;
  float* sP = sV + kTile * ld;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;

  // the forward scales q before the dot (_fwd_kernel :167)
  load_tile(sQ, ld, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D, scale);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.0f;
  }

  int n_kt = (Sk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // sQ is loaded; the last tile's sK, sV, sP are read
    load_tile(sK, ld, k + b * ks.b + h * ks.h, ks.s, k0, Sk, D, 1.0f);
    load_tile(sV, ld, v + b * vs.b + h * vs.h, vs.s, k0, Sk, D, 1.0f);
    __syncthreads();

    float s[4][4] = {};
    dot_4x4(s, sQ, sK, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(s[i][j], row, k0 + tx + 16 * j, Sk, causal, kvm);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * kLdp + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int n_k = min(kTile, Sk - k0);
    for (int j = 0; j < n_k; ++j) {
      float vv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? sV[j * ld + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty + 16 * i) * kLdp + j];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  const long long row_stride = (long long)H * D;
  T* ob = out + (long long)b * Sq * row_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Sq) {
      const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        if (col < D) store_f(ob + row * row_stride + col, acc[i][c] / li);
      }
      if (tx == 0) lse[(long long)bh * Sq + row] = m[i] + logf(li);
    }
  }
}

// --------------------------------------------------------------------------
// backward: p and dS of one (q tile, k tile) pair, shared by both kernels
// --------------------------------------------------------------------------

// Scores from sQ x sK and dP from sdO x sV, then p = exp(s - lse) and
// dS = p * (dP - delta) * scale into sP (when non-null) and sdS, rows q,
// columns k. Rows past Sq get p = 0.
__device__ __forceinline__ void bwd_scores(
    const float* sQ, const float* sK, const float* sdO, const float* sV,
    const float* sLse, const float* sDelta, float* sP, float* sdS, int ld,
    int D, int q0, int k0, int Sq, int Sk, bool causal, const float* kvm,
    float scale, int ty, int tx) {
  float s[4][4] = {};
  float dp[4][4] = {};
  dot_4x4(s, sQ, sK, ld, D, ty, tx);
  dot_4x4(dp, sdO, sV, ld, D, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float p = 0.0f;
      if (row < Sq) {
        p = expf(masked(scale * s[i][j], row, k0 + c, Sk, causal, kvm) -
                 sLse[r]);
      }
      if (sP != nullptr) sP[r * kLdp + c] = p;
      sdS[r * kLdp + c] = p * (dp[i][j] - sDelta[r]) * scale;
    }
  }
}

// lse and delta of rows [q0, q0 + kTile) into shared memory (0 past Sq)
__device__ __forceinline__ void load_rows(float* sLse, float* sDelta,
                                          const float* lse,
                                          const float* delta, long long base,
                                          int q0, int Sq) {
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    sLse[threadIdx.x] = row < Sq ? lse[base + row] : 0.0f;
    sDelta[threadIdx.x] = row < Sq ? delta[base + row] : 0.0f;
  }
}

// --------------------------------------------------------------------------
// backward: dK and dV
// --------------------------------------------------------------------------

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ kv_valid, T* __restrict__ dk,
    T* __restrict__ dv, int H, int Sq, int Sk, int D, Strides qs,
    Strides ks, Strides vs, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sK = smem;
  float* sV = sK + kTile * ld;
  float* sQ = sV + kTile * ld;
  float* sdO = sQ + kTile * ld;
  float* sP = sdO + kTile * ld;
  float* sdS = sP + kTile * kLdp;
  float* sLse = sdS + kTile * kLdp;
  float* sDelta = sLse + kTile;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;
  const long long row_stride = (long long)H * D;  // dout, dk, dv
  const T* dob = dout + (long long)b * Sq * row_stride + (long long)h * D;

  load_tile(sK, ld, k + b * ks.b + h * ks.h, ks.s, k0, Sk, D, 1.0f);
  load_tile(sV, ld, v + b * vs.b + h * vs.h, vs.s, k0, Sk, D, 1.0f);

  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk_acc[i][c] = 0.0f;
      dv_acc[i][c] = 0.0f;
    }
  }

  const int n_qt = (Sq + kTile - 1) / kTile;
  // causal: q tiles whose last row is before this tile's first key are dead
  const int qt0 = causal ? k0 / kTile : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // sK, sV are loaded; the last tile's readers are done
    load_tile(sQ, ld, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D, 1.0f);
    load_tile(sdO, ld, dob, row_stride, q0, Sq, D, 1.0f);
    load_rows(sLse, sDelta, lse, delta, (long long)bh * Sq, q0, Sq);
    __syncthreads();
    bwd_scores(sQ, sK, sdO, sV, sLse, sDelta, sP, sdS, ld, D, q0, k0, Sq,
               Sk, causal, kvm, scale, ty, tx);
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q: this thread's k rows are ty + 16 i
    const int n_q = min(kTile, Sq - q0);
    for (int r = 0; r < n_q; ++r) {
      float dov[DPT], qv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        dov[c] = col < D ? sdO[r * ld + col] : 0.0f;
        qv[c] = col < D ? sQ[r * ld + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[r * kLdp + ty + 16 * i];
        const float ds = sdS[r * kLdp + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          dv_acc[i][c] = fmaf(p, dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
        }
      }
    }
  }

  T* dkb = dk + (long long)b * Sk * row_stride + (long long)h * D;
  T* dvb = dv + (long long)b * Sk * row_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < Sk) {
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          store_f(dkb + row * row_stride + col, dk_acc[i][c]);
          store_f(dvb + row * row_stride + col, dv_acc[i][c]);
        }
      }
    }
  }
}

// --------------------------------------------------------------------------
// backward: dQ
// --------------------------------------------------------------------------

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ kv_valid, T* __restrict__ dq, int H, int Sq,
    int Sk, int D, Strides qs, Strides ks, Strides vs, float scale,
    int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;
  float* sdO = sQ + kTile * ld;
  float* sK = sdO + kTile * ld;
  float* sV = sK + kTile * ld;
  float* sdS = sV + kTile * ld;
  float* sLse = sdS + kTile * kLdp;
  float* sDelta = sLse + kTile;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;
  const long long row_stride = (long long)H * D;  // dout, dq
  const T* dob = dout + (long long)b * Sq * row_stride + (long long)h * D;

  load_tile(sQ, ld, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D, 1.0f);
  load_tile(sdO, ld, dob, row_stride, q0, Sq, D, 1.0f);
  load_rows(sLse, sDelta, lse, delta, (long long)bh * Sq, q0, Sq);

  float dq_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DPT; ++c) dq_acc[i][c] = 0.0f;
  }

  int n_kt = (Sk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // sQ, sdO, rows loaded; the last tile's readers done
    load_tile(sK, ld, k + b * ks.b + h * ks.h, ks.s, k0, Sk, D, 1.0f);
    load_tile(sV, ld, v + b * vs.b + h * vs.h, vs.s, k0, Sk, D, 1.0f);
    __syncthreads();
    bwd_scores(sQ, sK, sdO, sV, sLse, sDelta, nullptr, sdS, ld, D, q0, k0,
               Sq, Sk, causal, kvm, scale, ty, tx);
    __syncthreads();

    // dQ += dS K: this thread's q rows are ty + 16 i
    const int n_k = min(kTile, Sk - k0);
    for (int j = 0; j < n_k; ++j) {
      float kv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        kv[c] = col < D ? sK[j * ld + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sdS[(ty + 16 * i) * kLdp + j];
#pragma unroll
        for (int c = 0; c < DPT; ++c) dq_acc[i][c] = fmaf(ds, kv[c], dq_acc[i][c]);
      }
    }
  }

  T* dqb = dq + (long long)b * Sq * row_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Sq) {
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        if (col < D) store_f(dqb + row * row_stride + col, dq_acc[i][c]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------

size_t fwd_smem(int D) {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLdp);
}
size_t dkv_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kLdp + 2 * kTile);
}
size_t dq_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kLdp + 2 * kTile);
}

struct Problem {
  int B, H, Sq, Sk, D;
  Strides qs, ks, vs;
  float scale;
  int causal;
  cudaStream_t stream;
};

// grid (batch * heads, tiles) for a kernel that owns tiles of `n` rows
dim3 grid_of(const Problem& p, int n) {
  return dim3(static_cast<unsigned>(p.B * p.H),
              static_cast<unsigned>((n + kTile - 1) / kTile));
}

// Raise the kernel's dynamic shared-memory limit (above 48 KB it must be
// asked for) and return the error, 0 when accepted.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int DPT>
int fwd_t(const Problem& p, const void* q, const void* k, const void* v,
          const float* kv_valid, void* out, float* lse) {
  const size_t smem = fwd_smem(p.D);
  auto kernel = flash_fwd_kernel<T, DPT>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<grid_of(p, p.Sq), kThreads, smem, p.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_valid, static_cast<T*>(out), lse, p.H,
      p.Sq, p.Sk, p.D, p.qs, p.ks, p.vs, p.scale, p.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DPT>
int dkv_t(const Problem& p, const void* q, const void* k, const void* v,
          const void* dout, const float* lse, const float* delta,
          const float* kv_valid, void* dk, void* dv) {
  const size_t smem = dkv_smem(p.D);
  auto kernel = flash_bwd_dkv_kernel<T, DPT>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<grid_of(p, p.Sk), kThreads, smem, p.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_valid, static_cast<T*>(dk), static_cast<T*>(dv), p.H, p.Sq, p.Sk,
      p.D, p.qs, p.ks, p.vs, p.scale, p.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DPT>
int dq_t(const Problem& p, const void* q, const void* k, const void* v,
         const void* dout, const float* lse, const float* delta,
         const float* kv_valid, void* dq) {
  const size_t smem = dq_smem(p.D);
  auto kernel = flash_bwd_dq_kernel<T, DPT>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<grid_of(p, p.Sq), kThreads, smem, p.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_valid, static_cast<T*>(dq), p.H, p.Sq, p.Sk, p.D, p.qs, p.ks, p.vs,
      p.scale, p.causal);
  return static_cast<int>(cudaGetLastError());
}

// Columns per thread: ceil(D / 16) rounded up to 2, 4 or 8.
#define DPT_DISPATCH(D, CALL)              \
  ((D) <= 32 ? CALL(2) : (D) <= 64 ? CALL(4) : CALL(8))

Problem make_problem(int B, int H, int Sq, int Sk, int D, long long qsb,
                     long long qss, long long qsh, long long ksb,
                     long long kss, long long ksh, long long vsb,
                     long long vss, long long vsh, float scale, int causal,
                     void* stream) {
  return Problem{B, H, Sq, Sk, D, Strides{qsb, qss, qsh},
                 Strides{ksb, kss, ksh}, Strides{vsb, vss, vsh}, scale,
                 causal, static_cast<cudaStream_t>(stream)};
}

bool bad_shape(int B, int H, int Sq, int Sk, int D) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128;
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` (a cudaStream_t passed as a
// pointer) and returns cudaGetLastError() as an int: 0 when the launch was
// accepted. `bf16` selects bfloat16 tensors, else float32.

int dpt_flash_fwd(const void* q, const void* k, const void* v,
                  const float* kv_valid, void* out, float* lse, int B,
                  int H, int Sq, int Sk, int D, long long qsb, long long qss,
                  long long qsh, long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh, float scale,
                  int causal, int bf16, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = make_problem(B, H, Sq, Sk, D, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, scale, causal, stream);
#define FWD_F32(N) fwd_t<float, N>(p, q, k, v, kv_valid, out, lse)
#define FWD_BF16(N) fwd_t<__nv_bfloat16, N>(p, q, k, v, kv_valid, out, lse)
  return bf16 ? DPT_DISPATCH(D, FWD_BF16) : DPT_DISPATCH(D, FWD_F32);
#undef FWD_F32
#undef FWD_BF16
}

int dpt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* kv_valid, void* dk, void* dv, int B,
                      int H, int Sq, int Sk, int D, long long qsb,
                      long long qss, long long qsh, long long ksb,
                      long long kss, long long ksh, long long vsb,
                      long long vss, long long vsh, float scale, int causal,
                      int bf16, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = make_problem(B, H, Sq, Sk, D, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, scale, causal, stream);
#define DKV_F32(N) dkv_t<float, N>(p, q, k, v, dout, lse, delta, kv_valid, dk, dv)
#define DKV_BF16(N) \
  dkv_t<__nv_bfloat16, N>(p, q, k, v, dout, lse, delta, kv_valid, dk, dv)
  return bf16 ? DPT_DISPATCH(D, DKV_BF16) : DPT_DISPATCH(D, DKV_F32);
#undef DKV_F32
#undef DKV_BF16
}

int dpt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const float* kv_valid, void* dq, int B, int H, int Sq,
                     int Sk, int D, long long qsb, long long qss,
                     long long qsh, long long ksb, long long kss,
                     long long ksh, long long vsb, long long vss,
                     long long vsh, float scale, int causal, int bf16,
                     void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = make_problem(B, H, Sq, Sk, D, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, scale, causal, stream);
#define DQ_F32(N) dq_t<float, N>(p, q, k, v, dout, lse, delta, kv_valid, dq)
#define DQ_BF16(N) dq_t<__nv_bfloat16, N>(p, q, k, v, dout, lse, delta, kv_valid, dq)
  return bf16 ? DPT_DISPATCH(D, DQ_BF16) : DPT_DISPATCH(D, DQ_F32);
#undef DQ_F32
#undef DQ_BF16
}

const char* dpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
