// FlashAttention-2 forward and dQ for Hopper in float32, on mma.sync.
//
// Replace the Pallas TPU kernels of
//   distributed_pytorch_training_tpu/ops/flash_attention.py
// for float32 inputs as follows:
//   flash_fwd_kernel     <- _flash_fwd_lse (:199), body _fwd_kernel (:146)
//   flash_bwd_dq_kernel  <- _flash_bwd (:360), body _bwd_dq_kernel (:317)
// float32 dK/dV (K4) is the wgmma kernel of flash_attention_sm90_tf32.cu;
// bfloat16 K3, K4 and K5 are the wgmma kernels of flash_attention_sm90.cu,
// which keep the semantics below and the bf16 arithmetic in its header.
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
//     dot (:294, :341) and dS (:308, :352). The bf16 forward multiplies
//     the bf16 inputs as they are and scales the float32 dot: the two
//     differ by float32 rounding only, and not at all at D 64 (scale 1/8);
//   * the backward re-masks (causal and kv_valid), so no gradient reaches a
//     masked key through a normal row.
// Inputs are (B, S, H, D), read through their batch, sequence and head
// strides (the last axis is contiguous), so q, k and v can be views of one
// fused qkv tensor. Arithmetic is float32 throughout; out, dq, dk and dv
// are written contiguous in the input dtype, lse as (B*H, Sq) float32.
// kv_valid, when given, is (B, Sk) float32: a key attends iff > 0.
//
// Bound on the card: operations. At GPT-2 124M's shape (B 8, S 1024, H 12,
// D 64, causal) the forward does 4*D flops per live (q, k) pair, dK/dV 8*D
// and dQ 6*D (the JAX module's _cost counts), about 12.9, 25.8 and 19.4
// GFLOP, against some 100 MB of traffic each. Float32-accurate products on
// the tensor cores cost three TF32 products, so the least time is at 495 / 3
// = 165 TFLOP/s (the H100 SXM's dense TF32 rate, NVIDIA's data sheet):
// 0.078, 0.156 and 0.117 ms.
//
// All three kernels run every product on the tensor cores through
// mma.sync.m16n8k8 TF32 with float32 accumulation, as a 3xTF32 split: x =
// big + small, big = x rounded to TF32 (cvt.rna.tf32.f32's rounding), small
// = (x - big) rounded to TF32, and a b = big big + big small + small big
// (small small dropped). One TF32 pass is not enough. Emulated on the CPU
// (tests/test_torch_tf32_split.py) at D 64 against float32 plain
// arithmetic, max error over max |plain|, past the port's float32
// tolerance of 1e-4 with one pass and far inside it with three:
//   forward (out, lse), one pass: 3.1e-4, 7.2e-5 (B 2, S 128, causal);
//     4.7e-4, 1.0e-4 (causal + kv_valid); 5.6e-4, 4.9e-5 (S 96, kv_valid);
//     3.4e-4, 5.9e-5 (B 1, S 1024, causal); three passes: 2.8e-7, 8.5e-8;
//     1.8e-7, 9.0e-8; 8.1e-7, 8.9e-8; 2.5e-7, 1.2e-7;
//   backward (dq, dk, dv), one pass: (7.0e-4, 7.2e-4, 3.0e-4) at S 128 and
//     (3.5e-4, 5.6e-4, 3.4e-4) at S 1024, causal; three passes: (6.4e-7,
//     5.3e-7, 4.9e-7) and (3.4e-7, 1.0e-6, 1.0e-6).
// These kernels take float32 inputs alone.
// What the tiling does about the limits of a SIMT design:
//   * products: a warp owns 16 rows of its block's 64-row tile and computes
//     16 x 64 score tiles with mma.sync; P and dS go from the accumulators
//     straight into the next product's A operand, with the depth order of
//     the B operand permuted to match (no shuffle, no shared-memory trip);
//     fragment reads are free of bank conflicts (row stride D + 16 bytes);
//   * loads: the streamed side (K and V) is double-buffered with 16-byte cp.async, so the next tile's copy runs
//     under this tile's products; a row that is not 16-byte aligned is
//     staged element by element instead;
//   * masks: a tile wholly below the causal diagonal, inside both lengths
//     and without kv_valid, takes no mask test;
//   * occupancy: 128 threads a block; D is zero-padded to 16, 32, 64 or 128
//     columns, which is exact.
//
// Forward (K3): one block per (batch * head, 64-row q tile), heaviest
// causal tiles first; warp w owns q rows 16 w..16 w + 15. Q stays resident
// (five tiles of shared memory with K and V's two buffers each: 85 KB at D
// 64 in float32, 165 KB at D 128; up to D 64 also as split A fragments in
// registers, 233 registers a thread at D 64). Per k tile a warp forms S =
// (scale Q) K^T (q scaled in float32 as each element enters its A
// fragment, before the split, as the JAX kernel scales q before the dot),
// masks it where needs_mask says a mask bites, and keeps the online
// softmax in registers:
// a thread holds rows g and g + 8 of its warp's 16 x 64 S tile, the row max
// and row sum reduce over the 4 lanes of a quad, m and l stay float32, and
// alpha = exp(m_old - m_new) rescales the O accumulator in float32. P goes
// from the S accumulators straight into P V (no shared-memory P); each
// tile's P V sums in a fresh accumulator per 16 x 8 output tile, the D / 8
// tiles' mma chains side by side, and is added to alpha O in IEEE float32,
// so the running O never passes through the tensor cores' accumulation.
//
// dQ (K5): six tiles of shared memory a block (105 KB at D 64, so two
// blocks an SM).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;            // rows of a q tile and of a k tile
constexpr int kThreads = 128;        // 4 warps of 16 tile rows each
constexpr float kNegInf = -FLT_MAX;  // NEG_INF of the JAX module
constexpr unsigned kFullMask = 0xffffffffu;

struct Strides {  // element strides of a (B, S, H, D) tensor; D's is 1
  long long b, s, h;
};

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

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
// tensor-core helpers (TF32 mma.sync, 3xTF32)
// --------------------------------------------------------------------------

// A float split for 3xTF32: x = hi + lo, each a TF32 value (the low 13 bits
// zero). The rounding is cvt.rna.tf32.f32's (to nearest, ties away from
// zero), written as integer operations on the bits so that the low bits
// are zero by construction; the CPU test reproduces it bit for bit.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
struct Frag {  // N registers of one mma operand, big and small parts
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ void split(Frag<N>& f, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.hi[i] = tf32_rna(x[i]);
    f.lo[i] = tf32_rna(x[i] - __uint_as_float(f.hi[i]));
  }
}

// c += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), c 16 x 8
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: c += a.hi b.lo + a.lo b.hi + a.hi b.hi (small terms first; the
// a.lo b.lo term, 2^-22 of the product, is dropped)
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.hi);
}

// The m16n8k8 fragments (PTX ISA, mma.m16n8k8 .tf32), lane = 4 g + t:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g)            as (k, n)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

// A from a row-major tile: rows r0.., depth columns k0..k0 + 7, each
// element times `mul` in float32 before the split
template <int LD>
__device__ __forceinline__ void load_a(Frag<4>& f, const float* s, int r0,
                                       int k0, int g, int t,
                                       float mul = 1.0f) {
  const float* p = s + (r0 + g) * LD + k0 + t;
  const float x[4] = {p[0] * mul, p[8 * LD] * mul, p[4] * mul,
                      p[8 * LD + 4] * mul};
  split(f, x);
}

// B = X^T for a product against the rows of X: n = rows n0.., k = depth
// columns k0..k0 + 7
template <int LD>
__device__ __forceinline__ void load_bt(Frag<2>& f, const float* s, int n0,
                                        int k0, int g, int t) {
  const float* p = s + (n0 + g) * LD + k0 + t;
  const float x[2] = {p[0], p[4]};
  split(f, x);
}

// B = X for a product over X's rows, with the depth order permuted to match
// an accumulator re-used as A (see acc_as_a): k = t <-> row r0 + 2t,
// k = t + 4 <-> row r0 + 2t + 1; n = columns n0..n0 + 7
template <int LD>
__device__ __forceinline__ void load_b(Frag<2>& f, const float* s, int r0,
                                       int n0, int g, int t) {
  const float* p = s + (r0 + 2 * t) * LD + n0 + g;
  const float x[2] = {p[0], p[LD]};
  split(f, x);
}

// An accumulator tile (16 x 8, columns = the next product's depth) as that
// product's A operand, with no data movement: the thread's c0..c3 hold
// columns 2t and 2t + 1, which the permuted depth order of load_b names
// t and t + 4.
__device__ __forceinline__ void acc_as_a(Frag<4>& f, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split(f, x);
}

// --------------------------------------------------------------------------
// asynchronous staging into shared memory
// --------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory tile of DP (D zero-padded to a multiple of 8) columns: the
// row stride LD = DP + 16 bytes makes every fragment read above free of
// bank conflicts (LD = 4 mod 32 words for float32) and keeps rows 16-byte
// aligned for cp.async.
template <typename T, int DP>
struct Tile {
  static constexpr int kLd = DP + 16 / static_cast<int>(sizeof(T));
  static constexpr int kElems = kTile * kLd;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int kChunks = DP / kVec;                      // per row
};

// Rows [row0, row0 + kTile) of one (batch, head) slice (`src` at its row 0,
// `s_stride` apart) into a tile; rows at or past `n_rows` and columns at or
// past D are zero. `vec`: every row is 16-byte aligned and D * sizeof(T) a
// multiple of 16, so 16-byte cp.async copies (zero-filled where invalid);
// else a scalar path that loads and stores synchronously.
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(T* dst, const T* src,
                                           long long s_stride, int row0,
                                           int n_rows, int D, bool vec) {
  using L = Tile<T, DP>;
  if (vec) {
    const int c = threadIdx.x % L::kChunks;
    const int col = c * L::kVec;
    for (int r = threadIdx.x / L::kChunks; r < kTile;
         r += kThreads / L::kChunks) {
      const int row = row0 + r;
      const bool ok = row < n_rows && col < D;
      cp_async16(dst + r * L::kLd + col,
                 src + (ok ? row * s_stride + col : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
      const int r = i / DP;
      const int col = i % DP;
      const int row = row0 + r;
      if (row < n_rows && col < D) {
        dst[r * L::kLd + col] = src[row * s_stride + col];
      } else {
        store_f(dst + r * L::kLd + col, 0.0f);
      }
    }
  }
}

// p of one (q row, key) element after the JAX kernels' masks (JAX
// :294/:305, :341/:350): p = exp(scale * s - lse). Rows past Sq get 0.
__device__ __forceinline__ float masked_p(float s, int row, int col, int Sq,
                                          int Sk, bool causal,
                                          const float* kvm, float lse) {
  return row < Sq ? expf(masked(s, row, col, Sk, causal, kvm) - lse) : 0.0f;
}

// Whether the tile pair (q rows q0.., keys k0..) needs any mask: a tile
// wholly below the causal diagonal, inside both lengths and without
// kv_valid, takes p = exp(scale * s - lse) directly.
__device__ __forceinline__ bool needs_mask(int q0, int k0, int Sq, int Sk,
                                           bool causal, bool has_kvm) {
  return has_kvm || q0 + kTile > Sq || k0 + kTile > Sk ||
         (causal && k0 + kTile - 1 > q0);
}

// Two 16 x 8 N accumulators of one warp, x = scale * x1 -> p, y -> dS =
// p * (y - delta) * scale (JAX :305/:308, :350/:352), in place. Element
// (j, c) lies at local row rl(c) and column col0 + 8 j + 2 t + (c & 1);
// `p_of` returns p for (row, column, scaled logit).
template <int N, typename POf, typename DeltaOf>
__device__ __forceinline__ void p_and_ds(float (&x)[N][4], float (&y)[N][4],
                                         float scale, POf p_of,
                                         DeltaOf delta_of, int g, int t,
                                         int col0 = 0) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = g + 8 * (c >> 1);
      const int col = col0 + 8 * j + 2 * t + (c & 1);
      const float p = p_of(r, col, scale * x[j][c]);
      x[j][c] = p;
      y[j][c] = p * (y[j][c] - delta_of(r, col)) * scale;
    }
  }
}

// Write a warp's 16 x DP accumulator (rows r0.., columns 8 n + 2 t + (c & 1))
// to rows below n_rows and columns below D of `out` (row_stride apart).
template <typename T, int DP>
__device__ __forceinline__ void store_acc(T* out, long long row_stride,
                                          const float (&acc)[DP / 8][4],
                                          int r0, int n_rows, int D, int g,
                                          int t) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = r0 + g + 8 * (c >> 1);
      const int col = 8 * n + 2 * t + (c & 1);
      if (row < n_rows && col < D) store_f(out + row * row_stride + col,
                                           acc[n][c]);
    }
  }
}

// acc += X Y over one tile pair: X is a warp's 16 x kTile accumulator
// (split once into A operands), Y the kTile rows of a shared-memory tile.
// Each 16 x 8 output tile sums this tile's products in a fresh accumulator
// and is then added to `acc` in IEEE float32 arithmetic, so the running
// sum over the whole loop never passes through the tensor cores'
// accumulation.
template <int DP>
__device__ __forceinline__ void add_product(float (&acc)[DP / 8][4],
                                            const float (&x)[kTile / 8][4],
                                            const float* y, int g, int t) {
  Frag<4> a[kTile / 8];
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) acc_as_a(a[j], x[j]);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    float part[4] = {};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      Frag<2> b;
      load_b<Tile<float, DP>::kLd>(b, y, 8 * j, 8 * n, g, t);
      mma3(part, a[j], b);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] += part[c];
  }
}

// --------------------------------------------------------------------------
// forward: out and lse (K3)
// --------------------------------------------------------------------------

// max / sum over the 4 lanes of a quad, which hold one row of an
// accumulator tile
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

// One block per (batch * head, 64-row q tile), heaviest causal tiles first;
// warp w owns q rows 16 w..16 w + 15. Q stays resident; the block walks the
// live k tiles with K and V double-buffered by cp.async. Per k tile a warp
// forms S = (scale Q) K^T (16 x 64), masks it where a mask bites, updates
// the online softmax (m, l) of its rows in registers and feeds P straight
// to O = alpha O + P V, accumulated in registers over the whole loop.
// float32 only: bfloat16 inputs take flash_attention_sm90.cu's forward.
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kv_valid,
    float* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
    int D, Strides qs, Strides ks, Strides vs, float scale, int causal,
    int vec) {
  using T = float;
  using L = Tile<T, DP>;
  constexpr int LD = L::kLd;
  // up to D 64, Q's A fragments are scaled and split once and stay in
  // registers; at D 128 they would spill, and are read from sQ per tile
  constexpr bool kQInRegs = DP <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + L::kElems;        // [2] buffers
  T* sV = sK + 2 * L::kElems;    // [2]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int qr0 = 16 * warp;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;

  int n_kt = (Sk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);
  stage_tile<T, DP>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D, vec);
  stage_tile<T, DP>(sK, kb, ks.s, 0, Sk, D, vec);
  stage_tile<T, DP>(sV, vb, vs.s, 0, Sk, D, vec);
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: running max (from NEG_INF, as the
  // JAX kernel's m) and sum, and the output accumulator
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float o_acc[DP / 8][4] = {};
  Frag<4> q_frags[kQInRegs ? DP / 8 : 1];
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      const int next = (kt + 1) * kTile;
      stage_tile<T, DP>(sK + (buf ^ 1) * L::kElems, kb, ks.s, next, Sk, D,
                        vec);
      stage_tile<T, DP>(sV + (buf ^ 1) * L::kElems, vb, vs.s, next, Sk, D,
                        vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + buf * L::kElems;
    const T* cV = sV + buf * L::kElems;
    const int k0 = kt * kTile;

    // S = (scale Q) K^T: 16 q rows x 64 keys per warp
    if constexpr (kQInRegs) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < DP; kk += 8) {
          load_a<LD>(q_frags[kk / 8], sQ, qr0, kk, g, t, scale);
        }
      }
    }
    float s[kTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      Frag<4> qa;
      if constexpr (kQInRegs) {
        qa = q_frags[kk / 8];
      } else {
        load_a<LD>(qa, sQ, qr0, kk, g, t, scale);
      }
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        Frag<2> kf;
        load_bt<LD>(kf, cK, 8 * j, kk, g, t);
        mma3(s[j], qa, kf);
      }
    }
    if (needs_mask(q0, k0, Sq, Sk, causal, kvm != nullptr)) {
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = masked(s[j][c], q0 + qr0 + g + 8 * (c >> 1),
                           k0 + 8 * j + 2 * t + (c & 1), Sk, causal, kvm);
        }
      }
    }

    // online softmax (JAX :183-:190): element (j, c) is row c >> 1
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = expf(s[j][c] - m[c >> 1]);
        sum[c >> 1] += s[j][c];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);

    // O = alpha O + P V (JAX :189), depth = the tile's 64 keys: each 16 x 8
    // output tile sums this tile's products in a fresh accumulator, as
    // add_product does, with the DP / 8 tiles' mma chains side by side
    float part[DP / 8][4] = {};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      Frag<4> pa;
      acc_as_a(pa, s[j]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        Frag<2> vf;
        load_b<LD>(vf, cV, 8 * j, 8 * n, g, t);
        mma3(part[n], pa, vf);
      }
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o_acc[n][c] = o_acc[n][c] * alpha[c >> 1] + part[n][c];
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  // out = O / l and lse = m + log l, l floored at 1e-30 (JAX :194-:196)
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaxf(l[i], 1e-30f);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o_acc[n][c] /= l[c >> 1];
  }
  const long long row_stride = (long long)H * D;
  store_acc<T, DP>(out + (long long)b * Sq * row_stride + (long long)h * D,
                   row_stride, o_acc, q0 + qr0, Sq, D, g, t);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + qr0 + g + 8 * i;
      if (row < Sq) lse[(long long)bh * Sq + row] = m[i] + logf(l[i]);
    }
  }
}

// --------------------------------------------------------------------------
// backward: dQ (K5)
// --------------------------------------------------------------------------

// One block per (batch * head, 64-row q tile), heaviest causal tiles first;
// warp w owns q rows 16 w..16 w + 15. Q, dO, lse and delta stay resident;
// the block walks the live k tiles with K and V double-buffered by
// cp.async. Per k tile a warp forms S = Q K^T and dP = dO V^T (16 x 64),
// turns them into dS in registers and feeds it straight to dQ += dS K,
// accumulated in registers over the whole loop.
// float32 only: bfloat16 inputs take flash_attention_sm90.cu's dQ.
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ kv_valid, float* __restrict__ dq, int H,
    int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, float scale,
    int causal, int vec) {
  using T = float;
  using L = Tile<T, DP>;
  constexpr int LD = L::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + L::kElems;
  T* sK = sdO + L::kElems;       // [2] buffers
  T* sV = sK + 2 * L::kElems;    // [2]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int qr0 = 16 * warp;
  const long long row_stride = (long long)H * D;  // dout, dq
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;

  // this thread's two q rows (local g and g + 8)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr0 + g + 8 * i;
    row_lse[i] = row < Sq ? lse[(long long)bh * Sq + row] : 0.0f;
    row_delta[i] = row < Sq ? delta[(long long)bh * Sq + row] : 0.0f;
  }

  int n_kt = (Sk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);
  stage_tile<T, DP>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D, vec);
  stage_tile<T, DP>(sdO, dout + (long long)b * Sq * row_stride +
                             (long long)h * D,
                    row_stride, q0, Sq, D, vec);
  stage_tile<T, DP>(sK, kb, ks.s, 0, Sk, D, vec);
  stage_tile<T, DP>(sV, vb, vs.s, 0, Sk, D, vec);
  cp_async_commit();

  float dq_acc[DP / 8][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      const int next = (kt + 1) * kTile;
      stage_tile<T, DP>(sK + (buf ^ 1) * L::kElems, kb, ks.s, next, Sk, D,
                        vec);
      stage_tile<T, DP>(sV + (buf ^ 1) * L::kElems, vb, vs.s, next, Sk, D,
                        vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + buf * L::kElems;
    const T* cV = sV + buf * L::kElems;
    const int k0 = kt * kTile;

    // S = Q K^T and dP = dO V^T: 16 q rows x 64 keys per warp
    float s[kTile / 8][4] = {};
    float dp[kTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      Frag<4> qa, oa;
      load_a<LD>(qa, sQ, qr0, kk, g, t);
      load_a<LD>(oa, sdO, qr0, kk, g, t);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        Frag<2> kf, vf;
        load_bt<LD>(kf, cK, 8 * j, kk, g, t);
        load_bt<LD>(vf, cV, 8 * j, kk, g, t);
        mma3(s[j], qa, kf);
        mma3(dp[j], oa, vf);
      }
    }

    auto delta_of = [&](int r, int) { return row_delta[r >> 3]; };
    if (needs_mask(q0, k0, Sq, Sk, causal, kvm != nullptr)) {
      p_and_ds(s, dp, scale,
               [&](int r, int col, float x) {
                 return masked_p(x, q0 + qr0 + r, k0 + col, Sq, Sk, causal,
                                 kvm, row_lse[r >> 3]);
               },
               delta_of, g, t);
    } else {
      p_and_ds(s, dp, scale,
               [&](int r, int, float x) { return expf(x - row_lse[r >> 3]); },
               delta_of, g, t);
    }

    // dQ += dS K, depth = the tile's 64 keys
    add_product<DP>(dq_acc, dp, cK, g, t);
    __syncthreads();  // this buffer is refilled two tiles on
  }

  store_acc<T, DP>(dq + (long long)b * Sq * row_stride + (long long)h * D,
                   row_stride, dq_acc, q0 + qr0, Sq, D, g, t);
}

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------

// K3 holds five tiles (Q resident, K and V double-buffered)
template <typename T, int DP>
size_t fwd_smem() {
  return 5 * Tile<T, DP>::kElems * sizeof(T);
}

// K5 holds six tiles (two resident, two double-buffered)
template <typename T, int DP>
size_t dq_smem() {
  return 6 * Tile<T, DP>::kElems * sizeof(T);
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

// Every row of a (B, S, H, D) tensor at `x` with these strides (and of the
// contiguous dO, when given) starts on a 16-byte boundary and D fills whole
// 16-byte chunks: the kernels stage with cp.async, else element by element.
template <typename T>
bool rows_aligned(const Problem& p, const void* q, const void* k,
                  const void* v, const void* dout = nullptr) {
  const long long e = sizeof(T);
  auto ok = [&](const void* x, const Strides& s) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0 && s.b * e % 16 == 0 &&
           s.s * e % 16 == 0 && s.h * e % 16 == 0;
  };
  return p.D * e % 16 == 0 && ok(q, p.qs) && ok(k, p.ks) && ok(v, p.vs) &&
         reinterpret_cast<uintptr_t>(dout) % 16 == 0;
}

// float32 only
template <int DP>
int fwd_t(const Problem& p, const void* q, const void* k, const void* v,
          const float* kv_valid, void* out, float* lse) {
  const size_t smem = fwd_smem<float, DP>();
  auto kernel = flash_fwd_kernel<DP>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<grid_of(p, p.Sq), kThreads, smem, p.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_valid, static_cast<float*>(out), lse,
      p.H, p.Sq, p.Sk, p.D, p.qs, p.ks, p.vs, p.scale, p.causal,
      rows_aligned<float>(p, q, k, v));
  return static_cast<int>(cudaGetLastError());
}

// float32 only
template <int DP>
int dq_t(const Problem& p, const void* q, const void* k, const void* v,
         const void* dout, const float* lse, const float* delta,
         const float* kv_valid, void* dq) {
  const size_t smem = dq_smem<float, DP>();
  auto kernel = flash_bwd_dq_kernel<DP>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<grid_of(p, p.Sq), kThreads, smem, p.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, kv_valid, static_cast<float*>(dq), p.H, p.Sq, p.Sk, p.D, p.qs,
      p.ks, p.vs, p.scale, p.causal,
      rows_aligned<float>(p, q, k, v, dout));
  return static_cast<int>(cudaGetLastError());
}

// D zero-padded to 16, 32, 64 or 128 columns.
#define DP_DISPATCH(D, CALL) \
  ((D) <= 16 ? CALL(16)      \
             : (D) <= 32 ? CALL(32) : (D) <= 64 ? CALL(64) : CALL(128))

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
// accepted. Both take float32 alone (`bf16` must be 0): bfloat16 inputs
// go to flash_attention_sm90.cu's entry points of the same names and
// signatures, and float32 dK/dV to flash_attention_sm90_tf32.cu's
// dpt_flash_bwd_dkv.

int dpt_flash_fwd(const void* q, const void* k, const void* v,
                  const float* kv_valid, void* out, float* lse, int B,
                  int H, int Sq, int Sk, int D, long long qsb, long long qss,
                  long long qsh, long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh, float scale,
                  int causal, int bf16, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = make_problem(B, H, Sq, Sk, D, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, scale, causal, stream);
  if (bf16) return static_cast<int>(cudaErrorInvalidValue);
#define FWD_F32(N) fwd_t<N>(p, q, k, v, kv_valid, out, lse)
  return DP_DISPATCH(D, FWD_F32);
#undef FWD_F32
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
  if (bf16) return static_cast<int>(cudaErrorInvalidValue);
#define DQ_F32(N) dq_t<N>(p, q, k, v, dout, lse, delta, kv_valid, dq)
  return DP_DISPATCH(D, DQ_F32);
#undef DQ_F32
}

const char* dpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
