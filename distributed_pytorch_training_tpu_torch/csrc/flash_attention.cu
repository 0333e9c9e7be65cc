// FlashAttention-2 forward and backward for Hopper: three kernels in
// float32, and the dQ kernel in bfloat16.
//
// Replace the Pallas TPU kernels of
//   distributed_pytorch_training_tpu/ops/flash_attention.py
// as follows:
//   flash_fwd_kernel     <- _flash_fwd_lse (:199), body _fwd_kernel (:146)
//   flash_bwd_dkv_kernel <- _flash_bwd (:360), body _bwd_dkv_kernel (:269)
//   flash_bwd_dq_kernel  <- _flash_bwd (:360), body _bwd_dq_kernel (:317)
// For bfloat16 inputs dQ launches flash_bwd_dq_bf16_kernel (after the
// float32 kernels); the bfloat16 forward and dK/dV are the wgmma kernels of
// flash_attention_sm90.cu, which keep the bf16 arithmetic described below.
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
// Inputs are (B, S, H, D) in float32 or bfloat16, read through their batch,
// sequence and head strides (the last axis is contiguous), so q, k and v can
// be views of one fused qkv tensor. Arithmetic is float32 throughout,
// except that the bf16 kernels round P (P^T and dS^T in dK/dV, dS in dQ)
// once to bf16 as the next product's operand; out, dq, dk and dv are written
// contiguous in the input dtype, lse as (B*H, Sq) float32. kv_valid, when
// given, is (B, Sk) float32: a key attends iff > 0.
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
// These three kernels take float32 inputs alone: bfloat16 inputs have
// kernels of their own (below).
// What the tiling does about the limits of a SIMT design:
//   * products: a warp owns 16 rows of its block's 64-row tile and computes
//     16 x 64 score tiles with mma.sync; P and dS go from the accumulators
//     straight into the next product's A operand, with the depth order of
//     the B operand permuted to match (no shuffle, no shared-memory trip);
//     fragment reads are free of bank conflicts (row stride D + 16 bytes);
//   * loads: the streamed side (K and V for K3 and K5, Q and dO for K4) is
//     double-buffered with 16-byte cp.async, so the next tile's copy runs
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
// Backward (K4 dK/dV, K5 dQ): six tiles of shared memory a block (105 KB at
// D 64 in float32, so two blocks an SM).
//
// bfloat16 (K5 here; K3 and K4 in flash_attention_sm90.cu with the same
// arithmetic): the tiling, masks and staging above, with every
// product one mma.sync m16n8k16 bf16 x bf16 -> float32 per 16 of depth
// (989 TFLOP/s dense, twice TF32's rate, against the four TF32 products
// a split operand costs) and fragments read by ldmatrix (16 bytes a lane,
// conflict-free at the row stride of D + 16 bytes), non-transposed along
// D and transposed along the sequence. S (S^T, dP^T) multiplies the bf16
// inputs as they are: a product of two bf16 values is exact in float32.
// P (P^T and dS^T in K4, dS in K5) is formed in float32, l summed over the
// float32 P, and rounded once to bf16 (to nearest even) into the next
// product's A operand: m16n8k16's C layout of two neighbouring 8-column
// tiles is its A layout, so a thread packs its own registers. m, l,
// alpha, O, dQ, dK and dV stay float32 in registers, and O, dQ, dK and dV
// accumulate on the tensor cores. Emulated on the CPU
// (tests/test_torch_bf16_mma.py) against the float32 plain versions on the
// same bf16 inputs, max error over max |plain| before the outputs' own
// rounding to bf16: out <= 1.4e-3, dq, dk and dv <= 2.4e-3, lse <=
// 1.3e-7, so no operand needs a second bf16 term. Bound on the card at
// GPT-2 124M's shape: 12.9, 25.8 and 19.4 GFLOP at 989 TFLOP/s, 0.013,
// 0.026 and 0.020 ms, against 0.015, 0.023 and 0.019 ms of bytes (K3
// bound by bytes, K4 and K5 by operations). In K5 each warp owns 16 q rows
// and 4 blocks an SM fit at D 64: 128 registers a thread, Q's and dO's
// fragments resident, S and dP formed 16 keys at a time. One barrier a
// tile: a tile's copy is issued right after it, into the buffer every warp
// has finished with.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kTile = 64;            // rows of a q tile and of a k tile
constexpr int kThreads = 128;        // 4 warps of 16 tile rows each
constexpr float kNegInf = -FLT_MAX;  // NEG_INF of the JAX module
constexpr unsigned kFullMask = 0xffffffffu;

struct Strides {  // element strides of a (B, S, H, D) tensor; D's is 1
  long long b, s, h;
};

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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
// backward: dK and dV (K4)
// --------------------------------------------------------------------------

// One block per (batch * head, 64-key tile); warp w owns keys 16 w..16 w +
// 15 of the tile. K and V stay in shared memory; the block walks the live
// q tiles with Q, dO, lse and delta double-buffered by cp.async. Per q
// tile a warp forms S^T = K Q^T and dP^T = V dO^T (16 x 64), turns them
// into P^T and dS^T in registers and feeds those straight to dV += P^T dO
// and dK += dS^T Q, accumulated in registers over the whole loop.
// float32 only: bfloat16 inputs take flash_attention_sm90.cu's dK/dV.
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ kv_valid, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Sq, int Sk, int D, Strides qs,
    Strides ks, Strides vs, float scale, int causal, int vec) {
  using T = float;
  using L = Tile<T, DP>;
  constexpr int LD = L::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + L::kElems;
  T* sQ = sV + L::kElems;        // [2] buffers
  T* sdO = sQ + 2 * L::kElems;   // [2]
  float* sRows = reinterpret_cast<float*>(sdO + 2 * L::kElems);  // [2][2][64]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int kr0 = 16 * warp;
  const long long row_stride = (long long)H * D;  // dout, dk, dv
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + (long long)b * Sq * row_stride + (long long)h * D;
  const long long lse_base = (long long)bh * Sq;
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;

  const int n_qt = (Sq + kTile - 1) / kTile;
  // causal: q tiles whose last row is before this tile's first key are dead
  const int qt0 = causal ? k0 / kTile : 0;
  auto stage_q = [&](int buf, int qt) {
    const int q0 = qt * kTile;
    stage_tile<T, DP>(sQ + buf * L::kElems, qb, qs.s, q0, Sq, D, vec);
    stage_tile<T, DP>(sdO + buf * L::kElems, dob, row_stride, q0, Sq, D,
                      vec);
    const int i = threadIdx.x;  // 128 threads: 64 lse, then 64 delta
    const int row = q0 + (i & (kTile - 1));
    const bool ok = row < Sq;
    cp_async4(sRows + buf * 2 * kTile + i,
              (i < kTile ? lse : delta) + lse_base + (ok ? row : 0), ok);
  };

  stage_tile<T, DP>(sK, k + b * ks.b + h * ks.h, ks.s, k0, Sk, D, vec);
  stage_tile<T, DP>(sV, v + b * vs.b + h * vs.h, vs.s, k0, Sk, D, vec);
  if (qt0 < n_qt) stage_q(0, qt0);
  cp_async_commit();

  float dk_acc[DP / 8][4] = {};
  float dv_acc[DP / 8][4] = {};
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < n_qt) {
      stage_q(buf ^ 1, qt + 1);  // overlaps this tile's products
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cQ = sQ + buf * L::kElems;
    const T* cdO = sdO + buf * L::kElems;
    const float* cLse = sRows + buf * 2 * kTile;
    const float* cDelta = cLse + kTile;
    const int q0 = qt * kTile;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 q rows per warp
    float st[kTile / 8][4] = {};
    float dpt[kTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      Frag<4> ka, va;
      load_a<LD>(ka, sK, kr0, kk, g, t);
      load_a<LD>(va, sV, kr0, kk, g, t);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        Frag<2> qf, of;
        load_bt<LD>(qf, cQ, 8 * j, kk, g, t);
        load_bt<LD>(of, cdO, 8 * j, kk, g, t);
        mma3(st[j], ka, qf);
        mma3(dpt[j], va, of);
      }
    }

    // P^T and dS^T: rows are keys, columns q rows
    auto delta_of = [&](int, int col) { return cDelta[col]; };
    if (needs_mask(q0, k0, Sq, Sk, causal, kvm != nullptr)) {
      p_and_ds(st, dpt, scale,
               [&](int r, int col, float s) {
                 return masked_p(s, q0 + col, k0 + kr0 + r, Sq, Sk, causal,
                                 kvm, cLse[col]);
               },
               delta_of, g, t);
    } else {
      p_and_ds(st, dpt, scale,
               [&](int, int col, float s) { return expf(s - cLse[col]); },
               delta_of, g, t);
    }

    // dV += P^T dO and dK += dS^T Q, depth = the tile's 64 q rows
    add_product<DP>(dv_acc, st, cdO, g, t);
    add_product<DP>(dk_acc, dpt, cQ, g, t);
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();  // no live q tile: K and V were staged for nothing

  const long long out_base = (long long)b * Sk * row_stride + (long long)h * D;
  store_acc<T, DP>(dk + out_base, row_stride, dk_acc, k0 + kr0, Sk, D, g, t);
  store_acc<T, DP>(dv + out_base, row_stride, dv_acc, k0 + kr0, Sk, D, g, t);
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
// float32 only: bfloat16 inputs take flash_bwd_dq_bf16_kernel.
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
// bfloat16 tensor-core helpers (mma.sync m16n8k16, ldmatrix)
// --------------------------------------------------------------------------

using bf16_t = __nv_bfloat16;

// c += a b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), bf16
// operands with float32 accumulation. The m16n8k16 fragments (PTX ISA,
// mma.m16n8k16 .bf16), lane = 4 g + t, two bf16 a register, the lower
// column (A) or depth (B) in the low half:
//   A (16 x 16): a0 (g, 2t..2t + 1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                a3 (g + 8, 2t + 8..)
//   B (16 x 8):  b0 (2t..2t + 1, g), b1 (2t + 8..2t + 9, g)   as (k, n)
//   C (16 x 8):  as m16n8k8's
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory into fragments: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned);
// register i receives matrix i's (row g, columns 2t, 2t + 1), or with
// .trans its (rows 2t, 2t + 1, column g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// A of rows r0..r0 + 15 of a row-major tile, depth columns k0..k0 + 15
template <int LD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16_t* s,
                                       int r0, int k0, int lane) {
  ldsm_x4(a, s + (r0 + (lane & 15)) * LD + k0 + 8 * (lane >> 4));
}

// B = X^T for a product against the rows of X: two 8-column output tiles,
// n = rows n0..n0 + 15, depth = columns k0..k0 + 15; b[0], b[1] are tile
// n0's, b[2], b[3] tile n0 + 8's
template <int LD>
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const bf16_t* s,
                                        int n0, int k0, int lane) {
  ldsm_x4(b, s + (n0 + (lane & 7) + 8 * (lane >> 4)) * LD + k0 +
                 8 * ((lane >> 3) & 1));
}

// B = X for a product over the rows of X: depth = rows k0..k0 + 15, two
// 8-column output tiles of columns n0..n0 + 15 (read transposed)
template <int LD>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const bf16_t* s,
                                       int k0, int n0, int lane) {
  ldsm_x4_trans(b, s + (k0 + (lane & 15)) * LD + n0 + 8 * (lane >> 4));
}

// two floats rounded to nearest even into one bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring 16 x 8 accumulator tiles (columns 0..15 of the next
// product's depth) as that product's A operand: m16n8k16's C layout of the
// pair is its A layout, so the thread packs its own registers.
__device__ __forceinline__ void acc_pair_as_a(uint32_t (&a)[4],
                                              const float (&c0)[4],
                                              const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc (16 x DP) += A (16 x 16, depth rows k0.. of tile y) y, on every
// pair of output tiles
template <int DP>
__device__ __forceinline__ void add_product_bf16(float (&acc)[DP / 8][4],
                                                 const uint32_t (&a)[4],
                                                 const bf16_t* y, int k0,
                                                 int lane) {
#pragma unroll
  for (int nn = 0; nn < DP / 16; ++nn) {
    uint32_t b[4];
    ldsm_b<Tile<bf16_t, DP>::kLd>(b, y, k0, 16 * nn, lane);
    mma_bf16(acc[2 * nn], a, b[0], b[1]);
    mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
  }
}

// exp(x) for the bf16 kernels as exp2f(x log2 e): ex2.approx without
// flush-to-zero and without expf's extra-precise range reduction. P is
// rounded to bf16 after it; l and lse move by ~1e-7 of themselves.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp_bf16(float x) {
  return exp2f(x * kLog2e);
}

// Blocks an SM the bf16 dQ kernel is built for: 16 warps at D <= 64 (128
// registers a thread), 8 at D 128 (shared memory allows no more)
template <int DP>
constexpr int bf16_blocks_per_sm() {
  return DP <= 64 ? 4 : 2;
}

// --------------------------------------------------------------------------
// bfloat16 backward: dQ (K5)
// --------------------------------------------------------------------------

// keys of a staged k tile that one pass of the bf16 dQ kernel holds as S
// and dP accumulators (16 q rows x kDqCols keys each): with dQ and Q's and
// dO's resident A fragments (32 + 32 registers at D 64) they fit 128
// registers a thread without spilling
constexpr int kDqCols = 16;

// flash_bwd_dq_kernel's tiling, on the bf16 tensor cores. Q's and dO's A
// fragments are read once by ldmatrix and stay in registers; for each
// kDqCols-key slice of a staged k tile a warp forms S = Q K^T and dP = dO
// V^T from the bf16 inputs (K and V as B by ldmatrix), turns them into dS
// in float32, rounds it once to bf16 into the A operand of dQ += dS K (K
// read transposed), accumulated in float32 registers over the whole loop.
// One barrier a k tile, as the forward's.
template <int DP>
__global__ void __launch_bounds__(kThreads, bf16_blocks_per_sm<DP>())
    flash_bwd_dq_bf16_kernel(
        const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
        const bf16_t* __restrict__ v, const bf16_t* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const float* __restrict__ kv_valid, bf16_t* __restrict__ dq, int H,
        int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs,
        float scale, int causal, int vec) {
  using L = Tile<bf16_t, DP>;
  constexpr int LD = L::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* sQ = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* sdO = sQ + L::kElems;
  bf16_t* sK = sdO + L::kElems;       // [2] buffers
  bf16_t* sV = sK + 2 * L::kElems;    // [2]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qr0 = 16 * warp;
  const long long row_stride = (long long)H * D;  // dout, dq
  const bf16_t* kb = k + b * ks.b + h * ks.h;
  const bf16_t* vb = v + b * vs.b + h * vs.h;
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
  stage_tile<bf16_t, DP>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D, vec);
  stage_tile<bf16_t, DP>(sdO, dout + (long long)b * Sq * row_stride +
                                  (long long)h * D,
                         row_stride, q0, Sq, D, vec);
  stage_tile<bf16_t, DP>(sK, kb, ks.s, 0, Sk, D, vec);
  stage_tile<bf16_t, DP>(sV, vb, vs.s, 0, Sk, D, vec);
  cp_async_commit();

  float dq_acc[DP / 8][4] = {};
  uint32_t qa[DP / 16][4], oa[DP / 16][4];
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    // this tile has landed, and every warp is done with the other buffer
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < n_kt) {
      const int next = (kt + 1) * kTile;
      stage_tile<bf16_t, DP>(sK + (buf ^ 1) * L::kElems, kb, ks.s, next, Sk,
                             D, vec);
      stage_tile<bf16_t, DP>(sV + (buf ^ 1) * L::kElems, vb, vs.s, next, Sk,
                             D, vec);
      cp_async_commit();
    }
    const bf16_t* cK = sK + buf * L::kElems;
    const bf16_t* cV = sV + buf * L::kElems;
    const int k0 = kt * kTile;
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        ldsm_a<LD>(qa[kk], sQ, qr0, 16 * kk, lane);
        ldsm_a<LD>(oa[kk], sdO, qr0, 16 * kk, lane);
      }
    }
    const bool mask = needs_mask(q0, k0, Sq, Sk, causal, kvm != nullptr);

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kDqCols) {
      // S = Q K^T and dP = dO V^T: 16 q rows x kDqCols keys per warp
      float s[kDqCols / 8][4] = {};
      float dp[kDqCols / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < kDqCols / 16; ++jj) {
          uint32_t f[4];
          ldsm_bt<LD>(f, cK, c0 + 16 * jj, 16 * kk, lane);
          mma_bf16(s[2 * jj], qa[kk], f[0], f[1]);
          mma_bf16(s[2 * jj + 1], qa[kk], f[2], f[3]);
          ldsm_bt<LD>(f, cV, c0 + 16 * jj, 16 * kk, lane);
          mma_bf16(dp[2 * jj], oa[kk], f[0], f[1]);
          mma_bf16(dp[2 * jj + 1], oa[kk], f[2], f[3]);
        }
      }

      // P and dS in float32: rows are q rows, columns keys
      auto delta_of = [&](int r, int) { return row_delta[r >> 3]; };
      if (mask) {
        p_and_ds(s, dp, scale,
                 [&](int r, int col, float x) {
                   const int row = q0 + qr0 + r;
                   return row < Sq
                              ? exp_bf16(masked(x, row, k0 + col, Sk, causal,
                                                kvm) -
                                         row_lse[r >> 3])
                              : 0.0f;
                 },
                 delta_of, g, t, c0);
      } else {
        p_and_ds(s, dp, scale,
                 [&](int r, int, float x) {
                   return exp_bf16(x - row_lse[r >> 3]);
                 },
                 delta_of, g, t, c0);
      }

      // dQ += dS K, depth = these kDqCols keys
#pragma unroll
      for (int kk = 0; kk < kDqCols / 16; ++kk) {
        uint32_t a[4];
        acc_pair_as_a(a, dp[2 * kk], dp[2 * kk + 1]);
        add_product_bf16<DP>(dq_acc, a, cK, c0 + 16 * kk, lane);
      }
    }
  }

  store_acc<bf16_t, DP>(dq + (long long)b * Sq * row_stride +
                            (long long)h * D,
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

// K4 and K5 both hold six tiles (two resident, two double-buffered); K4
// adds lse and delta for its two q buffers
template <typename T, int DP>
size_t dkv_smem() {
  return 6 * Tile<T, DP>::kElems * sizeof(T) + 4 * kTile * sizeof(float);
}
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
// asked for) and return the error, 0 when accepted. `max_carveout`: ask
// for the SM's largest shared-memory share too, which the bf16 dQ kernel's
// four blocks an SM at D 64 need.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool max_carveout = false) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess && max_carveout) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  }
  return static_cast<int>(err);
}

// bfloat16 inputs take the bf16 dQ kernel (mma.sync m16n8k16 on the bf16
// tensor cores), float32 inputs the 3xTF32 ones; the bf16 forward and
// dK/dV are flash_attention_sm90.cu's
template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16_t>::value;

template <typename T, int DP>
auto dq_kernel() {
  if constexpr (kBf16<T>) {
    return flash_bwd_dq_bf16_kernel<DP>;
  } else {
    return flash_bwd_dq_kernel<DP>;
  }
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
int dkv_t(const Problem& p, const void* q, const void* k, const void* v,
          const void* dout, const float* lse, const float* delta,
          const float* kv_valid, void* dk, void* dv) {
  const size_t smem = dkv_smem<float, DP>();
  auto kernel = flash_bwd_dkv_kernel<DP>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<grid_of(p, p.Sk), kThreads, smem, p.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, kv_valid, static_cast<float*>(dk), static_cast<float*>(dv), p.H,
      p.Sq, p.Sk, p.D, p.qs, p.ks, p.vs, p.scale, p.causal,
      rows_aligned<float>(p, q, k, v, dout));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int dq_t(const Problem& p, const void* q, const void* k, const void* v,
         const void* dout, const float* lse, const float* delta,
         const float* kv_valid, void* dq) {
  const size_t smem = dq_smem<T, DP>();
  auto kernel = dq_kernel<T, DP>();
  if (int err = allow_smem(kernel, smem, kBf16<T>)) return err;
  kernel<<<grid_of(p, p.Sq), kThreads, smem, p.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_valid, static_cast<T*>(dq), p.H, p.Sq, p.Sk, p.D, p.qs, p.ks, p.vs,
      p.scale, p.causal, rows_aligned<T>(p, q, k, v, dout));
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
// accepted. `bf16` selects bfloat16 tensors, else float32; for bfloat16
// the forward and dK/dV are flash_attention_sm90.cu's entry points of the
// same names and signatures, and these refuse them.

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
  if (bf16) return static_cast<int>(cudaErrorInvalidValue);
#define DKV_F32(N) dkv_t<N>(p, q, k, v, dout, lse, delta, kv_valid, dk, dv)
  return DP_DISPATCH(D, DKV_F32);
#undef DKV_F32
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
  return bf16 ? DP_DISPATCH(D, DQ_BF16) : DP_DISPATCH(D, DQ_F32);
#undef DQ_F32
#undef DQ_BF16
}

const char* dpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
