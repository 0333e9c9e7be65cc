// FlashAttention dK/dV (K4) for float32 inputs, written for Hopper
// (sm_90a): every product is 3xTF32 on wgmma .tf32, fed by TMA.
//
// Replaces the Pallas TPU kernel of
//   distributed_pytorch_training_tpu/ops/flash_attention.py
// for float32 inputs:
//   flash_bwd_dkv_tf32_sm90_kernel <- _flash_bwd (:360), body
//                                     _bwd_dkv_kernel (:269), pallas_call :400
// bfloat16 K4 is flash_attention_sm90.cu's; float32 K3 and K5 stay with
// flash_attention.cu's mma.sync kernels. The C entry point
// dpt_flash_bwd_dkv has flash_attention.cu's signature and takes float32
// (bf16 = 0) only. flash_sm90.cuh holds what the Hopper kernels share.
//
// Semantics are flash_attention.cu's (its header): masked logits NEG_INF,
// keys past Sk -inf, causal top-left, the dot and dS scaled as the JAX
// kernel scales them, the backward re-masks; a tile pair that no mask
// bites takes no mask test, the masks are selects; p = expf(s - lse) in
// float32. Every dK and dV element is written once by the block that owns
// its key: no atomics, deterministic.
//
// 3xTF32: a float32 operand x is split as x = big + small; a product is
// big big + big small + small big, in that order per 8-deep slice, summed
// in float32 on the tensor cores (small small, 2^-22 of it, dropped). The
// tensor core reads a 32-bit register or word as tf32 and ignores its low
// 13 bits, so `big` is x itself as the TMA landed it (truncation, not
// cvt.rna's rounding) and small = x - big(x), exact in float32, in a tile
// or registers of its own. Emulated on the CPU
// (tests/test_torch_tf32_split.py) against the float32 plain backward, the
// truncated split lands within 2.1e-6 of max |plain| on every case, under
// FLASH_REL / 10 = 1e-5; cvt.rna's lands within 8.6e-7.
//
// Bound on the card (NVIDIA H100 SXM, 495 TFLOP/s dense TF32, NVIDIA's
// data sheet): at GPT-2 124M's shape (B 8, S 1024, H 12, D 64, causal)
// dK/dV does 25.8 GFLOP, three TF32 products each: 0.156 ms at 165
// TFLOP/s, against 0.046 ms of bytes. Bound by operations.
//
// Block: one per (batch * head, key tile), heaviest causal tiles first
// (the first key tiles see the most q tiles); K and V are loaded once by
// TMA and stay; Q, dO and the q tile's lse and delta rows ride a ring
// (lse and delta by cp.async, counted on the stage's mbarrier); causal
// blocks start at the first q tile that reaches the block's first key.
// Each consumer warpgroup owns 64 keys; thread 0 issues the copies. Per q
// tile a warpgroup computes S^T = K Q^T and dP^T = V dO^T as m64nMk8 (M:
// the q tile's rows), P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T -
// delta) scale in float32 registers, and accumulates dV += P^T dO and dK
// += dS^T Q as m64nDk8 with P^T and dS^T as the register A operand.
//
// The four things float32 changes, and what this kernel does:
// (1) wgmma .tf32 has no transpose bit: both shared-memory operands must be
//     K-major. S^T and dP^T read K, V, Q and dO as TMA lands them (D
//     contiguous, the depth). dV and dK sum over the q tile's rows, so
//     their B (dO, Q) must be q-contiguous: after a stage lands, the
//     block's threads write dO^T and Q^T (D rows of the tile's M q rows,
//     SWIZZLE_128B) once for both warpgroups, with 16-byte loads and 4-byte
//     stores that hit 32 banks a warp.
// (2) The split: an operand in registers splits in the registers. A
//     shared-memory B needs its small part as a tile of its own: Q and dO
//     small (row-major, for S^T and dP^T) and Q^T and dO^T small (for dK
//     and dV) are written by the same pass as the transposes; their big
//     parts are the raw tiles. K's and V's small parts are made once a
//     block: at D 64 as registers (the A operand of the small-big term,
//     32 + 32 a thread), at D 128 as shared-memory tiles.
// (3) A tf32 A fragment holds columns t and t + 4 of its 8, an accumulator
//     2t and 2t + 1. P^T and dS^T go from the accumulators into dV's and
//     dK's A operand with no data movement: the q order within each 8 of
//     the transposed tiles is permuted to match (k = t holds q 2t, k = t +
//     4 holds q 2t + 1), which the transpose pass writes at no cost. A
//     product's sum does not depend on the order of its depth.
// (4) Shared memory and registers (bytes; a transposed tile is D rows of
//     128 bytes):
//     D 64: two warpgroups (128 keys), q tiles of 32 rows (m64n32k8 for
//       S^T), a ring of 2 stages, two sets of derived tiles (one is written
//       while the other is read): K, V 64 KB + 2 x (Q + dO) 32 KB + 2 x
//       (Q, dO small 16 KB + 4 transposed 32 KB) 96 KB + lse, delta 0.5 KB
//       = 192.5 KB. Registers a thread: K, V small 64, S^T, dP^T 16 each,
//       dK, dV 32 each, P^T and dS^T as big and small A operands 64.
//     D 128: K, V and their small parts alone are 128 KB at 64 keys, and
//       as registers would be 128 a thread: one warpgroup (64 keys), K and
//       V small in shared memory, q tiles of 16 rows (m64n16k8; the
//       transposed tiles keep 128-byte rows, half used), one stage, one
//       set: K, V, K small, V small 128 KB + Q + dO 16 KB + (16 KB small +
//       4 x 16 KB transposed) 80 KB = 224 KB. Registers: S^T, dP^T 8
//       each, dK, dV 64 each, A operands 32.
// One block an SM at both widths; ptxas (CUDA 12.8) gives 221 registers a
// thread at D 64 and 187 at D 128, no spill. Order per q tile: S^T and dP^T
// (waited), the softmax terms, the stage released and refilled by TMA, dV
// and dK (waited), the next q tile's transposes, one __syncthreads. Two
// other layouts measured no faster on the card (PERF.md §6): one
// warpgroup a block with two blocks an SM, and dV and dK left running
// under the next tile's transposes and S^T (ptxas then serialized the
// wgmmas, C7515).
// Inputs must be 16-byte aligned with 16-byte strides and D a multiple of 4
// (TMA's rules for float32): ops/flash_attention.py stages a copy of any
// tensor that is not (never on the main paths). A box is 32 columns (128
// bytes); columns past D and rows past S arrive as zeros, which is exact.

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr int kF32 = 4;          // bytes of an element
constexpr int kBoxCols = 32;     // float32 columns of a TMA box: 128 bytes

// --------------------------------------------------------------------------
// 3xTF32 on wgmma
// --------------------------------------------------------------------------

// x as the tensor core reads it in tf32: its low 13 bits ignored
__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// the small part of x's split, exact in float32
__device__ __forceinline__ float tf32_small(float x) {
  return x - tf32_big(x);
}

// d (64 x 16) = a b + (scale_d ? d : 0) in tf32: a (64 x 8) and b (8 x
// 16), both K-major in shared memory (descriptors da and db)
__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[2][4],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// d (64 x 32) = a b + (scale_d ? d : 0) in tf32: a (64 x 8) and b (8 x
// 32), both K-major in shared memory (descriptors da and db)
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[4][4],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// d (64 x 32) += a b in tf32: a (64 x 8) in registers (each warp's 16
// rows in the m16n8k8 A layout), b (8 x 32) K-major in shared memory (db)
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[4][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 64) += a b in tf32: a (64 x 8) in registers (each warp's 16
// rows in the m16n8k8 A layout), b (8 x 64) K-major in shared memory (db)
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[8][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 128) += a b in tf32: a (64 x 8) in registers (each warp's 16
// rows in the m16n8k8 A layout), b (8 x 128) K-major in shared memory (db)
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[16][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 8][4],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  if constexpr (N == 16) {
    wgmma_tf32_ss_n16(d, da, db, scale_d);
  } else {
    wgmma_tf32_ss_n32(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (N == 32) {
    wgmma_tf32_rs_n32(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_tf32_rs_n64(d, a, db);
  } else {
    wgmma_tf32_rs_n128(d, a, db);
  }
}

// --------------------------------------------------------------------------
// tiles
// --------------------------------------------------------------------------

// Tile sizes at DP (D padded to 64 or 128 by TMA's zero fill); the header's
// item (4) gives the arithmetic.
template <int DP>
struct Tf32Tiles;

template <>
struct Tf32Tiles<64> {
  static constexpr int kWgs = 2;           // consumer warpgroups
  static constexpr int kM = 32;            // q rows of a q tile
  static constexpr int kStages = 2;        // ring stages of Q, dO, lse, delta
  static constexpr int kSets = 2;          // sets of derived tiles
  static constexpr bool kSmallInRegs = true;  // K's and V's small parts
};

template <>
struct Tf32Tiles<128> {
  static constexpr int kWgs = 1;
  static constexpr int kM = 16;
  static constexpr int kStages = 1;
  static constexpr int kSets = 1;
  static constexpr bool kSmallInRegs = false;
};

// Shared memory at DP columns: K, V (and their small parts), the ring of
// (Q, dO) stages, the sets of derived tiles (Q small, dO small, Q^T, Q^T
// small, dO^T, dO^T small), the ring's lse and delta rows, the barriers.
// Every tile starts on a 1024-byte boundary.
template <int DP>
struct Tf32Smem {
  using T = Tf32Tiles<DP>;
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kN = kRows * T::kWgs;        // keys of a block
  static constexpr int kKBox = kN * kRowBytes;      // one box of K
  static constexpr int kK = kBoxes * kKBox;         // K, V or a small part
  static constexpr int kQBox = T::kM * kRowBytes;   // one box of Q
  static constexpr int kQ = kBoxes * kQBox;         // a q tile of Q or dO
  static constexpr int kT = DP * kRowBytes;         // a transposed tile
  static constexpr int kStage = 2 * kQ;             // Q, dO
  static constexpr int kSet = 2 * kQ + 4 * kT;
  static constexpr int kRingOff = (T::kSmallInRegs ? 2 : 4) * kK;
  static constexpr int kSetsOff = kRingOff + T::kStages * kStage;
  static constexpr int kRowsOff = kSetsOff + T::kSets * kSet;
  static constexpr int kBars = kRowsOff + T::kStages * 2 * T::kM * 4;
  // kv_full, full, empty; and the alignment slack
  static constexpr int kBytes = kBars + 8 * (1 + 2 * T::kStages) + 1024;
};

// The tiles one q tile's products need beyond the raw Q and dO that TMA
// landed (`raw`: Q, then dO): their small parts in the same layout, for
// S^T's and dP^T's B, and both parts transposed into `set` (D rows of the
// tile's q rows, the q order within each 8 permuted as the A operands of
// dK and dV hold P^T and dS^T), for dK's and dV's B. Spread over the
// block's warps: one warp step moves one 16-byte column chunk of 32 q rows
// (two chunks of 16 rows at D 128), conflict-free both ways.
template <int DP>
__device__ __forceinline__ void derive(unsigned char* set,
                                       const unsigned char* raw) {
  using T = Tf32Tiles<DP>;
  using L = Tf32Smem<DP>;
  constexpr int kPerStep = 32 / T::kM;            // chunks a warp step
  constexpr int kSteps = 2 * (DP / 4) / kPerStep;  // Q's, then dO's
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = lane % T::kM;
  // q's place in its 8: even q at 0..3, odd q at 4..7
  const int k = (q & ~7) | ((q & 7) >> 1) | ((q & 1) << 2);
  for (int step = warp; step < kSteps; step += 4 * T::kWgs) {
    const int op = step / (kSteps / 2);
    const int c = (step % (kSteps / 2)) * kPerStep + lane / T::kM;
    const int off = (c / 8) * L::kQBox + sw128_offset(q, c % 8);
    const float4 x =
        *reinterpret_cast<const float4*>(raw + op * L::kQ + off);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    float lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) lo[e] = tf32_small(xs[e]);
    *reinterpret_cast<float4*>(set + op * L::kQ + off) =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
    unsigned char* tt = set + 2 * L::kQ + op * 2 * L::kT;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c + e;
      const int toff = sw128_offset(d, k >> 2) + (k & 3) * 4;
      *reinterpret_cast<float*>(tt + toff) = xs[e];
      *reinterpret_cast<float*>(tt + L::kT + toff) = lo[e];
    }
  }
}

// --------------------------------------------------------------------------
// backward: dK and dV (K4), float32
// --------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(128 * Tf32Tiles<DP>::kWgs, 1)
    flash_bwd_dkv_tf32_sm90_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const float* __restrict__ kv_valid, float* __restrict__ dk,
        float* __restrict__ dv, int H, int Sq, int Sk, int D, float scale,
        int causal) {
  using T = Tf32Tiles<DP>;
  using L = Tf32Smem<DP>;
  constexpr int kM = T::kM;
  constexpr int kSt = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + L::kK;
  unsigned char* sKs = sV + L::kK;              // small parts (D 128)
  unsigned char* sVs = sKs + L::kK;
  unsigned char* sRing = sK + L::kRingOff;      // [kSt] (Q, dO)
  unsigned char* sSets = sK + L::kSetsOff;      // [kSets]
  float* sRows = reinterpret_cast<float*>(sK + L::kRowsOff);  // [kSt][2][kM]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sK + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kSt;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * L::kN;
  // causal: q tiles whose last row is before this block's first key are
  // dead
  const int qt0 = causal ? k0 / kM : 0;
  const int n = max((Sq + kM - 1) / kM - qt0, 0);   // live q tiles
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // warp 0 produces: lane 0 issues the TMA copies, every lane copies the q
  // tile's lse and delta rows by cp.async
  const bool producer = threadIdx.x < 32;
  const long long row_base = (long long)bh * Sq;

  // Q, dO, lse and delta of the it-th live q tile into its stage, once
  // every warp is done with the q tile kSt before it
  auto produce = [&](int it) {
    const int s = it % kSt;
    const int q0 = (qt0 + it) * kM;
    mbar_wait(empty + s, ((it / kSt) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(full + s, L::kStage);
      unsigned char* st = sRing + s * L::kStage;
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load(st + x * L::kQBox, &tq, full + s, x * kBoxCols, h, q0, b);
        tma_load(st + L::kQ + x * L::kQBox, &tdo, full + s, x * kBoxCols, h,
                 q0, b);
      }
    }
    float* rows = sRows + s * 2 * kM;
    for (int i = lane; i < kM; i += 32) {
      const int row = q0 + i;
      const bool ok = row < Sq;
      cp_async4(rows + i, lse + row_base + (ok ? row : 0), ok);
      cp_async4(rows + kM + i, delta + row_base + (ok ? row : 0), ok);
    }
    cp_async_arrive(full + s);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      // lane 0's bytes, then the 32 lanes' cp.async rows
      mbar_init(full + s, 1 + 32);
      mbar_init(empty + s, 4 * T::kWgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer && n > 0) {
    // K and V once, and the ring's first kSt q tiles
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kK);
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load(sK + x * L::kKBox, &tk, kv_full, x * kBoxCols, h, k0, b);
        tma_load(sV + x * L::kKBox, &tv, kv_full, x * kBoxCols, h, k0, b);
      }
    }
    for (int it = 0; it < min(kSt, n); ++it) produce(it);
  }
  __syncwarp();

  const int g = lane / 4;
  const int t = lane % 4;
  const int kw0 = k0 + kRows * wg;         // this warpgroup's first key
  const int key0 = kw0 + 16 * warp + g;    // this thread's keys key0, +8
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;
  const float kv[2] = {kv_of(kvm, key0, Sk), kv_of(kvm, key0 + 8, Sk)};
  const uint32_t wg_rows = kRows * kRowBytes * wg;   // in each box of K
  const uint32_t k_addr = smem_u32(sK) + wg_rows;
  const uint32_t v_addr = smem_u32(sV) + wg_rows;
  const uint32_t ks_addr = smem_u32(sKs) + wg_rows;
  const uint32_t vs_addr = smem_u32(sVs) + wg_rows;

  // K's and V's small parts: at D 64 the A operands of the small-big terms
  // of S^T and dP^T, at D 128 tiles of their own
  uint32_t k_small[T::kSmallInRegs ? DP / 8 : 1][4];
  uint32_t v_small[T::kSmallInRegs ? DP / 8 : 1][4];
  if (n > 0) {
    mbar_wait(kv_full, 0);
    if constexpr (T::kSmallInRegs) {
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // A fragment: rows g, g + 8 (c & 1), columns t, t + 4 (c >> 1)
          const int r = kRows * wg + 16 * warp + g + 8 * (c & 1);
          const int col = 8 * kk + t + 4 * (c >> 1);
          const int off = (col / 32) * L::kKBox +
                          sw128_offset(r, (col % 32) / 4) + (col % 4) * 4;
          k_small[kk][c] = __float_as_uint(
              tf32_small(*reinterpret_cast<const float*>(sK + off)));
          v_small[kk][c] = __float_as_uint(
              tf32_small(*reinterpret_cast<const float*>(sV + off)));
        }
      }
    } else {
      for (int i = threadIdx.x; i < 2 * L::kK / 16; i += blockDim.x) {
        const int tile = i / (L::kK / 16);   // 0: K, 1: V
        const int off = (i % (L::kK / 16)) * 16;
        const float4 x =
            *reinterpret_cast<const float4*>(sK + tile * L::kK + off);
        *reinterpret_cast<float4*>(sKs + tile * L::kK + off) =
            make_float4(tf32_small(x.x), tf32_small(x.y), tf32_small(x.z),
                        tf32_small(x.w));
      }
    }
    mbar_wait(full, 0);
    derive<DP>(sSets, sRing);
    fence_proxy_async();
  }
  __syncthreads();

  float dk_acc[DP / 8][4] = {};
  float dv_acc[DP / 8][4] = {};
  float st[kM / 8][4];          // S^T, then P^T
  float dpt[kM / 8][4];         // dP^T, then dS^T
  // P^T and dS^T as dV's and dK's A operands, big and small
  uint32_t pa[kM / 8][4], ps[kM / 8][4], da[kM / 8][4], ds[kM / 8][4];

  for (int it = 0; it < n; ++it) {
    const int stage = it % kSt;
    const unsigned char* set = sSets + (it % T::kSets) * L::kSet;
    const uint32_t q_addr = smem_u32(sRing + stage * L::kStage);
    const uint32_t do_addr = q_addr + L::kQ;
    const uint32_t qs_addr = smem_u32(set);
    const uint32_t dos_addr = qs_addr + L::kQ;
    const uint32_t qt_addr = qs_addr + 2 * L::kQ;     // Q^T, then its small
    const uint32_t dot_addr = qt_addr + 2 * L::kT;    // dO^T, then its small

    // S^T = K Q^T and dP^T = V dO^T (64 keys x kM q rows a warpgroup), per
    // 8-deep slice big small, small big, big big
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint32_t ko = (kk / 4) * L::kKBox + (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * L::kQBox + (kk % 4) * 32;
      wgmma_tf32_ss<kM>(st, sw128_desc(k_addr + ko, 16),
                        sw128_desc(qs_addr + qo, 16), kk > 0);
      wgmma_tf32_ss<kM>(dpt, sw128_desc(v_addr + ko, 16),
                        sw128_desc(dos_addr + qo, 16), kk > 0);
      if constexpr (T::kSmallInRegs) {
        wgmma_tf32_rs<kM>(st, k_small[kk], sw128_desc(q_addr + qo, 16));
        wgmma_tf32_rs<kM>(dpt, v_small[kk], sw128_desc(do_addr + qo, 16));
      } else {
        wgmma_tf32_ss<kM>(st, sw128_desc(ks_addr + ko, 16),
                          sw128_desc(q_addr + qo, 16), 1);
        wgmma_tf32_ss<kM>(dpt, sw128_desc(vs_addr + ko, 16),
                          sw128_desc(do_addr + qo, 16), 1);
      }
      wgmma_tf32_ss<kM>(st, sw128_desc(k_addr + ko, 16),
                        sw128_desc(q_addr + qo, 16), 1);
      wgmma_tf32_ss<kM>(dpt, sw128_desc(v_addr + ko, 16),
                        sw128_desc(do_addr + qo, 16), 1);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(st);
    reg_fence(dpt);

    // P^T and dS^T in float32: rows are keys, columns q rows (JAX :294,
    // :305, :308), each element into its A fragment slot (a0: column 2t
    // of row g, a1: of row g + 8, a2, a3: column 2t + 1) big and small. A
    // q row past Sq needs no test: TMA filled its Q and dO with zeros and
    // its lse and delta are 0, so its P is at most 1 and adds nothing to
    // dV, and its dS is 0.
    const float* c_lse = sRows + stage * 2 * kM;
    const float* c_delta = c_lse + kM;
    const int q0 = (qt0 + it) * kM;
    auto emit = [&](int j, int c, float p) {
      const int col = 8 * j + 2 * t + (c & 1);
      const float dsv = p * (dpt[j][c] - c_delta[col]) * scale;
      const int slot = ((c & 1) << 1) | (c >> 1);
      pa[j][slot] = __float_as_uint(p);
      ps[j][slot] = __float_as_uint(tf32_small(p));
      da[j][slot] = __float_as_uint(dsv);
      ds[j][slot] = __float_as_uint(tf32_small(dsv));
    };
    if (needs_mask(q0, kM, kw0, kRows, Sq, Sk, causal, kvm != nullptr)) {
#pragma unroll
      for (int j = 0; j < kM / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          const float x = masked(scale * st[j][c], q0 + col,
                                 key0 + 8 * (c >> 1), Sk, causal,
                                 kv[c >> 1]);
          emit(j, c, expf(x - c_lse[col]));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kM / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          emit(j, c, expf(scale * st[j][c] - c_lse[col]));
        }
      }
    }
    // the stage's Q, dO, lse and delta are done with (its transposes and
    // small parts live in the set): it takes the q tile kSt on
    release(empty + stage);
    if (producer && it + kSt < n) produce(it + kSt);
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q, depth = the tile's kM q rows (8-row
    // slices 32 bytes apart in the transposed tiles' rows)
    wg_fence();
#pragma unroll
    for (int j = 0; j < kM / 8; ++j) {
      const uint32_t to = j * 32;
      wgmma_tf32_rs<DP>(dv_acc, pa[j], sw128_desc(dot_addr + L::kT + to, 16));
      wgmma_tf32_rs<DP>(dv_acc, ps[j], sw128_desc(dot_addr + to, 16));
      wgmma_tf32_rs<DP>(dv_acc, pa[j], sw128_desc(dot_addr + to, 16));
      wgmma_tf32_rs<DP>(dk_acc, da[j], sw128_desc(qt_addr + L::kT + to, 16));
      wgmma_tf32_rs<DP>(dk_acc, ds[j], sw128_desc(qt_addr + to, 16));
      wgmma_tf32_rs<DP>(dk_acc, da[j], sw128_desc(qt_addr + to, 16));
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    reg_fence(pa);
    reg_fence(ps);
    reg_fence(da);
    reg_fence(ds);

    // the next q tile's derived tiles, into the set no warpgroup reads now
    if (it + 1 < n) {
      const int next = it + 1;
      mbar_wait(full + next % kSt, (next / kSt) & 1);
      derive<DP>(sSets + (next % T::kSets) * L::kSet,
                 sRing + (next % kSt) * L::kStage);
      fence_proxy_async();
    }
    __syncthreads();
  }

  // rows below Sk of dK and dV, contiguous (B, Sk, H, D), float32; D is a
  // multiple of 4, so column pairs store whole
  const long long row_stride = (long long)H * D;
  const long long base = (long long)b * Sk * row_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Sk) continue;
#pragma unroll
    for (int nn = 0; nn < DP / 8; ++nn) {
      const int col = 8 * nn + 2 * t;
      if (col < D) {
        const long long at = base + key * row_stride + col;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(dk_acc[nn][2 * i], dk_acc[nn][2 * i + 1]);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(dv_acc[nn][2 * i], dv_acc[nn][2 * i + 1]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// launcher
// --------------------------------------------------------------------------

template <int DP>
int dkv_tf32(const Problem& p, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             const float* kv_valid, void* dk, void* dv) {
  using T = Tf32Tiles<DP>;
  using L = Tf32Smem<DP>;
  CUtensorMap tq, tk, tv, tdo;
  if (int err = make_map(&tq, q, p.B, p.Sq, p.H, p.D, p.qs, T::kM, kF32)) {
    return err;
  }
  if (int err = make_map(&tk, k, p.B, p.Sk, p.H, p.D, p.ks, L::kN, kF32)) {
    return err;
  }
  if (int err = make_map(&tv, v, p.B, p.Sk, p.H, p.D, p.vs, L::kN, kF32)) {
    return err;
  }
  if (int err = make_map(&tdo, dout, p.B, p.Sq, p.H, p.D, dout_strides(p),
                         T::kM, kF32)) {
    return err;
  }
  auto kernel = flash_bwd_dkv_tf32_sm90_kernel<DP>;
  static bool smem_set[kMaxDevices] = {};
  if (int err = allow_smem(kernel, L::kBytes, smem_set)) return err;
  const dim3 grid(static_cast<unsigned>(p.B * p.H),
                  static_cast<unsigned>((p.Sk + L::kN - 1) / L::kN));
  kernel<<<grid, 128 * T::kWgs, L::kBytes, p.stream>>>(
      tq, tk, tv, tdo, lse, delta, kv_valid, static_cast<float*>(dk),
      static_cast<float*>(dv), p.H, p.Sq, p.Sk, p.D, p.scale, p.causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// flash_attention.cu's dK/dV entry point for float32 inputs (bf16 must be
// 0): enqueues one kernel on `stream` and returns cudaGetLastError() as an
// int, 0 when the launch was accepted; cudaErrorMisalignedAddress when an
// input is not readable by TMA in place (the caller stages a copy).
int dpt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* kv_valid, void* dk, void* dv, int B,
                      int H, int Sq, int Sk, int D, long long qsb,
                      long long qss, long long qsh, long long ksb,
                      long long kss, long long ksh, long long vsb,
                      long long vss, long long vsh, float scale, int causal,
                      int bf16, void* stream) {
  if (bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = check_shape(B, H, Sq, Sk, D)) return err;
  const Problem p = make_problem(B, H, Sq, Sk, D, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, scale, causal, stream);
  if (!inputs_readable(p, q, k, v, dout, kF32)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return D <= 64 ? dkv_tf32<64>(p, q, k, v, dout, lse, delta, kv_valid, dk,
                                dv)
                 : dkv_tf32<128>(p, q, k, v, dout, lse, delta, kv_valid, dk,
                                 dv);
}

const char* dpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
