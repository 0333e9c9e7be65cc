// FlashAttention forward (K3), dK/dV (K4) and dQ (K5) for float32 inputs,
// written for Hopper (sm_90a): every product is 3xTF32 on wgmma .tf32, fed
// by TMA.
//
// Replaces the Pallas TPU kernels of
//   distributed_pytorch_training_tpu/ops/flash_attention.py
// for float32 inputs:
//   flash_fwd_tf32_sm90_kernel     <- _flash_fwd_lse (:199), body
//                                     _fwd_kernel (:146), pallas_call :232
//   flash_bwd_dkv_tf32_sm90_kernel <- _flash_bwd (:360), body
//                                     _bwd_dkv_kernel (:269), pallas_call :400
//   flash_bwd_dq_tf32_sm90_kernel  <- _flash_bwd (:360), body
//                                     _bwd_dq_kernel (:317), pallas_call :440
// bfloat16 K3-K5 are flash_attention_sm90.cu's. The C entry points
// dpt_flash_fwd, dpt_flash_bwd_dkv and dpt_flash_bwd_dq have
// flash_attention_sm90.cu's signatures and take float32 (bf16 = 0) only.
// flash_sm90.cuh holds what the Hopper kernels share and, in its header,
// the semantics every flash kernel keeps (NEG_INF masks, -inf past Sk,
// causal top-left, kv_valid, the scales, the backward's re-mask, no
// atomics). A tile pair that no mask bites takes no mask test, and the
// masks are selects; exponentials are expf and the log logf, in float32.
//
// 3xTF32: a float32 operand x is split as x = big + small; a product is
// big big + big small + small big, in that order per 8-deep slice, summed
// in float32 on the tensor cores (small small, 2^-22 of it, dropped). The
// tensor core reads a 32-bit register or word as tf32 and ignores its low
// 13 bits, so `big` is x itself as the TMA landed it (truncation, not
// cvt.rna's rounding) and small = x - big(x), exact in float32, in a tile
// or registers of its own. Emulated on the CPU
// (tests/test_torch_tf32_split.py) against the float32 plain versions, in
// these kernels' orders of summation, the truncated split lands within
// FLASH_REL / 10 = 1e-5 of max |plain| on every case: dK/dV within 2.1e-6,
// dQ 2.3e-6, the forward's out 1.1e-6 and lse 1.9e-7 (O carried on the
// tensor cores' accumulator from tile to tile).
//
// Bound on the card (NVIDIA H100 SXM, 495 TFLOP/s dense TF32, NVIDIA's
// data sheet): at GPT-2 124M's shape (B 8, S 1024, H 12, D 64, causal) the
// forward does 12.9 GFLOP, dK/dV 25.8 and dQ 19.4 (4, 8 and 6 x D a live
// (q, k) pair, the JAX module's cost counts), each as three TF32 products:
// 0.078, 0.156 and 0.117 ms at 165 TFLOP/s, against 0.03-0.05 ms of bytes.
// Bound by operations.
//
// What float32 changes, and what the kernels do about it:
// (1) wgmma .tf32 has no transpose bit: both shared-memory operands must be
//     K-major (the depth contiguous). A product over D (S = Q K^T, dP =
//     dO V^T, K4's S^T and dP^T) reads its tiles as TMA lands them (D
//     contiguous). A product over a tile's rows (K3's O += P V and K5's dQ
//     += dS K over keys, K4's dV += P^T dO and dK += dS^T Q over q rows)
//     needs that tile transposed: the block's threads write it (D rows of
//     the tile's rows, SWIZZLE_128B, 32 rows to a 128-byte row) with its
//     small part, once a tile for every warpgroup, with 16-byte loads and
//     4-byte stores that hit 32 banks a warp.
// (2) The split: an operand in registers splits in the registers. A
//     shared-memory operand needs its small part as a tile of its own,
//     written by the same pass as the transposes; its big part is the raw
//     tile.
// (3) A tf32 A fragment holds columns t and t + 4 of its 8, an accumulator
//     2t and 2t + 1. P, P^T, dS and dS^T go from the accumulators into the
//     next product's A operand with no data movement: the order of the
//     rows within each 8 of the transposed tiles is permuted to match (k =
//     t holds row 2t, k = t + 4 holds row 2t + 1), which the transpose pass
//     writes at no cost. A product's sum does not depend on the order of
//     its depth.
// (4) Shared memory (227 KB) and registers bound the tiles; per kernel
//     below (bytes; a transposed tile is D rows of 128 bytes for each 32
//     of the tile's rows).
//     A producer warp of its own would cap ptxas at 168 registers a thread,
//     so thread 0 issues the copies in band.
//
// Forward (K3): one block per (batch * head, q tile), heaviest causal tiles
// first; Q is loaded once by TMA and K and V ride a ring of k tiles (a
// causal block stops at the last k tile that reaches its last row). Per k
// tile the block's threads derive K's small part (row-major, for S) and
// V^T with its small part (for P V). A warpgroup owns 64 q rows and
// computes S = (scale Q) K^T as m64nNk8 (N: the tile's keys) with scale Q
// formed in float32 before the split, as the JAX kernel scales q before
// the dot (:167); the online softmax in float32 registers (JAX :183-:190:
// the mask, m from NEG_INF, alpha = expf(m_old - m_new), p = expf(s - m),
// l = alpha l + rowsum p); O = alpha O; and O += P V as m64nDk8 with P as
// the register A operand. O accumulates in float32 on the tensor cores, as
// dK/dV do; the CPU emulation holds it to the float32 plain forward
// (tests/test_torch_tf32_split.py). Then out = O / l, l floored at 1e-30,
// lse = m + log l (JAX :194-:196).
//   D 64: two warpgroups (128 q rows), k tiles of 64 keys, a ring of 2
//     stages and 2 sets of derived tiles (one written while the other is
//     read): Q 32 KB + 2 x (K, V) 64 KB + 2 x (K small, V^T, V^T small)
//     96 KB = 192 KB. scale Q's big and small parts are the register A
//     operands of S (32 + 32 a thread); S (then P) 32, P small 32, O 32;
//     ptxas (CUDA 12.8) 206 registers, no spill.
//   D 128: one warpgroup (64 q rows), k tiles of 32 keys: the threads
//     scale Q in place and write its small part, S's A operands from
//     shared memory: Q and Q small 64 KB + 2 x 32 KB + 2 x 48 KB = 224 KB.
//     Registers: S 16, P small 16, O 64 (138 used).
//   Order per k tile: S waited, the ring stage released (refilled by TMA
//   kStages tiles on), the softmax, O rescaled, P V issued; the next k
//   tile's derived tiles written into the other set while P V runs; P V
//   waited. No block-wide barrier: each set has a pair of mbarriers (full:
//   every warp wrote its share and fenced; empty: every warp's S and P V
//   of it are done), so the two warpgroups drift apart and one's softmax
//   runs under the other's products (4% faster on the card than one
//   __syncthreads a tile, PERF.md §6).
//
// dQ (K5): one block per (batch * head, q tile), heaviest causal tiles
// first; Q and dO are loaded once by TMA and stay, each thread keeps its
// two rows' lse and delta in registers; K and V ride a ring of k tiles.
// Per k tile the threads derive K's and V's small parts (row-major, for S
// and dP) and K^T with its small part (for dQ). A warpgroup owns 64 q rows
// and computes S = Q K^T and dP = dO V^T as m64nNk8 (Q's and dO's big parts
// the raw tiles in shared memory; their small parts registers at D 64,
// tiles at D 128), dS = exp(S scale - lse) (dP - delta) scale in float32
// registers (JAX :341-:352), and dQ += dS K as m64nDk8 with dS as the
// register A operand and K^T, K^T small as B. A q row past Sq needs no
// test: TMA filled its Q and dO with zeros and its lse and delta are 0, so
// its dS is 0.
//   D 64: two warpgroups (128 q rows), k tiles of 64 keys, a ring of 2
//     stages, one set of derived tiles: Q, dO 64 KB + 2 x (K, V) 64 KB + (K
//     small, V small, K^T, K^T small) 64 KB = 192 KB. Registers: Q and dO
//     small 32 + 32, S 32, dP (then dS) 32, dS small 32, dQ 32; ptxas 233,
//     no spill.
//   D 128: one warpgroup, k tiles of 32 keys, one stage: Q, dO and their
//     small parts 128 KB + 32 KB + 64 KB = 224 KB. Registers: S, dP, dS
//     small 16 each, dQ 64 (167 used).
//   Order per k tile: S and dP waited, the ring stage released, dS, dQ
//   issued and waited; a __syncthreads (the set is free), the next tile's
//   derived tiles, a __syncthreads, the next S and dP issued.
//
// dK/dV (K4): one block per (batch * head, key tile), heaviest causal tiles
// first (the first key tiles see the most q tiles); K and V are loaded once
// by TMA and stay; Q, dO and the q tile's lse and delta rows ride a ring
// (lse and delta by cp.async, counted on the stage's mbarrier); causal
// blocks start at the first q tile that reaches the block's first key.
// Each consumer warpgroup owns 64 keys. Per q tile a warpgroup computes S^T
// = K Q^T and dP^T = V dO^T as m64nMk8 (M: the q tile's rows), P^T =
// exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale in float32
// registers, and accumulates dV += P^T dO and dK += dS^T Q as m64nDk8 with
// P^T and dS^T as the register A operand; the block's threads write dO^T
// and Q^T (and Q's and dO's small parts) once a q tile. K's and V's small
// parts are made once a block: at D 64 as registers (the A operand of the
// small-big term, 32 + 32 a thread), at D 128 as shared-memory tiles.
//   D 64: two warpgroups (128 keys), q tiles of 32 rows (m64n32k8 for
//     S^T), a ring of 2 stages, two sets of derived tiles (one is written
//     while the other is read): K, V 64 KB + 2 x (Q + dO) 32 KB + 2 x (Q,
//     dO small 16 KB + 4 transposed 32 KB) 96 KB + lse, delta 0.5 KB =
//     192.5 KB. Registers a thread: K, V small 64, S^T, dP^T 16 each, dK,
//     dV 32 each, P^T and dS^T as big and small A operands 64.
//   D 128: K, V and their small parts alone are 128 KB at 64 keys, and as
//     registers would be 128 a thread: one warpgroup (64 keys), K and V
//     small in shared memory, q tiles of 16 rows (m64n16k8; the transposed
//     tiles keep 128-byte rows, half used), one stage, one set: K, V, K
//     small, V small 128 KB + Q + dO 16 KB + (16 KB small + 4 x 16 KB
//     transposed) 80 KB = 224 KB. Registers: S^T, dP^T 8 each, dK, dV 64
//     each, A operands 32.
//   One block an SM at both widths; ptxas (CUDA 12.8) gives 221 registers a
//   thread at D 64 and 187 at D 128, no spill. Order per q tile: S^T and
//   dP^T (waited), the softmax terms, the stage released and refilled by
//   TMA, dV and dK (waited), the next q tile's transposes, one
//   __syncthreads. Two other layouts measured no faster on the card
//   (PERF.md §6): one warpgroup a block with two blocks an SM, and dV and
//   dK left running under the next tile's transposes and S^T (ptxas then
//   serialized the wgmmas, C7515).
//
// Inputs must be 16-byte aligned with 16-byte strides and D a multiple of 4
// (TMA's rules for float32): ops/flash_attention.py stages a copy of any
// tensor that is not (never on the main paths). A box is 32 columns (128
// bytes); columns past D and rows past S arrive as zeros, which is exact:
// D 32 reads its second box as zeros at D 64's tiles, D 96 takes D 128's.

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

// d (64 x 64) = a b + (scale_d ? d : 0) in tf32: a (64 x 8) and b (8 x
// 64), both K-major in shared memory (descriptors da and db)
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[8][4],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// d (64 x 32) = a b + (scale_d ? d : 0) in tf32: a (64 x 8) in registers
// (each warp's 16 rows in the m16n8k8 A layout), b (8 x 32) K-major in
// shared memory (db)
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[4][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

// d (64 x 64) = a b + (scale_d ? d : 0) in tf32: a (64 x 8) in registers
// (each warp's 16 rows in the m16n8k8 A layout), b (8 x 64) K-major in
// shared memory (db)
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[8][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

// d (64 x 128) = a b + (scale_d ? d : 0) in tf32: a (64 x 8) in registers
// (each warp's 16 rows in the m16n8k8 A layout), b (8 x 128) K-major in
// shared memory (db)
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[16][4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 8][4],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  if constexpr (N == 16) {
    wgmma_tf32_ss_n16(d, da, db, scale_d);
  } else if constexpr (N == 32) {
    wgmma_tf32_ss_n32(d, da, db, scale_d);
  } else {
    wgmma_tf32_ss_n64(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d = 1) {
  if constexpr (N == 32) {
    wgmma_tf32_rs_n32(d, a, db, scale_d);
  } else if constexpr (N == 64) {
    wgmma_tf32_rs_n64(d, a, db, scale_d);
  } else {
    wgmma_tf32_rs_n128(d, a, db, scale_d);
  }
}

// The A fragment slot of accumulator element c (rows g, g + 8 by c >> 1;
// columns 2t, 2t + 1 by c & 1) once the columns' order is permuted as the
// transposed tiles hold it: column 2t is depth t, column 2t + 1 depth t + 4
__device__ __forceinline__ int acc_slot(int c) {
  return ((c & 1) << 1) | (c >> 1);
}

// --------------------------------------------------------------------------
// dK/dV (K4): tiles
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
      const int slot = acc_slot(c);
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
// forward (K3) and dQ (K5): a resident q tile, k tiles through a ring
// --------------------------------------------------------------------------

// Tile sizes of the forward and dQ at DP (the header's arithmetic)
template <int DP>
struct KvTiles;

template <>
struct KvTiles<64> {
  static constexpr int kWgs = 2;            // consumer warpgroups
  static constexpr int kN = 64;             // keys of a k tile
  static constexpr bool kQInRegs = true;    // the q tile's split in registers
};

template <>
struct KvTiles<128> {
  static constexpr int kWgs = 1;
  static constexpr int kN = 32;
  static constexpr bool kQInRegs = false;
};

// Shared memory of the forward (kDq false) or dQ (kDq true) at DP columns:
// the q tile (Q; dQ: Q, then dO) as TMA landed it, its small parts when
// they are not registers, the ring of (K, V) k tiles, the sets of derived
// tiles (forward: K small, V^T, V^T small; dQ: K small, V small, K^T, K^T
// small), the barriers. Every tile starts on a 1024-byte boundary.
template <int DP, bool kDq>
struct KvSmem {
  using T = KvTiles<DP>;
  static constexpr int kM = kRows * T::kWgs;        // q rows of a block
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kQBox = kM * kRowBytes;      // one box of Q
  static constexpr int kQ = kBoxes * kQBox;         // Q or dO
  static constexpr int kKBox = T::kN * kRowBytes;   // one box of K
  // K or V of a k tile, or one derived tile (kN x DP floats either way)
  static constexpr int kK = kBoxes * kKBox;
  static constexpr int kTSub = DP * kRowBytes;      // 32 keys transposed
  static constexpr int kOps = kDq ? 2 : 1;          // Q (and dO)
  static constexpr int kStages = kDq && DP == 128 ? 1 : 2;
  static constexpr int kSets = kDq ? 1 : 2;
  static constexpr int kSet = (kDq ? 4 : 3) * kK;
  static constexpr int kQsOff = kOps * kQ;
  static constexpr int kRingOff = kQsOff + (T::kQInRegs ? 0 : kOps * kQ);
  static constexpr int kSetsOff = kRingOff + kStages * 2 * kK;
  static constexpr int kBars = kSetsOff + kSets * kSet;
  // q_full, full, empty, (forward) set_full, set_empty; and the alignment
  // slack
  static constexpr int kBytes =
      kBars + 8 * (1 + 2 * kStages + (kDq ? 0 : 2 * kSets)) + 1024;
  static_assert(kBytes <= 232448, "227 KB of shared memory a block");
};

// One k tile's derived tiles from its raw tile (`raw`: kN keys x DP
// columns as TMA landed it), spread over the block's warps: one warp step
// moves one 16-byte column chunk of 32 keys (lane = key), conflict-free
// both ways. kSmall: x - big(x) into `small`, raw's layout (the B operand
// of S's or dP's big-small term). kTrans: x and its small part transposed
// into `trans` and `trans` + the tile's bytes (DP rows of 32 keys a
// sub-tile, kTSub bytes apart), the key order within each 8 permuted as
// the A operand of O += P V or dQ += dS K holds P or dS (header item 3).
template <int DP, int kN, bool kSmall, bool kTrans>
__device__ __forceinline__ void derive_kv(unsigned char* small,
                                          unsigned char* trans,
                                          const unsigned char* raw) {
  constexpr int kChunks = DP / 4;                 // 16-byte chunks a row
  constexpr int kSteps = (kN / 32) * kChunks;
  constexpr int kKBox = kN * kRowBytes;
  constexpr int kTile = kN * DP * kF32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the lane's key in its 8: even keys at 0..3, odd at 4..7
  const int pos = (lane & ~7) | ((lane & 7) >> 1) | ((lane & 1) << 2);
  for (int step = warp; step < kSteps; step += blockDim.x / 32) {
    const int sub = step / kChunks;
    const int c = step % kChunks;
    const int off = (c / 8) * kKBox + sw128_offset(32 * sub + lane, c % 8);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    float lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) lo[e] = tf32_small(xs[e]);
    if constexpr (kSmall) {
      *reinterpret_cast<float4*>(small + off) =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
    if constexpr (kTrans) {
      unsigned char* tt = trans + sub * DP * kRowBytes;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int toff = sw128_offset(4 * c + e, pos >> 2) + (pos & 3) * 4;
        *reinterpret_cast<float*>(tt + toff) = xs[e];
        *reinterpret_cast<float*>(tt + kTile + toff) = lo[e];
      }
    }
  }
}

// Element (row r, column col) of a q tile of kQBox-byte boxes, as a byte
// offset (the register A fragments of S's and dP's operands)
template <int kQBox>
__device__ __forceinline__ int q_offset(int r, int col) {
  return (col / kBoxCols) * kQBox + sw128_offset(r, (col % kBoxCols) / 4) +
         (col % 4) * 4;
}

template <int DP>
__global__ void __launch_bounds__(128 * KvTiles<DP>::kWgs, 1)
    flash_fwd_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const float* __restrict__ kv_valid,
                               float* __restrict__ out,
                               float* __restrict__ lse, int H, int Sq,
                               int Sk, int D, float scale, int causal) {
  using T = KvTiles<DP>;
  using L = KvSmem<DP, false>;
  constexpr int kN = T::kN;
  constexpr int kSt = L::kStages;
  constexpr int kSets = L::kSets;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sQs = sQ + L::kQsOff;          // D 128: scale Q's small
  unsigned char* sRing = sQ + L::kRingOff;      // [kSt] (K, V)
  unsigned char* sSets = sQ + L::kSetsOff;      // [kSets]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sQ + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kSt;
  // a set's derived tiles written by every warp / read by every warp
  uint64_t* set_full = empty + kSt;          // [kSets]
  uint64_t* set_empty = set_full + kSets;    // [kSets]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kM;
  int n = (Sk + kN - 1) / kN;
  if (causal) n = min(n, (q0 + L::kM - 1) / kN + 1);
  const bool producer = threadIdx.x == 0;

  // K and V of k tile kt into its stage, once every warp is done with the
  // tile kSt before it (a fresh stage passes at once)
  auto produce = [&](int kt) {
    const int s = kt % kSt;
    mbar_wait(empty + s, ((kt / kSt) & 1) ^ 1);
    mbar_expect_tx(full + s, 2 * L::kK);
    unsigned char* st = sRing + s * 2 * L::kK;
    for (int x = 0; x < L::kBoxes; ++x) {
      tma_load(st + x * L::kKBox, &tk, full + s, x * kBoxCols, h, kt * kN,
               b);
      tma_load(st + L::kK + x * L::kKBox, &tv, full + s, x * kBoxCols, h,
               kt * kN, b);
    }
  };
  // K small, V^T and V^T small of k tile kt into its set (this warp's
  // share)
  auto derive = [&](int kt) {
    unsigned char* set = sSets + (kt % kSets) * L::kSet;
    const unsigned char* raw = sRing + (kt % kSt) * 2 * L::kK;
    derive_kv<DP, kN, true, false>(set, nullptr, raw);
    derive_kv<DP, kN, false, true>(nullptr, set + L::kK, raw + L::kK);
  };

  if (producer) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * T::kWgs);
    }
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
      mbar_init(set_full + s, 4 * T::kWgs);
      mbar_init(set_empty + s, 4 * T::kWgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    // Q once, and the ring's first kSt k tiles
    mbar_expect_tx(q_full, L::kQ);
    for (int x = 0; x < L::kBoxes; ++x) {
      tma_load(sQ + x * L::kQBox, &tq, q_full, x * kBoxCols, h, q0, b);
    }
    for (int kt = 0; kt < min(kSt, n); ++kt) produce(kt);
  }
  __syncwarp();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int qw0 = q0 + kRows * wg;        // this warpgroup's first row
  const int r0 = qw0 + 16 * warp + g;     // this thread's rows r0, r0 + 8
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;
  const bool has_kvm = kvm != nullptr;
  const uint32_t q_addr = smem_u32(sQ) + kRows * kRowBytes * wg;
  const uint32_t qs_addr = smem_u32(sQs) + kRows * kRowBytes * wg;

  // scale Q in float32 (JAX :167), split: at D 64 the register A operands
  // of S, at D 128 written back in place with its small part beside it
  uint32_t qa[T::kQInRegs ? DP / 8 : 1][4];
  uint32_t qsm[T::kQInRegs ? DP / 8 : 1][4];
  mbar_wait(q_full, 0);
  if constexpr (T::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // A fragment: rows g, g + 8 (c & 1), columns t, t + 4 (c >> 1)
        const int r = kRows * wg + 16 * warp + g + 8 * (c & 1);
        const int col = 8 * kk + t + 4 * (c >> 1);
        const float x =
            scale * *reinterpret_cast<const float*>(
                        sQ + q_offset<L::kQBox>(r, col));
        qa[kk][c] = __float_as_uint(x);
        qsm[kk][c] = __float_as_uint(tf32_small(x));
      }
    }
  } else {
    for (int i = threadIdx.x; i < L::kQ / 16; i += blockDim.x) {
      float4 x = reinterpret_cast<float4*>(sQ)[i];
      x = make_float4(scale * x.x, scale * x.y, scale * x.z, scale * x.w);
      reinterpret_cast<float4*>(sQ)[i] = x;
      reinterpret_cast<float4*>(sQs)[i] =
          make_float4(tf32_small(x.x), tf32_small(x.y), tf32_small(x.z),
                      tf32_small(x.w));
    }
  }
  mbar_wait(full, 0);
  derive(0);
  fence_proxy_async();
  release(set_full);
  __syncthreads();

  // rows r0 and r0 + 8: running max (from NEG_INF, as the JAX kernel's m),
  // sum and the output accumulator
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float o[DP / 8][4] = {};
  float s[kN / 8][4];                     // S, then P
  uint32_t ps[kN / 8][4];                 // P's small part

  // S = (scale Q) K^T of k tile kt (64 q rows x kN keys a warpgroup), per
  // 8-deep slice big small, small big, big big
  auto issue_s = [&](int kt) {
    const uint32_t k_addr = smem_u32(sRing + (kt % kSt) * 2 * L::kK);
    const uint32_t ks_addr = smem_u32(sSets + (kt % kSets) * L::kSet);
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint32_t ko = (kk / 4) * L::kKBox + (kk % 4) * 32;
      if constexpr (T::kQInRegs) {
        wgmma_tf32_rs<kN>(s, qa[kk], sw128_desc(ks_addr + ko, 16), kk > 0);
        wgmma_tf32_rs<kN>(s, qsm[kk], sw128_desc(k_addr + ko, 16));
        wgmma_tf32_rs<kN>(s, qa[kk], sw128_desc(k_addr + ko, 16));
      } else {
        const uint32_t qo = (kk / 4) * L::kQBox + (kk % 4) * 32;
        wgmma_tf32_ss<kN>(s, sw128_desc(q_addr + qo, 16),
                          sw128_desc(ks_addr + ko, 16), kk > 0);
        wgmma_tf32_ss<kN>(s, sw128_desc(qs_addr + qo, 16),
                          sw128_desc(k_addr + ko, 16), 1);
        wgmma_tf32_ss<kN>(s, sw128_desc(q_addr + qo, 16),
                          sw128_desc(k_addr + ko, 16), 1);
      }
    }
  };
  // O += P V of k tile kt, depth = its kN keys (8-key slices 32 bytes apart
  // in V^T's rows, 32-key sub-tiles kTSub apart); P's big part is S's
  // registers as they are
  auto issue_pv = [&](int kt) {
    const uint32_t vt_addr =
        smem_u32(sSets + (kt % kSets) * L::kSet + L::kK);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const uint32_t to = (j / 4) * L::kTSub + (j % 4) * 32;
      const uint32_t pa[4] = {__float_as_uint(s[j][0]),
                              __float_as_uint(s[j][2]),
                              __float_as_uint(s[j][1]),
                              __float_as_uint(s[j][3])};
      wgmma_tf32_rs<DP>(o, pa, sw128_desc(vt_addr + L::kK + to, 16));
      wgmma_tf32_rs<DP>(o, ps[j], sw128_desc(vt_addr + to, 16));
      wgmma_tf32_rs<DP>(o, pa, sw128_desc(vt_addr + to, 16));
    }
  };

  // No block-wide barrier in the loop: a warpgroup waits for the warps'
  // mbarriers of the sets it reads and writes, so the two warpgroups drift
  // apart and one's softmax and derived tiles run under the other's
  // products.
  for (int kt = 0; kt < n; ++kt) {
    mbar_wait(set_full + kt % kSets, (kt / kSets) & 1);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
    }
    wg_fence();
    issue_s(kt);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    // K and V of this tile are done with (S read K, the derived tiles were
    // written from both): the stage takes k tile kt + kSt
    release(empty + kt % kSt);

    // online softmax (JAX :183-:190): element (j, c) is row r0 + 8 (c >> 1),
    // key k0 + 8 j + 2 t + (c & 1)
    const int k0 = kt * kN;
    if (needs_mask(qw0, kRows, k0, kN, Sq, Sk, causal, has_kvm)) {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int col = k0 + 8 * j + 2 * t;
        const float kv[2] = {kv_of(kvm, col, Sk), kv_of(kvm, col + 1, Sk)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = masked(s[j][c], r0 + 8 * (c >> 1), col + (c & 1), Sk,
                           causal, kv[c & 1]);
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
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
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = expf(s[j][c] - m[c >> 1]);
        sum[c >> 1] += s[j][c];
        ps[j][acc_slot(c)] = __float_as_uint(tf32_small(s[j][c]));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);

    // O = alpha O + P V (JAX :189)
#pragma unroll
    for (int nn = 0; nn < DP / 8; ++nn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nn][c] *= alpha[c >> 1];
    }
    wg_fence();
    issue_pv(kt);
    wg_commit();

    // the next k tile's derived tiles while P V runs, into the set that k
    // tile kt - 1 used, once every warp is done with it
    if (kt + 1 < n) {
      const int next = kt + 1;
      mbar_wait(set_empty + next % kSets, ((next / kSets) & 1) ^ 1);
      mbar_wait(full + next % kSt, (next / kSt) & 1);
      derive(next);
      fence_proxy_async();
      release(set_full + next % kSets);
    }
    wg_wait<0>();
    reg_fence(o);
    reg_fence(s);
    reg_fence(ps);
    release(set_empty + kt % kSets);
    if (producer && kt + kSt < n) produce(kt + kSt);
    __syncwarp();
  }

  // out = O / l and lse = m + log l, l floored at 1e-30 (JAX :194-:196);
  // rows below Sq, columns below D (a multiple of 4: column pairs store
  // whole)
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaxf(l[i], 1e-30f);
  const long long row_stride = (long long)H * D;
  float* ob = out + (long long)b * Sq * row_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int nn = 0; nn < DP / 8; ++nn) {
      const int col = 8 * nn + 2 * t;
      if (col < D) {
        *reinterpret_cast<float2*>(ob + row * row_stride + col) =
            make_float2(o[nn][2 * i] / l[i], o[nn][2 * i + 1] / l[i]);
      }
    }
    if (t == 0) lse[(long long)bh * Sq + row] = m[i] + logf(l[i]);
  }
}

template <int DP>
__global__ void __launch_bounds__(128 * KvTiles<DP>::kWgs, 1)
    flash_bwd_dq_tf32_sm90_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const float* __restrict__ kv_valid, float* __restrict__ dq, int H,
        int Sq, int Sk, int D, float scale, int causal) {
  using T = KvTiles<DP>;
  using L = KvSmem<DP, true>;
  constexpr int kN = T::kN;
  constexpr int kSt = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sdO = sQ + L::kQ;
  unsigned char* sQs = sQ + L::kQsOff;          // D 128: Q small, dO small
  unsigned char* sRing = sQ + L::kRingOff;      // [kSt] (K, V)
  // K small, V small, K^T, K^T small
  unsigned char* sSet = sQ + L::kSetsOff;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sQ + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kSt;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kM;
  int n = (Sk + kN - 1) / kN;
  if (causal) n = min(n, (q0 + L::kM - 1) / kN + 1);
  const bool producer = threadIdx.x == 0;

  // K and V of k tile kt into its stage, once every warp is done with the
  // tile kSt before it (a fresh stage passes at once)
  auto produce = [&](int kt) {
    const int s = kt % kSt;
    mbar_wait(empty + s, ((kt / kSt) & 1) ^ 1);
    mbar_expect_tx(full + s, 2 * L::kK);
    unsigned char* st = sRing + s * 2 * L::kK;
    for (int x = 0; x < L::kBoxes; ++x) {
      tma_load(st + x * L::kKBox, &tk, full + s, x * kBoxCols, h, kt * kN,
               b);
      tma_load(st + L::kK + x * L::kKBox, &tv, full + s, x * kBoxCols, h,
               kt * kN, b);
    }
  };
  // K small, V small, K^T and K^T small of k tile kt
  auto derive = [&](int kt) {
    const unsigned char* raw = sRing + (kt % kSt) * 2 * L::kK;
    derive_kv<DP, kN, true, true>(sSet, sSet + 2 * L::kK, raw);
    derive_kv<DP, kN, true, false>(sSet + L::kK, nullptr, raw + L::kK);
  };

  if (producer) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * T::kWgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    // Q and dO once, and the ring's first kSt k tiles
    mbar_expect_tx(q_full, 2 * L::kQ);
    for (int x = 0; x < L::kBoxes; ++x) {
      tma_load(sQ + x * L::kQBox, &tq, q_full, x * kBoxCols, h, q0, b);
      tma_load(sdO + x * L::kQBox, &tdo, q_full, x * kBoxCols, h, q0, b);
    }
    for (int kt = 0; kt < min(kSt, n); ++kt) produce(kt);
  }
  __syncwarp();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int qw0 = q0 + kRows * wg;        // this warpgroup's first row
  const int r0 = qw0 + 16 * warp + g;     // this thread's rows r0, r0 + 8
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;
  const bool has_kvm = kvm != nullptr;
  const uint32_t wg_rows = kRows * kRowBytes * wg;   // in each box of Q
  const uint32_t q_addr = smem_u32(sQ) + wg_rows;
  const uint32_t do_addr = smem_u32(sdO) + wg_rows;
  const uint32_t qs_addr = smem_u32(sQs) + wg_rows;
  const uint32_t dos_addr = qs_addr + L::kQ;
  // lse and delta of rows r0 and r0 + 8 (0 past Sq, whose dS is 0)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    row_lse[i] = row < Sq ? lse[(long long)bh * Sq + row] : 0.0f;
    row_delta[i] = row < Sq ? delta[(long long)bh * Sq + row] : 0.0f;
  }

  // Q's and dO's small parts: at D 64 the register A operands of the
  // small-big terms of S and dP, at D 128 tiles of their own
  uint32_t qsm[T::kQInRegs ? DP / 8 : 1][4];
  uint32_t dsm[T::kQInRegs ? DP / 8 : 1][4];
  mbar_wait(q_full, 0);
  if constexpr (T::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // A fragment: rows g, g + 8 (c & 1), columns t, t + 4 (c >> 1)
        const int off =
            q_offset<L::kQBox>(kRows * wg + 16 * warp + g + 8 * (c & 1),
                               8 * kk + t + 4 * (c >> 1));
        qsm[kk][c] = __float_as_uint(
            tf32_small(*reinterpret_cast<const float*>(sQ + off)));
        dsm[kk][c] = __float_as_uint(
            tf32_small(*reinterpret_cast<const float*>(sdO + off)));
      }
    }
  } else {
    for (int i = threadIdx.x; i < 2 * L::kQ / 16; i += blockDim.x) {
      const float4 x = reinterpret_cast<const float4*>(sQ)[i];
      reinterpret_cast<float4*>(sQs)[i] =
          make_float4(tf32_small(x.x), tf32_small(x.y), tf32_small(x.z),
                      tf32_small(x.w));
    }
  }
  mbar_wait(full, 0);
  derive(0);
  fence_proxy_async();
  __syncthreads();

  float dq_acc[DP / 8][4] = {};
  float s[kN / 8][4];                     // S
  float dp[kN / 8][4];                    // dP, then dS
  uint32_t dss[kN / 8][4];                // dS's small part

  // S = Q K^T and dP = dO V^T of k tile kt (64 q rows x kN keys a
  // warpgroup), per 8-deep slice big small, small big, big big
  auto issue_sdp = [&](int kt) {
    const uint32_t k_addr = smem_u32(sRing + (kt % kSt) * 2 * L::kK);
    const uint32_t v_addr = k_addr + L::kK;
    const uint32_t ks_addr = smem_u32(sSet);
    const uint32_t vs_addr = ks_addr + L::kK;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint32_t ko = (kk / 4) * L::kKBox + (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * L::kQBox + (kk % 4) * 32;
      wgmma_tf32_ss<kN>(s, sw128_desc(q_addr + qo, 16),
                        sw128_desc(ks_addr + ko, 16), kk > 0);
      wgmma_tf32_ss<kN>(dp, sw128_desc(do_addr + qo, 16),
                        sw128_desc(vs_addr + ko, 16), kk > 0);
      if constexpr (T::kQInRegs) {
        wgmma_tf32_rs<kN>(s, qsm[kk], sw128_desc(k_addr + ko, 16));
        wgmma_tf32_rs<kN>(dp, dsm[kk], sw128_desc(v_addr + ko, 16));
      } else {
        wgmma_tf32_ss<kN>(s, sw128_desc(qs_addr + qo, 16),
                          sw128_desc(k_addr + ko, 16), 1);
        wgmma_tf32_ss<kN>(dp, sw128_desc(dos_addr + qo, 16),
                          sw128_desc(v_addr + ko, 16), 1);
      }
      wgmma_tf32_ss<kN>(s, sw128_desc(q_addr + qo, 16),
                        sw128_desc(k_addr + ko, 16), 1);
      wgmma_tf32_ss<kN>(dp, sw128_desc(do_addr + qo, 16),
                        sw128_desc(v_addr + ko, 16), 1);
    }
  };
  // dQ += dS K, depth = the tile's kN keys (8-key slices 32 bytes apart in
  // K^T's rows, 32-key sub-tiles kTSub apart); dS's big part is dP's
  // registers as they are
  auto issue_dq = [&]() {
    const uint32_t kt_addr = smem_u32(sSet + 2 * L::kK);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const uint32_t to = (j / 4) * L::kTSub + (j % 4) * 32;
      const uint32_t da[4] = {__float_as_uint(dp[j][0]),
                              __float_as_uint(dp[j][2]),
                              __float_as_uint(dp[j][1]),
                              __float_as_uint(dp[j][3])};
      wgmma_tf32_rs<DP>(dq_acc, da, sw128_desc(kt_addr + L::kK + to, 16));
      wgmma_tf32_rs<DP>(dq_acc, dss[j], sw128_desc(kt_addr + to, 16));
      wgmma_tf32_rs<DP>(dq_acc, da, sw128_desc(kt_addr + to, 16));
    }
  };

  for (int kt = 0; kt < n; ++kt) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = 0.0f;
        dp[j][c] = 0.0f;
      }
    }
    wg_fence();
    issue_sdp(kt);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    // K and V of this tile are done with: the stage takes k tile kt + kSt
    release(empty + kt % kSt);

    // dS = P (dP - delta) scale, P = exp(S scale - lse) (JAX :341, :350,
    // :352): rows are q rows, columns keys
    const int k0 = kt * kN;
    auto emit = [&](int j, int c, float p) {
      dp[j][c] = p * (dp[j][c] - row_delta[c >> 1]) * scale;
      dss[j][acc_slot(c)] = __float_as_uint(tf32_small(dp[j][c]));
    };
    if (needs_mask(qw0, kRows, k0, kN, Sq, Sk, causal, has_kvm)) {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int col = k0 + 8 * j + 2 * t;
        const float kv[2] = {kv_of(kvm, col, Sk), kv_of(kvm, col + 1, Sk)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = masked(scale * s[j][c], r0 + 8 * (c >> 1),
                                 col + (c & 1), Sk, causal, kv[c & 1]);
          emit(j, c, expf(x - row_lse[c >> 1]));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          emit(j, c, expf(scale * s[j][c] - row_lse[c >> 1]));
        }
      }
    }
    wg_fence();
    issue_dq();
    wg_commit();
    if (producer && kt + kSt < n) produce(kt + kSt);
    __syncwarp();
    wg_wait<0>();
    reg_fence(dq_acc);
    reg_fence(dp);
    reg_fence(dss);
    // every warpgroup is done with the set: the next k tile's derived tiles
    __syncthreads();
    if (kt + 1 < n) {
      mbar_wait(full + (kt + 1) % kSt, ((kt + 1) / kSt) & 1);
      derive(kt + 1);
      fence_proxy_async();
      __syncthreads();
    }
  }

  // rows below Sq of dQ, contiguous (B, Sq, H, D), float32; D is a
  // multiple of 4, so column pairs store whole
  const long long row_stride = (long long)H * D;
  float* qb = dq + (long long)b * Sq * row_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int nn = 0; nn < DP / 8; ++nn) {
      const int col = 8 * nn + 2 * t;
      if (col < D) {
        *reinterpret_cast<float2*>(qb + row * row_stride + col) =
            make_float2(dq_acc[nn][2 * i], dq_acc[nn][2 * i + 1]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------

template <int DP>
int fwd_tf32(const Problem& p, const void* q, const void* k, const void* v,
             const float* kv_valid, void* out, float* lse) {
  using T = KvTiles<DP>;
  using L = KvSmem<DP, false>;
  CUtensorMap tq, tk, tv;
  if (int err = make_map(&tq, q, p.B, p.Sq, p.H, p.D, p.qs, L::kM, kF32)) {
    return err;
  }
  if (int err = make_map(&tk, k, p.B, p.Sk, p.H, p.D, p.ks, T::kN, kF32)) {
    return err;
  }
  if (int err = make_map(&tv, v, p.B, p.Sk, p.H, p.D, p.vs, T::kN, kF32)) {
    return err;
  }
  auto kernel = flash_fwd_tf32_sm90_kernel<DP>;
  static bool smem_set[kMaxDevices] = {};
  if (int err = allow_smem(kernel, L::kBytes, smem_set)) return err;
  const dim3 grid(static_cast<unsigned>(p.B * p.H),
                  static_cast<unsigned>((p.Sq + L::kM - 1) / L::kM));
  kernel<<<grid, 128 * T::kWgs, L::kBytes, p.stream>>>(
      tq, tk, tv, kv_valid, static_cast<float*>(out), lse, p.H, p.Sq, p.Sk,
      p.D, p.scale, p.causal);
  return static_cast<int>(cudaGetLastError());
}

// Q, K, V and dO's maps with boxes of `q_rows` (Q, dO) and `k_rows` (K, V)
// rows
int bwd_maps(const Problem& p, const void* q, const void* k, const void* v,
             const void* dout, int q_rows, int k_rows, CUtensorMap* tq,
             CUtensorMap* tk, CUtensorMap* tv, CUtensorMap* tdo) {
  if (int err = make_map(tq, q, p.B, p.Sq, p.H, p.D, p.qs, q_rows, kF32)) {
    return err;
  }
  if (int err = make_map(tk, k, p.B, p.Sk, p.H, p.D, p.ks, k_rows, kF32)) {
    return err;
  }
  if (int err = make_map(tv, v, p.B, p.Sk, p.H, p.D, p.vs, k_rows, kF32)) {
    return err;
  }
  return make_map(tdo, dout, p.B, p.Sq, p.H, p.D, dout_strides(p), q_rows,
                  kF32);
}

template <int DP>
int dkv_tf32(const Problem& p, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             const float* kv_valid, void* dk, void* dv) {
  using T = Tf32Tiles<DP>;
  using L = Tf32Smem<DP>;
  CUtensorMap tq, tk, tv, tdo;
  if (int err = bwd_maps(p, q, k, v, dout, T::kM, L::kN, &tq, &tk, &tv,
                         &tdo)) {
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

template <int DP>
int dq_tf32(const Problem& p, const void* q, const void* k, const void* v,
            const void* dout, const float* lse, const float* delta,
            const float* kv_valid, void* dq) {
  using T = KvTiles<DP>;
  using L = KvSmem<DP, true>;
  CUtensorMap tq, tk, tv, tdo;
  if (int err = bwd_maps(p, q, k, v, dout, L::kM, T::kN, &tq, &tk, &tv,
                         &tdo)) {
    return err;
  }
  auto kernel = flash_bwd_dq_tf32_sm90_kernel<DP>;
  static bool smem_set[kMaxDevices] = {};
  if (int err = allow_smem(kernel, L::kBytes, smem_set)) return err;
  const dim3 grid(static_cast<unsigned>(p.B * p.H),
                  static_cast<unsigned>((p.Sq + L::kM - 1) / L::kM));
  kernel<<<grid, 128 * T::kWgs, L::kBytes, p.stream>>>(
      tq, tk, tv, tdo, lse, delta, kv_valid, static_cast<float*>(dq), p.H,
      p.Sq, p.Sk, p.D, p.scale, p.causal);
  return static_cast<int>(cudaGetLastError());
}

// The problem of a float32 call (bf16 must be 0, D at most 128), or the
// error that refuses it: cudaErrorMisalignedAddress when an input is not
// readable by TMA in place (the caller stages a copy). `dout` is null for
// the forward.
int float32_problem(Problem* p, const void* q, const void* k, const void* v,
                    const void* dout, int B, int H, int Sq, int Sk, int D,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh, float scale,
                    int causal, int bf16, void* stream) {
  if (bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = check_shape(B, H, Sq, Sk, D)) return err;
  *p = make_problem(B, H, Sq, Sk, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                    vsh, scale, causal, stream);
  if (!inputs_readable(*p, q, k, v, dout, kF32)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return 0;
}

}  // namespace

extern "C" {

// flash_attention_sm90.cu's entry points for float32 inputs (bf16 must be
// 0): each enqueues one kernel on `stream` and returns cudaGetLastError()
// as an int, 0 when the launch was accepted; cudaErrorMisalignedAddress
// when an input is not readable by TMA in place (the caller stages a
// copy).

int dpt_flash_fwd(const void* q, const void* k, const void* v,
                  const float* kv_valid, void* out, float* lse, int B,
                  int H, int Sq, int Sk, int D, long long qsb, long long qss,
                  long long qsh, long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh, float scale,
                  int causal, int bf16, void* stream) {
  Problem p;
  if (int err = float32_problem(&p, q, k, v, nullptr, B, H, Sq, Sk, D, qsb,
                                qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                                scale, causal, bf16, stream)) {
    return err;
  }
  return D <= 64 ? fwd_tf32<64>(p, q, k, v, kv_valid, out, lse)
                 : fwd_tf32<128>(p, q, k, v, kv_valid, out, lse);
}

int dpt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* kv_valid, void* dk, void* dv, int B,
                      int H, int Sq, int Sk, int D, long long qsb,
                      long long qss, long long qsh, long long ksb,
                      long long kss, long long ksh, long long vsb,
                      long long vss, long long vsh, float scale, int causal,
                      int bf16, void* stream) {
  Problem p;
  if (int err = float32_problem(&p, q, k, v, dout, B, H, Sq, Sk, D, qsb,
                                qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                                scale, causal, bf16, stream)) {
    return err;
  }
  return D <= 64 ? dkv_tf32<64>(p, q, k, v, dout, lse, delta, kv_valid, dk,
                                dv)
                 : dkv_tf32<128>(p, q, k, v, dout, lse, delta, kv_valid, dk,
                                 dv);
}

int dpt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const float* kv_valid, void* dq, int B, int H, int Sq,
                     int Sk, int D, long long qsb, long long qss,
                     long long qsh, long long ksb, long long kss,
                     long long ksh, long long vsb, long long vss,
                     long long vsh, float scale, int causal, int bf16,
                     void* stream) {
  Problem p;
  if (int err = float32_problem(&p, q, k, v, dout, B, H, Sq, Sk, D, qsb,
                                qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                                scale, causal, bf16, stream)) {
    return err;
  }
  return D <= 64
             ? dq_tf32<64>(p, q, k, v, dout, lse, delta, kv_valid, dq)
             : dq_tf32<128>(p, q, k, v, dout, lse, delta, kv_valid, dq);
}

const char* dpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
