// FlashAttention forward (K3), dK/dV (K4) and dQ (K5) for bfloat16 inputs,
// written for Hopper (sm_90a): two consumer warpgroups run every product
// as wgmma, fed through rings of shared-memory tiles that TMA fills, with
// full/empty mbarrier pairs between the copies and the products.
//
// Replace the Pallas TPU kernels of
//   distributed_pytorch_training_tpu/ops/flash_attention.py
// for bfloat16 inputs:
//   flash_fwd_bf16_sm90_kernel     <- _flash_fwd_lse (:199), body
//                                     _fwd_kernel (:146), pallas_call :232
//   flash_bwd_dkv_bf16_sm90_kernel <- _flash_bwd (:360), body
//                                     _bwd_dkv_kernel (:269), pallas_call :400
//   flash_bwd_dq_bf16_sm90_kernel  <- _flash_bwd (:360), body
//                                     _bwd_dq_kernel (:317), pallas_call :440
// float32 K3-K5 are flash_attention_sm90_tf32.cu's. The C entry points
// dpt_flash_fwd, dpt_flash_bwd_dkv and dpt_flash_bwd_dq take bfloat16
// (bf16 = 1) only; the float32 library exports the same names and
// signatures. flash_sm90.cuh holds what the Hopper kernels share (masks,
// mbarriers, TMA, descriptors) and, in its header, the semantics every
// flash kernel keeps.
//
// Arithmetic: S multiplies the bf16 inputs as they are (exact products,
// float32 sums) and is scaled in float32 after the dot (the backward scales
// the dot and dS as the JAX kernel does); a tile pair that no mask bites
// (needs_mask) takes no mask test, and the masks are selects, not
// branches; exp(x) is exp2f(x log2 e) with no flush-to-zero; m and l are
// float32, l summed over the float32 P, floored at 1e-30; P (K4: P^T and
// dS^T; K5: dS) is rounded once to bf16, to nearest even, into the next
// product's A operand; O, dK, dV and dQ accumulate in float32; lse = m +
// log l; out = O (1 / l). An all-masked row (every key masked by kv_valid
// or causality) averages V over the keys of the k tiles its q tile visits,
// which depends on the tile sizes below: such a row has no weight in any
// loss, and the checks compare only rows with a live key.
//
// Bound on the card (NVIDIA H100 SXM, 989 TFLOP/s dense bf16, 3.35 TB/s,
// NVIDIA's data sheet): at GPT-2 124M's shape (B 8, S 1024, H 12, D 64,
// causal) the forward does 12.9 GFLOP (0.013 ms) against 0.015 ms of
// bytes, dK/dV 25.8 GFLOP (0.026 ms) against 0.023 ms, dQ 19.4 GFLOP
// (0.020 ms) against 0.019 ms: K3 is bound by bytes, K4 and K5 by
// operations, all by a hair. The exponentials are a third limit: the SM's
// 16 ex2 a clock take as long as the forward's products at D 64, and with
// the scale, the subtraction of the max, exp2f's no-flush-to-zero range
// fix, the max and the sum, the softmax issues about 9 instructions an
// element, which is what bounds this forward.
//
// Block (K3, K4): 256 threads, two consumer warpgroups. Each owns 64 rows
// of the block's tile (one wgmma M slice); thread 0 also issues every TMA
// copy. Registers: 8 warps, 2 on each SM sub-partition
// (16,384 registers each), so ptxas may give a thread 255, and the kernels
// use 212 (K3) and 189 (K4) at D 64 with no spill. A producer warp or
// warpgroup of its own (FlashAttention-3's layout) puts 3 warps on a
// sub-partition, which caps ptxas at 168 a thread: with setmaxnreg (240
// consumer, 24 producer; CUDA 12.9) ptxas still compiled the consumers
// within 168, spilled and serialized the wgmmas, and both kernels ran
// slower than this block, so the copies are issued in band: they are
// single TMA instructions, issued a ring's depth ahead. One block an SM.
// Tiles reach shared memory by TMA through 4-D tensor maps over (D, H, S,
// B) built from the tensors' own pointers and strides, so the fused qkv
// views of GPT-2 and BERT are read in place; a box is one head, 64
// columns of D (128 bytes, SWIZZLE_128B, wgmma's B128 layout) and a tile's
// rows; D 128 takes two boxes; columns past D and rows past S arrive as
// zeros (TMA's out-of-bounds fill), which is exact. Inputs must be 16-byte
// aligned with 16-byte strides and D a multiple of 8:
// ops/flash_attention.py stages a copy of any tensor that is not (never on
// the main paths).
//
// Forward (K3): one block per (batch * head, 128-row q tile), heaviest
// causal tiles first; k tiles of 128 keys. Q is loaded once; K and V ride
// a ring of 3 stages each. A warpgroup computes S = Q K^T as m64n128k16
// (A and B from shared memory, K-major), and O += P V as m64nDk16 with P
// as the register A operand (the accumulator's two 8-column groups are the
// A layout) and V MN-major through the transpose bit. Overlap:
// FlashAttention-3's intra-warpgroup pipelining. Each iteration issues
// this tile's S and then the previous tile's P V, so the softmax of this
// tile (mask, max, exponentials, sums) runs while P V is on the tensor
// cores; O is rescaled once that P V is in. The two-warpgroup ping-pong
// on named barriers, tried on top of it, and a persistent block that
// prefetches its next item, each measured no faster on the card (PERF.md
// §6). Registers a thread: S 64, P 32, O 32 (D 64) or 64 (D 128).
// Shared memory: Q 16 KB (32 KB at D 128) + 3 stages x (K + V) 96 KB
// (192 KB) = 112 KB (224 KB).
//
// dK/dV (K4): one block per (batch * head, 128-key tile), heaviest causal
// tiles first; K and V are loaded once and stay; Q, dO and the q tile's
// lse and delta rows ride a ring of 4 stages of 64 q rows (lse and delta
// by cp.async, counted on the stage's mbarrier; causal blocks start at
// the first q tile that reaches the block's first key). A warpgroup owns
// 64 keys and per q tile computes S^T = K Q^T and dP^T = V dO^T as
// m64n64k16 (both K-major from shared memory), P^T = exp(S^T scale - lse)
// and dS^T = P^T (dP^T - delta) scale in float32 registers, rounds each
// once to bf16 into the register A operand, and accumulates dV += P^T dO
// and dK += dS^T Q as m64nDk16 with dO and Q MN-major through the
// transpose bit; the next q tile's S^T and dP^T are issued before the wait
// for this tile's dV and dK. Registers a thread: S^T, dP^T, dK, dV 32 each
// and P^T, dS^T 16 each at D 64 (64 each for dK and dV at D 128). Shared
// memory: K and V 32 KB (64 KB) + 4 stages x (Q + dO + lse + delta) 16.5
// KB (32.5 KB) = 98 KB (194 KB).
//
// dQ (K5): K3's layout with K4's arithmetic, one consumer warpgroup a
// block. One block per (batch * head, 64-row q tile), heaviest causal
// tiles first; Q and dO are loaded once by TMA and stay, each thread keeps
// its two rows' lse and delta in registers; K and V ride a ring of 64-key
// k tiles. Per k tile the warpgroup computes S = Q K^T and dP = dO V^T as
// m64n64k16 (both K-major from shared memory), dS = exp(S scale - lse)
// (dP - delta) scale in float32 registers, rounds it once to bf16 into the
// register A operand and accumulates dQ += dS K as m64nDk16 with K
// MN-major through the transpose bit. Overlap: each iteration issues this
// tile's S and dP, then the previous tile's dQ, and runs this tile's
// softmax while that dQ is on the tensor cores (K3's order). What sets
// its speed is latency, not the tensor cores or the exponentials: on the
// card at GPT-2's shape the loads and barriers alone took 0.045 ms, the
// products without the softmax 0.059, and more resident warps paid better
// than any order within a warpgroup (PERF.md §6). So a block is one
// warpgroup and three blocks share an SM at D 64 (12 warps; a block of two
// warpgroups with two register sets, S and dP of the next tile issued
// before this tile's softmax, took 0.093 ms). Registers a thread: S, dP,
// dQ 32 each (dQ 64 at D 128), dS 16; three blocks an SM leave ptxas 168,
// and it uses 160 at D 64 (CUDA 12.8; 208 at D 128), no spill. Shared
// memory: Q and dO 16 KB (32 KB at D 128) + 3 stages x (K + V) 48 KB = 64
// KB, three blocks an SM; at D 128 2 stages x 64 KB, 96 KB, two blocks an
// SM.

#include <cuda_bf16.h>

#include "flash_sm90.cuh"

namespace {

using bf16_t = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers;
constexpr int kBoxCols = 64;     // bf16 columns of a TMA box: 128 bytes
constexpr int kBf16 = 2;         // bytes of an element
constexpr int kFwdStages = 3;    // ring stages of K and V in the forward
constexpr int kDkvStages = 4;    // of Q, dO, lse and delta in dK/dV
constexpr int kFwdM = kConsumers * kRows;  // q rows of a forward block
constexpr int kFwdN = 128;                 // keys of a forward k tile
constexpr int kDkvN = kConsumers * kRows;  // keys of a dK/dV block
constexpr int kDkvM = 64;                  // q rows of a dK/dV q tile
constexpr int kDqM = kRows;                // q rows of a dQ block
constexpr int kDqThreads = 128;            // one consumer warpgroup
constexpr int kDqN = 64;                   // keys of a dQ k tile

// --------------------------------------------------------------------------
// bf16 arithmetic kept from the earlier mma.sync bf16 kernels
// --------------------------------------------------------------------------

__device__ __forceinline__ float exp_bf16(float x) {
  return exp2f(x * kLog2e);
}

// two floats rounded to nearest even into one bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring 8-column groups of an accumulator (16 columns of the
// next product's depth) as that product's register A operand: the
// accumulator layout of the pair is the A layout, so a thread packs its
// own registers.
__device__ __forceinline__ void acc_pair_as_a(uint32_t (&a)[4],
                                              const float (&c0)[4],
                                              const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// --------------------------------------------------------------------------
// wgmma, bf16
// --------------------------------------------------------------------------

// d (64 x 64) = a b + (scale_d ? d : 0): a (64 x 16) and b (16 x 64),
// both K-major in shared memory (descriptors da and db)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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

// d (64 x 64) += a b: a (64 x 16) in registers (each warp's 16 rows in
// the m16n8k16 A layout), b (16 x 64) MN-major in shared memory (db, read
// through the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

// d (64 x 128) = a b + (scale_d ? d : 0): a (64 x 16) and b (16 x 128),
// both K-major in shared memory (descriptors da and db)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// d (64 x 128) += a b: a (64 x 16) in registers (each warp's 16 rows in
// the m16n8k16 A layout), b (16 x 128) MN-major in shared memory (db, read
// through the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// --------------------------------------------------------------------------
// forward (K3)
// --------------------------------------------------------------------------

// S (64 rows x kFwdN keys of k tile k0, this thread's rows r0 and r0 + 8)
// scaled in float32 and masked where `mask`, then the online softmax (JAX
// :183-:190) with m, l and P in float32: S becomes P = exp(s - m_new), l
// = alpha l + rowsum(P), and alpha = exp(m_old - m_new) is returned for
// the rescale of O.
__device__ __forceinline__ void online_softmax(
    float (&s)[kFwdN / 8][4], float (&m)[2], float (&l)[2],
    float (&alpha)[2], float scale, bool mask, int r0, int k0, int t,
    int Sk, bool causal, const float* kvm) {
#pragma unroll
  for (int j = 0; j < kFwdN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] *= scale;
  }
  if (mask) {
#pragma unroll
    for (int j = 0; j < kFwdN / 8; ++j) {
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
  for (int j = 0; j < kFwdN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    alpha[i] = exp_bf16(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < kFwdN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[j][c] = exp_bf16(s[j][c] - m[c >> 1]);
      sum[c >> 1] += s[j][c];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
}

// P rounded once to bf16 into the register A operand of P V
__device__ __forceinline__ void pack_p(uint32_t (&p)[kFwdN / 16][4],
                                       const float (&s)[kFwdN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kFwdN / 16; ++kk) {
    acc_pair_as_a(p[kk], s[2 * kk], s[2 * kk + 1]);
  }
}

// Shared memory of the forward at DP (64 or 128) columns: Q, then the ring
// of K tiles, then the ring of V tiles, then the barriers. Every box starts
// on a 1024-byte boundary.
template <int DP>
struct FwdSmem {
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kQBox = kFwdM * kRowBytes;   // one box of Q
  static constexpr int kKBox = kFwdN * kRowBytes;   // one box of K or V
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kK = kBoxes * kKBox;         // one stage of K or V
  static constexpr int kBars = kQ + 2 * kFwdStages * kK;
  // q_full, k_full, k_empty, v_full, v_empty; and the alignment slack
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kFwdStages) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_bf16_sm90_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ kv_valid, bf16_t* __restrict__ out,
    float* __restrict__ lse, int H, int Sq, int Sk, int D, float scale,
    int causal) {
  using L = FwdSmem<DP>;
  constexpr int kSt = kFwdStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sK = sQ + L::kQ;               // [kSt]
  unsigned char* sV = sK + kSt * L::kK;         // [kSt]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sQ + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kSt;
  uint64_t* v_full = k_empty + kSt;
  uint64_t* v_empty = v_full + kSt;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdM;
  int n_kt = (Sk + kFwdN - 1) / kFwdN;
  if (causal) n_kt = min(n_kt, (q0 + kFwdM - 1) / kFwdN + 1);
  const int wg = threadIdx.x / 128;
  const bool producer = threadIdx.x == 0;

  // K and V of k tile kt into its stage, once both warpgroups are done
  // with the tile kSt before it (a fresh stage passes at once)
  auto produce = [&](int kt) {
    const int s = kt % kSt;
    const uint32_t parity = ((kt / kSt) & 1) ^ 1;
    mbar_wait(k_empty + s, parity);
    mbar_expect_tx(k_full + s, L::kK);
    for (int x = 0; x < L::kBoxes; ++x) {
      tma_load(sK + s * L::kK + x * L::kKBox, &tk, k_full + s, x * kBoxCols,
               h, kt * kFwdN, b);
    }
    mbar_wait(v_empty + s, parity);
    mbar_expect_tx(v_full + s, L::kK);
    for (int x = 0; x < L::kBoxes; ++x) {
      tma_load(sV + s * L::kK + x * L::kKBox, &tv, v_full + s, x * kBoxCols,
               h, kt * kFwdN, b);
    }
  };

  if (producer) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kConsumerWarps);
      mbar_init(v_empty + s, kConsumerWarps);
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
    for (int kt = 0; kt < min(kSt, n_kt); ++kt) produce(kt);
  }
  __syncwarp();

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

  // S = Q K^T of the k tile in `stage`: DP / 16 slices of depth, 32 bytes
  // apart in a box row, the second box past 64 columns
  auto issue_s = [&](float (&s)[kFwdN / 8][4], int stage) {
    const uint32_t k_addr = smem_u32(sK + stage * L::kK);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kQBox + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * L::kKBox + (kk % 4) * 32;
      wgmma_ss_n128(s, sw128_desc(q_addr + off, 16),
                    sw128_desc(k_addr + koff, 16), kk > 0);
    }
  };
  // O += P V of the tile in `stage`: 8 slices of 16 keys, 2048 bytes
  // apart; V's second 64 columns one box on
  auto issue_pv = [&](float (&o)[DP / 8][4], uint32_t (&p)[kFwdN / 16][4],
                      int stage) {
    const uint32_t v_addr = smem_u32(sV + stage * L::kK);
#pragma unroll
    for (int kk = 0; kk < kFwdN / 16; ++kk) {
      wgmma_rs<DP>(o, p[kk],
                   sw128_desc(v_addr + kk * 16 * kRowBytes, L::kKBox));
    }
  };

  // rows r0 and r0 + 8: running max (from NEG_INF, as the JAX kernel's m),
  // sum and the output accumulator
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float alpha[2];
  float o[DP / 8][4] = {};
  float s[kFwdN / 8][4];
  uint32_t p[kFwdN / 16][4];

  // the first k tile: S, its softmax (O is still 0: no rescale) and P
  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  wg_fence();
  issue_s(s, 0);
  wg_commit();
  wg_wait<0>();
  reg_fence(s);
  release(k_empty);
  online_softmax(s, m, l, alpha, scale,
                 needs_mask(qw0, kRows, 0, kFwdN, Sq, Sk, causal, has_kvm),
                 r0, 0, t, Sk, causal, kvm);
  pack_p(p, s);
  // each later tile: issue its S, then the previous tile's P V, whose
  // products run under this tile's softmax
  for (int kt = 1; kt < n_kt; ++kt) {
    const int stage = kt % kSt;
    const int prev = (kt - 1) % kSt;
    mbar_wait(k_full + stage, (kt / kSt) & 1);
    wg_fence();
    issue_s(s, stage);
    wg_commit();
    mbar_wait(v_full + prev, ((kt - 1) / kSt) & 1);
    wg_fence();
    issue_pv(o, p, prev);
    wg_commit();
    wg_wait<1>();
    reg_fence(s);
    release(k_empty + stage);
    const int k0 = kt * kFwdN;
    online_softmax(s, m, l, alpha, scale,
                   needs_mask(qw0, kRows, k0, kFwdN, Sq, Sk, causal, has_kvm),
                   r0, k0, t, Sk, causal, kvm);
    wg_wait<0>();
    reg_fence(o);
    reg_fence(p);
    release(v_empty + prev);
    // k tile kt - 1 is done with: its stage takes tile kt - 1 + kSt
    if (producer && kt - 1 + kSt < n_kt) produce(kt - 1 + kSt);
    __syncwarp();
    // O = alpha O + P V (JAX :189): this tile's rescale, then its P V
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] *= alpha[c >> 1];
    }
    pack_p(p, s);
  }
  // the last tile's P V
  const int last = n_kt - 1;
  mbar_wait(v_full + last % kSt, (last / kSt) & 1);
  wg_fence();
  issue_pv(o, p, last % kSt);
  wg_commit();
  wg_wait<0>();
  reg_fence(o);

  // out = O (1 / l), rounded to bf16, and lse = m + log l, l floored at
  // 1e-30 (JAX :194-:196); D is even, so column pairs store whole
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.0f / l[i];
  }
  const long long row_stride = (long long)H * D;
  bf16_t* ob = out + (long long)b * Sq * row_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(ob + row * row_stride + col) =
            pack_bf16(o[n][2 * i] * inv[i], o[n][2 * i + 1] * inv[i]);
      }
    }
    if (t == 0) lse[(long long)bh * Sq + row] = m[i] + logf(l[i]);
  }
}

// --------------------------------------------------------------------------
// backward: dK and dV (K4)
// --------------------------------------------------------------------------

// Shared memory of dK/dV at DP columns: K, V, then the ring of Q tiles,
// the ring of dO tiles, the ring of (lse, delta) rows, then the barriers.
template <int DP>
struct DkvSmem {
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kKBox = kDkvN * kRowBytes;   // one box of K or V
  static constexpr int kQBox = kDkvM * kRowBytes;   // one box of Q or dO
  static constexpr int kK = kBoxes * kKBox;
  static constexpr int kQ = kBoxes * kQBox;         // one stage of Q or dO
  static constexpr int kRowsOff = 2 * kK + 2 * kDkvStages * kQ;
  static constexpr int kBars = kRowsOff + kDkvStages * 2 * kDkvM * 4;
  // kv_full, full, empty; and the alignment slack
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kDkvStages) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_bf16_sm90_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const float* __restrict__ kv_valid, bf16_t* __restrict__ dk,
        bf16_t* __restrict__ dv, int H, int Sq, int Sk, int D, float scale,
        int causal) {
  using L = DkvSmem<DP>;
  constexpr int kSt = kDkvStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + L::kK;
  unsigned char* sQ = sV + L::kK;               // [kSt]
  unsigned char* sdO = sQ + kSt * L::kQ;        // [kSt]
  float* sRows = reinterpret_cast<float*>(sK + L::kRowsOff);  // [kSt][2][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sK + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kSt;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kDkvN;
  const int n_qt = (Sq + kDkvM - 1) / kDkvM;
  // causal: q tiles whose last row is before this block's first key are
  // dead
  const int qt0 = causal ? k0 / kDkvM : 0;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // warp 0 produces: lane 0 issues the TMA copies, every lane copies two of
  // the q tile's lse and delta rows by cp.async
  const bool producer = threadIdx.x < 32;
  const long long row_base = (long long)bh * Sq;

  // Q, dO, lse and delta of the it-th live q tile into its stage, once both
  // warpgroups are done with the q tile kSt before it
  auto produce = [&](int it) {
    const int s = it % kSt;
    const int q0 = (qt0 + it) * kDkvM;
    mbar_wait(empty + s, ((it / kSt) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(full + s, 2 * L::kQ);
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load(sQ + s * L::kQ + x * L::kQBox, &tq, full + s, x * kBoxCols,
                 h, q0, b);
        tma_load(sdO + s * L::kQ + x * L::kQBox, &tdo, full + s,
                 x * kBoxCols, h, q0, b);
      }
    }
    float* rows = sRows + s * 2 * kDkvM;
    for (int i = lane; i < kDkvM; i += 32) {
      const int row = q0 + i;
      const bool ok = row < Sq;
      cp_async4(rows + i, lse + row_base + (ok ? row : 0), ok);
      cp_async4(rows + kDkvM + i, delta + row_base + (ok ? row : 0), ok);
    }
    cp_async_arrive(full + s);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      // lane 0's bytes, then the 32 lanes' cp.async rows
      mbar_init(full + s, 1 + 32);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer && qt0 < n_qt) {
    // K and V once, and the ring's first kSt q tiles
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kK);
      for (int x = 0; x < L::kBoxes; ++x) {
        tma_load(sK + x * L::kKBox, &tk, kv_full, x * kBoxCols, h, k0, b);
        tma_load(sV + x * L::kKBox, &tv, kv_full, x * kBoxCols, h, k0, b);
      }
    }
    for (int it = 0; it < min(kSt, n_qt - qt0); ++it) produce(it);
  }
  __syncwarp();

  const int g = lane / 4;
  const int t = lane % 4;
  const int kw0 = k0 + kRows * wg;         // this warpgroup's first key
  const int key0 = kw0 + 16 * warp + g;    // this thread's keys key0, +8
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;
  const float kv[2] = {kv_of(kvm, key0, Sk), kv_of(kvm, key0 + 8, Sk)};
  const uint32_t k_addr = smem_u32(sK) + kRows * kRowBytes * wg;
  const uint32_t v_addr = smem_u32(sV) + kRows * kRowBytes * wg;

  float dk_acc[DP / 8][4] = {};
  float dv_acc[DP / 8][4] = {};
  float st[kDkvM / 8][4];          // S^T, then P^T
  float dpt[kDkvM / 8][4];         // dP^T, then dS^T
  uint32_t pa[kDkvM / 16][4];      // P^T in bf16: dV's A operand
  uint32_t da[kDkvM / 16][4];      // dS^T in bf16: dK's A operand

  if (qt0 < n_qt) mbar_wait(kv_full, 0);
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int it = qt - qt0;
    const int stage = it % kSt;
    const uint32_t q_addr = smem_u32(sQ + stage * L::kQ);
    const uint32_t do_addr = smem_u32(sdO + stage * L::kQ);
    mbar_wait(full + stage, (it / kSt) & 1);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 q rows a warpgroup)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t ko = (kk / 4) * L::kKBox + (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * L::kQBox + (kk % 4) * 32;
      wgmma_ss_n64(st, sw128_desc(k_addr + ko, 16),
                   sw128_desc(q_addr + qo, 16), kk > 0);
      wgmma_ss_n64(dpt, sw128_desc(v_addr + ko, 16),
                   sw128_desc(do_addr + qo, 16), kk > 0);
    }
    wg_commit();
    if (it > 0) {
      // the previous q tile's dV and dK are done: its stage is free, and
      // takes the q tile kSt on
      wg_wait<1>();
      reg_fence(dk_acc);
      reg_fence(dv_acc);
      reg_fence(pa);
      reg_fence(da);
      release(empty + (it - 1) % kSt);
      if (producer && qt - 1 + kSt < n_qt) produce(it - 1 + kSt);
      __syncwarp();
    }
    wg_wait<0>();
    reg_fence(st);
    reg_fence(dpt);

    // P^T and dS^T in float32: rows are keys, columns q rows (JAX :294,
    // :305, :308)
    const float* c_lse = sRows + stage * 2 * kDkvM;
    const float* c_delta = c_lse + kDkvM;
    const int q0 = qt * kDkvM;
    if (needs_mask(q0, kDkvM, kw0, kRows, Sq, Sk, causal, kvm != nullptr)) {
#pragma unroll
      for (int j = 0; j < kDkvM / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          const float x = masked(scale * st[j][c], q0 + col,
                                 key0 + 8 * (c >> 1), Sk, causal,
                                 kv[c >> 1]);
          const float p = q0 + col < Sq ? exp_bf16(x - c_lse[col]) : 0.0f;
          st[j][c] = p;
          dpt[j][c] = p * (dpt[j][c] - c_delta[col]) * scale;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kDkvM / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          const float p = exp_bf16(scale * st[j][c] - c_lse[col]);
          st[j][c] = p;
          dpt[j][c] = p * (dpt[j][c] - c_delta[col]) * scale;
        }
      }
    }
    // each rounded once to bf16 into the register A operands
#pragma unroll
    for (int kk = 0; kk < kDkvM / 16; ++kk) {
      acc_pair_as_a(pa[kk], st[2 * kk], st[2 * kk + 1]);
      acc_pair_as_a(da[kk], dpt[2 * kk], dpt[2 * kk + 1]);
    }

    // dV += P^T dO and dK += dS^T Q, depth = the tile's 64 q rows (16-row
    // slices 2048 bytes apart; the second 64 columns one box on)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvM / 16; ++kk) {
      wgmma_rs<DP>(dv_acc, pa[kk],
                   sw128_desc(do_addr + kk * 16 * kRowBytes, L::kQBox));
      wgmma_rs<DP>(dk_acc, da[kk],
                   sw128_desc(q_addr + kk * 16 * kRowBytes, L::kQBox));
    }
    wg_commit();
  }
  wg_wait<0>();
  reg_fence(dk_acc);
  reg_fence(dv_acc);
  reg_fence(pa);
  reg_fence(da);

  // rows below Sk of dK and dV, contiguous (B, Sk, H, D), in bf16; D is
  // even, so column pairs store whole
  const long long row_stride = (long long)H * D;
  const long long base = (long long)b * Sk * row_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Sk) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D) {
        const long long at = base + key * row_stride + col;
        *reinterpret_cast<uint32_t*>(dk + at) =
            pack_bf16(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + at) =
            pack_bf16(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
  }
}
// --------------------------------------------------------------------------
// backward: dQ (K5)
// --------------------------------------------------------------------------

// Shared memory of dQ at DP columns: Q, dO, then the ring of K tiles, the
// ring of V tiles, then the barriers; and the blocks an SM it allows (the
// header's arithmetic).
template <int DP>
struct DqSmem {
  static constexpr int kStages = DP == 64 ? 3 : 2;  // ring stages of K, V
  static constexpr int kBlocks = DP == 64 ? 3 : 2;  // blocks an SM
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kQBox = kDqM * kRowBytes;    // one box of Q or dO
  static constexpr int kKBox = kDqN * kRowBytes;    // one box of K or V
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kK = kBoxes * kKBox;         // one stage of K or V
  static constexpr int kBars = 2 * kQ + 2 * kStages * kK;
  // q_full, full, empty; and the alignment slack
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kDqThreads, DqSmem<DP>::kBlocks)
    flash_bwd_dq_bf16_sm90_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo,
        const float* __restrict__ lse, const float* __restrict__ delta,
        const float* __restrict__ kv_valid, bf16_t* __restrict__ dq, int H,
        int Sq, int Sk, int D, float scale, int causal) {
  using L = DqSmem<DP>;
  constexpr int kSt = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sdO = sQ + L::kQ;
  unsigned char* sK = sdO + L::kQ;              // [kSt]
  unsigned char* sV = sK + kSt * L::kK;         // [kSt]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sQ + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kSt;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqM;
  int n_kt = (Sk + kDqN - 1) / kDqN;
  if (causal) n_kt = min(n_kt, (q0 + kDqM - 1) / kDqN + 1);
  const bool producer = threadIdx.x == 0;

  // K and V of k tile kt into its stage, once every warp is done with
  // the tile kSt before it (a fresh stage passes at once)
  auto produce = [&](int kt) {
    const int s = kt % kSt;
    mbar_wait(empty + s, ((kt / kSt) & 1) ^ 1);
    mbar_expect_tx(full + s, 2 * L::kK);
    for (int x = 0; x < L::kBoxes; ++x) {
      tma_load(sK + s * L::kK + x * L::kKBox, &tk, full + s, x * kBoxCols,
               h, kt * kDqN, b);
      tma_load(sV + s * L::kK + x * L::kKBox, &tv, full + s, x * kBoxCols,
               h, kt * kDqN, b);
    }
  };

  if (producer) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);
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
    for (int kt = 0; kt < min(kSt, n_kt); ++kt) produce(kt);
  }
  __syncwarp();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = q0 + 16 * warp + g;      // this thread's rows r0, r0 + 8
  const float* kvm = kv_valid ? kv_valid + (long long)b * Sk : nullptr;
  const bool has_kvm = kvm != nullptr;
  const uint32_t q_addr = smem_u32(sQ);
  const uint32_t do_addr = smem_u32(sdO);
  // lse and delta of rows r0 and r0 + 8 (0 past Sq, whose dS is 0)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    row_lse[i] = row < Sq ? lse[(long long)bh * Sq + row] : 0.0f;
    row_delta[i] = row < Sq ? delta[(long long)bh * Sq + row] : 0.0f;
  }

  // S = Q K^T and dP = dO V^T of the k tile in `stage`: DP / 16 slices of
  // depth, 32 bytes apart in a box row, the second box past 64 columns
  auto issue_sdp = [&](float (&s)[kDqN / 8][4], float (&dp)[kDqN / 8][4],
                       int stage) {
    const uint32_t k_addr = smem_u32(sK + stage * L::kK);
    const uint32_t v_addr = smem_u32(sV + stage * L::kK);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kQBox + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * L::kKBox + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(q_addr + off, 16),
                   sw128_desc(k_addr + koff, 16), kk > 0);
      wgmma_ss_n64(dp, sw128_desc(do_addr + off, 16),
                   sw128_desc(v_addr + koff, 16), kk > 0);
    }
  };
  // dS = P (dP - delta) scale in dp, P = exp(S scale - lse) (JAX :341,
  // :350, :352): rows are q rows, columns keys. A row past Sq needs no
  // test: TMA filled its Q and dO with zeros and its lse and delta are 0,
  // so its P is at most 1 and its dS is 0.
  auto ds_of = [&](float (&s)[kDqN / 8][4], float (&dp)[kDqN / 8][4],
                   int kt) {
    const int k0 = kt * kDqN;
    if (needs_mask(q0, kDqM, k0, kDqN, Sq, Sk, causal, has_kvm)) {
#pragma unroll
      for (int j = 0; j < kDqN / 8; ++j) {
        const int col = k0 + 8 * j + 2 * t;
        const float kv[2] = {kv_of(kvm, col, Sk), kv_of(kvm, col + 1, Sk)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = masked(scale * s[j][c], r0 + 8 * (c >> 1),
                                 col + (c & 1), Sk, causal, kv[c & 1]);
          const float p = exp_bf16(x - row_lse[c >> 1]);
          dp[j][c] = p * (dp[j][c] - row_delta[c >> 1]) * scale;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kDqN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp_bf16(scale * s[j][c] - row_lse[c >> 1]);
          dp[j][c] = p * (dp[j][c] - row_delta[c >> 1]) * scale;
        }
      }
    }
  };

  float dq_acc[DP / 8][4] = {};
  float s[kDqN / 8][4];                      // S
  float dp[kDqN / 8][4];                     // dP, then dS
  uint32_t da[kDqN / 16][4];                 // dS in bf16: dQ's A operand
  // dQ += dS K of the k tile in `stage`, depth = its 64 keys (16-key
  // slices 2048 bytes apart; K's second 64 columns one box on)
  auto issue_dq = [&](int stage) {
    const uint32_t k_addr = smem_u32(sK + stage * L::kK);
#pragma unroll
    for (int kk = 0; kk < kDqN / 16; ++kk) {
      wgmma_rs<DP>(dq_acc, da[kk],
                   sw128_desc(k_addr + kk * 16 * kRowBytes, L::kKBox));
    }
  };
  // dS rounded once to bf16 into the register A operand
  auto pack_ds = [&]() {
#pragma unroll
    for (int kk = 0; kk < kDqN / 16; ++kk) {
      acc_pair_as_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
    }
  };

  // the first k tile: S, dP and dS; then each later tile issues its S and
  // dP and the previous tile's dQ, whose products run under this tile's
  // softmax
  mbar_wait(q_full, 0);
  mbar_wait(full, 0);
  wg_fence();
  issue_sdp(s, dp, 0);
  wg_commit();
  wg_wait<0>();
  reg_fence(s);
  reg_fence(dp);
  ds_of(s, dp, 0);
  pack_ds();
  for (int kt = 1; kt < n_kt; ++kt) {
    const int stage = kt % kSt;
    const int prev = (kt - 1) % kSt;
    mbar_wait(full + stage, (kt / kSt) & 1);
    wg_fence();
    issue_sdp(s, dp, stage);
    wg_commit();
    issue_dq(prev);
    wg_commit();
    wg_wait<1>();
    reg_fence(s);
    reg_fence(dp);
    ds_of(s, dp, kt);
    wg_wait<0>();
    reg_fence(dq_acc);
    reg_fence(da);
    // k tile kt - 1 is done with: its stage takes tile kt - 1 + kSt
    release(empty + prev);
    if (producer && kt - 1 + kSt < n_kt) produce(kt - 1 + kSt);
    __syncwarp();
    pack_ds();
  }
  // the last tile's dQ
  wg_fence();
  issue_dq((n_kt - 1) % kSt);
  wg_commit();
  wg_wait<0>();
  reg_fence(dq_acc);
  reg_fence(da);

  // rows below Sq of dQ, contiguous (B, Sq, H, D), in bf16; D is even, so
  // column pairs store whole
  const long long row_stride = (long long)H * D;
  bf16_t* qb = dq + (long long)b * Sq * row_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(qb + row * row_stride + col) =
            pack_bf16(dq_acc[n][2 * i], dq_acc[n][2 * i + 1]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------

template <int DP>
int fwd_sm90(const Problem& p, const void* q, const void* k, const void* v,
             const float* kv_valid, void* out, float* lse) {
  CUtensorMap tq, tk, tv;
  if (int err = make_map(&tq, q, p.B, p.Sq, p.H, p.D, p.qs, kFwdM, kBf16)) {
    return err;
  }
  if (int err = make_map(&tk, k, p.B, p.Sk, p.H, p.D, p.ks, kFwdN, kBf16)) {
    return err;
  }
  if (int err = make_map(&tv, v, p.B, p.Sk, p.H, p.D, p.vs, kFwdN, kBf16)) {
    return err;
  }
  auto kernel = flash_fwd_bf16_sm90_kernel<DP>;
  static bool smem_set[kMaxDevices] = {};
  if (int err = allow_smem(kernel, FwdSmem<DP>::kBytes, smem_set)) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>(p.B * p.H),
                  static_cast<unsigned>((p.Sq + kFwdM - 1) / kFwdM));
  kernel<<<grid, kThreads, FwdSmem<DP>::kBytes, p.stream>>>(
      tq, tk, tv, kv_valid, static_cast<bf16_t*>(out), lse, p.H, p.Sq, p.Sk,
      p.D, p.scale, p.causal);
  return static_cast<int>(cudaGetLastError());
}

// Q, K, V and dO's maps with boxes of `q_rows` (Q, dO) and `k_rows` (K, V)
// rows
int bwd_maps(const Problem& p, const void* q, const void* k, const void* v,
             const void* dout, int q_rows, int k_rows, CUtensorMap* tq,
             CUtensorMap* tk, CUtensorMap* tv, CUtensorMap* tdo) {
  if (int err = make_map(tq, q, p.B, p.Sq, p.H, p.D, p.qs, q_rows, kBf16)) {
    return err;
  }
  if (int err = make_map(tk, k, p.B, p.Sk, p.H, p.D, p.ks, k_rows, kBf16)) {
    return err;
  }
  if (int err = make_map(tv, v, p.B, p.Sk, p.H, p.D, p.vs, k_rows, kBf16)) {
    return err;
  }
  return make_map(tdo, dout, p.B, p.Sq, p.H, p.D, dout_strides(p), q_rows,
                  kBf16);
}

template <int DP>
int dkv_sm90(const Problem& p, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             const float* kv_valid, void* dk, void* dv) {
  CUtensorMap tq, tk, tv, tdo;
  if (int err = bwd_maps(p, q, k, v, dout, kDkvM, kDkvN, &tq, &tk, &tv,
                         &tdo)) {
    return err;
  }
  auto kernel = flash_bwd_dkv_bf16_sm90_kernel<DP>;
  static bool smem_set[kMaxDevices] = {};
  if (int err = allow_smem(kernel, DkvSmem<DP>::kBytes, smem_set)) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>(p.B * p.H),
                  static_cast<unsigned>((p.Sk + kDkvN - 1) / kDkvN));
  kernel<<<grid, kThreads, DkvSmem<DP>::kBytes, p.stream>>>(
      tq, tk, tv, tdo, lse, delta, kv_valid, static_cast<bf16_t*>(dk),
      static_cast<bf16_t*>(dv), p.H, p.Sq, p.Sk, p.D, p.scale, p.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int dq_sm90(const Problem& p, const void* q, const void* k, const void* v,
            const void* dout, const float* lse, const float* delta,
            const float* kv_valid, void* dq) {
  CUtensorMap tq, tk, tv, tdo;
  if (int err = bwd_maps(p, q, k, v, dout, kDqM, kDqN, &tq, &tk, &tv,
                         &tdo)) {
    return err;
  }
  auto kernel = flash_bwd_dq_bf16_sm90_kernel<DP>;
  static bool smem_set[kMaxDevices] = {};
  if (int err = allow_smem(kernel, DqSmem<DP>::kBytes, smem_set)) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>(p.B * p.H),
                  static_cast<unsigned>((p.Sq + kDqM - 1) / kDqM));
  kernel<<<grid, kDqThreads, DqSmem<DP>::kBytes, p.stream>>>(
      tq, tk, tv, tdo, lse, delta, kv_valid, static_cast<bf16_t*>(dq), p.H,
      p.Sq, p.Sk, p.D, p.scale, p.causal);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 only, D at most 128
int check(int B, int H, int Sq, int Sk, int D, int bf16) {
  if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
  return check_shape(B, H, Sq, Sk, D);
}

}  // namespace

extern "C" {

// The entry points for bfloat16 inputs (bf16 must be 1):
// each enqueues one kernel on `stream` and returns cudaGetLastError() as
// an int, 0 when the launch was accepted; cudaErrorMisalignedAddress when
// an input is not readable by TMA in place (the caller stages a copy).

int dpt_flash_fwd(const void* q, const void* k, const void* v,
                  const float* kv_valid, void* out, float* lse, int B,
                  int H, int Sq, int Sk, int D, long long qsb, long long qss,
                  long long qsh, long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh, float scale,
                  int causal, int bf16, void* stream) {
  if (int err = check(B, H, Sq, Sk, D, bf16)) return err;
  const Problem p = make_problem(B, H, Sq, Sk, D, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, scale, causal, stream);
  if (!inputs_readable(p, q, k, v, nullptr, kBf16)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return D <= 64 ? fwd_sm90<64>(p, q, k, v, kv_valid, out, lse)
                 : fwd_sm90<128>(p, q, k, v, kv_valid, out, lse);
}

int dpt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* kv_valid, void* dk, void* dv, int B,
                      int H, int Sq, int Sk, int D, long long qsb,
                      long long qss, long long qsh, long long ksb,
                      long long kss, long long ksh, long long vsb,
                      long long vss, long long vsh, float scale, int causal,
                      int bf16, void* stream) {
  if (int err = check(B, H, Sq, Sk, D, bf16)) return err;
  const Problem p = make_problem(B, H, Sq, Sk, D, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, scale, causal, stream);
  if (!inputs_readable(p, q, k, v, dout, kBf16)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return D <= 64 ? dkv_sm90<64>(p, q, k, v, dout, lse, delta, kv_valid, dk,
                                dv)
                 : dkv_sm90<128>(p, q, k, v, dout, lse, delta, kv_valid, dk,
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
  if (int err = check(B, H, Sq, Sk, D, bf16)) return err;
  const Problem p = make_problem(B, H, Sq, Sk, D, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, scale, causal, stream);
  if (!inputs_readable(p, q, k, v, dout, kBf16)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return D <= 64
             ? dq_sm90<64>(p, q, k, v, dout, lse, delta, kv_valid, dq)
             : dq_sm90<128>(p, q, k, v, dout, lse, delta, kv_valid, dq);
}

const char* dpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
