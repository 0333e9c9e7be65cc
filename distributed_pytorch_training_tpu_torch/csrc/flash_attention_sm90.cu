// FlashAttention forward (K3) and dK/dV (K4) for bfloat16 inputs, written
// for Hopper (sm_90a): two consumer warpgroups run every product as
// wgmma, fed through rings of shared-memory tiles that TMA fills, with
// full/empty mbarrier pairs between the copies and the products.
//
// Replace the Pallas TPU kernels of
//   distributed_pytorch_training_tpu/ops/flash_attention.py
// for bfloat16 inputs:
//   flash_fwd_bf16_sm90_kernel     <- _flash_fwd_lse (:199), body
//                                     _fwd_kernel (:146), pallas_call :232
//   flash_bwd_dkv_bf16_sm90_kernel <- _flash_bwd (:360), body
//                                     _bwd_dkv_kernel (:269), pallas_call :400
// float32 inputs, and dQ (K5) in both types, stay with
// flash_attention.cu's mma.sync kernels. The C entry points dpt_flash_fwd
// and dpt_flash_bwd_dkv have flash_attention.cu's signatures and take
// bfloat16 (bf16 = 1) only.
//
// Semantics and arithmetic are flash_attention.cu's bf16 kernels' (its
// header): masked logits are NEG_INF (the float32 minimum), keys past Sk
// are -inf, causal is top-left; S multiplies the bf16 inputs as they are
// (exact products, float32 sums) and is scaled in float32 after the dot
// (the backward scales the dot and dS as the JAX kernel does); a tile pair
// that no mask bites (needs_mask) takes no mask test, and the masks are
// selects, not branches; exp(x) is exp2f(x log2 e) with no flush-to-zero;
// m and l are float32, l summed over the float32 P, floored at 1e-30; P
// (K4: P^T and dS^T) is rounded once to bf16, to nearest even, into the
// next product's A operand; O, dK and dV accumulate in float32; lse = m +
// log l; out = O (1 / l). An all-masked row (every key masked by kv_valid
// or causality) averages V over the keys of the k tiles its q tile visits,
// which depends on the tile sizes below: such a row has no weight in any
// loss, and the checks compare only rows with a live key.
//
// Bound on the card (NVIDIA H100 SXM, 989 TFLOP/s dense bf16, 3.35 TB/s,
// NVIDIA's data sheet): at GPT-2 124M's shape (B 8, S 1024, H 12, D 64,
// causal) the forward does 12.9 GFLOP (0.013 ms) against 0.015 ms of
// bytes, dK/dV 25.8 GFLOP (0.026 ms) against 0.023 ms: K3 is bound by
// bytes, K4 by operations, both by a hair. The exponentials are a third
// limit: the SM's 16 ex2 a clock take as long as the forward's products
// at D 64, and with the scale, the subtraction of the max, exp2f's
// no-flush-to-zero range fix, the max and the sum, the softmax issues
// about 9 instructions an element, which is what bounds this forward.
//
// Block (both kernels): 256 threads, two consumer warpgroups. Each owns 64
// rows of the block's tile (one wgmma M slice); thread 0 also issues every
// TMA copy. Registers: 8 warps, 2 on each SM sub-partition (16,384
// registers each), so ptxas may give a thread 255, and the kernels use
// 212 (K3) and 189 (K4) at D 64 with no spill. A producer warp or
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
// for this tile's dV and dK. dQ stays with K5, as in the JAX package.
// Registers a thread: S^T, dP^T, dK, dV 32 each and P^T, dS^T 16 each at
// D 64 (64 each for dK and dV at D 128). Shared memory: K and V 32 KB (64
// KB) + 4 stages x (Q + dO + lse + delta) 16.5 KB (32.5 KB) = 98 KB (194
// KB).

#include <cfloat>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16_t = __nv_bfloat16;

constexpr float kNegInf = -FLT_MAX;  // NEG_INF of the JAX module
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers;
constexpr int kRows = 64;        // rows a consumer warpgroup owns (wgmma M)
constexpr int kBoxCols = 64;     // bf16 columns of a TMA box: 128 bytes
constexpr int kRowBytes = 128;   // shared-memory bytes of a box row
constexpr int kFwdStages = 3;    // ring stages of K and V in the forward
constexpr int kDkvStages = 4;    // of Q, dO, lse and delta in dK/dV
constexpr int kFwdM = kConsumers * kRows;  // q rows of a forward block
constexpr int kFwdN = 128;                 // keys of a forward k tile
constexpr int kDkvN = kConsumers * kRows;  // keys of a dK/dV block
constexpr int kDkvM = 64;                  // q rows of a dK/dV q tile
// a barrier that has not completed after this many SM clocks (~8 s) traps:
// a launch error instead of a hung card
constexpr long long kSpinClocks = 1LL << 34;

// --------------------------------------------------------------------------
// arithmetic kept from flash_attention.cu's bf16 kernels
// --------------------------------------------------------------------------

// The logit after the JAX kernels' masks, with selects and no branch:
// keys past Sk do not exist (-inf); a key after the row under causal, or
// whose kv_valid `kv` is not > 0, is masked (NEG_INF).
__device__ __forceinline__ float masked(float s, int row, int col, int Sk,
                                        bool causal, float kv) {
  const float m = (causal && col > row) || !(kv > 0.0f) ? kNegInf : s;
  return col >= Sk ? -INFINITY : m;
}

// kv_valid of key `col` (1 without kv_valid; a key past Sk reads the last
// one, which masked() overrides)
__device__ __forceinline__ float kv_of(const float* kvm, int col, int Sk) {
  return kvm != nullptr ? kvm[min(col, Sk - 1)] : 1.0f;
}

// Whether the tile pair (`rows` q rows from q0, `cols` keys from k0) needs
// any mask: a tile wholly below the causal diagonal, inside both lengths
// and without kv_valid, takes p = exp(s - m) directly.
__device__ __forceinline__ bool needs_mask(int q0, int rows, int k0,
                                           int cols, int Sq, int Sk,
                                           bool causal, bool has_kvm) {
  return has_kvm || q0 + rows > Sq || k0 + cols > Sk ||
         (causal && k0 + cols - 1 > q0);
}

__device__ __forceinline__ float exp_bf16(float x) {
  return exp2f(x * kLog2e);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
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
// mbarriers, TMA
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA traffic before the phase
// completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (bool first = true;; first = false) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (first) {
      start = clock64();
    } else if (clock64() - start > kSpinClocks) {
      __trap();
    }
  }
}

// A consumer warp is done with a stage: its lane 0 arrives for the warp.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// One TMA box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into
// shared memory at `dst`, counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the first 1024-byte boundary at or after p: a SWIZZLE_128B box repeats
// every 8 rows of 128 bytes
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// --------------------------------------------------------------------------
// wgmma
// --------------------------------------------------------------------------

// Shared-memory matrix descriptor of a SWIZZLE_128B tile at `addr` (1024-
// byte aligned rows of 128 bytes, 8-row groups 1024 bytes apart: the
// stride byte offset). `lbo`: bytes to the next 64 columns of an MN-major
// operand (its second box); unused by a K-major one, whose 16-deep slices
// start 32 bytes apart inside a row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma writes or reads: no access to
// them moves across this point (placed after a wait, and around issues).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[j][c])::"memory");
  }
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(a[j][c])::"memory");
  }
}

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

// 4 bytes from global to shared memory without the registers (zeros when
// `valid` is false)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

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
// launchers
// --------------------------------------------------------------------------

struct Strides {  // element strides of a (B, S, H, D) tensor; D's is 1
  long long b, s, h;
};

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query: the library links the CUDA runtime alone
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Whether TMA reads a (B, S, H, D) bf16 tensor at `x` in place: 16-byte
// aligned, every stride of an axis longer than 1 a multiple of 16 bytes,
// and D a multiple of 8 (ops/flash_attention.py's needs_staged_copy is the
// same rule).
bool tma_readable(const void* x, int B, int S, int H, int D,
                  const Strides& st) {
  auto ok = [](int n, long long stride) { return n == 1 || stride % 8 == 0; };
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && D % 8 == 0 &&
         ok(B, st.b) && ok(S, st.s) && ok(H, st.h);
}

// A 4-D tensor map over (D, H, S, B) of a bf16 tensor: boxes of 64
// columns, one head, `rows` rows and one batch row, SWIZZLE_128B, zeros
// outside. An axis of length 1 gets a packed stride (it is never stepped).
int make_map(CUtensorMap* map, const void* x, int B, int S, int H, int D,
             const Strides& st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t sh = H > 1 ? st.h * 2 : 2ull * D;
  const cuuint64_t ss = S > 1 ? st.s * 2 : sh * H;
  const cuuint64_t sb = B > 1 ? st.b * 2 : ss * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {sh, ss, sb};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBoxCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Raise the kernel's dynamic shared-memory limit (above 48 KB it must be
// asked for) and its shared-memory carveout, once a device (`done`, one
// flag a device, belongs to the kernel); 0 when accepted.
constexpr int kMaxDevices = 64;

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kMaxDevices && done[device]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
  }
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return static_cast<int>(err);
}

struct Problem {
  int B, H, Sq, Sk, D;
  Strides qs, ks, vs;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int DP>
int fwd_sm90(const Problem& p, const void* q, const void* k, const void* v,
             const float* kv_valid, void* out, float* lse) {
  CUtensorMap tq, tk, tv;
  if (int err = make_map(&tq, q, p.B, p.Sq, p.H, p.D, p.qs, kFwdM)) return err;
  if (int err = make_map(&tk, k, p.B, p.Sk, p.H, p.D, p.ks, kFwdN)) return err;
  if (int err = make_map(&tv, v, p.B, p.Sk, p.H, p.D, p.vs, kFwdN)) return err;
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

template <int DP>
int dkv_sm90(const Problem& p, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             const float* kv_valid, void* dk, void* dv) {
  const long long hd = (long long)p.H * p.D;  // dO is contiguous
  const Strides dos{(long long)p.Sq * hd, hd, p.D};
  CUtensorMap tq, tk, tv, tdo;
  if (int err = make_map(&tq, q, p.B, p.Sq, p.H, p.D, p.qs, kDkvM)) return err;
  if (int err = make_map(&tk, k, p.B, p.Sk, p.H, p.D, p.ks, kDkvN)) return err;
  if (int err = make_map(&tv, v, p.B, p.Sk, p.H, p.D, p.vs, kDkvN)) return err;
  if (int err = make_map(&tdo, dout, p.B, p.Sq, p.H, p.D, dos, kDkvM)) {
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

// bfloat16 only, D at most 128
int check(int B, int H, int Sq, int Sk, int D, int bf16) {
  if (!bf16 || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

Problem make_problem(int B, int H, int Sq, int Sk, int D, long long qsb,
                     long long qss, long long qsh, long long ksb,
                     long long kss, long long ksh, long long vsb,
                     long long vss, long long vsh, float scale, int causal,
                     void* stream) {
  return Problem{B, H, Sq, Sk, D, Strides{qsb, qss, qsh},
                 Strides{ksb, kss, ksh}, Strides{vsb, vss, vsh}, scale,
                 causal, static_cast<cudaStream_t>(stream)};
}

bool inputs_readable(const Problem& p, const void* q, const void* k,
                     const void* v) {
  return tma_readable(q, p.B, p.Sq, p.H, p.D, p.qs) &&
         tma_readable(k, p.B, p.Sk, p.H, p.D, p.ks) &&
         tma_readable(v, p.B, p.Sk, p.H, p.D, p.vs);
}

}  // namespace

extern "C" {

// flash_attention.cu's entry points for bfloat16 inputs (bf16 must be 1):
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
  if (!inputs_readable(p, q, k, v)) {
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
  const long long hd = (long long)H * D;
  if (!inputs_readable(p, q, k, v) ||
      !tma_readable(dout, B, Sq, H, D, Strides{(long long)Sq * hd, hd, D})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return D <= 64 ? dkv_sm90<64>(p, q, k, v, dout, lse, delta, kv_valid, dk,
                                dv)
                 : dkv_sm90<128>(p, q, k, v, dout, lse, delta, kv_valid, dk,
                                 dv);
}

const char* dpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
