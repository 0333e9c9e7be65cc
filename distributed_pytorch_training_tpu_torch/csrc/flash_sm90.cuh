// What the Hopper (sm_90a) flash-attention kernels share: the JAX kernels'
// masks, mbarriers, TMA loads through 4-D tensor maps built on the host,
// and wgmma's shared-memory descriptors and fences. Included by
// flash_attention_sm90.cu (bfloat16 K3, K4, K5) and
// flash_attention_sm90_tf32.cu (float32 K3, K4, K5); everything is in an
// unnamed namespace, so each library holds its own copy. ops/build.py
// hashes this header into every library's name, so an edit here rebuilds
// both.
//
// Semantics every flash kernel keeps from the JAX kernels
// (distributed_pytorch_training_tpu/ops/flash_attention.py):
//   * masked logits are the float32 minimum (NEG_INF), not -inf: a row
//     whose keys are all masked gets p = 1 on every key of the k tiles it
//     visits and emits their mean(V), with lse = NEG_INF;
//   * keys past Sk (a ragged last tile) do not exist: their logit is -inf,
//     so p = 0 even in an all-masked row;
//   * causal alignment is top-left: row >= col on absolute indices from 0,
//     also when Sq != Sk; a causal k tile is live when its first key is at
//     or before the q tile's last row (the JAX `live` test);
//   * a key attends iff its kv_valid, when given ((B, Sk) float32), is > 0;
//   * the float32 forward scales q before the dot (:167); the bf16 forward
//     multiplies the bf16 inputs as they are and scales the float32 dot
//     (the two differ by float32 rounding only, and not at all at D 64,
//     scale 1/8); the backward scales the dot (:294, :341) and dS (:308,
//     :352);
//   * the backward re-masks (causal and kv_valid), so no gradient reaches a
//     masked key through a normal row;
//   * no atomics: every out, lse, dQ, dK and dV element is written once, by
//     the block that owns its row or key, so a run repeats bitwise.
// Inputs are (B, S, H, D), read through their batch, sequence and head
// strides (the last axis contiguous), so q, k and v can be views of one
// fused qkv tensor; out, dq, dk and dv are written contiguous in the input
// dtype, lse as (B*H, Sq) float32.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -FLT_MAX;  // NEG_INF of the JAX module
constexpr int kRows = 64;        // rows a consumer warpgroup owns (wgmma M)
constexpr int kRowBytes = 128;   // bytes of a TMA box row (SWIZZLE_128B)
// a barrier that has not completed after this many SM clocks (~8 s) traps:
// a launch error instead of a hung card
constexpr long long kSpinClocks = 1LL << 34;
constexpr unsigned kFullMask = 0xffffffffu;

// --------------------------------------------------------------------------
// the JAX kernels' masks
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

// the first 1024-byte boundary at or after p: a SWIZZLE_128B box repeats
// every 8 rows of 128 bytes
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// byte offset of the 16-byte chunk `chunk` of row `row` in a SWIZZLE_128B
// tile of 128-byte rows (TMA's and wgmma's B128 layout: the chunk index
// XOR the row's position in its group of 8)
__device__ __forceinline__ int sw128_offset(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

// Shared memory that threads wrote, made visible to the async proxy
// (wgmma's operand reads); a barrier between the writers and the issuing
// warpgroups follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// wgmma: descriptors, fences
// --------------------------------------------------------------------------

// Shared-memory matrix descriptor of a SWIZZLE_128B tile at `addr` (1024-
// byte aligned rows of 128 bytes, 8-row groups 1024 bytes apart: the
// stride byte offset). `lbo`: bytes to the next box of an MN-major
// operand; unused by a K-major one, whose 32-byte deep slices start 32
// bytes apart inside a row.
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

// --------------------------------------------------------------------------
// host: tensor maps, launch set-up
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

// Whether TMA reads a (B, S, H, D) tensor of `elem`-byte elements (2:
// bfloat16, 4: float32) at `x` in place: 16-byte aligned, every stride of
// an axis longer than 1 a multiple of 16 bytes, and rows of whole 16-byte
// chunks (ops/flash_attention.py's needs_staged_copy is the same rule).
bool tma_readable(const void* x, int B, int S, int H, int D,
                  const Strides& st, int elem) {
  auto ok = [elem](int n, long long stride) {
    return n == 1 || stride * elem % 16 == 0;
  };
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && D * elem % 16 == 0 &&
         ok(B, st.b) && ok(S, st.s) && ok(H, st.h);
}

// A 4-D tensor map over (D, H, S, B) of a tensor of `elem`-byte elements:
// boxes of 128 bytes of a row (64 bf16 or 32 float32 columns), one head,
// `rows` rows and one batch row, SWIZZLE_128B, zeros outside. An axis of
// length 1 gets a packed stride (it is never stepped).
int make_map(CUtensorMap* map, const void* x, int B, int S, int H, int D,
             const Strides& st, int rows, int elem) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t e = static_cast<cuuint64_t>(elem);
  const cuuint64_t sh = H > 1 ? st.h * e : e * D;
  const cuuint64_t ss = S > 1 ? st.s * e : sh * H;
  const cuuint64_t sb = B > 1 ? st.b * e : ss * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {sh, ss, sb};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kRowBytes / elem), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map,
      elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(x), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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

// D at most 128; a shape the kernels refuse returns cudaErrorInvalidValue
int check_shape(int B, int H, int Sq, int Sk, int D) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128) {
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

// dO's strides: the wrappers pass it contiguous
Strides dout_strides(const Problem& p) {
  const long long hd = (long long)p.H * p.D;
  return Strides{(long long)p.Sq * hd, hd, p.D};
}

// q, k, v and the contiguous dO (when given) readable by TMA in place
bool inputs_readable(const Problem& p, const void* q, const void* k,
                     const void* v, const void* dout, int elem) {
  return tma_readable(q, p.B, p.Sq, p.H, p.D, p.qs, elem) &&
         tma_readable(k, p.B, p.Sk, p.H, p.D, p.ks, elem) &&
         tma_readable(v, p.B, p.Sk, p.H, p.D, p.vs, elem) &&
         (dout == nullptr ||
          tma_readable(dout, p.B, p.Sq, p.H, p.D, dout_strides(p), elem));
}

}  // namespace
