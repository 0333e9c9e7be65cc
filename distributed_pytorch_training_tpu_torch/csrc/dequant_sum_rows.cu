// Column sums of dequantized int8 rows, (n, s) s8 x (n,) f32 -> (s,) f32,
// for Hopper.
//
// Replaces the Pallas TPU kernel
//   distributed_pytorch_training_tpu/ops/quantize.py::dequant_sum_rows_fused
//   (body _dequant_sum_kernel),
// the receive-side accumulate of every int8 gradient wire
// (parallel/grad_sync.py: the gather-form int8 sum, the multihop hop-1
// partial sum). It computes
//
//   out[j] = sum_{i = 0 .. n-1} float(q[i, j]) * scales[i]
//
// with one fixed order of operations, the one the JAX package's compiled
// codec uses and the plain PyTorch version (ops/quantize.py::
// dequant_sum_rows_ref) reproduces:
//
//   acc = 0.0f;  for i in 0 .. n-1:  acc = fmaf(float(q[i, j]), scales[i], acc)
//
// XLA fuses the multiply and the row sum of `jnp.sum(q * s[:, None], 0)`
// into this chain of fused multiply-adds inside a compiled step (measured
// on XLA:CPU: bitwise for n = 2, 3 and 8), so each step is __fmaf_rn, one
// rounding, never a separate multiply and add. The plain version emulates
// fmaf exactly (float64 with round-to-odd), so kernel and plain version
// are bitwise equal, and both bitwise equal to the reference. Starting
// from 0.0f, as XLA's reduction does, gives +0.0 for a -0.0 first product.
//
// Bound on the card: memory. Per column it reads n bytes of codes and
// writes 4 bytes; the n scales are read once. The arithmetic (a convert and
// an fma per code) is far below the H100's ratio of operations to bytes.
// At the int8 wire's (2, 11,181,642) that is ~67 MB, ~0.020 ms at
// 3.35 TB/s; at the wires' n = 2 the float32 output is 2/3 of the bytes.
//
// Two variants; the wrapper's launch plan (ops/quantize.py::dequant_plan)
// picks one with its tile and grid, and ops/quantize.py::
// staged_span and ragged_codes are this file's span rules in Python, which
// the CPU tests hold to the conditions below.
//
// * Staged, n <= kMaxStagedRows (8: the world sizes and int8_hier's
//   slices; every main-path shape). A persistent grid of a few 256-thread
//   blocks an SM walks column tiles of T columns (T a multiple of 16, up to
//   4096, about 8 KB of codes a tile), tile b, b + grid, ... Warp 0
//   stages each tile's rows with 1-D bulk async copies (cp.async.bulk, no
//   tensor map; lane i issues row i's, so the spans are worked out side by
//   side) into a ring of kStages (4) stages, one mbarrier a stage
//   carrying the stage's bytes (expect_tx); the first stages are issued
//   at entry, beside the scales' load. A row's copy is its span
//   [row_i + c0, row_i + c0 + w) widened out to 16-byte boundaries, the
//   alignment a bulk copy needs, and clipped to the 16-byte-aligned part
//   of q's storage [lo, hi) that the wrapper passes, so no copy reads a
//   byte outside the storage. The few codes a clipped copy cannot reach
//   (at most 15 at the storage's start and 15 at its end) are read by the
//   row's warp from global memory into the same slot (stage_ragged). So
//   neither s mod 16 nor a view's byte offset decides the path: each
//   thread reads its 4 columns of a row from shared memory at that row's
//   own offset (p & 15), as two 4-byte words joined by a funnel shift (a
//   warp's 32 words are consecutive: no bank conflict), with no branch on
//   the alignment. Each thread keeps its columns' sums in registers, rows
//   in order, and writes them with 16-byte streaming stores (__stcs on
//   float4, the output being 16-byte aligned and T a multiple of 4): the
//   sums leave registers once, where a bulk store would first write them
//   to shared memory and fence the async proxy. A block barrier after each
//   tile frees its stage before warp 0 copies the block's tile kStages
//   ahead into it. A launch of one tile a block issues its copies at entry
//   and waits for one round trip to memory.
// * Generic, n > kMaxStagedRows (no main path): a thread owns 4
//   neighbouring columns and walks the rows in order, loading one char4
//   a row (scalar bytes when s % 4 or q's alignment forbid it), scales
//   staged in shared memory, a grid-stride loop over s.
//
// Both variants sum every column in one thread, rows 0..n-1 in order: no
// atomics and no state across blocks.

#include <cstdint>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"  // smem_u32, mbar_*, fence_proxy_async

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedRows = 8;
constexpr int kStages = 4;  // the ring's stages
constexpr int kGroupsPerThread = 4;  // 4-column groups a thread owns a tile
constexpr long long kMaxTile = 4LL * kGroupsPerThread * kThreads;  // 4096
// the generic variant stages the n scales in 48 KB of shared memory
constexpr long long kMaxRows = 12288;

__device__ __forceinline__ float madd(float acc, int8_t code, float scale) {
  return __fmaf_rn(static_cast<float>(code), scale, acc);
}

// One 1-D bulk copy of `bytes` (a multiple of 16) from 16-byte aligned
// global memory into 16-byte aligned shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A row's staged span in tile c0: the row's w bytes from p widened out to
// 16-byte boundaries, [a, b), clipped to [lo16, hi16), the 16-byte-aligned
// part of q's storage, giving [c_lo, c_hi) (empty when c_lo >= c_hi). The
// copy lands at offset c_lo - a of the row's slot, so byte p + j is at slot
// offset (p & 15) + j. ops/quantize.py::staged_span is this rule.
struct Span {
  uintptr_t a, c_lo, c_hi;
};

__device__ __forceinline__ Span staged_span(uintptr_t p, long long w,
                                            uintptr_t lo16, uintptr_t hi16) {
  Span sp;
  sp.a = p & ~uintptr_t{15};
  const uintptr_t b = (p + static_cast<uintptr_t>(w) + 15) & ~uintptr_t{15};
  sp.c_lo = sp.a > lo16 ? sp.a : lo16;
  sp.c_hi = b < hi16 ? b : hi16;
  return sp;
}

// Warp 0: lane i < n copies row i of the tile of columns [c0, c0 + w)
// into its slot of a ring stage, after lane 0 has armed the stage's
// barrier `bar` with the copies' bytes. Each row's span on its own lane:
// a one-tile launch waits for one span's arithmetic, not n. Each copying
// lane first fences the stage's earlier generic reads (the tile that used
// it before) against its copy.
__device__ __forceinline__ void issue_tile(
    const int8_t* q, long long n, long long s, long long c0, long long w,
    uintptr_t lo16, uintptr_t hi16, unsigned char* stage, int slot,
    uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  Span sp{0, 0, 0};
  uint32_t bytes = 0;
  if (lane < n) {
    sp = staged_span(reinterpret_cast<uintptr_t>(q + lane * s + c0), w,
                     lo16, hi16);
    if (sp.c_lo < sp.c_hi) bytes = static_cast<uint32_t>(sp.c_hi - sp.c_lo);
  }
  const uint32_t total = __reduce_add_sync(kFullMask, bytes);
  if (lane == 0) mbar_expect_tx(bar, total);
  __syncwarp();
  if (bytes != 0) {
    fence_proxy_async();
    bulk_load(stage + lane * slot + (sp.c_lo - sp.a),
              reinterpret_cast<const void*>(sp.c_lo), bytes, bar);
  }
}

// Warp i, for row i of the tile of columns [c0, c0 + w) in ring stage
// `stage`: the codes the row's copy cannot reach, outside [c_lo, c_hi) (at
// most 15 at the storage's start and 15 at its end), read from global
// memory into the row's slot, lanes 0-15 the head, 16-31 the tail. Each
// writer then fences its write against the bulk copies that later reuse
// the stage. A block barrier makes them visible before the tile is read.
__device__ __forceinline__ void stage_ragged(
    const int8_t* q, long long n, long long s, long long c0, long long w,
    uintptr_t lo16, uintptr_t hi16, unsigned char* stage, int slot) {
  const int i = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const uintptr_t p = reinterpret_cast<uintptr_t>(q + i * s + c0);
  const uintptr_t end = p + static_cast<uintptr_t>(w);
  const Span sp = staged_span(p, w, lo16, hi16);
  const uintptr_t head_end = sp.c_lo < end ? sp.c_lo : end;
  uintptr_t tail = sp.c_hi > sp.c_lo ? sp.c_hi : sp.c_lo;
  tail = tail > p ? tail : p;
  const uintptr_t at = lane < 16 ? p + lane : tail + (lane - 16);
  if (lane < 16 ? at < head_end : at < end) {
    stage[i * slot + (at - sp.a)] =
        *reinterpret_cast<const unsigned char*>(at);
    fence_proxy_async();
  }
}

// the 4 codes of a little-endian word, as floats
__device__ __forceinline__ float code_of(uint32_t v, int k) {
  return static_cast<float>(static_cast<int8_t>(v >> (8 * k)));
}

// This thread's columns of the tile [c0, c0 + w): the sums over the rows
// staged in `stage` (a slot of tile + 16 bytes a row, code p + j of a row
// at p at slot offset (p & 15) + j), rows in order, stored to out. Thread
// t owns the 4-column groups t + g * kThreads.
__device__ __forceinline__ void sum_tile(
    const int8_t* q, const float* row_scale, float* __restrict__ out,
    long long n, long long s, long long c0, int w,
    const unsigned char* stage, int slot) {
  float acc[kGroupsPerThread][4];
  bool live[kGroupsPerThread];  // the group has columns in the tile
#pragma unroll
  for (int g = 0; g < kGroupsPerThread; ++g) {
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.0f;
    live[g] = 4 * (static_cast<int>(threadIdx.x) + g * kThreads) < w;
  }
  for (long long i = 0; i < n; ++i) {
    const int off =
        static_cast<int>(reinterpret_cast<uintptr_t>(q + i * s + c0) & 15);
    const float sc = row_scale[i];
    // this thread's first word of the row's slot, and the funnel shift
    // that aligns its codes
    const uint32_t* words =
        reinterpret_cast<const uint32_t*>(stage + i * slot) + (off >> 2) +
        threadIdx.x;
    const int shift = 8 * (off & 3);
#pragma unroll
    for (int g = 0; g < kGroupsPerThread; ++g) {
      if (live[g]) {
        const uint32_t v = __funnelshift_r(words[g * kThreads],
                                           words[g * kThreads + 1], shift);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[g][e] = __fmaf_rn(code_of(v, e), sc, acc[g][e]);
        }
      }
    }
  }
  float* dst = out + c0 + 4 * threadIdx.x;
#pragma unroll
  for (int g = 0; g < kGroupsPerThread; ++g) {
    const int col = 4 * (static_cast<int>(threadIdx.x) + g * kThreads);
    if (col + 4 <= w) {
      __stcs(reinterpret_cast<float4*>(dst + g * 4 * kThreads),
             make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]));
    } else if (live[g]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < w) dst[g * 4 * kThreads + e] = acc[g][e];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    dequant_sum_rows_staged_kernel(const int8_t* __restrict__ q,
                                   const float* __restrict__ scales,
                                   float* __restrict__ out, long long n,
                                   long long s, long long tile, int tiles,
                                   uintptr_t lo16, uintptr_t hi16) {
  // ring: kStages x n slots of tile + 16 bytes (a multiple of 16), then
  // the stages' barriers, then the n scales
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = static_cast<int>(tile) + 16;
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * n * slot);
  float* row_scale = reinterpret_cast<float*>(full + kStages);

  // 32-bit tile counts (the launcher refuses 2^31 tiles or more): a
  // 64-bit division is a long subroutine, which a one-tile launch would wait
  // for
  const int grid = static_cast<int>(gridDim.x);
  const int my_tiles =
      (tiles - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  auto columns = [&](int k, long long* c0) {
    *c0 = (blockIdx.x + static_cast<long long>(k) * grid) * tile;
    return s - *c0 < tile ? s - *c0 : tile;
  };

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < kStages; ++st) mbar_init(full + st, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int k = 0; k < kStages && k < my_tiles; ++k) {
      long long c0;
      const long long w = columns(k, &c0);
      issue_tile(q, n, s, c0, w, lo16, hi16, ring + k * n * slot, slot,
                 full + k);
    }
  }
  for (int k = 0; k < kStages && k < my_tiles; ++k) {
    long long c0;
    const long long w = columns(k, &c0);
    stage_ragged(q, n, s, c0, w, lo16, hi16, ring + k * n * slot, slot);
  }
  if (threadIdx.x < n) row_scale[threadIdx.x] = scales[threadIdx.x];
  __syncthreads();

  int st = 0;           // the ring stage of tile k
  uint32_t phase = 0;   // its barrier's phase parity
  for (int k = 0; k < my_tiles; ++k) {
    long long c0;
    const long long w = columns(k, &c0);
    mbar_wait(full + st, phase);
    sum_tile(q, row_scale, out, n, s, c0, static_cast<int>(w),
             ring + st * n * slot, slot);
    // every thread is done with stage st: refill it with the block's tile
    // kStages ahead (its ragged codes are read before the barrier that ends
    // the next tile, kStages >= 2)
    __syncthreads();
    if (k + kStages < my_tiles) {
      long long c1;
      const long long w1 = columns(k + kStages, &c1);
      if (threadIdx.x < 32) {
        issue_tile(q, n, s, c1, w1, lo16, hi16, ring + st * n * slot, slot,
                   full + st);
      }
      stage_ragged(q, n, s, c1, w1, lo16, hi16, ring + st * n * slot, slot);
    }
    if (++st == kStages) {
      st = 0;
      phase ^= 1;
    }
  }
}

template <bool kVector>
__global__ void dequant_sum_rows_kernel(const int8_t* __restrict__ q,
                                        const float* __restrict__ scales,
                                        float* __restrict__ out, long long n,
                                        long long s) {
  extern __shared__ float row_scale[];
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    row_scale[i] = scales[i];
  }
  __syncthreads();

  const long long groups = (s + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const long long col = 4 * g;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    if (kVector) {
      // s % 4 == 0 and q 4-byte aligned: every row's char4 is aligned
      for (long long i = 0; i < n; ++i) {
        const char4 c = *reinterpret_cast<const char4*>(q + i * s + col);
        const float sc = row_scale[i];
        a0 = madd(a0, c.x, sc);
        a1 = madd(a1, c.y, sc);
        a2 = madd(a2, c.z, sc);
        a3 = madd(a3, c.w, sc);
      }
      *reinterpret_cast<float4*>(out + col) = make_float4(a0, a1, a2, a3);
    } else {
      const long long width = s - col < 4 ? s - col : 4;
      for (long long i = 0; i < n; ++i) {
        const int8_t* row = q + i * s + col;
        const float sc = row_scale[i];
        a0 = madd(a0, row[0], sc);
        if (width > 1) a1 = madd(a1, row[1], sc);
        if (width > 2) a2 = madd(a2, row[2], sc);
        if (width > 3) a3 = madd(a3, row[3], sc);
      }
      out[col] = a0;
      if (width > 1) out[col + 1] = a1;
      if (width > 2) out[col + 2] = a2;
      if (width > 3) out[col + 3] = a3;
    }
  }
}

}  // namespace

extern "C" {

// Launches the variant of the wrapper's launch plan on `stream` (a
// cudaStream_t passed as a pointer) and returns cudaGetLastError() as an
// int: 0 when the launch was accepted, cudaErrorInvalidValue for a plan
// the kernels do not take. `staged` != 0 runs the staged variant over
// `blocks` blocks walking column tiles of `tile` columns; [lo, hi) is q's
// storage, which its copies stay inside. The caller guarantees n >= 1,
// s >= 1, and a 16-byte aligned `out` (torch's allocator gives 256).
int dpt_dequant_sum_rows(const int8_t* q, const float* scales, float* out,
                         long long n, long long s, int staged,
                         long long tile, long long blocks, const void* lo,
                         const void* hi, void* stream) {
  if (n <= 0 || s <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks <= 0 || blocks > (1LL << 31) - 1 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (staged) {
    const long long tiles = (s + tile - 1) / (tile > 0 ? tile : 1);
    const size_t smem = static_cast<size_t>(kStages * n * (tile + 16)) +
                        kStages * sizeof(uint64_t) + n * sizeof(float);
    if (n > kMaxStagedRows || tile <= 0 || tile % 16 != 0 ||
        tile > kMaxTile || tiles >= (1LL << 31) || blocks > tiles ||
        smem > 48 * 1024) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const uintptr_t lo16 = (reinterpret_cast<uintptr_t>(lo) + 15) &
                           ~uintptr_t{15};
    const uintptr_t hi16 = reinterpret_cast<uintptr_t>(hi) & ~uintptr_t{15};
    dequant_sum_rows_staged_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                     smem, st>>>(
        q, scales, out, n, s, tile, static_cast<int>(tiles), lo16, hi16);
    return static_cast<int>(cudaGetLastError());
  }
  if (n > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const bool vector =
      s % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  if (vector) {
    dequant_sum_rows_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                    smem, st>>>(q, scales, out, n, s);
  } else {
    dequant_sum_rows_kernel<false><<<static_cast<unsigned>(blocks), kThreads,
                                     smem, st>>>(q, scales, out, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
