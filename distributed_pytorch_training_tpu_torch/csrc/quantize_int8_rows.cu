// Row-wise symmetric int8 quantization of an (n, s) fp32 matrix, for Hopper.
//
// Replaces the Pallas TPU kernel
//   distributed_pytorch_training_tpu/ops/quantize.py::quantize_int8_rows_fused
//   (body _quantize_kernel),
// and computes exactly what its reference computes
// (parallel/grad_sync.py::_quantize_int8_rows, fused=False):
//
//   amax[r]  = max_j |x[r, j]|
//   scale[r] = max(amax[r], 1e-30f) * (1.0f / 127.0f)      (a multiply)
//   q[r, j]  = clip(round_half_even(x[r, j] / scale[r]), -127, 127)
//
// Bitwise equality with the reference rests on three details:
//   * the code step is an IEEE division (__fdiv_rn), never a reciprocal
//     multiply; build without --use_fast_math and without -ftz=true;
//   * rounding is round-half-to-even (rintf), as jnp.round and torch.round;
//   * the scale is the product amax * (1/127), floored at 1e-30f.
// A max over |x| is exact and order-free, so the reduction order, and how a
// row is split between blocks, is free.
// Inputs are finite: fmaxf drops a NaN where the reference would propagate it.
//
// Bound on the card: memory. Per element it reads 4 B and writes 1 B, and
// per row it writes one 4 B scale: 5 B an element, 0.0167 ms at (1,
// 11,181,642) at 3.35 TB/s. The arithmetic (abs, max, divide, round, clamp)
// is a handful of fp32 operations per 5 B moved, far below the H100's ratio
// of operations to bytes. Two passes over a row that is split between
// blocks read the input twice, ~9 B an element (~0.030 ms at that shape):
// the practical floor, unless the 44.7 MB row stays in the 50 MB L2
// between the passes.
//
// Design. The Pallas kernel's two phases (a running absmax over lane
// blocks, then the codes) need the whole row's max before any code, and
// the TPU's grid carries it from step to step; here blocks run in parallel
// and carry nothing. Three tilings, chosen from the shape (the wrapper's
// ops/quantize.py::chunks_per_row splits a row or not; the launcher picks
// the one-row tiling by width), with the same bits:
//   * many short rows (most of the serving path's weight matrices, 64 and
//     768 columns): one warp a row, the row held in registers (up to 1024
//     columns), so the input is read once; the max reduces by shuffles;
//   * many longer rows: one block a row, grid-striding over rows; pass 1
//     takes the row's |x| max, reduced by warp shuffles and across warps
//     through shared memory, and pass 2 reads the row again (from L1/L2)
//     and writes the codes;
//   * few long rows (the int8 gradient wires quantize a whole bucket, up to
//     11,181,642 floats, as one row): a 2-D grid of (column chunk, row),
//     enough blocks to fill the card. Launch 1 writes each block's partial
//     max to a scratch of (n, chunks) floats; launch 2, on the same stream,
//     reduces its row's partials, forms the scale exactly as above and
//     writes its chunk's codes; chunk 0 writes scales[row]. A single long
//     row no longer runs on one SM.
// Loads are 16 bytes (float4) and code stores 4 bytes (char4): each row
// starts at its own alignment (row 1 of a (2, 5,590,821) matrix starts 4
// bytes past a 16-byte boundary), so each row takes a scalar head of up to
// three elements to reach a 16-byte boundary, a float4 body and a scalar
// tail; the codes of the body are stored as char4 where their address is
// 4-byte aligned, byte by byte otherwise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRowVecs = 8;                   // float4s a lane holds
constexpr long long kShortRow = 32 * 4 * kRowVecs;  // a warp's row: 1024
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

// Max over the block, returned to every thread. `partial` is rewritten by
// the next call: a __syncthreads must come between two calls.
__device__ __forceinline__ float block_max(float m, float* partial) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  m = warp_max(m);
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  return warp_max(lane < static_cast<int>(blockDim.x >> 5) ? partial[lane]
                                                           : 0.0f);
}

__device__ __forceinline__ float scale_of(float amax) {
  return fmaxf(amax, 1e-30f) * (1.0f / 127.0f);
}

__device__ __forceinline__ int8_t code_of(float x, float scale) {
  float c = rintf(__fdiv_rn(x, scale));
  c = fminf(fmaxf(c, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(c));
}

__device__ __forceinline__ float absmax4(float4 a) {
  return fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fmaxf(fabsf(a.z), fabsf(a.w)));
}

// One row: a scalar head of `head` (< 4) elements up to a 16-byte boundary
// of x, `nvec` float4s, and a scalar tail from `tail0` to s.
struct Row {
  const float* x;
  int8_t* q;
  long long s, head, nvec, tail0;
  bool q4;  // the body's codes start on a 4-byte boundary
};

__device__ __forceinline__ Row row_of(const float* x, int8_t* q,
                                      long long row, long long s) {
  Row r;
  r.x = x + row * s;
  r.q = q + row * s;
  r.s = s;
  const long long off = (reinterpret_cast<uintptr_t>(r.x) >> 2) & 3;
  r.head = min(s, (4 - off) & 3);
  r.nvec = (s - r.head) >> 2;
  r.tail0 = r.head + 4 * r.nvec;
  r.q4 = ((reinterpret_cast<uintptr_t>(r.q) + r.head) & 3) == 0;
  return r;
}

// f(i, x4[i]) for the body's float4s i in [v0, v1), strided by the block,
// four loads in flight a thread
template <typename F>
__device__ __forceinline__ void for_each_vec(const Row& r, long long v0,
                                             long long v1, F f) {
  const float4* x4 = reinterpret_cast<const float4*>(r.x + r.head);
  const long long step = blockDim.x;
  long long i = v0 + threadIdx.x;
  for (; i + 3 * step < v1; i += 4 * step) {
    float4 a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = x4[i + u * step];
#pragma unroll
    for (int u = 0; u < 4; ++u) f(i + u * step, a[u]);
  }
  for (; i < v1; i += step) f(i, x4[i]);
}

// The block's |x| max over float4s [v0, v1) and, when `edges`, over the
// row's head and tail (at most 3 + 3 elements, one a thread).
__device__ __forceinline__ float chunk_absmax(const Row& r, long long v0,
                                              long long v1, bool edges) {
  float m = 0.0f;
  for_each_vec(r, v0, v1,
               [&](long long, float4 a) { m = fmaxf(m, absmax4(a)); });
  if (edges) {
    const long long j = threadIdx.x;
    if (j < r.head) m = fmaxf(m, fabsf(r.x[j]));
    if (r.tail0 + j < r.s) m = fmaxf(m, fabsf(r.x[r.tail0 + j]));
  }
  return m;
}

// The codes of the body's float4 i, `a`: one 4-byte store where aligned.
__device__ __forceinline__ void store_codes(const Row& r, long long i,
                                            float4 a, float scale) {
  const char4 c = make_char4(code_of(a.x, scale), code_of(a.y, scale),
                             code_of(a.z, scale), code_of(a.w, scale));
  int8_t* dst = r.q + r.head + 4 * i;
  if (r.q4) {
    *reinterpret_cast<char4*>(dst) = c;
  } else {
    dst[0] = c.x;
    dst[1] = c.y;
    dst[2] = c.z;
    dst[3] = c.w;
  }
}

// The codes of the same elements.
__device__ __forceinline__ void chunk_codes(const Row& r, long long v0,
                                            long long v1, bool edges,
                                            float scale) {
  for_each_vec(r, v0, v1,
               [&](long long i, float4 a) { store_codes(r, i, a, scale); });
  if (edges) {
    const long long j = threadIdx.x;
    if (j < r.head) r.q[j] = code_of(r.x[j], scale);
    if (r.tail0 + j < r.s) r.q[r.tail0 + j] = code_of(r.x[r.tail0 + j], scale);
  }
}

// Many short rows (s <= kShortRow): one warp a row, grid-striding over
// rows; the row's float4s stay in registers between the max and the codes.
__global__ void quantize_short_rows_kernel(const float* __restrict__ x,
                                           int8_t* __restrict__ q,
                                           float* __restrict__ scales,
                                           long long n, long long s) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) *
                          (blockDim.x >> 5);
  // warp-uniform: every lane of a warp takes the same rows
  for (long long row = static_cast<long long>(blockIdx.x) *
                           (blockDim.x >> 5) + (threadIdx.x >> 5);
       row < n; row += warps) {
    const Row r = row_of(x, q, row, s);
    const float4* x4 = reinterpret_cast<const float4*>(r.x + r.head);
    float4 a[kRowVecs];
    float m = 0.0f;
#pragma unroll
    for (int u = 0; u < kRowVecs; ++u) {
      const long long i = lane + 32 * u;
      a[u] = i < r.nvec ? x4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      m = fmaxf(m, absmax4(a[u]));
    }
    // the head's and the tail's elements, one a lane (at most 3 each)
    const bool in_head = lane < r.head;
    const bool in_tail = r.tail0 + lane < s;
    const float e_head = in_head ? r.x[lane] : 0.0f;
    const float e_tail = in_tail ? r.x[r.tail0 + lane] : 0.0f;
    m = fmaxf(m, fmaxf(fabsf(e_head), fabsf(e_tail)));
    const float scale = scale_of(warp_max(m));
    if (lane == 0) scales[row] = scale;
#pragma unroll
    for (int u = 0; u < kRowVecs; ++u) {
      const long long i = lane + 32 * u;
      if (i < r.nvec) store_codes(r, i, a[u], scale);
    }
    if (in_head) r.q[lane] = code_of(e_head, scale);
    if (in_tail) r.q[r.tail0 + lane] = code_of(e_tail, scale);
  }
}

// Many longer rows: one block a row, both passes in the block.
__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scales, long long n,
                                     long long s) {
  __shared__ float partial[kMaxThreads / 32];
  for (long long row = blockIdx.x; row < n; row += gridDim.x) {
    const Row r = row_of(x, q, row, s);
    const float scale =
        scale_of(block_max(chunk_absmax(r, 0, r.nvec, true), partial));
    if (threadIdx.x == 0) scales[row] = scale;
    chunk_codes(r, 0, r.nvec, true, scale);
    __syncthreads();  // partial is rewritten by the next row of this block
  }
}

// Few long rows, launch 1: block (c, row) writes the |x| max of its chunk
// of `per_chunk` float4s (chunk 0 also takes the head and tail) to
// partials[row * chunks + c].
__global__ void chunk_absmax_kernel(const float* __restrict__ x,
                                    int8_t* __restrict__ q,
                                    float* __restrict__ partials, long long s,
                                    long long per_chunk) {
  __shared__ float partial[kMaxThreads / 32];
  const long long row = blockIdx.y;
  const int c = blockIdx.x;
  const Row r = row_of(x, q, row, s);
  const long long v0 = c * per_chunk;
  const float m = block_max(
      chunk_absmax(r, v0, min(v0 + per_chunk, r.nvec), c == 0), partial);
  if (threadIdx.x == 0) partials[row * gridDim.x + c] = m;
}

// Few long rows, launch 2: the row's max from its partials, the scale, and
// the codes of this block's chunk.
__global__ void chunk_codes_kernel(const float* __restrict__ x,
                                   int8_t* __restrict__ q,
                                   float* __restrict__ scales,
                                   const float* __restrict__ partials,
                                   long long s, long long per_chunk) {
  __shared__ float partial[kMaxThreads / 32];
  const long long row = blockIdx.y;
  const int c = blockIdx.x;
  const float* pr = partials + row * gridDim.x;
  float m = 0.0f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += blockDim.x) {
    m = fmaxf(m, pr[i]);
  }
  const float scale = scale_of(block_max(m, partial));
  if (c == 0 && threadIdx.x == 0) scales[row] = scale;
  const Row r = row_of(x, q, row, s);
  const long long v0 = c * per_chunk;
  chunk_codes(r, v0, min(v0 + per_chunk, r.nvec), c == 0, scale);
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t passed as a pointer) and returns
// cudaGetLastError() as an int: 0 when the launches were accepted.
// `chunks` is the number of blocks a row is split over: 1 runs one warp (s
// <= 1024) or one block a row in one launch; more runs two launches on a
// (chunks, n) grid with `partials`, a scratch of n * chunks floats that
// the caller allocates.
int dpt_quantize_int8_rows(const float* x, int8_t* q, float* scales,
                           float* partials, long long n, long long s,
                           int chunks, void* stream) {
  if (n <= 0 || s <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long max_grid = 2147483647LL;
  if (chunks <= 1 && s <= kShortRow) {
    // a warp a row, 8 rows a block
    const long long blocks = (n + kMaxThreads / 32 - 1) / (kMaxThreads / 32);
    quantize_short_rows_kernel<<<
        static_cast<unsigned>(blocks < max_grid ? blocks : max_grid),
        kMaxThreads, 0, st>>>(x, q, scales, n, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (chunks <= 1) {
    // a thread per float4 of the row, rounded up to a warp, at most 256
    long long threads = ((s + 3) / 4 + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const unsigned grid = static_cast<unsigned>(n < max_grid ? n : max_grid);
    quantize_rows_kernel<<<grid, static_cast<unsigned>(threads), 0, st>>>(
        x, q, scales, n, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (partials == nullptr || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_chunk = ((s + 3) / 4 + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(n));
  chunk_absmax_kernel<<<grid, kMaxThreads, 0, st>>>(x, q, partials, s,
                                                    per_chunk);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  chunk_codes_kernel<<<grid, kMaxThreads, 0, st>>>(x, q, scales, partials, s,
                                                   per_chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* dpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
