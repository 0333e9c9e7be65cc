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
// A max over |x| is exact and order-free, so the reduction order is free.
// Inputs are finite: fmaxf drops a NaN where the reference would propagate it.
//
// Bound on the card: memory. Per element it reads 4 B and writes 1 B, and
// per row it writes one 4 B scale; the arithmetic (abs, max, divide, round,
// clamp) is a handful of fp32 operations per 5 B moved, far below the
// H100's ratio of operations to bytes.
//
// Design, simple and correct first: one block per row, grid-striding over
// rows. Pass 1 takes a strided |x| max, reduced by warp shuffles and then
// across warps through shared memory; pass 2 reads the row again (from L2
// for rows that fit) and writes the codes. Short rows get a narrower block
// (the row width rounded up to a warp, at most 256 threads). A single long
// row (n = 1, s ~ 1M, the plain int8 gradient wire) runs on one block and
// one SM: correct, and slow; its time is recorded beside its bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

__global__ void quantize_int8_rows_kernel(const float* __restrict__ x,
                                          int8_t* __restrict__ q,
                                          float* __restrict__ scales,
                                          long long n, long long s) {
  __shared__ float partial[kMaxThreads / 32];
  __shared__ float row_scale;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (long long row = blockIdx.x; row < n; row += gridDim.x) {
    const float* xr = x + row * s;
    int8_t* qr = q + row * s;

    // pass 1: amax over the row
    float m = 0.0f;
    for (long long j = threadIdx.x; j < s; j += blockDim.x) {
      m = fmaxf(m, fabsf(xr[j]));
    }
    m = warp_max(m);
    if (lane == 0) partial[warp] = m;
    __syncthreads();
    if (warp == 0) {
      float v = lane < n_warps ? partial[lane] : 0.0f;
      v = warp_max(v);
      if (lane == 0) {
        const float scale = fmaxf(v, 1e-30f) * (1.0f / 127.0f);
        row_scale = scale;
        scales[row] = scale;
      }
    }
    __syncthreads();

    // pass 2: codes
    const float scale = row_scale;
    for (long long j = threadIdx.x; j < s; j += blockDim.x) {
      float c = rintf(__fdiv_rn(xr[j], scale));
      c = fminf(fmaxf(c, -127.0f), 127.0f);
      qr[j] = static_cast<int8_t>(__float2int_rn(c));
    }
    // partial/row_scale are rewritten by the next row of this block
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t passed as a pointer) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
int dpt_quantize_int8_rows(const float* x, int8_t* q, float* scales,
                           long long n, long long s, void* stream) {
  if (n <= 0 || s <= 0) return 0;
  long long threads = (s + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long max_grid = 2147483647LL;
  const unsigned grid = static_cast<unsigned>(n < max_grid ? n : max_grid);
  quantize_int8_rows_kernel<<<grid, static_cast<unsigned>(threads), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, q, scales, n, s);
  return static_cast<int>(cudaGetLastError());
}

const char* dpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
