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
// writes 4 bytes; the n scales are read once. The arithmetic (a convert, a
// multiply and an add per code) is far below the H100's ratio of
// operations to bytes. At the int8 wire's (2, 11,181,642) that is ~67 MB,
// ~0.020 ms at 3.35 TB/s.
//
// Design, simple and correct first: the TPU kernel walks column blocks on
// an in-order grid with the whole row axis in one VMEM tile. Here a thread
// owns 4 neighbouring columns and walks the rows 0..n-1 in order, loading
// one char4 per row (a warp reads 128 contiguous bytes of a row) and
// keeping the 4 sums in registers. A grid-stride loop covers s; the ragged
// tail (s not a multiple of 4, or rows not 4-byte aligned) takes a scalar
// path. The n scales are staged in shared memory. No atomics and no state
// across blocks: every column is summed by exactly one thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float madd(float acc, int8_t code, float scale) {
  return __fmaf_rn(static_cast<float>(code), scale, acc);
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

// Launches on `stream` (a cudaStream_t passed as a pointer) and returns
// cudaGetLastError() as an int: 0 when the launch was accepted. The caller
// guarantees n >= 1, s >= 1, n * 4 bytes of shared memory within 48 KB,
// and a 16-byte aligned `out` (torch's allocator gives 256).
int dpt_dequant_sum_rows(const int8_t* q, const float* scales, float* out,
                         long long n, long long s, int sm_count,
                         void* stream) {
  if (n <= 0 || s <= 0) return 0;
  const long long groups = (s + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  const long long max_blocks = 8LL * (sm_count > 0 ? sm_count : 132);
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const bool vector =
      s % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
