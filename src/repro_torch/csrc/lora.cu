// NanoAdapter (LoRA) residual kernels for Hopper (sm_90a):
//   y = x + scale * (x A) B, math in fp32, one cast to x's dtype at the end.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/lora/lora.py::lora_residual_2d          (_kernel, line 29)
//   src/repro/kernels/lora/lora.py::grouped_lora_residual_2d  (_grouped_kernel, line 78)
//
// What bounds it on an H100: the work is 4*T*D*r fp32 operations over
// 2*T*D*sizeof(x) + 2*D*r*4 bytes. At the prefill shape (T = 128, D = 4096,
// r = 64, bf16 x) that is 134 MFLOP against 4.2 MB: 2.0 us at the 67 TFLOP/s
// fp32 rate of the CUDA cores, 1.25 us at 3.35 TB/s, so the fp32 operations
// bound it, narrowly. At the decode shape (8 rows) the adapter bytes bound it.
// chip_smoke.py computes both bounds for every shape it times.
//
// Design: the TPU kernel keeps both adapters in VMEM and walks token blocks
// in order on one core; here a call is two launches that spread the adapters
// over the SMs, with the rank-r intermediate kept out of the output path:
//   pass 1, grid (row tiles, kSplit d-chunks): partial h over one chunk of D,
//           written to an fp32 scratch (T, kSplit, r) the wrapper allocates;
//   pass 2, grid (row tiles, column blocks): h = sum of the kSplit partials
//           in a fixed order, then y = h B for kCols columns and the residual.
// Each block owns kRows rows, so one load of A or B feeds kRows fused
// multiply-adds. Tensor cores (wgmma), TMA and sorting rows by tenant are
// later work.
//
// Both kernels push each row through the same device functions, whose fp32
// operations for a row depend only on that row, A and B (explicit __fmaf_rn /
// __fadd_rn / __fmul_rn, no contraction left to the compiler, no atomics).
// So a row of a mixed-tenant batch equals the single-adapter kernel's row bit
// for bit in fp32, the property lora.py:72-74 pins for the TPU kernel.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kRows = 8;            // rows of x per block
constexpr int kSplit = 16;          // d-chunks of the down-projection; lora/ops.py::SPLIT
constexpr int kCols = kThreads;     // output columns per pass-2 block
constexpr int kMaxRank = kThreads;  // pass 1 gives each rank column >= 1 thread

// rows_s[i] = row index of slot i of this tile, or -1 when the slot is idle
// (past the end, or another adapter's row). Block-uniform answer: any row?
__device__ __forceinline__ bool select_rows(const int* __restrict__ idx, int n_rows, int n,
                                            int* rows_s) {
  if (threadIdx.x < kRows) {
    const int row = blockIdx.x * kRows + threadIdx.x;
    rows_s[threadIdx.x] = (row < n_rows && (idx == nullptr || idx[row] == n)) ? row : -1;
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int i = 0; i < kRows; ++i) any = any || rows_s[i] >= 0;
  return any;
}

// Pass 1: partial[row][s][:] = x[row, chunk s] · A[chunk s, :].
template <typename T>
__device__ __forceinline__ void down_chunk(const T* __restrict__ x, const float* __restrict__ A,
                                           float* __restrict__ partial, const int* rows_s, int D,
                                           int r, int s) {
  __shared__ float red[kRows][kThreads];
  const int t = threadIdx.x;
  const int groups = kThreads / r;  // thread (g, j) sums d = d0 + g, d0 + g + groups, ...
  const int chunk = (D + kSplit - 1) / kSplit;
  const int d0 = s * chunk, d1 = min(D, d0 + chunk);
  if (t < groups * r) {
    const int g = t / r, j = t % r;
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int d = d0 + g; d < d1; d += groups) {
      const float a = A[(int64_t)d * r + j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = rows_s[i];
        if (row >= 0) acc[i] = __fmaf_rn(to_f32(x[(int64_t)row * D + d]), a, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) red[i][g * r + j] = acc[i];
  }
  __syncthreads();
  for (int e = t; e < kRows * r; e += kThreads) {
    const int i = e / r, j = e % r, row = rows_s[i];
    if (row >= 0) {
      float sum = 0.f;
      for (int g = 0; g < groups; ++g) sum = __fadd_rn(sum, red[i][g * r + j]);
      partial[((int64_t)row * kSplit + s) * r + j] = sum;
    }
  }
}

// Pass 2: h = sum over s of the partials, out[row, c] = x[row, c] + scale * (h · B)[c].
template <typename T>
__device__ __forceinline__ void up_cols(const T* __restrict__ x, const float* __restrict__ B,
                                        const float* __restrict__ partial, T* __restrict__ out,
                                        const int* rows_s, int D, int r, float scale) {
  __shared__ float h[kRows][kMaxRank];
  const int t = threadIdx.x;
  for (int e = t; e < kRows * r; e += kThreads) {
    const int i = e / r, j = e % r, row = rows_s[i];
    float sum = 0.f;
    if (row >= 0) {
      for (int s = 0; s < kSplit; ++s) sum = __fadd_rn(sum, partial[((int64_t)row * kSplit + s) * r + j]);
    }
    h[i][j] = sum;
  }
  __syncthreads();
  const int c = blockIdx.y * kCols + t;
  if (c >= D) return;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < r; ++j) {
    const float b = B[(int64_t)j * D + c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = __fmaf_rn(h[i][j], b, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = rows_s[i];
    if (row >= 0) {
      const int64_t o = (int64_t)row * D + c;
      out[o] = from_f32<T>(__fadd_rn(to_f32(x[o]), __fmul_rn(scale, acc[i])));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lora_down_kernel(const T* __restrict__ x, const float* __restrict__ A,
                     float* __restrict__ partial, int n_rows, int D, int r) {
  __shared__ int rows_s[kRows];
  if (!select_rows(nullptr, n_rows, 0, rows_s)) return;
  down_chunk<T>(x, A, partial, rows_s, D, r, blockIdx.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lora_up_kernel(const T* __restrict__ x, const float* __restrict__ B,
                   const float* __restrict__ partial, T* __restrict__ out, int n_rows, int D,
                   int r, float scale) {
  __shared__ int rows_s[kRows];
  if (!select_rows(nullptr, n_rows, 0, rows_s)) return;
  up_cols<T>(x, B, partial, out, rows_s, D, r, scale);
}

// Grouped: grid.z = adapter n. Block (tile, ., n) serves the rows of its tile
// that selected adapter n and skips both products when there are none.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_down_kernel(const T* __restrict__ x, const float* __restrict__ A,
                        const int* __restrict__ idx, float* __restrict__ partial, int n_rows,
                        int D, int r) {
  __shared__ int rows_s[kRows];
  const int n = blockIdx.z;
  if (!select_rows(idx, n_rows, n, rows_s)) return;
  down_chunk<T>(x, A + (int64_t)n * D * r, partial, rows_s, D, r, blockIdx.y);
}

// Blocks of adapter 0 also copy the rows whose id lies outside [0, N) through
// as x, bit for bit (the identity slot of the serving bank).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_up_kernel(const T* __restrict__ x, const float* __restrict__ B,
                      const int* __restrict__ idx, const float* __restrict__ partial,
                      T* __restrict__ out, int n_rows, int D, int r, int N, float scale) {
  __shared__ int rows_s[kRows];
  const int n = blockIdx.z;
  const int c = blockIdx.y * kCols + threadIdx.x;
  if (n == 0 && c < D) {
    for (int i = 0; i < kRows; ++i) {
      const int row = blockIdx.x * kRows + i;
      if (row < n_rows && (idx[row] < 0 || idx[row] >= N)) {
        out[(int64_t)row * D + c] = x[(int64_t)row * D + c];
      }
    }
  }
  if (!select_rows(idx, n_rows, n, rows_s)) return;
  up_cols<T>(x, B + (int64_t)n * r * D, partial, out, rows_s, D, r, scale);
}

bool bad_shape(int n_rows, int D, int r, int64_t scratch_floats) {
  return r < 1 || r > kMaxRank || D < 1 || (int64_t)n_rows * kSplit * r > scratch_floats;
}

}  // namespace

// scratch: fp32, at least n_rows * kSplit * r floats.
extern "C" int repro_lora_residual(const void* x, const float* A, const float* B, float* scratch,
                                   long long scratch_floats, void* out, int n_rows, int D, int r,
                                   float scale, int dtype, void* stream) {
  if (bad_shape(n_rows, D, r, scratch_floats)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaGetLastError();
  const int tiles = (n_rows + kRows - 1) / kRows;
  const dim3 g1(tiles, kSplit), g2(tiles, (D + kCols - 1) / kCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    const float* xf = static_cast<const float*>(x);
    lora_down_kernel<float><<<g1, kThreads, 0, s>>>(xf, A, scratch, n_rows, D, r);
    lora_up_kernel<float><<<g2, kThreads, 0, s>>>(xf, B, scratch, static_cast<float*>(out),
                                                  n_rows, D, r, scale);
  } else if (dtype == repro::kBF16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    lora_down_kernel<__nv_bfloat16><<<g1, kThreads, 0, s>>>(xb, A, scratch, n_rows, D, r);
    lora_up_kernel<__nv_bfloat16><<<g2, kThreads, 0, s>>>(
        xb, B, scratch, static_cast<__nv_bfloat16*>(out), n_rows, D, r, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_grouped_lora_residual(const void* x, const float* A, const float* B,
                                           const int* idx, float* scratch,
                                           long long scratch_floats, void* out, int n_rows, int D,
                                           int r, int N, float scale, int dtype, void* stream) {
  if (bad_shape(n_rows, D, r, scratch_floats) || N < 1 || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return (int)cudaGetLastError();
  const int tiles = (n_rows + kRows - 1) / kRows;
  const dim3 g1(tiles, kSplit, N), g2(tiles, (D + kCols - 1) / kCols, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    const float* xf = static_cast<const float*>(x);
    grouped_down_kernel<float><<<g1, kThreads, 0, s>>>(xf, A, idx, scratch, n_rows, D, r);
    grouped_up_kernel<float><<<g2, kThreads, 0, s>>>(xf, B, idx, scratch,
                                                     static_cast<float*>(out), n_rows, D, r, N,
                                                     scale);
  } else if (dtype == repro::kBF16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    grouped_down_kernel<__nv_bfloat16><<<g1, kThreads, 0, s>>>(xb, A, idx, scratch, n_rows, D, r);
    grouped_up_kernel<__nv_bfloat16><<<g2, kThreads, 0, s>>>(
        xb, B, idx, scratch, static_cast<__nv_bfloat16*>(out), n_rows, D, r, N, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
