// Fisher-weighted merge kernels for Hopper (sm_90a), paper Eq. 1:
//   merge: out[n] = sum_k w_k F[k,n] theta[k,n] / (sum_k w_k F[k,n] + eps)
//   fold:  num[n] += w F[n] theta[n],  den[n] += w F[n]
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fisher_merge/fisher_merge.py::fisher_merge_2d  (_kernel, line 23)
//   src/repro/kernels/fisher_merge/fisher_merge.py::fisher_fold_2d   (_fold_kernel, line 33)
//
// What bounds them on an H100: bytes. The merge reads each of the K client
// rows of theta and F once and writes one row: (2K + 1) N elements for
// 4K + 2 fp32 operations per column. The fold reads num, den (f32), theta
// and F and writes num and den. At the training slice's shapes (K = 2,
// N = 262,144 f32 per adapter leaf) a merge moves 5.2 MB (1.6 us at
// 3.35 TB/s) and a fold 6.3 MB (1.9 us): launching costs more than the
// work. chip_smoke.py computes the bound for each shape it times.
//
// Design: the TPU kernel streams (K, block_n) tiles through VMEM and reduces
// over the client axis in registers. Here one thread owns one column, in a
// grid-stride loop: neighbouring threads read neighbouring columns of each
// client row, so every load is coalesced, and each element is read once.
// The loop over k = 0..K-1 runs in a fixed order in fp32 with explicit
// __fmul_rn / __fadd_rn (no contraction left to the compiler) and no atomics,
// so a column's result depends only on that column and does not change from
// run to run. The weights come as a (K,) f32 device array.
//
// The fold updates num and den IN PLACE (the TPU kernel writes new arrays):
// the server's running sums are its own buffers, and in place it never holds
// a second copy of them.

#include "common.cuh"

namespace {

using repro::to_f32;
using repro::from_f32;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

inline int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fisher_merge_kernel(const T* __restrict__ theta, const T* __restrict__ fisher,
                        const float* __restrict__ w, T* __restrict__ out, int K, long long N,
                        float eps) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long n = (long long)blockIdx.x * kThreads + threadIdx.x; n < N; n += stride) {
    float num = 0.f, den = 0.f;
    for (int k = 0; k < K; ++k) {
      const long long i = (long long)k * N + n;
      const float wf = __fmul_rn(w[k], to_f32(fisher[i]));
      num = __fadd_rn(num, __fmul_rn(wf, to_f32(theta[i])));
      den = __fadd_rn(den, wf);
    }
    out[n] = from_f32<T>(__fdiv_rn(num, __fadd_rn(den, eps)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fisher_fold_kernel(float* __restrict__ num, float* __restrict__ den,
                       const T* __restrict__ theta, const T* __restrict__ fisher, float w,
                       long long N) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long n = (long long)blockIdx.x * kThreads + threadIdx.x; n < N; n += stride) {
    const float wf = __fmul_rn(w, to_f32(fisher[n]));
    num[n] = __fadd_rn(num[n], __fmul_rn(wf, to_f32(theta[n])));
    den[n] = __fadd_rn(den[n], wf);
  }
}

}  // namespace

extern "C" int repro_fisher_merge(const void* theta, const void* fisher, const float* w,
                                  void* out, int K, long long N, float eps, int dtype,
                                  void* stream) {
  if (K < 1 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    fisher_merge_kernel<float><<<blocks_for(N), kThreads, 0, s>>>(
        static_cast<const float*>(theta), static_cast<const float*>(fisher), w,
        static_cast<float*>(out), K, N, eps);
  } else if (dtype == repro::kBF16) {
    fisher_merge_kernel<__nv_bfloat16><<<blocks_for(N), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(theta), static_cast<const __nv_bfloat16*>(fisher), w,
        static_cast<__nv_bfloat16*>(out), K, N, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_fisher_fold(float* num, float* den, const void* theta, const void* fisher,
                                 float w, long long N, int dtype, void* stream) {
  if (N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    fisher_fold_kernel<float><<<blocks_for(N), kThreads, 0, s>>>(
        num, den, static_cast<const float*>(theta), static_cast<const float*>(fisher), w, N);
  } else if (dtype == repro::kBF16) {
    fisher_fold_kernel<__nv_bfloat16><<<blocks_for(N), kThreads, 0, s>>>(
        num, den, static_cast<const __nv_bfloat16*>(theta),
        static_cast<const __nv_bfloat16*>(fisher), w, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
