// Shared helpers of the port's CUDA kernels: the dtype codes the Python
// wrappers pass, fp32 <-> storage-type conversions by intrinsic only, the
// async-copy, tensor-core and dependent-launch building blocks, and the host
// state each launch looks up per device (shared-memory opt-ins, SM count).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro {

// Must match repro_torch/kernels/build.py::DTYPE_CODES.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace repro

// Tensor-core and async-copy building blocks of the bf16 paths (sm_80+ PTX,
// which sm_90a runs): cp.async copies global -> shared without staging in
// registers, ldmatrix loads mma fragments from shared memory, and
// mma.sync.m16n8k16 (bf16) / m16n8k8 (tf32) multiply on the tensor cores
// with f32 accumulation. Fragment layouts are PTX ISA's "Matrix Fragments
// for mma.m16n8k16 / mma.m16n8k8": with g = lane / 4 and t = lane % 4,
// an accumulator holds (row g, cols 2t, 2t+1) in c[0..1] and
// (row g + 8, cols 2t, 2t+1) in c[2..3].
namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; zero-fills the destination when !valid
// (src must still be a valid address: it is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8 tf32, row) * b (8x8 tf32, col), f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Round to nearest at TF32's 10 mantissa bits, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-22 relative: hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Programmatic dependent launch (sm_90): a primary grid lets the grid
// launched after it with cudaLaunchAttributeProgrammaticStreamSerialization
// start early; the dependent grid waits for the primary's completion, and
// its memory, at griddep_wait (a no-op when launched without the attribute).
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Host state per device, keyed by cudaGetDevice: a kernel's opt-in to more
// than 48 KB of dynamic shared memory holds for one device only, and the SM
// count is the device's own. One process may drive several cards.
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

inline cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev >= 0 && *dev < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

// The current device's SM count, looked up once per device.
inline cudaError_t device_sms(int* sms) {
  static std::atomic<int> cache[kMaxDevices];  // 0: not looked up yet
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  int v = cache[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cache[dev].store(v, std::memory_order_relaxed);
  }
  *sms = v;
  return cudaSuccess;
}

// Let kernel K take `bytes` of dynamic shared memory on the current device
// (above 48 KB only after opting in); the attribute is set once per device
// and raised if a later call asks for more.
template <auto K>
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> granted[kMaxDevices];  // bytes opted in per device
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  if (granted[dev].load(std::memory_order_relaxed) >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted[dev].store(bytes, std::memory_order_relaxed);
  return err;
}

}  // namespace repro
