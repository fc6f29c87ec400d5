// Shared helpers of the port's CUDA kernels: dtype codes passed across the
// plain C interface, and f32 <-> storage-type conversions. Every kernel
// computes in f32 and stores in the input's dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace jimm {

// dtype codes the Python wrappers pass (keep in sync with _DTYPE_CODES in
// jimm_tpu_torch/_build.py)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the value x takes once stored in T and read back (bf16 rounding; the
// identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Raise a kernel's dynamic shared-memory cap on the current device; above
// 48 KB a launch without it is refused. The cap granted so far is kept per
// (kernel, device), so the driver call is made only when a launch needs
// more than that, not on every launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mutex;
  static std::map<std::pair<const void*, int>, int> granted;
  const std::lock_guard<std::mutex> lock(mutex);
  int& cap = granted[{reinterpret_cast<const void*>(kernel), device}];
  if (cap >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) cap = bytes;
  return err;
}

}  // namespace jimm
