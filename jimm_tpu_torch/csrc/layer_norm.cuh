// What the LayerNorm forward (layer_norm.cu) and backward
// (layer_norm_bwd.cu) register bodies share: the widest row they take,
// 16-byte vectors of a row widened to f32 and back, a warp-shuffle sum, the
// 16-byte alignment test that picks the body, and the number of CTAs of a
// kernel the card holds at once (the grid of a grid-stride loop).
#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace jimm {

// the register bodies' widest row (F elements): forward, the row as f32;
// backward, x, do and scale packed (0.5 register an element each in bf16,
// 1 in f32), 236 registers at 2048 in f32 with no spills
constexpr int kRegisterMaxF = 2048;

// 16 bytes of T as f32 and back: 4 f32 or 8 bf16
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// CTAs of `kernel` of `threads` threads and `smem` bytes of dynamic shared
// memory the current device holds at once (kept per (kernel, device,
// smem), so the occupancy query runs once)
template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, int threads, int smem, int* ctas) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mutex;
  static std::map<std::tuple<const void*, int, int>, int> known;
  const std::lock_guard<std::mutex> lock(mutex);
  int& n = known[{reinterpret_cast<const void*>(kernel), device, smem}];
  if (n == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    n = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  *ctas = n;
  return cudaSuccess;
}

}  // namespace jimm
