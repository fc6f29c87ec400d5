// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel jimm_tpu/ops/layer_norm.py::_fwd_kernel (launched
// by _ln_fwd_impl through pl.pallas_call). Same numerics: f32 statistics in
// two passes (the mean, then the centred biased variance), rstd =
// rsqrt(var + eps), y = ((x - mean) * rstd) * scale + bias stored in the
// dtype of x, plus the per-row mean and rstd in f32 for the backward.
//
// What bounds it on the H100: bytes. It reads x once and writes y once
// (2 bytes an element each in bf16) and does ~8 flops an element, far below
// the ~295 flops a byte where the tensor cores would be the limit; at the
// served shape (8192 rows x 768, bf16) the floor is ~25 MB over 3.35 TB/s.
//
// Two bodies, chosen in the C entry by shape:
// - the register body (every preset width: F = 768, 1024, 1152): one warp
//   a row, several rows a CTA, each warp walking rows in a grid-stride loop
//   over a grid of the CTAs the card holds at once. 16-byte loads and
//   stores (8 bf16 or 4 f32 a lane a vector), the row held in registers as
//   f32 (kVecs vectors a lane, the last one guarded where 32 lanes do not
//   divide the row's vectors, as at F = 1152 in bf16), warp-shuffle sums
//   with no barrier, and the scale and bias loaded once a warp and kept in
//   registers across its rows. It takes F a multiple of the vector width,
//   F <= 2048, and 16-byte aligned bases;
// - the CTA body (the rest: wider rows, an F off the vector width, views
//   off a 16-byte boundary): one CTA a row keeps the row in shared memory
//   as f32, so x is read from device memory exactly once although the
//   statistics take two passes; neighbouring threads touch neighbouring
//   elements, so every load and store is coalesced.
// ops/layer_norm.py::forward_body mirrors the choice.

#include "layer_norm.cuh"

namespace {

using jimm::Vec;
using jimm::warp_sum;

using jimm::kRegisterMaxF;

constexpr int kWarps = 4;  // the register body's rows a CTA

// The register body: warp w of CTA c takes rows c * kWarps + w, then every
// gridDim.x * kWarps rows further; lane l holds vectors l, l + 32, ... of
// the row (kVecs of them, the last guarded).
template <typename T, int kVecs>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_fwd_register_kernel(const T* __restrict__ x,
                                   const T* __restrict__ g,
                                   const T* __restrict__ b,
                                   T* __restrict__ y,
                                   float* __restrict__ mu_out,
                                   float* __restrict__ rstd_out,
                                   long long rows, int f, float eps) {
  constexpr int kE = Vec<T>::kN;
  const int lane = threadIdx.x & 31;
  const int nv = f / kE;
  uint4 gv[kVecs], bv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = lane + 32 * i;
    if (v < nv) {
      gv[i] = reinterpret_cast<const uint4*>(g)[v];
      bv[i] = reinterpret_cast<const uint4*>(b)[v];
    }
  }
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = blockIdx.x * static_cast<long long>(kWarps) +
                     threadIdx.x / 32;
       r < rows; r += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * f);
    float v[kVecs][kE];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < nv) {
        Vec<T>::unpack(xr[lane + 32 * i], v[i]);
#pragma unroll
        for (int e = 0; e < kE; ++e) s += v[i][e];
      }
    }
    const float mu = warp_sum(s) / f;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < nv) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          v[i][e] -= mu;
          s2 += v[i][e] * v[i][e];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(s2) / f + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + r * f);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < nv) {
        float gf[kE], bf[kE];
        Vec<T>::unpack(gv[i], gf);
        Vec<T>::unpack(bv[i], bf);
#pragma unroll
        for (int e = 0; e < kE; ++e) v[i][e] = v[i][e] * rstd * gf[e] + bf[e];
        yr[lane + 32 * i] = Vec<T>::pack(v[i]);
      }
    }
    if (lane == 0) {
      mu_out[r] = mu;
      rstd_out[r] = rstd;
    }
  }
}

// Sum of v over the block, the same value in every thread. `red` holds one
// partial per warp; the leading barrier lets a second call reuse it.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) t += red[w];
  return t;
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
    layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const T* __restrict__ b, T* __restrict__ y,
                          float* __restrict__ mu_out,
                          float* __restrict__ rstd_out, int f, float eps) {
  extern __shared__ float row[];  // f floats: the row, widened once
  __shared__ float red[THREADS / 32];
  const long long r = blockIdx.x;
  const T* xr = x + r * f;
  float s = 0.f;
  for (int i = threadIdx.x; i < f; i += THREADS) {
    const float v = jimm::to_f32(xr[i]);
    row[i] = v;
    s += v;
  }
  const float mu = block_sum<THREADS>(s, red) / f;
  // each thread revisits only the elements it wrote: no barrier needed
  float s2 = 0.f;
  for (int i = threadIdx.x; i < f; i += THREADS) {
    const float c = row[i] - mu;
    s2 += c * c;
  }
  const float var = block_sum<THREADS>(s2, red) / f;
  const float rstd = rsqrtf(var + eps);
  T* yr = y + r * f;
  for (int i = threadIdx.x; i < f; i += THREADS) {
    const float xhat = (row[i] - mu) * rstd;
    yr[i] = jimm::from_f32<T>(xhat * jimm::to_f32(g[i]) + jimm::to_f32(b[i]));
  }
  if (threadIdx.x == 0) {
    mu_out[r] = mu;
    rstd_out[r] = rstd;
  }
}

template <typename T, int THREADS>
cudaError_t launch(const void* x, const void* g, const void* b, void* y,
                   void* mu, void* rstd, long long rows, int f, float eps,
                   cudaStream_t stream) {
  auto kernel = layer_norm_fwd_kernel<T, THREADS>;
  const int smem = f * static_cast<int>(sizeof(float));
  cudaError_t err = jimm::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(rows), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y), static_cast<float*>(mu),
      static_cast<float*>(rstd), f, eps);
  return cudaGetLastError();
}

template <typename T, int kVecs>
cudaError_t launch_register(const void* x, const void* g, const void* b,
                            void* y, void* mu, void* rstd, long long rows,
                            int f, float eps, cudaStream_t stream) {
  auto kernel = layer_norm_fwd_register_kernel<T, kVecs>;
  int ctas = 0;
  const cudaError_t err =
      jimm::resident_ctas(kernel, kWarps * 32, 0, &ctas);
  if (err != cudaSuccess) return err;
  const long long needed = (rows + kWarps - 1) / kWarps;
  kernel<<<static_cast<unsigned>(needed < ctas ? needed : ctas), kWarps * 32,
           0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(g),
                        static_cast<const T*>(b), static_cast<T*>(y),
                        static_cast<float*>(mu), static_cast<float*>(rstd),
                        rows, f, eps);
  return cudaGetLastError();
}

// the register body with the fewest vectors a lane that hold `vecs`
template <typename T, int kVecs>
cudaError_t register_body(int vecs, const void* x, const void* g,
                          const void* b, void* y, void* mu, void* rstd,
                          long long rows, int f, float eps,
                          cudaStream_t stream) {
  if constexpr (kVecs > 1) {
    if (vecs <= kVecs - 1)
      return register_body<T, kVecs - 1>(vecs, x, g, b, y, mu, rstd, rows, f,
                                         eps, stream);
  }
  return launch_register<T, kVecs>(x, g, b, y, mu, rstd, rows, f, eps,
                                   stream);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, const void* b, void* y,
                     void* mu, void* rstd, long long rows, int f, float eps,
                     cudaStream_t stream) {
  constexpr int kE = Vec<T>::kN;
  if (f % kE == 0 && f <= kRegisterMaxF && jimm::aligned16(x) &&
      jimm::aligned16(g) && jimm::aligned16(b) && jimm::aligned16(y)) {
    const int vecs = (f / kE + 31) / 32;
    return register_body<T, kRegisterMaxF / kE / 32>(
        vecs, x, g, b, y, mu, rstd, rows, f, eps, stream);
  }
  // narrow rows: fewer threads, so each still has a few elements to do
  if (f <= 1024)
    return launch<T, 128>(x, g, b, y, mu, rstd, rows, f, eps, stream);
  return launch<T, 256>(x, g, b, y, mu, rstd, rows, f, eps, stream);
}

}  // namespace

// x, y: (rows, f) contiguous in `dtype`; g, b: (f,) in `dtype`;
// mu, rstd: (rows,) f32. Returns the launch's cudaError_t (0 = launched).
extern "C" int jimm_layer_norm_fwd(const void* x, const void* g, const void* b,
                                   void* y, void* mu, void* rstd,
                                   long long rows, int f, float eps, int dtype,
                                   void* stream) {
  // the row lives in shared memory: 227 KB caps f at 58,112 floats
  if (rows < 1 || rows > 0x7fffffffLL || f < 1 || f > 58112)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case jimm::kF32:
      return dispatch<float>(x, g, b, y, mu, rstd, rows, f, eps, s);
    case jimm::kBF16:
      return dispatch<__nv_bfloat16>(x, g, b, y, mu, rstd, rows, f, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
