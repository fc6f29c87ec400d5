// Row LayerNorm backward for Hopper (sm_90a).
//
// Replaces the TPU kernel jimm_tpu/ops/layer_norm.py::_bwd_kernel (launched
// by _ln_bwd through pl.pallas_call). Same numerics: from the forward's f32
// mean and rstd, x_hat = (x - mean) * rstd and dy = do * scale, then
//   dx = rstd * (dy - sum(dy) / F - x_hat * sum(dy * x_hat) / F)
// stored in the dtype of x, plus the per-feature sums dscale = sum(do * x_hat)
// and dbias = sum(do) over the rows, in f32.
//
// The TPU kernel accumulates dscale/dbias in one output block that every
// sequential grid step revisits. CUDA blocks run in parallel and in no
// order, so here each CTA walks a strided set of rows and keeps its own f32
// dscale/dbias partial row in shared memory (each thread owns a fixed set of
// columns, so the accumulation needs no barrier), then writes it to
// dg_part/db_part[blockIdx.x]. The wrapper sums the partials over CTAs
// (the JAX package sums its dg_part in XLA too). No float atomics: the
// result does not depend on the order the CTAs run in.
//
// What bounds it on the H100: bytes. It reads x and do once and writes dx
// once (2 bytes an element each in bf16) and does ~12 flops an element; at
// the training shape (32768 rows x 768, bf16) the floor is ~151 MB over
// 3.35 TB/s, ~0.045 ms. What the design does about it: neighbouring threads
// touch neighbouring elements (coalesced); the second pass over a row
// re-reads x/do/scale right after the first, so it is served from L1/L2 and
// not from device memory; the partials cost 8 bytes a feature per CTA,
// small against the rows a CTA covers when the grid is a few CTAs per SM
// (the wrapper launches 8 per SM).

#include "common.cuh"

namespace {

// (sum of v.x, sum of v.y) over the block, the same in every thread. `red`
// holds one partial per warp; the leading barrier lets the next row reuse it.
template <int THREADS>
__device__ __forceinline__ float2 block_sum2(float2 v, float2* red) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    t.x += red[w].x;
    t.y += red[w].y;
  }
  return t;
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS) layer_norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mu, const float* __restrict__ rstd,
    const T* __restrict__ dout, T* __restrict__ dx,
    float* __restrict__ dg_part, float* __restrict__ db_part, long long rows,
    int f) {
  extern __shared__ float acc[];  // 2f floats: this CTA's dscale, dbias
  __shared__ float2 red[THREADS / 32];
  float* dg_acc = acc;
  float* db_acc = acc + f;
  for (int i = threadIdx.x; i < f; i += THREADS) {
    dg_acc[i] = 0.f;
    db_acc[i] = 0.f;
  }
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * f;
    const T* dr = dout + r * f;
    const float m = mu[r], rs = rstd[r];
    float2 s = make_float2(0.f, 0.f);
    for (int i = threadIdx.x; i < f; i += THREADS) {
      const float xh = (jimm::to_f32(xr[i]) - m) * rs;
      const float d = jimm::to_f32(dr[i]);
      const float dy = d * jimm::to_f32(g[i]);
      s.x += dy;
      s.y += dy * xh;
      dg_acc[i] += d * xh;
      db_acc[i] += d;
    }
    s = block_sum2<THREADS>(s, red);
    const float m1 = s.x / f, m2 = s.y / f;
    T* dxr = dx + r * f;
    for (int i = threadIdx.x; i < f; i += THREADS) {
      const float xh = (jimm::to_f32(xr[i]) - m) * rs;
      const float dy = jimm::to_f32(dr[i]) * jimm::to_f32(g[i]);
      dxr[i] = jimm::from_f32<T>(rs * (dy - m1 - xh * m2));
    }
  }
  // each thread stores only the columns it accumulated: no barrier needed
  float* dgp = dg_part + static_cast<long long>(blockIdx.x) * f;
  float* dbp = db_part + static_cast<long long>(blockIdx.x) * f;
  for (int i = threadIdx.x; i < f; i += THREADS) {
    dgp[i] = dg_acc[i];
    dbp[i] = db_acc[i];
  }
}

template <typename T, int THREADS>
cudaError_t launch(const void* x, const void* g, const void* mu,
                   const void* rstd, const void* dout, void* dx, void* dg_part,
                   void* db_part, long long rows, int f, int ctas,
                   cudaStream_t stream) {
  auto kernel = layer_norm_bwd_kernel<T, THREADS>;
  const int smem = 2 * f * static_cast<int>(sizeof(float));
  cudaError_t err = jimm::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const T*>(dout), static_cast<T*>(dx),
      static_cast<float*>(dg_part), static_cast<float*>(db_part), rows, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, const void* mu,
                     const void* rstd, const void* dout, void* dx,
                     void* dg_part, void* db_part, long long rows, int f,
                     int ctas, cudaStream_t stream) {
  if (f <= 1024)
    return launch<T, 128>(x, g, mu, rstd, dout, dx, dg_part, db_part, rows, f,
                          ctas, stream);
  return launch<T, 256>(x, g, mu, rstd, dout, dx, dg_part, db_part, rows, f,
                        ctas, stream);
}

}  // namespace

// x, dout, dx: (rows, f) contiguous in `dtype`; g: (f,) in `dtype`; mu, rstd:
// (rows,) f32; dg_part, db_part: (ctas, f) f32, one row per CTA, every
// element written. Returns the launch's cudaError_t (0 = launched).
extern "C" int jimm_layer_norm_bwd(const void* x, const void* g, const void* mu,
                                   const void* rstd, const void* dout, void* dx,
                                   void* dg_part, void* db_part, long long rows,
                                   int f, int ctas, int dtype, void* stream) {
  // two f32 partial rows in shared memory: 227 KB caps f at 28,672 here
  if (rows < 1 || f < 1 || f > 28672 || ctas < 1 || ctas > rows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case jimm::kF32:
      return dispatch<float>(x, g, mu, rstd, dout, dx, dg_part, db_part, rows,
                             f, ctas, s);
    case jimm::kBF16:
      return dispatch<__nv_bfloat16>(x, g, mu, rstd, dout, dx, dg_part,
                                     db_part, rows, f, ctas, s);
    default:
      return cudaErrorInvalidValue;
  }
}
