// fp8 x fp8 -> f32 matmul with a fused dequantizing epilogue for Hopper
// (sm_90a): out = (a . b^T) * scale + bias[n], f32 out.
//
// Replaces the TPU kernel jimm_tpu/ops/fp8_matmul.py::_matmul_kernel
// (kernel row 12; launched by _fp8_gemm through pl.pallas_call), the GEMM
// of every Fp8Linear under the fp8_hybrid training policy: e4m3 x e4m3 in
// the forward, e5m2 (the gradient) x e4m3 (the saved residual) for dx and
// dw. Same numerics: each fp8 element is widened to f32 exactly, the product
// of two fp8 values is exact in f32, and the sum is kept in f32 (the TPU's
// MXU dot with preferred_element_type f32); the epilogue multiplies by the
// one combined per-tensor scale, then adds the bias, as _dequant then `+ b`,
// each step rounded on its own (__fmul_rn / __fadd_rn, so nvcc cannot
// contract them into an FMA). The kernel differs from its plain version (an
// f32 matmul of the widened values) only in the order of the f32 sum.
//
// Layout: a is (M, K) and b is (N, K), both K-contiguous (the nn.Linear
// weight layout; the TPU kernel takes (K, N), the same numbers); the format
// of each operand is a template parameter. scale is one f32 read from
// device memory, so a delayed or dynamic scale computed on the card never
// visits the host. Every K step stages 32 bytes of each operand's rows in
// shared memory, widened to f32 once and stored K-major (As[k][m]),
// zero-padded past K and past M/N; when K is a multiple of 16 and both
// bases are 16-byte aligned (every training shape) a thread copies 16
// bytes with one load, otherwise byte by byte (odd K: 7, 100, 769).
//
// Design: one CTA of 256 threads per 128 x 128 output tile, in a 16 x 16
// layout; thread (ty, tx) owns the rows 64*g + 4*ty + i and columns
// 64*h + 4*tx + j of the tile (i, j < 4; g, h < 2), so per k it reads two
// float4 of the A column (broadcast across the 16 threads of a row of the
// layout) and two of the B row (contiguous across them) and issues 64
// FMAs. An output with fewer tiles than two CTAs an SM (the dw GEMMs: a
// 768 x 768 weight gradient summed over 32768 token rows is 36 tiles)
// splits K into ranges (enough for four such waves), one CTA per (tile,
// range), each writing its raw f32 sums to a workspace; a second kernel
// adds the ranges in order and applies the epilogue (no atomics: the
// result does not depend on scheduling). The wrapper picks the ranges and
// allocates the workspace.
//
// What bounds it on the H100: at the training shapes the operations, at
// the card's fp8 tensor-core peak (fc1's forward, 32768 x 768 x 3072:
// 154.6 GFLOP at 1,979 TFLOP/s, 0.078 ms) against 430 MB of fp8 operands
// and f32 output (0.128 ms at 3.35 TB/s): the bytes, by a little. This first
// version runs on the CUDA cores' f32 FMAs (67 TFLOP/s at most), so it is
// bound by its FMA rate, ~30x the bound; fp8 wgmma, whose accumulator keeps
// fewer bits than f32 (partial sums promoted every ~128 of K), is later
// work (PERF.md).

#include <cuda_fp8.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;  // output rows and columns per CTA
constexpr int kLd = kTile + 4;
constexpr int kStepK = 32;  // K elements (bytes) staged per step

enum Format : int { kE4M3 = 0, kE5M2 = 1 };

template <typename F>
__device__ __forceinline__ float widen(uint8_t bits) {
  F v;
  v.__x = bits;
  return static_cast<float>(v);
}

// rows [r0, r0 + 128), bytes [k0, k0 + 32) of a (rows, k) fp8 matrix ->
// f32 dst[c * kLd + r] (K-major); zero past `rows` and past `k_end`
template <typename F, bool kVec16>
__device__ __forceinline__ void stage(float* dst, const uint8_t* src, int r0,
                                      int rows, int k0, int k_end, int k) {
  if constexpr (kVec16) {
    // 128 rows x 2 chunks of 16 bytes; neighbouring threads take
    // neighbouring rows, so the transposed stores hit distinct banks
    const int r = threadIdx.x % kTile, half = threadIdx.x / kTile;
    const int kb = k0 + half * 16;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows && kb < k_end)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r0 + r) * k + kb);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&val);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      dst[(half * 16 + e) * kLd + r] = widen<F>(bytes[e]);
  } else {
    for (int idx = threadIdx.x; idx < kTile * kStepK; idx += kThreads) {
      const int r = idx % kTile, c = idx / kTile;
      uint8_t bits = 0;
      if (r0 + r < rows && k0 + c < k_end)
        bits = src[static_cast<long long>(r0 + r) * k + k0 + c];
      dst[c * kLd + r] = widen<F>(bits);
    }
  }
}

// kSplit: sum K range blockIdx.z (k_split long) and write the raw sums to
// out + blockIdx.z * m * n; else the whole K and the epilogue
template <typename FA, typename FB, bool kVec16, bool kSplit>
__global__ void __launch_bounds__(kThreads, 2) fp8_matmul_kernel(
    const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int m, int n, int k, int k_split) {
  __shared__ __align__(16) float as[kStepK * kLd];
  __shared__ __align__(16) float bs[kStepK * kLd];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(k, k_begin + k_split);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kStepK) {
    __syncthreads();  // the previous step's tiles are no longer read
    stage<FA, kVec16>(as, a, m0, m, k0, k_end, k);
    stage<FB, kVec16>(bs, b, n0, n, k0, k_end, k);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kStepK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 ta = *reinterpret_cast<const float4*>(
            as + kk * kLd + g * 64 + ty * 4);
        const float4 tb = *reinterpret_cast<const float4*>(
            bs + kk * kLd + g * 64 + tx * 4);
        av[g * 4 + 0] = ta.x;
        av[g * 4 + 1] = ta.y;
        av[g * 4 + 2] = ta.z;
        av[g * 4 + 3] = ta.w;
        bv[g * 4 + 0] = tb.x;
        bv[g * 4 + 1] = tb.y;
        bv[g * 4 + 2] = tb.z;
        bv[g * 4 + 3] = tb.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  if constexpr (kSplit) out += static_cast<long long>(blockIdx.z) * m * n;
  const float s = kSplit ? 1.f : *scale;
  const bool vec_out = n % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= m) continue;
    float* orow = out + static_cast<long long>(row) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = acc[i][h * 4 + e];
        if (!kSplit) {
          y[e] = __fmul_rn(y[e], s);
          if (bias != nullptr && col + e < n)
            y[e] = __fadd_rn(y[e], bias[col + e]);
        }
      }
      if (vec_out && col + 3 < n) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < n) orow[col + e] = y[e];
      }
    }
  }
}

// out = (sum over the `splits` K ranges of ws, in order) * scale + bias
__global__ void __launch_bounds__(kThreads) fp8_split_reduce_kernel(
    const float* __restrict__ ws, int splits,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int m, int n) {
  const long long total = static_cast<long long>(m) * n;
  const float s = *scale;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
    float acc = ws[i];
    for (int z = 1; z < splits; ++z) acc = __fadd_rn(acc, ws[z * total + i]);
    float y = __fmul_rn(acc, s);
    if (bias != nullptr) y = __fadd_rn(y, bias[i % n]);
    out[i] = y;
  }
}

template <typename FA, typename FB, bool kSplit>
void launch(const dim3& grid, bool vec16, const uint8_t* a, const uint8_t* b,
            const float* scale, const float* bias, float* out, int m, int n,
            int k, int k_split, cudaStream_t stream) {
  if (vec16)
    fp8_matmul_kernel<FA, FB, true, kSplit><<<grid, kThreads, 0, stream>>>(
        a, b, scale, bias, out, m, n, k, k_split);
  else
    fp8_matmul_kernel<FA, FB, false, kSplit><<<grid, kThreads, 0, stream>>>(
        a, b, scale, bias, out, m, n, k, k_split);
}

template <typename FA, typename FB>
cudaError_t run(const uint8_t* a, const uint8_t* b, const float* scale,
                const float* bias, float* out, float* workspace, int m,
                int n, int k, int k_split, bool vec16, cudaStream_t stream) {
  const int splits = (k + k_split - 1) / k_split;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  if (splits == 1) {
    launch<FA, FB, false>(grid, vec16, a, b, scale, bias, out, m, n, k,
                          k_split, stream);
    return cudaGetLastError();
  }
  if (workspace == nullptr) return cudaErrorInvalidValue;
  launch<FA, FB, true>(grid, vec16, a, b, scale, bias, workspace, m, n, k,
                       k_split, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(m) * n;
  const int blocks =
      static_cast<int>(std::min<long long>((total + kThreads - 1) / kThreads,
                                           4096));
  fp8_split_reduce_kernel<<<blocks, kThreads, 0, stream>>>(
      workspace, splits, scale, bias, out, m, n);
  return cudaGetLastError();
}

}  // namespace

// a: (M, K) fp8 in format a_fmt and b: (N, K) fp8 in format b_fmt (0 e4m3,
// 1 e5m2; e4m3 x e4m3 and e5m2 x e4m3 are built), both contiguous; scale:
// one f32; bias: (N,) contiguous f32 or null; out: (M, N) contiguous f32,
// every element written. K is summed in ranges of k_split (a multiple of
// 32): with more than one range, workspace holds ceil(K / k_split) * M * N
// f32 (else it may be null). Returns the first failing launch's
// cudaError_t.
extern "C" int jimm_fp8_matmul(const void* a, const void* b,
                               const void* scale, const void* bias, void* out,
                               void* workspace, int m, int n, int k,
                               int k_split, int a_fmt, int b_fmt,
                               void* stream) {
  if (m < 1 || n < 1 || k < 1 || k_split < kStepK || k_split % kStepK != 0 ||
      b_fmt != kE4M3)
    return cudaErrorInvalidValue;
  const bool vec16 = k % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  const auto* ps = static_cast<const float*>(scale);
  const auto* pbias = static_cast<const float*>(bias);
  auto* po = static_cast<float*>(out);
  auto* pw = static_cast<float*>(workspace);
  auto s = static_cast<cudaStream_t>(stream);
  switch (a_fmt) {
    case kE4M3:
      return run<__nv_fp8_e4m3, __nv_fp8_e4m3>(pa, pb, ps, pbias, po, pw, m,
                                               n, k, k_split, vec16, s);
    case kE5M2:
      return run<__nv_fp8_e5m2, __nv_fp8_e4m3>(pa, pb, ps, pbias, po, pw, m,
                                               n, k, k_split, vec16, s);
    default:
      return cudaErrorInvalidValue;
  }
}
