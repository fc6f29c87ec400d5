// int8 x int8 -> s32 matmul with a fused dequantizing epilogue for Hopper
// (sm_90a): y = ((float)(x_q . w_q) * xs[m]) * ws[n] + b[n], then relu or
// exact-erf gelu, f32 out.
//
// Replaces the TPU kernel jimm_tpu/ops/int8_matmul.py::_matmul_kernel
// (kernel row 11; launched by int8_matmul through pl.pallas_call), the
// W8A8 serving path of QuantLinear. Same numerics: the s32 accumulation is
// exact (the TPU's MXU int32 dot; here __dp4a over 4-byte groups); the
// accumulator converts to f32 rounding to nearest even (__int2float_rn, as
// XLA's astype does: for K = 3072 |acc| reaches 3072 * 127^2 > 2^24); the
// epilogue multiplies by the row scale, then by the column scale, then adds
// the bias, in the order of _dequant, each step rounded on its own
// (__fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA). Then
// this kernel equals its plain version bit for bit, up to gelu's erff.
//
// Layout: x_q is (M, K) and w_q is (N, K), both K-contiguous int8 (the
// nn.Linear weight layout; the TPU kernel takes (K, N), the same numbers),
// so each dot product is __dp4a over words of both operands. Rows of odd K
// (7, 100, 769) are not 4-byte aligned: every k step stages 64 bytes of 64
// rows of each operand in shared memory, zero-padded past K and past M/N,
// and the dot products read whole words from there. When K is a multiple of
// 16 and both bases are 16-byte aligned (every served shape) the staging
// copies 16 bytes a thread with one load; otherwise byte by byte.
//
// Design: one CTA of 256 threads per 64 x 64 output tile, looping over K in
// 64-byte steps. Thread (ty, tx) of the 16 x 16 layout owns rows
// 4*ty..4*ty+3 and columns tx + 16*j, j < 4 (16 s32 sums in registers); the
// staged rows have a stride of 20 words, so the 16-byte shared-memory reads
// of 8 neighbouring threads fall in distinct banks.
//
// What bounds it on the H100: at the served shapes (M = 8192, K = 768 or
// 3072) the f32 output bytes and the 2*M*N*K operations take about the same
// time at the card's peaks (fc1: 100 MB of output, 0.030 ms; 38.7 GOP at
// 1,979 TOPS, 0.020 ms). The tensor cores (mma.sync s8 / wgmma) reach those
// peaks; __dp4a on the CUDA cores runs at a fraction of them, so this first
// version is bound by its dp4a instruction rate. The tensor-core version is
// later work (PERF.md).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 64;           // output rows and columns per CTA
constexpr int kStepBytes = 64;      // K bytes per step
constexpr int kStepWords = kStepBytes / 4;
constexpr int kLdw = kStepWords + 4;  // staged row stride in words
constexpr int kThreads = 256;

enum Activation : int { kNone = 0, kRelu = 1, kGelu = 2 };

// rows [r0, r0 + 64), bytes [k0, k0 + 64) of a (rows, K) int8 matrix ->
// shared words dst[r * kLdw + w]; zero past `rows` and past K
template <bool kVec16>
__device__ __forceinline__ void stage(int* dst, const int8_t* src, int r0,
                                      int rows, int k0, int k) {
  if constexpr (kVec16) {
    // 64 rows x 4 chunks of 16 bytes: one chunk a thread
    const int r = threadIdx.x >> 2, chunk = threadIdx.x & 3;
    const int kb = k0 + chunk * 16;
    int4 val = make_int4(0, 0, 0, 0);
    if (r0 + r < rows && kb < k)
      val = *reinterpret_cast<const int4*>(
          src + static_cast<long long>(r0 + r) * k + kb);
    *reinterpret_cast<int4*>(dst + r * kLdw + chunk * 4) = val;
  } else {
    auto* bytes = reinterpret_cast<int8_t*>(dst);
    for (int idx = threadIdx.x; idx < kTile * kStepBytes; idx += kThreads) {
      const int r = idx / kStepBytes, c = idx % kStepBytes;
      int8_t val = 0;
      if (r0 + r < rows && k0 + c < k)
        val = src[static_cast<long long>(r0 + r) * k + k0 + c];
      bytes[r * kLdw * 4 + c] = val;
    }
  }
}

template <bool kVec16>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const int8_t* __restrict__ wq, const float* __restrict__ ws,
    const float* __restrict__ bias, float* __restrict__ out, int m, int n,
    int k, int activation) {
  __shared__ __align__(16) int xs_tile[kTile * kLdw];
  __shared__ __align__(16) int ws_tile[kTile * kLdw];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kStepBytes) {
    __syncthreads();  // the previous step's tiles are no longer read
    stage<kVec16>(xs_tile, xq, m0, m, k0, k);
    stage<kVec16>(ws_tile, wq, n0, n, k0, k);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kStepWords; w += 4) {
      int4 xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const int4*>(xs_tile + (ty * 4 + i) * kLdw + w);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[j] = *reinterpret_cast<const int4*>(ws_tile + (tx + 16 * j) * kLdw + w);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __dp4a(xv[i].x, wv[j].x, acc[i][j]);
          acc[i][j] = __dp4a(xv[i].y, wv[j].y, acc[i][j]);
          acc[i][j] = __dp4a(xv[i].z, wv[j].z, acc[i][j]);
          acc[i][j] = __dp4a(xv[i].w, wv[j].w, acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
    const float x_scale = xs[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= n) continue;
      float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), x_scale),
                          ws[col]);
      if (bias != nullptr) y = __fadd_rn(y, bias[col]);
      if (activation == kRelu) {
        y = fmaxf(y, 0.f);
      } else if (activation == kGelu) {
        y = __fmul_rn(__fmul_rn(y, 0.5f),
                      __fadd_rn(1.f, erff(__fmul_rn(y, 0.70710678118654752f))));
      }
      out[static_cast<long long>(row) * n + col] = y;
    }
  }
}

}  // namespace

// x_q: (M, K) int8 and w_q: (N, K) int8, both contiguous; x_scale: (M,),
// w_scale: (N,) and bias: (N,) or null, contiguous f32; out: (M, N)
// contiguous f32, every element written. activation: 0 none, 1 relu,
// 2 gelu (exact erf). Returns the launch's cudaError_t.
extern "C" int jimm_int8_matmul(const void* x_q, const void* x_scale,
                                const void* w_q, const void* w_scale,
                                const void* bias, void* out, int m, int n,
                                int k, int activation, void* stream) {
  if (m < 1 || n < 1 || k < 1 || activation < kNone || activation > kGelu ||
      (m + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  const bool vec16 = k % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x_q) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w_q) % 16 == 0;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xq = static_cast<const int8_t*>(x_q);
  const auto* wq = static_cast<const int8_t*>(w_q);
  const auto* xs = static_cast<const float*>(x_scale);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (vec16)
    int8_matmul_kernel<true><<<grid, kThreads, 0, s>>>(xq, xs, wq, ws, b, o,
                                                       m, n, k, activation);
  else
    int8_matmul_kernel<false><<<grid, kThreads, 0, s>>>(xq, xs, wq, ws, b, o,
                                                        m, n, k, activation);
  return cudaGetLastError();
}
