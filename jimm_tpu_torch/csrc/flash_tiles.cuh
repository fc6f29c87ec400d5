// f32 tile helpers of the flash backward kernels (flash_attention_bwd.cu:
// dq and dk/dv; flash_attention_dbias.cu: dbias). A CTA of 256 threads in a
// 16 x 16 layout: thread (ty, tx) owns rows ty*R..ty*R+R-1 of a resident
// tile and meets rows tx + 16*j of a streamed one. Tiles live in shared
// memory as f32 with the head dim zero-padded to DP and row stride DP + 4,
// which keeps the float4 reads free of bank conflicts.
#pragma once

#include "common.cuh"

namespace jimm::flash {

constexpr int kThreads = 256;

// rows [r0, r0 + R) of one head's (S, D) slice -> f32 shared tile with row
// stride DP + 4; rows >= n and columns >= d are zero
template <typename T, int DP, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0, int n,
                                          int d) {
  constexpr int LD = DP + 4;
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float val = 0.f;
    if (r0 + r < n && c < d)
      val = to_f32(src[static_cast<long long>(r0 + r) * row_stride + c]);
    dst[r * LD + c] = val;
  }
}

// load_tile, written for the compiler (as flash_attention.cu's
// load_tile_batched): kThreads is a multiple of DP, so a thread's column is
// fixed and its rows advance by kThreads / DP; it issues every load of its
// rows before their stores, so their latencies overlap instead of adding up
template <typename T, int DP, int R>
__device__ __forceinline__ void load_tile_batched(float* dst, const T* src,
                                                  long long row_stride,
                                                  int r0, int n, int d) {
  static_assert(kThreads % DP == 0, "a thread's column must be fixed");
  constexpr int LD = DP + 4, kRowStep = kThreads / DP, kSteps = R / kRowStep;
  const int c = threadIdx.x % DP, r = threadIdx.x / DP;
  const bool col_in = c < d;
  const T* base = src + static_cast<long long>(r0 + r) * row_stride + c;
  const long long step = kRowStep * row_stride;
  float val[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    val[s] = col_in && r0 + r + s * kRowStep < n ? to_f32(base[s * step])
                                                 : 0.f;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) dst[(r + s * kRowStep) * LD + c] = val[s];
}

// out[a][b] = A[a0 + a] . B[tx + 16 b] over DP columns (row stride DP + 4)
template <int DP, int NA, int NB>
__device__ __forceinline__ void tile_dots(float (&out)[NA][NB], const float* A,
                                          int a0, const float* B, int tx) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) out[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 av[NA], bv[NB];
#pragma unroll
    for (int a = 0; a < NA; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (a0 + a) * LD + c);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      bv[b] = *reinterpret_cast<const float4*>(B + (tx + 16 * b) * LD + c);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        out[a][b] = fmaf(av[a].x, bv[b].x, out[a][b]);
        out[a][b] = fmaf(av[a].y, bv[b].y, out[a][b]);
        out[a][b] = fmaf(av[a].z, bv[b].z, out[a][b]);
        out[a][b] = fmaf(av[a].w, bv[b].w, out[a][b]);
      }
  }
}

}  // namespace jimm::flash
