// Tile helpers shared by the int8-QK flash-attention kernels
// (flash_attention_int8.cu, flash_attention_int8_bwd.cu): staging int8 rows
// as words in shared memory, s32 score tiles with __dp4a, the dequantized
// score in the TPU kernel's order, and the f32 tile products of the FA2
// arrangement. Every CTA has 256 threads in a 16 x 16 layout (ty, tx): a
// thread owns rows a0 + a of the tile its CTA keeps resident and meets the
// streamed rows tx + 16 b.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace jimm {
namespace flash_int8 {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

using jimm::round_to;

// whether stage_i8 may read the rows of contiguous (B, S, N, D) int8
// tensors at these bases a word at a time
inline bool words_aligned(const void* a, const void* b, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 4 == 0;
}

// rows [r0, r0 + R) of one head's (S, D) int8 slice (row stride
// `row_stride` bytes) -> shared words dst[r * (DP / 4 + 4) + w], zero past
// row n and past byte d. `words`: d is a multiple of 4 and rows are 4-byte
// aligned, so a row is read a word at a time; else a byte at a time.
template <int DP, int R>
__device__ __forceinline__ void stage_i8(int* dst, const int8_t* src,
                                         long long row_stride, int r0, int n,
                                         int d, bool words) {
  constexpr int DW = DP / 4, LDW = DW + 4;
  if (words) {
    for (int idx = threadIdx.x; idx < R * DW; idx += kThreads) {
      const int r = idx / DW, w = idx % DW;
      int val = 0;
      if (r0 + r < n && 4 * w < d)
        val = *reinterpret_cast<const int*>(
            src + static_cast<long long>(r0 + r) * row_stride + 4 * w);
      dst[r * LDW + w] = val;
    }
  } else {
    auto* bytes = reinterpret_cast<int8_t*>(dst);
    for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      int8_t val = 0;
      if (r0 + r < n && c < d)
        val = src[static_cast<long long>(r0 + r) * row_stride + c];
      bytes[r * LDW * 4 + c] = val;
    }
  }
}

// rows [r0, r0 + R) of one head's (S, D) slice in T -> f32 shared tile with
// row stride DP + 4; rows >= n and columns >= d are zero
template <typename T, int DP, int R>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
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

// the staged int8 rows times their per-row scales, rounded to T, as an f32
// tile with row stride DP + 4 (the TPU kernel's _dequant_operand: the
// backward contracts ds against the dequantized operand in the storage
// dtype)
template <typename T, int DP, int R>
__device__ __forceinline__ void dequant_rows(float* dst, const int* src,
                                             const float* row_scale) {
  constexpr int LDW = DP / 4 + 4, LD = DP + 4;
  const auto* bytes = reinterpret_cast<const int8_t*>(src);
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    dst[r * LD + c] = round_to<T>(
        __fmul_rn(static_cast<float>(bytes[r * LDW * 4 + c]), row_scale[r]));
  }
}

// out[a][b] = A[a0 + a] . B[tx + 16 b] over DP int8 columns, exact in s32
template <int DP, int NA, int NB>
__device__ __forceinline__ void tile_dots_i8(int (&out)[NA][NB], const int* A,
                                             int a0, const int* B, int tx) {
  constexpr int DW = DP / 4, LDW = DW + 4;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) out[a][b] = 0;
#pragma unroll
  for (int w = 0; w < DW; w += 4) {
    int4 av[NA], bv[NB];
#pragma unroll
    for (int a = 0; a < NA; ++a)
      av[a] = *reinterpret_cast<const int4*>(A + (a0 + a) * LDW + w);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      bv[b] = *reinterpret_cast<const int4*>(B + (tx + 16 * b) * LDW + w);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        out[a][b] = __dp4a(av[a].x, bv[b].x, out[a][b]);
        out[a][b] = __dp4a(av[a].y, bv[b].y, out[a][b]);
        out[a][b] = __dp4a(av[a].z, bv[b].z, out[a][b]);
        out[a][b] = __dp4a(av[a].w, bv[b].w, out[a][b]);
      }
  }
}

// the dequantized, scaled score of the TPU kernel, in its order:
// ((float(s) * q_scale) * k_scale) * sm_scale, each product rounded
__device__ __forceinline__ float dequant_score(int s, float q_scale,
                                               float k_scale, float sm_scale) {
  return __fmul_rn(
      __fmul_rn(__fmul_rn(__int2float_rn(s), q_scale), k_scale), sm_scale);
}

// out[a][b] = A[a0 + a] . B[tx + 16 b] over DP f32 columns (row stride
// DP + 4)
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

// acc[a][4g + e] += sum_c P[a0 + a][c] * B[c][64 g + 4 tx + e] for c < NC;
// P has row stride NC + 4, B row stride DP + 4
template <int DP, int NA, int NC>
__device__ __forceinline__ void tile_accum(float (&acc)[NA][DP / 16],
                                           const float* P, int a0,
                                           const float* B, int tx) {
  constexpr int LD = DP + 4, LDP = NC + 4, DG = DP / 64;
#pragma unroll 2
  for (int c = 0; c < NC; c += 4) {
    float p[NA][4];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const float4 t = *reinterpret_cast<const float4*>(P + (a0 + a) * LDP + c);
      p[a][0] = t.x;
      p[a][1] = t.y;
      p[a][2] = t.z;
      p[a][3] = t.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 bv = *reinterpret_cast<const float4*>(
            B + (c + cc) * LD + g * 64 + tx * 4);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          acc[a][g * 4 + 0] = fmaf(p[a][cc], bv.x, acc[a][g * 4 + 0]);
          acc[a][g * 4 + 1] = fmaf(p[a][cc], bv.y, acc[a][g * 4 + 1]);
          acc[a][g * 4 + 2] = fmaf(p[a][cc], bv.z, acc[a][g * 4 + 2]);
          acc[a][g * 4 + 3] = fmaf(p[a][cc], bv.w, acc[a][g * 4 + 3]);
        }
      }
  }
}

// rows a0..a0+NA-1 of acc (times mul) -> rows r0 + a0 + a < n of the
// contiguous (B, S, N, D) output, columns < d
template <typename T, int DP, int NA>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[NA][DP / 16],
                                           float mul, int bi, int h, int heads,
                                           int r0, int a0, int n, int d,
                                           int tx) {
  constexpr int DG = DP / 64;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int row = r0 + a0 + a;
    if (row >= n) continue;
    T* orow = out + (static_cast<long long>(bi) * n + row) * heads * d +
              static_cast<long long>(h) * d;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tx * 4 + e;
        if (col < d) orow[col] = from_f32<T>(acc[a][g * 4 + e] * mul);
      }
  }
}

}  // namespace flash_int8
}  // namespace jimm
