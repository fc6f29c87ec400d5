// int8 x int8 -> s32 matmul with a fused dequantizing epilogue for Hopper
// (sm_90a): y = ((float)(x_q . w_q) * xs[m]) * ws[n] + b[n], then relu or
// exact-erf gelu, f32 out.
//
// Replaces the TPU kernel jimm_tpu/ops/int8_matmul.py::_matmul_kernel
// (kernel row 11; launched by int8_matmul through pl.pallas_call), the
// W8A8 serving path of QuantLinear. Same numerics: the s32 accumulation is
// exact (the TPU's MXU int32 dot; here s8 wgmma, whose s32 sums are exact:
// K * 127^2 = 4.95e7 at K = 3072, far below 2^31, so no .satfinite); the
// accumulator converts to f32 rounding to nearest even (__int2float_rn, as
// XLA's astype does: for K = 3072 |acc| reaches 3072 * 127^2 > 2^24); the
// epilogue multiplies by the row scale, then by the column scale, then adds
// the bias, in the order of _dequant, each step rounded on its own
// (__fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA). Then
// this kernel equals its plain version bit for bit, up to gelu's erff.
//
// Layout: x_q is (M, K) and w_q is (N, K), both K-contiguous int8 (the
// nn.Linear weight layout; the TPU kernel takes (K, N), the same numbers):
// the K-major layout, the only one 8-bit wgmma reads. K is a multiple of 16
// and both bases are 16-byte aligned (a TMA row stride must be): the
// wrapper zero-pads K otherwise (a zero product adds nothing), and this
// entry point refuses such inputs.
//
// Design: one CTA of `kWarpgroups` warpgroups per (64 * kWarpgroups) x
// kBlockN output tile, each warpgroup 64 rows. Thread 0 keeps kStages
// stages in flight: each a TMA 2-D tiled load of a box 128 bytes of K wide
// of each operand, 128-byte swizzled (CU_TENSOR_MAP_SWIZZLE_128B), which is
// the K-major layout wgmma reads, completing on the stage's mbarrier; TMA
// zero-fills rows past M or N and bytes past K, so ragged edges need no
// masking on the load side. No CUDA-core pass touches the operands: each
// warpgroup runs four wgmma.m64n128k32.s32.s8.s8 per stage and 128 columns
// (the descriptor's start advanced 32 bytes for each k32 step) straight
// from the TMA buffers, into s32 registers. After the products of a stage
// are done in every warpgroup, thread 0 refills it. The column scales and
// bias of the tile are staged in shared memory before the loop, the row
// scales in registers; the epilogue writes float2 pairs from the
// accumulator fragment (a quad of lanes writes 32 contiguous bytes of a
// row).
//
// Tiles: 128 x 128 with two warpgroups and three stages (98 KB, two CTAs
// an SM) for M > 64; 64 x 128 with one warpgroup for M <= 64 (the MAP
// head's M = 32). PERF.md records the side-by-side timings
// (kernel_ab) of the other shapes tried.
//
// What bounds it on the H100: at the served shapes (M = 8192, K = 768 or
// 3072) the f32 output bytes and the 2*M*N*K operations take about the same
// time at the card's peaks (fc1: 100 MB of output, 0.030 ms; 38.7 GOP at
// 1,979 TOPS, 0.020 ms). The tensor cores run the products and TMA moves
// the operands; what is left to the threads is the epilogue and the
// per-stage barriers.

#include <cstdint>

#include "common.cuh"
#include "hopper_tma.cuh"

namespace {

using jimm::fence_operand;
using jimm::mbar_expect_tx;
using jimm::mbar_init;
using jimm::mbar_wait;
using jimm::smem_desc;
using jimm::smem_u32;
using jimm::tma_load;

constexpr int kStageK = 128;  // K bytes a stage: one 128-byte swizzle atom
constexpr int kInstrN = 128;  // columns of one wgmma
// the tile choice (PERF.md section 6 has the side-by-side timings)
constexpr int kSmallM = 64;       // M <= this: one warpgroup, 64 rows
constexpr int kBlockN = 128;      // columns a CTA
constexpr int kStages = 3;        // stages in flight

enum Activation : int { kNone = 0, kRelu = 1, kGelu = 2 };

template <int kWarpgroups>
struct Tile {
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kRows = 64 * kWarpgroups;
  static constexpr int kABytes = kRows * kStageK;
  static constexpr int kStageBytes = (kRows + kBlockN) * kStageK;
  // the ring, its barriers, the column scales and bias, and 1 KB to align
  // the ring to the 1024-byte period of the 128-byte swizzle
  static constexpr int kSmemBytes =
      kStages * kStageBytes + kStages * 8 + 2 * kBlockN * 4 + 1024;
  // two CTAs an SM where their shared memory fits (228 KB an SM, 1 KB of
  // it reserved per CTA)
  static constexpr int kMinBlocks =
      2 * (kSmemBytes + 1024) <= 228 * 1024 ? 2 : 1;
};

// d += A (64 x 32, K-major at da) . B (128 x 32, K-major at db)^T, s8
// operands, s32 accumulator
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float activate(float y, int activation) {
  if (activation == kRelu) return fmaxf(y, 0.f);
  if (activation == kGelu)
    return __fmul_rn(__fmul_rn(y, 0.5f),
                     __fadd_rn(1.f, erff(__fmul_rn(y, 0.70710678118654752f))));
  return y;
}

template <int kWarpgroups>
__global__ void __launch_bounds__(Tile<kWarpgroups>::kThreads,
                                  Tile<kWarpgroups>::kMinBlocks)
    int8_matmul_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const float* __restrict__ xs,
                       const float* __restrict__ ws,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int m, int n, int k,
                       int activation) {
  using T = Tile<kWarpgroups>;
  // wgmma column blocks: 1 as built (2 in the 128 x 256 tile PERF.md
  // compares)
  constexpr int kSub = kBlockN / kInstrN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kStages * T::kStageBytes);
  float* col_scale = reinterpret_cast<float*>(full + kStages);
  float* col_bias = col_scale + kBlockN;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int m0 = blockIdx.y * T::kRows, n0 = blockIdx.x * kBlockN;
  const int steps = (k + kStageK - 1) / kStageK;

  const CUtensorMap* px = &map_x;
  const CUtensorMap* pw = &map_w;
  auto issue = [&](int s, int step) {
    unsigned char* a = ring + s * T::kStageBytes;
    mbar_expect_tx(&full[s], T::kStageBytes);
    tma_load(a, px, &full[s], step * kStageK, m0);
    tma_load(a + T::kABytes, pw, &full[s], step * kStageK, n0);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < kBlockN; i += T::kThreads) {
    const int col = n0 + i;
    col_scale[i] = col < n ? ws[col] : 0.f;
    col_bias[i] = bias != nullptr && col < n ? bias[col] : 0.f;
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages && s < steps; ++s) issue(s, s);

  // accumulator layout of m64nNk32: element 4j + 2h + e of a thread is row
  // 16 * warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e of the
  // warpgroup's 64 x 128 block
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  float row_scale[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row_scale[h] = row0 + 8 * h < m ? xs[row0 + 8 * h] : 0.f;

  int acc[kSub][64];
#pragma unroll
  for (int b = 0; b < kSub; ++b)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[b][i] = 0;

  for (int step = 0; step < steps; ++step) {
    const int s = step % kStages;
    const unsigned char* a = ring + s * T::kStageBytes + wg * 64 * kStageK;
    const unsigned char* w = ring + s * T::kStageBytes + T::kABytes;
    mbar_wait(&full[s], (step / kStages) & 1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kStageK / 32; ++kk)
#pragma unroll
      for (int b = 0; b < kSub; ++b)
        wgmma_m64n128k32_s8(acc[b], smem_desc(a + kk * 32),
                            smem_desc(w + b * kInstrN * kStageK + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // this warpgroup's products of step - 1 are done
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (step > 0) {
      // and every warpgroup's: refill the stage step - 1 read
      __syncthreads();
      if (tid == 0 && step - 1 + kStages < steps)
        issue((step - 1) % kStages, step - 1 + kStages);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int b = 0; b < kSub; ++b)
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[b][i]);

  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= m) continue;
    float* orow = out + static_cast<long long>(row) * n;
#pragma unroll
    for (int b = 0; b < kSub; ++b)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = b * kInstrN + 8 * j + 2 * (lane % 4);
        const int col = n0 + c;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[b][4 * j + 2 * h + e]),
                                     row_scale[h]),
                           col_scale[c + e]);
          if (bias != nullptr) y[e] = __fadd_rn(y[e], col_bias[c + e]);
          y[e] = activate(y[e], activation);
        }
        if (pairs && col + 1 < n) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(y[0], y[1]);
        } else {
          if (col < n) orow[col] = y[0];
          if (col + 1 < n) orow[col + 1] = y[1];
        }
      }
  }
}

template <int kWarpgroups>
cudaError_t launch(const void* x_q, const float* xs, const void* w_q,
                   const float* ws, const float* bias, float* out, int m,
                   int n, int k, int activation, cudaStream_t stream) {
  using T = Tile<kWarpgroups>;
  const dim3 grid((n + kBlockN - 1) / kBlockN,
                  (m + T::kRows - 1) / T::kRows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  if (!jimm::byte_operand_map(&map_x, x_q, m, k, kStageK, T::kRows,
                              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !jimm::byte_operand_map(&map_w, w_q, n, k, kStageK, kBlockN,
                              CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kernel = int8_matmul_kernel<kWarpgroups>;
  const cudaError_t err = jimm::allow_smem(kernel, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      map_x, map_w, xs, ws, bias, out, m, n, k, activation);
  return cudaGetLastError();
}

}  // namespace

// x_q: (M, K) int8 and w_q: (N, K) int8, both contiguous, K a multiple of
// 16 and both bases 16-byte aligned; x_scale: (M,), w_scale: (N,) and
// bias: (N,) or null, contiguous f32; out: (M, N) contiguous f32, every
// element written. activation: 0 none, 1 relu, 2 gelu (exact erf). Returns
// the launch's cudaError_t, or cudaErrorInvalidValue for inputs the kernel
// does not take.
extern "C" int jimm_int8_matmul(const void* x_q, const void* x_scale,
                                const void* w_q, const void* w_scale,
                                const void* bias, void* out, int m, int n,
                                int k, int activation, void* stream) {
  if (m < 1 || n < 1 || k < 1 || k % 16 != 0 || activation < kNone ||
      activation > kGelu || reinterpret_cast<uintptr_t>(x_q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w_q) % 16 != 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float*>(x_scale);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (m <= kSmallM)
    return launch<1>(x_q, xs, w_q, ws, b, o, m, n, k, activation, s);
  return launch<2>(x_q, xs, w_q, ws, b, o, m, n, k, activation, s);
}
