// fp8 x fp8 -> f32 matmul with a fused dequantizing epilogue for Hopper
// (sm_90a): out = (a . b^T) * scale + bias[n], f32 out.
//
// Replaces the TPU kernel jimm_tpu/ops/fp8_matmul.py::_matmul_kernel
// (kernel row 12; launched by _fp8_gemm through pl.pallas_call), the GEMM
// of every Fp8Linear under the fp8_hybrid training policy: e4m3 x e4m3 in
// the forward, e5m2 (the gradient) x e4m3 (the saved residual) for dx and
// dw. Same numerics as the TPU's MXU dot with preferred_element_type f32:
// each fp8 value is widened exactly, every product is exact, the sum is
// kept in an f32 accumulator; the epilogue multiplies by the one combined
// per-tensor scale, then adds the bias, as _dequant then `+ b`, each step
// rounded on its own (__fmul_rn / __fadd_rn, so nvcc cannot contract them
// into an FMA).
//
// Layout: a is (M, K) and b is (N, K), both K-contiguous (the nn.Linear
// weight layout; the TPU kernel takes (K, N), the same numbers): the
// K-major layout wgmma reads both operands in. K is a multiple of 16 and
// both bases are 16-byte aligned (a TMA row stride must be): the wrapper
// zero-pads K otherwise, and this entry point refuses such inputs. scale is
// one f32 read from device memory, so a delayed or dynamic scale computed
// on the card never visits the host.
//
// Design: one CTA of two warpgroups per 128 x 128 output tile, two CTAs an
// SM (97 KB of shared memory each), so one CTA's loads, widening and
// barriers overlap the other's products. Thread 0 keeps kStages stages of
// fp8 in flight: each a TMA 2-D tiled load of a 128-row x 64-byte box of
// each operand (unswizzled: a thread reads whole 16-byte chunks, free of
// bank conflicts), completing on the stage's mbarrier; TMA zero-fills rows
// past M or N and bytes past K, so ragged edges need no masking on the load
// side. The CTA widens each arrived stage to f16 in shared memory (exact
// for both formats), into the K-major, 128-byte-swizzled layout of f16
// wgmma, and each warpgroup multiplies its 64 rows of A by the 128 rows of
// B with four wgmma.m64n128k16.f32.f16.f16 from there, into one f32
// accumulator. The widened stages are double-buffered, so one stage is
// widened while the previous one's products run. Side by side on an H100
// 80GB HBM3, this took 0.391 ms at fc1's forward where 128-wide stages
// and one CTA an SM (225 KB) took 0.513.
//
// Why f16 wgmma on widened values, not fp8 wgmma on the bytes: the fp8
// tensor-core instructions sum their products in an accumulator of about
// 14 significant bits (products aligned to the largest and truncated
// toward zero: on an H100 80GB HBM3, 65536 + 31 x (-1) in one instruction
// reads back 65536). That version, with its sums promoted into f32 every
// 128 of K, then every 32 (each instruction), kept to its own derived
// bound but moved the fp8_hybrid step's amax histories 2.9e-4, then
// 1.1e-4, of their values from the plain version's (chip_smoke.py phase
// 9(a), whose limit is 1e-4). f16 wgmma accumulates with f32's bits, so
// the kernel differs from its plain version (an f32 matmul of the widened
// values) only by f32 rounding in another order;
// ops/fp8_matmul.py::gemm_error_bound derives the bound the card tests and
// chip_smoke.py hold it to.
//
// An output with less than four waves of tiles and a long K (the dw GEMMs:
// a 768 x 768 weight gradient summed over 32768 token rows is 36 tiles)
// splits K into ranges of whole stages, one CTA per (tile, range), each
// writing its raw f32 sums to a workspace; a second kernel adds the ranges
// in order and applies the epilogue (no atomics: the result does not depend
// on scheduling). The wrapper picks the ranges (k_range) and allocates the
// workspace.
//
// What bounds it on the H100: at the training shapes the bytes, by a
// little (fc1's forward, 32768 x 768 x 3072: 430 MB of fp8 operands and
// f32 output, 0.128 ms at 3.35 TB/s, against 154.6 GFLOP at 1,979 TFLOP/s
// fp8, 0.078 ms; 0.156 ms at f16's 989). The f32 output dominates the
// bytes; the operands come from L2 for every tile after the first that
// shares them (the grid walks N fastest, so neighbouring CTAs share their A
// rows). The tensor cores run the products (not the CUDA cores' 67
// TFLOP/s of f32 FMA) and TMA moves the operands without a thread's
// registers or instructions; what holds the kernel back is shared-memory
// traffic (the widened operands are twice the bytes, written once and
// read by both warpgroups) and the CUDA cores' share of each stage
// (widening, barriers). Not done: A widened into registers, warp
// specialisation with setmaxnreg, persistent CTAs, cluster multicast
// (PERF.md).

#include <cuda.h>
#include <cuda_fp8.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper_tma.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTile = 128;     // output rows and columns per CTA
constexpr int kStageK = 64;    // K a stage: one f16 swizzle atom wide
constexpr int kStages = 2;     // fp8 stages in flight
constexpr int kOperandBytes = kTile * kStageK;  // one operand's fp8 box
constexpr int kStageBytes = 2 * kOperandBytes;
// a stage widened to f16: per operand a 128-row x 64-K tile, one column
// of 128-byte swizzle atoms
constexpr int kHalfBytes = kTile * kStageK * 2;
constexpr int kWideBytes = 2 * kHalfBytes;
// the fp8 ring, two widened stages, the ring's barriers, and 1 KB to align
// the widened tiles to the 1024-byte period of the 128-byte swizzle
constexpr int kSmemBytes =
    kStages * kStageBytes + 2 * kWideBytes + kStages * 8 + 1024;

enum Format : int { kE4M3 = 0, kE5M2 = 1 };

using jimm::fence_operand;
using jimm::mbar_expect_tx;
using jimm::mbar_init;
using jimm::mbar_wait;
using jimm::smem_desc;
using jimm::smem_u32;
using jimm::tma_load;

// d += A (64 x 16, K-major at da) . B (128 x 16, K-major at db)^T, f16
// operands, f32 accumulator
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// four fp8 values (one word, the low byte first) as f16 pairs, exactly:
// lo holds bytes 0, 1 and hi bytes 2, 3 (cvt of fp8x2 to f16x2, timed on
// an H100 against a byte-permute-and-multiply form that gives the same
// bits: 0.5256 against 0.6167 ms at fc1's forward)
template <bool kE5M2>
__device__ __forceinline__ void widen4(uint32_t x, uint32_t& lo,
                                       uint32_t& hi) {
  auto pair = [](uint32_t two) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(two & 0xffffu),
        kE5M2 ? __NV_E5M2 : __NV_E4M3);
    return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
  };
  lo = pair(x);
  hi = pair(x >> 16);
}

// A stage's fp8 tiles (TMA's layout: row r at r * 64 bytes) into their
// f16 tiles (wgmma's K-major layout with 128-byte swizzle: row r's 16-byte
// chunk c at r * 128 + (c ^ (r & 7)) * 16). A thread takes whole 16-byte
// chunks, 16 fp8 in and two chunks of 8 f16 out, two of A and two of B, all
// loaded before the first is widened.
template <bool kE5M2A>
__device__ __forceinline__ void widen_stage(const unsigned char* fp8_a,
                                            const unsigned char* fp8_b,
                                            unsigned char* wide_a,
                                            unsigned char* wide_b) {
  constexpr int kChunks = kTile * 4 / kThreads;  // per operand and thread
  uint4 v[2][kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / 4, c = idx % 4, off = r * 64 + c * 16;
    v[0][i] = *reinterpret_cast<const uint4*>(fp8_a + off);
    v[1][i] = *reinterpret_cast<const uint4*>(fp8_b + off);
  }
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / 4, c = idx % 4, sw = r & 7;
      const uint32_t in[4] = {v[o][i].x, v[o][i].y, v[o][i].z, v[o][i].w};
      uint32_t w[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (o == 0)
          widen4<kE5M2A>(in[q], w[2 * q], w[2 * q + 1]);
        else
          widen4<false>(in[q], w[2 * q], w[2 * q + 1]);
      }
      unsigned char* row =
          (o == 0 ? wide_a : wide_b) + r * 128;
      const int c0 = 2 * c;
      *reinterpret_cast<uint4*>(row + ((c0 ^ sw) * 16)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ sw) * 16)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
}

// kSplit: sum K range blockIdx.z (k_split long, whole stages) and write the
// raw sums to out + blockIdx.z * m * n; else the whole K and the epilogue
template <bool kE5M2A, bool kSplit>
__global__ void __launch_bounds__(kThreads, 2) fp8_matmul_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int m, int n, int k, int k_split) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* wide = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(wide + 2 * kWideBytes);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(k, k_begin + k_split);
  const int steps = (k_end - k_begin + kStageK - 1) / kStageK;

  auto stage_a = [&](int s) { return ring + s * kStageBytes; };
  auto stage_b = [&](int s) {
    return ring + s * kStageBytes + kOperandBytes;
  };
  const CUtensorMap* pa = &map_a;
  const CUtensorMap* pb = &map_b;
  auto issue = [&](int s, int step) {
    mbar_expect_tx(&full[s], kStageBytes);
    const int k0 = k_begin + step * kStageK;
    tma_load(stage_a(s), pa, &full[s], k0, m0);
    tma_load(stage_b(s), pb, &full[s], k0, n0);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages && s < steps; ++s) issue(s, s);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // the epilogue's scale and this thread's 32 bias columns, loaded while
  // the products run (read at the end, their latency cost fc1's forward a
  // third of its time)
  float sc = 1.f, bias_v[16][2] = {};
  if constexpr (!kSplit) {
    sc = *scale;
    if (bias != nullptr) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * (lane % 4) + e;
          if (col < n) bias_v[j][e] = bias[col];
        }
    }
  }

  for (int step = 0; step < steps; ++step) {
    const int s = step % kStages;
    unsigned char* wa = wide + (step % 2) * kWideBytes;
    unsigned char* wb = wa + kHalfBytes;
    // every thread has seen its products of step - 2, which read this
    // widened buffer, complete (wait_group 1 below)
    __syncthreads();
    mbar_wait(&full[s], (step / kStages) & 1);
    widen_stage<kE5M2A>(stage_a(s), stage_b(s), wa, wb);
    // the generic-proxy writes of the widened stage, before wgmma's
    // async-proxy reads of it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the fp8 stage is read: refill it
    if (tid == 0 && step + kStages < steps) issue(s, step + kStages);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kStageK / 16; ++kk) {
      // k16 step kk: 32 bytes into each 128-byte row
      const int off = kk * 32;
      wgmma_m64n128k16(acc, smem_desc(wa + off + wg * 64 * 128),
                       smem_desc(wb + off));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
  const float(&total)[64] = acc;

  // accumulator layout of m64nNk16: element 4j + 2h + e of a thread is row
  // 16 * warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e of the
  // warpgroup's 64 x 128 tile
  if constexpr (kSplit) out += static_cast<long long>(blockIdx.z) * m * n;
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (row >= m) continue;
    float* orow = out + static_cast<long long>(row) * n;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      float y[2] = {total[4 * j + 2 * h], total[4 * j + 2 * h + 1]};
      if (!kSplit) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = __fmul_rn(y[e], sc);
          if (bias != nullptr) y[e] = __fadd_rn(y[e], bias_v[j][e]);
        }
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

// the (rows, k) byte matrix at base as 128-row x 64-byte boxes,
// unswizzled; out-of-bounds elements read as zero
bool operand_map(CUtensorMap* map, const void* base, int rows, int k) {
  return jimm::byte_operand_map(map, base, rows, k, kStageK, kTile,
                                CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <bool kE5M2A, bool kSplit>
cudaError_t launch(const dim3& grid, const CUtensorMap& map_a,
                   const CUtensorMap& map_b, const float* scale,
                   const float* bias, float* out, int m, int n, int k,
                   int k_split, cudaStream_t stream) {
  auto kernel = fp8_matmul_kernel<kE5M2A, kSplit>;
  const cudaError_t err = jimm::allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_b, scale, bias,
                                                 out, m, n, k, k_split);
  return cudaGetLastError();
}

template <bool kE5M2A>
cudaError_t run(const CUtensorMap& map_a, const CUtensorMap& map_b,
                const float* scale, const float* bias, float* out,
                float* workspace, int m, int n, int k, int k_split,
                cudaStream_t stream) {
  const int splits = (k + k_split - 1) / k_split;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  if (splits == 1)
    return launch<kE5M2A, false>(grid, map_a, map_b, scale, bias, out, m, n,
                                 k, k_split, stream);
  if (workspace == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = launch<kE5M2A, true>(grid, map_a, map_b, scale, bias,
                                         workspace, m, n, k, k_split, stream);
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
// 1 e5m2; e4m3 x e4m3 and e5m2 x e4m3 are built), both contiguous, K a
// multiple of 16 and both bases 16-byte aligned; scale: one f32; bias: (N,)
// contiguous f32 or null; out: (M, N) contiguous f32, every element
// written. K is summed in ranges of k_split (a multiple of 128): with more
// than one range, workspace holds ceil(K / k_split) * M * N f32 (else it
// may be null). Returns the first failing launch's cudaError_t, or
// cudaErrorInvalidValue for inputs the kernel does not take.
extern "C" int jimm_fp8_matmul(const void* a, const void* b,
                               const void* scale, const void* bias, void* out,
                               void* workspace, int m, int n, int k,
                               int k_split, int a_fmt, int b_fmt,
                               void* stream) {
  if (m < 1 || n < 1 || k < 1 || k % 16 != 0 || k_split < kStageK ||
      k_split % kStageK != 0 || b_fmt != kE4M3 ||
      (a_fmt != kE4M3 && a_fmt != kE5M2) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!operand_map(&map_a, a, m, k) || !operand_map(&map_b, b, n, k))
    return cudaErrorInvalidValue;
  const auto* ps = static_cast<const float*>(scale);
  const auto* pbias = static_cast<const float*>(bias);
  auto* po = static_cast<float*>(out);
  auto* pw = static_cast<float*>(workspace);
  auto s = static_cast<cudaStream_t>(stream);
  if (a_fmt == kE5M2)
    return run<true>(map_a, map_b, ps, pbias, po, pw, m, n, k, k_split, s);
  return run<false>(map_a, map_b, ps, pbias, po, pw, m, n, k, k_split, s);
}
