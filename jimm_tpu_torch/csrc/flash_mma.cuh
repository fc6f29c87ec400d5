// mma.sync building blocks of the tensor-core flash kernels
// (flash_attention.cu: the bf16 forward, rows 3-6; flash_attention_bwd.cu:
// the bf16 dq and dk/dv kernels, row 7 in every kind;
// flash_attention_int8.cu: the int8-QK forward, row 9;
// flash_attention_int8_bwd.cu: its dq and dk/dv kernels, row 10;
// flash_attention_dbias.cu: the bias gradient, row 8): XOR-swizzled shared
// tiles filled by cp.async, ldmatrix lane maps, the m16n8k16 bf16 and
// m16n8k32 s8 products, int8 tiles dequantized to bf16, and the bf16 row
// stores of a warp's accumulator.
//
// Fragment layouts (lane = 4 g + t). An f32 or s32 accumulator block of 16
// rows x 8 columns holds (row g, columns 2t, 2t + 1) in elements 0, 1 and
// (row g + 8, the same columns) in elements 2, 3. A bf16 A fragment (16 x
// 16) holds in its four registers (row g, k 2t..2t+1), (row g + 8, k
// 2t..2t+1), (row g, k 2t+8..2t+9), (row g + 8, k 2t+8..2t+9); an s8 A
// fragment (16 x 32) the same registers at four bytes each: (row g, k
// 4t..4t+3), (row g + 8, ...), (row g, k 16+4t..), (row g + 8, k 16+4t..).
// In bytes the two are one layout: lane (g, t) holds bytes 4t..4t+3 of a
// row's first and second 16-byte chunk. So ldmatrix, which hands lane (g,
// t) bytes 4t..4t+3 of row g of each 8-row, 16-byte matrix, reads either
// operand with the same addressing: a k16 step of bf16 and a k32 step of
// s8 are both two 16-byte chunks of a row. B fragments alike: (k 2t..2t+1,
// column g) and (k 2t+8.., column g) in bf16, (k 4t..4t+3, column g) and
// (k 16+4t.., column g) in s8.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace jimm::mma {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;                 // a CTA; 16 tile rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;        // rows of a q, k or v tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a tile of CH chunks a row. With
// 8 or more chunks a row the chunk index is XORed with the row's low three
// bits; with 4 (64-byte rows, two to a 128-byte line) with bits 1-2 of the
// row: either way the eight rows an ldmatrix reads at one logical chunk
// sit in eight different bank groups
template <int CH>
__device__ __forceinline__ uint32_t swz_chunks(int r, int c) {
  static_assert(CH == 4 || CH % 8 == 0, "4 or a multiple of 8 chunks a row");
  if constexpr (CH == 4)
    return static_cast<uint32_t>((r * CH + (c ^ ((r >> 1) & 3))) * 16);
  else
    return static_cast<uint32_t>((r * CH + (c ^ (r & 7))) * 16);
}

// the same for a tile of DP-wide bf16 rows
template <int DP>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return swz_chunks<DP / 8>(r, c);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one 4-byte word (zero-filled when src_bytes is 0)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row-major fragments) . b (16 x 8, column fragments)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 32 int8, row-major fragments) . b (32 x 8 int8, column
// fragments), exact in s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of a 16 x 16 product from two accumulator blocks of 16 rows
// x 8 columns (columns 0-7 and 8-15 of the k16 step), rounded to bf16:
// FA2's reuse of a score tile as the next product's operand
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// c[j] += a . B^T over one k16 step kc for NB / 2 pairs of 8-row blocks of
// the tile at `tile` (rows r0.., the B operand read as rows x k: k in the
// forward's scores; k, v in dq; q, do in dk/dv)
template <int DP, int NB>
__device__ __forceinline__ void mma_rows(float (&c)[NB][4],
                                         const uint32_t (&a)[4],
                                         uint32_t tile, int r0, int kc,
                                         int lane) {
#pragma unroll
  for (int j2 = 0; j2 < NB / 2; ++j2) {
    // rows r0 + 16 j2 + (lane / 16) * 8 + lane % 8 at the k16 step's first
    // (lanes 0-7, 16-23) or last (8-15, 24-31) 8 columns: the B fragments
    // of blocks 2 j2 and 2 j2 + 1
    uint32_t b[4];
    ldmatrix_x4(b, tile + swz<DP>(r0 + j2 * 16 + (lane / 16) * 8 + lane % 8,
                                  kc * 2 + (lane / 8) % 2));
    mma_bf16(c[2 * j2], a, b[0], b[1]);
    mma_bf16(c[2 * j2 + 1], a, b[2], b[3]);
  }
}

// acc += a . tile[r0 .. r0 + 16) over the whole head dim: the tile read as
// k x D (v in the forward's P.V; k in dq; do, q in dk/dv) through
// ldmatrix.trans
template <int DP>
__device__ __forceinline__ void mma_cols(float (&acc)[DP / 8][4],
                                         const uint32_t (&a)[4],
                                         uint32_t tile, int r0, int lane) {
#pragma unroll
  for (int dp = 0; dp < DP / 16; ++dp) {
    // lanes 0-7 rows +0, 8-15 rows +8 at the d16 step's first 8 columns,
    // 16-31 the same at its last 8
    uint32_t b[4];
    ldmatrix_x4_trans(b, tile + swz<DP>(r0 + ((lane / 8) % 2) * 8 + lane % 8,
                                        dp * 2 + lane / 16));
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// the A fragments of rows r0..r0 + 15 of a tile at k16 step kc
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile,
                                       int r0, int kc, int lane) {
  ldmatrix_x4(a, tile + swz<DP>(r0 + lane % 16, kc * 2 + lane / 16));
}

// the s8 A fragments of rows r0..r0 + 15 of an int8 tile of CH 16-byte
// chunks a row at k32 step kc (lanes 0-15 address the step's first 16
// bytes, 16-31 its last: the bf16 lane map at twice the elements)
template <int CH>
__device__ __forceinline__ void load_a_s8(uint32_t (&a)[4], uint32_t tile,
                                          int r0, int kc, int lane) {
  ldmatrix_x4(a, tile + swz_chunks<CH>(r0 + lane % 16, kc * 2 + lane / 16));
}

// c[j] += a . B^T in s32 over one s8 k32 step kc for NB / 2 pairs of 8-row
// blocks of the int8 tile at `tile` (CH chunks a row, rows r0..): the s8
// twin of mma_rows (k in the int8-QK forward's and dq's scores, q in
// dk/dv's)
template <int CH, int NB>
__device__ __forceinline__ void mma_rows_s8(int (&c)[NB][4],
                                            const uint32_t (&a)[4],
                                            uint32_t tile, int r0, int kc,
                                            int lane) {
#pragma unroll
  for (int j2 = 0; j2 < NB / 2; ++j2) {
    // rows r0 + 16 j2 + (lane / 16) * 8 + lane % 8 at the k32 step's first
    // (lanes 0-7, 16-23) or last (8-15, 24-31) 16 bytes: the B fragments of
    // blocks 2 j2 and 2 j2 + 1
    uint32_t b[4];
    ldmatrix_x4(b, tile + swz_chunks<CH>(r0 + j2 * 16 + (lane / 16) * 8 +
                                             lane % 8,
                                         kc * 2 + (lane / 8) % 2));
    mma_s8(c[2 * j2], a, b[0], b[1]);
    mma_s8(c[2 * j2 + 1], a, b[2], b[3]);
  }
}

// one 64-key tile's step of the online softmax, on the scores s of a warp's
// 16 rows (lane rows g, g + 8) whose tile maxima are mx: the running max m
// and sum l (of the unrounded p) move on, s becomes p = exp(s - m), and
// acc is rescaled by exp(m_old - m); the max and sum are reduced over each
// row's quad of lanes by shuffles
template <int DP>
__device__ __forceinline__ void online_softmax(float (&s)[8][4],
                                               float (&mx)[2], float (&m)[2],
                                               float (&l)[2],
                                               float (&acc)[DP / 8][4]) {
  float corr[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    m_new[i] = fmaxf(m[i], mx[i]);
    corr[i] = expf(m[i] - m_new[i]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m_new[e >> 1]);
      rs[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l[i] = l[i] * corr[i] + rs[i];
    m[i] = m_new[i];
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    acc[j][0] *= corr[0];
    acc[j][1] *= corr[0];
    acc[j][2] *= corr[1];
    acc[j][3] *= corr[1];
  }
}

// acc += p . v over one 64-key tile: p (the score blocks 2 kk, 2 kk + 1 of
// keys 16 kk..16 kk + 15) rounded to bf16 as A fragments, v's B fragments
// by ldmatrix.trans
template <int DP>
__device__ __forceinline__ void mma_pv(float (&acc)[DP / 8][4],
                                       const float (&s)[8][4], uint32_t vt,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    uint32_t a[4];
    pack_a(a, s[2 * kk], s[2 * kk + 1]);
    mma_cols<DP>(acc, a, vt, kk * 16, lane);
  }
}

// rows [r0, r0 + 64) of one head's (S, D) bf16 slice into the swizzled
// tile at dst, by a CTA of NT threads; rows >= n and columns >= d are zero.
// vec: every row of the slice starts on a 16-byte boundary, so a 16-byte
// chunk is one cp.async (zero-filled past d, or wholly past n); else
// element by element.
template <int DP, int NT = kThreads>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src,
                                          long long row_stride, int r0, int n,
                                          int d, bool vec) {
  constexpr int kChunks = DP / 8;
  const uint32_t base = smem_u32(dst);
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += NT) {
    const int r = idx / kChunks, c = idx % kChunks, col = c * 8;
    const bool in = r0 + r < n && col < d;
    const bf16* p = src + static_cast<long long>(r0 + r) * row_stride + col;
    const uint32_t off = swz<DP>(r, c);
    if (vec) {
      cp_async16(base + off, in ? p : src, in ? min(8, d - col) * 2 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = in && col + 2 * e < d
                                ? __bfloat16_as_ushort(p[2 * e]) : 0u;
        const uint32_t hi = in && col + 2 * e + 1 < d
                                ? __bfloat16_as_ushort(p[2 * e + 1]) : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// rows [r0, r0 + 64) of one head's (S, D) int8 slice into the swizzled
// tile of DP-byte rows at dst, as load_tile; vec: every row starts on a
// 16-byte boundary and d is a multiple of 16
template <int DP>
__device__ __forceinline__ void load_tile_i8(unsigned char* dst,
                                             const int8_t* src,
                                             long long row_stride, int r0,
                                             int n, int d, bool vec) {
  constexpr int kChunks = DP / 16;
  const uint32_t base = smem_u32(dst);
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks, col = c * 16;
    const bool in = r0 + r < n && col < d;
    const int8_t* p = src + static_cast<long long>(r0 + r) * row_stride + col;
    const uint32_t off = swz_chunks<kChunks>(r, c);
    if (vec) {
      cp_async16(base + off, in ? p : src, in ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int cc = col + 4 * e + b;
          const uint32_t byte =
              in && cc < d ? static_cast<uint8_t>(p[4 * e + b]) : 0u;
          word |= byte << (8 * b);
        }
        w[e] = word;
      }
      *reinterpret_cast<uint4*>(dst + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// the 64-row int8 tile at src (DP-byte rows, swizzled as load_tile_i8
// leaves them) times its rows' scales, rounded to bf16, into the bf16 tile
// of DP-wide rows at dst (swizzled as load_tile): bf16(float(x) * scale),
// the product rounded on its own, as the TPU's _dequant_operand rounds the
// backward's int8 operand. Zero bytes give zeros.
template <int DP>
__device__ __forceinline__ void dequant_tile(unsigned char* dst,
                                             const unsigned char* src,
                                             const float* scale) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks of a bf16 row
#pragma unroll 2
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    // elements 8 c..8 c + 7: half c % 2 of the int8 row's chunk c / 2
    const uint2 w = *reinterpret_cast<const uint2*>(
        src + swz_chunks<DP / 16>(r, c / 2) + (c % 2) * 8);
    const float sc = scale[r];
    uint32_t out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t word = (e < 2 ? w.x : w.y) >> (16 * (e % 2));
      const float lo = static_cast<float>(static_cast<int8_t>(word & 0xff));
      const float hi =
          static_cast<float>(static_cast<int8_t>((word >> 8) & 0xff));
      out[e] = pack_bf16(__fmul_rn(lo, sc), __fmul_rn(hi, sc));
    }
    *reinterpret_cast<uint4*>(dst + swz<DP>(r, c)) =
        make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// a warp's accumulator (16 rows x DP, this lane's rows r_lo and r_lo + 8)
// times mul as bf16 rows < n of the contiguous (B, S, N, D) output at
// batch bi, head h, columns < d
template <int DP>
__device__ __forceinline__ void store_acc(bf16* out,
                                          const float (&acc)[DP / 8][4],
                                          float mul, int bi, int h, int heads,
                                          int n, int d, int r_lo, int lane) {
  const bool pairs = d % 2 == 0;  // a column pair is one 4-byte store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= n) continue;
    bf16* orow = out + (static_cast<long long>(bi) * n + row) * heads * d +
                 static_cast<long long>(h) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * (lane % 4);
      const float y0 = acc[j][2 * i] * mul, y1 = acc[j][2 * i + 1] * mul;
      if (pairs && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(y0, y1);
      } else {
        if (col < d) orow[col] = __float2bfloat16(y0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(y1);
      }
    }
  }
}

// 64 f32 values [r0, r0 + 64) of a row vector into dst (zero at >= n), one
// 4-byte cp.async each, by the CTA's first 64 threads
__device__ __forceinline__ void load_vec64(float* dst, const float* src,
                                           int r0, int n) {
  if (threadIdx.x < kRows) {
    const bool in = r0 + threadIdx.x < n;
    cp_async4(smem_u32(dst + threadIdx.x), in ? src + r0 + threadIdx.x : src,
              in ? 4 : 0);
  }
}

}  // namespace jimm::mma
