// int8-QK flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel jimm_tpu/ops/flash_attention_int8.py::_fwd_kernel
// (kernel row 9; launched by _int8_fwd_impl through pl.pallas_call), the
// forward of the int8_qk training policy and of impl="flash_int8". Q and K
// arrive quantized per (batch, position, head) row over D (int8 values and
// f32 scales, ops/flash_attention_int8.py::quantize_heads); V stays in the
// storage dtype. Same numerics: the q.k score is an exact s32 dot (the
// TPU's MXU int32 dot), dequantized as ((float(s) * q_scale) * k_scale) *
// sm_scale in that order, each product rounded on its own; masked scores
// are -1e30; the online softmax keeps its max and sum in f32 and sums the
// unrounded p, while the P.V product takes p rounded to V's dtype (the TPU
// kernel's p.astype(v.dtype)); a row with l == 0 divides by 1; o = acc / l
// in V's dtype, lse = m + log(l) in f32. The TPU kernel's blocks reach 512
// keys, so at S <= 512 its softmax is one pass; this kernel rescales over
// 64-key tiles, which in f32 differs at rounding level and in bf16 can move
// a rounded p by one bf16 step.
//
// Design for bf16 V (the FA2 arrangement of flash_attention.cu's bf16 body,
// on the building blocks of flash_mma.cuh): one CTA of four warps per
// (batch*head, 64-row q tile), each warp owning 16 q rows; 64-key tiles of
// int8 k, bf16 v and the keys' scales double-buffered by cp.async into
// XOR-swizzled shared tiles. The scores run on the s8 tensor cores: the
// int8 A and B fragments of mma.m16n8k32 have the bf16 fragments' register
// layout at twice the elements, so ldmatrix reads them as b16 pairs; the q
// fragments stay in registers for the whole kv loop (D <= 128), and S = q .
// k^T runs as s8 mma.sync into s32, exact integer sums, so bit for bit the
// dot of the FMA body's __dp4a in any order. The epilogue runs on the
// fragments in the TPU kernel's order: q_scale per row in registers,
// k_scale per key from the staged tile, the ragged and causal keep
// predicate, then the running max and sum reduced over each row's quad by
// shuffles. p is rounded to bf16 and packed in registers as the A fragments
// of P.V, V read by ldmatrix.trans, and P.V runs on bf16 mma.sync. The head
// dim is zero-padded in shared memory only, to 64/128/256 bytes (int8, a
// multiple of the s8 k-step's 32) and elements (V); zero bytes add zero to
// the dot. Rows off a 16-byte boundary (D not a multiple of 16, a base or
// stride off it) are loaded element by element into the same layout.
//
// f32 V keeps the FMA body below (CTAs of 256 threads in a 16 x 16 layout,
// int8 rows staged as words, __dp4a scores, P.V on f32 FMAs): mma.sync
// would round V and p to TF32, and f32 is the port's exactness path, so the
// dispatch by dtype is a compile-time choice, not a fallback.
//
// What bounds it on the H100: the bytes. At the train image shape (128,
// 256, 12, 64) bf16 it moves ~155 MB (int8 q/k 50 MB, V and o 101 MB,
// scales and lse 5 MB), 0.046 ms at 3.35 TB/s, against 6.4 GOP of int8
// scores and 6.4 GFLOP of P.V (under 0.01 ms on the tensor cores). As in
// the bf16 forward, the per-score epilogue on the CUDA cores (the three
// dequantizing multiplies, the exp, the running max) sets the pace.

#include <type_traits>

#include "flash_int8.cuh"
#include "flash_mma.cuh"

namespace {

using namespace jimm::flash_int8;

constexpr int kBQ = 64;  // q rows per CTA
constexpr int kBK = 64;  // keys per tile

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_int8_fwd_kernel(
    const int8_t* __restrict__ qq, const int8_t* __restrict__ kq,
    const float* __restrict__ qs, const float* __restrict__ ks,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int heads, int sq, int sk, int d, long long v_sb, long long v_ss,
    long long v_sn, float scale, int causal, bool words) {
  constexpr int LDW = DP / 4 + 4;  // staged int8 row stride (words)
  constexpr int LD = DP + 4;       // V tile row stride (floats)
  constexpr int LDP = kBK + 4;     // probability tile row stride
  constexpr int DG = DP / 64;      // float4 column groups of o per thread
  extern __shared__ __align__(16) float smem[];
  int* q_tile = reinterpret_cast<int*>(smem);
  int* k_tile = q_tile + kBQ * LDW;
  float* v_tile = reinterpret_cast<float*>(k_tile + kBK * LDW);
  float* p_tile = v_tile + kBK * LD;
  float* k_scale = p_tile + kBQ * LDP;

  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int q0 = blockIdx.y * kBQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long row_stride = static_cast<long long>(heads) * d;
  const int8_t* qb = qq + static_cast<long long>(bi) * sq * row_stride +
                     static_cast<long long>(h) * d;
  const int8_t* kb = kq + static_cast<long long>(bi) * sk * row_stride +
                     static_cast<long long>(h) * d;
  const T* vb = v + bi * v_sb + h * v_sn;
  const float* ksb = ks + static_cast<long long>(bh) * sk;

  stage_i8<DP, kBQ>(q_tile, qb, row_stride, q0, sq, d, words);
  float q_scale[4], m[4], l[4], acc[4][DG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    q_scale[i] = row < sq ? qs[static_cast<long long>(bh) * sq + row] : 1.f;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DG * 4; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's k/v/p/scales are no longer read
    stage_i8<DP, kBK>(k_tile, kb, row_stride, k0, sk, d, words);
    load_rows<T, DP, kBK>(v_tile, vb, v_ss, k0, sk, d);
    if (threadIdx.x < kBK)
      k_scale[threadIdx.x] = k0 + threadIdx.x < sk ? ksb[k0 + threadIdx.x] : 1.f;
    __syncthreads();

    int si[4][4];
    tile_dots_i8<DP, 4, 4>(si, q_tile, ty * 4, k_tile, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float s[4], mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < sk && (!causal || col <= row);
        s[j] = keep ? dequant_score(si[i][j], q_scale[i], k_scale[tx + 16 * j],
                                    scale)
                    : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[j] - m_new);
        rs += p;
        p_tile[(ty * 4 + i) * LDP + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DG * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    tile_accum<DP, 4, kBK>(acc, p_tile, ty * 4, v_tile, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float ll = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (static_cast<long long>(bi) * sq + row) * heads * d +
              static_cast<long long>(h) * d;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tx * 4 + e;
        if (col < d) orow[col] = jimm::from_f32<T>(acc[i][g * 4 + e] / ll);
      }
    if (tx == 0) lse[static_cast<long long>(bh) * sq + row] = m[i] + logf(ll);
  }
}

// -- the bf16 body (s8 and bf16 mma.sync) ------------------------------------

namespace tc {

using jimm::mma::bf16;
using jimm::mma::cp_async_commit;
using jimm::mma::cp_async_wait;
using jimm::mma::kRows;
using jimm::mma::kThreads;
using jimm::mma::load_a_s8;
using jimm::mma::load_tile;
using jimm::mma::load_tile_i8;
using jimm::mma::load_vec64;
using jimm::mma::mma_pv;
using jimm::mma::mma_rows_s8;
using jimm::mma::online_softmax;
using jimm::mma::smem_u32;
static_assert(kBQ == kRows && kBK == kRows, "64-row q and k tiles");

// shared memory: the q tile, then per buffer a k tile, a v tile, and after
// both buffers the two tiles' 64 key scales
template <int DP>
constexpr int kI8Tile = kRows * DP;       // an int8 q or k tile (bytes)
template <int DP>
constexpr int kV16Tile = kRows * DP * 2;  // a bf16 v tile
template <int DP>
constexpr int kSmemBytes =
    kI8Tile<DP> + 2 * (kI8Tile<DP> + kV16Tile<DP>) + 2 * kBK * 4;

// CTAs an SM should hold: four at D = 64, as the bf16 forward
template <int DP>
constexpr int kMinCtas = DP == 64 ? 4 : 1;

template <int DP>
__global__ void __launch_bounds__(kThreads, kMinCtas<DP>)
    flash_int8_fwd_mma_kernel(
    const int8_t* __restrict__ qq, const int8_t* __restrict__ kq,
    const float* __restrict__ qs, const float* __restrict__ ks,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int heads, int sq, int sk, int d,
    long long v_sb, long long v_ss, long long v_sn, float scale, int causal,
    int vec_qk, int vec_v) {
  constexpr int kCH = DP / 16;      // 16-byte chunks of an int8 row
  constexpr int kKC = DP / 32;      // s8 k32 steps over the head dim
  constexpr bool kQRegs = DP <= 128;  // q held as A fragments
  extern __shared__ __align__(16) unsigned char smem_i8[];
  unsigned char* q_tile = smem_i8;
  auto k_tile = [&](int buf) {
    return smem_i8 + kI8Tile<DP> + buf * (kI8Tile<DP> + kV16Tile<DP>);
  };
  float* k_scale = reinterpret_cast<float*>(
      smem_i8 + kI8Tile<DP> + 2 * (kI8Tile<DP> + kV16Tile<DP>));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int q0 = blockIdx.y * kBQ;
  const long long row_stride = static_cast<long long>(heads) * d;
  const int8_t* qb = qq + static_cast<long long>(bi) * sq * row_stride +
                     static_cast<long long>(h) * d;
  const int8_t* kb = kq + static_cast<long long>(bi) * sk * row_stride +
                     static_cast<long long>(h) * d;
  const bf16* vb = v + bi * v_sb + h * v_sn;
  const float* ksb = ks + static_cast<long long>(bh) * sk;
  const int r_lo = q0 + warp * 16 + lane / 4;  // this lane's rows: +0, +8

  load_tile_i8<DP>(q_tile, qb, row_stride, q0, sq, d, vec_qk);
  cp_async_commit();
  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + kBQ) : sk;
  const int tiles = (kv_end + kBK - 1) / kBK;
  auto issue = [&](int t) {
    const int buf = t & 1, k0 = t * kBK;
    load_tile_i8<DP>(k_tile(buf), kb, row_stride, k0, sk, d, vec_qk);
    load_tile<DP>(k_tile(buf) + kI8Tile<DP>, vb, v_ss, k0, sk, d, vec_v);
    load_vec64(k_scale + buf * kBK, ksb, k0, sk);
    cp_async_commit();
  };
  issue(0);

  float q_scale[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    q_scale[i] = row < sq ? qs[static_cast<long long>(bh) * sq + row] : 1.f;
  }
  uint32_t qf[kQRegs ? kKC : 1][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1, k0 = t * kBK;
    if (t + 1 < tiles) {
      issue(t + 1);  // into the buffer the previous tile released
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t kt = smem_u32(k_tile(buf));
    const uint32_t vt = kt + kI8Tile<DP>;
    const float* ksc = k_scale + buf * kBK;
    if constexpr (kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          load_a_s8<kCH>(qf[kc], smem_u32(q_tile), warp * 16, kc, lane);
      }
    }

    // s = q . k^T in s32: 16 rows x 64 keys a warp, 8 blocks of 8 keys
    int si[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) si[j][e] = 0;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
      } else {
        load_a_s8<kCH>(a, smem_u32(q_tile), warp * 16, kc, lane);
      }
      mma_rows_s8<kCH, 8>(si, a, kt, 0, kc, lane);
    }

    // the dequantized, scaled scores and the rows' max; a tile in which
    // every key counts for every row of this warp takes the epilogue
    // without the keep test
    const bool interior = k0 + kBK <= sk &&
                          (!causal || k0 + kBK - 1 <= q0 + warp * 16);
    float s[8][4];
    float mx[2] = {kNegInf, kNegInf};
    auto epilogue = [&](auto edge) {
      constexpr bool kEdge = decltype(edge)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r_lo + 8 * (e >> 1);
          const int key = j * 8 + 2 * (lane % 4) + (e & 1);
          bool keep = true;
          if constexpr (kEdge)
            keep = k0 + key < sk && (!causal || k0 + key <= row);
          s[j][e] = keep ? dequant_score(si[j][e], q_scale[e >> 1],
                                         ksc[key], scale)
                         : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    };
    if (interior)
      epilogue(std::false_type{});
    else
      epilogue(std::true_type{});
    online_softmax<DP>(s, mx, m, l, acc);
    // acc += p . v on bf16 mma.sync, p rounded to bf16 in registers
    mma_pv<DP>(acc, s, vt, lane);
    __syncthreads();  // this tile's buffer is no longer read
  }

  const bool pairs = d % 2 == 0;  // a column pair is one 4-byte store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= sq) continue;
    const float ll = l[i] == 0.f ? 1.f : l[i];
    bf16* orow = o + (static_cast<long long>(bi) * sq + row) * heads * d +
                 static_cast<long long>(h) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * (lane % 4);
      const float y0 = acc[j][2 * i] / ll, y1 = acc[j][2 * i + 1] / ll;
      if (pairs && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(y0, y1);
      } else {
        if (col < d) orow[col] = __float2bfloat16(y0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(y1);
      }
    }
    if (lane % 4 == 0)
      lse[static_cast<long long>(bh) * sq + row] = m[i] + logf(ll);
  }
}

}  // namespace tc

struct Args {
  const void *qq, *kq, *qs, *ks, *v;
  void *o, *lse;
  int batch, heads, sq, sk, d;
  long long v_sb, v_ss, v_sn;
  float scale;
  int causal;
  cudaStream_t stream;
};

// f32 V on the FMA body, bf16 on the mma.sync body
template <typename T, int DP>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.batch * a.heads, (a.sq + kBQ - 1) / kBQ);
  if constexpr (std::is_same_v<T, float>) {
    auto kernel = flash_int8_fwd_kernel<T, DP>;
    const int smem = (kBQ + kBK) * (DP / 4 + 4) * 4 +
                     (kBK * (DP + 4) + kBQ * (kBK + 4) + kBK) * 4;
    cudaError_t err = jimm::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const int8_t*>(a.qq), static_cast<const int8_t*>(a.kq),
        static_cast<const float*>(a.qs), static_cast<const float*>(a.ks),
        static_cast<const T*>(a.v), static_cast<T*>(a.o),
        static_cast<float*>(a.lse), a.heads, a.sq, a.sk, a.d, a.v_sb, a.v_ss,
        a.v_sn, a.scale, a.causal, words_aligned(a.qq, a.kq, a.d));
  } else {
    auto kernel = tc::flash_int8_fwd_mma_kernel<DP>;
    const int smem = tc::kSmemBytes<DP>;
    cudaError_t err = jimm::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    // cp.async needs every row on a 16-byte boundary: for the contiguous
    // int8 q and k, aligned bases and D a multiple of 16; for v, its base
    // and strides
    const bool vec_qk = a.d % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(a.qq) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(a.kq) % 16 == 0;
    const bool vec_v = reinterpret_cast<uintptr_t>(a.v) % 16 == 0 &&
                       a.v_sb % 8 == 0 && a.v_ss % 8 == 0 && a.v_sn % 8 == 0;
    kernel<<<grid, tc::kThreads, smem, a.stream>>>(
        static_cast<const int8_t*>(a.qq), static_cast<const int8_t*>(a.kq),
        static_cast<const float*>(a.qs), static_cast<const float*>(a.ks),
        static_cast<const T*>(a.v), static_cast<T*>(a.o),
        static_cast<float*>(a.lse), a.heads, a.sq, a.sk, a.d, a.v_sb, a.v_ss,
        a.v_sn, a.scale, a.causal, static_cast<int>(vec_qk),
        static_cast<int>(vec_v));
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  if (a.d <= 64) return launch<T, 64>(a);
  if (a.d <= 128) return launch<T, 128>(a);
  return launch<T, 256>(a);
}

}  // namespace

// qq: (B, Sq, N, D), kq: (B, Sk, N, D) contiguous int8; qs: (B, N, Sq),
// ks: (B, N, Sk) contiguous f32 scales; v: (B, Sk, N, D) in `dtype`, unit
// stride over D, the other strides in elements. o: (B, Sq, N, D)
// contiguous in `dtype`; lse: (B, N, Sq) contiguous f32. Returns the
// launch's cudaError_t.
extern "C" int jimm_flash_attention_int8_fwd(
    const void* qq, const void* kq, const void* qs, const void* ks,
    const void* v, void* o, void* lse, int batch, int heads, int sq, int sk,
    int d, long long v_sb, long long v_ss, long long v_sn, float scale,
    int causal, int dtype, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1 || d < 1 || d > 256 ||
      static_cast<long long>(batch) * heads > 0x7fffffffLL ||
      (sq + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  const Args a{qq,    kq,    qs,   ks,    v,      o,
               lse,   batch, heads, sq,   sk,     d,
               v_sb,  v_ss,  v_sn, scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case jimm::kF32:
      return dispatch<float>(a);
    case jimm::kBF16:
      return dispatch<__nv_bfloat16>(a);
    default:
      return cudaErrorInvalidValue;
  }
}
