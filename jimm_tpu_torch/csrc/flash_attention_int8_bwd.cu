// int8-QK flash-attention backward for Hopper (sm_90a): dq, and dk/dv.
//
// Replaces the TPU kernels
// jimm_tpu/ops/flash_attention_int8.py::_bwd_dq_kernel and ::_bwd_dkv_kernel
// (kernel row 10; launched by _int8_bwd through pl.pallas_call), the
// backward of the int8_qk training policy. Same numerics: the score tile is
// recomputed from the forward's saved int8 q and k and their scales (the
// same s32 dot and dequantization as the forward kernel, so the softmax
// recomputation is exact), p = exp(s - lse) from the forward's f32 lse,
// dp = do . v in f32, ds = p * (dp - delta) with delta = rowsum(do * o)
// (computed by the wrapper; there is no lse output, so no lse cotangent).
// The rounding points of the TPU kernels: dq contracts ds against
// dequant(k) = k_q * k_scale rounded to the storage dtype, dk contracts it
// against dequant(q) rounded the same way (_dequant_operand); ds is formed
// from the unrounded f32 p and rounded for those products; dv takes p
// rounded to do's dtype. sm_scale is applied once, to the finished dq and
// dk. The gradient reaches q and k straight through the quantizer.
//
// Design for bf16 v and do (the FA2 arrangement of flash_attention_bwd.cu's
// bf16 body, no atomics, on the building blocks of flash_mma.cuh), up to
// D = 128:
// - dq: one CTA of four warps per (batch*head, 64-row q tile), each warp
//   owning 16 q rows; 64-key tiles of int8 k, bf16 v and the keys' scales
//   double-buffered by cp.async into XOR-swizzled shared tiles. S = q . k^T
//   runs on s8 mma.sync into s32, the q fragments held in registers for the
//   whole key loop (row 9's loaders: the s8 fragments are the bf16 ones'
//   byte layout); dP = do . v^T on bf16 mma.sync. The epilogue runs on the
//   fragments in the TPU kernel's order (q_scale, k_scale, sm_scale, the
//   keep predicate, p, ds); ds is rounded to bf16 in registers as the A
//   fragments of dq += ds . dequant(k), where dequant(k) is a bf16 tile each
//   CTA builds once per key tile from the staged int8 tile and its scales
//   (rounded as _dequant_operand rounds) and reads by ldmatrix.trans.
// - dk/dv: one CTA of four warps per (batch*head, 64-key tile), on
//   transposed tiles: S^T = k . q^T on s8 mma.sync (both operands
//   D-contiguous, no transpose) and dP^T = v . do^T on bf16 mma.sync, 32
//   query columns a step, each column with its own lse, delta and q_scale;
//   dv += bf16(p^T) . do and dk += bf16(ds^T) . dequant(q), dequant(q)
//   built per q tile as above; the dk and dv accumulators stay in
//   registers.
// The s32 score is exact, bit for bit the __dp4a sum in any order, so p
// differs from the FMA body's only by the dp product's summation order.
// The head dim is zero-padded in shared memory only (int8 rows to 64 or 128
// bytes, a multiple of the s8 k-step's 32); rows off a 16-byte boundary
// (D not a multiple of 16, strided v or do views) load element by element
// into the same layouts.
//
// f32 (and bf16 at D = 256, where dk and dv would take 128 f32 registers
// each a lane) keeps the FMA body: one CTA of 256 threads per (batch*head,
// BQ-row q tile) or (batch*head, BK-key tile), int8 tiles staged as words
// for __dp4a scores, everything else on f32 FMAs through shared ds, p^T and
// ds^T tiles (3.50 ms at the train image shape in bf16 on an H100 80GB HBM3
// at 700 W; PERF.md). mma.sync would round f32 to TF32, and f32 is the
// port's exactness path, so the dispatch by dtype is a compile-time choice,
// not a fallback.
//
// What bounds it on the H100: the bytes at the training shapes (int8 q/k,
// bf16 v, o, do, dq, dk, dv: ~17 bytes per (row, feature)), against two s32
// score products and four bf16 products of S x S x D, which take a few
// microseconds on the tensor cores; the per-score epilogue on the CUDA
// cores (three dequantizing multiplies, the exp, ds) and the dequant tiles
// set the pace, as in the bf16 backward.

#include <type_traits>

#include "flash_int8.cuh"
#include "flash_mma.cuh"

namespace {

using namespace jimm::flash_int8;

struct Strides {
  long long b, s, n;
};

struct Args {
  const void *qq, *kq, *qs, *ks, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int batch, heads, sq, sk, d;
  Strides vs, dos;
  float scale;
  int causal;
  bool words;
  cudaStream_t stream;
};

template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_int8_bwd_dq_kernel(
    const int8_t* __restrict__ qq, const int8_t* __restrict__ kq,
    const float* __restrict__ qs, const float* __restrict__ ks,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int heads, int sq, int sk, int d, Strides vst,
    Strides dst, float scale, int causal, bool words) {
  constexpr int LDW = DP / 4 + 4, LD = DP + 4, LDS = BK + 4;
  constexpr int RQ = BQ / 16, RK = BK / 16;
  extern __shared__ __align__(16) float smem[];
  int* q_tile = reinterpret_cast<int*>(smem);
  int* k_tile = q_tile + BQ * LDW;
  float* do_tile = reinterpret_cast<float*>(k_tile + BK * LDW);
  float* v_tile = do_tile + BQ * LD;
  float* kd_tile = v_tile + BK * LD;  // dequant(k), rounded to T
  float* ds_tile = kd_tile + BK * LD;
  float* k_scale = ds_tile + BQ * LDS;

  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int q0 = blockIdx.y * BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long row_stride = static_cast<long long>(heads) * d;
  const int8_t* kb = kq + static_cast<long long>(bi) * sk * row_stride +
                     static_cast<long long>(h) * d;
  const T* vb = v + bi * vst.b + h * vst.n;
  const float* ksb = ks + static_cast<long long>(bh) * sk;
  stage_i8<DP, BQ>(q_tile,
                   qq + static_cast<long long>(bi) * sq * row_stride +
                       static_cast<long long>(h) * d,
                   row_stride, q0, sq, d, words);
  load_rows<T, DP, BQ>(do_tile, dout + bi * dst.b + h * dst.n, dst.s, q0, sq,
                       d);

  float q_scale[RQ], lse_r[RQ], delta_r[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    const long long at = static_cast<long long>(bh) * sq + row;
    q_scale[i] = row < sq ? qs[at] : 1.f;
    lse_r[i] = row < sq ? lse[at] : 0.f;
    delta_r[i] = row < sq ? delta[at] : 0.f;
  }
  float acc[RQ][DP / 16];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc[i][c] = 0.f;

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's k, dequant(k), v, ds are read
    stage_i8<DP, BK>(k_tile, kb, row_stride, k0, sk, d, words);
    load_rows<T, DP, BK>(v_tile, vb, vst.s, k0, sk, d);
    if (threadIdx.x < BK)
      k_scale[threadIdx.x] = k0 + threadIdx.x < sk ? ksb[k0 + threadIdx.x] : 1.f;
    __syncthreads();
    dequant_rows<T, DP, BK>(kd_tile, k_tile, k_scale);  // read after a sync
    int si[RQ][RK];
    float dp[RQ][RK];
    tile_dots_i8<DP, RQ, RK>(si, q_tile, ty * RQ, k_tile, tx);
    tile_dots<DP, RQ, RK>(dp, do_tile, ty * RQ, v_tile, tx);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = row < sq && col < sk && (!causal || col <= row);
        const float p =
            keep ? expf(dequant_score(si[i][j], q_scale[i],
                                      k_scale[tx + 16 * j], scale) -
                        lse_r[i])
                 : 0.f;
        ds_tile[(ty * RQ + i) * LDS + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncthreads();
    tile_accum<DP, RQ, BK>(acc, ds_tile, ty * RQ, kd_tile, tx);
  }
  store_rows<T, DP, RQ>(dq, acc, scale, bi, h, heads, q0, ty * RQ, sq, d, tx);
}

// at D = 64 two CTAs share an SM (2 x 95 KB of shared memory) only if a
// thread keeps to 128 registers; unbounded, nvcc took 192 and one CTA ran
// per SM
template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
    flash_int8_bwd_dkv_kernel(
    const int8_t* __restrict__ qq, const int8_t* __restrict__ kq,
    const float* __restrict__ qs, const float* __restrict__ ks,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int heads, int sq, int sk, int d,
    Strides vst, Strides dst, float scale, int causal, bool words) {
  constexpr int LDW = DP / 4 + 4, LD = DP + 4, LDS = BQ + 4;
  constexpr int RQ = BQ / 16, RK = BK / 16;
  extern __shared__ __align__(16) float smem[];
  int* k_tile = reinterpret_cast<int*>(smem);
  int* q_tile = k_tile + BK * LDW;
  float* v_tile = reinterpret_cast<float*>(q_tile + BQ * LDW);
  float* do_tile = v_tile + BK * LD;
  float* qd_tile = do_tile + BQ * LD;  // dequant(q), rounded to T
  float* pt_tile = qd_tile + BQ * LD;
  float* dst_tile = pt_tile + BK * LDS;
  float* q_scale = dst_tile + BK * LDS;

  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * BK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long row_stride = static_cast<long long>(heads) * d;
  const int8_t* qb = qq + static_cast<long long>(bi) * sq * row_stride +
                     static_cast<long long>(h) * d;
  const T* db = dout + bi * dst.b + h * dst.n;
  const float* qsb = qs + static_cast<long long>(bh) * sq;
  stage_i8<DP, BK>(k_tile,
                   kq + static_cast<long long>(bi) * sk * row_stride +
                       static_cast<long long>(h) * d,
                   row_stride, k0, sk, d, words);
  load_rows<T, DP, BK>(v_tile, v + bi * vst.b + h * vst.n, vst.s, k0, sk, d);

  float k_scale[RK];
#pragma unroll
  for (int a = 0; a < RK; ++a) {
    const int col = k0 + ty * RK + a;
    k_scale[a] = col < sk ? ks[static_cast<long long>(bh) * sk + col] : 1.f;
  }
  float dk_acc[RK][DP / 16], dv_acc[RK][DP / 16];
#pragma unroll
  for (int a = 0; a < RK; ++a)
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      dk_acc[a][c] = 0.f;
      dv_acc[a][c] = 0.f;
    }

  // causal: q tiles whose last row lies before this k tile never attend to it
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < sq; q0 += BQ) {
    __syncthreads();  // the previous tile's q, do, dequant(q), p^T, ds^T
    stage_i8<DP, BQ>(q_tile, qb, row_stride, q0, sq, d, words);
    load_rows<T, DP, BQ>(do_tile, db, dst.s, q0, sq, d);
    if (threadIdx.x < BQ)
      q_scale[threadIdx.x] = q0 + threadIdx.x < sq ? qsb[q0 + threadIdx.x] : 1.f;
    __syncthreads();
    dequant_rows<T, DP, BQ>(qd_tile, q_tile, q_scale);
    int si[RK][RQ];
    float dp[RK][RQ];
    tile_dots_i8<DP, RK, RQ>(si, k_tile, ty * RK, q_tile, tx);
    tile_dots<DP, RK, RQ>(dp, v_tile, ty * RK, do_tile, tx);
#pragma unroll
    for (int b = 0; b < RQ; ++b) {
      const int row = q0 + tx + 16 * b;  // query row
      const long long at = static_cast<long long>(bh) * sq + row;
      const float l = row < sq ? lse[at] : 0.f;
      const float dl = row < sq ? delta[at] : 0.f;
      const float qsc = q_scale[tx + 16 * b];
#pragma unroll
      for (int a = 0; a < RK; ++a) {
        const int col = k0 + ty * RK + a;  // key row
        const bool keep = row < sq && col < sk && (!causal || col <= row);
        const float p =
            keep ? expf(dequant_score(si[a][b], qsc, k_scale[a], scale) - l)
                 : 0.f;
        pt_tile[(ty * RK + a) * LDS + tx + 16 * b] = round_to<T>(p);
        dst_tile[(ty * RK + a) * LDS + tx + 16 * b] =
            round_to<T>(p * (dp[a][b] - dl));
      }
    }
    __syncthreads();
    tile_accum<DP, RK, BQ>(dv_acc, pt_tile, ty * RK, do_tile, tx);
    tile_accum<DP, RK, BQ>(dk_acc, dst_tile, ty * RK, qd_tile, tx);
  }
  store_rows<T, DP, RK>(dk, dk_acc, scale, bi, h, heads, k0, ty * RK, sk, d,
                        tx);
  store_rows<T, DP, RK>(dv, dv_acc, 1.f, bi, h, heads, k0, ty * RK, sk, d,
                        tx);
}

// -- the bf16 body (mma.sync) ------------------------------------------------

namespace tc {

using jimm::mma::bf16;
using jimm::mma::cp_async_commit;
using jimm::mma::cp_async_wait;
using jimm::mma::dequant_tile;
using jimm::mma::kRows;
using jimm::mma::kThreads;
using jimm::mma::load_a;
using jimm::mma::load_a_s8;
using jimm::mma::load_tile;
using jimm::mma::load_tile_i8;
using jimm::mma::load_vec64;
using jimm::mma::mma_cols;
using jimm::mma::mma_rows;
using jimm::mma::mma_rows_s8;
using jimm::mma::pack_a;
using jimm::mma::smem_u32;
using jimm::mma::store_acc;

constexpr int kQN = 32;  // query columns a dk/dv step

template <int DP>
constexpr int kI8Tile = kRows * DP;       // an int8 q or k tile (bytes)
template <int DP>
constexpr int kB16Tile = kRows * DP * 2;  // a bf16 tile
// dq: the int8 q tile and the do tile, then per buffer an int8 k tile, a v
// tile and the keys' scales, then the dequant(k) tile
template <int DP>
constexpr int kDqBuf = kI8Tile<DP> + kB16Tile<DP> + kRows * 4;
template <int DP>
constexpr int kDqSmem =
    kI8Tile<DP> + kB16Tile<DP> + 2 * kDqBuf<DP> + kB16Tile<DP>;
// dk/dv: the int8 k tile and the v tile, then per buffer an int8 q tile, a
// do tile and the query rows' scales, lse and delta, then the dequant(q)
// tile
template <int DP>
constexpr int kDkvBuf = kI8Tile<DP> + kB16Tile<DP> + 3 * kRows * 4;
template <int DP>
constexpr int kDkvSmem =
    kI8Tile<DP> + kB16Tile<DP> + 2 * kDkvBuf<DP> + kB16Tile<DP>;

// CTAs an SM should hold: three at D = 64 (a cap of 168 registers), as row
// 7's mma kernels
template <int DP>
constexpr int kMinCtas = DP == 64 ? 3 : 1;

template <int DP>
__global__ void __launch_bounds__(kThreads, kMinCtas<DP>)
    flash_int8_bwd_dq_mma_kernel(
    const int8_t* __restrict__ qq, const int8_t* __restrict__ kq,
    const float* __restrict__ qs, const float* __restrict__ ks,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int heads, int sq, int sk, int d, Strides vst,
    Strides dst, float scale, int causal, int vec_qk, int vec) {
  constexpr int kCH = DP / 16;         // 16-byte chunks of an int8 row
  constexpr int kKC8 = DP / 32;        // s8 k32 steps over the head dim
  constexpr int kKC = DP / 16;         // bf16 k16 steps
  constexpr bool kDoRegs = DP <= 64;   // do held as A fragments
  extern __shared__ __align__(16) unsigned char smem_dq8[];
  unsigned char* q_tile = smem_dq8;
  unsigned char* do_tile = q_tile + kI8Tile<DP>;
  // buffer b: the int8 k tile, the v tile, the keys' scales; after both,
  // the dequant(k) tile
  auto k_tile = [&](int buf) {
    return do_tile + kB16Tile<DP> + buf * kDqBuf<DP>;
  };
  unsigned char* kd_tile = k_tile(2);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int q0 = blockIdx.y * kRows;
  const long long row_stride = static_cast<long long>(heads) * d;
  const int8_t* kb = kq + static_cast<long long>(bi) * sk * row_stride +
                     static_cast<long long>(h) * d;
  const bf16* vb = v + bi * vst.b + h * vst.n;
  const float* ksb = ks + static_cast<long long>(bh) * sk;
  const int r_lo = q0 + warp * 16 + lane / 4;  // this lane's rows: +0, +8

  load_tile_i8<DP>(q_tile,
                   qq + static_cast<long long>(bi) * sq * row_stride +
                       static_cast<long long>(h) * d,
                   row_stride, q0, sq, d, vec_qk);
  load_tile<DP>(do_tile, dout + bi * dst.b + h * dst.n, dst.s, q0, sq, d,
                vec);
  cp_async_commit();
  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + kRows) : sk;
  const int tiles = (kv_end + kRows - 1) / kRows;
  auto issue = [&](int t) {
    unsigned char* b = k_tile(t & 1);
    const int k0 = t * kRows;
    load_tile_i8<DP>(b, kb, row_stride, k0, sk, d, vec_qk);
    load_tile<DP>(b + kI8Tile<DP>, vb, vst.s, k0, sk, d, vec);
    load_vec64(reinterpret_cast<float*>(b + kI8Tile<DP> + kB16Tile<DP>), ksb,
               k0, sk);
    cp_async_commit();
  };
  issue(0);

  float q_scale[2], lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    const long long at = static_cast<long long>(bh) * sq + row;
    q_scale[i] = row < sq ? qs[at] : 1.f;
    lse_r[i] = row < sq ? lse[at] : 0.f;
    delta_r[i] = row < sq ? delta[at] : 0.f;
  }
  uint32_t qf[kKC8][4], df[kDoRegs ? kKC : 1][4];
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t qt = smem_u32(q_tile), dt = smem_u32(do_tile);
  const uint32_t kdt = smem_u32(kd_tile);

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kRows;
    unsigned char* b = k_tile(t & 1);
    if (t + 1 < tiles) {
      issue(t + 1);  // into the buffer the previous tile released
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t kt = smem_u32(b), vt = kt + kI8Tile<DP>;
    const float* ksc =
        reinterpret_cast<const float*>(b + kI8Tile<DP> + kB16Tile<DP>);
    // dequant(k) of this key tile, read after the barrier before dq's
    // product
    dequant_tile<DP>(kd_tile, b, ksc);
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < kKC8; ++kc)
        load_a_s8<kCH>(qf[kc], qt, warp * 16, kc, lane);
      if constexpr (kDoRegs) {
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          load_a<DP>(df[kc], dt, warp * 16, kc, lane);
      }
    }

    // s = q . k^T in s32 and dp = do . v^T in f32: 16 rows x 64 keys a warp
    int si[8][4];
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        si[j][e] = 0;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kc = 0; kc < kKC8; ++kc)
      mma_rows_s8<kCH, 8>(si, qf[kc], kt, 0, kc, lane);
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t ad[4];
      if constexpr (kDoRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ad[e] = df[kc][e];
      } else {
        load_a<DP>(ad, dt, warp * 16, kc, lane);
      }
      mma_rows<DP, 8>(dp, ad, vt, 0, kc, lane);
    }

    // the epilogue on the fragments; dp becomes ds. A tile in which every
    // key counts for every row of this warp takes it without the keep test.
    const bool interior = k0 + kRows <= sk &&
                          (!causal || k0 + kRows - 1 <= q0 + warp * 16) &&
                          q0 + warp * 16 + 16 <= sq;
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
            keep = row < sq && k0 + key < sk && (!causal || k0 + key <= row);
          const float p =
              keep ? expf(dequant_score(si[j][e], q_scale[e >> 1], ksc[key],
                                        scale) -
                          lse_r[e >> 1])
                   : 0.f;
          dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
        }
    };
    if (interior)
      epilogue(std::false_type{});
    else
      epilogue(std::true_type{});
    __syncthreads();  // dequant(k) is complete

    // dq += ds . dequant(k): ds rounded to bf16 as the A fragments of keys
    // 16 kk..16 kk + 15, dequant(k)'s B fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, dp[2 * kk], dp[2 * kk + 1]);
      mma_cols<DP>(acc, a, kdt, kk * 16, lane);
    }
    __syncthreads();  // this tile's buffer and dequant(k) are no longer read
  }
  store_acc<DP>(dq, acc, scale, bi, h, heads, sq, d, r_lo, lane);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, kMinCtas<DP>)
    flash_int8_bwd_dkv_mma_kernel(
    const int8_t* __restrict__ qq, const int8_t* __restrict__ kq,
    const float* __restrict__ qs, const float* __restrict__ ks,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq, int sk,
    int d, Strides vst, Strides dst, float scale, int causal, int vec_qk,
    int vec) {
  constexpr int kCH = DP / 16;        // 16-byte chunks of an int8 row
  constexpr int kKC8 = DP / 32;       // s8 k32 steps over the head dim
  constexpr int kKC = DP / 16;        // bf16 k16 steps
  constexpr bool kVRegs = DP <= 64;   // v held as A fragments
  extern __shared__ __align__(16) unsigned char smem_dkv8[];
  unsigned char* k_tile = smem_dkv8;
  unsigned char* v_tile = k_tile + kI8Tile<DP>;
  // buffer b: the int8 q tile, the do tile, the rows' q_scale, lse and
  // delta; after both, the dequant(q) tile
  auto buffer = [&](int buf) {
    return v_tile + kB16Tile<DP> + buf * kDkvBuf<DP>;
  };
  unsigned char* qd_tile = buffer(2);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * kRows;
  const long long row_stride = static_cast<long long>(heads) * d;
  const int8_t* qb = qq + static_cast<long long>(bi) * sq * row_stride +
                     static_cast<long long>(h) * d;
  const bf16* db = dout + bi * dst.b + h * dst.n;
  const long long stat0 = static_cast<long long>(bh) * sq;
  const int key_lo = k0 + warp * 16 + lane / 4;  // this lane's keys: +0, +8

  load_tile_i8<DP>(k_tile,
                   kq + static_cast<long long>(bi) * sk * row_stride +
                       static_cast<long long>(h) * d,
                   row_stride, k0, sk, d, vec_qk);
  load_tile<DP>(v_tile, v + bi * vst.b + h * vst.n, vst.s, k0, sk, d, vec);
  cp_async_commit();
  // causal: q tiles whose last row lies before this k tile never attend to
  // it; a k tile past the last query (Sk > Sq) gets zero dk and dv
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < sq ? (sq - q_begin + kRows - 1) / kRows : 0;
  auto issue = [&](int t) {
    unsigned char* b = buffer(t & 1);
    const int q0 = q_begin + t * kRows;
    load_tile_i8<DP>(b, qb, row_stride, q0, sq, d, vec_qk);
    load_tile<DP>(b + kI8Tile<DP>, db, dst.s, q0, sq, d, vec);
    float* stats = reinterpret_cast<float*>(b + kI8Tile<DP> + kB16Tile<DP>);
    load_vec64(stats, qs + stat0, q0, sq);
    load_vec64(stats + kRows, lse + stat0, q0, sq);
    load_vec64(stats + 2 * kRows, delta + stat0, q0, sq);
    cp_async_commit();
  };
  if (tiles > 0) issue(0);

  // this lane's two keys: real, and their scales
  bool key_ok[2];
  float k_scale[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    key_ok[i] = key < sk;
    k_scale[i] = key < sk ? ks[static_cast<long long>(bh) * sk + key] : 1.f;
  }
  uint32_t kf[kKC8][4], vf[kVRegs ? kKC : 1][4];
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const uint32_t kt = smem_u32(k_tile), vt = smem_u32(v_tile);
  const uint32_t qdt = smem_u32(qd_tile);

  for (int t = 0; t < tiles; ++t) {
    const int q0 = q_begin + t * kRows;
    unsigned char* b = buffer(t & 1);
    if (t + 1 < tiles) {
      issue(t + 1);  // into the buffer the previous tile released
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t qt = smem_u32(b), dt = qt + kI8Tile<DP>;
    const float* q_sc =
        reinterpret_cast<const float*>(b + kI8Tile<DP> + kB16Tile<DP>);
    const float* lse_t = q_sc + kRows;
    const float* delta_t = q_sc + 2 * kRows;
    dequant_tile<DP>(qd_tile, b, q_sc);
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < kKC8; ++kc)
        load_a_s8<kCH>(kf[kc], kt, warp * 16, kc, lane);
      if constexpr (kVRegs) {
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          load_a<DP>(vf[kc], vt, warp * 16, kc, lane);
      }
    }
    // every query row of the tile is real and at or past this warp's keys
    const bool interior =
        q0 + kRows <= sq && (!causal || q0 >= k0 + warp * 16 + 15);
    __syncthreads();  // dequant(q) is complete

#pragma unroll
    for (int hq = 0; hq < kRows / kQN; ++hq) {
      // s^T = k . q^T in s32 and dp^T = v . do^T in f32: 16 keys x 32
      // query columns
      int st[kQN / 8][4];
      float dpt[kQN / 8][4];
#pragma unroll
      for (int j = 0; j < kQN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0;
          dpt[j][e] = 0.f;
        }
#pragma unroll
      for (int kc = 0; kc < kKC8; ++kc)
        mma_rows_s8<kCH, kQN / 8>(st, kf[kc], qt, hq * kQN, kc, lane);
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        uint32_t av[4];
        if constexpr (kVRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) av[e] = vf[kc][e];
        } else {
          load_a<DP>(av, vt, warp * 16, kc, lane);
        }
        mma_rows<DP, kQN / 8>(dpt, av, dt, hq * kQN, kc, lane);
      }
      // p^T and ds^T: the columns are query rows, with their q_scale, lse
      // and delta; dpt becomes ds^T
      float pt[kQN / 8][4];
#pragma unroll
      for (int j = 0; j < kQN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_lo + 8 * (e >> 1);
          const int qc = hq * kQN + j * 8 + 2 * (lane % 4) + (e & 1);
          const int row = q0 + qc;
          const bool keep = key_ok[e >> 1] &&
                            (interior || (row < sq && (!causal || key <= row)));
          const float p =
              keep ? expf(dequant_score(st[j][e], q_sc[qc], k_scale[e >> 1],
                                        scale) -
                          lse_t[qc])
                   : 0.f;
          pt[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - delta_t[qc]);
        }
      // dv += p^T . do and dk += ds^T . dequant(q), p and ds rounded to bf16
      // as the A fragments of query columns 16 kk..16 kk + 15
#pragma unroll
      for (int kk = 0; kk < kQN / 16; ++kk) {
        uint32_t ap[4], ads[4];
        pack_a(ap, pt[2 * kk], pt[2 * kk + 1]);
        pack_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
        mma_cols<DP>(dv_acc, ap, dt, hq * kQN + kk * 16, lane);
        mma_cols<DP>(dk_acc, ads, qdt, hq * kQN + kk * 16, lane);
      }
    }
    __syncthreads();  // this tile's buffer and dequant(q) are no longer read
  }
  if (tiles == 0) cp_async_wait<0>();  // the k/v copies nothing read
  store_acc<DP>(dk, dk_acc, scale, bi, h, heads, sk, d, key_lo, lane);
  store_acc<DP>(dv, dv_acc, 1.f, bi, h, heads, sk, d, key_lo, lane);
}

// both bf16 kernels on `stream`: dq, then dk/dv
template <int DP>
cudaError_t launch(const Args& a) {
  const auto* qq = static_cast<const int8_t*>(a.qq);
  const auto* kq = static_cast<const int8_t*>(a.kq);
  const auto* qs = static_cast<const float*>(a.qs);
  const auto* ks = static_cast<const float*>(a.ks);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* dout = static_cast<const bf16*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* delta = static_cast<const float*>(a.delta);
  // cp.async needs every row on a 16-byte boundary: for the contiguous int8
  // q and k, aligned bases and D a multiple of 16; for v and do, their bases
  // and strides
  const bool vec_qk = a.d % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.qq) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.kq) % 16 == 0;
  bool vec = reinterpret_cast<uintptr_t>(a.v) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(a.dout) % 16 == 0;
  for (const Strides& st : {a.vs, a.dos})
    vec = vec && st.b % 8 == 0 && st.s % 8 == 0 && st.n % 8 == 0;

  auto dq_kernel = flash_int8_bwd_dq_mma_kernel<DP>;
  cudaError_t err = jimm::allow_smem(dq_kernel, kDqSmem<DP>);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(a.batch * a.heads, (a.sq + kRows - 1) / kRows), kThreads,
              kDqSmem<DP>, a.stream>>>(
      qq, kq, qs, ks, v, dout, lse, delta, static_cast<bf16*>(a.dq), a.heads,
      a.sq, a.sk, a.d, a.vs, a.dos, a.scale, a.causal,
      static_cast<int>(vec_qk), static_cast<int>(vec));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = flash_int8_bwd_dkv_mma_kernel<DP>;
  err = jimm::allow_smem(dkv_kernel, kDkvSmem<DP>);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(a.batch * a.heads, (a.sk + kRows - 1) / kRows),
               kThreads, kDkvSmem<DP>, a.stream>>>(
      qq, kq, qs, ks, v, dout, lse, delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.heads, a.sq, a.sk, a.d, a.vs, a.dos,
      a.scale, a.causal, static_cast<int>(vec_qk), static_cast<int>(vec));
  return cudaGetLastError();
}

}  // namespace tc

// f32 (and bf16 at D = 256) on the FMA body, bf16 up to D = 128 on the
// mma.sync body
template <typename T, int DP, int BQ, int BK>
cudaError_t launch(const Args& a) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && DP <= 128) {
    return tc::launch<DP>(a);
  } else {
    constexpr int LDW = DP / 4 + 4, LD = DP + 4;
    const auto* qq = static_cast<const int8_t*>(a.qq);
    const auto* kq = static_cast<const int8_t*>(a.kq);
    const auto* qs = static_cast<const float*>(a.qs);
    const auto* ks = static_cast<const float*>(a.ks);
    const auto* v = static_cast<const T*>(a.v);
    const auto* dout = static_cast<const T*>(a.dout);
    const auto* lse = static_cast<const float*>(a.lse);
    const auto* delta = static_cast<const float*>(a.delta);

    auto dq_kernel = flash_int8_bwd_dq_kernel<T, DP, BQ, BK>;
    const int dq_smem = (BQ + BK) * LDW * 4 +
                        ((BQ + 2 * BK) * LD + BQ * (BK + 4) + BK) * 4;
    cudaError_t err = jimm::allow_smem(dq_kernel, dq_smem);
    if (err != cudaSuccess) return err;
    dq_kernel<<<dim3(a.batch * a.heads, (a.sq + BQ - 1) / BQ), kThreads,
                dq_smem, a.stream>>>(qq, kq, qs, ks, v, dout, lse, delta,
                                     static_cast<T*>(a.dq), a.heads, a.sq, a.sk,
                                     a.d, a.vs, a.dos, a.scale, a.causal,
                                     a.words);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    auto dkv_kernel = flash_int8_bwd_dkv_kernel<T, DP, BQ, BK>;
    const int dkv_smem = (BQ + BK) * LDW * 4 +
                         ((BK + 2 * BQ) * LD + 2 * BK * (BQ + 4) + BQ) * 4;
    err = jimm::allow_smem(dkv_kernel, dkv_smem);
    if (err != cudaSuccess) return err;
    dkv_kernel<<<dim3(a.batch * a.heads, (a.sk + BK - 1) / BK), kThreads,
                 dkv_smem, a.stream>>>(
        qq, kq, qs, ks, v, dout, lse, delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.heads, a.sq, a.sk, a.d, a.vs, a.dos, a.scale,
        a.causal, a.words);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  // 64-row tiles up to D = 128; at 256 32-row tiles fit the 227 KB of
  // shared memory and keep the accumulators in registers
  if (a.d <= 64) return launch<T, 64, 64, 64>(a);
  if (a.d <= 128) return launch<T, 128, 64, 64>(a);
  return launch<T, 256, 32, 32>(a);
}

}  // namespace

// qq, dout: (B, Sq, N, D) and kq, v: (B, Sk, N, D); qq and kq contiguous
// int8, v and dout in `dtype` with unit stride over D, the other strides in
// elements; qs: (B, N, Sq), ks: (B, N, Sk), lse, delta: (B, N, Sq)
// contiguous f32. dq: (B, Sq, N, D), dk/dv: (B, Sk, N, D) contiguous in
// `dtype`, every element written. Launches the dq kernel, then the dk/dv
// kernel, on `stream`. Returns the first failing launch's cudaError_t
// (0 = launched).
extern "C" int jimm_flash_attention_int8_bwd(
    const void* qq, const void* kq, const void* qs, const void* ks,
    const void* v, const void* dout, const void* lse, const void* delta,
    void* dq, void* dk, void* dv, int batch, int heads, int sq, int sk, int d,
    long long v_sb, long long v_ss, long long v_sn, long long do_sb,
    long long do_ss, long long do_sn, float scale, int causal, int dtype,
    void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1 || d < 1 || d > 256 ||
      static_cast<long long>(batch) * heads > 0x7fffffffLL ||
      (sq + 31) / 32 > 65535 || (sk + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  const Args a{qq,    kq,     qs,     ks,    v,     dout,
               lse,   delta,  dq,     dk,    dv,    batch,
               heads, sq,     sk,     d,     {v_sb, v_ss, v_sn},
               {do_sb, do_ss, do_sn}, scale, causal,
               words_aligned(qq, kq, d), static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case jimm::kF32:
      return dispatch<float>(a);
    case jimm::kBF16:
      return dispatch<__nv_bfloat16>(a);
    default:
      return cudaErrorInvalidValue;
  }
}
