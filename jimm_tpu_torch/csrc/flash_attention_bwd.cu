// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv, softmax or
// sigmoid scores, with or without a key-padding mask, or softmax with an
// additive bias.
//
// Replaces the TPU kernels jimm_tpu/ops/flash_attention.py::_bwd_dq_kernel
// and ::_bwd_dkv_kernel, softmax kind: without a mask, with one (has_mask,
// the mask kind of kernel row 7) and with a bias (has_bias, the bias kind,
// below; all launched by _flash_bwd through pl.pallas_call). Same numerics
// (_ds_tile): the score s = (q . k) * scale is recomputed in f32 from the
// saved inputs, p = exp(s - lse) from the forward's f32 logsumexp, dp =
// do . v in f32, ds = p * (dp - delta) with delta = rowsum(do * o)
// (computed by the wrapper, minus any lse cotangent). Before the products
// that consume them, p (for dv) and ds (for dq and dk) are rounded to the
// input dtype, as the TPU kernels round them to bf16 before their MXU dots;
// in f32 that rounding is the identity. scale is applied once, to the
// finished dq and dk.
//
// Design for bf16 (the FA2 backward on mma.sync tensor cores, with the
// building blocks of flash_mma.cuh): the two kernels of the FA2
// arrangement, as on the TPU, and no atomics. The TPU kernels make the
// inner loop a sequential grid axis and carry the sums in VMEM scratch;
// here it runs inside the CTA and the sums live in registers.
// - dq: one CTA of four warps per (batch*head, 64-row q tile), each warp
//   owning 16 q rows. The q and do tiles are loaded once (held as A
//   fragments at D <= 64, read from shared memory each tile at 128), lse
//   and delta of each lane's two rows sit in registers. Each 64-key k/v
//   tile is double-buffered by cp.async into XOR-swizzled shared tiles and
//   used in this order: S = q . k^T and dP = do . v^T (k and v as B
//   operands through ldmatrix), the per-kind epilogue on the fragments, ds
//   rounded to bf16 and packed in registers as A fragments, and dq += ds .
//   k with k through ldmatrix.trans. dq is multiplied by scale and stored.
// - dk/dv: one CTA of four warps per (batch*head, 64-key tile), each warp
//   owning 16 keys; the k and v tiles are held (as A fragments at D <= 64)
//   and the loop runs over double-buffered q, do, lse and delta tiles (and
//   the bias tile). It works on transposed tiles, 32 query columns a step:
//   S^T = k . q^T and dP^T = v . do^T, p^T and ds^T from lse and delta per
//   column, then dv += p^T(bf16) . do and dk += ds^T(bf16) . q with do and q
//   through ldmatrix.trans; the dk and dv accumulators stay in registers
//   for the whole loop.
// Each product sums exact bf16 products in f32 per k16 step; p (for dv)
// and ds are rounded to bf16 where the FMA body and the TPU kernels round
// them. The head dim is zero-padded to 64/128 in shared memory only; rows
// off a 16-byte boundary (a strided view, an odd D) are loaded element by
// element into the same layout. At D = 256 (no preset reaches it) dk and
// dv would need 128 f32 registers each a lane, so bf16 keeps the FMA body
// there: a compile-time choice by head dim, as f32 is by dtype.
//
// The f32 body (FMA; bf16 too at D = 256): dq, one CTA of 256 threads per
// (batch*head, BQ-row q tile), the q and do tiles resident in shared
// memory, looping over BK-row k/v tiles; the ds tile goes through shared
// memory into dq += ds . k. dk/dv: one CTA per (batch*head, BK-row k tile),
// the k and v tiles resident, looping over q tiles; p^T and ds^T go
// through shared memory into dv += p^T . do and dk += ds^T . q. Thread (ty,
// tx) of the 16 x 16 layout owns rows ty*R..ty*R+R-1 of its CTA's resident
// tile, computes their scores against the streamed rows tx + 16*j, and
// accumulates its rows over output columns 64*g + 4*tx..+3, as the forward
// kernel does; tiles are f32 in shared memory (each input element
// converted once, row strides padded by 4 floats). mma.sync would round f32
// to TF32, and f32 is the port's exactness path. Inputs are read through
// their (B, S, N, D) strides. Keys >= Sk (dq kernel) and queries >= Sq
// (dkv kernel; padded rows have lse 0 and exp(s - 0) overflows) are masked
// to p = 0, as the TPU kernels mask them with `pos`; causal skips the
// tiles wholly above the diagonal (top-left aligned) in both kernels.
//
// The key-padding mask (HAS_MASK): as in the forward kernel, the (B, Sk)
// mask, one byte a key, is read at the CTA's batch index, staged in shared
// memory with the k/v tiles (once per CTA in the dk/dv kernel, whose keys
// are fixed) and folded into the keep predicate, so a masked key gets p = 0
// and ds = 0, where the TPU's additive -1e30 row gives exp(-1e30 - lse) = 0:
// zero dk and dv for masked keys. (A query row whose keys are all masked
// gets p = 0 here and exp(0) on the TPU; under the zero cotangent that such
// rows carry both give zero gradient.)
//
// The sigmoid kind (SIGMOID, row 7's sigmoid kind; _ds_tile with
// kind="sigmoid", launched by sigmoid_attention's VJP): p = sigmoid(s +
// logit_bias) recomputed in f32 from the saved inputs, ds = p * (1 - p) * dp,
// each step rounded on its own; no lse and no delta (the wrapper computes
// no rowsum(do * o)), and p (for dv) and ds are rounded to the input dtype
// before their products, as in the softmax kind. A dropped key has p = 0,
// so ds = 0 and zero dk and dv.
//
// The bias kind (HAS_BIAS, row 7's bias kind; _bwd_dq_kernel and
// _bwd_dkv_kernel with has_bias, launched by flash_attention_bias's VJP):
// the score is recomputed as (q . k) * scale + bias[h][row][col], the
// multiply and the add each rounded on its own as XLA rounds _scores, then
// p = exp(that - lse). The (N, Sq, Sk) f32 bias is shared by the batch and
// read at head bh % heads through its strides (0 over a broadcast axis): the
// dq kernel reads it straight from memory (a half-warp's 16 keys are
// neighbours, so the reads coalesce, and 128 samples hit the same 3 MB in
// L2), the dk/dv kernel stages each (BQ, BK) tile key-major in the shared
// buffer of p^T (its threads' scores run down query rows). A key whose bias is -inf gets
// p = 0, and so does every key of a row whose lse is the forward's -1e30 (a
// row with no finite key). dbias, the batch sum of ds, is its own kernel
// (flash_attention_dbias.cu). Instantiated for softmax without a mask only.
//
// The mask kind in the bf16 body: the dq kernel keeps each k tile's mask as
// one bit a key (a ballot, as the forward), the dk/dv kernel a predicate
// for each lane's two keys. The bias kind: the dq kernel reads the bias
// from device memory per fragment element (a quad's keys are neighbours),
// the dk/dv kernel stages each (64 q, 64 key) f32 tile in shared memory by
// cp.async with the q tile (row stride 68 floats: a fragment's reads hit 32
// banks), because its lanes run down query rows.
//
// What bounds it on the H100: at the training shapes (S <= 256, D = 64) the
// bytes, ~20 bytes per (row, feature) in bf16 moved once, against
// 8*Sq*Sk*D flops (10 with the recomputed products): 0.121 ms by bytes at
// the train image shape, 0.065 ms by operations at 989 TFLOP/s. On mma.sync
// the products (seven: s and dp are recomputed in both kernels) leave the
// FMA pipe; the per-score epilogue on the CUDA cores (the exp, the bias
// reads) and the shared-memory operand traffic (each warp reads the
// streamed tiles' B fragments itself) set the pace.

#include <cstdint>
#include <type_traits>

#include "flash_mma.cuh"
#include "flash_tiles.cuh"

namespace {

using jimm::round_to;
using jimm::flash::kThreads;
using jimm::flash::load_tile;
using jimm::flash::tile_dots;

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
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[NA][DP / 16],
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
        if (col < d) orow[col] = jimm::from_f32<T>(acc[a][g * 4 + e] * mul);
      }
  }
}

struct Strides {
  long long b, s, n;
};

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int batch, heads, sq, sk, d;
  Strides qs, ks, vs, dos;
  float scale, logit_bias;
  int causal;
  const void* mask;
  long long mask_sb;
  const void* bias;  // (N, Sq, Sk) f32, unit stride over Sk; null for none
  long long bias_sn, bias_ss;
  cudaStream_t stream;
};

// p and ds of one (query, key) pair from its unscaled score s and dp; a
// dropped pair has p = ds = 0. Softmax: p = exp(s * scale - lse), ds =
// p * (dp - delta); with a bias b (HAS_BIAS): p = exp((s * scale + b) -
// lse), each step rounded on its own as XLA rounds _scores; sigmoid: p =
// sigmoid(s * scale + logit_bias), ds = p * (1 - p) * dp. p and ds are
// returned unrounded: the FMA body rounds them to T, the bf16 body as it
// packs them into fragments.
template <bool SIGMOID, bool HAS_BIAS>
__device__ __forceinline__ float p_ds(float s, float dp, bool keep,
                                      float scale, float lse_or_bias,
                                      float delta, float b, float& ds) {
  if constexpr (SIGMOID) {
    const float x = __fadd_rn(__fmul_rn(s, scale), lse_or_bias);
    const float p = keep ? 1.f / (1.f + expf(-x)) : 0.f;
    ds = __fmul_rn(__fmul_rn(p, __fsub_rn(1.f, p)), dp);
    return p;
  } else if constexpr (HAS_BIAS) {
    const float x = __fadd_rn(__fmul_rn(s, scale), b);
    const float p = keep ? expf(__fsub_rn(x, lse_or_bias)) : 0.f;
    ds = p * (dp - delta);
    return p;
  } else {
    const float p = keep ? expf(s * scale - lse_or_bias) : 0.f;
    ds = p * (dp - delta);
    return p;
  }
}

template <typename T, int DP, int BQ, int BK, bool HAS_MASK, bool SIGMOID,
          bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int heads, int sq,
    int sk, int d, Strides qst, Strides kst, Strides vst, Strides dst,
    float scale, float logit_bias, int causal,
    const unsigned char* __restrict__ mask, long long mask_sb,
    const float* __restrict__ bias, long long bias_sn, long long bias_ss) {
  constexpr int LD = DP + 4, RQ = BQ / 16, RK = BK / 16, LDS = BK + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;
  __shared__ bool attend[HAS_MASK ? BK : 1];  // the k tile's mask bytes

  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int q0 = blockIdx.y * BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kb = k + bi * kst.b + h * kst.n;
  const T* vb = v + bi * vst.b + h * vst.n;
  load_tile<T, DP, BQ>(qs, q + bi * qst.b + h * qst.n, qst.s, q0, sq, d);
  load_tile<T, DP, BQ>(dos, dout + bi * dst.b + h * dst.n, dst.s, q0, sq, d);
  // the bias kind: this head's bias, shared by the batch; a thread's keys
  // are neighbours of its half-warp's, so its reads coalesce
  const float* hbias = HAS_BIAS ? bias + h * bias_sn : nullptr;

  // softmax: each row's lse and delta; sigmoid: the logit bias, no delta
  float lse_r[RQ], delta_r[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    const long long at = static_cast<long long>(bh) * sq + row;
    lse_r[i] = SIGMOID ? logit_bias : row < sq ? lse[at] : 0.f;
    delta_r[i] = SIGMOID || row >= sq ? 0.f : delta[at];
  }
  float acc[RQ][DP / 16];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc[i][c] = 0.f;

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's k and ds are no longer read
    load_tile<T, DP, BK>(ks, kb, kst.s, k0, sk, d);
    load_tile<T, DP, BK>(vs, vb, vst.s, k0, sk, d);
    if constexpr (HAS_MASK) {
      const int col = k0 + threadIdx.x;
      if (threadIdx.x < BK)
        attend[threadIdx.x] = col < sk && mask[bi * mask_sb + col] != 0;
    }
    __syncthreads();
    float s[RQ][RK], dp[RQ][RK];
    tile_dots<DP, RQ, RK>(s, qs, ty * RQ, ks, tx);
    tile_dots<DP, RQ, RK>(dp, dos, ty * RQ, vs, tx);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = row < sq && col < sk && (!causal || col <= row) &&
                          (!HAS_MASK || attend[tx + 16 * j]);
        const float b = HAS_BIAS && keep ? hbias[row * bias_ss + col] : 0.f;
        float ds;
        p_ds<SIGMOID, HAS_BIAS>(s[i][j], dp[i][j], keep, scale, lse_r[i],
                                delta_r[i], b, ds);
        dss[(ty * RQ + i) * LDS + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_accum<DP, RQ, BK>(acc, dss, ty * RQ, ks, tx);
  }
  store_rows<T, DP, RQ>(dq, acc, scale, bi, h, heads, q0, ty * RQ, sq, d, tx);
}

template <typename T, int DP, int BQ, int BK, bool HAS_MASK, bool SIGMOID,
          bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int heads, int sq, int sk, int d, Strides qst, Strides kst, Strides vst,
    Strides dst, float scale, float logit_bias, int causal,
    const unsigned char* __restrict__ mask, long long mask_sb,
    const float* __restrict__ bias, long long bias_sn, long long bias_ss) {
  constexpr int LD = DP + 4, RQ = BQ / 16, RK = BK / 16, LDS = BQ + 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* dos = qs + BQ * LD;
  float* pts = dos + BQ * LD;
  float* dsts = pts + BK * LDS;
  __shared__ bool attend[HAS_MASK ? BK : 1];  // this CTA's keys' mask bytes

  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * BK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + bi * qst.b + h * qst.n;
  const T* db = dout + bi * dst.b + h * dst.n;
  load_tile<T, DP, BK>(ks, k + bi * kst.b + h * kst.n, kst.s, k0, sk, d);
  load_tile<T, DP, BK>(vs, v + bi * vst.b + h * vst.n, vst.s, k0, sk, d);

  float dk_acc[RK][DP / 16], dv_acc[RK][DP / 16];
#pragma unroll
  for (int a = 0; a < RK; ++a)
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      dk_acc[a][c] = 0.f;
      dv_acc[a][c] = 0.f;
    }
  if constexpr (HAS_MASK) {  // visible after the q loop's first barrier
    const int col = k0 + threadIdx.x;
    if (threadIdx.x < BK)
      attend[threadIdx.x] = col < sk && mask[bi * mask_sb + col] != 0;
  }

  // causal: q tiles whose last row lies before this k tile never attend to it
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < sq; q0 += BQ) {
    __syncthreads();  // the previous tile's q, do, p^T and ds^T are read
    load_tile<T, DP, BQ>(qs, qb, qst.s, q0, sq, d);
    load_tile<T, DP, BQ>(dos, db, dst.s, q0, sq, d);
    if constexpr (HAS_BIAS) {
      // a thread's scores run down the query rows of one key: stage the
      // (BQ, BK) bias tile key-major in p^T's buffer, where each thread
      // reads the bias of a score just before it writes that score's p over
      // it (no extra shared memory, so no lost occupancy). A warp stores 4
      // query rows x 8 keys: its loads take 8-float runs of 4 rows, and its
      // stores hit 32 banks (LDS = 4 mod 32).
      const float* hbias = bias + h * bias_sn;
      const int lane = threadIdx.x & 31;
      for (int chunk = threadIdx.x >> 5; chunk < BQ * BK / 32;
           chunk += kThreads / 32) {
        const int r = chunk / (BK / 8) * 4 + lane / 8;
        const int c = chunk % (BK / 8) * 8 + lane % 8;
        pts[c * LDS + r] = q0 + r < sq && k0 + c < sk
                               ? hbias[(q0 + r) * bias_ss + k0 + c]
                               : 0.f;
      }
    }
    __syncthreads();
    float s[RK][RQ], dp[RK][RQ];
    tile_dots<DP, RK, RQ>(s, ks, ty * RK, qs, tx);
    tile_dots<DP, RK, RQ>(dp, vs, ty * RK, dos, tx);
#pragma unroll
    for (int b = 0; b < RQ; ++b) {
      const int row = q0 + tx + 16 * b;  // query row
      const long long at = static_cast<long long>(bh) * sq + row;
      const float l = SIGMOID ? logit_bias : row < sq ? lse[at] : 0.f;
      const float dl = SIGMOID || row >= sq ? 0.f : delta[at];
#pragma unroll
      for (int a = 0; a < RK; ++a) {
        const int col = k0 + ty * RK + a;  // key row
        const bool keep = row < sq && col < sk && (!causal || col <= row) &&
                          (!HAS_MASK || attend[ty * RK + a]);
        const float bv = HAS_BIAS ? pts[(ty * RK + a) * LDS + tx + 16 * b]
                                  : 0.f;
        float ds;
        const float p = p_ds<SIGMOID, HAS_BIAS>(s[a][b], dp[a][b], keep,
                                                scale, l, dl, bv, ds);
        pts[(ty * RK + a) * LDS + tx + 16 * b] = round_to<T>(p);
        dsts[(ty * RK + a) * LDS + tx + 16 * b] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_accum<DP, RK, BQ>(dv_acc, pts, ty * RK, dos, tx);
    tile_accum<DP, RK, BQ>(dk_acc, dsts, ty * RK, qs, tx);
  }
  store_rows<T, DP, RK>(dk, dk_acc, scale, bi, h, heads, k0, ty * RK, sk, d,
                        tx);
  store_rows<T, DP, RK>(dv, dv_acc, 1.f, bi, h, heads, k0, ty * RK, sk, d,
                        tx);
}

// -- the bf16 body (mma.sync) ------------------------------------------------

namespace tc {

using jimm::mma::bf16;
using jimm::mma::cp_async16;
using jimm::mma::cp_async_commit;
using jimm::mma::cp_async_wait;
using jimm::mma::kRows;
using jimm::mma::kThreads;
using jimm::mma::load_a;
using jimm::mma::load_tile;
using jimm::mma::load_vec64;
using jimm::mma::mma_cols;
using jimm::mma::mma_rows;
using jimm::mma::pack_a;
using jimm::mma::smem_u32;
using jimm::mma::store_acc;
using jimm::mma::swz;

constexpr int kQN = 32;             // query columns a dk/dv step
constexpr int kBiasLd = kRows + 4;  // staged bias row stride (floats)

template <int DP>
constexpr int kTile = kRows * DP * 2;  // one bf16 tile (bytes)
// q, do, two k/v buffers, and the two k tiles' mask bits (in the dynamic
// shared memory: with them the kernel passes 48 KB and must ask for it)
template <int DP>
constexpr int kDqSmem = 6 * kTile<DP> + 16;
// a dk/dv buffer: the q and do tiles, lse and delta, and the bias tile
template <int DP, bool HAS_BIAS>
constexpr int kDkvBuf =
    2 * kTile<DP> + 2 * kRows * 4 + (HAS_BIAS ? kRows * kBiasLd * 4 : 0);
template <int DP, bool HAS_BIAS>
constexpr int kDkvSmem = 2 * kTile<DP> + 2 * kDkvBuf<DP, HAS_BIAS>;

// CTAs an SM should hold: three at D = 64 (a cap of 168 registers), where
// the compiler would otherwise take all 255 and leave room for two
template <int DP>
constexpr int kMinCtas = DP == 64 ? 3 : 1;

template <int DP, bool HAS_MASK, bool SIGMOID, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads, kMinCtas<DP>)
    flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int heads, int sq, int sk, int d, Strides qst,
    Strides kst, Strides vst, Strides dst, float scale, float logit_bias,
    int causal, const unsigned char* __restrict__ mask, long long mask_sb,
    const float* __restrict__ bias, long long bias_sn, long long bias_ss,
    int vec) {
  constexpr int kKC = DP / 16;        // k16 steps over the head dim
  constexpr bool kARegs = DP <= 64;   // q and do held as A fragments
  extern __shared__ __align__(16) unsigned char smem_dq[];
  unsigned char* qs = smem_dq;  // then do, k, v of buffer 0, k, v of 1
  // each k tile's attended keys (real and unmasked), one bit a key
  auto* attend = reinterpret_cast<uint32_t(*)[2]>(smem_dq + 6 * kTile<DP>);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int q0 = blockIdx.y * kRows;
  const bf16* kb = k + bi * kst.b + h * kst.n;
  const bf16* vb = v + bi * vst.b + h * vst.n;
  const float* hbias = HAS_BIAS ? bias + h * bias_sn : nullptr;
  const int r_lo = q0 + warp * 16 + lane / 4;  // this lane's rows: +0, +8

  load_tile<DP>(qs, q + bi * qst.b + h * qst.n, qst.s, q0, sq, d, vec);
  load_tile<DP>(qs + kTile<DP>, dout + bi * dst.b + h * dst.n, dst.s, q0,
                sq, d, vec);
  cp_async_commit();
  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + kRows) : sk;
  const int tiles = (kv_end + kRows - 1) / kRows;
  auto issue = [&](int t) {
    const int buf = t & 1, k0 = t * kRows;
    load_tile<DP>(qs + (2 + 2 * buf) * kTile<DP>, kb, kst.s, k0, sk, d, vec);
    load_tile<DP>(qs + (3 + 2 * buf) * kTile<DP>, vb, vst.s, k0, sk, d, vec);
    if constexpr (HAS_MASK) {
      const int col = k0 + threadIdx.x;
      if (threadIdx.x < kRows) {  // warps 0 and 1, whole
        const uint32_t bits = __ballot_sync(
            0xffffffffu, col < sk && mask[bi * mask_sb + col] != 0);
        if (lane == 0) attend[buf][warp] = bits;
      }
    }
    cp_async_commit();
  };
  issue(0);

  // softmax: each row's lse and delta; sigmoid: the logit bias, no delta
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    const long long at = static_cast<long long>(bh) * sq + row;
    lse_r[i] = SIGMOID ? logit_bias : row < sq ? lse[at] : 0.f;
    delta_r[i] = SIGMOID || row >= sq ? 0.f : delta[at];
  }
  uint32_t qf[kARegs ? kKC : 1][4], df[kARegs ? kKC : 1][4];
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t qt = smem_u32(qs), dt = qt + kTile<DP>;

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1, k0 = t * kRows;
    if (t + 1 < tiles) {
      issue(t + 1);  // into the buffer the previous tile released
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t kt = qt + (2 + 2 * buf) * kTile<DP>;
    const uint32_t vt = kt + kTile<DP>;
    if constexpr (kARegs) {
      if (t == 0) {
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc) {
          load_a<DP>(qf[kc], qt, warp * 16, kc, lane);
          load_a<DP>(df[kc], dt, warp * 16, kc, lane);
        }
      }
    }

    // s = q . k^T and dp = do . v^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t aq[4], ad[4];
      if constexpr (kARegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aq[e] = qf[kc][e];
          ad[e] = df[kc][e];
        }
      } else {
        load_a<DP>(aq, qt, warp * 16, kc, lane);
        load_a<DP>(ad, dt, warp * 16, kc, lane);
      }
      mma_rows<DP, 8>(s, aq, kt, 0, kc, lane);
      mma_rows<DP, 8>(dp, ad, vt, 0, kc, lane);
    }

    // the kinds' epilogue on the fragments; s becomes ds. A key counts when
    // it is real, not past the row (causal) and attended (mask), and its
    // row is real; a tile in which every key counts for every row of this
    // warp takes the epilogue without the test.
    [[maybe_unused]] uint64_t attended = ~0ull;
    if constexpr (HAS_MASK)
      attended = attend[buf][0] |
                 (static_cast<uint64_t>(attend[buf][1]) << 32);
    const bool interior = attended == ~0ull && k0 + kRows <= sk &&
                          (!causal || k0 + kRows - 1 <= q0 + warp * 16) &&
                          q0 + warp * 16 + 16 <= sq;
    auto epilogue = [&](auto edge) {
      constexpr bool kEdge = decltype(edge)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r_lo + 8 * (e >> 1);
          const int col = k0 + j * 8 + 2 * (lane % 4) + (e & 1);
          bool keep = true;
          if constexpr (kEdge)
            keep = row < sq && col < sk && (!causal || col <= row) &&
                   (!HAS_MASK || (attended >> (col - k0)) & 1);
          const float b =
              HAS_BIAS && keep ? hbias[row * bias_ss + col] : 0.f;
          float ds;
          p_ds<SIGMOID, HAS_BIAS>(s[j][e], dp[j][e], keep, scale,
                                  lse_r[e >> 1], delta_r[e >> 1], b, ds);
          s[j][e] = ds;
        }
    };
    if (interior)
      epilogue(std::false_type{});
    else
      epilogue(std::true_type{});

    // dq += ds . k: ds rounded to bf16 as the A fragments of keys
    // 16 kk..16 kk + 15, k's B fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_cols<DP>(acc, a, kt, kk * 16, lane);
    }
    __syncthreads();  // this tile's buffer is no longer read
  }
  store_acc<DP>(dq, acc, scale, bi, h, heads, sq, d, r_lo, lane);
}

template <int DP, bool HAS_MASK, bool SIGMOID, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads, kMinCtas<DP>)
    flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq, int sk,
    int d, Strides qst, Strides kst, Strides vst, Strides dst, float scale,
    float logit_bias, int causal, const unsigned char* __restrict__ mask,
    long long mask_sb, const float* __restrict__ bias, long long bias_sn,
    long long bias_ss, int vec, int vec_bias) {
  constexpr int kKC = DP / 16;        // k16 steps over the head dim
  constexpr bool kARegs = DP <= 64;   // k and v held as A fragments
  constexpr int kBuf = kDkvBuf<DP, HAS_BIAS>;
  extern __shared__ __align__(16) unsigned char smem_dkv[];
  // k, v, then per buffer: q, do, lse, delta, the bias tile
  auto buffer = [&](int buf) { return smem_dkv + 2 * kTile<DP> + buf * kBuf; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * kRows;
  const bf16* qb = q + bi * qst.b + h * qst.n;
  const bf16* db = dout + bi * dst.b + h * dst.n;
  const float* hbias = HAS_BIAS ? bias + h * bias_sn : nullptr;
  const int key_lo = k0 + warp * 16 + lane / 4;  // this lane's keys: +0, +8

  load_tile<DP>(smem_dkv, k + bi * kst.b + h * kst.n, kst.s, k0, sk, d, vec);
  load_tile<DP>(smem_dkv + kTile<DP>, v + bi * vst.b + h * vst.n, vst.s, k0,
                sk, d, vec);
  cp_async_commit();
  // causal: q tiles whose last row lies before this k tile never attend to
  // it; a k tile past the last query (Sk > Sq) gets zero dk and dv
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < sq ? (sq - q_begin + kRows - 1) / kRows : 0;
  auto issue = [&](int t) {
    unsigned char* b = buffer(t & 1);
    const int q0 = q_begin + t * kRows;
    load_tile<DP>(b, qb, qst.s, q0, sq, d, vec);
    load_tile<DP>(b + kTile<DP>, db, dst.s, q0, sq, d, vec);
    if constexpr (!SIGMOID) {
      float* lse_t = reinterpret_cast<float*>(b + 2 * kTile<DP>);
      load_vec64(lse_t, lse + static_cast<long long>(bh) * sq, q0, sq);
      load_vec64(lse_t + kRows, delta + static_cast<long long>(bh) * sq, q0,
                 sq);
    }
    if constexpr (HAS_BIAS) {
      // the (64 q, 64 key) bias tile, zero past Sq and Sk: 16-byte chunks
      // by cp.async where every row is on a 16-byte boundary, else word by
      // word (visible after the next barrier, as the copies)
      float* bt = reinterpret_cast<float*>(b + 2 * kTile<DP> + 2 * kRows * 4);
      for (int idx = threadIdx.x; idx < kRows * kRows / 4; idx += kThreads) {
        const int r = idx / (kRows / 4), c = (idx % (kRows / 4)) * 4;
        const int row = q0 + r, col = k0 + c;
        const bool in = row < sq && col < sk;
        const float* src = hbias + static_cast<long long>(row) * bias_ss + col;
        if (vec_bias) {
          cp_async16(smem_u32(bt + r * kBiasLd + c), in ? src : hbias,
                     in ? min(4, sk - col) * 4 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            bt[r * kBiasLd + c + e] = in && col + e < sk ? src[e] : 0.f;
        }
      }
    }
    cp_async_commit();
  };
  if (tiles > 0) issue(0);

  // this lane's two keys: real and attended
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    key_ok[i] = key < sk && (!HAS_MASK || mask[bi * mask_sb + key] != 0);
  }
  uint32_t kf[kARegs ? kKC : 1][4], vf[kARegs ? kKC : 1][4];
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const uint32_t kt = smem_u32(smem_dkv), vt = kt + kTile<DP>;

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
    const uint32_t qt = smem_u32(b), dt = qt + kTile<DP>;
    const float* lse_t = reinterpret_cast<const float*>(b + 2 * kTile<DP>);
    const float* bias_t = lse_t + 2 * kRows;
    if constexpr (kARegs) {
      if (t == 0) {
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc) {
          load_a<DP>(kf[kc], kt, warp * 16, kc, lane);
          load_a<DP>(vf[kc], vt, warp * 16, kc, lane);
        }
      }
    }
    // every query row of the tile is real and at or past this warp's keys
    const bool interior =
        q0 + kRows <= sq && (!causal || q0 >= k0 + warp * 16 + 15);

#pragma unroll
    for (int hq = 0; hq < kRows / kQN; ++hq) {
      // s^T = k . q^T and dp^T = v . do^T: 16 keys x 32 query columns
      float st[kQN / 8][4], dpt[kQN / 8][4];
#pragma unroll
      for (int j = 0; j < kQN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        uint32_t ak[4], av[4];
        if constexpr (kARegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ak[e] = kf[kc][e];
            av[e] = vf[kc][e];
          }
        } else {
          load_a<DP>(ak, kt, warp * 16, kc, lane);
          load_a<DP>(av, vt, warp * 16, kc, lane);
        }
        mma_rows<DP, kQN / 8>(st, ak, qt, hq * kQN, kc, lane);
        mma_rows<DP, kQN / 8>(dpt, av, dt, hq * kQN, kc, lane);
      }
      // p^T and ds^T: the columns are query rows, with their lse and delta
#pragma unroll
      for (int j = 0; j < kQN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_lo + 8 * (e >> 1);
          const int qc = hq * kQN + j * 8 + 2 * (lane % 4) + (e & 1);
          const int row = q0 + qc;
          const bool keep = key_ok[e >> 1] &&
                            (interior || (row < sq && (!causal || key <= row)));
          const float bv =
              HAS_BIAS ? bias_t[qc * kBiasLd + key - k0] : 0.f;
          const float l = SIGMOID ? logit_bias : lse_t[qc];
          const float dl = SIGMOID ? 0.f : lse_t[kRows + qc];
          float ds;
          st[j][e] = p_ds<SIGMOID, HAS_BIAS>(st[j][e], dpt[j][e], keep,
                                             scale, l, dl, bv, ds);
          dpt[j][e] = ds;
        }
      // dv += p^T . do and dk += ds^T . q, p and ds rounded to bf16 as the
      // A fragments of query columns 16 kk..16 kk + 15
#pragma unroll
      for (int kk = 0; kk < kQN / 16; ++kk) {
        uint32_t ap[4], ads[4];
        pack_a(ap, st[2 * kk], st[2 * kk + 1]);
        pack_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
        mma_cols<DP>(dv_acc, ap, dt, hq * kQN + kk * 16, lane);
        mma_cols<DP>(dk_acc, ads, qt, hq * kQN + kk * 16, lane);
      }
    }
    __syncthreads();  // this tile's buffer is no longer read
  }
  if (tiles == 0) cp_async_wait<0>();  // the k/v copies nothing read
  store_acc<DP>(dk, dk_acc, scale, bi, h, heads, sk, d, key_lo, lane);
  store_acc<DP>(dv, dv_acc, 1.f, bi, h, heads, sk, d, key_lo, lane);
}

// both bf16 kernels on `stream`: dq, then dk/dv
template <int DP, bool HAS_MASK, bool SIGMOID, bool HAS_BIAS>
cudaError_t launch(const Args& a) {
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* dout = static_cast<const bf16*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* delta = static_cast<const float*>(a.delta);
  const auto* mask = static_cast<const unsigned char*>(a.mask);
  const auto* bias = static_cast<const float*>(a.bias);
  // cp.async needs every row of q, k, v and do on a 16-byte boundary, and
  // the bias's rows for its tiles
  bool vec = true;
  for (const void* p : {a.q, a.k, a.v, a.dout})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const Strides& st : {a.qs, a.ks, a.vs, a.dos})
    vec = vec && st.b % 8 == 0 && st.s % 8 == 0 && st.n % 8 == 0;
  const bool vec_bias = reinterpret_cast<uintptr_t>(a.bias) % 16 == 0 &&
                        a.bias_sn % 4 == 0 && a.bias_ss % 4 == 0;

  auto dq_kernel = flash_bwd_dq_mma_kernel<DP, HAS_MASK, SIGMOID, HAS_BIAS>;
  cudaError_t err = jimm::allow_smem(dq_kernel, kDqSmem<DP>);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(a.batch * a.heads, (a.sq + kRows - 1) / kRows), kThreads,
              kDqSmem<DP>, a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<bf16*>(a.dq), a.heads, a.sq,
      a.sk, a.d, a.qs, a.ks, a.vs, a.dos, a.scale, a.logit_bias, a.causal,
      mask, a.mask_sb, bias, a.bias_sn, a.bias_ss, static_cast<int>(vec));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = flash_bwd_dkv_mma_kernel<DP, HAS_MASK, SIGMOID, HAS_BIAS>;
  constexpr int dkv_smem = kDkvSmem<DP, HAS_BIAS>;
  err = jimm::allow_smem(dkv_kernel, dkv_smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(a.batch * a.heads, (a.sk + kRows - 1) / kRows), kThreads,
               dkv_smem, a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.heads, a.sq, a.sk, a.d, a.qs, a.ks, a.vs,
      a.dos, a.scale, a.logit_bias, a.causal, mask, a.mask_sb, bias,
      a.bias_sn, a.bias_ss, static_cast<int>(vec),
      static_cast<int>(vec_bias));
  return cudaGetLastError();
}

}  // namespace tc

// f32 (and bf16 at D = 256) on the FMA body, bf16 up to D = 128 on the
// mma.sync body
template <typename T, int DP, int BQ, int BK, bool HAS_MASK, bool SIGMOID,
          bool HAS_BIAS>
cudaError_t launch(const Args& a) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && DP <= 128) {
    return tc::launch<DP, HAS_MASK, SIGMOID, HAS_BIAS>(a);
  } else {
    constexpr int LD = DP + 4;
    const auto* q = static_cast<const T*>(a.q);
    const auto* k = static_cast<const T*>(a.k);
    const auto* v = static_cast<const T*>(a.v);
    const auto* dout = static_cast<const T*>(a.dout);
    const auto* lse = static_cast<const float*>(a.lse);
    const auto* delta = static_cast<const float*>(a.delta);
    const auto* mask = static_cast<const unsigned char*>(a.mask);
    const auto* bias = static_cast<const float*>(a.bias);

    auto dq_kernel =
        flash_bwd_dq_kernel<T, DP, BQ, BK, HAS_MASK, SIGMOID, HAS_BIAS>;
    const int dq_smem = ((2 * BQ + 2 * BK) * LD + BQ * (BK + 4)) *
                        static_cast<int>(sizeof(float));
    cudaError_t err = jimm::allow_smem(dq_kernel, dq_smem);
    if (err != cudaSuccess) return err;
    dq_kernel<<<dim3(a.batch * a.heads, (a.sq + BQ - 1) / BQ), kThreads,
                dq_smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.heads, a.sq,
        a.sk, a.d, a.qs, a.ks, a.vs, a.dos, a.scale, a.logit_bias, a.causal,
        mask, a.mask_sb, bias, a.bias_sn, a.bias_ss);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    auto dkv_kernel =
        flash_bwd_dkv_kernel<T, DP, BQ, BK, HAS_MASK, SIGMOID, HAS_BIAS>;
    const int dkv_smem = ((2 * BQ + 2 * BK) * LD + 2 * BK * (BQ + 4)) *
                         static_cast<int>(sizeof(float));
    err = jimm::allow_smem(dkv_kernel, dkv_smem);
    if (err != cudaSuccess) return err;
    dkv_kernel<<<dim3(a.batch * a.heads, (a.sk + BK - 1) / BK), kThreads,
                 dkv_smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.heads, a.sq, a.sk, a.d, a.qs, a.ks, a.vs,
        a.dos, a.scale, a.logit_bias, a.causal, mask, a.mask_sb, bias,
        a.bias_sn, a.bias_ss);
    return cudaGetLastError();
  }
}

// the kinds: masked, biased (softmax without a mask only: no entry point of
// either package passes a bias with a mask or under sigmoid), or neither
template <typename T, int DP, int BQ, int BK, bool SIGMOID>
cudaError_t with_mask(const Args& a) {
  if (a.mask) return launch<T, DP, BQ, BK, true, SIGMOID, false>(a);
  if constexpr (!SIGMOID) {
    if (a.bias) return launch<T, DP, BQ, BK, false, false, true>(a);
  }
  return launch<T, DP, BQ, BK, false, SIGMOID, false>(a);
}

template <typename T, bool SIGMOID>
cudaError_t dispatch(const Args& a) {
  // 64-row tiles up to D = 128; at 256 the f32 tiles take 32 rows to fit
  // the 227 KB of shared memory and keep the accumulators in registers
  if (a.d <= 64) return with_mask<T, 64, 64, 64, SIGMOID>(a);
  if (a.d <= 128) return with_mask<T, 128, 64, 64, SIGMOID>(a);
  return with_mask<T, 256, 32, 32, SIGMOID>(a);
}

bool bad_shape(int batch, int heads, int sq, int sk, int d) {
  return batch < 1 || heads < 1 || sq < 1 || sk < 1 || d < 1 || d > 256 ||
         static_cast<long long>(batch) * heads > 0x7fffffffLL ||
         (sq + 31) / 32 > 65535 || (sk + 31) / 32 > 65535;
}

template <bool SIGMOID>
int run(const Args& a, int dtype) {
  switch (dtype) {
    case jimm::kF32:
      return dispatch<float, SIGMOID>(a);
    case jimm::kBF16:
      return dispatch<__nv_bfloat16, SIGMOID>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout: (B, Sq, N, D), k/v: (B, Sk, N, D) in `dtype`, unit stride over D,
// the other strides in elements. lse, delta: (B, N, Sq) contiguous f32.
// dq: (B, Sq, N, D), dk/dv: (B, Sk, N, D) contiguous in `dtype`, every
// element written. mask: null, or the (B, Sk) key-padding mask, one byte a
// key (nonzero = attend), unit stride over Sk and batch stride mask_sb.
// Launches the dq kernel, then the dk/dv kernel, on `stream`. Returns the
// first failing launch's cudaError_t (0 = launched).
extern "C" int jimm_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int batch, int heads, int sq, int sk, int d, long long q_sb,
    long long q_ss, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn,
    long long do_sb, long long do_ss, long long do_sn, float scale,
    int causal, const void* mask, long long mask_sb, int dtype,
    void* stream) {
  if (bad_shape(batch, heads, sq, sk, d)) return cudaErrorInvalidValue;
  const Args a{q,      k,      v,     dout,  lse,   delta,
               dq,     dk,     dv,    batch, heads, sq,
               sk,     d,      {q_sb, q_ss, q_sn},  {k_sb, k_ss, k_sn},
               {v_sb, v_ss, v_sn},    {do_sb, do_ss, do_sn},
               scale,  0.f,    causal, mask, mask_sb, nullptr, 0, 0,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, dtype);
}

// The bias kind's backward (row 7's bias kind): jimm_flash_attention_bwd's
// arguments without a mask, and the forward's bias: (N, Sq, Sk) f32, unit
// stride over Sk, head stride bias_sn and row stride bias_ss (0 for a bias
// broadcast over heads or rows), read at head `bh % heads`. dbias is
// jimm_flash_attention_dbias's. Launches the dq kernel, then the dk/dv
// kernel, on `stream`. Returns the first failing launch's cudaError_t.
extern "C" int jimm_flash_attention_bias_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dq, void* dk,
    void* dv, int batch, int heads, int sq, int sk, int d, long long q_sb,
    long long q_ss, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn,
    long long do_sb, long long do_ss, long long do_sn, long long bias_sn,
    long long bias_ss, float scale, int causal, int dtype, void* stream) {
  if (bad_shape(batch, heads, sq, sk, d) || bias == nullptr)
    return cudaErrorInvalidValue;
  const Args a{q,      k,      v,     dout,  lse,   delta,
               dq,     dk,     dv,    batch, heads, sq,
               sk,     d,      {q_sb, q_ss, q_sn},  {k_sb, k_ss, k_sn},
               {v_sb, v_ss, v_sn},    {do_sb, do_ss, do_sn},
               scale,  0.f,    causal, nullptr, 0, bias, bias_sn, bias_ss,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, dtype);
}

// Sigmoid attention's backward (row 7's sigmoid kind): the same arguments
// but lse and delta (none) and logit_bias, the forward's scalar bias.
// Launches the dq kernel, then the dk/dv kernel, on `stream`. Returns the
// first failing launch's cudaError_t (0 = launched).
extern "C" int jimm_sigmoid_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, int batch, int heads, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn, long long k_sb,
    long long k_ss, long long k_sn, long long v_sb, long long v_ss,
    long long v_sn, long long do_sb, long long do_ss, long long do_sn,
    float scale, float logit_bias, int causal, const void* mask,
    long long mask_sb, int dtype, void* stream) {
  if (bad_shape(batch, heads, sq, sk, d)) return cudaErrorInvalidValue;
  const Args a{q,      k,          v,      dout,  nullptr, nullptr,
               dq,     dk,         dv,     batch, heads,   sq,
               sk,     d,          {q_sb, q_ss, q_sn},     {k_sb, k_ss, k_sn},
               {v_sb, v_ss, v_sn}, {do_sb, do_ss, do_sn},
               scale,  logit_bias, causal, mask,  mask_sb, nullptr, 0, 0,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, dtype);
}
