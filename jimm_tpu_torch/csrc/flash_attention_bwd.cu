// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv, softmax or
// sigmoid scores, with or without a key-padding mask, or softmax with an
// additive bias.
//
// Replaces the TPU kernels jimm_tpu/ops/flash_attention.py::_bwd_dq_kernel
// and ::_bwd_dkv_kernel, softmax kind: without a mask, with one (has_mask,
// the mask kind of kernel row 7) and with a bias (has_bias, the bias kind,
// below; all launched by _flash_bwd through pl.pallas_call). Same numerics (_ds_tile): the score
// s = (q . k) * scale is recomputed in f32 from the saved inputs,
// p = exp(s - lse) from the forward's f32 logsumexp, dp = do . v in f32,
// ds = p * (dp - delta) with delta = rowsum(do * o) (computed by the wrapper,
// minus any lse cotangent). Before the products that consume them, p (for
// dv) and ds (for dq and dk) are rounded to the input dtype, as the TPU
// kernels round them to bf16 before their MXU dots; in f32 that rounding is
// the identity. scale is applied once, to the finished dq and dk.
//
// Design: the two kernels of the FA2 arrangement, as on the TPU, and no
// atomics. dq: one CTA of 256 threads per (batch*head, BQ-row q tile), the
// q and do tiles resident in shared memory, looping over BK-row k/v tiles;
// the ds tile goes through shared memory into dq += ds . k. dk/dv: one CTA
// per (batch*head, BK-row k tile), the k and v tiles resident, looping over
// q tiles; p^T and ds^T go through shared memory into dv += p^T . do and
// dk += ds^T . q. The TPU kernels make that loop a sequential grid axis and
// carry the sums in VMEM scratch; here it runs inside the CTA and the sums
// live in registers. Thread (ty, tx) of the 16 x 16 layout owns rows
// ty*R..ty*R+R-1 of its CTA's resident tile, computes their scores against
// the streamed rows tx + 16*j, and accumulates its rows over output columns
// 64*g + 4*tx..+3, as the forward kernel does. The head dim is zero-padded
// to 64/128/256 in shared memory only; inputs are read through their
// (B, S, N, D) strides. Keys >= Sk (dq kernel) and queries >= Sq (dkv
// kernel; padded rows have lse 0 and exp(s - 0) overflows) are masked to
// p = 0, as the TPU kernels mask them with `pos`; causal skips the tiles
// wholly above the diagonal (top-left aligned) in both kernels.
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
// What bounds it on the H100: at the training shapes (S <= 256, D = 64) the
// bytes, ~20 bytes per (row, feature) in bf16 moved once, against
// 8*Sq*Sk*D flops; like the forward, this first version computes with f32
// FMAs, so its time is set by those FMAs (five S x S x D products, two of
// them recomputations of the forward's) rather than by the bytes; the
// tensor-core version is later work. f32 tiles in shared memory convert
// each input element once, and row strides padded by 4 floats keep the
// float4 reads free of bank conflicts.

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
// sigmoid(s * scale + logit_bias), ds = p * (1 - p) * dp. ds is rounded to
// T; p is returned unrounded.
template <typename T, bool SIGMOID, bool HAS_BIAS>
__device__ __forceinline__ float p_ds(float s, float dp, bool keep,
                                      float scale, float lse_or_bias,
                                      float delta, float b, float& ds) {
  if constexpr (SIGMOID) {
    const float x = __fadd_rn(__fmul_rn(s, scale), lse_or_bias);
    const float p = keep ? 1.f / (1.f + expf(-x)) : 0.f;
    ds = round_to<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(1.f, p)), dp));
    return p;
  } else if constexpr (HAS_BIAS) {
    const float x = __fadd_rn(__fmul_rn(s, scale), b);
    const float p = keep ? expf(__fsub_rn(x, lse_or_bias)) : 0.f;
    ds = round_to<T>(p * (dp - delta));
    return p;
  } else {
    const float p = keep ? expf(s * scale - lse_or_bias) : 0.f;
    ds = round_to<T>(p * (dp - delta));
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
        p_ds<T, SIGMOID, HAS_BIAS>(s[i][j], dp[i][j], keep, scale, lse_r[i],
                                   delta_r[i], b, ds);
        dss[(ty * RQ + i) * LDS + tx + 16 * j] = ds;
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
        const float p = p_ds<T, SIGMOID, HAS_BIAS>(s[a][b], dp[a][b], keep,
                                                   scale, l, dl, bv, ds);
        pts[(ty * RK + a) * LDS + tx + 16 * b] = round_to<T>(p);
        dsts[(ty * RK + a) * LDS + tx + 16 * b] = ds;
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

template <typename T, int DP, int BQ, int BK, bool HAS_MASK, bool SIGMOID,
          bool HAS_BIAS>
cudaError_t launch(const Args& a) {
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
  const int dq_smem =
      ((2 * BQ + 2 * BK) * LD + BQ * (BK + 4)) * static_cast<int>(sizeof(float));
  cudaError_t err = jimm::allow_smem(dq_kernel, dq_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(a.batch * a.heads, (a.sq + BQ - 1) / BQ), kThreads, dq_smem,
              a.stream>>>(q, k, v, dout, lse, delta, static_cast<T*>(a.dq),
                          a.heads, a.sq, a.sk, a.d, a.qs, a.ks, a.vs, a.dos,
                          a.scale, a.logit_bias, a.causal, mask, a.mask_sb,
                          bias, a.bias_sn, a.bias_ss);
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
      q, k, v, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.heads, a.sq, a.sk, a.d, a.qs, a.ks, a.vs, a.dos, a.scale,
      a.logit_bias, a.causal, mask, a.mask_sb, bias, a.bias_sn, a.bias_ss);
  return cudaGetLastError();
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
