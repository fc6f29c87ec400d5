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
// Design: the two kernels of flash_attention_bwd.cu (the FA2 arrangement,
// no atomics), with int8 score tiles. dq: one CTA of 256 threads per
// (batch*head, BQ-row q tile), the int8 q tile and the do tile resident,
// looping over BK-key tiles; each k tile is staged as int8 words (for the
// scores) and once more as dequant(k) in f32 (for dq += ds . k). dk/dv: one
// CTA per (batch*head, BK-key tile), the int8 k tile and the v tile
// resident, looping over q tiles staged as int8 words and as dequant(q).
// Keys >= Sk (dq kernel) and queries >= Sq (dk/dv kernel) are masked to
// p = 0, as the TPU kernels mask them with `pos`; causal skips the tiles
// wholly above the diagonal (top-left aligned).
//
// What bounds it on the H100: the bytes at the training shapes (int8 q/k,
// bf16 v, o, do, dq, dk, dv: ~17 bytes per (row, feature)), against two s32
// score products and four f32 products of S x S x D; this first version
// runs the scores on __dp4a and the rest on f32 FMAs, whose instruction
// rate sets its time, as for the softmax backward kernels.

#include "flash_int8.cuh"

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

template <typename T, int DP, int BQ, int BK>
cudaError_t launch(const Args& a) {
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
