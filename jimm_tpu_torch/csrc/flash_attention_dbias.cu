// The gradient of flash attention's additive bias for Hopper (sm_90a):
// dbias[h] = sum over the batch of ds[b, h], f32 (N, Sq, Sk).
//
// Replaces the TPU kernel jimm_tpu/ops/flash_attention.py::_bwd_dbias_kernel
// (kernel row 8, launched by _flash_bwd through pl.pallas_call for the
// has_bias variant). Same numerics (_scores, _ds_tile): for each sample the
// score is recomputed as s = (q . k) * scale + bias in f32, the multiply and
// the add each rounded on its own, p = exp(s - lse) from the forward's f32
// logsumexp, dp = do . v in f32, and ds = p * (dp - delta) with delta =
// rowsum(do * o) (computed by the wrapper). ds is neither scaled (the bias
// adds to the scaled logits) nor rounded to the input dtype: the dq and dk/dv
// kernels round their ds before its products, the TPU's dbias adds the f32
// one. The samples are added in order, 0 to B - 1, into an f32 sum, as the
// TPU's batch-innermost grid adds them (in ranges, below: each range in
// order, then the ranges in order).
//
// Design, from the function rather than from the TPU's grid (there the batch
// is the innermost sequential grid axis, with the sum in VMEM scratch): one
// CTA of 256 threads per (head, BT-row q tile, BT-row k tile, batch range),
// which loops over its samples. For each it stages that sample's q, do, k
// and v tiles in shared memory as f32, each thread at a fixed column issuing
// all its loads of a tile before their stores, and the rows' lse and delta
// with them, so that their latencies overlap (the loop has four tiles to
// load for two products, twice the forward's share); computes the two
// (BT, BT) products s and dp with f32 FMAs (thread (ty, tx) owns rows
// ty*R..+R-1 and keys tx + 16*j, as in the dq kernel); and adds ds to its
// R x R sums in registers, predicated rather than branched. The bias tile is
// staged in shared memory once, before the loop; the sums are written once,
// after it. (The first version, with the scalar tile loop, the bias in
// registers and lse read row by row after the products, took 2.77 ms at the
// train shape on an H100 80GB HBM3 at 700 W; PERF.md.) When the tiles give
// fewer than two CTAs an SM (the train shape's 192 tiles on 132 SMs), the
// wrapper splits the batch into ranges (for about four waves), each CTA
// writes its range's sums to a workspace, and a second kernel adds the
// ranges in order, as row 12's split K does. No atomics: the result does
// not depend on scheduling. Dropped
// pairs (ragged rows and keys, causal) add nothing; a tile wholly above the
// causal diagonal skips the loop and writes its zeros. A key whose bias is
// -inf, and every key of a row with no finite score (lse = -1e30), has
// p = 0 and gets a zero gradient.
//
// What bounds it on the H100: at the train shape (B = 128, S = 256, N = 12,
// D = 64) the bytes, ~211 MB (q, k, v and do in bf16 read once, lse, delta,
// the bias and dbias in f32), against 4 * B * N * Sq * Sk * D = 25.8 GFLOP of
// two products; on f32 FMAs (67 TFLOP/s) those products take longer than
// the bytes, and each CTA rereads its q/do and k/v tiles once per k or q
// tile of the row (from L2).

#include <algorithm>

#include "flash_tiles.cuh"

namespace {

using jimm::flash::kThreads;
using jimm::flash::load_tile_batched;
using jimm::flash::tile_dots;

struct Strides {
  long long b, s, n;
};

// the register cap of two CTAs an SM (128 a thread) made the bf16 kernel
// faster and the f32 one slower at the train shape, timed side by side on an
// H100 80GB HBM3 at 700 W; each storage type gets its faster build
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 2 : 1;

template <typename T, int DP, int BT>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) flash_dbias_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ bias,
    float* __restrict__ out_base, int batch, int heads, int sq, int sk,
    int d, int b_range, Strides qst, Strides kst, Strides vst, Strides dst,
    long long bias_sn, long long bias_ss, float scale, int causal) {
  constexpr int LD = DP + 4, R = BT / 16;
  constexpr int LDB = BT + 4;  // bias tile row stride: a warp's two ty rows
                               // land 16 banks apart
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + BT * LD;
  float* ks = dos + BT * LD;
  float* vs = ks + BT * LD;
  float* bs = vs + BT * LD;  // the bias tile, read once

  // blockIdx.x: head h of batch range r; range r's sums go to slice r of
  // out_base (dbias itself for a single range, else the workspace)
  const int h = blockIdx.x % heads, r = blockIdx.x / heads;
  const int q0 = blockIdx.y * BT, k0 = blockIdx.z * BT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* hbias = bias + h * bias_sn;
  float* out = out_base + (static_cast<long long>(r) * heads + h) * sq * sk;

  for (int idx = threadIdx.x; idx < BT * BT; idx += kThreads) {
    const int row = idx / BT, col = idx % BT;
    bs[row * LDB + col] = q0 + row < sq && k0 + col < sk
                              ? hbias[(q0 + row) * bias_ss + k0 + col]
                              : 0.f;
  }
  // this thread's pairs: rows q0 + ty*R + i, keys k0 + tx + 16*j
  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

  // causal: a tile whose first key lies past its last query row is all
  // dropped pairs; it skips the batch loop and writes zeros
  const int b_end = causal && k0 > q0 + BT - 1 ? 0
                                               : min(batch, (r + 1) * b_range);
  for (int bi = r * b_range; bi < b_end; ++bi) {
    // the rows' lse and delta, loaded with the tiles (a row past Sq reads
    // row Sq - 1 and adds nothing)
    float l_r[R], dl_r[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long at = (static_cast<long long>(bi) * heads + h) * sq +
                           min(q0 + ty * R + i, sq - 1);
      l_r[i] = lse[at];
      dl_r[i] = delta[at];
    }
    __syncthreads();  // the previous sample's tiles are no longer read
    load_tile_batched<T, DP, BT>(qs, q + bi * qst.b + h * qst.n, qst.s, q0,
                                 sq, d);
    load_tile_batched<T, DP, BT>(dos, dout + bi * dst.b + h * dst.n, dst.s,
                                 q0, sq, d);
    load_tile_batched<T, DP, BT>(ks, k + bi * kst.b + h * kst.n, kst.s, k0,
                                 sk, d);
    load_tile_batched<T, DP, BT>(vs, v + bi * vst.b + h * vst.n, vst.s, k0,
                                 sk, d);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dots<DP, R, R>(s, qs, ty * R, ks, tx);
    tile_dots<DP, R, R>(dp, dos, ty * R, vs, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = row < sq && col < sk && (!causal || col <= row);
        const float x = __fadd_rn(__fmul_rn(s[i][j], scale),
                                  bs[(ty * R + i) * LDB + tx + 16 * j]);
        const float p = expf(__fsub_rn(x, l_r[i]));
        const float ds = __fmul_rn(p, __fsub_rn(dp[i][j], dl_r[i]));
        acc[i][j] = keep ? __fadd_rn(acc[i][j], ds) : acc[i][j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = k0 + tx + 16 * j;
      if (col < sk) out[static_cast<long long>(row) * sk + col] = acc[i][j];
    }
  }
}

// dbias = the `ranges` slices of ws, (ranges, n) f32, added in order
__global__ void __launch_bounds__(kThreads) dbias_range_sum_kernel(
    const float* __restrict__ ws, int ranges, long long n,
    float* __restrict__ dbias) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    float acc = ws[i];
    for (int z = 1; z < ranges; ++z) acc = __fadd_rn(acc, ws[z * n + i]);
    dbias[i] = acc;
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *bias;
  void *dbias, *workspace;
  int batch, heads, sq, sk, d, b_range;
  Strides qs, ks, vs, dos;
  long long bias_sn, bias_ss;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int DP, int BT>
cudaError_t launch(const Args& a) {
  auto kernel = flash_dbias_kernel<T, DP, BT>;
  const int smem =
      (4 * BT * (DP + 4) + BT * (BT + 4)) * static_cast<int>(sizeof(float));
  cudaError_t err = jimm::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int ranges = (a.batch + a.b_range - 1) / a.b_range;
  auto* dbias = static_cast<float*>(a.dbias);
  auto* out = ranges == 1 ? dbias : static_cast<float*>(a.workspace);
  const dim3 grid(a.heads * ranges, (a.sq + BT - 1) / BT,
                  (a.sk + BT - 1) / BT);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.bias), out, a.batch, a.heads, a.sq, a.sk,
      a.d, a.b_range, a.qs, a.ks, a.vs, a.dos, a.bias_sn, a.bias_ss, a.scale,
      a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return err;
  const long long n = static_cast<long long>(a.heads) * a.sq * a.sk;
  const int blocks = static_cast<int>(
      std::min<long long>((n + kThreads - 1) / kThreads, 4096));
  dbias_range_sum_kernel<<<blocks, kThreads, 0, a.stream>>>(out, ranges, n,
                                                            dbias);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  // 64 x 64 tiles up to D = 128 (four f32 tiles: 68 / 132 KB of shared
  // memory); at 256 the tiles take 32 rows to fit in 227 KB
  if (a.d <= 64) return launch<T, 64, 64>(a);
  if (a.d <= 128) return launch<T, 128, 64>(a);
  return launch<T, 256, 32>(a);
}

}  // namespace

// q, dout: (B, Sq, N, D), k/v: (B, Sk, N, D) in `dtype`, unit stride over D,
// the other strides in elements. lse, delta: (B, N, Sq) contiguous f32.
// bias: (N, Sq, Sk) f32, unit stride over Sk, head stride bias_sn and row
// stride bias_ss (0 for a bias broadcast over heads or rows). dbias:
// (N, Sq, Sk) contiguous f32, every element written. The batch is summed in
// ranges of b_range samples: with more than one range, workspace holds
// ceil(B / b_range) * N * Sq * Sk f32 (null for one range). Launches the
// dbias kernel and, for more than one range, the kernel that adds the
// ranges, on `stream`. Returns the first failing launch's cudaError_t.
extern "C" int jimm_flash_attention_dbias(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dbias,
    void* workspace, int batch, int heads, int sq, int sk, int d,
    int b_range, long long q_sb,
    long long q_ss, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn,
    long long do_sb, long long do_ss, long long do_sn, long long bias_sn,
    long long bias_ss, float scale, int causal, int dtype, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1 || d < 1 || d > 256 ||
      bias == nullptr || b_range < 1 ||
      (b_range < batch && workspace == nullptr) ||
      static_cast<long long>(heads) * ((batch + b_range - 1) / b_range) >
          0x7fffffffLL ||
      (sq + 31) / 32 > 65535 || (sk + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  const Args a{q,          k,        v,     dout,      lse,
               delta,      bias,     dbias, workspace, batch,
               heads,      sq,       sk,    d,         b_range,
               {q_sb, q_ss, q_sn},
               {k_sb, k_ss, k_sn},   {v_sb, v_ss, v_sn},
               {do_sb, do_ss, do_sn}, bias_sn, bias_ss,
               scale,      causal,   static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case jimm::kF32:
      return dispatch<float>(a);
    case jimm::kBF16:
      return dispatch<__nv_bfloat16>(a);
    default:
      return cudaErrorInvalidValue;
  }
}
