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
// CTA per (head, 64-row q tile, 64-key tile, batch range), which loops over
// its samples in order and keeps its sums in registers; the bias tile is
// staged in shared memory once, before the loop, and the sums are written
// once, after it. When the tiles give fewer than two CTAs an SM (the train
// shape's 192 tiles on 132 SMs), the wrapper splits the batch into ranges
// (for about four waves), each CTA writes its range's sums to a workspace,
// and a second kernel adds the ranges in order, as row 12's split K does.
// No atomics: the result does not depend on scheduling. Dropped pairs
// (ragged rows and keys, causal) add nothing; a tile wholly above the
// causal diagonal skips the loop and writes its zeros. A key whose bias is
// -inf, and every key of a row with no finite score (lse = -1e30), has
// p = 0 and gets a zero gradient.
//
// bf16 up to D = 128 (the mma.sync body, on the building blocks of
// flash_mma.cuh): eight warps, each owning 16 q rows and 32 keys of the
// tile (four warps of 16 rows x 64 keys took 0.82 ms at the train shape
// against 0.67, side by side on an H100 80GB HBM3 at 700 W); for each
// sample the q, do, k and v bf16 tiles and the rows' lse and delta arrive
// by cp.async into XOR-swizzled shared tiles, double-buffered across
// samples; s = q . k^T and dp = do . v^T run on bf16 mma.sync with the
// fragment code of row 7's dq kernel; ds is formed on the fragments and
// added to the warp's 16 x 32 f32 sums. The CTAs of one (head, batch range)
// are launched side by side (the k tile fastest, then the q tile), so the
// four that share a q tile, and the four that share a k tile, read it from
// L2 at about the same time.
//
// f32 (and bf16 at D = 256) keeps the FMA body: 256 threads, each sample's
// tiles staged as f32 (each thread at a fixed column issuing all its loads
// of a tile before their stores), s and dp on f32 FMAs, thread (ty, tx)
// owning rows ty*R..+R-1 and keys tx + 16*j (2.21 ms at the train shape in
// bf16 on an H100 80GB HBM3 at 700 W, the first version with the scalar
// tile loop 2.77 ms; PERF.md). mma.sync would round f32 to TF32, and f32 is
// the port's exactness path, so the dispatch by dtype is a compile-time
// choice, not a fallback.
//
// What bounds it on the H100: at the train shape (B = 128, S = 256, N = 12,
// D = 64) the bytes, ~211 MB (q, k, v and do in bf16 read once, lse, delta,
// the bias and dbias in f32), against 4 * B * N * Sq * Sk * D = 25.8 GFLOP of
// two products (~0.03 ms on bf16 tensor cores). Each CTA rereads its q/do
// and k/v tiles once per k or q tile of the row: ~800 MB of tile reads,
// mostly from L2, which the launch order above keeps together.

#include <algorithm>
#include <climits>
#include <type_traits>

#include "flash_mma.cuh"
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
// H100 80GB HBM3 at 700 W, when bf16 ran this body; each storage type gets
// its faster build (bf16 reaches it now at D = 256 only)
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

// -- the bf16 body (mma.sync) ------------------------------------------------

namespace tc {

using jimm::mma::bf16;
using jimm::mma::cp_async16;
using jimm::mma::cp_async_commit;
using jimm::mma::cp_async_wait;
using jimm::mma::kRows;
using jimm::mma::load_a;
using jimm::mma::load_tile;
using jimm::mma::load_vec64;
using jimm::mma::mma_rows;
using jimm::mma::smem_u32;

// the staged bias tile's row stride (floats): a quad's float2 reads of one
// row land in other banks than the next row's
constexpr int kBiasLd = kRows + 8;

template <int DP>
constexpr int kTile = kRows * DP * 2;  // one bf16 tile (bytes)
// a sample's buffer: the q, do, k and v tiles, the rows' lse and delta
template <int DP>
constexpr int kBuf = 4 * kTile<DP> + 2 * kRows * 4;
template <int DP>
constexpr int kSmem = 2 * kBuf<DP> + kRows * kBiasLd * 4;

// eight warps a CTA; two CTAs an SM at D = 64 (83 KB of shared memory
// each), one at 128
constexpr int kThreads = 256;
template <int DP>
constexpr int kMinCtas = DP == 64 ? 2 : 1;

template <int DP>
__global__ void __launch_bounds__(kThreads, kMinCtas<DP>)
    flash_dbias_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ out_base, int batch,
    int heads, int sq, int sk, int d, int b_range, Strides qst, Strides kst,
    Strides vst, Strides dst, long long bias_sn, long long bias_ss,
    float scale, int causal, int vec, int vec_bias) {
  constexpr int kKC = DP / 16;  // k16 steps over the head dim
  extern __shared__ __align__(16) unsigned char smem_db[];
  auto buffer = [&](int buf) { return smem_db + buf * kBuf<DP>; };
  float* bias_t = reinterpret_cast<float*>(smem_db + 2 * kBuf<DP>);

  // blockIdx.x: ((range r, head h), q tile, k tile), the k tile fastest;
  // range r's sums go to slice r of out_base (dbias itself for a single
  // range, else the workspace)
  const int tq = (sq + kRows - 1) / kRows, tk = (sk + kRows - 1) / kRows;
  const int ki = blockIdx.x % tk, qi = (blockIdx.x / tk) % tq;
  const int hr = blockIdx.x / tk / tq;
  const int h = hr % heads, r = hr / heads;
  const int q0 = qi * kRows, k0 = ki * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this warp's rows 16 wr.. and keys 32 wc.. of the tile
  const int wr = warp % 4, wc = warp / 4;
  const int r_lo = q0 + wr * 16 + lane / 4;  // this lane's rows: +0, +8
  const float* hbias = bias + h * bias_sn;
  float* out = out_base + (static_cast<long long>(r) * heads + h) * sq * sk;

  // causal: a tile whose first key lies past its last query row is all
  // dropped pairs; it skips the batch loop and writes zeros
  const int b0 = r * b_range;
  const int samples =
      causal && k0 > q0 + kRows - 1 ? 0 : min(batch, b0 + b_range) - b0;
  auto issue = [&](int i) {
    unsigned char* b = buffer(i & 1);
    const int bi = b0 + i;
    load_tile<DP, kThreads>(b, q + bi * qst.b + h * qst.n, qst.s, q0, sq, d,
                            vec);
    load_tile<DP, kThreads>(b + kTile<DP>, dout + bi * dst.b + h * dst.n,
                            dst.s, q0, sq, d, vec);
    load_tile<DP, kThreads>(b + 2 * kTile<DP>, k + bi * kst.b + h * kst.n,
                            kst.s, k0, sk, d, vec);
    load_tile<DP, kThreads>(b + 3 * kTile<DP>, v + bi * vst.b + h * vst.n,
                            vst.s, k0, sk, d, vec);
    float* stats = reinterpret_cast<float*>(b + 4 * kTile<DP>);
    const long long at = (static_cast<long long>(bi) * heads + h) * sq;
    load_vec64(stats, lse + at, q0, sq);
    load_vec64(stats + kRows, delta + at, q0, sq);
    cp_async_commit();
  };
  if (samples > 0) {
    // the (64 q, 64 key) bias tile, zero past Sq and Sk: 16-byte chunks by
    // cp.async where every row is on a 16-byte boundary, else word by word;
    // it arrives with the first sample's tiles
    for (int idx = threadIdx.x; idx < kRows * kRows / 4; idx += kThreads) {
      const int rr = idx / (kRows / 4), c = (idx % (kRows / 4)) * 4;
      const int row = q0 + rr, col = k0 + c;
      const bool in = row < sq && col < sk;
      const float* src = hbias + static_cast<long long>(row) * bias_ss + col;
      if (vec_bias) {
        cp_async16(smem_u32(bias_t + rr * kBiasLd + c), in ? src : hbias,
                   in ? min(4, sk - col) * 4 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bias_t[rr * kBiasLd + c + e] = in && col + e < sk ? src[e] : 0.f;
      }
    }
    issue(0);
  }

  // the warp's 16 x 32 sums: rows r_lo + 8 i, keys k0 + 32 wc + 8 j +
  // 2 (lane % 4) + c in element 2 i + c of block j
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int rl = wr * 16 + lane / 4;  // this lane's first tile row

  for (int i = 0; i < samples; ++i) {
    const unsigned char* b = buffer(i & 1);
    if (i + 1 < samples) {
      issue(i + 1);  // into the buffer the previous sample released
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t qt = smem_u32(b), dt = qt + kTile<DP>;
    const uint32_t kt = dt + kTile<DP>, vt = kt + kTile<DP>;
    const float* stats = reinterpret_cast<const float*>(b + 4 * kTile<DP>);

    // s = q . k^T and dp = do . v^T: 16 rows x 32 keys a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t aq[4], ad[4];
      load_a<DP>(aq, qt, wr * 16, kc, lane);
      load_a<DP>(ad, dt, wr * 16, kc, lane);
      mma_rows<DP, 4>(s, aq, kt, wc * 32, kc, lane);
      mma_rows<DP, 4>(dp, ad, vt, wc * 32, kc, lane);
    }

    // ds on the fragments, the TPU kernel's roundings, added in order (a
    // dropped pair's sum, which may be inf or NaN, is never written)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row_t = rl + 8 * hi;
      const float l = stats[row_t], dl = stats[kRows + row_t];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col_t = wc * 32 + j * 8 + 2 * (lane % 4);
        const float2 bb =
            *reinterpret_cast<const float2*>(bias_t + row_t * kBiasLd + col_t);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * hi + c;
          const float x = __fadd_rn(__fmul_rn(s[j][e], scale),
                                    c == 0 ? bb.x : bb.y);
          const float p = expf(__fsub_rn(x, l));
          acc[j][e] =
              __fadd_rn(acc[j][e], __fmul_rn(p, __fsub_rn(dp[j][e], dl)));
        }
      }
    }
    __syncthreads();  // this sample's buffer is no longer read
  }

  // the sums of the kept pairs, zero at a dropped one (causal)
  const bool pairs = sk % 2 == 0;  // a column pair is one 8-byte store
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = r_lo + 8 * hi;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + wc * 32 + j * 8 + 2 * (lane % 4);
      const float y0 = !causal || col <= row ? acc[j][2 * hi] : 0.f;
      const float y1 = !causal || col + 1 <= row ? acc[j][2 * hi + 1] : 0.f;
      float* o = out + static_cast<long long>(row) * sk + col;
      if (pairs && col + 1 < sk) {
        *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
      } else {
        if (col < sk) o[0] = y0;
        if (col + 1 < sk) o[1] = y1;
      }
    }
  }
}

}  // namespace tc

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

// the dbias kernel on `stream` (bf16 up to D = 128 on the mma.sync body,
// f32 and bf16 at D = 256 on the FMA body), then, for more than one batch
// range, the kernel that adds the ranges
template <typename T, int DP, int BT>
cudaError_t launch(const Args& a) {
  const int ranges = (a.batch + a.b_range - 1) / a.b_range;
  auto* dbias = static_cast<float*>(a.dbias);
  auto* out = ranges == 1 ? dbias : static_cast<float*>(a.workspace);
  const auto* q = static_cast<const T*>(a.q);
  const auto* k = static_cast<const T*>(a.k);
  const auto* v = static_cast<const T*>(a.v);
  const auto* dout = static_cast<const T*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* delta = static_cast<const float*>(a.delta);
  const auto* bias = static_cast<const float*>(a.bias);
  cudaError_t err;
  if constexpr (std::is_same_v<T, __nv_bfloat16> && DP <= 128) {
    const long long ctas = static_cast<long long>(a.heads) * ranges *
                           ((a.sq + tc::kRows - 1) / tc::kRows) *
                           ((a.sk + tc::kRows - 1) / tc::kRows);
    if (ctas > INT_MAX) return cudaErrorInvalidValue;
    // cp.async needs every row of q, k, v and do on a 16-byte boundary, and
    // the bias's rows for its tile
    bool vec = true;
    for (const void* p : {a.q, a.k, a.v, a.dout})
      vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    for (const Strides& st : {a.qs, a.ks, a.vs, a.dos})
      vec = vec && st.b % 8 == 0 && st.s % 8 == 0 && st.n % 8 == 0;
    const bool vec_bias = reinterpret_cast<uintptr_t>(a.bias) % 16 == 0 &&
                          a.bias_sn % 4 == 0 && a.bias_ss % 4 == 0;
    auto kernel = tc::flash_dbias_mma_kernel<DP>;
    err = jimm::allow_smem(kernel, tc::kSmem<DP>);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(ctas), tc::kThreads, tc::kSmem<DP>,
             a.stream>>>(q, k, v, dout, lse, delta, bias, out, a.batch,
                         a.heads, a.sq, a.sk, a.d, a.b_range, a.qs, a.ks,
                         a.vs, a.dos, a.bias_sn, a.bias_ss, a.scale,
                         a.causal, static_cast<int>(vec),
                         static_cast<int>(vec_bias));
  } else {
    auto kernel = flash_dbias_kernel<T, DP, BT>;
    const int smem =
        (4 * BT * (DP + 4) + BT * (BT + 4)) * static_cast<int>(sizeof(float));
    err = jimm::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.heads * ranges, (a.sq + BT - 1) / BT,
                    (a.sk + BT - 1) / BT);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, dout, lse, delta, bias, out, a.batch, a.heads, a.sq, a.sk,
        a.d, a.b_range, a.qs, a.ks, a.vs, a.dos, a.bias_sn, a.bias_ss,
        a.scale, a.causal);
  }
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
  // 64 x 64 tiles up to D = 128 (the FMA body's four f32 tiles: 68 / 132
  // KB of shared memory; the mma body's two buffers of four bf16 tiles and
  // the bias tile: 83 / 147 KB); at 256 the FMA body's tiles take 32 rows to
  // fit in 227 KB
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
