// Flash-attention forward for Hopper (sm_90a), softmax or sigmoid scores,
// with or without a key-padding mask, or softmax with an additive bias.
//
// Replaces the TPU kernel jimm_tpu/ops/flash_attention.py::_fwd_kernel,
// softmax kind: without a mask (kernel row 3), with one (has_mask, kernel
// row 4, reached through flash_attention_masked) and with a bias (has_bias,
// kernel row 5, below; all launched by _flash through pl.pallas_call).
// Same numerics: the q.k score is accumulated in f32 and scaled after the
// dot; masked scores are -1e30, not -inf; the running max starts at -1e30
// and the running sum at 0; p is rounded to the input dtype before p . v
// (the sum l is taken of the unrounded p, as on the TPU); a row with l == 0
// divides by 1; o = acc / l is stored in the input dtype and lse =
// m + log(l) in f32.
//
// The key-padding mask: the TPU kernel adds an f32 row of 0 / -1e30 per key,
// expanded host-side to one row per (batch, head). Here the HAS_MASK
// instantiation reads the caller's (B, Sk) mask, one byte a key (nonzero =
// attend), at the CTA's own batch index: each k tile's 64 bytes are staged
// in shared memory with the k/v tiles (as bytes in the f32 body, as one
// bit a key in the bf16 body) and folded into the keep predicate
// that already masks ragged and causal keys. For a finite score
// s + (-1e30) rounds to -1e30 in f32, so the select is the TPU's add. A
// query row whose keys are all masked gives finite garbage, as on the TPU.
// The f32 body's HAS_MASK instantiation loads its k/v tiles with
// load_tile_batched: with load_tile, nvcc laid its v loop out as
// branch-guarded single loads, each waiting out its latency before the next
// store (one LDG per STS in the SASS), and the masked kernel took 1.31x its
// unmasked twin's time on an H100 80GB HBM3 at 700 W (PERF.md).
//
// The sigmoid kind (SIGMOID, kernel row 6; _fwd_kernel with
// kind="sigmoid", launched by sigmoid_attention): p = sigmoid(s + logit_bias)
// with s = (q . k) * scale in f32, each step rounded on its own as XLA
// rounds the TPU kernel's; a dropped key (ragged, causal or masked) has
// p = 0 exactly, where the TPU's -1e30 score gives sigmoid(-1e30) = 0, so a
// row with no key to attend is exactly zero. There is no normaliser: no
// running max or sum, no rescale of the accumulator, no lse; p is rounded
// to the input dtype before p . v, as the TPU kernel casts it for its MXU
// dot, and o is the accumulator itself.
//
// The bias kind (HAS_BIAS, kernel row 5; _fwd_kernel with has_bias,
// launched by flash_attention_bias): an f32 (N, Sq, Sk) bias, shared by the
// batch, read at head bh % heads through its strides (0 over an axis the
// caller broadcast) and added to each kept score after the scale: s =
// (q . k) * scale + bias, the multiply and the add each rounded on its own
// (__fmul_rn, __fadd_rn: no FMA contraction), as XLA rounds _scores. A
// quad's 8 keys of one row are neighbours in the bias (a half-warp's 16 in
// the f32 body), so its reads fill whole sectors, and the 3 MB bias of the train shape stays in L2 across the
// batch. A bias of -inf (an additive mask) drops a key: p = exp(-inf) = 0.
// Dropped keys (ragged, causal) give p = 0 here rather than exp(-1e30 - m),
// which is the same number whenever the row has a finite score; a row with
// no finite score then keeps m = -1e30 and l = 0, and gives o = 0 and
// lse = -1e30, as on the TPU, where the reference softmax gives NaN.
// Instantiated for softmax without a mask only: no entry point of either
// package passes a bias with a mask or under sigmoid.
//
// Design for bf16 (the FA2 arrangement on mma.sync tensor cores, with the
// building blocks of flash_mma.cuh, which the bf16 backward and the int8-QK
// forward share): one CTA of four warps per (batch*head, 64-row q tile);
// each warp owns 16 q rows.
// The TPU kernel makes the kv loop a sequential grid axis and carries
// m/l/acc in VMEM scratch between grid steps; here the kv loop runs inside
// the CTA over 64-key k/v tiles, and m/l/acc live in registers. q and each
// k/v tile come from device memory by cp.async, 16 bytes a thread along D
// (contiguous in the (B, S, N, D) layout, read through its strides), into
// shared tiles whose 16-byte chunks are XOR-swizzled by row, so that
// ldmatrix reads them free of bank conflicts; the k/v tiles are double
// buffered, the next tile's copies in flight while this one is computed.
// q is read once into registers as mma A fragments (D <= 128; at D = 256
// from shared memory each tile, which keeps the kernel within its
// registers). S = q . k^T runs as m16n8k16 bf16 mma with f32 accumulators;
// the per-kind epilogue (scale, keep predicate, bias, sigmoid) runs on the
// fragments, with the same rounding points as the TPU kernel, and the
// online max and sum are reduced across each row's quad of threads with
// shuffles. p is rounded to bf16 and packed in registers into the A
// fragments of p . v (FA2's register reuse), the bf16 p the TPU kernel's
// MXU dot takes (p.astype(v.dtype)); v is read with ldmatrix.trans as the
// B operand. The head dim is zero-padded to 64/128/256 in shared memory
// only; device memory is read at its real width D (a partial chunk is
// zero-filled by cp.async). Rows whose base is not on a 16-byte boundary
// (a strided view, an odd D) are loaded element by element into the same
// layout. Ragged Sq and Sk are masked inside; causal skips the k/v tiles
// past the q tile's last row (top-left aligned, as on the TPU).
//
// f32 inputs keep the FMA body below (one CTA of 256 threads in a 16 x 16
// layout, f32 tiles in shared memory): mma.sync would round them to TF32,
// and f32 is the port's exactness path, so the dispatch by dtype is a
// compile-time choice, not a fallback.
//
// What bounds it on the H100: at the served and trained shapes (S <= 256,
// D = 64) the bytes: 2 bytes an element of q/k/v/o in bf16 against
// 4*Sq*Sk*D flops, under the ~295 flops a byte where the tensor cores would
// be the limit (train image shape (128, 256, 12, 64): 0.0606 ms by bytes,
// 0.026 ms by operations at 989 TFLOP/s). On mma.sync the products leave
// the CUDA cores' FMA pipe (67 TFLOP/s), and the per-score epilogue (the
// exp, the running max, the bias reads) on the CUDA cores sets the pace
// (PERF.md: 3.6x the bytes bound at that shape). The mask adds B*Sk bytes to
// what is read (32 KB at the NaFlex train shape, against ~200 MB of
// q/k/v/o), and masked keys are computed like real ones, so the masked
// kernel should take its unmasked twin's time.

#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kBQ = 64;       // q rows per CTA
constexpr int kBK = 64;       // k/v rows per tile
constexpr int kThreads = 256;  // the f32 body
constexpr float kNegInf = -1e30f;

// -- the f32 body (FMA) --------------------------------------------------

// rows [r0, r0 + 64) of one head's (S, D) slice -> f32 shared tile with row
// stride DP + 4; rows >= n and columns >= d are zero
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0, int n,
                                          int d) {
  constexpr int LD = DP + 4;
  for (int idx = threadIdx.x; idx < kBK * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float val = 0.f;
    if (r0 + r < n && c < d)
      val = src[static_cast<long long>(r0 + r) * row_stride + c];
    dst[r * LD + c] = val;
  }
}

// load_tile, written for the compiler: kThreads is a multiple of DP, so a
// thread's column is fixed and its rows advance by kThreads / DP; each load
// address is then the thread's base plus a compile-time multiple of one
// row step, and each thread issues four loads before their four stores
template <int DP>
__device__ __forceinline__ void load_tile_batched(float* dst, const float* src,
                                                  long long row_stride,
                                                  int r0, int n, int d) {
  static_assert(kThreads % DP == 0, "a thread's column must be fixed");
  constexpr int LD = DP + 4;
  constexpr int kRowStep = kThreads / DP;     // 4, 2 or 1
  constexpr int kSteps = kBK / kRowStep;      // 16, 32 or 64 rows a thread
  const int c = threadIdx.x % DP, r = threadIdx.x / DP;
  const bool col_in = c < d;
  const float* base = src + static_cast<long long>(r0 + r) * row_stride + c;
  const long long step = kRowStep * row_stride;
  float* out = dst + r * LD + c;
#pragma unroll
  for (int s0 = 0; s0 < kSteps; s0 += 4) {
    float val[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = col_in && r0 + r + (s0 + u) * kRowStep < n;
      val[u] = in ? base[(s0 + u) * step] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) out[(s0 + u) * kRowStep * LD] = val[u];
  }
}

template <int DP, bool HAS_MASK, bool SIGMOID, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int heads, int sq, int sk,
    int d, long long q_sb, long long q_ss, long long q_sn, long long k_sb,
    long long k_ss, long long k_sn, long long v_sb, long long v_ss,
    long long v_sn, float scale, float logit_bias, int causal,
    const unsigned char* __restrict__ mask, long long mask_sb,
    const float* __restrict__ bias, long long bias_sn, long long bias_ss) {
  constexpr int LD = DP + 4;    // q/k/v tile row stride (floats)
  constexpr int LDP = kBK + 4;  // probability tile row stride
  constexpr int DG = DP / 64;   // float4 column groups of o per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * LD;
  __shared__ bool attend[HAS_MASK ? kBK : 1];  // the k tile's mask bytes

  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int q0 = blockIdx.y * kBQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = q + bi * q_sb + h * q_sn;
  const float* kb = k + bi * k_sb + h * k_sn;
  const float* vb = v + bi * v_sb + h * v_sn;
  const float* hbias = HAS_BIAS ? bias + h * bias_sn : nullptr;

  load_tile<DP>(qs, qb, q_ss, q0, sq, d);

  float m[4], l[4], acc[4][DG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DG * 4; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's k/v/p are no longer read
    if constexpr (HAS_MASK) {
      load_tile_batched<DP>(ks, kb, k_ss, k0, sk, d);
      load_tile_batched<DP>(vs, vb, v_ss, k0, sk, d);
      const int col = k0 + threadIdx.x;
      if (threadIdx.x < kBK)
        attend[threadIdx.x] = col < sk && mask[bi * mask_sb + col] != 0;
    } else {
      load_tile<DP>(ks, kb, k_ss, k0, sk, d);
      load_tile<DP>(vs, vb, v_ss, k0, sk, d);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if constexpr (SIGMOID) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          const bool keep = col < sk && (!causal || col <= row) &&
                            (!HAS_MASK || attend[tx + 16 * j]);
          const float x = __fadd_rn(__fmul_rn(s[i][j], scale), logit_bias);
          ps[(ty * 4 + i) * LDP + tx + 16 * j] =
              keep ? 1.f / (1.f + expf(-x)) : 0.f;
        }
        continue;
      }
      float mx = kNegInf;
      [[maybe_unused]] bool kept[4];  // HAS_BIAS: which scores are real
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < sk && (!causal || col <= row) &&
                          (!HAS_MASK || attend[tx + 16 * j]);
        if constexpr (HAS_BIAS) {
          kept[j] = keep && row < sq;
          s[i][j] = kept[j] ? __fadd_rn(__fmul_rn(s[i][j], scale),
                                        hbias[row * bias_ss + col])
                            : kNegInf;
        } else {
          s[i][j] = keep ? s[i][j] * scale : kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (HAS_BIAS)
          s[i][j] = kept[j] ? expf(s[i][j] - m_new) : 0.f;
        else
          s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DG * 4; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * LDP + c);
        p[i][0] = t.x;
        p[i][1] = t.y;
        p[i][2] = t.z;
        p[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (c + cc) * LD + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g * 4 + 0] = fmaf(p[i][cc], vv.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(p[i][cc], vv.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(p[i][cc], vv.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(p[i][cc], vv.w, acc[i][g * 4 + 3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    // the sigmoid kind's o is the accumulator itself
    const float ll = SIGMOID || l[i] == 0.f ? 1.f : l[i];
    float* orow = o + (static_cast<long long>(bi) * sq + row) * heads * d +
              static_cast<long long>(h) * d;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tx * 4 + e;
        if (col < d) orow[col] = acc[i][g * 4 + e] / ll;
      }
    if (!SIGMOID && tx == 0)
      lse[static_cast<long long>(bh) * sq + row] = m[i] + logf(ll);
  }
}

// -- the bf16 body (mma.sync) ----------------------------------------------

namespace tc {

// the mma.sync building blocks (flash_mma.cuh), named here so that they,
// not the f32 body's load_tile and kThreads, are what the bf16 body sees
using jimm::mma::bf16;
using jimm::mma::cp_async_commit;
using jimm::mma::cp_async_wait;
using jimm::mma::kThreads;
using jimm::mma::kWarps;
using jimm::mma::load_a;
using jimm::mma::load_tile;
using jimm::mma::mma_pv;
using jimm::mma::mma_rows;
using jimm::mma::online_softmax;
using jimm::mma::smem_u32;
static_assert(kBQ == 16 * kWarps, "a warp owns 16 rows of the q tile");
static_assert(kBK == jimm::mma::kRows, "load_tile fills 64-row tiles");

// CTAs an SM should hold: at D = 64 a cap of 128 registers for four
// (timed side by side on an H100 80GB HBM3: 7% faster unmasked, 13% for
// sigmoid, and the masked kind, once its fully attended tiles took the
// epilogue without the keep test, faster still); larger D spills under it
template <int DP>
constexpr int kMinCtas = DP == 64 ? 4 : 1;

// Fragment layouts: flash_mma.cuh (lane 4 g + t holds accumulator rows g
// and g + 8, columns 2t and 2t + 1 of each 8-column block).
template <int DP, bool HAS_MASK, bool SIGMOID, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads, kMinCtas<DP>)
    flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int heads, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn, long long k_sb,
    long long k_ss, long long k_sn, long long v_sb, long long v_ss,
    long long v_sn, float scale, float logit_bias, int causal,
    const unsigned char* __restrict__ mask, long long mask_sb,
    const float* __restrict__ bias, long long bias_sn, long long bias_ss,
    int vec) {
  constexpr int kTileBytes = kBK * DP * 2;  // one q, k or v tile
  constexpr int kKC = DP / 16;              // k16 steps over the head dim
  constexpr bool kQRegs = DP <= 128;        // q held as A fragments
  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* qs = smem_mma;  // then k, v of buffer 0, k, v of buffer 1
  // each k tile's attended keys (real and unmasked), one bit a key
  __shared__ uint32_t attend[2][HAS_MASK ? 2 : 1];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / heads, h = bh % heads;
  const int q0 = blockIdx.y * kBQ;
  const bf16* qb = q + bi * q_sb + h * q_sn;
  const bf16* kb = k + bi * k_sb + h * k_sn;
  const bf16* vb = v + bi * v_sb + h * v_sn;
  const float* hbias = HAS_BIAS ? bias + h * bias_sn : nullptr;
  const int r_lo = q0 + warp * 16 + lane / 4;  // this lane's rows: +0, +8

  load_tile<DP>(qs, qb, q_ss, q0, sq, d, vec);
  cp_async_commit();
  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + kBQ) : sk;
  const int tiles = (kv_end + kBK - 1) / kBK;
  auto issue = [&](int t) {
    const int buf = t & 1, k0 = t * kBK;
    load_tile<DP>(qs + (1 + 2 * buf) * kTileBytes, kb, k_ss, k0, sk, d, vec);
    load_tile<DP>(qs + (2 + 2 * buf) * kTileBytes, vb, v_ss, k0, sk, d, vec);
    if constexpr (HAS_MASK) {
      const int col = k0 + threadIdx.x;
      if (threadIdx.x < kBK) {  // warps 0 and 1, whole
        const uint32_t bits = __ballot_sync(
            0xffffffffu, col < sk && mask[bi * mask_sb + col] != 0);
        if (lane == 0) attend[buf][warp] = bits;
      }
    }
    cp_async_commit();
  };
  issue(0);

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
    const uint32_t ks = smem_u32(qs + (1 + 2 * buf) * kTileBytes);
    const uint32_t vs = smem_u32(qs + (2 + 2 * buf) * kTileBytes);
    // A fragments of q, this warp's 16 rows
    if constexpr (kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          load_a<DP>(qf[kc], smem_u32(qs), warp * 16, kc, lane);
      }
    }

    // s = q . k^T: 16 rows x 64 keys a warp, 8 blocks of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
      } else {
        load_a<DP>(a, smem_u32(qs), warp * 16, kc, lane);
      }
      mma_rows<DP, 8>(s, a, ks, 0, kc, lane);
    }

    // the kinds' epilogue on the fragments; s becomes p (sigmoid) or the
    // scaled score and the rows' max (softmax). A key counts when it is
    // real, not past the row (causal) and attended (mask), and, for the
    // bias kind, whose bias is read per score, when its row is real; a
    // tile in which every key counts for every row of this warp (a NaFlex
    // batch's tiles but the last of its padded ones) takes the epilogue
    // without the test.
    [[maybe_unused]] uint64_t attended = ~0ull;
    if constexpr (HAS_MASK)
      attended = attend[buf][0] |
                 (static_cast<uint64_t>(attend[buf][1]) << 32);
    const bool interior = attended == ~0ull && k0 + kBK <= sk &&
                          (!causal || k0 + kBK - 1 <= q0 + warp * 16) &&
                          (!HAS_BIAS || q0 + warp * 16 + 16 <= sq);
    float mx[2] = {kNegInf, kNegInf};
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
            keep = col < sk && (!causal || col <= row) &&
                   (!HAS_MASK || (attended >> (col - k0)) & 1) &&
                   (!HAS_BIAS || row < sq);
          if constexpr (SIGMOID) {
            const float x =
                __fadd_rn(__fmul_rn(s[j][e], scale), logit_bias);
            s[j][e] = keep ? 1.f / (1.f + expf(-x)) : 0.f;
          } else {
            if constexpr (HAS_BIAS) {
              // a dropped key is -inf: below the running max's -1e30
              // start, and exp(-inf - m) = 0, so it adds nothing to l or
              // acc
              s[j][e] = keep ? __fadd_rn(__fmul_rn(s[j][e], scale),
                                         hbias[row * bias_ss + col])
                             : -CUDART_INF_F;
            } else {
              s[j][e] = keep ? s[j][e] * scale : kNegInf;
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
    };
    if (interior)
      epilogue(std::false_type{});
    else
      epilogue(std::true_type{});
    if constexpr (!SIGMOID) online_softmax<DP>(s, mx, m, l, acc);
    // acc += p . v, p rounded to bf16 in registers (FA2's register reuse)
    mma_pv<DP>(acc, s, vs, lane);
    __syncthreads();  // this tile's buffer is no longer read
  }

  const bool pairs = d % 2 == 0;  // a column pair is one 4-byte store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= sq) continue;
    // the sigmoid kind's o is the accumulator itself
    const float ll = SIGMOID || l[i] == 0.f ? 1.f : l[i];
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
    if (!SIGMOID && lane % 4 == 0)
      lse[static_cast<long long>(bh) * sq + row] = m[i] + logf(ll);
  }
}

}  // namespace tc

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int batch, heads, sq, sk, d;
  long long q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn;
  float scale, logit_bias;
  int causal;
  const void* mask;
  long long mask_sb;
  const void* bias;  // (N, Sq, Sk) f32, unit stride over Sk; null for none
  long long bias_sn, bias_ss;
  cudaStream_t stream;
};

// f32 on the FMA body, bf16 on the mma.sync body
template <typename T, int DP, bool HAS_MASK, bool SIGMOID, bool HAS_BIAS>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.batch * a.heads, (a.sq + kBQ - 1) / kBQ);
  if constexpr (std::is_same_v<T, float>) {
    auto kernel = flash_fwd_f32_kernel<DP, HAS_MASK, SIGMOID, HAS_BIAS>;
    const int smem =
        ((kBQ + 2 * kBK) * (DP + 4) + kBQ * (kBK + 4)) * sizeof(float);
    cudaError_t err = jimm::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o),
        static_cast<float*>(a.lse), a.heads, a.sq, a.sk, a.d, a.q_sb, a.q_ss,
        a.q_sn, a.k_sb, a.k_ss, a.k_sn, a.v_sb, a.v_ss, a.v_sn, a.scale,
        a.logit_bias, a.causal, static_cast<const unsigned char*>(a.mask),
        a.mask_sb, static_cast<const float*>(a.bias), a.bias_sn, a.bias_ss);
  } else {
    auto kernel = tc::flash_fwd_mma_kernel<DP, HAS_MASK, SIGMOID, HAS_BIAS>;
    const int smem = 5 * kBK * DP * static_cast<int>(sizeof(T));
    cudaError_t err = jimm::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    // cp.async needs every row of q, k and v on a 16-byte boundary
    bool vec = true;
    for (const void* p : {a.q, a.k, a.v})
      vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    for (long long st : {a.q_sb, a.q_ss, a.q_sn, a.k_sb, a.k_ss, a.k_sn,
                         a.v_sb, a.v_ss, a.v_sn})
      vec = vec && st % 8 == 0;
    kernel<<<grid, tc::kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o),
        static_cast<float*>(a.lse), a.heads, a.sq, a.sk, a.d, a.q_sb, a.q_ss,
        a.q_sn, a.k_sb, a.k_ss, a.k_sn, a.v_sb, a.v_ss, a.v_sn, a.scale,
        a.logit_bias, a.causal, static_cast<const unsigned char*>(a.mask),
        a.mask_sb, static_cast<const float*>(a.bias), a.bias_sn, a.bias_ss,
        static_cast<int>(vec));
  }
  return cudaGetLastError();
}

// the kinds: masked, biased (softmax without a mask only), or neither
template <typename T, int DP, bool SIGMOID>
cudaError_t with_mask(const Args& a) {
  if (a.mask) return launch<T, DP, true, SIGMOID, false>(a);
  if constexpr (!SIGMOID) {
    if (a.bias) return launch<T, DP, false, false, true>(a);
  }
  return launch<T, DP, false, SIGMOID, false>(a);
}

template <typename T, bool SIGMOID>
cudaError_t dispatch(const Args& a) {
  if (a.d <= 64) return with_mask<T, 64, SIGMOID>(a);
  if (a.d <= 128) return with_mask<T, 128, SIGMOID>(a);
  return with_mask<T, 256, SIGMOID>(a);
}

bool bad_shape(int batch, int heads, int sq, int sk, int d) {
  return batch < 1 || heads < 1 || sq < 1 || sk < 1 || d < 1 || d > 256 ||
         static_cast<long long>(batch) * heads > 0x7fffffffLL ||
         (sq + kBQ - 1) / kBQ > 65535;
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

// q: (B, Sq, N, D), k/v: (B, Sk, N, D) in `dtype`, unit stride over D, the
// other strides in elements. o: (B, Sq, N, D) contiguous in `dtype`;
// lse: (B, N, Sq) contiguous f32. mask: null, or the (B, Sk) key-padding
// mask, one byte a key (nonzero = attend), unit stride over Sk and batch
// stride mask_sb. Returns the launch's cudaError_t.
extern "C" int jimm_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int batch,
    int heads, int sq, int sk, int d, long long q_sb, long long q_ss,
    long long q_sn, long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn, float scale, int causal,
    const void* mask, long long mask_sb, int dtype, void* stream) {
  if (bad_shape(batch, heads, sq, sk, d)) return cudaErrorInvalidValue;
  const Args a{q,    k,    v,    o,     lse,  batch,  heads, sq,
               sk,   d,    q_sb, q_ss,  q_sn, k_sb,   k_ss,  k_sn,
               v_sb, v_ss, v_sn, scale, 0.f,  causal, mask,  mask_sb,
               nullptr, 0,  0,    static_cast<cudaStream_t>(stream)};
  return run<false>(a, dtype);
}

// The bias kind (kernel row 5): jimm_flash_attention_fwd's arguments without
// a mask, and bias: (N, Sq, Sk) f32, unit stride over Sk, head stride
// bias_sn and row stride bias_ss (0 for a bias broadcast over heads or
// rows), read at head `bh % heads`. o: (B, Sq, N, D) contiguous in `dtype`;
// lse: (B, N, Sq) contiguous f32. Returns the launch's cudaError_t.
extern "C" int jimm_flash_attention_bias_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int batch, int heads, int sq, int sk, int d, long long q_sb,
    long long q_ss, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn,
    long long bias_sn, long long bias_ss, float scale, int causal, int dtype,
    void* stream) {
  if (bad_shape(batch, heads, sq, sk, d) || bias == nullptr)
    return cudaErrorInvalidValue;
  const Args a{q,    k,    v,    o,     lse,  batch,  heads,   sq,
               sk,   d,    q_sb, q_ss,  q_sn, k_sb,   k_ss,    k_sn,
               v_sb, v_ss, v_sn, scale, 0.f,  causal, nullptr, 0,
               bias, bias_sn, bias_ss, static_cast<cudaStream_t>(stream)};
  return run<false>(a, dtype);
}

// Sigmoid attention (kernel row 6): the same arguments but lse (none) and
// logit_bias, the scalar added to every scaled score before the sigmoid.
// o: (B, Sq, N, D) contiguous in `dtype`. Returns the launch's cudaError_t.
extern "C" int jimm_sigmoid_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int sk, int d, long long q_sb, long long q_ss,
    long long q_sn, long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn, float scale,
    float logit_bias, int causal, const void* mask, long long mask_sb,
    int dtype, void* stream) {
  if (bad_shape(batch, heads, sq, sk, d)) return cudaErrorInvalidValue;
  const Args a{q,    k,    v,    o,     nullptr,    batch,  heads, sq,
               sk,   d,    q_sb, q_ss,  q_sn,       k_sb,   k_ss,  k_sn,
               v_sb, v_ss, v_sn, scale, logit_bias, causal, mask,  mask_sb,
               nullptr, 0,  0,    static_cast<cudaStream_t>(stream)};
  return run<true>(a, dtype);
}
