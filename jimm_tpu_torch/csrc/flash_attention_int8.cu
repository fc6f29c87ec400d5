// int8-QK flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel jimm_tpu/ops/flash_attention_int8.py::_fwd_kernel
// (kernel row 9; launched by _int8_fwd_impl through pl.pallas_call), the
// forward of the int8_qk training policy and of impl="flash_int8". Q and K
// arrive quantized per (batch, position, head) row over D (int8 values and
// f32 scales, ops/flash_attention_int8.py::quantize_heads); V stays in the
// storage dtype. Same numerics: the q.k score is an exact s32 dot (the
// TPU's MXU int32 dot; here __dp4a over words of both rows), dequantized as
// ((float(s) * q_scale) * k_scale) * sm_scale in that order, each product
// rounded on its own; masked scores are -1e30; the online softmax keeps its
// max and sum in f32 and sums the unrounded p, while the P.V product takes
// p rounded to V's dtype (the TPU kernel's p.astype(v.dtype)); a row with
// l == 0 divides by 1; o = acc / l in V's dtype, lse = m + log(l) in f32.
// The TPU kernel's blocks reach 512 keys, so at S <= 512 its softmax is one
// pass; this kernel rescales over 64-key tiles, which in f32 differs at
// rounding level and in bf16 can move a rounded p by one bf16 step.
//
// Design: the FA2 arrangement of flash_attention.cu (one CTA of 256 threads
// per (batch*head, 64-row q tile), looping over 64-key tiles in shared
// memory, m/l/acc in registers, thread (ty, tx) owning q rows 4*ty..+3 and
// keys tx + 16*j), with the int8 q and k rows staged as words: a 64-row
// tile of D = 64 is 4 KB instead of the f32 kernel's 16 KB, and each s32
// score is D/4 __dp4a instead of D f32 FMAs. Per-key scales ride in shared
// memory with the k tile, per-query scales in registers. The head dim is
// zero-padded to 64/128/256 bytes (int8) and floats (V) in shared memory;
// zero bytes add zero to the dot. The TPU pads D to 128 lanes for its int8
// tiles, a Mosaic constraint that does not carry over.
//
// What bounds it on the H100: the bytes, as for the f32 kernel: at the train
// image shape (128, 256, 12, 64) bf16 it moves ~155 MB (int8 q/k 50 MB,
// V and o 101 MB, scales and lse 5 MB), 0.046 ms at 3.35 TB/s, against
// 6.4 GOP of int8 scores and 6.4 GFLOP of P.V. This first version runs the
// scores on __dp4a and P.V on f32 FMAs, whose instruction rate sets its
// time; the tensor-core version (mma.sync s8 for the scores) is later work.

#include "flash_int8.cuh"

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

struct Args {
  const void *qq, *kq, *qs, *ks, *v;
  void *o, *lse;
  int batch, heads, sq, sk, d;
  long long v_sb, v_ss, v_sn;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int DP>
cudaError_t launch(const Args& a) {
  auto kernel = flash_int8_fwd_kernel<T, DP>;
  const int smem = (kBQ + kBK) * (DP / 4 + 4) * 4 +
                   (kBK * (DP + 4) + kBQ * (kBK + 4) + kBK) * 4;
  cudaError_t err = jimm::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const int8_t*>(a.qq), static_cast<const int8_t*>(a.kq),
      static_cast<const float*>(a.qs), static_cast<const float*>(a.ks),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.heads, a.sq, a.sk, a.d, a.v_sb, a.v_ss,
      a.v_sn, a.scale, a.causal, words_aligned(a.qq, a.kq, a.d));
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
