// Row LayerNorm backward for Hopper (sm_90a).
//
// Replaces the TPU kernel jimm_tpu/ops/layer_norm.py::_bwd_kernel (launched
// by _ln_bwd through pl.pallas_call). Same numerics: from the forward's f32
// mean and rstd, x_hat = (x - mean) * rstd and dy = do * scale, then
//   dx = rstd * (dy - sum(dy) / F - x_hat * sum(dy * x_hat) / F)
// stored in the dtype of x, plus the per-feature sums dscale = sum(do * x_hat)
// and dbias = sum(do) over the rows, in f32.
//
// The TPU kernel accumulates dscale/dbias in one output block that every
// sequential grid step revisits. CUDA blocks run in parallel and in no
// order, so here each CTA walks a strided set of rows, keeps its own f32
// dscale/dbias partials, and writes one partial row of each to
// dg_part/db_part[blockIdx.x]; a second kernel sums the partial rows over
// CTAs in a fixed order and stores dscale/dbias in the dtype of x (the JAX
// package sums its dg_part in XLA). No float atomics: the result does not
// depend on the order the CTAs run in.
//
// What bounds it on the H100: bytes. It reads x and do once and writes dx
// once (2 bytes an element each in bf16) and does ~12 flops an element; at
// the training shape (32768 rows x 768, bf16) the floor is ~151 MB over
// 3.35 TB/s, ~0.045 ms. Two bodies, chosen in the C entry by shape
// (ops/layer_norm.py::backward_body mirrors the choice):
// - the register body (the forward's shapes: F a multiple of the vector
//   width up to kRegisterMaxF = 2048, every base on a 16-byte boundary):
//   one warp a row, kWarps warps a CTA, a grid of the CTAs the card holds
//   at once, each warp walking rows in a grid-stride loop. Lane l holds
//   16-byte vectors l, l + 32, ... of the row (the last one guarded), so x
//   and do are read once into registers and dx stored once: no second pass
//   over device memory. The row sums are warp shuffles with no barrier. A
//   lane owns the same columns in every row it visits, so it keeps its
//   dscale/dbias partials across its rows, in a per-warp row of shared
//   memory only it touches (kept in registers instead, they double the
//   registers a lane needs, and ran 8-12% slower at 8192 rows); at the end
//   the CTA adds its warps' partials in warp order;
// - the CTA body (the rest: wider rows, an F off the vector width, bases
//   off a 16-byte boundary): one CTA a row reduced across the CTA with two
//   barriers, a strided set of rows a CTA, partial rows in shared memory
//   (each thread owns a fixed set of columns), the second pass over a row
//   served from L1/L2.

#include "layer_norm.cuh"

namespace {

using jimm::Vec;
using jimm::warp_sum;

constexpr int kWarps = 8;  // the register body's rows in flight a CTA
// the CTA body's grid: CTAs a SM (on the H100 at (32768, 768) bf16, 8 beat
// 4, 16 and 32)
constexpr int kCtaBodyCtasPerSm = 8;

// The register body: warp w of CTA c takes rows c * kWarps + w, then every
// gridDim.x * kWarps rows further; lane l holds vectors l, l + 32, ... of
// the row (kVecs of them, the last guarded). Each warp keeps its dscale and
// dbias partials in its own two rows of float4 slots in shared memory, slot
// (i * kQ + q) * 32 + lane holding columns (lane + 32 i) kE + 4 q .. + 3,
// so that the 32 lanes of a warp touch 32 consecutive slots and a lane
// only its own.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_bwd_register_kernel(const T* __restrict__ x,
                                   const T* __restrict__ g,
                                   const float* __restrict__ mu,
                                   const float* __restrict__ rstd,
                                   const T* __restrict__ dout,
                                   T* __restrict__ dx,
                                   float* __restrict__ dg_part,
                                   float* __restrict__ db_part,
                                   long long rows, int f) {
  constexpr int kE = Vec<T>::kN;
  constexpr int kQ = kE / 4;                // float4 slots a vector
  constexpr int kSlots = kVecs * kQ * 32;   // slots of one partial row
  extern __shared__ float4 part[];  // kWarps x (dscale, dbias) slot rows
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nv = f / kE;
  float4* mine = part + warp * 2 * kSlots;
  uint4 gv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (lane + 32 * i < nv)
      gv[i] = reinterpret_cast<const uint4*>(g)[lane + 32 * i];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      mine[(i * kQ + q) * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
      mine[kSlots + (i * kQ + q) * 32 + lane] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = blockIdx.x * static_cast<long long>(kWarps) + warp;
       r < rows; r += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * f);
    const uint4* dr = reinterpret_cast<const uint4*>(dout + r * f);
    uint4 xv[kVecs], dv[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < nv) {
        xv[i] = xr[lane + 32 * i];
        dv[i] = dr[lane + 32 * i];
      }
    }
    const float m = mu[r], rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < nv) {
        float xf[kE], df[kE], gf[kE];
        Vec<T>::unpack(xv[i], xf);
        Vec<T>::unpack(dv[i], df);
        Vec<T>::unpack(gv[i], gf);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float xh = (xf[e] - m) * rs;
          const float dy = df[e] * gf[e];
          s1 += dy;
          s2 += dy * xh;
          xf[e] = df[e] * xh;  // this row's dscale term
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          float4* a = mine + (i * kQ + q) * 32 + lane;
          float4* b = a + kSlots;
          float4 ta = *a, tb = *b;
          ta.x += xf[4 * q];
          ta.y += xf[4 * q + 1];
          ta.z += xf[4 * q + 2];
          ta.w += xf[4 * q + 3];
          tb.x += df[4 * q];
          tb.y += df[4 * q + 1];
          tb.z += df[4 * q + 2];
          tb.w += df[4 * q + 3];
          *a = ta;
          *b = tb;
        }
      }
    }
    const float m1 = warp_sum(s1) / f, m2 = warp_sum(s2) / f;
    uint4* dxr = reinterpret_cast<uint4*>(dx + r * f);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < nv) {
        float xf[kE], df[kE], gf[kE];
        Vec<T>::unpack(xv[i], xf);
        Vec<T>::unpack(dv[i], df);
        Vec<T>::unpack(gv[i], gf);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float xh = (xf[e] - m) * rs;
          xf[e] = rs * (df[e] * gf[e] - m1 - xh * m2);
        }
        dxr[lane + 32 * i] = Vec<T>::pack(xf);
      }
    }
  }
  // the CTA's partial rows: its warps' partials added in warp order
  __syncthreads();
  float4* dgp = reinterpret_cast<float4*>(
      dg_part + static_cast<long long>(blockIdx.x) * f);
  float4* dbp = reinterpret_cast<float4*>(
      db_part + static_cast<long long>(blockIdx.x) * f);
  for (int s = threadIdx.x; s < kSlots; s += kWarps * 32) {
    const int v = s % 32 + 32 * (s / 32 / kQ);
    if (v >= nv) continue;
    float4 a = part[s], b = part[kSlots + s];
    for (int w = 1; w < kWarps; ++w) {
      const float4 ta = part[w * 2 * kSlots + s];
      const float4 tb = part[w * 2 * kSlots + kSlots + s];
      a.x += ta.x;
      a.y += ta.y;
      a.z += ta.z;
      a.w += ta.w;
      b.x += tb.x;
      b.y += tb.y;
      b.z += tb.z;
      b.w += tb.w;
    }
    const int slot = v * kQ + s / 32 % kQ;  // column / 4
    dgp[slot] = a;
    dbp[slot] = b;
  }
}

// dscale and dbias from the partial rows (ctas, f) of each in `part`: CTA
// c sums columns [32 c, 32 c + 32) of the (2 f)-column row (dscale, dbias),
// warp w the partial rows w, w + kSumWarps, ..., in order, then warp 0 the
// warps' sums in warp order
constexpr int kSumWarps = 16;
template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32)
    layer_norm_bwd_partial_sum_kernel(const float* __restrict__ part,
                                      int ctas, int f, T* __restrict__ dg,
                                      T* __restrict__ db) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;  // column of (dscale, dbias)
  const bool live = j < 2 * f;
  const float* col =
      part + (live ? static_cast<long long>(j / f) * ctas * f + j % f : 0);
  float s = 0.f;
  if (live) {
#pragma unroll 8
    for (int k = warp; k < ctas; k += kSumWarps)
      s += col[static_cast<long long>(k) * f];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && live) {
    for (int w = 1; w < kSumWarps; ++w) s += red[w][lane];
    (j < f ? dg : db)[j % f] = jimm::from_f32<T>(s);
  }
}

// shared memory of the register body at kVecs vectors a lane
template <typename T, int kVecs>
constexpr int register_smem() {
  return kWarps * 2 * kVecs * (Vec<T>::kN / 4) * 32 *
         static_cast<int>(sizeof(float4));
}

// (sum of v.x, sum of v.y) over the block, the same in every thread. `red`
// holds one partial per warp; the leading barrier lets the next row reuse it.
template <int THREADS>
__device__ __forceinline__ float2 block_sum2(float2 v, float2* red) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    t.x += red[w].x;
    t.y += red[w].y;
  }
  return t;
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS) layer_norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ mu, const float* __restrict__ rstd,
    const T* __restrict__ dout, T* __restrict__ dx,
    float* __restrict__ dg_part, float* __restrict__ db_part, long long rows,
    int f) {
  extern __shared__ float acc[];  // 2f floats: this CTA's dscale, dbias
  __shared__ float2 red[THREADS / 32];
  float* dg_acc = acc;
  float* db_acc = acc + f;
  for (int i = threadIdx.x; i < f; i += THREADS) {
    dg_acc[i] = 0.f;
    db_acc[i] = 0.f;
  }
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * f;
    const T* dr = dout + r * f;
    const float m = mu[r], rs = rstd[r];
    float2 s = make_float2(0.f, 0.f);
    for (int i = threadIdx.x; i < f; i += THREADS) {
      const float xh = (jimm::to_f32(xr[i]) - m) * rs;
      const float d = jimm::to_f32(dr[i]);
      const float dy = d * jimm::to_f32(g[i]);
      s.x += dy;
      s.y += dy * xh;
      dg_acc[i] += d * xh;
      db_acc[i] += d;
    }
    s = block_sum2<THREADS>(s, red);
    const float m1 = s.x / f, m2 = s.y / f;
    T* dxr = dx + r * f;
    for (int i = threadIdx.x; i < f; i += THREADS) {
      const float xh = (jimm::to_f32(xr[i]) - m) * rs;
      const float dy = jimm::to_f32(dr[i]) * jimm::to_f32(g[i]);
      dxr[i] = jimm::from_f32<T>(rs * (dy - m1 - xh * m2));
    }
  }
  // each thread stores only the columns it accumulated: no barrier needed
  float* dgp = dg_part + static_cast<long long>(blockIdx.x) * f;
  float* dbp = db_part + static_cast<long long>(blockIdx.x) * f;
  for (int i = threadIdx.x; i < f; i += THREADS) {
    dgp[i] = dg_acc[i];
    dbp[i] = db_acc[i];
  }
}

template <typename T, int THREADS>
cudaError_t launch_cta(const void* x, const void* g, const void* mu,
                       const void* rstd, const void* dout, void* dx,
                       void* dg_part, void* db_part, long long rows, int f,
                       int ctas, cudaStream_t stream) {
  auto kernel = layer_norm_bwd_kernel<T, THREADS>;
  const int smem = 2 * f * static_cast<int>(sizeof(float));
  cudaError_t err = jimm::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const T*>(dout), static_cast<T*>(dx),
      static_cast<float*>(dg_part), static_cast<float*>(db_part), rows, f);
  return cudaGetLastError();
}

template <typename T>
constexpr int max_vecs() {
  return jimm::kRegisterMaxF / Vec<T>::kN / 32;
}

// whether the register body takes rows of f elements at these bases
template <typename T>
bool takes_register(const void* x, const void* g, const void* dout, int f) {
  return f % Vec<T>::kN == 0 && f <= jimm::kRegisterMaxF &&
         jimm::aligned16(x) && jimm::aligned16(g) && jimm::aligned16(dout);
}

// The CTAs to give the register body with the fewest vectors a lane that
// hold `vecs`: those the card holds at once, at most one for every kWarps
// rows.
template <typename T, int kVecs = max_vecs<T>()>
cudaError_t register_ctas(int vecs, long long rows, int* ctas) {
  if constexpr (kVecs > 1) {
    if (vecs <= kVecs - 1) return register_ctas<T, kVecs - 1>(vecs, rows, ctas);
  }
  auto kernel = layer_norm_bwd_register_kernel<T, kVecs>;
  constexpr int smem = register_smem<T, kVecs>();
  cudaError_t err = jimm::allow_smem(kernel, smem);
  int resident = 0;
  if (err == cudaSuccess)
    err = jimm::resident_ctas(kernel, kWarps * 32, smem, &resident);
  const long long needed = (rows + kWarps - 1) / kWarps;
  *ctas = static_cast<int>(needed < resident ? needed : resident);
  return err;
}

// The register body with the fewest vectors a lane that hold `vecs`.
template <typename T, int kVecs = max_vecs<T>()>
cudaError_t launch_register(int vecs, const void* x, const void* g,
                            const void* mu, const void* rstd,
                            const void* dout, void* dx, void* dg_part,
                            void* db_part, long long rows, int f, int ctas,
                            cudaStream_t stream) {
  if constexpr (kVecs > 1) {
    if (vecs <= kVecs - 1)
      return launch_register<T, kVecs - 1>(vecs, x, g, mu, rstd, dout, dx,
                                           dg_part, db_part, rows, f, ctas,
                                           stream);
  }
  auto kernel = layer_norm_bwd_register_kernel<T, kVecs>;
  constexpr int smem = register_smem<T, kVecs>();
  const cudaError_t err = jimm::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const T*>(dout), static_cast<T*>(dx),
      static_cast<float*>(dg_part), static_cast<float*>(db_part), rows, f);
  return cudaGetLastError();
}

// The number of CTAs, and so of partial rows, to give the body the C entry
// runs for these operands: register_ctas for the register body; for the
// CTA body kCtaBodyCtasPerSm a SM, at most one a row.
template <typename T>
cudaError_t grid(const void* x, const void* g, const void* dout,
                 long long rows, int f, int* ctas) {
  if (takes_register<T>(x, g, dout, f))
    return register_ctas<T>((f / Vec<T>::kN + 31) / 32, rows, ctas);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long most = static_cast<long long>(kCtaBodyCtasPerSm) * sms;
  *ctas = static_cast<int>(rows < most ? rows : most);
  return err;
}

template <typename T>
cudaError_t body(const void* x, const void* g, const void* mu,
                 const void* rstd, const void* dout, void* dx, void* dg_part,
                 void* db_part, long long rows, int f, int ctas,
                 cudaStream_t stream) {
  if (takes_register<T>(x, g, dout, f) && jimm::aligned16(dx) &&
      jimm::aligned16(dg_part) && jimm::aligned16(db_part))
    return launch_register<T>((f / Vec<T>::kN + 31) / 32, x, g, mu, rstd,
                              dout, dx, dg_part, db_part, rows, f, ctas,
                              stream);
  if (f <= 1024)
    return launch_cta<T, 128>(x, g, mu, rstd, dout, dx, dg_part, db_part,
                              rows, f, ctas, stream);
  return launch_cta<T, 256>(x, g, mu, rstd, dout, dx, dg_part, db_part, rows,
                            f, ctas, stream);
}

// the body the shape takes, then the ordered sum of its partial rows
template <typename T>
cudaError_t dispatch(const void* x, const void* g, const void* mu,
                     const void* rstd, const void* dout, void* dx, void* part,
                     void* dg, void* db, long long rows, int f, int ctas,
                     cudaStream_t stream) {
  float* dg_part = static_cast<float*>(part);
  float* db_part = dg_part + static_cast<long long>(ctas) * f;
  const cudaError_t err = body<T>(x, g, mu, rstd, dout, dx, dg_part, db_part,
                                  rows, f, ctas, stream);
  if (err != cudaSuccess) return err;
  layer_norm_bwd_partial_sum_kernel<T>
      <<<(2 * f + 31) / 32, kSumWarps * 32, 0, stream>>>(
          dg_part, ctas, f, static_cast<T*>(dg), static_cast<T*>(db));
  return cudaGetLastError();
}

bool valid(long long rows, int f) {
  // the CTA body keeps two f32 partial rows in shared memory: 227 KB caps
  // f at 28,672
  return rows >= 1 && rows <= 0x7fffffffLL && f >= 1 && f <= 28672;
}

}  // namespace

// The CTAs to give jimm_layer_norm_bwd for these operands (*ctas), which
// is the number of partial rows it writes (dx and the partial rows taken to
// be 16-byte aligned, as fresh allocations are). Returns a cudaError_t
// (0 = answered).
extern "C" int jimm_layer_norm_bwd_grid(const void* x, const void* g,
                                        const void* dout, long long rows,
                                        int f, int dtype, int* ctas) {
  if (!valid(rows, f)) return cudaErrorInvalidValue;
  switch (dtype) {
    case jimm::kF32:
      return grid<float>(x, g, dout, rows, f, ctas);
    case jimm::kBF16:
      return grid<__nv_bfloat16>(x, g, dout, rows, f, ctas);
    default:
      return cudaErrorInvalidValue;
  }
}

// x, dout, dx: (rows, f) contiguous in `dtype`; g, dg, db: (f,) in `dtype`;
// mu, rstd: (rows,) f32; part: (2, ctas, f) f32 workspace, the partial rows
// of dscale then of dbias, one a CTA. Launches the body the shape takes and
// the ordered sum of its partial rows into dg and db on `stream`. Returns
// the first failing launch's cudaError_t (0 = launched).
extern "C" int jimm_layer_norm_bwd(const void* x, const void* g, const void* mu,
                                   const void* rstd, const void* dout, void* dx,
                                   void* part, void* dg, void* db,
                                   long long rows, int f, int ctas, int dtype,
                                   void* stream) {
  if (!valid(rows, f) || ctas < 1 || ctas > rows) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case jimm::kF32:
      return dispatch<float>(x, g, mu, rstd, dout, dx, part, dg, db, rows, f,
                             ctas, s);
    case jimm::kBF16:
      return dispatch<__nv_bfloat16>(x, g, mu, rstd, dout, dx, part, dg, db,
                                     rows, f, ctas, s);
    default:
      return cudaErrorInvalidValue;
  }
}
