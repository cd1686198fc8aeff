// Flash attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// The JAX package has no backward kernel: off the TPU it trains through
// src/repro/kernels/ops.py:blocked_attention, which JAX differentiates.
// This is the gradient of the forward in flash_attention.cu (which
// replaces src/repro/kernels/flash_attention.py:_attn_kernel), for the
// training paths: the federated LM's client steps and the single-pod
// trainer (models/transformer.py -> kernels/flash_attention.py
// FlashAttention).
//
// What it computes.  With s = scale * q . k over the keys the forward's
// mask lets through (t < T, t <= s when causal, s - t < window when a
// window is set), p = exp(s - lse) from the forward's per-row
// log-sum-exp (p = 0 where the mask hides the key, and for a row that sees
// no key, whose lse is -inf), D = rowsum(dO o O) and dS = p (dO . v - D):
//   dV[t] = sum_s p dO[s]            dK[t] = scale sum_s dS q[s]
//   dQ[s] = scale sum_t dS k[t]
// with dK and dV summed over the G query heads of each KV head (GQA:
// query head h reads KV head h / G).  Every product accumulates in fp32 on
// fp32 or bf16 inputs; the gradients come out in the input type.
//
// What bounds it on an H100: operations.  The recompute backward needs 5
// products per visible (row, key) pair (S, dP, dV, dK, dQ: 2.5x the
// forward's 2); at the trainer's shape (B = 1, S = T = 4096, H = 28, KV =
// 4, hd = 128, causal) that is 301 GFLOP: 4.5 ms of FFMA at 67 TFLOP/s
// fp32, against 269 MB of fp32 q, k, v, o, dO, lse and gradients (0.08 ms
// at 3.35 TB/s).  This design recomputes S and dP twice (once for dK/dV,
// once for dQ): 7 products, 1.4x the bound's operations, and in exchange
// no atomics and no second pass over a dQ accumulator, so the result is
// deterministic.
//
// Design: three kernels on one stream, all on the CUDA cores (FFMA).
//  * flash_bwd_delta_kernel: D = rowsum(dO o O), one warp per row.
//  * flash_bwd_dkdv_kernel: one CTA of 256 threads per (batch, KV head,
//    64-key tile).  K and V stay in shared memory; the CTA loops over the
//    G query heads and over the 64-row query tiles that can see its keys,
//    recomputes the tile's P from Q, K and lse, forms dS, and adds P^T dO
//    and dS^T Q into dV and dK, which each thread holds in registers (a
//    4-key x hd/16-column tile of each).
//  * flash_bwd_dq_kernel: one CTA per (batch, head, 64-row query tile),
//    looping over the visible key tiles like the forward; dQ lives in
//    registers.
// Each thread owns a 4 x 4 tile of the 64 x 64 logits: Q and dO rows are
// read from shared memory as float4 along the head dim (a broadcast over
// the 16 threads of a row group), K and V rows through a stride of hd + 4
// floats, so a quarter-warp's eight rows hit distinct banks.  bf16 inputs
// are widened to fp32 as they are staged in shared memory.  The head dim
// is padded to 16, 32, 64, 96 or 128 by zero fill.  Tensor cores for the
// backward are later work.
//
// This file must never be built with --use_fast_math (expf stays exact to
// an ulp or two).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx the columns
constexpr int kR = 4;          // rows per thread
constexpr int kC = 4;          // logit columns per thread: tx + 16 j

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // contiguous (B, S, H, hd)
  const void* dout;
  const float* lse;  // (B, H, S)
  float* delta;      // (B, H, S)
  void* dq;          // contiguous (B, S, H, hd)
  void* dk;          // contiguous (B, T, KV, hd)
  void* dv;
  int B, S, T, H, KV, hd;
  long long sq_b, sq_s, sq_h;
  long long sk_b, sk_t, sk_h;
  long long sv_b, sv_t, sv_h;
  long long sd_b, sd_s, sd_h;  // dO
  int causal;
  int window;  // <= 0: no window
  float scale;
  int vec;     // every pointer, stride and hd allow 4-element loads
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.T && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Rows [r0, r0 + ROWS) of a (rows, hd) slab with row stride rs into shared
// memory as fp32 (row stride ss, D columns); rows >= n and columns >= hd
// are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ss, const T* src,
                                          long long rs, int r0, int n, int hd,
                                          bool vec) {
  if (vec) {
    constexpr int kQuads = D / 4;
    for (int i = threadIdx.x; i < ROWS * kQuads; i += kThreads) {
      const int r = i / kQuads, c = (i % kQuads) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < n && c < hd) x = load4(src + (r0 + r) * rs + c);
      *reinterpret_cast<float4*>(dst + r * ss + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
      const int r = i / D, c = i % D;
      dst[r * ss + c] =
          r0 + r < n && c < hd ? to_f(src[(r0 + r) * rs + c]) : 0.f;
    }
  }
}

// lse and D of rows [r0, r0 + kBQ) of one (batch, head); rows past S get
// lse = -inf, so their p is 0.
__device__ __forceinline__ void load_rowstats(float* lse_s, float* delta_s,
                                              const Params& p, int bh,
                                              int r0) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const bool ok = r0 + i < p.S;
    const long long idx = static_cast<long long>(bh) * p.S + r0 + i;
    lse_s[i] = ok ? p.lse[idx] : -INFINITY;
    delta_s[i] = ok ? p.delta[idx] : 0.f;
  }
}

template <int D>
struct Layout {
  static constexpr int kKS = D + 4;  // K and V row stride (bank offsets)
  static constexpr int kQ = kBQ * D;
  static constexpr int kK = kBK * kKS;
  static constexpr int kP = kBQ * kBK;
  // Q, dO, K, V, P, dS, lse, D: 163 KiB at D = 128
  static constexpr int kFloats = 2 * kQ + 2 * kK + 2 * kP + 2 * kBQ;
  // output columns per thread: float4 groups tx*4 + 64 g when D is a
  // multiple of 64, else single columns tx + 16 c
  static constexpr bool kVec4 = D % 64 == 0;
  static constexpr int kOC = D / 16;
};

template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  return Layout<D>::kVec4 ? 64 * (c / 4) + tx * 4 + (c % 4) : tx + 16 * c;
}

// The kOC columns of row r of a (rows, D) shared tile with row stride ss
// that this thread owns.
template <int D>
__device__ __forceinline__ void read_cols(float (&out)[Layout<D>::kOC],
                                          const float* row, int tx) {
  if (Layout<D>::kVec4) {
#pragma unroll
    for (int g = 0; g < Layout<D>::kOC / 4; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(&row[64 * g + tx * 4]);
      out[4 * g] = x.x;
      out[4 * g + 1] = x.y;
      out[4 * g + 2] = x.z;
      out[4 * g + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < Layout<D>::kOC; ++c) out[c] = row[tx + 16 * c];
  }
}

// acc[i][j] = A[rA + i] . B[tx + 16 j] over D: A (kBQ x D, stride D) rows
// of this thread's row group, B (kBK x D, stride D + 4).
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[kR][kC], const float* A,
                                         const float* Bt, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 b[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j)
      b[j] = *reinterpret_cast<const float4*>(
          &Bt[(tx + 16 * j) * Layout<D>::kKS + d]);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(&A[(ty * kR + i) * D + d]);
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }
}

// P and dS of one (query tile, key tile) pair into shared memory (kBQ x
// kBK each): s and dp are this thread's logits and dO . v products.
__device__ __forceinline__ void p_and_ds(const Params& p, float (&s)[kR][kC],
                                         const float (&dp)[kR][kC],
                                         const float* lse_s,
                                         const float* delta_s, float* Ps,
                                         float* dSs, int q0, int k0, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i;
    const float l = lse_s[r];
    const bool live = l != -INFINITY;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int c = tx + 16 * j;
      const float pr = live && visible(p, q0 + r, k0 + c)
                           ? expf(s[i][j] * p.scale - l)
                           : 0.f;
      Ps[r * kBK + c] = pr;
      dSs[r * kBK + c] = pr * (dp[i][j] - delta_s[r]);
    }
  }
}

// D = rowsum(dO o O): one warp per (batch, row, head).
template <typename T>
__global__ void flash_bwd_delta_kernel(const Params p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.B) * p.S * p.H) return;
  const int h = static_cast<int>(row % p.H);
  const int s = static_cast<int>((row / p.H) % p.S);
  const int b = static_cast<int>(row / (static_cast<long long>(p.H) * p.S));
  const T* o = static_cast<const T*>(p.o) + row * p.hd;
  const T* g = static_cast<const T*>(p.dout) + b * p.sd_b + s * p.sd_s +
               h * p.sd_h;
  float acc = 0.f;
  for (int d = lane; d < p.hd; d += 32) acc = fmaf(to_f(o[d]), to_f(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0)
    p.delta[(static_cast<long long>(b) * p.H + h) * p.S + s] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + L::kQ;
  float* Ks = dOs + L::kQ;
  float* Vs = Ks + L::kK;
  float* Ps = Vs + L::kK;
  float* dSs = Ps + L::kP;
  float* lse_s = dSs + L::kP;
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x % p.KV;
  const int G = p.H / p.KV;
  const int k0 = blockIdx.y * kBK;  // causal: the heaviest tiles first
  const bool vec = p.vec != 0;

  const T* kg = static_cast<const T*>(p.k) + b * p.sk_b + kvh * p.sk_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv_b + kvh * p.sv_h;
  load_tile<T, D, kBK>(Ks, L::kKS, kg, p.sk_t, k0, p.T, p.hd, vec);
  load_tile<T, D, kBK>(Vs, L::kKS, vg, p.sv_t, k0, p.T, p.hd, vec);

  // the query tiles that can see a key of [k0, min(k0 + kBK, T))
  const int kmax = min(k0 + kBK, p.T) - 1;
  const int qlo = p.causal ? k0 : 0;
  const int qhi = p.window > 0 ? min(p.S, kmax + p.window) : p.S;
  const int qt_lo = qlo / kBQ;
  const int qt_hi = qhi > qlo ? (qhi + kBQ - 1) / kBQ : qt_lo;

  float dk[kR][L::kOC], dv[kR][L::kOC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qg = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
    const T* dg = static_cast<const T*>(p.dout) + b * p.sd_b + h * p.sd_h;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // every read of the previous tile is done
      load_tile<T, D, kBQ>(Qs, D, qg, p.sq_s, q0, p.S, p.hd, vec);
      load_tile<T, D, kBQ>(dOs, D, dg, p.sd_s, q0, p.S, p.hd, vec);
      load_rowstats(lse_s, delta_s, p, b * p.H + h, q0);
      __syncthreads();

      float s[kR][kC], dp[kR][kC];
      tile_dot<D>(s, Qs, Ks, ty, tx);
      tile_dot<D>(dp, dOs, Vs, ty, tx);
      p_and_ds(p, s, dp, lse_s, delta_s, Ps, dSs, q0, k0, ty, tx);
      __syncthreads();

      // dV[key] += sum_r P[r][key] dO[r]; dK[key] += sum_r dS[r][key] Q[r]
      // (this thread's keys ty * 4 + i)
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(&Ps[r * kBK + ty * kR]);
        const float4 ds =
            *reinterpret_cast<const float4*>(&dSs[r * kBK + ty * kR]);
        float go[L::kOC], qo[L::kOC];
        read_cols<D>(go, dOs + r * D, tx);
        read_cols<D>(qo, Qs + r * D, tx);
        const float pv[kR] = {pr.x, pr.y, pr.z, pr.w};
        const float dsv[kR] = {ds.x, ds.y, ds.z, ds.w};
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int c = 0; c < L::kOC; ++c) {
            dv[i][c] = fmaf(pv[i], go[c], dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qo[c], dk[i][c]);
          }
      }
    }
  }

  // dk/dv are contiguous (B, T, KV, hd)
  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int t = k0 + ty * kR + i;
    if (t >= p.T) continue;
    const long long base =
        ((static_cast<long long>(b) * p.T + t) * p.KV + kvh) * p.hd;
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) {
      const int d = out_col<D>(tx, c);
      if (d < p.hd) {
        dkg[base + d] = from_f<T>(dk[i][c] * p.scale);
        dvg[base + d] = from_f<T>(dv[i][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + L::kQ;
  float* Ks = dOs + L::kQ;
  float* Vs = Ks + L::kK;
  float* dSs = Vs + L::kK;
  float* Ps = dSs + L::kP;
  float* lse_s = Ps + L::kP;
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const bool vec = p.vec != 0;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* dg = static_cast<const T*>(p.dout) + b * p.sd_b + h * p.sd_h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk_b + kvh * p.sk_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv_b + kvh * p.sv_h;
  load_tile<T, D, kBQ>(Qs, D, qg, p.sq_s, q0, p.S, p.hd, vec);
  load_tile<T, D, kBQ>(dOs, D, dg, p.sd_s, q0, p.S, p.hd, vec);
  load_rowstats(lse_s, delta_s, p, b * p.H + h, q0);

  // the key tiles rows [q0, q0 + kBQ) can see
  const int khi = p.causal ? min(q0 + kBQ, p.T) : p.T;
  const int klo = p.window > 0 ? max(q0 + 1 - p.window, 0) : 0;
  const int kt_lo = klo / kBK;
  const int kt_hi = (khi + kBK - 1) / kBK;

  float dq[kR][L::kOC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) dq[i][c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every read of the previous tile is done
    load_tile<T, D, kBK>(Ks, L::kKS, kg, p.sk_t, k0, p.T, p.hd, vec);
    load_tile<T, D, kBK>(Vs, L::kKS, vg, p.sv_t, k0, p.T, p.hd, vec);
    __syncthreads();

    float s[kR][kC], dp[kR][kC];
    tile_dot<D>(s, Qs, Ks, ty, tx);
    tile_dot<D>(dp, dOs, Vs, ty, tx);
    p_and_ds(p, s, dp, lse_s, delta_s, Ps, dSs, q0, k0, ty, tx);
    __syncthreads();

    // dQ[r] += sum_key dS[r][key] K[key] (this thread's rows ty * 4 + i)
#pragma unroll 2
    for (int t = 0; t < kBK; t += 4) {
      float4 ds[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        ds[i] = *reinterpret_cast<const float4*>(&dSs[(ty * kR + i) * kBK + t]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kc[L::kOC];
        read_cols<D>(kc, Ks + (t + u) * L::kKS, tx);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float w = u == 0 ? ds[i].x : u == 1 ? ds[i].y
                        : u == 2 ? ds[i].z : ds[i].w;
#pragma unroll
          for (int c = 0; c < L::kOC; ++c) dq[i][c] = fmaf(w, kc[c], dq[i][c]);
        }
      }
    }
  }

  // dq is contiguous (B, S, H, hd)
  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int s = q0 + ty * kR + i;
    if (s >= p.S) continue;
    const long long base =
        ((static_cast<long long>(b) * p.S + s) * p.H + h) * p.hd;
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) {
      const int d = out_col<D>(tx, c);
      if (d < p.hd) dqg[base + d] = from_f<T>(dq[i][c] * p.scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * Layout<D>::kFloats;
  // set on every launch: the attribute is per device, and it is cheap
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(p.B) * p.S * p.H;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3(p.B * p.KV, (p.T + kBK - 1) / kBK),
                                kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3(p.B * p.H, (p.S + kBQ - 1) / kBQ),
                              kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.hd <= 16) return launch<T, 16>(p, stream);
  if (p.hd <= 32) return launch<T, 32>(p, stream);
  if (p.hd <= 64) return launch<T, 64>(p, stream);
  if (p.hd <= 96) return launch<T, 96>(p, stream);
  return launch<T, 128>(p, stream);
}

template <typename T, int D>
cudaError_t occupancy(int which, int* ctas) {
  constexpr size_t bytes = sizeof(float) * Layout<D>::kFloats;
  const void* fn = which == 0
                       ? reinterpret_cast<const void*>(flash_bwd_dkdv_kernel<T, D>)
                       : reinterpret_cast<const void*>(flash_bwd_dq_kernel<T, D>);
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads,
                                                       bytes);
}

template <typename T>
cudaError_t occupancy_hd(int hd, int which, int* ctas) {
  if (hd <= 16) return occupancy<T, 16>(which, ctas);
  if (hd <= 32) return occupancy<T, 32>(which, ctas);
  if (hd <= 64) return occupancy<T, 64>(which, ctas);
  if (hd <= 96) return occupancy<T, 96>(which, ctas);
  return occupancy<T, 128>(which, ctas);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype (of q, k, v, o, dout, dq, dk, dv): 0 = float32, 1 = bfloat16; lse
// and delta are float32 (B, H, S), delta a scratch this call fills.
// Strides are in elements and the last dim of q, k, v and dout has stride
// 1; o and dq are contiguous (B, S, H, hd), dk and dv contiguous (B, T,
// KV, hd).  Launches three kernels on `stream`; returns the CUDA error of
// the first launch that fails (0 on success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int dtype,
                        int B, int S, int T, int H, int KV, int hd,
                        long long sq_b, long long sq_s, long long sq_h,
                        long long sk_b, long long sk_t, long long sk_h,
                        long long sv_b, long long sv_t, long long sv_h,
                        long long sd_b, long long sd_s, long long sd_h,
                        int causal, int window, float scale, void* stream) {
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0 || B < 1 || S < 1 ||
      T < 1 || static_cast<long long>(B) * H > 2147483647LL ||
      (S + kBQ - 1) / kBQ > 65535 || (T + kBK - 1) / kBK > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout) && hd % 4 == 0 && sq_b % 4 == 0 &&
                   sq_s % 4 == 0 && sq_h % 4 == 0 && sk_b % 4 == 0 &&
                   sk_t % 4 == 0 && sk_h % 4 == 0 && sv_b % 4 == 0 &&
                   sv_t % 4 == 0 && sv_h % 4 == 0 && sd_b % 4 == 0 &&
                   sd_s % 4 == 0 && sd_h % 4 == 0;
  const Params p{q,    k,    v,    o,    dout, lse,    delta,  dq,   dk,
                 dv,   B,    S,    T,    H,    KV,     hd,     sq_b, sq_s,
                 sq_h, sk_b, sk_t, sk_h, sv_b, sv_t,   sv_h,   sd_b, sd_s,
                 sd_h, causal, window, scale, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                                     : dispatch<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}

// CTAs of the dK/dV (which = 0) or dQ (which = 1) kernel for `dtype` and
// head dim `hd` that fit on one SM, or minus the CUDA error; launches
// nothing.
int flash_attention_bwd_ctas_per_sm(int dtype, int hd, int which) {
  int ctas = 0;
  const cudaError_t err = dtype == 0
                              ? occupancy_hd<float>(hd, which, &ctas)
                              : occupancy_hd<__nv_bfloat16>(hd, which, &ctas);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
