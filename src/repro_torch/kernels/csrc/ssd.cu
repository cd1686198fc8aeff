// Mamba2 SSD chunk scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces src/repro/kernels/ssd.py:ssd_scan / _ssd_kernel (the Pallas TPU
// kernel behind ops.ssd), and serves the model's chunk scan
// (src/repro/models/mamba2.py:_ssd_chunked, the same function with a state
// in and out), which every mamba2 layer of zamba2's prefill runs once.
//
// What it computes, for every batch b and head h, over the tokens t in
// order, from the state h (P x N, f32) given in `state`:
//   h[p][n] = exp(da_t) * h[p][n] + x_t[p] * B_t[n]
//   y_t[p]  = sum_n C_t[n] * h[p][n]
// (x has dt folded in; da <= 0 is one log decay per head and token) and
// the final h is written back to `state` in place.  It is evaluated
// chunkwise, as the reference does: with cum = cumsum(da) down a chunk,
//   y  = exp(cum_t) * (C_t . h) + sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) x_s
//   h' = exp(cum_last) * h + sum_s x_s (x) (exp(cum_last - cum_s) * B_s)
// where cum_t - cum_s <= 0 for s <= t, so no exp can overflow.  B and C
// have no head axis (n_groups = 1): every head of a batch row reads the
// same rows by index, and x is read through its (B, S, H, P) strides.
// Tokens past S read as x = B = C = 0, da = 0 and are not written.  x, B
// and C are fp32 or bf16; da is fp32; arithmetic is fp32; y is written in
// x's type.
//
// What bounds it on an H100: operations.  At the zamba2-2.7b prefill wave
// (B*H = 8*80 = 640 heads, S = 1024, P = N = 64) a token costs 2 P N
// multiply-adds for C.h and the state update, C N / 2 for the visible
// C.B products and C P / 2 for their product with x: about 15 GFLOP of
// FFMA at C = 32 (0.22 ms at 67 TFLOP/s) against 0.36 GB of x, y, B, C
// and da (0.11 ms at 3.35 TB/s).  The kernel takes C = 32 whatever chunk
// the model's config names (zamba2's is 128; the result is the same
// function): the C x C tile then takes 4 KiB instead of the 64 KiB a
// 128-row tile would, and the intra-chunk work per token shrinks with C.
//
// Design (simple and right first): one CTA of 256 threads per (batch,
// head), looping over the chunks in order, the (P, N) f32 state held in
// shared memory (16 KiB at P = N = 64) and written to device memory once
// at the end.  Per chunk the x, B and C tiles are staged as f32 (row
// stride D + 1, conflict-free column walks), one thread takes the cumsum
// of the C decays, the masked C x C matrix (C_t . B_s) exp(cum_t - cum_s)
// is built one entry per thread iteration, then each thread owns one
// output column p for C D / 256 rows and one state column n for D^2 / 256
// rows.  P and N are padded inside the kernel to D = 16, 32 or 64 (zeros
// in shared memory).  A CTA takes 45 KiB of shared memory: four fit on an
// SM.  C.B is recomputed by every head of a batch row (80 times at
// zamba2's width); sharing it across the heads of a CTA, tensor cores and
// TMA are later work.
//
// This file must never be built with --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;

struct Params {
  const void* x;
  const void* Bm;
  const void* Cm;
  const float* da;
  void* y;         // contiguous (B, S, H, P), x's type
  float* state;    // contiguous (B, H, P, N), read and written in place
  int B, S, H, P, N;
  long long sx_b, sx_s, sx_h;
  long long sb_b, sb_s;
  long long sc_b, sc_s;
  long long sd_b, sd_s, sd_h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  // x, B, C tiles | masked decayed C.B | state | cum, exp(cum), weights
  return 3 * kChunk * (D + 1) + kChunk * (kChunk + 1) + D * (D + 1) +
         3 * kChunk;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const Params p) {
  constexpr int C = kChunk;
  constexpr int LD = D + 1;
  constexpr int LM = C + 1;
  constexpr int kStep = kThreads / D;
  constexpr int kYRows = C * D / kThreads;
  constexpr int kHRows = D * D / kThreads;
  static_assert(kThreads % D == 0 && kYRows >= 1 && kHRows >= 1, "D");

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // [C][LD] x
  float* bs = xs + C * LD;     // [C][LD] B
  float* cm = bs + C * LD;     // [C][LD] C
  float* M = cm + C * LD;      // [C][LM]
  float* hs = M + C * LM;      // [D][LD] state h[p][n]
  float* cum = hs + D * LD;    // [C] da, then its cumsum
  float* ecum = cum + C;       // [C] exp(cum_t)
  float* wdec = ecum + C;      // [C] exp(cum_last - cum_s)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int P = p.P, N = p.N;
  const T* xg = static_cast<const T*>(p.x) + b * p.sx_b + h * p.sx_h;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.sb_b;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.sc_b;
  const float* dg = p.da + b * p.sd_b + h * p.sd_h;
  float* hg = p.state + (static_cast<long long>(b) * p.H + h) * P * N;
  T* yg = static_cast<T*>(p.y) + (static_cast<long long>(b) * p.S * p.H + h) * P;
  const long long sy = static_cast<long long>(p.H) * P;

  for (int e = tid; e < D * D; e += kThreads) {
    const int pp = e / D, n = e % D;
    hs[pp * LD + n] = (pp < P && n < N) ? hg[pp * N + n] : 0.f;
  }

  const int col = tid % D;   // this thread's output column p / state column n
  const int r0 = tid / D;    // its first row

  for (int t0 = 0; t0 < p.S; t0 += C) {
    __syncthreads();  // the previous chunk's tile reads are done
    for (int e = tid; e < C * D; e += kThreads) {
      const int t = e / D, i = e % D, s = t0 + t;
      const bool in = s < p.S;
      xs[t * LD + i] = (in && i < P) ? to_float(xg[s * p.sx_s + i]) : 0.f;
      bs[t * LD + i] = (in && i < N) ? to_float(bg[s * p.sb_s + i]) : 0.f;
      cm[t * LD + i] = (in && i < N) ? to_float(cg[s * p.sc_s + i]) : 0.f;
    }
    for (int t = tid; t < C; t += kThreads)
      cum[t] = t0 + t < p.S ? dg[(t0 + t) * p.sd_s] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += cum[t];
        cum[t] = acc;
      }
    }
    __syncthreads();

    // M[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, 0 above
    for (int e = tid; e < C * C; e += kThreads) {
      const int t = e / C, s = e % C;
      float g = 0.f;
      if (s <= t) {
#pragma unroll 8
        for (int n = 0; n < D; ++n) g = fmaf(cm[t * LD + n], bs[s * LD + n], g);
        g *= expf(cum[t] - cum[s]);
      }
      M[t * LM + s] = g;
    }
    for (int t = tid; t < C; t += kThreads) {
      ecum[t] = expf(cum[t]);
      wdec[t] = expf(cum[C - 1] - cum[t]);
    }
    __syncthreads();

    // y[t][p] = exp(cum_t) sum_n C[t][n] h[p][n] + sum_s M[t][s] x[s][p]
    {
      float acc[kYRows];
#pragma unroll
      for (int m = 0; m < kYRows; ++m) acc[m] = 0.f;
#pragma unroll 4
      for (int n = 0; n < D; ++n) {
        const float hv = hs[col * LD + n];
#pragma unroll
        for (int m = 0; m < kYRows; ++m)
          acc[m] = fmaf(cm[(r0 + m * kStep) * LD + n], hv, acc[m]);
      }
#pragma unroll
      for (int m = 0; m < kYRows; ++m) acc[m] *= ecum[r0 + m * kStep];
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        const float xv = xs[s * LD + col];
#pragma unroll
        for (int m = 0; m < kYRows; ++m)
          acc[m] = fmaf(M[(r0 + m * kStep) * LM + s], xv, acc[m]);
      }
      if (col < P) {
#pragma unroll
        for (int m = 0; m < kYRows; ++m) {
          const int s = t0 + r0 + m * kStep;
          if (s < p.S) store(&yg[s * sy + col], acc[m]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // h[p][n] = exp(cum_last) h[p][n] + sum_s x[s][p] wdec[s] B[s][n]
    {
      float acc[kHRows];
#pragma unroll
      for (int m = 0; m < kHRows; ++m) acc[m] = 0.f;
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        const float wb = wdec[s] * bs[s * LD + col];
#pragma unroll
        for (int m = 0; m < kHRows; ++m)
          acc[m] = fmaf(xs[s * LD + r0 + m * kStep], wb, acc[m]);
      }
      const float dtot = expf(cum[C - 1]);
#pragma unroll
      for (int m = 0; m < kHRows; ++m) {
        const int pp = r0 + m * kStep;
        hs[pp * LD + col] = dtot * hs[pp * LD + col] + acc[m];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int pp = e / N, n = e % N;
    hg[e] = hs[pp * LD + n];
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<D>();
  // set on every launch: the attribute is per device, and it is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssd_kernel<T, D><<<p.B * p.H, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  const int d = p.P > p.N ? p.P : p.N;
  if (d <= 16) return launch<T, 16>(p, stream);
  if (d <= 32) return launch<T, 32>(p, stream);
  return launch<T, 64>(p, stream);
}

}  // namespace

extern "C" {

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16; da is float32.
// Strides are in elements, the last dim of x, Bm and Cm has stride 1, y is
// contiguous (B, S, H, P) and state contiguous (B, H, P, N).  Returns the
// CUDA error of the launch (0 on success).
int ssd_fwd(const void* x, const void* Bm, const void* Cm, const float* da,
            void* y, float* state, int dtype, int B, int S, int H, int P,
            int N, long long sx_b, long long sx_s, long long sx_h,
            long long sb_b, long long sb_s, long long sc_b, long long sc_s,
            long long sd_b, long long sd_s, long long sd_h, void* stream) {
  if (P < 1 || P > 64 || N < 1 || N > 64 || B < 1 || S < 1 || H < 1 ||
      static_cast<long long>(B) * H > 2147483647LL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x,    Bm,   Cm,   da,   y,    state, B,    S,
                 H,    P,    N,    sx_b, sx_s, sx_h,  sb_b, sb_s,
                 sc_b, sc_s, sd_b, sd_s, sd_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                                     : dispatch<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
