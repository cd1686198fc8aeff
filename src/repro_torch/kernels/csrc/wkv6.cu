// WKV6 chunk scan (RWKV-6 time mix) for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces src/repro/kernels/rwkv6_scan.py:wkv6 / _wkv_kernel (the Pallas
// TPU kernel behind ops.wkv6), and serves the model's chunk scan
// (src/repro/models/rwkv6.py:_wkv_chunked, the same function with a state
// in and out), which rwkv6's prefill runs once per layer.
//
// What it computes, for every batch b and head h, over the tokens t in
// order, from the state S (N x N, f32) given in `state`:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] = exp(logw_t[i]) * S[i][j] + k_t[i] * v_t[j]
// and the final S is written back to `state` in place.  It is evaluated
// chunkwise, as the reference does: within a chunk of C tokens, with
// cum = inclusive cumsum of logw down the chunk and cum_prev = cum - logw,
//   y   = (r * exp(cum_prev)) @ S                          (cross-chunk)
//       + A @ v,  A[t][s] = sum_i r_t[i] k_s[i] exp(cum_prev_t[i] - cum_s[i])
//                 for s < t, A[t][t] = sum_i r_t[i] k_t[i] u[i], 0 above
//   S'  = exp(cum_C) * S + (k * exp(cum_C - cum))^T @ v
// The intra-chunk decay is exponentiated pairwise: cum_prev_t - cum_s <= 0
// for s < t, while the factored exp(cum_prev_t) * exp(-cum_s) overflows
// for strong decays (logw = -8 over 64 tokens is exp(512)).  Tokens past S
// read as r = k = v = 0, logw = 0 (no effect on the state) and are not
// written.  r, k, v are fp32 or bf16; logw and u are fp32; arithmetic is
// fp32; y is written in r's type.
//
// What bounds it on an H100: operations.  At the rwkv6-3b prefill wave
// (B*H = 320 heads, S = 1024, N = 64) a token costs 2 N^2 multiply-adds
// for the cross-chunk product and the state update, C N for the
// intra-chunk attention and its product with v, and C N / 2 exps, against
// 5 N values moved: about 10 GFLOP of FFMA (0.15 ms at 67 TFLOP/s)
// against 0.42 GB (0.125 ms at 3.35 TB/s) at C = 64.  The kernel takes
// C = 32 whatever chunk the caller's reference would use (the result is
// the same function): the cross-chunk cost per token does not depend on
// C, and the intra-chunk cost and the exps halve with it (N C / 2 = 1024
// pairwise exps a token instead of 2048).
//
// Design (simple and right first): one CTA of 256 threads per (batch,
// head), looping over the chunks in order; the (N, N) f32 state stays in
// shared memory across chunks (16 KiB at N = 64) and goes to device memory
// once at the end.  Per chunk the r, k, v, logw tiles are staged in shared
// memory as f32 (row stride N + 1, so column walks are conflict-free), one
// thread per channel takes the cumsum, the C x C matrix A is built one
// entry per thread iteration, then each thread owns one output column j
// for C N / 256 rows, and one state column for N^2 / 256 rows.  N is
// padded inside the kernel to 16, 32 or 64 (zeros in shared memory), so
// device memory is never padded.  Shared memory is 61.5 KiB at N = 64:
// three CTAs fit on an SM, and the 320 CTAs of the prefill wave run in
// one wave on 132 SMs.  Tensor cores, TMA and a split of the state across
// warps are later work.
//
// This file must never be built with --use_fast_math (expf stays exact to
// an ulp or two).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;  // contiguous (H, N)
  void* y;         // contiguous (B, S, H, N), r's type
  float* state;    // contiguous (B, H, N, N), read and written in place
  int B, S, H, N;
  long long sr_b, sr_s, sr_h;
  long long sk_b, sk_s, sk_h;
  long long sv_b, sv_s, sv_h;
  long long sw_b, sw_s, sw_h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int NP>
constexpr int smem_floats() {
  // r, k, v, cum_prev, cum tiles | A | state | u | cum at the last row
  return 5 * kChunk * (NP + 1) + kChunk * (kChunk + 1) + NP * (NP + 1) +
         2 * NP;
}

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const Params p) {
  constexpr int C = kChunk;
  constexpr int LD = NP + 1;
  constexpr int LA = C + 1;
  constexpr int kStep = kThreads / NP;        // rows between a thread's rows
  constexpr int kYRows = C * NP / kThreads;   // output rows per thread
  constexpr int kSRows = NP * NP / kThreads;  // state rows per thread
  static_assert(kThreads % NP == 0 && kYRows >= 1 && kSRows >= 1, "NP");

  extern __shared__ __align__(16) float smem[];
  float* rs = smem;            // r, then r * exp(cum_prev)
  float* ks = rs + C * LD;     // k, then k * exp(cum_C - cum)
  float* vs = ks + C * LD;
  float* cp = vs + C * LD;     // logw, then cum_prev
  float* cs = cp + C * LD;     // cum
  float* A = cs + C * LD;      // [C][LA]
  float* St = A + C * LA;      // [NP][LD] state
  float* us = St + NP * LD;    // [NP]
  float* last = us + NP;       // [NP] cum at the chunk's last row

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int N = p.N;
  const T* rg = static_cast<const T*>(p.r) + b * p.sr_b + h * p.sr_h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk_b + h * p.sk_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv_b + h * p.sv_h;
  const float* wg = p.logw + b * p.sw_b + h * p.sw_h;
  const float* ug = p.u + static_cast<long long>(h) * N;
  float* sg = p.state + (static_cast<long long>(b) * p.H + h) * N * N;
  T* yg = static_cast<T*>(p.y) + (static_cast<long long>(b) * p.S * p.H + h) * N;
  const long long sy = static_cast<long long>(p.H) * N;

  for (int e = tid; e < NP * NP; e += kThreads) {
    const int i = e / NP, j = e % NP;
    St[i * LD + j] = (i < N && j < N) ? sg[i * N + j] : 0.f;
  }
  for (int i = tid; i < NP; i += kThreads) us[i] = i < N ? ug[i] : 0.f;

  const int jc = tid % NP;   // this thread's column (outputs and state)
  const int r0 = tid / NP;   // its first row

  for (int t0 = 0; t0 < p.S; t0 += C) {
    __syncthreads();  // the previous chunk's tile reads are done
    for (int e = tid; e < C * NP; e += kThreads) {
      const int t = e / NP, i = e % NP, s = t0 + t;
      const bool ok = s < p.S && i < N;
      rs[t * LD + i] = ok ? to_float(rg[s * p.sr_s + i]) : 0.f;
      ks[t * LD + i] = ok ? to_float(kg[s * p.sk_s + i]) : 0.f;
      vs[t * LD + i] = ok ? to_float(vg[s * p.sv_s + i]) : 0.f;
      cp[t * LD + i] = ok ? wg[s * p.sw_s + i] : 0.f;
    }
    __syncthreads();

    // inclusive cumsum of logw down the chunk, one thread per channel;
    // cum_prev = cum - logw, as the reference computes it
    if (tid < NP) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = cp[t * LD + tid];
        acc += lw;
        cs[t * LD + tid] = acc;
        cp[t * LD + tid] = acc - lw;
      }
      last[tid] = acc;
    }
    __syncthreads();

    // A: strictly lower decayed attention, the bonus on the diagonal
    for (int e = tid; e < C * C; e += kThreads) {
      const int t = e / C, s = e % C;
      float a = 0.f;
      if (s < t) {
#pragma unroll 8
        for (int i = 0; i < NP; ++i)
          a = fmaf(rs[t * LD + i] * ks[s * LD + i],
                   expf(cp[t * LD + i] - cs[s * LD + i]), a);
      } else if (s == t) {
#pragma unroll 8
        for (int i = 0; i < NP; ++i)
          a = fmaf(rs[t * LD + i] * ks[t * LD + i], us[i], a);
      }
      A[t * LA + s] = a;
    }
    __syncthreads();

    // decayed r for the cross-chunk product, decayed k for the state
    for (int e = tid; e < C * NP; e += kThreads) {
      const int t = e / NP, i = e % NP;
      rs[t * LD + i] *= expf(cp[t * LD + i]);
      ks[t * LD + i] *= expf(last[i] - cs[t * LD + i]);
    }
    __syncthreads();

    // y[t][j] = sum_i rdec[t][i] S[i][j] + sum_s A[t][s] v[s][j]
    {
      float acc[kYRows];
#pragma unroll
      for (int m = 0; m < kYRows; ++m) acc[m] = 0.f;
#pragma unroll 4
      for (int i = 0; i < NP; ++i) {
        const float sv = St[i * LD + jc];
#pragma unroll
        for (int m = 0; m < kYRows; ++m)
          acc[m] = fmaf(rs[(r0 + m * kStep) * LD + i], sv, acc[m]);
      }
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        const float vv = vs[s * LD + jc];
#pragma unroll
        for (int m = 0; m < kYRows; ++m)
          acc[m] = fmaf(A[(r0 + m * kStep) * LA + s], vv, acc[m]);
      }
      if (jc < N) {
#pragma unroll
        for (int m = 0; m < kYRows; ++m) {
          const int s = t0 + r0 + m * kStep;
          if (s < p.S) store(&yg[s * sy + jc], acc[m]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S[i][j] = exp(cum_C[i]) S[i][j] + sum_s kdec[s][i] v[s][j]
    {
      float acc[kSRows];
#pragma unroll
      for (int m = 0; m < kSRows; ++m) acc[m] = 0.f;
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        const float vv = vs[s * LD + jc];
#pragma unroll
        for (int m = 0; m < kSRows; ++m)
          acc[m] = fmaf(ks[s * LD + r0 + m * kStep], vv, acc[m]);
      }
#pragma unroll
      for (int m = 0; m < kSRows; ++m) {
        const int i = r0 + m * kStep;
        St[i * LD + jc] = expf(last[i]) * St[i * LD + jc] + acc[m];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += kThreads) {
    const int i = e / N, j = e % N;
    sg[e] = St[i * LD + j];
  }
}

template <typename T, int NP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<NP>();
  // set on every launch: the attribute is per device, and it is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  wkv6_kernel<T, NP><<<p.B * p.H, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.N <= 16) return launch<T, 16>(p, stream);
  if (p.N <= 32) return launch<T, 32>(p, stream);
  return launch<T, 64>(p, stream);
}

}  // namespace

extern "C" {

// dtype (of r, k, v and y): 0 = float32, 1 = bfloat16.  logw and u are
// float32.  Strides are in elements, the last dim of every input has
// stride 1, u is contiguous (H, N), y contiguous (B, S, H, N) and state
// contiguous (B, H, N, N).
// Returns the CUDA error of the launch (0 on success).
int wkv6_fwd(const void* r, const void* k, const void* v, const float* logw,
             const float* u, void* y, float* state, int dtype, int B, int S,
             int H, int N, long long sr_b, long long sr_s, long long sr_h,
             long long sk_b, long long sk_s, long long sk_h, long long sv_b,
             long long sv_s, long long sv_h, long long sw_b, long long sw_s,
             long long sw_h, void* stream) {
  if (N < 1 || N > 64 || B < 1 || S < 1 || H < 1 ||
      static_cast<long long>(B) * H > 2147483647LL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{r,    k,    v,    logw, u,    y,    state, B,   S,
                 H,    N,    sr_b, sr_s, sr_h, sk_b, sk_s,  sk_h, sv_b,
                 sv_s, sv_h, sw_b, sw_s, sw_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                                     : dispatch<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
