// Flash attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention /
// _attn_kernel (the Pallas TPU kernel behind ops.flash_attention), which
// the dense LM's full-sequence attention runs once per layer: the serving
// plane's batched prefill (models/attention.py prefill_attention ->
// full_attention -> ops.attention).
//
// What it computes, for every batch b, query head h and query row s:
//   o[b,s,h,:] = softmax_t(scale * q[b,s,h,:] . k[b,t,h/G,:]) @ v[b,t,h/G,:]
// over the keys t the mask lets through (t < T, t <= s when causal,
// s - t < window when a window is set; masked logits are -1e30, as in the
// reference), with G = H / KV query heads per KV head (kv-major grouping,
// mapped by index: K and V are never repeated in memory), scale =
// 1/sqrt(hd) of the unpadded head dim, logits, softmax and the PV product
// in fp32 on fp32 or bf16 inputs, and the output in the input type,
// normalised by max(l, 1e-30).
//
// What bounds it on an H100: operations.  At the serving prefill shape
// (B*H = 224 heads, S = T = 1024, hd = 128, causal) the visible pairs need
// 60.2 GFLOP against 268 MB of q, k, v and o; in fp32 that is 0.90 ms of
// FFMA at 67 TFLOP/s against 0.08 ms of bytes at 3.35 TB/s.  fp32 inputs
// must stay on the CUDA cores (TF32 tensor cores would break the 2e-5
// tolerance the reference holds the kernel to).
//
// Design (FA2-style, simple and right first): one CTA of 256 threads per
// (batch*head, 64-row query tile), heaviest causal tiles launched first.
// The tile's scaled Q is staged once in shared memory; K/V tiles of 64 rows
// stream through shared memory; each thread owns 4 query rows x 4 key
// columns of the logits and 4 rows x D/16 columns of the output, with the
// running max, sum and accumulator in fp32 registers and the row
// reductions done by warp shuffles (a row lives on 16 lanes of one warp).
// The K loop is clipped to the causal upper bound and the window's lower
// bound, and masks come from absolute positions.  The head dim is padded
// inside the kernel (zeros past hd in shared memory) to the next of 16,
// 32, 64, 80, 96, 128, so nothing is padded in device memory.  The
// probability tile reuses the K tile's shared memory, which keeps the
// hd = 128 CTA at 98.5 KiB so two CTAs fit on an SM.  wgmma, TMA and bf16
// tensor-core products are later work.
//
// This file must never be built with --use_fast_math (expf stays exact to
// an ulp or two; the 2e-5 fp32 tolerance depends on it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // key rows per K/V tile
constexpr int kThreads = 256;      // 16 x 16: ty picks rows, tx columns
constexpr int kRows = kBQ / 16;    // query rows per thread
constexpr int kCols = kBK / 16;    // logit columns per thread
constexpr int kQStride = kBQ + 4;  // Qs/Ps row stride (float4-aligned)
constexpr int kKStride = kBK + 1;  // Ks row stride (conflict-free stores)
constexpr float kNegInf = -1e30f;  // the reference's mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, T, H, KV, hd;
  long long sq_b, sq_s, sq_h;
  long long sk_b, sk_t, sk_h;
  long long sv_b, sv_t, sv_h;
  int causal;
  int window;  // <= 0: no window
  float scale;
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
  // Qs [D][kQStride] | Ks [D][kKStride] aliased by Ps [kBK][kQStride] | Vs [kBK][D]
  return D * kQStride +
         (D * kKStride > kBK * kQStride ? D * kKStride : kBK * kQStride) +
         kBK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kOC = D / 16;      // output columns per thread
  float* Qs = smem;                               // transposed, pre-scaled
  float* Ks = Qs + D * kQStride;                  // transposed
  float* Ps = Ks;                                 // transposed probabilities
  float* Vs = Ks + (D * kKStride > kBK * kQStride ? D * kKStride
                                                  : kBK * kQStride);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KV);

  const T* qg = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk_b + kvh * p.sk_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv_b + kvh * p.sv_h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[d * kQStride + r] =
        (s < p.S && d < p.hd) ? to_float(qg[s * p.sq_s + d]) * p.scale : 0.f;
  }

  // the K range this query tile can see
  const int hi = p.causal ? min(q0 + kBQ, p.T) : p.T;
  const int lo = p.window > 0 ? max(q0 + 1 - p.window, 0) : 0;
  const int kt_lo = lo / kBK;
  const int kt_hi = (hi + kBK - 1) / kBK;

  float m[kRows], l[kRows], acc[kRows][kOC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ps/Vs reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int t = i / D, d = i % D, tt = k0 + t;
      const bool ok = tt < p.T && d < p.hd;
      Ks[d * kKStride + t] = ok ? to_float(kg[tt * p.sk_t + d]) : 0.f;
      Vs[t * D + d] = ok ? to_float(vg[tt * p.sv_t + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv =
          *reinterpret_cast<const float4*>(&Qs[d * kQStride + ty * kRows]);
      const float qa[kRows] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = Ks[d * kKStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i][j] = fmaf(qa[i], kv, s[i][j]);
      }
    }

    // mask, then the online softmax update of each of this thread's rows
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < p.T;
        if (p.causal) ok = ok && qpos >= kpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        if (!ok) s[i][j] = kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every Ks read is done: Ps may overwrite it
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * kQStride + ty * kRows]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      const float4 pv =
          *reinterpret_cast<const float4*>(&Ps[t * kQStride + ty * kRows]);
      const float pa[kRows] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < kOC; ++c) {
        const float vv = Vs[t * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

  // o is contiguous (B, S, H, hd)
  T* og = static_cast<T*>(p.o) +
          (static_cast<long long>(b) * p.S * p.H + h) * p.hd;
  const long long so = static_cast<long long>(p.H) * p.hd;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + ty * kRows + i;
    if (s >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd) store(&og[s * so + d], acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<D>();
  // set on every launch: the attribute is per device, and it is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.B * p.H);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.hd <= 16) return launch<T, 16>(p, stream);
  if (p.hd <= 32) return launch<T, 32>(p, stream);
  if (p.hd <= 64) return launch<T, 64>(p, stream);
  if (p.hd <= 80) return launch<T, 80>(p, stream);
  if (p.hd <= 96) return launch<T, 96>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dim of q, k and v has stride 1 and o is contiguous (B, S, H, hd).
// Returns the CUDA error of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int S, int T, int H, int KV, int hd,
                        long long sq_b, long long sq_s, long long sq_h,
                        long long sk_b, long long sk_t, long long sk_h,
                        long long sv_b, long long sv_t, long long sv_h,
                        int causal, int window, float scale, void* stream) {
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0 || B < 1 || S < 1 ||
      T < 1 || B * H > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    B,    S,    T,      H,
                 KV,   hd,   sq_b, sq_s, sq_h, sk_b, sk_t,   sk_h,
                 sv_b, sv_t, sv_h, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                                     : dispatch<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
