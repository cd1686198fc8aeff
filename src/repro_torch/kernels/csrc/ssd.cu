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
// the final h is written back to `state` in place; when `states` is
// given, the state at the start of each 32-token chunk is written there
// too, for the backward (ssd_bwd.cu).  It is evaluated
// chunkwise, as the reference does: with cum = cumsum(da) down a chunk,
//   y  = exp(cum_t) * (C_t . h) + sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) x_s
//   h' = exp(cum_last) * h + sum_s x_s (x) (exp(cum_last - cum_s) * B_s)
// where cum_t - cum_s <= 0 for s <= t, so no exp can overflow.  B and C
// have no head axis (n_groups = 1): every head of a batch row reads the
// same rows by index, and x is read through its (B, S, H, P) strides.
// Tokens past S read as x = B = C = 0, da = 0 and are not written.  x, B
// and C are fp32 or bf16; da is fp32; y is written in x's type.
//
// What bounds it on an H100: operations on the CUDA cores, bytes on the
// tensor cores.  At the zamba2-2.7b prefill wave (B*H = 8*80 = 640 heads,
// S = 1024, P = N = 64) a chunk of C tokens costs 2 C P N multiply-adds
// per head for C.h and the state update, C^2 N / 2 for the visible C.B
// products and C^2 P / 2 for their product with x: about 12 GFLOP at C =
// 32 (0.18 ms at 67 TFLOP/s fp32), 0.07 ms as 3xTF32 at 495 TFLOP/s,
// against 0.36 GB of x, y, B, C and da (0.11 ms at 3.35 TB/s).
//
// Design.  One CTA of four warps per (batch, head), looping over chunks of
// 32 tokens (kChunk, whatever chunk the caller names: the function is the
// same).  The state's rows evolve apart (h[p, :] sees only x_t[p]), so
// each warp holds 16 rows of the (64, 64) state in registers, as the
// accumulator tile of the state update, for the whole scan; read as the A
// operand of h C^T straight from those registers, it never goes through
// shared memory.  Per chunk, with two barriers:
//   * x, B, C arrive in their own type by cp.async (16-byte copies where
//     aligned, 4-byte ones for unaligned f32, plain loads for unaligned
//     bf16) into one of two stages while the previous chunk computes;
//   * each warp takes the cumsum of da with a shuffle scan (lane = token);
//   * warp w builds G = C B^T on the 16 x 8 tile of rows 16-31 and key
//     columns 8 w.., warps 0 and 1 also rows 0-15 (the two products share
//     B's fragments), and decays and masks it into M[t][s] = G exp(cum_t -
//     cum_s), s <= t, in shared memory;
//   * each warp computes its rows of y^T = exp(cum_t) (h C^T), which needs
//     no M, then, past the barrier, y^T += x^T M^T and h = exp(cum_last) h
//     + x^T (exp(cum_last - cum_s) B).
// Every product runs on mma.sync m16n8k8 in 3xTF32 (chunk_scan.cuh); bf16
// inputs are exact in TF32, so their lo terms are dropped.  P and N are
// padded to 64 inside the kernel.  A CTA takes 52.5 KiB of shared memory
// for f32 inputs (28.5 KiB for bf16) and 128 registers a thread: four CTAs
// fit on an SM, so the 640 CTAs of the prefill wave take 1.21 waves on
// 132 SMs.
//
// Measured and left for later (PERF.md): two heads a CTA sharing G (it
// is the same for the heads of a batch row, B and C having no head axis)
// were slower in a same-call A/B build on an H100, four slower still;
// bf16 inputs still go through TF32, at half the bf16 tensor rate; wgmma.
//
// This file must never be built with --use_fast_math.
#include "chunk_scan.cuh"

namespace {

using namespace chunk_scan;

constexpr int C = kChunk;
constexpr int LM = C + 4;  // M's row stride: M[t][s] reads are conflict-free
// two stages of x, B, C tiles in the inputs' type, then M
template <typename T>
__host__ __device__ constexpr int smem_floats() {
  return 2 * 3 * kTile * static_cast<int>(sizeof(T)) / 4 + C * LM;
}

struct Params {
  const void* x;
  const void* Bm;
  const void* Cm;
  const float* da;
  void* y;         // contiguous (B, S, H, P), x's type
  float* state;    // contiguous (B, H, P, N), read and written in place
  float* states;   // contiguous (B, H, nchunks, P, N) chunk-start states,
                   // or null (not written)
  int B, S, H, P, N;
  long long sx_b, sx_s, sx_h;
  long long sb_b, sb_s;
  long long sc_b, sc_s;
  long long sd_b, sd_s, sd_h;
  int mode_x, mode_bc;  // LoadMode of the x tiles and of the B, C tiles
};

// Rows t..t+15 of M's column tile nt from the accumulator d of G there.
__device__ __forceinline__ void store_m(float* M, const float (&d)[4],
                                        float cum, int t, int nt, int q) {
  const int s0 = 8 * nt + 2 * q;
  const float ct0 = __shfl_sync(0xffffffffu, cum, t);
  const float ct1 = __shfl_sync(0xffffffffu, cum, t + 8);
  const float cs0 = __shfl_sync(0xffffffffu, cum, s0);
  const float cs1 = __shfl_sync(0xffffffffu, cum, s0 + 1);
  M[t * LM + s0] = s0 <= t ? d[0] * expf(ct0 - cs0) : 0.f;
  M[t * LM + s0 + 1] = s0 + 1 <= t ? d[1] * expf(ct0 - cs1) : 0.f;
  M[(t + 8) * LM + s0] = s0 <= t + 8 ? d[2] * expf(ct1 - cs0) : 0.f;
  M[(t + 8) * LM + s0 + 1] = s0 + 1 <= t + 8 ? d[3] * expf(ct1 - cs1) : 0.f;
}

// G = C B^T on column tile nt for rows 16-31 and, when LOW, rows 0-15 (the
// two accumulators interleave), decayed and masked into M.
template <bool LO, bool LOW, typename T>
__device__ __forceinline__ void build_m(float* M, const T* cs, const T* bs,
                                        float cum, int nt, int g, int q) {
  float d1[4] = {0.f, 0.f, 0.f, 0.f}, d0[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int col = 8 * kk + 2 * q;
    const float2 bv = ldf2(bs, 8 * nt + g, col);
    FragB<LO> bb;
    bb.set(bv.x, bv.y);
    const float2 c0 = ldf2(cs, 16 + g, col), c1 = ldf2(cs, 24 + g, col);
    FragA<LO> a;
    a.set(c0.x, c1.x, c0.y, c1.y);
    mma3(d1, a, bb);
    if (LOW) {
      const float2 e0 = ldf2(cs, g, col), e1 = ldf2(cs, 8 + g, col);
      FragA<LO> a0;
      a0.set(e0.x, e1.x, e0.y, e1.y);
      mma3(d0, a0, bb);
    }
  }
  store_m(M, d1, cum, 16 + g, nt, q);
  if (LOW) store_m(M, d0, cum, g, nt, q);
}

// STATES: the chunk-start states are written (training's forward only;
// serving runs the instantiation without that code)
template <typename T, bool STATES>
__global__ void __launch_bounds__(kThreads, 4) ssd_kernel(const Params p) {
  constexpr bool LO = sizeof(T) == 4;  // bf16 inputs are exact in TF32
  extern __shared__ __align__(16) float smem[];
  T* tiles0 = reinterpret_cast<T*>(smem);  // stage c & 1 at 3 c kTile
  float* M = smem + smem_floats<T>() - C * LM;  // [C][LM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int P = p.P, N = p.N, S = p.S;
  const T* xg = static_cast<const T*>(p.x) + b * p.sx_b + h * p.sx_h;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.sb_b;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.sc_b;
  const float* dg = p.da + b * p.sd_b + h * p.sd_h;
  float* hg = p.state + (static_cast<long long>(b) * p.H + h) * P * N;
  T* yg = static_cast<T*>(p.y) + (static_cast<long long>(b) * S * p.H + h) * P;
  const long long sy = static_cast<long long>(p.H) * P;
  const int p0 = warp * 16;  // this warp's rows of the state and of y^T

  for (int e = tid; e < C * LM; e += kThreads) M[e] = 0.f;

  // hs[nt] holds h[p0 + g + 8 r][8 nt + 2 q + c] at 2 r + c (D layout)
  float hs[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = p0 + g + 8 * (e >> 1), n = 8 * nt + 2 * q + (e & 1);
      hs[nt][e] = (pp < P && n < N) ? hg[pp * N + n] : 0.f;
    }

  // two stages of x, B, C tiles, the chunk's own by its parity
  auto tiles = [&](int c) { return tiles0 + (c & 1) * 3 * kTile; };
  auto issue = [&](int c) {
    T* st = tiles(c);
    const int t0 = c * C, rows = min(C, S - t0);
    load_tile(st, xg + t0 * p.sx_s, p.sx_s, rows, P, p.mode_x);
    load_tile(st + kTile, bg + t0 * p.sb_s, p.sb_s, rows, N, p.mode_bc);
    load_tile(st + 2 * kTile, cg + t0 * p.sc_s, p.sc_s, rows, N, p.mode_bc);
    cp_async_commit();
  };

  const int nchunks = (S + C - 1) / C;
  issue(0);
  float dnext = lane < S ? dg[lane * p.sd_s] : 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * C;
    if (STATES) {
      float* o = p.states +
                 ((static_cast<long long>(b) * p.H + h) * nchunks + c) * P * N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pp = p0 + g + 8 * (e >> 1), n = 8 * nt + 2 * q + (e & 1);
          if (pp < P && n < N) o[pp * N + n] = hs[nt][e];
        }
    }
    const T* xs = tiles(c);
    const T* bs = xs + kTile;
    const T* cs = bs + kTile;
    cp_async_wait_all();
    __syncthreads();  // this chunk's tiles are in; the last chunk is done
    if (c + 1 < nchunks) issue(c + 1);

    // cumsum of da down the chunk: lane t holds cum_t
    float cum = dnext;
    if (c + 1 < nchunks) {
      const int t = t0 + C + lane;
      dnext = t < S ? dg[t * p.sd_s] : 0.f;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, cum, o);
      if (lane >= o) cum += v;
    }
    const float cum_last = __shfl_sync(0xffffffffu, cum, C - 1);
    const float ecum = expf(cum);              // exp(cum_t), lane t
    const float wdec = expf(cum_last - cum);   // exp(cum_last - cum_s), lane s

    // M = (C B^T) exp(cum_t - cum_s), s <= t, on the tiles (16 rows of t,
    // 8 columns of s) that reach the diagonal: warp w takes the columns
    // 8 w.. against rows 16-31, and warps 0 and 1 against rows 0-15 too,
    // sharing the B fragments
    if (warp < 2)
      build_m<LO, true>(M, cs, bs, cum, warp, g, q);
    else
      build_m<LO, false>(M, cs, bs, cum, warp, g, q);

    // y^T (rows p, columns t) = exp(cum_t) (h C^T): h is the A operand
    // straight from its accumulators (k slot q = n 2q, slot q + 4 = 2q + 1)
    float ya[4][4];
#pragma unroll
    for (int jt = 0; jt < 4; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[jt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      FragA<true> a;
      a.set(hs[kk][0], hs[kk][2], hs[kk][1], hs[kk][3]);
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        const float2 cv = ldf2(cs, 8 * jt + g, 8 * kk + 2 * q);
        FragB<LO> bb;
        bb.set(cv.x, cv.y);
        mma3(ya[jt], a, bb);
      }
    }
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) {
      const float e0 = __shfl_sync(0xffffffffu, ecum, 8 * jt + 2 * q);
      const float e1 = __shfl_sync(0xffffffffu, ecum, 8 * jt + 2 * q + 1);
      ya[jt][0] *= e0;
      ya[jt][1] *= e1;
      ya[jt][2] *= e0;
      ya[jt][3] *= e1;
    }
    const float dtot = __shfl_sync(0xffffffffu, ecum, C - 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[nt][e] *= dtot;

    __syncthreads();  // M is built (the readout above does not read it)

    // y^T += x^T M^T and h += x^T (wdec B), one x^T fragment per 8 tokens
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int s = 8 * kk + q;
      FragA<LO> a;
      a.set(ldf(xs, s, p0 + g), ldf(xs, s, p0 + g + 8), ldf(xs, s + 4, p0 + g),
            ldf(xs, s + 4, p0 + g + 8));
#pragma unroll
      for (int jt = kk; jt < 4; ++jt) {
        FragB<true> m;
        m.set(M[(8 * jt + g) * LM + s], M[(8 * jt + g) * LM + s + 4]);
        mma3(ya[jt], a, m);
      }
      const float w0 = __shfl_sync(0xffffffffu, wdec, s);
      const float w1 = __shfl_sync(0xffffffffu, wdec, s + 4);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        FragB<true> bw;
        bw.set(w0 * ldf(bs, s, 8 * nt + g), w1 * ldf(bs, s + 4, 8 * nt + g));
        mma3(hs[nt], a, bw);
      }
    }

#pragma unroll
    for (int jt = 0; jt < 4; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = p0 + g + 8 * (e >> 1);
        const int t = t0 + 8 * jt + 2 * q + (e & 1);
        if (pp < P && t < S) store(&yg[t * sy + pp], ya[jt][e]);
      }
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = p0 + g + 8 * (e >> 1), n = 8 * nt + 2 * q + (e & 1);
      if (pp < P && n < N) hg[pp * N + n] = hs[nt][e];
    }
}

template <typename T, bool STATES>
cudaError_t launch_as(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<T>();
  // set on every launch: the attribute is per device, and it is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, STATES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssd_kernel<T, STATES><<<p.B * p.H, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.states ? launch_as<T, true>(p, stream)
                  : launch_as<T, false>(p, stream);
}

template <typename T>
cudaError_t occupancy(int* ctas) {
  constexpr size_t bytes = sizeof(float) * smem_floats<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, ssd_kernel<T, false>, kThreads, bytes);
}

}  // namespace

extern "C" {

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16; da is float32.
// Strides are in elements, the last dim of x, Bm and Cm has stride 1, y is
// contiguous (B, S, H, P), state contiguous (B, H, P, N) and states null
// or contiguous (B, H, ceil(S / 32), P, N).  Returns the CUDA error of the
// launch (0 on success).
int ssd_fwd(const void* x, const void* Bm, const void* Cm, const float* da,
            void* y, float* state, float* states, int dtype, int B, int S,
            int H, int P, int N, long long sx_b, long long sx_s,
            long long sx_h, long long sb_b, long long sb_s, long long sc_b,
            long long sc_s, long long sd_b, long long sd_s, long long sd_h,
            void* stream) {
  if (P < 1 || P > kDim || N < 1 || N > kDim || B < 1 || S < 1 || H < 1 ||
      static_cast<long long>(B) * H > 2147483647LL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int mode_x, mode_bc;  // the slower of B's and C's modes for both
  if (dtype == 0) {
    mode_x = load_mode<float>(x, P, {sx_b, sx_s, sx_h});
    mode_bc = std::max(load_mode<float>(Bm, N, {sb_b, sb_s}),
                       load_mode<float>(Cm, N, {sc_b, sc_s}));
  } else {  // (a bf16 mode is kVec16 or kPlain)
    mode_x = load_mode<__nv_bfloat16>(x, P, {sx_b, sx_s, sx_h});
    mode_bc = std::max(load_mode<__nv_bfloat16>(Bm, N, {sb_b, sb_s}),
                       load_mode<__nv_bfloat16>(Cm, N, {sc_b, sc_s}));
  }
  const Params p{x,    Bm,   Cm,   da,   y,    state, states, B,
                 S,    H,    P,    N,    sx_b, sx_s,  sx_h,   sb_b,
                 sb_s, sc_b, sc_s, sd_b, sd_s, sd_h,  mode_x, mode_bc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch<float>(p, st)
                                     : launch<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}

// CTAs of the kernel for `dtype` that fit on one SM, or minus the CUDA
// error; launches nothing.
int ssd_ctas_per_sm(int dtype) {
  int ctas = 0;
  const cudaError_t err = dtype == 0 ? occupancy<float>(&ctas)
                                     : occupancy<__nv_bfloat16>(&ctas);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
