// Mamba2 SSD chunk-scan backward for Hopper (sm_90a), bound to Python
// with ctypes.
//
// The gradient of ssd.cu's function (B4), which the reference gets by
// differentiating its jnp chunk scan (src/repro/models/mamba2.py:
// _ssd_chunked under jax.grad): there is no Pallas backward to replace.
// Training zamba2 runs it once per mamba2 layer per microbatch.
//
// What it computes, for every batch b and head h, from the forward's
// inputs x (B, S, H, P; dt folded in), B and C (B, S, N; no head axis),
// da (B, S, H), the state at the start of each of its 32-token chunks
// (written by ssd.cu when asked), the gradient dy of y and dh_end of the
// final state (zero when null): dx (B, S, H, P), dda (B, S, H), dh_0
// (B, H, P, N) and this head's parts of dB and dC (B, S, H, N; the
// wrapper sums the heads, with no atomics).  In reverse over the chunks,
// carrying dh (P x N, f32), the gradient of the state after the chunk;
// with cum = cumsum of da down the chunk, L_ts = e^{cum_t - cum_s} for s
// <= t (else 0), G = C B^T, M = G L, dye = dy e^{cum}, xd = x e^{cum_C -
// cum} and h the chunk-start state:
//   dM = dy x^T, dG = dM L, W = dG G
//   dx = M^T dy + e^{cum_C - cum} (B dh^T)
//   dC = dye h + dG B          dB = dG^T C + xd dh
//   dcum_t = C_t . (dye h)_t + rowsum(W)_t - colsum(W)_t
//            - e^{cum_C - cum_t} x_t . (B dh^T)_t, and dcum_C adds
//            e^{cum_C} (dh . h) + sum_s e^{cum_C - cum_s} x_s . (B dh^T)_s
//   dda_t = sum_{t' >= t} dcum_t'
//   dh <- e^{cum_C} dh + dye^T C
// Every exponent is <= 0: L is taken pairwise, e^{cum_t - cum_s} with s
// <= t, never as e^{cum_t} e^{-cum_s} and never above the diagonal, where
// the reference's form (exp, then mask) overflows and makes its dda NaN
// once a chunk's decay sums past about 88.
//
// What bounds it on an H100: at the zamba2-2.7b training microbatch (B*H
// = 80 heads, S = 4096, P = N = 64) it moves x, dy, dx (B, S, H, P), the
// per-head dB and dC, the 128 chunk states a head and B, C, da once
// (about 0.5 GB, 0.15 ms at 3.35 TB/s) and does about 9 GFLOP (0.14 ms at
// 67 TFLOP/s fp32); its 80 CTAs take one wave on 132 SMs, and the chunk
// loop's dependence bounds it more than either.
//
// Design (a simple one, right first): one CTA of four warps per (batch,
// head), looping over the chunks in reverse.  Each chunk's x, B, C, dy,
// the chunk-start h and the carried dh sit in shared memory as f32 tiles
// (scan_bwd.cuh); the nine matrix products of a chunk run on mma.sync in
// 3xTF32 over the CTA's warps (scan_bwd.cuh gemm: fresh registers per
// 8-deep step, summed in f32); the cumsum is a warp's shuffle scan, L and
// the products with it elementwise, the row and column sums and dda's
// reverse cumsum a thread per token.  Seven barriers a chunk; 133 KiB of
// shared memory, one CTA per SM.  fp32 only (training is fp32 in both
// packages).
//
// Left for later: G is the same for the heads of a batch row (B and C
// have no head axis), so two heads a CTA would share it; fewer barriers.
//
// This file must never be built with --use_fast_math.
#include "scan_bwd.cuh"

namespace {

using namespace scan_bwd;

// x, B, C, dy, dye, xd, B dh^T, dx, dC, dB tiles; h, dh; G (then M), dM
// (then dG), W; cum, e^{cum}, e^{cum_C - cum}, x . (B dh^T), dcum; dh . h
// per row
constexpr int kSmemFloats = 10 * kCT + 2 * kDT + 3 * kCC + 5 * C + D;

struct Params {
  const float* x;       // contiguous (B, S, H, P), as dy
  const float* Bm;      // contiguous (B, S, N), as Cm
  const float* Cm;
  const float* da;      // contiguous (B, S, H)
  const float* states;  // contiguous (B, H, nchunks, P, N)
  const float* dy;
  const float* dh;      // contiguous (B, H, P, N), or null (zero)
  float* dx;            // contiguous (B, S, H, P)
  float* dB;            // contiguous (B, S, H, N): each head's part
  float* dC;
  float* dda;           // contiguous (B, S, H)
  float* dh0;           // contiguous (B, H, P, N)
  int B, S, H, P, N;
};

__global__ void __launch_bounds__(NT, 1) ssd_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* tx = sm;           // x
  float* tB = tx + kCT;     // B
  float* tC = tB + kCT;     // C
  float* tg = tC + kCT;     // dy
  float* tye = tg + kCT;    // dy e^{cum}
  float* txd = tye + kCT;   // x e^{cum_C - cum}
  float* tBh = txd + kCT;   // B dh^T
  float* tdx = tBh + kCT;   // dx
  float* tdC = tdx + kCT;   // dC
  float* tdB = tdC + kCT;   // dB
  float* sH = tdB + kCT;    // the chunk-start state h[p][n]
  float* sD = sH + kDT;     // dh[p][n]
  float* tG = sD + kDT;     // G, then M
  float* tM = tG + kCC;     // dM, then dG
  float* tW = tM + kCC;     // W
  float* vcum = tW + kCC;   // da, then cum
  float* vec = vcum + C;    // e^{cum}
  float* vkd = vec + C;     // e^{cum_C - cum}
  float* vdk = vkd + C;     // x_s . (B dh^T)_s
  float* vdc = vdk + C;     // dcum
  float* vrs = vdc + C;     // (dh . h) of row p

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int P = p.P, N = p.N, S = p.S, H = p.H;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long xrow = static_cast<long long>(H) * P;  // token strides
  const long long nrow = static_cast<long long>(H) * N;
  const long long xbase = (static_cast<long long>(b) * S * H + h) * P;
  const long long nbase = (static_cast<long long>(b) * S * H + h) * N;
  const long long bcbase = static_cast<long long>(b) * S * N;
  const int nchunks = (S + C - 1) / C;

  const float* dhg = p.dh ? p.dh + bh * P * N : nullptr;
  for (int e = tid; e < D * D; e += NT) {
    const int i = e / D, j = e % D;
    sD[i * LT + j] = (dhg && i < P && j < N) ? dhg[i * N + j] : 0.f;
  }

  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * C, rows = min(C, S - t0);
    load_rows<C>(tx, LT, p.x + xbase + t0 * xrow, xrow, rows, P);
    load_rows<C>(tg, LT, p.dy + xbase + t0 * xrow, xrow, rows, P);
    load_rows<C>(tB, LT, p.Bm + bcbase + static_cast<long long>(t0) * N, N,
                 rows, N);
    load_rows<C>(tC, LT, p.Cm + bcbase + static_cast<long long>(t0) * N, N,
                 rows, N);
    load_rows<D>(sH, LT, p.states + (bh * nchunks + c) * P * N, N, P, N);
    if (tid < C)
      vcum[tid] = tid < rows
                      ? p.da[(static_cast<long long>(b) * S + t0 + tid) * H + h]
                      : 0.f;
    __syncthreads();

    // cum by a shuffle scan over warp 0 (lane t); the products that need
    // no cum
    if (warp == 0) {
      float cum = vcum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, cum, o);
        if (lane >= o) cum += v;
      }
      const float last = __shfl_sync(0xffffffffu, cum, C - 1);
      vcum[lane] = cum;
      vec[lane] = expf(cum);
      vkd[lane] = expf(last - cum);
    }
    gemm<C, C, D>(tG, LC, tC, LT, 1, tB, 1, LT);   // G = C B^T
    gemm<C, C, D>(tM, LC, tg, LT, 1, tx, 1, LT);   // dM = dy x^T
    gemm<C, D, D>(tBh, LT, tB, LT, 1, sD, 1, LT);  // B dh^T
    if (tid < D) {
      float a = 0.f;
      for (int jj = 0; jj < D; ++jj) {
        const int j = (jj + tid) & (D - 1);
        a = fmaf(sD[tid * LT + j], sH[tid * LT + j], a);
      }
      vrs[tid] = a;
    }
    __syncthreads();

    // dye, xd; L, M, dG and W elementwise; x . (B dh^T)
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, j = e % D;
      tye[t * LT + j] = tg[t * LT + j] * vec[t];
      txd[t * LT + j] = tx[t * LT + j] * vkd[t];
    }
    for (int e = tid; e < C * C; e += NT) {
      const int t = e / C, s = e % C;
      const float l = s <= t ? expf(vcum[t] - vcum[s]) : 0.f;
      const float gg = tG[t * LC + s], dg = tM[t * LC + s] * l;
      tG[t * LC + s] = gg * l;
      tM[t * LC + s] = dg;
      tW[t * LC + s] = dg * gg;
    }
    if (tid < C) {
      float a = 0.f;
      for (int jj = 0; jj < D; ++jj) {
        const int j = (jj + tid) & (D - 1);
        a = fmaf(tx[tid * LT + j], tBh[tid * LT + j], a);
      }
      vdk[tid] = a;
    }
    __syncthreads();

    gemm<C, D, D>(tdC, LT, tye, LT, 1, sH, LT, 1);        // dye h
    gemm<C, D, C>(tdx, LT, tG, 1, LC, tg, LT, 1);         // M^T dy
    gemm<C, D, C>(tdB, LT, tM, 1, LC, tC, LT, 1);         // dG^T C
    gemm<C, D, D, true>(tdB, LT, txd, LT, 1, sD, LT, 1);  // + xd dh
    if (tid < C) {
      const int t = tid;
      float a = 0.f;
      for (int ss = 0; ss < C; ++ss) {
        const int s = (ss + t) & (C - 1);
        a += tW[t * LC + s] - tW[s * LC + t];
      }
      vdc[t] = a - vdk[t] * vkd[t];
    }
    __syncthreads();

    // C_t . (dye h)_t; dh <- e^{cum_C} dh + dye^T C; dx and dB out
    if (tid < C) {
      float a = 0.f;
      for (int jj = 0; jj < D; ++jj) {
        const int j = (jj + tid) & (D - 1);
        a = fmaf(tC[tid * LT + j], tdC[tid * LT + j], a);
      }
      vdc[tid] += a;
    }
    gemm<D, D, C, true>(sD, LT, tye, 1, LT, tC, LT, 1, nullptr, vec[C - 1]);
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, j = e % D;
      if (t < rows && j < P)
        p.dx[xbase + t0 * xrow + t * xrow + j] =
            tdx[t * LT + j] + vkd[t] * tBh[t * LT + j];
    }
    store_rows<C>(p.dB + nbase + t0 * nrow, nrow, tdB, LT, rows, N);
    __syncthreads();

    // dC += dG B; dda by a reverse cumsum
    gemm<C, D, C, true>(tdC, LT, tM, LC, 1, tB, LT, 1);
    if (tid == 0) {
      float dlast = 0.f;
      for (int j = 0; j < D; ++j) dlast += vrs[j];
      dlast *= vec[C - 1];
      for (int s = 0; s < C; ++s) dlast = fmaf(vdk[s], vkd[s], dlast);
      float a = dlast;
      for (int t = C - 1; t >= 0; --t) {
        a += vdc[t];
        if (t < rows)
          p.dda[(static_cast<long long>(b) * S + t0 + t) * H + h] = a;
      }
    }
    __syncthreads();
    store_rows<C>(p.dC + nbase + t0 * nrow, nrow, tdC, LT, rows, N);
    __syncthreads();  // the next chunk's loads overwrite the tiles
  }

  store_rows<D>(p.dh0 + bh * P * N, N, sD, LT, P, N);
}

}  // namespace

extern "C" {

// Every tensor is float32 and contiguous, of the shapes in Params; states
// holds ceil(S / 32) chunk-start states a (batch, head), as ssd_fwd
// writes them.  Returns the CUDA error of the launch (0 on success).
int ssd_bwd(const float* x, const float* Bm, const float* Cm,
            const float* da, const float* states, const float* dy,
            const float* dh, float* dx, float* dB, float* dC, float* dda,
            float* dh0, int B, int S, int H, int P, int N, void* stream) {
  if (P < 1 || P > D || N < 1 || N > D || B < 1 || S < 1 || H < 1 ||
      static_cast<long long>(B) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x,  Bm, Cm,  da, states, dy, dh, dx, dB,
                 dC, dda, dh0, B, S,      H,  P,  N};
  constexpr size_t bytes = sizeof(float) * kSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel<<<B * H, NT, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
