// WKV6 chunk-scan backward for Hopper (sm_90a), bound to Python with
// ctypes.
//
// The gradient of wkv6.cu's function (RWKV-6 time mix, B3), which the
// reference gets by differentiating its jnp chunk scan
// (src/repro/models/rwkv6.py:_wkv_chunked under jax.grad): there is no
// Pallas backward to replace.  Training rwkv6 runs it once per layer per
// microbatch.
//
// What it computes, for every batch b and head h, from the forward's
// inputs r, k, v, logw (B, S, H, N), u (H, N), the state at the start of
// each of its 32-token chunks (written by wkv6.cu when asked), the
// gradient dy of y and dS_end of the final state (zero when null): dr, dk,
// dv, dlogw (B, S, H, N), du per (batch, head) (B, H, N; the wrapper sums
// the batch) and dS_0 (B, H, N, N).  In reverse over the chunks, carrying
// dS (N x N, f32), the gradient of the state after the chunk; with cum =
// inclusive cumsum of logw down the chunk, cum_prev = cum - logw, rd = r
// e^{cum_prev}, kd = k e^{cum_C - cum}, A the chunk's attention (strictly
// lower pairwise decayed products, the bonus u on the diagonal) and S the
// chunk-start state:
//   dA = dy v^T (its diagonal dd, the bonus's; below it the pairs')
//   dv = A^T dy + kd dS           d(rd) = dy S^T          d(kd) = v dS^T
//   dr_t = d(rd)_t e^{cum_prev_t} + sum_{s<t} dA_ts k_s e^{cum_prev_t - cum_s}
//          + dd_t u k_t, and dk alike; du = sum_t dd_t r_t k_t
//   dcum_prev, dcum from the same terms; dcum_C adds e^{cum_C} (dS . S)
//   dlogw_t = sum_{t' >= t} dcum_t' + sum_{t' > t} dcum_prev_t'
//   dS <- e^{cum_C} dS + rd^T dy
// Every exponent is <= 0: the pairwise decays stay pairwise in log space,
// as the forward's do, so strong decays cannot overflow.
//
// What bounds it on an H100: at the rwkv6-3b training microbatch (B*H =
// 40 heads, S = 4096, N = 64) it moves r, k, v, logw, dy, the 128 chunk
// states and the four gradients once (about 0.25 GB, 0.08 ms at 3.35
// TB/s) and does about 3 GFLOP (0.05 ms at 67 TFLOP/s fp32): it is bound
// by neither, but by its 40 CTAs on 132 SMs and the chunk loop's
// dependence, the forward's too.
//
// Design (a simple one, right first): one CTA of four warps per (batch,
// head), looping over the chunks in reverse.  Each chunk's r, k, v, dy,
// cum, S and the carried dS sit in shared memory as f32 tiles
// (scan_bwd.cuh); the eight matrix products of a chunk run on mma.sync in
// 3xTF32 over the CTA's warps (scan_bwd.cuh gemm: fresh registers per
// 8-deep step, summed in f32); A's 496 strictly-lower entries and the
// pairwise sums of dr and dk run on the CUDA cores with one exp a term,
// the latter a thread per channel (threads 0-63 for dr and dcum_prev,
// 64-127 for dk and dcum), and the reverse cumsum for dlogw a thread per
// channel.  Five barriers a chunk; 129 KiB of shared memory, one CTA per
// SM.  fp32 only (training is fp32 in both packages).
//
// Left for later: A and the pairwise sums in the factored form the
// forward takes below its diagonal blocks; more than one CTA per head.
//
// This file must never be built with --use_fast_math.
#include "scan_bwd.cuh"

namespace {

using namespace scan_bwd;

// r, k, v, dy, cum, rd, kd, d(rd), d(kd), dv tiles; S, dS; A, dA; u,
// e^{cum_C}, the state's part of dcum_C
constexpr int kSmemFloats = 10 * kCT + 2 * kDT + 2 * kCC + 3 * D;

struct Params {
  const float* r;       // contiguous (B, S, H, N), as k, v, logw, dy
  const float* k;
  const float* v;
  const float* logw;
  const float* u;       // contiguous (H, N)
  const float* states;  // contiguous (B, H, nchunks, N, N)
  const float* dy;
  const float* dstate;  // contiguous (B, H, N, N), or null (zero)
  float* dr;            // contiguous (B, S, H, N), as dk, dv, dlogw
  float* dk;
  float* dv;
  float* dlogw;
  float* du;            // contiguous (B, H, N): this batch row's part
  float* dstate0;       // contiguous (B, H, N, N)
  int B, S, H, N;
};

__global__ void __launch_bounds__(NT, 1) wkv6_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* tr = sm;          // r
  float* tk = tr + kCT;    // k
  float* tv = tk + kCT;    // v
  float* tg = tv + kCT;    // dy
  float* tc = tg + kCT;    // cum
  float* trd = tc + kCT;   // r e^{cum_prev}
  float* tkd = trd + kCT;  // k e^{cum_C - cum}
  float* tp = tkd + kCT;   // d(rd), then dcum_prev
  float* tq = tp + kCT;    // d(kd), then dcum
  float* tdv = tq + kCT;   // dv
  float* sS = tdv + kCT;   // the chunk-start state S[i][j]
  float* sD = sS + kDT;    // dS[i][j]
  float* tA = sD + kDT;    // A[t][s]
  float* tdA = tA + kCC;   // dA[t][s]
  float* vu = tdA + kCC;   // u
  float* vdc = vu + D;     // e^{cum_C}
  float* vdl = vdc + D;    // e^{cum_C} (dS . S), per channel

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int N = p.N, S = p.S, H = p.H;
  const long long row = static_cast<long long>(H) * N;  // token stride
  const long long base = (static_cast<long long>(b) * S * H + h) * N;
  const long long bh = static_cast<long long>(b) * H + h;
  const int nchunks = (S + C - 1) / C;

  if (tid < D) vu[tid] = tid < N ? p.u[h * N + tid] : 0.f;
  const float* dsg = p.dstate ? p.dstate + bh * N * N : nullptr;
  for (int e = tid; e < D * D; e += NT) {
    const int i = e / D, j = e % D;
    sD[i * LT + j] = (dsg && i < N && j < N) ? dsg[i * N + j] : 0.f;
  }
  float du = 0.f;  // threads 0-63: du of channel tid

  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * C, rows = min(C, S - t0);
    const long long off = base + t0 * row;
    load_rows<C>(tr, LT, p.r + off, row, rows, N);
    load_rows<C>(tk, LT, p.k + off, row, rows, N);
    load_rows<C>(tv, LT, p.v + off, row, rows, N);
    load_rows<C>(tg, LT, p.dy + off, row, rows, N);
    load_rows<C>(tc, LT, p.logw + off, row, rows, N);
    load_rows<D>(sS, LT, p.states + (bh * nchunks + c) * N * N, N, N, N);
    __syncthreads();

    // cum: inclusive cumsum of logw down the chunk, a thread per channel
    if (tid < D) {
      float a = 0.f;
      for (int t = 0; t < C; ++t) {
        a += tc[t * LT + tid];
        tc[t * LT + tid] = a;
      }
      vdc[tid] = expf(a);
    }
    __syncthreads();

    // rd and kd
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, i = e % D;
      const float cp = t ? tc[(t - 1) * LT + i] : 0.f;
      const float cu = tc[t * LT + i], last = tc[(C - 1) * LT + i];
      trd[t * LT + i] = tr[t * LT + i] * expf(cp);
      tkd[t * LT + i] = tk[t * LT + i] * expf(last - cu);
    }
    // A: warp w takes rows w, w + 4, .., lane s the key; channels walked
    // from the lane's own (fewer bank conflicts)
    for (int e = tid; e < C * C; e += NT) {
      const int t = e / C, s = e % C;
      float a = 0.f;
      if (s < t) {
        for (int jj = 0; jj < D; ++jj) {
          const int i = (jj + lane) & (D - 1);
          a = fmaf(tr[t * LT + i] * tk[s * LT + i],
                   expf(tc[(t - 1) * LT + i] - tc[s * LT + i]), a);
        }
      } else if (s == t) {
        for (int jj = 0; jj < D; ++jj) {
          const int i = (jj + lane) & (D - 1);
          a = fmaf(tr[t * LT + i] * tk[t * LT + i], vu[i], a);
        }
      }
      tA[t * LC + s] = a;
    }
    __syncthreads();

    // the products that read dS before its update
    gemm<C, C, D>(tdA, LC, tg, LT, 1, tv, 1, LT);         // dy v^T
    gemm<C, D, C>(tdv, LT, tA, 1, LC, tg, LT, 1);         // A^T dy
    gemm<C, D, D, true>(tdv, LT, tkd, LT, 1, sD, LT, 1);  // + kd dS
    gemm<C, D, D>(tp, LT, tg, LT, 1, sS, 1, LT);          // dy S^T
    gemm<C, D, D>(tq, LT, tv, LT, 1, sD, 1, LT);          // v dS^T
    if (tid < D) {
      float a = 0.f;
      for (int jj = 0; jj < D; ++jj) {
        const int j = (jj + tid) & (D - 1);
        a = fmaf(sD[tid * LT + j], sS[tid * LT + j], a);
      }
      vdl[tid] = vdc[tid] * a;
    }
    __syncthreads();

    // dS <- e^{cum_C} dS + rd^T dy
    gemm<D, D, C, true>(sD, LT, trd, 1, LT, tg, LT, 1, vdc);
    const float* dd = tdA;  // dd_t at tdA[t * (LC + 1)]
    if (tid < D) {
      // dr and dcum_prev of channel i, token by token
      const int i = tid;
      for (int t = 0; t < C; ++t) {
        const float cp = t ? tc[(t - 1) * LT + i] : 0.f;
        float a = 0.f;
        for (int s = 0; s < t; ++s)
          a = fmaf(tdA[t * LC + s] * tk[s * LT + i],
                   expf(cp - tc[s * LT + i]), a);
        const float ddt = dd[t * (LC + 1)], drd = tp[t * LT + i];
        const float rt = tr[t * LT + i], kt = tk[t * LT + i];
        if (t < rows && i < N)
          p.dr[off + t * row + i] = drd * expf(cp) + a + ddt * vu[i] * kt;
        tp[t * LT + i] = drd * trd[t * LT + i] + rt * a;
        du = fmaf(ddt, rt * kt, du);
      }
    } else {
      // dk and dcum of channel i, key by key
      const int i = tid - D;
      const float last = tc[(C - 1) * LT + i];
      float dl = 0.f;
      for (int s = 0; s < C; ++s) {
        const float cs = tc[s * LT + i];
        float a = 0.f;
        for (int t = s + 1; t < C; ++t)
          a = fmaf(tdA[t * LC + s] * tr[t * LT + i],
                   expf(tc[(t - 1) * LT + i] - cs), a);
        const float ddt = dd[s * (LC + 1)], dkd = tq[s * LT + i];
        const float kd = tkd[s * LT + i];
        if (s < rows && i < N)
          p.dk[off + s * row + i] =
              dkd * expf(last - cs) + a + ddt * vu[i] * tr[s * LT + i];
        dl = fmaf(dkd, kd, dl);
        tq[s * LT + i] = -dkd * kd - tk[s * LT + i] * a;
      }
      tq[(C - 1) * LT + i] += dl + vdl[i];
    }
    store_rows<C>(p.dv + off, row, tdv, LT, rows, N);
    __syncthreads();

    // dlogw_t = sum_{t' >= t} dcum_t' + sum_{t' > t} dcum_prev_t'
    if (tid < D) {
      float a = 0.f, bq = 0.f;
      for (int t = C - 1; t >= 0; --t) {
        a += tq[t * LT + tid];
        if (t < rows && tid < N) p.dlogw[off + t * row + tid] = a + bq;
        bq += tp[t * LT + tid];
      }
    }
    __syncthreads();  // the next chunk's loads overwrite the tiles
  }

  if (tid < N) p.du[bh * N + tid] = du;
  store_rows<D>(p.dstate0 + bh * N * N, N, sD, LT, N, N);
}

}  // namespace

extern "C" {

// Every tensor is float32 and contiguous, of the shapes in Params; states
// holds ceil(S / 32) chunk-start states a (batch, head), as wkv6_fwd
// writes them.  Returns the CUDA error of the launch (0 on success).
int wkv6_bwd(const float* r, const float* k, const float* v,
             const float* logw, const float* u, const float* states,
             const float* dy, const float* dstate, float* dr, float* dk,
             float* dv, float* dlogw, float* du, float* dstate0, int B, int S,
             int H, int N, void* stream) {
  if (N < 1 || N > D || B < 1 || S < 1 || H < 1 ||
      static_cast<long long>(B) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{r,  k,  v,     logw, u,  states, dy, dstate, dr,
                 dk, dv, dlogw, du,   dstate0, B, S,  H,      N};
  constexpr size_t bytes = sizeof(float) * kSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<<<B * H, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
