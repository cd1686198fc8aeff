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
// wrapper sums the heads, with no atomics).  With cum = cumsum of da down
// a chunk, L_ts = e^{cum_t - cum_s} for s <= t (else 0), G = C B^T, M = G
// L, dye = dy e^{cum}, xd = x e^{cum_C - cum}, h the chunk-start state and
// dh the gradient of the state after the chunk:
//   pass 1 (ssd_bwd_dstate), in reverse over the chunks from dh_end:
//     dh <- e^{cum_C} dh + dye^T C, written after every chunk; dh_0
//   pass 2 (ssd_bwd), every chunk on its own:
//     dM = dy x^T, dG = dM L, W = dG G
//     dx = M^T dy + e^{cum_C - cum} (B dh^T)
//     dC = dye h + dG B          dB = dG^T C + xd dh
//     dcum_t = C_t . (dye h)_t + rowsum(W)_t - colsum(W)_t
//              - e^{cum_C - cum_t} x_t . (B dh^T)_t, and dcum_C adds
//              e^{cum_C} (dh . h) + sum_s e^{cum_C - cum_s} x_s . (B dh^T)_s
//     dda_t = sum_{t' >= t} dcum_t'
// Every exponent is <= 0: L is taken pairwise, e^{cum_t - cum_s} with s
// <= t, never as e^{cum_t} e^{-cum_s} and never above the diagonal, where
// the reference's form (exp, then mask) overflows and makes its dda NaN
// once a chunk's decay sums past about 88.  Every exp is expf.
//
// What bounds it on an H100: at the zamba2-2.7b training microbatch (B*H
// = 80 heads, S = 4096, P = N = 64) the function moves x, dy, dx, the
// per-head dB and dC, the 128 chunk states a head and B, C, da once
// (about 0.35 GB, 0.10 ms at 3.35 TB/s) and does about 13.5 GFLOP (0.20
// ms at 67 TFLOP/s fp32).  The only dependence between chunks is the
// carried dh; this design writes it out (a further 168 MB, written by
// pass 1 and read by pass 2) so that everything else runs a CTA a chunk.
//
// Design.
//   * Pass 1: a CTA of four warps per (batch, head, 16 rows p of dh),
//     320 CTAs at the training shape, looping over the chunks in reverse
//     with its (16, 64) slice of dh in registers as the accumulator tiles
//     of mma.sync (warp w: columns 16 w..16 w + 15), as ssd.cu holds the
//     forward's state.  A chunk's dy slice, C and da arrive by cp.async
//     into one of two stages while the previous chunk computes; each warp
//     takes cum by a shuffle scan and the one product dye^T C, 3xTF32.
//     One barrier a chunk.
//   * Pass 2: a CTA of four warps per (batch, head, chunk), the heads of
//     a chunk next to each other (B and C come from L2), 10,240 CTAs at
//     the training shape with no loop.  x, dy, B, C, h and dh arrive by
//     cp.async (16-byte copies where aligned) into unpadded, swizzled f32
//     tiles (scan_bwd.cuh at); the nine products run on mma.sync in
//     3xTF32 over the warps, operands stored as rows of their m or n
//     index loaded by ldmatrix, with G and dM in shared memory (L, M and
//     dG are formed there elementwise) and dx, dB and dC written from the
//     accumulators; cum and dda's reverse cumsum are warp shuffle scans,
//     the row and column sums of W = dG G and the per-token dots are
//     spread over all four warps and summed in a fixed order.  Four
//     barriers; 74.25 KiB of shared memory and 140 registers, three CTAs
//     (twelve warps) an SM.
// fp32 only (training is fp32 in both packages).  scripts/
// scan_bwd_ablation.py times each part of the work.
//
// Left for later: G is the same for the heads of a batch row (B and C
// have no head axis), so two heads a CTA would share it and halve the
// per-head dB and dC, which the wrapper sums.  Tried and slower: pass 1
// at eight warps a CTA, deeper copy pipelines or three chunks a step,
// bulk (TMA) stores of its state gradients, and pass 2 leaving out the
// tiles and depth steps its triangular masks zero (warp-uniform branches
// cost more than the work).

// This file must never be built with --use_fast_math.
#include "scan_bwd.cuh"

namespace {

using namespace scan_bwd;

constexpr int kSlice = 16;  // rows of dh a pass-1 CTA holds
constexpr int LS = 24;      // row stride of pass 1's (C, 16) dy slice
constexpr int LR = D + 8;   // row stride of pass 1's (C, 64) C tile

// pass 2: x, dy, B, C tiles; h, dh; G (then M), dM (then dG); cum,
// e^{cum}, e^{cum_C - cum}; dh . h per row; three (4, C) per-warp parts;
// the row sums of W.  Tiles are unpadded and swizzled (scan_bwd.cuh at).
constexpr int kCD = C * D, kDD = D * D, kCCs = C * C;
constexpr int kSmemFloats =
    4 * kCD + 2 * kDD + 2 * kCCs + 3 * C + D + 3 * 4 * C + C;

struct Params {
  const float* x;        // contiguous (B, S, H, P), as dy
  const float* Bm;       // contiguous (B, S, N), as Cm
  const float* Cm;
  const float* da;       // contiguous (B, S, H)
  const float* states;   // contiguous (B, H, nchunks, P, N): the forward's
  const float* dstates;  // (B, H, nchunks, P, N): pass 1's
  const float* dy;
  const float* dh;       // contiguous (B, H, P, N), or null (zero)
  float* dx;             // contiguous (B, S, H, P)
  float* dB;             // contiguous (B, S, H, N): each head's part
  float* dC;
  float* dda;            // contiguous (B, S, H)
  float* dh0;            // contiguous (B, H, P, N)
  float* dst;            // pass 1's output, dstates
  int B, S, H, P, N;
  bool vx, vn;           // 16-byte copies of x/dy rows, of B/C/state rows
};

__global__ void __launch_bounds__(NT) ssd_bwd_dstate_kernel(const Params p) {
  __shared__ __align__(16) float sg[2][C * LS];  // dy[:, p0..p0 + 15]
  __shared__ __align__(16) float sc[2][C * LR];  // C
  __shared__ __align__(16) float sa[2][C];       // da

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int p0 = blockIdx.y * kSlice;
  const int P = p.P, N = p.N, S = p.S, H = p.H;
  const int pr = min(kSlice, P - p0);  // rows of the slice
  const long long xrow = static_cast<long long>(H) * P;
  const float* dyg = p.dy + (static_cast<long long>(b) * S * H + h) * P + p0;
  const float* cg = p.Cm + static_cast<long long>(b) * S * N;
  const float* dag = p.da + static_cast<long long>(b) * S * H + h;
  const int nchunks = (S + C - 1) / C;
  float* out = p.dst + static_cast<long long>(bh) * nchunks * P * N;

  // acc[j] holds dh[p0 + g + 8 (e >> 1)][16 warp + 8 j + 2 q + (e & 1)]
  float acc[2][4];
  const float* dhg = p.dh ? p.dh + static_cast<long long>(bh) * P * N
                          : nullptr;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), n = 16 * warp + 8 * j + 2 * q + (e & 1);
      acc[j][e] = (dhg && r < pr && n < N) ? dhg[(p0 + r) * N + n] : 0.f;
    }
  auto store = [&](float* o) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = g + 8 * hh, n = 16 * warp + 8 * j + 2 * q;
        st_pair(o + (p0 + r) * N + n, acc[j][2 * hh], acc[j][2 * hh + 1],
                r < pr && n < N, r < pr && n + 1 < N);
      }
  };
  auto issue = [&](int c) {
    const int t0 = c * C, rows = min(C, S - t0), st = c & 1;
    load_async<C, kSlice>(sg[st], LS, dyg + t0 * xrow, xrow, rows, pr, p.vx);
    load_async<C, D>(sc[st], LR, cg + static_cast<long long>(t0) * N, N,
                     rows, N, p.vn);
    if (tid < C) {
      const bool ok = tid < rows;
      cp_async4(&sa[st][tid],
                ok ? dag + static_cast<long long>(t0 + tid) * H : dag, ok);
    }
    cp_async_commit();
  };

  issue(nchunks - 1);
  for (int c = nchunks - 1; c >= 0; --c) {
    const int st = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c is in; every warp is done with chunk c + 1
    if (c > 0) issue(c - 1);
    store(out + static_cast<long long>(c) * P * N);  // dh after chunk c

    // cum, e^{cum} and e^{cum_C}, lane t of every warp
    const float cum = scan_up(sa[st][lane]);
    const float ec = expf(cum), el = expf(__shfl_sync(kAll, cum, C - 1));
    // dh <- e^{cum_C} dh + dye^T C: dye^T (rows p, depth t) as the A
    // operand, e^{cum_t} taken from lane t
    float sum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 8) {
      const float e0 = __shfl_sync(kAll, ec, k0 + q);
      const float e1 = __shfl_sync(kAll, ec, k0 + q + 4);
      const float* y0 = sg[st] + (k0 + q) * LS;
      const float* y1 = y0 + 4 * LS;
      FragA<true> fa;
      fa.set(y0[g] * e0, y0[g + 8] * e0, y1[g] * e1, y1[g + 8] * e1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* cc = sc[st] + (k0 + q) * LR + 16 * warp + 8 * j + g;
        FragB<true> fb;
        fb.set(cc[0], cc[4 * LR]);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(part, fa, fb);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[j][e] += part[e];
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = el * acc[j][e] + sum[j][e];
  }
  store(p.dh0 + static_cast<long long>(bh) * P * N);
}

__global__ void __launch_bounds__(NT, 3) ssd_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* tx = sm;            // x, (C, D) swizzled (at<D>)
  float* tg = tx + kCD;      // dy
  float* tB = tg + kCD;      // B
  float* tC = tB + kCD;      // C
  float* sH = tC + kCD;      // the chunk-start state h[p][n], (D, D)
  float* sD = sH + kDD;      // dh[p][n], the gradient after the chunk
  float* tG = sD + kDD;      // G, then M, (C, C) swizzled (at<C>)
  float* tM = tG + kCCs;     // dM, then dG
  float* vcum = tM + kCCs;   // da, then cum
  float* vec = vcum + C;     // e^{cum}
  float* vkd = vec + C;      // e^{cum_C - cum}
  float* vrs = vkd + C;      // (dh . h) of row p
  float* pdk = vrs + D;      // per warp: x_t . (B dh^T)_t
  float* pdc = pdk + 4 * C;  // per warp: C_t . (dye h)_t
  float* pcol = pdc + 4 * C; // per warp: W's column sums over its rows
  float* vrow = pcol + 4 * C;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = p.P, N = p.N, S = p.S, H = p.H;
  const int nchunks = (S + C - 1) / C;
  const int h = blockIdx.x % H, c = blockIdx.x / H % nchunks;
  const int b = blockIdx.x / H / nchunks;
  const int t0 = c * C, rows = min(C, S - t0);
  const long long bh = static_cast<long long>(b) * H + h;
  const long long xrow = static_cast<long long>(H) * P;  // token strides
  const long long nrow = static_cast<long long>(H) * N;
  const long long xoff = ((static_cast<long long>(b) * S + t0) * H + h) * P;
  const long long noff = ((static_cast<long long>(b) * S + t0) * H + h) * N;
  const long long bcoff = (static_cast<long long>(b) * S + t0) * N;
  const long long soff = (bh * nchunks + c) * P * N;
  const auto at64 = [](int r, int cc) { return at<D>(r, cc); };
  const auto at32 = [](int r, int cc) { return at<C>(r, cc); };

  load_async_sw<C, D>(tx, p.x + xoff, xrow, rows, P, p.vx);
  load_async_sw<C, D>(tg, p.dy + xoff, xrow, rows, P, p.vx);
  load_async_sw<C, D>(tB, p.Bm + bcoff, N, rows, N, p.vn);
  load_async_sw<C, D>(tC, p.Cm + bcoff, N, rows, N, p.vn);
  load_async_sw<D, D>(sH, p.states + soff, N, P, N, p.vn);
  load_async_sw<D, D>(sD, p.dstates + soff, N, P, N, p.vn);
  if (tid < C) {
    const bool ok = tid < rows;
    const float* src = p.da + (static_cast<long long>(b) * S + t0) * H + h;
    cp_async4(vcum + tid, ok ? src + static_cast<long long>(tid) * H : src,
              ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // cum by a shuffle scan over warp 0; G = C B^T and dM = dy x^T into
  // shared memory; dh . h per row p
  if (warp == 0) {
    const float cum = scan_up(vcum[lane]);
    const float last = __shfl_sync(kAll, cum, C - 1);
    vcum[lane] = cum;
    vec[lane] = expf(cum);
    vkd[lane] = expf(last - cum);
  }
  {
    float acc[2][4];
    zero(acc);
    mma_frag<C, C, D>(acc, rows_a(tC, at64), rows_b(tB, at64));
    each<C, C>(acc, [&](int r, int s, float& v) { tG[at<C>(r, s)] = v; });
    zero(acc);
    mma_frag<C, C, D>(acc, rows_a(tg, at64), rows_b(tx, at64));
    each<C, C>(acc, [&](int r, int s, float& v) { tM[at<C>(r, s)] = v; });
  }
  {
    const int pp = tid >> 1, n0 = (tid & 1) * (D / 2);
    float a = 0.f;
#pragma unroll 8
    for (int n = n0; n < n0 + D / 2; ++n)
      a = fmaf(sD[at<D>(pp, n)], sH[at<D>(pp, n)], a);
    a += __shfl_xor_sync(kAll, a, 1);
    if ((tid & 1) == 0) vrs[pp] = a;
  }
  __syncthreads();

  // L, then M = G L and dG = dM L in place; W = dG G summed by rows (the
  // four lanes of a row) and by columns (the warp's eight rows of each,
  // its lanes of the same tid & 3)
  {
    const int t = tid >> 2;
    const float ct = vcum[t];
    float rs = 0.f, cs[C / 4];
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      const int s = (tid & 3) + 4 * j;
      const float l = s <= t ? expf(ct - vcum[s]) : 0.f;
      const float gg = tG[at<C>(t, s)], dg = tM[at<C>(t, s)] * l;
      tG[at<C>(t, s)] = gg * l;
      tM[at<C>(t, s)] = dg;
      rs += dg * gg;
      cs[j] = dg * gg;
    }
    rs += __shfl_xor_sync(kAll, rs, 1);
    rs += __shfl_xor_sync(kAll, rs, 2);
    if ((tid & 3) == 0) vrow[t] = rs;
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      float v = cs[j];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(kAll, v, o);
      if (lane < 4) pcol[warp * C + lane + 4 * j] = v;
    }
  }
  __syncthreads();

  // dx = M^T dy + e^{cum_C - cum} (B dh^T); x_t . (B dh^T)_t
  {
    float bd[4][4], acc[4][4];
    zero(bd);
    zero(acc);
    mma_frag<C, D, D>(bd, rows_a(tB, at64), rows_b(sD, at64));
    mma_acc<C, D, C>(acc, [&](int m, int k) { return tG[at<C>(k, m)]; },
                     [&](int k, int n) { return tg[at<D>(k, n)]; });
    float rs[4] = {0.f, 0.f, 0.f, 0.f};
    each_pair<C, D>(bd, acc, [&](int t, int pp, float v0, float v1,
                                 float a0, float a1) {
      rs[t >> 3] = fmaf(tx[at<D>(t, pp)], v0,
                        fmaf(tx[at<D>(t, pp + 1)], v1, rs[t >> 3]));
      st_pair(p.dx + xoff + t * xrow + pp, a0 + vkd[t] * v0,
              a1 + vkd[t] * v1, t < rows && pp < P, t < rows && pp + 1 < P);
    });
    row_parts(pdk, rs);
  }
  // dC = e^{cum} (dy h) + dG B; C_t . (dye h)_t
  {
    float acc[4][4];
    zero(acc);
    mma_frag<C, D, D>(acc, rows_a(tg, at64), elems_b([&](int k, int n) {
                        return sH[at<D>(k, n)];
                      }));
    float rs[4] = {0.f, 0.f, 0.f, 0.f};
    each<C, D>(acc, [&](int t, int n, float& v) {
      v *= vec[t];
      rs[t >> 3] = fmaf(tC[at<D>(t, n)], v, rs[t >> 3]);
    });
    row_parts(pdc, rs);
    mma_frag<C, D, C>(acc, rows_a(tM, at32), elems_b([&](int k, int n) {
                        return tB[at<D>(k, n)];
                      }));
    each_pair<C, D>(acc, acc, [&](int t, int n, float v0, float v1, float,
                                  float) {
      st_pair(p.dC + noff + t * nrow + n, v0, v1, t < rows && n < N,
              t < rows && n + 1 < N);
    });
  }
  // dB = dG^T C + e^{cum_C - cum} (x dh)
  {
    float acc[4][4], xd[4][4];
    zero(acc);
    zero(xd);
    mma_acc<C, D, C>(acc, [&](int m, int k) { return tM[at<C>(k, m)]; },
                     [&](int k, int n) { return tC[at<D>(k, n)]; });
    mma_frag<C, D, D>(xd, rows_a(tx, at64), elems_b([&](int k, int n) {
                        return sD[at<D>(k, n)];
                      }));
    each_pair<C, D>(acc, xd, [&](int s, int n, float v0, float v1, float x0,
                                 float x1) {
      st_pair(p.dB + noff + s * nrow + n, v0 + vkd[s] * x0, v1 + vkd[s] * x1,
              s < rows && n < N, s < rows && n + 1 < N);
    });
  }
  __syncthreads();

  // dcum, and dda by a reverse shuffle scan over warp 0
  if (warp == 0) {
    const int t = lane;
    auto sum4 = [&](const float* part) {
      return (part[t] + part[C + t]) + (part[2 * C + t] + part[3 * C + t]);
    };
    const float kdk = vkd[t] * sum4(pdk);
    float dcum = sum4(pdc) + vrow[t] - sum4(pcol) - kdk;
    const float hs = warp_sum(vrs[t] + vrs[t + C]);
    const float extra = warp_sum(kdk) + vec[C - 1] * hs;
    if (t == C - 1) dcum += extra;
    const float a = scan_down(dcum);
    if (t < rows)
      p.dda[(static_cast<long long>(b) * S + t0 + t) * H + h] = a;
  }
}

Params make_params(const float* x, const float* Bm, const float* Cm,
                   const float* da, const float* states, const float* dstates,
                   const float* dy, const float* dh, float* dx, float* dB,
                   float* dC, float* dda, float* dh0, float* dst, int B,
                   int S, int H, int P, int N) {
  auto al = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const bool vx = P % 4 == 0 && (!x || al(x)) && (!dy || al(dy));
  const bool vn = N % 4 == 0 && (!Bm || al(Bm)) && (!Cm || al(Cm)) &&
                  (!states || al(states)) && (!dstates || al(dstates));
  return Params{x,  Bm,  Cm,  da,  states, dstates, dy, dh, dx, dB,
                dC, dda, dh0, dst, B,      S,       H,  P,  N,  vx, vn};
}

bool bad_dims(int B, int S, int H, int P, int N) {
  const long long grid = static_cast<long long>(B) * H * ((S + C - 1) / C);
  return P < 1 || P > D || N < 1 || N > D || B < 1 || S < 1 || H < 1 ||
         grid > 2147483647LL;
}

constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

}  // namespace

extern "C" {

// Pass 1.  Cm (B, S, N), da (B, S, H), dy (B, S, H, P) and dh (B, H, P,
// N, or null: zero) float32 and contiguous; writes dstates (B, H,
// ceil(S / 32), P, N), the gradient of the state after each chunk, and
// dh0 (B, H, P, N).  Returns the CUDA error of the launch (0 on success).
int ssd_bwd_dstate(const float* Cm, const float* da, const float* dy,
                   const float* dh, float* dstates, float* dh0, int B, int S,
                   int H, int P, int N, void* stream) {
  if (bad_dims(B, S, H, P, N) || static_cast<long long>(B) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(nullptr, nullptr, Cm, da, nullptr, nullptr,
                               dy, dh, nullptr, nullptr, nullptr, nullptr,
                               dh0, dstates, B, S, H, P, N);
  const dim3 grid(B * H, (P + kSlice - 1) / kSlice);
  ssd_bwd_dstate_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2.  x, dy (B, S, H, P), Bm, Cm (B, S, N), da (B, S, H), states
// (the forward's chunk-start states) and dstates (pass 1's), both (B, H,
// ceil(S / 32), P, N), float32 and contiguous; writes dx, dda and each
// head's dB and dC (B, S, H, N).  Returns the CUDA error of the launch.
int ssd_bwd(const float* x, const float* Bm, const float* Cm,
            const float* da, const float* states, const float* dstates,
            const float* dy, float* dx, float* dB, float* dC, float* dda,
            int B, int S, int H, int P, int N, void* stream) {
  if (bad_dims(B, S, H, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(x, Bm, Cm, da, states, dstates, dy, nullptr,
                               dx, dB, dC, dda, nullptr, nullptr, B, S, H, P,
                               N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((S + C - 1) / C);
  ssd_bwd_kernel<<<grid, NT, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// What pass 1 (pass = 1) or pass 2 (pass = 2) takes on the current card:
// what = 0 the CTAs that fit on one SM, 1 the registers a thread, 2 the
// shared memory a CTA (static and dynamic bytes), 3 the threads a CTA;
// minus the CUDA error on failure.  Launches nothing.
int ssd_bwd_attr(int pass, int what) {
  const void* fn =
      pass == 1 ? reinterpret_cast<const void*>(ssd_bwd_dstate_kernel)
                : reinterpret_cast<const void*>(ssd_bwd_kernel);
  const size_t dyn = pass == 1 ? 0 : kSmemBytes;
  cudaError_t err = cudaSuccess;
  if (pass != 1)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, NT, dyn);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return what == 0   ? ctas
         : what == 1 ? attr.numRegs
         : what == 2 ? static_cast<int>(attr.sharedSizeBytes + dyn)
                     : NT;
}

const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
