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
// gradient dy of y and dS_end of the final state (zero when null): dr,
// dk, dv, dlogw (B, S, H, N), du per (batch, head, chunk) (the wrapper
// sums them, with no atomics) and dS_0 (B, H, N, N).  With cum the
// inclusive cumsum of logw down a chunk, cum_prev = cum - logw, rd = r
// e^{cum_prev}, kd = k e^{cum_C - cum}, A the chunk's attention (strictly
// lower pairwise decayed products, the bonus u on the diagonal), S the
// chunk-start state and dS the gradient of the state after the chunk:
//   pass 1 (wkv6_bwd_dstate), in reverse over the chunks from dS_end:
//     dS <- diag(e^{cum_C}) dS + rd^T dy, written after every chunk; dS_0
//   pass 2 (wkv6_bwd), every chunk on its own:
//     dA = dy v^T (its diagonal dd, the bonus's; below it the pairs')
//     dv = A^T dy + kd dS          d(rd) = dy S^T          d(kd) = v dS^T
//     dr_t = d(rd)_t e^{cum_prev_t}
//            + sum_{s<t} dA_ts k_s e^{cum_prev_t - cum_s} + dd_t u k_t,
//            and dk alike; du = sum_t dd_t r_t k_t
//     dcum_prev, dcum from the same terms; dcum_C adds e^{cum_C} (dS . S)
//     dlogw_t = sum_{t' >= t} dcum_t' + sum_{t' > t} dcum_prev_t'
// Every exponent is <= 0, so strong decays cannot overflow: the pairwise
// decays stay pairwise in log space within the diagonal 8 x 8 blocks of a
// chunk, and below them factor through a reference point, as the
// forward's do (below).  Every exp is expf.
//
// What bounds it on an H100: at the rwkv6-3b training microbatch (B*H =
// 40 heads, S = 4096, N = 64) the function moves r, k, v, logw, dy, the
// 128 chunk states a head and the four gradients once (about 0.38 GB,
// 0.11 ms at 3.35 TB/s) and does about 7.2 GFLOP (0.11 ms at 67 TFLOP/s
// fp32).  The only dependence between chunks is the carried dS; this
// design writes it out (a further 84 MB, written by pass 1 and read by
// pass 2) so that everything else runs a CTA a chunk.
//
// Design.
//   * Pass 1: a CTA of eight warps per (batch, head, 16 rows i of dS),
//     160 CTAs at the training shape, looping over the chunks in reverse
//     with its (16, 64) slice of dS in registers as the accumulator tiles
//     of mma.sync (warp w: columns 8 w..8 w + 7), as wkv6.cu holds the
//     forward's state.  A chunk's r and logw (the slice's 16 channels)
//     and dy arrive by cp.async into one of two stages while the
//     previous chunk computes; each warp takes the cumsum of two channels
//     by shuffle scans and writes rd channel by channel, then the one
//     product rd^T dy runs in 3xTF32.  Two barriers a chunk.
//   * Pass 2: a CTA of four warps per (batch, head, chunk), 5,120 CTAs at
//     the training shape with no loop.  r, k, v, dy, logw, S and dS arrive
//     by cp.async into padded f32 tiles; cum is a shuffle scan per
//     channel.  The products run on mma.sync in 3xTF32 with their sums in
//     registers (row tiles loaded by ldmatrix): dA, d(rd) and d(kd) first
//     (held to the end), then dv (written from its accumulators).  A, and
//     the pairwise sums of dr and dk, take the forward's factored form
//     below the diagonal 8 x 8 blocks: with ref = cum at the token before
//     a block of queries (so at or after every key below it),
//       A[t][s]  = sum_i (r_t e^{cum_prev_t - ref}) (k_s e^{ref - cum_s})
//       dr2[t]  += e^{cum_prev_t - ref} (dA[t, K] (k_K e^{ref - cum_K}))
//       dk2[s]  += e^{ref - cum_s} (dA[T, s]^T (r_T e^{cum_prev_T - ref}))
//     (rows 16-31 x keys 0-15 with ref = cum_15; rows 8-15 x keys 0-7
//     with cum_7 and rows 24-31 x keys 16-23 with cum_23, taken as one
//     block-diagonal product), both exponents <= 0, as products on the
//     tensor cores.  Inside the four diagonal blocks a thread per (block,
//     channel) takes each pair's decay e^{cum_prev_t - cum_s} as the
//     product of the tokens' e^{logw} between them (every factor <= 1, no
//     pairwise exp), adds the pairs' terms of dr2 and dk2 on its own, and
//     sums A's pairs over the warp's channels by a reduce-scatter.
//     dlogw's reverse cumsums, du and the column sums of d(kd) kd run in
//     registers: the owner of a column holds all its rows across the
//     lanes of its q.  Four barriers; 104 KiB of shared memory and 161
//     registers, two CTAs (eight warps) an SM.
// fp32 only (training is fp32 in both packages).  scripts/
// scan_bwd_ablation.py times each part of the work.
//
// Left for later: a third CTA an SM (shared memory and registers); pass
// 1's copies and stores a chunk at a time.

// This file must never be built with --use_fast_math.
#include "scan_bwd.cuh"

namespace {

using namespace scan_bwd;

constexpr int kSlice = 16;  // rows i of dS a pass-1 CTA holds
constexpr int NT1 = 256;    // pass 1's eight warps, a column block each
constexpr int LS = kSlice + 4;  // row stride of pass 1's (C, 16) slices
constexpr int LQ = C + 4;   // row stride of pass 1's channel-major rd
constexpr int LR = D + 8;   // row stride of pass 1's (C, 64) dy tile
constexpr int LF = kDT / 4; // a (16, 64) factored operand tile in pass 2

// pass 2: r, k, v (then e^{cum_C - cum}), dy, logw (then cum) tiles; S
// (then the factored operands), dS; the diagonal blocks' dr2, dk2; A, dA;
// u, e^{cum_C} (dS . S); dA's diagonal; each warp's part of A's diagonal
// blocks' pairs
constexpr int kSmemFloats =
    7 * kCT + 2 * kDT + 2 * kCC + 2 * D + C + 8 * 28;

struct Params {
  const float* r;        // contiguous (B, S, H, N), as k, v, logw, dy
  const float* k;
  const float* v;
  const float* logw;
  const float* u;        // contiguous (H, N)
  const float* states;   // contiguous (B, H, nchunks, N, N): the forward's
  const float* dstates;  // (B, H, nchunks, N, N): pass 1's
  const float* dy;
  const float* dstate;   // contiguous (B, H, N, N), or null (zero)
  float* dr;             // contiguous (B, S, H, N), as dk, dv, dlogw
  float* dk;
  float* dv;
  float* dlogw;
  float* du;             // contiguous (B, H, nchunks, N): each chunk's part
  float* dstate0;        // contiguous (B, H, N, N)
  float* dst;            // pass 1's output, dstates
  int B, S, H, N;
  bool vec;              // 16-byte copies of every row
};

__global__ void __launch_bounds__(NT1) wkv6_bwd_dstate_kernel(const Params p) {
  __shared__ __align__(16) float sr[2][C * LS];  // r[t][i0 + i]
  __shared__ __align__(16) float sw[2][C * LS];  // logw, the same
  __shared__ __align__(16) float sg[2][C * LR];  // dy
  __shared__ __align__(16) float rd[kSlice * LQ];  // rd[i][t]
  __shared__ float sel[kSlice];                  // e^{cum_C}

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int i0 = blockIdx.y * kSlice;
  const int N = p.N, S = p.S, H = p.H;
  const int ir = min(kSlice, N - i0);  // rows of the slice
  const long long row = static_cast<long long>(H) * N;  // token stride
  const long long base = (static_cast<long long>(b) * S * H + h) * N;
  const int nchunks = (S + C - 1) / C;
  float* out = p.dst + static_cast<long long>(bh) * nchunks * N * N;

  // acc holds dS[i0 + g + 8 (e >> 1)][8 warp + 2 q + (e & 1)]
  float acc[4];
  const float* dsg = p.dstate ? p.dstate + static_cast<long long>(bh) * N * N
                              : nullptr;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 8 * warp + 2 * q + (e & 1);
    acc[e] = (dsg && r < ir && n < N) ? dsg[(i0 + r) * N + n] : 0.f;
  }
  auto store = [&](float* o) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh, n = 8 * warp + 2 * q;
      st_pair(o + (i0 + r) * N + n, acc[2 * hh], acc[2 * hh + 1],
              r < ir && n < N, r < ir && n + 1 < N);
    }
  };
  auto issue = [&](int c) {
    const int t0 = c * C, rows = min(C, S - t0), st = c & 1;
    const long long o = base + t0 * row;
    load_async<C, kSlice, NT1>(sr[st], LS, p.r + o + i0, row, rows, ir,
                               p.vec);
    load_async<C, kSlice, NT1>(sw[st], LS, p.logw + o + i0, row, rows, ir,
                               p.vec);
    load_async<C, D, NT1>(sg[st], LR, p.dy + o, row, rows, N, p.vec);
    cp_async_commit();
  };

  issue(nchunks - 1);
  for (int c = nchunks - 1; c >= 0; --c) {
    const int st = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c is in; every warp is done with chunk c + 1
    if (c > 0) issue(c - 1);
    store(out + static_cast<long long>(c) * N * N);  // dS after chunk c

    // cum of two channels a warp, lane t: rd = r e^{cum_prev}, channel by
    // channel; e^{cum_C}
#pragma unroll
    for (int cc = 0; cc < kSlice / 8; ++cc) {
      const int i = 2 * warp + cc;
      const float lw = sw[st][lane * LS + i];
      const float cum = scan_up(lw);
      rd[i * LQ + lane] = sr[st][lane * LS + i] * expf(cum - lw);
      if (lane == C - 1) sel[i] = expf(cum);
    }
    __syncthreads();

    // dS <- diag(e^{cum_C}) dS + rd^T dy: rd^T (rows i, depth t) as the A
    // operand
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 8) {
      FragA<true> fa;
      fa.set(rd[g * LQ + k0 + q], rd[(g + 8) * LQ + k0 + q],
             rd[g * LQ + k0 + q + 4], rd[(g + 8) * LQ + k0 + q + 4]);
      const float* yy = sg[st] + (k0 + q) * LR + 8 * warp + g;
      FragB<true> fb;
      fb.set(yy[0], yy[4 * LR]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(part, fa, fb);
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] += part[e];
    }
    const float s0 = sel[g], s1 = sel[g + 8];
    acc[0] = s0 * acc[0] + sum[0];
    acc[1] = s0 * acc[1] + sum[1];
    acc[2] = s1 * acc[2] + sum[2];
    acc[3] = s1 * acc[3] + sum[3];
  }
  store(p.dstate0 + static_cast<long long>(bh) * N * N);
}

// A[t][s] for the queries t0.. (16 rows, or 8 when not ROWS16) and the
// keys s0..s0 + 7, all before t0, in the factored form with ref = cum at
// t0 - 1: both exponents <= 0
template <bool ROWS16>
__device__ __forceinline__ void factored_tile(float* A, const float* tr,
                                              const float* tk,
                                              const float* tc, int t0, int s0,
                                              int g, int q) {
  const int ta = t0 + g, tb = ta + 8, s = s0 + g;
  const float* ref = tc + (t0 - 1) * LT;
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    const int ia = k0 + q, ib = ia + 4;
    float a1 = 0.f, a3 = 0.f;
    if (ROWS16) {
      a1 = tr[tb * LT + ia] * expf(tc[(tb - 1) * LT + ia] - ref[ia]);
      a3 = tr[tb * LT + ib] * expf(tc[(tb - 1) * LT + ib] - ref[ib]);
    }
    FragA<true> fa;
    fa.set(tr[ta * LT + ia] * expf(tc[(ta - 1) * LT + ia] - ref[ia]), a1,
           tr[ta * LT + ib] * expf(tc[(ta - 1) * LT + ib] - ref[ib]), a3);
    FragB<true> fb;
    fb.set(tk[s * LT + ia] * expf(ref[ia] - tc[s * LT + ia]),
           tk[s * LT + ib] * expf(ref[ib] - tc[s * LT + ib]));
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(part, fa, fb);
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] += part[e];
  }
  const int s1 = s0 + 2 * q;
  A[ta * LC + s1] = sum[0];
  A[ta * LC + s1 + 1] = sum[1];
  if (ROWS16) {
    A[tb * LC + s1] = sum[2];
    A[tb * LC + s1 + 1] = sum[3];
  }
}

// One step of a reduce-scatter over the warp: the lanes with bit O of
// their index keep v[O..2 O) and send v[0..O) to their partner, the others
// the reverse, each adding what it gets to what it keeps (in v[0..O)).
// After the steps 16, 8, .., 1, lane l holds the warp's sum of v[l].
template <int O>
__device__ __forceinline__ void scatter_step(float (&v)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int x = 0; x < O; ++x) {
    const float send = up ? v[x] : v[x + O];
    v[x] = (up ? v[x + O] : v[x]) + __shfl_xor_sync(kAll, send, O);
  }
}

// One m16n8 tile of depth 16: d = sum_k a(m, k) b(k, n) at this lane's
// rows g, g + 8 and columns 2 q, 2 q + 1 (b reads column n = g)
template <typename FA, typename FB>
__device__ __forceinline__ void tile16(float (&d)[4], FA a, FB b, int g,
                                       int q) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < 16; k0 += 8) {
    FragA<true> fa;
    fa.set(a(g, k0 + q), a(g + 8, k0 + q), a(g, k0 + q + 4),
           a(g + 8, k0 + q + 4));
    FragB<true> fb;
    fb.set(b(k0 + q, g), b(k0 + q + 4, g));
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(part, fa, fb);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += part[e];
  }
}

__global__ void __launch_bounds__(NT, 2) wkv6_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* tr = sm;          // r
  float* tk = tr + kCT;    // k
  float* tv = tk + kCT;    // v, then e^{cum_C - cum}
  float* tg = tv + kCT;    // dy
  float* tc = tg + kCT;    // logw, then cum
  float* sS = tc + kCT;    // the chunk-start state S[i][j], then the
                           // factored operands fr[2], fk[2]
  float* sD = sS + kDT;    // dS[i][j]
  float* tdr = sD + kDT;   // dr2 of the diagonal blocks
  float* tdk = tdr + kCT;  // dk2 of the diagonal blocks
  float* tA = tdk + kCT;   // A[t][s]
  float* tdA = tA + kCC;   // dA[t][s]
  float* vu = tdA + kCC;   // u
  float* vdl = vu + D;     // e^{cum_C} (dS . S), per channel
  float* vdd = vdl + D;    // dd_t = dA[t][t]
  float* apart = vdd + C;  // [block][half of the channels][28 pairs]
  float* fr = sS;          // [X, Y][16][LT]: r_t e^{cum_prev_t - ref}
  float* fk = sS + 2 * LF; // [X, Y][16][LT]: k_s e^{ref - cum_s}

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int N = p.N, S = p.S, H = p.H;
  const int nchunks = (S + C - 1) / C;
  const int h = blockIdx.x % H, c0 = blockIdx.x / H % nchunks;
  const int b = blockIdx.x / H / nchunks;
  const int t0 = c0 * C, rows = min(C, S - t0);
  const long long bh = static_cast<long long>(b) * H + h;
  const long long row = static_cast<long long>(H) * N;  // token stride
  const long long off = ((static_cast<long long>(b) * S + t0) * H + h) * N;
  const long long soff = (bh * nchunks + c0) * N * N;
  const auto pad = [](int r, int cc) { return r * LT + cc; };

  load_async<C, D>(tr, LT, p.r + off, row, rows, N, p.vec);
  load_async<C, D>(tk, LT, p.k + off, row, rows, N, p.vec);
  load_async<C, D>(tv, LT, p.v + off, row, rows, N, p.vec);
  load_async<C, D>(tg, LT, p.dy + off, row, rows, N, p.vec);
  load_async<C, D>(tc, LT, p.logw + off, row, rows, N, p.vec);
  load_async<D, D>(sS, LT, p.states + soff, N, N, N, p.vec);
  load_async<D, D>(sD, LT, p.dstates + soff, N, N, N, p.vec);
  if (tid < D) {
    const bool ok = tid < N;
    cp_async4(vu + tid, ok ? p.u + h * N + tid : p.u, ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // cum in place, a warp per 16 channels, lane t; dA = dy v^T; d(rd) = dy
  // S^T and d(kd) = v dS^T, held in registers to the end; dS . S per row
#pragma unroll 4
  for (int cc = 0; cc < D / 4; ++cc) {
    const int i = 16 * warp + cc;
    tc[lane * LT + i] = scan_up(tc[lane * LT + i]);
  }
  {
    float acc[2][4];
    zero(acc);
    mma_frag<C, C, D>(acc, rows_a(tg, pad), rows_b(tv, pad));
    each<C, C>(acc, [&](int t, int s, float& v) { tdA[t * LC + s] = v; });
  }
  float drd[4][4], dkd[4][4];
  zero(drd);
  zero(dkd);
  mma_frag<C, D, D>(drd, rows_a(tg, pad), rows_b(sS, pad));
  mma_frag<C, D, D>(dkd, rows_a(tv, pad), rows_b(sD, pad));
  {
    const int i = tid >> 1, j0 = (tid & 1) * (D / 2);
    float a = 0.f;
#pragma unroll 8
    for (int j = j0; j < j0 + D / 2; ++j)
      a = fmaf(sD[i * LT + j], sS[i * LT + j], a);
    a += __shfl_xor_sync(kAll, a, 1);
    if ((tid & 1) == 0) vdl[i] = a;
  }
  __syncthreads();

  // dlast, dd; e^{cum_C - cum} over v; the factored operands over S
  if (tid < D) vdl[tid] *= expf(tc[(C - 1) * LT + tid]);
  if (tid < C) vdd[tid] = tdA[tid * LC + tid];
  for (int e = tid; e < C * D; e += NT) {
    const int t = e / D, i = e % D;
    tv[t * LT + i] = expf(tc[(C - 1) * LT + i] - tc[t * LT + i]);
  }
  // slot X (0): queries 16 + m, keys m, ref = cum_15; slot Y (1): queries
  // 8 + m, keys m, ref = cum_7 for m < 8, queries 16 + m, keys 8 + m, ref
  // = cum_23 for m >= 8
  for (int e = tid; e < 2 * 16 * D; e += NT) {
    const int slot = e / (16 * D), m = e / D % 16, i = e % D;
    const int tq = slot == 0 ? 16 + m : (m < 8 ? 8 + m : 16 + m);
    const int sk = slot == 0 ? m : (m < 8 ? m : 8 + m);
    const int rt = slot == 0 ? 15 : (m < 8 ? 7 : 23);
    const float ref = tc[rt * LT + i];
    fr[slot * LF + m * LT + i] =
        tr[tq * LT + i] * expf(tc[(tq - 1) * LT + i] - ref);
    fk[slot * LF + m * LT + i] =
        tk[sk * LT + i] * expf(ref - tc[sk * LT + i]);
  }
  // A: zero above the diagonal; below the diagonal blocks factored (warps
  // 0 and 1 rows 16-31 x keys 8 w.., warp 2 rows 8-15 x keys 0-7, warp 3
  // rows 24-31 x keys 16-23)
  for (int e = tid; e < C * C; e += NT)
    if (e % C > e / C) tA[e / C * LC + e % C] = 0.f;
  if (warp < 2)
    factored_tile<true>(tA, tr, tk, tc, 16, 8 * warp, g, q);
  else
    factored_tile<false>(tA, tr, tk, tc, warp == 2 ? 8 : 24,
                         warp == 2 ? 0 : 16, g, q);
  // A's bonus diagonal, four threads an entry
  {
    const int t = tid >> 2, ib = (tid & 3) * (D / 4);
    float a = 0.f;
#pragma unroll 4
    for (int i = ib; i < ib + D / 4; ++i)
      a = fmaf(tr[t * LT + i] * tk[t * LT + i], vu[i], a);
    a += __shfl_xor_sync(kAll, a, 1);
    a += __shfl_xor_sync(kAll, a, 2);
    if ((tid & 3) == 0) tA[t * LC + t] = a;
  }
  // The diagonal 8 x 8 blocks pairwise, a thread per (block, channel i)
  // holding the block's 8 rows: the decay of the pair (t, s < t) is
  // e^{cum_prev_t - cum_s} = prod_{s < v < t} w_v with w_v = e^{logw_v}
  // (every factor <= 1), one exp a token.  dr2 and dk2 of the pairs go
  // to their tiles; A's 28 pairs are summed over the warp's 32 channels by
  // a reduce-scatter (lane x ends with pair x), the two warps' parts of a
  // block in order after the barrier.
#pragma unroll 1
  for (int it = 0; it < 2; ++it) {
    const int item = tid + NT * it, blk = item / D, i = item % D;
    const int tb = 8 * blk;
    float rr[8], kk[8], w[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      rr[u] = tr[(tb + u) * LT + i];
      kk[u] = tk[(tb + u) * LT + i];
      w[u] = u == 0 ? 0.f
                    : expf(tc[(tb + u) * LT + i] - tc[(tb + u - 1) * LT + i]);
    }
    float v[32], dr8[8], dk8[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) dr8[u] = dk8[u] = 0.f;
#pragma unroll
    for (int x = 28; x < 32; ++x) v[x] = 0.f;
#pragma unroll
    for (int t = 1; t < 8; ++t) {
      float e = 1.f;  // the decay of (t, s2 = t - d)
#pragma unroll
      for (int d = 1; d < 8; ++d) {
        const int s2 = t - d;
        if (s2 < 0) continue;
        const float de = tdA[(tb + t) * LC + tb + s2] * e;
        v[t * (t - 1) / 2 + s2] = rr[t] * kk[s2] * e;
        dr8[t] = fmaf(de, kk[s2], dr8[t]);
        dk8[s2] = fmaf(de, rr[t], dk8[s2]);
        e *= w[s2];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      tdr[(tb + u) * LT + i] = dr8[u];
      tdk[(tb + u) * LT + i] = dk8[u];
    }
    scatter_step<16>(v, lane);
    scatter_step<8>(v, lane);
    scatter_step<4>(v, lane);
    scatter_step<2>(v, lane);
    scatter_step<1>(v, lane);
    if (lane < 28) apart[(2 * blk + i / 32) * 28 + lane] = v[0];
  }
  __syncthreads();

  // A's diagonal blocks from the two warps' parts, in order; dr2 and dk2:
  // the diagonal blocks' from their tiles, then below the diagonal blocks
  // factored: this warp's columns 8 nt.., nt = warp, warp + 4 (tiles jn
  // and 2 + jn: rows 0-15 and 16-31)
  if (tid < 4 * 28) {
    const int blk = tid / 28, x = tid % 28;
    int t = 1;
    while ((t + 1) * t / 2 <= x) ++t;
    tA[(8 * blk + t) * LC + 8 * blk + x - t * (t - 1) / 2] =
        apart[2 * blk * 28 + x] + apart[(2 * blk + 1) * 28 + x];
  }
  float d2r[4][4], d2k[4][4];
  each2<C, D>(d2r, d2k, [&](int t, int i, float& a, float& b) {
    a = tdr[t * LT + i];
    b = tdk[t * LT + i];
  });
#pragma unroll
  for (int jn = 0; jn < 2; ++jn) {
    const int n0 = 8 * (warp + 4 * jn);
    const int i0 = n0 + 2 * q;  // this lane's two columns
    auto cumv = [&](int t, int e) { return tc[t * LT + i0 + (e & 1)]; };
    auto col = [&](const float* f) {
      return [=](int k, int n) { return f[k * LT + n0 + n]; };
    };
    float pt[4];
    // dr2: queries 16 + m (ref cum_15) against keys 0..15 ...
    tile16(pt, [&](int m, int k) { return tdA[(16 + m) * LC + k]; },
           col(fk), g, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 16 + g + 8 * (e >> 1);
      d2r[2 + jn][e] += expf(cumv(t - 1, e) - cumv(15, e)) * pt[e];
    }
    // ... and queries 8 + m (cum_7), 16 + m (cum_23) against their keys
    tile16(pt, [&](int m, int k) {
             return (m < 8) != (k < 8) ? 0.f
                    : m < 8            ? tdA[(8 + m) * LC + k]
                                       : tdA[(16 + m) * LC + 8 + k];
           },
           col(fk + LF), g, q);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      d2r[jn][2 + e] += expf(cumv(7 + g, e) - cumv(7, e)) * pt[e];
      d2r[2 + jn][2 + e] +=
          expf(cumv(23 + g, e) - cumv(23, e)) * pt[2 + e];
    }
    // dk2: keys m (ref cum_15) against queries 16..31 ...
    tile16(pt, [&](int m, int k) { return tdA[(16 + k) * LC + m]; },
           col(fr), g, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = g + 8 * (e >> 1);
      d2k[jn][e] += expf(cumv(15, e) - cumv(s, e)) * pt[e];
    }
    // ... and keys m < 8 (cum_7), 16 + (m - 8) (cum_23) against theirs
    tile16(pt, [&](int m, int k) {
             return (m < 8) != (k < 8) ? 0.f
                    : m < 8            ? tdA[(8 + k) * LC + m]
                                       : tdA[(16 + k) * LC + 8 + m];
           },
           col(fr + LF), g, q);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      d2k[jn][e] += expf(cumv(7, e) - cumv(g, e)) * pt[e];
      d2k[2 + jn][e] += expf(cumv(23, e) - cumv(16 + g, e)) * pt[2 + e];
    }
  }
  __syncthreads();

  // dv = A^T dy + kd dS, written from the accumulators
  {
    float acc[4][4];
    zero(acc);
    mma_acc<C, D, C>(acc, [&](int m, int k) { return tA[k * LC + m]; },
                     [&](int k, int n) { return tg[k * LT + n]; });
    mma_acc<C, D, D>(
        acc, [&](int m, int k) { return tk[m * LT + k] * tv[m * LT + k]; },
        [&](int k, int n) { return sD[k * LT + n]; });
    each_pair<C, D>(acc, acc, [&](int s, int j, float v0, float v1, float,
                                  float) {
      st_pair(p.dv + off + s * row + j, v0, v1, s < rows && j < N,
              s < rows && j + 1 < N);
    });
  }
  // dr and dk out; then, for the thread's columns i0, i0 + 1 (its rows t
  // = 8 b4 + g, its lanes g = 0..7 of the same q hold the rest of each
  // column): du, dcum and dcum_prev, and dlogw by a reverse scan, within
  // each 8-row block over the lanes g, then the later blocks' totals
#pragma unroll
  for (int jn = 0; jn < 2; ++jn) {
    const int i0 = 8 * (warp + 4 * jn) + 2 * q;
    float dcp[2][4], dcum[2][4], pk[2] = {0.f, 0.f}, du[2] = {0.f, 0.f};
#pragma unroll
    for (int b4 = 0; b4 < 4; ++b4) {
      const int j = 2 * (b4 >> 1) + jn, t = 8 * b4 + g;
      float dr[2], dk[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + c, e = 2 * (b4 & 1) + c;
        const float ecp = t > 0 ? expf(tc[(t - 1) * LT + i]) : 1.f;
        const float ek = tv[t * LT + i];
        const float rt = tr[t * LT + i], kt = tk[t * LT + i];
        const float bon = vdd[t] * vu[i];
        dr[c] = drd[j][e] * ecp + d2r[j][e] + bon * kt;
        dk[c] = dkd[j][e] * ek + d2k[j][e] + bon * rt;
        const float pkt = dkd[j][e] * (kt * ek);
        dcp[c][b4] = drd[j][e] * rt * ecp + rt * d2r[j][e];
        dcum[c][b4] = -pkt - kt * d2k[j][e];
        pk[c] += pkt;
        du[c] = fmaf(vdd[t], rt * kt, du[c]);
      }
      st_pair(p.dr + off + t * row + i0, dr[0], dr[1], t < rows && i0 < N,
              t < rows && i0 + 1 < N);
      st_pair(p.dk + off + t * row + i0, dk[0], dk[1], t < rows && i0 < N,
              t < rows && i0 + 1 < N);
    }
    float dl[2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        pk[c] += __shfl_xor_sync(kAll, pk[c], o);
        du[c] += __shfl_xor_sync(kAll, du[c], o);
      }
      if (g == 7) dcum[c][3] += pk[c] + vdl[i0 + c];
      float sfx[4], tot[4];
#pragma unroll
      for (int b4 = 0; b4 < 4; ++b4) {
        float x = dcum[c][b4] + dcp[c][b4];
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          const float y = __shfl_down_sync(kAll, x, 4 * o);
          if (g + o < 8) x += y;
        }
        sfx[b4] = x;
        tot[b4] = __shfl_sync(kAll, x, q);
      }
      float later = 0.f;
#pragma unroll
      for (int b4 = 3; b4 >= 0; --b4) {
        dl[c][b4] = sfx[b4] + later - dcp[c][b4];
        later += tot[b4];
      }
    }
    if (g == 0)
      st_pair(p.du + (bh * nchunks + c0) * N + i0, du[0], du[1], i0 < N,
              i0 + 1 < N);
#pragma unroll
    for (int b4 = 0; b4 < 4; ++b4) {
      const int t = 8 * b4 + g;
      st_pair(p.dlogw + off + t * row + i0, dl[0][b4], dl[1][b4],
              t < rows && i0 < N, t < rows && i0 + 1 < N);
    }
  }
}

Params make_params(const float* r, const float* k, const float* v,
                   const float* logw, const float* u, const float* states,
                   const float* dstates, const float* dy,
                   const float* dstate, float* dr, float* dk, float* dv,
                   float* dlogw, float* du, float* dstate0, float* dst, int B,
                   int S, int H, int N) {
  bool vec = N % 4 == 0;
  for (const float* ptr : {r, k, v, logw, states, dstates, dy})
    vec = vec && (!ptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0);
  return Params{r,  k,     v,  logw,    u,   states, dstates,
                dy, dstate, dr, dk,      dv,  dlogw,  du,
                dstate0,    dst, B,       S,   H,      N,       vec};
}

bool bad_dims(int B, int S, int H, int N) {
  const long long grid = static_cast<long long>(B) * H * ((S + C - 1) / C);
  return N < 1 || N > D || B < 1 || S < 1 || H < 1 || grid > 2147483647LL;
}

constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

}  // namespace

extern "C" {

// Pass 1.  r, logw, dy (B, S, H, N) and dstate (B, H, N, N, or null:
// zero) float32 and contiguous; writes dstates (B, H, ceil(S / 32), N,
// N), the gradient of the state after each chunk, and dstate0 (B, H, N,
// N).  Returns the CUDA error of the launch (0 on success).
int wkv6_bwd_dstate(const float* r, const float* logw, const float* dy,
                    const float* dstate, float* dstates, float* dstate0,
                    int B, int S, int H, int N, void* stream) {
  if (bad_dims(B, S, H, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p =
      make_params(r, nullptr, nullptr, logw, nullptr, nullptr, nullptr, dy,
                  dstate, nullptr, nullptr, nullptr, nullptr, nullptr,
                  dstate0, dstates, B, S, H, N);
  const dim3 grid(B * H, (N + kSlice - 1) / kSlice);
  wkv6_bwd_dstate_kernel<<<grid, NT1, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2.  r, k, v, logw, dy (B, S, H, N), u (H, N), states (the
// forward's chunk-start states) and dstates (pass 1's), both (B, H,
// ceil(S / 32), N, N), float32 and contiguous; writes dr, dk, dv, dlogw
// and du (B, H, ceil(S / 32), N), each chunk's part.  Returns the CUDA
// error of the launch.
int wkv6_bwd(const float* r, const float* k, const float* v,
             const float* logw, const float* u, const float* states,
             const float* dstates, const float* dy, float* dr, float* dk,
             float* dv, float* dlogw, float* du, int B, int S, int H, int N,
             void* stream) {
  if (bad_dims(B, S, H, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(r, k, v, logw, u, states, dstates, dy, nullptr,
                               dr, dk, dv, dlogw, du, nullptr, nullptr, B, S,
                               H, N);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B * H * ((S + C - 1) / C);
  wkv6_bwd_kernel<<<grid, NT, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// What pass 1 (pass = 1) or pass 2 (pass = 2) takes on the current card:
// what = 0 the CTAs that fit on one SM, 1 the registers a thread, 2 the
// shared memory a CTA (static and dynamic bytes), 3 the threads a CTA;
// minus the CUDA error on failure.  Launches nothing.
int wkv6_bwd_attr(int pass, int what) {
  const void* fn =
      pass == 1 ? reinterpret_cast<const void*>(wkv6_bwd_dstate_kernel)
                : reinterpret_cast<const void*>(wkv6_bwd_kernel);
  const size_t dyn = pass == 1 ? 0 : kSmemBytes;
  cudaError_t err = cudaSuccess;
  if (pass != 1)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, fn, pass == 1 ? NT1 : NT, dyn);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return what == 0   ? ctas
         : what == 1 ? attr.numRegs
         : what == 2 ? static_cast<int>(attr.sharedSizeBytes + dyn)
                     : pass == 1 ? NT1 : NT;
}

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
