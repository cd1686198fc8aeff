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
// 4, hd = 128, causal) that is 301 GFLOP: 0.30 ms on the bf16 tensor cores
// at 989 TFLOP/s, 0.61 ms in TF32 at 495 (1.8 ms for the three TF32
// products of 3xTF32), 4.5 ms of FFMA at 67 fp32, against 269 MB of fp32
// q, k, v, o, dO, lse and gradients (0.08 ms at 3.35 TB/s).
//
// Three kernels on one stream, in both dtypes:
//  * flash_bwd_delta_kernel: D = rowsum(dO o O), one warp per row (bound
//    by bytes, near 70% of the card's rate at the trainer's shape; 16-byte
//    loads measured no faster; a separate launch, not fused into the dQ
//    kernel's prologue, because the dK/dV kernel needs D of every query
//    tile it visits).
//  * dK/dV: one CTA per (batch, KV head, 64-key tile).  K and V stay in
//    shared memory; the CTA loops over the G query heads and the 64-row
//    query tiles that can see its keys.  Its two halves split the
//    products: one forms S^T = K Q^T and P^T = exp(S^T - lse) and adds P^T
//    dO into dV; the other forms dP^T = V dO^T, takes P^T through shared
//    memory, forms dS^T = P^T (dP^T - D) and adds dS^T Q into dK.  Each
//    half holds one gradient tile and one logit tile, which keeps the
//    registers in bounds, and 64-key CTAs (twice as many as 128-key ones)
//    balance the causal work: the first key tile sees every query tile,
//    the last one only its own.
//  * dQ: one CTA per (batch, head, 128-row query tile), looping over the
//    64-key tiles its rows see: S = Q K^T, dP = dO V^T, dQ += dS K.
// S and dP are computed in both (7 products where the bound counts 5, 1.4x
// its operations).  In exchange every output element has one owner and
// every sum runs in a fixed order: no atomics, no second pass over a dQ
// accumulator, and two calls give the same bits (the trainer's resumed
// step is checked bitwise against the uninterrupted one).
//
// bf16: wgmma on the tensor cores, fed by TMA (flash_bwd_*_wgmma_kernel),
// FlashAttention-3's backward at its simplest.  A CTA is 2 consumer
// warpgroups and a producer warp, which streams the tiles through a
// 3-stage ring guarded by full/empty mbarriers: (Q, dO) tiles
// of each (head, query tile) by TMA, with their lse and D written by its
// lanes, for dK/dV (K and V loaded once); K and V tiles for dQ (Q and dO
// loaded once, each consumer warpgroup owning 64 rows).  S^T = K Q^T and
// dP^T = V dO^T (dK/dV), S = Q K^T and dP = dO V^T (dQ) are wgmma
// m64n64k16 from shared memory, both operands K-major; P and dS are packed
// to bf16 in the accumulator layout, which is wgmma's register-A layout,
// and dV += P^T dO, dK += dS^T Q, dQ += dS K take them from registers with
// dO, Q and K as MN-major B operands (the transpose bit).  The dK/dV
// warpgroups pass P^T (fp32) through two shared-memory tiles under named
// barriers.  The head dim is padded to 64 or 128 by the tensor maps' zero
// fill, as in the forward.  P and dS are rounded to bf16 once
// (FlashAttention-3 does the same): the CPU model of this arithmetic
// (tests/test_torch_attention_grad.py) stays within 0.7% of each
// gradient's max of the plain bf16 version and 0.4 bf16 roundings (+1% of
// the max) of the fp32 gradients, so no hi + lo split.  dO that TMA cannot
// read (a misaligned pointer, odd strides) is copied by the wrapper first.
//
// fp32: 3xTF32 on mma.sync m16n8k8 (flash_bwd_*_mma_kernel; tf32_mma.cuh).
// wgmma takes tf32 operands from shared memory only K-major (no
// transpose bit), and dV = P^T dO, dK = dS^T Q, dQ = dS K need MN-major B
// operands; mma.sync fed by the kernel's own shared-memory loads has no
// such limit.  A CTA is 8 warps of 16 rows: keys for dK/dV (warps w and w
// + 4 share them and split the products as above), queries for dQ.  A
// warp holds its 16 x 64 logit tiles and its 16 x D gradient tile in
// registers, takes P and dS as the A operand straight from the
// accumulator layout, and splits every operand into TF32 hi + lo (error
// near 2^-21 of each product; one TF32 product would miss the 1e-4
// tolerance: see the CPU model).  The tensor cores accumulate with
// truncation, so a gradient tile is not one chain of mma over every tile
// the CTA visits: each tile's products accumulate in fresh registers and
// are added in fp32 (gemm_pb).  Rows have a stride of D + 4 floats, so
// every fragment read is conflict-free.  The S and dP products read both
// operands along their rows (the reduction runs over the head dim), by
// ldmatrix, 4 values a lane an instruction (3% faster than 32-bit loads
// on the card); the gradient products read B down its columns, by 32-bit
// loads (ldmatrix's transpose moves 16-bit values).  dK/dV streams (Q,
// dO, lse, D) through two stages by cp.async (215 KiB at D = 128); dQ's
// 128 rows of Q and dO leave room for one K/V tile (198 KiB), and the
// next tile's V loads while the current one's last product runs.  The
// head dim is padded to 16, 32, 64, 96 or 128.
//
// This file must never be built with --use_fast_math.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "tf32_mma.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int kKeys = 64;   // keys a dK/dV CTA owns
constexpr int kRows = 128;  // query rows a dQ CTA owns
constexpr int kBS = 64;     // a streamed tile: query rows (dK/dV) or keys (dQ)
constexpr int kDeltaThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// which kernels a call launches
constexpr int kDelta = 1, kDkdv = 2, kDq = 4;

// fp32 operands that allow 16-byte copies (bit per operand)
constexpr int kVecQ = 1, kVecK = 2, kVecV = 4, kVecD = 8;

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
  int vec;     // fp32: kVec* bits
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.T && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// Whether a mask hides some (query, key) of rows [q0, q0 + nq) x keys
// [k0, k0 + nk), so the block needs the per-element mask.  Rows past S
// need none: their lse is -inf.
__device__ __forceinline__ bool block_masked(const Params& p, int q0, int nq,
                                             int k0, int nk) {
  return k0 + nk > p.T || (p.causal && k0 + nk - 1 > q0) ||
         (p.window > 0 && q0 + nq - 1 - k0 >= p.window);
}

// Whether the masks hide every (query, key) of the block.
__device__ __forceinline__ bool block_dead(const Params& p, int q0, int nq,
                                           int k0, int nk) {
  return k0 >= p.T || (p.causal && k0 > q0 + nq - 1) ||
         (p.window > 0 && q0 - (k0 + nk - 1) >= p.window);
}

// The kBS-row query tiles [lo, hi) that see a key of [k0, min(k0 + n, T)).
__device__ __forceinline__ void query_tiles(const Params& p, int k0, int n,
                                            int& lo, int& hi) {
  const int kmax = min(k0 + n, p.T) - 1;
  const int qlo = p.causal ? k0 : 0;
  const int qhi = p.window > 0 ? min(p.S, kmax + p.window) : p.S;
  lo = qlo / kBS;
  hi = qhi > qlo ? (qhi + kBS - 1) / kBS : lo;
}

// The kBS-key tiles [lo, hi) that rows [q0, q0 + n) see.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int n,
                                          int& lo, int& hi) {
  const int khi = p.causal ? min(q0 + n, p.T) : p.T;
  const int klo = p.window > 0 ? max(q0 + 1 - p.window, 0) : 0;
  lo = klo / kBS;
  hi = khi > klo ? (khi + kBS - 1) / kBS : lo;
}

// lse in the log2 domain (-inf stays -inf) and D of query row s of (b, h);
// a row past S gets -inf and 0, so its p is 0.
__device__ __forceinline__ float2 row_stats(const Params& p, int b, int h,
                                            int s) {
  if (s >= p.S) return make_float2(-INFINITY, 0.f);
  const long long i = (static_cast<long long>(b) * p.H + h) * p.S + s;
  const float l = p.lse[i];
  return make_float2(l == -INFINITY ? -INFINITY : l * kLog2e, p.delta[i]);
}

// p = 2^(s c - l2) where the key is visible and the row live, else 0.
__device__ __forceinline__ float prob(float s, bool keep, float c, float l2) {
  return keep && l2 != -INFINITY ? sm90::ex2(fmaf(s, c, -l2)) : 0.f;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// D = rowsum(dO o O): one warp per (batch, row, head).
template <typename T>
__global__ void flash_bwd_delta_kernel(const Params p) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kDeltaThreads / 32) + threadIdx.x / 32;
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

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

namespace mma {

using namespace tf32;

constexpr int kThreads = 256;  // 8 warps of 16 rows

template <int D>
struct Layout {
  // row stride: 4 or 20 banks apart, so the 8 rows x 4 columns a fragment
  // read touches (or 4 row pairs x 8 columns) hit 32 distinct banks
  static constexpr int kS = D + 4;
  static constexpr int kTile = kBS * kS;  // 64 rows
  // dK/dV: K and V, two stages of (Q, dO, lse, D), P^T: 215 KiB at D = 128
  static constexpr int kStage = 2 * kTile + 2 * kBS;
  static constexpr int kDkdv = 2 * kTile + 2 * kStage + kKeys * kBS;
  // dQ: Q and dO (128 rows), one K and V tile: 198 KiB at D = 128
  static constexpr int kDq = 4 * kTile + 2 * kTile;
};

// Rows [r0, r0 + ROWS) of a (n, hd) slab with row stride rs into shared
// memory (row stride D + 4), by cp.async; rows >= n and columns >= hd are
// zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int r0, int n, int hd,
                                          bool vec) {
  constexpr int kS = Layout<D>::kS;
  if (vec) {
    constexpr int kC = D / 4;
    for (int i = threadIdx.x; i < ROWS * kC; i += kThreads) {
      const int r = i / kC, c = (i % kC) * 4;
      const bool ok = r0 + r < n && c < hd;
      cp_async16(dst + r * kS + c, ok ? src + (r0 + r) * rs + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = r0 + r < n && c < hd;
      cp_async4(dst + r * kS + c, ok ? src + (r0 + r) * rs + c : src, ok);
    }
  }
}

// Four 8 x 4 fp32 blocks (8 x 8 of b16) from shared memory in one
// instruction: lane l gives the address of row l % 8 of block l / 8 and
// gets element (lane / 4, lane % 4) of each block.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

// acc = A B^T over D for one warp: A its 16 rows (at a), B the NT * 8 rows
// of a tile, both with the reduction along their columns (the k order q,
// q + 4), their fragments loaded by ldmatrix (rows of D + 4 floats fall
// on distinct 16-byte bank groups).  acc[nt] is the 16 x 8 tile of B's
// rows 8 nt ...
template <int D, int NT>
__device__ __forceinline__ void gemm_abt(float (&acc)[NT][4], const float* a,
                                         const float* b, int lane) {
  constexpr int kS = Layout<D>::kS;
  static_assert(NT % 2 == 0, "B fragments come two tiles at a time");
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // A: blocks (rows 0-7 | 8-15) x (columns 0-3 | 4-7) give a0, a1, a2, a3;
  // B: blocks (columns 0-3 | 4-7) x (tile nt | nt + 1) give b0, b1 of each
  const int blk = lane / 8, r = lane % 8;
  const float* ar = a + (r + 8 * (blk & 1)) * kS + 4 * (blk >> 1);
  const float* br = b + (r + 8 * (blk >> 1)) * kS + 4 * (blk & 1);
#pragma unroll 2
  for (int k = 0; k < D; k += 8) {
    uint32_t u[4];
    ldsm_x4(u, ar + k);
    FragA<true> fa;
    fa.set(__uint_as_float(u[0]), __uint_as_float(u[1]),
           __uint_as_float(u[2]), __uint_as_float(u[3]));
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      ldsm_x4(u, br + 8 * nt * kS + k);
      FragB<true> f0, f1;
      f0.set(__uint_as_float(u[0]), __uint_as_float(u[1]));
      f1.set(__uint_as_float(u[2]), __uint_as_float(u[3]));
      mma3(acc[nt], fa, f0);
      mma3(acc[nt + 1], fa, f1);
    }
  }
}

// acc += P B for one warp: P (16 x 8 KT) in the accumulator layout (p[kt]
// the tile of columns 8 kt ..), B a (8 KT, D) tile with the reduction
// along its rows (the k order 2q, 2q + 1, under which the accumulator
// layout is the A layout).  The products of each group of NG output tiles
// accumulate in fresh registers (a chain of 3 KT mma) and are then added
// into acc in fp32: the tensor cores' accumulation truncates, and the
// dK/dV sums over every query tile of G heads, thousands of mma in one
// chain, would lose about 1e-4 of their size (measured on the card at the
// trainer's shape: 1.8e-4 of the gradients' max).
template <int D, int KT>
__device__ __forceinline__ void gemm_pb(float (&acc)[D / 8][4],
                                        const float (&p)[KT][4],
                                        const float* b, int lane) {
  constexpr int kS = Layout<D>::kS;
  constexpr int NT = D / 8;
  constexpr int NG = NT % 8 == 0 ? 8 : NT % 4 == 0 ? 4 : 2;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += NG) {
    float part[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      FragA<true> fa;
      fa.set(p[kt][0], p[kt][2], p[kt][1], p[kt][3]);
      const float* br = b + (8 * kt + 2 * q) * kS + 8 * n0 + g;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        FragB<true> fb;
        fb.set(br[8 * j], br[kS + 8 * j]);
        mma3(part[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + j][e] += part[j][e];
  }
}

// A warp's 16 x D gradient tile (rows r0 + g, r0 + g + 8; columns 8 nt +
// 2 q + e) times `scale` into a contiguous (.., rows, heads, hd) tensor:
// row r of head `head` at ((b * n + r) * heads + head) * hd.
template <int D>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[D / 8][4],
                                           float scale, int b, int n,
                                           int heads, int head, int hd,
                                           int r0, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r >= n) continue;
    float* row =
        out + ((static_cast<long long>(b) * n + r) * heads + head) * hd;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * nt + 2 * q + e;
        if (c < hd) row[c] = acc[nt][2 * hh + e] * scale;
      }
  }
}

// One CTA per (batch, KV head, 64 keys); warps w and w + 4 share keys k0 +
// 16 (w % 4).  Warps 0-3 form S^T = K Q^T and P^T and add P^T dO into dV;
// warps 4-7 form dP^T = V dO^T, take P^T from shared memory, and add
// dS^T Q into dK.  The (Q, dO, lse, D) of each (head, query tile) stream
// through two stages: the next one loads while this one computes.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_mma_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::kTile;
  float* stages = Vs + L::kTile;  // Q, dO, lse (log2 domain), D
  float* Ps = stages + 2 * L::kStage;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const bool dv_warp = warp < 4;
  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x % p.KV;
  const int G = p.H / p.KV;
  const int k0 = blockIdx.y * kKeys;      // causal: the heaviest tiles first
  const int kw0 = k0 + 16 * (warp % 4);  // this warp's keys
  const float c = p.scale * kLog2e;

  const float* kg = static_cast<const float*>(p.k) + b * p.sk_b + kvh * p.sk_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv_b + kvh * p.sv_h;
  load_rows<D, kKeys>(Ks, kg, p.sk_t, k0, p.T, p.hd, p.vec & kVecK);
  load_rows<D, kKeys>(Vs, vg, p.sv_t, k0, p.T, p.hd, p.vec & kVecV);

  // items: (head kvh G + i / nq, query tile qt_lo + i % nq)
  int qt_lo, qt_hi;
  query_tiles(p, k0, kKeys, qt_lo, qt_hi);
  const int nq = qt_hi - qt_lo;
  const int n_items = G * nq;
  auto load_item = [&](int i) {
    const int h = kvh * G + i / nq, q0 = (qt_lo + i % nq) * kBS;
    float* st = stages + (i & 1) * L::kStage;
    load_rows<D, kBS>(st, static_cast<const float*>(p.q) + b * p.sq_b +
                              h * p.sq_h,
                      p.sq_s, q0, p.S, p.hd, p.vec & kVecQ);
    load_rows<D, kBS>(st + L::kTile, static_cast<const float*>(p.dout) +
                                         b * p.sd_b + h * p.sd_h,
                      p.sd_s, q0, p.S, p.hd, p.vec & kVecD);
    for (int r = threadIdx.x; r < kBS; r += kThreads) {
      const float2 rs = row_stats(p, b, h, q0 + r);
      st[2 * L::kTile + r] = rs.x;
      st[2 * L::kTile + kBS + r] = rs.y;
    }
  };
  if (n_items > 0) load_item(0);
  cp_async_commit();

  float acc[D / 8][4];  // dV (warps 0-3) or dK (warps 4-7)
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // this thread's P^T values in the exchange tile
  float* pt = Ps + (warp % 4) * 32 * 32 + lane;

  for (int it = 0; it < n_items; ++it) {
    const int q0 = (qt_lo + it % nq) * kBS;
    const float* Qs = stages + (it & 1) * L::kStage;
    const float* dOs = Qs + L::kTile;
    const float* lse_s = dOs + L::kTile;
    const float* delta_s = lse_s + kBS;
    cp_async_wait_all();
    __syncthreads();  // the item is in; every read of the item before done
    if (it + 1 < n_items) load_item(it + 1);
    cp_async_commit();
    const bool live = !block_dead(p, q0, kBS, kw0, 16);
    const bool masked = block_masked(p, q0, kBS, kw0, 16);
    float x[kBS / 8][4];  // S^T then P^T, or dP^T then dS^T
    if (live) {
      if (dv_warp) {
        gemm_abt<D, kBS / 8>(x, Ks + 16 * warp * L::kS, Qs, lane);
#pragma unroll
        for (int nt = 0; nt < kBS / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * nt + 2 * q + (e & 1);  // query q0 + col
            x[nt][e] = prob(x[nt][e],
                            !masked || visible(p, q0 + col,
                                               kw0 + g + 8 * (e >> 1)),
                            c, lse_s[col]);
            pt[(4 * nt + e) * 32] = x[nt][e];
          }
      } else {
        gemm_abt<D, kBS / 8>(x, Vs + 16 * (warp - 4) * L::kS, dOs, lane);
      }
    }
    __syncthreads();  // P^T is in
    if (live) {
      if (dv_warp) {
        gemm_pb<D, kBS / 8>(acc, x, dOs, lane);  // dV += P^T dO
      } else {
#pragma unroll
        for (int nt = 0; nt < kBS / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[nt][e] = pt[(4 * nt + e) * 32] *
                       (x[nt][e] - delta_s[8 * nt + 2 * q + (e & 1)]);
        gemm_pb<D, kBS / 8>(acc, x, Qs, lane);  // dK += dS^T Q
      }
    }
  }

  store_rows<D>(static_cast<float*>(dv_warp ? p.dv : p.dk), acc,
                dv_warp ? 1.f : p.scale, b, p.T, p.KV, kvh, p.hd, kw0, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_mma_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;  // 128 rows each
  float* dOs = Qs + 2 * L::kTile;
  float* Ks = dOs + 2 * L::kTile;
  float* Vs = Ks + L::kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  const int qw0 = q0 + 16 * warp;                       // this warp's rows
  const float c = p.scale * kLog2e;

  const float* kg = static_cast<const float*>(p.k) + b * p.sk_b + kvh * p.sk_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv_b + kvh * p.sv_h;
  load_rows<D, kRows>(Qs, static_cast<const float*>(p.q) + b * p.sq_b +
                              h * p.sq_h,
                      p.sq_s, q0, p.S, p.hd, p.vec & kVecQ);
  load_rows<D, kRows>(dOs, static_cast<const float*>(p.dout) + b * p.sd_b +
                               h * p.sd_h,
                      p.sd_s, q0, p.S, p.hd, p.vec & kVecD);
  int kt_lo, kt_hi;
  key_tiles(p, q0, kRows, kt_lo, kt_hi);
  if (kt_lo < kt_hi) {
    load_rows<D, kBS>(Ks, kg, p.sk_t, kt_lo * kBS, p.T, p.hd, p.vec & kVecK);
    load_rows<D, kBS>(Vs, vg, p.sv_t, kt_lo * kBS, p.T, p.hd, p.vec & kVecV);
  }
  cp_async_commit();
  const float2 stA = row_stats(p, b, h, qw0 + g);
  const float2 stB = row_stats(p, b, h, qw0 + g + 8);

  float dq[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBS;
    cp_async_wait_all();
    __syncthreads();  // the tile's K and V are in
    const bool live = !block_dead(p, qw0, 16, k0, kBS);
    float s[kBS / 8][4], dp[kBS / 8][4];
    if (live)  // dP = dO V^T: this warp's 16 rows x 64 keys
      gemm_abt<D, kBS / 8>(dp, dOs + 16 * warp * L::kS, Vs, lane);
    __syncthreads();  // every warp is done with V
    if (kt + 1 < kt_hi)
      load_rows<D, kBS>(Vs, vg, p.sv_t, k0 + kBS, p.T, p.hd, p.vec & kVecV);
    cp_async_commit();
    if (live) {
      gemm_abt<D, kBS / 8>(s, Qs + 16 * warp * L::kS, Ks, lane);  // S = Q K^T
      const bool masked = block_masked(p, qw0, 16, k0, kBS);
#pragma unroll
      for (int nt = 0; nt < kBS / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = qw0 + g + 8 * (e >> 1);
          const float2 st = e >> 1 ? stB : stA;
          const float pr = prob(
              s[nt][e],
              !masked || visible(p, row, k0 + 8 * nt + 2 * q + (e & 1)), c,
              st.x);
          dp[nt][e] = pr * (dp[nt][e] - st.y);
        }
      gemm_pb<D, kBS / 8>(dq, dp, Ks, lane);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with K
    if (kt + 1 < kt_hi)
      load_rows<D, kBS>(Ks, kg, p.sk_t, k0 + kBS, p.T, p.hd, p.vec & kVecK);
    cp_async_commit();
  }

  store_rows<D>(static_cast<float*>(p.dq), dq, p.scale, b, p.S, p.H, h, p.hd,
                qw0, lane);
}

template <int D>
const void* kernel(int which) {
  return which == kDkdv
             ? reinterpret_cast<const void*>(flash_bwd_dkdv_mma_kernel<D>)
             : reinterpret_cast<const void*>(flash_bwd_dq_mma_kernel<D>);
}

template <int D>
int smem_bytes(int which) {
  return sizeof(float) * (which == kDkdv ? Layout<D>::kDkdv : Layout<D>::kDq);
}

template <int D>
cudaError_t launch(const Params& p, int which, cudaStream_t stream) {
  const int bytes = smem_bytes<D>(which);
  // set on every launch: the attribute is per device, and it is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      kernel<D>(which), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (which == kDkdv)
    flash_bwd_dkdv_mma_kernel<D><<<dim3(p.B * p.KV, (p.T + kKeys - 1) / kKeys),
                                   kThreads, bytes, stream>>>(p);
  else
    flash_bwd_dq_mma_kernel<D><<<dim3(p.B * p.H, (p.S + kRows - 1) / kRows),
                                 kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t occupancy(int which, int* ctas) {
  const int bytes = smem_bytes<D>(which);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel<D>(which), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel<D>(which),
                                                       kThreads, bytes);
}

// Calls F<D>(args...) for the padded head dim D of hd.
template <template <int> class F, typename... A>
cudaError_t by_hd(int hd, A... args) {
  if (hd <= 16) return F<16>::run(args...);
  if (hd <= 32) return F<32>::run(args...);
  if (hd <= 64) return F<64>::run(args...);
  if (hd <= 96) return F<96>::run(args...);
  return F<128>::run(args...);
}

template <int D>
struct Launch {
  static cudaError_t run(const Params& p, int which, cudaStream_t s) {
    return launch<D>(p, which, s);
  }
};
template <int D>
struct Occupancy {
  static cudaError_t run(int which, int* ctas) {
    return occupancy<D>(which, ctas);
  }
};

}  // namespace mma

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace sm90;

constexpr int kStages = 3;
constexpr int kConsumers = 256;            // 2 consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and a producer warp

// Shared memory of the dK/dV kernel: K and V (kKeys x D), a ring of Q and
// dO tiles (kBS x D) with the tiles' lse (log2 domain) and D, two P^T
// tiles (fp32, one per thread's accumulator layout) passed from one
// consumer warpgroup to the other, the mbarriers; every TMA tile as
// 64-column boxes of 128-byte rows, swizzled.  161.6 KiB at D = 128.
template <int D>
struct DkdvLayout {
  static constexpr int kOwnedBytes = kKeys * D * 2;
  static constexpr int kTileBytes = kBS * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kOwnedBytes;
  static constexpr int kQ = kV + kOwnedBytes;
  static constexpr int kdO = kQ + kStages * kTileBytes;
  static constexpr int kStat = kdO + kStages * kTileBytes;
  static constexpr int kP = kStat + kStages * 2 * kBS * 4;
  static constexpr int kBar = kP + 2 * kKeys * kBS * 4;
  // K/V, full and empty per stage; slack to align to the swizzle atom
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

// Shared memory of the dQ kernel: Q and dO (kRows x D), a ring of K and V
// tiles (kBS x D), the mbarriers.  161 KiB at D = 128.
template <int D>
struct DqLayout {
  static constexpr int kOwnedBytes = kRows * D * 2;
  static constexpr int kTileBytes = kBS * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kdO = kQ + kOwnedBytes;
  static constexpr int kK = kdO + kOwnedBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

// d += A B: A (64 x kBS) in registers, B a tile of kBS rows (the
// reduction) x D, MN-major through the transpose bit (its boxes of 64
// columns lie kBS * 128 bytes apart, its 8-row groups 1024 bytes apart).
template <int D>
__device__ __forceinline__ void rs_product(float (&d)[D / 2],
                                           const uint32_t (&a)[kBS / 16][4],
                                           uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < kBS / 16; ++kk)
    wgmma_rs(d, a[kk], sw128_desc(b_tile + kk * 16 * 128, kBS * 128, 1024));
}

// An accumulator tile (64 x kBS) as the register A operand of a k16 step
// per 16 columns, rounded to bf16.
__device__ __forceinline__ void pack_a(const float (&x)[kBS / 2],
                                       uint32_t (&a)[kBS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBS / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// A warpgroup's 64 x D gradient tile times `scale`, in bf16, into a
// contiguous (.., n, heads, hd) tensor: this thread's rows rA and rA + 8,
// columns 8 i + 2 (lane % 4) (+ 1).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2],
                                           float scale, int b, int n,
                                           int heads, int head, int hd,
                                           int rA, int lane) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rA + 8 * hh;
    if (r >= n) continue;
    __nv_bfloat16* row =
        out + ((static_cast<long long>(b) * n + r) * heads + head) * hd;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + 2 * (lane % 4);
      const float x0 = acc[4 * i + 2 * hh] * scale;
      const float x1 = acc[4 * i + 2 * hh + 1] * scale;
      if (hd % 2 == 0) {
        if (c < hd)
          *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(x0, x1);
      } else {
        if (c < hd) row[c] = __float2bfloat16(x0);
        if (c + 1 < hd) row[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers)
               : "memory");
}
// named barriers between the consumer warpgroups: P^T tile b is in (kFull
// + b), has been read (kFree + b)
constexpr int kFull = 1, kFree = 3;

// One CTA per (batch, KV head, 64 keys).  Consumer warpgroup 0 forms S^T =
// K Q^T and P^T, hands P^T to warpgroup 1 through shared memory, and adds
// P^T dO into dV; warpgroup 1 forms dP^T = V dO^T and dS^T = P^T (dP^T -
// D) and adds dS^T Q into dK.  Each holds one 64 x D gradient and one 64
// x 64 tile in registers.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap dmap,
                            const Params p) {
  using L = DkdvLayout<D>;
  constexpr int kBoxes = D / kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* stats = reinterpret_cast<float*>(smem + L::kStat);
  float4* ptiles = reinterpret_cast<float4*>(smem + L::kP);
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  const uint32_t sQ = base + L::kQ, sdO = base + L::kdO;
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_full = bar_kv + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 * stage

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x % p.KV;
  const int G = p.H / p.KV;
  const int k0 = blockIdx.y * kKeys;  // causal: the heaviest tiles first
  // items: (head kvh G + i / nq, query tile qt_lo + i % nq)
  int qt_lo, qt_hi;
  query_tiles(p, k0, kKeys, qt_lo, qt_hi);
  const int nq = qt_hi - qt_lo;
  const int n_items = G * nq;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 32);  // the producer warp's lanes
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: lane 0 issues the TMA loads, every lane writes its rows'
    // lse and D and then arrives
    const int lane = tid - kConsumers;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kOwnedBytes);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(sK + x * kKeys * 128, &kmap, bar_kv, x * kBox, kvh, k0, b);
        tma_load(sV + x * kKeys * 128, &vmap, bar_kv, x * kBox, kvh, k0, b);
      }
    }
    for (int it = 0; it < n_items; ++it) {
      const int st = it % kStages;
      const int h = kvh * G + it / nq;
      const int q0 = (qt_lo + it % nq) * kBS;
      mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
      float* lse2 = stats + st * 2 * kBS;
      for (int r = lane; r < kBS; r += 32) {
        const float2 s2 = row_stats(p, b, h, q0 + r);
        lse2[r] = s2.x;
        lse2[kBS + r] = s2.y;
      }
      if (lane == 0) {
        mbar_expect_tx(bar_full + 8 * st, 2 * L::kTileBytes);
        for (int x = 0; x < kBoxes; ++x) {
          const uint32_t off = st * L::kTileBytes + x * kBS * 128;
          tma_load(sQ + off, &qmap, bar_full + 8 * st, x * kBox, h, q0, b);
          tma_load(sdO + off, &dmap, bar_full + 8 * st, x * kBox, h, q0, b);
        }
      } else {
        mbar_arrive(bar_full + 8 * st);
      }
    }
  } else {
    const int wg = tid / 128;  // 0: P^T and dV; 1: dS^T and dK
    const int wt = tid % 128;
    const int lane = tid % 32;
    const int rA = k0 + (wt / 32) * 16 + lane / 4;  // keys rA and rA + 8
    const float c = p.scale * kLog2e;

    float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    int n = 0;  // items computed so far: P^T tile n % 2
    for (int it = 0; it < n_items; ++it) {
      const int st = it % kStages;
      const int q0 = (qt_lo + it % nq) * kBS;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
      if (!block_dead(p, q0, kBS, k0, kKeys)) {
        const uint32_t q_t = sQ + st * L::kTileBytes;
        const uint32_t d_t = sdO + st * L::kTileBytes;
        const float* lse2 = stats + st * 2 * kBS;
        float4* pt = ptiles + (n & 1) * (kKeys * kBS / 4) + wt;
        // x[4i + 2hh + e]: key rA + 8hh, query q0 + 8i + 2 (lane % 4) + e
        float x[kBS / 2];
        uint32_t a[kBS / 16][4];
        wgmma_fence();
        wgmma_abt<D, kKeys, kBS>(x, wg == 0 ? sK : sV, wg == 0 ? q_t : d_t);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(x);
        if (wg == 0) {  // P^T, to warpgroup 1, then dV += P^T dO
          const bool masked = block_masked(p, q0, kBS, k0, kKeys);
#pragma unroll
          for (int i = 0; i < kBS / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * i + 2 * (lane % 4) + (e & 1);
              x[4 * i + e] = prob(
                  x[4 * i + e],
                  !masked || visible(p, q0 + col, rA + 8 * (e >> 1)), c,
                  lse2[col]);
            }
          if (n >= 2) bar_sync(kFree + (n & 1));
#pragma unroll
          for (int i = 0; i < kBS / 8; ++i)
            pt[i * 128] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2],
                                      x[4 * i + 3]);
          bar_arrive(kFull + (n & 1));
          pack_a(x, a);
          wgmma_fence();
          rs_product<D>(acc, a, d_t);
        } else {  // dS^T = P^T (dP^T - D), then dK += dS^T Q
          bar_sync(kFull + (n & 1));
#pragma unroll
          for (int i = 0; i < kBS / 8; ++i) {
            const float4 pr = pt[i * 128];
            const float* d = lse2 + kBS + 8 * i + 2 * (lane % 4);
            x[4 * i] = pr.x * (x[4 * i] - d[0]);
            x[4 * i + 1] = pr.y * (x[4 * i + 1] - d[1]);
            x[4 * i + 2] = pr.z * (x[4 * i + 2] - d[0]);
            x[4 * i + 3] = pr.w * (x[4 * i + 3] - d[1]);
          }
          bar_arrive(kFree + (n & 1));
          pack_a(x, a);
          wgmma_fence();
          rs_product<D>(acc, a, q_t);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(a);
        ++n;
      }
      mbar_arrive(bar_empty + 8 * st);
    }
    store_rows<D>(static_cast<__nv_bfloat16*>(wg == 0 ? p.dv : p.dk), acc,
                  wg == 0 ? 1.f : p.scale, b, p.T, p.KV, kvh, p.hd, rA, lane);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const Params p) {
  using L = DqLayout<D>;
  constexpr int kBoxes = D / kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base + L::kQ, sdO = base + L::kdO;
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  int kt_lo, kt_hi;
  key_tiles(p, q0, kRows, kt_lo, kt_hi);
  const int n_tiles = kt_hi - kt_lo;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {  // producer: one thread issues every TMA load
      mbar_expect_tx(bar_q, 2 * L::kOwnedBytes);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(sQ + x * kRows * 128, &qmap, bar_q, x * kBox, h, q0, b);
        tma_load(sdO + x * kRows * 128, &dmap, bar_q, x * kBox, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int k0 = (kt_lo + it) * kBS;
        mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * L::kTileBytes);
        for (int x = 0; x < kBoxes; ++x) {
          const uint32_t off = st * L::kTileBytes + x * kBS * 128;
          tma_load(sK + off, &kmap, bar_full + 8 * st, x * kBox, kvh, k0, b);
          tma_load(sV + off, &vmap, bar_full + 8 * st, x * kBox, kvh, k0, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    const int wg = tid / 128;
    const int wt = tid % 128;
    const int lane = tid % 32;
    const int wq0 = q0 + 64 * wg;
    const int rA = wq0 + (wt / 32) * 16 + lane / 4;  // rows rA and rA + 8
    const float c = p.scale * kLog2e;
    const float2 stA = row_stats(p, b, h, rA);
    const float2 stB = row_stats(p, b, h, rA + 8);
    const uint32_t q_rows = sQ + wg * 64 * 128, d_rows = sdO + wg * 64 * 128;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int k0 = (kt_lo + it) * kBS;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
      if (!block_dead(p, wq0, 64, k0, kBS)) {
        const uint32_t k_t = sK + st * L::kTileBytes;
        float s[kBS / 2], dp[kBS / 2];
        wgmma_fence();
        wgmma_abt<D, kRows, kBS>(s, q_rows, k_t);                      // S
        wgmma_abt<D, kRows, kBS>(dp, d_rows, sV + st * L::kTileBytes);  // dP
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // s[4i + 2hh + e]: row rA + 8hh, key k0 + 8i + 2 (lane % 4) + e
        const bool masked = block_masked(p, wq0, 64, k0, kBS);
#pragma unroll
        for (int i = 0; i < kBS / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 st2 = e >> 1 ? stB : stA;
            const float pr = prob(
                s[4 * i + e],
                !masked || visible(p, rA + 8 * (e >> 1),
                                   k0 + 8 * i + 2 * (lane % 4) + (e & 1)),
                c, st2.x);
            dp[4 * i + e] = pr * (dp[4 * i + e] - st2.y);
          }
        uint32_t da[kBS / 16][4];
        pack_a(dp, da);
        wgmma_fence();
        rs_product<D>(dq, da, k_t);  // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(da);
      }
      mbar_arrive(bar_empty + 8 * st);
    }
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dq), dq, p.scale, b, p.S, p.H,
                  h, p.hd, rA, lane);
  }
}

template <int D>
const void* kernel(int which) {
  return which == kDkdv
             ? reinterpret_cast<const void*>(flash_bwd_dkdv_wgmma_kernel<D>)
             : reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel<D>);
}

template <int D>
int smem_bytes(int which) {
  return which == kDkdv ? DkdvLayout<D>::kBytes : DqLayout<D>::kBytes;
}

template <int D>
cudaError_t launch(const Params& p, int which, cudaStream_t stream) {
  // Q and dO: kBS-row tiles for dK/dV, kRows for dQ; K and V: kKeys
  // (dK/dV) or kBS (dQ), both 64
  const int rq = which == kDkdv ? kBS : kRows;
  const int rk = kBS;
  CUtensorMap qm, km, vm, dm;
  if (!make_map(&qm, p.q, p.hd, p.H, p.S, p.B, p.sq_h, p.sq_s, p.sq_b, rq) ||
      !make_map(&dm, p.dout, p.hd, p.H, p.S, p.B, p.sd_h, p.sd_s, p.sd_b,
                rq) ||
      !make_map(&km, p.k, p.hd, p.KV, p.T, p.B, p.sk_h, p.sk_t, p.sk_b, rk) ||
      !make_map(&vm, p.v, p.hd, p.KV, p.T, p.B, p.sv_h, p.sv_t, p.sv_b, rk))
    return cudaErrorInvalidValue;
  const int bytes = smem_bytes<D>(which);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel<D>(which), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (which == kDkdv)
    flash_bwd_dkdv_wgmma_kernel<D><<<dim3(p.B * p.KV,
                                          (p.T + kKeys - 1) / kKeys),
                                     kThreads, bytes, stream>>>(qm, km, vm,
                                                                dm, p);
  else
    flash_bwd_dq_wgmma_kernel<D><<<dim3(p.B * p.H, (p.S + kRows - 1) / kRows),
                                   kThreads, bytes, stream>>>(qm, km, vm, dm,
                                                              p);
  return cudaGetLastError();
}

template <int D>
cudaError_t occupancy(int which, int* ctas) {
  const int bytes = smem_bytes<D>(which);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel<D>(which), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel<D>(which),
                                                       kThreads, bytes);
}

bool operands_ok(const Params& p) {
  return tma_ok(p.q, p.sq_b, p.B, p.sq_s, p.S, p.sq_h, p.H) &&
         tma_ok(p.k, p.sk_b, p.B, p.sk_t, p.T, p.sk_h, p.KV) &&
         tma_ok(p.v, p.sv_b, p.B, p.sv_t, p.T, p.sv_h, p.KV) &&
         tma_ok(p.dout, p.sd_b, p.B, p.sd_s, p.S, p.sd_h, p.H);
}

}  // namespace tc

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// fp32 operand that allows 16-byte copies: aligned, hd and strides
// multiples of 4 elements
bool vec4(const void* ptr, int hd, long long s0, long long s1, long long s2) {
  return aligned16(ptr) && hd % 4 == 0 && s0 % 4 == 0 && s1 % 4 == 0 &&
         s2 % 4 == 0;
}

// Launches the kernels of `which` (kDelta | kDkdv | kDq) in that order.
cudaError_t run(const Params& p, int dtype, int which, cudaStream_t stream) {
  if (which & kDelta) {
    const long long rows = static_cast<long long>(p.B) * p.S * p.H;
    const long long blocks =
        (rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32);
    if (blocks > 2147483647LL) return cudaErrorInvalidValue;
    if (dtype == 0)
      flash_bwd_delta_kernel<float><<<static_cast<unsigned>(blocks),
                                      kDeltaThreads, 0, stream>>>(p);
    else
      flash_bwd_delta_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks),
                                              kDeltaThreads, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dtype == 1 && (which & (kDkdv | kDq)) && !tc::operands_ok(p))
    return cudaErrorInvalidValue;
  for (int part : {kDkdv, kDq}) {
    if (!(which & part)) continue;
    const cudaError_t err =
        dtype == 0 ? mma::by_hd<mma::Launch>(p.hd, p, part, stream)
        : p.hd <= 64 ? tc::launch<64>(p, part, stream)
                     : tc::launch<128>(p, part, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype (of q, k, v, o, dout, dq, dk, dv): 0 = float32, 1 = bfloat16; lse
// and delta are float32 (B, H, S), delta a scratch this call fills.
// Strides are in elements and the last dim of q, k, v and dout has stride
// 1; o and dq are contiguous (B, S, H, hd), dk and dv contiguous (B, T,
// KV, hd).  bfloat16 q, k, v and dout also need TMA's 16-byte rule
// (sm90::tma_ok).  `which` picks the kernels to launch: 1 = D, 2 = dK/dV,
// 4 = dQ, 7 = all three, in that order (one alone times a part; dK/dV and
// dQ read the delta an earlier call wrote).  Launches on `stream`; returns
// the CUDA error of the first launch that fails (0 on success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int dtype,
                        int B, int S, int T, int H, int KV, int hd,
                        long long sq_b, long long sq_s, long long sq_h,
                        long long sk_b, long long sk_t, long long sk_h,
                        long long sv_b, long long sv_t, long long sv_h,
                        long long sd_b, long long sd_s, long long sd_h,
                        int causal, int window, float scale, int which,
                        void* stream) {
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0 || B < 1 || S < 1 ||
      T < 1 || static_cast<long long>(B) * H > 2147483647LL ||
      (S + kRows - 1) / kRows > 65535 || (T + kKeys - 1) / kKeys > 65535 ||
      (dtype != 0 && dtype != 1) || which < 1 || which > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (vec4(q, hd, sq_b, sq_s, sq_h) ? kVecQ : 0) |
                  (vec4(k, hd, sk_b, sk_t, sk_h) ? kVecK : 0) |
                  (vec4(v, hd, sv_b, sv_t, sv_h) ? kVecV : 0) |
                  (vec4(dout, hd, sd_b, sd_s, sd_h) ? kVecD : 0);
  const Params p{q,    k,    v,    o,    dout, lse,    delta,  dq,   dk,
                 dv,   B,    S,    T,    H,    KV,     hd,     sq_b, sq_s,
                 sq_h, sk_b, sk_t, sk_h, sv_b, sv_t,   sv_h,   sd_b, sd_s,
                 sd_h, causal, window, scale, vec};
  return static_cast<int>(
      run(p, dtype, which, static_cast<cudaStream_t>(stream)));
}

// CTAs of the dK/dV (which = 0) or dQ (which = 1) kernel for `dtype` and
// head dim `hd` that fit on one SM, or minus the CUDA error; launches
// nothing.
int flash_attention_bwd_ctas_per_sm(int dtype, int hd, int which) {
  int ctas = 0;
  const int part = which == 0 ? kDkdv : kDq;
  const cudaError_t err =
      dtype == 0 ? mma::by_hd<mma::Occupancy>(hd, part, &ctas)
      : hd <= 64 ? tc::occupancy<64>(part, &ctas)
                 : tc::occupancy<128>(part, &ctas);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
