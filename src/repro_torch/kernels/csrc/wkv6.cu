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
// and the final S is written back to `state` in place; when `states` is
// given, the state at the start of each 32-token chunk is written there
// too, for the backward (wkv6_bwd.cu).  It is evaluated
// chunkwise, as the reference does: within a chunk of C tokens, with
// cum = inclusive cumsum of logw down the chunk and cum_prev = cum - logw,
//   y   = (r * exp(cum_prev)) @ S                          (cross-chunk)
//       + A @ v,  A[t][s] = sum_i r_t[i] k_s[i] exp(cum_prev_t[i] - cum_s[i])
//                 for s < t, A[t][t] = sum_i r_t[i] k_t[i] u[i], 0 above
//   S'  = exp(cum_C) * S + (k * exp(cum_C - cum))^T @ v
// A factored exp(cum_prev_t) * exp(-cum_s) overflows for strong decays
// (logw = -8 over 64 tokens is exp(512)), so every exponent here is <= 0.
// Tokens past S read as r = k = v = 0, logw = 0 (no effect on the state)
// and are not written.  r, k, v are fp32 or bf16; logw and u are fp32; y
// is written in r's type.
//
// What bounds it on an H100: bytes.  At the rwkv6-3b prefill wave (B*H =
// 320 heads, S = 1024, N = 64) r, k, v, logw and y move 0.43 GB (0.128 ms
// at 3.35 TB/s); the chunked form's multiply-adds and exps at C = 32 are
// about 7 GFLOP (0.106 ms on the CUDA cores, 0.04 ms as 3xTF32 on the
// tensor cores).
//
// Design.  One CTA of four warps per (batch, head), looping over chunks of
// 32 tokens (kChunk, whatever chunk the caller names: the function is the
// same).  The state's columns evolve apart (S[:, j] sees only v_t[j]), so
// each warp holds 16 columns j of the (64, 64) state in registers, as the
// accumulator tile of S^T's update, for the whole scan; read as the A
// operand of S^T r^T straight from those registers, it never goes through
// shared memory.  Per chunk:
//   * r, k, v arrive in their own type by cp.async (16-byte copies where
//     aligned, 4-byte ones for unaligned f32, plain loads for unaligned
//     bf16) into one of two stages while the previous chunk computes;
//     logw arrives by 4-byte copies, channel i by thread 64 + i, which
//     then takes the cumsum of its own copies (no barrier between);
//   * A is built once per CTA.  Below the diagonal 8 x 8 blocks it is a
//     product over the channels, with ref = cum at the token before the
//     queries (so at or after every key):
//       A[t][s] = sum_i (r_t[i] e^{cum_prev_t[i] - ref[i]})
//                       (k_s[i] e^{ref[i] - cum_s[i]}),
//     both exponents <= 0, so it is exact and cannot overflow: warps 0
//     and 1 take rows 16-31 x keys 0-15, warps 2 and 3 rows 8-15 x keys
//     0-7 and rows 24-31 x keys 16-23, one m16n8k8 tile each.  Only the
//     four diagonal 8 x 8 blocks take pairwise exps (3.5 N a token; the
//     whole chunk pairwise takes 15.5 N), four channels a step, and the
//     diagonal takes the bonus u;
//   * r e^{cum_prev} and k e^{cum_C - cum} are formed (f32 in place, past
//     a barrier; bf16 into f32 tiles of their own, with no barrier);
//   * each warp computes its columns of y^T = S^T (r e^{cum_prev})^T +
//     v^T A^T, then S^T = e^{cum_C} S^T + v^T (k e^{cum_C - cum}).
// Every product runs on mma.sync m16n8k8 in 3xTF32 (chunk_scan.cuh); for
// bf16 inputs v is exact in TF32 and its lo terms are dropped.  Every exp
// has an argument <= 0 and is taken as 2^(x log2(e)).  N is padded to 64
// inside the kernel.  A CTA takes 61 KiB of shared memory for f32 inputs
// (53 KiB for bf16) and up to 168 registers a thread: three fit on an SM,
// so the 320 CTAs of the prefill wave run in one wave on 132 SMs.
//
// Left for later: the pairwise exps of the diagonal blocks are still the
// largest single cost (PERF.md); bf16 inputs still go through TF32, at
// half the bf16 tensor rate; wgmma.
//
// This file must never be built with --use_fast_math.
#include "chunk_scan.cuh"

namespace {

using namespace chunk_scan;

constexpr int C = kChunk;
constexpr int LA = C + 4;  // A's row stride: A[t][s] reads are conflict-free
constexpr int kBlock = 8;  // A's diagonal blocks, the only pairwise ones
constexpr int kPairs = kBlock * (kBlock - 1) / 2;  // below a block's diagonal
constexpr int kEntries = C / kBlock * kPairs + C;  // and the diagonal
// two stages of r, k, v tiles in the inputs' type; for bf16 inputs f32
// tiles of the decayed r and k (f32 inputs are decayed in place); cum, A,
// u, e^{cum_C}
template <typename T>
__host__ __device__ constexpr int smem_floats() {
  return 2 * 3 * kTile * static_cast<int>(sizeof(T)) / 4 +
         (sizeof(T) == 2 ? 2 * kTile : 0) + kTile + C * LA + 2 * kDim;
}

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;  // contiguous (H, N)
  void* y;         // contiguous (B, S, H, N), r's type
  float* state;    // contiguous (B, H, N, N), read and written in place
  float* states;   // contiguous (B, H, nchunks, N, N) chunk-start states,
                   // or null (not written)
  int B, S, H, N;
  long long sr_b, sr_s, sr_h;
  long long sk_b, sk_s, sk_h;
  long long sv_b, sv_s, sv_h;
  long long sw_b, sw_s, sw_h;
  int mode;        // LoadMode of the r, k, v tiles
};

constexpr float kLog2e = 1.4426950408889634f;

// e^x for x <= 0 as 2^(x log2(e)): the scaling errs by 2^-24 of x, which
// moves e^x by at most 2^-24 |x| e^x < 2^-25 (relative to 1)
__device__ __forceinline__ float exp_neg(float x) { return exp2f(x * kLog2e); }


// A[t][s] for the queries t0.. (16 rows, or 8 when not ROWS16) and the
// keys s0..s0 + 7, all before t0:
//   A[t][s] = sum_i (r_t[i] e^{cum_prev_t[i] - ref[i]})
//                   (k_s[i] e^{ref[i] - cum_s[i]})
// with ref = cum at token t0 - 1, so both exponents are <= 0.  One m16n8k8
// product per 8 channels; with 8 rows the A operand's lower half is 0.
template <bool ROWS16, typename T>
__device__ __forceinline__ void factored_tile(float* A, const T* rs,
                                              const T* ks, const float* cm,
                                              int t0, int s0, int g, int q) {
  const int ta = t0 + g, tb = ta + 8, s = s0 + g;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int kk = 0; kk < 8; ++kk) {
    const int col = 8 * kk + 2 * q;
    const float2 ref = ldf2(cm, t0 - 1, col);
    const float2 ra = ldf2(rs, ta, col), pa = ldf2(cm, ta - 1, col);
    const float2 kv = ldf2(ks, s, col), ck = ldf2(cm, s, col);
    float a1 = 0.f, a3 = 0.f;
    if (ROWS16) {
      const float2 rb = ldf2(rs, tb, col), pb = ldf2(cm, tb - 1, col);
      a1 = rb.x * exp_neg(pb.x - ref.x);
      a3 = rb.y * exp_neg(pb.y - ref.y);
    }
    FragA<true> a;
    a.set(ra.x * exp_neg(pa.x - ref.x), a1, ra.y * exp_neg(pa.y - ref.y), a3);
    FragB<true> bb;
    bb.set(kv.x * exp_neg(ref.x - ck.x), kv.y * exp_neg(ref.y - ck.y));
    mma3(d, a, bb);
  }
  const int s1 = s0 + 2 * q;
  A[ta * LA + s1] = d[0];
  A[ta * LA + s1 + 1] = d[1];
  if (ROWS16) {
    A[tb * LA + s1] = d[2];
    A[tb * LA + s1 + 1] = d[3];
  }
}

// STATES: the chunk-start states are written (training's forward only;
// serving runs the instantiation without that code)
template <typename T, bool STATES>
__global__ void __launch_bounds__(kThreads, 3) wkv6_kernel(const Params p) {
  constexpr bool LO = sizeof(T) == 4;  // bf16 inputs are exact in TF32
  extern __shared__ __align__(16) float smem[];
  T* tiles0 = reinterpret_cast<T*>(smem);  // stage c & 1 at 3 c kTile
  float* dec = smem + 6 * kTile * static_cast<int>(sizeof(T)) / 4;
  float* cm = dec + (LO ? 0 : 2 * kTile);  // cum, swizzled like the tiles
  float* A = cm + kTile;         // [C][LA]
  float* us = A + C * LA;        // [64] u
  float* dt = us + kDim;         // [64] exp(cum_C)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int N = p.N, S = p.S;
  const T* rg = static_cast<const T*>(p.r) + b * p.sr_b + h * p.sr_h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk_b + h * p.sk_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv_b + h * p.sv_h;
  const float* wg = p.logw + b * p.sw_b + h * p.sw_h;
  float* sg = p.state + (static_cast<long long>(b) * p.H + h) * N * N;
  T* yg = static_cast<T*>(p.y) + (static_cast<long long>(b) * S * p.H + h) * N;
  const long long sy = static_cast<long long>(p.H) * N;
  const int j0 = warp * 16;  // this warp's columns of the state, rows of S^T

  for (int e = tid; e < C * LA; e += kThreads) A[e] = 0.f;
  if (tid < kDim) us[tid] = tid < N ? p.u[h * N + tid] : 0.f;

  // ss[nt] holds S^T[j0 + g + 8 r][8 nt + 2 q + c] = S[i][j] at 2 r + c
  float ss[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + g + 8 * (e >> 1), i = 8 * nt + 2 * q + (e & 1);
      ss[nt][e] = (i < N && j < N) ? sg[i * N + j] : 0.f;
    }

  // two stages of r, k, v tiles, the chunk's own by its parity
  auto tiles = [&](int c) { return tiles0 + (c & 1) * 3 * kTile; };
  auto issue = [&](int c) {
    T* st = tiles(c);
    const int t0 = c * C, rows = min(C, S - t0);
    load_tile(st, rg + t0 * p.sr_s, p.sr_s, rows, N, p.mode);
    load_tile(st + kTile, kg + t0 * p.sk_s, p.sk_s, rows, N, p.mode);
    load_tile(st + 2 * kTile, vg + t0 * p.sv_s, p.sv_s, rows, N, p.mode);
    cp_async_commit();
  };
  const int ch = tid - kDim;  // the logw channel of threads 64-127
  // logw of one chunk into cm by 4-byte cp.async, thread 64 + i copying
  // channel i, so that it can take the cumsum of its own copies
  auto issue_logw = [&](int c) {
    const int t0 = c * C;
    if (ch >= 0) {
#pragma unroll 4
      for (int t = 0; t < C; ++t) {
        const bool ok = ch < N && t0 + t < S;
        cp_async4(cm + swz(t, ch), ok ? wg + (t0 + t) * p.sw_s + ch : wg, ok);
      }
    }
    cp_async_commit();
  };

  const int nchunks = (S + C - 1) / C;
  issue(0);
  issue_logw(0);
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * C;
    if (STATES) {
      float* o = p.states +
                 ((static_cast<long long>(b) * p.H + h) * nchunks + c) * N * N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + g + 8 * (e >> 1), i = 8 * nt + 2 * q + (e & 1);
          if (i < N && j < N) o[i * N + j] = ss[nt][e];
        }
    }
    const T* rs = tiles(c);
    const T* ks = rs + kTile;
    const T* vs = ks + kTile;
    // r e^{cum_prev} and k e^{cum_C - cum}: f32 in place, bf16 apart
    float* rd = LO ? reinterpret_cast<float*>(tiles(c)) : dec;
    float* kd = rd + kTile;
    cp_async_wait_all();
    // inclusive cumsum of logw down the chunk, in place, each thread over
    // the channel it copied
    if (ch >= 0) {
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < C; ++t) {
        acc += cm[swz(t, ch)];
        cm[swz(t, ch)] = acc;
      }
    }
    __syncthreads();  // tiles and cum are in; the last chunk is done
    if (c + 1 < nchunks) issue(c + 1);

    // A below the diagonal 8 x 8 blocks, as products over the channels
    // with ref = cum at the row before the queries (every key precedes it):
    // warps 0 and 1 take rows 16-31 x keys 8 w.., warps 2 and 3 rows 8-15
    // x keys 0-7 and rows 24-31 x keys 16-23
    if (warp < 2)
      factored_tile<true>(A, rs, ks, cm, 16, 8 * warp, g, q);
    else
      factored_tile<false>(A, rs, ks, cm, warp == 2 ? 8 : 24,
                           warp == 2 ? 0 : 16, g, q);
    // the diagonal blocks pairwise, and the bonus on the diagonal, four
    // channels a step; warp 2's first lanes take the entries past 128, and
    // each thread walks the channels from its own lane (fewer bank
    // conflicts)
    for (int e = (tid + 64) % kThreads; e < kEntries; e += kThreads) {
      float a = 0.f;
      if (e < kEntries - C) {
        const int blk = e / kPairs, idx = e % kPairs;
        int tt = static_cast<int>((1.f + sqrtf(1.f + 8.f * idx)) * 0.5f);
        while (tt * (tt - 1) / 2 > idx) --tt;
        while (tt * (tt + 1) / 2 <= idx) ++tt;
        const int t = kBlock * blk + tt;
        const int s = kBlock * blk + idx - tt * (tt - 1) / 2;
#pragma unroll 4
        for (int jj = 0; jj < kDim / 4; ++jj) {
          const int i = ((jj + lane) & (kDim / 4 - 1)) * 4;
          const float4 rv = ldf4(rs, t, i), kv = ldf4(ks, s, i);
          const float4 cp = ldf4(cm, t - 1, i), cv = ldf4(cm, s, i);
          a = fmaf(rv.x * kv.x, exp_neg(cp.x - cv.x), a);
          a = fmaf(rv.y * kv.y, exp_neg(cp.y - cv.y), a);
          a = fmaf(rv.z * kv.z, exp_neg(cp.z - cv.z), a);
          a = fmaf(rv.w * kv.w, exp_neg(cp.w - cv.w), a);
        }
        A[t * LA + s] = a;
      } else {
        const int t = e - (kEntries - C);
#pragma unroll 4
        for (int jj = 0; jj < kDim / 4; ++jj) {
          const int i = ((jj + lane) & (kDim / 4 - 1)) * 4;
          const float4 rv = ldf4(rs, t, i), kv = ldf4(ks, t, i);
          const float4 uv = *reinterpret_cast<const float4*>(us + i);
          a = fmaf(rv.x * kv.x, uv.x, a);
          a = fmaf(rv.y * kv.y, uv.y, a);
          a = fmaf(rv.z * kv.z, uv.z, a);
          a = fmaf(rv.w * kv.w, uv.w, a);
        }
        A[t * LA + t] = a;
      }
    }
    // f32: A is built; raw r and k are no longer read (bf16 inputs are
    // decayed into tiles of their own)
    if constexpr (LO) __syncthreads();

    // r e^{cum_prev} and k e^{cum_C - cum}, four channels a thread;
    // e^{cum_C}
    for (int e = tid; e < kTile / 4; e += kThreads) {
      const int t = e / (kDim / 4), i = (e % (kDim / 4)) * 4;
      const float4 cp = t > 0 ? ldf4(cm, t - 1, i) : make_float4(0, 0, 0, 0);
      const float4 cv = ldf4(cm, t, i), cl = ldf4(cm, C - 1, i);
      const float4 rv = ldf4(rs, t, i), kv = ldf4(ks, t, i);
      float4* rp = reinterpret_cast<float4*>(rd + swz(t, i));
      float4* kp = reinterpret_cast<float4*>(kd + swz(t, i));
      *rp = make_float4(rv.x * exp_neg(cp.x), rv.y * exp_neg(cp.y),
                        rv.z * exp_neg(cp.z), rv.w * exp_neg(cp.w));
      *kp = make_float4(
          kv.x * exp_neg(cl.x - cv.x), kv.y * exp_neg(cl.y - cv.y),
          kv.z * exp_neg(cl.z - cv.z), kv.w * exp_neg(cl.w - cv.w));
    }
    if (tid < kDim) dt[tid] = exp_neg(cm[swz(C - 1, tid)]);
    __syncthreads();  // the last reads of cm: the next logw may land there
    if (c + 1 < nchunks) issue_logw(c + 1);

    // y^T (rows j, columns t) = S^T (r e^{cum_prev})^T: S^T is the A
    // operand straight from its accumulators (k slot q = i 2q, q + 4 = 2q+1)
    float ya[4][4];
#pragma unroll
    for (int jt = 0; jt < 4; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[jt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      FragA<true> a;
      a.set(ss[kk][0], ss[kk][2], ss[kk][1], ss[kk][3]);
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        const float2 rv = ldf2(rd, 8 * jt + g, 8 * kk + 2 * q);
        FragB<true> bb;
        bb.set(rv.x, rv.y);
        mma3(ya[jt], a, bb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float d0 = dt[8 * nt + 2 * q], d1 = dt[8 * nt + 2 * q + 1];
      ss[nt][0] *= d0;
      ss[nt][1] *= d1;
      ss[nt][2] *= d0;
      ss[nt][3] *= d1;
    }

    // y^T += v^T A^T and S^T += v^T (k e^{cum_C - cum}), one v^T fragment
    // per 8 tokens
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int s = 8 * kk + q;
      FragA<LO> a;
      a.set(ldf(vs, s, j0 + g), ldf(vs, s, j0 + g + 8), ldf(vs, s + 4, j0 + g),
            ldf(vs, s + 4, j0 + g + 8));
#pragma unroll
      for (int jt = kk; jt < 4; ++jt) {
        FragB<true> m;
        m.set(A[(8 * jt + g) * LA + s], A[(8 * jt + g) * LA + s + 4]);
        mma3(ya[jt], a, m);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        FragB<true> kb;
        kb.set(kd[swz(s, 8 * nt + g)], kd[swz(s + 4, 8 * nt + g)]);
        mma3(ss[nt], a, kb);
      }
    }

#pragma unroll
    for (int jt = 0; jt < 4; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + g + 8 * (e >> 1);
        const int t = t0 + 8 * jt + 2 * q + (e & 1);
        if (j < N && t < S) store(&yg[t * sy + j], ya[jt][e]);
      }
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + g + 8 * (e >> 1), i = 8 * nt + 2 * q + (e & 1);
      if (i < N && j < N) sg[i * N + j] = ss[nt][e];
    }
}

template <typename T, bool STATES>
cudaError_t launch_as(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<T>();
  // set on every launch: the attribute is per device, and it is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, STATES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  wkv6_kernel<T, STATES><<<p.B * p.H, kThreads, bytes, stream>>>(p);
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
      wkv6_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, wkv6_kernel<T, false>, kThreads, bytes);
}

}  // namespace

extern "C" {

// dtype (of r, k, v and y): 0 = float32, 1 = bfloat16.  logw and u are
// float32.  Strides are in elements, the last dim of every input has
// stride 1, u is contiguous (H, N), y contiguous (B, S, H, N), state
// contiguous (B, H, N, N) and states null or contiguous (B, H, ceil(S /
// 32), N, N).
// Returns the CUDA error of the launch (0 on success).
int wkv6_fwd(const void* r, const void* k, const void* v, const float* logw,
             const float* u, void* y, float* state, float* states, int dtype,
             int B, int S, int H, int N, long long sr_b, long long sr_s,
             long long sr_h, long long sk_b, long long sk_s, long long sk_h,
             long long sv_b, long long sv_s, long long sv_h, long long sw_b,
             long long sw_s, long long sw_h, void* stream) {
  if (N < 1 || N > kDim || B < 1 || S < 1 || H < 1 ||
      static_cast<long long>(B) * H > 2147483647LL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // the slowest of the three tiles' modes for all three
  int mode;
  if (dtype == 0)
    mode = std::max({load_mode<float>(r, N, {sr_b, sr_s, sr_h}),
                     load_mode<float>(k, N, {sk_b, sk_s, sk_h}),
                     load_mode<float>(v, N, {sv_b, sv_s, sv_h})});
  else
    mode = std::max({load_mode<__nv_bfloat16>(r, N, {sr_b, sr_s, sr_h}),
                     load_mode<__nv_bfloat16>(k, N, {sk_b, sk_s, sk_h}),
                     load_mode<__nv_bfloat16>(v, N, {sv_b, sv_s, sv_h})});
  const Params p{r,    k,    v,    logw, u,    y,    state, states, B,
                 S,    H,    N,    sr_b, sr_s, sr_h, sk_b,  sk_s,   sk_h,
                 sv_b, sv_s, sv_h, sw_b, sw_s, sw_h, mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch<float>(p, st)
                                     : launch<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}

// CTAs of the kernel for `dtype` that fit on one SM, or minus the CUDA
// error; launches nothing.
int wkv6_ctas_per_sm(int dtype) {
  int ctas = 0;
  const cudaError_t err = dtype == 0 ? occupancy<float>(&ctas)
                                     : occupancy<__nv_bfloat16>(&ctas);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
