// Flash attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention /
// _attn_kernel (the Pallas TPU kernel behind ops.flash_attention), which
// the dense LM's full-sequence attention runs once per layer: the serving
// plane's batched prefill (models/attention.py prefill_attention ->
// full_attention -> ops.attention) and zamba2's shared attention block.
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
// 60.2 GFLOP against 268 MB of q, k, v and o (fp32): 0.90 ms of FFMA at 67
// TFLOP/s, or 0.061 ms on the bf16 tensor cores at 989 TFLOP/s, against
// 0.08 ms (fp32) or 0.04 ms (bf16) of bytes at 3.35 TB/s.  Two designs:
//
// fp32: the CUDA cores (flash_fwd_ffma_kernel).  TF32 tensor cores keep 10
// mantissa bits and would break the 2e-5 tolerance the reference holds the
// kernel to, so the products stay FFMA.  One CTA of 256 threads per
// (batch*head, 128-row query tile); K/V tiles of 64 rows stream through a
// 2-stage ring filled by 16-byte cp.async, so tile j+1 loads while tile j
// computes.  Each thread owns an 8 x 4 register tile of the logits and an
// 8 x D/16 tile of the output: Q and K are read from shared memory as
// float4 along the head dim (12 loads per 128 FFMA), P and V as float4
// along the keys and head dim (16 loads per 256 FFMA at D = 128).  Row
// statistics live on the 16 lanes of a half-warp.  At D = 128 a CTA takes
// 226 KiB of shared memory and 254 registers a thread: one CTA an SM.
// It runs near half the FFMA rate.  The QK^T loop issues more 128-bit
// shared loads per FFMA (12 per 128) than the PV loop (16 per 256), and
// with 254 registers a thread one CTA of 8 warps fills an SM, so little
// latency is hidden and the softmax and barriers between the two
// products leave the FFMA pipes idle.  A 128 x 128 logit tile (8 x 8 a
// thread) evens the loads but spills and loses the double buffering.
// Operands whose pointers or strides are not 16-byte multiples take
// 4-byte cp.async instead.
//
// bf16: the tensor cores (flash_fwd_wgmma_kernel), FlashAttention-3's
// shape at its simplest (the TMA and wgmma wrappers: wgmma_tma.cuh).
// One CTA of 2 consumer warpgroups and a producer warp per (batch*head,
// 128-row query tile).  The producer issues TMA
// loads (4-D tensor maps over (hd, heads, seq, batch) with 128-byte
// swizzle, built on the host) of the Q tile once and of 64-key K/V tiles
// into a 3-stage ring guarded by full/empty mbarriers; each consumer
// warpgroup owns 64 query rows.  S = Q K^T is wgmma m64n64k16 from shared
// memory (K's rows are K-major as the B operand needs); the mask and the
// online softmax run in fp32 registers, a row spread over the 4 lanes of a
// quad; O += P V is wgmma m64nDk16 with P from registers and V through the
// transpose bit.  A tile's S and the tile before's PV product are issued
// together, so the softmax of one overlaps the PV product of the other.
// The head dim is padded to D = 64 or 128 by the tensor maps' zero fill
// (so zamba2's hd 80 does 1.6x the MMA work), as are the rows past S and
// T.  Registers bound the tiles: 9 warps a CTA leave each a budget of 168
// registers (a scheduler's 16384 over its 3 warps), which 128-key tiles
// overflow (the compiler spills and serialises the wgmma).
//
// Numerics of the bf16 design.  Q K^T on bf16 inputs with fp32
// accumulation is exact per product, as in the fp32 reference; only the
// order of the sums differs.  The softmax scale multiplies the fp32
// logits (1/sqrt(128) is not a power of two, so scaling Q in bf16 would
// round).  P is not rounded to bf16 once: that errs by up to 2^-9 of each
// p and so by about 2^-9 |p . v| in the output, which an output near zero
// cannot absorb, while the reference multiplies P V in fp32.  P is split
// into hi = bf16(P) and lo = bf16(P - hi), and both products accumulate
// into the same fp32 registers: P then carries about 16 bits (error near
// 2^-17 |p|), at 1.5x the bound's operations.  The output is rounded to
// bf16 once, so every element stays within one bf16 rounding of the fp32
// result plus the fp32 tolerance.
//
// Training (kernels/flash_attention.py FlashAttention) asks both designs
// for each row's log-sum-exp in fp32 as well, which the backward
// (flash_attention_bwd.cu) recomputes P from; serving passes a null
// pointer and nothing more is written.
//
// This file must never be built with --use_fast_math (expf stays exact to
// an ulp or two; the 2e-5 fp32 tolerance depends on it).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kBQ = 128;           // query rows per CTA, both designs

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
  int vec;     // fp32: every pointer, stride and hd allow 16-byte copies
  float* lse;  // (B, H, S) per-row log-sum-exp, or null: none is written
};

// Key tiles [lo, hi) of width bk that rows [q0, q0 + rows) can see.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int rows,
                                          int bk, int& lo, int& hi) {
  const int khi = p.causal ? min(q0 + rows, p.T) : p.T;
  const int klo = p.window > 0 ? max(q0 + 1 - p.window, 0) : 0;
  lo = klo / bk;
  hi = (khi + bk - 1) / bk;
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.T && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// Whether some (row, key) of rows [q0, q0 + rows) x keys [k0, k0 + bk) is
// masked, so the tile needs the per-element mask.
__device__ __forceinline__ bool tile_masked(const Params& p, int q0, int rows,
                                            int k0, int bk) {
  return k0 + bk > p.T || (p.causal && k0 + bk - 1 > q0) ||
         (p.window > 0 && q0 + rows - 1 - k0 >= p.window);
}

// ---------------------------------------------------------------------------
// fp32: register-tiled FFMA
// ---------------------------------------------------------------------------

namespace ffma {

using sm90::smem_u32;

constexpr int kBK = 64;        // key rows per K/V tile
constexpr int kThreads = 256;  // 16 x 16: ty picks 8 rows, tx the columns
constexpr int kRows = 8;       // query rows per thread
constexpr int kCols = 4;       // logit columns per thread: tx + 16 j

template <int D>
struct Layout {
  // Q rows are read by all the threads of a quarter-warp at once (a
  // broadcast), K rows by 8 threads on 8 rows: only K's stride is padded
  static constexpr int kKStride = D + 4;
  static constexpr int kQ = kBQ * D;
  static constexpr int kK = kBK * kKStride;     // one K stage
  static constexpr int kV = kBK * D;            // one V stage
  static constexpr int kP = kBQ * kBK;
  static constexpr int kFloats = kQ + 2 * kK + 2 * kV + kP;  // 226 KiB at 128
  // output columns per thread: float4 groups tx*4 + 64 g when D is a
  // multiple of 64, else single columns tx + 16 c
  static constexpr bool kVec4 = D % 64 == 0;
  static constexpr int kOC = D / 16;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of a (rows, hd) slab with row stride rs into
// shared memory (row stride ss, D columns); rows >= n and columns >= hd
// are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ss, const float* src,
                                          long long rs, int r0, int n, int hd,
                                          bool vec) {
  if (vec) {
    constexpr int kC = D / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * kC; i += kThreads) {
      const int r = i / kC, c = (i % kC) * 4;
      const bool ok = r0 + r < n && c < hd;
      cp_async16(dst + r * ss + c, ok ? src + (r0 + r) * rs + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = r0 + r < n && c < hd;
      cp_async4(dst + r * ss + c, ok ? src + (r0 + r) * rs + c : src, ok);
    }
  }
}

template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  return Layout<D>::kVec4 ? 64 * (c / 4) + tx * 4 + (c % 4) : tx + 16 * c;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_ffma_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + L::kQ;
  float* Vs = Ks + 2 * L::kK;
  float* Ps = Vs + 2 * L::kV;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first

  const float* qg = static_cast<const float*>(p.q) + b * p.sq_b + h * p.sq_h;
  const float* kg = static_cast<const float*>(p.k) + b * p.sk_b + kvh * p.sk_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv_b + kvh * p.sv_h;
  const bool vec = p.vec != 0;

  int kt_lo, kt_hi;
  key_tiles(p, q0, kBQ, kBK, kt_lo, kt_hi);

  load_rows<D, kBQ>(Qs, D, qg, p.sq_s, q0, p.S, p.hd, vec);
  if (kt_lo < kt_hi) {
    load_rows<D, kBK>(Ks, L::kKStride, kg, p.sk_t, kt_lo * kBK, p.T, p.hd,
                      vec);
    load_rows<D, kBK>(Vs, D, vg, p.sv_t, kt_lo * kBK, p.T, p.hd, vec);
  }
  cp_async_commit();

  float m[kRows], l[kRows], acc[kRows][L::kOC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;  // this thread's share of the row sum
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    const int k0 = kt * kBK;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every read of tile kt - 1 is done
    if (kt + 1 < kt_hi) {
      load_rows<D, kBK>(Ks + (st ^ 1) * L::kK, L::kKStride, kg, p.sk_t,
                        k0 + kBK, p.T, p.hd, vec);
      load_rows<D, kBK>(Vs + (st ^ 1) * L::kV, D, vg, p.sv_t, k0 + kBK, p.T,
                        p.hd, vec);
    }
    cp_async_commit();
    const float* Kt = Ks + st * L::kK;
    const float* Vt = Vs + st * L::kV;

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &Kt[(tx + 16 * j) * L::kKStride + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&Qs[(ty * kRows + i) * D + d]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // scale and mask, then the online softmax update, all rows at once so
    // their shuffles overlap
    const bool masked = tile_masked(p, q0, kBQ, k0, kBK);
    float mx[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      mx[i] = m[i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * p.scale;
        if (masked && !visible(p, q0 + ty * kRows + i, k0 + tx + 16 * j))
          x = kNegInf;
        s[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float alpha = expf(m[i] - mx[i]);
      m[i] = mx[i];
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - mx[i]);
        rsum += s[i][j];
        Ps[(ty * kRows + i) * kBK + tx + 16 * j] = s[i][j];
      }
      l[i] = alpha * l[i] + rsum;
#pragma unroll
      for (int c = 0; c < L::kOC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; t += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &Ps[(ty * kRows + i) * kBK + t]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[L::kOC];
        const float* vrow = Vt + (t + u) * D;
        if (L::kVec4) {
#pragma unroll
          for (int g = 0; g < L::kOC / 4; ++g) {
            const float4 x =
                *reinterpret_cast<const float4*>(&vrow[64 * g + tx * 4]);
            vv[4 * g] = x.x;
            vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z;
            vv[4 * g + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < L::kOC; ++c) vv[c] = vrow[tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float pu = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                         : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < L::kOC; ++c)
            acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
  }

  // o is contiguous (B, S, H, hd)
  float* og = static_cast<float*>(p.o) +
              (static_cast<long long>(b) * p.S * p.H + h) * p.hd;
  const long long so = static_cast<long long>(p.H) * p.hd;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float lsum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const int s = q0 + ty * kRows + i;
    if (s >= p.S) continue;
    // a row that saw no key kept m = kNegInf: its lse is -inf
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.S + s] =
          m[i] <= kNegInf ? -INFINITY : m[i] + logf(lsum);
    const float denom = fmaxf(lsum, 1e-30f);
    float* orow = og + s * so;
    if (L::kVec4 && p.hd % 4 == 0) {
#pragma unroll
      for (int g = 0; g < L::kOC / 4; ++g) {
        const int d = 64 * g + tx * 4;
        if (d < p.hd)
          *reinterpret_cast<float4*>(&orow[d]) = make_float4(
              acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
              acc[i][4 * g + 2] / denom, acc[i][4 * g + 3] / denom);
      }
    } else {
#pragma unroll
      for (int c = 0; c < L::kOC; ++c) {
        const int d = out_col<D>(tx, c);
        if (d < p.hd) orow[d] = acc[i][c] / denom;
      }
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * Layout<D>::kFloats;
  // set on every launch: the attribute is per device, and it is cheap
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_ffma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.S + kBQ - 1) / kBQ);
  flash_fwd_ffma_kernel<D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.hd <= 16) return launch<16>(p, stream);
  if (p.hd <= 32) return launch<32>(p, stream);
  if (p.hd <= 64) return launch<64>(p, stream);
  if (p.hd <= 80) return launch<80>(p, stream);
  if (p.hd <= 96) return launch<96>(p, stream);
  return launch<128>(p, stream);
}

}  // namespace ffma

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace sm90;

constexpr int kBK = 64;          // key rows per K/V tile
constexpr int kStages = 3;       // K/V ring
constexpr int kConsumers = 256;  // 2 consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and a producer warp

template <int D>
struct Layout {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kOStride = D + 8;        // output staging (bf16)
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kO = kV + kStages * kKVBytes;  // 2 x 64 rows
  static constexpr int kBar = kO + 2 * 64 * kOStride * 2;
  // the mbarriers (Q, full and empty per stage), and slack to align the
  // base to the 1024-byte swizzle atom: 163 KiB at D = 128
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

// O += (hi + lo) V: per 16 keys, two m64nDk16 steps with P from registers
// and V MN-major (its boxes of 64 head-dim columns lie kBK * 128 bytes
// apart, its 8-key groups 1024 bytes apart).
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&phi)[kBK / 16][4],
                                           const uint32_t (&plo)[kBK / 16][4],
                                           uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dv = sw128_desc(v_tile + kk * 16 * 128, kBK * 128, 1024);
    wgmma_rs(o, phi[kk], dv);
    wgmma_rs(o, plo[kk], dv);
  }
}

// A masked logit before scaling.  A power of two, so that its product with
// the scale is exact and a row with every key masked so far gets p =
// exp2(fma(kMasked, c, -kMasked c)) = 1 exactly, as the reference's
// exp(-1e30 - -1e30) does; any visible key then takes its weight to 0.
constexpr float kMasked = -0x1p100f;

// The online softmax of one tile in this thread's rows rA and rA + 8:
// masks the logits in s, turns them into probabilities p = 2^(c s - m)
// with c the softmax scale times log2(e) (one FMA and one exp2 each) and
// updates the running max m (log2 domain) and sum l (this thread's share;
// the quad's shares are added at the end).  Returns the factors the rows'
// accumulators must be scaled by.  s[4i + e] is (row rA, key k0 + 8i + 2
// (lane % 4) + e), s[4i + 2 + e] the same key of rA + 8.
__device__ __forceinline__ float2 softmax_tile(float (&s)[kBK / 2],
                                               const Params& p, int k0,
                                               int wq0, int rA, int lane,
                                               float scale_log2, float& mA,
                                               float& mB, float& lA,
                                               float& lB) {
  const bool masked = tile_masked(p, wq0, 64, k0, kBK);
  float xA = kMasked, xB = kMasked;
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kpos = k0 + 8 * i + 2 * (lane % 4) + e;
      if (masked) {
        if (!visible(p, rA, kpos)) s[4 * i + e] = kMasked;
        if (!visible(p, rA + 8, kpos)) s[4 * i + 2 + e] = kMasked;
      }
      xA = fmaxf(xA, s[4 * i + e]);
      xB = fmaxf(xB, s[4 * i + 2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, off));
    xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, off));
  }
  xA = fmaxf(mA, xA * scale_log2);
  xB = fmaxf(mB, xB * scale_log2);
  const float2 alpha = make_float2(ex2(mA - xA), ex2(mB - xB));
  mA = xA;
  mB = xB;
  float sumA = 0.f, sumB = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * i + e] = ex2(fmaf(s[4 * i + e], scale_log2, -mA));
      s[4 * i + 2 + e] = ex2(fmaf(s[4 * i + 2 + e], scale_log2, -mB));
      sumA += s[4 * i + e];
      sumB += s[4 * i + 2 + e];
    }
  }
  lA = alpha.x * lA + sumA;
  lB = alpha.y * lB + sumB;
  return alpha;
}

// P as the A operand of the PV product: the accumulator layout of keys
// 16 kk .. + 15 is the register-A layout of a k16 step.  hi = bf16(P) and
// lo = bf16(P - hi).
__device__ __forceinline__ void split_p(const float (&s)[kBK / 2],
                                        uint32_t (&phi)[kBK / 16][4],
                                        uint32_t (&plo)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      phi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[kk][r] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
  }
}

// Shared memory per CTA: Q (128 x D) and a ring of K and V stages (64 x
// D), each as 64-column boxes of 128-byte rows swizzled by TMA; the output
// staging of each consumer warpgroup; the mbarriers.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const Params p) {
  using L = Layout<D>;
  constexpr int kBoxes = D / kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;    // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  int kt_lo, kt_hi;
  key_tiles(p, q0, kBQ, kBK, kt_lo, kt_hi);
  const int n_tiles = max(kt_hi - kt_lo, 0);

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
    // producer: one thread issues every TMA load
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int x = 0; x < kBoxes; ++x)
        tma_load(sQ + x * kBQ * 128, &qmap, bar_q, x * kBox, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int k0 = (kt_lo + it) * kBK;
        mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * L::kKVBytes);
        for (int x = 0; x < kBoxes; ++x) {
          const uint32_t off = st * L::kKVBytes + x * kBK * 128;
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
    const float scale_log2 = p.scale * 1.4426950408889634f;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;  // log2 domain

    mbar_wait(bar_q, 0);
    const uint32_t q_rows = sQ + wg * 64 * 128;
    // this warpgroup's live tiles [lo, hi): the ones before lo lie before
    // the window of all its 64 rows, the ones from hi on past its diagonal;
    // it waits for the others only to release them
    auto dead = [&](int it) {
      const int k0 = (kt_lo + it) * kBK;
      return (p.causal && k0 > wq0 + 63) ||
             (p.window > 0 && wq0 - (k0 + kBK - 1) >= p.window);
    };
    int lo = 0, hi = n_tiles;
    while (lo < hi && dead(lo)) ++lo;
    while (hi > lo && dead(hi - 1)) --hi;
    auto skip = [&](int it) {
      mbar_wait(bar_full + 8 * (it % kStages), (it / kStages) & 1);
      mbar_arrive(bar_empty + 8 * (it % kStages));
    };
    for (int it = 0; it < lo; ++it) skip(it);
    if (lo < hi) {
      float s[kBK / 2];
      // P of the tile before: the A operand of its PV product
      uint32_t phi[kBK / 16][4], plo[kBK / 16][4];
      int st = lo % kStages;
      mbar_wait(bar_full + 8 * st, (lo / kStages) & 1);
      wgmma_fence();
      wgmma_abt<D, kBQ, kBK>(s, q_rows, sK + st * L::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, p, (kt_lo + lo) * kBK, wq0, rA, lane, scale_log2, mA,
                   mB, lA, lB);  // o is still zero: nothing to rescale
      split_p(s, phi, plo);
      // then a tile's S = Q K^T and the tile before's PV product run on
      // the tensor cores together, and the softmax overlaps the PV product
      for (int it = lo + 1; it < hi; ++it) {
        const int prev = st;
        st = it % kStages;
        mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
        wgmma_fence();
        wgmma_abt<D, kBQ, kBK>(s, q_rows, sK + st * L::kKVBytes);
        wgmma_commit();
        pv_product<D>(o, phi, plo, sV + prev * L::kKVBytes);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        const float2 alpha = softmax_tile(s, p, (kt_lo + it) * kBK, wq0, rA,
                                          lane, scale_log2, mA, mB, lA, lB);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(phi);
        fence_regs(plo);
        mbar_arrive(bar_empty + 8 * prev);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[4 * i] *= alpha.x;
          o[4 * i + 1] *= alpha.x;
          o[4 * i + 2] *= alpha.y;
          o[4 * i + 3] *= alpha.y;
        }
        split_p(s, phi, plo);
      }
      wgmma_fence();
      pv_product<D>(o, phi, plo, sV + st * L::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(bar_empty + 8 * st);
    }
    for (int it = hi; it < n_tiles; ++it) skip(it);

    // the row sums over the quad, then the output through shared memory
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      lA += __shfl_xor_sync(0xffffffffu, lA, off);
      lB += __shfl_xor_sync(0xffffffffu, lB, off);
    }
    const float dA = fmaxf(lA, 1e-30f), dB = fmaxf(lB, 1e-30f);
    // lse = ln 2 (m + log2 l); a row that saw no visible key has m at or
    // below kMasked times the scale (every logit masked) or kNegInf (no
    // tile): its lse is -inf
    if (p.lse != nullptr && lane % 4 == 0) {
      float* lrow = p.lse + (static_cast<long long>(b) * p.H + h) * p.S;
      if (rA < p.S)
        lrow[rA] = mA < -1e20f ? -INFINITY
                               : (mA + log2f(lA)) * 0.6931471805599453f;
      if (rA + 8 < p.S)
        lrow[rA + 8] = mB < -1e20f ? -INFINITY
                                   : (mB + log2f(lB)) * 0.6931471805599453f;
    }
    __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(
        smem + L::kO + wg * 64 * L::kOStride * 2);
    const int rr = (wt / 32) * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(&os[rr * L::kOStride + c]) =
          pack_bf16(o[4 * i] / dA, o[4 * i + 1] / dA);
      *reinterpret_cast<uint32_t*>(&os[(rr + 8) * L::kOStride + c]) =
          pack_bf16(o[4 * i + 2] / dB, o[4 * i + 3] / dB);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                        (static_cast<long long>(b) * p.S * p.H + h) * p.hd;
    const long long so = static_cast<long long>(p.H) * p.hd;
    const int rows = min(64, p.S - wq0);
    if (p.hd % 8 == 0) {
      const int cpr = p.hd / 8;  // 16-byte chunks per row
      for (int i = wt; i < rows * cpr; i += 128) {
        const int r = i / cpr, c = (i % cpr) * 8;
        *reinterpret_cast<uint4*>(&og[(wq0 + r) * so + c]) =
            *reinterpret_cast<const uint4*>(&os[r * L::kOStride + c]);
      }
    } else {
      for (int i = wt; i < rows * p.hd; i += 128) {
        const int r = i / p.hd, c = i % p.hd;
        og[(wq0 + r) * so + c] = os[r * L::kOStride + c];
      }
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, p.q, p.hd, p.H, p.S, p.B, p.sq_h, p.sq_s, p.sq_b,
                kBQ) ||
      !make_map(&km, p.k, p.hd, p.KV, p.T, p.B, p.sk_h, p.sk_t, p.sk_b,
                kBK) ||
      !make_map(&vm, p.v, p.hd, p.KV, p.T, p.B, p.sv_h, p.sv_t, p.sv_b, kBK))
    return cudaErrorInvalidValue;
  constexpr int bytes = Layout<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.S + kBQ - 1) / kBQ);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, bytes, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (!tma_ok(p.q, p.sq_b, p.B, p.sq_s, p.S, p.sq_h, p.H) ||
      !tma_ok(p.k, p.sk_b, p.B, p.sk_t, p.T, p.sk_h, p.KV) ||
      !tma_ok(p.v, p.sv_b, p.B, p.sv_t, p.T, p.sv_h, p.KV))
    return cudaErrorInvalidValue;
  return p.hd <= 64 ? launch<64>(p, stream) : launch<128>(p, stream);
}

}  // namespace tc

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dim of q, k and v has stride 1 and o is contiguous (B, S, H, hd).  lse,
// when not null, receives each row's float32 log-sum-exp as (B, H, S)
// (-inf for a row that sees no key), for the backward.
// bfloat16 operands also need TMA's 16-byte rule (tc::tma_ok).  Returns
// the CUDA error of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int S, int T, int H, int KV, int hd,
                        long long sq_b, long long sq_s, long long sq_h,
                        long long sk_b, long long sk_t, long long sk_h,
                        long long sv_b, long long sv_t, long long sv_h,
                        int causal, int window, float scale, float* lse,
                        void* stream) {
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0 || B < 1 || S < 1 ||
      T < 1 || static_cast<long long>(B) * H > 2147483647LL ||
      (S + kBQ - 1) / kBQ > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   hd % 4 == 0 && sq_b % 4 == 0 && sq_s % 4 == 0 &&
                   sq_h % 4 == 0 && sk_b % 4 == 0 && sk_t % 4 == 0 &&
                   sk_h % 4 == 0 && sv_b % 4 == 0 && sv_t % 4 == 0 &&
                   sv_h % 4 == 0;
  const Params p{q,    k,    v,    o,    B,      S,      T,     H,
                 KV,   hd,   sq_b, sq_s, sq_h,   sk_b,   sk_t,  sk_h,
                 sv_b, sv_t, sv_h, causal, window, scale, vec, lse};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? ffma::dispatch(p, st)
                                     : tc::dispatch(p, st);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
