// Pieces shared by the chunk scans' backward kernels (wkv6_bwd.cu,
// ssd_bwd.cu): f32 tiles in shared memory with padded rows and their
// cp.async loads, products of two tiles on the tensor cores in 3xTF32
// (tf32_mma.cuh) with the output in registers, and warp shuffle sums and
// scans; with the forward kernels' chunk, padded width and CTA
// (chunk_scan.cuh).
//
// Both backward kernels run in two passes.  Pass 1 (*_bwd_dstate) scans
// the chunks in reverse carrying only the gradient of the state, split by
// rows over several CTAs a head, and writes it after every chunk.  Pass 2
// (*_bwd) is one CTA per (batch, head, chunk) with no loop: it reads its
// chunk's start state (the forward's) and that gradient and computes every
// chunk-local gradient.
//
// Tiles.  A (32, 64) chunk tile or a (64, 64) state tile is held in f32
// with a row stride of 68 floats, a (32, 32) one with 36: both are 4 mod
// 32, so the fragment reads (row g, col q) of a product, for the 8 rows g
// and 4 columns q of a warp, hit 32 distinct banks.  Reads of a tile as
// (row q, col g) meet 2-way conflicts there; pass 1's tiles, read only so,
// take strides that are 8 mod 32 instead.
//
// Products.  mma_frag() spreads the m16n8 output tiles of an (M x NN)
// product over the CTA's four warps, warp w taking the column blocks w,
// w + 4, .. of every row block (Tiles); the sums stay in registers, where
// the caller scales, combines and stores them, so every product of the
// same shape gives a thread the same output elements.  Each 8-deep
// step's 3xTF32 products go to fresh registers and are added to the sum
// in f32: the tensor cores' fp32 accumulation truncates, so a long sum
// kept in their accumulator loses more than the 3xTF32 split keeps.
#pragma once

#include "chunk_scan.cuh"

namespace scan_bwd {

using namespace tf32;

constexpr int C = chunk_scan::kChunk;     // tokens per chunk (32)
constexpr int D = chunk_scan::kDim;       // N and P, padded to 64
constexpr int NT = chunk_scan::kThreads;  // four warps
constexpr int LT = D + 4;                 // row stride of (C, D), (D, D)
constexpr int LC = C + 4;                 // row stride of (C, C)
constexpr int kCT = C * LT, kDT = D * LT, kCC = C * LC;
constexpr unsigned kAll = 0xffffffffu;

// Rows [0, R) x columns [0, W) of dst (row stride ld, a multiple of 4)
// from src, whose row r starts at src + r * rs, by cp.async: rows < rows
// and columns < cols are copied, the rest zero-filled.  vec: 16-byte
// copies (src 16-byte aligned, rs and cols multiples of 4), else 4-byte
// ones; T threads share the copies.  The caller commits and waits.
template <int R, int W, int T = NT>
__device__ __forceinline__ void load_async(float* dst, int ld,
                                           const float* src, long long rs,
                                           int rows, int cols, bool vec) {
  if (vec) {
    constexpr int kPer = W / 4;
    for (int e = threadIdx.x; e < R * kPer; e += T) {
      const int r = e / kPer, c = (e % kPer) * 4;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * W; e += T) {
      const int r = e / W, c = e % W;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  }
}

// Two adjacent floats of a row (columns c, c + 1) to global memory: one
// 8-byte store where both are in range and p is 8-byte aligned, else each
// one in range alone
__device__ __forceinline__ void st_pair(float* p, float a, float b, bool ok0,
                                        bool ok1) {
  if (ok0 && ok1 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (ok0) p[0] = a;
    if (ok1) p[1] = b;
  }
}

// Unpadded tiles, rows of W floats (64 or 32), swizzled: element (r, c)
// at r W + (c ^ sx(r)), sx(r) = 8 (r & 3) | (r & 4).  Both fragment reads
// of a product, (row g, col q) and (row q, col g) for the 8 g and 4 q of
// a warp, hit 32 distinct banks, and the XOR keeps each group of four
// floats together (16-byte copies).
__device__ __forceinline__ int sx(int r) { return ((r & 3) << 3) | (r & 4); }

template <int W>
__device__ __forceinline__ int at(int r, int c) {
  return r * W + (c ^ sx(r));
}

// load_async() into a swizzled (R, W) tile
template <int R, int W>
__device__ __forceinline__ void load_async_sw(float* dst, const float* src,
                                              long long rs, int rows,
                                              int cols, bool vec) {
  if (vec) {
    constexpr int kPer = W / 4;
    for (int e = threadIdx.x; e < R * kPer; e += NT) {
      const int r = e / kPer, c = (e % kPer) * 4;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + at<W>(r, c), ok ? src + r * rs + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * W; e += NT) {
      const int r = e / W, c = e % W;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + at<W>(r, c), ok ? src + r * rs + c : src, ok);
    }
  }
}

// The output tiles of an (M x NN) product that each warp owns: all kMB
// row blocks of 16 and kNB column blocks of 8, warp w taking columns 8 (w
// + 4 jn), jn < kNB; tile j is (row block j / kNB, jn = j % kNB)
template <int M, int NN>
struct Tiles {
  static_assert(M % 16 == 0 && NN % 32 == 0, "tile sizes");
  static constexpr int kMB = M / 16, kNB = NN / 32;
  static constexpr int kPer = kMB * kNB;
};

template <int PER>
__device__ __forceinline__ void zero(float (&acc)[PER][4]) {
#pragma unroll
  for (int j = 0; j < PER; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// Operand fragments of an m16n8k8 product at rows (A) or columns (B) m0
// / n0 and depth k0, split into TF32 hi and lo: from element functors a(m,
// k), b(k, n) (read from shared memory, scaled as they are read) ...
template <typename FA>
__device__ __forceinline__ FragA<true> frag_a(FA a, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  FragA<true> f;
  f.set(a(m0 + g, k0 + q), a(m0 + g + 8, k0 + q), a(m0 + g, k0 + q + 4),
        a(m0 + g + 8, k0 + q + 4));
  return f;
}

template <typename FB>
__device__ __forceinline__ FragB<true> frag_b(FB b, int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  FragB<true> f;
  f.set(b(k0 + q, n0 + g), b(k0 + q + 4, n0 + g));
  return f;
}

// ... or by ldmatrix from a tile stored as rows of m (A) or n (B) and
// columns of k, element (r, c) at t[idx(r, c)] with each group of four
// columns 16 contiguous, aligned bytes (the padded and the swizzled
// layouts).  ldmatrix reads 8 x 4-float blocks, lane l giving the address
// of row l & 7 of block l >> 3 and getting the 32-bit element (l / 4, l %
// 4) of each: (g, q) of the fragment.  A's blocks are (rows m0.., m0 +
// 8..) x (columns k0.., k0 + 4..), a0..a3; B's two are columns k0.., k0 +
// 4.. of rows n0...
template <typename IDX>
__device__ __forceinline__ FragA<true> ldsm_a(const float* t, IDX idx,
                                              int m0, int k0) {
  const int l = threadIdx.x & 31;
  const float* p =
      t + idx(m0 + (l & 7) + ((l >> 3) & 1) * 8, k0 + (l >> 4) * 4);
  uint32_t r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  FragA<true> f;
  f.set(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
        __uint_as_float(r[3]));
  return f;
}

template <typename IDX>
__device__ __forceinline__ FragB<true> ldsm_b(const float* t, IDX idx,
                                              int n0, int k0) {
  const int l = threadIdx.x & 15;  // lanes 16-31's addresses are unused
  const float* p = t + idx(n0 + (l & 7), k0 + (l >> 3) * 4);
  uint32_t r[2];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  FragB<true> f;
  f.set(__uint_as_float(r[0]), __uint_as_float(r[1]));
  return f;
}

// Fragment loaders for mma_frag(): of element functors, or of row tiles
template <typename FA>
__device__ __forceinline__ auto elems_a(FA a) {
  return [=](int m0, int k0) { return frag_a(a, m0, k0); };
}
template <typename FB>
__device__ __forceinline__ auto elems_b(FB b) {
  return [=](int n0, int k0) { return frag_b(b, n0, k0); };
}
template <typename IDX>
__device__ __forceinline__ auto rows_a(const float* t, IDX idx) {
  return [=](int m0, int k0) { return ldsm_a(t, idx, m0, k0); };
}
template <typename IDX>
__device__ __forceinline__ auto rows_b(const float* t, IDX idx) {
  return [=](int n0, int k0) { return ldsm_b(t, idx, n0, k0); };
}

// acc += a b over this warp's output tiles, with la(m0, k0) and lb(n0, k0)
// the operands' fragment loaders.  Each 8-deep step loads a row block's A
// fragment once for all its column blocks, and a column block's B
// fragment once for all its rows.
template <int M, int NN, int K, typename LA, typename LB>
__device__ __forceinline__ void mma_frag(
    float (&acc)[Tiles<M, NN>::kPer][4], LA la, LB lb) {
  static_assert(K % 8 == 0, "depth");
  constexpr int MB = Tiles<M, NN>::kMB, NB = Tiles<M, NN>::kNB;
  const int warp = threadIdx.x >> 5;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA<true> fa[MB];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fa[mb] = la(16 * mb, k0);
    FragB<true> fb[NB];
#pragma unroll
    for (int jn = 0; jn < NB; ++jn) fb[jn] = lb(8 * (warp + 4 * jn), k0);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int jn = 0; jn < NB; ++jn) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(part, fa[mb], fb[jn]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mb * NB + jn][e] += part[e];
      }
  }
}

// mma_frag() with the operands' element functors a(m, k), b(k, n)
template <int M, int NN, int K, typename FA, typename FB>
__device__ __forceinline__ void mma_acc(float (&acc)[Tiles<M, NN>::kPer][4],
                                        FA a, FB b) {
  mma_frag<M, NN, K>(acc, elems_a(a), elems_b(b));
}

// f(row, col, value) for every element of this warp's output tiles of an
// (M x NN) product; value is a reference into acc
template <int M, int NN, typename F>
__device__ __forceinline__ void each(float (&acc)[Tiles<M, NN>::kPer][4],
                                     F f) {
  constexpr int NB = Tiles<M, NN>::kNB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < Tiles<M, NN>::kPer; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f(j / NB * 16 + g + 8 * (e >> 1),
        8 * (warp + 4 * (j % NB)) + 2 * q + (e & 1), acc[j][e]);
  }
}

// each() over two products of the same shape: f(row, col, a, o) with a
// and o the elements of acc and other at (row, col)
template <int M, int NN, typename F>
__device__ __forceinline__ void each2(float (&acc)[Tiles<M, NN>::kPer][4],
                                      float (&other)[Tiles<M, NN>::kPer][4],
                                      F f) {
  constexpr int NB = Tiles<M, NN>::kNB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < Tiles<M, NN>::kPer; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f(j / NB * 16 + g + 8 * (e >> 1),
        8 * (warp + 4 * (j % NB)) + 2 * q + (e & 1), acc[j][e],
        other[j][e]);
  }
}

// f(row, col, a0, a1, o0, o1) for every pair of adjacent columns (col,
// col + 1) of this warp's output tiles: a of acc, o of other
template <int M, int NN, typename F>
__device__ __forceinline__ void each_pair(
    float (&acc)[Tiles<M, NN>::kPer][4], float (&other)[Tiles<M, NN>::kPer][4],
    F f) {
  constexpr int NB = Tiles<M, NN>::kNB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < Tiles<M, NN>::kPer; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      f(j / NB * 16 + g + 8 * hh, 8 * (warp + 4 * (j % NB)) + 2 * q,
        acc[j][2 * hh], acc[j][2 * hh + 1], other[j][2 * hh],
        other[j][2 * hh + 1]);
}

// A thread's elements of a (32 x NN) product lie in four rows, row >> 3
// = 0..3 (row & 7 is its g).  Per-row sums rs[row >> 3] over the thread's
// columns are summed over the warp's columns (its four lanes q) and
// written to part[warp * C + row]; the caller adds the four warps' parts
// in order after a barrier.
__device__ __forceinline__ void row_parts(float* part, float (&rs)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = rs[i];
    v += __shfl_xor_sync(kAll, v, 1);
    v += __shfl_xor_sync(kAll, v, 2);
    if ((lane & 3) == 0) part[warp * C + 8 * i + (lane >> 2)] = v;
  }
}

// sum over the warp, the same bits in every lane
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// inclusive prefix sum over the lanes, in order
__device__ __forceinline__ float scan_up(float x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += v;
  }
  return x;
}

// inclusive suffix sum over the lanes: lane t gets the sum over t' >= t
__device__ __forceinline__ float scan_down(float x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(kAll, x, o);
    if (lane + o < 32) x += v;
  }
  return x;
}

}  // namespace scan_bwd
