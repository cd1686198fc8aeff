// Pieces shared by the chunk scans' backward kernels (wkv6_bwd.cu,
// ssd_bwd.cu): f32 tiles in shared memory with padded rows, their loads
// and stores, and the product of two such tiles on the tensor cores in
// 3xTF32 (tf32_mma.cuh), with the forward kernels' chunk, padded width and
// CTA (chunk_scan.cuh).
//
// Tiles.  A (32, 64) chunk tile or a (64, 64) state tile is held in f32
// with a row stride of 68 floats, a (32, 32) one with 36: both are 4 mod
// 32, so the fragment reads of a product, (row g, col q) for the 8 rows g
// and 4 columns q of a warp, hit 32 distinct banks whether a tile is read
// as it is or transposed.
//
// Products.  gemm() spreads the 16 x 8 output tiles of one product over
// the CTA's four warps; every warp takes the same tiles in every product
// of the same shape, so a product that adds to another's output needs no
// barrier between the two.  Each 8-deep step's 3xTF32 products go to
// fresh registers and are added to the sum in f32: the tensor cores'
// fp32 accumulation truncates, so a long sum kept in their accumulator
// loses more than the 3xTF32 split keeps.
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

// Rows [0, R) x columns [0, D) of dst (row stride ld) from src, whose row
// r starts at src + r * rs: rows < rows and columns < cols, the rest 0.
template <int R>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long rs, int rows, int cols) {
  for (int e = threadIdx.x; e < R * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[r * ld + c] = (r < rows && c < cols) ? src[r * rs + c] : 0.f;
  }
}

// The inverse: rows < rows and columns < cols of src into dst.
template <int R>
__device__ __forceinline__ void store_rows(float* dst, long long rs,
                                           const float* src, int ld, int rows,
                                           int cols) {
  for (int e = threadIdx.x; e < R * D; e += NT) {
    const int r = e / D, c = e % D;
    if (r < rows && c < cols) dst[r * rs + c] = src[r * ld + c];
  }
}

// out (M x NN, row stride ld) = sum_k a(m, k) b(k, n), all in shared
// memory, with a(m, k) = a[m am + k ak] and b(k, n) = b[k bk + n bn] (so a
// transposed operand is a swap of its two strides).  With ACC the product
// is added to out scaled by row: out = s(m) out + a b, s(m) = rowscale[m],
// or `scale` when rowscale is null.
template <int M, int NN, int K, bool ACC = false>
__device__ __forceinline__ void gemm(float* out, int ld, const float* a,
                                     int am, int ak, const float* b, int bk,
                                     int bn, const float* rowscale = nullptr,
                                     float scale = 1.f) {
  static_assert(M % 16 == 0 && NN % 8 == 0 && K % 8 == 0, "tile sizes");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  constexpr int TN = NN / 8, TILES = M / 16 * TN;
  for (int t = warp; t < TILES; t += NT / 32) {
    const int m0 = t / TN * 16 + g, n0 = t % TN * 8;
    const float* ar = a + m0 * am;            // row g of the tile
    const float* bc = b + (n0 + g) * bn;      // column g of the tile
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int ka = (k0 + q) * ak, kb = (k0 + q) * bk;
      FragA<true> fa;
      fa.set(ar[ka], ar[8 * am + ka], ar[ka + 4 * ak],
             ar[8 * am + ka + 4 * ak]);
      FragB<true> fb;
      fb.set(bc[kb], bc[kb + 4 * bk]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(part, fa, fb);
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] += part[e];
    }
    float* o0 = out + m0 * ld + n0 + 2 * q;  // rows g and g + 8
    float* o1 = o0 + 8 * ld;
    if (ACC) {
      const float s0 = rowscale ? rowscale[m0] : scale;
      const float s1 = rowscale ? rowscale[m0 + 8] : scale;
      o0[0] = s0 * o0[0] + sum[0];
      o0[1] = s0 * o0[1] + sum[1];
      o1[0] = s1 * o1[0] + sum[2];
      o1[1] = s1 * o1[1] + sum[3];
    } else {
      o0[0] = sum[0];
      o0[1] = sum[1];
      o1[0] = sum[2];
      o1[1] = sum[3];
    }
  }
}

}  // namespace scan_bwd
