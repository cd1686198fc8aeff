// Pieces shared by the chunk-scan kernels (ssd.cu, wkv6.cu): the tile
// layout and loader, and 3xTF32 products on the tensor cores.
//
// Tiles.  A chunk's (32, 64) operand tile is held in shared memory in its
// input type (f32 or bf16) without padding; element (row, col) sits at
// row * 64 + (col ^ 8 (row & 3)).  The XOR keeps groups of 16 bytes
// together (the copies) and makes both fragment reads of the kernels
// conflict-free for f32: two neighbours at (row g, col 8 k + 2 q) for the
// 8 rows g and 4 column pairs q of a warp, and one value at (row 8 k + q,
// col c0 + g).  For bf16 the first read meets 2-way conflicts.
//
// Products.  mma.sync m16n8k8 with TF32 inputs and f32 accumulation.
// TF32 keeps 10 mantissa bits, too few for the fp32 tolerance, so each
// f32 operand x is split into hi = tf32(x), rounded to nearest, and lo =
// x - hi (exact in f32; the tensor cores read its top 10 mantissa bits),
// and a product is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (3xTF32):
// what is dropped or cut is at most about 2^-21 of the product, and of
// either sign (lo is).  An operand that came from bf16 is exact in TF32
// (lo = 0), so its lo terms are skipped.
//
// Fragments (PTX ISA, m16n8k8 .tf32), with g = lane / 4, q = lane % 4:
//   A (16 x 8):  a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8):   b0 (q, g), b1 (q + 4, g)
//   D (16 x 8):  d0 (g, 2q), d1 (g, 2q + 1), d2 (g + 8, 2q), d3 (g + 8, 2q + 1)
// The order of the k index inside a step is free, as long as A and B
// agree.  The kernels read k slot q as k = 2q and slot q + 4 as 2q + 1
// where that lets them load a float2, or take an accumulator tile (D
// layout) as the A operand of the next product without any shuffle: D's
// (d0, d2, d1, d3) are A's (a0, a1, a2, a3) under that order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace chunk_scan {

constexpr int kChunk = 32;    // tokens per chunk
constexpr int kDim = 64;      // P, N, head size: padded to 64 inside
constexpr int kThreads = 128; // four warps, each 16 rows of a state
constexpr int kTile = kChunk * kDim;

__device__ __forceinline__ int swz(int row, int col) {
  return row * kDim + (col ^ ((row & 3) << 3));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// end of the PTX wrappers
// ---------------------------------------------------------------------------

// f32 bits rounded to the nearest TF32, ties away from zero (as cvt.rna;
// the operands here are finite)
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x as hi (+ lo when LO)
template <bool LO>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (LO) {
    hi = tf32_rna(__float_as_uint(x));
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);  // exact in TF32 already
    lo = 0u;
  }
}

// An operand fragment split into TF32 hi and lo; lo is kept only when LO.
template <bool LO>
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split<LO>(a0, hi[0], lo[0]);
    split<LO>(a1, hi[1], lo[1]);
    split<LO>(a2, hi[2], lo[2]);
    split<LO>(a3, hi[3], lo[3]);
  }
};

template <bool LO>
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split<LO>(b0, hi[0], lo[0]);
    split<LO>(b1, hi[1], lo[1]);
  }
};

// d += a b in 3xTF32 (the small terms first), dropping the terms whose lo
// is known to be zero.
template <bool ALO, bool BLO>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA<ALO>& a,
                                     const FragB<BLO>& b) {
  if (ALO) mma_tf32(d, a.lo, b.hi);
  if (BLO) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// How a (32, 64) tile comes from device memory into shared memory, in its
// own type: 16-byte cp.async (16-byte aligned rows, the valid columns a
// multiple of 16 bytes), 4-byte cp.async (any f32), or plain loads (any
// bf16; no cp.async is narrower than 4 bytes).
enum LoadMode { kVec16 = 0, kElem4 = 1, kPlain = 2 };

// Rows [0, rows) and columns [0, cols) of a tile whose row r starts at
// src + r * rs into the swizzled tile dst of the same type; the rest is
// zero.  The CTA's NT threads share the copies.
template <int NT = kThreads, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          int rows, int cols, int mode) {
  const int tid = threadIdx.x;
  if (mode == kVec16) {
    // thread tid copies the 16 bytes at column c of rows r0, r0 + step, ..
    constexpr int kPer = 16 / sizeof(T), kPerRow = kDim / kPer;
    constexpr int kStep = NT / kPerRow;
    const int r0 = tid / kPerRow, c = (tid % kPerRow) * kPer;
    const T* sp = src + r0 * rs + c;
#pragma unroll
    for (int m = 0; m < (kChunk + kStep - 1) / kStep; ++m) {
      const int r = r0 + kStep * m;
      const bool ok = r < rows && c < cols;
      if (r < kChunk)
        cp_async16(dst + swz(r, c), ok ? sp + kStep * m * rs : src, ok);
    }
  } else if (sizeof(T) == 4 && mode == kElem4) {
    for (int e = tid; e < kTile; e += NT) {
      const int r = e / kDim, c = e % kDim;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + swz(r, c), ok ? src + r * rs + c : src, ok);
    }
  } else {
    for (int e = tid; e < kTile; e += NT) {
      const int r = e / kDim, c = e % kDim;
      dst[swz(r, c)] = (r < rows && c < cols) ? src[r * rs + c] : T(0.f);
    }
  }
}

// Reads of a swizzled tile as f32: one value, two (col even) or four (col
// a multiple of 4) neighbours in a row.
__device__ __forceinline__ float ldf(const float* t, int row, int col) {
  return t[swz(row, col)];
}
__device__ __forceinline__ float ldf(const __nv_bfloat16* t, int row,
                                     int col) {
  return __bfloat162float(t[swz(row, col)]);
}
__device__ __forceinline__ float2 ldf2(const float* t, int row, int col) {
  return *reinterpret_cast<const float2*>(t + swz(row, col));
}
__device__ __forceinline__ float2 ldf2(const __nv_bfloat16* t, int row,
                                       int col) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(t + swz(row, col));
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float4 ldf4(const float* t, int row, int col) {
  return *reinterpret_cast<const float4*>(t + swz(row, col));
}
__device__ __forceinline__ float4 ldf4(const __nv_bfloat16* t, int row,
                                       int col) {
  const uint2 u = *reinterpret_cast<const uint2*>(t + swz(row, col));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The LoadMode of a tile of T (f32 or bf16) with `cols` valid columns
// from `ptr`, whose rows step by multiples of `strides` (elements).
template <typename T>
inline int load_mode(const void* ptr, int cols,
                     std::initializer_list<long long> strides) {
  const int per16 = 16 / static_cast<int>(sizeof(T));  // elements in 16 B
  bool vec = reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && cols % per16 == 0;
  for (long long s : strides) vec = vec && s % per16 == 0;
  return vec ? kVec16 : sizeof(T) == 4 ? kElem4 : kPlain;
}

}  // namespace chunk_scan
