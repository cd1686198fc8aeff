// Pieces shared by the chunk-scan kernels (ssd.cu, wkv6.cu): the tile
// layout and loader; the 3xTF32 products come from tf32_mma.cuh.
//
// Tiles.  A chunk's (32, 64) operand tile is held in shared memory in its
// input type (f32 or bf16) without padding; element (row, col) sits at
// row * 64 + (col ^ 8 (row & 3)).  The XOR keeps groups of 16 bytes
// together (the copies) and makes both fragment reads of the kernels
// conflict-free for f32: two neighbours at (row g, col 8 k + 2 q) for the
// 8 rows g and 4 column pairs q of a warp, and one value at (row 8 k + q,
// col c0 + g).  For bf16 the first read meets 2-way conflicts.
//
// Products: 3xTF32 on mma.sync (tf32_mma.cuh).  The kernels read k slot
// q as k = 2q and slot q + 4 as 2q + 1 where that lets them load a
// float2, or take an accumulator tile (D layout) as the A operand of the
// next product without any shuffle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "tf32_mma.cuh"

namespace chunk_scan {

using namespace tf32;

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
