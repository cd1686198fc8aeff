// 3xTF32 products on the tensor cores (mma.sync m16n8k8) and the cp.async
// copies that feed them, shared by the fp32 designs of the chunk scans
// (chunk_scan.cuh: ssd.cu, wkv6.cu) and of the flash-attention backward
// (flash_attention_bwd.cu).
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
// agree.  Under the order that reads k slot q as k = 2q and slot q + 4 as
// 2q + 1, D's (d0, d2, d1, d3) are A's (a0, a1, a2, a3): an accumulator
// tile is the A operand of the next product without any shuffle.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// cp.async copies into shared memory; !ok zero-fills the destination
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

// d += a b on TF32 operands (their bits past TF32's are ignored)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}


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

}  // namespace tf32
