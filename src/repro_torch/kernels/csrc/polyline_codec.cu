// Blockwise quantize codec for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces src/repro/kernels/polyline_codec.py:_compress_kernel and
// _decompress_kernel (the Pallas TPU kernels behind compress_blocks /
// decompress_blocks), the lossy step of the quantize8 / quantize16 link
// codecs, which FedAT's fused round runs twice per committed update
// (downlink and uplink).
//
// What it computes, for every 256-value block of a flat float32 vector
// (blocks start at offset 0; the ragged tail reads as zeros):
//   scale = max(max|x| * fl32(1/qmax), 1e-30)     (NaN if the block holds one)
//   q     = clamp(round_half_even(x / scale), -qmax, qmax)   as int8 or int16
// and decompress writes x = float(q) * scale.
//
// Bitwise agreement with the JAX reference fixes the arithmetic:
//   * the scale is a multiply by the float reciprocal of qmax, because XLA
//     rewrites max|x| / qmax into that form inside jit, which is how the
//     reference engine runs the codec;
//   * q uses a true IEEE division (__fdiv_rn), which XLA keeps as a division;
//   * __float2int_rn rounds half to even, as jnp.round does (roundf would
//     round half away from zero);
//   * this file must never be built with --use_fast_math.
//
// What bounds it: memory bandwidth. Compress reads 4 B and writes about
// 1.016 B (int8 + one f32 scale per 256 values) per value; decompress the
// reverse. There is no reuse to exploit, so the design is one simple pass:
// one warp per codec block, each lane holding 8 values loaded as two
// coalesced float4 reads, the block max by warp shuffle, and vector stores
// of the codes. At the model sizes of the federated path (about 10^5..10^6
// values per leaf) a launch costs more than the bytes; fusing the
// quantize-dequantize roundtrip into one kernel over all leaves is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;        // values per codec block (one scale)
constexpr int kWarpsPerCta = 8;    // codec blocks per CTA (one warp each)

template <typename QT> struct Vec4;
template <> struct Vec4<int8_t> { using type = char4; };
template <> struct Vec4<int16_t> { using type = short4; };

__device__ __forceinline__ int quantize(float x, float scale, int qmax) {
  int q = __float2int_rn(__fdiv_rn(x, scale));
  return max(-qmax, min(qmax, q));
}

// Lane l of the warp owns values [4l, 4l+4) and [128+4l, 128+4l+4) of its
// block: two fully coalesced 512-byte loads per warp.
__device__ __forceinline__ int64_t lane_index(int64_t base, int lane, int j) {
  return base + (j < 4 ? 4 * lane + j : 128 + 4 * lane + (j - 4));
}

template <typename QT>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
compress_kernel(const float* __restrict__ x, int64_t n, int64_t nblocks,
                QT* __restrict__ q, float* __restrict__ scale, int qmax,
                float inv_qmax) {
  const int lane = threadIdx.x & 31;
  const int64_t blk =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= nblocks) return;  // whole warp leaves together
  const int64_t base = blk * kBlock;

  float v[8];
  const bool vec = base + kBlock <= n &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    const float4 a = x4[lane];
    const float4 b = x4[32 + lane];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t i = lane_index(base, lane, j);
      v[j] = i < n ? x[i] : 0.0f;
    }
  }

  float amax = 0.0f;
  bool nan = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    amax = fmaxf(amax, fabsf(v[j]));
    nan |= isnan(v[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  // fmaxf drops NaN; the reference's max propagates it into the scale
  nan = __any_sync(0xffffffffu, nan);
  const float s = nan ? __int_as_float(0x7fc00000)
                      : fmaxf(amax * inv_qmax, 1e-30f);

  using V = typename Vec4<QT>::type;
  V lo, hi;
  lo.x = static_cast<QT>(quantize(v[0], s, qmax));
  lo.y = static_cast<QT>(quantize(v[1], s, qmax));
  lo.z = static_cast<QT>(quantize(v[2], s, qmax));
  lo.w = static_cast<QT>(quantize(v[3], s, qmax));
  hi.x = static_cast<QT>(quantize(v[4], s, qmax));
  hi.y = static_cast<QT>(quantize(v[5], s, qmax));
  hi.z = static_cast<QT>(quantize(v[6], s, qmax));
  hi.w = static_cast<QT>(quantize(v[7], s, qmax));
  // q holds nblocks * 256 codes (tail codes are those of x = 0), and its
  // block starts are 256-element aligned, so the vector stores are aligned
  V* q4 = reinterpret_cast<V*>(q + base);
  q4[lane] = lo;
  q4[32 + lane] = hi;
  if (lane == 0) scale[blk] = s;
}

template <typename QT>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
decompress_kernel(const QT* __restrict__ q, const float* __restrict__ scale,
                  int64_t n, int64_t nblocks, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t blk =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= nblocks) return;
  const int64_t base = blk * kBlock;
  const float s = scale[blk];

  using V = typename Vec4<QT>::type;
  const V* q4 = reinterpret_cast<const V*>(q + base);
  const V lo = q4[lane];
  const V hi = q4[32 + lane];
  float v[8];
  v[0] = static_cast<float>(lo.x) * s; v[1] = static_cast<float>(lo.y) * s;
  v[2] = static_cast<float>(lo.z) * s; v[3] = static_cast<float>(lo.w) * s;
  v[4] = static_cast<float>(hi.x) * s; v[5] = static_cast<float>(hi.y) * s;
  v[6] = static_cast<float>(hi.z) * s; v[7] = static_cast<float>(hi.w) * s;

  const bool vec = base + kBlock <= n &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (vec) {
    float4* o4 = reinterpret_cast<float4*>(out + base);
    o4[lane] = make_float4(v[0], v[1], v[2], v[3]);
    o4[32 + lane] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t i = lane_index(base, lane, j);
      if (i < n) out[i] = v[j];
    }
  }
}

int64_t n_blocks(long long n) { return (static_cast<int64_t>(n) + kBlock - 1) / kBlock; }

dim3 grid_for(int64_t nblocks) {
  return dim3(static_cast<unsigned>((nblocks + kWarpsPerCta - 1) / kWarpsPerCta));
}

}  // namespace

extern "C" {

// x: n float32 values; q: ceil(n/256)*256 codes (int8 if bits <= 8, else
// int16); scale: ceil(n/256) float32. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
int codec_compress(const float* x, long long n, void* q, float* scale,
                   int bits, void* stream) {
  if (bits < 2 || bits > 16 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nb = n_blocks(n);
  if (nb == 0) return 0;
  const int qmax = (1 << (bits - 1)) - 1;
  // correctly rounded float reciprocal, the constant XLA folds 1/qmax into
  const float inv_qmax = 1.0f / static_cast<float>(qmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits <= 8) {
    compress_kernel<int8_t><<<grid_for(nb), kWarpsPerCta * 32, 0, st>>>(
        x, n, nb, static_cast<int8_t*>(q), scale, qmax, inv_qmax);
  } else {
    compress_kernel<int16_t><<<grid_for(nb), kWarpsPerCta * 32, 0, st>>>(
        x, n, nb, static_cast<int16_t*>(q), scale, qmax, inv_qmax);
  }
  return static_cast<int>(cudaGetLastError());
}

// q/scale as written by codec_compress; out: the first n values.
int codec_decompress(const void* q, const float* scale, long long n,
                     float* out, int bits, void* stream) {
  if (bits < 2 || bits > 16 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nb = n_blocks(n);
  if (nb == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits <= 8) {
    decompress_kernel<int8_t><<<grid_for(nb), kWarpsPerCta * 32, 0, st>>>(
        static_cast<const int8_t*>(q), scale, n, nb, out);
  } else {
    decompress_kernel<int16_t><<<grid_for(nb), kWarpsPerCta * 32, 0, st>>>(
        static_cast<const int16_t*>(q), scale, n, nb, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* codec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
