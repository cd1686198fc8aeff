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
// Three kernels share one set of block functions (load, scale, quantize,
// store), so they agree bit for bit by construction:
//   * compress_kernel / decompress_kernel: the counterparts of the
//     reference's compress_blocks / decompress_blocks, one launch per leaf,
//     with the int codes and scales in device memory;
//   * roundtrip_kernel: decompress(compress(x)) for every leaf of a link in
//     one launch, the lossy step the federated path runs.
//
// What bounds it: launches, then memory. The link's leaves are small (the
// paper CNN's stacked uplink holds 4,791 codec blocks over 10 leaves, the
// downlink 484), so the pair's 20 launches a link cost more than its bytes.
// The roundtrip reads 4 B and writes 4 B per value and keeps no int tensor
// or scale in device memory: the integer step stays in registers. Its
// leaves arrive as a segment table in the kernel parameters (no host-to-
// device copy; 64 leaves of 32 B each), and a warp finds its leaf by a
// warp-uniform binary search over the segments' first blocks. Blocks still
// start at each leaf's offset 0, so a stacked (K, ...) leaf is blocked as
// one tensor and a block may span two clients, as in the reference.
//
// One warp per codec block, each lane holding 8 values loaded as two
// coalesced float4 reads (a masked scalar path for a ragged tail or a
// pointer that is not 16-byte aligned), the block max by warp shuffle.
// The roundtrip CTA is 4 warps of one block each, so every block of both
// links is resident in one wave and the downlink's 484 blocks spread over
// 121 CTAs. The shape hardly matters at these sizes: scripts/
// codec_shapes.py timed 2, 4 and 8 warps a CTA within 1% of each other,
// and 2 or 4 blocks a warp slower on the downlink (0.0045 against 0.0036
// ms a tree); the streaming hints took the L2-cold uplink tree from 0.00615
// to 0.00582 ms (NVIDIA H100 80GB HBM3, 700 W). What is left is about one
// launch (an empty kernel takes 0.0011 ms in the same graph) and the
// latency of one load-reduce-store pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;         // values per codec block (one scale)
constexpr int kWarpsPerCta = 8;     // pair kernels: codec blocks per CTA
constexpr int kRoundtripWarps = 4;  // roundtrip: warps per CTA
constexpr int kRoundtripBlocksPerWarp = 1;  // roundtrip: codec blocks a warp
constexpr int kMaxSegments = 64;    // leaves per roundtrip launch

template <typename QT> struct Vec4;
template <> struct Vec4<int8_t> { using type = char4; };
template <> struct Vec4<int16_t> { using type = short4; };

// One leaf of a roundtrip launch: its blocks are [first, first + ceil(n/256))
// of the launch's grid.
struct Segment {
  const float* x;
  float* out;
  long long n;
  long long first;
};

// Passed by value in the kernel parameters (2,056 B of the 4 KB).
struct SegmentTable {
  Segment seg[kMaxSegments];
  int count;
};

// --- the block arithmetic, shared by all three kernels -----------------------

__device__ __forceinline__ int quantize(float x, float scale, int qmax) {
  int q = __float2int_rn(__fdiv_rn(x, scale));
  return max(-qmax, min(qmax, q));
}

// Lane l of the warp owns values [4l, 4l+4) and [128+4l, 128+4l+4) of its
// block: two fully coalesced 512-byte accesses per warp.
__device__ __forceinline__ int64_t lane_index(int64_t base, int lane, int j) {
  return base + (j < 4 ? 4 * lane + j : 128 + 4 * lane + (j - 4));
}

__device__ __forceinline__ bool whole_aligned(const void* p, int64_t base,
                                              int64_t n) {
  return base + kBlock <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The block at value `base` of x (n values); values past n read as 0.  The
// vector loads and stores carry the streaming hint (evict first): each value
// is touched once.
__device__ __forceinline__ void load_block(const float* __restrict__ x,
                                           int64_t base, int64_t n, int lane,
                                           float v[8]) {
  if (whole_aligned(x, base, n)) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    const float4 a = __ldcs(x4 + lane);
    const float4 b = __ldcs(x4 + 32 + lane);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t i = lane_index(base, lane, j);
      v[j] = i < n ? x[i] : 0.0f;
    }
  }
}

// The values of the block at `base` that lie below n.
__device__ __forceinline__ void store_block(float* __restrict__ out,
                                            int64_t base, int64_t n, int lane,
                                            const float v[8]) {
  if (whole_aligned(out, base, n)) {
    float4* o4 = reinterpret_cast<float4*>(out + base);
    __stcs(o4 + lane, make_float4(v[0], v[1], v[2], v[3]));
    __stcs(o4 + 32 + lane, make_float4(v[4], v[5], v[6], v[7]));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t i = lane_index(base, lane, j);
      if (i < n) out[i] = v[j];
    }
  }
}

// The block's scale, the same in every lane of the warp.
__device__ __forceinline__ float block_scale(const float v[8],
                                             float inv_qmax) {
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
  return nan ? __int_as_float(0x7fc00000) : fmaxf(amax * inv_qmax, 1e-30f);
}

__device__ __forceinline__ float dequantize(int q, float scale) {
  return static_cast<float>(q) * scale;
}

// --- the kernels --------------------------------------------------------------

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
  load_block(x, base, n, lane, v);
  const float s = block_scale(v, inv_qmax);

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
  v[0] = dequantize(lo.x, s); v[1] = dequantize(lo.y, s);
  v[2] = dequantize(lo.z, s); v[3] = dequantize(lo.w, s);
  v[4] = dequantize(hi.x, s); v[5] = dequantize(hi.y, s);
  v[6] = dequantize(hi.z, s); v[7] = dequantize(hi.w, s);
  store_block(out, base, n, lane, v);
}

// The last segment whose first block is <= blk (blk is warp-uniform, so is
// the search).
__device__ __forceinline__ Segment find_segment(const SegmentTable& table,
                                                int64_t blk) {
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.seg[mid].first <= blk) lo = mid; else hi = mid - 1;
  }
  return table.seg[lo];
}

// decompress(compress(x)) for every segment of the table; the int code of
// each value stays in a register (clamped to +-qmax, so casting it to int8 /
// int16 and back, as the pair does, would not change it).  A warp loads
// all its blocks before it quantizes any.
__global__ void __launch_bounds__(kRoundtripWarps * 32)
roundtrip_kernel(const __grid_constant__ SegmentTable table, int64_t nblocks,
                 int qmax, float inv_qmax) {
  constexpr int kB = kRoundtripBlocksPerWarp;
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kRoundtripWarps +
                       (threadIdx.x >> 5);
  Segment seg[kB];
  int64_t base[kB];
  float v[kB][8];
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int64_t blk = warp * kB + b;
    if (blk < nblocks) {
      seg[b] = find_segment(table, blk);
      base[b] = (blk - seg[b].first) * kBlock;
      load_block(seg[b].x, base[b], seg[b].n, lane, v[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    if (warp * kB + b < nblocks) {
      const float s = block_scale(v[b], inv_qmax);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[b][j] = dequantize(quantize(v[b][j], s, qmax), s);
      store_block(seg[b].out, base[b], seg[b].n, lane, v[b]);
    }
  }
}

__global__ void empty_kernel() {}

int64_t n_blocks(long long n) { return (static_cast<int64_t>(n) + kBlock - 1) / kBlock; }

dim3 grid_for(int64_t nblocks, int warps) {
  return dim3(static_cast<unsigned>((nblocks + warps - 1) / warps));
}

bool bad_bits(int bits) { return bits < 2 || bits > 16; }

}  // namespace

extern "C" {

// x: n float32 values; q: ceil(n/256)*256 codes (int8 if bits <= 8, else
// int16); scale: ceil(n/256) float32. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
int codec_compress(const float* x, long long n, void* q, float* scale,
                   int bits, void* stream) {
  if (bad_bits(bits) || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nb = n_blocks(n);
  if (nb == 0) return 0;
  const int qmax = (1 << (bits - 1)) - 1;
  // correctly rounded float reciprocal, the constant XLA folds 1/qmax into
  const float inv_qmax = 1.0f / static_cast<float>(qmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(nb, kWarpsPerCta);
  if (bits <= 8) {
    compress_kernel<int8_t><<<grid, kWarpsPerCta * 32, 0, st>>>(
        x, n, nb, static_cast<int8_t*>(q), scale, qmax, inv_qmax);
  } else {
    compress_kernel<int16_t><<<grid, kWarpsPerCta * 32, 0, st>>>(
        x, n, nb, static_cast<int16_t*>(q), scale, qmax, inv_qmax);
  }
  return static_cast<int>(cudaGetLastError());
}

// q/scale as written by codec_compress; out: the first n values.
int codec_decompress(const void* q, const float* scale, long long n,
                     float* out, int bits, void* stream) {
  if (bad_bits(bits) || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nb = n_blocks(n);
  if (nb == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(nb, kWarpsPerCta);
  if (bits <= 8) {
    decompress_kernel<int8_t><<<grid, kWarpsPerCta * 32, 0, st>>>(
        static_cast<const int8_t*>(q), scale, n, nb, out);
  } else {
    decompress_kernel<int16_t><<<grid, kWarpsPerCta * 32, 0, st>>>(
        static_cast<const int16_t*>(q), scale, n, nb, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// One roundtrip launch over `count` (1..64) segments: segment i reads n[i]
// float32 values at x[i] and writes as many at out[i], and owns the grid's
// blocks from first[i] on. The host arrays are copied into the kernel's
// parameters. first[0] must be 0, each later first[i] must follow the
// previous segment's last block, n[i] >= 1, and nblocks must end the last
// segment. Launches on `stream` and returns cudaGetLastError(); it never
// synchronises, so a CUDA graph can capture it.
int codec_roundtrip(const void* const* x, void* const* out,
                    const long long* n, const long long* first, int count,
                    long long nblocks, int bits, void* stream) {
  if (bad_bits(bits) || count < 1 || count > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  SegmentTable table;
  long long next = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 1 || first[i] != next)
      return static_cast<int>(cudaErrorInvalidValue);
    table.seg[i] = {static_cast<const float*>(x[i]),
                    static_cast<float*>(out[i]), n[i], first[i]};
    next += n_blocks(n[i]);
  }
  for (int i = count; i < kMaxSegments; ++i) table.seg[i] = {};
  table.count = count;
  if (next != nblocks || nblocks > 0x7fffffffLL * kRoundtripWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qmax = (1 << (bits - 1)) - 1;
  const float inv_qmax = 1.0f / static_cast<float>(qmax);
  roundtrip_kernel<<<grid_for(nblocks, kRoundtripWarps * kRoundtripBlocksPerWarp),
                     kRoundtripWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      table, nblocks, qmax, inv_qmax);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the roundtrip kernel that fit on one SM, or minus the CUDA error;
// launches nothing.
int codec_roundtrip_ctas_per_sm() {
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, roundtrip_kernel, kRoundtripWarps * 32, 0);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

// Codec blocks a roundtrip CTA takes.
int codec_roundtrip_blocks_per_cta() {
  return kRoundtripWarps * kRoundtripBlocksPerWarp;
}

// An empty kernel of one warp: the launch floor the roundtrip is timed
// against.
int codec_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* codec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
