// The CNN's conv-block glue for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the elementwise passes around the paper CNN's three fp32 conv
// products (src/repro_torch/models/cnn.py), which the products themselves
// leave untouched (torch.matmul on the same operands, under autograd):
//   * im2col_kernel: x (N, H, W, C) -> patches (N, H, W, kh*kw*C) of a
//     SAME-padded stride-1 conv, taps in (i, j, c) order. Today's composite
//     pads x, slices nine shifted views and concatenates them.
//   * col2im_kernel: the patches' gradient -> dx (N, H, W, C), a gather-sum.
//     Autograd's backward of the composite fills a zeroed padded buffer per
//     tap and adds the nine buffers, the last tap's first.
//   * pool_kernel: y (N, H, W, O), b (K, O) -> the 2x2 stride-2 max-pool of
//     relu(y + b) over (H, W) cropped to even sizes, and under grad a uint8
//     mask per pooled value: bit e marks the window positions (e = 2*dh +
//     dw) equal to the max, bit 4 + e those whose ReLU output is not <= 0.
//     It replaces the bias add, relu and amax, three full-size passes.
//   * pool_bwd_kernel: the pooled gradient and the mask -> dy (N, H, W, O),
//     +0 in the cropped row and column. It replaces amax's backward (an
//     eq, a count, a divide and a multiply) and threshold_backward.
//
// Bit for bit the composite's result: each kernel repeats ATen's per-element
// arithmetic on CUDA and its order of accumulation (the tests and
// chip_smoke.py hold each to autograd through the composite ops, which
// kernels/ref.py keeps as the plain version):
//   * the bias add is one IEEE add (__fadd_rn), relu is ATen's clamp_min,
//     NaN kept, else fmaxf(v, 0);
//   * the max folds the window from -inf in (dh, dw) order with ATen's
//     NaN-propagating compare, (isnan(a) || a > b) ? a : b;
//   * the pool gradient is (g / count) * eq, an IEEE divide and multiply,
//     then passed where the ReLU output is not <= 0, else +0;
//   * col2im adds a tap's value, or +0 where it falls in the padding, from
//     the last tap to the first: the order autograd's input buffer adds the
//     slices' padded gradients in, and the zeros they are padded with;
//   * this file must never be built with --use_fast_math.
//
// What bounds them: memory. im2col writes nine copies of x; a CTA stages a
// band of input rows, with the halo, in shared memory once and writes the
// band's patch rows with 16-byte stores, so x is read about once. col2im
// reads each patch gradient once (16-byte loads where C % 4 == 0) and writes
// dx once, with no atomics and no zero-filled buffer. The pool reads y once
// and writes a quarter of it plus a byte per pooled value; its backward
// writes dy once, a thread per element, and reads those through the cache.
// Index arithmetic divides by run-time sizes through multiply-shift
// divisors (Div), so the integer work stays below the stores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // im2col: the band in shared memory

// n / d and n % d for 0 <= n < 2^31 by a multiply and a shift
// (round-up method), d >= 1 fixed at launch.
struct Div {
  unsigned d, m, s;
};

Div make_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ unsigned div_q(unsigned n, const Div& v) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

// n = q * d + r
__device__ __forceinline__ unsigned divmod(unsigned n, const Div& v,
                                           unsigned* r) {
  const unsigned q = div_q(n, v);
  *r = n - q * v.d;
  return q;
}

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// ATen's relu on CUDA (clamp_min(v, 0)): NaN kept, else fmaxf.
__device__ __forceinline__ float relu(float v) {
  return is_nan(v) ? v : fmaxf(v, 0.f);
}

// ATen's NaN-propagating max step (MaxNanFunctor): a is the running value.
__device__ __forceinline__ float max_step(float a, float b) {
  return (is_nan(a) || a > b) ? a : b;
}

struct Im2colArgs {
  const float* x;
  float* out;
  int H, W, C, kh, kw;
  int rows;      // output rows a CTA writes (its band)
  int bands;     // ceil(H / rows)
  int vec_in;    // x rows load as float4 (W*C % 4 == 0, x 16-byte aligned)
  Div bands_d, row_d, tap_d, c_d, c4_d, kw_d;  // by bands, W*T, T, C, C/4, kw
};

// One CTA per (image, band of output rows): stage the band's input rows and
// the kh//2 rows of halo on each side (zeros outside the image) in shared
// memory, then write the band's patch rows, which are contiguous in `out`.
__global__ void __launch_bounds__(kThreads)
im2col_kernel(Im2colArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned band_r;
  const unsigned n = divmod(blockIdx.x, a.bands_d, &band_r);
  const int h0 = static_cast<int>(band_r) * a.rows;
  const int ph = a.kh / 2, pw = a.kw / 2;
  const int R = min(a.rows, a.H - h0);
  const int srows = R + a.kh - 1;
  const int WC = a.W * a.C;
  // -- stage rows h0 - ph .. h0 + R - 1 + ph
  const long long img = static_cast<long long>(n) * a.H * WC;
  if (a.vec_in) {
    const int wc4 = WC / 4;
    for (int i = threadIdx.x; i < srows * wc4; i += blockDim.x) {
      const int sr = i / wc4, col = i - sr * wc4;
      const int h = h0 - ph + sr;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (h >= 0 && h < a.H)
        v = __ldg(reinterpret_cast<const float4*>(a.x + img + static_cast<long long>(h) * WC) + col);
      smem4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < srows * WC; i += blockDim.x) {
      const int sr = i / WC, col = i - sr * WC;
      const int h = h0 - ph + sr;
      smem[i] = (h >= 0 && h < a.H)
                    ? __ldg(a.x + img + static_cast<long long>(h) * WC + col)
                    : 0.f;
    }
  }
  __syncthreads();
  // -- write the band: R * W * T floats from out + (n*H + h0) * W * T
  const int T = a.kh * a.kw * a.C;
  float* out = a.out + (static_cast<long long>(n) * a.H + h0) * a.W * T;
  if (a.C % 4 == 0) {
    // a float4 of 4 channels of one tap: one 16-byte shared load and store
    const int T4 = T / 4;
    const unsigned items = static_cast<unsigned>(R) * a.W * T4;
    for (unsigned it = threadIdx.x; it < items; it += blockDim.x) {
      unsigned rem, c4;
      const unsigned r = divmod(it, a.row_d /* W*T4 */, &rem);
      const unsigned w = divmod(rem, a.tap_d /* T4 */, &rem);
      const unsigned t = divmod(rem, a.c4_d /* C/4 */, &c4);
      unsigned j;
      const unsigned i = divmod(t, a.kw_d, &j);
      const int sx = static_cast<int>(w + j) - pw;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (sx >= 0 && sx < a.W)
        v = smem4[((r + i) * a.W + sx) * (a.C / 4) + c4];
      reinterpret_cast<float4*>(out)[it] = v;
    }
  } else {
    // any C (3 for RGB images): four consecutive floats of the flat band,
    // each decoded on its own, stored as one float4 where aligned
    const unsigned total = static_cast<unsigned>(R) * a.W * T;
    const bool vec = (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                     (total % 4 == 0);
    for (unsigned f0 = 4 * threadIdx.x; f0 < total; f0 += 4 * blockDim.x) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned f = f0 + q;
        v[q] = 0.f;
        if (f < total) {
          unsigned rem, c, j;
          const unsigned r = divmod(f, a.row_d /* W*T */, &rem);
          const unsigned w = divmod(rem, a.tap_d /* T */, &rem);
          const unsigned t = divmod(rem, a.c_d /* C */, &c);
          const unsigned i = divmod(t, a.kw_d, &j);
          const int sx = static_cast<int>(w + j) - pw;
          if (sx >= 0 && sx < a.W) v[q] = smem[((r + i) * a.W + sx) * a.C + c];
        }
      }
      if (vec) {
        reinterpret_cast<float4*>(out)[f0 / 4] = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (f0 + q < total) out[f0 + q] = v[q];
      }
    }
  }
}

struct Col2imArgs {
  const float* g;   // (N, H, W, kh*kw*C)
  float* dx;        // (N, H, W, C)
  int H, W, C, kh, kw, vec;
  long long items;  // N*H*W*C, or N*H*W*C/4 when vec
  Div lane_d, w_d, h_d;  // by C (or C/4), W, H
};

// One thread per element of dx (four channels when vec): the sum of its
// taps from the last to the first, a tap in the padding adding +0.
__global__ void __launch_bounds__(kThreads)
col2im_kernel(Col2imArgs a) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= a.items) return;
  // items < 2^31 is checked at launch
  unsigned c, w, h;
  unsigned rest = divmod(static_cast<unsigned>(idx), a.lane_d, &c);
  rest = divmod(rest, a.w_d, &w);
  const unsigned n = divmod(rest, a.h_d, &h);
  const int ph = a.kh / 2, pw = a.kw / 2;
  const int T = a.kh * a.kw * a.C;
  const long long base = static_cast<long long>(n) * a.H;
  if (a.vec) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    bool first = true;
    for (int i = a.kh - 1; i >= 0; --i) {
      for (int j = a.kw - 1; j >= 0; --j) {
        const int hh = static_cast<int>(h) + ph - i;
        const int ww = static_cast<int>(w) + pw - j;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (hh >= 0 && hh < a.H && ww >= 0 && ww < a.W)
          v = __ldg(reinterpret_cast<const float4*>(
              a.g + ((base + hh) * a.W + ww) * T + (i * a.kw + j) * a.C) + c);
        if (first) {
          acc = v;
          first = false;
        } else {
          acc.x = __fadd_rn(acc.x, v.x);
          acc.y = __fadd_rn(acc.y, v.y);
          acc.z = __fadd_rn(acc.z, v.z);
          acc.w = __fadd_rn(acc.w, v.w);
        }
      }
    }
    reinterpret_cast<float4*>(a.dx)[idx] = acc;
  } else {
    float acc = 0.f;
    bool first = true;
    for (int i = a.kh - 1; i >= 0; --i) {
      for (int j = a.kw - 1; j >= 0; --j) {
        const int hh = static_cast<int>(h) + ph - i;
        const int ww = static_cast<int>(w) + pw - j;
        float v = 0.f;
        if (hh >= 0 && hh < a.H && ww >= 0 && ww < a.W)
          v = __ldg(a.g + ((base + hh) * a.W + ww) * T + (i * a.kw + j) * a.C + c);
        acc = first ? v : __fadd_rn(acc, v);
        first = false;
      }
    }
    a.dx[idx] = acc;
  }
}

struct PoolArgs {
  const float* y;   // (N, H, W, O)
  const float* b;   // (K, O), image n is client n / B
  float* out;       // (N, H/2, W/2, O)
  uint8_t* mask;    // (N, H/2, W/2, O) or null
  int H, W, O, vec;
  long long items;  // N*Hh*Wh*O, or /4 when vec
  Div lane_d, w_d, h_d, b_d;  // by O (or O/4), Wh, Hh, B
};

__device__ __forceinline__ void pool_window(const float r[4], float* out,
                                            unsigned* bits) {
  float m = -INFINITY;
#pragma unroll
  for (int e = 0; e < 4; ++e) m = max_step(m, r[e]);
  unsigned k = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (r[e] == m) k |= 1u << e;
    if (!(r[e] <= 0.f)) k |= 1u << (4 + e);
  }
  *out = m;
  *bits = k;
}

// One thread per pooled value (four channels when vec).
__global__ void __launch_bounds__(kThreads)
pool_kernel(PoolArgs a) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= a.items) return;
  unsigned c, pw, ph;
  unsigned rest = divmod(static_cast<unsigned>(idx), a.lane_d, &c);
  rest = divmod(rest, a.w_d, &pw);
  const unsigned n = divmod(rest, a.h_d, &ph);
  const unsigned k = div_q(n, a.b_d);
  const long long row = static_cast<long long>(a.W) * a.O;
  const float* y0 = a.y + (static_cast<long long>(n) * a.H + 2 * ph) * row +
                    static_cast<long long>(2 * pw) * a.O;
  const long long offs[4] = {0, a.O, row, row + a.O};  // e = 2*dh + dw
  if (a.vec) {
    const float4 bv = __ldg(reinterpret_cast<const float4*>(a.b + static_cast<long long>(k) * a.O) + c);
    float r[4][4];  // [channel][e]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(y0 + offs[e]) + c);
      r[0][e] = relu(__fadd_rn(v.x, bv.x));
      r[1][e] = relu(__fadd_rn(v.y, bv.y));
      r[2][e] = relu(__fadd_rn(v.z, bv.z));
      r[3][e] = relu(__fadd_rn(v.w, bv.w));
    }
    float o[4];
    unsigned bits[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) pool_window(r[q], &o[q], &bits[q]);
    reinterpret_cast<float4*>(a.out)[idx] = make_float4(o[0], o[1], o[2], o[3]);
    if (a.mask)
      reinterpret_cast<uchar4*>(a.mask)[idx] =
          make_uchar4(bits[0], bits[1], bits[2], bits[3]);
  } else {
    const float bv = __ldg(a.b + static_cast<long long>(k) * a.O + c);
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = relu(__fadd_rn(__ldg(y0 + offs[e] + c), bv));
    float o;
    unsigned bits;
    pool_window(r, &o, &bits);
    a.out[idx] = o;
    if (a.mask) a.mask[idx] = static_cast<uint8_t>(bits);
  }
}

struct PoolBwdArgs {
  const float* g;       // (N, Hh, Wh, O)
  const uint8_t* mask;  // (N, Hh, Wh, O)
  float* dy;            // (N, H, W, O)
  int H, W, O, Hh, Wh, vec;
  long long items;      // N*H*W*O, or /4 when vec
  Div lane_d, w_d, h_d;  // by O (or O/4), W, H
};

__device__ __forceinline__ float pool_grad(float g, unsigned bits, int e) {
  // amax's (g / count) * eq, then threshold_backward: +0 unless passed
  const float q = __fdiv_rn(g, static_cast<float>(__popc(bits & 15u)));
  const float v = __fmul_rn(q, ((bits >> e) & 1u) ? 1.f : 0.f);
  return ((bits >> (4 + e)) & 1u) ? v : 0.f;
}

// One thread per element of dy (four channels when vec), so the stores
// are contiguous; the four threads of a window read its pooled gradient
// and mask (through the cache). The cropped row and column take +0.
__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(PoolBwdArgs a) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= a.items) return;
  unsigned c, w, h;
  unsigned rest = divmod(static_cast<unsigned>(idx), a.lane_d, &c);
  rest = divmod(rest, a.w_d, &w);
  const unsigned n = divmod(rest, a.h_d, &h);
  const bool inside = static_cast<int>(h) < 2 * a.Hh && static_cast<int>(w) < 2 * a.Wh;
  const int e = 2 * (h & 1u) + (w & 1u);
  const long long cell = (static_cast<long long>(n) * a.Hh + h / 2) * a.Wh + w / 2;
  if (a.vec) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (inside) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(a.g + cell * a.O) + c);
      const uchar4 mv = __ldg(reinterpret_cast<const uchar4*>(a.mask + cell * a.O) + c);
      o = make_float4(pool_grad(gv.x, mv.x, e), pool_grad(gv.y, mv.y, e),
                      pool_grad(gv.z, mv.z, e), pool_grad(gv.w, mv.w, e));
    }
    reinterpret_cast<float4*>(a.dy)[idx] = o;
  } else {
    a.dy[idx] = inside ? pool_grad(__ldg(a.g + cell * a.O + c),
                                   __ldg(a.mask + cell * a.O + c), e)
                       : 0.f;
  }
}

unsigned grid_for(long long items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

constexpr long long kMaxItems = 0x7fffffffLL;

}  // namespace

extern "C" {

// The output rows an im2col CTA writes for a row of W*C floats and a kh-tap
// kernel: as many as fit in shared memory with the halo, at most H; 0 if
// not even one does.
int cnn_im2col_rows(int H, int W, int C, int kh) {
  const long long row = 4LL * W * C;
  const long long fit = kSmemBytes / row - (kh - 1);
  return static_cast<int>(fit < 1 ? 0 : (fit < H ? fit : H));
}

// x (N, H, W, C) -> out (N, H, W, kh*kw*C), both contiguous float32, out
// 16-byte aligned; odd kh, kw. Launches on `stream`, returns
// cudaGetLastError() (0 on success); it never synchronises.
int cnn_im2col(const float* x, float* out, long long N, int H, int W, int C,
               int kh, int kw, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || kh % 2 == 0 || kw % 2 == 0 ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = cnn_im2col_rows(H, W, C, kh);
  const long long T = 1LL * kh * kw * C;
  if (rows < 1 || 1LL * rows * W * T > kMaxItems)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bands = (H + rows - 1) / rows;
  if (N * bands > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  Im2colArgs a;
  a.x = x;
  a.out = out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.kh = kh;
  a.kw = kw;
  a.rows = rows;
  a.bands = bands;
  a.vec_in = (1LL * W * C % 4 == 0) && aligned16(x);
  const bool c4 = C % 4 == 0;
  a.bands_d = make_div(bands);
  a.row_d = make_div(static_cast<unsigned>(c4 ? W * T / 4 : W * T));
  a.tap_d = make_div(static_cast<unsigned>(c4 ? T / 4 : T));
  a.c_d = make_div(C);
  a.c4_d = make_div(c4 ? C / 4 : 1);
  a.kw_d = make_div(kw);
  const size_t smem = 4ull * (rows + kh - 1) * W * C;
  im2col_kernel<<<static_cast<unsigned>(N * bands), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// g (N, H, W, kh*kw*C) -> dx (N, H, W, C), both contiguous float32.
int cnn_col2im(const float* g, float* dx, long long N, int H, int W, int C,
               int kh, int kw, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || kh % 2 == 0 || kw % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Col2imArgs a;
  a.g = g;
  a.dx = dx;
  a.H = H;
  a.W = W;
  a.C = C;
  a.kh = kh;
  a.kw = kw;
  a.vec = C % 4 == 0 && aligned16(g) && aligned16(dx);
  const int lanes = a.vec ? C / 4 : C;
  a.items = N * H * W * lanes;
  if (a.items > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  a.lane_d = make_div(lanes);
  a.w_d = make_div(W);
  a.h_d = make_div(H);
  col2im_kernel<<<grid_for(a.items), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// y (N, H, W, O), b (K, O) with N = K*B -> out (N, H/2, W/2, O) and, if mask
// is not null, the uint8 mask of the same shape; all contiguous, H, W >= 2.
int cnn_pool(const float* y, const float* b, float* out, uint8_t* mask,
             long long N, int B, int H, int W, int O, void* stream) {
  if (N < 1 || B < 1 || N % B != 0 || H < 2 || W < 2 || O < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PoolArgs a;
  a.y = y;
  a.b = b;
  a.out = out;
  a.mask = mask;
  a.H = H;
  a.W = W;
  a.O = O;
  a.vec = O % 4 == 0 && aligned16(y) && aligned16(b) && aligned16(out) &&
          (mask == nullptr || reinterpret_cast<uintptr_t>(mask) % 4 == 0);
  const int lanes = a.vec ? O / 4 : O;
  a.items = N * (H / 2) * (W / 2) * lanes;
  if (a.items > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  a.lane_d = make_div(lanes);
  a.w_d = make_div(W / 2);
  a.h_d = make_div(H / 2);
  a.b_d = make_div(B);
  pool_kernel<<<grid_for(a.items), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// g and mask (N, H/2, W/2, O) -> dy (N, H, W, O), all contiguous.
int cnn_pool_bwd(const float* g, const uint8_t* mask, float* dy, long long N,
                 int H, int W, int O, void* stream) {
  if (N < 1 || H < 2 || W < 2 || O < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PoolBwdArgs a;
  a.g = g;
  a.mask = mask;
  a.dy = dy;
  a.H = H;
  a.W = W;
  a.O = O;
  a.Hh = H / 2;
  a.Wh = W / 2;
  a.vec = O % 4 == 0 && aligned16(g) && aligned16(dy) &&
          reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const int lanes = a.vec ? O / 4 : O;
  a.items = N * H * W * lanes;
  if (a.items > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  a.lane_d = make_div(lanes);
  a.w_d = make_div(W);
  a.h_d = make_div(H);
  pool_bwd_kernel<<<grid_for(a.items), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* cnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
