// ResNet stem max-pool (3x3 window, stride 2, pad 1, NHWC) for Hopper
// (sm_90a): the value forward K2a below, and the training path's argmax
// forward K2b and gather backward K2c further down.
//
// K2a replaces the Pallas TPU kernel `_fwd_value_kernel` reached through
// `maxpool3x3s2` (theanompi_tpu/ops/maxpool_pallas.py), the idx-free
// forward of the inference path.  The Pallas version holds one whole
// (H, W, C) image per grid step in VMEM (1.6 MB in bf16 at 112x112x64),
// which is far over the 227 KB of shared memory a Hopper block has.
//
// What bounds it on an H100: bytes.  9 compares per output on one read
// of x and one write of y (a quarter of x); the floor is
// (bytes of x + y) / 3.35 TB/s.
//
// What the design does about it: one thread per output pixel and
// 16-byte channel vector (8 bf16 or 4 f32 channels), so a warp reads
// 512 contiguous bytes of one input pixel row per tap.  Overlapping
// windows re-read neighbouring input pixels; those re-reads hit L1/L2,
// so DRAM sees x about once.  No shared memory is needed.
//
// Semantics follow the Pallas kernel exactly: padding is -inf (an
// out-of-range tap never wins), taps run in row-major window order, and
// a tap is taken when `v > best || isnan(v)`, so NaN propagates and the
// first NaN sticks (NaN > x is false).  The winning value's bits are
// copied, so the output is exact.
//
// The launch allocates nothing, runs on the caller's stream and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename T>
struct Lanes;

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static float value(const uint4& u, int k) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&u)[k]);
  }
  __device__ __forceinline__ static void copy(uint4& dst, const uint4& src,
                                              int k) {
    reinterpret_cast<__nv_bfloat16*>(&dst)[k] =
        reinterpret_cast<const __nv_bfloat16*>(&src)[k];
  }
  __device__ __forceinline__ static uint4 neg_inf() {
    // bf16 -inf is 0xFF80; two per 32-bit word
    return make_uint4(0xFF80FF80u, 0xFF80FF80u, 0xFF80FF80u, 0xFF80FF80u);
  }
};

template <>
struct Lanes<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static float value(const uint4& u, int k) {
    return reinterpret_cast<const float*>(&u)[k];
  }
  __device__ __forceinline__ static void copy(uint4& dst, const uint4& src,
                                              int k) {
    reinterpret_cast<float*>(&dst)[k] = reinterpret_cast<const float*>(&src)[k];
  }
  __device__ __forceinline__ static uint4 neg_inf() {
    return make_uint4(0xFF800000u, 0xFF800000u, 0xFF800000u, 0xFF800000u);
  }
};

// x: (n, h, w, cv) 16-byte vectors; y: (n, oh, ow, cv).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool3x3s2_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                        int64_t total, int h, int w, int oh, int ow, int cv) {
  constexpr int N = Lanes<T>::N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int cvi = (int)(i % cv);
    int64_t t = i / cv;
    const int ox = (int)(t % ow);
    t /= ow;
    const int oy = (int)(t % oh);
    const int64_t b = t / oh;

    uint4 best = Lanes<T>::neg_inf();
    float bestf[N];
#pragma unroll
    for (int k = 0; k < N; ++k) bestf[k] = -INFINITY;

#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = 2 * oy - 1 + dy;
      if (iy < 0 || iy >= h) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = 2 * ox - 1 + dx;
        if (ix < 0 || ix >= w) continue;
        const uint4 v = x[((b * h + iy) * w + ix) * cv + cvi];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float f = Lanes<T>::value(v, k);
          if (f > bestf[k] || isnan(f)) {
            bestf[k] = f;
            Lanes<T>::copy(best, v, k);
          }
        }
      }
    }
    y[i] = best;
  }
}

template <typename T>
void launch(const void* x, void* y, int64_t n, int h, int w, int c,
            cudaStream_t stream) {
  const int cv = c / Lanes<T>::N;
  const int oh = h / 2, ow = w / 2;
  const int64_t total = n * oh * (int64_t)ow * cv;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  maxpool3x3s2_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), total, h, w, oh,
      ow, cv);
}

// -- training path (K2b, K2c) ------------------------------------------------
//
// Replace the Pallas TPU kernels `_fwd_kernel` (through `_mp_fwd`) and
// `_bwd_kernel` (through `_mp_bwd`) of theanompi_tpu/ops/maxpool_pallas.py.
//
// K2b is K2a plus the int8 argmax tap 0..8 of each output, with the
// Pallas rules: the tap starts at 4 (the window centre, in range for
// every window under pad 1), so an all-(-inf) window routes its gradient
// to a real pixel; a tap is taken when `(v > best || isnan(v)) &&
// !isnan(best)`, so the first maximum in row-major order wins and the
// first NaN claims the window and sticks.  Bound: bytes (x read once, y
// and idx written once).  Same thread layout as K2a; each thread writes
// its N taps as one 8- (bf16) or 4-byte (f32) store.
//
// K2c is the scatter-free gather: one thread per INPUT pixel and 16-byte
// channel vector reads the idx and g of the <= 4 windows that cover it
// (the Pallas version holds a whole image per grid step, 1.6 MB at
// 112x112x64 bf16, far over a block's 227 KB of shared memory) and adds
// the g of each window whose tap points at it.  The sum starts at zero
// and adds in the Pallas version's order (window-row tap dy ascending,
// then dx ascending), rounding to g's dtype after every add, as the
// Pallas version's `acc + where(...)` in g's dtype does.  Bound: bytes
// (g and idx read once, dx written once).

template <typename T>
struct Taps;

template <>
struct Taps<__nv_bfloat16> {
  using Word = uint2;  // 8 int8 taps
};

template <>
struct Taps<float> {
  using Word = uint32_t;  // 4 int8 taps
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool3x3s2_argmax_kernel(const uint4* __restrict__ x,
                               uint4* __restrict__ y,
                               typename Taps<T>::Word* __restrict__ idx,
                               int64_t total, int h, int w, int oh, int ow,
                               int cv) {
  constexpr int N = Lanes<T>::N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int cvi = (int)(i % cv);
    int64_t t = i / cv;
    const int ox = (int)(t % ow);
    t /= ow;
    const int oy = (int)(t % oh);
    const int64_t b = t / oh;

    uint4 best = Lanes<T>::neg_inf();
    float bestf[N];
    int8_t tap[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      bestf[k] = -INFINITY;
      tap[k] = 4;
    }
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = 2 * oy - 1 + dy;
      if (iy < 0 || iy >= h) continue;  // a -inf tap never wins
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = 2 * ox - 1 + dx;
        if (ix < 0 || ix >= w) continue;
        const uint4 v = x[((b * h + iy) * w + ix) * cv + cvi];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float f = Lanes<T>::value(v, k);
          if ((f > bestf[k] || isnan(f)) && !isnan(bestf[k])) {
            bestf[k] = f;
            Lanes<T>::copy(best, v, k);
            tap[k] = (int8_t)(dy * 3 + dx);
          }
        }
      }
    }
    y[i] = best;
    typename Taps<T>::Word word;
    int8_t* wp = reinterpret_cast<int8_t*>(&word);
#pragma unroll
    for (int k = 0; k < N; ++k) wp[k] = tap[k];
    idx[i] = word;
  }
}

// v rounded to T (round to nearest even; exact for T = float), and that
// value back in f32
template <typename T>
__device__ __forceinline__ T to_lane(float v);

template <>
__device__ __forceinline__ __nv_bfloat16 to_lane<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <>
__device__ __forceinline__ float to_lane<float>(float v) {
  return v;
}

template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

// g, idx: (n, oh, ow, cv) vectors; dx: (n, 2*oh, 2*ow, cv).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool3x3s2_bwd_kernel(const uint4* __restrict__ g,
                            const typename Taps<T>::Word* __restrict__ idx,
                            uint4* __restrict__ dx, int64_t total, int oh,
                            int ow, int cv) {
  constexpr int N = Lanes<T>::N;
  const int h = 2 * oh, w = 2 * ow;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int cvi = (int)(i % cv);
    int64_t t = i / cv;
    const int ix = (int)(t % w);
    t /= w;
    const int iy = (int)(t % h);
    const int64_t b = t / h;

    float acc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      // window row oy covers input rows 2*oy-1 .. 2*oy+1; tap dy of it
      // is input row iy when 2*oy = iy + 1 - dy
      const int ey = iy + 1 - dy;
      if (ey & 1) continue;
      const int oy = ey >> 1;
      if (oy < 0 || oy >= oh) continue;
#pragma unroll
      for (int dxi = 0; dxi < 3; ++dxi) {
        const int ex = ix + 1 - dxi;
        if (ex & 1) continue;
        const int ox = ex >> 1;
        if (ox < 0 || ox >= ow) continue;
        const int64_t o = ((b * oh + oy) * ow + ox) * cv + cvi;
        const typename Taps<T>::Word word = idx[o];
        const int8_t* wp = reinterpret_cast<const int8_t*>(&word);
        const int8_t want = (int8_t)(dy * 3 + dxi);
        bool any = false;
#pragma unroll
        for (int k = 0; k < N; ++k) any |= wp[k] == want;
        if (!any) continue;
        const uint4 gv = g[o];
#pragma unroll
        for (int k = 0; k < N; ++k)
          if (wp[k] == want)
            acc[k] = round_to<T>(__fadd_rn(acc[k], Lanes<T>::value(gv, k)));
      }
    }
    uint4 out;
    T* p = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = to_lane<T>(acc[k]);
    dx[i] = out;
  }
}

template <typename T>
void launch_argmax(const void* x, void* y, void* idx, int64_t n, int h, int w,
                   int c, cudaStream_t stream) {
  const int cv = c / Lanes<T>::N;
  const int oh = h / 2, ow = w / 2;
  const int64_t total = n * oh * (int64_t)ow * cv;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  maxpool3x3s2_argmax_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y),
      static_cast<typename Taps<T>::Word*>(idx), total, h, w, oh, ow, cv);
}

template <typename T>
void launch_bwd(const void* g, const void* idx, void* dx, int64_t n, int oh,
                int ow, int c, cudaStream_t stream) {
  const int cv = c / Lanes<T>::N;
  const int64_t total = n * (2 * oh) * (int64_t)(2 * ow) * cv;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  maxpool3x3s2_bwd_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(g),
      static_cast<const typename Taps<T>::Word*>(idx), static_cast<uint4*>(dx),
      total, oh, ow, cv);
}

}  // namespace

// K2b.  x: contiguous NHWC (n, h, w, c) with even h and w; y: (n, h/2,
// w/2, c) of x's dtype (0 = float32, 1 = bfloat16); idx: int8 of y's
// shape.  Same limits on c as tm_maxpool3x3s2.  Returns cudaGetLastError().
extern "C" int tm_maxpool3x3s2_argmax(const void* x, void* y, void* idx,
                                      long long n, int h, int w, int c,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_argmax<__nv_bfloat16>(x, y, idx, n, h, w, c, s);
  else if (dtype == 0)
    launch_argmax<float>(x, y, idx, n, h, w, c, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K2c.  g: (n, oh, ow, c) of `dtype`, idx: int8 (n, oh, ow, c) from
// tm_maxpool3x3s2_argmax; dx: (n, 2*oh, 2*ow, c) of g's dtype.  Returns
// cudaGetLastError().
extern "C" int tm_maxpool3x3s2_bwd(const void* g, const void* idx, void* dx,
                                   long long n, int oh, int ow, int c,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_bwd<__nv_bfloat16>(g, idx, dx, n, oh, ow, c, s);
  else if (dtype == 0)
    launch_bwd<float>(g, idx, dx, n, oh, ow, c, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x: contiguous NHWC (n, h, w, c) with even h and w; y: (n, h/2, w/2, c)
// of the same dtype (0 = float32, 1 = bfloat16).  c must be a multiple of
// the 16-byte vector width (4 for f32, 8 for bf16); the Python wrapper
// checks it.  Returns cudaGetLastError().
extern "C" int tm_maxpool3x3s2(const void* x, void* y, long long n, int h,
                               int w, int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch<__nv_bfloat16>(x, y, n, h, w, c, s);
  else if (dtype == 0)
    launch<float>(x, y, n, h, w, c, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
