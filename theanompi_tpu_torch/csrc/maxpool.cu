// ResNet stem max-pool forward (3x3 window, stride 2, pad 1, NHWC) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_value_kernel` reached through
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

}  // namespace

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
