// Fused host-side augmentation: random crop (with virtual reflect
// padding) + horizontal flip + affine normalize, uint8 NHWC -> float32.
//
// The port's copy of theanompi_tpu/native/augment.cpp: the whole
// per-image transform in ONE pass over the crop window, where numpy
// makes a pad copy, a gather, an astype and two arithmetic passes, each
// a full-batch temporary.  Bitwise equal to the numpy path.
//
// Built on demand by theanompi_tpu_torch/native/__init__.py with g++ -O3
// into build/native/; ctypes ABI, plain C signature, no Python.h.

#include <cstdint>
#include <thread>
#include <vector>

namespace {

// numpy 'reflect' boundary (no edge repeat), applied repeatedly like
// np.pad does — handles pad >= n-1 (e.g. 4px pad on a 4px image).
inline int reflect(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

// The normalize arithmetic deliberately mirrors the numpy fallback's
// op sequence — f32 divide by `divisor`, subtract mean, divide by std
// — so the two paths are BITWISE identical (training runs must not
// depend on which implementation decoded the batch).
void run_range(const uint8_t* src, int h, int w, int c, int pad,
               const int64_t* ys, const int64_t* xs, const uint8_t* flips,
               int crop_h, int crop_w, const float* mean, const float* stdv,
               float divisor, float* dst, int begin, int end) {
  const int64_t img_stride = (int64_t)h * w * c;
  const int64_t out_stride = (int64_t)crop_h * crop_w * c;
  for (int i = begin; i < end; ++i) {
    const uint8_t* img = src + i * img_stride;
    float* out = dst + i * out_stride;
    const int y0 = (int)ys[i] - pad;  // offsets are in padded coords
    const int x0 = (int)xs[i] - pad;
    const bool flip = flips[i] != 0;
    for (int y = 0; y < crop_h; ++y) {
      const int sy = reflect(y0 + y, h);
      const uint8_t* row = img + (int64_t)sy * w * c;
      float* orow = out + (int64_t)y * crop_w * c;
      for (int x = 0; x < crop_w; ++x) {
        const int px = flip ? (crop_w - 1 - x) : x;
        const int sx = reflect(x0 + px, w);
        const uint8_t* p = row + (int64_t)sx * c;
        float* o = orow + (int64_t)x * c;
        for (int ch = 0; ch < c; ++ch)
          o[ch] = ((float)p[ch] / divisor - mean[ch]) / stdv[ch];
      }
    }
  }
}

}  // namespace

extern "C" {

// src: (n,h,w,c) uint8; ys/xs: per-image crop origin in PADDED
// coordinates, i.e. in [0, h+2*pad-crop_h]; flips: per-image 0/1;
// mean/stdv: per-channel, in (px/divisor) units;
// dst: (n,crop_h,crop_w,c) float32.
void tm_crop_flip_normalize(const uint8_t* src, int n, int h, int w, int c,
                            int pad, const int64_t* ys, const int64_t* xs,
                            const uint8_t* flips, int crop_h, int crop_w,
                            const float* mean, const float* stdv,
                            float divisor, float* dst, int n_threads) {
  if (n_threads <= 1 || n < 2 * n_threads) {
    run_range(src, h, w, c, pad, ys, xs, flips, crop_h, crop_w, mean, stdv,
              divisor, dst, 0, n);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  const int per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int b = t * per;
    const int e = b + per < n ? b + per : n;
    if (b >= e) break;
    ts.emplace_back(run_range, src, h, w, c, pad, ys, xs, flips, crop_h,
                    crop_w, mean, stdv, divisor, dst, b, e);
  }
  for (auto& t : ts) t.join();
}

int tm_native_abi_version() { return 2; }

}  // extern "C"
