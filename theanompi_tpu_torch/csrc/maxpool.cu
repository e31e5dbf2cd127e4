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

#include <algorithm>
#include <climits>

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
// first NaN claims the window and sticks.
//
// K2c is the scatter-free gather of the Pallas version's class planes:
// input pixel (2*oy + pi, 2*ox + pj) sums, in g's dtype from zero, the g
// of each window whose saved tap points at it, in the Pallas order (tap
// row dy ascending, then dx: `plane()` in ops/maxpool.py), rounding to
// g's dtype after every add, as the Pallas `acc + where(...)` does.
//
// What bounds both on an H100: bytes.  K2b reads x once and writes y and
// idx; K2c reads g and idx once and writes dx: 283 MB each at (128, 112,
// 112, 64) bf16.  The Pallas versions hold a whole image per grid step
// (1.6 MB at 112x112x64 bf16), far over a block's 227 KB of shared
// memory.
//
// What the design does about it: a block owns one tile of one image, R
// output rows by TW output columns by at most 32 channel vectors
// (`train_geometry`, exported by tm_maxpool_train_geometry), and stages
// what the tile reads in shared memory with 16-byte cp.async copies
// before it computes:
//   K2b: the 2R+1 input rows and 2TW+1 input columns under its windows,
//        -inf where they fall off the image, so no tap is bound-tested;
//   K2c: g and idx of R+1 output rows and TW+1 columns (the next strip's
//        first row and the next tile's first column are its halo), with
//        zero g and tap -1, which matches no tap, off the image.
// The halos are read again by the neighbouring tile, mostly from L2: x
// (2R+1)/(2R) times, g and idx (R+1)/R times.  Then one thread per
// output cell and channel vector: in K2b it takes the nine taps from
// shared memory; in K2c it writes its 2x2 input quad (one pixel of each
// class plane) from the four staged windows that reach it.  Both choose
// with selects, not branches, and each warp's stores fill whole 128-byte
// lines at C = 64 bf16.  Index math is 32-bit inside an image, with one
// 64-bit image offset; a block finds its tile with one division chain of
// blockIdx.x.  Several blocks share an SM (3 of K2b by shared memory, 4
// of K2c by registers at the ResNet stem shape), so one block's copies
// overlap another's compute.  R = 2 for both: tools/maxpool_kernel_probe.py
// measured K2b slower at R = 4 and K2c slower at R = 4 than at 2.

constexpr int kTrainThreads = 256;
// shared memory a tile may take: three K2b blocks of the ResNet stem
// shape fit an SM's 228 KB (each block also reserves 1 KB)
constexpr int kTileBytes = 74 * 1024;
// channel vectors per tile: 512 bytes of a pixel
constexpr int kMaxTileVecs = 32;
// output rows per tile
constexpr int kArgmaxRows = 2;
constexpr int kBwdRows = 2;

template <typename T>
struct Taps;

template <>
struct Taps<__nv_bfloat16> {
  using Word = uint2;  // 8 int8 taps
  __device__ __forceinline__ static int get(const Word& u, int k) {
    return ((k < 4 ? u.x : u.y) >> (8 * (k & 3))) & 0xFF;
  }
  __device__ __forceinline__ static Word pack(const int (&t)[8]) {
    return make_uint2(t[0] | t[1] << 8 | t[2] << 16 | t[3] << 24,
                      t[4] | t[5] << 8 | t[6] << 16 | t[7] << 24);
  }
  __device__ __forceinline__ static Word none() {
    return make_uint2(0xFFFFFFFFu, 0xFFFFFFFFu);
  }
};

template <>
struct Taps<float> {
  using Word = uint32_t;  // 4 int8 taps
  __device__ __forceinline__ static int get(Word u, int k) {
    return (u >> (8 * k)) & 0xFF;
  }
  __device__ __forceinline__ static Word pack(const int (&t)[4]) {
    return t[0] | t[1] << 8 | t[2] << 16 | t[3] << 24;
  }
  __device__ __forceinline__ static Word none() { return 0xFFFFFFFFu; }
};

// the lanes' bits (`v` holds values of T widened to f32, so for bf16 the
// high halves), and the lanes rounded to T (round to nearest even)
__device__ __forceinline__ uint4 lane_bits(const float (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = __byte_perm(__float_as_uint(v[2 * i]),
                       __float_as_uint(v[2 * i + 1]), 0x7632);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ uint4 lane_bits(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 rounded(const float (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ uint4 rounded(const float (&v)[4]) {
  return lane_bits(v);
}

// v rounded to T (round to nearest even; exact for T = float), back in f32
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

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// A tile is `rows` output rows by `cols` output columns by `vecs` channel
// vectors; an image has strips x col_tiles x vec_tiles of them (the last
// of each may be cut short); a block takes `smem` bytes of shared memory.
struct TrainGeometry {
  int rows, cols, vecs;
  int strips, col_tiles, vec_tiles;
  int smem;
};

// K2b's (bwd false) or K2c's tiles for an (oh, ow) output of cv channel
// vectors of `lanes` lanes each.  Columns and channel vectors are split
// into near-equal tiles, as few as fit kTileBytes.
TrainGeometry train_geometry(bool bwd, int lanes, int oh, int ow, int cv) {
  TrainGeometry q;
  q.vec_tiles = ceil_div(cv, kMaxTileVecs);
  q.vecs = ceil_div(cv, q.vec_tiles);
  q.rows = std::min(bwd ? kBwdRows : kArgmaxRows, oh);
  q.strips = ceil_div(oh, q.rows);
  // a staged K2b vector is 16 bytes of x; a K2c one 16 bytes of g and
  // `lanes` bytes of idx
  const int vec_bytes = bwd ? 16 + lanes : 16;
  const int stage_rows = bwd ? q.rows + 1 : 2 * q.rows + 1;
  const int per_row = kTileBytes / (vec_bytes * q.vecs) / stage_rows;
  const int max_cols = std::max(1, bwd ? per_row - 1 : (per_row - 1) / 2);
  q.col_tiles = ceil_div(ow, max_cols);
  q.cols = ceil_div(ow, q.col_tiles);
  q.smem = stage_rows * (bwd ? q.cols + 1 : 2 * q.cols + 1) * q.vecs *
           vec_bytes;
  return q;
}

// the block's tile: image b, first output row, column and channel vector,
// and its extent (channel tiles vary fastest, then column tiles, strips)
struct Tile {
  int b, oy0, ox0, c0, rows, cols, vecs;
};

__device__ __forceinline__ Tile tile_of(const TrainGeometry& q, int oh,
                                        int ow, int cv) {
  int i = blockIdx.x;
  Tile t;
  t.c0 = (i % q.vec_tiles) * q.vecs;
  i /= q.vec_tiles;
  t.ox0 = (i % q.col_tiles) * q.cols;
  i /= q.col_tiles;
  t.oy0 = (i % q.strips) * q.rows;
  t.b = i / q.strips;
  t.rows = min(q.rows, oh - t.oy0);
  t.cols = min(q.cols, ow - t.ox0);
  t.vecs = min(q.vecs, cv - t.c0);
  return t;
}

// 16 (.cg: L2 only), 8 or 4 (.ca) bytes from global to shared memory
template <typename V>
__device__ __forceinline__ void cp_async(V* dst, const V* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(V) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(sizeof(V))
                 : "memory");
}

// `vecs` vectors of each of `npix` pixels, from global memory (pixels cv
// vectors apart) into shared memory (pixels px apart)
template <typename V>
__device__ __forceinline__ void stage(V* dst, const V* src, int npix,
                                      int vecs, int cv, int px) {
  if (vecs == cv) {  // one channel tile: both sides contiguous
    for (int i = threadIdx.x; i < npix * cv; i += blockDim.x)
      cp_async(dst + i, src + i);
    return;
  }
  for (int i = threadIdx.x; i < npix * vecs; i += blockDim.x) {
    const int p = i / vecs, k = i - p * vecs;
    cp_async(dst + p * px + k, src + p * cv + k);
  }
}

// the same pixels of shared memory set to v
template <typename V>
__device__ __forceinline__ void fill(V* dst, int npix, int vecs, int px,
                                     V v) {
  for (int i = threadIdx.x; i < npix * vecs; i += blockDim.x) {
    const int p = i / vecs;
    dst[p * px + i - p * vecs] = v;
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x: (n, h, w, cv) 16-byte vectors; y: (n, h/2, w/2, cv); idx: one tap
// word per vector of y.
template <typename T>
__global__ void __launch_bounds__(kTrainThreads, 3)
    maxpool3x3s2_argmax_tile_kernel(const uint4* __restrict__ x,
                                    uint4* __restrict__ y,
                                    typename Taps<T>::Word* __restrict__ idx,
                                    int h, int w, int cv, TrainGeometry q) {
  constexpr int N = Lanes<T>::N;
  extern __shared__ uint4 tile[];
  const int oh = h >> 1, ow = w >> 1;
  const Tile t = tile_of(q, oh, ow, cv);
  // staged row j is input row 2*oy0 - 1 + j, staged column i input
  // column 2*ox0 - 1 + i; the last of each lies on the image (h, w even)
  const int px = q.vecs, pitch = (2 * q.cols + 1) * px;
  const int left = t.ox0 == 0;  // staged column 0 is off the image
  const uint4 ninf = Lanes<T>::neg_inf();
  const uint4* xb = x + (int64_t)t.b * h * w * cv + t.c0;
  for (int j = 0; j < 2 * t.rows + 1; ++j) {
    const int iy = 2 * t.oy0 - 1 + j;
    uint4* dst = tile + j * pitch;
    if (iy < 0) {
      fill(dst, 2 * t.cols + 1, t.vecs, px, ninf);
      continue;
    }
    if (left) fill(dst, 1, t.vecs, px, ninf);
    stage(dst + left * px, xb + (iy * w + 2 * t.ox0 - 1 + left) * cv,
          2 * t.cols + 1 - left, t.vecs, cv, px);
  }
  cp_async_wait_all();
  __syncthreads();

  const int64_t img = (int64_t)t.b * oh * ow * cv + t.c0;
  for (int p = threadIdx.x; p < t.cols * t.vecs; p += blockDim.x) {
    const int ox = p / t.vecs, c = p - ox * t.vecs;
    const uint4* s = tile + 2 * ox * px + c;
    int o = (t.oy0 * ow + t.ox0 + ox) * cv + c;
    for (int r = 0; r < t.rows; ++r, s += 2 * pitch, o += ow * cv) {
      float best[N];
      int tap[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        best[k] = -INFINITY;
        tap[k] = 4;
      }
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint4 v = s[dy * pitch + dx * px];
#pragma unroll
          for (int k = 0; k < N; ++k) {
            // (f > best || isnan(f)) && !isnan(best), as selects: written
            // with && and ||, it compiles to a branch per lane and tap
            const float f = Lanes<T>::value(v, k);
            const bool take = !(f <= best[k]) & (best[k] == best[k]);
            best[k] = take ? f : best[k];
            tap[k] = take ? dy * 3 + dx : tap[k];
          }
        }
      }
      y[img + o] = lane_bits(best);  // the winners' bits
      idx[img + o] = Taps<T>::pack(tap);
    }
  }
}

// g, idx: (n, oh, ow, cv) vectors and tap words; dx: (n, 2*oh, 2*ow, cv).
template <typename T>
__global__ void __launch_bounds__(kTrainThreads, 4)
    maxpool3x3s2_bwd_tile_kernel(const uint4* __restrict__ g,
                                 const typename Taps<T>::Word* __restrict__ idx,
                                 uint4* __restrict__ dx, int oh, int ow,
                                 int cv, TrainGeometry q) {
  using Word = typename Taps<T>::Word;
  constexpr int N = Lanes<T>::N;
  extern __shared__ uint4 tile[];
  const int w = 2 * ow;
  const Tile t = tile_of(q, oh, ow, cv);
  // staged row j is output row oy0 + j, staged column i output column
  // ox0 + i (j = rows, i = cols: the halo); g, then idx
  const int px = q.vecs, pitch = (q.cols + 1) * px;
  Word* itile = reinterpret_cast<Word*>(tile + (q.rows + 1) * pitch);
  const int64_t img = (int64_t)t.b * oh * ow * cv + t.c0;
  const int on = t.cols + (t.ox0 + t.cols < ow);  // staged columns on it
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int j = 0; j <= t.rows; ++j) {
    uint4* gd = tile + j * pitch;
    Word* id = itile + j * pitch;
    if (t.oy0 + j == oh) {
      fill(gd, t.cols + 1, t.vecs, px, zero);
      fill(id, t.cols + 1, t.vecs, px, Taps<T>::none());
      continue;
    }
    const int o = ((t.oy0 + j) * ow + t.ox0) * cv;
    stage(gd, g + img + o, on, t.vecs, cv, px);
    stage(id, idx + img + o, on, t.vecs, cv, px);
    if (on == t.cols) {
      fill(gd + t.cols * px, 1, t.vecs, px, zero);
      fill(id + t.cols * px, 1, t.vecs, px, Taps<T>::none());
    }
  }
  cp_async_wait_all();
  __syncthreads();

  uint4* db = dx + (int64_t)t.b * oh * ow * 4 * cv + t.c0;
  for (int p = threadIdx.x; p < t.cols * t.vecs; p += blockDim.x) {
    const int ox = p / t.vecs, c = p - ox * t.vecs;
    int s = ox * px + c;
    // windows (oy, ox), (oy, ox + 1); then (oy + 1, ox), (oy + 1, ox + 1)
    uint4 g0 = tile[s], g1 = tile[s + px];
    Word i0 = itile[s], i1 = itile[s + px];
    int o = (2 * t.oy0 * w + 2 * (t.ox0 + ox)) * cv + c;
    for (int r = 0; r < t.rows; ++r, o += 2 * w * cv) {
      s += pitch;
      const uint4 g2 = tile[s], g3 = tile[s + px];
      const Word i2 = itile[s], i3 = itile[s + px];
      // where(idx == tap, g, 0) of one window, for the tap that reaches
      // this pixel of the quad
      const auto term = [](const uint4& gv, const Word& iv, int tap, int k) {
        return Taps<T>::get(iv, k) == tap ? Lanes<T>::value(gv, k) : 0.f;
      };
      // one class plane at a time, each pixel's terms in plane() order;
      // 0 + a is exact, and so is rounding it, and a plane's last sum is
      // rounded once, as it is written
      float acc[N];
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] = __fadd_rn(0.f, term(g0, i0, 4, k));
      db[o] = rounded(acc);
#pragma unroll
      for (int k = 0; k < N; ++k)
        acc[k] = __fadd_rn(__fadd_rn(0.f, term(g1, i1, 3, k)),
                           term(g0, i0, 5, k));
      db[o + cv] = rounded(acc);
#pragma unroll
      for (int k = 0; k < N; ++k)
        acc[k] = __fadd_rn(__fadd_rn(0.f, term(g2, i2, 1, k)),
                           term(g0, i0, 7, k));
      db[o + w * cv] = rounded(acc);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float a = __fadd_rn(0.f, term(g3, i3, 0, k));
        a = round_to<T>(__fadd_rn(a, term(g2, i2, 2, k)));
        a = round_to<T>(__fadd_rn(a, term(g1, i1, 6, k)));
        acc[k] = __fadd_rn(a, term(g0, i0, 8, k));
      }
      db[o + (w + 1) * cv] = rounded(acc);
      g0 = g2;
      g1 = g3;
      i0 = i2;
      i1 = i3;
    }
  }
}

// the launch: refuses an image of 2^31 vectors or more (its index math is
// 32-bit) and a grid of more than INT_MAX blocks
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, const TrainGeometry& q, int64_t n,
                 int64_t image_vecs, cudaStream_t stream, Args... args) {
  const int64_t blocks =
      n * q.strips * (int64_t)q.col_tiles * q.vec_tiles;
  if (image_vecs >= ((int64_t)1 << 31) || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (q.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kTrainThreads, q.smem, stream>>>(args..., q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_argmax(const void* x, void* y, void* idx, int64_t n, int h, int w,
                  int c, cudaStream_t stream) {
  const int cv = c / Lanes<T>::N;
  const TrainGeometry q = train_geometry(false, Lanes<T>::N, h / 2, w / 2,
                                         cv);
  return launch_tiles(maxpool3x3s2_argmax_tile_kernel<T>, q, n,
                         (int64_t)h * w * cv, stream,
                         static_cast<const uint4*>(x), static_cast<uint4*>(y),
                         static_cast<typename Taps<T>::Word*>(idx), h, w, cv);
}

template <typename T>
int launch_bwd(const void* g, const void* idx, void* dx, int64_t n, int oh,
               int ow, int c, cudaStream_t stream) {
  const int cv = c / Lanes<T>::N;
  const TrainGeometry q = train_geometry(true, Lanes<T>::N, oh, ow, cv);
  return launch_tiles(
      maxpool3x3s2_bwd_tile_kernel<T>, q, n, (int64_t)4 * oh * ow * cv,
      stream, static_cast<const uint4*>(g),
      static_cast<const typename Taps<T>::Word*>(idx),
      static_cast<uint4*>(dx), oh, ow, cv);
}

}  // namespace

// K2b.  x: contiguous NHWC (n, h, w, c) with even h and w; y: (n, h/2,
// w/2, c) of x's dtype (0 = float32, 1 = bfloat16); idx: int8 of y's
// shape.  Same limits on c as tm_maxpool3x3s2.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an image of 2^31 vectors or more.
extern "C" int tm_maxpool3x3s2_argmax(const void* x, void* y, void* idx,
                                      long long n, int h, int w, int c,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_argmax<__nv_bfloat16>(x, y, idx, n, h, w, c, s);
  if (dtype == 0) return launch_argmax<float>(x, y, idx, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

// K2c.  g: (n, oh, ow, c) of `dtype`, idx: int8 (n, oh, ow, c) from
// tm_maxpool3x3s2_argmax; dx: (n, 2*oh, 2*ow, c) of g's dtype.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue as tm_maxpool3x3s2_argmax.
extern "C" int tm_maxpool3x3s2_bwd(const void* g, const void* idx, void* dx,
                                   long long n, int oh, int ow, int c,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(g, idx, dx, n, oh, ow, c, s);
  if (dtype == 0) return launch_bwd<float>(g, idx, dx, n, oh, ow, c, s);
  return (int)cudaErrorInvalidValue;
}

// The tiles of K2b (bwd = 0) or K2c (bwd = 1) for x of (h, w, c) per
// image in `dtype`: out[0..7] = rows, cols and channel vectors of a
// tile; strips, column tiles and channel tiles of an image; shared
// memory bytes and threads per block.  Returns cudaErrorInvalidValue for
// a shape the kernels do not take.
extern "C" int tm_maxpool_train_geometry(int bwd, int dtype, int h, int w,
                                         int c, int* out) {
  const int lanes = dtype == 1 ? 8 : dtype == 0 ? 4 : 0;
  if (!lanes || h < 2 || w < 2 || h % 2 || w % 2 || c < lanes || c % lanes)
    return (int)cudaErrorInvalidValue;
  const TrainGeometry q =
      train_geometry(bwd != 0, lanes, h / 2, w / 2, c / lanes);
  const int v[8] = {q.rows,      q.cols,      q.vecs,  q.strips,
                    q.col_tiles, q.vec_tiles, q.smem,  kTrainThreads};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
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
