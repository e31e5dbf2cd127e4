// Cross-channel LRN for Hopper (sm_90a): the forward (K3a) and the
// backward (K3b), over the row-major (N*H*W, C) view of an NHWC tensor.
//
//     s  = k + a * W(x*x)        W: sum over the n-channel window, zero-padded
//     y  = x * s^(-beta)                                          (K3a)
//     dx = g * s^(-beta-1) * s - 2*a*beta * x * W^T(g * x * s^(-beta-1))
//                                                                 (K3b)
//
// W takes the taps x[c - lo + d], d = 0 .. n-1, lo = (n-1)/2; W^T (the
// adjoint) takes x[c - hi + d], hi = n-1-lo: the same window for odd n,
// the mirrored one for even n.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` / `_bwd_kernel` that
// `_blocked_call` (theanompi_tpu/ops/lrn_pallas.py) launches for
// `_lrn_fwd` / `_lrn_bwd`.  The Pallas version holds 1024 rows x all C in
// VMEM per grid step and computes in the input's dtype.
//
// What bounds it on an H100: instructions, not bytes.  The accurate powf
// is about 70 SASS instructions per element (cuobjdump; its exponent is a
// run-time value, so its special cases stay in), one per element in each
// kernel: at AlexNet's 61 M LRN elements per step that alone is about
// 0.13 ms of issue on 132 SMs, beside a byte bound of 0.073 ms (K3a) and
// 0.109 ms (K3b).  So the rest of the work per element has to be a few
// instructions, and the loads have to run under the arithmetic.
//
// What the design does about it.  A persistent block (as many as fit on
// the card) walks tiles of whole rows; a tile is one contiguous run of at
// most 4096 elements, and each thread owns 16 of them as 16-byte vectors
// (8 bf16 or 4 f32 channels of one row; a C that is not a multiple of the
// vector width, or a misaligned tensor, takes the scalar path).  The
// thread issues the next tile's loads before it computes the current one
// and keeps x (and g) in registers from load to store; the results leave
// as 16-byte stores.  Shared memory holds only what crosses threads: the
// squares, and in K3b t = g*x*s^(-beta-1), which the windows read across
// channels, each row padded with zeros on both sides so no tap tests a
// bound, and K3b's first term g*s^(-beta-1)*s, parked there over the
// barrier so that three blocks fit on an SM.  For n = 5 (AlexNet's) a
// thread reads just the 4 values on each side of its vector from shared
// memory and takes its own from registers; other n read every tap.  K3a
// alternates two planes of squares (one barrier a tile), K3b has two
// barriers a tile.  The tile geometry is computed in one place,
// `geometry`, which `tm_lrn_geometry` exports.
//
// Exactness: every product and sum uses __fmul_rn/__fadd_rn/__fsub_rn, so
// the compiler does not contract them into FMAs, in the plain PyTorch
// version's order (window taps d = 0 .. n-1 left to right over zero
// padding; a tap that lies further than C channels out adds a zero that
// a nearer padded tap already added, so the window is cut to C on each
// side without changing a bit); the power is powf, never __powf, and
// nothing is built with --use_fast_math; the result is rounded to the
// output dtype once.  The plain version does the same f32 operations one
// rounding at a time.
//
// The launch allocates nothing, runs on the caller's stream and does not
// synchronise; each C entry point returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// values of one tensor a thread holds per tile
constexpr int kPerThread = 16;
// elements per tile (whole rows)
constexpr int kTileElems = kThreads * kPerThread;
// widest C: one row per tile
constexpr int kMaxChannels = 4096;
static_assert(kMaxChannels <= kTileElems, "a row must fit in a tile");
// floats of a shared plane the tile's row count is held to; one row of
// C = 4096 with the widest window cut to C needs exactly this many
constexpr int kPlaneFloats = 3 * kMaxChannels;

// shared planes: K3a's squares for alternate tiles; K3b's squares, t and
// the first term
__host__ __device__ constexpr int planes(bool bwd) { return bwd ? 3 : 2; }

struct Geometry {
  int lo, hi;     // window taps below and above a channel, cut to C
  int pad;        // zero columns on each side of a plane's row (>= lo, hi)
  int stride;     // floats per row of a plane
  int rows;       // rows per tile
  int smem;       // bytes of shared memory per block
};

Geometry geometry(int c, int n, bool bwd) {
  Geometry q;
  q.lo = (n - 1) / 2 < c ? (n - 1) / 2 : c;
  q.hi = n - 1 - (n - 1) / 2 < c ? n - 1 - (n - 1) / 2 : c;
  const int reach = q.lo > q.hi ? q.lo : q.hi;
  q.pad = (reach > 1 ? reach : 1) + 3 & ~3;
  q.stride = (c + 3 & ~3) + 2 * q.pad;
  const int by_elems = kTileElems / c, by_plane = kPlaneFloats / q.stride;
  const int rows = by_elems < by_plane ? by_elems : by_plane;
  q.rows = rows > 1 ? rows : 1;
  q.smem = planes(bwd) * q.rows * q.stride * (int)sizeof(float);
  return q;
}

struct Params {
  int64_t rows;
  int c, lo, hi, pad, stride, tile_rows;
  float k, a, neg_beta, neg_beta_m1, c2;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements as they cross HBM: one 16-byte access, or one
// element on the scalar path
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&f)[V]) {
  const T* q = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f32(q[i]);
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> pack(const float (&f)[V]) {
  Raw<T, V> r;
  T* q = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) q[i] = from_f32<T>(f[i]);
  return r;
}

template <int V>
__device__ __forceinline__ void get(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      f[i] = v.x, f[i + 1] = v.y, f[i + 2] = v.z, f[i + 3] = v.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void put(float* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = f[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

// w[j] = sum over d = 0 .. taps-1 of plane[own + j - below + d], added left
// to right; mine[j] = plane[own + j].  FAST: below = 2, taps = 5, V >= 4:
// the 4 values on each side come from shared memory as two 16-byte
// reads (zero padding at the row's ends), the rest from registers.
template <int V, bool FAST>
__device__ __forceinline__ void window(const float* plane, int own,
                                       const float (&mine)[V], int below,
                                       int taps, float (&w)[V]) {
  if constexpr (FAST) {
    const float4 l = *reinterpret_cast<const float4*>(plane + own - 4);
    const float4 r = *reinterpret_cast<const float4*>(plane + own + V);
    float t[V + 8];
    t[0] = l.x, t[1] = l.y, t[2] = l.z, t[3] = l.w;
#pragma unroll
    for (int j = 0; j < V; ++j) t[4 + j] = mine[j];
    t[V + 4] = r.x, t[V + 5] = r.y, t[V + 6] = r.z, t[V + 7] = r.w;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float acc = t[j + 2];
#pragma unroll
      for (int d = 1; d < 5; ++d) acc = __fadd_rn(acc, t[j + 2 + d]);
      w[j] = acc;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float* q = plane + own + j - below;
      float acc = q[0];
      for (int d = 1; d < taps; ++d) acc = __fadd_rn(acc, q[d]);
      w[j] = acc;
    }
  }
}

// Blocks per SM each instance is built for: registers are capped at
// 65536 / (256 * that), chosen so no instance spills.
__host__ __device__ constexpr int min_blocks(size_t elt, int v, bool bwd) {
  return v == 1 ? 1 : bwd ? (elt == 2 ? 3 : 2) : (elt == 2 ? 5 : 4);
}

// K3a (BWD false) and K3b (BWD true).  Block b takes tiles b, b + grid,
// ...; tile t is rows [t*tile_rows, ...), elements [t*tile_rows*C, ...).
// Thread slot u holds the vector at element (threadIdx.x + u*kThreads)*V
// of every tile.  Shared memory: planes of tile_rows x stride f32, zero
// outside the row's C channels: K3a's squares, in two planes used tile
// by tile in turn; K3b's squares, t and the first term g*s^(-beta-1)*s.
template <typename T, int V, bool FAST, bool BWD>
__global__ void __launch_bounds__(kThreads, min_blocks(sizeof(T), V, BWD))
    lrn_kernel(const T* __restrict__ x, const T* __restrict__ g,
               T* __restrict__ out, Params p) {
  constexpr int U = kPerThread / V;
  using R = Raw<T, V>;
  extern __shared__ float4 shared4[];
  float* sh = reinterpret_cast<float*>(shared4);
  const int plane = p.tile_rows * p.stride;
  for (int e = threadIdx.x; e < planes(BWD) * plane; e += kThreads)
    sh[e] = 0.f;

  const int vpr = p.c / V;
  const int tile_elems = p.tile_rows * p.c;
  const int taps = p.lo + p.hi + 1;
  int own[U];  // plane index of the slot's first channel
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / vpr;
    own[u] = r * p.stride + p.pad + (i - r * vpr) * V;
  }
  const int64_t ntiles = (p.rows + p.tile_rows - 1) / p.tile_rows;
  auto tile_size = [&](int64_t t) {
    const int64_t left = p.rows - t * p.tile_rows;
    return (left < p.tile_rows ? (int)left : p.tile_rows) * p.c;
  };
  R xc[U], gc[U], xn[U], gn[U];
  auto fetch = [&](int64_t t, R (&xr)[U], R (&gr)[U]) {
    const int64_t base = t * tile_elems;
    const int size = tile_size(t);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = (threadIdx.x + u * kThreads) * V;
      if (e < size) {
        xr[u] = *reinterpret_cast<const R*>(x + base + e);
        if constexpr (BWD) gr[u] = *reinterpret_cast<const R*>(g + base + e);
      }
    }
  };

  int64_t t = blockIdx.x;
  fetch(t, xc, gc);
  __syncthreads();
  for (int it = 0; t < ntiles; ++it, t += gridDim.x) {
    if (t + gridDim.x < ntiles) fetch(t + gridDim.x, xn, gn);
    const int size = tile_size(t);
    const int64_t base = t * tile_elems;
    float* sq = sh + (BWD ? 0 : (it & 1) * plane);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if ((threadIdx.x + u * kThreads) * V < size) {
        float xv[V], s2[V];
        unpack<T, V>(xc[u], xv);
#pragma unroll
        for (int j = 0; j < V; ++j) s2[j] = __fmul_rn(xv[j], xv[j]);
        put<V>(sq + own[u], s2);
      }
    }
    __syncthreads();
    if constexpr (!BWD) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = (threadIdx.x + u * kThreads) * V;
        if (e < size) {
          float xv[V], s2[V], w[V];
          unpack<T, V>(xc[u], xv);
#pragma unroll
          for (int j = 0; j < V; ++j) s2[j] = __fmul_rn(xv[j], xv[j]);
          window<V, FAST>(sq, own[u], s2, p.lo, taps, w);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float s = __fadd_rn(p.k, __fmul_rn(p.a, w[j]));
            w[j] = __fmul_rn(xv[j], powf(s, p.neg_beta));
          }
          *reinterpret_cast<R*>(out + base + e) = pack<T, V>(w);
        }
      }
    } else {
      float* ts = sh + plane;
      float* fs = sh + 2 * plane;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if ((threadIdx.x + u * kThreads) * V < size) {
          float xv[V], gv[V], s2[V], w[V], tv[V];
          unpack<T, V>(xc[u], xv);
          unpack<T, V>(gc[u], gv);
#pragma unroll
          for (int j = 0; j < V; ++j) s2[j] = __fmul_rn(xv[j], xv[j]);
          window<V, FAST>(sq, own[u], s2, p.lo, taps, w);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float s = __fadd_rn(p.k, __fmul_rn(p.a, w[j]));
            const float s_mb1 = powf(s, p.neg_beta_m1);
            tv[j] = __fmul_rn(__fmul_rn(gv[j], xv[j]), s_mb1);
            w[j] = __fmul_rn(__fmul_rn(gv[j], s_mb1), s);
          }
          put<V>(ts + own[u], tv);
          put<V>(fs + own[u], w);
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = (threadIdx.x + u * kThreads) * V;
        if (e < size) {
          float xv[V], tv[V], first[V], wt[V];
          unpack<T, V>(xc[u], xv);
          get<V>(ts + own[u], tv);
          get<V>(fs + own[u], first);
          window<V, FAST>(ts, own[u], tv, p.hi, taps, wt);
#pragma unroll
          for (int j = 0; j < V; ++j)
            wt[j] = __fsub_rn(first[j],
                              __fmul_rn(__fmul_rn(p.c2, xv[j]), wt[j]));
          *reinterpret_cast<R*>(out + base + e) = pack<T, V>(wt);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xc[u] = xn[u];
      if constexpr (BWD) gc[u] = gn[u];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, T*, Params);

template <typename T, bool BWD>
KernelFn<T> pick(bool vec, bool fast) {
  constexpr int V = 16 / sizeof(T);
  if (fast) return lrn_kernel<T, V, true, BWD>;
  if (vec) return lrn_kernel<T, V, false, BWD>;
  return lrn_kernel<T, 1, false, BWD>;
}

template <typename T>
int launch(const void* x, const void* g, void* out, const Params& p,
           int smem, bool bwd, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = p.c % V == 0 && aligned16(x) && aligned16(out) &&
                   (!bwd || aligned16(g));
  const bool fast = vec && p.lo == 2 && p.hi == 2;
  const KernelFn<T> kernel =
      bwd ? pick<T, true>(vec, fast) : pick<T, false>(vec, fast);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t ntiles = (p.rows + p.tile_rows - 1) / p.tile_rows;
  const int64_t room = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned blocks = (unsigned)(ntiles < room ? ntiles : room);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* g, void* out, long long rows, int c,
             int n, float k, float a, float neg_beta, float neg_beta_m1,
             float c2, bool bwd, int dtype, void* stream) {
  if (rows <= 0 || c < 1 || c > kMaxChannels || n < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry q = geometry(c, n, bwd);
  const Params p{rows, c, q.lo, q.hi, q.pad, q.stride, q.rows,
                 k, a, neg_beta, neg_beta_m1, c2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, out, p, q.smem, bwd, s);
  if (dtype == 0) return launch<float>(x, g, out, p, q.smem, bwd, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3a.  x, y: contiguous (rows, c) of `dtype` (0 = float32, 1 = bfloat16),
// 1 <= c <= 4096.  Returns the first CUDA error (0: launched).
extern "C" int tm_lrn_fwd(const void* x, void* y, long long rows, int c,
                          int n, float k, float a, float neg_beta, int dtype,
                          void* stream) {
  return dispatch(x, nullptr, y, rows, c, n, k, a, neg_beta, 0.f, 0.f, false,
                  dtype, stream);
}

// K3b.  x, g, dx: contiguous (rows, c) of `dtype`; c2 = 2*a*beta.
// Returns the first CUDA error (0: launched).
extern "C" int tm_lrn_bwd(const void* x, const void* g, void* dx,
                          long long rows, int c, int n, float k, float a,
                          float neg_beta_m1, float c2, int dtype,
                          void* stream) {
  return dispatch(x, g, dx, rows, c, n, k, a, 0.f, neg_beta_m1, c2, true,
                  dtype, stream);
}

// The tile the kernels take for (c, n): out[0] rows per tile, out[1]
// floats per row of a shared plane, out[2] zero columns on each side of
// a row, out[3] and out[4] bytes of shared memory per block of K3a and
// K3b.  Returns 0, or cudaErrorInvalidValue for c or n out of range.
extern "C" int tm_lrn_geometry(int c, int n, int* out) {
  if (c < 1 || c > kMaxChannels || n < 1) return (int)cudaErrorInvalidValue;
  const Geometry q = geometry(c, n, false);
  out[0] = q.rows;
  out[1] = q.stride;
  out[2] = q.pad;
  out[3] = q.smem;
  out[4] = geometry(c, n, true).smem;
  return 0;
}
