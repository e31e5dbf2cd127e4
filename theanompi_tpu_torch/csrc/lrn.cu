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
// What bounds it on an H100: bytes.  Per element the forward does ~2n+5
// f32 operations and one powf on 4 bytes of bf16 traffic (x in, y out),
// the backward twice that on 6 bytes (x, g in, dx out); even counting a
// powf as ~20 operations that is well under the card's ~20 f32 operations
// per byte of HBM, so the floor is the bytes over 3.35 TB/s.
//
// What the design does about it: a block takes a tile of whole rows,
// which is one contiguous run of rows*C elements, so every thread loads
// and stores 16 bytes (8 bf16 or 4 f32 values) at neighbouring addresses
// whatever C is (a C that is not a multiple of the vector width, or a
// misaligned tensor, takes a scalar path).  The tile is staged once in
// shared memory as f32, so x crosses HBM once, and the arithmetic runs
// one element per thread at a time, neighbouring threads on neighbouring
// channels, so the window's reads of its neighbours hit distinct shared
// memory banks; results go to a shared plane and leave the block as
// 16-byte stores.  The backward's planes: x, then g overwritten in place
// by t = g*x*s^(-beta-1) (which the adjoint window reads across
// channels), and the first term g*s^(-beta-1)*s overwritten in place by
// dx.  No value crosses rows, so there is no reduction across blocks and
// no ragged-tail masking beyond the last tile's row count.
//
// Exactness: every product and sum uses __fmul_rn/__fadd_rn/__fsub_rn, so
// the compiler does not contract them into FMAs, in the plain PyTorch
// version's order (window taps d = 0 .. n-1 left to right over zero
// padding); the power is powf, never __powf, and nothing is built with
// --use_fast_math; the result is rounded to the output dtype once.  The
// plain version does the same f32 operations one rounding at a time.
//
// The launch allocates nothing, runs on the caller's stream and does not
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// f32 elements of x per tile (whole rows; one row when C is larger)
constexpr int kTileElems = 2048;
// widest C: the backward's three f32 planes of one row then fill the
// default 48 KB of shared memory
constexpr int kMaxChannels = 4096;

struct Params {
  int c, n, lo;
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

// V consecutive elements: one 16-byte access when V * sizeof(T) == 16
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* q = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f32(q[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f32(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    T* q = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) q[i] = from_f32<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<T>(f[i]);
  }
}

// sum over d = 0 .. n-1 of sq(row[ch - lo + d]) (0 outside [0, c)), added
// left to right as the plain version adds its shifted copies
template <bool SQUARE>
__device__ __forceinline__ float window(const float* row, int ch, int lo,
                                        int n, int c) {
  float acc = 0.f;
  for (int d = 0; d < n; ++d) {
    const int j = ch - lo + d;
    float v = 0.f;
    if (j >= 0 && j < c) {
      v = row[j];
      if (SQUARE) v = __fmul_rn(v, v);
    }
    acc = d == 0 ? v : __fadd_rn(acc, v);
  }
  return acc;
}

// Copy `elems` values from global memory into a shared f32 plane.
template <typename T, int V>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      float* plane, int elems) {
  for (int e = threadIdx.x * V; e < elems; e += kThreads * V) {
    float f[V];
    load_vec<T, V>(src + e, f);
#pragma unroll
    for (int i = 0; i < V; ++i) plane[e + i] = f[i];
  }
}

// Round a shared f32 plane to T and store it to global memory.
template <typename T, int V>
__device__ __forceinline__ void unstage(const float* plane,
                                        T* __restrict__ dst, int elems) {
  for (int e = threadIdx.x * V; e < elems; e += kThreads * V) {
    float f[V];
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = plane[e + i];
    store_vec<T, V>(dst + e, f);
  }
}

// Walks the tile one element per thread per step: element e = base + ch
// of the row starting at `base`, advanced by kThreads without a division.
struct Cursor {
  int e, ch, base, step;
  __device__ __forceinline__ Cursor(int c) {
    e = threadIdx.x;
    ch = e % c;
    base = e - ch;
    step = kThreads % c;
  }
  __device__ __forceinline__ void next(int c) {
    e += kThreads;
    ch += step;
    base += kThreads - step;
    if (ch >= c) {
      ch -= c;
      base += c;
    }
  }
};

// K3a.  Block b takes rows [b*rpt, min((b+1)*rpt, rows)).  Shared
// memory: x and y, each rpt*C f32 values.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                   int rpt, Params p) {
  extern __shared__ float sh[];
  float* xs = sh;
  float* ys = sh + rpt * p.c;
  const int64_t row0 = (int64_t)blockIdx.x * rpt;
  const int64_t left = rows - row0;
  const int nrows = left < rpt ? (int)left : rpt;
  const int elems = nrows * p.c;
  const int64_t off = row0 * p.c;
  stage<T, V>(x + off, xs, elems);
  __syncthreads();
  for (Cursor u(p.c); u.e < elems; u.next(p.c)) {
    const float w = window<true>(xs + u.base, u.ch, p.lo, p.n, p.c);
    const float s = __fadd_rn(p.k, __fmul_rn(p.a, w));
    ys[u.e] = __fmul_rn(xs[u.e], powf(s, p.neg_beta));
  }
  __syncthreads();
  unstage<T, V>(ys, y + off, elems);
}

// K3b.  Shared memory: x; g, then t = (g*x)*s^(-beta-1); the first term
// (g*s^(-beta-1))*s, then dx: each rpt*C f32 values.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ dx, int64_t rows, int rpt, Params p) {
  extern __shared__ float sh[];
  const int tile = rpt * p.c;
  float* xs = sh;
  float* ts = sh + tile;
  float* out = sh + 2 * tile;
  const int64_t row0 = (int64_t)blockIdx.x * rpt;
  const int64_t left = rows - row0;
  const int nrows = left < rpt ? (int)left : rpt;
  const int elems = nrows * p.c;
  const int64_t off = row0 * p.c;
  stage<T, V>(x + off, xs, elems);
  stage<T, V>(g + off, ts, elems);
  __syncthreads();
  for (Cursor u(p.c); u.e < elems; u.next(p.c)) {
    const float w = window<true>(xs + u.base, u.ch, p.lo, p.n, p.c);
    const float s = __fadd_rn(p.k, __fmul_rn(p.a, w));
    const float s_mb1 = powf(s, p.neg_beta_m1);
    const float gv = ts[u.e];
    ts[u.e] = __fmul_rn(__fmul_rn(gv, xs[u.e]), s_mb1);
    out[u.e] = __fmul_rn(__fmul_rn(gv, s_mb1), s);
  }
  __syncthreads();
  const int lo_adj = p.n - 1 - p.lo;
  for (Cursor u(p.c); u.e < elems; u.next(p.c)) {
    const float wt = window<false>(ts + u.base, u.ch, lo_adj, p.n, p.c);
    out[u.e] = __fsub_rn(out[u.e],
                         __fmul_rn(__fmul_rn(p.c2, xs[u.e]), wt));
  }
  __syncthreads();
  unstage<T, V>(out, dx + off, elems);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* x, const void* g, void* out, int64_t rows,
           const Params& p, bool bwd, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int rpt = p.c >= kTileElems ? 1 : kTileElems / p.c;
  const int64_t blocks = (rows + rpt - 1) / rpt;
  const size_t smem = (bwd ? 3 : 2) * (size_t)rpt * p.c * sizeof(float);
  const bool vec = p.c % V == 0 && aligned16(x) && aligned16(out) &&
                   (!bwd || aligned16(g));
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  if (bwd) {
    if (vec)
      lrn_bwd_kernel<T, V><<<(unsigned)blocks, kThreads, smem, stream>>>(
          xt, gt, ot, rows, rpt, p);
    else
      lrn_bwd_kernel<T, 1><<<(unsigned)blocks, kThreads, smem, stream>>>(
          xt, gt, ot, rows, rpt, p);
  } else {
    if (vec)
      lrn_fwd_kernel<T, V><<<(unsigned)blocks, kThreads, smem, stream>>>(
          xt, ot, rows, rpt, p);
    else
      lrn_fwd_kernel<T, 1><<<(unsigned)blocks, kThreads, smem, stream>>>(
          xt, ot, rows, rpt, p);
  }
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* g, void* out, long long rows,
             const Params& p, bool bwd, int dtype, void* stream) {
  if (rows <= 0 || p.c < 1 || p.c > kMaxChannels || p.n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, g, out, rows, p, bwd, s);
  if (dtype == 0) return launch<float>(x, g, out, rows, p, bwd, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3a.  x, y: contiguous (rows, c) of `dtype` (0 = float32, 1 = bfloat16),
// 1 <= c <= 4096.  Returns cudaGetLastError().
extern "C" int tm_lrn_fwd(const void* x, void* y, long long rows, int c,
                          int n, float k, float a, float neg_beta, int dtype,
                          void* stream) {
  const Params p{c, n, (n - 1) / 2, k, a, neg_beta, 0.f, 0.f};
  return dispatch(x, nullptr, y, rows, p, false, dtype, stream);
}

// K3b.  x, g, dx: contiguous (rows, c) of `dtype`; c2 = 2*a*beta.
// Returns cudaGetLastError().
extern "C" int tm_lrn_bwd(const void* x, const void* g, void* dx,
                          long long rows, int c, int n, float k, float a,
                          float neg_beta_m1, float c2, int dtype,
                          void* stream) {
  const Params p{c, n, (n - 1) / 2, k, a, 0.f, neg_beta_m1, c2};
  return dispatch(x, g, dx, rows, p, true, dtype, stream);
}
