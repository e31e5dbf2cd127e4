// Fused BN epilogue for Hopper (sm_90a): the forward (K1a, K1b) here,
// the backward (K1c, K1d) further down.
//
//     y = act(x * scale + bias [+ residual])      per channel, f32 math
//
// The forward replaces the Pallas TPU kernels `_fwd_kernel` / `_fwd_res_kernel`
// reached through `_fused_fwd` / `_fused_res_fwd`
// (theanompi_tpu/ops/fused_bn.py).  The Pallas version tiles the
// flattened (N*H*W, C) view into ~512 KB VMEM row blocks, one grid step
// at a time on one core.
//
// What bounds it on an H100: bytes.  Per element it does 2-3 f32 ops on
// 4-6 bytes of traffic (bf16 x [+ res] in, bf16 y out), ~0.5 op/byte
// against the card's ~20 f32 op/byte of ALU per byte of HBM, so the
// floor is (bytes of x + res + y) / 3.35 TB/s.
//
// What the design does about it: every global access is 16 bytes wide
// along C (8 bf16 or 4 f32 values per thread), neighbouring threads on
// neighbouring addresses, so each warp moves 512 contiguous bytes per
// load.  The C-vectors of scale and bias are staged once per block in
// shared memory (2*C*4 bytes) instead of being re-read per element.  A
// grid-stride loop over the 16-byte vectors keeps a fixed number of
// blocks resident whatever the row count; the channel of a vector is
// carried incrementally so the loop has no 64-bit division.  Products
// and sums use __fmul_rn/__fadd_rn so the compiler does not contract
// them into an FMA: the result is then bit-identical to the plain
// PyTorch version, which rounds after each op.
//
// The launch allocates nothing, runs on the caller's stream and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <bool RES, bool RELU>
__device__ __forceinline__ float epilogue(float x, float s, float b,
                                          float r) {
  float z = __fadd_rn(__fmul_rn(x, s), b);
  if (RES) z = __fadd_rn(z, r);
  // `z < 0 ? 0 : z` lets NaN through, as jnp.maximum and torch.relu do
  // (fmaxf would turn NaN into 0)
  if (RELU) z = z < 0.f ? 0.f : z;
  return z;
}

// One 16-byte vector: 8 bf16 or 4 f32 values.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const uint4& u, float (&f)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 t = __bfloat1622float2(p[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 store(const float (&f)[8]) {
    uint4 u;
    __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = __float2bfloat16(f[k]);
    return u;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const uint4& u, float (&f)[4]) {
    const float* p = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = p[k];
  }
  __device__ __forceinline__ static uint4 store(const float (&f)[4]) {
    uint4 u;
    float* p = reinterpret_cast<float*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = f[k];
    return u;
  }
};

// x, res, y: n_vec 16-byte vectors of a row-major (rows, c) tensor;
// cv = c / N vectors per row.
template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
    scale_bias_act_kernel(const uint4* __restrict__ x,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          const uint4* __restrict__ res,
                          uint4* __restrict__ y, int64_t n_vec, int cv,
                          int c) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float smem[];
  float* s_sh = smem;
  float* b_sh = smem + c;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    s_sh[i] = scale[i];
    b_sh[i] = bias[i];
  }
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  int cvi = (int)(v % cv);
  const int step = (int)(stride % cv);
  for (; v < n_vec; v += stride) {
    const int ch = cvi * N;
    float xf[N], rf[N], z[N];
    Vec<T>::load(x[v], xf);
    if (RES) Vec<T>::load(res[v], rf);
#pragma unroll
    for (int k = 0; k < N; ++k)
      z[k] = epilogue<RES, RELU>(xf[k], s_sh[ch + k], b_sh[ch + k],
                                 RES ? rf[k] : 0.f);
    y[v] = Vec<T>::store(z);
    cvi += step;
    if (cvi >= cv) cvi -= cv;
  }
}

template <typename T, bool RES, bool RELU>
void launch(const void* x, const void* scale, const void* bias,
            const void* res, void* y, int64_t rows, int c,
            cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const int cv = c / N;
  const int64_t n_vec = rows * (int64_t)cv;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t smem = 2 * (size_t)c * sizeof(float);
  scale_bias_act_kernel<T, RES, RELU><<<(int)blocks, kThreads, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const uint4*>(res),
      static_cast<uint4*>(y), n_vec, cv, c);
}

template <typename T>
void dispatch(const void* x, const void* scale, const void* bias,
              const void* res, void* y, int64_t rows, int c, int relu,
              cudaStream_t stream) {
  if (res != nullptr) {
    if (relu)
      launch<T, true, true>(x, scale, bias, res, y, rows, c, stream);
    else
      launch<T, true, false>(x, scale, bias, res, y, rows, c, stream);
  } else {
    if (relu)
      launch<T, false, true>(x, scale, bias, res, y, rows, c, stream);
    else
      launch<T, false, false>(x, scale, bias, res, y, rows, c, stream);
  }
}

// -- backward (K1c, K1d) ---------------------------------------------------
//
// Replaces the Pallas TPU kernels `_bwd_kernel` / `_bwd_res_kernel`
// reached through `_fused_bwd` / `_fused_res_bwd`
// (theanompi_tpu/ops/fused_bn.py):
//
//     g'   = relu ? (x*s + b [+ r] > 0 ? g : 0) : g      (mask recomputed)
//     dx   = g' * s            in x's dtype
//     dres = g'                in res's dtype
//     ds   = sum over rows of g' * x,  db = sum over rows of g'   (f32)
//
// What bounds it on an H100: bytes.  x, g and dx (K1c), plus res and
// dres (K1d), each cross HBM once: 3 or 5 streams of rows*C elements.
//
// What the design does about it: two passes, no atomics, as the Pallas
// version (per-block partials summed after the launch).  Pass 1 is a
// grid of row tiles (blockIdx.x) by channel chunks (blockIdx.y).  Each
// thread owns one 16-byte channel vector and streams every `groups`-th
// row of its tile, writing dx (and dres) and keeping the partial sums of
// g'*x and g' in f32 registers.  The block then adds its row groups'
// partials in a fixed order through shared memory and stores one (C,)
// row per tile into an f32 scratch of (tiles, C).  Pass 2 sums that
// scratch over tiles in tile order, one thread per channel.  Every sum
// runs in a fixed order, so the gradients are the same from run to run.
// The mask uses the forward's arithmetic (__fmul_rn/__fadd_rn, no FMA),
// so a z within an ulp of 0 gets the same mask in both directions.

constexpr int kBwdThreads = 256;

// Per-launch geometry: lanes = channel vectors per block, groups = rows
// in flight per block, chunks = blocks along C.  The number of row tiles
// (blocks along the rows) is the caller's: it sizes the scratch.
struct BwdGeometry {
  int lanes, groups, chunks;
};

inline BwdGeometry bwd_geometry(int cv) {
  BwdGeometry g;
  g.lanes = cv < kBwdThreads ? cv : kBwdThreads;
  g.groups = kBwdThreads / g.lanes;
  g.chunks = (cv + g.lanes - 1) / g.lanes;
  return g;
}

template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kBwdThreads)
    scale_bias_act_bwd_kernel(const uint4* __restrict__ x,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              const uint4* __restrict__ res,
                              const uint4* __restrict__ g,
                              uint4* __restrict__ dx, uint4* __restrict__ dres,
                              float* __restrict__ ds_part,
                              float* __restrict__ db_part, int64_t rows,
                              int cv, int c, int lanes, int groups,
                              int64_t tile_rows) {
  constexpr int N = Vec<T>::N;
  // [groups][lanes][N] partials of sum(g'x) then of sum(g')
  extern __shared__ float part[];
  float* ds_sh = part;
  float* db_sh = part + (size_t)groups * lanes * N;

  const int lane = threadIdx.x % lanes;
  const int grp = threadIdx.x / lanes;
  const int cvi = blockIdx.y * lanes + lane;
  const bool live = grp < groups && cvi < cv;
  float ds_acc[N], db_acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) ds_acc[k] = db_acc[k] = 0.f;

  if (live) {
    const int ch = cvi * N;
    float s[N], b[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s[k] = scale[ch + k];
      b[k] = bias[ch + k];
    }
    const int64_t r0 = (int64_t)blockIdx.x * tile_rows;
    int64_t r1 = r0 + tile_rows;
    if (r1 > rows) r1 = rows;
    for (int64_t r = r0 + grp; r < r1; r += groups) {
      const int64_t v = r * cv + cvi;
      float xf[N], gf[N], rf[N], o[N];
      Vec<T>::load(x[v], xf);
      Vec<T>::load(g[v], gf);
      if (RES && RELU) Vec<T>::load(res[v], rf);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (RELU) {
          float z = __fadd_rn(__fmul_rn(xf[k], s[k]), b[k]);
          if (RES) z = __fadd_rn(z, rf[k]);
          if (!(z > 0.f)) gf[k] = 0.f;
        }
        o[k] = __fmul_rn(gf[k], s[k]);
        ds_acc[k] = __fadd_rn(ds_acc[k], __fmul_rn(gf[k], xf[k]));
        db_acc[k] = __fadd_rn(db_acc[k], gf[k]);
      }
      dx[v] = Vec<T>::store(o);
      if (RES) dres[v] = Vec<T>::store(gf);
    }
  }
  if (grp < groups) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      ds_sh[((size_t)grp * lanes + lane) * N + k] = ds_acc[k];
      db_sh[((size_t)grp * lanes + lane) * N + k] = db_acc[k];
    }
  }
  __syncthreads();
  // row group 0 adds the groups in order and stores this tile's row
  if (grp == 0 && cvi < cv) {
    float ds_t[N], db_t[N];
#pragma unroll
    for (int k = 0; k < N; ++k) ds_t[k] = db_t[k] = 0.f;
    for (int q = 0; q < groups; ++q) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        ds_t[k] = __fadd_rn(ds_t[k], ds_sh[((size_t)q * lanes + lane) * N + k]);
        db_t[k] = __fadd_rn(db_t[k], db_sh[((size_t)q * lanes + lane) * N + k]);
      }
    }
    float* ds_row = ds_part + (size_t)blockIdx.x * c + (size_t)cvi * N;
    float* db_row = db_part + (size_t)blockIdx.x * c + (size_t)cvi * N;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      ds_row[k] = ds_t[k];
      db_row[k] = db_t[k];
    }
  }
}

// ds[ch] = sum over tiles of ds_part[tile][ch], in tile order (db alike)
__global__ void __launch_bounds__(kBwdThreads)
    sum_tiles_kernel(const float* __restrict__ ds_part,
                     const float* __restrict__ db_part, float* __restrict__ ds,
                     float* __restrict__ db, int tiles, int c) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float s = 0.f, b = 0.f;
  for (int t = 0; t < tiles; ++t) {
    s = __fadd_rn(s, ds_part[(size_t)t * c + ch]);
    b = __fadd_rn(b, db_part[(size_t)t * c + ch]);
  }
  ds[ch] = s;
  db[ch] = b;
}

template <typename T, bool RES, bool RELU>
void launch_bwd(const void* x, const void* scale, const void* bias,
                const void* res, const void* g, void* dx, void* dres,
                void* part, void* ds, void* db, int64_t rows, int c,
                int tiles, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const int cv = c / N;
  const BwdGeometry geo = bwd_geometry(cv);
  const int64_t tile_rows = (rows + tiles - 1) / tiles;
  float* ds_part = static_cast<float*>(part);
  float* db_part = ds_part + (size_t)tiles * c;
  const size_t smem = 2 * (size_t)geo.groups * geo.lanes * N * sizeof(float);
  const dim3 grid(tiles, geo.chunks);
  scale_bias_act_bwd_kernel<T, RES, RELU><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const uint4*>(res),
      static_cast<const uint4*>(g), static_cast<uint4*>(dx),
      static_cast<uint4*>(dres), ds_part, db_part, rows, cv, c, geo.lanes,
      geo.groups, tile_rows);
  sum_tiles_kernel<<<(c + kBwdThreads - 1) / kBwdThreads, kBwdThreads, 0,
                     stream>>>(ds_part, db_part, static_cast<float*>(ds),
                               static_cast<float*>(db), tiles, c);
}

template <typename T>
void dispatch_bwd(const void* x, const void* scale, const void* bias,
                  const void* res, const void* g, void* dx, void* dres,
                  void* part, void* ds, void* db, int64_t rows, int c,
                  int tiles, int relu, cudaStream_t stream) {
  if (res != nullptr) {
    if (relu)
      launch_bwd<T, true, true>(x, scale, bias, res, g, dx, dres, part, ds,
                                db, rows, c, tiles, stream);
    else
      launch_bwd<T, true, false>(x, scale, bias, res, g, dx, dres, part, ds,
                                 db, rows, c, tiles, stream);
  } else {
    if (relu)
      launch_bwd<T, false, true>(x, scale, bias, res, g, dx, dres, part, ds,
                                 db, rows, c, tiles, stream);
    else
      launch_bwd<T, false, false>(x, scale, bias, res, g, dx, dres, part, ds,
                                  db, rows, c, tiles, stream);
  }
}

}  // namespace

// The backward of tm_scale_bias_act.  x, res, g, dx and dres share
// `dtype` (0 = float32, 1 = bfloat16) and the (rows, c) row-major layout;
// res and dres are both null (K1c) or both set (K1d).  scale, bias, ds
// and db are float32 (c,); part is a float32 scratch of 2 * tiles * c,
// where tiles >= 1 is the number of row tiles (any count is correct; it
// sets how the rows are split).  Same limits on c as the forward; the
// Python wrapper checks them.  rows must be > 0.  Returns
// cudaGetLastError().
extern "C" int tm_scale_bias_act_bwd(const void* x, const void* scale,
                                     const void* bias, const void* res,
                                     const void* g, void* dx, void* dres,
                                     void* part, void* ds, void* db,
                                     long long rows, int c, int tiles,
                                     int dtype, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((res == nullptr) != (dres == nullptr) || rows <= 0 || tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    dispatch_bwd<__nv_bfloat16>(x, scale, bias, res, g, dx, dres, part, ds,
                                db, rows, c, tiles, relu, s);
  else if (dtype == 0)
    dispatch_bwd<float>(x, scale, bias, res, g, dx, dres, part, ds, db, rows,
                        c, tiles, relu, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (x, res and y share it); scale and
// bias are float32 (c,).  res may be null.  c must be a multiple of the
// 16-byte vector width (4 for f32, 8 for bf16) and at most 6144, so the
// staged scale/bias fit the default 48 KB of shared memory; the Python
// wrapper checks both.  Returns cudaGetLastError().
extern "C" int tm_scale_bias_act(const void* x, const void* scale,
                                 const void* bias, const void* res, void* y,
                                 long long rows, int c, int dtype, int relu,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dispatch<__nv_bfloat16>(x, scale, bias, res, y, rows, c, relu, s);
  else if (dtype == 0)
    dispatch<float>(x, scale, bias, res, y, rows, c, relu, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
