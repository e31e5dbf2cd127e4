// Fused BN epilogue forward for Hopper (sm_90a):
//
//     y = act(x * scale + bias [+ residual])      per channel, f32 math
//
// Replaces the Pallas TPU kernels `_fwd_kernel` / `_fwd_res_kernel`
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

}  // namespace

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
