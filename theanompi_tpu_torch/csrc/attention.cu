// Fused softmax attention for Hopper (sm_90a): the forward (K4a) and the
// two-pass backward (K4b: a row pass for dq, a column pass for dk and dv).
// Tensors are (B, T, H, D), contiguous, read in place: a head's row is D
// values at a stride of H*D.
//
//     s   = scale * q k^T                    (f32)
//     s   = -1e30 where q_pos < k_pos        (causal only; global positions)
//     p   = exp(s - m), l = sum p, o = (round_T(p) v) / l, lse = m + log l
//                                                                  (K4a)
//     p   = exp(s - lse) / sum_k exp(s - lse)    (renormalized, as the
//           reference does, so a fully masked row gets the uniform 1/Tk)
//     dv  = p^T g,  dp = g v^T,  ds = p (dp - sum(dp p)),
//     dq  = ds k scale,  dk = ds^T q scale   (all f32)            (K4b)
//
// Replaces the Pallas TPU kernels `_kernel` (launched by
// `_pallas_attention`, theanompi_tpu/ops/attention.py:107) and
// `_bwd_kernel` (launched by `_pallas_attention_bwd`, attention.py:249).
// The Pallas forward holds a whole head's K and V in VMEM next to one
// (256, Tk) f32 score block; the backward holds a whole head's Q, G, K, V
// and f32 dk/dv scratch and loops the query blocks in order.  Neither fits
// the 227 KB of shared memory a block has here, and blocks run in no order.
//
// What bounds it on an H100: operations.  Per query-key pair the forward
// does 4*D operations on the causal half's work, the backward 10*D, against
// a few bytes per row of traffic: at T = 1024 that is hundreds of
// operations per byte, well above the card's balance point.  This first
// version computes in f32 on the CUDA cores (the reference computes its
// backward in f32, and the tolerances of the port hold it to that), so its
// ceiling is the 67 TFLOP/s of f32 FMA, not the 989 of bf16 tensor cores;
// wgmma tiles are work for a later change.
//
// What the design does about it:
// * K4a: one block of 256 threads per (b*h, 64 query rows), an online
//   softmax over 64-key tiles staged in shared memory as f32 (rescaling
//   the running output by exp(m_old - m_new)); the (Tq, Tk) matrix never
//   leaves the block.  p is rounded to the input dtype before the PV
//   product and l is summed from the unrounded p, as the reference does.
//   Every key tile is visited, masked or not, so a fully masked row comes
//   out as the uniform average of v with lse = -1e30 + log Tk.
// * K4b row pass: one block per (b*h, 64 query rows); a first sweep over
//   the key tiles sums p and dp*p per row, giving r = 1/sum p and
//   delta = sum(dp p) r; a second sweep writes dq = sum p r (dp - delta)
//   k scale.  r and delta go to a small f32 buffer.
// * K4b column pass: one block per (b*h, 64 keys) sweeps the query tiles
//   for dv = sum (p r)^T g and dk = sum ds^T q scale.  No atomics: every
//   output element has one owner, so the result is deterministic.
// * Every operand plane is kept in its natural [row][d] layout, padded to
//   D + 4 floats per row.  A thread owns a 4x4 micro tile of rows
//   ty + 16 i and columns tx + 16 j (interleaved), so the 16 threads that
//   read 16 different rows of a plane at one d hit 16 different bank
//   groups, and the 16 that share a row read it as a broadcast; the inner
//   loops read 16-byte vectors along d.  Row reductions (max, sums) are
//   shuffles across the 16 lanes that share a row.
// * Ragged edges are masked in the kernel: keys past Tk take p = 0, rows
//   past Tq are computed on zeros and never stored, head dims past D are
//   zero in shared memory (D <= 128, padded to 32, 64 or 128).
//
// The launch allocates nothing, runs on the caller's stream and does not
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kTile = 64;         // query rows per block, keys per tile
constexpr int kPLd = kTile + 4;   // row pitch of the p / ds planes
constexpr int kMaxHeadDim = 128;
constexpr float kMaskNeg = -1e30f;  // _MASK_NEG: finite, as the reference

struct Shape {
  int b, tq, tk, h, d;
  float scale;
  int causal;
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

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + kTile) of head (bi, hi) of a contiguous (B, t, H, D)
// tensor into the f32 plane [kTile][DP + 4]; zero past t and past D.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float* plane, int bi, int hi,
                                          int row0, int t, const Shape& s) {
  constexpr int ld = DP + 4;
  const size_t stride = (size_t)s.h * s.d;
  const T* base = src + ((size_t)bi * t * s.h + hi) * s.d;
  for (int e = threadIdx.x; e < kTile * DP; e += kThreads) {
    const int r = e / DP, dd = e % DP;
    const int row = row0 + r;
    float v = 0.f;
    if (row < t && dd < s.d) v = to_f32(base[(size_t)row * stride + dd]);
    plane[r * ld + dd] = v;
  }
}

// acc[i][j] += sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two
// [kTile][DP + 4] planes (d in order).
template <int DP>
__device__ __forceinline__ void tile_abt(const float* a, const float* b,
                                         int ty, int tx,
                                         float (&acc)[4][4]) {
  constexpr int ld = DP + 4;
#pragma unroll 2
  for (int dd = 0; dd < DP; dd += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(a + (ty + 16 * i) * ld + dd);
      av[i][0] = t.x; av[i][1] = t.y; av[i][2] = t.z; av[i][3] = t.w;
      const float4 u =
          *reinterpret_cast<const float4*>(b + (tx + 16 * i) * ld + dd);
      bv[i][0] = u.x; bv[i][1] = u.y; bv[i][2] = u.z; bv[i][3] = u.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i][e], bv[j][e], acc[i][j]);
  }
}

// acc[i][w] += sum_c p[ty + 16 i][c] * v[c][tx * DW + w] for a
// [kTile][kPLd] plane p and a [kTile][DP + 4] plane v (c in order).
template <int DP>
__device__ __forceinline__ void tile_ab(const float* p, const float* v,
                                        int ty, int tx,
                                        float (&acc)[4][DP / 16]) {
  constexpr int ld = DP + 4, DW = DP / 16;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kPLd + c);
      pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* row = v + (c + e) * ld + tx * DW;
      float vv[DW];
      if constexpr (DW == 2) {
        const float2 t = *reinterpret_cast<const float2*>(row);
        vv[0] = t.x; vv[1] = t.y;
      } else {
#pragma unroll
        for (int w = 0; w < DW; w += 4) {
          const float4 t = *reinterpret_cast<const float4*>(row + w);
          vv[w] = t.x; vv[w + 1] = t.y; vv[w + 2] = t.z; vv[w + 3] = t.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int w = 0; w < DW; ++w)
          acc[i][w] = fmaf(pv[i][e], vv[w], acc[i][w]);
    }
  }
}

// Scale and mask a 4x4 score tile of rows with positions qp[i] (rows
// ty + 16 i) and keys c0 + tx + 16 j: -1e30 where q_pos < k_pos (causal),
// -inf for keys past tk (they do not exist).
__device__ __forceinline__ void mask_scores(float (&sc)[4][4],
                                            const int (&qp)[4],
                                            const int* __restrict__ k_pos,
                                            int c0, int tx, const Shape& s) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + tx + 16 * j;
    const bool valid = c < s.tk;
    const int kp = (s.causal && valid) ? k_pos[c] : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = sc[i][j] * s.scale;
      if (s.causal && !(qp[i] >= kp)) x = kMaskNeg;
      sc[i][j] = valid ? x : -INFINITY;
    }
  }
}

template <int DP>
constexpr size_t fwd_smem() {
  return (3 * (size_t)kTile * (DP + 4) + (size_t)kTile * kPLd) *
         sizeof(float);
}
template <int DP>
constexpr size_t dq_smem() {
  return (4 * (size_t)kTile * (DP + 4) + (size_t)kTile * kPLd) *
         sizeof(float);
}
template <int DP>
constexpr size_t dkdv_smem() {
  return (4 * (size_t)kTile * (DP + 4) + 2 * (size_t)kTile * kPLd) *
         sizeof(float);
}

// K4a.  Grid (B*H, ceil(Tq / 64)).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, T* __restrict__ o,
                    float* __restrict__ lse, Shape s) {
  constexpr int ld = DP + 4, DW = DP / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * ld;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const int row0 = blockIdx.y * kTile;
  load_rows<T, DP>(q, qs, bi, hi, row0, s.tq, s);
  int qp[4];
  float m[4], l[4], acc[4][DW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    qp[i] = (s.causal && r < s.tq) ? q_pos[r] : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int w = 0; w < DW; ++w) acc[i][w] = 0.f;
  }
  for (int c0 = 0; c0 < s.tk; c0 += kTile) {
    __syncthreads();  // the last tile's reads of ks, vs, ps are done
    load_rows<T, DP>(k, ks, bi, hi, c0, s.tk, s);
    load_rows<T, DP>(v, vs, bi, hi, c0, s.tk, s);
    __syncthreads();
    float sc[4][4] = {};
    tile_abt<DP>(qs, ks, ty, tx, sc);
    mask_scores(sc, qp, k_pos, c0, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < 4; ++j) mx = fmaxf(mx, sc[i][j]);
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * kPLd + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int w = 0; w < DW; ++w) acc[i][w] *= alpha;
    }
    __syncthreads();
    tile_ab<DP>(ps, vs, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= s.tq) continue;
    T* out = o + ((size_t)(bi * s.tq + r) * s.h + hi) * s.d;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const int dd = tx * DW + w;
      if (dd < s.d) out[dd] = from_f32<T>(acc[i][w] / l[i]);
    }
    if (tx == 0) lse[(size_t)bh * s.tq + r] = m[i] + logf(l[i]);
  }
}

// K4b, row pass.  Grid (B*H, ceil(Tq / 64)).  Writes dq and, per row,
// rd = (r, delta) with r = 1 / sum p and delta = sum(dp p) r.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos,
                       const T* __restrict__ g,
                       const float* __restrict__ lse, T* __restrict__ dq,
                       float* __restrict__ rd, Shape s) {
  constexpr int ld = DP + 4, DW = DP / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* gs = qs + kTile * ld;
  float* ks = gs + kTile * ld;
  float* vs = ks + kTile * ld;
  float* dss = vs + kTile * ld;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const int row0 = blockIdx.y * kTile;
  load_rows<T, DP>(q, qs, bi, hi, row0, s.tq, s);
  load_rows<T, DP>(g, gs, bi, hi, row0, s.tq, s);
  int qp[4];
  float ls[4], sp[4], sdp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    const bool valid = r < s.tq;
    qp[i] = (s.causal && valid) ? q_pos[r] : 0;
    ls[i] = valid ? lse[(size_t)bh * s.tq + r] : 0.f;
    sp[i] = 0.f;
    sdp[i] = 0.f;
  }
  // sweep 1: sum p and sum dp p per row
  for (int c0 = 0; c0 < s.tk; c0 += kTile) {
    __syncthreads();
    load_rows<T, DP>(k, ks, bi, hi, c0, s.tk, s);
    load_rows<T, DP>(v, vs, bi, hi, c0, s.tk, s);
    __syncthreads();
    float sc[4][4] = {}, dp[4][4] = {};
    tile_abt<DP>(qs, ks, ty, tx, sc);
    tile_abt<DP>(gs, vs, ty, tx, dp);
    mask_scores(sc, qp, k_pos, c0, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - ls[i]);  // 0 past tk (-inf)
        sp[i] += p;
        sdp[i] += dp[i][j] * p;
      }
  }
  float rr[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rr[i] = 1.f / group_sum(sp[i]);
    delta[i] = group_sum(sdp[i]) * rr[i];
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < s.tq) {
      rd[((size_t)bh * s.tq + r) * 2] = rr[i];
      rd[((size_t)bh * s.tq + r) * 2 + 1] = delta[i];
    }
  }
  // sweep 2: dq = sum_c ds k
  float acc[4][DW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int w = 0; w < DW; ++w) acc[i][w] = 0.f;
  for (int c0 = 0; c0 < s.tk; c0 += kTile) {
    __syncthreads();
    load_rows<T, DP>(k, ks, bi, hi, c0, s.tk, s);
    load_rows<T, DP>(v, vs, bi, hi, c0, s.tk, s);
    __syncthreads();
    float sc[4][4] = {}, dp[4][4] = {};
    tile_abt<DP>(qs, ks, ty, tx, sc);
    tile_abt<DP>(gs, vs, ty, tx, dp);
    mask_scores(sc, qp, k_pos, c0, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - ls[i]) * rr[i];
        dss[(ty + 16 * i) * kPLd + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    tile_ab<DP>(dss, ks, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= s.tq) continue;
    T* out = dq + ((size_t)(bi * s.tq + r) * s.h + hi) * s.d;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const int dd = tx * DW + w;
      if (dd < s.d) out[dd] = from_f32<T>(acc[i][w] * s.scale);
    }
  }
}

// K4b, column pass.  Grid (B*H, ceil(Tk / 64)).  A thread's micro tile is
// keys ty + 16 i by queries tx + 16 j.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ q_pos,
                         const int* __restrict__ k_pos,
                         const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ rd, T* __restrict__ dk,
                         T* __restrict__ dv, Shape s) {
  constexpr int ld = DP + 4, DW = DP / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* gs = qs + kTile * ld;
  float* pt = gs + kTile * ld;   // [key][query]
  float* dst = pt + kTile * kPLd;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const int c0 = blockIdx.y * kTile;
  load_rows<T, DP>(k, ks, bi, hi, c0, s.tk, s);
  load_rows<T, DP>(v, vs, bi, hi, c0, s.tk, s);
  int kp[4];
  bool kvalid[4];
  float dka[4][DW], dva[4][DW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    kvalid[i] = c < s.tk;
    kp[i] = (s.causal && kvalid[i]) ? k_pos[c] : 0;
#pragma unroll
    for (int w = 0; w < DW; ++w) dka[i][w] = dva[i][w] = 0.f;
  }
  for (int r0 = 0; r0 < s.tq; r0 += kTile) {
    __syncthreads();
    load_rows<T, DP>(q, qs, bi, hi, r0, s.tq, s);
    load_rows<T, DP>(g, gs, bi, hi, r0, s.tq, s);
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};
    tile_abt<DP>(ks, qs, ty, tx, st);
    tile_abt<DP>(vs, gs, ty, tx, dpt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tx + 16 * j;
      const bool valid = r < s.tq;
      const size_t row = (size_t)bh * s.tq + r;
      const float lr = valid ? lse[row] : 0.f;
      const float rr = valid ? rd[row * 2] : 0.f;
      const float dl = valid ? rd[row * 2 + 1] : 0.f;
      const int qpj = (s.causal && valid) ? q_pos[r] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = st[i][j] * s.scale;
        if (s.causal && !(qpj >= kp[i])) x = kMaskNeg;
        const float p = (valid && kvalid[i]) ? expf(x - lr) * rr : 0.f;
        pt[(ty + 16 * i) * kPLd + tx + 16 * j] = p;
        dst[(ty + 16 * i) * kPLd + tx + 16 * j] = p * (dpt[i][j] - dl);
      }
    }
    __syncthreads();
    tile_ab<DP>(pt, gs, ty, tx, dva);
    tile_ab<DP>(dst, qs, ty, tx, dka);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= s.tk) continue;
    const size_t off = ((size_t)(bi * s.tk + c) * s.h + hi) * s.d;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const int dd = tx * DW + w;
      if (dd < s.d) {
        dk[off + dd] = from_f32<T>(dka[i][w] * s.scale);
        dv[off + dd] = from_f32<T>(dva[i][w]);
      }
    }
  }
}

bool valid_shape(const Shape& s) {
  return s.b >= 1 && s.h >= 1 && s.tq >= 1 && s.tk >= 1 && s.d >= 1 &&
         s.d <= kMaxHeadDim && (s.tq + kTile - 1) / kTile <= 65535 &&
         (s.tk + kTile - 1) / kTile <= 65535 &&
         (long long)s.b * s.h <= 0x7fffffffLL;
}

// Lets `kern` take `smem` bytes of dynamic shared memory, once per
// instantiation (the first launch of each runs outside any CUDA graph
// capture; one process drives one card).
template <typename Kern>
int launch_setup(Kern kern, size_t smem, bool& ready) {
  if (ready) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ready = e == cudaSuccess;
  return (int)e;
}

// which = 0: K4a, 1: K4b row pass, 2: K4b column pass
template <typename T, int DP>
int launch(int which, const void* q, const void* k, const void* v,
           const int* q_pos, const int* k_pos, const void* g, void* o,
           void* dk, void* dv, float* lse, float* rd, const Shape& s,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const unsigned bh = (unsigned)(s.b * s.h);
  const dim3 rows(bh, (unsigned)((s.tq + kTile - 1) / kTile));
  const dim3 cols(bh, (unsigned)((s.tk + kTile - 1) / kTile));
  static bool ready[3] = {false, false, false};
  int err;
  if (which == 0) {
    auto kern = attn_fwd_kernel<T, DP>;
    if ((err = launch_setup(kern, fwd_smem<DP>(), ready[0])) != 0) return err;
    kern<<<rows, kThreads, fwd_smem<DP>(), stream>>>(
        qt, kt, vt, q_pos, k_pos, static_cast<T*>(o), lse, s);
  } else if (which == 1) {
    auto kern = attn_bwd_dq_kernel<T, DP>;
    if ((err = launch_setup(kern, dq_smem<DP>(), ready[1])) != 0) return err;
    kern<<<rows, kThreads, dq_smem<DP>(), stream>>>(
        qt, kt, vt, q_pos, k_pos, gt, lse, static_cast<T*>(o), rd, s);
  } else {
    auto kern = attn_bwd_dkdv_kernel<T, DP>;
    if ((err = launch_setup(kern, dkdv_smem<DP>(), ready[2])) != 0)
      return err;
    kern<<<cols, kThreads, dkdv_smem<DP>(), stream>>>(
        qt, kt, vt, q_pos, k_pos, gt, lse, rd, static_cast<T*>(dk),
        static_cast<T*>(dv), s);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(int which, const void* q, const void* k, const void* v,
           const int* q_pos, const int* k_pos, const void* g, void* o,
           void* dk, void* dv, float* lse, float* rd, const Shape& s,
           cudaStream_t stream) {
  if (s.d <= 32)
    return launch<T, 32>(which, q, k, v, q_pos, k_pos, g, o, dk, dv, lse,
                         rd, s, stream);
  if (s.d <= 64)
    return launch<T, 64>(which, q, k, v, q_pos, k_pos, g, o, dk, dv, lse,
                         rd, s, stream);
  return launch<T, 128>(which, q, k, v, q_pos, k_pos, g, o, dk, dv, lse, rd,
                        s, stream);
}

int dispatch(int which, const void* q, const void* k, const void* v,
             const int* q_pos, const int* k_pos, const void* g, void* o,
             void* dk, void* dv, float* lse, float* rd, const Shape& s,
             int dtype, void* stream) {
  if (!valid_shape(s) || (s.causal && (q_pos == nullptr || k_pos == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(which, q, k, v, q_pos, k_pos, g, o, dk, dv,
                                 lse, rd, s, st);
  if (dtype == 0)
    return by_dim<float>(which, q, k, v, q_pos, k_pos, g, o, dk, dv, lse, rd,
                         s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K4a.  q (b, tq, h, d), k and v (b, tk, h, d), o like q: contiguous, of
// `dtype` (0 = float32, 1 = bfloat16), 1 <= d <= 128; q_pos (tq,) and
// k_pos (tk,) int32 (read only when causal); lse (b*h, tq) float32.
// Returns cudaGetLastError().
extern "C" int tm_attention_fwd(const void* q, const void* k, const void* v,
                                const int* q_pos, const int* k_pos, void* o,
                                float* lse, int b, int tq, int tk, int h,
                                int d, float scale, int causal, int dtype,
                                void* stream) {
  const Shape s{b, tq, tk, h, d, scale, causal};
  return dispatch(0, q, k, v, q_pos, k_pos, nullptr, o, nullptr, nullptr,
                  lse, nullptr, s, dtype, stream);
}

// K4b, row pass.  g and dq like q; lse from K4a; rd (b*h, tq, 2) float32
// receives (1 / sum p, sum(dp p) / sum p) per row for the column pass.
extern "C" int tm_attention_bwd_dq(const void* q, const void* k,
                                   const void* v, const int* q_pos,
                                   const int* k_pos, const void* g,
                                   const float* lse, void* dq, float* rd,
                                   int b, int tq, int tk, int h, int d,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  const Shape s{b, tq, tk, h, d, scale, causal};
  return dispatch(1, q, k, v, q_pos, k_pos, g, dq, nullptr, nullptr,
                  const_cast<float*>(lse), rd, s, dtype, stream);
}

// K4b, column pass.  dk and dv like k; rd from the row pass.
extern "C" int tm_attention_bwd_dkdv(const void* q, const void* k,
                                     const void* v, const int* q_pos,
                                     const int* k_pos, const void* g,
                                     const float* lse, const float* rd,
                                     void* dk, void* dv, int b, int tq,
                                     int tk, int h, int d, float scale,
                                     int causal, int dtype, void* stream) {
  const Shape s{b, tq, tk, h, d, scale, causal};
  return dispatch(2, q, k, v, q_pos, k_pos, g, nullptr, dk, dv,
                  const_cast<float*>(lse), const_cast<float*>(rd), s, dtype,
                  stream);
}
