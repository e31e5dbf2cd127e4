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
// operations per byte, well above the card's balance point.
//
// Two routes, chosen by dtype alone (`dispatch`):
//
// bfloat16 (namespace tc; the dtype the models train in): tensor cores.
// * Products: mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32, operands from
//   shared memory by ldmatrix.  Chosen over wgmma as the simpler route:
//   a warp owns 16 rows, and the f32 score fragment of one product is
//   repacked in registers as the A fragment of the next (p v, ds k,
//   p^T g, ds^T q), so p and ds never touch shared memory.  Four warps
//   per block, 64-row tiles against 64-key tiles.
// * The reference's arithmetic: q k^T, g v^T and round_bf16(p) v take
//   bf16 operands, whose products are exact in f32; only the order of
//   summation changes.  The backward's f32 p and ds (dv = p^T g,
//   dq = ds k scale, dk = ds^T q scale) go in as a bf16 pair hi = bf16(x),
//   lo = bf16(x - hi) (x - hi is exact in f32): two products carrying
//   about 16 bits of x, never a single bf16 rounding.
// * Copies: 16-byte cp.async chunks of bf16 rows into a two-stage ring
//   (K/V and their positions in K4a and in both sweeps of the row pass;
//   Q/G with their lse, rd and positions in the column pass), so the next
//   tile's copy overlaps this tile's products.  bf16 staging halves a
//   tile against f32, and a block's own tiles borrow the second stage
//   once their fragments are in registers; the room goes to resident
//   blocks, not stages: at D = 64 a block takes 37.8 KB in K4a and in the
//   row pass and 39.3 KB in the column pass, so 4, 4 and 3 blocks fit an
//   SM, as many as their registers (128, 126 and 168 a thread, no spills)
//   allow.  Tensors that are not 16-byte aligned, or D not a multiple of
//   8, load by plain loads into the same ring.
// * Exact causal tile skipping.  A block reads the positions (any int32
//   order, read from L2, no host work) and skips a (query tile Q, key tile
//   K) pair only when both hold: min k_pos over K > max q_pos over Q (every
//   key of K is masked for every row of Q), and min q_pos over Q >= min
//   k_pos over all keys (every row of Q sees some key).  Then each row's
//   running max (K4a) or lse (K4b) is a real score, so every p of the pair
//   is exp(-1e30 - real) = 0 in f32 and skipping it changes no bit.  A
//   tile holding a row that sees no key visits every key tile (that row
//   averages every v); the column pass applies the rule from the key
//   tile's side.  A whole tile whose keys are all visible to all its rows
//   skips the per-element compare.  At T = 1024 the rule leaves 136 of
//   256 tile pairs per (b, h) of an arange mask (counted by its plain
//   mirror, ops/attention.skipped_tiles).  Blocks with the most tiles to
//   visit start first.  Each block plans its sweep up front (the classes
//   of up to 1024 tiles at a time, in shared memory, split over the
//   warps); classing each tile only when the sweep reaches it puts a
//   position load and two warp reductions before every tile's copies, and
//   measured 4-7% slower, with a spill in K4a at D = 64.
// * The row pass keeps two sweeps: the first sums p and dp p per row, the
//   second forms ds = p r (dp - delta) and dq.  Folding them into one
//   sweep, dq = r (sum p dp k - delta sum p k), costs the same six
//   products per pair but subtracts two sums that can be far larger than
//   ds; the two sweeps keep ds as the reference forms it.
// * D is padded with zeros to 32, 64 or 128 in shared memory.
//
// float32: the first version's kernels (below, templated on T, now
// instantiated for float alone), unchanged: f32 FMA on the CUDA cores, a
// 4x4 micro tile per thread, every key tile visited.  The tensor cores
// have no exact f32 route (TF32 keeps 10 bits of mantissa), and the f32
// path is the reference that the tests hold to 2e-5.
//
// The f32 kernels, in detail:
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
//   for dv = sum (p r)^T g and dk = sum ds^T q scale.  No atomics in either
//   route: every output element has one owner, so the result is
//   deterministic.
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
#include <limits.h>
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
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
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

// ---------------------------------------------------------------------------
// The bfloat16 route: tensor cores (mma.sync m16n8k16, bf16 in, f32 out),
// cp.async into a two-stage ring of bf16 tiles, exact causal tile skipping.
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;              // one warp per 16 rows of a 64-row tile
constexpr int kThreadsTc = 32 * kWarps;
constexpr int kChunk = 1024;           // other-side tiles planned at a time
enum : uint8_t { kSkip = 0, kMasked = 1, kFull = 2 };

template <int DP>
struct Geo {
  static constexpr int LD = DP + 8;      // bf16 row pitch: 16 bytes of pad
  static constexpr int TILE = kTile * LD;
  static constexpr int CH = DP / 8;      // 16-byte chunks of a row
};

// What a block plans its sweeps with, kept in shared memory (in registers
// it would be held through every sweep): block_min's scratch, the range of
// the block's own positions, the least k_pos of all keys, and the own
// tile's positions (causal only).
struct Info {
  int red[kWarps];
  int own_mn, own_mx, kmin_all;
  int pos[kTile];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16, 8 or 4 bytes from global to shared memory; the bytes past `bytes`
// are zero-filled (bytes = 0: a zero chunk, nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) rounded to bf16 (x0 in the low half, the lower column)
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  return bits(__floats2bfloat162_rn(x0, x1));
}
// (x0, x1) as a bf16 pair hi + lo: hi = bf16(x), lo = bf16(x - hi); x - hi
// is exact in f32, so hi + lo keeps about 16 bits of x
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [row0, row0 + 64) of head (bi, hi) of a contiguous (B, t, H, D) bf16
// tensor into the tile [64][LD], asynchronously when `vec` (D % 8 == 0 and
// 16-byte aligned tensors), else by plain loads; zero past t and past D.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* tile,
                                          const bf16* __restrict__ src,
                                          int bi, int hi, int row0, int t,
                                          const Shape& s, bool vec) {
  constexpr int LD = Geo<DP>::LD, CH = Geo<DP>::CH;
  const size_t stride = (size_t)s.h * s.d;
  const bf16* base = src + ((size_t)bi * t * s.h + hi) * s.d;
  for (int e = threadIdx.x; e < kTile * CH; e += kThreadsTc) {
    const int r = e / CH, c = e % CH, row = row0 + r;
    bf16* dst = tile + r * LD + c * 8;
    if (vec) {
      const bool in = row < t && c * 8 < s.d;
      cp_async16(dst, in ? base + (size_t)row * stride + c * 8 : src,
                 in ? 16 : 0);
    } else {
      union {
        uint4 v;
        uint16_t e[8];
      } u;
      const uint16_t* b16 = reinterpret_cast<const uint16_t*>(base);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int dd = c * 8 + i;
        u.e[i] = (row < t && dd < s.d) ? b16[(size_t)row * stride + dd] : 0;
      }
      *reinterpret_cast<uint4*>(dst) = u.v;
    }
  }
}

// The staged tile's rows [row0, row0 + 64) (those below t) into head
// (bi, hi) of a contiguous (B, t, H, D) bf16 tensor.
template <int DP>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst,
                                           const bf16* tile, int bi, int hi,
                                           int row0, int t, const Shape& s,
                                           bool vec) {
  constexpr int LD = Geo<DP>::LD, CH = Geo<DP>::CH;
  const size_t stride = (size_t)s.h * s.d;
  bf16* base = dst + ((size_t)bi * t * s.h + hi) * s.d;
  for (int e = threadIdx.x; e < kTile * CH; e += kThreadsTc) {
    const int r = e / CH, c = e % CH, row = row0 + r;
    if (row >= t || c * 8 >= s.d) continue;
    const bf16* from = tile + r * LD + c * 8;
    bf16* to = base + (size_t)row * stride + c * 8;
    if (vec) {
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
      for (int i = 0; i < 8 && c * 8 + i < s.d; ++i) to[i] = from[i];
    }
  }
}

// The min of pos[0, n) over the block (every thread returns it).
__device__ int block_min(const int* __restrict__ pos, int n, int* red) {
  int m = INT_MAX;
  for (int i = threadIdx.x; i < n; i += kThreadsTc) m = min(m, __ldg(pos + i));
  m = __reduce_min_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  int r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = min(r, red[w]);
  return r;
}

// The min and max of pos over [start, start + 64) within [0, n), per warp.
__device__ __forceinline__ void tile_range(const int* __restrict__ pos,
                                           int start, int n, int& mn,
                                           int& mx) {
  const int lane = threadIdx.x & 31;
  int a = INT_MAX, b = INT_MIN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = start + lane + 32 * h;
    if (i < n) {
      const int p = __ldg(pos + i);
      a = min(a, p);
      b = max(b, p);
    }
  }
  mn = __reduce_min_sync(0xffffffffu, a);
  mx = __reduce_max_sync(0xffffffffu, b);
}

// Flags of the other side's tiles [j0, j0 + n) (64 positions each, of the
// `len` in pos) against the block's own tile, whose positions span
// [info->own_mn, info->own_mx].  keys_other: the other side is the keys
// (K4a, row pass) or the queries (column pass).  kSkip, the exact rule:
// every key of the pair is masked for every query (k_min > q_max) and
// every query of the pair sees some key (q_min >= kmin_all), so every p
// of the pair is exp(-1e30 - real) = 0.  kFull: no key is masked and both
// tiles are whole.
__device__ void plan(uint8_t* flags, const int* __restrict__ pos, int len,
                     int j0, int n, const Info* info, bool own_ragged,
                     bool causal, bool keys_other) {
  for (int jj = threadIdx.x >> 5; jj < n; jj += kWarps) {
    const int start = (j0 + jj) * kTile;
    const bool ragged = own_ragged || start + kTile > len;
    uint8_t f = ragged ? kMasked : kFull;
    if (causal) {
      int mn, mx;
      tile_range(pos, start, len, mn, mx);
      const int q_mn = keys_other ? info->own_mn : mn;
      const int q_mx = keys_other ? info->own_mx : mx;
      const int k_mn = keys_other ? mn : info->own_mn;
      const int k_mx = keys_other ? mx : info->own_mx;
      if (k_mn > q_mx && q_mn >= info->kmin_all)
        f = kSkip;
      else if (ragged || k_mx > q_mn)
        f = kMasked;
    }
    if ((threadIdx.x & 31) == 0) flags[jj] = f;
  }
}

__device__ __forceinline__ int next_tile(const uint8_t* flags, int n, int j) {
  for (++j; j < n && flags[j] == kSkip; ++j) {
  }
  return j;
}

// Visits the other side's tiles that the plan does not skip, in order,
// through a two-stage ring: issue(tile, stage) starts the copies of a tile
// (cp.async), body(tile, stage, full) computes on a tile that has arrived
// while the next one's copies are in flight.  `planned` keeps one plan for
// a second sweep over the same tiles.
template <typename Issue, typename Body>
__device__ __forceinline__ void sweep(uint8_t* flags, bool& planned,
                                      const int* __restrict__ pos, int len,
                                      const Info* info, bool own_ragged,
                                      bool causal, bool keys_other,
                                      Issue issue, Body body) {
  const int nt = (len + kTile - 1) / kTile;
  for (int j0 = 0; j0 < nt; j0 += kChunk) {
    const int n = min(kChunk, nt - j0);
    __syncthreads();  // the last sweep's reads of flags and stages are done
    if (!planned || nt > kChunk) {
      plan(flags, pos, len, j0, n, info, own_ragged, causal, keys_other);
      __syncthreads();
    }
    planned = true;
    int j = next_tile(flags, n, -1), st = 0;
    if (j < n) issue(j0 + j, 0);
    cp_commit();
    while (j < n) {
      cp_wait_all();
      __syncthreads();  // tile j has landed; stage st ^ 1 is free
      const int jn = next_tile(flags, n, j);
      if (jn < n) issue(j0 + jn, st ^ 1);
      cp_commit();
      body(j0 + j, st, flags[j] == kFull);
      st ^= 1;
      j = jn;
    }
  }
}

// A fragments of rows [r0, r0 + 16) x [0, DP) of a tile.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[DP / 16][4],
                                       const bf16* tile, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldsm_x4(a[kk],
            tile + (r0 + (lane & 15)) * Geo<DP>::LD + kk * 16 +
                (lane >> 4) * 8);
}

// c0, c1 (16 x 8 each) += a (16 x DP) * tile[n0 .. n0 + 16)^T: the product
// with 16 rows of a [row][d] tile (q k^T, g v^T, k q^T, v g^T).
template <int DP>
__device__ __forceinline__ void mma_abt(float (&c0)[4], float (&c1)[4],
                                        const uint32_t (&a)[DP / 16][4],
                                        const bf16* tile, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * Geo<DP>::LD +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, p + kk * 16);
    mma16816(c0, a[kk], b[0], b[1]);
    mma16816(c1, a[kk], b[2], b[3]);
  }
}

// acc (16 x DP) += a (16 x 16) * tile[k0 .. k0 + 16) (p v); with the pair
// a_lo, acc += a * t + a_lo * t (ds k, p^T g, ds^T q).
template <int DP, bool kPair>
__device__ __forceinline__ void mma_ab(float (&acc)[DP / 8][4],
                                       const uint32_t (&a)[4],
                                       const uint32_t (&a_lo)[4],
                                       const bf16* tile, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             Geo<DP>::LD +
                  (lane >> 4) * 8;
#pragma unroll
  for (int dn = 0; dn < DP / 16; ++dn) {
    uint32_t b[4];
    ldsm_x4_t(b, p + dn * 16);
    mma16816(acc[2 * dn], a, b[0], b[1]);
    if (kPair) mma16816(acc[2 * dn], a_lo, b[0], b[1]);
    mma16816(acc[2 * dn + 1], a, b[2], b[3]);
    if (kPair) mma16816(acc[2 * dn + 1], a_lo, b[2], b[3]);
  }
}

// A thread's accumulator rows (g and g + 8 of the warp's 16) into the
// staging tile as bf16.
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* tile, int r0,
                                           const float (&acc)[DP / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(tile + (r0 + g) * Geo<DP>::LD + col) =
        __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r0 + g + 8) * Geo<DP>::LD +
                                       col) =
        __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// s = scale * acc, masked: -1e30 where q_pos < k_pos (causal), -inf for a
// key past tk.  A whole, fully visible tile (full) skips the compares.
__device__ __forceinline__ float score(float acc, float scale, bool full,
                                      bool causal, int qp, int kp,
                                      bool key_valid) {
  float x = acc * scale;
  if (!full) {
    if (causal && !(qp >= kp)) x = kMaskNeg;
    if (!key_valid) x = -INFINITY;
  }
  return x;
}

// The prologue every kernel shares: the own positions' copy (joins the
// own tiles' cp.async group) and, when causal, the plan's ranges.
__device__ __forceinline__ void own_positions(Info* info,
                                              const int* __restrict__ pos,
                                              int start, int len) {
  if (threadIdx.x < kTile) {
    const int i = start + threadIdx.x;
    cp_async4(info->pos + threadIdx.x, i < len ? pos + i : pos,
              i < len ? 4 : 0);
  }
}
__device__ __forceinline__ void own_ranges(Info* info,
                                           const int* __restrict__ pos,
                                           int start, int len,
                                           const int* __restrict__ k_pos,
                                           int tk) {
  const int kmin_all = block_min(k_pos, tk, info->red);
  int mn, mx;
  tile_range(pos, start, len, mn, mx);
  if (threadIdx.x == 0) {
    info->own_mn = mn;
    info->own_mx = mx;
    info->kmin_all = kmin_all;
  }
}

template <int DP>
constexpr size_t fwd_smem() {
  return 4 * (size_t)Geo<DP>::TILE * sizeof(bf16) + 2 * kTile * sizeof(int) +
         kChunk + sizeof(Info);
}
template <int DP>
constexpr size_t dq_smem() {
  return 4 * (size_t)Geo<DP>::TILE * sizeof(bf16) + 2 * kTile * sizeof(int) +
         kChunk + sizeof(Info);
}
template <int DP>
constexpr size_t dkdv_smem() {
  return 4 * (size_t)Geo<DP>::TILE * sizeof(bf16) +
         2 * 4 * kTile * sizeof(int) + kChunk + sizeof(Info);
}

// K4a, bf16.  Grid (B*H, ceil(Tq / 64)); the last query tile first (it has
// the most keys to visit under an arange mask).
template <int DP>
__global__ void __launch_bounds__(kThreadsTc, DP <= 64 ? 4 : 1)
    attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ q_pos,
               const int* __restrict__ k_pos, bf16* __restrict__ o,
               float* __restrict__ lse, Shape s, int vec) {
  using G = Geo<DP>;
  extern __shared__ uint4 smem_tc[];
  // [stage][k, v]; the query tile borrows stage 1's k (its fragments go
  // to registers before the sweep) and stages the output at the end
  bf16* kvs = reinterpret_cast<bf16*>(smem_tc);
  bf16* qs = kvs + 2 * G::TILE;
  int* kps = reinterpret_cast<int*>(kvs + 4 * G::TILE);  // [stage][64]
  uint8_t* flags = reinterpret_cast<uint8_t*>(kps + 2 * kTile);
  Info* info = reinterpret_cast<Info*>(flags + kChunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const bool causal = s.causal != 0;
  load_tile<DP>(qs, q, bi, hi, row0, s.tq, s, vec);
  if (causal) own_positions(info, q_pos, row0, s.tq);
  cp_commit();
  if (causal) own_ranges(info, q_pos, row0, s.tq, k_pos, s.tk);
  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
  const int* qp = info->pos + warp * 16 + g;  // rows g and g + 8
  cp_wait_all();
  __syncthreads();
  uint32_t qf[DP / 16][4];
  load_a<DP>(qf, qs, warp * 16);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  auto issue = [&](int jt, int stg) {
    bf16* ks = kvs + stg * 2 * G::TILE;
    load_tile<DP>(ks, k, bi, hi, jt * kTile, s.tk, s, vec);
    load_tile<DP>(ks + G::TILE, v, bi, hi, jt * kTile, s.tk, s, vec);
    if (causal && threadIdx.x < kTile) {
      const int c = jt * kTile + threadIdx.x;
      cp_async4(kps + stg * kTile + threadIdx.x, c < s.tk ? k_pos + c : k_pos,
                c < s.tk ? 4 : 0);
    }
  };
  auto body = [&](int jt, int stg, bool full) {
    const bf16* ks = kvs + stg * 2 * G::TILE;
    const bf16* vs = ks + G::TILE;
    const int* kp = kps + stg * kTile;
    const int c0 = jt * kTile;
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np)
      mma_abt<DP>(sc[2 * np], sc[2 * np + 1], qf, ks, np * 16);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = n * 8 + 2 * t4 + (e & 1);
        sc[n][e] = score(sc[n][e], s.scale, full, causal,
                         causal ? qp[(e >> 1) * 8] : 0, causal ? kp[kc] : 0,
                         c0 + kc < s.tk);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = __expf(m[i] - m_new);  // 0 on the first tile
      m[i] = m_new;
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = __expf(sc[n][0] - m[0]), p1 = __expf(sc[n][1] - m[0]);
      const float p2 = __expf(sc[n][2] - m[1]), p3 = __expf(sc[n][3] - m[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack(p0, p1);  // p rounded to bf16
      pa[n >> 1][(n & 1) * 2 + 1] = pack(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ab<DP, false>(acc, pa[kk], pa[kk], vs, kk * 16);
  };
  bool planned = false;
  sweep(flags, planned, k_pos, s.tk, info, false, causal, true, issue,
        body);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    acc[n][0] /= l[0];
    acc[n][1] /= l[0];
    acc[n][2] /= l[1];
    acc[n][3] /= l[1];
  }
  __syncthreads();
  stage_rows<DP>(qs, warp * 16, acc);
  if (t4 == 0) {
    if (r_lo < s.tq) lse[(size_t)bh * s.tq + r_lo] = m[0] + logf(l[0]);
    if (r_hi < s.tq) lse[(size_t)bh * s.tq + r_hi] = m[1] + logf(l[1]);
  }
  __syncthreads();
  store_tile<DP>(o, qs, bi, hi, row0, s.tq, s, vec);
}

// K4b row pass, bf16.  Grid (B*H, ceil(Tq / 64)), the last query tile
// first.  Sweep 1 sums p and dp p per row; sweep 2 forms ds and dq.
template <int DP>
__global__ void __launch_bounds__(kThreadsTc, DP <= 64 ? 4 : 1)
    attn_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ q_pos,
              const int* __restrict__ k_pos, const bf16* __restrict__ g,
              const float* __restrict__ lse, bf16* __restrict__ dq,
              float* __restrict__ rd, Shape s, int vec) {
  using G = Geo<DP>;
  extern __shared__ uint4 smem_tc[];
  // [stage][k, v]; q and g borrow stage 1 (as in K4a)
  bf16* kvs = reinterpret_cast<bf16*>(smem_tc);
  bf16* qs = kvs + 2 * G::TILE;
  bf16* gs = kvs + 3 * G::TILE;
  int* kps = reinterpret_cast<int*>(kvs + 4 * G::TILE);
  uint8_t* flags = reinterpret_cast<uint8_t*>(kps + 2 * kTile);
  Info* info = reinterpret_cast<Info*>(flags + kChunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const bool causal = s.causal != 0;
  load_tile<DP>(qs, q, bi, hi, row0, s.tq, s, vec);
  load_tile<DP>(gs, g, bi, hi, row0, s.tq, s, vec);
  if (causal) own_positions(info, q_pos, row0, s.tq);
  cp_commit();
  if (causal) own_ranges(info, q_pos, row0, s.tq, k_pos, s.tk);
  const int r_lo = row0 + warp * 16 + gq, r_hi = r_lo + 8;
  const int* qp = info->pos + warp * 16 + gq;  // rows gq and gq + 8
  const float ls[2] = {r_lo < s.tq ? lse[(size_t)bh * s.tq + r_lo] : 0.f,
                       r_hi < s.tq ? lse[(size_t)bh * s.tq + r_hi] : 0.f};
  cp_wait_all();
  __syncthreads();
  uint32_t qf[DP / 16][4], gf[DP / 16][4];
  load_a<DP>(qf, qs, warp * 16);
  load_a<DP>(gf, gs, warp * 16);
  auto issue = [&](int jt, int stg) {
    bf16* ks = kvs + stg * 2 * G::TILE;
    load_tile<DP>(ks, k, bi, hi, jt * kTile, s.tk, s, vec);
    load_tile<DP>(ks + G::TILE, v, bi, hi, jt * kTile, s.tk, s, vec);
    if (causal && threadIdx.x < kTile) {
      const int c = jt * kTile + threadIdx.x;
      cp_async4(kps + stg * kTile + threadIdx.x, c < s.tk ? k_pos + c : k_pos,
                c < s.tk ? 4 : 0);
    }
  };
  // p = exp(s - lse) and dp = g v^T of the 16 keys [n0, n0 + 16) of a tile
  auto scores = [&](const bf16* ks, const bf16* vs, const int* kp, int c0,
                    int n0, bool full, float (&p)[2][4], float (&dp)[2][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[h][e] = dp[h][e] = 0.f;
    mma_abt<DP>(p[0], p[1], qf, ks, n0);
    mma_abt<DP>(dp[0], dp[1], gf, vs, n0);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = n0 + h * 8 + 2 * t4 + (e & 1);
        const float x = score(p[h][e], s.scale, full, causal,
                              causal ? qp[(e >> 1) * 8] : 0,
                              causal ? kp[kc] : 0, c0 + kc < s.tk);
        p[h][e] = __expf(x - ls[e >> 1]);  // 0 past tk (-inf)
      }
  };
  float sp[2] = {0.f, 0.f}, sdp[2] = {0.f, 0.f};
  auto body1 = [&](int jt, int stg, bool full) {
    const bf16* ks = kvs + stg * 2 * G::TILE;
    const int* kp = kps + stg * kTile;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      float p[2][4], dp[2][4];
      scores(ks, ks + G::TILE, kp, jt * kTile, np * 16, full, p, dp);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sp[e >> 1] += p[h][e];
          sdp[e >> 1] += dp[h][e] * p[h][e];
        }
    }
  };
  bool planned = false;
  sweep(flags, planned, k_pos, s.tk, info, false, causal, true, issue,
        body1);
  float rr[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rr[i] = 1.f / quad_sum(sp[i]);
    delta[i] = quad_sum(sdp[i]) * rr[i];
  }
  if (t4 == 0) {
    if (r_lo < s.tq) {
      rd[((size_t)bh * s.tq + r_lo) * 2] = rr[0];
      rd[((size_t)bh * s.tq + r_lo) * 2 + 1] = delta[0];
    }
    if (r_hi < s.tq) {
      rd[((size_t)bh * s.tq + r_hi) * 2] = rr[1];
      rd[((size_t)bh * s.tq + r_hi) * 2 + 1] = delta[1];
    }
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  auto body2 = [&](int jt, int stg, bool full) {
    const bf16* ks = kvs + stg * 2 * G::TILE;
    const int* kp = kps + stg * kTile;
#pragma unroll 1  // unrolled, the slices' overlap spills at 128 registers
    for (int np = 0; np < 4; ++np) {
      float p[2][4], dp[2][4];
      scores(ks, ks + G::TILE, kp, jt * kTile, np * 16, full, p, dp);
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = p[h][e] * rr[e >> 1] * (dp[h][e] - delta[e >> 1]);
        split(ds[0], ds[1], a_hi[2 * h], a_lo[2 * h]);
        split(ds[2], ds[3], a_hi[2 * h + 1], a_lo[2 * h + 1]);
      }
      mma_ab<DP, true>(acc, a_hi, a_lo, ks, np * 16);
    }
  };
  sweep(flags, planned, k_pos, s.tk, info, false, causal, true, issue,
        body2);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= s.scale;
  __syncthreads();
  stage_rows<DP>(qs, warp * 16, acc);
  __syncthreads();
  store_tile<DP>(dq, qs, bi, hi, row0, s.tq, s, vec);
}

// K4b column pass, bf16.  Grid (B*H, ceil(Tk / 64)), the first key tile
// first.  A warp owns 16 keys; the visited query tiles stream through the
// ring with their lse, rd and positions.
template <int DP>
__global__ void __launch_bounds__(kThreadsTc, DP <= 64 ? 3 : 1)
    attn_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ q_pos,
                const int* __restrict__ k_pos, const bf16* __restrict__ g,
                const float* __restrict__ lse, const float* __restrict__ rd,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Shape s,
                int vec) {
  using G = Geo<DP>;
  extern __shared__ uint4 smem_tc[];
  // [stage][q, g]; the block's own k and v borrow stage 1 (as in K4a)
  bf16* qgs = reinterpret_cast<bf16*>(smem_tc);
  bf16* ks = qgs + 2 * G::TILE;
  bf16* vs = qgs + 3 * G::TILE;
  // [stage][lse 64 | rd 128 | q_pos 64]
  float* rows = reinterpret_cast<float*>(qgs + 4 * G::TILE);
  uint8_t* flags = reinterpret_cast<uint8_t*>(rows + 2 * 4 * kTile);
  Info* info = reinterpret_cast<Info*>(flags + kChunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const int c0 = blockIdx.y * kTile;
  const bool causal = s.causal != 0;
  load_tile<DP>(ks, k, bi, hi, c0, s.tk, s, vec);
  load_tile<DP>(vs, v, bi, hi, c0, s.tk, s, vec);
  if (causal) own_positions(info, k_pos, c0, s.tk);
  cp_commit();
  if (causal) own_ranges(info, k_pos, c0, s.tk, k_pos, s.tk);
  const int c_lo = c0 + warp * 16 + gq;  // the thread's keys c_lo, c_lo + 8
  const int* kpo = info->pos + warp * 16 + gq;
  cp_wait_all();
  __syncthreads();
  uint32_t kf[DP / 16][4], vf[DP / 16][4];
  load_a<DP>(kf, ks, warp * 16);
  load_a<DP>(vf, vs, warp * 16);
  const float* lse_bh = lse + (size_t)bh * s.tq;
  const float* rd_bh = rd + (size_t)bh * s.tq * 2;
  auto issue = [&](int it, int stg) {
    bf16* qt = qgs + stg * 2 * G::TILE;
    const int r0 = it * kTile;
    load_tile<DP>(qt, q, bi, hi, r0, s.tq, s, vec);
    load_tile<DP>(qt + G::TILE, g, bi, hi, r0, s.tq, s, vec);
    float* rs = rows + stg * 4 * kTile;
    if (threadIdx.x < kTile) {
      const int r = r0 + threadIdx.x;
      const bool in = r < s.tq;
      cp_async4(rs + threadIdx.x, in ? lse_bh + r : lse, in ? 4 : 0);
      cp_async8(rs + kTile + 2 * threadIdx.x, in ? rd_bh + 2 * r : rd,
                in ? 8 : 0);
      if (causal)
        cp_async4(rs + 3 * kTile + threadIdx.x, in ? q_pos + r : q_pos,
                  in ? 4 : 0);
    }
  };
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  auto body = [&](int it, int stg, bool full) {
    const bf16* qt = qgs + stg * 2 * G::TILE;
    const bf16* gt = qt + G::TILE;
    const float* rs = rows + stg * 4 * kTile;
    const int* qps = reinterpret_cast<const int*>(rs + 3 * kTile);
    const int r0 = it * kTile;
#pragma unroll 1  // unrolled, the slices' overlap spills at 168 registers
    for (int np = 0; np < 4; ++np) {
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[h][e] = dpt[h][e] = 0.f;
      mma_abt<DP>(st[0], st[1], kf, qt, np * 16);
      mma_abt<DP>(dpt[0], dpt[1], vf, gt, np * 16);
      uint32_t p_hi[4], p_lo[4], d_hi[4], d_lo[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = np * 16 + h * 8 + 2 * t4 + (e & 1);
          const bool kvalid = c_lo + (e >> 1) * 8 < s.tk;
          const float x = score(st[h][e], s.scale, full, causal,
                                causal ? qps[qc] : 0,
                                causal ? kpo[(e >> 1) * 8] : 0, true);
          p[e] = __expf(x - rs[qc]) * rs[kTile + 2 * qc];
          if (!full && !(r0 + qc < s.tq && kvalid)) p[e] = 0.f;
          ds[e] = p[e] * (dpt[h][e] - rs[kTile + 2 * qc + 1]);
        }
        split(p[0], p[1], p_hi[2 * h], p_lo[2 * h]);
        split(p[2], p[3], p_hi[2 * h + 1], p_lo[2 * h + 1]);
        split(ds[0], ds[1], d_hi[2 * h], d_lo[2 * h]);
        split(ds[2], ds[3], d_hi[2 * h + 1], d_lo[2 * h + 1]);
      }
      mma_ab<DP, true>(dva, p_hi, p_lo, gt, np * 16);
      mma_ab<DP, true>(dka, d_hi, d_lo, qt, np * 16);
    }
  };
  bool planned = false;
  sweep(flags, planned, q_pos, s.tq, info, c0 + kTile > s.tk, causal,
        false, issue, body);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] *= s.scale;
  __syncthreads();
  stage_rows<DP>(ks, warp * 16, dka);
  stage_rows<DP>(vs, warp * 16, dva);
  __syncthreads();
  store_tile<DP>(dk, ks, bi, hi, c0, s.tk, s, vec);
  store_tile<DP>(dv, vs, bi, hi, c0, s.tk, s, vec);
}

// which = 0: K4a, 1: K4b row pass, 2: K4b column pass
template <int DP>
int launch(int which, const void* q, const void* k, const void* v,
           const int* q_pos, const int* k_pos, const void* g, void* o,
           void* dk, void* dv, float* lse, float* rd, const Shape& s,
           int vec, cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(g);
  const unsigned bh = (unsigned)(s.b * s.h);
  const dim3 rows(bh, (unsigned)((s.tq + kTile - 1) / kTile));
  const dim3 cols(bh, (unsigned)((s.tk + kTile - 1) / kTile));
  static bool ready[3] = {false, false, false};
  int err;
  if (which == 0) {
    auto kern = attn_fwd_tc_kernel<DP>;
    if ((err = launch_setup(kern, fwd_smem<DP>(), ready[0])) != 0) return err;
    kern<<<rows, kThreadsTc, fwd_smem<DP>(), stream>>>(
        qt, kt, vt, q_pos, k_pos, static_cast<bf16*>(o), lse, s, vec);
  } else if (which == 1) {
    auto kern = attn_bwd_dq_tc_kernel<DP>;
    if ((err = launch_setup(kern, dq_smem<DP>(), ready[1])) != 0) return err;
    kern<<<rows, kThreadsTc, dq_smem<DP>(), stream>>>(
        qt, kt, vt, q_pos, k_pos, gt, lse, static_cast<bf16*>(o), rd, s, vec);
  } else {
    auto kern = attn_bwd_dkdv_tc_kernel<DP>;
    if ((err = launch_setup(kern, dkdv_smem<DP>(), ready[2])) != 0)
      return err;
    kern<<<cols, kThreadsTc, dkdv_smem<DP>(), stream>>>(
        qt, kt, vt, q_pos, k_pos, gt, lse, rd, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), s, vec);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

int by_dim(int which, const void* q, const void* k, const void* v,
           const int* q_pos, const int* k_pos, const void* g, void* o,
           void* dk, void* dv, float* lse, float* rd, const Shape& s,
           cudaStream_t stream) {
  // 16-byte copies need D % 8 == 0 and 16-byte aligned tensors
  const void* ptrs[] = {q, k, v, g, o, dk, dv};
  bool vec = s.d % 8 == 0;
  for (const void* p : ptrs)
    if (p != nullptr) vec = vec && aligned16(p);
  const int iv = vec ? 1 : 0;
  if (s.d <= 32)
    return launch<32>(which, q, k, v, q_pos, k_pos, g, o, dk, dv, lse, rd, s,
                      iv, stream);
  if (s.d <= 64)
    return launch<64>(which, q, k, v, q_pos, k_pos, g, o, dk, dv, lse, rd, s,
                      iv, stream);
  return launch<128>(which, q, k, v, q_pos, k_pos, g, o, dk, dv, lse, rd, s,
                     iv, stream);
}

}  // namespace tc

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
  if (dtype == 1)  // the tensor-core route
    return tc::by_dim(which, q, k, v, q_pos, k_pos, g, o, dk, dv, lse, rd, s,
                      st);
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
