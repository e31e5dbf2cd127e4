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

#include <cooperative_groups.h>
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
// The per-channel sums are what a TPU grid does not have to think about:
// it runs in order and carries them from step to step, while here the
// row blocks run side by side and their partials have to meet.
//
// What the design does about it: one launch, with the reduction across
// blocks inside it, in an order fixed by (rows, C, dtype) alone and with
// no floating-point atomics.
//  - Geometry (`bwd_geometry`; ops/fused_bn.py `bwd_geometry_plain`
//    mirrors it): a block of 256 threads is `lanes` 16-byte channel
//    vectors by `groups` rows, `chunks` blocks along C.  A row tile is
//    groups * 4 rows: each thread issues the loads of its 4 rows (x, g
//    and, for K1d under relu, r: up to 12 x 16 B in flight) before the
//    arithmetic that uses them.  Blocks walk the tiles grid-stride.  The
//    grid is sized from the card, as many clusters as it holds at once
//    (one wave: a cluster that waits for a second one doubles the time),
//    so a small C and a large one both fill it, and it takes at most one
//    block a tile (rounded up to whole clusters), so a small shape
//    spreads over as many SMs as it has tiles.  With up to 8 tiles a
//    chunk is one cluster of the next power of two blocks (a block past
//    the last tile adds zeros); with more, clusters are of 8.
//  - Block: each thread keeps f32 partials of g'x and g' over its rows in
//    row order; the block adds its row groups pairwise in shared memory
//    (a fixed tree: n entries -> ceil(n/2), entry i += entry i + ceil(n/2)),
//    as float4s laid out so that a warp takes no bank twice (scalar
//    partials there cost 8-way conflicts, about 2.5 us a call).
//  - Cluster: the blocks of consecutive row ranges form a thread-block
//    cluster of 8 (fewer only as the one cluster of a chunk).  Block p
//    adds slice p of the chunk's (ds, db) row over the members' shared
//    memory (distributed shared memory), in rank order, and writes it to
//    an f32 scratch of (chunks, clusters, 2, lanes * N): one row a
//    cluster, where the two-pass version wrote one a block and read them
//    back in a second kernel.  With one cluster a chunk that row is
//    ds/db: no scratch, no tickets.
//  - Across clusters, a slice at a time: the rank-p block of each
//    cluster draws a ticket of (chunk, p) (an int32, which the entry
//    point zeroes per call on the caller's stream; acquire-release at GPU
//    scope).  The block that draws the last one adds slice p's cluster
//    rows: `final_split` threads share each float4, thread j adding rows
//    j, j + final_split, ... in order with all its loads in flight, then
//    the parts pairwise.  Which block comes last varies; the order it
//    adds in does not.  A block waits for its cluster's others to finish
//    reading its shared memory only before it exits (a split cluster
//    barrier), so that wait hides behind the tickets.
// So the same inputs give the same bits from launch to launch and on any
// stream, two calls on two streams share nothing, and the call is
// capturable in a CUDA graph (a memset node, then the kernel).  The mask
// uses the forward's arithmetic (__fmul_rn/__fadd_rn, no FMA), so a z
// within an ulp of 0 gets the same mask in both directions.
//
// Loads go through registers.  A cp.async ring of two stages in shared
// memory (96 KB a block, the next tile's rows in flight while this one's
// are used) was 5-10% slower at ResNet-50's shapes on an H100 SXM
// (tools/fused_bn_kernel_probe.py); so was making room for 3 blocks an
// SM (registers capped at 80 spill), and cache hints on the loads and
// stores moved nothing.

constexpr int kBwdThreads = 256;
// rows a thread loads before it computes any of them
constexpr int kBwdUnroll = 4;
// blocks an SM holds (__launch_bounds__), blocks a cluster at most (the
// portable size), and the clusters of 8 such blocks an H100 SXM holds at
// once (cudaOccupancyMaxActiveClusters: 30, not 132 * 2 / 8, since a
// cluster stays inside one GPC)
constexpr int kBwdBlocksPerSm = 2;
constexpr int kBwdMaxCluster = 8;
constexpr int kBwdMaxClusters = 30;
// cluster rows a thread of the last cluster loads, all at once, and
// threads at most that share a float4 of its sum.  With more than one
// cluster a chunk, clusters are of 8, so a block's slice is at most
// 1024 / 8 float4s and at least 2 threads share each: 2 x 16 loads cover
// the clusters (`bwd_geometry_ok` holds every geometry to that).  (A
// loop over batches of loads spills 4 bytes.)
constexpr int kBwdFinalLoads = 16;
constexpr int kBwdFinalSplit = 16;
static_assert(2 * kBwdFinalLoads >= kBwdMaxClusters,
              "the last cluster's threads load every cluster row at once");

// Per-call geometry, a function of (rows, C, N) only: lanes = channel
// vectors a block, groups = rows a block takes at a time, chunks = blocks
// along C, tile_rows = groups * kBwdUnroll, tiles = row tiles, cluster =
// blocks a cluster, clusters = clusters a chunk, row_blocks = blocks along
// the rows (cluster * clusters).
struct BwdGeometry {
  long long tiles;
  int lanes, groups, chunks, tile_rows, cluster, clusters, row_blocks;
  int slice, final_split;
};

// slice = float4s of a chunk's (ds, db) row that one block of a cluster
// adds, final_split = threads that share a float4 of the last cluster's
// sum (1 with one cluster a chunk)
inline BwdGeometry bwd_geometry(long long rows, int cv, int n) {
  BwdGeometry q;
  q.lanes = cv < kBwdThreads ? cv : kBwdThreads;
  q.groups = kBwdThreads / q.lanes;
  q.chunks = (cv + q.lanes - 1) / q.lanes;
  q.tile_rows = q.groups * kBwdUnroll;
  q.tiles = (rows + q.tile_rows - 1) / q.tile_rows;
  int cap = kBwdMaxClusters * kBwdMaxCluster / q.chunks / kBwdMaxCluster *
            kBwdMaxCluster;
  if (cap < kBwdMaxCluster) cap = kBwdMaxCluster;
  const long long want = q.tiles < cap ? q.tiles : cap;
  // one cluster of the next power of two >= want, up to 8
  q.cluster = 1;
  while (q.cluster < kBwdMaxCluster && q.cluster < want) q.cluster *= 2;
  q.clusters = (int)((want + q.cluster - 1) / q.cluster);
  q.row_blocks = q.cluster * q.clusters;
  const int quads = q.lanes * n / 2;
  q.slice = (quads + q.cluster - 1) / q.cluster;
  q.final_split = 1;
  while (q.clusters > 1 && q.final_split * 2 <= kBwdFinalSplit &&
         q.final_split * 2 * q.slice <= kBwdThreads)
    q.final_split *= 2;
  return q;
}

// What the last cluster's sum needs of a geometry: its threads cover
// every float4 of a block's slice, and load every cluster row at once.
inline bool bwd_geometry_ok(const BwdGeometry& q) {
  return q.clusters == 1 ||
         (q.cluster == kBwdMaxCluster &&
          q.final_split * q.slice <= kBwdThreads &&
          q.clusters <= q.final_split * kBwdFinalLoads);
}

// f32 scratch: one (2, lanes * N) row of ds/db partials a cluster and chunk
inline long long bwd_scratch_floats(const BwdGeometry& q, int n) {
  return q.clusters > 1 ? (long long)q.chunks * q.clusters * 2 * q.lanes * n
                        : 0;
}

// int32 tickets, one a chunk and cluster rank (none with one cluster a
// chunk)
inline int bwd_tickets(const BwdGeometry& q) {
  return q.clusters > 1 ? q.chunks * q.cluster : 0;
}

// the block's [2][groups][lanes * N] partials
inline size_t bwd_smem(const BwdGeometry& q, int n) {
  return 2 * (size_t)q.groups * q.lanes * n * sizeof(float);
}

// quad e of a chunk's (ds row, db row), stored where it is a channel:
// quad j * lanes + l of a row holds channels l * n + 4j .. + 3 past ch0
template <int n>
__device__ __forceinline__ void store_sums(const float4& acc, int e,
                                           int ds_quads, int lanes, int ch0,
                                           int c, float* ds, float* db) {
  const bool is_ds = e < ds_quads;
  const int el = is_ds ? e : e - ds_quads;
  const int ch = ch0 + (el % lanes) * n + 4 * (el / lanes);
  if (ch < c) reinterpret_cast<float4*>(is_ds ? ds : db)[ch / 4] = acc;
}

// a ticket: atomic add of 1 with acquire-release semantics at GPU scope
__device__ __forceinline__ int ticket(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
}

template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
    scale_bias_act_bwd_cluster_kernel(
        const uint4* __restrict__ x, const float* __restrict__ scale,
        const float* __restrict__ bias, const uint4* __restrict__ res,
        const uint4* __restrict__ g, uint4* __restrict__ dx,
        uint4* __restrict__ dres, float* __restrict__ part,
        int* __restrict__ tickets, float* __restrict__ ds,
        float* __restrict__ db, long long rows, int cv, int c,
        BwdGeometry q) {
  namespace cg = cooperative_groups;
  constexpr int N = Vec<T>::N;
  constexpr int U = kBwdUnroll;
  extern __shared__ __align__(16) float part_sh[];
  __shared__ int last_sh;
  __shared__ float4 fin_sh[kBwdThreads];
  cg::cluster_group cluster = cg::this_cluster();
  const int lanes = q.lanes, groups = q.groups, width = lanes * N;
  const int lane = threadIdx.x % lanes;
  const int grp = threadIdx.x / lanes;
  const int chunk = blockIdx.y;
  const int cvi = chunk * lanes + lane;
  float ds_acc[N], db_acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) ds_acc[k] = db_acc[k] = 0.f;

  if (grp < groups && cvi < cv) {
    float s[N], b[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s[k] = scale[cvi * N + k];
      b[k] = bias[cvi * N + k];
    }
    for (long long t = blockIdx.x; t < q.tiles; t += gridDim.x) {
      // 64-bit offsets once a tile, 32-bit ones (< tile_rows * cv) inside
      const long long row0 = t * q.tile_rows;
      const int live = rows - row0 < q.tile_rows ? (int)(rows - row0)
                                                 : q.tile_rows;
      const size_t base = (size_t)row0 * cv + cvi;
      uint4 xv[U], gv[U], rv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = u * groups + grp;
        if (r < live) {
          xv[u] = x[base + r * cv];
          gv[u] = g[base + r * cv];
          if (RES && RELU) rv[u] = res[base + r * cv];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = u * groups + grp;
        if (r < live) {
          float xf[N], gf[N], rf[N], o[N];
          Vec<T>::load(xv[u], xf);
          Vec<T>::load(gv[u], gf);
          if (RES && RELU) Vec<T>::load(rv[u], rf);
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
          dx[base + r * cv] = Vec<T>::store(o);
          if (RES) dres[base + r * cv] = Vec<T>::store(gf);
        }
      }
    }
  }

  // the block: row groups added pairwise, in a fixed tree, into group 0;
  // the partials as float4s [ds, db][groups][N / 4][lanes], so a warp's
  // accesses take no bank twice
  constexpr int NQ = N / 4;
  float4* part4 = reinterpret_cast<float4*>(part_sh);
  const int ds_quads = NQ * lanes;        // float4s of a ds (or db) row
  const int quads = 2 * ds_quads;
  const int db_base = groups * ds_quads;
  if (grp < groups) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int i = (grp * NQ + j) * lanes + lane;
      part4[i] = make_float4(ds_acc[4 * j], ds_acc[4 * j + 1],
                             ds_acc[4 * j + 2], ds_acc[4 * j + 3]);
      part4[db_base + i] = make_float4(db_acc[4 * j], db_acc[4 * j + 1],
                                       db_acc[4 * j + 2], db_acc[4 * j + 3]);
    }
  }
  __syncthreads();
  for (int n = groups; n > 1;) {
    const int half = (n + 1) / 2;
    if (grp < n - half) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int i = (grp * NQ + j) * lanes + lane;
        const int o = ((grp + half) * NQ + j) * lanes + lane;
        add4(part4[i], part4[o]);
        add4(part4[db_base + i], part4[db_base + o]);
      }
    }
    __syncthreads();
    n = half;
  }

  // the cluster: block `rank` adds its slice [e0, e1) of the row's quads
  // (ds then db) over the members in rank order
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int e0 = rank * q.slice;
  const int e1 = e0 + q.slice < quads ? e0 + q.slice : quads;
  const int ch0 = chunk * width;
  float4* rows0 = reinterpret_cast<float4*>(part) +
                  (size_t)chunk * q.clusters * quads;
  cluster.sync();
  for (int e = e0 + (int)threadIdx.x; e < e1; e += kBwdThreads) {
    const int off = e < ds_quads ? e : db_base + e - ds_quads;
    float4 w[kBwdMaxCluster];
#pragma unroll
    for (int p = 0; p < kBwdMaxCluster; ++p)
      if (p < cs) w[p] = cluster.map_shared_rank(part4, p)[off];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < kBwdMaxCluster; ++p)
      if (p < cs) add4(acc, w[p]);
    if (q.clusters == 1)      // one cluster a chunk: its row is the sum
      store_sums<N>(acc, e, ds_quads, lanes, ch0, c, ds, db);
    else
      rows0[(size_t)(blockIdx.x / cs) * quads + e] = acc;
  }
  // done with the members' shared memory: each waits for the others only
  // before it exits, so the barrier's latency hides behind what follows
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");

  if (q.clusters > 1) {
    // across clusters, a slice at a time: the rank-p blocks of all
    // clusters write slice p, and the one that draws the last ticket of
    // (chunk, p) adds the slice's cluster rows.  Its thread 0's ticket
    // releases the block's writes at GPU scope (the barrier makes them
    // its own, as CUTLASS's semaphore does) and acquires the other
    // clusters' rows for the block.
    __syncthreads();
    if (threadIdx.x == 0)
      last_sh = ticket(&tickets[chunk * q.cluster + rank]) == q.clusters - 1;
    __syncthreads();
    if (last_sh) {
      // thread (j, i) adds cluster rows j, j + J, ... of quad e0 + i in
      // order (J = final_split), all its loads in flight at once; then
      // the J partials are added pairwise, J/2 apart, J/4, ... 1
      const int split = q.final_split;
      const int i = (int)threadIdx.x % q.slice;
      const int j = (int)threadIdx.x / q.slice;
      const int e = e0 + i;
      const bool on = j < split && e < e1;
      if (on) {
        float4 w[kBwdFinalLoads];
#pragma unroll
        for (int k = 0; k < kBwdFinalLoads; ++k)
          if (j + k * split < q.clusters)
            w[k] = __ldcg(rows0 + (size_t)(j + k * split) * quads + e);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < kBwdFinalLoads; ++k)
          if (j + k * split < q.clusters) add4(acc, w[k]);
        fin_sh[j * q.slice + i] = acc;
      }
      __syncthreads();
      for (int h = split / 2; h >= 1; h /= 2) {
        if (on && j < h) add4(fin_sh[j * q.slice + i],
                              fin_sh[(j + h) * q.slice + i]);
        __syncthreads();
      }
      if (on && j == 0)
        store_sums<N>(fin_sh[i], e, ds_quads, lanes, ch0, c, ds, db);
    }
  }
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

template <typename T, bool RES, bool RELU>
cudaError_t launch_bwd(const void* x, const void* scale, const void* bias,
                       const void* res, const void* g, void* dx, void* dres,
                       void* part, void* tickets, void* ds, void* db,
                       long long rows, int c, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const int cv = c / N;
  const BwdGeometry q = bwd_geometry(rows, cv, N);
  if (bwd_tickets(q) > 0) {
    const cudaError_t err = cudaMemsetAsync(
        tickets, 0, (size_t)bwd_tickets(q) * sizeof(int), stream);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q.row_blocks, q.chunks);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = bwd_smem(q, N);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, scale_bias_act_bwd_cluster_kernel<T, RES, RELU>,
      static_cast<const uint4*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const uint4*>(res),
      static_cast<const uint4*>(g), static_cast<uint4*>(dx),
      static_cast<uint4*>(dres), static_cast<float*>(part),
      static_cast<int*>(tickets), static_cast<float*>(ds),
      static_cast<float*>(db), rows, cv, c, q);
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* scale, const void* bias,
                         const void* res, const void* g, void* dx,
                         void* dres, void* part, void* tickets, void* ds,
                         void* db, long long rows, int c, int relu,
                         cudaStream_t stream) {
  if (res != nullptr) {
    if (relu)
      return launch_bwd<T, true, true>(x, scale, bias, res, g, dx, dres,
                                       part, tickets, ds, db, rows, c,
                                       stream);
    return launch_bwd<T, true, false>(x, scale, bias, res, g, dx, dres, part,
                                      tickets, ds, db, rows, c, stream);
  }
  if (relu)
    return launch_bwd<T, false, true>(x, scale, bias, res, g, dx, dres, part,
                                      tickets, ds, db, rows, c, stream);
  return launch_bwd<T, false, false>(x, scale, bias, res, g, dx, dres, part,
                                     tickets, ds, db, rows, c, stream);
}

}  // namespace

// The geometry of the backward at (rows, c) in `dtype` (0 = float32,
// 1 = bfloat16), into out[0..12]: lanes, groups, chunks, tile_rows,
// tiles, cluster, clusters, row_blocks, scratch floats, tickets, dynamic
// shared memory bytes, slice, final_split.  Returns
// cudaErrorInvalidValue for a shape the backward does not take.
extern "C" int tm_scale_bias_act_bwd_geometry(long long rows, int c,
                                              int dtype, long long* out) {
  const int n = dtype == 1 ? 8 : dtype == 0 ? 4 : 0;
  if (n == 0 || rows <= 0 || c <= 0 || c % n)
    return (int)cudaErrorInvalidValue;
  const BwdGeometry q = bwd_geometry(rows, c / n, n);
  if (!bwd_geometry_ok(q)) return (int)cudaErrorInvalidValue;
  const long long v[13] = {q.lanes,      q.groups,   q.chunks,
                           q.tile_rows,  q.tiles,    q.cluster,
                           q.clusters,   q.row_blocks,
                           bwd_scratch_floats(q, n), bwd_tickets(q),
                           (long long)bwd_smem(q, n), q.slice,
                           q.final_split};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}

// The backward of tm_scale_bias_act.  x, res, g, dx and dres share
// `dtype` (0 = float32, 1 = bfloat16) and the (rows, c) row-major layout;
// res and dres are both null (K1c) or both set (K1d).  scale, bias, ds
// and db are float32 (c,).  part is a float32 scratch of `part_floats`
// and tickets an int32 scratch of `n_tickets`, both as
// tm_scale_bias_act_bwd_geometry gives them (anything else is refused);
// the tickets are zeroed here, on `stream`, before the launch.  Same
// limits on c as the forward; the Python wrapper checks them.  rows must
// be > 0.  Returns the launch's error, then cudaGetLastError().
extern "C" int tm_scale_bias_act_bwd(const void* x, const void* scale,
                                     const void* bias, const void* res,
                                     const void* g, void* dx, void* dres,
                                     void* part, void* tickets, void* ds,
                                     void* db, long long rows, int c,
                                     long long part_floats, int n_tickets,
                                     int dtype, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = dtype == 1 ? 8 : dtype == 0 ? 4 : 0;
  if ((res == nullptr) != (dres == nullptr) || rows <= 0 || n == 0 ||
      c <= 0 || c % n)
    return (int)cudaErrorInvalidValue;
  const BwdGeometry q = bwd_geometry(rows, c / n, n);
  if (!bwd_geometry_ok(q) || part_floats != bwd_scratch_floats(q, n) ||
      n_tickets != bwd_tickets(q))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      dtype == 1 ? dispatch_bwd<__nv_bfloat16>(x, scale, bias, res, g, dx,
                                               dres, part, tickets, ds, db,
                                               rows, c, relu, s)
                 : dispatch_bwd<float>(x, scale, bias, res, g, dx, dres,
                                       part, tickets, ds, db, rows, c, relu,
                                       s);
  if (err != cudaSuccess) return (int)err;
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
