// Dense trunk (concat-skip, softplus beta 100) for a batch of rows: the
// forward (K1) and its recompute backward (K2), all layers in one kernel.
//
// K1 replaces robir_tpu/render/pallas/fused_mlp.py:_fwd_kernel (launched by
// _fused_forward, pallas_call at :143). A 16-row tile (TRUNK_ROWS) carries
// its activations through every layer in shared memory, so device memory
// sees only the input rows, the output rows and the weights (read from
// L2). Bound on the H100: operations, 2 multiply-adds' worth of FLOPs per
// weight per row (2 * 524,544 for the SDF trunk, 2 * 1,836,544 for the
// 512-wide CESR normal net) against well under 3 KB in and out per row, on
// the CUDA cores in fp32.
//
// K2 replaces robir_tpu/render/pallas/fused_mlp.py:_bwd_kernel (launched by
// _fused_backward, pallas_call at :232): recompute the tile's forward, then
// backpropagate g_i = (g_{i+1} W_{i+1}^T) * sigma'(z_i) to dx, and dW_i =
// c_i^T g_i, db_i = sum g_i over all rows. Bound: operations, 6 FLOPs per
// weight per row (recompute, dgrad, wgrad). What differs from the TPU
// kernel, and why:
//   * The TPU tile keeps every layer's input c_i in VMEM. At width 512 the
//     nine layers of a 16-row tile are ~290 KB, more than a block's 227 KB
//     of shared memory, so the rows kernel writes c_i and sigma'(z_i) to a
//     global scratch buffer that the wrapper allocates
//     (fused_mlp_bwd_scratch_floats gives its size), and overwrites the
//     latter with g_i on the way down.
//   * Blocks run in parallel, in no order, so dW and db are not summed
//     across a sequential grid. A second kernel, shared with K4
//     (wgrad.cuh), reduces them per layer: each block owns a 128x128 tile
//     of dW_i and a slice of the rows, stages 16-row slices of c_i and g_i
//     in shared memory with cp.async, two deep, keeps an 8x8 register tile
//     per thread, and adds its partial into dW/db (zeroed by the wrapper)
//     with fp32 atomics. A scratch row is read once per 128 columns of the
//     other operand. The sum order changes from run to run.
//   * Rows past the ragged edge are loaded as zeros and never stored, so
//     they add nothing.
// The widest layer is a template parameter: TRUNK_MAXW (264) for the SDF
// trunk, TRUNK_MAXW_WIDE (520) for the 512-wide nets, whose 16 x 520 tiles
// need dynamic shared memory above the 48 KB default.
//
// What held both kernels far from their bound, and what the design does:
//   * Too few blocks. The CESR step launches both at 1,024 rows: 64 tiles
//     for 132 SMs, 8 warps on each busy SM. Below one tile per SM (N < 16
//     x SMs) a cluster of 2 blocks shares each tile: rank r computes its
//     windows of every layer's columns (starts 4-aligned; the plan's meta
//     carries them, from render/cuda/fused_mlp.py:launch_geometry), applies
//     the activation to them and writes them, as float4, into its own and
//     every peer's next-layer buffer through distributed shared memory,
//     then one cluster barrier a layer (its release/acquire covers the
//     remote writes). Every block loads the tile's input rows itself.
//     Clusters of 4 measured slower: at width 264 their 64-column windows
//     idle half of each warp, at width 520 two blocks do not fit an SM.
//   * The product. Each window is one rt_mm call (trunk.cuh) at R = 16
//     with 4 rows per thread (2 in K2's 264-wide build, for registers),
//     weights staged in a ring of three cp.async k-slabs (rings of 3 to 8
//     measured alike: the weights' latency is not the limit); a window of
//     at most RT_EXTRA columns (the normal net's last layer) is summed
//     straight from L1 by k-slices instead.
//   * From one tile per SM on, the cluster is 1. K2 keeps rt_mm there (a
//     512-wide layer is two windows); K1 runs its tile_mm kernel, whose
//     small shared memory lets several blocks share an SM to hide the L2
//     weight reads: with rt_mm's slab ring one block per SM fits at width
//     520 and two at 264, which measured slower from 8,192 rows on.
// Hazards the split adds: the first remote write follows a cluster barrier
// that follows every block's zeroing of its shared memory; at a skip layer
// the concatenated input is built locally and a cluster barrier follows,
// since the layer's output then goes to the buffer the peers just read; no
// block exits while a peer may still write to or read from its shared
// memory. A refused cluster launch returns its error.
#include <cooperative_groups.h>

#include "wgrad.cuh"

namespace cg = cooperative_groups;

#define SQRT_HALF 0.70710678118654752f
#define MLP_CLUSTER 2       // blocks per row tile below one tile per SM
#define MLP_MAX_WINDOWS 8   // column windows of one layer and direction, all ranks
#define MLP_OUT 0           // windows over a layer's output columns (the W product)
#define MLP_IN 1            // windows over its input columns (the W^T product)
#define MLP_TM 4            // rows per thread of rt_mm's register tile at R = 16

// The launch geometry: blocks per row tile, and each layer's column
// windows. Window k of (direction d, layer i) is [cut[d][i][k], cut[d][i][k
// + 1]) and belongs to rank k / (nwin[d][i] / cluster). At one block per
// tile K1 runs its tile_mm kernel, which takes no windows.
struct MLPGeom {
  int cluster;  // 1 or MLP_CLUSTER
  int nwin[2][TRUNK_MAX_LAYERS];
  short cut[2][TRUNK_MAX_LAYERS][MLP_MAX_WINDOWS + 1];
};

// meta after the plan: [cluster, then for each layer: nwin, nwin + 1 cuts
// over its outputs, nwin, nwin + 1 cuts over its inputs]. Returns 0, or 1
// unless each direction's windows partition its columns in order, each at
// most TRUNK_MAXW wide, non-empty ones starting 4-aligned.
static int mlp_geom_from_meta(const int* m, const TrunkPlan& p, MLPGeom* g) {
  g->cluster = *m++;
  if (g->cluster != 1 && g->cluster != MLP_CLUSTER) return 1;
  for (int i = 0; i < p.n; ++i) {
    for (int d = 0; d < 2; ++d) {
      const int width = d == MLP_OUT ? p.dout[i] : p.din[i];
      const int nw = *m++;
      if (nw < 1 || nw > MLP_MAX_WINDOWS || nw % g->cluster || m[0] != 0 || m[nw] != width)
        return 1;
      g->nwin[d][i] = nw;
      for (int k = 0; k <= nw; ++k) g->cut[d][i][k] = (short)m[k];
      for (int k = 0; k < nw; ++k)
        if (m[k + 1] < m[k] || m[k + 1] - m[k] > TRUNK_MAXW || (m[k + 1] > m[k] && (m[k] & 3)))
          return 1;
      m += nw + 1;
    }
  }
  return 0;
}

static __device__ __forceinline__ float* other_buf(float* p, float* a, float* b) {
  return p == a ? b : a;
}

// The shared memory of a block of the rt_mm kernels.
template <int LD>
struct MLPTile {
  float* bufA;   // [TRUNK_ROWS][LD] activations, then the backward's rows
  float* bufB;   // [TRUNK_ROWS][LD]
  float* x0;     // [TRUNK_ROWS][TRUNK_MAXD0] the tile's input rows
  float* acc;    // [TRUNK_ROWS][TRUNK_MAXD0] K2's dx (this block's part)
  float* slabs;  // [RT_SLAB_STAGES][RT_SLAB_K][RT_SLAB_LD] rt_mm's weight slabs
  static constexpr size_t floats =
      2 * TRUNK_ROWS * LD + 2 * TRUNK_ROWS * TRUNK_MAXD0 + RT_SLAB_STAGES * RT_SLAB_K * RT_SLAB_LD;
  // blocks an SM can hold by shared memory (227 KB, 1 KB reserved each), at most 2
  static constexpr int per_sm = 232448 / (4 * floats + 1024) >= 2 ? 2 : 1;
};

// Carve the dynamic shared memory and zero it, so that a product's reads
// past a buffer's written width (up to the next multiple of 4) see zeros.
template <int LD>
static __device__ __forceinline__ MLPTile<LD> mlp_tile(float* smem) {
  MLPTile<LD> t;
  t.bufA = smem;
  t.bufB = t.bufA + TRUNK_ROWS * LD;
  t.x0 = t.bufB + TRUNK_ROWS * LD;
  t.acc = t.x0 + TRUNK_ROWS * TRUNK_MAXD0;
  t.slabs = t.acc + TRUNK_ROWS * TRUNK_MAXD0;
  float4* s4 = reinterpret_cast<float4*>(smem);
  for (int idx = threadIdx.x; idx < (int)(MLPTile<LD>::floats / 4); idx += blockDim.x)
    s4[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  return t;
}

// A barrier over the row tile's blocks.
static __device__ __forceinline__ void mlp_sync(int C) {
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// buf[off .. off + 3] = v in this block's shared memory and in every peer's
// (off a multiple of 4).
static __device__ __forceinline__ void mlp_put4(int C, int rank, float* buf, int off, float4 v) {
  *reinterpret_cast<float4*>(buf + off) = v;
  for (int q = 0; q < C; ++q)
    if (q != rank) *reinterpret_cast<float4*>(cg::this_cluster().map_shared_rank(buf + off, q)) = v;
}

static __device__ __forceinline__ float4 act4(float4 v) {
  return make_float4(trunk_act(v.x), trunk_act(v.y), trunk_act(v.z), trunk_act(v.w));
}

static __device__ __forceinline__ float at(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// out[r][j] = sum_k in[r][k] * M[k * ldm + j] (+ bias[j]) for ncols at most
// RT_EXTRA (the normal net's 3 outputs): the 16 threads of a row each sum
// every 16th k, with weights read through L1, and shuffles add them up. A
// slab ring would stream such a thin matrix a few floats per barrier.
template <int LD>
static __device__ void mlp_narrow_mm(const float* in, int nk, const float* __restrict__ M,
                                     int ldm, int ncols, const float* __restrict__ bias,
                                     float* out) {
  constexpr int TPR = TRUNK_THREADS / TRUNK_ROWS;  // threads per row, in one warp
  const int r = threadIdx.x / TPR, u = threadIdx.x % TPR;
  float acc[RT_EXTRA];
#pragma unroll
  for (int e = 0; e < RT_EXTRA; ++e) acc[e] = 0.f;
  for (int k = u; k < nk; k += TPR) {
    const float a = in[r * LD + k];
    const float* m = M + (size_t)k * ldm;
#pragma unroll
    for (int e = 0; e < RT_EXTRA; ++e)
      if (e < ncols) acc[e] = fmaf(a, __ldg(m + e), acc[e]);
  }
#pragma unroll
  for (int e = 0; e < RT_EXTRA; ++e) {
    float v = acc[e];
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (e < ncols && u == 0) out[r * LD + e] = v + (bias != nullptr ? bias[e] : 0.f);
  }
}

// out[:, window] = in x M[:, window] (+ bias[window]) for each of this
// rank's windows of (direction d, layer i); M has row stride ldm. The
// caller synchronises before and after, as for rt_mm.
template <int LD, int TM>
static __device__ void mlp_product(const MLPGeom& g, int d, int i, int rank, const float* in,
                                   int nk, const float* __restrict__ M, int ldm,
                                   const float* __restrict__ bias, float* out, float* slabs) {
  const int per = g.nwin[d][i] / g.cluster;
  bool first = true;
  for (int k = rank * per; k < (rank + 1) * per; ++k) {
    const int a = g.cut[d][i][k], w = g.cut[d][i][k + 1] - a;
    if (w <= 0) continue;
    if (!first) __syncthreads();  // the last call's slabs are read before they refill
    first = false;
    const float* bw = bias != nullptr ? bias + a : nullptr;
    if (w <= RT_EXTRA)
      mlp_narrow_mm<LD>(in, nk, M + a, ldm, w, bw, out + a);
    else
      rt_mm_window<TRUNK_ROWS, LD, TM>(in, nk, M + a, ldm, w, bw, out + a, slabs);
  }
}

// f(r, j, n) for every row r of the tile and every group of 4 columns
// j .. j + 3 of this rank's windows of (direction d, layer i), n of them
// inside the window, each group once across the block's threads. A thread
// reads its group with one float4 load and writes it, to this block and
// its peers, with float4 stores: per column, a shared load that may alias
// the last remote store waits for it. Only a layer's last window is ragged,
// so columns j + n .. j + 3 lie past the layer's width, where a write
// changes nothing that a product reads (only times zero weights).
template <typename F>
static __device__ __forceinline__ void mlp_each4(const MLPGeom& g, int d, int i, int rank, F f) {
  const int per = g.nwin[d][i] / g.cluster;
  for (int k = rank * per; k < (rank + 1) * per; ++k) {
    const int a = g.cut[d][i][k], e = g.cut[d][i][k + 1], groups = (e - a + 3) >> 2;
    for (int idx = threadIdx.x; idx < TRUNK_ROWS * groups; idx += blockDim.x) {
      const int r = idx / groups, j = a + 4 * (idx - r * groups);
      f(r, j, min(4, e - j));
    }
  }
}

// K1 at one block per tile: tile_mm, each thread a column of 16 rows fed
// with weights read through L1 from L2, and shared memory small enough
// (two 16-row tiles and x0) for several blocks per SM to hide those reads.
template <int LD>
__global__ void __launch_bounds__(TRUNK_THREADS)
    fused_mlp_fwd_tile_kernel(TrunkPlan p, const float* __restrict__ x,
                              const float* __restrict__ W, const float* __restrict__ b,
                              float* __restrict__ y, long long N) {
  extern __shared__ float smem[];
  float* bufA = smem;
  float* bufB = bufA + TRUNK_ROWS * LD;
  float* x0 = bufB + TRUNK_ROWS * LD;
  const long long row0 = (long long)blockIdx.x * TRUNK_ROWS;

  tile_load_rows(x, p.d0, row0, N, x0, TRUNK_MAXD0);
  tile_load_rows(x, p.d0, row0, N, bufA, LD);
  __syncthreads();

  float* h = bufA;
  for (int i = 0; i < p.n; ++i) {
    float* c = tile_layer_input<LD>(p, i, h, x0, other_buf(h, bufA, bufB));
    float* z = other_buf(c, bufA, bufB);
    tile_mm<LD>(c, p.din[i], W + p.woff[i], p.dout[i], b + p.boff[i], z);
    __syncthreads();
    if (i < p.n - 1) {
      const int w = p.dout[i];
      for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
        int r = idx / w, j = idx - r * w;
        z[r * LD + j] = trunk_act(z[r * LD + j]);
      }
      __syncthreads();
    }
    h = z;
  }
  tile_store_rows(h, LD, p.dout[p.n - 1], row0, N, y);
}

// K1 below one tile per SM: x [N, d0] -> y [N, dout_last], through rt_mm,
// in clusters of MLP_CLUSTER blocks.
template <int LD>
__global__ void __launch_bounds__(TRUNK_THREADS, MLPTile<LD>::per_sm)
    fused_mlp_fwd_kernel(TrunkPlan p, MLPGeom g, const float* __restrict__ x,
                         const float* __restrict__ W, const float* __restrict__ b,
                         float* __restrict__ y, long long N) {
  extern __shared__ __align__(16) float smem[];
  const MLPTile<LD> t = mlp_tile<LD>(smem);
  const int C = g.cluster;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long row0 = (long long)(blockIdx.x / C) * TRUNK_ROWS;

  tile_load_rows(x, p.d0, row0, N, t.x0, TRUNK_MAXD0);
  tile_load_rows(x, p.d0, row0, N, t.bufA, LD);
  mlp_sync(C);  // every block has zeroed and loaded before any remote write

  float* h = t.bufA;
  for (int i = 0; i < p.n; ++i) {
    float* c = tile_layer_input<LD>(p, i, h, t.x0, other_buf(h, t.bufA, t.bufB));
    if (p.skip[i] && C > 1) mlp_sync(C);  // the peers have read h, whose buffer takes z
    float* z = other_buf(c, t.bufA, t.bufB);
    mlp_product<LD, MLP_TM>(g, MLP_OUT, i, rank, c, p.din[i], W + p.woff[i], p.dout[i],
                            b + p.boff[i], z, t.slabs);
    __syncthreads();
    if (i < p.n - 1) {
      mlp_each4(g, MLP_OUT, i, rank, [&](int r, int j, int) {
        mlp_put4(C, rank, z, r * LD + j, act4(*reinterpret_cast<const float4*>(z + r * LD + j)));
      });
      mlp_sync(C);
    } else {
      const int w = p.dout[i];
      mlp_each4(g, MLP_OUT, i, rank, [&](int r, int j, int n) {
        const float4 v = *reinterpret_cast<const float4*>(z + r * LD + j);
        if (row0 + r < N)
          for (int u = 0; u < n; ++u) y[(row0 + r) * w + j + u] = at(v, u);
      });
    }
    h = z;
  }
}

// Offsets (in floats) of each layer's [N, width] region in K2's scratch.
struct BwdScratch {
  long long c[TRUNK_MAX_LAYERS];  // layer inputs c_i                   [N, din_i]
  long long g[TRUNK_MAX_LAYERS];  // sigma'(z_i), then g_i = dL/dz_i     [N, dout_i]
};

static long long bwd_scratch_layout(const TrunkPlan& p, long long N, BwdScratch* sc) {
  long long off = 0;
  for (int i = 0; i < p.n; ++i) {
    sc->c[i] = off;
    off += N * p.din[i];
    sc->g[i] = off;
    off += N * p.dout[i];
  }
  return off;
}

// K2, row-tile part: recompute the forward (saving c_i and sigma'(z_i);
// the last layer's output is not needed), then walk the layers backwards
// from dy, leaving g_i in scratch and writing dx (skipped when dx is null:
// then layer 0's transposed product is not needed at all). Each rank stores
// the columns of its own windows; in the backward, rank r's windows run
// over each layer's input columns. Column k of dx gathers layer 0's column
// k and the skip layer's column dh + k, which may be two ranks' windows, so
// each block sums its part in acc and the ranks add theirs at the end.
template <int LD>
__global__ void __launch_bounds__(TRUNK_THREADS, MLPTile<LD>::per_sm)
    mlp_bwd_rows_kernel(TrunkPlan p, MLPGeom g, BwdScratch sc, const float* __restrict__ x,
                        const float* __restrict__ dy, const float* __restrict__ W,
                        const float* __restrict__ Wt, const float* __restrict__ b,
                        float* __restrict__ dx, float* scratch, long long N) {
  // rows per thread of the register tile: at width 264 two blocks share an
  // SM, and 4 rows per thread spill under their 128 registers
  constexpr int TM = LD == TRUNK_MAXW ? 2 : MLP_TM;
  extern __shared__ __align__(16) float smem[];
  const MLPTile<LD> t = mlp_tile<LD>(smem);
  const int C = g.cluster;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long row0 = (long long)(blockIdx.x / C) * TRUNK_ROWS;

  tile_load_rows(x, p.d0, row0, N, t.x0, TRUNK_MAXD0);
  tile_load_rows(x, p.d0, row0, N, t.bufA, LD);
  mlp_sync(C);  // every block has zeroed and loaded before any remote write

  // recompute: c_i and sigma'(z_i) to scratch
  float* h = t.bufA;
  for (int i = 0; i < p.n; ++i) {
    float* c = tile_layer_input<LD>(p, i, h, t.x0, other_buf(h, t.bufA, t.bufB));
    if (p.skip[i] && C > 1) mlp_sync(C);  // the peers have read h, whose buffer takes z
    const int win = p.din[i];
    float* cs = scratch + sc.c[i];
    mlp_each4(g, MLP_IN, i, rank, [&](int r, int k, int n) {
      const float4 v = *reinterpret_cast<const float4*>(c + r * LD + k);
      if (row0 + r < N)
        for (int u = 0; u < n; ++u) cs[(row0 + r) * win + k + u] = at(v, u);
    });
    if (i == p.n - 1) break;
    float* z = other_buf(c, t.bufA, t.bufB);
    mlp_product<LD, TM>(g, MLP_OUT, i, rank, c, p.din[i], W + p.woff[i], p.dout[i],
                        b + p.boff[i], z, t.slabs);
    __syncthreads();
    const int w = p.dout[i];
    float* s = scratch + sc.g[i];
    mlp_each4(g, MLP_OUT, i, rank, [&](int r, int j, int n) {
      const float4 zz = *reinterpret_cast<const float4*>(z + r * LD + j);
      if (row0 + r < N)
        for (int u = 0; u < n; ++u) s[(row0 + r) * w + j + u] = trunk_act_d1(at(zz, u));
      mlp_put4(C, rank, z, r * LD + j, act4(zz));
    });
    mlp_sync(C);
    h = z;
  }

  // backward: g_{n-1} = dy (the last layer has no activation)
  __syncthreads();  // c_{n-1} is stored before its buffer may take dy
  float* gb = t.bufA;
  tile_load_rows(dy, p.dout[p.n - 1], row0, N, gb, LD);
  mlp_sync(C);  // every block is done with its recompute before remote writes
  for (int i = p.n - 1; i >= 0; --i) {
    const int w = p.dout[i];
    float* gs = scratch + sc.g[i];
    mlp_each4(g, MLP_OUT, i, rank, [&](int r, int j, int n) {
      const float4 v = *reinterpret_cast<const float4*>(gb + r * LD + j);
      if (row0 + r < N)
        for (int u = 0; u < n; ++u) gs[(row0 + r) * w + j + u] = at(v, u);
    });
    if (i == 0 && dx == nullptr) break;
    float* cb = other_buf(gb, t.bufA, t.bufB);
    mlp_product<LD, TM>(g, MLP_IN, i, rank, gb, p.dout[i], Wt + p.woff[i], p.din[i], nullptr,
                        cb, t.slabs);  // dL/dc_i
    __syncthreads();
    const int dh = p.dh[i], skip = p.skip[i];
    const float* s = i > 0 ? scratch + sc.g[i - 1] : nullptr;  // sigma'(z_{i-1}) [N, dh]
    mlp_each4(g, MLP_IN, i, rank, [&](int r, int k0, int n) {
      const float4 v4 = *reinterpret_cast<const float4*>(cb + r * LD + k0);
      float v[4] = {v4.x, v4.y, v4.z, v4.w};
      for (int u = 0; u < n; ++u) {
        const int k = k0 + u;
        if (k >= dh) {  // the x0 half of a skip input: to dx
          t.acc[r * TRUNK_MAXD0 + (k - dh)] += v[u] * SQRT_HALF;
          continue;
        }
        const float a = skip ? v[u] * SQRT_HALF : v[u];
        if (i > 0) {
          v[u] = (row0 + r < N ? s[(row0 + r) * dh + k] : 0.f) * a;
        } else {
          t.acc[r * TRUNK_MAXD0 + k] += a;
        }
      }
      if (i > 0) mlp_put4(C, rank, cb, r * LD + k0, make_float4(v[0], v[1], v[2], v[3]));
    });
    if (i > 0) mlp_sync(C);
    gb = cb;
  }
  if (dx == nullptr) return;  // no peer reads or writes this block's memory any more
  mlp_sync(C);  // every block's part of dx is in its acc
  const int d0 = p.d0;
  for (int idx = rank * TRUNK_THREADS + threadIdx.x; idx < TRUNK_ROWS * d0;
       idx += C * TRUNK_THREADS) {
    const int r = idx / d0, k = idx - r * d0;
    float v = 0.f;
    for (int q = 0; q < C; ++q)
      v += q == rank ? t.acc[r * TRUNK_MAXD0 + k]
                     : *cg::this_cluster().map_shared_rank(t.acc + r * TRUNK_MAXD0 + k, q);
    if (row0 + r < N) dx[(row0 + r) * d0 + k] = v;
  }
  if (C > 1) mlp_sync(C);  // no block exits while a peer reads its acc
}

// The narrowest instantiation that holds the plan, or 0 if none does.
static int plan_width(const int* meta, TrunkPlan* p) {
  if (!trunk_plan_from_meta(meta, p, TRUNK_MAXW)) return TRUNK_MAXW;
  if (!trunk_plan_from_meta(meta, p, TRUNK_MAXW_WIDE)) return TRUNK_MAXW_WIDE;
  return 0;
}

// The plan and the launch geometry after it; the build width, or 0 if
// either does not fit the kernels.
static int plan_and_geom(const int* meta, TrunkPlan* p, MLPGeom* g) {
  const int width = plan_width(meta, p);
  if (!width || mlp_geom_from_meta(meta + 2 + 4 * p->n, *p, g)) return 0;
  return width;
}

// A launch of `tiles` row tiles, each a cluster of C blocks.
static void mlp_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, long long tiles,
                       int C, size_t smem, cudaStream_t st) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(tiles * C));
  cfg->blockDim = dim3(TRUNK_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename... Params, typename... Args>
static int mlp_launch(void (*kernel)(Params...), size_t smem, long long N, int C,
                      cudaStream_t st, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  mlp_config(&cfg, attr, (N + TRUNK_ROWS - 1) / TRUNK_ROWS, C, smem, st);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* trunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

template <int LD>
static int launch_forward(const TrunkPlan& p, const MLPGeom& g, const float* x, const float* W,
                          const float* b, float* y, long long N, cudaStream_t st) {
  if (g.cluster > 1)
    return mlp_launch(fused_mlp_fwd_kernel<LD>, sizeof(float) * MLPTile<LD>::floats, N,
                      g.cluster, st, p, g, x, W, b, y, N);
  const size_t smem = sizeof(float) * (2 * TRUNK_ROWS * LD + TRUNK_ROWS * TRUNK_MAXD0);
  cudaError_t err = allow_smem(fused_mlp_fwd_tile_kernel<LD>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + TRUNK_ROWS - 1) / TRUNK_ROWS;
  fused_mlp_fwd_tile_kernel<LD><<<(unsigned)blocks, TRUNK_THREADS, smem, st>>>(p, x, W, b, y, N);
  return (int)cudaGetLastError();
}

// K1: x [N, d0] -> y [N, dout_last]; W and b are the flat folded weights and
// biases; meta is the plan, then the launch geometry.
extern "C" int fused_mlp_forward(const float* x, const float* W, const float* b, float* y,
                                 const int* meta, long long N, void* stream) {
  TrunkPlan p;
  MLPGeom g;
  const int width = plan_and_geom(meta, &p, &g);
  if (!width) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return width == TRUNK_MAXW ? launch_forward<TRUNK_MAXW>(p, g, x, W, b, y, N, st)
                             : launch_forward<TRUNK_MAXW_WIDE>(p, g, x, W, b, y, N, st);
}

// Floats of scratch K2 needs for N rows, or -1 if the plan does not fit
// (meta: the plan alone).
extern "C" long long fused_mlp_bwd_scratch_floats(const int* meta, long long N) {
  TrunkPlan p;
  if (!plan_width(meta, &p)) return -1;
  BwdScratch sc;
  return bwd_scratch_layout(p, N, &sc);
}

template <int LD>
static int launch_bwd_rows(const TrunkPlan& p, const MLPGeom& g, const BwdScratch& sc,
                           const float* x, const float* dy, const float* W, const float* Wt,
                           const float* b, float* dx, float* scratch, long long N,
                           cudaStream_t st) {
  return mlp_launch(mlp_bwd_rows_kernel<LD>, sizeof(float) * MLPTile<LD>::floats, N, g.cluster,
                    st, p, g, sc, x, dy, W, Wt, b, dx, scratch, N);
}

// K2: dy [N, dout_last] -> dx [N, d0] (unless dx is null), and dW, db added
// into the flat buffers, which the caller zeroes.
extern "C" int fused_mlp_backward(const float* x, const float* dy, const float* W,
                                  const float* Wt, const float* b, float* dx, float* dW,
                                  float* db, float* scratch, const int* meta, long long N,
                                  void* stream) {
  TrunkPlan p;
  MLPGeom g;
  const int width = plan_and_geom(meta, &p, &g);
  if (!width) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  BwdScratch sc;
  bwd_scratch_layout(p, N, &sc);
  cudaStream_t st = (cudaStream_t)stream;
  int err = width == TRUNK_MAXW
                ? launch_bwd_rows<TRUNK_MAXW>(p, g, sc, x, dy, W, Wt, b, dx, scratch, N, st)
                : launch_bwd_rows<TRUNK_MAXW_WIDE>(p, g, sc, x, dy, W, Wt, b, dx, scratch, N, st);
  if (err) return err;

  const int sms = trunk_sm_count();
  if (!sms) return (int)cudaErrorInvalidDevice;
  for (int i = 0; i < p.n; ++i) {
    cudaError_t e = wgrad_launch(scratch + sc.c[i], scratch + sc.g[i], nullptr, nullptr, N,
                                 p.din[i], p.dout[i], sms, dW + p.woff[i], db + p.boff[i], st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Clusters of MLP_CLUSTER blocks of K1 (backward = 0) or K2's rows kernel
// (1), their rt_mm form at build width `width`, that the device holds at once.
template <typename... Params>
static int max_clusters(void (*kernel)(Params...), size_t smem, int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  mlp_config(&cfg, attr, 1, MLP_CLUSTER, smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)kernel, &cfg);
}

extern "C" int fused_mlp_max_active_clusters(int width, int backward, int* out) {
  const size_t narrow = sizeof(float) * MLPTile<TRUNK_MAXW>::floats;
  const size_t wide = sizeof(float) * MLPTile<TRUNK_MAXW_WIDE>::floats;
  if (width == TRUNK_MAXW)
    return backward ? max_clusters(mlp_bwd_rows_kernel<TRUNK_MAXW>, narrow, out)
                    : max_clusters(fused_mlp_fwd_kernel<TRUNK_MAXW>, narrow, out);
  if (width == TRUNK_MAXW_WIDE)
    return backward ? max_clusters(mlp_bwd_rows_kernel<TRUNK_MAXW_WIDE>, wide, out)
                    : max_clusters(fused_mlp_fwd_kernel<TRUNK_MAXW_WIDE>, wide, out);
  return (int)cudaErrorInvalidValue;
}
