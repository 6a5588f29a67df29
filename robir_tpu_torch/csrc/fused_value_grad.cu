// SDF trunk value + spatial gradient (forward) and its hand-derived VJP
// (backward).
//
// Replaces robir_tpu/render/pallas/fused_value_grad.py:
//   _fwd_kernel (launched by _fused_vg_forward, pallas_call at :209) and
//   _bwd_kernel (launched by _fused_vg_backward, pallas_call at :244).
// The math and its derivation are in that module's docstring (:27-40):
//   forward  - trunk forward saving s_i = sigma'(z_i), then the reverse chain
//              u_{i-1} = s_{i-1} * q_i from the one-hot seed e0 on output
//              column 0, which yields de = d y[:, 0] / d x;
//   backward - an ascending sweep through the reverse chain (pbar_i, sbar_i
//              and half of dW), then the descending backward with
//              sigma''(z) * sbar injections -> dx, dW, db.
//
// What differs from the TPU kernels, and why:
//   * Per-row state does not fit on chip. The TPU tile keeps c_i, s_i, u_i
//     and q_i for all layers in VMEM; on the H100 that is ~33 KB per row of
//     the full-width trunk. The row tile's current activations stay in shared
//     memory, and the per-layer state goes to global scratch buffers that the
//     wrapper allocates (fused_vg_scratch_floats gives their sizes). When a
//     backward will follow, the forward writes c_i, s_i, u_i and q_i there
//     as it computes them, and the wrapper keeps that buffer for the
//     backward, which starts from it: nothing of the forward is computed
//     twice. Otherwise the forward writes s_i alone and drops it. The
//     backward's own buffer holds pbar_i, zbar_i and sigma''(z_{i-1}) *
//     sbar_{i-1}; it writes nothing into the kept state, so a second
//     backward from that state gives the same dx.
//   * Blocks run in parallel, in no order, so dW and db are not accumulated
//     across a sequential grid. The backward's rows kernel writes the
//     operands of dW_i = c_i^T zbar_i + pbar_i^T u_i to scratch, and the
//     reduction K2 also uses (wgrad.cuh) sums both pairs per layer in one
//     launch: 128 x 128 tiles of dW, 8 x 8 register tiles, fp32 atomicAdd
//     into dW and db, which the wrapper zeroes. The order of those sums
//     changes from run to run.
//   * Rows past the ragged edge are loaded as zeros and never stored, so they
//     add nothing to dW or db.
// Bound on the H100: operations, about 4 * 524,544 (forward) and 8 * 524,544
// (backward) fp32 FLOPs per row of the full-width trunk, on the CUDA
// cores in fp32. What holds the kernels below that: the trunk products,
// which tile_mm fed with one scalar shared load per multiply-add; then the
// elementwise sweeps between products, which with one or two blocks per SM
// wait on their scratch reads; then, in K4, the reduction. So:
//   * The products run in rt_mm (trunk.cuh): R-row tiles, an R/8 x 8
//     register tile per thread, float4 shared loads (16 per 256
//     multiply-adds at R = 64), and the weights staged in a ring of three
//     cp.async k-slabs.
//   * R is 64 once N gives about two tiles per SM (213.5 KB of dynamic
//     shared memory, one 256-thread block per SM), else 16 (90.5 KB), so
//     that the CESR step's 1,024-row launches keep 64 blocks.
//   * The elementwise sweeps give each thread whole columns, with no index
//     division, issue VG_BATCH scratch loads per thread before using any,
//     and ask L2 for the rows of their next sweep before each product.
//   * The reduction is the one K2 uses (wgrad.cuh), both operand pairs of
//     a layer in one launch.
#include "wgrad.cuh"

#define SQRT_HALF 0.70710678118654752f

// Offsets (in floats) of each layer's [N, width] region in its scratch
// buffer; -1 where that array is not stored.
struct VGScratch {
  // the forward's state: s alone, or all four where the backward keeps them
  long long c[TRUNK_MAX_LAYERS];   // layer inputs c_i       [N, din_i]
  long long s[TRUNK_MAX_LAYERS];   // sigma'(z_i), hidden    [N, dout_i]
  long long u[TRUNK_MAX_LAYERS];   // reverse-chain u_i      [N, dout_i]
  long long q[TRUNK_MAX_LAYERS];   // q_i                    [N, dh_i]
  // the backward's own buffer
  long long pb[TRUNK_MAX_LAYERS];  // pbar_i                 [N, din_i]
  long long zb[TRUNK_MAX_LAYERS];  // zbar_i                 [N, dout_i]
  long long t[TRUNK_MAX_LAYERS];   // sigma''(z_{i-1}) * sbar_{i-1}, i > 0 [N, dh_i]
};

// The scratch buffers (fused_vg_scratch_floats's `buffer`): the forward's
// state when no backward follows (s_i), the state kept for the backward
// (c_i, s_i, u_i, q_i), and the backward's own (pbar_i, zbar_i, t_i).
enum { VG_FORWARD = 0, VG_STATE = 1, VG_BACKWARD = 2 };

// Lays out one buffer in sc and returns its floats. VG_FORWARD and VG_STATE
// set every offset (-1 for the backward's own arrays); VG_BACKWARD sets its
// own arrays alone, so it comes after the state's.
static long long vg_scratch_layout(const TrunkPlan& p, long long N, int buffer, VGScratch* sc) {
  long long off = 0;
  for (int i = 0; i < p.n; ++i) {
    if (buffer == VG_BACKWARD) {
      sc->pb[i] = off; off += N * p.din[i];
      sc->zb[i] = off; off += N * p.dout[i];
      sc->t[i] = -1;
      if (i > 0) { sc->t[i] = off; off += N * p.dh[i]; }
      continue;
    }
    sc->c[i] = sc->s[i] = sc->u[i] = sc->q[i] = sc->pb[i] = sc->zb[i] = sc->t[i] = -1;
    if (i < p.n - 1) { sc->s[i] = off; off += N * p.dout[i]; }
    if (buffer == VG_STATE) {
      sc->c[i] = off; off += N * p.din[i];
      sc->u[i] = off; off += N * p.dout[i];
      sc->q[i] = off; off += N * p.dh[i];
    }
  }
  return off;
}

static __device__ __forceinline__ float* other_buf(float* p, float* a, float* b) {
  return p == a ? b : a;
}

// R = 64 from about two row tiles per SM, else R = 16 (more blocks for few rows).
#define VG_TALL_TILES_PER_SM 2
// The elementwise sweeps give each thread whole columns of the tile (thread
// j: columns j, j + 256, ...) and walk the rows in batches of VG_BATCH,
// issuing a batch's global loads before using any of them: no index
// division, coalesced rows, and VG_BATCH loads in flight per thread.
#define VG_BATCH 8

template <int R>
struct VGTile {
  float* bufA;   // [R][TRUNK_MAXW] activations, then reverse-chain and backward rows
  float* bufB;   // [R][TRUNK_MAXW]
  float* x0;     // [R][TRUNK_MAXD0] the tile's input rows
  float* acc;    // [R][TRUNK_MAXD0] de (forward) or dx (backward)
  float* slabs;  // [RT_SLAB_STAGES][RT_SLAB_K][RT_SLAB_LD] weight slabs of rt_mm
  static constexpr size_t floats =
      2 * R * TRUNK_MAXW + 2 * R * TRUNK_MAXD0 + RT_SLAB_STAGES * RT_SLAB_K * RT_SLAB_LD;
};

// Carve the dynamic shared memory and zero it, so that a product's reads
// past a buffer's written width (up to the next multiple of 4) see zeros.
template <int R>
static __device__ __forceinline__ VGTile<R> vg_tile(float* smem) {
  VGTile<R> t;
  t.bufA = smem;
  t.bufB = t.bufA + R * TRUNK_MAXW;
  t.x0 = t.bufB + R * TRUNK_MAXW;
  t.acc = t.x0 + R * TRUNK_MAXD0;
  t.slabs = t.acc + R * TRUNK_MAXD0;
  float4* s4 = reinterpret_cast<float4*>(smem);
  for (int idx = threadIdx.x; idx < (int)(VGTile<R>::floats / 4); idx += blockDim.x)
    s4[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  return t;
}

// Rows row0 .. row0 + R - 1 of a global [N, width] array into a shared
// [R][ld] tile, zeros past N.
template <int R>
static __device__ __forceinline__ void vg_load_rows(const float* __restrict__ src, int width,
                                                    long long row0, long long N, float* dst,
                                                    int ld) {
  const int rows = (int)min((long long)R, N - row0);
  for (int j = threadIdx.x; j < width; j += TRUNK_THREADS) {
    const float* g = src + row0 * width + j;
    for (int rb = 0; rb < R; rb += VG_BATCH) {
      float v[VG_BATCH];
#pragma unroll
      for (int u = 0; u < VG_BATCH; ++u) v[u] = rb + u < rows ? g[(long long)(rb + u) * width] : 0.f;
#pragma unroll
      for (int u = 0; u < VG_BATCH; ++u) dst[(rb + u) * ld + j] = v[u];
    }
  }
}

// The tile's rows below N of a shared [R][ld] tile to a global [N, width]
// array at dst (nothing if off < 0).
template <int R>
static __device__ __forceinline__ void vg_store_rows(const float* src, int ld, int width,
                                                     long long row0, long long N, float* dst,
                                                     long long off = 0) {
  if (off < 0) return;
  const int rows = (int)min((long long)R, N - row0);
  for (int j = threadIdx.x; j < width; j += TRUNK_THREADS) {
    float* g = dst + off + row0 * width + j;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) g[(long long)r * width] = src[r * ld + j];
  }
}

// Ask L2 for the tile's rows of a global [N, width] array (at off; nothing
// if off < 0), so that the sweep after the next product finds them there:
// one 128-byte line per thread and step.
template <int R>
static __device__ __forceinline__ void vg_prefetch_rows(const float* base, long long off,
                                                        int width, long long row0, long long N) {
  if (off < 0) return;
  const char* a = reinterpret_cast<const char*>(base + off + row0 * width);
  const long long bytes = 4LL * min((long long)R, N - row0) * width;
  for (long long o = 128LL * threadIdx.x; o < bytes; o += 128LL * TRUNK_THREADS)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a + o));
}

// K3 for one row tile of R rows: forward (y into y_out), then the reverse
// chain (de into t.acc). Leaves in scratch whatever sc asks for: s_i alone,
// or the whole state (c_i, s_i, u_i, q_i) that the backward starts from.
template <int R>
static __device__ void vg_forward_phases(const TrunkPlan& p, const float* x, const float* W,
                                         const float* Wt, const float* b, long long N,
                                         long long row0, const VGScratch& sc, float* scratch,
                                         const VGTile<R>& t, float* y_out) {
  float *bufA = t.bufA, *bufB = t.bufB;
  const int rows = (int)min((long long)R, N - row0);
  vg_load_rows<R>(x, p.d0, row0, N, t.x0, TRUNK_MAXD0);
  vg_load_rows<R>(x, p.d0, row0, N, bufA, TRUNK_MAXW);
  __syncthreads();

  // phase 1: forward, saving c_i and s_i
  float* h = bufA;
  for (int i = 0; i < p.n; ++i) {
    float* c = tile_layer_input<TRUNK_MAXW, R>(p, i, h, t.x0, other_buf(h, bufA, bufB));
    vg_store_rows<R>(c, TRUNK_MAXW, p.din[i], row0, N, scratch, sc.c[i]);
    float* z = other_buf(c, bufA, bufB);
    rt_mm<R>(c, p.din[i], W + p.woff[i], p.dout[i], b + p.boff[i], z, t.slabs);
    __syncthreads();
    if (i < p.n - 1) {
      const int w = p.dout[i];
      for (int j = threadIdx.x; j < w; j += TRUNK_THREADS) {
        float* s = scratch + sc.s[i] + row0 * w + j;
#pragma unroll 8
        for (int r = 0; r < R; ++r) {
          const float zz = z[r * TRUNK_MAXW + j];
          if (r < rows) s[(long long)r * w] = trunk_act_d1(zz);
          z[r * TRUNK_MAXW + j] = trunk_act(zz);
        }
      }
      __syncthreads();
    } else {
      vg_store_rows<R>(z, TRUNK_MAXW, p.dout[i], row0, N, y_out);
    }
    h = z;
  }
  __syncthreads();

  // phase 2: reverse chain from the one-hot seed on output column 0
  float* u = bufA;
  {
    const int w = p.dout[p.n - 1];
    for (int j = threadIdx.x; j < w; j += TRUNK_THREADS)
      for (int r = 0; r < R; ++r) u[r * TRUNK_MAXW + j] = j == 0 ? 1.f : 0.f;
    __syncthreads();
  }
  for (int i = p.n - 1; i >= 0; --i) {
    vg_store_rows<R>(u, TRUNK_MAXW, p.dout[i], row0, N, scratch, sc.u[i]);
    if (i > 0) vg_prefetch_rows<R>(scratch, sc.s[i - 1], p.dh[i], row0, N);
    float* pq = other_buf(u, bufA, bufB);
    rt_mm<R>(u, p.dout[i], Wt + p.woff[i], p.din[i], nullptr, pq, t.slabs);  // p_i = u_i W_i^T
    __syncthreads();
    const int w = p.din[i], dh = p.dh[i];
    for (int k = threadIdx.x; k < w; k += TRUNK_THREADS) {
      if (k >= dh) {  // skip part: de += p_i[d:] / sqrt2
        for (int r = 0; r < R; ++r) t.acc[r * TRUNK_MAXD0 + (k - dh)] += pq[r * TRUNK_MAXW + k] * SQRT_HALF;
        continue;
      }
      const float* s = i > 0 ? scratch + sc.s[i - 1] + row0 * dh + k : nullptr;  // s_{i-1}
      float* qs = sc.q[i] >= 0 ? scratch + sc.q[i] + row0 * dh + k : nullptr;
      for (int rb = 0; rb < R; rb += VG_BATCH) {
        float sv[VG_BATCH];
#pragma unroll
        for (int v = 0; v < VG_BATCH; ++v)
          sv[v] = s != nullptr && rb + v < rows ? s[(long long)(rb + v) * dh] : 0.f;
#pragma unroll
        for (int v = 0; v < VG_BATCH; ++v) {
          const int r = rb + v;
          const float pv = pq[r * TRUNK_MAXW + k];
          const float q = p.skip[i] ? pv * SQRT_HALF : pv;
          if (qs != nullptr && r < rows) qs[(long long)r * dh] = q;
          if (i > 0) {  // u_{i-1} = s_{i-1} * q_i
            pq[r * TRUNK_MAXW + k] = sv[v] * q;
          } else {
            t.acc[r * TRUNK_MAXD0 + k] += q;
          }
        }
      }
    }
    __syncthreads();
    u = pq;
  }
}

template <int R>
__global__ void __launch_bounds__(TRUNK_THREADS, R == 64 ? 1 : 2)
    vg_fwd_kernel(TrunkPlan p, VGScratch sc, const float* __restrict__ x,
                  const float* __restrict__ W, const float* __restrict__ Wt,
                  const float* __restrict__ b, float* __restrict__ y, float* __restrict__ de,
                  float* scratch, long long N) {
  extern __shared__ __align__(16) float smem[];
  const VGTile<R> t = vg_tile<R>(smem);
  const long long row0 = (long long)blockIdx.x * R;
  vg_forward_phases<R>(p, x, W, Wt, b, N, row0, sc, scratch, t, y);
  vg_store_rows<R>(t.acc, TRUNK_MAXD0, p.d0, row0, N, de);
}

// Row-tile part of the backward, from the state K3 kept (s_i, q_i read
// here; c_i, u_i by the reduction): the ascending and descending sweeps.
// Writes dx, and pbar_i, zbar_i into its own buffer (work) for the dW/db
// reduction; reads the state alone.
template <int R>
__global__ void __launch_bounds__(TRUNK_THREADS, R == 64 ? 1 : 2)
    vg_bwd_rows_kernel(TrunkPlan p, VGScratch sc, const float* __restrict__ dy,
                       const float* __restrict__ dde, const float* __restrict__ W,
                       const float* __restrict__ Wt, float* __restrict__ dx,
                       const float* __restrict__ state, float* __restrict__ work, long long N) {
  extern __shared__ __align__(16) float smem[];
  const VGTile<R> t = vg_tile<R>(smem);
  float *bufA = t.bufA, *bufB = t.bufB;
  const long long row0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, N - row0);

  // phase 3, ascending: qbar_0 = dde; qbar_i = s_{i-1} * ubar_{i-1};
  // sbar_{i-1} = q_i * ubar_{i-1}; pbar_i = qbar_i (skip: [qbar, dde] / sqrt2);
  // ubar_i = pbar_i W_i. t_i = sigma''(z_{i-1}) * sbar_{i-1} goes to work.
  float* ubar = bufA;
  for (int i = 0; i < p.n; ++i) {
    float* pb = other_buf(ubar, bufA, bufB);
    const int w = p.din[i], dh = p.dh[i];
    for (int k = threadIdx.x; k < w; k += TRUNK_THREADS) {
      const bool from_dde = k >= dh || i == 0;  // pbar is dde (/ sqrt2) in this column
      const float* d = dde + row0 * p.d0 + (k >= dh ? k - dh : k);
      const float* s = i > 0 ? state + sc.s[i - 1] + row0 * dh + k : nullptr;
      const float* qs = i > 0 ? state + sc.q[i] + row0 * dh + k : nullptr;
      float* ts = i > 0 ? work + sc.t[i] + row0 * dh + k : nullptr;
      for (int rb = 0; rb < R; rb += VG_BATCH) {
        float dv[VG_BATCH], sv[VG_BATCH], qv[VG_BATCH];  // dde, s_{i-1}, q_i
#pragma unroll
        for (int v = 0; v < VG_BATCH; ++v) {
          const int r = rb + v;
          const bool chain = !from_dde && r < rows;
          dv[v] = from_dde && r < rows ? d[(long long)r * p.d0] : 0.f;
          sv[v] = chain ? s[(long long)r * dh] : 0.f;
          qv[v] = chain ? qs[(long long)r * dh] : 0.f;
        }
#pragma unroll
        for (int v = 0; v < VG_BATCH; ++v) {
          const int r = rb + v;
          float val;
          if (k >= dh) {
            val = dv[v] * SQRT_HALF;
          } else {
            float qbar;
            if (i == 0) {
              qbar = dv[v];
            } else {
              const float ub = ubar[r * TRUNK_MAXW + k];
              qbar = sv[v] * ub;
              if (r < rows) ts[(long long)r * dh] = trunk_act_d2(sv[v]) * (qv[v] * ub);
            }
            val = p.skip[i] ? qbar * SQRT_HALF : qbar;
          }
          pb[r * TRUNK_MAXW + k] = val;
        }
      }
    }
    __syncthreads();
    vg_store_rows<R>(pb, TRUNK_MAXW, w, row0, N, work, sc.pb[i]);
    if (i < p.n - 1) {
      vg_prefetch_rows<R>(state, sc.s[i], p.dh[i + 1], row0, N);
      vg_prefetch_rows<R>(state, sc.q[i + 1], p.dh[i + 1], row0, N);
      if (p.skip[i + 1]) vg_prefetch_rows<R>(dde, 0, p.d0, row0, N);
      rt_mm<R>(pb, w, W + p.woff[i], p.dout[i], nullptr, ubar, t.slabs);
      __syncthreads();
    }
  }
  __syncthreads();

  // phase 4, descending: zbar_{L-1} = dy; cbar = zbar_i W_i^T;
  // zbar_{i-1} = s_{i-1} * abar + t_i
  for (int idx = threadIdx.x; idx < R * TRUNK_MAXD0; idx += blockDim.x) t.acc[idx] = 0.f;
  float* zbar = bufA;
  vg_load_rows<R>(dy, p.dout[p.n - 1], row0, N, zbar, TRUNK_MAXW);
  __syncthreads();
  for (int i = p.n - 1; i >= 0; --i) {
    vg_store_rows<R>(zbar, TRUNK_MAXW, p.dout[i], row0, N, work, sc.zb[i]);
    if (i > 0) {
      vg_prefetch_rows<R>(state, sc.s[i - 1], p.dh[i], row0, N);
      vg_prefetch_rows<R>(work, sc.t[i], p.dh[i], row0, N);
    }
    float* cb = other_buf(zbar, bufA, bufB);
    rt_mm<R>(zbar, p.dout[i], Wt + p.woff[i], p.din[i], nullptr, cb, t.slabs);
    __syncthreads();
    const int w = p.din[i], dh = p.dh[i];
    for (int k = threadIdx.x; k < w; k += TRUNK_THREADS) {
      if (k >= dh) {
        for (int r = 0; r < R; ++r) t.acc[r * TRUNK_MAXD0 + (k - dh)] += cb[r * TRUNK_MAXW + k] * SQRT_HALF;
        continue;
      }
      if (i == 0) {
        for (int r = 0; r < R; ++r) t.acc[r * TRUNK_MAXD0 + k] += cb[r * TRUNK_MAXW + k];
        continue;
      }
      const float* s = state + sc.s[i - 1] + row0 * dh + k;  // s_{i-1}
      const float* ts = work + sc.t[i] + row0 * dh + k;      // sigma''(z_{i-1}) * sbar_{i-1}
      for (int rb = 0; rb < R; rb += VG_BATCH) {
        float sv[VG_BATCH], tv[VG_BATCH];
#pragma unroll
        for (int v = 0; v < VG_BATCH; ++v) {
          const bool ok = rb + v < rows;
          sv[v] = ok ? s[(long long)(rb + v) * dh] : 0.f;
          tv[v] = ok ? ts[(long long)(rb + v) * dh] : 0.f;
        }
#pragma unroll
        for (int v = 0; v < VG_BATCH; ++v) {
          const int r = rb + v;
          const float cv = cb[r * TRUNK_MAXW + k];
          const float a = p.skip[i] ? cv * SQRT_HALF : cv;
          cb[r * TRUNK_MAXW + k] = sv[v] * a + tv[v];
        }
      }
    }
    __syncthreads();
    zbar = cb;
  }
  vg_store_rows<R>(t.acc, TRUNK_MAXD0, p.d0, row0, N, dx);
}

// The row tile for N rows: 64 once that gives about VG_TALL_TILES_PER_SM
// tiles per SM, else 16; 0 on error.
static int vg_row_tile(long long N) {
  const int sms = trunk_sm_count();
  if (!sms) return 0;
  return N >= (long long)VG_TALL_TILES_PER_SM * sms * 64 ? 64 : 16;
}

template <int R>
static int launch_vg_forward(const TrunkPlan& p, const VGScratch& sc, const float* x,
                             const float* W, const float* Wt, const float* b, float* y,
                             float* de, float* scratch, long long N, cudaStream_t st) {
  const size_t smem = sizeof(float) * VGTile<R>::floats;
  cudaError_t err = allow_smem(vg_fwd_kernel<R>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + R - 1) / R;
  vg_fwd_kernel<R><<<(unsigned)blocks, TRUNK_THREADS, smem, st>>>(p, sc, x, W, Wt, b, y, de,
                                                                  scratch, N);
  return (int)cudaGetLastError();
}

template <int R>
static int launch_vg_bwd_rows(const TrunkPlan& p, const VGScratch& sc, const float* dy,
                              const float* dde, const float* W, const float* Wt, float* dx,
                              const float* state, float* work, long long N, cudaStream_t st) {
  const size_t smem = sizeof(float) * VGTile<R>::floats;
  cudaError_t err = allow_smem(vg_bwd_rows_kernel<R>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + R - 1) / R;
  vg_bwd_rows_kernel<R><<<(unsigned)blocks, TRUNK_THREADS, smem, st>>>(p, sc, dy, dde, W, Wt,
                                                                       dx, state, work, N);
  return (int)cudaGetLastError();
}

extern "C" const char* trunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Floats of one scratch buffer (VG_FORWARD, VG_STATE or VG_BACKWARD) for N
// rows, or -1 if the plan does not fit the kernels or there is no such buffer.
extern "C" long long fused_vg_scratch_floats(const int* meta, long long N, int buffer) {
  TrunkPlan p;
  if (trunk_plan_from_meta(meta, &p) || buffer < VG_FORWARD || buffer > VG_BACKWARD) return -1;
  VGScratch sc;
  return vg_scratch_layout(p, N, buffer, &sc);
}

// x [N, d0] -> y [N, dout_last], de [N, d0]; with keep, scratch (VG_STATE's
// size) holds the state that fused_vg_backward starts from, else VG_FORWARD's.
extern "C" int fused_vg_forward(const float* x, const float* W, const float* Wt, const float* b,
                                float* y, float* de, float* scratch, const int* meta, long long N,
                                int keep, void* stream) {
  TrunkPlan p;
  if (trunk_plan_from_meta(meta, &p)) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  VGScratch sc;
  vg_scratch_layout(p, N, keep ? VG_STATE : VG_FORWARD, &sc);
  cudaStream_t st = (cudaStream_t)stream;
  switch (vg_row_tile(N)) {
    case 64: return launch_vg_forward<64>(p, sc, x, W, Wt, b, y, de, scratch, N, st);
    case 16: return launch_vg_forward<16>(p, sc, x, W, Wt, b, y, de, scratch, N, st);
    default: return (int)cudaErrorInvalidDevice;
  }
}

// (dy [N, dout_last], dde [N, d0]) and the state fused_vg_forward kept for
// them -> dx [N, d0], and dW, db added into the flat buffers, which the
// caller zeroes. work is VG_BACKWARD's size; state is only read.
extern "C" int fused_vg_backward(const float* dy, const float* dde, const float* W,
                                 const float* Wt, float* dx, float* dW, float* db,
                                 const float* state, float* work, const int* meta, long long N,
                                 void* stream) {
  TrunkPlan p;
  if (trunk_plan_from_meta(meta, &p)) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  VGScratch sc;
  vg_scratch_layout(p, N, VG_STATE, &sc);
  vg_scratch_layout(p, N, VG_BACKWARD, &sc);
  cudaStream_t st = (cudaStream_t)stream;
  const int sms = trunk_sm_count();
  const int tile = vg_row_tile(N);
  int err = tile == 64 ? launch_vg_bwd_rows<64>(p, sc, dy, dde, W, Wt, dx, state, work, N, st)
            : tile == 16 ? launch_vg_bwd_rows<16>(p, sc, dy, dde, W, Wt, dx, state, work, N, st)
                         : (int)cudaErrorInvalidDevice;
  if (err) return err;
  // dW_i = c_i^T zbar_i + pbar_i^T u_i, db_i = sum zbar_i: both pairs in one launch
  for (int i = 0; i < p.n; ++i) {
    cudaError_t e = wgrad_launch(state + sc.c[i], work + sc.zb[i], work + sc.pb[i],
                                 state + sc.u[i], N, p.din[i], p.dout[i], sms,
                                 dW + p.woff[i], db + p.boff[i], st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
