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
//   backward - recompute, an ascending sweep through the reverse chain
//              (pbar_i, sbar_i and half of dW), then the descending backward
//              with sigma''(z) * sbar injections -> dx, dW, db.
//
// What differs from the TPU kernels, and why:
//   * Per-row state does not fit on chip. The TPU tile keeps c_i, s_i, u_i
//     and q_i for all layers in VMEM; on the H100 that is ~50 KB per row of
//     the full-width trunk. The row tile's current activations stay in shared
//     memory, and the per-layer state goes to a global scratch buffer that
//     the wrapper allocates (fused_vg_scratch_floats gives its size): s_i only
//     in the forward, c_i, s_i, u_i, q_i, pbar_i and zbar_i in the backward.
//   * Blocks run in parallel, in no order, so dW and db are not accumulated
//     across a sequential grid. The backward's row-tile kernel writes the
//     operands of dW_i = c_i^T zbar_i + pbar_i^T u_i to scratch, and a second
//     kernel reduces them over rows in 32x32 output tiles, each block summing
//     a slice of the rows and adding its partial with fp32 atomicAdd into dW
//     and db, which the wrapper zeroes. The order of those sums changes from
//     run to run.
//   * Rows past the ragged edge are loaded as zeros and never stored, so they
//     add nothing to dW or db.
// Bound on the H100: operations, about 4 * 524,544 (forward) and 12 * 524,544
// (backward) fp32 multiply-adds per row of the full-width trunk, on the CUDA
// cores in fp32.
#include "trunk.cuh"

#define SQRT_HALF 0.70710678118654752f

// Offsets (in floats) of each layer's [N, width] region in the scratch
// buffer; -1 where that array is not stored.
struct VGScratch {
  long long c[TRUNK_MAX_LAYERS];   // layer inputs c_i       [N, din_i]
  long long s[TRUNK_MAX_LAYERS];   // sigma'(z_i), hidden    [N, dout_i]
  long long u[TRUNK_MAX_LAYERS];   // reverse-chain u_i      [N, dout_i]
  long long q[TRUNK_MAX_LAYERS];   // q_i, then sigma''*sbar [N, dh_i]
  long long pb[TRUNK_MAX_LAYERS];  // pbar_i                 [N, din_i]
  long long zb[TRUNK_MAX_LAYERS];  // zbar_i                 [N, dout_i]
};

static long long vg_scratch_layout(const TrunkPlan& p, long long N, int backward, VGScratch* sc) {
  long long off = 0;
  for (int i = 0; i < p.n; ++i) {
    sc->c[i] = sc->u[i] = sc->q[i] = sc->pb[i] = sc->zb[i] = -1;
    sc->s[i] = -1;
    if (i < p.n - 1) { sc->s[i] = off; off += N * p.dout[i]; }
    if (backward) {
      sc->c[i] = off;  off += N * p.din[i];
      sc->u[i] = off;  off += N * p.dout[i];
      sc->q[i] = off;  off += N * p.dh[i];
      sc->pb[i] = off; off += N * p.din[i];
      sc->zb[i] = off; off += N * p.dout[i];
    }
  }
  return off;
}

static __device__ __forceinline__ float* other_buf(float* p, float* a, float* b) {
  return p == a ? b : a;
}

static __device__ __forceinline__ void store_tile(float* scratch, long long off, const float* src,
                                                  int width, long long row0, long long N) {
  if (off >= 0) tile_store_rows(src, TRUNK_MAXW, width, row0, N, scratch + off);
}

// Phases 1 and 2 for one row tile: forward (y into y_out if given), then the
// reverse chain (de into acc, TRUNK_ROWS x TRUNK_MAXD0). Leaves in scratch
// whatever sc asks for.
static __device__ void vg_forward_phases(const TrunkPlan& p, const float* x, const float* W,
                                         const float* Wt, const float* b, long long N,
                                         long long row0, const VGScratch& sc, float* scratch,
                                         float* bufA, float* bufB, float* x0, float* acc,
                                         float* y_out) {
  tile_load_rows(x, p.d0, row0, N, x0, TRUNK_MAXD0);
  tile_load_rows(x, p.d0, row0, N, bufA, TRUNK_MAXW);
  for (int idx = threadIdx.x; idx < TRUNK_ROWS * TRUNK_MAXD0; idx += blockDim.x) acc[idx] = 0.f;
  __syncthreads();

  // phase 1: forward, saving c_i and s_i
  float* h = bufA;
  for (int i = 0; i < p.n; ++i) {
    float* c = tile_layer_input(p, i, h, x0, other_buf(h, bufA, bufB));
    store_tile(scratch, sc.c[i], c, p.din[i], row0, N);
    float* z = other_buf(c, bufA, bufB);
    tile_mm(c, p.din[i], W + p.woff[i], p.dout[i], b + p.boff[i], z);
    __syncthreads();
    if (i < p.n - 1) {
      const int w = p.dout[i];
      for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
        int r = idx / w, j = idx - r * w;
        long long row = row0 + r;
        float zz = z[r * TRUNK_MAXW + j];
        if (row < N) scratch[sc.s[i] + row * w + j] = trunk_act_d1(zz);
        z[r * TRUNK_MAXW + j] = trunk_act(zz);
      }
      __syncthreads();
    } else if (y_out) {
      tile_store_rows(z, TRUNK_MAXW, p.dout[i], row0, N, y_out);
    }
    h = z;
  }
  __syncthreads();

  // phase 2: reverse chain from the one-hot seed on output column 0
  float* u = bufA;
  {
    const int w = p.dout[p.n - 1];
    for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
      int r = idx / w, j = idx - r * w;
      u[r * TRUNK_MAXW + j] = j == 0 ? 1.f : 0.f;
    }
    __syncthreads();
  }
  for (int i = p.n - 1; i >= 0; --i) {
    store_tile(scratch, sc.u[i], u, p.dout[i], row0, N);
    float* pq = other_buf(u, bufA, bufB);
    tile_mm(u, p.dout[i], Wt + p.woff[i], p.din[i], nullptr, pq);  // p_i = u_i W_i^T
    __syncthreads();
    const int w = p.din[i], dh = p.dh[i];
    for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
      int r = idx / w, k = idx - r * w;
      long long row = row0 + r;
      float v = pq[r * TRUNK_MAXW + k];
      if (k >= dh) {  // skip part: de += p_i[d:] / sqrt2
        acc[r * TRUNK_MAXD0 + (k - dh)] += v * SQRT_HALF;
        continue;
      }
      float q = p.skip[i] ? v * SQRT_HALF : v;
      if (sc.q[i] >= 0 && row < N) scratch[sc.q[i] + row * dh + k] = q;
      if (i > 0) {  // u_{i-1} = s_{i-1} * q_i
        float s = row < N ? scratch[sc.s[i - 1] + row * dh + k] : 0.f;
        pq[r * TRUNK_MAXW + k] = s * q;
      } else {
        acc[r * TRUNK_MAXD0 + k] += q;
      }
    }
    __syncthreads();
    u = pq;
  }
}

__global__ void __launch_bounds__(TRUNK_THREADS)
    vg_fwd_kernel(TrunkPlan p, VGScratch sc, const float* __restrict__ x,
                  const float* __restrict__ W, const float* __restrict__ Wt,
                  const float* __restrict__ b, float* __restrict__ y, float* __restrict__ de,
                  float* scratch, long long N) {
  __shared__ float bufA[TRUNK_ROWS * TRUNK_MAXW];
  __shared__ float bufB[TRUNK_ROWS * TRUNK_MAXW];
  __shared__ float x0[TRUNK_ROWS * TRUNK_MAXD0];
  __shared__ float acc[TRUNK_ROWS * TRUNK_MAXD0];
  const long long row0 = (long long)blockIdx.x * TRUNK_ROWS;
  vg_forward_phases(p, x, W, Wt, b, N, row0, sc, scratch, bufA, bufB, x0, acc, y);
  tile_store_rows(acc, TRUNK_MAXD0, p.d0, row0, N, de);
}

// Row-tile part of the backward: recompute (phases 1-2), then the ascending
// and descending sweeps. Writes dx and leaves c_i, zbar_i, pbar_i, u_i in
// scratch for the dW/db reduction.
__global__ void __launch_bounds__(TRUNK_THREADS)
    vg_bwd_rows_kernel(TrunkPlan p, VGScratch sc, const float* __restrict__ x,
                       const float* __restrict__ dy, const float* __restrict__ dde,
                       const float* __restrict__ W, const float* __restrict__ Wt,
                       const float* __restrict__ b, float* __restrict__ dx, float* scratch,
                       long long N) {
  __shared__ float bufA[TRUNK_ROWS * TRUNK_MAXW];
  __shared__ float bufB[TRUNK_ROWS * TRUNK_MAXW];
  __shared__ float x0[TRUNK_ROWS * TRUNK_MAXD0];
  __shared__ float acc[TRUNK_ROWS * TRUNK_MAXD0];
  const long long row0 = (long long)blockIdx.x * TRUNK_ROWS;
  vg_forward_phases(p, x, W, Wt, b, N, row0, sc, scratch, bufA, bufB, x0, acc, nullptr);

  // phase 3, ascending: qbar_0 = dde; qbar_i = s_{i-1} * ubar_{i-1};
  // sbar_{i-1} = q_i * ubar_{i-1}; pbar_i = qbar_i (skip: [qbar, dde] / sqrt2);
  // ubar_i = pbar_i W_i. The q_i slot is overwritten with sigma''(z_{i-1}) * sbar_{i-1}.
  float* ubar = bufA;
  for (int i = 0; i < p.n; ++i) {
    float* pb = other_buf(ubar, bufA, bufB);
    const int w = p.din[i], dh = p.dh[i];
    for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
      int r = idx / w, k = idx - r * w;
      long long row = row0 + r;
      bool ok = row < N;
      float v;
      if (k >= dh) {
        v = (ok ? dde[row * p.d0 + (k - dh)] : 0.f) * SQRT_HALF;
      } else {
        float qbar;
        if (i == 0) {
          qbar = ok ? dde[row * p.d0 + k] : 0.f;
        } else {
          float ub = ubar[r * TRUNK_MAXW + k];
          float s = ok ? scratch[sc.s[i - 1] + row * dh + k] : 0.f;
          qbar = s * ub;
          if (ok) {
            float* qslot = scratch + sc.q[i] + row * dh + k;
            *qslot = trunk_act_d2(s) * (*qslot * ub);
          }
        }
        v = p.skip[i] ? qbar * SQRT_HALF : qbar;
      }
      pb[r * TRUNK_MAXW + k] = v;
    }
    __syncthreads();
    store_tile(scratch, sc.pb[i], pb, w, row0, N);
    if (i < p.n - 1) {
      tile_mm(pb, w, W + p.woff[i], p.dout[i], nullptr, ubar);
      __syncthreads();
    }
  }
  __syncthreads();

  // phase 4, descending: zbar_{L-1} = dy; cbar = zbar_i W_i^T;
  // zbar_{i-1} = s_{i-1} * abar + sigma''(z_{i-1}) * sbar_{i-1}
  for (int idx = threadIdx.x; idx < TRUNK_ROWS * TRUNK_MAXD0; idx += blockDim.x) acc[idx] = 0.f;
  float* zbar = bufA;
  tile_load_rows(dy, p.dout[p.n - 1], row0, N, zbar, TRUNK_MAXW);
  __syncthreads();
  for (int i = p.n - 1; i >= 0; --i) {
    store_tile(scratch, sc.zb[i], zbar, p.dout[i], row0, N);
    float* cb = other_buf(zbar, bufA, bufB);
    tile_mm(zbar, p.dout[i], Wt + p.woff[i], p.din[i], nullptr, cb);
    __syncthreads();
    const int w = p.din[i], dh = p.dh[i];
    for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
      int r = idx / w, k = idx - r * w;
      long long row = row0 + r;
      float v = cb[r * TRUNK_MAXW + k];
      if (k >= dh) {
        acc[r * TRUNK_MAXD0 + (k - dh)] += v * SQRT_HALF;
        continue;
      }
      float a = p.skip[i] ? v * SQRT_HALF : v;
      if (i > 0) {
        bool ok = row < N;
        float s = ok ? scratch[sc.s[i - 1] + row * dh + k] : 0.f;
        float t = ok ? scratch[sc.q[i] + row * dh + k] : 0.f;
        cb[r * TRUNK_MAXW + k] = s * a + t;
      } else {
        acc[r * TRUNK_MAXD0 + k] += a;
      }
    }
    __syncthreads();
    zbar = cb;
  }
  tile_store_rows(acc, TRUNK_MAXD0, p.d0, row0, N, dx);
}

#define RED_TILE 32
#define RED_CHUNK 32
#define RED_ROWS_PER_BLOCK 1024

// dW[k][j] += sum_r A1[r][k] B1[r][j] + A2[r][k] B2[r][j]; db[j] += sum_r B1[r][j],
// over this block's slice of rows. A* are [N, K], B* are [N, J].
__global__ void __launch_bounds__(256)
    vg_reduce_kernel(const float* __restrict__ A1, const float* __restrict__ B1,
                     const float* __restrict__ A2, const float* __restrict__ B2, long long N,
                     int K, int J, float* __restrict__ dW, float* __restrict__ db) {
  __shared__ float sa[RED_CHUNK][RED_TILE + 1];
  __shared__ float sb[RED_CHUNK][RED_TILE + 1];
  const int k0 = blockIdx.x * RED_TILE, j0 = blockIdx.y * RED_TILE;
  const long long r0 = (long long)blockIdx.z * RED_ROWS_PER_BLOCK;
  const long long r1 = min(N, r0 + RED_ROWS_PER_BLOCK);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;  // 8 warps; warp ty owns k0+ty+8m
  float accw[4] = {0.f, 0.f, 0.f, 0.f};
  float accb = 0.f;
  const bool do_db = blockIdx.x == 0 && ty == 0;
  for (int pass = 0; pass < 2; ++pass) {
    const float* A = pass ? A2 : A1;
    const float* B = pass ? B2 : B1;
    for (long long rb = r0; rb < r1; rb += RED_CHUNK) {
      for (int idx = threadIdx.x; idx < RED_CHUNK * RED_TILE; idx += blockDim.x) {
        int rr = idx / RED_TILE, cc = idx % RED_TILE;
        long long r = rb + rr;
        sa[rr][cc] = (r < r1 && k0 + cc < K) ? A[r * K + k0 + cc] : 0.f;
        sb[rr][cc] = (r < r1 && j0 + cc < J) ? B[r * J + j0 + cc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int rr = 0; rr < RED_CHUNK; ++rr) {
        float bv = sb[rr][tx];
#pragma unroll
        for (int m = 0; m < 4; ++m) accw[m] = fmaf(sa[rr][ty + 8 * m], bv, accw[m]);
        if (pass == 0 && do_db) accb += bv;
      }
      __syncthreads();
    }
  }
  const int j = j0 + tx;
  if (j < J) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      int k = k0 + ty + 8 * m;
      if (k < K) atomicAdd(&dW[(size_t)k * J + j], accw[m]);
    }
    if (do_db) atomicAdd(&db[j], accb);
  }
}

extern "C" const char* trunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Floats of scratch the forward (backward = 0) or backward (1) needs for N rows,
// or -1 if the plan does not fit the kernels.
extern "C" long long fused_vg_scratch_floats(const int* meta, long long N, int backward) {
  TrunkPlan p;
  if (trunk_plan_from_meta(meta, &p)) return -1;
  VGScratch sc;
  return vg_scratch_layout(p, N, backward, &sc);
}

// x [N, d0] -> y [N, dout_last], de [N, d0].
extern "C" int fused_vg_forward(const float* x, const float* W, const float* Wt, const float* b,
                                float* y, float* de, float* scratch, const int* meta, long long N,
                                void* stream) {
  TrunkPlan p;
  if (trunk_plan_from_meta(meta, &p)) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  VGScratch sc;
  vg_scratch_layout(p, N, 0, &sc);
  const long long blocks = (N + TRUNK_ROWS - 1) / TRUNK_ROWS;
  vg_fwd_kernel<<<(unsigned)blocks, TRUNK_THREADS, 0, (cudaStream_t)stream>>>(p, sc, x, W, Wt, b,
                                                                             y, de, scratch, N);
  return (int)cudaGetLastError();
}

// (dy [N, dout_last], dde [N, d0]) -> dx [N, d0], and dW, db added into the
// flat buffers, which the caller zeroes.
extern "C" int fused_vg_backward(const float* x, const float* dy, const float* dde,
                                 const float* W, const float* Wt, const float* b, float* dx,
                                 float* dW, float* db, float* scratch, const int* meta,
                                 long long N, void* stream) {
  TrunkPlan p;
  if (trunk_plan_from_meta(meta, &p)) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  VGScratch sc;
  vg_scratch_layout(p, N, 1, &sc);
  cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (N + TRUNK_ROWS - 1) / TRUNK_ROWS;
  vg_bwd_rows_kernel<<<(unsigned)blocks, TRUNK_THREADS, 0, st>>>(p, sc, x, dy, dde, W, Wt, b, dx,
                                                                 scratch, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned splits = (unsigned)((N + RED_ROWS_PER_BLOCK - 1) / RED_ROWS_PER_BLOCK);
  for (int i = 0; i < p.n; ++i) {
    const int K = p.din[i], J = p.dout[i];
    dim3 grid((K + RED_TILE - 1) / RED_TILE, (J + RED_TILE - 1) / RED_TILE, splits);
    vg_reduce_kernel<<<grid, 256, 0, st>>>(scratch + sc.c[i], scratch + sc.zb[i],
                                           scratch + sc.pb[i], scratch + sc.u[i], N, K, J,
                                           dW + p.woff[i], db + p.boff[i]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
