// Dense trunk (concat-skip, softplus beta 100) for a batch of rows: the
// forward (K1) and its recompute backward (K2), all layers in one kernel.
//
// K1 replaces robir_tpu/render/pallas/fused_mlp.py:_fwd_kernel (launched by
// _fused_forward, pallas_call at :143). Each block owns TRUNK_ROWS rows and
// carries their activations through every layer in shared memory, so device
// memory sees only the input rows, the output rows and the weights (read
// from L2). Bound on the H100: operations, 2 multiply-adds' worth of FLOPs
// per weight per row (2 * 524,544 for the SDF trunk, 2 * 1,836,544 for the
// 512-wide CESR normal net) against well under 3 KB in and out per row; the
// kernel runs them on the CUDA cores in fp32, one L2 weight load feeding
// TRUNK_ROWS fused multiply-adds.
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
// trunk, TRUNK_MAXW_WIDE (520) for the 512-wide nets, whose two 16 x 520
// fp32 tiles (66.5 KB) need dynamic shared memory above the 48 KB default.
// Both keep tile_mm, whose scalar shared loads (one per multiply-add) set
// their pace, rather than K3/K4's register-tiled rt_mm: a 64-row pair of
// 520-wide tiles (266 KB) does not fit in a block's 227 KB.
#include "wgrad.cuh"

#define SQRT_HALF 0.70710678118654752f

static __device__ __forceinline__ float* other_buf(float* p, float* a, float* b) {
  return p == a ? b : a;
}

// K1: x [N, d0] -> y [N, dout_last].
template <int MAXW>
__global__ void __launch_bounds__(TRUNK_THREADS)
    fused_mlp_fwd_kernel(TrunkPlan p, const float* __restrict__ x, const float* __restrict__ W,
                         const float* __restrict__ b, float* __restrict__ y, long long N) {
  extern __shared__ float smem[];
  float* bufA = smem;
  float* bufB = bufA + TRUNK_ROWS * MAXW;
  float* x0 = bufB + TRUNK_ROWS * MAXW;
  const long long row0 = (long long)blockIdx.x * TRUNK_ROWS;

  tile_load_rows(x, p.d0, row0, N, x0, TRUNK_MAXD0);
  tile_load_rows(x, p.d0, row0, N, bufA, MAXW);
  __syncthreads();

  float* h = bufA;
  for (int i = 0; i < p.n; ++i) {
    float* c = tile_layer_input<MAXW>(p, i, h, x0, other_buf(h, bufA, bufB));
    float* z = other_buf(c, bufA, bufB);
    tile_mm<MAXW>(c, p.din[i], W + p.woff[i], p.dout[i], b + p.boff[i], z);
    __syncthreads();
    if (i < p.n - 1) {
      const int w = p.dout[i];
      for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
        int r = idx / w, j = idx - r * w;
        z[r * MAXW + j] = trunk_act(z[r * MAXW + j]);
      }
      __syncthreads();
    }
    h = z;
  }
  tile_store_rows(h, MAXW, p.dout[p.n - 1], row0, N, y);
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

// K2, row-tile part: recompute the forward (saving c_i and sigma'(z_i)),
// then walk the layers backwards from dy, leaving g_i in scratch and writing
// dx (skipped when dx is null: then layer 0's transposed product is not
// needed at all).
template <int MAXW>
__global__ void __launch_bounds__(TRUNK_THREADS)
    mlp_bwd_rows_kernel(TrunkPlan p, BwdScratch sc, const float* __restrict__ x,
                        const float* __restrict__ dy, const float* __restrict__ W,
                        const float* __restrict__ Wt, const float* __restrict__ b,
                        float* __restrict__ dx, float* scratch, long long N) {
  extern __shared__ float smem[];
  float* bufA = smem;
  float* bufB = bufA + TRUNK_ROWS * MAXW;
  float* x0 = bufB + TRUNK_ROWS * MAXW;
  float* acc = x0 + TRUNK_ROWS * TRUNK_MAXD0;  // dx of the tile
  const long long row0 = (long long)blockIdx.x * TRUNK_ROWS;

  tile_load_rows(x, p.d0, row0, N, x0, TRUNK_MAXD0);
  tile_load_rows(x, p.d0, row0, N, bufA, MAXW);
  for (int idx = threadIdx.x; idx < TRUNK_ROWS * TRUNK_MAXD0; idx += blockDim.x) acc[idx] = 0.f;
  __syncthreads();

  // recompute: c_i and sigma'(z_i) to scratch
  float* h = bufA;
  for (int i = 0; i < p.n; ++i) {
    float* c = tile_layer_input<MAXW>(p, i, h, x0, other_buf(h, bufA, bufB));
    tile_store_rows(c, MAXW, p.din[i], row0, N, scratch + sc.c[i]);
    float* z = other_buf(c, bufA, bufB);
    tile_mm<MAXW>(c, p.din[i], W + p.woff[i], p.dout[i], b + p.boff[i], z);
    __syncthreads();
    if (i < p.n - 1) {
      const int w = p.dout[i];
      float* s = scratch + sc.g[i];
      for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
        int r = idx / w, j = idx - r * w;
        long long row = row0 + r;
        float zz = z[r * MAXW + j];
        if (row < N) s[row * w + j] = trunk_act_d1(zz);
        z[r * MAXW + j] = trunk_act(zz);
      }
      __syncthreads();
    }
    h = z;
  }

  // backward: g_{n-1} = dy (the last layer has no activation)
  float* g = bufA;
  tile_load_rows(dy, p.dout[p.n - 1], row0, N, g, MAXW);
  __syncthreads();
  for (int i = p.n - 1; i >= 0; --i) {
    tile_store_rows(g, MAXW, p.dout[i], row0, N, scratch + sc.g[i]);
    if (i == 0 && dx == nullptr) break;
    float* cb = other_buf(g, bufA, bufB);
    tile_mm<MAXW>(g, p.dout[i], Wt + p.woff[i], p.din[i], nullptr, cb);  // dL/dc_i
    __syncthreads();
    const int w = p.din[i], dh = p.dh[i];
    const float* s = i > 0 ? scratch + sc.g[i - 1] : nullptr;  // sigma'(z_{i-1}) [N, dh]
    for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
      int r = idx / w, k = idx - r * w;
      long long row = row0 + r;
      float v = cb[r * MAXW + k];
      if (k >= dh) {  // the x0 half of a skip input: to dx
        acc[r * TRUNK_MAXD0 + (k - dh)] += v * SQRT_HALF;
        continue;
      }
      float a = p.skip[i] ? v * SQRT_HALF : v;
      if (i > 0) {
        cb[r * MAXW + k] = (row < N ? s[row * dh + k] : 0.f) * a;
      } else {
        acc[r * TRUNK_MAXD0 + k] += a;
      }
    }
    __syncthreads();
    g = cb;
  }
  if (dx != nullptr) tile_store_rows(acc, TRUNK_MAXD0, p.d0, row0, N, dx);
}

// The narrowest instantiation that holds the plan, or 0 if none does.
static int plan_width(const int* meta, TrunkPlan* p) {
  if (!trunk_plan_from_meta(meta, p, TRUNK_MAXW)) return TRUNK_MAXW;
  if (!trunk_plan_from_meta(meta, p, TRUNK_MAXW_WIDE)) return TRUNK_MAXW_WIDE;
  return 0;
}

template <int MAXW>
static int launch_forward(const TrunkPlan& p, const float* x, const float* W, const float* b,
                          float* y, long long N, cudaStream_t st) {
  const size_t smem = sizeof(float) * (2 * TRUNK_ROWS * MAXW + TRUNK_ROWS * TRUNK_MAXD0);
  cudaError_t err = allow_smem(fused_mlp_fwd_kernel<MAXW>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + TRUNK_ROWS - 1) / TRUNK_ROWS;
  fused_mlp_fwd_kernel<MAXW><<<(unsigned)blocks, TRUNK_THREADS, smem, st>>>(p, x, W, b, y, N);
  return (int)cudaGetLastError();
}

template <int MAXW>
static int launch_bwd_rows(const TrunkPlan& p, const BwdScratch& sc, const float* x,
                           const float* dy, const float* W, const float* Wt, const float* b,
                           float* dx, float* scratch, long long N, cudaStream_t st) {
  const size_t smem = sizeof(float) * (2 * TRUNK_ROWS * MAXW + 2 * TRUNK_ROWS * TRUNK_MAXD0);
  cudaError_t err = allow_smem(mlp_bwd_rows_kernel<MAXW>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + TRUNK_ROWS - 1) / TRUNK_ROWS;
  mlp_bwd_rows_kernel<MAXW><<<(unsigned)blocks, TRUNK_THREADS, smem, st>>>(p, sc, x, dy, W, Wt,
                                                                          b, dx, scratch, N);
  return (int)cudaGetLastError();
}

extern "C" const char* trunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1: x [N, d0] -> y [N, dout_last]; W and b are the flat folded weights and biases.
extern "C" int fused_mlp_forward(const float* x, const float* W, const float* b, float* y,
                                 const int* meta, long long N, void* stream) {
  TrunkPlan p;
  const int width = plan_width(meta, &p);
  if (!width) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return width == TRUNK_MAXW ? launch_forward<TRUNK_MAXW>(p, x, W, b, y, N, st)
                             : launch_forward<TRUNK_MAXW_WIDE>(p, x, W, b, y, N, st);
}

// Floats of scratch K2 needs for N rows, or -1 if the plan does not fit.
extern "C" long long fused_mlp_bwd_scratch_floats(const int* meta, long long N) {
  TrunkPlan p;
  if (!plan_width(meta, &p)) return -1;
  BwdScratch sc;
  return bwd_scratch_layout(p, N, &sc);
}

// K2: dy [N, dout_last] -> dx [N, d0] (unless dx is null), and dW, db added
// into the flat buffers, which the caller zeroes.
extern "C" int fused_mlp_backward(const float* x, const float* dy, const float* W,
                                  const float* Wt, const float* b, float* dx, float* dW,
                                  float* db, float* scratch, const int* meta, long long N,
                                  void* stream) {
  TrunkPlan p;
  const int width = plan_width(meta, &p);
  if (!width) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  BwdScratch sc;
  bwd_scratch_layout(p, N, &sc);
  cudaStream_t st = (cudaStream_t)stream;
  int err = width == TRUNK_MAXW
                ? launch_bwd_rows<TRUNK_MAXW>(p, sc, x, dy, W, Wt, b, dx, scratch, N, st)
                : launch_bwd_rows<TRUNK_MAXW_WIDE>(p, sc, x, dy, W, Wt, b, dx, scratch, N, st);
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
