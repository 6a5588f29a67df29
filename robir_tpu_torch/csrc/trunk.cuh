// Shared device code for the SDF-trunk kernels (fused_mlp.cu, fused_value_grad.cu).
//
// The trunk is a stack of dense layers z_i = c_i W_i + b_i, where c_i is the
// previous activation, or at a skip layer concat([h, x0]) / sqrt(2). Hidden
// layers apply softplus with beta 100 (the SDF trunk's only activation; the
// wrappers refuse any other); the last layer has none. The plan below carries the per-layer widths; weights
// arrive pre-folded (weight norm is applied in PyTorch) as one flat fp32
// buffer of row-major [in, out] blocks, and their transposes as a second
// flat buffer of [out, in] blocks at the same offsets.
//
// One thread block owns a tile of TRUNK_ROWS rows. The tile's activations
// live in shared memory; each layer's weights are streamed from global
// memory (all 2.1 MB of the full-width SDF trunk, 8.4 MB of a 512-wide one,
// stay in the 50 MB L2), one weight load feeding TRUNK_ROWS fused
// multiply-adds. Arithmetic is fp32 on the CUDA cores.
//
// The widest layer is a compile-time parameter (LD, the row stride of the
// tile buffers) of the helpers below: TRUNK_MAXW (264) serves the SDF
// trunk and is what K3 and K4 use; TRUNK_MAXW_WIDE (520) serves the
// 512-wide CESR trunks in K1 and K2, whose tiles need dynamic shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TRUNK_MAX_LAYERS 16
#define TRUNK_ROWS 16      // rows per block tile
#define TRUNK_THREADS 256  // threads per block
#define TRUNK_MAXW 264     // widest layer input or output (>= 257), padded
#define TRUNK_MAXW_WIDE 520  // the same for the 512-wide trunks (K1, K2 only)
#define TRUNK_MAXD0 64     // widest trunk input (63 for PE with 10 bands)

struct TrunkPlan {
  int n;   // number of layers
  int d0;  // input width
  int din[TRUNK_MAX_LAYERS];   // layer input width, skip concat included
  int dout[TRUNK_MAX_LAYERS];  // layer output width
  int dh[TRUNK_MAX_LAYERS];    // width of the trunk part of the input
  int skip[TRUNK_MAX_LAYERS];  // 1 where the input is concat([h, x0]) / sqrt(2)
  long long woff[TRUNK_MAX_LAYERS];  // offset of W_i (and of W_i^T) in the flat buffers
  int boff[TRUNK_MAX_LAYERS];        // offset of b_i in the flat bias buffer
};

// meta = [n, d0, then for each layer: din, dout, dh, skip].
// Returns 0, or 1 if the plan does not fit the kernels' fixed limits
// (layers at most maxw wide).
static inline int trunk_plan_from_meta(const int* meta, TrunkPlan* p,
                                       int maxw = TRUNK_MAXW) {
  p->n = meta[0];
  p->d0 = meta[1];
  if (p->n < 1 || p->n > TRUNK_MAX_LAYERS || p->d0 < 1 || p->d0 > TRUNK_MAXD0) return 1;
  if (meta[2] != p->d0) return 1;  // layer 0 reads the input itself
  long long w = 0;
  int b = 0;
  for (int i = 0; i < p->n; ++i) {
    p->din[i] = meta[2 + 4 * i];
    p->dout[i] = meta[3 + 4 * i];
    p->dh[i] = meta[4 + 4 * i];
    p->skip[i] = meta[5 + 4 * i];
    if (p->din[i] < 1 || p->din[i] > maxw || p->dout[i] < 1 || p->dout[i] > maxw) return 1;
    if (p->dh[i] < 1 || p->dh[i] > p->din[i] || (!p->skip[i] && p->dh[i] != p->din[i]) ||
        (p->skip[i] && (i == 0 || p->din[i] - p->dh[i] != p->d0)))
      return 1;
    if (i > 0 && p->dh[i] != p->dout[i - 1]) return 1;
    p->woff[i] = w;
    p->boff[i] = b;
    w += (long long)p->din[i] * p->dout[i];
    b += p->dout[i];
  }
  return 0;
}

// sigma(z) = softplus(100 z) / 100 in the stable form max(t, 0) + log1p(exp(-|t|))
__device__ __forceinline__ float trunk_act(float z) {
  float t = 100.f * z;
  return 0.01f * (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t))));
}

// sigma'(z)
__device__ __forceinline__ float trunk_act_d1(float z) { return 1.f / (1.f + expf(-100.f * z)); }

// sigma''(z), expressed through s = sigma'(z)
__device__ __forceinline__ float trunk_act_d2(float s) { return 100.f * s * (1.f - s); }

// out[r][j] = sum_k in[r][k] * M[k * ncols + j] (+ bias[j]) for the tile's rows.
// `in` and `out` are distinct shared buffers of TRUNK_ROWS x LD; M is
// row-major [nk, ncols] in global memory. Each thread owns whole columns, so
// a warp reads 32 neighbouring weights per k. The caller synchronises after.
template <int LD = TRUNK_MAXW>
__device__ __forceinline__ void tile_mm(const float* in, int nk, const float* __restrict__ M,
                                        int ncols, const float* __restrict__ bias, float* out) {
  for (int j = threadIdx.x; j < ncols; j += blockDim.x) {
    float acc[TRUNK_ROWS];
#pragma unroll
    for (int r = 0; r < TRUNK_ROWS; ++r) acc[r] = 0.f;
    const float* mj = M + j;
    for (int k = 0; k < nk; ++k) {
      float w = __ldg(mj + (size_t)k * ncols);
#pragma unroll
      for (int r = 0; r < TRUNK_ROWS; ++r) acc[r] = fmaf(in[r * LD + k], w, acc[r]);
    }
    float b = bias ? bias[j] : 0.f;
#pragma unroll
    for (int r = 0; r < TRUNK_ROWS; ++r) out[r * LD + j] = acc[r] + b;
  }
}

// Load the tile's input rows into x0 (zeros past the ragged edge).
__device__ __forceinline__ void tile_load_rows(const float* __restrict__ src, int width,
                                               long long row0, long long nrows, float* dst,
                                               int ld) {
  for (int idx = threadIdx.x; idx < TRUNK_ROWS * width; idx += blockDim.x) {
    int r = idx / width, k = idx - r * width;
    long long row = row0 + r;
    dst[r * ld + k] = row < nrows ? src[row * width + k] : 0.f;
  }
}

// Store the tile's valid rows of a shared buffer to a global [nrows, width] array.
__device__ __forceinline__ void tile_store_rows(const float* src, int ld, int width,
                                                long long row0, long long nrows, float* dst) {
  for (int idx = threadIdx.x; idx < TRUNK_ROWS * width; idx += blockDim.x) {
    int r = idx / width, k = idx - r * width;
    long long row = row0 + r;
    if (row < nrows) dst[row * width + k] = src[r * ld + k];
  }
}

// If layer i is a skip layer, rebuild the tile's layer input as
// concat([h, x0]) / sqrt(2) in `dst` and return it; otherwise return h.
template <int LD = TRUNK_MAXW>
__device__ __forceinline__ float* tile_layer_input(const TrunkPlan& p, int i, float* h,
                                                   const float* x0, float* dst) {
  if (!p.skip[i]) return h;
  const float s2 = 0.70710678118654752f;
  int dh = p.dh[i], w = p.din[i];
  for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
    int r = idx / w, k = idx - r * w;
    dst[r * LD + k] = (k < dh ? h[r * LD + k] : x0[r * TRUNK_MAXD0 + (k - dh)]) * s2;
  }
  __syncthreads();
  return dst;
}
