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
// One thread block owns a tile of rows (TRUNK_ROWS in K1 and K2; 16 or 64
// in K3 and K4). The tile's activations live in shared memory; each layer's
// weights come from global memory (all 2.1 MB of the full-width SDF trunk,
// 8.4 MB of a 512-wide one, stay in the 50 MB L2). Arithmetic is fp32 on
// the CUDA cores. K1 and K2 multiply with tile_mm, one L2 weight load
// feeding TRUNK_ROWS fused multiply-adds; K3 and K4 with rt_mm (below),
// register tiles fed from weight slabs staged in shared memory.
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
template <int LD = TRUNK_MAXW, int ROWS = TRUNK_ROWS>
__device__ __forceinline__ float* tile_layer_input(const TrunkPlan& p, int i, float* h,
                                                   const float* x0, float* dst) {
  if (!p.skip[i]) return h;
  const float s2 = 0.70710678118654752f;
  int dh = p.dh[i], w = p.din[i];
  for (int idx = threadIdx.x; idx < ROWS * w; idx += blockDim.x) {
    int r = idx / w, k = idx - r * w;
    dst[r * LD + k] = (k < dh ? h[r * LD + k] : x0[r * TRUNK_MAXD0 + (k - dh)]) * s2;
  }
  __syncthreads();
  return dst;
}

// Dynamic shared memory of a kernel instance, after raising its limit.
template <typename Kern>
static cudaError_t allow_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The SM count of the current device, or 0 on error.
static int trunk_sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// ---------------------------------------------------------------------------
// The register-tiled row-tile product of K3 and K4 (rt_mm). K1 and K2 keep
// tile_mm: their 520-wide builds leave no room for a tall row tile.
//
// tile_mm gives each weight load TRUNK_ROWS multiply-adds and feeds every
// multiply-add with a scalar shared load. rt_mm instead
//   * keeps an R/8 x 8 register tile of the R x 256 output per thread, so
//     a float4 of activations (4 k of one row, one address across the warp)
//     and two float4 of weights (8 columns of one k) feed 4 x R/8 x 8 and
//     R/8 x 8 multiply-adds: at R = 64, 16 shared loads per 256;
//   * stages the weights in shared memory in k-slabs of RT_SLAB_K rows, in
//     a ring of three filled by cp.async (16-byte copies where a layer's
//     rows are 16-byte aligned, else 4-byte), so that the next two slabs'
//     copies run under this slab's multiply-adds, with one barrier a slab.
//     Reading the weights straight through L1 instead was faster for the
//     product alone but slower inside K4.
// Columns past 256 (the SDF trunk's 257th output, at most 8) are summed by
// short k-slices per thread from the same slabs and reduced by shuffles.
// Where a layer has at most 128 outputs, the upper half of each register
// tile is skipped. That choice is a template parameter and full slabs take
// an unrolled path, so that no branch splits the multiply-add loop, and the
// body is compiled out of line (one copy per R and choice, shared by the
// kernel's call sites): each measured faster than the alternative.
#define RT_SLAB_K 16            // k rows per weight slab
#define RT_SLAB_STAGES 3        // slabs in flight or in use
#define RT_SLAB_LD TRUNK_MAXW   // a slab's row stride, in floats
#define RT_COLS 256             // columns of the register tiles: 32 lanes x 8
#define RT_EXTRA (TRUNK_MAXW - RT_COLS)  // most columns past them

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Stage rows k0 .. k0 + RT_SLAB_K - 1 of M ([nk, ncols], row-major, global)
// into slab ([RT_SLAB_K][RT_SLAB_LD], shared) as one cp.async group. Rows
// past nk are zero-filled (src-size 0), so they add nothing to the sums.
__device__ __forceinline__ void rt_load_slab(const float* __restrict__ M, int nk, int ncols,
                                             bool vec, int k0, float* slab) {
  if (vec) {
    const int q = ncols >> 2;
    for (int idx = threadIdx.x; idx < RT_SLAB_K * q; idx += TRUNK_THREADS) {
      const int kk = idx / q, c = (idx - kk * q) << 2;
      const bool ok = k0 + kk < nk;
      cp_async16(slab + kk * RT_SLAB_LD + c, ok ? M + (size_t)(k0 + kk) * ncols + c : M,
                 ok ? 16 : 0);
    }
  } else {
    for (int kk = 0; kk < RT_SLAB_K; ++kk) {
      const bool ok = k0 + kk < nk;
      const float* row = M + (size_t)(k0 + kk) * ncols;
      for (int c = threadIdx.x; c < ncols; c += TRUNK_THREADS)
        cp_async4(slab + kk * RT_SLAB_LD + c, ok ? row + c : M, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// acc += in[rows r0 .. r0 + TM - 1][k0 + 4q .. k0 + 4q + 3] x the slab's rows
// 4q .. 4q + 3 at this lane's columns (only the lower half without HI).
template <int TM, bool HI>
__device__ __forceinline__ void rt_quad(const float* in, int r0, int k0, int q, const float* w,
                                        int lane, float (&acc)[TM][8]) {
  float4 a[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m)
    a[m] = *reinterpret_cast<const float4*>(in + (r0 + m) * TRUNK_MAXW + k0 + 4 * q);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* wr = w + (4 * q + kk) * RT_SLAB_LD;
    const float4 w0 = *reinterpret_cast<const float4*>(wr + 4 * lane);
    if (HI) {
      const float4 w1 = *reinterpret_cast<const float4*>(wr + 128 + 4 * lane);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const float av = kk == 0 ? a[m].x : kk == 1 ? a[m].y : kk == 2 ? a[m].z : a[m].w;
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(av, wv[n], acc[m][n]);
      }
    } else {  // no column of the upper half exists
      const float wv[4] = {w0.x, w0.y, w0.z, w0.w};
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const float av = kk == 0 ? a[m].x : kk == 1 ? a[m].y : kk == 2 ? a[m].z : a[m].w;
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(av, wv[n], acc[m][n]);
      }
    }
  }
}

// The body of rt_mm (below) for one half-tile choice.
template <int R, bool HI>
__device__ __noinline__ void rt_mm_body(const float* in, int nk, const float* __restrict__ M,
                                        int ncols, const float* __restrict__ bias, float* out,
                                        float* slabs) {
  static_assert(TRUNK_THREADS == 256 && (R == 16 || R == 64), "rt_mm: 256 threads, R 16 or 64");
  static_assert(RT_SLAB_STAGES == 3, "rt_mm: a ring of three slabs, two copies ahead");
  constexpr int TM = R / 8;                     // rows per thread
  constexpr int TPR = TRUNK_THREADS / R;        // threads per row for the extra columns
  constexpr int KPT = RT_SLAB_K / TPR;          // their k per thread and slab
  constexpr int SLAB = RT_SLAB_K * RT_SLAB_LD;  // floats per slab
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * TM;
  const int er = threadIdx.x / TPR, ek = (threadIdx.x % TPR) * KPT;
  const int n_extra = ncols - RT_COLS;
  const bool vec = (ncols & 3) == 0 && (reinterpret_cast<uintptr_t>(M) & 15) == 0;
  float acc[TM][8];
  float eacc[RT_EXTRA];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < RT_EXTRA; ++e) eacc[e] = 0.f;

  const int nslab = (nk + RT_SLAB_K - 1) / RT_SLAB_K;
  rt_load_slab(M, nk, ncols, vec, 0, slabs);
  if (nslab > 1) rt_load_slab(M, nk, ncols, vec, RT_SLAB_K, slabs + SLAB);
  for (int s = 0; s < nslab; ++s) {
    if (s + 1 < nslab) {
      cp_async_wait<1>();  // slab s has landed; s + 1 may still be in flight
    } else {
      cp_async_wait<0>();
    }
    // slab s is visible to all, and every thread is done with slab s - 1,
    // whose buffer the copy of slab s + 2 now refills
    __syncthreads();
    if (s + 2 < nslab)
      rt_load_slab(M, nk, ncols, vec, (s + 2) * RT_SLAB_K,
                   slabs + ((s + 2) % RT_SLAB_STAGES) * SLAB);
    const float* w = slabs + (s % RT_SLAB_STAGES) * SLAB;
    const int k0 = s * RT_SLAB_K;
    const int nq = min(RT_SLAB_K / 4, (nk - k0 + 3) >> 2);  // k quads holding a k < nk
    if (nq == RT_SLAB_K / 4) {  // a full slab: unrolled, so loads run ahead of the FMAs
#pragma unroll
      for (int q = 0; q < RT_SLAB_K / 4; ++q) rt_quad<TM, HI>(in, r0, k0, q, w, lane, acc);
    } else {
#pragma unroll 1
      for (int q = 0; q < nq; ++q) rt_quad<TM, HI>(in, r0, k0, q, w, lane, acc);
    }
    if (n_extra > 0) {
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const int k = k0 + ek + u;
        if (k < nk) {
          const float av = in[er * TRUNK_MAXW + k];
          const float* wr = w + (ek + u) * RT_SLAB_LD + RT_COLS;
#pragma unroll
          for (int e = 0; e < RT_EXTRA; ++e)
            if (e < n_extra) eacc[e] = fmaf(av, wr[e], eacc[e]);
        }
      }
    }
  }

  float bv[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int j = (n < 4 ? 0 : 128) + 4 * lane + (n & 3);
    bv[n] = bias != nullptr && j < ncols ? bias[j] : 0.f;
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    float* o = out + (r0 + m) * TRUNK_MAXW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = h * 128 + 4 * lane;
      const float* v = &acc[m][4 * h];
      const float* b4 = &bv[4 * h];
      if (j + 3 < ncols) {
        *reinterpret_cast<float4*>(o + j) =
            make_float4(v[0] + b4[0], v[1] + b4[1], v[2] + b4[2], v[3] + b4[3]);
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (j + n < ncols) o[j + n] = v[n] + b4[n];
      }
    }
  }
  if (n_extra > 0) {
#pragma unroll
    for (int e = 0; e < RT_EXTRA; ++e) {
      float v = eacc[e];
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (e < n_extra && threadIdx.x % TPR == 0)
        out[er * TRUNK_MAXW + RT_COLS + e] = v + (bias != nullptr ? bias[RT_COLS + e] : 0.f);
    }
  }
}

// out[r][j] = sum_k in[r][k] * M[k * ncols + j] (+ bias[j]) for a tile of R
// rows (16 or 64). `in` and `out` are distinct shared [R][TRUNK_MAXW]
// buffers whose entries past the written widths hold zeros or earlier
// finite values (the kernels zero their shared memory at start); M is
// row-major [nk, ncols] in global memory; `slabs` is RT_SLAB_STAGES x
// RT_SLAB_K x RT_SLAB_LD shared floats. Warp w owns rows w*R/8 ..
// w*R/8 + R/8 - 1; lane l owns columns 4l .. 4l+3 and 128+4l .. 128+4l+3.
// Every thread of the block calls; the caller synchronises before (in
// written) and after (out read, and before the next call refills slabs).
template <int R>
__device__ __forceinline__ void rt_mm(const float* in, int nk, const float* __restrict__ M,
                                      int ncols, const float* __restrict__ bias, float* out,
                                      float* slabs) {
  if (ncols > 128)  // a column in 128 .. 255: the upper half of the register tile is live
    rt_mm_body<R, true>(in, nk, M, ncols, bias, out, slabs);
  else
    rt_mm_body<R, false>(in, nk, M, ncols, bias, out, slabs);
}
