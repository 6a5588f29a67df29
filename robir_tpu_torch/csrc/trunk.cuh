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
// A thread block owns a tile of rows (TRUNK_ROWS in K1 and K2; 16 or 64 in
// K3 and K4), or, in K1 and K2 below one tile per SM, a cluster of blocks
// shares a tile and splits each layer's columns. The tile's activations
// live in shared memory; each layer's weights come from global memory (all
// 2.1 MB of the full-width SDF trunk, 8.4 MB of a 512-wide one, stay in the
// 50 MB L2). Arithmetic is fp32 on the CUDA cores, through rt_mm (below):
// register tiles fed from weight slabs staged in shared memory, over the
// whole layer or over a window of its columns. K1 from one tile per SM on
// multiplies with tile_mm: a column per thread, weights read through L1.
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
// The register-tiled row-tile product of all four kernels (rt_mm).
//
// tile_mm gives each weight load TRUNK_ROWS multiply-adds and feeds every
// multiply-add with a scalar shared load. rt_mm instead
//   * keeps a TM x 8 (or TM x 4) register tile of the R x 256 output per
//     thread, so a float4 of activations (4 k of one row, one address
//     across the warp) and 8 (or 4) weights of one k feed TM x 8 (or 4)
//     multiply-adds: at R = 64, TM = 8, 16 shared loads per 256;
//   * stages the weights in shared memory in k-slabs of RT_SLAB_K rows, in
//     a ring of three filled by cp.async (16-byte copies where a layer's
//     rows are 16-byte aligned, else 4-byte copies spread over all
//     threads), so that the next two slabs' copies run under this slab's
//     multiply-adds, with one barrier a slab. Reading the
//     weights straight through L1 instead was faster for the product alone
//     but slower inside K4.
// Columns past the register tile (at most RT_EXTRA: the SDF trunk's 257th
// output, or the 129th of a 129-column window) are summed by short k-slices
// per thread from the same slabs and reduced by shuffles. Where a product
// has at most 128 + RT_EXTRA columns, the upper half of each register tile
// is skipped. That choice is a template parameter and full slabs take an
// unrolled path, so that no branch splits the multiply-add loop, and the
// body is compiled out of line (one copy per R, choice, LD and TM, shared
// by the kernel's call sites): each measured faster than the
// alternative.
//
// A product may cover a window of a wider layer's columns (K1 and K2 split
// a layer's columns across the blocks of a cluster, and a 512-wide layer
// into two windows of 256): M, bias and out then point at the window's
// first column, ldm is M's row stride and ncols the window's width.
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

// Stage rows k0 .. k0 + RT_SLAB_K - 1 of M ([nk, ncols] with row stride
// ldm, global) into slab ([RT_SLAB_K][RT_SLAB_LD], shared) as one cp.async
// group. Rows past nk are zero-filled (src-size 0), so they add nothing to
// the sums. vec: 16-byte copies (ldm, ncols and M's address 16-byte aligned).
__device__ __forceinline__ void rt_load_slab(const float* __restrict__ M, int nk, int ldm,
                                             int ncols, bool vec, int k0, float* slab) {
  if (vec) {
    const int q = ncols >> 2;
    for (int idx = threadIdx.x; idx < RT_SLAB_K * q; idx += TRUNK_THREADS) {
      const int kk = idx / q, c = (idx - kk * q) << 2;
      const bool ok = k0 + kk < nk;
      cp_async16(slab + kk * RT_SLAB_LD + c, ok ? M + (size_t)(k0 + kk) * ldm + c : M,
                 ok ? 16 : 0);
    }
  } else {  // every thread takes its share of the slab, whatever ncols is
    for (int idx = threadIdx.x; idx < RT_SLAB_K * ncols; idx += TRUNK_THREADS) {
      const int kk = idx / ncols, c = idx - kk * ncols;
      const bool ok = k0 + kk < nk;
      cp_async4(slab + kk * RT_SLAB_LD + c, ok ? M + (size_t)(k0 + kk) * ldm + c : M,
                ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// acc += in[rows r0 .. r0 + TM - 1][k0 + 4q .. k0 + 4q + 3] x the slab's rows
// 4q .. 4q + 3 at this thread's TN columns (TN = 8 / CG, halved without HI):
// V-float vectors (V = min(TN, 4)) at col0 + h * 128, h < TN / V.
template <int TM, bool HI, int LD, int CG>
__device__ __forceinline__ void rt_quad(const float* in, int r0, int k0, int q, const float* w,
                                        int col0, float (&acc)[TM][8 / CG]) {
  constexpr int TN = (HI ? 8 : 4) / CG, V = TN < 4 ? TN : 4;
  float4 a[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m)
    a[m] = *reinterpret_cast<const float4*>(in + (r0 + m) * LD + k0 + 4 * q);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* wr = w + (4 * q + kk) * RT_SLAB_LD + col0;
    float wv[TN];
#pragma unroll
    for (int h = 0; h < TN / V; ++h) {
      if constexpr (V == 4) {
        const float4 t = *reinterpret_cast<const float4*>(wr + h * 128);
        wv[4 * h] = t.x, wv[4 * h + 1] = t.y, wv[4 * h + 2] = t.z, wv[4 * h + 3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(wr + h * 128);
        wv[2 * h] = t.x, wv[2 * h + 1] = t.y;
      }
    }
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const float av = kk == 0 ? a[m].x : kk == 1 ? a[m].y : kk == 2 ? a[m].z : a[m].w;
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(av, wv[n], acc[m][n]);
    }
  }
}

// The body of rt_mm (below) for one half-tile choice, row stride, ring and
// register tile. The 8 warps form R / TM row groups of TM rows times CG
// column groups: with TM = R / 8 (K3, K4) each warp spans all 256 columns,
// lane l holding 4l .. 4l+3 and 128+4l .. 128+4l+3; with TM = 4 at R = 16
// (K1, K2) two groups of warps split them, lane l of group g holding
// g*128 + 4l .. +3 (g*64 + 2l, +1 without HI), so each weight read from
// shared memory feeds TM multiply-adds instead of 2.
template <int R, bool HI, int LD, int TM>
__device__ __noinline__ void rt_mm_body(const float* in, int nk, const float* __restrict__ M,
                                        int ldm, int ncols, const float* __restrict__ bias,
                                        float* out, float* slabs) {
  static_assert(TRUNK_THREADS == 256 && (R == 16 || R == 64), "rt_mm: 256 threads, R 16 or 64");
  static_assert(RT_SLAB_STAGES == 3, "rt_mm: a ring of three slabs, two copies ahead");
  constexpr int RG = R / TM, CG = 8 / RG;       // row groups x column groups of warps
  static_assert(RG * CG == 8 && (CG == 1 || CG == 2), "rt_mm: 8 warps, 1 or 2 column groups");
  constexpr int TN = (HI ? 8 : 4) / CG;         // columns per thread
  constexpr int V = TN < 4 ? TN : 4;            // their vector width
  constexpr int TPR = TRUNK_THREADS / R;        // threads per row for the extra columns
  constexpr int KPT = RT_SLAB_K / TPR;          // their k per thread and slab
  constexpr int SLAB = RT_SLAB_K * RT_SLAB_LD;  // floats per slab
  constexpr int XB = HI ? RT_COLS : RT_COLS / 2;  // first extra column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp % RG) * TM, col0 = (warp / RG) * 32 * V + V * lane;
  const int er = threadIdx.x / TPR, ek = (threadIdx.x % TPR) * KPT;
  const int n_extra = ncols - XB;
  const bool vec = ((ldm | ncols) & 3) == 0 && (reinterpret_cast<uintptr_t>(M) & 15) == 0;
  float acc[TM][8 / CG];
  float eacc[RT_EXTRA];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int n = 0; n < 8 / CG; ++n) acc[m][n] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < RT_EXTRA; ++e) eacc[e] = 0.f;

  const int nslab = (nk + RT_SLAB_K - 1) / RT_SLAB_K;
  rt_load_slab(M, nk, ldm, ncols, vec, 0, slabs);
  if (nslab > 1) rt_load_slab(M, nk, ldm, ncols, vec, RT_SLAB_K, slabs + SLAB);
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
      rt_load_slab(M, nk, ldm, ncols, vec, (s + 2) * RT_SLAB_K,
                   slabs + ((s + 2) % RT_SLAB_STAGES) * SLAB);
    const float* w = slabs + (s % RT_SLAB_STAGES) * SLAB;
    const int k0 = s * RT_SLAB_K;
    const int nq = min(RT_SLAB_K / 4, (nk - k0 + 3) >> 2);  // k quads holding a k < nk
    if (nq == RT_SLAB_K / 4) {  // a full slab: unrolled, so loads run ahead of the FMAs
#pragma unroll
      for (int q = 0; q < RT_SLAB_K / 4; ++q) rt_quad<TM, HI, LD, CG>(in, r0, k0, q, w, col0, acc);
    } else {
#pragma unroll 1
      for (int q = 0; q < nq; ++q) rt_quad<TM, HI, LD, CG>(in, r0, k0, q, w, col0, acc);
    }
    if (n_extra > 0) {
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const int k = k0 + ek + u;
        if (k < nk) {
          const float av = in[er * LD + k];
          const float* wr = w + (ek + u) * RT_SLAB_LD + XB;
#pragma unroll
          for (int e = 0; e < RT_EXTRA; ++e)
            if (e < n_extra) eacc[e] = fmaf(av, wr[e], eacc[e]);
        }
      }
    }
  }

  float bv[TN];
#pragma unroll
  for (int n = 0; n < TN; ++n) {
    const int j = (n / V) * 128 + col0 + n % V;
    bv[n] = bias != nullptr && j < ncols ? bias[j] : 0.f;
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    float* o = out + (r0 + m) * LD;
#pragma unroll
    for (int h = 0; h < TN / V; ++h) {
      const int j = h * 128 + col0;
      const float* v = &acc[m][V * h];
      const float* bh = &bv[V * h];
      if (j + V - 1 < ncols) {
        if constexpr (V == 4)
          *reinterpret_cast<float4*>(o + j) =
              make_float4(v[0] + bh[0], v[1] + bh[1], v[2] + bh[2], v[3] + bh[3]);
        else
          *reinterpret_cast<float2*>(o + j) = make_float2(v[0] + bh[0], v[1] + bh[1]);
      } else {
#pragma unroll
        for (int n = 0; n < V; ++n)
          if (j + n < ncols) o[j + n] = v[n] + bh[n];
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
        out[er * LD + XB + e] = v + (bias != nullptr ? bias[XB + e] : 0.f);
    }
  }
}

// out[r][j] = sum_k in[r][k] * M[k * ldm + j] (+ bias[j]), j < ncols, for a
// tile of R rows (16 or 64), ncols at most TRUNK_MAXW. `in` and `out` are
// distinct shared [R][LD] buffers whose entries past the written widths
// hold zeros or earlier finite values (the kernels zero their shared memory
// at start); M is row-major with row stride ldm in global memory; `slabs`
// is RT_SLAB_STAGES x RT_SLAB_K x RT_SLAB_LD shared floats; TM rows per
// thread (see rt_mm_body). Every thread of the block calls; the caller
// synchronises before (in written) and after (out read, and before the
// next call refills slabs).
template <int R, int LD = TRUNK_MAXW, int TM = R / 8>
__device__ __forceinline__ void rt_mm_window(const float* in, int nk, const float* __restrict__ M,
                                             int ldm, int ncols, const float* __restrict__ bias,
                                             float* out, float* slabs) {
  if (ncols > RT_COLS / 2 + RT_EXTRA)  // a column of the upper half is live
    rt_mm_body<R, true, LD, TM>(in, nk, M, ldm, ncols, bias, out, slabs);
  else
    rt_mm_body<R, false, LD, TM>(in, nk, M, ldm, ncols, bias, out, slabs);
}

// rt_mm_window over all ncols columns of M ([nk, ncols]).
template <int R>
__device__ __forceinline__ void rt_mm(const float* in, int nk, const float* __restrict__ M,
                                      int ncols, const float* __restrict__ bias, float* out,
                                      float* slabs) {
  rt_mm_window<R>(in, nk, M, ncols, ncols, bias, out, slabs);
}
