// The weight-gradient reduction shared by K2 (fused_mlp.cu) and K4
// (fused_value_grad.cu): for one layer,
//   dW[k][j] += sum_r C[r][k] G[r][j] (+ C2[r][k] G2[r][j]),  db[j] += sum_r G[r][j]
// over all N rows of operands that a rows kernel left in global scratch
// (C, C2 are [N, K]; G, G2 are [N, J]).
//
// Blocks run in parallel, in no order, so the sum over rows cannot be
// carried across a sequential grid as on the TPU. Each block owns a
// WG_T x WG_T tile of dW and a slice of the rows (about two blocks per SM in
// all), stages WG_CH-row slices of the operands in shared memory with
// cp.async, two deep, keeps an 8 x 8 register tile per thread (four float4
// shared loads feed 64 fused multiply-adds), and adds its partial into dW
// and db, which the caller zeroes, with fp32 atomics. With two operand pairs (K4) both are summed
// into the same registers before the atomics. A scratch row is read once
// per WG_T columns of the other operand. The order of the sums changes from
// run to run. Rows past N are loaded as zeros.
#pragma once

#include "trunk.cuh"

#define WG_T 128        // dW tile: WG_T rows (k) x WG_T columns (j)
#define WG_CH 16        // rows of each operand staged per step
#define WG_MIN_ROWS 128  // least rows per block
#define WG_BLOCKS_PER_SM 2  // resident blocks per SM (registers capped to fit), hiding each other's loads

// 16 x 16 threads; thread (tx, ty) owns k in {ty*4 + m, 64 + ty*4 + m} and
// j in {tx*4 + n, 64 + tx*4 + n}. PAIRS is 1 (C^T G) or 2 (C^T G + C2^T G2).
// The slices are staged with cp.async, 16-byte copies where the operands'
// rows are 16-byte aligned and 4-byte ones at odd widths, two buffers deep,
// so that the next slice is in flight while this one is summed.
template <int PAIRS>
__global__ void __launch_bounds__(256, WG_BLOCKS_PER_SM)
    wgrad_kernel(const float* __restrict__ C, const float* __restrict__ G,
                 const float* __restrict__ C2, const float* __restrict__ G2, long long N, int K,
                 int J, long long rows_per_block, float* __restrict__ dW,
                 float* __restrict__ db) {
  __shared__ __align__(16) float sc[2][WG_CH][WG_T];
  __shared__ __align__(16) float sg[2][WG_CH][WG_T];
  const int k0 = blockIdx.x * WG_T, j0 = blockIdx.y * WG_T;
  const long long r0 = (long long)blockIdx.z * rows_per_block;
  const long long r1 = min(N, r0 + rows_per_block);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool do_db = blockIdx.x == 0 && ty == 0;
  // slices: nslice of the first pair's rows, then as many of the second's
  const int nslice = (int)((r1 - r0 + WG_CH - 1) / WG_CH), total = PAIRS * nslice;
  float acc[8][8];
  float accb[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    accb[m] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;
  }
  // 16-byte copies where both operands' rows are 16-byte aligned
  const bool vec = ((K | J) & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(G) |
                     reinterpret_cast<uintptr_t>(C2) | reinterpret_cast<uintptr_t>(G2)) & 15) == 0;
  auto stage = [&](int slice, int buf) {
    const int pair = slice >= nslice;
    const long long rb = r0 + (long long)(slice - pair * nslice) * WG_CH;
    const float* A = pair ? C2 : C;
    const float* B = pair ? G2 : G;
    if (vec) {
      for (int idx = threadIdx.x; idx < WG_CH * WG_T / 4; idx += blockDim.x) {
        const int rr = idx / (WG_T / 4), cc = 4 * (idx - rr * (WG_T / 4));
        const long long r = rb + rr;
        const bool oka = r < r1 && k0 + cc < K, okb = r < r1 && j0 + cc < J;
        cp_async16(&sc[buf][rr][cc], oka ? A + r * K + k0 + cc : A, oka ? 16 : 0);
        cp_async16(&sg[buf][rr][cc], okb ? B + r * J + j0 + cc : B, okb ? 16 : 0);
      }
    } else {
      for (int idx = threadIdx.x; idx < WG_CH * WG_T; idx += blockDim.x) {
        const int rr = idx / WG_T, cc = idx - rr * WG_T;
        const long long r = rb + rr;
        const bool oka = r < r1 && k0 + cc < K, okb = r < r1 && j0 + cc < J;
        cp_async4(&sc[buf][rr][cc], oka ? A + r * K + k0 + cc : A, oka ? 4 : 0);
        cp_async4(&sg[buf][rr][cc], okb ? B + r * J + j0 + cc : B, okb ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  stage(0, 0);
  for (int slice = 0; slice < total; ++slice) {
    if (slice + 1 < total) {
      stage(slice + 1, (slice + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = slice & 1;
    const bool db_now = do_db && slice < nslice;  // db from the first pair's rows
#pragma unroll 4
    for (int rr = 0; rr < WG_CH; ++rr) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sc[buf][rr][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sc[buf][rr][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sg[buf][rr][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sg[buf][rr][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
      }
      if (db_now) {
#pragma unroll
        for (int n = 0; n < 8; ++n) accb[n] += bv[n];
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int k = k0 + (m < 4 ? ty * 4 + m : 64 + ty * 4 + (m - 4));
    if (k >= K) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = j0 + (n < 4 ? tx * 4 + n : 64 + tx * 4 + (n - 4));
      if (j < J) atomicAdd(&dW[(size_t)k * J + j], acc[m][n]);
    }
  }
  if (do_db) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = j0 + (n < 4 ? tx * 4 + n : 64 + tx * 4 + (n - 4));
      if (j < J) atomicAdd(&db[j], accb[n]);
    }
  }
}

// Launch the reduction of one layer [K, J] over N rows (C2, G2 null for one
// pair): about WG_BLOCKS_PER_SM blocks per SM over all tiles, slices of at
// least WG_MIN_ROWS rows, a multiple of WG_CH.
static cudaError_t wgrad_launch(const float* C, const float* G, const float* C2, const float* G2,
                                long long N, int K, int J, int sms, float* dW, float* db,
                                cudaStream_t st) {
  const long long tiles = (long long)((K + WG_T - 1) / WG_T) * ((J + WG_T - 1) / WG_T);
  long long splits = (WG_BLOCKS_PER_SM * sms + tiles - 1) / tiles;
  const long long max_splits = (N + WG_MIN_ROWS - 1) / WG_MIN_ROWS;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  long long rows = (N + splits - 1) / splits;
  rows = (rows + WG_CH - 1) / WG_CH * WG_CH;
  splits = (N + rows - 1) / rows;
  dim3 grid((K + WG_T - 1) / WG_T, (J + WG_T - 1) / WG_T, (unsigned)splits);
  if (C2 != nullptr)
    wgrad_kernel<2><<<grid, 256, 0, st>>>(C, G, C2, G2, N, K, J, rows, dW, db);
  else
    wgrad_kernel<1><<<grid, 256, 0, st>>>(C, G, C2, G2, N, K, J, rows, dW, db);
  return cudaGetLastError();
}
