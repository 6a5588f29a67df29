// Forward of the SDF trunk for a batch of rows, all layers in one kernel.
//
// Replaces robir_tpu/render/pallas/fused_mlp.py:_fwd_kernel (launched by
// _fused_forward, pallas_call at :143). Each block owns TRUNK_ROWS rows and
// carries their activations through every layer in shared memory, so device
// memory sees only the input rows, the output rows and the weights (read
// from L2). Bound on the H100: operations, 2 * 524,544 fp32 multiply-adds
// per row of the full-width trunk against 64 bytes in and 1 KB out per row;
// the kernel runs them on the CUDA cores in fp32, one L2 weight load feeding
// TRUNK_ROWS fused multiply-adds.
//
// Forward only: the recompute backward of the TPU kernel (_bwd_kernel) is
// not ported, and the wrapper refuses inputs that need a gradient.
#include "trunk.cuh"

static __device__ __forceinline__ float* other_buf(float* p, float* a, float* b) {
  return p == a ? b : a;
}

__global__ void __launch_bounds__(TRUNK_THREADS)
    fused_mlp_fwd_kernel(TrunkPlan p, const float* __restrict__ x, const float* __restrict__ W,
                         const float* __restrict__ b, float* __restrict__ y, long long N) {
  __shared__ float bufA[TRUNK_ROWS * TRUNK_MAXW];
  __shared__ float bufB[TRUNK_ROWS * TRUNK_MAXW];
  __shared__ float x0[TRUNK_ROWS * TRUNK_MAXD0];
  const long long row0 = (long long)blockIdx.x * TRUNK_ROWS;

  tile_load_rows(x, p.d0, row0, N, x0, TRUNK_MAXD0);
  tile_load_rows(x, p.d0, row0, N, bufA, TRUNK_MAXW);
  __syncthreads();

  float* h = bufA;
  for (int i = 0; i < p.n; ++i) {
    float* c = tile_layer_input(p, i, h, x0, other_buf(h, bufA, bufB));
    float* z = other_buf(c, bufA, bufB);
    tile_mm(c, p.din[i], W + p.woff[i], p.dout[i], b + p.boff[i], z);
    __syncthreads();
    if (i < p.n - 1) {
      const int w = p.dout[i];
      for (int idx = threadIdx.x; idx < TRUNK_ROWS * w; idx += blockDim.x) {
        int r = idx / w, j = idx - r * w;
        z[r * TRUNK_MAXW + j] = trunk_act(z[r * TRUNK_MAXW + j]);
      }
      __syncthreads();
    }
    h = z;
  }
  tile_store_rows(h, TRUNK_MAXW, p.dout[p.n - 1], row0, N, y);
}

extern "C" const char* trunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x [N, d0] -> y [N, dout_last]; W and b are the flat folded weights and biases.
extern "C" int fused_mlp_forward(const float* x, const float* W, const float* b, float* y,
                                 const int* meta, long long N, void* stream) {
  TrunkPlan p;
  if (trunk_plan_from_meta(meta, &p)) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const long long blocks = (N + TRUNK_ROWS - 1) / TRUNK_ROWS;
  fused_mlp_fwd_kernel<<<(unsigned)blocks, TRUNK_THREADS, 0, (cudaStream_t)stream>>>(p, x, W, b,
                                                                                   y, N);
  return (int)cudaGetLastError();
}
