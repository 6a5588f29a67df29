// Grid march: sphere tracing of a cached SDF grid, one thread per ray.
//
// Replaces the march of robir_tpu/tracing/grid.py:grid_cast (:473): _march,
// a lax.while_loop that XLA runs as one masked device loop over all rays
// (up to max_steps steps, an early exit once no ray is active), then
// _refine (8 bisection steps and one Newton step). The JAX package has no
// Pallas kernel for it. Eager PyTorch would issue some 20 ops per step
// from the host, with a sync per step for the early exit; here each
// thread runs its ray's march and refinement in registers and stops when
// its ray stops, so inactive rays cost nothing and need no compaction.
//
// A lookup reads the eight corners of its cell straight from the base
// [R, R, R] grid (bf16 or fp32) in device memory; the interpolation runs
// in fp32 with JAX's association: the four (x, y) corners blended in the
// order r00, r01, r10, r11, then the two z nodes. Bound on the H100: the
// bytes of the corners each lookup reads (8 x 2 bytes in bf16) over the
// steps the rays take; the loads are scattered, so the kernel is held by
// the latency of dependent loads, one march step after another.
//
// Arithmetic matches the plain version (tracing/grid.py:grid_cast_plain)
// operation for operation: a hit is a comparison (s < eps_hit), and one
// contracted multiply-add could flip it on a grazing ray. So this source
// is compiled with -fmad=false (render/cuda/build.py), divisions and
// square roots are IEEE (no fast math), and every scalar arrives rounded
// to fp32 as the JAX package rounds it (MarchConstants).

#include <cuda_runtime.h>
#include <math.h>

#define MARCH_THREADS 128

struct MarchParams {
  float lo[3], hi[3], span[3];  // bbox, and hi - lo in fp32
  float rm1;                    // R - 1
  float clip_hi;                // fp32(R - 1 - 1e-6)
  float cell_max;               // R - 2, the largest cell index
  float eps_hit, min_step, max_dt, omega, relax, over_margin, start_offset;
  float normal_eps, two_eps;
  long long R;
  int max_steps;
};

template <bool BF16>
__device__ __forceinline__ float corner(const void* grid, long long i) {
  if (BF16) {
    const unsigned short bits = __ldg(static_cast<const unsigned short*>(grid) + i);
    return __uint_as_float(static_cast<unsigned>(bits) << 16);
  }
  return __ldg(static_cast<const float*>(grid) + i);
}

// grid_sdf: trilinear lookup at p, clamped to the bbox.
template <bool BF16>
__device__ float lookup(const void* grid, const MarchParams& P, const float p[3]) {
  long long i0[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float g = (p[a] - P.lo[a]) / P.span[a] * P.rm1;
    g = fminf(fmaxf(g, 0.0f), P.clip_hi);
    const float c = fminf(floorf(g), P.cell_max);
    i0[a] = static_cast<long long>(c);
    f[a] = g - c;
  }
  const float fx = f[0], fy = f[1], fz = f[2];
  const float w00 = (1.0f - fx) * (1.0f - fy), w01 = (1.0f - fx) * fy;
  const float w10 = fx * (1.0f - fy), w11 = fx * fy;
  const long long R = P.R;
  const long long base = (i0[0] * R + i0[1]) * R + i0[2];
  float b[2];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const long long k = base + dz;
    b[dz] = corner<BF16>(grid, k) * w00 + corner<BF16>(grid, k + R) * w01 +
            corner<BF16>(grid, k + R * R) * w10 + corner<BF16>(grid, k + R * R + R) * w11;
  }
  return b[0] * (1.0f - fz) + b[1] * fz;
}

__device__ __forceinline__ void along(const float o[3], const float d[3], float t, float p[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = o[a] + t * d[a];
}

template <bool BF16, bool OVER>
__global__ void __launch_bounds__(MARCH_THREADS)
grid_march_kernel(const void* __restrict__ grid, const float* __restrict__ rays_o,
                  const float* __restrict__ rays_d, float* __restrict__ t_out,
                  unsigned char* __restrict__ hit_out, float* __restrict__ x_out,
                  const MarchParams P, long long N) {
  const long long r = static_cast<long long>(blockIdx.x) * MARCH_THREADS + threadIdx.x;
  if (r >= N) return;
  float o[3], d[3], p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = rays_o[3 * r + a];
    d[a] = rays_d[3 * r + a];
  }

  // _ray_bbox
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float inv = 1.0f / (fabsf(d[a]) < 1e-9f ? 1e-9f : d[a]);
    const float t0 = (P.lo[a] - o[a]) * inv, t1 = (P.hi[a] - o[a]) * inv;
    tmin = a == 0 ? fminf(t0, t1) : fmaxf(tmin, fminf(t0, t1));
    tmax = a == 0 ? fmaxf(t0, t1) : fminf(tmax, fmaxf(t0, t1));
  }
  const float t_near = fmaxf(tmin, 0.0f), t_far = tmax;

  // _march: the ray's state freezes once it is inactive, so it stops there
  float t = t_near + P.start_offset, t_prev = t, s_prev = 0.0f, step_prev = 0.0f;
  bool active = t_far > t_near, hit = false;
  for (int it = 0; active && it < P.max_steps; ++it) {
    along(o, d, t, p);
    const float s = lookup<BF16>(grid, P, p);
    bool fail = false;
    float cons_prev = 0.0f;
    if (OVER) {
      cons_prev = fmaxf(P.relax * s_prev, P.min_step);
      const bool was_over = step_prev > cons_prev * P.over_margin;
      fail = was_over && step_prev > fabsf(s_prev) + fabsf(s);
    }
    const bool new_hit = !fail && s < P.eps_hit;
    float step = fmaxf(P.omega * s, P.min_step);
    if (OVER) {
      const float cons_now = fmaxf(P.relax * s, P.min_step);
      if (t + step > t_far && t + cons_now <= t_far) step = cons_now;
    }
    const bool adv = !new_hit && !fail;
    float t_next = adv ? t + step : t;
    if (OVER && fail) t_next = t_prev + cons_prev;
    active = !new_hit && t_next <= t_far;
    if (adv) {
      t_prev = t;
      s_prev = s;
      step_prev = step;
    } else if (fail) {
      step_prev = cons_prev;
    }
    hit = hit || new_hit;
    t = t_next;
  }

  // _refine: bisection where the last step overshot, then one Newton step
  if (hit) {
    float lo = t_prev, hi = t;
    along(o, d, hi, p);
    const bool bracketed = lookup<BF16>(grid, P, p) < 0.0f;
    if (bracketed) {
      for (int i = 0; i < 8; ++i) {
        const float mid = 0.5f * (lo + hi);
        along(o, d, mid, p);
        if (lookup<BF16>(grid, P, p) > 0.0f)
          lo = mid;
        else
          hi = mid;
      }
      t = 0.5f * (lo + hi);
    }
    float x[3], g[3];
    along(o, d, t, x);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float q[3] = {x[0], x[1], x[2]};
      q[a] = x[a] + P.normal_eps;
      const float up = lookup<BF16>(grid, P, q);
      q[a] = x[a] - P.normal_eps;
      g[a] = (up - lookup<BF16>(grid, P, q)) / P.two_eps;
    }
    const float scale = fmaxf(sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]), 1e-4f);
    const float n0 = g[0] / scale, n1 = g[1] / scale, n2 = g[2] / scale;
    const float s = lookup<BF16>(grid, P, x);
    float speed = d[0] * n0 + d[1] * n1 + d[2] * n2;
    if (fabsf(speed) < 1e-4f) speed = 1e-4f;
    const float dt = fminf(fmaxf(-s / speed, -P.max_dt), P.max_dt);
    t = t + dt;
  }
  along(o, d, t, p);
  t_out[r] = t;
  hit_out[r] = hit ? 1 : 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) x_out[3 * r + a] = p[a];
}

// the name every kernel library of the port exports for its error messages
extern "C" const char* trunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// consts: lo[3], hi[3], eps_hit, min_step, max_dt, omega, relax, over_margin,
// start_offset, normal_eps, two_eps, clip_hi (16 floats, each already fp32).
extern "C" int grid_march(const void* grid, const float* rays_o, const float* rays_d,
                          float* t, unsigned char* hit, float* x, const float* consts, int R,
                          int max_steps, int bf16, int over, long long N, void* stream) {
  if (R < 2 || max_steps < 0) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  MarchParams P;
  for (int a = 0; a < 3; ++a) {
    P.lo[a] = consts[a];
    P.hi[a] = consts[3 + a];
    P.span[a] = P.hi[a] - P.lo[a];
  }
  P.eps_hit = consts[6];
  P.min_step = consts[7];
  P.max_dt = consts[8];
  P.omega = consts[9];
  P.relax = consts[10];
  P.over_margin = consts[11];
  P.start_offset = consts[12];
  P.normal_eps = consts[13];
  P.two_eps = consts[14];
  P.clip_hi = consts[15];
  P.rm1 = static_cast<float>(R - 1);
  P.cell_max = static_cast<float>(R - 2);
  P.R = R;
  P.max_steps = max_steps;
  const unsigned blocks = static_cast<unsigned>((N + MARCH_THREADS - 1) / MARCH_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 && over)
    grid_march_kernel<true, true><<<blocks, MARCH_THREADS, 0, st>>>(grid, rays_o, rays_d, t, hit, x, P, N);
  else if (bf16)
    grid_march_kernel<true, false><<<blocks, MARCH_THREADS, 0, st>>>(grid, rays_o, rays_d, t, hit, x, P, N);
  else if (over)
    grid_march_kernel<false, true><<<blocks, MARCH_THREADS, 0, st>>>(grid, rays_o, rays_d, t, hit, x, P, N);
  else
    grid_march_kernel<false, false><<<blocks, MARCH_THREADS, 0, st>>>(grid, rays_o, rays_d, t, hit, x, P, N);
  return (int)cudaGetLastError();
}
