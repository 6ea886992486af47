// Sphere march of the exact lidar scan for Hopper (sm_90a): one thread a
// ray, marched to its end on the map's distance transform.
//
// Replaces no Pallas kernel: the JAX package marches with one
// lax.while_loop (or a fori_loop budget) that XLA compiles into one loop on
// the device, red_gym_tpu/ops/scan.py:153 (march).  The math, and the plain
// PyTorch version this kernel is held against, are in
// red_gym_tpu_torch/ops/march_kernels.py (march_reference, the eager
// compacting march, and march_beams_reference).
//
// Two entry forms on one device function, march_ray:
//   rays:  flat x, y, c, s (the range-texture build);
//   beams: a pose row (x, y, theta) per car and the theta tables; the thread
//          of beam b computes its theta index as beam_theta_indices does and
//          reads its cos/sin from the tables, so only the (K, B) output is
//          written.
//
// Rounding.  Built with -fmad=false (ops/_build.py): every + - * / is
// rounded on its own, in the association of the PyTorch code, with IEEE
// division and truncating float-to-int casts, as PyTorch's one-kernel-per-
// operator code rounds them; Python floats reach the kernel as doubles and
// are rounded to the instance's type first, as PyTorch rounds a scalar
// operand.  So the kernel and its plain version agree bit for bit on the
// card, the out-of-map read of dt[h-1, w-1] included.
//
// What bounds it on the H100.  At 16384 x 2 cars and 1080 beams it writes
// 141.6 MB of ranges (0.04 ms at the memory rate) and reads a 3.2 MB
// distance transform (track_0019, float32) that stays in the 50 MB L2.  Its
// work is 24 operations a ray-iteration, times the iterations the data
// decide (on random free poses of track_0019: 6.7 a ray on average, 29 at
// the 99th percentile, 116 at most), about 0.1 ms at the float32 rate; so
// operations bound it, not bytes.  But each iteration is a dependent chain
// of two IEEE divisions and a gather from L2, so latency, not the issue
// rate, is what a thread waits on, and a warp runs as long as its longest
// ray.  Design: the simplest form that keeps that latency hidden, one
// thread a ray (the beams of one car side by side in a warp, whose rays run
// similar courses), 256 threads a block, 32 registers and no shared memory,
// so 2048 rays are in flight on each SM; the distance transform is read
// through the read-only cache.  It took 1.10 ms on an H100 80GB HBM3 at
// 700 W (PERF.md).  Compacting the rays still running, or a persistent
// grid, would cut the warps' idle lanes and is left for later.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Map {
  const T* dt;
  T ox, oy, oc, os, res, w_m, h_m;
  int last_r, last_c;  // height - 1, width - 1: the out-of-map cell
  int full_h, full_w;
};

template <typename T>
__device__ __forceinline__ Map<T> load_map(const T* dt, const T* ox, const T* oy,
                                           const T* oc, const T* os, const T* res,
                                           const int* height, const int* width,
                                           int full_h, int full_w) {
  Map<T> m;
  m.dt = dt;
  m.ox = *ox;
  m.oy = *oy;
  m.oc = *oc;
  m.os = *os;
  m.res = *res;
  const int h = *height, w = *width;
  m.w_m = (T)w * m.res;
  m.h_m = (T)h * m.res;
  m.last_r = h - 1;
  m.last_c = w - 1;
  m.full_h = full_h;
  m.full_w = full_w;
  return m;
}

// march_kernels.dt_lookup
template <typename T>
__device__ __forceinline__ T dt_lookup(T x, T y, const Map<T>& m) {
  const T xt = x - m.ox;
  const T yt = y - m.oy;
  const T xr = xt * m.oc + yt * m.os;
  const T yr = -xt * m.os + yt * m.oc;
  const bool oob = xr < T(0) || xr >= m.w_m || yr < T(0) || yr >= m.h_m;
  int r, c;
  if (oob) {
    r = m.last_r;
    c = m.last_c;
  } else {
    c = min(max((int)(xr / m.res), 0), m.full_w - 1);
    r = min(max((int)(yr / m.res), 0), m.full_h - 1);
  }
  return __ldg(m.dt + (r * m.full_w + c));
}

// march_kernels.march_reference for one ray; iters > 0 caps the iterations
// (cfg.march_iters), as the twin's fixed budget does
template <typename T>
__device__ __forceinline__ T march_ray(T x, T y, const T c, const T s, const Map<T>& m,
                                       const T eps, const T max_range, const int iters) {
  T d = dt_lookup(x, y, m);
  T total = d;
  for (int i = 0; iters <= 0 || i < iters; ++i) {
    if (!(d > eps && total <= max_range)) break;
    x = x + d * c;
    y = y + d * s;
    d = dt_lookup(x, y, m);
    total = total + d;
  }
  // torch.clamp(total, max=max_range): NaN passes through
  return total != total ? total : (total < max_range ? total : max_range);
}

// torch.remainder of floats: the sign of the divisor (jnp.mod's)
template <typename T>
__device__ __forceinline__ T floor_mod(T a, T b) {
  T r = fmod(a, b);
  if (r != T(0) && ((b < T(0)) != (r < T(0)))) r += b;
  return r;
}

// march_kernels.beam_theta_indices for beam b of heading th: the beam offset
// rounded once (in float64 for the float instance, where the product is
// exact; plainly in double)
__device__ __forceinline__ int theta_index(float th, int b, float half_fov,
                                           float bins_per_rad, double inc, float td) {
  const float t0 = floor_mod((th - half_fov) * bins_per_rad, td);
  const float ti = (float)((double)t0 + inc * (double)b);
  return (int)floor_mod(ti, td);
}
__device__ __forceinline__ int theta_index(double th, int b, double half_fov,
                                           double bins_per_rad, double inc, double td) {
  const double t0 = floor_mod((th - half_fov) * bins_per_rad, td);
  const double ti = t0 + inc * (double)b;
  return (int)floor_mod(ti, td);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    march_rays_kernel(const T* __restrict__ x, const T* __restrict__ y,
                      const T* __restrict__ c, const T* __restrict__ s, int64_t n,
                      const T* dt, const T* ox, const T* oy, const T* oc, const T* os,
                      const T* res, const int* height, const int* width, int full_h,
                      int full_w, T eps, T max_range, int iters, T* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Map<T> m = load_map(dt, ox, oy, oc, os, res, height, width, full_h, full_w);
  out[i] = march_ray(x[i], y[i], c[i], s[i], m, eps, max_range, iters);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    march_beams_kernel(const T* __restrict__ pose, const T* __restrict__ cos_tab,
                       const T* __restrict__ sin_tab, int64_t rows, int beams, T td,
                       T half_fov, T bins_per_rad, double inc, const T* dt, const T* ox,
                       const T* oy, const T* oc, const T* os, const T* res,
                       const int* height, const int* width, int full_h, int full_w, T eps,
                       T max_range, int iters, T* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= rows * beams) return;
  const int64_t k = i / beams;
  const int b = (int)(i - k * beams);
  const Map<T> m = load_map(dt, ox, oy, oc, os, res, height, width, full_h, full_w);
  const T px = __ldg(pose + 3 * k), py = __ldg(pose + 3 * k + 1);
  const int t = theta_index(__ldg(pose + 3 * k + 2), b, half_fov, bins_per_rad, inc, td);
  out[i] = march_ray(px, py, __ldg(cos_tab + t), __ldg(sin_tab + t), m, eps, max_range,
                     iters);
}

// a 1-D grid of one thread a ray; 0 where the rays need more blocks than
// a grid holds
unsigned int blocks_for(int64_t n) {
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  return blocks > 0x7fffffff ? 0u : (unsigned int)blocks;
}

template <typename T>
int rays(const void* x, const void* y, const void* c, const void* s, int64_t n,
         const void* dt, const void* ox, const void* oy, const void* oc, const void* os,
         const void* res, const void* height, const void* width, int full_h, int full_w,
         double eps, double max_range, int iters, void* out, cudaStream_t stream) {
  const unsigned int blocks = blocks_for(n);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  march_rays_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(c),
      static_cast<const T*>(s), n, static_cast<const T*>(dt), static_cast<const T*>(ox),
      static_cast<const T*>(oy), static_cast<const T*>(oc), static_cast<const T*>(os),
      static_cast<const T*>(res), static_cast<const int*>(height),
      static_cast<const int*>(width), full_h, full_w, (T)eps, (T)max_range, iters,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int beams_(const void* pose, const void* cos_tab, const void* sin_tab, int64_t rows,
           int beams, int theta_dis, double half_fov, double bins_per_rad, double inc,
           const void* dt, const void* ox, const void* oy, const void* oc, const void* os,
           const void* res, const void* height, const void* width, int full_h, int full_w,
           double eps, double max_range, int iters, void* out, cudaStream_t stream) {
  // the float instance adds the beam offset in double, to the float32 value
  // of inc (the Python float rounded as PyTorch rounds a scalar operand)
  const double inc_t = (double)(T)inc;
  const unsigned int blocks = blocks_for(rows * beams);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  march_beams_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(pose), static_cast<const T*>(cos_tab),
      static_cast<const T*>(sin_tab), rows, beams, (T)theta_dis, (T)half_fov,
      (T)bins_per_rad, inc_t, static_cast<const T*>(dt), static_cast<const T*>(ox),
      static_cast<const T*>(oy), static_cast<const T*>(oc), static_cast<const T*>(os),
      static_cast<const T*>(res), static_cast<const int*>(height),
      static_cast<const int*>(width), full_h, full_w, (T)eps, (T)max_range, iters,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rays form: out[i] = the march of ray (x[i], y[i], c[i], s[i]), n rays;
// is_double picks the instance.  Returns cudaGetLastError() of the launch.
extern "C" int march_rays_launch(const void* x, const void* y, const void* c,
                                 const void* s, int64_t n, const void* dt, const void* ox,
                                 const void* oy, const void* oc, const void* os,
                                 const void* res, const void* height, const void* width,
                                 int full_h, int full_w, double eps, double max_range,
                                 int iters, int is_double, void* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? rays<double>(x, y, c, s, n, dt, ox, oy, oc, os, res, height, width,
                                   full_h, full_w, eps, max_range, iters, out, st)
                   : rays<float>(x, y, c, s, n, dt, ox, oy, oc, os, res, height, width,
                                 full_h, full_w, eps, max_range, iters, out, st);
}

// The beams form: out[k, b] = the march of beam b of pose row k (x, y,
// theta), rows x beams rays along the theta tables (theta_dis,).
extern "C" int march_beams_launch(const void* pose, const void* cos_tab,
                                  const void* sin_tab, int64_t rows, int beams,
                                  int theta_dis, double half_fov, double bins_per_rad,
                                  double inc, const void* dt, const void* ox,
                                  const void* oy, const void* oc, const void* os,
                                  const void* res, const void* height, const void* width,
                                  int full_h, int full_w, double eps, double max_range,
                                  int iters, int is_double, void* out, void* stream) {
  if (rows <= 0 || beams <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double
             ? beams_<double>(pose, cos_tab, sin_tab, rows, beams, theta_dis, half_fov,
                              bins_per_rad, inc, dt, ox, oy, oc, os, res, height, width,
                              full_h, full_w, eps, max_range, iters, out, st)
             : beams_<float>(pose, cos_tab, sin_tab, rows, beams, theta_dis, half_fov,
                             bins_per_rad, inc, dt, ox, oy, oc, os, res, height, width,
                             full_h, full_w, eps, max_range, iters, out, st);
}
