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
// Each form marches one map, or a stack of M maps of one padded shape
// (multi-map batches): then an int32 map index per ray (rays) or per pose
// row (beams) picks the map, whose scalars are read at that index of their
// (M,) arrays and whose distance transform starts at m * H * W of the
// (M, H, W) stack, addressed in size_t (JAX scan.py:96-137, dt_lookup with
// midx).  A null index array is the one-map form: index 0 of 0-d scalars.
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
// the 99th percentile, 116 at most), and 12 a ray for its theta index.  None
// is a fused multiply-add, so each is one lane instruction, at most 128 a
// cycle an SM (half the float32 FLOP rate, which counts an FMA as two):
// about 0.21 ms, and only a floor, since each IEEE division is a reciprocal
// and a Newton sequence and each cast issues at a quarter of the rate.  The
// kernel takes about five times that, waiting on its gathers: each
// iteration is a dependent chain ending in a read of the distance
// transform, and a warp runs as long as its longest ray (10.3 iterations
// against 6.7 a ray).  Design: the simplest form that keeps many gathers in
// flight and each of them narrow: one thread a ray, the adjacent beams of
// one car side by side in a warp (their rays start together and run similar
// courses, so a warp's lookups share sectors of the distance transform),
// 256 threads a block, 32 registers and no shared memory, so 2048 rays are
// in flight on each SM and all of L1 is left to the read-only cache.  It
// took 1.09-1.10 ms on an H100 80GB HBM3 at 700 W (PERF.md).
//
// Tried and dropped, each bit-equal to the twin and measured against this
// form on the same card (PERF.md):
// - a persistent grid whose idle lanes take the warp's next rays (a ring of
//   prepared rays in shared memory, __ballot_sync and __popc prefix ranks, a
//   refill at 8 idle lanes, one or two rays a lane): 0.92 of the lanes' slots
//   march against 0.65 here, yet 1.36-1.49x slower on one map and 1.57-1.75x
//   on the stack, and slower at small launches.  A refilled warp marches
//   rays of many cars, so each gather touches about as many sectors as it has
//   lanes, and the ring and the second ray took 54-56 registers;
// - the same grid refilling a lane group only once all 32 of its rays have
//   ended, and two rays a thread in this form (32-48 registers): slower
//   still, as is this form held to fewer resident warps;
// - a multiply by the reciprocal of the resolution in place of the two
//   divisions (exact for a power-of-two resolution, guarded by the division
//   near cell boundaries), int32 row indices and a shortcut of the second
//   floored remainder: 3 % on one map, none on the stack;
// - rows ordered along a Z curve of the cars' positions: 2-4 %;
// - the distance transform copied in tiles of 8 x 4 cells a 128-byte line,
//   so a warp's lookups share more lines: 8-14 % slower.
//
// The stacked form.  The 11 packaged tracks' float32 transforms, padded to
// 952 x 947, are 39.7 MB: still within L2.  A one-map thread reads its map's
// scalars as warp-uniform values; a stacked thread holds its own map's in
// registers, 37 a thread unbounded (75 % occupancy).  So the stacked kernels
// are kernels of their own, the float ones held to 8 blocks a SM (32
// registers, 32 spill bytes: 1.17-1.18 ms against the one-map 1.09-1.10 ms at
// 16384 x 2 x 1080, PERF.md); the one-map kernels take no map index and keep
// 32 registers and full occupancy.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// blocks a SM the stacked kernels must fit: for float all 2048 threads a SM
// holds, as the one-map kernels reach; double is left free, as its one-map
// kernels are (held, it spilled 216-240 bytes)
template <typename T>
constexpr int stacked_min_blocks() {
  return sizeof(T) == sizeof(float) ? 8 : 1;
}

template <typename T>
struct Map {
  const T* dt;
  T ox, oy, oc, os, res, w_m, h_m;
  int last_r, last_c;  // height - 1, width - 1: the out-of-map cell
  int full_h, full_w;
};

// map mi of the stack (0 for one map): its scalars, and its distance
// transform at mi * full_h * full_w, an offset in size_t; the rays of one
// car share a map, so these reads hit the cache
template <typename T>
__device__ __forceinline__ Map<T> load_map(const T* dt, const T* ox, const T* oy,
                                           const T* oc, const T* os, const T* res,
                                           const int* height, const int* width,
                                           int full_h, int full_w, int mi) {
  Map<T> m;
  m.dt = dt + (size_t)mi * (size_t)full_h * (size_t)full_w;
  m.ox = ox[mi];
  m.oy = oy[mi];
  m.oc = oc[mi];
  m.os = os[mi];
  m.res = res[mi];
  const int h = height[mi], w = width[mi];
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

// the thread of ray i of the rays form; STACKED reads its map index
template <typename T, bool STACKED>
__device__ __forceinline__ void rays_thread(const T* __restrict__ x, const T* __restrict__ y,
                                            const T* __restrict__ c, const T* __restrict__ s,
                                            int64_t n, const int* __restrict__ midx,
                                            const T* dt, const T* ox, const T* oy,
                                            const T* oc, const T* os, const T* res,
                                            const int* height, const int* width, int full_h,
                                            int full_w, T eps, T max_range, int iters,
                                            T* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int mi = STACKED ? __ldg(midx + i) : 0;
  const Map<T> m = load_map(dt, ox, oy, oc, os, res, height, width, full_h, full_w, mi);
  out[i] = march_ray(x[i], y[i], c[i], s[i], m, eps, max_range, iters);
}

// the thread of beam i % beams of pose row i / beams of the beams form
template <typename T, bool STACKED>
__device__ __forceinline__ void beams_thread(const T* __restrict__ pose,
                                             const T* __restrict__ cos_tab,
                                             const T* __restrict__ sin_tab, int64_t rows,
                                             int beams, T td, T half_fov, T bins_per_rad,
                                             double inc, const int* __restrict__ midx,
                                             const T* dt, const T* ox, const T* oy,
                                             const T* oc, const T* os, const T* res,
                                             const int* height, const int* width,
                                             int full_h, int full_w, T eps, T max_range,
                                             int iters, T* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= rows * beams) return;
  const int64_t k = i / beams;
  const int b = (int)(i - k * beams);
  const int mi = STACKED ? __ldg(midx + k) : 0;
  const Map<T> m = load_map(dt, ox, oy, oc, os, res, height, width, full_h, full_w, mi);
  const T px = __ldg(pose + 3 * k), py = __ldg(pose + 3 * k + 1);
  const int t = theta_index(__ldg(pose + 3 * k + 2), b, half_fov, bins_per_rad, inc, td);
  out[i] = march_ray(px, py, __ldg(cos_tab + t), __ldg(sin_tab + t), m, eps, max_range,
                     iters);
}

// one map: the map's scalars are the same for every thread
template <typename T>
__global__ void __launch_bounds__(THREADS)
    march_rays_kernel(const T* __restrict__ x, const T* __restrict__ y,
                      const T* __restrict__ c, const T* __restrict__ s, int64_t n,
                      const T* dt, const T* ox, const T* oy, const T* oc, const T* os,
                      const T* res, const int* height, const int* width, int full_h,
                      int full_w, T eps, T max_range, int iters, T* __restrict__ out) {
  rays_thread<T, false>(x, y, c, s, n, nullptr, dt, ox, oy, oc, os, res, height, width,
                        full_h, full_w, eps, max_range, iters, out);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    march_beams_kernel(const T* __restrict__ pose, const T* __restrict__ cos_tab,
                       const T* __restrict__ sin_tab, int64_t rows, int beams, T td,
                       T half_fov, T bins_per_rad, double inc, const T* dt, const T* ox,
                       const T* oy, const T* oc, const T* os, const T* res,
                       const int* height, const int* width, int full_h, int full_w, T eps,
                       T max_range, int iters, T* __restrict__ out) {
  beams_thread<T, false>(pose, cos_tab, sin_tab, rows, beams, td, half_fov, bins_per_rad,
                         inc, nullptr, dt, ox, oy, oc, os, res, height, width, full_h,
                         full_w, eps, max_range, iters, out);
}

// a stack of maps: each thread keeps its own map's scalars, which takes
// registers the one-map form does not need; held to stacked_min_blocks
template <typename T>
__global__ void __launch_bounds__(THREADS, stacked_min_blocks<T>())
    march_rays_stacked_kernel(const T* __restrict__ x, const T* __restrict__ y,
                              const T* __restrict__ c, const T* __restrict__ s, int64_t n,
                              const int* __restrict__ midx, const T* dt, const T* ox,
                              const T* oy, const T* oc, const T* os, const T* res,
                              const int* height, const int* width, int full_h, int full_w,
                              T eps, T max_range, int iters, T* __restrict__ out) {
  rays_thread<T, true>(x, y, c, s, n, midx, dt, ox, oy, oc, os, res, height, width, full_h,
                       full_w, eps, max_range, iters, out);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, stacked_min_blocks<T>())
    march_beams_stacked_kernel(const T* __restrict__ pose, const T* __restrict__ cos_tab,
                               const T* __restrict__ sin_tab, int64_t rows, int beams,
                               T td, T half_fov, T bins_per_rad, double inc,
                               const int* __restrict__ midx, const T* dt, const T* ox,
                               const T* oy, const T* oc, const T* os, const T* res,
                               const int* height, const int* width, int full_h,
                               int full_w, T eps, T max_range, int iters,
                               T* __restrict__ out) {
  beams_thread<T, true>(pose, cos_tab, sin_tab, rows, beams, td, half_fov, bins_per_rad,
                        inc, midx, dt, ox, oy, oc, os, res, height, width, full_h, full_w,
                        eps, max_range, iters, out);
}

// a 1-D grid of one thread a ray; 0 where the rays need more blocks than
// a grid holds
unsigned int blocks_for(int64_t n) {
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  return blocks > 0x7fffffff ? 0u : (unsigned int)blocks;
}

template <typename T>
int rays(const void* x, const void* y, const void* c, const void* s, int64_t n,
         const void* midx, const void* dt, const void* ox, const void* oy, const void* oc,
         const void* os, const void* res, const void* height, const void* width,
         int full_h, int full_w, double eps, double max_range, int iters, void* out,
         cudaStream_t stream) {
  const unsigned int blocks = blocks_for(n);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const T *x_ = static_cast<const T*>(x), *y_ = static_cast<const T*>(y);
  const T *c_ = static_cast<const T*>(c), *s_ = static_cast<const T*>(s);
  const T *dt_ = static_cast<const T*>(dt), *ox_ = static_cast<const T*>(ox);
  const T *oy_ = static_cast<const T*>(oy), *oc_ = static_cast<const T*>(oc);
  const T *os_ = static_cast<const T*>(os), *res_ = static_cast<const T*>(res);
  const int *h_ = static_cast<const int*>(height), *w_ = static_cast<const int*>(width);
  if (midx)
    march_rays_stacked_kernel<T><<<blocks, THREADS, 0, stream>>>(
        x_, y_, c_, s_, n, static_cast<const int*>(midx), dt_, ox_, oy_, oc_, os_, res_, h_,
        w_, full_h, full_w, (T)eps, (T)max_range, iters, static_cast<T*>(out));
  else
    march_rays_kernel<T><<<blocks, THREADS, 0, stream>>>(
        x_, y_, c_, s_, n, dt_, ox_, oy_, oc_, os_, res_, h_, w_, full_h, full_w, (T)eps,
        (T)max_range, iters, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int beams_(const void* pose, const void* cos_tab, const void* sin_tab, int64_t rows,
           int beams, int theta_dis, double half_fov, double bins_per_rad, double inc,
           const void* midx, const void* dt, const void* ox, const void* oy, const void* oc,
           const void* os, const void* res, const void* height, const void* width,
           int full_h, int full_w, double eps, double max_range, int iters, void* out,
           cudaStream_t stream) {
  // the float instance adds the beam offset in double, to the float32 value
  // of inc (the Python float rounded as PyTorch rounds a scalar operand)
  const double inc_t = (double)(T)inc;
  const unsigned int blocks = blocks_for(rows * beams);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const T *pose_ = static_cast<const T*>(pose), *cos_ = static_cast<const T*>(cos_tab);
  const T *sin_ = static_cast<const T*>(sin_tab), *dt_ = static_cast<const T*>(dt);
  const T *ox_ = static_cast<const T*>(ox), *oy_ = static_cast<const T*>(oy);
  const T *oc_ = static_cast<const T*>(oc), *os_ = static_cast<const T*>(os);
  const T* res_ = static_cast<const T*>(res);
  const int *h_ = static_cast<const int*>(height), *w_ = static_cast<const int*>(width);
  if (midx)
    march_beams_stacked_kernel<T><<<blocks, THREADS, 0, stream>>>(
        pose_, cos_, sin_, rows, beams, (T)theta_dis, (T)half_fov, (T)bins_per_rad, inc_t,
        static_cast<const int*>(midx), dt_, ox_, oy_, oc_, os_, res_, h_, w_, full_h,
        full_w, (T)eps, (T)max_range, iters, static_cast<T*>(out));
  else
    march_beams_kernel<T><<<blocks, THREADS, 0, stream>>>(
        pose_, cos_, sin_, rows, beams, (T)theta_dis, (T)half_fov, (T)bins_per_rad, inc_t,
        dt_, ox_, oy_, oc_, os_, res_, h_, w_, full_h, full_w, (T)eps, (T)max_range, iters,
        static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rays form: out[i] = the march of ray (x[i], y[i], c[i], s[i]), n rays,
// on map midx[i] of the stack (midx null: one map); is_double picks the
// instance.  Returns cudaGetLastError() of the launch.
extern "C" int march_rays_launch(const void* x, const void* y, const void* c,
                                 const void* s, int64_t n, const void* midx,
                                 const void* dt, const void* ox, const void* oy,
                                 const void* oc, const void* os,
                                 const void* res, const void* height, const void* width,
                                 int full_h, int full_w, double eps, double max_range,
                                 int iters, int is_double, void* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? rays<double>(x, y, c, s, n, midx, dt, ox, oy, oc, os, res, height,
                                   width, full_h, full_w, eps, max_range, iters, out, st)
                   : rays<float>(x, y, c, s, n, midx, dt, ox, oy, oc, os, res, height,
                                 width, full_h, full_w, eps, max_range, iters, out, st);
}

// The beams form: out[k, b] = the march of beam b of pose row k (x, y,
// theta), rows x beams rays along the theta tables (theta_dis,), on map
// midx[k] of the stack (midx null: one map).
extern "C" int march_beams_launch(const void* pose, const void* cos_tab,
                                  const void* sin_tab, int64_t rows, int beams,
                                  int theta_dis, double half_fov, double bins_per_rad,
                                  double inc, const void* midx, const void* dt,
                                  const void* ox, const void* oy, const void* oc,
                                  const void* os,
                                  const void* res, const void* height,
                                  const void* width, int full_h, int full_w, double eps,
                                  double max_range, int iters, int is_double, void* out,
                                  void* stream) {
  if (rows <= 0 || beams <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double
             ? beams_<double>(pose, cos_tab, sin_tab, rows, beams, theta_dis, half_fov,
                              bins_per_rad, inc, midx, dt, ox, oy, oc, os, res, height,
                              width, full_h, full_w, eps, max_range, iters, out, st)
             : beams_<float>(pose, cos_tab, sin_tab, rows, beams, theta_dis, half_fov,
                             bins_per_rad, inc, midx, dt, ox, oy, oc, os, res, height,
                             width, full_h, full_w, eps, max_range, iters, out, st);
}
