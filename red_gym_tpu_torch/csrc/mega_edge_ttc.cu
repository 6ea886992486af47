// Scan megakernel for Hopper (sm_90a): texture rows -> noisy scan + iTTC,
// optionally with the opponent ray cast and a resident noise pool.
//
// Replaces red_gym_tpu/ops/pallas_scan.py::mega_edge_ttc (_mega_kernel) in
// all four of its variants: plain, opponents (n_opp > 0, the TPU kernel's
// _opp_raycast_tile), resident pool (pool_rows > 0, noise_mode="pool_rot"),
// and both; each variant is a template instance of its own (<OPP, POOL,
// texture type, noise type>), so the plain one carries no opponent code.
// The math, row by row, and what bounds it on the H100 are set out in
// red_gym_tpu_torch/ops/scan_kernels.py, whose mega_edge_ttc_reference is
// the plain PyTorch version of this kernel.
//
// One block of THREADS threads handles ROWS consecutive rows (cars):
//   phase 1  each (row, bin) item reads its texture row directly (the gather
//            lives here), applies the gradient fold and the corner-bearing
//            parallax, and stages the three corrected channels in shared
//            memory; the rows' opponent packs (10 floats per opponent) are
//            staged in dynamic shared memory;
//   phase 2  thread (j, half) forms spectral lane j of the packed rfft for
//            half of the rows (summed in float64), then the integer-roll
//            twiddle; the T/2 column rotation of fmat_sw is the lane index
//            (j + T/2) % T; e/w spectra are rounded to bf16 when ew_bf16;
//   phase 3  each thread owns beams b, b + THREADS, ...: seven tap sums over
//            the 128 lanes for all ROWS rows (float4 shared-memory
//            broadcasts, gmat columns from L2), then the edge-ramp render,
//            mask, clip, noise add and iTTC test (a row's hit is the OR over
//            its beams), then the slab test against each opponent inside its
//            blocked beam window [lo, hi].
// Noise: env g = k / agents_per_env reads row g of an (E, B) slab, or, with
// pool_rows > 0, row (g + (*pool_off & ~15)) % pool_rows of the resident
// (pool_rows, B) pool (2.2 MB at 1024 x 1080 in bf16, held in L2).  The
// offset is read on the device, so the host never waits for it.
// Two blocks a SM, pinned by __launch_bounds__(THREADS, MIN_BLOCKS): each
// thread then has 128 registers, and one block's phases 1-2 run while the
// other's phase 3 multiplies.
// No tensor cores: the taps are float32 FMAs, so no TF32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <stddef.h>

namespace {

constexpr int T = 128;        // theta bins
constexpr int HALF = T / 2;
constexpr int CH = 5;         // texture channels [R | e | w | gx | gy]
constexpr int ROWS = 8;       // rows per block
constexpr int THREADS = 256;  // threads per block
constexpr int MIN_BLOCKS = 2; // resident blocks a SM
constexpr float TWO_PI = 6.283185307179586f;
constexpr float DTH = TWO_PI / T;  // exact: division by a power of two
constexpr float INV_TWO_PI = (float)(1.0 / 6.283185307179586);
constexpr float INV_DTH = (float)(T / 6.283185307179586);
constexpr int OPP_PACK = 10;  // [lo, hi, a_u, b_u, a_w, b_w, o_u, o_w, hu, hw]

static_assert(THREADS == 2 * T, "phase 2 maps two threads to each lane");
static_assert(ROWS % 2 == 0, "phase 2 splits the rows in halves");

__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// torch.minimum / torch.maximum: NaN-propagating, unlike fminf / fmaxf
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// One slab of the ray-vs-box test (agent_scan._slab): entry and exit ray
// parameters; a beam parallel to the slab is inside it everywhere or never.
// Each operation is rounded on its own, as the plain twin's PyTorch code
// rounds it; 1/d is a correctly rounded reciprocal, as torch's.
__device__ __forceinline__ void slab_axis(float o, float d, float h, float& nr,
                                          float& fr) {
  const float inv = __frcp_rn(d);
  const float t1 = __fmul_rn(__fsub_rn(-h, o), inv);
  const float t2 = __fmul_rn(__fsub_rn(h, o), inv);
  nr = nan_min(t1, t2);
  fr = nan_max(t1, t2);
  if (d == 0.f) {
    const bool inside = fabsf(o) <= h;
    nr = inside ? -CUDART_INF_F : CUDART_INF_F;
    fr = inside ? CUDART_INF_F : -CUDART_INF_F;
  }
}

// Ray parameter at which beam (cos_b, sin_b) meets the opponent box of pack
// p, or +inf (the in-kernel form of agent_scan.ray_cast_opponent).
__device__ __forceinline__ float opp_hit(const float* p, float cb, float sb) {
  const float d_u = __fadd_rn(__fmul_rn(p[2], cb), __fmul_rn(p[3], sb));
  const float d_w = __fadd_rn(__fmul_rn(p[4], cb), __fmul_rn(p[5], sb));
  float near_u, far_u, near_w, far_w;
  slab_axis(p[6], d_u, p[8], near_u, far_u);
  slab_axis(p[7], d_w, p[9], near_w, far_w);
  const float tmin = nan_max(near_u, near_w);
  const float tmax = nan_min(far_u, far_w);
  const bool hit = tmax >= tmin && tmax >= 0.f;
  const float t = tmin >= 0.f ? tmin : tmax;  // from inside: exit distance
  return hit ? t : CUDART_INF_F;
}

template <bool OPP, bool POOL, typename TexT, typename NoiseT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mega_edge_ttc_kernel(const TexT* __restrict__ rt, const int* __restrict__ rows,
                     const float* __restrict__ scal, const float* __restrict__ fmat,
                     const float* __restrict__ gmat, const float* __restrict__ c_frac,
                     const NoiseT* __restrict__ noise, const float* __restrict__ cosv,
                     const float* __restrict__ side, float* __restrict__ out,
                     float* __restrict__ hit, int K, int B, int agents_per_env,
                     float max_range, float ttc_thresh, int ew_bf16,
                     const float* __restrict__ sinv, const float* __restrict__ opp,
                     int n_opp, const int* __restrict__ pool_off, int pool_rows) {
  extern __shared__ float row_opp[];               // [ROWS][n_opp][OPP_PACK]
  __shared__ __align__(16) float xs[ROWS][3][T];  // corrected range, e, w
  __shared__ __align__(16) float ss[ROWS][3][T];  // rolled packed spectra
  __shared__ float row_fs[ROWS], row_wsum[ROWS], row_vel[ROWS];
  __shared__ int row_ii[ROWS], row_hit[ROWS];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;

  // ---- phase 1: gather + gradient fold + parallax --------------------------
  for (int it = tid; it < ROWS * T; it += THREADS) {
    const int r = it / T, t = it % T;
    const int k = row0 + r;
    float v_r = 0.f, v_e = 0.f, v_w = 0.f;
    if (k < K) {
      const TexT* row = rt + (size_t)rows[k] * (CH * T);
      const float R = load_f(row, t);
      const float R_next = load_f(row, (t + 1) % T);
      const float e = load_f(row, T + t);
      const float w = load_f(row, 2 * T + t);
      const float gx = load_f(row, 3 * T + t);
      const float gy = load_f(row, 4 * T + t);
      const float dx = scal[(size_t)k * 8 + 0];
      const float dy = scal[(size_t)k * 8 + 1];
      // every operation below is rounded on its own (no FMA contraction),
      // as the plain twin's one-operator-per-step PyTorch code rounds it:
      // these values are rounded to bf16 further on, and a last-bit
      // difference there can move a hard edge
      v_r = clampf(__fadd_rn(__fadd_rn(R, __fmul_rn(dx, gx)), __fmul_rn(dy, gy)),
                   0.f, max_range);
      // the visibility edge is a fixed world point: rebuild it from the
      // stored sub-bin angle and the foreground range, re-bear it from the pose
      const float theta_e = __fmul_rn(__fadd_rn((float)t, e), DTH);
      const float r_fore = fmaxf(fminf(R, R_next), 0.05f);
      const float ex = __fsub_rn(__fmul_rn(r_fore, cosf(theta_e)), dx);
      const float ey = __fsub_rn(__fmul_rn(r_fore, sinf(theta_e)), dy);
      float dbeta = __fsub_rn(atan2f(ey, ex), theta_e);
      dbeta = __fsub_rn(dbeta, __fmul_rn(rintf(__fmul_rn(dbeta, INV_TWO_PI)), TWO_PI));
      v_e = __fadd_rn(e, __fmul_rn(__fmul_rn(__fsub_rn(1.f, w), dbeta), INV_DTH));
      v_w = w;
    }
    xs[r][0][t] = v_r;
    xs[r][1][t] = v_e;
    xs[r][2][t] = v_w;
  }
  const int pack = OPP ? OPP_PACK * n_opp : 0;
  for (int it = tid; it < ROWS * pack; it += THREADS) {
    const int k = row0 + it / pack;
    row_opp[it] = k < K ? opp[(size_t)k * pack + it % pack] : 0.f;
  }
  if (tid < ROWS) {
    const int k = row0 + tid;
    float fs = 0.f, wsum = 0.f, vel = 0.f;
    int ii = 0;
    if (k < K) {
      const float R0 = load_f(rt + (size_t)rows[k] * (CH * T), 0);
      fs = scal[(size_t)k * 8 + 2];
      ii = (int)scal[(size_t)k * 8 + 3];
      wsum = scal[(size_t)k * 8 + 4] * fminf(R0 * 1e3f, 1.f);
      vel = scal[(size_t)k * 8 + 5];
    }
    row_fs[tid] = fs;
    row_wsum[tid] = wsum;
    row_vel[tid] = vel;
    row_ii[tid] = ii;
    row_hit[tid] = 0;
  }
  __syncthreads();

  // ---- phase 2: packed rfft (X @ fmat) and the integer-roll twiddle --------
  // The spectra are summed in float64 and rounded once to float32, so they
  // do not depend on the order of summation: the e/w spectra are rounded to
  // bf16 next, and the plain twin must land on the same bf16 values.
  {
    const int j = tid % T;
    const int rb = (tid / T) * (ROWS / 2);
    double acc[ROWS / 2][3];
#pragma unroll
    for (int r = 0; r < ROWS / 2; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[r][c] = 0.0;
    for (int t = 0; t < T; t += 4) {
      const double f0 = fmat[(t + 0) * T + j];
      const double f1 = fmat[(t + 1) * T + j];
      const double f2 = fmat[(t + 2) * T + j];
      const double f3 = fmat[(t + 3) * T + j];
#pragma unroll
      for (int r = 0; r < ROWS / 2; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(&xs[rb + r][c][t]);
          acc[r][c] += (double)x.x * f0 + (double)x.y * f1 + (double)x.z * f2 +
                       (double)x.w * f3;
        }
    }
#pragma unroll
    for (int r = 0; r < ROWS / 2; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) ss[rb + r][c][j] = (float)acc[r][c];
    __syncthreads();

    // lanes [Re 0..T/2 | Im 1..T/2-1]; spec_sw[j] = spec[(j + T/2) % T]
    const int l_eff = j <= HALF ? j : j - HALF;
    const int jsw = (j + HALF) % T;
    float rolled[ROWS / 2][3];
#pragma unroll
    for (int r = 0; r < ROWS / 2; ++r) {
      const int m = (row_ii[rb + r] * l_eff) % T;
      const float phi = __fmul_rn((float)m, DTH);
      const float sp = sinf(phi), cp = cosf(phi);
      const float qr = (j >= 1 && j <= HALF - 1) ? -sp : (j >= HALF + 1 ? sp : 0.f);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        rolled[r][c] = __fadd_rn(__fmul_rn(ss[rb + r][c][j], cp),
                                 __fmul_rn(ss[rb + r][c][jsw], qr));
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS / 2; ++r) {
      ss[rb + r][0][j] = rolled[r][0];
      ss[rb + r][1][j] = ew_bf16 ? round_bf16(rolled[r][1]) : rolled[r][1];
      ss[rb + r][2][j] = ew_bf16 ? round_bf16(rolled[r][2]) : rolled[r][2];
    }
  }
  __syncthreads();

  // ---- phase 3: taps, edge-ramp render, noise, iTTC, opponents -------------
  const size_t ld = 3 * (size_t)B;
  const int off = POOL ? (*pool_off & ~15) : 0;
  for (int b = tid; b < B; b += THREADS) {
    float acc[ROWS][7];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int q = 0; q < 7; ++q) acc[r][q] = 0.f;
    for (int j = 0; j < T; j += 4) {
      float g0[4], g1[4], g2[4], g0b[4], g1b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* g = gmat + (size_t)(j + q) * ld + b;
        g0[q] = g[0];
        g1[q] = g[B];
        g2[q] = g[2 * B];
        g0b[q] = ew_bf16 ? round_bf16(g0[q]) : g0[q];
        g1b[q] = ew_bf16 ? round_bf16(g1[q]) : g1[q];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 sr = *reinterpret_cast<const float4*>(&ss[r][0][j]);
        const float4 se = *reinterpret_cast<const float4*>(&ss[r][1][j]);
        const float4 sw = *reinterpret_cast<const float4*>(&ss[r][2][j]);
        const float vr[4] = {sr.x, sr.y, sr.z, sr.w};
        const float ve[4] = {se.x, se.y, se.z, se.w};
        const float vw[4] = {sw.x, sw.y, sw.z, sw.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][0] += vr[q] * g0[q];
          acc[r][1] += vr[q] * g1[q];
          acc[r][2] += vr[q] * g2[q];
          acc[r][3] += ve[q] * g0b[q];
          acc[r][4] += ve[q] * g1b[q];
          acc[r][5] += vw[q] * g0b[q];
          acc[r][6] += vw[q] * g1b[q];
        }
      }
    }
    const float cf = c_frac[b], cb = cosv[b], sd = side[b];
    const float sb = OPP ? sinv[b] : 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int k = row0 + r;
      if (k >= K) continue;
      const float alpha = row_fs[r] + cf;
      const bool lt = alpha < 1.f;
      const float frac = alpha - floorf(alpha);
      const float ga = lt ? acc[r][0] : acc[r][1];
      const float gb = lt ? acc[r][1] : acc[r][2];
      const float e_sel = clampf(lt ? acc[r][3] : acc[r][4], 0.f, 1.f);
      const float w_sel = clampf(lt ? acc[r][5] : acc[r][6], 1.f / 32.f, 1.f);
      const float aa = clampf((frac - (e_sel - 0.5f * w_sel)) / w_sel, 0.f, 1.f);
      float o = ga + aa * (gb - ga);
      o = row_wsum[r] > 0.f ? o : 0.f;
      o = clampf(o, 0.f, max_range);
      const int g = k / agents_per_env;
      const size_t nrow = POOL ? (size_t)((g + off) % pool_rows) : (size_t)g;
      o += load_f(noise, nrow * B + b);
      const float pv = row_vel[r] * cb;
      const float num = o - sd;
      if ((pv > 0.f && num >= 0.f && num < ttc_thresh * pv) ||
          (pv < 0.f && num <= 0.f && num > ttc_thresh * pv))
        row_hit[r] = 1;
      // opponents shorten the noisy scan after the iTTC test, as the TPU
      // kernel orders it: the wall hit flags come from the pre-opponent scan
      const float bpos = (float)b;
      if (OPP)
        for (int q = 0; q < n_opp; ++q) {
          const float* p = &row_opp[(r * n_opp + q) * OPP_PACK];
          if (bpos >= p[0] && bpos <= p[1]) o = nan_min(o, opp_hit(p, cb, sb));
        }
      out[(size_t)k * B + b] = o;
    }
  }
  __syncthreads();
  if (tid < ROWS && row0 + tid < K) hit[row0 + tid] = row_hit[tid] ? 1.f : 0.f;
}

// dynamic shared memory: the rows' opponent packs
size_t smem_bytes(int n_opp) { return sizeof(float) * ROWS * OPP_PACK * (size_t)n_opp; }

template <bool OPP, bool POOL, typename TexT, typename NoiseT>
int launch(const void* rt, const void* rows, const void* scal, const void* fmat,
           const void* gmat, const void* c_frac, const void* noise, const void* cosv,
           const void* side, void* out, void* hit, int K, int B, int agents_per_env,
           float max_range, float ttc_thresh, int ew_bf16, const void* sinv,
           const void* opp, int n_opp, const void* pool_off, int pool_rows,
           cudaStream_t stream) {
  const dim3 grid((K + ROWS - 1) / ROWS), block(THREADS);
  const size_t smem = smem_bytes(n_opp);
  auto kernel = mega_edge_ttc_kernel<OPP, POOL, TexT, NoiseT>;
  if (smem > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so that it is not reported again later
      return static_cast<int>(err);
    }
  }
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const TexT*>(rt), static_cast<const int*>(rows),
      static_cast<const float*>(scal), static_cast<const float*>(fmat),
      static_cast<const float*>(gmat), static_cast<const float*>(c_frac),
      static_cast<const NoiseT*>(noise), static_cast<const float*>(cosv),
      static_cast<const float*>(side), static_cast<float*>(out),
      static_cast<float*>(hit), K, B, agents_per_env, max_range, ttc_thresh, ew_bf16,
      static_cast<const float*>(sinv), static_cast<const float*>(opp), n_opp,
      static_cast<const int*>(pool_off), pool_rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool OPP, bool POOL, typename TexT, typename NoiseT>
int occupancy(int n_opp, int* blocks) {
  auto kernel = mega_edge_ttc_kernel<OPP, POOL, TexT, NoiseT>;
  const size_t smem = smem_bytes(n_opp);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// op.run<OPP, POOL, TexT, NoiseT>() of the instance these operands select
template <bool OPP, bool POOL, class Op>
int by_storage(int rt_bf16, int noise_bf16, const Op& op) {
  if (rt_bf16 && noise_bf16) return op.template run<OPP, POOL, __nv_bfloat16, __nv_bfloat16>();
  if (rt_bf16) return op.template run<OPP, POOL, __nv_bfloat16, float>();
  if (noise_bf16) return op.template run<OPP, POOL, float, __nv_bfloat16>();
  return op.template run<OPP, POOL, float, float>();
}
template <class Op>
int by_variant(int n_opp, int pool_rows, int rt_bf16, int noise_bf16, const Op& op) {
  if (n_opp > 0)
    return pool_rows > 0 ? by_storage<true, true>(rt_bf16, noise_bf16, op)
                         : by_storage<true, false>(rt_bf16, noise_bf16, op);
  return pool_rows > 0 ? by_storage<false, true>(rt_bf16, noise_bf16, op)
                       : by_storage<false, false>(rt_bf16, noise_bf16, op);
}

// mega_edge_ttc_launch's arguments
struct Launch {
  const void *rt, *rows, *scal, *fmat, *gmat, *c_frac, *noise, *cosv, *side;
  void *out, *hit;
  int K, B, agents_per_env;
  float max_range, ttc_thresh;
  int ew_bf16;
  const void *sinv, *opp;
  int n_opp;
  const void* pool_off;
  int pool_rows;
  cudaStream_t stream;
  template <bool OPP, bool POOL, typename TexT, typename NoiseT>
  int run() const {
    return launch<OPP, POOL, TexT, NoiseT>(rt, rows, scal, fmat, gmat, c_frac, noise, cosv,
                                          side, out, hit, K, B, agents_per_env, max_range,
                                          ttc_thresh, ew_bf16, sinv, opp, n_opp, pool_off,
                                          pool_rows, stream);
  }
};

struct Occupancy {
  int n_opp;
  int* blocks;
  template <bool OPP, bool POOL, typename TexT, typename NoiseT>
  int run() const { return occupancy<OPP, POOL, TexT, NoiseT>(n_opp, blocks); }
};

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer; scal
// is (K, 8) float32 [dx, dy, f_s, i_f, inb, vel, -, -]; rt is (N, 5*128)
// bf16 (rt_bf16) or float32; noise is bf16 (noise_bf16) or float32, either
// (K / agents_per_env, B) or, with pool_rows > 0, the (pool_rows, B) pool
// with pool_off a 1-element int32.  With n_opp > 0, sinv is (B,) float32 and
// opp is (K, 10 * n_opp) float32.  Launches on `stream` and returns the CUDA
// error: non-zero means the launch did not happen.
extern "C" int mega_edge_ttc_launch(const void* rt, int rt_bf16, const void* rows,
                                    const void* scal, const void* fmat, const void* gmat,
                                    const void* c_frac, const void* noise, int noise_bf16,
                                    const void* cosv, const void* side, void* out,
                                    void* hit, int K, int B, int agents_per_env,
                                    float max_range, float ttc_thresh, int ew_bf16,
                                    const void* sinv, const void* opp, int n_opp,
                                    const void* pool_off, int pool_rows, void* stream) {
  if (K <= 0) return 0;
  const Launch op{rt, rows, scal, fmat, gmat, c_frac, noise, cosv, side, out, hit, K, B,
                  agents_per_env, max_range, ttc_thresh, ew_bf16, sinv, opp, n_opp, pool_off,
                  pool_rows, static_cast<cudaStream_t>(stream)};
  return by_variant(n_opp, pool_rows, rt_bf16, noise_bf16, op);
}

// Blocks of THREADS threads that one SM holds at once of the instance that
// n_opp, pool_rows, rt_bf16 and noise_bf16 select (as mega_edge_ttc_launch
// selects it), at its shared memory; returns the CUDA error.
extern "C" int mega_edge_ttc_occupancy(int n_opp, int pool_rows, int rt_bf16, int noise_bf16,
                                       int* blocks) {
  *blocks = 0;
  return by_variant(n_opp, pool_rows, rt_bf16, noise_bf16, Occupancy{n_opp, blocks});
}
