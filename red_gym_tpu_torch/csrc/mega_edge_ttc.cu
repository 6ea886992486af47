// Scan megakernel for Hopper (sm_90a): texture rows -> noisy scan + iTTC.
//
// Replaces red_gym_tpu/ops/pallas_scan.py::mega_edge_ttc (_mega_kernel),
// plain variant.  The math, row by row, and what bounds it on the H100 are
// set out in red_gym_tpu_torch/ops/scan_kernels.py, whose
// mega_edge_ttc_reference is the plain PyTorch version of this kernel.
//
// One block of THREADS threads handles ROWS consecutive rows (cars):
//   phase 1  each (row, bin) item reads its texture row directly (the gather
//            lives here), applies the gradient fold and the corner-bearing
//            parallax, and stages the three corrected channels in shared
//            memory;
//   phase 2  thread (j, half) forms spectral lane j of the packed rfft for
//            half of the rows (summed in float64), then the integer-roll
//            twiddle; the T/2 column rotation of fmat_sw is the lane index
//            (j + T/2) % T; e/w spectra are rounded to bf16 when ew_bf16;
//   phase 3  each thread owns beams b, b + THREADS, ...: seven tap sums over
//            the 128 lanes for all ROWS rows (float4 shared-memory
//            broadcasts, gmat columns from L2), then the edge-ramp render,
//            mask, clip, noise add and iTTC test; a row's hit is the OR
//            over its beams.
// No tensor cores: the taps are float32 FMAs, so no TF32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int T = 128;        // theta bins
constexpr int HALF = T / 2;
constexpr int CH = 5;         // texture channels [R | e | w | gx | gy]
constexpr int ROWS = 8;       // rows per block
constexpr int THREADS = 256;  // threads per block
constexpr float TWO_PI = 6.283185307179586f;
constexpr float DTH = TWO_PI / T;  // exact: division by a power of two
constexpr float INV_TWO_PI = (float)(1.0 / 6.283185307179586);
constexpr float INV_DTH = (float)(T / 6.283185307179586);

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

template <typename TexT, typename NoiseT>
__global__ void __launch_bounds__(THREADS)
mega_edge_ttc_kernel(const TexT* __restrict__ rt, const int* __restrict__ rows,
                     const float* __restrict__ scal, const float* __restrict__ fmat,
                     const float* __restrict__ gmat, const float* __restrict__ c_frac,
                     const NoiseT* __restrict__ noise, const float* __restrict__ cosv,
                     const float* __restrict__ side, float* __restrict__ out,
                     float* __restrict__ hit, int K, int B, int agents_per_env,
                     float max_range, float ttc_thresh, int ew_bf16) {
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

  // ---- phase 3: taps, edge-ramp render, noise, iTTC ------------------------
  const size_t ld = 3 * (size_t)B;
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
      o += load_f(noise, (size_t)(k / agents_per_env) * B + b);
      out[(size_t)k * B + b] = o;
      const float pv = row_vel[r] * cb;
      const float num = o - sd;
      if ((pv > 0.f && num >= 0.f && num < ttc_thresh * pv) ||
          (pv < 0.f && num <= 0.f && num > ttc_thresh * pv))
        row_hit[r] = 1;
    }
  }
  __syncthreads();
  if (tid < ROWS && row0 + tid < K) hit[row0 + tid] = row_hit[tid] ? 1.f : 0.f;
}

template <typename TexT, typename NoiseT>
void launch(const void* rt, const void* rows, const void* scal, const void* fmat,
            const void* gmat, const void* c_frac, const void* noise, const void* cosv,
            const void* side, void* out, void* hit, int K, int B, int agents_per_env,
            float max_range, float ttc_thresh, int ew_bf16, cudaStream_t stream) {
  const dim3 grid((K + ROWS - 1) / ROWS), block(THREADS);
  mega_edge_ttc_kernel<TexT, NoiseT><<<grid, block, 0, stream>>>(
      static_cast<const TexT*>(rt), static_cast<const int*>(rows),
      static_cast<const float*>(scal), static_cast<const float*>(fmat),
      static_cast<const float*>(gmat), static_cast<const float*>(c_frac),
      static_cast<const NoiseT*>(noise), static_cast<const float*>(cosv),
      static_cast<const float*>(side), static_cast<float*>(out),
      static_cast<float*>(hit), K, B, agents_per_env, max_range, ttc_thresh, ew_bf16);
}

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer; scal
// is (K, 8) float32 [dx, dy, f_s, i_f, inb, vel, 0, 0]; rt is (N, 5*128)
// bf16 (rt_bf16) or float32; noise is (K / agents_per_env, B) bf16
// (noise_bf16) or float32.  Launches on `stream` and returns
// cudaGetLastError(): non-zero means the launch did not happen.
extern "C" int mega_edge_ttc_launch(const void* rt, int rt_bf16, const void* rows,
                                    const void* scal, const void* fmat, const void* gmat,
                                    const void* c_frac, const void* noise, int noise_bf16,
                                    const void* cosv, const void* side, void* out,
                                    void* hit, int K, int B, int agents_per_env,
                                    float max_range, float ttc_thresh, int ew_bf16,
                                    void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rt_bf16 && noise_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(rt, rows, scal, fmat, gmat, c_frac, noise, cosv,
                                         side, out, hit, K, B, agents_per_env, max_range,
                                         ttc_thresh, ew_bf16, s);
  else if (rt_bf16)
    launch<__nv_bfloat16, float>(rt, rows, scal, fmat, gmat, c_frac, noise, cosv, side,
                                 out, hit, K, B, agents_per_env, max_range, ttc_thresh,
                                 ew_bf16, s);
  else if (noise_bf16)
    launch<float, __nv_bfloat16>(rt, rows, scal, fmat, gmat, c_frac, noise, cosv, side,
                                 out, hit, K, B, agents_per_env, max_range, ttc_thresh,
                                 ew_bf16, s);
  else
    launch<float, float>(rt, rows, scal, fmat, gmat, c_frac, noise, cosv, side, out, hit,
                         K, B, agents_per_env, max_range, ttc_thresh, ew_bf16, s);
  return static_cast<int>(cudaGetLastError());
}
