// The unfused fast scan's epilogue kernels for Hopper (sm_90a): rolled
// spectra -> scan, with the noise, iTTC and opponent tails.
//
// Replaces four TPU kernels of red_gym_tpu/ops/pallas_scan.py, one template
// each instance:
//   EDGE=false TAIL=none     theta_shuffle_blend              (_kernel)
//   EDGE=true  TAIL=none     theta_shuffle_blend_edge         (_edge_kernel)
//   EDGE=true  TAIL=ttc      theta_shuffle_blend_edge_ttc     (_edge_ttc_kernel)
//   EDGE=true  TAIL=ttc_opp  theta_shuffle_blend_edge_ttc_opp (_edge_ttc_opp_kernel)
// The math and what bounds it on the H100 are set out in
// red_gym_tpu_torch/ops/blend_kernels.py, whose *_reference functions are
// the plain PyTorch versions of these kernels.
//
// One block of THREADS threads handles ROWS consecutive rows (cars):
//   stage    the rows' rolled spectra (range, and e and w with EDGE) go to
//            shared memory, the e/w spectra rounded to bf16 when ew_bf16;
//            the rows' opponent packs go to dynamic shared memory;
//   taps     each thread owns beams b, b + THREADS, ...: three range taps
//            against gmat blocks 0-2 (and four e/w taps against blocks 0-1,
//            whose gmat values are rounded to bf16 when ew_bf16) summed over
//            the 128 lanes for all ROWS rows, float4 shared-memory
//            broadcasts, gmat columns from L2;
//   render   the plain 3-tap blend, or the edge ramp through the active
//            pair; mask, clip;
//   tail     with TAIL >= ttc, the env's noise row (row k belongs to env
//            k / agents_per_env) is added and the iTTC test runs (a row's
//            hit is the OR over its beams); with ttc_opp, each opponent then
//            shortens the beams inside its window [lo, hi] of absolute beam
//            indices.
// No tensor cores: the taps are float32 FMAs, so no TF32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "scan_tail.cuh"

namespace {

using namespace scan_tail;

constexpr int T = 128;        // theta bins
constexpr int ROWS = 8;       // rows per block
constexpr int THREADS = 256;  // threads per block

enum Tail { TAIL_NONE = 0, TAIL_TTC = 1, TAIL_TTC_OPP = 2 };

// Two blocks per SM: at 256 threads that caps ptxas at 128 registers a
// thread.  Left free, the edge + iTTC instance took 139 and ran at one block
// per SM, 1.4x slower than the opponent instance at 128.
template <bool EDGE, int TAIL, typename NoiseT>
__global__ void __launch_bounds__(THREADS, 2)
theta_blend_kernel(const float* __restrict__ spec_r, const float* __restrict__ spec_e,
                   const float* __restrict__ spec_w, int ld, const float* __restrict__ fs,
                   const float* __restrict__ wsum, const float* __restrict__ vel,
                   const float* __restrict__ gmat, const float* __restrict__ c_frac,
                   const NoiseT* __restrict__ noise, const float* __restrict__ cosv,
                   const float* __restrict__ sinv, const float* __restrict__ side,
                   const float* __restrict__ opp, int n_opp, float* __restrict__ out,
                   float* __restrict__ hit, int K, int B, int agents_per_env,
                   float max_range, float ttc_thresh, int ew_bf16) {
  constexpr int NCH = EDGE ? 3 : 1;   // spectra per row
  constexpr int NTAP = EDGE ? 7 : 3;  // tap sums per row and beam
  extern __shared__ float row_opp[];  // [ROWS][n_opp][OPP_PACK]
  __shared__ __align__(16) float ss[ROWS][NCH][T];
  __shared__ float row_fs[ROWS], row_wsum[ROWS], row_vel[ROWS];
  __shared__ int row_hit[ROWS];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;

  // ---- stage the spectra, packs and per-row scalars -------------------------
  for (int it = tid; it < ROWS * NCH * T; it += THREADS) {
    const int r = it / (NCH * T), c = (it / T) % NCH, t = it % T;
    const int k = row0 + r;
    float v = 0.f;
    if (k < K) {
      const float* src = c == 0 ? spec_r : (c == 1 ? spec_e : spec_w);
      v = src[(size_t)k * ld + t];
      // the e/w taps take bf16 inputs (a bf16 x bf16 -> float32 product)
      if (c > 0 && ew_bf16) v = round_bf16(v);
    }
    ss[r][c][t] = v;
  }
  if constexpr (TAIL == TAIL_TTC_OPP) {
    const int pack = OPP_PACK * n_opp;
    for (int it = tid; it < ROWS * pack; it += THREADS) {
      const int k = row0 + it / pack;
      row_opp[it] = k < K ? opp[(size_t)k * pack + it % pack] : 0.f;
    }
  }
  if (tid < ROWS) {
    const int k = row0 + tid;
    row_fs[tid] = k < K ? fs[k] : 0.f;
    row_wsum[tid] = k < K ? wsum[k] : 0.f;
    float v = 0.f;
    if constexpr (TAIL != TAIL_NONE) v = k < K ? vel[k] : 0.f;
    row_vel[tid] = v;
    row_hit[tid] = 0;
  }
  __syncthreads();

  // ---- taps, render and tail -------------------------------------------------
  const size_t ld_g = 3 * (size_t)B;
  for (int b = tid; b < B; b += THREADS) {
    float acc[ROWS][NTAP];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int q = 0; q < NTAP; ++q) acc[r][q] = 0.f;
    for (int j = 0; j < T; j += 4) {
      float g0[4], g1[4], g2[4], g0b[4], g1b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* g = gmat + (size_t)(j + q) * ld_g + b;
        g0[q] = g[0];
        g1[q] = g[B];
        g2[q] = g[2 * B];
        if constexpr (EDGE) {
          g0b[q] = ew_bf16 ? round_bf16(g0[q]) : g0[q];
          g1b[q] = ew_bf16 ? round_bf16(g1[q]) : g1[q];
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 sr = *reinterpret_cast<const float4*>(&ss[r][0][j]);
        const float vr[4] = {sr.x, sr.y, sr.z, sr.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][0] += vr[q] * g0[q];
          acc[r][1] += vr[q] * g1[q];
          acc[r][2] += vr[q] * g2[q];
        }
        if constexpr (EDGE) {
          const float4 se = *reinterpret_cast<const float4*>(&ss[r][1][j]);
          const float4 sw = *reinterpret_cast<const float4*>(&ss[r][2][j]);
          const float ve[4] = {se.x, se.y, se.z, se.w};
          const float vw[4] = {sw.x, sw.y, sw.z, sw.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][3] += ve[q] * g0b[q];
            acc[r][4] += ve[q] * g1b[q];
            acc[r][5] += vw[q] * g0b[q];
            acc[r][6] += vw[q] * g1b[q];
          }
        }
      }
    }
    const float cf = c_frac[b];
    float cb = 0.f, sd = 0.f, sb = 0.f;
    if constexpr (TAIL != TAIL_NONE) {
      cb = cosv[b];
      sd = side[b];
    }
    if constexpr (TAIL == TAIL_TTC_OPP) sb = sinv[b];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int k = row0 + r;
      if (k >= K) continue;
      const float alpha = row_fs[r] + cf;
      float o;
      if constexpr (EDGE) {
        // the ramp through the active pair (0, 1) or (1, 2); a smooth pair
        // (e, w) = (0.5, 1) is the lerp
        const bool lt = alpha < 1.f;
        const float frac = alpha - floorf(alpha);
        const float ga = lt ? acc[r][0] : acc[r][1];
        const float gb = lt ? acc[r][1] : acc[r][2];
        const float e_sel = clampf(lt ? acc[r][3] : acc[r][4], 0.f, 1.f);
        const float w_sel = clampf(lt ? acc[r][5] : acc[r][6], 1.f / 32.f, 1.f);
        const float aa = clampf((frac - (e_sel - 0.5f * w_sel)) / w_sel, 0.f, 1.f);
        o = ga + aa * (gb - ga);
      } else {
        const float w0 = fmaxf(1.f - alpha, 0.f);
        const float w2 = fmaxf(alpha - 1.f, 0.f);
        const float w1 = 1.f - w0 - w2;
        o = w0 * acc[r][0] + w1 * acc[r][1] + w2 * acc[r][2];
      }
      o = row_wsum[r] > 0.f ? o : 0.f;
      o = clampf(o, 0.f, max_range);
      if constexpr (TAIL != TAIL_NONE) {
        o = __fadd_rn(o, load_f(noise, (size_t)(k / agents_per_env) * B + b));
        if (ttc_hit(o, row_vel[r], cb, sd, ttc_thresh)) row_hit[r] = 1;
        // opponents shorten the noisy scan after the iTTC test, as the TPU
        // kernel orders it: the wall hit flags come from the pre-opponent scan
        if constexpr (TAIL == TAIL_TTC_OPP)
          o = opp_cast(o, &row_opp[r * n_opp * OPP_PACK], n_opp, b, cb, sb);
      }
      out[(size_t)k * B + b] = o;
    }
  }
  if constexpr (TAIL != TAIL_NONE) {
    __syncthreads();
    if (tid < ROWS && row0 + tid < K) hit[row0 + tid] = row_hit[tid] ? 1.f : 0.f;
  }
}

template <bool EDGE, int TAIL, typename NoiseT>
int launch(const void* spec_r, const void* spec_e, const void* spec_w, int ld,
           const void* fs, const void* wsum, const void* vel, const void* gmat,
           const void* c_frac, const void* noise, const void* cosv, const void* sinv,
           const void* side, const void* opp, int n_opp, void* out, void* hit, int K,
           int B, int agents_per_env, float max_range, float ttc_thresh, int ew_bf16,
           cudaStream_t stream) {
  const dim3 grid((K + ROWS - 1) / ROWS), block(THREADS);
  const size_t smem = sizeof(float) * ROWS * OPP_PACK * (size_t)n_opp;
  auto kernel = theta_blend_kernel<EDGE, TAIL, NoiseT>;
  if (smem > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so that it is not reported again later
      return static_cast<int>(err);
    }
  }
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const float*>(spec_r), static_cast<const float*>(spec_e),
      static_cast<const float*>(spec_w), ld, static_cast<const float*>(fs),
      static_cast<const float*>(wsum), static_cast<const float*>(vel),
      static_cast<const float*>(gmat), static_cast<const float*>(c_frac),
      static_cast<const NoiseT*>(noise), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<const float*>(side),
      static_cast<const float*>(opp), n_opp, static_cast<float*>(out),
      static_cast<float*>(hit), K, B, agents_per_env, max_range, ttc_thresh, ew_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer to
// float32 unless stated.  spec_r (and with edge spec_e, spec_w) are (K, T)
// with row stride ld; fs, wsum and vel are (K,); gmat is (T, 3B); c_frac,
// cosv, sinv and side are (B,); noise is (K / agents_per_env, B), bf16 when
// noise_bf16; opp is (K, 10 * n_opp).  tail: 0 none, 1 noise + iTTC, 2 noise
// + iTTC + opponents (needs edge).  Pointers a variant does not read may be
// null.  Launches on `stream` and returns the CUDA error: non-zero means the
// launch did not happen (cudaErrorInvalidValue for a variant that does not
// exist).
extern "C" int theta_blend_launch(const void* spec_r, const void* spec_e,
                                  const void* spec_w, int ld, const void* fs,
                                  const void* wsum, const void* vel, const void* gmat,
                                  const void* c_frac, const void* noise, int noise_bf16,
                                  const void* cosv, const void* sinv, const void* side,
                                  const void* opp, int n_opp, void* out, void* hit,
                                  int K, int B, int agents_per_env, float max_range,
                                  float ttc_thresh, int edge, int tail, int ew_bf16,
                                  void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BLEND_ARGS                                                                     \
  spec_r, spec_e, spec_w, ld, fs, wsum, vel, gmat, c_frac, noise, cosv, sinv, side, opp, \
      n_opp, out, hit, K, B, agents_per_env, max_range, ttc_thresh, ew_bf16, s
  if (!edge && tail == TAIL_NONE) return launch<false, TAIL_NONE, float>(BLEND_ARGS);
  if (edge && tail == TAIL_NONE) return launch<true, TAIL_NONE, float>(BLEND_ARGS);
  if (edge && tail == TAIL_TTC)
    return noise_bf16 ? launch<true, TAIL_TTC, __nv_bfloat16>(BLEND_ARGS)
                      : launch<true, TAIL_TTC, float>(BLEND_ARGS);
  if (edge && tail == TAIL_TTC_OPP)
    return noise_bf16 ? launch<true, TAIL_TTC_OPP, __nv_bfloat16>(BLEND_ARGS)
                      : launch<true, TAIL_TTC_OPP, float>(BLEND_ARGS);
#undef BLEND_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
