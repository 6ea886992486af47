// The unfused fast scan's epilogue kernels for Hopper (sm_90a): rolled
// spectra -> scan, with the noise, iTTC and opponent tails.
//
// Replaces four TPU kernels of red_gym_tpu/ops/pallas_scan.py:
//   theta_shuffle_blend              (_kernel)               theta_shuffle_blend_kernel
//   theta_shuffle_blend_edge         (_edge_kernel)          theta_blend_kernel TAIL=none
//   theta_shuffle_blend_edge_ttc     (_edge_ttc_kernel)      theta_blend_kernel TAIL=ttc
//   theta_shuffle_blend_edge_ttc_opp (_edge_ttc_opp_kernel)  theta_blend_kernel TAIL=ttc_opp
// The math and what bounds them on the H100 (float32 FMAs) are set out in
// red_gym_tpu_torch/ops/blend_kernels.py, whose *_reference functions are
// the plain PyTorch versions of these kernels.
//
// theta_shuffle_blend_kernel (kernel 7) is one plain product, spec_r (K, T)
// @ gmat (T, 3B), and an elementwise blend: rowtile_gemm.cuh's mainloop with
// three slabs (gmat's taps 0-2 of the same beams), 8 rows x 4 beams x 3 taps
// in each thread's registers, then the 3-tap blend with weights from
// alpha = f_s + c_frac, mask and clip on those registers, each operation
// rounded as the plain twin rounds it, and float4 stores.  One block of 256
// threads a SM: the 96 accumulators need more than the 128 registers a
// thread that two such blocks leave.
//
// theta_blend_kernel (the edge forms 6, 3 and 4) is edge_render.cuh's
// seven-tap register tile with no tail (6), the noise + iTTC tail (3) or
// that and the opponent cast (4); each form and noise type is an instance of
// its own, so the plain render carries no tail code.
// No tensor cores: the taps are float32 FMAs, so no TF32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "edge_render.cuh"
#include "rowtile_gemm.cuh"
#include "scan_tail.cuh"

namespace {

using namespace scan_tail;

using edge_render::TAIL_NONE;
using edge_render::TAIL_TTC;
using edge_render::TAIL_TTC_OPP;

template <int TAIL, typename NoiseT>
__global__ void __launch_bounds__(edge_render::THREADS, edge_render::MIN_BLOCKS)
theta_blend_kernel(const edge_render::Params p) {
  extern __shared__ __align__(16) float smem[];
  edge_render::run<TAIL, false, NoiseT>(smem, p);
}

// ---- kernel 7: the plain 3-tap blend on rowtile_gemm.cuh's mainloop ---------

template <bool VEC>
using Blend = rowtile::Tile<4, 3, VEC, 256>;

template <bool VEC>
struct BlendTail {
  using C = Blend<VEC>;
  const float* __restrict__ fs;
  const float* __restrict__ wsum;
  const float* __restrict__ c_frac;
  float* __restrict__ out;
  int K, B;
  float max_range;
  float* s_fs;  // [BM] each, in shared memory
  float* s_wsum;

  __device__ void rows(int row0, int tid) const {
    if (tid < C::BM) {
      const int k = row0 + tid;
      s_fs[tid] = k < K ? fs[k] : 0.f;
      s_wsum[tid] = k < K ? wsum[k] : 0.f;
    }
  }

  __device__ void prefetch(int, int, int) const {}

  // out = w0 g0 + w1 g1 + w2 g2, masked and clipped; every operation rounded
  // on its own, as the twin's PyTorch ops round it
  __device__ void tile(const float (&acc)[rowtile::TM][C::NACC], int row0, int b0, int tx,
                       int ty) const {
    const int b = b0 + tx * 4;
    if (b >= B) return;
    float cf[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) cf[q] = b + q < B ? c_frac[b + q] : 0.f;
#pragma unroll
    for (int i = 0; i < rowtile::TM; ++i) {
      const int r = C::row_of(i, ty), k = row0 + r;
      if (k >= K) continue;
      const float f = s_fs[r];
      const bool live = s_wsum[r] > 0.f;
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float alpha = __fadd_rn(f, cf[q]);
        const float w0 = fmaxf(__fsub_rn(1.f, alpha), 0.f);
        const float w2 = fmaxf(__fsub_rn(alpha, 1.f), 0.f);
        const float w1 = __fsub_rn(__fsub_rn(1.f, w0), w2);
        const float v = __fadd_rn(__fadd_rn(__fmul_rn(w0, acc[i][q]), __fmul_rn(w1, acc[i][4 + q])),
                                  __fmul_rn(w2, acc[i][8 + q]));
        o[q] = clampf(live ? v : 0.f, 0.f, max_range);
      }
      float* orow = out + (size_t)k * B;
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(orow + b) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (b + q < B) orow[b + q] = o[q];
      }
    }
  }

  __device__ void flush(int, int) const {}
};

template <bool VEC>
__global__ void __launch_bounds__(256, 1)
theta_shuffle_blend_kernel(const float* __restrict__ spec_r, int ld,
                           const float* __restrict__ fs, const float* __restrict__ wsum,
                           const float* __restrict__ gmat, const float* __restrict__ c_frac,
                           float* __restrict__ out, int K, int B, float max_range) {
  using C = Blend<VEC>;
  extern __shared__ __align__(16) float smem[];
  float* s_row = smem + C::ROW_OFF;
  const BlendTail<VEC> tail{fs, wsum, c_frac, out, K, B, max_range, s_row, s_row + C::BM};
  rowtile::run<C>(smem, spec_r, ld, gmat, K, B, tail);
}

template <bool VEC>
int launch_plain(const void* spec_r, int ld, const void* fs, const void* wsum,
                 const void* gmat, const void* c_frac, void* out, int K, int B,
                 float max_range, cudaStream_t stream) {
  auto kernel = theta_shuffle_blend_kernel<VEC>;
  const size_t smem = Blend<VEC>::smem_bytes(2);
  int grid = 0;
  const cudaError_t err = rowtile::persistent_grid<Blend<VEC>>(kernel, smem, K, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, Blend<VEC>::THREADS, smem, stream>>>(
      static_cast<const float*>(spec_r), ld, static_cast<const float*>(fs),
      static_cast<const float*>(wsum), static_cast<const float*>(gmat),
      static_cast<const float*>(c_frac), static_cast<float*>(out), K, B, max_range);
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
// exist).  Kernel 7 (edge 0, tail 0) runs its 16-byte copy instance when
// B % 4 == 0, ld % 4 == 0 and spec_r, gmat and out are 16-byte aligned, the
// 4-byte one otherwise; the edge forms take their 16-byte path on the same
// condition (and every spectrum and the noise aligned).
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
  if (!edge && tail == TAIL_NONE) {
    const bool vec = B % 4 == 0 && ld % 4 == 0 && rowtile::aligned16({spec_r, gmat, out});
    return vec ? launch_plain<true>(spec_r, ld, fs, wsum, gmat, c_frac, out, K, B, max_range, s)
               : launch_plain<false>(spec_r, ld, fs, wsum, gmat, c_frac, out, K, B, max_range,
                                     s);
  }
  edge_render::Params p{static_cast<const float*>(spec_r), static_cast<const float*>(spec_e),
                        static_cast<const float*>(spec_w), ld, static_cast<const float*>(fs),
                        static_cast<const float*>(wsum), static_cast<const float*>(vel),
                        static_cast<const float*>(gmat), static_cast<const float*>(c_frac),
                        noise, nullptr, 0, static_cast<const float*>(cosv),
                        static_cast<const float*>(sinv), static_cast<const float*>(side),
                        static_cast<const float*>(opp), tail == TAIL_TTC_OPP ? n_opp : 0,
                        static_cast<float*>(out), static_cast<float*>(hit), K, B,
                        agents_per_env, max_range, ttc_thresh, ew_bf16, 0, 0};
  edge_render::set_paths(p, noise_bf16 ? 2 : 4);
  if (edge && tail == TAIL_NONE) return edge_render::launch(theta_blend_kernel<TAIL_NONE, float>, p, s);
  if (edge && tail == TAIL_TTC)
    return noise_bf16 ? edge_render::launch(theta_blend_kernel<TAIL_TTC, __nv_bfloat16>, p, s)
                      : edge_render::launch(theta_blend_kernel<TAIL_TTC, float>, p, s);
  if (edge && tail == TAIL_TTC_OPP)
    return noise_bf16 ? edge_render::launch(theta_blend_kernel<TAIL_TTC_OPP, __nv_bfloat16>, p, s)
                      : edge_render::launch(theta_blend_kernel<TAIL_TTC_OPP, float>, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
