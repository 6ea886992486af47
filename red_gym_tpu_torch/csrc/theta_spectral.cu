// The spectral fast scan's render kernel for Hopper (sm_90a): rolled
// spectrum -> noisy scan + wall-iTTC flags.
//
// Replaces red_gym_tpu/ops/pallas_scan.py::theta_spectral_ttc
// (_spec_ttc_kernel).  The math is set out in
// red_gym_tpu_torch/ops/spectral_kernels.py, whose
// theta_spectral_ttc_reference is the plain PyTorch version of this kernel.
// At K = 32768 rows and B = 1080 beams the product spec (K, 128) @ smat
// (128, B) is 9.06 GFLOP against about 195 MB of bytes, so float32 FMAs
// bound it.
//
// The product is rowtile_gemm.cuh's mainloop with one slab: a block owns 128
// rows and walks the beam tiles of 128 with the rows' spectra in shared
// memory, smat streaming through a cp.async ring; each thread keeps 8 rows
// x 8 beams in registers.  The tail runs on those registers: mask on
// wsum > 0, clip to [0, max_range], the env's noise row added (row k belongs
// to env k / agents_per_env), the iTTC test (a row's hit is the OR over its
// beams, gathered in shared memory and written once a row tile), float4
// stores.  The noise is the tail's only read from device memory: the block
// asks L2 for the beam tile's noise rows when the tile's product starts, and
// each thread loads two rows of bf16 noise (one of float32) at a time
// before using them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "rowtile_gemm.cuh"
#include "scan_tail.cuh"

namespace {

using namespace scan_tail;
using rowtile::TM;

// Four noise values as loaded, 16 bytes of float32 or 8 of bf16 (16- or
// 8-byte aligned), widened to float32 on use.
template <typename NoiseT>
struct Raw4;
template <>
struct Raw4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ float operator[](int q) const {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  }
};
template <>
struct Raw4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ float operator[](int q) const {
    const unsigned w = q < 2 ? v.x : v.y;
    return __uint_as_float(q % 2 ? w & 0xffff0000u : w << 16);
  }
};

template <bool VEC>
using Spectral = rowtile::Tile<8, 1, VEC, 256>;

template <typename NoiseT, bool VEC>
struct SpectralTail {
  using C = Spectral<VEC>;
  static constexpr int BM = C::BM;
  const float* __restrict__ wsum;
  const float* __restrict__ vel;
  const NoiseT* __restrict__ noise;
  const float* __restrict__ cosv;
  const float* __restrict__ side;
  float* __restrict__ out;
  float* __restrict__ hit;
  int K, B, agents_per_env;
  float max_range, ttc_thresh;
  float* s_wsum;  // [BM] each, in shared memory
  float* s_vel;
  float* s_hit;

  __device__ void rows(int row0, int tid) const {
    if (tid < BM) {
      const int k = row0 + tid;
      s_wsum[tid] = k < K ? wsum[k] : 0.f;
      s_vel[tid] = k < K ? vel[k] : 0.f;
      s_hit[tid] = 0.f;
    }
  }

  // the noise rows of the row tile's envs, over the beam tile, into L2
  __device__ void prefetch(int row0, int b0, int tid) const {
    constexpr int LINE = 128;
    const int e0 = row0 / agents_per_env;
    const int n_env = (min(row0 + BM, K) - 1) / agents_per_env - e0 + 1;
    const int bytes = min(C::BN, B - b0) * (int)sizeof(NoiseT);
    const int lines = (bytes + LINE - 1) / LINE + 1;  // + 1: a span across a line
    for (int it = tid; it < n_env * lines; it += C::THREADS) {
      const int e = e0 + it / lines, l = it % lines;
      const char* p = reinterpret_cast<const char*>(noise + (size_t)e * B + b0);
      rowtile::prefetch_l2(p + min(l * LINE, bytes - 1));
    }
  }

  __device__ void tile(const float (&acc)[TM][C::NACC], int row0, int b0, int tx,
                       int ty) const {
    float cb[C::TN], sd[C::TN];
#pragma unroll
    for (int n = 0; n < C::TN; ++n) {
      const int b = b0 + C::beam_of(n, tx);
      cb[n] = b < B ? cosv[b] : 0.f;
      sd[n] = b < B ? side[b] : 0.f;
    }
    // RB rows at a time: their noise loads are all in flight before any is used
    // (more than two rows of bf16, or one of float32, would not fit in 128
    // registers)
    constexpr int RB = sizeof(NoiseT) == 2 ? 2 : 1;
#pragma unroll
    for (int h = 0; h < TM; h += RB) {
      Raw4<NoiseT> raw[RB][C::NG];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int k = row0 + C::row_of(h + i, ty);
        const NoiseT* nrow = noise + (size_t)((k < K ? k : 0) / agents_per_env) * B;
#pragma unroll
        for (int g = 0; g < C::NG; ++g) {
          const int b = b0 + g * rowtile::HALF + tx * 4;
          if (VEC && k < K && b < B) raw[i][g].load(nrow + b);
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = C::row_of(h + i, ty), k = row0 + r;
        if (k >= K) continue;
        const bool live = s_wsum[r] > 0.f;
        const float v = s_vel[r];
        const NoiseT* nrow = noise + (size_t)(k / agents_per_env) * B;
        float* orow = out + (size_t)k * B;
        bool any = false;
#pragma unroll
        for (int g = 0; g < C::NG; ++g) {
          const int b = b0 + g * rowtile::HALF + tx * 4;
          if (b >= B) continue;
          float o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int n = g * 4 + q;
            const float nz = VEC ? raw[i][g][q] : (b + q < B ? load_f(nrow, b + q) : 0.f);
            o[q] = clampf(live ? acc[h + i][n] : 0.f, 0.f, max_range);
            o[q] = __fadd_rn(o[q], nz);
            any |= b + q < B && ttc_hit(o[q], v, cb[n], sd[n], ttc_thresh);
          }
          if constexpr (VEC) {
            *reinterpret_cast<float4*>(orow + b) = make_float4(o[0], o[1], o[2], o[3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (b + q < B) orow[b + q] = o[q];
          }
        }
        if (any) s_hit[r] = 1.f;
      }
    }
  }

  __device__ void flush(int row0, int tid) const {
    if (tid < BM && row0 + tid < K) hit[row0 + tid] = s_hit[tid];
  }
};

template <typename NoiseT, bool VEC>
__global__ void __launch_bounds__(256, 2)
theta_spectral_kernel(const float* __restrict__ spec, const float* __restrict__ wsum,
                      const float* __restrict__ vel, const float* __restrict__ smat,
                      const NoiseT* __restrict__ noise, const float* __restrict__ cosv,
                      const float* __restrict__ side, float* __restrict__ out,
                      float* __restrict__ hit, int K, int B, int agents_per_env,
                      float max_range, float ttc_thresh) {
  using C = Spectral<VEC>;
  extern __shared__ __align__(16) float smem[];
  float* s_row = smem + C::ROW_OFF;
  const SpectralTail<NoiseT, VEC> tail{wsum, vel, noise, cosv, side, out, hit, K, B,
                                       agents_per_env, max_range, ttc_thresh,
                                       s_row, s_row + C::BM, s_row + 2 * C::BM};
  rowtile::run<C>(smem, spec, rowtile::T, smat, K, B, tail);
}

template <typename NoiseT, bool VEC>
int launch(const void* spec, const void* wsum, const void* vel, const void* smat,
           const void* noise, const void* cosv, const void* side, void* out, void* hit,
           int K, int B, int agents_per_env, float max_range, float ttc_thresh,
           cudaStream_t stream) {
  auto kernel = theta_spectral_kernel<NoiseT, VEC>;
  const size_t smem = Spectral<VEC>::smem_bytes(3);
  int grid = 0;
  const cudaError_t err = rowtile::persistent_grid<Spectral<VEC>>(kernel, smem, K, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, Spectral<VEC>::THREADS, smem, stream>>>(
      static_cast<const float*>(spec), static_cast<const float*>(wsum),
      static_cast<const float*>(vel), static_cast<const float*>(smat),
      static_cast<const NoiseT*>(noise), static_cast<const float*>(cosv),
      static_cast<const float*>(side), static_cast<float*>(out), static_cast<float*>(hit),
      K, B, agents_per_env, max_range, ttc_thresh);
  return static_cast<int>(cudaGetLastError());
}

template <typename NoiseT>
int launch_vec(bool vec, const void* spec, const void* wsum, const void* vel,
               const void* smat, const void* noise, const void* cosv, const void* side,
               void* out, void* hit, int K, int B, int agents_per_env, float max_range,
               float ttc_thresh, cudaStream_t stream) {
  return vec ? launch<NoiseT, true>(spec, wsum, vel, smat, noise, cosv, side, out, hit, K, B,
                                    agents_per_env, max_range, ttc_thresh, stream)
             : launch<NoiseT, false>(spec, wsum, vel, smat, noise, cosv, side, out, hit, K,
                                     B, agents_per_env, max_range, ttc_thresh, stream);
}

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer to
// float32 unless stated: spec is (K, T) row-major; wsum and vel are (K,); smat
// is (T, B); noise is (K / agents_per_env, B), bf16 when noise_bf16; cosv and
// side are (B,); out is (K, B) and hit (K,).  Launches on `stream` and returns
// the CUDA error: non-zero means the launch did not happen.  The 16-byte copy
// instance runs when B % 4 == 0 and spec, smat, noise and out are 16-byte
// aligned, the 4-byte one otherwise.
extern "C" int theta_spectral_launch(const void* spec, const void* wsum, const void* vel,
                                     const void* smat, const void* noise, int noise_bf16,
                                     const void* cosv, const void* side, void* out,
                                     void* hit, int K, int B, int agents_per_env,
                                     float max_range, float ttc_thresh, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = B % 4 == 0 && rowtile::aligned16({spec, smat, noise, out});
  return noise_bf16
             ? launch_vec<__nv_bfloat16>(vec, spec, wsum, vel, smat, noise, cosv, side, out,
                                         hit, K, B, agents_per_env, max_range, ttc_thresh, s)
             : launch_vec<float>(vec, spec, wsum, vel, smat, noise, cosv, side, out, hit, K,
                                 B, agents_per_env, max_range, ttc_thresh, s);
}
