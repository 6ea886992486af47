// Device code shared by the scan epilogue kernels: loads of bf16 or float32
// storage, the noise + wall-iTTC tail and the opponent slab ray cast.
//
// The counterparts of the TPU kernels' _noise_ttc_tile and _opp_raycast_tile
// (red_gym_tpu/ops/pallas_scan.py); their plain PyTorch versions are
// scan_kernels.noise_ttc_reference and scan_kernels.opp_cast_reference.
// csrc/edge_render.cuh (the edge epilogues and the megakernel's render) and
// csrc/theta_spectral.cu use them.

#pragma once

#include <cuda_bf16.h>
#include <math_constants.h>

#include <stddef.h>

namespace scan_tail {

constexpr int OPP_PACK = 10;  // [lo, hi, a_u, b_u, a_w, b_w, o_u, o_w, hu, hw]

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

// Wall iTTC of one beam of the noisy scan (agent_scan.check_ttc, multiplied
// out and split on the sign of the projected speed pv = vel * cos_b).
__device__ __forceinline__ bool ttc_hit(float o, float vel, float cb, float sd,
                                        float ttc_thresh) {
  const float pv = __fmul_rn(vel, cb);
  const float num = __fsub_rn(o, sd);
  const float lim = __fmul_rn(ttc_thresh, pv);
  return (pv > 0.f && num >= 0.f && num < lim) || (pv < 0.f && num <= 0.f && num > lim);
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

}  // namespace scan_tail
