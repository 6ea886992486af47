// Pre-scan state kernel for Hopper (sm_90a): steer delay, PID, one RK4 or
// Euler step of the single-track model, yaw wrap, and the nearest1 cell and
// theta decomposition the scan megakernel reads.
//
// Replaces red_gym_tpu/ops/pallas_state.py::prestep (_kernel).  The math and
// what bounds it on the H100 are set out in
// red_gym_tpu_torch/ops/state_kernels.py, whose prestep_reference (the eager
// PyTorch chain of env.sim_step) is the plain version of this kernel.
//
// One thread per row (car).  The source is built with -fmad=false (see
// ops/_build.py): every + - * / below is rounded on its own, as PyTorch's
// one-kernel-per-operator code rounds it, and the expressions keep the
// association of the PyTorch code they mirror (ops/dynamics.py,
// ops/integrate.py, ops/scan_fast.py), so the kernel and its plain version
// agree bit for bit.  Division is IEEE division (PyTorch divides tensor by
// tensor there); constants that PyTorch takes as Python floats are rounded
// to float32 first, as PyTorch does.

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr float G = 9.81f;
constexpr float TWO_PI = 6.283185307179586f;

// torch.minimum / torch.maximum: NaN-propagating
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// torch.sign of a float
__device__ __forceinline__ float sign_f(float a) {
  return (float)((0.f < a) - (a < 0.f));
}

struct Veh {  // VehicleParams order (pack_params)
  float mu, C_Sf, C_Sr, lf, lr, h, m, I, s_min, s_max, sv_min, sv_max, v_switch,
      a_max, v_min, v_max;
};

struct State {
  float v[7];
};

// dynamics.steering_constraint
__device__ float steering_constraint(float sa, float svel, const Veh& p) {
  const float c = nan_min(nan_max(svel, p.sv_min), p.sv_max);
  const bool pinned = (sa <= p.s_min && svel <= 0.f) || (sa >= p.s_max && svel >= 0.f);
  return pinned ? 0.f : c;
}

// dynamics.accl_constraints
__device__ float accl_constraints(float vel, float accl, const Veh& p) {
  const bool above = vel > p.v_switch;
  const float vel_safe = above ? vel : 1.f;
  const float pos_limit = above ? (p.a_max * p.v_switch) / vel_safe : p.a_max;
  const float c = nan_min(nan_max(accl, -p.a_max), pos_limit);
  const bool pinned = (vel <= p.v_min && accl <= 0.f) || (vel >= p.v_max && accl >= 0.f);
  return pinned ? 0.f : c;
}

// dynamics.vehicle_dynamics_st_t (with vehicle_dynamics_ks_t inlined)
__device__ State rhs_st(const State& x, float sv0, float ac0, const Veh& p) {
  const float sv = steering_constraint(x.v[2], sv0, p);
  const float ac = accl_constraints(x.v[3], ac0, p);
  const float lwb = p.lf + p.lr;
  const bool use_ks = fabsf(x.v[3]) < 0.5f;

  // the kinematic branch constrains its (already constrained) inputs again
  const float sv_k = steering_constraint(x.v[2], sv, p);
  const float ac_k = accl_constraints(x.v[3], ac, p);
  const float tan_s = tanf(x.v[2]);
  const float ks0 = x.v[3] * cosf(x.v[4]);
  const float ks1 = x.v[3] * sinf(x.v[4]);
  const float ks4 = (x.v[3] / lwb) * tan_s;
  const float cos_s = cosf(x.v[2]);
  const float ks5 = ((ac / lwb) * tan_s) + ((x.v[3] / (lwb * (cos_s * cos_s))) * sv);

  const float v = use_ks ? 1.f : x.v[3];
  const float delta = x.v[2], psi = x.v[4], wz = x.v[5], beta = x.v[6];
  const float glr_f = (p.lr * G) - (ac * p.h);
  const float glf_r = (p.lf * G) + (ac * p.h);
  const float denom = p.lr + p.lf;
  const float mm = p.mu * p.m;
  const float mm_id = mm / (p.I * denom);
  const float st5 =
      ((((-p.mu) * p.m) / ((v * p.I) * denom)) *
       ((((p.lf * p.lf) * p.C_Sf) * glr_f) + (((p.lr * p.lr) * p.C_Sr) * glf_r))) * wz +
      (mm_id * (((p.lr * p.C_Sr) * glf_r) - ((p.lf * p.C_Sf) * glr_f))) * beta +
      ((((mm_id * p.lf) * p.C_Sf) * glr_f) * delta);
  const float mu_vd = p.mu / (v * denom);
  const float st6 =
      ((((p.mu / ((v * v) * denom)) *
         (((p.C_Sr * glf_r) * p.lr) - ((p.C_Sf * glr_f) * p.lf))) - 1.f) * wz) -
      ((mu_vd * ((p.C_Sr * glf_r) + (p.C_Sf * glr_f))) * beta) +
      ((mu_vd * (p.C_Sf * glr_f)) * delta);

  State f;
  f.v[0] = use_ks ? ks0 : v * cosf(beta + psi);
  f.v[1] = use_ks ? ks1 : v * sinf(beta + psi);
  f.v[2] = use_ks ? sv_k : sv;
  f.v[3] = use_ks ? ac_k : ac;
  f.v[4] = use_ks ? ks4 : wz;
  f.v[5] = use_ks ? ks5 : st5;
  f.v[6] = use_ks ? 0.f : st6;
  return f;
}

// integrate._taxpy: x + a * k per component
__device__ __forceinline__ State taxpy(const State& x, float a, const State& k) {
  State y;
#pragma unroll
  for (int i = 0; i < 7; ++i) y.v[i] = x.v[i] + (k.v[i] * a);
  return y;
}

__global__ void prestep_kernel(const float* __restrict__ xin, const float* __restrict__ buf,
                               const int* __restrict__ cnt, const float* __restrict__ act,
                               const float* __restrict__ pk, float* __restrict__ xout,
                               float* __restrict__ buf_out, int* __restrict__ cnt_out,
                               int* __restrict__ row_out, float* __restrict__ scal,
                               int K, float half_dt, float dt, float dt_6, int rk4,
                               int t_bins, float bins_per_rad) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  Veh p;
  p.mu = pk[0];
  p.C_Sf = pk[1];
  p.C_Sr = pk[2];
  p.lf = pk[3];
  p.lr = pk[4];
  p.h = pk[5];
  p.m = pk[6];
  p.I = pk[7];
  p.s_min = pk[8];
  p.s_max = pk[9];
  p.sv_min = pk[10];
  p.sv_max = pk[11];
  p.v_switch = pk[12];
  p.a_max = pk[13];
  p.v_min = pk[14];
  p.v_max = pk[15];
  const float ox = pk[18], oy = pk[19], oc = pk[20], osn = pk[21], cell = pk[22];
  const int hc = (int)pk[23], wc = (int)pk[24];

  State x;
#pragma unroll
  for (int i = 0; i < 7; ++i) x.v[i] = xin[(size_t)k * 7 + i];

  // steering delay line, depth 2 (state_kernels.steer_delay)
  const float raw = act[(size_t)k * 2 + 0], speed = act[(size_t)k * 2 + 1];
  const int c = cnt[k];
  const float steer = c >= 2 ? buf[(size_t)k * 2 + 1] : 0.f;
  buf_out[(size_t)k * 2 + 0] = raw;
  buf_out[(size_t)k * 2 + 1] = buf[(size_t)k * 2 + 0];
  cnt_out[k] = min(c + 1, 2);

  // dynamics.pid
  const float steer_diff = steer - x.v[2];
  const float sv = fabsf(steer_diff) > 1e-4f ? sign_f(steer_diff) * p.sv_max : 0.f;
  const float vel_diff = speed - x.v[3];
  const float fwd_gain = vel_diff > 0.f ? (p.a_max * 10.f) / p.v_max : (p.a_max * 10.f) / (-p.v_min);
  const float rev_gain = vel_diff > 0.f ? (p.a_max * 2.f) / p.v_max : (p.a_max * 2.f) / (-p.v_min);
  const float accl = (x.v[3] > 0.f ? fwd_gain : rev_gain) * vel_diff;

  // integrate.rk4_step_t / euler_step_t
  State xn;
  if (rk4) {
    const State k1 = rhs_st(x, sv, accl, p);
    const State k2 = rhs_st(taxpy(x, half_dt, k1), sv, accl, p);
    const State k3 = rhs_st(taxpy(x, half_dt, k2), sv, accl, p);
    const State k4 = rhs_st(taxpy(x, dt, k3), sv, accl, p);
#pragma unroll
    for (int i = 0; i < 7; ++i)
      xn.v[i] = x.v[i] + ((((k1.v[i] + (k2.v[i] * 2.f)) + (k3.v[i] * 2.f)) + k4.v[i]) * dt_6);
  } else {
    xn = taxpy(x, dt, rhs_st(x, sv, accl, p));
  }
  // integrate.wrap_yaw
  float yaw = xn.v[4];
  yaw = yaw > TWO_PI ? yaw - TWO_PI : yaw;
  yaw = yaw < 0.f ? yaw + TWO_PI : yaw;
  xn.v[4] = yaw;
#pragma unroll
  for (int i = 0; i < 7; ++i) xout[(size_t)k * 7 + i] = xn.v[i];

  // scan_fast._cells_and_theta (nearest1)
  const float x_t = xn.v[0] - ox;
  const float y_t = xn.v[1] - oy;
  const float gx = (((x_t * oc) + (y_t * osn)) / cell) - 0.5f;
  const float gy = ((((-x_t) * osn) + (y_t * oc)) / cell) - 0.5f;
  const int rr = (int)nearbyintf(gy);
  const int cc = (int)nearbyintf(gx);
  const bool inb = rr >= 0 && rr < hc && cc >= 0 && cc < wc;
  row_out[k] = min(max(rr, 0), hc - 1) * wc + min(max(cc, 0), wc - 1);
  const float cxr = ((float)rr + 0.5f) * cell;
  const float cxc = ((float)cc + 0.5f) * cell;
  const float dx = xn.v[0] - (((cxc * oc) - (cxr * osn)) + ox);
  const float dy = xn.v[1] - (((cxc * osn) + (cxr * oc)) + oy);

  // theta decomposition (scan_fast.row_scalars): torch.remainder, then bins
  float md = fmodf(yaw, TWO_PI);
  if (md != 0.f && ((TWO_PI < 0.f) != (md < 0.f))) md += TWO_PI;
  const float s = md * bins_per_rad;
  const float i_s = floorf(s);
  int i_i = (int)i_s;
  i_i = i_i >= t_bins ? i_i - t_bins : i_i;

  float* o = scal + (size_t)k * 8;
  o[0] = dx;
  o[1] = dy;
  o[2] = s - i_s;
  o[3] = (float)i_i;
  o[4] = inb ? 1.f : 0.f;
  o[5] = xn.v[3];
  o[6] = 0.f;
  o[7] = 0.f;
}

}  // namespace

// C entry point, bound with ctypes.  Device pointers: x (K, 7), buf (K, 2),
// cnt (K,) int32, act (K, 2), pk (32,) from state_kernels.pack_params;
// outputs x' (K, 7), buf' (K, 2), cnt' (K,) int32, texture row (K,) int32,
// scal (K, 8).  Launches on `stream` and returns the CUDA error: non-zero
// means the launch did not happen.
extern "C" int prestep_launch(const void* x, const void* buf, const void* cnt,
                              const void* act, const void* pk, void* xout, void* buf_out,
                              void* cnt_out, void* row_out, void* scal, int K,
                              float half_dt, float dt, float dt_6, int rk4, int t_bins,
                              void* stream) {
  if (K <= 0) return 0;
  constexpr int THREADS = 128;
  // t_bins / (2 pi) rounded once to float32, as PyTorch rounds the Python float
  const float bins_per_rad = (float)(t_bins / 6.283185307179586);
  prestep_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(buf),
      static_cast<const int*>(cnt), static_cast<const float*>(act),
      static_cast<const float*>(pk), static_cast<float*>(xout),
      static_cast<float*>(buf_out), static_cast<int*>(cnt_out),
      static_cast<int*>(row_out), static_cast<float*>(scal), K, half_dt, dt, dt_6, rk4,
      t_bins, bins_per_rad);
  return static_cast<int>(cudaGetLastError());
}
