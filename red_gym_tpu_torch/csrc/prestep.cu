// Pre-scan state kernel for Hopper (sm_90a): steer delay, PID, one RK4 or
// Euler step of the single-track model, yaw wrap, and the nearest1 cell and
// theta decomposition the scan megakernel reads.
//
// Replaces red_gym_tpu/ops/pallas_state.py::prestep (_kernel).  The math is
// set out in red_gym_tpu_torch/ops/state_kernels.py, whose
// prestep_reference (the eager PyTorch chain of env.sim_step) is the plain
// version of this kernel.
//
// Rounding.  The source is built with -fmad=false (see ops/_build.py):
// every + - * / below is rounded on its own, as PyTorch's
// one-kernel-per-operator code rounds it, and the expressions keep the
// association of the PyTorch code they mirror (ops/dynamics.py,
// ops/integrate.py, ops/scan_fast.py), so the kernel and its plain version
// agree bit for bit.  Division is IEEE division (PyTorch divides tensor by
// tensor there); constants that PyTorch takes as Python floats are rounded
// to float32 first, as PyTorch does.  sincosf gives the bits of sinf and
// cosf.
//
// What bounds it on the H100.  At K = 32768 rows it moves about 4 MB (about
// 1.2 us at the memory rate), but its time is latency: each row is a chain
// of four right-hand sides, each with up to six accurate transcendentals
// and a dozen IEEE divisions, whose slow-path branches keep the compiler
// from overlapping them.  One thread a row gives 1024 warps, under two a
// scheduler on 132 SMs, too few to hide that chain.
//
// Design.  Two warps share 32 rows, one row a lane; both keep the row's
// state, and the right-hand side of each stage is cut into four tasks: the
// kinematic branch's (x, y) rates (K1: one sincosf) and its steer and
// yaw-rate terms (K2: tanf, cosf, three divisions), the dynamic branch's
// (x, y) rates (D1: one sincosf) and its yaw-rate and slip rates (D2: three
// divisions).  Only the branches that a row of the 32 takes run (|v| < 0.5
// picks the kinematic one, as the plain version's select does): where both
// run, warp 0 takes K1 and K2 and warp 1 D1 and D2; where one runs, each
// warp takes one of its two tasks.  Each task writes its two values to
// shared memory, and after one barrier both warps read their row's values
// of the branch the row takes.  So the warps in flight double and each
// warp's chain is about half the row's.  On an H100 one warp per 32 rows
// (the branch alone) and four were slower, and so were blocks of two to
// eight such pairs (PERF.md §6).

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int THREADS = 64;  // two warps, sharing a block's 32 rows

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
__device__ __forceinline__ float steering_constraint(float sa, float svel, const Veh& p) {
  const float c = nan_min(nan_max(svel, p.sv_min), p.sv_max);
  const bool pinned = (sa <= p.s_min && svel <= 0.f) || (sa >= p.s_max && svel >= 0.f);
  return pinned ? 0.f : c;
}

// dynamics.accl_constraints
__device__ __forceinline__ float accl_constraints(float vel, float accl, const Veh& p) {
  const bool above = vel > p.v_switch;
  const float vel_safe = above ? vel : 1.f;
  const float pos_limit = above ? (p.a_max * p.v_switch) / vel_safe : p.a_max;
  const float c = nan_min(nan_max(accl, -p.a_max), pos_limit);
  const bool pinned = (vel <= p.v_min && accl <= 0.f) || (vel >= p.v_max && accl >= 0.f);
  return pinned ? 0.f : c;
}

// The four tasks of one right-hand side (dynamics.vehicle_dynamics_st_t,
// with vehicle_dynamics_ks_t inlined), each two of its seven rates.
enum Task { K1 = 0, K2 = 1, D1 = 2, D2 = 3 };

// One task's two rates of the stage state x, with sv and ac the inputs
// after their constraints.  The kinematic branch constrains them again.
__device__ __forceinline__ void run_task(int task, const State& x, float sv, float ac,
                                         const Veh& p, float& a, float& b) {
  const float lwb = p.lf + p.lr;
  if (task == K1) {  // x * cos(yaw), x * sin(yaw)
    float s, c;
    sincosf(x.v[4], &s, &c);
    a = x.v[3] * c;
    b = x.v[3] * s;
  } else if (task == K2) {  // yaw rate and its derivative
    const float tan_s = tanf(x.v[2]);
    const float cos_s = cosf(x.v[2]);
    a = (x.v[3] / lwb) * tan_s;
    b = ((ac / lwb) * tan_s) + ((x.v[3] / (lwb * (cos_s * cos_s))) * sv);
  } else if (task == D1) {  // v * cos(beta + psi), v * sin(beta + psi)
    float s, c;
    sincosf(x.v[6] + x.v[4], &s, &c);
    a = x.v[3] * c;
    b = x.v[3] * s;
  } else {  // D2: the yaw acceleration and the slip rate
    // 1 in a kinematic row, whose D2 is not read, as the plain version
    // keeps the untaken branch finite
    const float v = fabsf(x.v[3]) < 0.5f ? 1.f : x.v[3];
    const float delta = x.v[2], wz = x.v[5], beta = x.v[6];
    const float glr_f = (p.lr * G) - (ac * p.h);
    const float glf_r = (p.lf * G) + (ac * p.h);
    const float denom = p.lr + p.lf;
    const float mm = p.mu * p.m;
    const float mm_id = mm / (p.I * denom);
    a = ((((-p.mu) * p.m) / ((v * p.I) * denom)) *
         ((((p.lf * p.lf) * p.C_Sf) * glr_f) + (((p.lr * p.lr) * p.C_Sr) * glf_r))) * wz +
        (mm_id * (((p.lr * p.C_Sr) * glf_r) - ((p.lf * p.C_Sf) * glr_f))) * beta +
        ((((mm_id * p.lf) * p.C_Sf) * glr_f) * delta);
    const float mu_vd = p.mu / (v * denom);
    b = ((((p.mu / ((v * v) * denom)) *
           (((p.C_Sr * glf_r) * p.lr) - ((p.C_Sf * glr_f) * p.lf))) - 1.f) * wz) -
        ((mu_vd * ((p.C_Sr * glf_r) + (p.C_Sf * glr_f))) * beta) +
        ((mu_vd * (p.C_Sf * glr_f)) * delta);
  }
}

// The right-hand side at the stage state x of this lane's row, computed by
// the two warps of the block together; xch is this stage's exchange
// buffer, [task][value][lane].  Every warp returns the row's seven rates.
__device__ __forceinline__ State rhs_st(const State& x, float sv0, float ac0, const Veh& p,
                                        float (*xch)[2][32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float sv = steering_constraint(x.v[2], sv0, p);
  const float ac = accl_constraints(x.v[3], ac0, p);
  const bool use_ks = fabsf(x.v[3]) < 0.5f;
  const unsigned ks = __ballot_sync(0xffffffffu, use_ks);
  // the tasks the 32 rows need: where both branches run, a branch a warp,
  // else a task a warp; warp-uniform, so no warp diverges
  const bool need_k = ks != 0u, need_d = ks != 0xffffffffu, both = need_k && need_d;
  float a, b;
  if (need_k && warp == 0) {
    run_task(K1, x, sv, ac, p, a, b);
    xch[K1][0][lane] = a, xch[K1][1][lane] = b;
  }
  if (need_k && warp == (both ? 0 : 1)) {
    run_task(K2, x, sv, ac, p, a, b);
    xch[K2][0][lane] = a, xch[K2][1][lane] = b;
  }
  if (need_d && warp == (both ? 1 : 0)) {
    run_task(D1, x, sv, ac, p, a, b);
    xch[D1][0][lane] = a, xch[D1][1][lane] = b;
  }
  if (need_d && warp == 1) {
    run_task(D2, x, sv, ac, p, a, b);
    xch[D2][0][lane] = a, xch[D2][1][lane] = b;
  }
  __syncthreads();
  State f;
  if (use_ks) {
    f.v[0] = xch[K1][0][lane];
    f.v[1] = xch[K1][1][lane];
    f.v[2] = steering_constraint(x.v[2], sv, p);
    f.v[3] = accl_constraints(x.v[3], ac, p);
    f.v[4] = xch[K2][0][lane];
    f.v[5] = xch[K2][1][lane];
    f.v[6] = 0.f;
  } else {
    f.v[0] = xch[D1][0][lane];
    f.v[1] = xch[D1][1][lane];
    f.v[2] = sv;
    f.v[3] = ac;
    f.v[4] = x.v[5];
    f.v[5] = xch[D2][0][lane];
    f.v[6] = xch[D2][1][lane];
  }
  return f;
}

// integrate._taxpy: x + a * k per component
__device__ __forceinline__ State taxpy(const State& x, float a, const State& k) {
  State y;
#pragma unroll
  for (int i = 0; i < 7; ++i) y.v[i] = x.v[i] + (k.v[i] * a);
  return y;
}

__global__ void __launch_bounds__(THREADS)
    prestep_kernel(const float* __restrict__ xin, const float* __restrict__ buf,
                   const int* __restrict__ cnt, const float* __restrict__ act,
                   const float* __restrict__ pk, float* __restrict__ xout,
                   float* __restrict__ buf_out, int* __restrict__ cnt_out,
                   int* __restrict__ row_out, float* __restrict__ scal, int K,
                   float half_dt, float dt, float dt_6, int rk4, int t_bins,
                   float bins_per_rad) {
  // two exchange buffers, one for even and one for odd stages: a stage
  // writes one while no warp can still be reading it from two stages back
  __shared__ float xch[2][4][2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k_row = blockIdx.x * 32 + lane;
  const bool live = k_row < K;
  const size_t k = live ? k_row : K - 1;  // the ragged block's spare lanes
                                          // shadow the last row
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

  State x;
#pragma unroll
  for (int i = 0; i < 7; ++i) x.v[i] = xin[k * 7 + i];

  // steering delay line, depth 2 (state_kernels.steer_delay)
  const float raw = act[k * 2 + 0], speed = act[k * 2 + 1];
  const int c = cnt[k];
  const float old0 = buf[k * 2 + 0];
  const float steer = c >= 2 ? buf[k * 2 + 1] : 0.f;
  if (live && warp == 1) {
    buf_out[k * 2 + 0] = raw;
    buf_out[k * 2 + 1] = old0;
    cnt_out[k] = min(c + 1, 2);
  }

  // dynamics.pid
  const float steer_diff = steer - x.v[2];
  const float sv = fabsf(steer_diff) > 1e-4f ? sign_f(steer_diff) * p.sv_max : 0.f;
  const float vel_diff = speed - x.v[3];
  float gain;
  if (x.v[3] > 0.f) {
    gain = vel_diff > 0.f ? (p.a_max * 10.f) / p.v_max : (p.a_max * 10.f) / (-p.v_min);
  } else {
    gain = vel_diff > 0.f ? (p.a_max * 2.f) / p.v_max : (p.a_max * 2.f) / (-p.v_min);
  }
  const float accl = gain * vel_diff;

  // integrate.rk4_step_t / euler_step_t
  State xn;
  if (rk4) {
    const State k1 = rhs_st(x, sv, accl, p, xch[0]);
    const State k2 = rhs_st(taxpy(x, half_dt, k1), sv, accl, p, xch[1]);
    const State k3 = rhs_st(taxpy(x, half_dt, k2), sv, accl, p, xch[0]);
    const State k4 = rhs_st(taxpy(x, dt, k3), sv, accl, p, xch[1]);
#pragma unroll
    for (int i = 0; i < 7; ++i)
      xn.v[i] = x.v[i] + ((((k1.v[i] + (k2.v[i] * 2.f)) + (k3.v[i] * 2.f)) + k4.v[i]) * dt_6);
  } else {
    xn = taxpy(x, dt, rhs_st(x, sv, accl, p, xch[0]));
  }
  // integrate.wrap_yaw
  float yaw = xn.v[4];
  yaw = yaw > TWO_PI ? yaw - TWO_PI : yaw;
  yaw = yaw < 0.f ? yaw + TWO_PI : yaw;
  xn.v[4] = yaw;
  if (!live) return;
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 7; ++i) xout[k * 7 + i] = xn.v[i];
  }
  if (warp != 1) return;

  // scan_fast._cells_and_theta (nearest1)
  const float ox = pk[18], oy = pk[19], oc = pk[20], osn = pk[21], cell = pk[22];
  const int hc = (int)pk[23], wc = (int)pk[24];
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

  // theta decomposition (scan_fast.row_scalars): torch.remainder, which is
  // the yaw itself on [0, 2 pi), where the wrap leaves almost every yaw
  float md = yaw;
  if (!(yaw >= 0.f && yaw < TWO_PI)) {
    md = fmodf(yaw, TWO_PI);
    if (md != 0.f && ((TWO_PI < 0.f) != (md < 0.f))) md += TWO_PI;
  }
  const float s = md * bins_per_rad;
  const float i_s = floorf(s);
  int i_i = (int)i_s;
  i_i = i_i >= t_bins ? i_i - t_bins : i_i;

  // the (K, 8) row is 32 bytes: two 16-byte stores (the wrapper allocates it)
  float4* o = reinterpret_cast<float4*>(scal + k * 8);
  o[0] = make_float4(dx, dy, s - i_s, (float)i_i);
  o[1] = make_float4(inb ? 1.f : 0.f, xn.v[3], 0.f, 0.f);
}

__global__ void __launch_bounds__(THREADS) prestep_floor_kernel() {}

inline int blocks_for(int K) { return (K + 31) / 32; }

}  // namespace

// C entry point, bound with ctypes.  Device pointers: x (K, 7), buf (K, 2),
// cnt (K,) int32, act (K, 2), pk (32,) from state_kernels.pack_params;
// outputs x' (K, 7), buf' (K, 2), cnt' (K,) int32, texture row (K,) int32,
// scal (K, 8), 16-byte aligned.  Launches on `stream` and returns the CUDA
// error: non-zero means the launch did not happen.
extern "C" int prestep_launch(const void* x, const void* buf, const void* cnt,
                              const void* act, const void* pk, void* xout, void* buf_out,
                              void* cnt_out, void* row_out, void* scal, int K,
                              float half_dt, float dt, float dt_6, int rk4, int t_bins,
                              void* stream) {
  if (K <= 0) return 0;
  // t_bins / (2 pi) rounded once to float32, as PyTorch rounds the Python float
  const float bins_per_rad = (float)(t_bins / 6.283185307179586);
  prestep_kernel<<<blocks_for(K), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(buf),
      static_cast<const int*>(cnt), static_cast<const float*>(act),
      static_cast<const float*>(pk), static_cast<float*>(xout),
      static_cast<float*>(buf_out), static_cast<int*>(cnt_out),
      static_cast<int*>(row_out), static_cast<float*>(scal), K, half_dt, dt, dt_6, rk4,
      t_bins, bins_per_rad);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel with prestep_kernel's grid and block for K rows: the least
// time a launch of that shape takes (chip_smoke.py's floor_ms).
extern "C" int prestep_floor_launch(int K, void* stream) {
  if (K <= 0) return 0;
  prestep_floor_kernel<<<blocks_for(K), THREADS, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
