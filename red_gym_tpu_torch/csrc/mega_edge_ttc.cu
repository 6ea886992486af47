// Scan megakernel for Hopper (sm_90a): texture rows -> noisy scan + iTTC,
// optionally with the opponent ray cast and a resident noise pool.
//
// Replaces red_gym_tpu/ops/pallas_scan.py::mega_edge_ttc (_mega_kernel) in
// all four of its variants: plain, opponents (n_opp > 0, the TPU kernel's
// _opp_raycast_tile), resident pool (pool_rows > 0, noise_mode="pool_rot"),
// and both.  The math, row by row, and what bounds it on the H100 are set out
// in red_gym_tpu_torch/ops/scan_kernels.py, whose mega_edge_ttc_reference is
// the plain PyTorch version of this pair of kernels.
//
// One call launches two kernels on one stream:
//   spectra  mega_spectra_kernel: per row, the texture-row gather, the
//            gradient fold and the corner-bearing parallax, the packed rfft
//            x @ fmat summed in float64, and the integer-roll twiddle; it writes
//            the rolled spectra (K, 3T) [range | e | w] (e/w rounded to bf16
//            under ew_bf16) and the per-row f_s, wsum and vel to a workspace;
//   render   mega_render_kernel: csrc/edge_render.cuh's seven-tap register
//            tile with the noise + iTTC tail and, for the opponent variants,
//            the opponent cast, on those spectra.
// The spectra round trip through device memory (50 MB at K = 32768, about
// 0.03 ms) buys each kernel its own shape: the render holds 64 rows at one
// block a SM, the spectra kernel keeps 16 warps a SM busy on float64 FMAs.
//
// mega_spectra_kernel: 3.2 GFLOP of float64 at K = 32768 (0.048 ms at the
// H100's 67 TFLOP/s float64 tensor-core rate, 0.096 ms at the 33.5 TFLOP/s
// SIMT rate of the FMAs it runs) against 92 MB of bytes (0.03 ms).
// One persistent block of 512 threads a SM stages fmat in float64 in shared
// memory once (128 KB), then walks tiles of 32 rows:
//   phase 1  each (row, bin) item reads its texture row (the gather lives
//            here; a thread issues the loads of its 8 items before it uses
//            any), folds the gradient, applies the parallax, and stages the
//            three channels in float64 (one widening per value), as
//            [channel][bin][row] with the row pairs of each bin swizzled;
//   phase 2  thread (row pair, lane quad) sums 2 rows x 4 lanes x 3 channels
//            of the rfft with fma in bin order (24 float64 accumulators; per
//            bin five 16-byte shared-memory loads feed 24 FMAs), rounds once
//            to float32 and parks the spectra in shared memory;
//   twiddle  lane j of the rolled spectrum is spec[j] cos + spec[(j + T/2) %
//            T] qr (the T/2 column rotation of fmat_sw is that index), each
//            operation rounded on its own; cos and sin of the 128 phases come
//            from a table made once a block; the rows are written out whole.
// The next tile's texture rows are asked into L2 while phase 2 runs.
// No tensor cores: the rfft is float64 SIMT, the taps float32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "edge_render.cuh"
#include "rowtile_gemm.cuh"
#include "scan_tail.cuh"

namespace {

using namespace scan_tail;
using edge_render::TAIL_TTC;
using edge_render::TAIL_TTC_OPP;

constexpr int T = 128;        // theta bins
constexpr int HALF = T / 2;
constexpr int CH = 5;         // texture channels [R | e | w | gx | gy]
constexpr int NSPEC = 3 * T;  // floats of a row's rolled spectra
static_assert((T & (T - 1)) == 0, "the twiddle's floor-mod is a mask");
constexpr float TWO_PI = 6.283185307179586f;
constexpr float DTH = TWO_PI / T;  // exact: division by a power of two
constexpr float INV_TWO_PI = (float)(1.0 / 6.283185307179586);
constexpr float INV_DTH = (float)(T / 6.283185307179586);

// ---- the spectra kernel ------------------------------------------------------

constexpr int S_THREADS = 512;     // 16 row pairs x 32 lane quads
constexpr int S_MIN_BLOCKS = 1;
constexpr int S_ROWS = 32;         // rows a tile
constexpr int SS_LD = NSPEC + 4;   // float row stride of the parked spectra
// dynamic shared memory: fmat in float64, the tile's channels in float64
// (later the parked float32 spectra), the twiddle table and the rows' bins
constexpr size_t S_SMEM = sizeof(double) * (T * T + 3 * T * S_ROWS) +
                          sizeof(float) * 2 * T + sizeof(int) * S_ROWS;
static_assert(S_THREADS == (S_ROWS / 2) * (T / 4), "one thread a row pair and lane quad");
static_assert(S_THREADS % T == 0 && S_ROWS * T % S_THREADS == 0, "whole rows of bins a pass");
static_assert(sizeof(float) * S_ROWS * SS_LD <= sizeof(double) * 3 * T * S_ROWS,
              "the parked spectra fit in the channels' space");

__device__ __forceinline__ float load_tex(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_tex(const float* p, size_t i) { return p[i]; }

// Index of (channel c, bin t, row r) in the staged channels: the row pairs
// of bin t are XOR-swizzled by t % 16, so that the stores of 32 bins of one
// row spread over the banks and the 16-byte loads of a row pair stay whole.
__device__ __forceinline__ int xs_at(int c, int t, int r) {
  return (c * T + t) * S_ROWS + (r ^ (2 * (t & 15)));
}

template <typename TexT>
__global__ void __launch_bounds__(S_THREADS, S_MIN_BLOCKS)
mega_spectra_kernel(const TexT* __restrict__ rt, const int* __restrict__ rows,
                    const float* __restrict__ scal, const float* __restrict__ fmat,
                    float* __restrict__ spec, float* __restrict__ row_out, int K,
                    float max_range, int ew_bf16) {
  extern __shared__ __align__(16) double s_mem[];
  double* fm = s_mem;                        // [T][T]
  double* xs = fm + T * T;                   // [3][T][S_ROWS], swizzled (xs_at)
  float* ss = reinterpret_cast<float*>(xs);  // [S_ROWS][SS_LD] after phase 2
  float* tab_c = reinterpret_cast<float*>(xs + 3 * T * S_ROWS);
  float* tab_s = tab_c + T;
  int* s_ii = reinterpret_cast<int*>(tab_s + T);
  float* out_fs = row_out;
  float* out_wsum = row_out + K;
  float* out_vel = row_out + 2 * K;

  const int tid = threadIdx.x;
  for (int i = tid; i < T * T; i += S_THREADS) fm[i] = fmat[i];
  if (tid < T) {
    const float phi = __fmul_rn((float)tid, DTH);
    tab_c[tid] = cosf(phi);
    tab_s[tid] = sinf(phi);
  }
  const int rg = tid % (S_ROWS / 2), lq = tid / (S_ROWS / 2);
  const int n_tiles = (K + S_ROWS - 1) / S_ROWS;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * S_ROWS;
    // ---- phase 1: gather + gradient fold + parallax -------------------------
    // Thread t takes bin t % T of the rows t / T + 4 n, n < NI: all their
    // loads are issued first, the row indices and then the texture values,
    // so that the two dependent trips to memory are made once, not NI times.
    constexpr int NI = S_ROWS * T / S_THREADS;  // items a thread
    const int t = tid % T;
    int rowi[NI];
    float tex[NI][6], d[NI][2];
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int k = row0 + tid / T + n * (S_THREADS / T);
      rowi[n] = k < K ? rows[k] : -1;
      d[n][0] = k < K ? scal[(size_t)k * 8 + 0] : 0.f;
      d[n][1] = k < K ? scal[(size_t)k * 8 + 1] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const TexT* row = rt + (size_t)(rowi[n] < 0 ? 0 : rowi[n]) * (CH * T);
      tex[n][0] = load_tex(row, t);             // R
      tex[n][1] = load_tex(row, (t + 1) % T);   // R of the next bin
      tex[n][2] = load_tex(row, T + t);         // e
      tex[n][3] = load_tex(row, 2 * T + t);     // w
      tex[n][4] = load_tex(row, 3 * T + t);     // gx
      tex[n][5] = load_tex(row, 4 * T + t);     // gy
    }
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int r = tid / T + n * (S_THREADS / T);
      float v_r = 0.f, v_e = 0.f, v_w = 0.f;
      if (rowi[n] >= 0) {
        const float R = tex[n][0], R_next = tex[n][1], e = tex[n][2], w = tex[n][3];
        const float gx = tex[n][4], gy = tex[n][5], dx = d[n][0], dy = d[n][1];
        // every operation below is rounded on its own (no FMA contraction),
        // as the plain twin's one-operator-per-step PyTorch code rounds it:
        // these values are rounded to bf16 further on, and a last-bit
        // difference there can move a hard edge
        v_r = clampf(__fadd_rn(__fadd_rn(R, __fmul_rn(dx, gx)), __fmul_rn(dy, gy)), 0.f,
                     max_range);
        // the visibility edge is a fixed world point: rebuild it from the
        // stored sub-bin angle and the foreground range, re-bear it from the
        // pose
        const float theta_e = __fmul_rn(__fadd_rn((float)t, e), DTH);
        const float r_fore = fmaxf(fminf(R, R_next), 0.05f);
        const float ex = __fsub_rn(__fmul_rn(r_fore, cosf(theta_e)), dx);
        const float ey = __fsub_rn(__fmul_rn(r_fore, sinf(theta_e)), dy);
        float dbeta = __fsub_rn(atan2f(ey, ex), theta_e);
        dbeta = __fsub_rn(dbeta, __fmul_rn(rintf(__fmul_rn(dbeta, INV_TWO_PI)), TWO_PI));
        v_e = __fadd_rn(e, __fmul_rn(__fmul_rn(__fsub_rn(1.f, w), dbeta), INV_DTH));
        v_w = w;
      }
      xs[xs_at(0, t, r)] = v_r;
      xs[xs_at(1, t, r)] = v_e;
      xs[xs_at(2, t, r)] = v_w;
    }
    if (tid < S_ROWS) {
      const int k = row0 + tid;
      s_ii[tid] = k < K ? (int)scal[(size_t)k * 8 + 3] : 0;
      if (k < K) {
        const float R0 = load_tex(rt + (size_t)rows[k] * (CH * T), 0);
        out_fs[k] = scal[(size_t)k * 8 + 2];
        out_wsum[k] = scal[(size_t)k * 8 + 4] * fminf(R0 * 1e3f, 1.f);
        out_vel[k] = scal[(size_t)k * 8 + 5];
      }
    }
    __syncthreads();

    // the next tile's texture rows into L2 while this one is summed
    {
      constexpr int LINES = CH * T * (int)sizeof(TexT) / 128;
      const int k = row0 + (int)gridDim.x * S_ROWS + tid / LINES;
      if (tid < S_ROWS * LINES && k < K)
        rowtile::prefetch_l2(rt + (size_t)rows[k] * (CH * T) + (tid % LINES) * 128 / sizeof(TexT));
    }

    // ---- phase 2: packed rfft (X @ fmat), float64 -----------------------------
    // The spectra are summed in float64 and rounded once to float32, so they
    // do not depend on the order of summation: the e/w spectra are rounded
    // to bf16 next, and the plain twin must land on the same bf16 values.
    double acc[2][3][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[i][c][l] = 0.0;
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
      const double2 fa = *reinterpret_cast<const double2*>(fm + t * T + 4 * lq);
      const double2 fb = *reinterpret_cast<const double2*>(fm + t * T + 4 * lq + 2);
      const double f[4] = {fa.x, fa.y, fb.x, fb.y};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const double2 x = *reinterpret_cast<const double2*>(xs + xs_at(c, t, 2 * rg));
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          acc[0][c][l] = fma(x.x, f[l], acc[0][c][l]);
          acc[1][c][l] = fma(x.y, f[l], acc[1][c][l]);
        }
      }
    }
    __syncthreads();  // every thread is done with xs, which ss overwrites
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        *reinterpret_cast<float4*>(ss + (2 * rg + i) * SS_LD + c * T + 4 * lq) =
            make_float4((float)acc[i][c][0], (float)acc[i][c][1], (float)acc[i][c][2],
                        (float)acc[i][c][3]);
    __syncthreads();

    // ---- the integer-roll twiddle, then the rows out -------------------------
    // lanes [Re 0..T/2 | Im 1..T/2-1]; spec_sw[j] = spec[(j + T/2) % T]
    for (int it = tid; it < S_ROWS * NSPEC; it += S_THREADS) {
      const int r = it / NSPEC, c = (it / T) % 3, j = it % T;
      const int k = row0 + r;
      if (k >= K) break;
      const int l_eff = j <= HALF ? j : j - HALF;
      const int m = (s_ii[r] * l_eff) & (T - 1);  // floor-mod, as the twin's %
      const float sp = tab_s[m], cp = tab_c[m];
      const float qr = (j >= 1 && j <= HALF - 1) ? -sp : (j >= HALF + 1 ? sp : 0.f);
      const float* srow = ss + r * SS_LD + c * T;
      float v = __fadd_rn(__fmul_rn(srow[j], cp), __fmul_rn(srow[(j + HALF) % T], qr));
      if (c > 0 && ew_bf16) v = round_bf16(v);
      spec[(size_t)k * NSPEC + c * T + j] = v;
    }
    __syncthreads();  // ss, s_ii are rewritten by the next tile
  }
}

// ---- the render kernel -------------------------------------------------------

template <bool OPP, bool POOL, typename NoiseT>
__global__ void __launch_bounds__(edge_render::THREADS, edge_render::MIN_BLOCKS)
mega_render_kernel(const edge_render::Params p) {
  extern __shared__ __align__(16) float r_mem[];
  edge_render::run<OPP ? TAIL_TTC_OPP : TAIL_TTC, POOL, NoiseT>(r_mem, p);
}

// The spectra kernel's block shape, for rowtile::persistent_grid.
struct SpectraShape {
  static constexpr int THREADS = S_THREADS;
  static constexpr int BM = S_ROWS;
};

template <typename TexT>
int launch_spectra(const void* rt, const void* rows, const void* scal, const void* fmat,
                   float* spec, float* row_out, int K, float max_range, int ew_bf16,
                   cudaStream_t stream) {
  auto kernel = mega_spectra_kernel<TexT>;
  int grid = 0;
  const cudaError_t err = rowtile::persistent_grid<SpectraShape>(kernel, S_SMEM, K, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, S_THREADS, S_SMEM, stream>>>(
      static_cast<const TexT*>(rt), static_cast<const int*>(rows),
      static_cast<const float*>(scal), static_cast<const float*>(fmat), spec, row_out, K,
      max_range, ew_bf16);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the spectra kernel that one SM holds at once.
template <typename TexT>
int spectra_occupancy(int* blocks) {
  auto kernel = mega_spectra_kernel<TexT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, S_THREADS, S_SMEM);
  if (err != cudaSuccess) cudaGetLastError();  // clear it, so that it is not reported again
  return static_cast<int>(err);
}

// op.run<OPP, POOL, NoiseT>() of the render instance these operands select
template <class Op>
int by_variant(int n_opp, int pool_rows, int noise_bf16, const Op& op) {
  using bf = __nv_bfloat16;
  if (n_opp > 0) {
    if (pool_rows > 0)
      return noise_bf16 ? op.template run<true, true, bf>() : op.template run<true, true, float>();
    return noise_bf16 ? op.template run<true, false, bf>() : op.template run<true, false, float>();
  }
  if (pool_rows > 0)
    return noise_bf16 ? op.template run<false, true, bf>() : op.template run<false, true, float>();
  return noise_bf16 ? op.template run<false, false, bf>() : op.template run<false, false, float>();
}

struct Render {
  const edge_render::Params* p;
  cudaStream_t stream;
  template <bool OPP, bool POOL, typename NoiseT>
  int run() const {
    return edge_render::launch(mega_render_kernel<OPP, POOL, NoiseT>, *p, stream);
  }
};

struct RenderOccupancy {
  int n_opp;
  int* blocks;
  template <bool OPP, bool POOL, typename NoiseT>
  int run() const {
    return edge_render::occupancy(mega_render_kernel<OPP, POOL, NoiseT>, n_opp, blocks);
  }
};

}  // namespace

// C entry point, bound with ctypes.  Every pointer is a device pointer; scal
// is (K, 8) float32 [dx, dy, f_s, i_f, inb, vel, -, -]; rt is (N, 5*128)
// bf16 (rt_bf16) or float32; noise is bf16 (noise_bf16) or float32, either
// (K / agents_per_env, B) or, with pool_rows > 0, the (pool_rows, B) pool
// with pool_off a 1-element int32.  With n_opp > 0, sinv is (B,) float32 and
// opp is (K, 10 * n_opp) float32.  ws is a float32 workspace of K * (3 * 128
// + 3) values: the spectra kernel writes the rolled spectra (K, 3 * 128) and
// then f_s, wsum and vel (K,) each there, and the render kernel reads them.
// stages: 1 the spectra kernel, 2 the render kernel (on the workspace as a
// spectra launch left it), 3 both, in that order (a call of the scan).
// Launches on `stream` and returns the CUDA error: non-zero means that a
// launch did not happen.
extern "C" int mega_edge_ttc_launch(const void* rt, int rt_bf16, const void* rows,
                                    const void* scal, const void* fmat, const void* gmat,
                                    const void* c_frac, const void* noise, int noise_bf16,
                                    const void* cosv, const void* side, void* out,
                                    void* hit, int K, int B, int agents_per_env,
                                    float max_range, float ttc_thresh, int ew_bf16,
                                    const void* sinv, const void* opp, int n_opp,
                                    const void* pool_off, int pool_rows, void* ws,
                                    int stages, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* spec = static_cast<float*>(ws);
  float* row_out = spec + (size_t)K * NSPEC;
  if (stages & 1) {
    const int err = rt_bf16 ? launch_spectra<__nv_bfloat16>(rt, rows, scal, fmat, spec,
                                                            row_out, K, max_range, ew_bf16, s)
                            : launch_spectra<float>(rt, rows, scal, fmat, spec, row_out, K,
                                                    max_range, ew_bf16, s);
    if (err != 0) return err;
  }
  if (!(stages & 2)) return 0;
  edge_render::Params p{spec, spec + T, spec + 2 * T, NSPEC, row_out, row_out + K,
                        row_out + 2 * K, static_cast<const float*>(gmat),
                        static_cast<const float*>(c_frac), noise,
                        static_cast<const int*>(pool_off), pool_rows,
                        static_cast<const float*>(cosv), static_cast<const float*>(sinv),
                        static_cast<const float*>(side), static_cast<const float*>(opp), n_opp,
                        static_cast<float*>(out), static_cast<float*>(hit), K, B, agents_per_env,
                        max_range, ttc_thresh, ew_bf16, 0, 0};
  edge_render::set_paths(p, noise_bf16 ? 2 : 4);
  return by_variant(n_opp, pool_rows, noise_bf16, Render{&p, s});
}

// Blocks that one SM holds at once of the spectra kernel of rt_bf16's texture
// type and of the render instance that n_opp, pool_rows and noise_bf16 select
// (as mega_edge_ttc_launch selects them), at their shared memory; returns the
// CUDA error.
extern "C" int mega_edge_ttc_occupancy(int n_opp, int pool_rows, int rt_bf16, int noise_bf16,
                                       int* spectra_blocks, int* render_blocks) {
  *spectra_blocks = *render_blocks = 0;
  const int err = rt_bf16 ? spectra_occupancy<__nv_bfloat16>(spectra_blocks)
                          : spectra_occupancy<float>(spectra_blocks);
  if (err != 0) return err;
  return by_variant(n_opp, pool_rows, noise_bf16, RenderOccupancy{n_opp, render_blocks});
}
