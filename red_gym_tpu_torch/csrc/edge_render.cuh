// The seven-tap edge render on a register tile, with its noise, iTTC and
// opponent tails, for Hopper (sm_90a): rolled spectra -> scan.
//
// The counterpart of the TPU kernels' _edge_render_tile, _noise_ttc_tile and
// _opp_raycast_tile (red_gym_tpu/ops/pallas_scan.py :143, :181, :334) as
// _edge_kernel, _edge_ttc_kernel, _edge_ttc_opp_kernel and _mega_kernel use
// them.  Two kernels are built on it: csrc/theta_blend.cu's edge forms
// (kernels 6, 3 and 4) and csrc/mega_edge_ttc.cu's render, which reads the
// spectra that its spectra kernel writes.  Their plain PyTorch versions are
// scan_kernels.edge_render_reference, noise_ttc_reference and
// opp_cast_reference.
//
// Per row k and beam b, from the row's rolled spectra (range, e and w; T =
// 128 lanes each) and gmat (T, 3B) = [g0 | g1 | g2]: three range taps
// spec_r @ g0, g1, g2 and four e/w taps spec_e, spec_w @ g0, g1, whose
// inputs are rounded to bf16 under ew_bf16 (a bf16 x bf16 -> float32
// product), then the ramp through the active bin pair, mask and clip; with
// a tail, the env's noise row is added (a slab row, or the resident pool row
// (g + (*pool_off & ~15)) % pool_rows), the iTTC test runs (a row's hit is
// the OR over its beams) and the opponents shorten the beams in their
// windows.
//
// What bounds it: 7 x 2 x K x T x B operations, 63.4 GFLOP at K = 32768 and
// B = 1080: the three float32 range taps take 0.41 ms at the H100's 67
// TFLOP/s of float32 FMAs, the four bf16-input e/w taps 0.04 ms at its bf16
// tensor-core rate (0.54 ms as float32 FMAs), against about 0.07 ms of
// bytes.  The float32 bar keeps the range taps out of TF32, and a bf16
// tensor-core product of the e/w taps would sum in another order, so all
// seven taps are SIMT float32 FMAs here, and the design is that of an SGEMM:
//   block     THREADS = 256 threads (16 beam groups x 16 row groups) own a
//             tile of BM = 64 rows and walk every beam tile of BN = 64 beams;
//             the rows' three spectra stay in shared memory, transposed to
//             [channel][lane][row] (96 KB), so a row's hit stays in the block;
//             persistent: min(row tiles, SMs) blocks, one a SM.
//   ring      gmat streams through a 3-stage ring of BK = 32 lanes x BN beams
//             x up to three slabs, filled with cp.async (rowtile_gemm.cuh's
//             copy helpers), across beam tiles and row tiles alike.
//   two passes  each thread owns 4 rows x 4 beams.  Pass A runs the four e/w
//             taps over the 128 lanes (64 accumulators) on ring chunks of the
//             g0 and g1 slabs, which every thread rounds to bf16 in place, once
//             a chunk, in the part it copied itself; it reduces them to the ramp
//             weight aa per (row, beam).  Pass B runs the three range taps (48
//             accumulators) on chunks of g0, g1 and g2, and the render and tail
//             run on those registers.  Per lane a thread loads 4 float4 from
//             shared memory for 64 (pass A) or 48 (pass B) FMAs; the tap loops
//             are unrolled 8 lanes deep, since fully unrolled they outgrow the
//             instruction cache.
//   noise     with a tail, each thread loads the noise of its 4 rows at its 4
//             beams (a slab row, or a pool row, of each row's env) into
//             registers before pass B, so their latency hides behind the
//             range taps.
//   opponents  the cast runs in place on the beam tile's stored scan, a row a
//             warp, and only where a row's window meets the tile: in the
//             render's own lanes almost every warp holds a beam of some
//             window, and all its lanes would wait for the slab test.
//   order     every tap accumulator starts at 0 and takes fmaf(spec[k, j],
//             g[j, b], acc) for j = 0, 1, ..., 127 in turn, and the render and
//             tail round each operation as the earlier kernels did (the
//             expressions of scan_tail.cuh), so equal spectra give equal scans.
// No tensor cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "rowtile_gemm.cuh"
#include "scan_tail.cuh"

namespace edge_render {

using namespace scan_tail;

constexpr int T = 128;             // theta lanes
constexpr int THREADS = 256;       // threads a block
constexpr int MIN_BLOCKS = 1;      // resident blocks a SM (registers and shared memory)
constexpr int TM = 4, TN = 4;      // rows x beams a thread
constexpr int BM = THREADS / 16 * TM;  // rows a block tile
constexpr int BN = 16 * TN;        // beams a beam tile
constexpr int BK = 32;             // lanes a ring chunk
constexpr int NKC = T / BK;        // ring chunks a pass
constexpr int STAGES = 3;          // ring depth
constexpr int NSLAB = 3;           // gmat slabs a stage holds (pass A fills two)
constexpr int CHUNK = NSLAB * BK * BN;       // floats a ring stage
constexpr int SPEC = 3 * T * BM;             // floats of the resident spectra
constexpr int ROW_OFF = SPEC + STAGES * CHUNK;  // per-row arrays after the ring
constexpr int N_ROW = 4;                     // fs, wsum, vel, hit
constexpr int OPP_OFF = ROW_OFF + N_ROW * BM;   // the rows' opponent packs

enum Tail { TAIL_NONE = 0, TAIL_TTC = 1, TAIL_TTC_OPP = 2 };

// Dynamic shared memory of a launch with n_opp opponents a row.
inline size_t smem_bytes(int n_opp) {
  return sizeof(float) * (OPP_OFF + (size_t)BM * OPP_PACK * n_opp);
}

// A launch's operands.  Every pointer is a device pointer to float32 unless
// stated: spec_r, spec_e and spec_w (K, T) with one row stride ld; fs, wsum
// and vel (K,); gmat (T, 3B); c_frac, cosv, sinv and side (B,); noise (rows,
// B) of NoiseT; pool_off a 1-element int32 (POOL); opp (K, 10 n_opp); out
// (K, B) and hit (K,).  vec and nz_vec are set from these by set_paths.
struct Params {
  const float* spec_r;
  const float* spec_e;
  const float* spec_w;
  int ld;
  const float* fs;
  const float* wsum;
  const float* vel;
  const float* gmat;
  const float* c_frac;
  const void* noise;
  const int* pool_off;
  int pool_rows;
  const float* cosv;
  const float* sinv;
  const float* side;
  const float* opp;
  int n_opp;
  float* out;
  float* hit;
  int K, B, agents_per_env;
  float max_range, ttc_thresh;
  int ew_bf16;
  int vec;     // 16-byte copies, loads and stores of spectra, gmat and out
  int nz_vec;  // a load of 4 noise values at once (B % 4 == 0, rows aligned)
};

// The block tile's spectra into sS[c][lane][row], e/w rounded to bf16 under
// ew_bf16; rows past K read 0.  Thread t takes row t % BM and a quarter of
// the lanes: the stores of a warp go to 32 consecutive rows, one bank each.
__device__ __forceinline__ void stage_spectra(float* sS, const Params& p, int row0, int tid) {
  const int r = tid % BM, j0 = (tid / BM) * (T / 4);
  const int k = row0 + r;
  const bool ok = k < p.K;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* spec = c == 0 ? p.spec_r : (c == 1 ? p.spec_e : p.spec_w);
    const float* src = spec + (size_t)(ok ? k : 0) * p.ld + j0;
    const bool bf = c > 0 && p.ew_bf16;
    float* dst = sS + (c * T + j0) * BM + r;
    if (p.vec) {
#pragma unroll
      for (int i = 0; i < T / 16; ++i) {
        float4 v = ok ? __ldg(reinterpret_cast<const float4*>(src) + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        if (bf) v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                                round_bf16(v.w));
        dst[(4 * i + 0) * BM] = v.x;
        dst[(4 * i + 1) * BM] = v.y;
        dst[(4 * i + 2) * BM] = v.z;
        dst[(4 * i + 3) * BM] = v.w;
      }
    } else {
#pragma unroll 8
      for (int i = 0; i < T / 4; ++i) {
        const float v = ok ? __ldg(src + i) : 0.f;
        dst[i * BM] = bf ? round_bf16(v) : v;
      }
    }
  }
}

// The next block tile's spectra into L2 while this one is multiplied.
__device__ __forceinline__ void prefetch_spectra(const Params& p, int row0, int tid) {
  constexpr int LINES = T * (int)sizeof(float) / 128;  // a row's lines a channel
  for (int it = tid; it < BM * 3 * LINES; it += THREADS) {
    const int r = it / (3 * LINES), c = (it / LINES) % 3, l = it % LINES;
    const int k = row0 + r;
    if (k >= p.K) break;
    const float* spec = c == 0 ? p.spec_r : (c == 1 ? p.spec_e : p.spec_w);
    rowtile::prefetch_l2(spec + (size_t)k * p.ld + l * 32);
  }
}

// Ring chunk kc (lanes kc * BK ..) of nslab gmat slabs of the beam tile at b0
// into `stage` ([slab][lane][beam]); beams past B read 0.  A thread's copies
// lie at the stage offsets tid, tid + THREADS, ... (in 16- or 4-byte units),
// which round_chunk relies on.
__device__ __forceinline__ void load_chunk(float* stage, const Params& p, int b0, int kc,
                                           int nslab, int tid) {
  const size_t ldg = 3 * (size_t)p.B;
  if (p.vec) {
    for (int f = tid; f < nslab * BK * BN / 4; f += THREADS) {
      const int n = (f % (BN / 4)) * 4, kk = (f / (BN / 4)) % BK, s = f / (BN / 4 * BK);
      const bool ok = b0 + n < p.B;
      const float* src = ok ? p.gmat + (size_t)(kc * BK + kk) * ldg + (size_t)s * p.B + b0 + n
                            : p.gmat;
      rowtile::cp_async_16(stage + (s * BK + kk) * BN + n, src, ok ? 16 : 0);
    }
  } else {
    for (int f = tid; f < nslab * BK * BN; f += THREADS) {
      const int n = f % BN, kk = (f / BN) % BK, s = f / (BN * BK);
      const bool ok = b0 + n < p.B;
      const float* src = ok ? p.gmat + (size_t)(kc * BK + kk) * ldg + (size_t)s * p.B + b0 + n
                            : p.gmat;
      rowtile::cp_async_4(stage + (s * BK + kk) * BN + n, src, ok ? 4 : 0);
    }
  }
}

// The bf16 rounding of this thread's own copies of a pass-A chunk (g0 and
// g1), after they landed: the copies of load_chunk with nslab = 2.
__device__ __forceinline__ void round_chunk(float* stage, const Params& p, int tid) {
  const int per = p.vec ? 4 : 1;
  for (int f = tid; f < 2 * BK * BN / per; f += THREADS) {
    float* v = stage + f * per;  // the copy pattern is the stage's own order
    for (int q = 0; q < per; ++q) v[q] = round_bf16(v[q]);
  }
}

// Pass A on one ring chunk: the four e/w taps of a thread's 4 x 4 tile.
__device__ __forceinline__ void taps_ew(const float* sS, const float* stage, int kc, int tx,
                                        int ty, float (&ea)[TM][TN], float (&eb)[TM][TN],
                                        float (&wa)[TM][TN], float (&wb)[TM][TN]) {
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    const int j = kc * BK + kk;
    const float4 e4 = *reinterpret_cast<const float4*>(sS + (1 * T + j) * BM + ty * TM);
    const float4 w4 = *reinterpret_cast<const float4*>(sS + (2 * T + j) * BM + ty * TM);
    const float4 a4 = *reinterpret_cast<const float4*>(stage + (0 * BK + kk) * BN + tx * TN);
    const float4 b4 = *reinterpret_cast<const float4*>(stage + (1 * BK + kk) * BN + tx * TN);
    const float e[TM] = {e4.x, e4.y, e4.z, e4.w}, w[TM] = {w4.x, w4.y, w4.z, w4.w};
    const float a[TN] = {a4.x, a4.y, a4.z, a4.w}, b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        ea[i][q] = fmaf(e[i], a[q], ea[i][q]);
        eb[i][q] = fmaf(e[i], b[q], eb[i][q]);
        wa[i][q] = fmaf(w[i], a[q], wa[i][q]);
        wb[i][q] = fmaf(w[i], b[q], wb[i][q]);
      }
  }
}

// Pass B on one ring chunk: the three range taps of a thread's 4 x 4 tile.
__device__ __forceinline__ void taps_range(const float* sS, const float* stage, int kc, int tx,
                                           int ty, float (&g0)[TM][TN], float (&g1)[TM][TN],
                                           float (&g2)[TM][TN]) {
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    const int j = kc * BK + kk;
    const float4 r4 = *reinterpret_cast<const float4*>(sS + j * BM + ty * TM);
    const float4 x4 = *reinterpret_cast<const float4*>(stage + (0 * BK + kk) * BN + tx * TN);
    const float4 y4 = *reinterpret_cast<const float4*>(stage + (1 * BK + kk) * BN + tx * TN);
    const float4 z4 = *reinterpret_cast<const float4*>(stage + (2 * BK + kk) * BN + tx * TN);
    const float r[TM] = {r4.x, r4.y, r4.z, r4.w};
    const float x[TN] = {x4.x, x4.y, x4.z, x4.w}, y[TN] = {y4.x, y4.y, y4.z, y4.w},
                z[TN] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        g0[i][q] = fmaf(r[i], x[q], g0[i][q]);
        g1[i][q] = fmaf(r[i], y[q], g1[i][q]);
        g2[i][q] = fmaf(r[i], z[q], g2[i][q]);
      }
  }
}

// Four noise values of one row from beam b (vec: one 16- or 8-byte load).
__device__ __forceinline__ void load_noise4(const float* row, int b, int B, bool vec,
                                            float (&v)[TN]) {
  if (vec) {
    const float4 x = *reinterpret_cast<const float4*>(row + b);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int q = 0; q < TN; ++q) v[q] = b + q < B ? row[b + q] : 0.f;
  }
}
__device__ __forceinline__ void load_noise4(const __nv_bfloat16* row, int b, int B, bool vec,
                                            float (&v)[TN]) {
  if (vec) {
    const uint2 x = *reinterpret_cast<const uint2*>(row + b);
    v[0] = __uint_as_float(x.x << 16), v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16), v[3] = __uint_as_float(x.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int q = 0; q < TN; ++q) v[q] = b + q < B ? __bfloat162float(row[b + q]) : 0.f;
  }
}

// Row k's scan o at beams b .. b + 3 (those below B).
__device__ __forceinline__ void store4(const Params& p, int k, int b, const float (&o)[TN]) {
  float* orow = p.out + (size_t)k * p.B;
  if (p.vec) {
    *reinterpret_cast<float4*>(orow + b) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int q = 0; q < TN; ++q)
      if (b + q < p.B) orow[b + q] = o[q];
  }
}

// The whole kernel body, for a kernel of THREADS threads launched with
// smem_bytes(n_opp) of dynamic shared memory (`smem`) on a persistent grid.
template <int TAIL, bool POOL, typename NoiseT>
__device__ __forceinline__ void run(float* smem, const Params& p) {
  constexpr bool TTC = TAIL != TAIL_NONE, OPP = TAIL == TAIL_TTC_OPP;
  float* sS = smem;
  float* ring = smem + SPEC;
  float* s_fs = smem + ROW_OFF;
  float* s_wsum = s_fs + BM;
  float* s_vel = s_wsum + BM;
  int* s_hit = reinterpret_cast<int*>(s_vel + BM);
  float* s_opp = smem + OPP_OFF;  // [BM][n_opp][OPP_PACK] (OPP)
  const NoiseT* noise = static_cast<const NoiseT*>(p.noise);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int K = p.K, B = p.B;
  const int n_tiles = (K + BM - 1) / BM;
  const int nbt = (B + BN - 1) / BN;
  const int per_tile = nbt * 2 * NKC;  // ring chunks a row tile: two passes a beam tile
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int n_chunks = my_tiles * per_tile;
  const int pack = OPP ? OPP_PACK * p.n_opp : 0;
  const int off = POOL ? (*p.pool_off & ~15) : 0;

  // chunk g of this block's sequence goes to stage g % STAGES; pass A's
  // chunks (q / NKC even) carry g0 and g1, pass B's g0, g1 and g2; every
  // call commits one group, empty past the end
  auto fetch = [&](int g) {
    if (g < n_chunks) {
      const int q = g % per_tile;
      load_chunk(ring + (g % STAGES) * CHUNK, p, (q / (2 * NKC)) * BN, q % NKC,
                 (q / NKC) % 2 ? 3 : 2, tid);
    }
    rowtile::cp_async_commit();
  };
  for (int g = 0; g < STAGES - 1; ++g) fetch(g);

  int g = 0;
  // wait for chunk g, round it (pass A), and start the copy of chunk g + 2
  // into the stage that every thread has finished reading
  auto next_stage = [&](bool ew_round) -> const float* {
    rowtile::cp_async_wait<STAGES - 2>();
    float* stage = ring + (g % STAGES) * CHUNK;
    if (ew_round) round_chunk(stage, p, tid);
    __syncthreads();
    fetch(g + STAGES - 1);
    ++g;
    return stage;
  };

  for (int t = 0; t < my_tiles; ++t) {
    const int row0 = ((int)blockIdx.x + t * (int)gridDim.x) * BM;
    // the previous tile's readers of shared memory finished before its
    // flush barrier
    stage_spectra(sS, p, row0, tid);
    if (tid < BM) {
      const int k = row0 + tid;
      s_fs[tid] = k < K ? p.fs[k] : 0.f;
      s_wsum[tid] = k < K ? p.wsum[k] : 0.f;
      s_vel[tid] = TTC && k < K ? p.vel[k] : 0.f;
      s_hit[tid] = 0;
    }
    for (int it = tid; it < BM * pack; it += THREADS) {
      const int k = row0 + it / pack;
      s_opp[it] = k < K ? p.opp[(size_t)k * pack + it % pack] : 0.f;
    }
    if (t + 1 < my_tiles) prefetch_spectra(p, row0 + (int)gridDim.x * BM, tid);

    for (int bt = 0; bt < nbt; ++bt) {
      const int b0 = bt * BN, b = b0 + tx * TN;  // the tile's and this thread's first beam
      float cf[TN];
#pragma unroll
      for (int q = 0; q < TN; ++q) cf[q] = b + q < B ? p.c_frac[b + q] : 0.f;

      // ---- pass A: e/w taps -> ramp weight ----------------------------------
      float aa[TM][TN];
      {
        float ea[TM][TN], eb[TM][TN], wa[TM][TN], wb[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q) ea[i][q] = eb[i][q] = wa[i][q] = wb[i][q] = 0.f;
        for (int kc = 0; kc < NKC; ++kc)
          taps_ew(sS, next_stage(p.ew_bf16), kc, tx, ty, ea, eb, wa, wb);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float fs = s_fs[ty * TM + i];
#pragma unroll
          for (int q = 0; q < TN; ++q) {
            // the ramp through the active pair (0, 1) or (1, 2); a smooth
            // pair (e, w) = (0.5, 1) is the lerp
            const float alpha = fs + cf[q];
            const bool lt = alpha < 1.f;
            const float frac = alpha - floorf(alpha);
            const float e_sel = clampf(lt ? ea[i][q] : eb[i][q], 0.f, 1.f);
            const float w_sel = clampf(lt ? wa[i][q] : wb[i][q], 1.f / 32.f, 1.f);
            aa[i][q] = clampf((frac - (e_sel - 0.5f * w_sel)) / w_sel, 0.f, 1.f);
          }
        }
      }

      // ---- the tail's noise, then pass B: range taps -------------------------
      float nz[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int k = row0 + ty * TM + i;
#pragma unroll
        for (int q = 0; q < TN; ++q) nz[i][q] = 0.f;
        if (TTC && k < K && b < B) {
          const int e = k / p.agents_per_env;
          const size_t nrow = POOL ? (size_t)((e + off) % p.pool_rows) : (size_t)e;
          load_noise4(noise + nrow * B, b, B, p.nz_vec, nz[i]);
        }
      }
      float g0[TM][TN], g1[TM][TN], g2[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < TN; ++q) g0[i][q] = g1[i][q] = g2[i][q] = 0.f;
      for (int kc = 0; kc < NKC; ++kc) taps_range(sS, next_stage(false), kc, tx, ty, g0, g1, g2);

      // ---- render and tail ----------------------------------------------------
      if (b < B) {
        float cb[TN], sd[TN];
        if constexpr (TTC) {
#pragma unroll
          for (int q = 0; q < TN; ++q) {
            cb[q] = b + q < B ? p.cosv[b + q] : 0.f;
            sd[q] = b + q < B ? p.side[b + q] : 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = ty * TM + i, k = row0 + r;
          if (k >= K) continue;
          const float fs = s_fs[r];
          const bool live = s_wsum[r] > 0.f;
          bool any = false;
          float o[TN];
#pragma unroll
          for (int q = 0; q < TN; ++q) {
            const float alpha = fs + cf[q];
            const bool lt = alpha < 1.f;
            const float ga = lt ? g0[i][q] : g1[i][q];
            const float gb = lt ? g1[i][q] : g2[i][q];
            float v = ga + aa[i][q] * (gb - ga);
            v = live ? v : 0.f;
            v = clampf(v, 0.f, p.max_range);
            if constexpr (TTC) {
              v = __fadd_rn(v, nz[i][q]);
              any |= b + q < B && ttc_hit(v, s_vel[r], cb[q], sd[q], p.ttc_thresh);
            }
            o[q] = v;
          }
          store4(p, k, b, o);
          if (TTC && any) s_hit[r] = 1;  // the same value from every writer
        }
      }
      // ---- opponents ----------------------------------------------------------
      // They shorten the noisy scan after the iTTC test, as the TPU kernel
      // orders it: the wall hit flags come from the pre-opponent scan.  A
      // row's opponent covers a window [lo, hi] of some dozens of beams, so
      // once the tile's scan is stored the cast runs in place: warp w takes
      // rows w, w + 8, ..., and only a window that meets the beam tile costs
      // its lanes the slab test, on the tile's beams in turn.  No barrier
      // follows: the next beam tile's stores go elsewhere.
      if constexpr (OPP) {
        __syncthreads();  // the tile's stores are visible to the block
        for (int r = warp; r < BM; r += THREADS / 32) {
          if (row0 + r >= K) break;
          float* orow = p.out + (size_t)(row0 + r) * B;
          for (int q = 0; q < p.n_opp; ++q) {
            const float* pk = s_opp + r * pack + q * OPP_PACK;
            if (!(pk[1] >= (float)b0 && pk[0] <= (float)(b0 + BN - 1))) continue;
            for (int n = lane; n < BN; n += 32) {
              const int bb = b0 + n;
              const float bpos = (float)bb;
              if (bb < B && bpos >= pk[0] && bpos <= pk[1])
                orow[bb] = nan_min(orow[bb], opp_hit(pk, p.cosv[bb], p.sinv[bb]));
            }
          }
        }
      }
    }
    __syncthreads();
    if (TTC && tid < BM && row0 + tid < K) p.hit[row0 + tid] = s_hit[tid] ? 1.f : 0.f;
  }
  rowtile::cp_async_wait<0>();
}

// The block shape of rowtile::persistent_grid.
struct Shape {
  static constexpr int THREADS = edge_render::THREADS;
  static constexpr int BM = edge_render::BM;
};

// Launch `kernel` (a __global__ wrapper of run<>) with n_opp opponents: sets
// its dynamic shared memory, sizes the persistent grid and launches on
// `stream`.  Returns the CUDA error (cleared): non-zero means no launch.
template <class Kernel>
int launch(Kernel kernel, const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.n_opp);
  int grid = 0;
  const cudaError_t err = rowtile::persistent_grid<Shape>(kernel, smem, p.K, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `kernel` that one SM holds at once with n_opp opponents.
template <class Kernel>
int occupancy(Kernel kernel, int n_opp, int* blocks) {
  const size_t smem = smem_bytes(n_opp);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// Set p.vec (16-byte copies, loads and stores of the spectra, gmat and out)
// and p.nz_vec (4 noise values a load: B % 4 == 0 and noise aligned to 4
// values) from the operands; noise_elem is the noise's element size.
inline void set_paths(Params& p, size_t noise_elem) {
  p.vec = p.B % 4 == 0 && p.ld % 4 == 0 &&
          rowtile::aligned16({p.spec_r, p.spec_e, p.spec_w, p.gmat, p.out});
  p.nz_vec = p.noise != nullptr && p.B % 4 == 0 &&
             reinterpret_cast<size_t>(p.noise) % (4 * noise_elem) == 0;
}

}  // namespace edge_render
