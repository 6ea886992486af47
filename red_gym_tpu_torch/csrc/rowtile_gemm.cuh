// The register-tiled float32 mainloop of the scan's plain-product kernels:
// out[k, b] = epilogue(sum over j of spec[k, j] * mat[j, b]) for K rows, a
// depth of T = 128 theta lanes and B beams, with one to three matrix slabs.
//
// It serves two TPU kernels of red_gym_tpu/ops/pallas_scan.py:
//   _kernel (:35, theta_shuffle_blend, kernel 7)  three slabs, the 3-tap blend
//   _spec_ttc_kernel (:646, theta_spectral_ttc, kernel 5)  one slab, noise + iTTC
// (csrc/theta_blend.cu and csrc/theta_spectral.cu hold their kernels and
// tails).  At K = 32768 and B = 1080 they are bound by float32 FMAs (9.1 and
// 27.2 GFLOP against 0.2 GB of bytes), and the float32 bar keeps them out of
// TF32, so the design is that of a SIMT SGEMM whose inner loop does nothing
// but FMAs:
//   block    THREADS threads (16 beam groups x THREADS / 16 row groups)
//            own BM = THREADS / 2 consecutive rows and all B beams of them.
//            The rows' spectra stay in shared memory, transposed to
//            [lane][row], while the block walks the beam tiles (as the TPU
//            kernel's sequential beam-tile grid axis does), so a row's
//            reduction over beams (kernel 5's iTTC hit) stays in the block.
//   ring     the matrix streams through a 3-stage ring of BK = 16 lanes by
//            BN beams a slab, filled with cp.async (16 bytes a thread, or 4
//            where B % 4 or an alignment forbids it), so that the next chunk
//            loads while this one is multiplied, across beam tiles and row
//            tiles alike.
//   registers  each thread owns 8 rows x TN beams of every slab (rows
//            4ty..4ty+3 and BM / 2 + 4ty.., beams 4tx..4tx+3 and, for
//            TN = 8, 64 + 4tx..): per lane two float4 of spectra (a
//            broadcast) and TN / 4 float4 of each slab feed 8 x TN x NSLAB
//            FMAs.
//   order    every accumulator starts at 0 and takes fmaf(spec[k, j],
//            mat[j, b], acc) for j = 0, 1, ..., 127 in turn: no split of the
//            depth, the rounding of a sequential float32 dot product.
//   grid     persistent: min(row tiles, SMs x resident blocks) blocks, each
//            looping over row tiles.
// No tensor cores: float32 FMAs, so no TF32 rounding.

#pragma once

#include <cuda_runtime.h>

#include <stddef.h>

#include <initializer_list>

namespace rowtile {

constexpr int T = 128;        // depth: theta lanes
constexpr int TM = 8;         // rows a thread: two groups of 4, BM / 2 apart
constexpr int HALF = 64;      // distance of a thread's second beam group
constexpr int BK = 16;        // lanes a ring chunk
constexpr int NKC = T / BK;   // ring chunks a beam tile
constexpr int STAGES = 3;     // ring depth

// One instance of the mainloop: THREADS threads, TN beams a thread in each
// of NSLAB matrix slabs (mat[:, s * B + b] is slab s), 16-byte copies when
// VEC.
template <int TN_, int NSLAB_, bool VEC_, int THREADS_>
struct Tile {
  static constexpr int TN = TN_;
  static constexpr int NSLAB = NSLAB_;
  static constexpr bool VEC = VEC_;
  static constexpr int THREADS = THREADS_;
  static constexpr int BM = THREADS / 2;        // rows a block tile
  static constexpr int RH = BM / 2;             // distance of a thread's second row group
  static constexpr int NG = TN / 4;             // beam groups a thread
  static constexpr int BN = HALF * NG;          // beams a tile
  static constexpr int NACC = NSLAB * TN;       // accumulators a row
  static constexpr int CHUNK = NSLAB * BK * BN; // floats a ring stage
  static constexpr int ROW_OFF = T * BM + STAGES * CHUNK;  // per-row scalars
  static_assert(CHUNK % (4 * THREADS) == 0, "whole 16-byte copies a thread");
  // dynamic shared memory with n_row per-row float arrays after the ring
  static constexpr size_t smem_bytes(int n_row) {
    return sizeof(float) * (size_t)(ROW_OFF + n_row * BM);
  }
  // row (of the block tile) and beam (of the beam tile) of a thread's
  // register i of TM, n of TN
  static __device__ __forceinline__ int row_of(int i, int ty) {
    return (i >> 2) * RH + ty * 4 + (i & 3);
  }
  static __device__ __forceinline__ int beam_of(int n, int tx) {
    return (n >> 2) * HALF + tx * 4 + (n & 3);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// a hint to bring the line at p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The rows' spectra (row stride ld) into sS[lane][row]; rows past K read 0.
// Thread t takes row t % BM and one half of its lanes: the stores of a warp
// go to 32 consecutive rows, one bank each.
template <class C>
__device__ __forceinline__ void stage_spectra(float* sS, const float* __restrict__ spec,
                                              int ld, int K, int row0, int tid) {
  constexpr int BM = C::BM;
  const int r = tid % BM, j0 = (tid / BM) * (T / 2);
  const int k = row0 + r;
  const bool ok = k < K;
  const float* src = spec + (size_t)(ok ? k : 0) * ld + j0;
  if constexpr (C::VEC) {
#pragma unroll
    for (int i = 0; i < T / 8; ++i) {
      const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(src) + i)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      float* dst = sS + (j0 + 4 * i) * BM + r;
      dst[0] = v.x;
      dst[BM] = v.y;
      dst[2 * BM] = v.z;
      dst[3 * BM] = v.w;
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < T / 2; ++i) sS[(j0 + i) * BM + r] = ok ? __ldg(src + i) : 0.f;
  }
}

// Ring chunk kc (lanes kc * BK ..) of the beam tile at b0, every slab, into
// `stage`; beams past B read 0.  mat is (T, NSLAB * B) row-major.
template <class C>
__device__ __forceinline__ void load_chunk(float* stage, const float* __restrict__ mat, int B,
                                           int b0, int kc, int tid) {
  const size_t ldm = (size_t)C::NSLAB * B;
  if constexpr (C::VEC) {
    constexpr int N4 = C::BN / 4;
#pragma unroll
    for (int i = 0; i < C::CHUNK / 4 / C::THREADS; ++i) {
      const int f = tid + i * C::THREADS;
      const int n = (f % N4) * 4, kk = (f / N4) % BK, s = f / (N4 * BK);
      const bool ok = b0 + n < B;
      const float* src = ok ? mat + (size_t)(kc * BK + kk) * ldm + (size_t)s * B + b0 + n : mat;
      cp_async_16(stage + (s * BK + kk) * C::BN + n, src, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < C::CHUNK / C::THREADS; ++i) {
      const int f = tid + i * C::THREADS;
      const int n = f % C::BN, kk = (f / C::BN) % BK, s = f / (C::BN * BK);
      const bool ok = b0 + n < B;
      const float* src = ok ? mat + (size_t)(kc * BK + kk) * ldm + (size_t)s * B + b0 + n : mat;
      cp_async_4(stage + (s * BK + kk) * C::BN + n, src, ok ? 4 : 0);
    }
  }
}

// The BK lanes of one ring stage into the accumulators, NGA of the NG beam
// groups (the other stay 0: a last tile of at most HALF beams has no second).
template <class C, int NGA>
__device__ __forceinline__ void mma_chunk(const float* sS, const float* stage, int kc, int tx,
                                          int ty, float (&acc)[TM][C::NACC]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float* sa = sS + (kc * BK + kk) * C::BM + ty * 4;
    const float4 a0 = *reinterpret_cast<const float4*>(sa);
    const float4 a1 = *reinterpret_cast<const float4*>(sa + C::RH);
    const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int s = 0; s < C::NSLAB; ++s) {
#pragma unroll
      for (int g = 0; g < NGA; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(stage + (s * BK + kk) * C::BN + g * HALF + tx * 4);
        const float b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float& c = acc[i][s * C::TN + g * 4 + q];
            c = fmaf(a[i], b[q], c);
          }
      }
    }
  }
}

// The whole kernel body.  `smem` is the dynamic shared memory of
// Tile::smem_bytes; the epilogue `epi` provides
//   rows(row0, tid)                     per-row scalars of a row tile
//   prefetch(row0, b0, tid)             at the start of a beam tile
//   tile(acc, row0, b0, tx, ty)         a thread's registers of a beam tile
//   flush(row0, tid)                    per-row results, after a barrier
template <class C, class Epi>
__device__ __forceinline__ void run(float* smem, const float* __restrict__ spec, int ld,
                                    const float* __restrict__ mat, int K, int B,
                                    const Epi& epi) {
  constexpr int BM = C::BM;
  float* sS = smem;
  float* ring = smem + T * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_tiles = (K + BM - 1) / BM;
  const int nbt = (B + C::BN - 1) / C::BN;
  const int per_tile = nbt * NKC;  // ring chunks a row tile
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int n_chunks = my_tiles * per_tile;

  // chunk g of this block's sequence goes to stage g % STAGES; every call
  // commits one group, empty past the end
  auto fetch = [&](int g) {
    if (g < n_chunks) {
      const int q = g % per_tile;
      load_chunk<C>(ring + (g % STAGES) * C::CHUNK, mat, B, (q / NKC) * C::BN, q % NKC, tid);
    }
    cp_async_commit();
  };
  for (int g = 0; g < STAGES - 1; ++g) fetch(g);

  int g = 0;
  for (int t = 0; t < my_tiles; ++t) {
    const int row0 = ((int)blockIdx.x + t * (int)gridDim.x) * BM;
    // the previous tile's readers of sS finished before its flush barrier
    stage_spectra<C>(sS, spec, ld, K, row0, tid);
    epi.rows(row0, tid);
    for (int bt = 0; bt < nbt; ++bt) {
      const int b0 = bt * C::BN;
      const bool narrow = C::NG > 1 && B - b0 <= HALF;
      epi.prefetch(row0, b0, tid);
      float acc[TM][C::NACC];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < C::NACC; ++n) acc[i][n] = 0.f;
      for (int kc = 0; kc < NKC; ++kc, ++g) {
        cp_async_wait<STAGES - 2>();
        // chunk g has landed for every thread, and every thread is done with
        // chunk g - 1, whose stage the next fetch overwrites
        __syncthreads();
        fetch(g + STAGES - 1);
        const float* stage = ring + (g % STAGES) * C::CHUNK;
        if (narrow)
          mma_chunk<C, 1>(sS, stage, kc, tx, ty, acc);
        else
          mma_chunk<C, C::NG>(sS, stage, kc, tx, ty, acc);
      }
      epi.tile(acc, row0, b0, tx, ty);
    }
    __syncthreads();
    epi.flush(row0, tid);
  }
  cp_async_wait<0>();
}

// Prepare a launch of `kernel` with `smem` bytes of dynamic shared memory
// over K rows: one block per row tile, at most as many as the card holds at
// once.  Returns the CUDA error (cleared), or cudaSuccess and *grid.
template <class C, class Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int K, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::THREADS, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported again later
    return err;
  }
  const int tiles = (K + C::BM - 1) / C::BM;
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  *grid = tiles < slots ? tiles : slots;
  return cudaSuccess;
}

// Whether every pointer is 16-byte aligned (the VEC instances' condition,
// with B % 4 == 0 and a row stride that is a multiple of 4).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<size_t>(p) % 16) return false;
  return true;
}

}  // namespace rowtile
