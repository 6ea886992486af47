// Lidar-bitmap rasterizer for Hopper (sm_90a): the polygon fill and the
// line-segment draw of lidar_to_bitmap.
//
// Replaces no Pallas kernel: the JAX package rasterizes with one broadcast
// that XLA fuses, red_gym_tpu/ops/rasterize.py:43 (_fill_polygon: a
// crossing-number test of every pixel against every polygon edge, an
// (H, W, K) = 256 x 256 x 600 array an image) and :67 (_draw_segments: 448
// samples a segment scattered into the mask).  The plain PyTorch versions
// these kernels are held against (torch.equal on the card) are in
// red_gym_tpu_torch/ops/raster_kernels.py (fill_polygon_reference,
// draw_segments_reference).
//
// fill_polygon_kernel.  Pixel (px, py) is inside where the edges (x1, y1) ->
// (x2, y2) with (y1 > py) != (y2 > py) and px < x_int, x_int = (x2 - x1) *
// (py - y1) / denom + x1, are odd in number.  A block covers a band of rows
// (and a tile of at most 8192 columns) of one image.  Its threads load 4
// edges each at once; an edge crosses the rows [min(y1, y2), max(y1, y2))
// (the y's are integers), and for each such row of the band x_int is
// computed with the twin's sequence of operations.  The pixels left of a
// crossing are a prefix of the row, px < ceil(x_int) (where pixel indices
// are exact floats; first_not_below_wide past 2^24), so a crossing toggles
// one bit of the row's difference bits in shared memory (atomicXor), and
// the parity of the bits above a pixel says whether it is inside: a warp a
// row takes 8 pixels a lane, a suffix XOR over the lanes (__shfl_down_sync)
// and within each lane's byte, and writes them with one 8-byte store.  Order
// does not change a parity, so the result is bit-equal to the twin.
//
// draw_segments_kernel.  The sample point is s * (1 - t) + e * t with the
// caller's t table, rounded as XLA's CPU code rounds it, fma(s, 1 - t, e * t)
// (one rounding of the first product and the sum), then rint (half to
// even), clip to the canvas, and a 1 stored there in place.  A warp draws a
// segment 32 consecutive samples at a time, lane l sample 32 * it + l, and a
// lane stores its pixel only where it differs from the sample before it,
// lane l - 1's or, for lane 0, lane 31's of the iteration before (the run
// test, one __shfl_sync).  At segment_t's 448 samples a warp holds its
// lanes' 14 t's in registers and computes a segment's 14 pixels before
// their run tests; where one warp a segment would leave the card short of
// blocks (few images) the iterations are split into pieces on blockIdx.z.
// On canvases under 2^24 pixels the pixel is kept as a float index: clip,
// then rint by adding and subtracting 1.5 * 2^23 (exact below 2^22), no
// float-to-int conversion a sample.  Every store writes 1, so their order
// does not matter.
//
// Rounding.  Built with -fmad=false (ops/_build.py), and the arithmetic is
// written with the _rn intrinsics: every operation rounds on its own, with
// IEEE division, as the one-kernel-per-operator PyTorch twins round it; the
// one fused multiply-add is explicit.  So kernels and twins agree bit for
// bit.
//
// What bounds them on the H100, at 64 images x 256 x 256 and K = 600 (the
// exact scan on track_0019).  The fill reads 0.3 MB of points and writes 4.2
// MB of mask, 1.3 us at the memory rate; its least work, a few operations
// an edge and a crossing and one a pixel, is far less, so bytes bound it.
// The draw's least work is the samples of the segments whose endpoints
// differ (a third are one pixel), about 11.3 M of 11 lane instructions, and
// 1 - t once a t: 3.7 us at the lane rate; the kernel evaluates all 17.2 M
// samples (a one-pixel shortcut that holds for any t did not pay).  The
// earlier forms (a block a pixel row, each reading all 600 points; a thread
// a sample and 17.2 M scattered byte stores, most onto pixels set already)
// took 0.027 and 0.079 ms; these take 0.0106 and 0.0214 ms, and at one image
// 0.0024 and 0.0023 ms (device time, prestep_ab.py --kernel raster, H100
// 80GB HBM3 at 700 W; PERF.md section 6, rows R and R-d, with the forms
// tried on the way).

#include <cuda_runtime.h>

#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int FILL_WARPS = 8;
constexpr int DRAW_WARPS = 4;
// blocks a launch aims at: 8 on each of an H100's 132 SMs
constexpr int TARGET_BLOCKS = 132 * 8;
constexpr int FILL_BAND = 16;               // rows a fill block at most
constexpr int FILL_EDGES = 4;               // edges a fill thread loads at once
constexpr int FILL_TILE = 8192;             // columns a fill block at most
constexpr int DRAW_ITERS = 14;              // segment_t's 448 samples in iterations of 32
constexpr float RINT_MAGIC = 12582912.0f;   // 1.5 * 2^23: v + it rounds v to an integer
constexpr float EXACT_INTS = 16777216.0f;   // 2^24: every integer up to it is a float

// The first pixel px of a row with float(px) >= x (x >= 2^24), so that
// px < x, as the twin compares them (pixel indices as float32), holds for
// the pixels before it: the integers between the float below x and x round
// to the nearer of the two, a tie to the one of even mantissa.
__device__ __noinline__ int64_t first_not_below_wide(float x) {
  if (x >= 2147483648.0f) return int64_t{1} << 31;   // past every row
  const int64_t hi = static_cast<int64_t>(x);
  const int64_t lo = static_cast<int64_t>(nextafterf(x, 0.0f));
  const int64_t mid2 = lo + hi;
  const bool even = (__float_as_uint(x) & 1u) == 0;
  return mid2 / 2 + ((mid2 % 2 != 0 || !even) ? 1 : 0);
}

__global__ void __launch_bounds__(FILL_WARPS * WARP)
fill_polygon_kernel(const int2* __restrict__ pts, int k, int h, int w, int band,
                    unsigned char* __restrict__ mask) {
  // block (x, y, z): rows [row0, row0 + rows) of image y, columns
  // [col0, col0 + cols); each row's crossings as difference bits: bit q
  // toggles the pixels col0 + i, i < q, bit cols every pixel of the tile
  extern __shared__ unsigned diff[];
  const int img = blockIdx.y;
  const int row0 = static_cast<int>(blockIdx.x) * band;
  const int rows = min(band, h - row0);
  const int64_t col0 = static_cast<int64_t>(blockIdx.z) * FILL_TILE;
  const int cols = static_cast<int>(min(static_cast<int64_t>(FILL_TILE), w - col0));
  const int words = cols / 32 + 1;
  const int2* p = pts + static_cast<size_t>(img) * k;
  for (int i = threadIdx.x; i < rows * words; i += blockDim.x) diff[i] = 0;
  const float first = static_cast<float>(row0);
  const float last = static_cast<float>(row0 + rows);
  // edge pass: FILL_EDGES edges a thread at a time, all their points loading
  // at once; each crossing of a row of the band toggles one difference bit
  for (int e0 = 0; e0 < k; e0 += FILL_EDGES * blockDim.x) {
    int2 pa[FILL_EDGES], pb[FILL_EDGES];
#pragma unroll
    for (int u = 0; u < FILL_EDGES; ++u) {
      const int e = e0 + u * blockDim.x + threadIdx.x;
      if (e < k) {
        pa[u] = p[e];
        pb[u] = p[e + 1 == k ? 0 : e + 1];
      }
    }
    if (e0 == 0) __syncthreads();   // the bits are zero
#pragma unroll
    for (int u = 0; u < FILL_EDGES; ++u) {
      if (e0 + u * blockDim.x + threadIdx.x >= k) break;
      const float2 a = make_float2(__int2float_rn(pa[u].x), __int2float_rn(pa[u].y));
      const float2 b = make_float2(__int2float_rn(pb[u].x), __int2float_rn(pb[u].y));
      // the rows py where (y1 > py) != (y2 > py) are the integers in
      // [min(y1, y2), max(y1, y2)): the y's are integers, as floats
      const float ylo = fminf(a.y, b.y), yhi = fmaxf(a.y, b.y);
      if (!(yhi > first && ylo < last)) continue;
      const int r1 = static_cast<int>(fminf(yhi, last)) - row0;
      for (int r = static_cast<int>(fmaxf(ylo, first)) - row0; r < r1; ++r) {
        const float py = static_cast<float>(row0 + r);
        if ((a.y > py) == (b.y > py)) continue;
        const float denom = (b.y == a.y) ? 1.0f : __fsub_rn(b.y, a.y);
        const float prod = __fmul_rn(__fsub_rn(b.x, a.x), __fsub_rn(py, a.y));
        // 0 / denom + x1 is x1: the division (its slow path for a 0) is left out
        const float xi = prod == 0.0f ? a.x : __fadd_rn(__fdiv_rn(prod, denom), a.x);
        // the pixels px < xi: px < ceil(xi) where pixel indices are exact floats
        const float c = ceilf(xi);
        if (c <= 0.0f) continue;
        const int64_t q = (c < EXACT_INTS ? static_cast<int64_t>(static_cast<int>(c))
                                          : first_not_below_wide(xi)) - col0;
        if (q <= 0) continue;   // no pixel of the tile left of the crossing
        const int bit = q < cols ? static_cast<int>(q) : cols;
        atomicXor(&diff[r * words + bit / 32], 1u << (bit % 32));
      }
    }
  }
  __syncthreads();
  // pixel pass: a warp a row, a lane 8 consecutive pixels of each 256, from
  // the tile's end: a pixel is inside where the bits above it are odd
  const int lane = threadIdx.x % WARP;
  for (int r = threadIdx.x / WARP; r < rows; r += blockDim.x / WARP) {
    const unsigned* d = diff + r * words;
    unsigned carry = (d[cols / 32] >> (cols % 32)) & 1u;   // the bits right of this pass
    unsigned char* out = mask + (static_cast<size_t>(img) * h + row0 + r) * w + col0;
    for (int x0 = (cols - 1) / 256 * 256; x0 >= 0; x0 -= 256) {
      const int px = x0 + 8 * lane;
      unsigned b = 0;   // the bits of this lane's 8 pixels
      if (px < cols) {
        b = (d[px / 32] >> (px % 32)) & 0xffu;
        if (cols - px < 8) b &= (1u << (cols - px)) - 1u;
      }
      const unsigned own = __popc(b) & 1u;
      unsigned odd = own;   // then: of this lane's bits and those of the lanes after it
#pragma unroll
      for (int off = 1; off < WARP; off *= 2) {
        const unsigned o = __shfl_down_sync(FULL, odd, off);
        if (lane + off < WARP) odd ^= o;
      }
      unsigned s = b;   // bit i: the parity of bits i..7
      s ^= s >> 1;
      s ^= s >> 2;
      s ^= s >> 4;
      const unsigned inside = ((s >> 1) ^ ((odd ^ own ^ carry) ? 0xffu : 0u)) & 0xffu;
      if (w % 8 == 0 && px < cols) {   // rows and tiles start 8-byte aligned
        const unsigned lo = ((inside & 0xfu) * 0x00204081u) & 0x01010101u;
        const unsigned hi = ((inside >> 4) * 0x00204081u) & 0x01010101u;
        *reinterpret_cast<unsigned long long*>(out + px) =
            lo | (static_cast<unsigned long long>(hi) << 32);
      } else {
        for (int i = 0; i < 8 && px + i < cols; ++i)
          out[px + i] = static_cast<unsigned char>((inside >> i) & 1u);
      }
      carry ^= __shfl_sync(FULL, odd, 0);
    }
  }
}

// The pixel of the sample at t of segment (sx, sy) -> (ex, ey), rounded as
// the twin rounds it (fma(s, 1 - t, e * t), then rint),
// clipped to the canvas, as a key that is equal for equal pixels: its index
// y * w + x, a float in the SMALL form (h * w < 2^24 and h, w <= 2^22:
// clipping before rint gives the same pixel, rint of a value in [0, 2^22] is
// exact by RINT_MAGIC, and the index is an exact float), else an int64.
template <bool SMALL>
struct Key {
  using type = typename std::conditional<SMALL, float, int64_t>::type;
  static constexpr type NONE = -1;

  __device__ __forceinline__ static type at(float sx, float sy, float ex, float ey, float t,
                                            int h, int w) {
    const float omt = __fsub_rn(1.0f, t);
    const float vx = __fmaf_rn(sx, omt, __fmul_rn(ex, t));
    const float vy = __fmaf_rn(sy, omt, __fmul_rn(ey, t));
    if constexpr (SMALL) {
      const float x = __fsub_rn(__fadd_rn(fminf(fmaxf(vx, 0.0f), w - 1.0f), RINT_MAGIC),
                                RINT_MAGIC);
      const float y = __fsub_rn(__fadd_rn(fminf(fmaxf(vy, 0.0f), h - 1.0f), RINT_MAGIC),
                                RINT_MAGIC);
      return __fadd_rn(__fmul_rn(y, static_cast<float>(w)), x);
    } else {
      const int x = min(max(__float2int_rn(vx), 0), w - 1);
      const int y = min(max(__float2int_rn(vy), 0), h - 1);
      return static_cast<int64_t>(y) * w + x;
    }
  }
};

// The run test of one iteration: the lane's key against the sample before
// it, lane l - 1's, for lane 0 `prev` of lane 31 (the iteration before),
// passed in one __shfl_sync; a 1 stored where they differ.
template <class KeyT>
__device__ __forceinline__ void store_run(KeyT key, KeyT prev, bool valid, int lane,
                                          unsigned char* __restrict__ out) {
  const KeyT before = __shfl_sync(FULL, lane == WARP - 1 ? prev : key, (lane + WARP - 1) % WARP);
  if (valid && key != before) out[static_cast<int64_t>(key)] = 1;
}

// Block (x, y, z) draws piece z (`chunk` iterations of 32 consecutive
// samples, lane l sample 32 * it + l) of the segments of slice y (`slice`
// segments) of image x, a warp a segment at a time; the next segment's
// endpoints load while one is drawn.  ITERS > 0: whole segments of ITERS
// iterations, t of the lane's samples held in registers and all ITERS keys
// computed before their run tests (ILP); else pieces of any length.
template <bool SMALL, int ITERS>
__global__ void __launch_bounds__(DRAW_WARPS * WARP, ITERS > 0 ? 4 : 8)
draw_segments_kernel(const int2* __restrict__ starts, const int2* __restrict__ ends, int k,
                     int slice, int chunk, const float* __restrict__ t, int samples,
                     int h, int w, unsigned char* __restrict__ mask) {
  using K = Key<SMALL>;
  using KeyT = typename K::type;
  const int64_t img = blockIdx.x;
  const int s0 = static_cast<int>(blockIdx.y) * slice;
  const int s1 = min(k, s0 + slice);
  const int lane = threadIdx.x % WARP;
  const int iters = (samples + WARP - 1) / WARP;
  const int it0 = static_cast<int>(blockIdx.z) * chunk;
  const int it1 = min(iters, it0 + chunk);
  unsigned char* out = mask + img * (static_cast<int64_t>(h) * w);
  // t of this lane's samples: all of them, or the piece's first
  float tr[ITERS > 0 ? ITERS : 1];
  if constexpr (ITERS > 0) {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) tr[i] = __ldg(t + min(i * WARP + lane, samples - 1));
  } else {
    tr[0] = __ldg(t + min(it0 * WARP + lane, samples - 1));
  }
  const int2* sp = starts + static_cast<size_t>(img) * k;
  const int2* ep = ends + static_cast<size_t>(img) * k;
  int seg = s0 + static_cast<int>(threadIdx.x) / WARP;
  int2 a = make_int2(0, 0), b = make_int2(0, 0);
  if (seg < s1) {
    a = sp[seg];
    b = ep[seg];
  }
  for (; seg < s1; seg += DRAW_WARPS) {
    int2 na = a, nb = b;
    if (seg + DRAW_WARPS < s1) {
      na = sp[seg + DRAW_WARPS];
      nb = ep[seg + DRAW_WARPS];
    }
    const float sx = __int2float_rn(a.x), sy = __int2float_rn(a.y);
    const float ex = __int2float_rn(b.x), ey = __int2float_rn(b.y);
    if constexpr (ITERS > 0) {
      KeyT key[ITERS];
#pragma unroll
      for (int i = 0; i < ITERS; ++i) key[i] = K::at(sx, sy, ex, ey, tr[i], h, w);
#pragma unroll
      for (int i = 0; i < ITERS; ++i)
        store_run(key[i], i > 0 ? key[i - 1] : K::NONE, i * WARP + lane < samples, lane, out);
    } else {
      KeyT prev = K::NONE;   // a piece stores its first pixel
      for (int it = it0; it < it1; ++it) {
        const float tt = it == it0 ? tr[0] : __ldg(t + min(it * WARP + lane, samples - 1));
        const KeyT key = K::at(sx, sy, ex, ey, tt, h, w);
        store_run(key, prev, it * WARP + lane < samples, lane, out);
        prev = key;
      }
    }
    a = na;
    b = nb;
  }
}

template <bool SMALL>
void launch_draw(dim3 grid, cudaStream_t stream, const int2* s, const int2* e, int k, int slice,
                 int chunk, const float* t, int samples, int h, int w, unsigned char* mask) {
  if (grid.z == 1 && (samples + WARP - 1) / WARP == DRAW_ITERS) {
    draw_segments_kernel<SMALL, DRAW_ITERS><<<grid, DRAW_WARPS * WARP, 0, stream>>>(
        s, e, k, slice, chunk, t, samples, h, w, mask);
  } else {
    draw_segments_kernel<SMALL, 0><<<grid, DRAW_WARPS * WARP, 0, stream>>>(
        s, e, k, slice, chunk, t, samples, h, w, mask);
  }
}

}  // namespace

extern "C" {

// points (n, k, 2) int32 (x, y), contiguous -> mask (n, h, w) uint8, every
// pixel written (1 inside the polygon, else 0); n <= 65535.  Returns the
// CUDA error.
int fill_polygon_launch(const int* points, int n, int k, int h, int w,
                        unsigned char* mask, cudaStream_t stream) {
  // rows a block: enough for about TARGET_BLOCKS blocks, at most FILL_BAND
  const int64_t rows = static_cast<int64_t>(n) * h;
  const int band = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(
      FILL_BAND, (rows + TARGET_BLOCKS - 1) / TARGET_BLOCKS)));
  // the band's difference bits: at most FILL_BAND x 257 words, 16 KB
  const size_t smem = band * (std::min(FILL_TILE, w) / 32 + 1) * sizeof(unsigned);
  const dim3 grid((h + band - 1) / band, n, static_cast<unsigned>((w + FILL_TILE - 1) / FILL_TILE));
  fill_polygon_kernel<<<grid, FILL_WARPS * WARP, smem, stream>>>(
      reinterpret_cast<const int2*>(points), k, h, w, band, mask);
  return static_cast<int>(cudaGetLastError());
}

// starts, ends (n, k, 2) int32, contiguous; t (samples,) float32 -> a 1
// stored into mask (n, h, w) at every sample's pixel; n * k > 0, samples >
// 0.  Returns the CUDA error.
int draw_segments_launch(const int* starts, const int* ends, int n, int k, const float* t,
                         int samples, int h, int w, unsigned char* mask,
                         cudaStream_t stream) {
  const int64_t segments = static_cast<int64_t>(n) * k;
  // a warp a segment; the segment's samples in pieces, grid.z of them, where
  // that leaves the card short of TARGET_BLOCKS blocks of DRAW_WARPS warps
  const int iters = (samples + WARP - 1) / WARP;
  const int pieces = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(
      std::min(iters, 65535), int64_t{TARGET_BLOCKS} * DRAW_WARPS / segments)));
  const int blocks_per_img = std::min((k + DRAW_WARPS - 1) / DRAW_WARPS,
                                      std::max(1, TARGET_BLOCKS / (n * pieces)));
  const int slice = (k + blocks_per_img - 1) / blocks_per_img;
  const int chunk = (iters + pieces - 1) / pieces;
  const dim3 grid(static_cast<unsigned>(n), (k + slice - 1) / slice, (iters + chunk - 1) / chunk);
  const auto* s = reinterpret_cast<const int2*>(starts);
  const auto* e = reinterpret_cast<const int2*>(ends);
  if (static_cast<int64_t>(h) * w < (int64_t{1} << 24) && h <= (1 << 22) && w <= (1 << 22)) {
    launch_draw<true>(grid, stream, s, e, k, slice, chunk, t, samples, h, w, mask);
  } else {
    launch_draw<false>(grid, stream, s, e, k, slice, chunk, t, samples, h, w, mask);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
