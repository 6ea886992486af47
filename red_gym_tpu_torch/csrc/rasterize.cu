// Lidar-bitmap rasterizer for Hopper (sm_90a): the polygon fill and the
// line-segment draw of lidar_to_bitmap.
//
// Replaces no Pallas kernel: the JAX package rasterizes with one broadcast
// that XLA fuses, red_gym_tpu/ops/rasterize.py:43-82 (_fill_polygon: a
// crossing-number test of every pixel against every polygon edge, an
// (H, W, K) = 256 x 256 x 600 array an image; _draw_segments: 448 samples a
// segment scattered into the mask).  The plain PyTorch versions this kernel
// is held against (torch.equal on the card) are in
// red_gym_tpu_torch/ops/raster_kernels.py (fill_polygon_reference,
// draw_segments_reference).
//
// fill_polygon_kernel: one block a (pixel row, image).  The crossing test of
// pixel (px, py) against edge (x1, y1) -> (x2, y2) is
//     cond = (y1 > py) != (y2 > py),  x_int = (x2 - x1) * (py - y1) / denom + x1,
//     crossing = cond & (px < x_int)
// and the pixel is inside where the count of crossings is odd.  cond and
// x_int do not depend on px, so the block computes them once a row, K
// divisions instead of K x W, and keeps only the x_int of edges whose cond
// holds (a handful a row: the polygon's boundary crosses a row a few times)
// in shared memory, appended through a shared counter.  Leaving out the
// edges whose cond is false is exact, since their crossing is false at
// every px, and the order of the list does not change the count.  Then each
// thread counts px < x_int over the list for its pixels; every lane of a
// warp reads the same shared word.
//
// draw_segments_kernel: one thread a (segment, sample).  The sample point is
// s * (1 - t) + e * t with the 448-entry t table of the caller, rounded as
// XLA's CPU code rounds it, fma(s, 1 - t, e * t) (one rounding of the first
// product and the sum), then rint (half to even), clip to the canvas and a
// byte store of 1 into the mask.  Stores that land on one pixel write the
// same value, so their order does not matter.
//
// Rounding.  Built with -fmad=false (ops/_build.py), and the arithmetic is
// written with the _rn intrinsics: every operation rounds on its own, with
// IEEE division, as the one-kernel-per-operator PyTorch twins round it; the
// one fused multiply-add is explicit.  So kernel and twin agree bit for bit.
//
// What bounds it on the H100.  At 64 images x 256 x 256 pixels and K = 600
// edges the fill reads 0.3 MB of points and writes 4.2 MB of mask (1.3 us
// at the memory rate); its operations, counted on 64 polygons of the exact
// scan on track_0019 (28,560 crossing (row, edge) pairs, under 2 a row), are
// 3 a (row, edge), 7 a crossing edge and 2 a (pixel, crossing edge), about
// 44 M or 0.7 us at the float32 rate: bytes bound it.  The segment draw
// makes 17.2 M samples of about 15 operations (3.9 us).  Both take far
// longer than that (0.027 and 0.079 ms on an H100 80GB HBM3 at 700 W,
// PERF.md): the fill's 16,384 blocks each pass a barrier between a short
// edge pass and a short pixel pass, and the draw issues 17.2 M scattered
// byte stores, most onto pixels set already.  Both are a few of a planning
// step's 2,270 device operations, so the simple form stays for now.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int FILL_THREADS = 256;
constexpr int DRAW_THREADS = 256;

__global__ void __launch_bounds__(FILL_THREADS)
fill_polygon_kernel(const int* __restrict__ pts, int k, int h, int w,
                    unsigned char* __restrict__ mask) {
  extern __shared__ float x_cross[];
  __shared__ int n_cross;
  const int row = blockIdx.x;
  const int img = blockIdx.y;
  const int* p = pts + static_cast<size_t>(img) * k * 2;
  if (threadIdx.x == 0) n_cross = 0;
  __syncthreads();
  const float py = static_cast<float>(row);
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const int e2 = (e + 1 == k) ? 0 : e + 1;
    const float x1 = __int2float_rn(p[2 * e]);
    const float y1 = __int2float_rn(p[2 * e + 1]);
    const float x2 = __int2float_rn(p[2 * e2]);
    const float y2 = __int2float_rn(p[2 * e2 + 1]);
    if ((y1 > py) != (y2 > py)) {
      const float denom = (y2 == y1) ? 1.0f : __fsub_rn(y2, y1);
      const float prod = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(py, y1));
      const float xi = __fadd_rn(__fdiv_rn(prod, denom), x1);
      x_cross[atomicAdd(&n_cross, 1)] = xi;
    }
  }
  __syncthreads();
  const int n = n_cross;
  unsigned char* out = mask + (static_cast<size_t>(img) * h + row) * w;
  for (int px = threadIdx.x; px < w; px += blockDim.x) {
    const float fx = static_cast<float>(px);
    int c = 0;
    for (int j = 0; j < n; ++j) c += fx < x_cross[j];
    out[px] = static_cast<unsigned char>(c & 1);
  }
}

__global__ void __launch_bounds__(DRAW_THREADS)
draw_segments_kernel(const int* __restrict__ starts, const int* __restrict__ ends,
                     int64_t total, int samples, int seg_per_img,
                     const float* __restrict__ t, int h, int w,
                     unsigned char* __restrict__ mask) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t seg = i / samples;
  const int j = static_cast<int>(i - seg * samples);
  const int64_t img = seg / seg_per_img;
  const float tt = t[j];
  const float omt = __fsub_rn(1.0f, tt);
  int pix[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float s = __int2float_rn(starts[2 * seg + c]);
    const float e = __int2float_rn(ends[2 * seg + c]);
    pix[c] = __float2int_rn(__fmaf_rn(s, omt, __fmul_rn(e, tt)));
  }
  const int x = min(max(pix[0], 0), w - 1);
  const int y = min(max(pix[1], 0), h - 1);
  mask[(img * h + y) * w + x] = 1;
}

}  // namespace

extern "C" {

// points (n, k, 2) int32 (x, y), contiguous -> mask (n, h, w) uint8, every
// pixel written (1 inside the polygon, else 0).  Returns the CUDA error.
int fill_polygon_launch(const int* points, int n, int k, int h, int w,
                        unsigned char* mask, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * sizeof(float);
  fill_polygon_kernel<<<dim3(h, n), FILL_THREADS, smem, stream>>>(points, k, h, w, mask);
  return static_cast<int>(cudaGetLastError());
}

// starts, ends (m, 2) int32, contiguous, segment i of image i / seg_per_img;
// t (samples,) float32 -> a 1 stored into mask (n, h, w) at every sample's
// pixel.  Returns the CUDA error.
int draw_segments_launch(const int* starts, const int* ends, int64_t m, int seg_per_img,
                         const float* t, int samples, int h, int w, unsigned char* mask,
                         cudaStream_t stream) {
  const int64_t total = m * samples;
  const int64_t blocks = (total + DRAW_THREADS - 1) / DRAW_THREADS;
  draw_segments_kernel<<<static_cast<unsigned>(blocks), DRAW_THREADS, 0, stream>>>(
      starts, ends, total, samples, seg_per_img, t, h, w, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
