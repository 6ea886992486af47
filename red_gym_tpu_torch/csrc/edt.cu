// Exact Euclidean distance transform for Hopper (sm_90a): kernel E.
//
// Replaces no Pallas kernel: the JAX package computes its device EDT with
// two dense min-plus passes that XLA fuses, red_gym_tpu/ops/edt.py:34-61
// (edt, chunked by _chunked :64-75).  The plain PyTorch version this kernel
// is held against (torch.equal on the card) is
// red_gym_tpu_torch/ops/edt_kernels.py (edt_reference, JAX's chunked form).
//
// The work.  With zero[r, y] the occupied ("zero") pixels of an (H, W) grid,
//     D1[r, x] = min over zero[r, y] of (x - y)^2             (row pass)
//     D2[r, c] = min over r' of D1[r', c] + (r - r')^2         (column pass)
//     out      = sqrt(D2) * resolution
// A row with no zero pixel has D1 = 3.4e38 (JAX's sentinel), and 3.4e38 +
// (r - r')^2 rounds back to it, so an all-free grid reads
// sqrt(3.4e38) * resolution, as in JAX.
//
// edt_row_kernel: one block a row.  min over the row's zeros of (x - y)^2 is
// the smaller of (x - L)^2 and (R - x)^2, with L the last zero at or before
// x and R the first at or after it, so the row pass needs no W x W
// product: each thread takes a run of consecutive pixels, finds the last and
// the first zero of its run, a block scan (max from the left, min from the
// right, over the threads' runs in shared memory) gives every run the
// nearest zero outside it, and a second pass over the run writes D1.
//
// edt_col_kernel: one thread an output pixel, brute force over the column:
// a block of 32 columns x 8 row lanes owns a 64 x 32 output tile (8 rows a
// thread), stages D1 in 64-row slabs of the tile's columns in shared
// memory, and keeps the running minimum of D1[r', c] + (r - r')^2 for its
// rows.  It writes sqrt(D2) * resolution (one rounding each).
//
// Exactness.  Every squared distance of a map up to 2896 px a side is an
// integer below 2^24, so each float32 sum and minimum is exact and any order
// of the minimum gives the same float32; __fsqrt_rn and __fmul_rn round
// once, correctly.  Built with -fmad=false (ops/_build.py).  So the kernel
// is bit-equal to its twin and to JAX.
//
// What bounds the function on the H100: its bytes (the occupancy read once,
// D1 written and read once and the output written once), since an exact EDT
// needs only a few operations a pixel (a row pass and a lower envelope of
// parabolas a column).  This kernel's brute-force column pass does 2 H^2 W
// operations instead (an add and a min a (pixel, row) pair; 1.48 G for
// track_0019's 920 x 875): its known gap to that bound.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int ROW_THREADS = 256;
constexpr int COL_X = 32;      // columns of a column-pass tile
constexpr int COL_Y = 8;       // row lanes of a column-pass block
constexpr int COL_RPT = 8;     // output rows a thread
constexpr int COL_TILE_R = COL_Y * COL_RPT;  // output rows a block
constexpr int SLAB = 64;       // D1 rows staged a step
constexpr float BIG = 3.4e38f;

__global__ void edt_row_kernel(const uint8_t* __restrict__ zero, int h, int w,
                               float* __restrict__ d1) {
    __shared__ int s_left[ROW_THREADS];
    __shared__ int s_right[ROW_THREADS];
    const int r = blockIdx.x;
    const int t = threadIdx.x;
    const uint8_t* row = zero + (size_t)r * w;
    const int run = (w + ROW_THREADS - 1) / ROW_THREADS;
    const int x0 = min(w, t * run);
    const int x1 = min(w, x0 + run);
    int last = -1, first = INT32_MAX;
    for (int x = x0; x < x1; ++x) {
        if (row[x]) {
            last = x;
            if (first == INT32_MAX) first = x;
        }
    }
    s_left[t] = last;
    s_right[t] = first;
    __syncthreads();
    // inclusive scans over the threads' runs: max from the left, min from
    // the right (Hillis-Steele, log2(256) steps)
    for (int off = 1; off < ROW_THREADS; off <<= 1) {
        int l = (t >= off) ? s_left[t - off] : -1;
        int rr = (t + off < ROW_THREADS) ? s_right[t + off] : INT32_MAX;
        __syncthreads();
        s_left[t] = max(s_left[t], l);
        s_right[t] = min(s_right[t], rr);
        __syncthreads();
    }
    int left = (t > 0) ? s_left[t - 1] : -1;                     // before the run
    int right = (t + 1 < ROW_THREADS) ? s_right[t + 1] : INT32_MAX;  // after it
    // the run's own zeros, from the right, give each pixel its R
    float* out = d1 + (size_t)r * w;
    // first pass from the right: R of each pixel, stored as a float in d1
    int nxt = right;
    for (int x = x1 - 1; x >= x0; --x) {
        if (row[x]) nxt = x;
        out[x] = (nxt == INT32_MAX) ? -1.0f : (float)(nxt - x);
    }
    int prv = left;
    for (int x = x0; x < x1; ++x) {
        if (row[x]) prv = x;
        float best = BIG;
        if (prv >= 0) {
            float d = (float)(x - prv);
            best = __fmul_rn(d, d);
        }
        float dr = out[x];
        if (dr >= 0.0f) best = fminf(best, __fmul_rn(dr, dr));
        out[x] = best;
    }
}

__global__ void edt_col_kernel(const float* __restrict__ d1, int h, int w, float res,
                               float* __restrict__ out) {
    __shared__ float slab[SLAB][COL_X];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int c = blockIdx.x * COL_X + tx;
    const int r_base = blockIdx.y * COL_TILE_R + ty;
    float best[COL_RPT];
#pragma unroll
    for (int i = 0; i < COL_RPT; ++i) best[i] = BIG;
    for (int s0 = 0; s0 < h; s0 += SLAB) {
        for (int k = ty; k < SLAB; k += COL_Y) {
            int rp = s0 + k;
            slab[k][tx] = (rp < h && c < w) ? d1[(size_t)rp * w + c] : BIG;
        }
        __syncthreads();
        const int n = min(SLAB, h - s0);
        for (int k = 0; k < n; ++k) {
            float v = slab[k][tx];
            int rp = s0 + k;
#pragma unroll
            for (int i = 0; i < COL_RPT; ++i) {
                int d = r_base + i * COL_Y - rp;
                float cand = __fadd_rn(v, (float)(d * d));
                best[i] = fminf(best[i], cand);
            }
        }
        __syncthreads();
    }
    if (c >= w) return;
#pragma unroll
    for (int i = 0; i < COL_RPT; ++i) {
        int r = r_base + i * COL_Y;
        if (r < h) out[(size_t)r * w + c] = __fmul_rn(__fsqrt_rn(best[i]), res);
    }
}

}  // namespace

extern "C" int edt_launch(const uint8_t* zero, int h, int w, float res, float* d1,
                          float* out, cudaStream_t stream) {
    if (h <= 0 || w <= 0) return 0;
    edt_row_kernel<<<h, ROW_THREADS, 0, stream>>>(zero, h, w, d1);
    dim3 block(COL_X, COL_Y);
    dim3 grid((w + COL_X - 1) / COL_X, (h + COL_TILE_R - 1) / COL_TILE_R);
    edt_col_kernel<<<grid, block, 0, stream>>>(d1, h, w, res, out);
    return (int)cudaGetLastError();
}
