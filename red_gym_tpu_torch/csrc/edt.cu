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
// edt_row_kernel: a warp a row, no shared memory and no block barrier.
// min over the row's zeros of (x - y)^2 is the smaller of (x - L)^2 and
// (R - x)^2, with L the last zero at or before x and R the first at or
// after it.  The warp takes the row in chunks of 32 words of 32 pixels:
// pass j loads the 32 bytes of word j (one sector, bytes only, so a row of
// any width and alignment is read as it lies) and __ballot_sync makes the
// word, which lane j keeps.  Each lane's last and first zero come from
// __clz / __ffs of its word; a warp max scan (__shfl_up_sync) and min scan
// (__shfl_down_sync) give every word the nearest zero in the words before
// and after it, and a carry from the chunks before and a look-ahead to the
// first zero after the chunk (each chunk read at most twice) close the
// row.  Then word j's pixels, base + 32 j + lane, are written in one
// coalesced store: lane b finds L and R inside the word by __clz / __ffs
// of the word masked to bits <= b and >= b.  D1 is written once.
//
// edt_col_kernel: the 32 lanes of a warp are 32 adjacent columns, so every
// read of a D1 row is one 128-byte line, and each lane owns COL_R = 16
// consecutive output rows r0 .. r0 + 15 of its column (a block is 32
// columns x COL_WARPS such tiles).  It starts from the tile's own rows
// (every pair), then, a step of COL_STEP = 8 offsets at a time, folds in
// the rows k .. k + 7 above the tile and below it, each into all 16 rows,
// with the same __fadd_rn(v, d^2) and fminf as a brute-force pass; a side
// with no row left is not folded, and a row past an end of the column
// reads 3.4e38, whose sums round back to it.  An unread row lies k or more
// rows from every row of the tile and every D1 is >= 0, so its candidates
// are all >= k^2: before a step from offset k, a lane is done once k^2 >=
// its largest best, and the warp goes on while __any_sync finds a lane not
// done (and some row is left).  Every skipped candidate is >= the best it
// could have replaced, so the minimum equals the brute-force one bit for
// bit; no lane reads more than its own column, and a column whose D1 is all
// 3.4e38 (an all-free grid) is read whole, as JAX does, and keeps the
// sentinel.  The squares are float products of exact integers, as JAX's
// (r - r')^2, not int-to-float conversions (a brute-force pass spends one
// a pair on them).  A step shares its vote among 256 pairs a lane, each
// load among 16 and each square among up to 16: fewer rows a lane or
// offsets a step made the long searches slower than the brute-force pass
// on the H100, more made the maps slower.
//
// Reads.  D1 (3.2 MB on track_0019) stays in L2; the column pass reads it
// through the read-only path (__ldg), not staged in shared memory: a tile's
// window is known only as its search ends, most searches on a map end
// within a few steps, and a step's 16 loads are independent and issued
// before its folds.  Loading each step's rows one step ahead gained nothing
// on the card.
//
// Exactness.  Every squared distance of a map up to 2896 px a side is an
// integer below 2^24, so each float32 sum and minimum is exact and any order
// of the minimum gives the same float32; __fsqrt_rn and __fmul_rn round
// once, correctly.  Built with -fmad=false (ops/_build.py).  So the kernel
// is bit-equal to its twin and to JAX.
//
// What bounds the function on the H100: its bytes (the uint8 zero mask read
// once and the output written once, 5 a pixel), since an exact EDT needs
// only a few operations a pixel (a row pass and a lower envelope of
// parabolas a column).  D1's write and read (8 bytes a pixel) are this
// two-pass design's own traffic, beyond that bound.  A brute-force column pass does 2 H^2 W adds and
// mins (1.41 G on track_0019, H 875 x W 920); this one does 2 adds and mins
// a (row read, tile row) pair, and reads a tile's column until its search
// stops, a few steps on a map and up to the whole column on a grid with
// few walls.

#include <cuda_runtime.h>

#include <climits>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_WARPS = 4;        // rows a row-pass block, a warp each
constexpr int CHUNK = 32 * 32;      // pixels a warp takes at once: 32 words of 32
constexpr int COL_R = 16;           // output rows a column-pass lane
constexpr int COL_STEP = 8;         // offsets a column-pass lane folds in between two votes
constexpr int COL_WARPS = 4;        // row tiles (warps) a column-pass block
constexpr float BIG = 3.4e38f;

// This lane's word of the chunk at `base`: bit b of lane l's word is 1 where
// pixel base + 32 l + b is a zero pixel.  Pass j reads bytes base + 32 j +
// lane; its ballot is lane j's word.
__device__ __forceinline__ uint32_t chunk_word(const uint8_t* __restrict__ row, int w,
                                               int base, int lane) {
    uint8_t z[32];  // every load issued before the first ballot
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const int x = base + 32 * j + lane;
        z[j] = x < w ? row[x] : 0;
    }
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const uint32_t word = __ballot_sync(FULL, z[j] != 0);
        if (lane == j) mine = word;
    }
    return mine;
}

__global__ void __launch_bounds__(32 * ROW_WARPS)
edt_row_kernel(const uint8_t* __restrict__ zero, int h, int w, float* __restrict__ d1) {
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (r >= h) return;  // the warp agrees
    const uint8_t* row = zero + (size_t)r * w;
    float* out = d1 + (size_t)r * w;
    int left = -1;   // the last zero before the chunk (-1: none)
    int ahead = -1;  // the first zero at or after the chunk's end (INT_MAX: none; -1: not sought)
    for (int base = 0; base < w; base += CHUNK) {
        const int end = base + CHUNK;
        if (ahead < end) {
            ahead = INT_MAX;
            for (int b = end; b < w && ahead == INT_MAX; b += CHUNK) {
                const uint32_t m = chunk_word(row, w, b, lane);
                ahead = __reduce_min_sync(FULL, m ? b + 32 * lane + __ffs(m) - 1 : INT_MAX);
            }
        }
        const uint32_t m = chunk_word(row, w, base, lane);
        const int p0 = base + 32 * lane;
        int lo = m ? p0 + 31 - __clz(m) : -1;       // -> the last zero of words <= lane
        int hi = m ? p0 + __ffs(m) - 1 : INT_MAX;   // -> the first zero of words >= lane
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int a = __shfl_up_sync(FULL, lo, off);
            const int b = __shfl_down_sync(FULL, hi, off);
            if (lane >= off) lo = max(lo, a);
            if (lane + off < 32) hi = min(hi, b);
        }
        int before = __shfl_up_sync(FULL, lo, 1);   // the last zero before this word
        int after = __shfl_down_sync(FULL, hi, 1);  // the first zero after it
        before = lane == 0 ? left : max(left, before);
        after = lane == 31 ? ahead : min(ahead, after);
        left = max(left, __shfl_sync(FULL, lo, 31));
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            if (base + 32 * j >= w) break;  // the warp agrees
            const uint32_t mj = __shfl_sync(FULL, m, j);
            const int bj = __shfl_sync(FULL, before, j);
            const int aj = __shfl_sync(FULL, after, j);
            const int p = base + 32 * j;
            const int x = p + lane;
            const uint32_t below = mj & (FULL >> (31 - lane));  // bits 0 .. lane
            const uint32_t above = mj & (FULL << lane);         // bits lane .. 31
            const int lz = below ? p + 31 - __clz(below) : bj;
            const int rz = above ? p + __ffs(above) - 1 : aj;
            float best = BIG;
            if (lz >= 0) {
                const float d = (float)(x - lz);
                best = __fmul_rn(d, d);
            }
            if (rz != INT_MAX) {
                const float d = (float)(rz - x);
                best = fminf(best, __fmul_rn(d, d));
            }
            if (x < w) out[x] = best;
        }
    }
}

__global__ void __launch_bounds__(32 * COL_WARPS)
edt_col_kernel(const float* __restrict__ d1, int h, int w, float res, float* __restrict__ out) {
    const int lane = threadIdx.x;
    const int c = blockIdx.x * 32 + lane;
    const int r0 = (blockIdx.y * COL_WARPS + threadIdx.y) * COL_R;
    if (r0 >= h) return;                       // the warp agrees
    const int n = min(COL_R, h - r0);          // the tile's rows in the grid
    const float* col = d1 + min(c, w - 1);     // lanes past the last column repeat it
    // rows past the grid's end hold 0, so they never keep the search going
    float best[COL_R];
#pragma unroll
    for (int i = 0; i < COL_R; ++i) best[i] = i < n ? BIG : 0.0f;
#pragma unroll
    for (int j = 0; j < COL_R; ++j) {
        if (j < n) {
            const float v = __ldg(col + (size_t)(r0 + j) * w);
#pragma unroll
            for (int i = 0; i < COL_R; ++i)
                best[i] = fminf(best[i], __fadd_rn(v, (float)((i - j) * (i - j))));
        }
    }
    float worst = best[0];
#pragma unroll
    for (int i = 1; i < COL_R; ++i) worst = fmaxf(worst, best[i]);
    // rows r0 - k and r0 + COL_R - 1 + k at the top of step k, or the
    // column's first row where that side has none; moved only while the
    // side has rows left, so they never leave the column
    const float* up_row = col + (size_t)(r0 - 1) * w * (r0 > 0);
    const float* dn_row = col + (size_t)(r0 + COL_R) * w * (r0 + COL_R < h);
    float kf = 1.0f;  // k
    for (int k = 1;; k += COL_STEP, kf = __fadd_rn(kf, (float)COL_STEP)) {
        const bool up_on = k <= r0, dn_on = r0 + COL_R - 1 + k < h;  // the warp agrees
        if (!up_on && !dn_on) break;
        // every row not read yet is k or more rows from each row of the tile
        if (!__any_sync(FULL, __fmul_rn(kf, kf) < worst)) break;
        // rows k .. k + COL_STEP - 1 above and below; a row past an end reads
        // 3.4e38, whose sums round back to it and change no minimum
        float u[COL_STEP], v[COL_STEP];
#pragma unroll
        for (int s = 0; s < COL_STEP; ++s) {
            u[s] = k + s <= r0 ? __ldg(up_row - s * w) : BIG;
            v[s] = r0 + COL_R - 1 + k + s < h ? __ldg(dn_row + s * w) : BIG;
        }
        float sq[COL_STEP + COL_R - 1];  // (k + d)^2
#pragma unroll
        for (int d = 0; d < COL_STEP + COL_R - 1; ++d) {
            const float x = __fadd_rn(kf, (float)d);
            sq[d] = __fmul_rn(x, x);
        }
        if (up_on) {
            up_row -= COL_STEP * w * (k + COL_STEP <= r0);
#pragma unroll
            for (int s = 0; s < COL_STEP; ++s)
#pragma unroll
                for (int i = 0; i < COL_R; ++i)
                    best[i] = fminf(best[i], __fadd_rn(u[s], sq[s + i]));
        }
        if (dn_on) {
            dn_row += COL_STEP * w * (r0 + COL_R - 1 + k + COL_STEP < h);
#pragma unroll
            for (int s = 0; s < COL_STEP; ++s)
#pragma unroll
                for (int i = 0; i < COL_R; ++i)
                    best[i] = fminf(best[i], __fadd_rn(v[s], sq[s + COL_R - 1 - i]));
        }
        worst = best[0];
#pragma unroll
        for (int i = 1; i < COL_R; ++i) worst = fmaxf(worst, best[i]);
    }
    if (c >= w) return;
#pragma unroll
    for (int i = 0; i < COL_R; ++i)
        if (i < n) out[(size_t)(r0 + i) * w + c] = __fmul_rn(__fsqrt_rn(best[i]), res);
}

}  // namespace

extern "C" int edt_launch(const uint8_t* zero, int h, int w, float res, float* d1,
                          float* out, cudaStream_t stream) {
    if (h <= 0 || w <= 0) return 0;
    edt_row_kernel<<<(h + ROW_WARPS - 1) / ROW_WARPS, 32 * ROW_WARPS, 0, stream>>>(zero, h, w,
                                                                                  d1);
    const int tile = COL_R * COL_WARPS;
    edt_col_kernel<<<dim3((w + 31) / 32, (h + tile - 1) / tile), dim3(32, COL_WARPS), 0,
                     stream>>>(d1, h, w, res, out);
    return (int)cudaGetLastError();
}
