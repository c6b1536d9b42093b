// Host driver of the peak-candidates kernels' arithmetic and schedule, for
// the CPU tests (tests/test_torch_peaks_cuh.py builds it with g++,
// -ffp-contract=off).
//
// It runs the control flow of c3poa_tpu_torch/kernels/csrc/peaks.cu
// serially over the functions of peaks.cuh: per read, the statistics
// kernel's radix-select passes (a histogram of the group's digits a pass,
// warp 0's pick over its lanes' 8 bins each, the second rank from the
// last histogram or a pass for the least key above the first) and its
// scalars; then per chunk of `chunk` columns (the kernel's 2048, or any
// multiple of the tile and of 8), the candidates kernel's block: the
// dead-chunk exit, the staged columns, the carry (the staged column
// before the chunk, else the walk left), the threads' columns from the
// latest start before each thread (their running max across the chunk),
// and, for a tile wider than 8 columns, the shuffle butterfly over its
// tile / 8 threads.
#include <stdint.h>

#include <algorithm>
#include <vector>

#include "peaks.cuh"

namespace {

// warp 0's pick after a pass, lane by lane: each of 32 lanes takes 8 bins
// and the count below them; the number of lanes that found rank k
int pick_lanes(const uint32_t* hist, uint32_t k, int* d, uint32_t* below) {
    int found = 0;
    uint32_t prefix = 0;
    for (int lane = 0; lane < 32; ++lane) {
        int dl;
        uint32_t bl;
        if (pk_pick(hist + 8 * lane, 8, prefix, k, &dl, &bl)) {
            *d = 8 * lane + dl;
            *below = bl;
            ++found;
        }
        for (int i = 0; i < 8; ++i)
            prefix += hist[8 * lane + i];
    }
    return found;
}

// false when some pick was found by more than one lane, or rank k by none
bool stats_host(const float* row, int n, int L, float* med, float* height,
                uint8_t* gated, uint8_t* deep, uint8_t* margin,
                float* tol) {
    float xmax = pk_xmax_start(n, L);
    uint32_t klo = PK_EMPTY_KEY, khi = PK_EMPTY_KEY;
    if (n > 0) {
        uint32_t k = pk_rank_lo(n);
        const bool two = pk_rank_hi(n) != pk_rank_lo(n);
        uint32_t prefix = 0;
        bool found2 = false;
        int d2 = 0;
        for (int p = 0; p < PK_PASSES; ++p) {
            uint32_t hist[PK_BINS] = {};
            for (int i = 0; i < n; ++i) {
                if (p == 0)
                    xmax = fmaxf(xmax, row[i]);
                const uint32_t key = pk_key(row[i]);
                if (pk_in_group(key, prefix, p))
                    ++hist[pk_digit(key, p)];
            }
            int d = 0;
            uint32_t below = 0;
            if (pick_lanes(hist, k, &d, &below) != 1)
                return false;
            if (two && p == PK_PASSES - 1) {
                uint32_t below2;
                const int lanes = pick_lanes(hist, k + 1, &d2, &below2);
                if (lanes > 1)
                    return false;
                found2 = lanes == 1;
            }
            prefix = (prefix << PK_DIGIT) | (uint32_t)d;
            k -= below;
        }
        klo = khi = prefix;
        if (two) {
            if (found2) {
                khi = ((prefix >> PK_DIGIT) << PK_DIGIT) | (uint32_t)d2;
            } else {
                khi = 0xffffffffu;
                for (int i = 0; i < n; ++i) {
                    const uint32_t key = pk_key(row[i]);
                    if (key > klo && key < khi)
                        khi = key;
                }
            }
        }
    }
    const float m = pk_median(klo, khi);
    const PkGate g = pk_gate(xmax, m);
    *med = m;
    *height = g.height;
    *gated = g.gated;
    *tol = g.tol;
    *margin = g.near_gate;
    *deep = 0;
    return true;
}

void chunk_host(const float* row, int n, int L, int tile, int chunk, int c0,
                float height, bool gated, float tol, int32_t* pos, float* hs,
                uint8_t* deep, uint8_t* margin) {
    const int w = std::min(chunk, L - c0);
    const int M = L / tile;
    if (!pk_chunk_live(c0, n)) {
        for (int m = c0 / tile; m < (c0 + w) / tile; ++m)
            pk_write_tile(pos, hs, M, m, PkTop3{0, 0, 0});
        return;
    }
    std::vector<float> xs(w + PK_LEFT + 1);
    for (int i = 0; i < w + PK_LEFT + 1; ++i)
        xs[i] = pk_xm(row, c0 - PK_LEFT + i, n);
    int carry = c0 > 0 ? pk_start(c0 - 1, xs[PK_LEFT - 1], xs[PK_LEFT - 2])
                       : -1;
    if (carry < 0 && c0 > 1) {
        PkWalk walk(c0 - 1);
        do {
            carry = pk_latest_start(row, n, walk.lo, walk.hi, 0, 1);
        } while (carry < 0 && walk.next());
    }
    const int threads = chunk / PK_COLS;
    std::vector<PkTop3> top(threads);
    bool third = false, marg = false;
    int before = carry;  // the latest start before thread t's columns
    for (int t = 0; t < threads; ++t) {
        const int i0 = t * PK_COLS;
        // the thread's window: xs[i0 .. i0 + PK_WINDOW), one past the
        // chunk's staged columns where the thread is past its end
        float v[PK_WINDOW];
        for (int k = 0; k < PK_WINDOW; ++k)
            v[k] = i0 + k < w + PK_LEFT + 1 ? xs[i0 + k] : NAN;
        const PkThread o = pk_thread(v, c0 + i0, w - i0, n, before, height,
                                     gated, tol, tile, M, pos, hs);
        before = pk_latest(before, pk_thread_latest(v, c0 + i0, w - i0));
        top[t] = o.top;
        third = third || o.third;
        marg = marg || o.margin;
    }
    if (tile > PK_COLS) {
        const int lanes = tile / PK_COLS;
        std::vector<PkTop3> next(threads);
        for (int off = 1; off < lanes; off <<= 1) {
            for (int t = 0; t < threads; ++t)
                next[t] = pk_top3_merge(top[t], top[t ^ off]);
            top.swap(next);
        }
        for (int t = 0; t < threads; t += lanes)
            if (t * PK_COLS < w) {
                pk_write_tile(pos, hs, M, (c0 + t * PK_COLS) / tile, top[t]);
                third = third || top[t].c != 0;
            }
    }
    if (third)
        *deep = 1;
    if (marg)
        *margin = 1;
}

}  // namespace

extern "C" {

// the kernels' outputs for sm (B, L) float32 and lens (B,) int32, the
// candidates in chunks of `chunk` columns; -1 (nothing written) for a
// tile that is no power of two <= 64 or does not divide L, or a chunk
// that is no multiple of the tile and of 8; -2 when a pick of the median
// was found by more than one of warp 0's lanes, or by none
int pk_host(const float* sm, const int32_t* lens, int B, int L, int tile,
            int chunk, int32_t* cand_pos, float* cand_h, float* med,
            float* height, uint8_t* gated, uint8_t* deep, uint8_t* margin) {
    if (tile < 1 || tile > PK_MAX_TILE || (tile & (tile - 1)) || L < 1 ||
        L % tile || chunk < tile || chunk % tile || chunk % PK_COLS)
        return -1;
    const int M = L / tile;
    for (int b = 0; b < B; ++b) {
        const float* row = sm + (size_t)b * L;
        int n = lens[b];
        n = n < 0 ? 0 : (n > L ? L : n);
        float tol;
        if (!stats_host(row, n, L, &med[b], &height[b], &gated[b], &deep[b],
                        &margin[b], &tol))
            return -2;
        for (int c0 = 0; c0 < L; c0 += chunk)
            chunk_host(row, n, L, tile, chunk, c0, height[b], gated[b] != 0,
                       tol, cand_pos + (size_t)b * 2 * M,
                       cand_h + (size_t)b * 2 * M, &deep[b], &margin[b]);
    }
    return 0;
}

int pk_kernel_chunk() { return PK_CHUNK; }

}  // extern "C"
