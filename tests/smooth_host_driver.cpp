// Host driver of the smoothing kernel's arithmetic and tile schedule, for
// the CPU tests (tests/test_torch_smooth.py builds it with g++,
// -ffp-contract=off).
//
// It runs the control flow of c3poa_tpu_torch/kernels/csrc/smooth.cu
// serially over the functions of smooth.cuh, for any tile width T and
// any group width R (1, 2, 4 or 8): per (read, tile) the early zeros of a
// tile past the read, the load, and per pass every pad slot read before
// any is written, then every group of R columns from its window in the
// buffer.  The buffers start as NaN, so a stored column that read a slot
// no phase wrote would show.
#include <stdint.h>

#include <cmath>
#include <vector>

#include "smooth.cuh"

namespace {

template <int R>
void tile_host(const SmTile& t, const int32_t* row, const float* m,
               float* orow) {
    const int len = sm_buf_len(t.T, R);
    std::vector<float> buf[2] = {std::vector<float>(len, NAN),
                                 std::vector<float>(len, NAN)};
    for (int i = 0; i < len; ++i)
        buf[0][i] = sm_load_value(t, row, i);
    for (int k = 1; k <= SM_PASSES; ++k) {
        float* x = buf[(k - 1) & 1].data();
        float* y = buf[k & 1].data();
        int pos[SM_PADS];
        float val[SM_PADS];
        bool pad[SM_PADS];
        for (int s = 0; s < SM_PADS; ++s)
            pad[s] = sm_pad(t, k, x, s, &pos[s], &val[s]);
        for (int s = 0; s < SM_PADS; ++s)
            if (pad[s])
                x[pos[s]] = val[s];
        const int lo = t.lo(k), hi = t.hi(k);
        for (int g = 0; g < t.groups(k, R); ++g) {
            const int j0 = lo + g * R;
            float acc[R];
            if (j0 >= t.n) {
                for (int r = 0; r < R; ++r)
                    acc[r] = 0.0f;
            } else {
                sm_group<R>(x + t.idx(j0 - SM_HALF), m, j0, t.n, acc);
            }
            for (int r = 0; r < R; ++r) {
                const int j = j0 + r;
                if (j >= hi)
                    break;
                if (k < SM_PASSES)
                    y[t.idx(j)] = acc[r];
                else if (j < t.L)
                    orow[j] = acc[r];
            }
        }
    }
}

template <int R>
void run(const int32_t* prof, const int32_t* combo, const int32_t* lens,
         const float* m, float* out, int B, int C, int L, int T) {
    for (int b = 0; b < B; ++b) {
        float* orow = out + (size_t)b * L;
        int n = lens[b];
        n = n < 0 ? 0 : (n > L ? L : n);
        int c = combo[b];
        c = c < 0 ? 0 : (c >= C ? C - 1 : c);
        const int32_t* row = prof + ((size_t)b * C + c) * L;
        for (int t0 = 0; t0 < L; t0 += T) {
            if (t0 >= n) {
                for (int j = t0; j < t0 + T && j < L; ++j)
                    orow[j] = 0.0f;
                continue;
            }
            tile_host<R>(SmTile{t0, T, n, L}, row, m, orow);
        }
    }
}

}  // namespace

extern "C" {

// the kernel's own tile width and group width
int sm_kernel_tile(void) { return SM_TILE; }
int sm_kernel_r(void) { return SM_R; }

// As c3t_smooth3, with the tile width T >= 1 and group width R in {1, 2,
// 4, 8} chosen by the caller; returns 0, or -1 for an R not built.
int sm_host(const int32_t* prof, const int32_t* combo, const int32_t* lens,
            const float* coeffs, float* out, int B, int C, int L, int T,
            int R) {
    switch (R) {
        case 1: run<1>(prof, combo, lens, coeffs, out, B, C, L, T); return 0;
        case 2: run<2>(prof, combo, lens, coeffs, out, B, C, L, T); return 0;
        case 4: run<4>(prof, combo, lens, coeffs, out, B, C, L, T); return 0;
        case 8: run<8>(prof, combo, lens, coeffs, out, B, C, L, T); return 0;
        default: return -1;
    }
}

}  // extern "C"
