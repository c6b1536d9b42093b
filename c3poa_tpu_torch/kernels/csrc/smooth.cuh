// Arithmetic and tile schedule of the locate step's smoothing
// (csrc/smooth.cu), written once for the device and the host: a g++
// build of tests/smooth_host_driver.cpp (-ffp-contract=off, never
// -ffast-math) runs the kernel's tiles serially over these functions and
// the CPU tests hold it bit for bit to the plain torch version,
// c3poa_tpu_torch/kernels/smooth.py:smooth3_batch.
//
// The function.  x0 is the chosen combo's int32 profile row (L columns),
// n the read's length (0 <= n <= L), m[0..40] the float32 taps of
// ref/sg.py:sg_coeffs(41, 2), computed on the host.  Three passes; pass k
// reads x = x_{k-1} (x_0 = float(x0), exact for these scores) through the
// padded row ext(p), p in [-20, L + 20):
//   p < 0            x[0] - |x[-p] - x[0]|   (x[-p] read also when -p >= n:
//                                            the raw row in pass 1, 0 after)
//   0 <= p < n       x[p]
//   n <= p < n + 20  yn + |x[clamp(n - 2 - (p - n), 0, L - 1)] - yn|,
//                    yn = x[max(n - 1, 0)]
//   n + 20 <= p < L  x[p]                    (reaches masked outputs only)
//   p >= L           0
// and writes x_k[j] = sum_{k=0..40} m[k] * ext(j - 20 + k) for j < n, +0
// for j >= n.  The sum starts at +0.0f and rounds after every multiply and
// every add, in the order k = 0..40: never an FMA, never the symmetric-tap
// shortcut (either changes the bits; the +0.0f start turns a sum of -0
// products over a run of zero scores into +0, as the plain version does).
// On the device the rounding is explicit (__fmul_rn, __fadd_rn,
// __fsub_rn, which nvcc never contracts); on the host it is what
// -ffp-contract=off gives.
//
// The tile schedule.  A block owns the output columns [t0, t0 + T) of one
// read, t0 < n (a tile with t0 >= n only writes zeros).  Let r(k) =
// 20 * (3 - k): 60, 40, 20, 0 for k = 0 (the load) .. 3.  Pass k computes
// x_k over lo(k) = max(t0 - r(k), 0) .. hi(k) = t0 + T + r(k), every
// column of it (+0 where j >= n), into the other of two buffers that
// cover the columns [t0 - 60, t0 + T + 60 + R) (column p at index p - t0 +
// 60); the load puts float(x0[p]) for 0 <= p < L and 0 for p >= L.  Pass
// k reads ext over lo(k) - 20 .. hi(k) + 20 = lo(k - 1) .. hi(k - 1) (for
// lo(k) >= 20), so it reads only what pass k - 1 wrote, and before it the
// pad positions in that span, p in [-20, 0) and p in [n, n + 20), are
// overwritten with their pad values; every pad value is read out of the
// buffer before any is written (a head source x[1..20] may sit at a tail
// position when n <= 20).  Why the pads' sources are in the buffer (t0 <
// n, any T >= 1):
//   - head, used by pass k only if lo(k) - 20 < 0: then t0 < 20 + r(k) =
//     r(k - 1), so lo(k - 1) = 0, and hi(k - 1) >= T + 20 > 20: x[0..20]
//     of pass k - 1 were all written (as the raw row or +0 past n);
//   - tail, used only for p < hi(k) + 20 = hi(k - 1): its sources lie in
//     [max(n - 21, 0), n - 1]; n - 1 < p < hi(k - 1), and n - 21 >= t0 -
//     20 >= t0 - r(k - 1) since t0 < n and r(k - 1) >= 20, so
//     max(n - 21, 0) >= lo(k - 1).
// So the tile equals the whole-row computation for any T and any tiling;
// T and R only change which thread computes which column.  A thread
// computes R consecutive columns from a window of 40 + R values (one
// shared-memory read a value, not one a tap); the last group of a pass
// may run past hi(k) (when R does not divide hi(k) - lo(k)): its extra
// columns read at most R - 1 values past hi(k - 1), inside the buffer,
// and are not stored.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SM_HD __host__ __device__ __forceinline__
#else
#define SM_HD inline
#endif

constexpr int SM_TAPS = 41;
constexpr int SM_HALF = 20;
constexpr int SM_PASSES = 3;
// the tile's halo: 20 columns a pass on each side
constexpr int SM_HALO = SM_PASSES * SM_HALF;
// pad slots a pass: 20 head positions, then 20 tail positions
constexpr int SM_PADS = 2 * SM_HALF;
// the kernel's launch shape: SM_THREADS threads a block, SM_R columns a
// thread, and a tile whose widest pass (T + 80 columns) is one group a
// thread
constexpr int SM_THREADS = 128;
constexpr int SM_R = 8;
constexpr int SM_TILE = SM_THREADS * SM_R - 2 * (SM_HALO - SM_HALF);

SM_HD float sm_mul(float a, float b) {
#ifdef __CUDA_ARCH__
    return __fmul_rn(a, b);
#else
    return a * b;
#endif
}

SM_HD float sm_add(float a, float b) {
#ifdef __CUDA_ARCH__
    return __fadd_rn(a, b);
#else
    return a + b;
#endif
}

SM_HD float sm_sub(float a, float b) {
#ifdef __CUDA_ARCH__
    return __fsub_rn(a, b);
#else
    return a - b;
#endif
}

// one tap: acc + m * e, rounded twice (the mutant of the CPU tests fuses
// it, and must disagree)
SM_HD float sm_tap(float acc, float m, float e) {
#ifdef SMOOTH_MUTANT_FMA
    return fmaf(m, e, acc);
#else
    return sm_add(acc, sm_mul(m, e));
#endif
}

// buffer floats a tile of T columns needs at R columns a thread
SM_HD int sm_buf_len(int T, int R) { return T + 2 * SM_HALO + R; }

// One read's tile: columns [t0, t0 + T) of a row of L columns, n of them
// the read's.  Buffer index of column p: p - t0 + SM_HALO.
struct SmTile {
    int t0, T, n, L;

    SM_HD int reach(int k) const { return SM_HALF * (SM_PASSES - k); }
    SM_HD int lo(int k) const {
        const int a = t0 - reach(k);
        return a > 0 ? a : 0;
    }
    SM_HD int hi(int k) const { return t0 + T + reach(k); }
    SM_HD int idx(int p) const { return p - t0 + SM_HALO; }
    // groups of R columns pass k computes
    SM_HD int groups(int k, int R) const {
        return (hi(k) - lo(k) + R - 1) / R;
    }
};

// the load: buffer slot i holds column t0 - SM_HALO + i
SM_HD float sm_load_value(const SmTile& t, const int32_t* row, int i) {
    const int p = t.t0 - SM_HALO + i;
    return (p >= 0 && p < t.L) ? (float)row[p] : 0.0f;
}

// Pad slot s of pass k (s < SM_HALF: p = -1 - s; else p = n + s - 20):
// false when pass k reads no column p; else its position and value from
// x = pass k - 1's buffer.
SM_HD bool sm_pad(const SmTile& t, int k, const float* x, int s, int* pos,
                  float* val) {
    const int p = s < SM_HALF ? -1 - s : t.n + s - SM_HALF;
    if (p < t.lo(k) - SM_HALF || p >= t.hi(k) + SM_HALF)
        return false;
    *pos = t.idx(p);
    if (p < 0) {
        const float y0 = x[t.idx(0)];
        *val = sm_sub(y0, fabsf(sm_sub(x[t.idx(-p)], y0)));
    } else {
        const float yn = x[t.idx(t.n > 0 ? t.n - 1 : 0)];
        int q = t.n - 2 - (p - t.n);
        q = q < 0 ? 0 : (q > t.L - 1 ? t.L - 1 : q);
        *val = sm_add(yn, fabsf(sm_sub(x[t.idx(q)], yn)));
    }
    return true;
}

// R columns j0 .. j0 + R - 1 from their window e[0 .. 40 + R) = ext(j0 -
// 20 ..): acc[r] = sum over k of m[k] * e[r + k], k = 0..40 in order,
// from +0; then +0 for a column at or past n.
template <int R>
SM_HD void sm_group(const float* e, const float* m, int j0, int n,
                    float* acc) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int r = 0; r < R; ++r)
        acc[r] = 0.0f;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = 0; k < SM_TAPS; ++k) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int r = 0; r < R; ++r)
            acc[r] = sm_tap(acc[r], m[k], e[r + k]);
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int r = 0; r < R; ++r)
        acc[r] = j0 + r < n ? acc[r] : 0.0f;
}
