// Per-cell and per-strip arithmetic of the adapter-hits DP
// (csrc/adapters.cu), written once for the device and the host: a g++
// build of a host driver over this header holds it against the spec,
// c3poa_tpu/ref/sw.py:local_hits, in the CPU tests.
//
// Cell rule (ref/sw.py:local_hits): from the previous row's H at columns
// j-1 (diagonal) and j (up),
//   T = diag >= up ? diag : up        the diagonal wins ties
//   a diagonal from H <= 0 starts a fresh path at (j, i)
//   T < 0 -> T = 0, path (j+1, i+1)   the local floor
// then the in-row gap run H[j] = max_{k <= j} T[k] - gap * (j - k), a
// prefix max of A = T + gap * j in which the rightmost source wins ties:
// join(left, right) takes left only when left > right.  That join is
// associative, so a strip prefix, a warp scan and a chain of carries give
// the same result as the spec's left-to-right loop.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ADP_HD __host__ __device__ __forceinline__
#else
#define ADP_HD inline
#endif

// columns a thread holds in registers
constexpr int ADP_K = 8;
// the path's (t_start, q_start) in one word: t_start <= L < 2^18,
// q_start <= m < 2^14
constexpr int ADP_QS_BITS = 14;
constexpr int32_t ADP_NEG = -(1 << 30);

ADP_HD uint32_t adp_pack(int32_t ts, int32_t qs) {
    return ((uint32_t)ts << ADP_QS_BITS) | (uint32_t)qs;
}
ADP_HD int32_t adp_ts(uint32_t p) { return (int32_t)(p >> ADP_QS_BITS); }
ADP_HD int32_t adp_qs(uint32_t p) {
    return (int32_t)(p & ((1u << ADP_QS_BITS) - 1u));
}

// the in-row run's join: (*b, *pb), right of (a, pa), becomes their
// join; the right side wins ties
ADP_HD void adp_join(int32_t a, uint32_t pa, int32_t* b, uint32_t* pb) {
    if (a > *b) { *b = a; *pb = pa; }
}

// T of cell (i, j) and its payload, before the in-row run.  hd/pd: the
// previous row at column j-1; hu/pu: the previous row at column j.
ADP_HD int32_t adp_cell(int qc, int rc, int32_t hd, uint32_t pd, int32_t hu,
                        uint32_t pu, int32_t j, int32_t i, int match,
                        int mismatch, int gap, uint32_t* pay) {
    const int32_t s = (qc == 4 || rc == 4) ? 0
                    : (qc == rc ? match : mismatch);
    const int32_t diag = hd + s;
    const uint32_t dp = hd <= 0 ? adp_pack(j, i) : pd;
    const int32_t up = hu - gap;
    int32_t t = up;
    uint32_t p = pu;
    if (diag >= up) { t = diag; p = dp; }
    if (t < 0) { t = 0; p = adp_pack(j + 1, i + 1); }
    *pay = p;
    return t;
}

// One row over a strip of ADP_K columns j0 .. j0+K-1, first half: from
// the previous row (H, P) and its value (hl, pl) at column j0-1, the
// in-strip inclusive prefix (A, Q) of A = T + gap * j.
ADP_HD void adp_strip_prefix(const int* rc, int qc, int32_t j0, int32_t i,
                             int match, int mismatch, int gap, int32_t hl,
                             uint32_t pl, const int32_t* H, const uint32_t* P,
                             int32_t* A, uint32_t* Q) {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < ADP_K; ++k) {
        const int32_t hd = k ? H[k - 1] : hl;
        const uint32_t pd = k ? P[k - 1] : pl;
        A[k] = adp_cell(qc, rc[k], hd, pd, H[k], P[k], j0 + k, i, match,
                        mismatch, gap, &Q[k]) + gap * (j0 + k);
        if (k) adp_join(A[k - 1], Q[k - 1], &A[k], &Q[k]);
    }
}

// Second half: join the carry (cin, pin) — the row's inclusive prefix at
// column j0-1 — into the strip, giving the row's H and P there, and
// update the column maxima of the columns below ``len`` (strict '>', so
// the earliest row wins).
ADP_HD void adp_strip_finish(int32_t cin, uint32_t pin, int32_t j0, int32_t i,
                             int gap, int32_t len, int32_t* A, uint32_t* Q,
                             int32_t* H, uint32_t* P, int32_t* cm,
                             int32_t* qe, uint32_t* cp) {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < ADP_K; ++k) {
        adp_join(cin, pin, &A[k], &Q[k]);
        H[k] = A[k] - gap * (j0 + k);
        P[k] = Q[k];
        if (j0 + k < len && H[k] > cm[k]) {
            cm[k] = H[k];
            qe[k] = i;
            cp[k] = Q[k];
        }
    }
}

// The best hit's order: the higher score, then the earlier column.
ADP_HD bool adp_better(int32_t s, int32_t j, int32_t s0, int32_t j0) {
    return s > s0 || (s == s0 && j < j0);
}

// Column j's contribution to the second hit: its maximum, unless its span
// [ts, j] shares more than ``tol`` columns with the best span [ts1, j1].
ADP_HD int32_t adp_second(int32_t cm, int32_t ts, int32_t j, int32_t j1,
                          int32_t ts1, int tol) {
    const int32_t lo = ts > ts1 ? ts : ts1;
    const int32_t hi = j < j1 ? j : j1;
    return hi - lo + 1 > tol ? ADP_NEG : cm;
}
