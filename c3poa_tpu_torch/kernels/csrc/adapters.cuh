// Per-cell and per-lane arithmetic of the adapter-hits DP
// (csrc/adapters.cu), written once for the device and the host: a g++
// build of tests/adapters_host_driver.cpp runs whole (read, combo) sweeps
// lane by lane over these functions, with the warp's shuffle as an array
// shift, and holds them to the spec, c3poa_tpu/ref/sw.py:local_hits.
//
// The sweep is a wavefront.  A lane owns R consecutive adapter rows; at
// step s it computes its rows at read column j = s - lane, taking the row
// above at column j from the lane above (what that lane computed one step
// earlier) and at column j - 1 from what it took one step earlier.  The
// in-row gap run is the lane's own register: per cell, from the previous
// row at columns j - 1 (diagonal) and j (up) and this row at j - 1 (left):
//   T = diag >= up ? diag : up        the diagonal wins ties
//   a diagonal from H <= 0 starts a fresh path at (j, i)
//   T < 0 -> T = 0, path (j+1, i+1)   the local floor
//   H = T >= left - gap ? T : left - gap     T wins ties against the run
// which is ref/sw.py:local_hits's left-to-right loop, unchanged.  The
// column maximum (strict '>' over increasing rows: the earliest row wins)
// travels down the lanes with the row above.  On the general path (first
// below) H and the payload are two words and the column's key is
// colmax * 2^13 + (8191 - row), whose plain max is that rule; the packed
// path (last) keeps a cell, its payload and its place in the tie order in
// one word.
//
// Every H travels as Hg = H - gap, the value the cell below (up) and the
// cell to the right (left) both need.  Columns before the read's start
// see code N and the boundary H = 0 on every row, which is what the spec
// holds there, so the first lanes need no guard while they wait.
//
// A cell whose H is 0 carries the payload (j + 1, i + 1), the fresh start
// of the cell diagonally below it, and so does every cell of row -1 and
// column -1.  The spec can give an H = 0 cell another payload, but never
// reads it: a diagonal from H <= 0 starts afresh; an up candidate from H =
// 0 (T = -gap) wins only where T <= 0, and a left one (-gap) never beats T
// >= 0; H = 0 never raises a column maximum.  So the diagonal takes its
// payload as it comes, with no test of H, and a cell whose T is 0 takes
// the fresh payload as a floored one does.  (gap >= 0.)
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ADP_HD __host__ __device__ __forceinline__
#else
#define ADP_HD inline
#endif

// the path's (t_start, q_start) in one word: t_start <= L < 2^18,
// q_start <= m < 2^14
constexpr int ADP_QS_BITS = 14;
constexpr int32_t ADP_NEG = -(1 << 30);
// the column-maximum key: colmax << 13 | (8191 - row); colmax and row
// stay below 2^13 (the wrapper checks m * match)
constexpr int ADP_ROW_BITS = 13;
constexpr int32_t ADP_ROW_MASK = (1 << ADP_ROW_BITS) - 1;
// a column no row has raised above 0: colmax 0 at row 0
constexpr int32_t ADP_CM0 = ADP_ROW_MASK;
// substitution bytes are biased by 128; byte 4 (read code N) is 0 + 128
constexpr int32_t ADP_BIAS = 128;
// the scratch word of a finished column: colmax << 18 | t_start
constexpr int ADP_TS_BITS = 18;
// rows a lane owns at most; longer combos run in passes of 32 * R lanes
constexpr int ADP_MAX_R = 2;

ADP_HD uint32_t adp_pack(int32_t ts, int32_t qs) {
    return ((uint32_t)ts << ADP_QS_BITS) | (uint32_t)qs;
}
ADP_HD int32_t adp_ts(uint32_t p) { return (int32_t)(p >> ADP_QS_BITS); }
ADP_HD int32_t adp_qs(uint32_t p) {
    return (int32_t)(p & ((1u << ADP_QS_BITS) - 1u));
}

// ---- twins of the device intrinsics -----------------------------------
// max(a, b), *pred = a >= b (__vibmax_s32: on sm_90a a compare and a
// select, no single DPX instruction; the packed path needs neither)
ADP_HD int32_t adp_vibmax(int32_t a, int32_t b, bool* pred) {
#ifdef __CUDA_ARCH__
    return __vibmax_s32(a, b, pred);
#else
    *pred = a >= b;
    return a >= b ? a : b;
#endif
}

// byte permute, selector nibbles 0..7 (bytes of a, then of b)
ADP_HD uint32_t adp_perm(uint32_t a, uint32_t b, uint32_t sel) {
#ifdef __CUDA_ARCH__
    return __byte_perm(a, b, sel);
#else
    const uint64_t ab = ((uint64_t)b << 32) | a;
    uint32_t out = 0;
    for (int n = 0; n < 4; ++n)
        out |= (uint32_t)((ab >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF)
               << (8 * n);
    return out;
#endif
}

// ---- rows and cells -----------------------------------------------------
// a row's table: byte t = 128 + the score of read code t (0..3) against
// the adapter code qc; an adapter N scores 0 against everything
ADP_HD uint32_t adp_sub_table(int qc, int match, int mismatch) {
    const uint32_t mm = (uint32_t)((mismatch + ADP_BIAS) & 0xFF) * 0x01010101u;
    if (qc < 0 || qc > 3) return (uint32_t)ADP_BIAS * 0x01010101u;
    return mm ^ ((uint32_t)((match ^ mismatch) & 0xFF) << (8 * qc));
}

// the selector that picks a read code's byte (code 4 picks byte 4, the
// low byte of ADP_BIAS; bytes 1..3 of the result come from its zero bytes)
ADP_HD uint32_t adp_selector(int code) { return 0x7650u | (uint32_t)code; }

// one lane's R rows and their left column
template <int R>
struct AdpLane {
    uint32_t tab[R];   // substitution table
    uint32_t fresh[R]; // (0, i) + (1, 1): added to j << 14, (j + 1, i + 1)
    int32_t mul[R];    // 2^13 for a row of the combo, 0 for one past it
    int32_t kb[R];     // 8191 - i for a row of the combo, 0 past it
    int32_t lHg[R];    // H - gap at the lane's last column
    uint32_t lP[R];    // its payload
};

// rows first .. first + R - 1 of a combo of mc rows (codes q); rows past
// mc never reach the column maximum
template <int R>
ADP_HD void adp_lane_init(AdpLane<R>& st, const int8_t* q, int mc, int first,
                          int match, int mismatch, int gap) {
    for (int k = 0; k < R; ++k) {
        const int i = first + k;
        const bool live = i < mc;
        st.tab[k] = adp_sub_table(live ? q[i] : 4, match, mismatch);
        st.fresh[k] = adp_pack(1, i + 1);
        st.mul[k] = live ? (1 << ADP_ROW_BITS) : 0;
        st.kb[k] = live ? ADP_ROW_MASK - i : 0;
        st.lHg[k] = -gap;      // column -1: H = 0
        st.lP[k] = adp_pack(0, i + 1);
    }
}

// What travels down the lanes each step: the lane's last row at its
// column (Hg, payload) and the column maximum over the rows so far (key,
// payload).
struct AdpFlow {
    int32_t hg;
    uint32_t p;
    int32_t key;
    uint32_t kp;
};

// The flow into the first row of a combo (row -1) at column j: H = 0 with
// t_start j + 1, and no column maximum yet.
ADP_HD AdpFlow adp_top(int32_t j, int gap) {
    return AdpFlow{-gap, (uint32_t)(j + 1) << ADP_QS_BITS, ADP_CM0, 0u};
}

// What row i holds at column -1 (H = 0), as a lane passes it down before
// its first column.
ADP_HD AdpFlow adp_edge(int32_t i, int gap) {
    return AdpFlow{-gap, adp_pack(0, i + 1), ADP_CM0, 0u};
}

// One step of a lane: its rows at column j (read code ``code``, N before
// the read and past it), from the row above at column j (``up``) and at
// column j - 1 (``dhg``, ``dp``).  Returns what flows to the lane below.
// Per cell: the diagonal by a byte permute and one add, three maxima
// (diagonal or up, the floor, the gap run) each with its payload, and the
// column-maximum key.
template <int R>
ADP_HD AdpFlow adp_lane_step(AdpLane<R>& st, int code, int32_t j,
                             int32_t dhg, uint32_t dp, AdpFlow up, int gap) {
    const uint32_t sel = adp_selector(code);
    const uint32_t jsh = (uint32_t)j << ADP_QS_BITS;
    const int32_t cdiag = gap - ADP_BIAS;
    int32_t key = up.key;
    uint32_t kp = up.kp;
    int32_t uhg = up.hg;
    uint32_t up_ = up.p;
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < R; ++k) {
        const int32_t byte = (int32_t)adp_perm(st.tab[k], (uint32_t)ADP_BIAS,
                                               sel);
        const int32_t diag = dhg + byte + cdiag;
        bool take;
        int32_t t = adp_vibmax(diag, uhg, &take);
        uint32_t tp = take ? dp : up_;
        // T <= 0: H = 0 (or a gap run), the fresh start (j + 1, i + 1)
        tp = t > 0 ? tp : jsh + st.fresh[k];
        t = t > 0 ? t : 0;
        // the row's own left cell, before it is overwritten: the next
        // row's diagonal
        const int32_t lhg = st.lHg[k];
        const uint32_t lp = st.lP[k];
        const int32_t h = adp_vibmax(t, lhg, &take);
        const uint32_t hp = take ? tp : lp;
        st.lHg[k] = h - gap;
        st.lP[k] = hp;
        bool keep;
        key = adp_vibmax(key, h * st.mul[k] + st.kb[k], &keep);
        kp = keep ? kp : hp;
        dhg = lhg;
        dp = lp;
        uhg = h - gap;
        up_ = hp;
    }
    return AdpFlow{uhg, up_, key, kp};
}

// ---- a finished column ------------------------------------------------
ADP_HD int32_t adp_colmax(int32_t key) { return key >> ADP_ROW_BITS; }
ADP_HD int32_t adp_qe(int32_t key) {
    return ADP_ROW_MASK - (key & ADP_ROW_MASK);
}
// the scratch word the s2 reduction reads
ADP_HD uint32_t adp_word(int32_t key, uint32_t kp) {
    return ((uint32_t)adp_colmax(key) << ADP_TS_BITS) | (uint32_t)adp_ts(kp);
}

// Column j's contribution to the second hit, from its scratch word: its
// maximum, unless its span [ts, j] shares more than ``tol`` columns with
// the best span [ts1, j1].
ADP_HD int32_t adp_second(uint32_t word, int32_t j, int32_t j1, int32_t ts1,
                          int tol) {
    const int32_t cm = (int32_t)(word >> ADP_TS_BITS);
    const int32_t ts = (int32_t)(word & ((1u << ADP_TS_BITS) - 1u));
    const int32_t lo = ts > ts1 ? ts : ts1;
    const int32_t hi = j < j1 ? j : j1;
    return hi - lo + 1 > tol ? ADP_NEG : cm;
}

// rows a lane owns for a combo of mc rows
ADP_HD int adp_rows_per_lane(int mc, int lanes) {
    return mc <= lanes ? 1 : ADP_MAX_R;
}

// ---- the packed path ----------------------------------------------------
// For reads of at most 4095 columns and combos of at most 63 rows (the
// postprocess run's: ~2 kb reads, adapters of 25 and 56 bases) a cell and
// its payload fit one word, and so does each candidate of the cell's max
// with its place in the tie order:
//   bits 24..31  H (signed; H + a score stays in [-128, 127])
//   bits 22..23  tie rank of a candidate: floor 3 > diagonal 2 > up 1 >
//                left 0 (0 in a stored cell)
//   bits  6..17  t_start           bits 0..5  q_start
// so H = max(diagonal, up, left, floor) of the four words is the spec's
// rule, payload and ties included (the floor, value 0, outranks the rest
// only where H = 0: the fresh payload an H = 0 cell carries).  A column's
// key adds (63 - row) << 18 to the stored cell: its plain max is the
// strict '>' over increasing rows, and the key holds everything the
// outputs need, so it is the scratch word too.
constexpr int ADPK_MAX_L = 4095;
constexpr int ADPK_MAX_ROWS = 63;
constexpr int ADPK_H = 24;
constexpr int ADPK_TIE = 22;
constexpr int ADPK_ROW = 18;
constexpr int ADPK_TS = 6;
constexpr int32_t ADPK_TIES = 3 << ADPK_TIE;
// a column no row has raised above 0 (decodes as colmax, row and payload
// 0); every live row's key with H = 0 is below it, every H >= 1 above
constexpr int32_t ADPK_CM0 = (1 << ADPK_H) - 1;

// whether a read of ``len`` columns, adapters of width ``m`` and the
// scoring fit the packed words
ADP_HD bool adpk_fits(int len, int m, int match, int mismatch, int gap) {
    const int mt = match > 0 ? match : 0;
    return len <= ADPK_MAX_L && m <= ADPK_MAX_ROWS && (m + 1) * mt <= 127 &&
           mismatch >= -128 && gap >= 0 && gap <= 127;
}

// max(a, b, c) (DPX: VIMNMX3)
ADP_HD int32_t adp_vimax3(int32_t a, int32_t b, int32_t c) {
#ifdef __CUDA_ARCH__
    return __vimax3_s32(a, b, c);
#else
    const int32_t m = a > b ? a : b;
    return m > c ? m : c;
#endif
}

ADP_HD int32_t adpk_payload(int32_t ts, int32_t qs) {
    return (ts << ADPK_TS) + qs;
}

template <int R>
struct AdpkLane {
    uint32_t tab[R];   // substitution table (adp_sub_table)
    int32_t fresh[R];  // the floor candidate at column 0 (t_start 1, i + 1)
    int32_t mul[R];    // 1 for a row of the combo, 0 for one past it
    int32_t rank[R];   // (63 - i) << 18 for a row of the combo, 0 past it
    int32_t left[R];   // the row's cell at the lane's last column, ranked
                       // as a left candidate (H - gap, tie 0)
};

template <int R>
ADP_HD void adpk_lane_init(AdpkLane<R>& st, const int8_t* q, int mc,
                           int first, int match, int mismatch, int gap) {
    for (int k = 0; k < R; ++k) {
        const int i = first + k;
        const bool live = i < mc;
        st.tab[k] = adp_sub_table(live ? q[i] : 4, match, mismatch);
        st.fresh[k] = adpk_payload(1, i + 1) + (3 << ADPK_TIE);
        st.mul[k] = live ? 1 : 0;
        st.rank[k] = live ? (ADPK_MAX_ROWS - i) << ADPK_ROW : 0;
        // column -1: H = 0, payload (0, i + 1)
        st.left[k] = adpk_payload(0, i + 1) - (gap << ADPK_H);
    }
}

// What travels down the lanes: the lane's last row at its column, ranked
// as an up candidate (H - gap, tie 1), and the column's key so far.
struct AdpkFlow {
    int32_t up;
    int32_t key;
};

ADP_HD int32_t adpk_up(int32_t cell, int gap) {
    return cell + (1 << ADPK_TIE) - (gap << ADPK_H);
}

// row -1 at column j: H = 0 with t_start j + 1
ADP_HD AdpkFlow adpk_top(int32_t j, int gap) {
    return AdpkFlow{adpk_up(adpk_payload(j + 1, 0), gap), ADPK_CM0};
}

// row i at column -1
ADP_HD AdpkFlow adpk_edge(int32_t i, int gap) {
    return AdpkFlow{adpk_up(adpk_payload(0, i + 1), gap), ADPK_CM0};
}

// One step of a lane on the packed path: its rows at column j, from the
// row above at column j (``in.up``) and at column j - 1 (``dup``, the up
// word it took one step earlier).  Per cell: a byte permute puts the
// biased score in the top byte, one add makes the diagonal, one the floor,
// three maxima pick the cell, a mask clears the rank, two adds rank it as
// left and up, and a multiply-add and a max update the column's key.
template <int R>
ADP_HD AdpkFlow adpk_lane_step(AdpkLane<R>& st, int code, int32_t j,
                               int32_t dup, AdpkFlow in, int gap) {
    // nibble 3 picks the code's byte (4: the low byte of ADP_BIAS), the
    // others zero bytes: the biased score << 24
    const uint32_t sel = (uint32_t)code * 4096u + 0x765u;
    const int32_t jsh = (int32_t)((uint32_t)j << ADPK_TS);
    const int32_t from_up = (1 << ADPK_TIE) + ((gap - ADP_BIAS) << ADPK_H);
    const int32_t from_left = (2 << ADPK_TIE) + ((gap - ADP_BIAS) << ADPK_H);
    int32_t u = in.up, key = in.key, d = dup;
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int k = 0; k < R; ++k) {
        const int32_t diag = d + (int32_t)adp_perm(st.tab[k],
                                                   (uint32_t)ADP_BIAS, sel) +
                             (k ? from_left : from_up);
        const int32_t floor = jsh + st.fresh[k];
        const int32_t cell = adp_vimax3(diag, u, st.left[k]);
        const int32_t h = (cell > floor ? cell : floor) & ~ADPK_TIES;
        d = st.left[k];
        st.left[k] = h - (gap << ADPK_H);
        u = adpk_up(h, gap);
        const int32_t k2 = h * st.mul[k] + st.rank[k];
        key = key > k2 ? key : k2;
    }
    return AdpkFlow{u, key};
}

ADP_HD int32_t adpk_colmax(int32_t key) { return key >> ADPK_H; }
ADP_HD int32_t adpk_qe(int32_t key) {
    return key == ADPK_CM0 ? 0
         : ADPK_MAX_ROWS - ((key >> ADPK_ROW) & ADPK_MAX_ROWS);
}
ADP_HD int32_t adpk_ts(int32_t key) {
    return key == ADPK_CM0 ? 0 : (key >> ADPK_TS) & ADPK_MAX_L;
}
ADP_HD int32_t adpk_qs(int32_t key) {
    return key == ADPK_CM0 ? 0 : key & ((1 << ADPK_TS) - 1);
}
// a column's rank for the best hit: the higher colmax, then the earlier
// column
ADP_HD int32_t adpk_best(int32_t key, int32_t j) {
    return (adpk_colmax(key) << 12) | (ADPK_MAX_L - j);
}
ADP_HD int32_t adpk_best_column(int32_t best) {
    return ADPK_MAX_L - (best & ADPK_MAX_L);
}
// column j's contribution to the second hit (adp_second's rule)
ADP_HD int32_t adpk_second(int32_t key, int32_t j, int32_t j1, int32_t ts1,
                           int tol) {
    const int32_t ts = adpk_ts(key);
    const int32_t lo = ts > ts1 ? ts : ts1;
    const int32_t hi = j < j1 ? j : j1;
    return hi - lo + 1 > tol ? ADP_NEG : adpk_colmax(key);
}
