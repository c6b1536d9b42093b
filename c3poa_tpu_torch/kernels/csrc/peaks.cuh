// Arithmetic and chunk schedule of the locate step's peak candidates
// (csrc/peaks.cu), written once for the device and the host: a g++ build
// of tests/peaks_host_driver.cpp (-ffp-contract=off, never -ffast-math)
// runs the kernels' passes, chunks and tiles serially over these
// functions, and the CPU tests hold every output bit for bit to the plain
// torch version, c3poa_tpu_torch/kernels/peaks.py:peak_candidates_batch.
//
// The function.  x is a read's smoothed row (L columns, float32), n its
// length (0 <= n <= L), xm(j) = x[j] for 0 <= j < n and NEG_F elsewhere
// (j < 0 and j >= L included).  Domain: finite values above NEG_F / 2 and
// no -0.0.  (The smoothing kernel writes none: its sums start at +0.0f,
// and in round-to-nearest x + y is -0 only when x and y both are.  The
// plain version's sort leaves the order of -0 and +0 open; the key below
// puts -0 first, as the JAX package's bit search does.)
//   med    = (lo + hi) * 0.5, lo and hi the order statistics k1 = (n-1)/2
//            and k2 = n/2 of x[0..n), found by a radix select over the
//            order-preserving keys (pk_key) of the values;
//   xmax   = max over j < L of xm(j);
//   gated  = xmax < 6 * med,  height = 3 * med;
//   tol    = clamp(STRUCT_REL * xmax, min = STRUCT_ATOL);
//   start(j) = (j << 1 | xm(j) > xm(j-1)) where xm(j) != xm(j-1), else -1:
//            increasing in j, so the running max run(j) = max over i <= j
//            of start(i) is the latest run start l and whether the row
//            rises into it (torch.cummax in the plain version);
//   peak(j) = rise into l, l >= 1, xm(j+1) < xm(j), j <= n - 2: the last
//            column of a plateau [l, j] with a strict rise before and a
//            strict drop after (scipy's plateau semantics);
//   ok(j)  = peak(j), xm(j) >= height, not gated; its candidate is
//            (xm(j), (l + j) / 2), reported in the tile j / tile;
//   margin = near(xmax, 6 * med) with xmax > 0, or some j with peak(j),
//            xm(j) > 0 and near(xm(j), height), or some j < n with
//            xm(j+1) > NEG_F / 2, xm(j) and xm(j+1) >= height and
//            |xm(j+1) - xm(j)| <= tol; near(a, b) = |a - b| <= MARGIN_REL *
//            max(|a|, |b|).  The margin ignores the gate.
// Every float operation rounds once, in float32, as torch does: on the
// device explicitly (__fmul_rn, __fadd_rn, __fsub_rn, which nvcc never
// contracts into an FFMA), on the host by -ffp-contract=off.  Torch
// multiplies a Python float into a float32 tensor as a float32 constant,
// so the constants are float literals (1e-4f, 2e-6f, 2e-4f, -3.0e38f).
//
// The per-tile compaction.  A tile's entries are its columns' (h, mid):
// (xm(j), midpoint) where ok(j), else (NEG_F, -1).  The plain version
// takes (h1, p1) = the max h and the largest mid among entries at that h
// (p1 = -1 unless h1 > NEG_F / 2), sets h := NEG_F where mid == p1, takes
// (h2, p2) the same way, sets h := NEG_F where mid == p2, and flags `deep`
// when some h > NEG_F / 2 is left.  Two plateaus never share a midpoint
// (disjoint runs [l1, r1], [l2, r2] with r1 < l2 have (l1 + r1) / 2 <= r1
// < l2 <= (l2 + r2) / 2), and only a run's last column is a peak, so mids
// of ok entries are distinct and the removals drop exactly the entry
// taken.  In the domain every ok entry has h > NEG_F / 2.  So (h1, p1),
// (h2, p2) and `deep` are the first, second and existence of a third
// entry of the ok entries in descending (h, mid) order, (NEG_F, -1) where
// there are fewer; pk_entry packs (h, mid) into one uint64 whose unsigned
// order is that order (0 = no entry), and a tile keeps the top three.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define PK_HD __host__ __device__ __forceinline__
#else
#define PK_HD inline
#endif

constexpr float PK_NEG_F = -3.0e38f;
// NEG_F / 2 in the plain version: halving is exact, so this is the same
// float as -1.5e38f
constexpr float PK_NEG_HALF = PK_NEG_F * 0.5f;
constexpr float PK_MARGIN_REL = 1e-4f;
constexpr float PK_STRUCT_REL = 2e-6f;
constexpr float PK_STRUCT_ATOL = 2e-4f;

// the radix select: PK_PASSES digits of PK_DIGIT bits, most significant
// first
constexpr int PK_DIGIT = 8;
constexpr int PK_BINS = 1 << PK_DIGIT;
constexpr int PK_PASSES = 32 / PK_DIGIT;
// the statistics kernel: one block of PK_STATS_THREADS threads a read,
// PK_STATS_LOADS loads in flight a thread
constexpr int PK_STATS_THREADS = 1024;
constexpr int PK_STATS_LOADS = 8;
// the candidates kernel: one block of PK_THREADS threads a (read, chunk
// of PK_CHUNK columns), PK_COLS consecutive columns a thread; the chunk is
// staged with PK_LEFT columns before it and one after
constexpr int PK_THREADS = 256;
constexpr int PK_COLS = 8;
constexpr int PK_CHUNK = PK_THREADS * PK_COLS;
constexpr int PK_LEFT = 2;
// the largest tile: its PK_MAX_TILE / PK_COLS threads lie in one warp
constexpr int PK_MAX_TILE = 64;

#if defined(__CUDA_ARCH__)
#define PK_UNROLL _Pragma("unroll")
#else
#define PK_UNROLL
#endif

// ---- float32 arithmetic, rounded once an operation ----

PK_HD float pk_mul(float a, float b) {
#ifdef __CUDA_ARCH__
    return __fmul_rn(a, b);
#else
    return a * b;
#endif
}

PK_HD float pk_add(float a, float b) {
#ifdef __CUDA_ARCH__
    return __fadd_rn(a, b);
#else
    return a + b;
#endif
}

PK_HD float pk_sub(float a, float b) {
#ifdef __CUDA_ARCH__
    return __fsub_rn(a, b);
#else
    return a - b;
#endif
}

PK_HD uint32_t pk_bits(float x) {
#ifdef __CUDA_ARCH__
    return __float_as_uint(x);
#else
    uint32_t b;
    memcpy(&b, &x, sizeof b);
    return b;
#endif
}

PK_HD float pk_float(uint32_t b) {
#ifdef __CUDA_ARCH__
    return __uint_as_float(b);
#else
    float x;
    memcpy(&x, &b, sizeof x);
    return x;
#endif
}

// ---- the median ----

// float32 -> uint32 preserving order (c3poa_tpu/kernels/peaks.py:70-78):
// a negative value's bits inverted, a positive value's sign bit set
PK_HD uint32_t pk_key(float x) {
    const uint32_t b = pk_bits(x);
    return (b >> 31) ? ~b : (b | 0x80000000u);
}

PK_HD float pk_unkey(uint32_t k) {
    return pk_float((k >> 31) ? (k & 0x7fffffffu) : ~k);
}

// the digit of pass p (0 = the most significant)
PK_HD int pk_digit(uint32_t key, int p) {
    return (int)((key >> (32 - PK_DIGIT * (p + 1))) & (PK_BINS - 1));
}

// whether a key lies in the group that passes 0..p-1 chose, whose digits
// are `prefix` (pass 0 takes every key)
PK_HD bool pk_in_group(uint32_t key, uint32_t prefix, int p) {
    return p == 0 || (key >> (32 - PK_DIGIT * p)) == prefix;
}

// One step of the order-statistic selection, over a run of bins.  h[0..nb)
// counts the group's keys of consecutive digits, `below` of its keys have a
// smaller digit than h[0]'s.  True when the rank k (0-based, within the
// group) falls in the run, below <= k < below + sum(h): then *d is the bin
// (0 <= *d < nb) of the k-th key and *below_d the count of the group's keys
// with a smaller digit, so the k-th key of the group is the (k -
// *below_d)-th of digit *d.  The device calls it on each lane's 8 bins
// with the lane's exclusive prefix, so at most one lane finds k.
PK_HD bool pk_pick(const uint32_t* h, int nb, uint32_t below, uint32_t k,
                   int* d, uint32_t* below_d) {
    if (k < below)
        return false;
    for (int i = 0; i < nb; ++i) {
        if (k < below + h[i]) {
            *d = i;
            *below_d = below;
            return true;
        }
        below += h[i];
    }
    return false;
}

// the ranks masked_median averages, for n >= 1
PK_HD uint32_t pk_rank_lo(int n) { return (uint32_t)((n - 1) / 2); }
PK_HD uint32_t pk_rank_hi(int n) { return (uint32_t)(n / 2); }

// the key both ranks take for n = 0 (the plain version takes no such row;
// the JAX package's bit search ends on all ones, NaN, and so does this)
constexpr uint32_t PK_EMPTY_KEY = 0xffffffffu;

// (lo + hi) * 0.5, each rounded
PK_HD float pk_median(uint32_t klo, uint32_t khi) {
    return pk_mul(pk_add(pk_unkey(klo), pk_unkey(khi)), 0.5f);
}

// ---- the gates ----

// |a - b| <= MARGIN_REL * max(|a|, |b|)
PK_HD bool pk_near(float a, float b) {
    return fabsf(pk_sub(a, b)) <=
           pk_mul(PK_MARGIN_REL, fmaxf(fabsf(a), fabsf(b)));
}

// a read's scalars: the gate and the height cut at 6x and 3x the median,
// the gate half of the margin and the structure half's tolerance
struct PkGate {
    float height, tol;
    bool gated, near_gate;
};

PK_HD PkGate pk_gate(float xmax, float med) {
    PkGate g;
    const float six = pk_mul(6.0f, med);
    g.height = pk_mul(3.0f, med);
    g.gated = xmax < six;
#ifdef PEAKS_MUTANT_FMA
    // what nvcc makes of xmax - 6.0f * med unless told otherwise: one
    // FFMA, the product unrounded (the CPU tests' mutant; must disagree)
    g.near_gate = xmax > 0.0f &&
                  fabsf(fmaf(-6.0f, med, xmax)) <=
                      pk_mul(PK_MARGIN_REL, fmaxf(fabsf(xmax), fabsf(six)));
#else
    g.near_gate = xmax > 0.0f && pk_near(xmax, six);
#endif
    // torch.clamp(v, min=ATOL): ATOL where v < ATOL, else v
    const float t = pk_mul(PK_STRUCT_REL, xmax);
    g.tol = t < PK_STRUCT_ATOL ? PK_STRUCT_ATOL : t;
    return g;
}

// xmax starts from NEG_F when the row holds a column past the read
PK_HD float pk_xmax_start(int n, int L) {
    return n < L ? PK_NEG_F : -INFINITY;
}

// ---- the columns ----

// xm(j) of a row of L columns of which n are the read's
PK_HD float pk_xm(const float* row, int j, int n) {
    return (j >= 0 && j < n) ? row[j] : PK_NEG_F;
}

// column j's run start, packed (j << 1 | rise into it), or -1
PK_HD int pk_start(int j, float xm, float xprev) {
    return xm != xprev ? (j << 1) | (xm > xprev ? 1 : 0) : -1;
}

// the latest-run-start combine: starts grow with j, so the latest of two
// is the larger (associative and commutative: any scan order)
PK_HD int pk_latest(int a, int b) { return a > b ? a : b; }

// a candidate (h, mid) as one key whose unsigned order is (h, mid)'s
// lexicographic order: ties in h go to the largest midpoint; 0 is below
// every entry (the low word is at least 1)
PK_HD uint32_t pk_mid_code(int mid) {
#ifdef PEAKS_MUTANT_TIES
    return (uint32_t)(0x7fffffff - mid);  // the smallest mid wins a tie
#else
    return (uint32_t)mid + 1u;
#endif
}

PK_HD int pk_mid_of(uint32_t code) {
#ifdef PEAKS_MUTANT_TIES
    return 0x7fffffff - (int)code;
#else
    return (int)code - 1;
#endif
}

PK_HD uint64_t pk_entry(float h, int mid) {
    return ((uint64_t)pk_key(h) << 32) | pk_mid_code(mid);
}

// a slot's (cand_h, cand_pos): (NEG_F, -1) for no entry
PK_HD void pk_slot(uint64_t e, float* h, int* pos) {
    *h = e ? pk_unkey((uint32_t)(e >> 32)) : PK_NEG_F;
    *pos = e ? pk_mid_of((uint32_t)e) : -1;
}

// what column j contributes: its candidate key (0 unless ok) and whether
// it sets the margin flag; run = run(j), xm = xm(j), xnext = xm(j + 1)
struct PkCol {
    uint64_t key;
    bool margin;
};

PK_HD PkCol pk_col(int j, int n, int run, float xm, float xnext,
                   float height, bool gated, float tol) {
    const int l = run >> 1;
    const bool peak = (run & 1) == 1 && l >= 1 && xnext < xm && j <= n - 2;
    const bool ok = peak && xm >= height && !gated;
    const bool near_h = peak && xm > 0.0f && pk_near(xm, height);
    const bool near_struct = j < n && xnext > PK_NEG_HALF && xm >= height &&
                             xnext >= height &&
                             fabsf(pk_sub(xnext, xm)) <= tol;
    // l >= 1 where ok: (l + j) >> 1 is the floor division
    return PkCol{ok ? pk_entry(xm, (l + j) >> 1) : 0, near_h || near_struct};
}

// whether a chunk starting at column c0 can hold a peak or a structure
// pair (both need j <= n - 2); one that cannot writes empty slots only
PK_HD bool pk_chunk_live(int c0, int n) { return c0 <= n - 2; }

// The carry of a chunk starting at c0 > 0: the latest run start before
// it.  The run entering the chunk may have started anywhere before, as far
// back as column 0 (a plateau can be as long as the read), so no halo is
// enough.  The staged columns give start(c0 - 1); only where c0 - 1 starts
// no run does the block walk left from it in global memory: windows [lo,
// hi) with hi = c0 - 1 first, the first PK_THREADS columns wide and each
// next one twice the last (at most PK_WALK_MAX), until one holds a start or
// column 0 is passed; the first window that holds one holds the latest.
constexpr int PK_WALK_MAX = 1 << 16;

struct PkWalk {
    int lo, hi, span;

    PK_HD explicit PkWalk(int end) : lo(0), hi(end), span(PK_THREADS) {
#ifdef PEAKS_MUTANT_CARRY
        // no walk: the staged halo alone (the CPU tests' mutant; must
        // disagree)
        lo = hi;
#else
        lo = hi > span ? hi - span : 0;
#endif
    }
    // the next window to the left; false when column 0 was in this one
    PK_HD bool next() {
#ifdef PEAKS_MUTANT_CARRY
        return false;
#else
        if (lo == 0)
            return false;
        hi = lo;
        span = span < PK_WALK_MAX / 2 ? 2 * span : PK_WALK_MAX;
        lo = hi > span ? hi - span : 0;
        return true;
#endif
    }
};

// the latest run start among the columns hi - 1 - first, hi - 1 - first -
// step, ... >= lo, or -1 (a thread's share of a window: the first start
// found from the right is its latest)
PK_HD int pk_latest_start(const float* row, int n, int lo, int hi,
                          int first, int step) {
    for (int j = hi - 1 - first; j >= lo; j -= step) {
        const int s = pk_start(j, pk_xm(row, j, n), pk_xm(row, j - 1, n));
        if (s >= 0)
            return s;
    }
    return -1;
}

// ---- the per-tile top three ----

// the three largest entries of a tile, a >= b >= c (0 where fewer)
struct PkTop3 {
    uint64_t a, b, c;
};

PK_HD uint64_t pk_max64(uint64_t x, uint64_t y) { return x > y ? x : y; }
PK_HD uint64_t pk_min64(uint64_t x, uint64_t y) { return x < y ? x : y; }

// one entry into a sorted three: a' = max(a, x), b' = the second of
// {a, b, x} = max(b, min(a, x)), c' = the third of {a, b, c, x} =
// max(c, min(b, x))
PK_HD PkTop3 pk_top3_insert(PkTop3 t, uint64_t x) {
    return PkTop3{pk_max64(t.a, x), pk_max64(t.b, pk_min64(t.a, x)),
                  pk_max64(t.c, pk_min64(t.b, x))};
}

// the top three of two sorted threes: the elementwise max of one and the
// other reversed, (max(s.a, t.c), max(s.b, t.b), max(s.c, t.a)), holds
// the three largest of the six (if the top three take i of s, i = 0..3,
// then for r < i s's r-th beats t's (2 - r)-th, which lies below t's
// (3 - i) taken; for r >= i, t's (2 - r)-th is taken and beats s's r-th),
// then sorted by three compare-exchanges.  Symmetric in s and t, so a
// butterfly of shuffles gives every lane the same three.
PK_HD PkTop3 pk_top3_merge(PkTop3 s, PkTop3 t) {
    uint64_t x = pk_max64(s.a, t.c), y = pk_max64(s.b, t.b),
             z = pk_max64(s.c, t.a);
    uint64_t hi = pk_max64(x, y), lo = pk_min64(x, y);
    x = hi;
    y = lo;
    hi = pk_max64(y, z);
    z = pk_min64(y, z);
    y = hi;
    hi = pk_max64(x, y);
    y = pk_min64(x, y);
    return PkTop3{hi, y, z};
}


// tile m's two slots: the winner at m, the runner-up at M + m, as
// torch.cat([p1, p2]) lays them out
PK_HD void pk_write_tile(int32_t* pos, float* h, int M, int m, PkTop3 t) {
    pk_slot(t.a, &h[m], &pos[m]);
    pk_slot(t.b, &h[M + m], &pos[M + m]);
}

// ---- a thread's columns in the candidates kernel ----

// A thread owns the columns j0 .. j0 + PK_COLS - 1, of which the first
// `live` are the chunk's (live may be <= 0 or > PK_COLS), and holds them
// in v[0 .. PK_WINDOW): v[r + PK_LEFT] = xm(j0 + r), with PK_LEFT columns
// before and one after.  The unrolled column index is a constant, so on
// the device v and the keys stay in registers.
constexpr int PK_WINDOW = PK_LEFT + PK_COLS + 1;

// the latest run start among the thread's columns, or -1
PK_HD int pk_thread_latest(const float* v, int j0, int live) {
    int own = -1;
    PK_UNROLL
    for (int r = 0; r < PK_COLS; ++r)
        if (r < live)
            own = pk_latest(own, pk_start(j0 + r, v[r + PK_LEFT],
                                          v[r + PK_LEFT - 1]));
    return own;
}

// What a thread's columns leave: the top three of its tile when a tile is
// wider than PK_COLS (for the butterfly), and whether one of its tiles
// holds a third entry or one of its columns sets the margin.
struct PkThread {
    PkTop3 top;
    bool third, margin;
};

// The thread's columns from `run`, the latest start before them: each
// column's key and margin, each key into the running three; a tile of at
// most PK_COLS columns (tile | PK_COLS) ends at the thread's column r when
// tile divides r + 1, and is written there.
PK_HD PkThread pk_thread(const float* v, int j0, int live, int n, int run,
                         float height, bool gated, float tol, int tile,
                         int M, int32_t* pos, float* hs) {
    PkThread o{PkTop3{0, 0, 0}, false, false};
    PK_UNROLL
    for (int r = 0; r < PK_COLS; ++r) {
        uint64_t key = 0;
        if (r < live) {
            const float xm = v[r + PK_LEFT];
            run = pk_latest(run, pk_start(j0 + r, xm, v[r + PK_LEFT - 1]));
            const PkCol col = pk_col(j0 + r, n, run, xm, v[r + PK_LEFT + 1],
                                     height, gated, tol);
            key = col.key;
            o.margin = o.margin || col.margin;
        }
        o.top = pk_top3_insert(o.top, key);
        if (tile <= PK_COLS && ((r + 1) & (tile - 1)) == 0) {
            const int first = r + 1 - tile;
            if (first < live) {
                pk_write_tile(pos, hs, M, (j0 + first) / tile, o.top);
                o.third = o.third || o.top.c != 0;
            }
            o.top = PkTop3{0, 0, 0};
        }
    }
    return o;
}
