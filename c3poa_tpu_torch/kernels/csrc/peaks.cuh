// Arithmetic and cluster schedule of the locate step's peak candidates
// (csrc/peaks.cu), written once for the device and the host: a g++ build
// of tests/peaks_host_driver.cpp (-ffp-contract=off, never -ffast-math)
// runs the kernel's ranks, passes, warps and steps serially over these
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
// there are fewer; an entry packs (h, mid) into one uint64 whose unsigned
// order is that order (pk_column; 0 = no entry), and a tile keeps the top
// three.
//
// The schedule (csrc/peaks.cu).  A read is a cluster of R CTAs (ranks);
// rank r holds the columns [r * S, r * S + w) of the row in its shared
// memory as keys, S a power of two of at least PK_SHARE_ALIGN columns (so
// a tile never straddles two ranks), w = the share's columns below L (0
// for a rank past the row's end).  The median's passes build each rank's
// histogram of its share, merge the ranks' (pk_merges) and make the same
// pick in every rank; the carry into a share is the latest run start of
// the ranks below it (pk_carries); a warp goes over its part of the share
// a step of PK_STEP columns at a time, PK_COLS a lane, and a column that
// cannot matter (pk_may_matter) pays no candidate or margin arithmetic.
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
// a CTA: PK_THREADS threads, at least PK_MIN_CTAS of them on an SM; each
// warp a segment of the share, gone over a step of PK_STEP columns at a
// time, PK_COLS consecutive columns a lane with the column before
// (PK_LEFT) and after
constexpr int PK_THREADS = 512;
constexpr int PK_MIN_CTAS = 2;
// 16-byte loads of the row in flight a thread
constexpr int PK_LOADS = 4;
constexpr int PK_WARPS = PK_THREADS / 32;
constexpr int PK_COLS = 8;
constexpr int PK_STEP = 32 * PK_COLS;
constexpr int PK_LEFT = 1;
constexpr int PK_WINDOW = PK_LEFT + PK_COLS + 1;
// the largest tile: its PK_MAX_TILE / PK_COLS threads lie in one warp
constexpr int PK_MAX_TILE = 64;
// shares: a power of two of at least PK_SHARE_ALIGN columns (a whole number
// of steps a warp), never wider than PK_MAX_SHARE; R at most PK_MAX_RANKS
// (the largest portable cluster)
constexpr int PK_SHARE_ALIGN = PK_WARPS * PK_STEP;
constexpr int PK_MAX_SHARE = 32768;
constexpr int PK_MAX_RANKS = 8;
// the widest row the kernel takes
constexpr int PK_MAX_L = PK_MAX_RANKS * PK_MAX_SHARE;

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

// ---- the cluster's shape ----

// S for L columns over R ranks: a power of two, at least ceil(L / R) and
// PK_SHARE_ALIGN; so a thread's segment, S / PK_THREADS columns, is a
// power of two of at least PK_COLS, and a tile lies in one segment or
// spans whole ones
PK_HD int pk_share_width(int L, int R) {
    const int s = (L + R - 1) / R;
    int w = PK_SHARE_ALIGN;
    while (w < s)
        w <<= 1;
    return w;
}

// R for B reads of L columns on a card of `sms` SMs: the largest power of
// two up to PK_MAX_RANKS with B * R <= sms (at most a CTA for each SM:
// the card's time goes to each SM's whole share of the work once every SM
// has one, and a wider cluster only adds its barriers), at least the
// ranks that shares of PK_MAX_SHARE need, and no rank past the row's end
PK_HD int pk_default_ranks(int L, int B, int sms) {
    int r = 1;
    while (r < PK_MAX_RANKS && (long long)B * r * 2 <= sms)
        r <<= 1;
    const int least = (L + PK_MAX_SHARE - 1) / PK_MAX_SHARE;
    r = r < least ? least : r;
    const int S = pk_share_width(L, r);
    return (L + S - 1) / S;
}

// w: the columns of share r that lie in the row
PK_HD int pk_share_cols(int L, int S, int r) {
    const long long left = (long long)L - (long long)r * S;
    return left <= 0 ? 0 : (left < S ? (int)left : S);
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

// Whether pass p counts a key of the share, kneg = pk_key(NEG_F) the key
// of every column past the read: pass 0 takes every other key; a later
// pass the keys of its group, which never holds kneg (the group's first
// digit is the median's, and every key of the read's values, x > NEG_F /
// 2, has a first digit of at least pk_digit(pk_key(NEG_F / 2), 0) = 1,
// against kneg's 0).
PK_HD bool pk_counted(uint32_t key, uint32_t prefix, int p, uint32_t kneg) {
    return p ? pk_in_group(key, prefix, p) : key != kneg;
}

// A rank's histogram of a pass, kept as 32 copies, one for each lane, so
// that the 32 lanes of a warp never add to the same word: copy `lane` of
// bin d sits at d * 32 + lane, in bank `lane`.
constexpr int PK_REP_WORDS = PK_BINS * 32;

PK_HD int pk_rep_word(int d, int lane) { return d * 32 + lane; }

// The fold of the copies into bins: thread t (t < PK_BINS) sums bin t's
// 32 copies, the q-th at lane pk_rep_lane(t, q), which puts a warp's 32
// reads of one q on 32 banks.
PK_HD int pk_rep_lane(int t, int q) { return (q + t) & 31; }

// The merge of the ranks' histograms: rank q's enters the sum of every
// rank (each rank sums the R histograms itself, over the cluster's
// shared memory, and all make the same pick).
PK_HD bool pk_merges(int q, int R) {
#ifdef PEAKS_MUTANT_MERGE
    return q < R - 1;  // the last rank's histogram dropped (must disagree)
#else
    return q < R;
#endif
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

// ---- the columns ----

// xm(j) of a row of L columns of which n are the read's
PK_HD float pk_xm(const float* row, int j, int n) {
    return (j >= 0 && j < n) ? row[j] : PK_NEG_F;
}

// The kernel holds a column as its key, k(j) = pk_key(xm(j)): in the
// domain (no NaN, no -0.0) k(i) < k(j) exactly when xm(i) < xm(j), and
// k(i) == k(j) exactly when xm(i) == xm(j), and pk_unkey gives back the
// float's bits; so the run starts and the skip test compare keys, and
// only a column that passes the skip test is turned back into a float.

// column j's run start from its key and the key before it, packed (j << 1
// | rise into it), or -1
PK_HD int pk_start(int j, uint32_t k, uint32_t kprev) {
    return k != kprev ? (j << 1) | (k > kprev ? 1 : 0) : -1;
}

// The latest run start among the columns [c0, c0 + w) of a row, where
// every column from n on is NEG_F: a start at n (xm(n - 1) > NEG_F / 2 >
// NEG_F, so no rise) when n lies among them, none after it, so the latest
// is that one; else the latest among [c0, c0 + pk_valid_cols(c0, w, n)),
// found from the right (the first start found is the latest; the device
// takes 32 columns a step, the host driver the same lanes in turn).
PK_HD int pk_start_at_n(int c0, int w, int n) {
    return (n >= 1 && c0 <= n && n < c0 + w) ? n << 1 : -1;
}

PK_HD int pk_valid_cols(int c0, int w, int n) {
    const int e = n - c0;
    return e <= 0 ? 0 : (e < w ? e : w);
}

// the latest-run-start combine: starts grow with j, so the latest of two
// is the larger (associative and commutative: any scan order)
PK_HD int pk_latest(int a, int b) { return a > b ? a : b; }

// The carry into share r: the latest run start of the ranks below it
// (each rank publishes the latest start among its columns; the latest of
// those of ranks 0 .. r - 1 is the latest start before the share, however
// many shares a plateau spans).
PK_HD bool pk_carries(int q, int r) {
#ifdef PEAKS_MUTANT_CARRY
    return q == r - 1;  // the left neighbour alone (must disagree)
#else
    return q < r;
#endif
}

// The skip test.  A column j matters only through ok(j), near_struct(j)
// (both need xm(j) >= height) or near_h(j) (needs xm(j) > 0 and
// near(xm(j), height)).  So every column with xm(j) < pk_matter_floor
// (height) leaves every output as it is, and pays no candidate or margin
// arithmetic; why near_h needs no column below the floor:
// - height <= 0 (or NaN, n = 0: every comparison is false): with xm > 0,
//   |xm - height| rounds to at least m = max(|xm|, |height|) > 0, and
//   MARGIN_REL * m to less than m, so near(xm, height) is false; the
//   floor is height itself.
// - height >= 1e-30 (a normal float, its products rounded to a relative
//   2^-24): a column 0 < xm < floor = 0.999f * height has height - xm >
//   0.00099 * height, so |xm - height| > 0.00098 * height against
//   MARGIN_REL * height < 0.00011 * height: near is false.
// - 0 < height < 1e-30: the floor is 0, below every xm > 0.
PK_HD float pk_matter_floor(float height) {
#ifdef PEAKS_MUTANT_SKIP
    return height;  // skips the near-height columns below it (must disagree)
#else
    return height > 0.0f ? (height >= 1e-30f ? pk_mul(height, 0.999f) : 0.0f)
                         : height;
#endif
}

// A bound b as a key: pk_key(x) >= pk_cut_key(b) exactly when x >= b, for
// every x of the domain (b = -0.0 has the key below +0.0's, so every x >=
// 0 passes, as in floats; a NaN bound, n = 0, passes none: no finite
// float's key reaches 0xffffffff).
PK_HD uint32_t pk_cut_key(float cut) {
    return cut == cut ? pk_key(cut) : 0xffffffffu;
}

PK_HD bool pk_may_matter(uint32_t k, uint32_t cut_key) { return k >= cut_key; }

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

// a slot's (cand_h, cand_pos): (NEG_F, -1) for no entry
PK_HD void pk_slot(uint64_t e, float* h, int* pos) {
    *h = e ? pk_unkey((uint32_t)(e >> 32)) : PK_NEG_F;
    *pos = e ? pk_mid_of((uint32_t)e) : -1;
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
// max(c, min(b, x)); inserting 0 changes nothing
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

// ---- shared memory of a CTA ----

// The share's keys in shared memory, four to a 16-byte chunk, chunk c of
// the share (columns 4c .. 4c + 3) at chunk c ^ ((c >> 3) & 1): a
// bijection of each aligned block of 16 chunks.  A lane's 8 columns in a
// warp's step are two chunks, 2l and 2l + 1 from a multiple of 64, and
// the 8 lanes of a quarter warp then land on 8 different chunks modulo 8,
// so on all 32 banks (without the swap they would share 4).  The sweeps
// of the median read the chunks in order.
PK_HD int pk_chunk_at(int c) { return c ^ ((c >> 3) & 1); }

PK_HD int pk_key_at(int i) { return (pk_chunk_at(i >> 2) << 2) | (i & 3); }

// the key of share column i (i = -1: the column before the share)
PK_HD uint32_t pk_share_key(const uint32_t* xs, uint32_t left, int i) {
    return i < 0 ? left : xs[pk_key_at(i)];
}

// the chunks a sweep reads to meet the share's first wn columns: whole
// blocks of 16 chunks (64 columns)
PK_HD int pk_sweep_chunks(int wn) { return ((wn + 63) >> 6) << 4; }

// The dynamic shared memory of a CTA of a cluster of R ranks whose share
// is S columns wide, in 32-bit words: the share's keys (first, so that its
// chunks are 16-byte aligned); the histogram's lane copies; the inbox,
// where every rank stores its histogram of a pass (two consecutive passes
// kept apart); the merged histogram; the scalars every rank stores into
// every other's (PK_PUB_WORDS a rank: its max key, latest start, least key
// above the first median key, flags); the warps' scratch; and the keys of
// the columns either side of the share.
struct PkSmem {
    int xs, rep, inbox, hg, pub, scratch, halo, words;
};

constexpr int PK_PUB_WORDS = 4;
constexpr int PK_SCRATCH_WORDS = 3 * PK_WARPS;

PK_HD PkSmem pk_smem(int S, int R) {
    PkSmem m;
    m.xs = 0;
    m.rep = m.xs + S;
    m.inbox = m.rep + PK_REP_WORDS;
    m.hg = m.inbox + 2 * R * PK_BINS;
    m.pub = m.hg + PK_BINS;
    m.scratch = m.pub + PK_PUB_WORDS * R;
    m.halo = m.scratch + PK_SCRATCH_WORDS;
    m.words = m.halo + 2;
    return m;
}

PK_HD int pk_smem_bytes(int S, int R) { return 4 * pk_smem(S, R).words; }

// ---- the columns of a warp ----

// Warp w of a CTA owns the segment of S / PK_WARPS consecutive columns of
// the share from wseg0 = w * S / PK_WARPS (a multiple of PK_STEP), and goes
// over it a step of PK_STEP columns at a time, PK_COLS consecutive columns
// a lane.  A lane's keys sit in v[0 .. PK_WINDOW): v[r + PK_LEFT] = k(j0 +
// r), with the column before and the one after; `live` of them are the
// share's (live may be <= 0 or > PK_COLS).  The unrolled column index is a
// constant, so on the device v and the entries stay in registers.

// the latest run start among a lane's columns, or -1
PK_HD int pk_thread_latest(const uint32_t* v, int j0, int live) {
    int own = -1;
    PK_UNROLL
    for (int r = 0; r < PK_COLS; ++r)
        if (r < live)
            own = pk_latest(own, pk_start(j0 + r, v[r + PK_LEFT],
                                          v[r + PK_LEFT - 1]));
    return own;
}

// a read's scalars for its columns: the height, the gate and the
// structure tolerance; the skip test's cut, the height and NEG_F / 2 as
// keys (pk_cut_key: a NaN height, n = 0, as no key)
struct PkRead {
    float height, tol;
    bool gated;
    uint32_t cut, kh, khalf;
};

PK_HD PkRead pk_read(const PkGate& g) {
    return PkRead{g.height, g.tol, g.gated,
                  pk_cut_key(pk_matter_floor(g.height)),
                  pk_cut_key(g.height), pk_key(PK_NEG_HALF)};
}

// whether one of the lane's columns passes the skip test (its warp takes
// the slow path when one of its lanes' does)
PK_HD bool pk_thread_may(const uint32_t* v, int live, uint32_t cut) {
    bool may = false;
    PK_UNROLL
    for (int r = 0; r < PK_COLS; ++r)
        may = may || (r < live && pk_may_matter(v[r + PK_LEFT], cut));
    return may;
}

// What column j contributes where it passes the skip test: k = k(j), kn =
// k(j + 1), run = run(j).  The definition's (header) ok, near_h and
// near_struct, on keys where it compares: xm(j) >= height exactly when k
// >= kh, xm(j + 1) > NEG_F / 2 exactly when kn > khalf, xm(j + 1) < xm(j)
// exactly when kn < k; a peak's candidate (xm(j), (l + j) / 2) is the
// entry (k << 32 | mid code) into the tile's three (its unsigned order is
// (xm, mid)'s, ties to the largest mid); the float arithmetic only for a
// peak (near_h) and for a pair at or above the height (near_struct).
PK_HD void pk_column(int j, int n, int run, uint32_t k, uint32_t kn,
                     const PkRead& rd, PkTop3& top, bool& margin) {
    const int l = run >> 1;
    const bool above = k >= rd.kh;
    if ((run & 1) == 1 && l >= 1 && kn < k && j <= n - 2) {
        if (above && !rd.gated)
            top = pk_top3_insert(top, ((uint64_t)k << 32) |
                                          pk_mid_code((l + j) >> 1));
        const float xm = pk_unkey(k);
        margin = margin || (xm > 0.0f && pk_near(xm, rd.height));
    }
    if (above && kn >= rd.kh && kn > rd.khalf && j < n)
        margin = margin ||
                 fabsf(pk_sub(pk_unkey(kn), pk_unkey(k))) <= rd.tol;
}

// What a lane's columns leave: the top three of its tile when a tile is
// wider than PK_COLS (for the butterfly), and whether one of its tiles
// holds a third entry or one of its columns sets the margin.
struct PkThread {
    PkTop3 top;
    bool third, margin;
};

// The lane's columns from `run`, the latest start before them: each
// column's start, and for a column that passes the skip test its part
// (pk_column); a tile of at most PK_COLS columns (tile | PK_COLS) ends at
// the lane's column r when tile divides r + 1, and is written there.
PK_HD PkThread pk_thread(const uint32_t* v, int j0, int live, int n,
                         int run, const PkRead& rd, int tile, int M,
                         int32_t* pos, float* hs) {
    PkThread o{PkTop3{0, 0, 0}, false, false};
    PK_UNROLL
    for (int r = 0; r < PK_COLS; ++r) {
        if (r < live) {
            const uint32_t k = v[r + PK_LEFT];
            run = pk_latest(run, pk_start(j0 + r, k, v[r + PK_LEFT - 1]));
            if (pk_may_matter(k, rd.cut))
                pk_column(j0 + r, n, run, k, v[r + PK_LEFT + 1], rd, o.top,
                          o.margin);
        }
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

// The same lane where no column of its warp's step passes the skip test:
// every tile of the step is empty, so it writes its tiles of at most
// PK_COLS columns empty (a wider tile is written by its first lane, as
// after the butterfly), and flags nothing.
PK_HD void pk_thread_empty(int j0, int live, int tile, int M, int32_t* pos,
                           float* hs) {
    const PkTop3 none{0, 0, 0};
    if (tile <= PK_COLS) {
        for (int first = 0; first < PK_COLS && first < live; first += tile)
            pk_write_tile(pos, hs, M, (j0 + first) / tile, none);
    } else if (live > 0 && j0 % tile == 0) {
        pk_write_tile(pos, hs, M, j0 / tile, none);
    }
}
