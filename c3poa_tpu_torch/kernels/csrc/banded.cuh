// Per-row, per-cell and per-step arithmetic of the banded aligner's
// forward kernel and walk (csrc/banded.cu), written once for the device
// and the host: a g++ build of tests/banded_host_driver.cpp over this
// header runs whole alignments lane by lane and whole walks in the CPU
// tests and holds them to the plain torch versions bit for bit.
//
// Forward, one row of a lane's CPL consecutive band columns (k = k0 + c),
// from the previous row shifted to this row's columns (Hp, Ep at the same
// target column, Hd one to its left):
//   En = max(Hp - oe, Ep - e)      D = Hd + sub      Ht = max(D, En)
//   a  = Ht + e*k                  F' = max_{u<k} a[u] - gap_open
//   H  = max(Ht, F' - e*k)         (F' is F + e*k: the in-row gap run as a
//                                   prefix max, which the warp scans)
// The move nibble is built from signs of differences, one funnel shift a
// bit (bnd_push), never from compares and selects:
//   bit 0  source is E    sign((D - H) ^ (a - F'))
//   bit 1  source is F    sign(a - F')              = Ht < F
//   bit 2  E extends      sign(Hp - Ep - gap_open)  = Ep - e > Hp - oe
//   bit 3  F extends      sign(a[k-1] - F'[k-1] - gap_open), 0 at k = 0
// which are the plain version's rules: the diagonal wins ties over E, E
// over F (D == H exactly when D >= En and D >= F; F is the source exactly
// when F > max(D, En)).  Bits are pushed in order into a word whose bit
// reversal (bnd_moves_word) is the move word of 8 rows.
//
// Substitution scores without a compare: targets are staged as 4-bit
// codes with one pad slot on the left (slot j holds target j - 1; slot 0
// and the slots past the target hold 4), a lane's codes for a row are 16
// bits of that string, and one byte permute with those nibbles as its
// selector picks each cell's score out of the row's table (byte t: the
// score of target code t against this row's query code; selector 4 picks
// a zero byte of the second operand: N scores 0, and so does a query N,
// whose table is 0).  dp4a with a one-hot byte adds a cell's score to Hd.
#pragma once

#include <stdint.h>

#include "band_lo.cuh"

#ifdef __CUDACC__
#define BND_HD __host__ __device__ __forceinline__
#else
#define BND_HD inline
#endif

constexpr int32_t BND_NEG = -(1 << 28);
// staged target slots beyond the widest index a row reads, in 32-bit
// words of 8 slots: see bnd_target_words
constexpr int BND_SLOTS_PER_WORD = 8;

// ---- twins of the device intrinsics -----------------------------------
// max(a + b, c)
BND_HD int32_t bnd_addmax(int32_t a, int32_t b, int32_t c) {
#ifdef __CUDA_ARCH__
    return __viaddmax_s32(a, b, c);
#else
    const int32_t s = a + b;
    return s > c ? s : c;
#endif
}

BND_HD int32_t bnd_max(int32_t a, int32_t b) {
#ifdef __CUDA_ARCH__
    return max(a, b);
#else
    return a > b ? a : b;
#endif
}

BND_HD int32_t bnd_min(int32_t a, int32_t b) {
#ifdef __CUDA_ARCH__
    return min(a, b);
#else
    return a < b ? a : b;
#endif
}

// byte permute, selector nibbles 0..7 (bytes of a, then of b)
BND_HD uint32_t bnd_perm(uint32_t a, uint32_t b, uint32_t sel) {
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

// c + the dot product of the signed bytes of a and b
BND_HD int32_t bnd_dp4a(uint32_t a, uint32_t b, int32_t c) {
#ifdef __CUDA_ARCH__
    return __dp4a((int)a, (int)b, c);
#else
    for (int n = 0; n < 4; ++n)
        c += (int32_t)(int8_t)(a >> (8 * n)) * (int32_t)(int8_t)(b >> (8 * n));
    return c;
#endif
}

// (acc << 1) | (d < 0)
BND_HD uint32_t bnd_push(uint32_t acc, int32_t d) {
#ifdef __CUDA_ARCH__
    return __funnelshift_l((uint32_t)d, acc, 1);
#else
    return (acc << 1) | ((uint32_t)d >> 31);
#endif
}

BND_HD uint32_t bnd_brev(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __brev(x);
#else
    uint32_t r = 0;
    for (int n = 0; n < 32; ++n) r |= ((x >> n) & 1u) << (31 - n);
    return r;
#endif
}

// low 32 bits of (hi:lo) >> sh, sh in [0, 31]
BND_HD uint32_t bnd_funnel_r(uint32_t lo, uint32_t hi, uint32_t sh) {
#ifdef __CUDA_ARCH__
    return __funnelshift_r(lo, hi, sh);
#else
    return (uint32_t)((((uint64_t)hi << 32) | lo) >> (sh & 31));
#endif
}

// ---- forward: targets and substitution --------------------------------
// 32-bit words of staged target slots a pair needs: rows read 8 slots
// from slot lo(i) + k0 on, at most max(tl + 1, W) - 1, out of two words
BND_HD int bnd_target_words(int nt, int W) {
    const int top = nt + 1 > W ? nt + 1 : W;
    return top / BND_SLOTS_PER_WORD + 2;
}

// word w of the staged target: slots 8w .. 8w + 7, 4 bits each
BND_HD uint32_t bnd_target_word(const int8_t* trow, int32_t tl, int w) {
    uint32_t x = 0;
    for (int u = 0; u < BND_SLOTS_PER_WORD; ++u) {
        const int32_t j = BND_SLOTS_PER_WORD * w + u;
        const uint32_t code = (j >= 1 && j <= tl) ? (uint32_t)trow[j - 1] : 4u;
        x |= (code & 0xFu) << (4 * u);
    }
    return x;
}

// the 8 slots from slot n0 on
BND_HD uint32_t bnd_target_window(const uint32_t* ts, int32_t n0) {
    const int w = n0 >> 3;
    return bnd_funnel_r(ts[w], ts[w + 1], 4u * (uint32_t)(n0 & 7));
}

// a row's table: byte t = score of target code t (0..3) against qc
BND_HD uint32_t bnd_sub_table(int qc, int match, int mismatch) {
    if (qc < 0 || qc > 3) return 0u;
    const uint32_t mm = (uint32_t)(mismatch & 0xFF) * 0x01010101u;
    return mm ^ ((uint32_t)((match ^ mismatch) & 0xFF) << (8 * qc));
}

// the scores of 4 cells (bytes), from the low 4 nibbles of ``window``
BND_HD uint32_t bnd_subs4(uint32_t table, uint32_t window) {
    return bnd_perm(table, 0u, window & 0xFFFFu);
}

// ---- forward: one lane's row, in three phases between the warp's
// shuffles ---------------------------------------------------------------
template <int CPL>
struct BndRow {
    int32_t En[CPL], D[CPL], Ht[CPL], a[CPL], pm[CPL], de[CPL];
    int32_t Fp[CPL], Hn[CPL], b[CPL];
};

// phase 1: E, the diagonal, their max, and the lane's running maxima of
// a = Ht + e*k.  ek[c] = e * (k0 + c); window: bnd_target_window at the
// lane's first column.  pm[CPL - 1] goes into the warp's scan.
template <int CPL>
BND_HD void bnd_row_open(const int32_t (&Hp)[CPL], const int32_t (&Ep)[CPL],
                         const int32_t (&Hd)[CPL], uint32_t table,
                         uint32_t window, const int32_t (&ek)[CPL],
                         int32_t oe, int32_t e, int32_t go,
                         BndRow<CPL>& r) {
    uint32_t subs = 0;
#ifdef __CUDA_ARCH__
    #pragma unroll
#endif
    for (int c = 0; c < CPL; ++c) {
        if ((c & 3) == 0) subs = bnd_subs4(table, window >> (4 * c));
        r.En[c] = bnd_addmax(Hp[c], -oe, Ep[c] - e);
        r.de[c] = Hp[c] - Ep[c] - go;
        r.D[c] = bnd_dp4a(subs, 1u << (8 * (c & 3)), Hd[c]);
        r.Ht[c] = bnd_max(r.D[c], r.En[c]);
        r.a[c] = r.Ht[c] + ek[c];
        r.pm[c] = c ? bnd_max(r.pm[c - 1], r.a[c]) : r.a[c];
    }
}

// phase 2: ex = the scan's exclusive result (max of a over every column
// left of this lane, BND_NEG in lane 0).  b[CPL - 1] goes to the next lane.
template <int CPL>
BND_HD void bnd_row_gap(int32_t ex, const int32_t (&ek)[CPL], int32_t go,
                        BndRow<CPL>& r) {
    const int32_t exg = ex - go;
#ifdef __CUDA_ARCH__
    #pragma unroll
#endif
    for (int c = 0; c < CPL; ++c) {
        r.Fp[c] = c ? bnd_addmax(r.pm[c - 1], -go, exg) : exg;
        r.Hn[c] = bnd_addmax(r.Fp[c], -ek[c], r.Ht[c]);
        r.b[c] = r.a[c] - r.Fp[c];
    }
}

// phase 3: push the row's move nibbles.  bl = the previous lane's
// b[CPL - 1]; first = this is band column 0 (F cannot extend into it).
template <int CPL>
BND_HD void bnd_row_moves(const BndRow<CPL>& r, int32_t bl, bool first,
                          int32_t go, uint32_t (&acc)[CPL]) {
#ifdef __CUDA_ARCH__
    #pragma unroll
#endif
    for (int c = 0; c < CPL; ++c) {
        const int32_t fw = c ? r.b[c - 1] - go : (first ? 0 : bl - go);
        uint32_t x = acc[c];
        x = bnd_push(x, (r.D[c] - r.Hn[c]) ^ r.b[c]);
        x = bnd_push(x, r.b[c]);
        x = bnd_push(x, r.de[c]);
        acc[c] = bnd_push(x, fw);
    }
}

// the move word of ``rows`` (1..8) pushed rows: row u's nibble at bits
// 4u .. 4u + 3, zero above
BND_HD uint32_t bnd_moves_word(uint32_t acc, int rows) {
    return bnd_brev(acc) >> (32 - 4 * rows);
}

// ---- walk ---------------------------------------------------------------
struct BndWalk {
    int32_t i, j;
    int st;          // 0 none, 1 inside an E run, 2 inside an F run
    int step;
    uint32_t emin;   // 0 once the path has touched an interior band edge
    uint32_t cur;    // the last 16 steps' sources, 2 bits each, newest on top
};

BND_HD void bnd_walk_init(BndWalk& s, int32_t ql, int32_t jend) {
    s.i = ql; s.j = jend; s.st = 0; s.step = 0; s.emin = 0xffffffffu;
    s.cur = 0;
}

BND_HD uint32_t bnd_umin(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    return min(a, b);
#else
    return a < b ? a : b;
#endif
}

// 16 sources (0 diagonal, 1 E, 2 F, 3 none) -> 16 ops (1 diagonal, 2
// insertion, 3 deletion; 3 for no move, as the plain version writes)
BND_HD uint32_t bnd_ops_word(uint32_t src) {
    const uint32_t none = src & (src >> 1) & 0x55555555u;
    return src - none + 0x55555555u;
}

// DP rows a call of bnd_walk_chunk covers: 4 row groups of move words
constexpr int BND_WALK_ROWS = 32;

// The walk's state inside a chunk: the row as r4 = 4 * (row in the
// chunk), whose low 5 bits are the nibble's shift and whose upper bits
// the row group (negative: the path has left the chunk upwards); lo of
// the row; the masks that make the effective source from the nibble.
struct BndStep {
    int r4;
    int32_t lo_i;
    uint32_t f_or, f_and;
};

// One step.  It is arithmetic on the nibble without a branch, because the
// walk is one dependent chain and on an in-order core whatever a step
// waits for delays the next: the effective source eff = st ? st : source
// (one logic op with masks kept from the step before) is 0 diagonal, 1 E,
// 2 F (3: no move, never written by the forward pass); E and the diagonal
// go up a row (eff < 2), F and the diagonal go left (eff even); the run
// goes on when the nibble's extend bit of that source (bit eff + 1) is
// set.  The band-edge rule (column 0 with columns cut off to its left, or
// W - 1 with columns beyond it; rlim = tl - W) is a running minimum that
// reaches 0 on such a cell.
BND_HD void bnd_walk_step(const uint32_t* buf, const int32_t* lo, int W,
                          int32_t wm1, int32_t rlim, BndStep& t,
                          BndWalk& s) {
    constexpr int RMASK = 4 * (BND_WALK_ROWS - 1);      // 124
    const int32_t lo_up = lo[((t.r4 + RMASK) & RMASK) >> 2];
    const int32_t k = s.j - t.lo_i;
    const uint32_t el = (uint32_t)k | (t.lo_i > 0 ? 0u : 1u);
    const uint32_t er = (uint32_t)(k ^ wm1) | (t.lo_i <= rlim ? 0u : 1u);
    s.emin = bnd_umin(s.emin, bnd_umin(el, er));
    const int32_t kc = bnd_max(bnd_min(k, wm1), 0);
    const uint32_t mv = buf[(t.r4 >> 5) * W + kc] >> (t.r4 & 31);
    const uint32_t eff = (mv & t.f_and) | t.f_or;
    const uint32_t x = ((mv & 0xFu) >> eff) & 2u;
    const uint32_t run = x | (x >> 1);     // 3: the source's run goes on
    t.f_or = eff & run;
    t.f_and = 3u & ~run;
    const bool up = eff < 2u;
    s.j -= (int32_t)((eff & 1u) ^ 1u);
    t.lo_i = up ? lo_up : t.lo_i;
    t.r4 -= up ? 4 : 0;
    s.cur = bnd_funnel_r(s.cur, eff, 2);   // (cur >> 2) | (eff << 30)
}

// Walk the rows of one chunk of 32 DP rows (rows 32c + 1 .. 32c + 32):
// buf = the chunk's 4 row groups of W move words, lo[u] = lo(32c + 1 + u).
// Returns when the path leaves the chunk upwards (or reaches row 0) or the
// step budget is spent.  ``writer`` stores the full words of ops (one lane
// of the pair's).  Steps run two to a loop iteration and one word of ops
// (16 steps) to an outer iteration, so that a step meets one taken branch
// in two and the store of a word sits outside the step loop.
BND_HD void bnd_walk_chunk(const uint32_t* buf, const int32_t* lo, int W,
                           int32_t tl, int n_steps, bool writer,
                           uint32_t* orow, BndWalk& s) {
    const int32_t wm1 = W - 1, rlim = tl - W;
    const int32_t i0 = (s.i - 1) & ~(BND_WALK_ROWS - 1);    // rows before
    BndStep t;
    t.r4 = 4 * ((s.i - 1) & (BND_WALK_ROWS - 1));
    t.lo_i = lo[t.r4 >> 2];
    t.f_or = (uint32_t)s.st;
    t.f_and = s.st ? 0u : 3u;
    for (;;) {
        const int room = 16 - (s.step & 15), budget = n_steps - s.step;
        const int planned = room < budget ? room : budget;     // >= 1
        int left = planned;
        for (;;) {
            bnd_walk_step(buf, lo, W, wm1, rlim, t, s);
            --left;
            if ((t.r4 | (left - 1)) < 0) break;     // r4 < 0 or left == 0
            bnd_walk_step(buf, lo, W, wm1, rlim, t, s);
            --left;
            if ((t.r4 | (left - 1)) < 0) break;
        }
        s.step += planned - left;
        if ((s.step & 15) == 0 && writer)
            orow[(s.step >> 4) - 1] = bnd_ops_word(s.cur);
        if (t.r4 < 0 || s.step >= n_steps) break;
    }
    s.i = i0 + (t.r4 >> 2) + 1;
    s.st = (int)t.f_or;
}

// the last, partial word of ops after ``step`` steps (step % 16 != 0)
BND_HD uint32_t bnd_walk_tail(uint32_t cur, int step) {
    return bnd_ops_word(cur) >> (32 - 2 * (step & 15));
}
