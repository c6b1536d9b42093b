/* Scalar-C banded semiglobal affine DP (forward scores only).
 *
 * Purpose: quantify the Python/numpy penalty of the CPU proxy baseline
 * (BENCHMARKS.md "baseline bias"): the reference outsources its inner
 * alignment loops to SIMD C tools (abPOA/racon/conk), so the honest
 * bound on "what reference-grade C would do on this machine" is this
 * routine's cells/s versus ref/banded.py's numpy rows on identical
 * inputs.  The recurrence and band placement mirror ref/banded.py
 * (textbook F-recurrence, score-equivalent per its module docstring);
 * scores must match banded_align exactly (tests/test_native.py).
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

#define NEG (-((int64_t)1 << 40))

static int64_t band_lo(int64_t i, int64_t nq, int64_t nt, int64_t band) {
    /* float32 band placement, matching ref/banded.band_starts (rintf =
     * round-half-to-even, numpy's rounding) */
    float ctr_f = rintf((float)i * (float)nt / (float)(nq > 0 ? nq : 1));
    int64_t hi = nt + 1 - band > 0 ? nt + 1 - band : 0;
    int64_t lo = (int64_t)ctr_f - band / 2;
    if (lo < 0) lo = 0;
    if (lo > hi) lo = hi;
    return lo;
}

/* q, t: int8 codes (4 = N, scores 0).  Hp/Ep/H/E: caller work arrays of
 * nt+1 int64 each (contents ignored).  Returns best H[nq][j];
 * *j_end_out = smallest argmax (ref tie rule). */
int64_t c3_dp_score(const int8_t *q, int64_t nq, const int8_t *t, int64_t nt,
                    int64_t match, int64_t mismatch, int64_t gap_open,
                    int64_t gap_ext, int64_t band,
                    int64_t *Hp, int64_t *Ep, int64_t *H, int64_t *E,
                    int64_t *j_end_out) {
    const int64_t oe = gap_open + gap_ext, e = gap_ext;

    /* invariant: outside each buffer's recorded window the cells are NEG */
    int64_t lo0 = band_lo(0, nq, nt, band);
    int64_t end0 = lo0 + band;
    if (end0 > nt + 1) end0 = nt + 1;
    for (int64_t j = 0; j <= nt; j++) {
        Hp[j] = (j >= lo0 && j < end0) ? 0 : NEG;
        Ep[j] = NEG;
        H[j] = NEG;
        E[j] = NEG;
    }
    int64_t win_lo[2] = {lo0, 0}, win_end[2] = {end0, 0};
    /* parity 0 = the buffer currently in Hp/Ep, parity 1 = in H/E */

    for (int64_t i = 1; i <= nq; i++) {
        int64_t lo = band_lo(i, nq, nt, band);
        int64_t end = lo + band;
        if (end > nt + 1) end = nt + 1;

        /* clear this buffer's stale cells not covered by the new window */
        int64_t plo = win_lo[1], pend = win_end[1];
        for (int64_t j = plo; j < pend; j++) {
            if (j < lo || j >= end) {
                H[j] = NEG;
                E[j] = NEG;
            }
        }
        win_lo[1] = lo;
        win_end[1] = end;

        const int8_t qc = q[i - 1];
        /* F-gap chains are clipped at the band edge (the spec:
         * ref/banded.py row comment) — F starts NEG at j = lo */
        int64_t js = lo;
        int64_t F = NEG;
        int64_t Hleft = NEG;              /* H[i][j-1], NEG left of band */
        for (int64_t j = js; j < end; j++) {
            int64_t Ev = Hp[j] - oe;
            int64_t Ee = Ep[j] - e;
            if (Ee > Ev) Ev = Ee;
            int64_t h = Ev;
            if (j > 0) {
                const int8_t tc = t[j - 1];
                int64_t s = (qc == 4 || tc == 4) ? 0
                            : (qc == tc ? match : mismatch);
                int64_t diag = Hp[j - 1] + s;
                if (diag > h) h = diag;
                int64_t Fo = Hleft - oe;  /* textbook: opens from full H */
                int64_t Fe = F - e;
                F = Fo > Fe ? Fo : Fe;
                if (F > h) h = F;
            }
            if (j >= lo) {
                H[j] = h;
                E[j] = Ev;
            }
            Hleft = h;
        }

        /* swap row buffers (and their window records) */
        int64_t *tmp;
        tmp = Hp; Hp = H; H = tmp;
        tmp = Ep; Ep = E; E = tmp;
        int64_t ti;
        ti = win_lo[0]; win_lo[0] = win_lo[1]; win_lo[1] = ti;
        ti = win_end[0]; win_end[0] = win_end[1]; win_end[1] = ti;
    }

    int64_t best = NEG, j_end = 0;
    for (int64_t j = 0; j <= nt; j++) {
        if (Hp[j] > best) {
            best = Hp[j];
            j_end = j;
        }
    }
    if (j_end_out) *j_end_out = j_end;
    return best;
}
