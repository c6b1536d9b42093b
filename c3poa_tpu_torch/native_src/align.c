/* Scalar-C banded semiglobal affine forward WITH band-local move bytes.
 *
 * This is the C-grade CPU aligner wired into NumpyBackend.align_many
 * (pipeline/backend.py): together with c3_traceback + c3_normalize
 * (traceback.c) it replaces the numpy rows of ref/banded.py at scalar-C
 * speed, making the recorded CPU proxy baseline honest against the
 * reference's SIMD C tools (abPOA/racon/conk — SURVEY.md §2.2).  The
 * forward-only twin (dpbench.c:c3_dp_score, textbook F recurrence) stays
 * as the microbenchmark.
 *
 * Recurrence and tie rules mirror ref/banded.py:banded_align exactly:
 *   E[j]  = max(Hp[j] - oe, Ep[j] - e);  eext = (Ep[j]-e) > (Hp[j]-oe)
 *   diag  = Hp[j-1] + s(q[i-1], t[j-1])             (NEG at j == 0)
 *   Ht[j] = max(diag, E[j])
 *   F[j]  = max(Ht[j-1] - oe, F[j-1] - e)           (Ht-opening: exact
 *           for open >= 0);  fext = (F[j-1]-e) > (Ht[j-1]-oe)
 *   H[j]  = max(Ht[j], F[j])
 *   src: diag on (diag >= E && diag >= F), else E on (E >= F), else F.
 * Band row i covers [lo(i), lo(i)+W); out-of-band cells are NEG.  F may
 * enter the band from columns of the previous row's band left of lo(i)
 * ("virtual" columns: computed, not stored) — real scores can only
 * originate at j >= lo(i-1), so the walk starts there.  NEG-derived
 * arithmetic in unreachable cells may differ from numpy's by small
 * constants; the traceback path only visits real-valued cells, so the
 * emitted record is bit-identical (tests/test_native.py).
 */

#include <stdint.h>
#include <string.h>

#define NEG_A (-((int64_t)1 << 40))

/* must equal traceback.c:band_lo / ref.banded.band_starts (float32
 * rint = round-half-to-even) */
static int64_t band_lo_a(int64_t i, int64_t nq, int64_t nt, int64_t band) {
    float ctr_f = __builtin_rintf((float)i * (float)nt /
                                  (float)(nq > 0 ? nq : 1));
    int64_t hi = nt + 1 - band > 0 ? nt + 1 - band : 0;
    int64_t lo = (int64_t)ctr_f - band / 2;
    if (lo < 0) lo = 0;
    if (lo > hi) lo = hi;
    return lo;
}

/* moves: (nq, W) row-major band-local out (row r = DP row r+1), layout
 * consumed by c3_traceback.  work: caller scratch of 4*(nt+1) int64.
 * Returns the semiglobal score (NEG_A if the final row is unreachable —
 * cannot happen when nt <= 3*nq, which the consensus engine guarantees);
 * *j_end_out = smallest argmax column of the final row. */
int64_t c3_align_moves(const int8_t *q, int32_t nq, const int8_t *t,
                       int32_t nt, int64_t match, int64_t mismatch,
                       int64_t gap_open, int64_t gap_ext, int32_t W,
                       uint8_t *moves, int64_t *work, int32_t *j_end_out) {
    const int64_t oe = gap_open + gap_ext, e = gap_ext;
    int64_t *Hp = work, *Ep = work + (nt + 1);
    int64_t *Hn = Ep + (nt + 1), *En = Hn + (nt + 1);

    memset(moves, 0, (size_t)nq * (size_t)W);

    int64_t lo0 = band_lo_a(0, nq, nt, W);
    int64_t end0 = lo0 + W;
    if (end0 > nt + 1) end0 = nt + 1;
    for (int64_t j = 0; j <= nt; j++) {
        Hp[j] = (j >= lo0 && j < end0) ? 0 : NEG_A;
        Ep[j] = NEG_A;
        Hn[j] = NEG_A;
        En[j] = NEG_A;
    }
    /* window invariant: outside [win_lo, win_end) each buffer holds NEG */
    int64_t win_lo[2] = {lo0, 0}, win_end[2] = {end0, 0};

    for (int64_t i = 1; i <= nq; i++) {
        int64_t lo = band_lo_a(i, nq, nt, W);
        int64_t end = lo + W;
        if (end > nt + 1) end = nt + 1;

        /* clear this row buffer's stale cells outside the new window */
        for (int64_t j = win_lo[1]; j < win_end[1]; j++) {
            if (j < lo || j >= end) {
                Hn[j] = NEG_A;
                En[j] = NEG_A;
            }
        }
        win_lo[1] = lo;
        win_end[1] = end;

        const int8_t qc = q[i - 1];
        uint8_t *mrow = moves + (size_t)(i - 1) * (size_t)W;

        /* F-gap chains cannot enter the band from columns left of
         * lo(i): the spec clips F at the band edge (ref/banded.py row
         * comment) so traceback paths never leave the band — the
         * band-local walk (c3_traceback) depends on it. */
        int64_t js = lo;
        int64_t F = NEG_A - oe + e;     /* numpy's F[0] constant */
        int64_t Ht_prev = NEG_A;        /* Htm[j-1]: NEG left of band */
        for (int64_t j = js; j < end; j++) {
            int64_t Ev = Hp[j] - oe;
            int64_t Ee = Ep[j] - e;
            int eext = Ee > Ev;
            int64_t E = eext ? Ee : Ev;
            int64_t diag = NEG_A;
            if (j > 0) {
                const int8_t tc = t[j - 1];
                int64_t s = (qc == 4 || tc == 4)
                                ? 0
                                : (qc == tc ? match : mismatch);
                diag = Hp[j - 1] + s;
            }
            int64_t Ht = diag > E ? diag : E;
            int fext = 0;
            if (j > 0) {
                int64_t Fo = Ht_prev - oe;
                int64_t Fe = F - e;
                fext = Fe > Fo;
                F = fext ? Fe : Fo;
            }
            Ht_prev = Ht;
            if (j >= lo) {
                int64_t H = Ht > F ? Ht : F;
                int src = (diag >= E && diag >= F) ? 0 : (E >= F ? 1 : 2);
                mrow[j - lo] = (uint8_t)(src | (eext << 2) | (fext << 3));
                Hn[j] = H;
                En[j] = E;
            }
        }

        /* swap row buffers and their window records */
        int64_t *tmp;
        tmp = Hp; Hp = Hn; Hn = tmp;
        tmp = Ep; Ep = En; En = tmp;
        int64_t ti;
        ti = win_lo[0]; win_lo[0] = win_lo[1]; win_lo[1] = ti;
        ti = win_end[0]; win_end[0] = win_end[1]; win_end[1] = ti;
    }

    /* smallest argmax among reachable cells (ref tie rule) */
    const int64_t thresh = NEG_A / 2;
    int64_t best = NEG_A;
    int64_t j_end = 0;
    for (int64_t j = 0; j <= nt; j++) {
        if (Hp[j] > thresh && Hp[j] > best) {
            best = Hp[j];
            j_end = j;
        }
    }
    if (j_end_out) *j_end_out = (int32_t)j_end;
    return best;
}
