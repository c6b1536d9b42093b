/* K-mer diagonal-vote overlap finder — C fast path for
 * c3poa_tpu/consensus/overlap.py:find_overlap (same contract, same
 * results; parity enforced by tests/test_overlap.py).
 *
 * Replaces mappy's role in the zero-repeat / dangling-anchor paths
 * (reference bin/determine_consensus.py:117).  The numpy version costs
 * ~0.5 ms per fragment (argsort + searchsorted + fancy indexing); this
 * routine runs the same algorithm ~20x faster, which matters because the
 * pipeline calls it once per dangling fragment inside the hot
 * pairs_build stage.
 *
 * Matching is a linear-probing hash of target k-mers: per code the first
 * 8 positions in ascending order are kept, which is exactly the numpy
 * path's cap (first 8 entries of a stable argsort = the 8 smallest
 * target positions of that code).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_HITS 8

/* 2-bit packed k-mer codes over s[0..n); windows containing a code >= 4
 * (N) get -1.  out must hold n - k + 1 entries. */
static void kmer_codes(const int8_t *s, int64_t n, int k, int64_t *out) {
    int64_t code = 0;
    int bad = 0; /* count of N inside the current window */
    int64_t mask = ((int64_t)1 << (2 * k)) - 1;
    for (int64_t i = 0; i < n; i++) {
        int c = s[i];
        if (c >= 4 || c < 0) { bad++; c = 0; }
        code = ((code << 2) | c) & mask;
        if (i >= k) {
            int p = s[i - k];
            if (p >= 4 || p < 0) bad--;
        }
        if (i >= k - 1) out[i - k + 1] = bad ? -1 : code;
    }
}

static inline uint64_t mix64(uint64_t x) {
    /* splitmix64 finalizer: full-avalanche hash for the probe start */
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

/* Sliding-window Levenshtein for oligo-dT index demux (the reference's
 * editdistance role, C3POa_postprocessing.py:266-285): for each index
 * i, out[i] = min over window offsets p of the unit-cost edit distance
 * between seq[p : p + len_i] and index i, with windows limited to
 * p + len_i <= n_eff[i] (the caller derives n_eff from the reference's
 * position-outer loop, whose inner `break` stops later-listed indexes
 * at the first too-long window of any EARLIER index), or len_i when no
 * window fits.  One call covers every index of a junction window — the
 * per-call numpy version cost ~0.2 ms x 95k calls on a 4k-read
 * postprocess run.  Bytes compare raw (ASCII), matching ref/lev.py.
 * Each window's distance is the bit-parallel global edit distance
 * (Myers 1999 in Hyyro's 2001 form: one 64-bit column a window byte),
 * exactly the DP's value. */
static int32_t edit_distance_bp(const uint64_t *peq, const uint8_t *w,
                                int64_t m) {
    uint64_t pv = ~(uint64_t)0, mv = 0, top = (uint64_t)1 << (m - 1);
    int32_t score = (int32_t)m;
    for (int64_t j = 0; j < m; j++) {
        uint64_t eq = peq[w[j]];
        uint64_t xv = eq | mv;
        uint64_t xh = (((eq & pv) + pv) ^ pv) | eq;
        uint64_t ph = mv | ~(xh | pv);
        uint64_t mh = pv & xh;
        if (ph & top) score++;
        else if (mh & top) score--;
        ph = (ph << 1) | 1;  /* row 0 of the global DP grows by 1 a column */
        mh <<= 1;
        pv = mh | ~(xv | ph);
        mv = ph & xv;
    }
    return score;
}

void c3_sliding_min_dist_multi(const uint8_t *seq, const int64_t *n_eff,
                               const uint8_t *idx_blob,
                               const int64_t *idx_off, int32_t n_idx,
                               int32_t *out) {
    uint64_t peq[256];
    memset(peq, 0, sizeof peq);
    for (int32_t x = 0; x < n_idx; x++) {
        const uint8_t *idx = idx_blob + idx_off[x];
        int64_t m = idx_off[x + 1] - idx_off[x];
        int64_t n = n_eff[x];
        if (m > 63) { out[x] = -1; continue; }  /* caller falls back */
        if (n < m) { out[x] = (int32_t)m; continue; }
        for (int64_t i = 0; i < m; i++) peq[idx[i]] |= (uint64_t)1 << i;
        int32_t best = (int32_t)m;
        for (int64_t p = 0; p + m <= n && best > 0; p++) {
            int32_t d = edit_distance_bp(peq, seq + p, m);
            if (d < best) best = d;
        }
        for (int64_t i = 0; i < m; i++) peq[idx[i]] = 0;
        out[x] = best;
    }
}

/* Best-diagonal overlap of query onto target.
 * out4 = {r_st, r_en, q_st, q_en}; returns 1 if found, 0 if none,
 * -1 on allocation failure (caller falls back to the Python path). */
int c3_find_overlap(const int8_t *target, int64_t nt,
                    const int8_t *query, int64_t nq,
                    int32_t k, int32_t band, int32_t min_matches,
                    int64_t *out4) {
    if (nt < k || nq < k) return 0;
    if (2 * k > 62) return -1; /* code must fit an int64 */
    int64_t ntk = nt - k + 1, nqk = nq - k + 1;

    /* hash table at load factor <= 0.5 */
    int64_t tsize = 64;
    while (tsize < 2 * ntk) tsize <<= 1;
    int64_t tmask = tsize - 1;

    int64_t *tk = (int64_t *)malloc((size_t)ntk * sizeof(int64_t));
    int64_t *qk = (int64_t *)malloc((size_t)nqk * sizeof(int64_t));
    int64_t *hcode = (int64_t *)malloc((size_t)tsize * sizeof(int64_t));
    uint8_t *hcnt = (uint8_t *)malloc((size_t)tsize);
    int32_t *hpos = (int32_t *)malloc((size_t)tsize * MAX_HITS * sizeof(int32_t));
    int32_t *qpos = (int32_t *)malloc((size_t)nqk * MAX_HITS * sizeof(int32_t));
    int32_t *tpos = (int32_t *)malloc((size_t)nqk * MAX_HITS * sizeof(int32_t));
    if (!tk || !qk || !hcode || !hcnt || !hpos || !qpos || !tpos) {
        free(tk); free(qk); free(hcode); free(hcnt); free(hpos);
        free(qpos); free(tpos);
        return -1;
    }
    kmer_codes(target, nt, k, tk);
    kmer_codes(query, nq, k, qk);

    memset(hcode, 0xFF, (size_t)tsize * sizeof(int64_t)); /* -1 = empty */

    /* insert target k-mers in ascending position: per code, the first
     * MAX_HITS positions stay, ascending — the numpy cap semantics */
    for (int64_t i = 0; i < ntk; i++) {
        int64_t c = tk[i];
        if (c < 0) continue; /* invalid windows never match a valid qk */
        uint64_t h = mix64((uint64_t)c) & (uint64_t)tmask;
        for (;;) {
            if (hcode[h] == c) {
                if (hcnt[h] < MAX_HITS) hpos[h * MAX_HITS + hcnt[h]++] = (int32_t)i;
                break;
            }
            if (hcode[h] == -1) {
                hcode[h] = c;
                hcnt[h] = 1;
                hpos[h * MAX_HITS] = (int32_t)i;
                break;
            }
            h = (h + 1) & (uint64_t)tmask;
        }
    }

    int64_t npairs = 0;
    for (int64_t i = 0; i < nqk; i++) {
        int64_t c = qk[i];
        if (c < 0) continue;
        uint64_t h = mix64((uint64_t)c) & (uint64_t)tmask;
        while (hcode[h] != -1) {
            if (hcode[h] == c) {
                int n = hcnt[h];
                const int32_t *pp = hpos + h * MAX_HITS;
                for (int x = 0; x < n; x++) {
                    qpos[npairs] = (int32_t)i;
                    tpos[npairs] = pp[x];
                    npairs++;
                }
                break;
            }
            h = (h + 1) & (uint64_t)tmask;
        }
    }

    int found = 0;
    if (npairs > 0) {
        /* diagonal binning: bins = (tpos - qpos + nq) / band, all >= 0 */
        int64_t nbins = (nt + nq) / band + 2;
        int32_t *bincnt = (int32_t *)calloc((size_t)nbins, sizeof(int32_t));
        if (!bincnt) {
            free(tk); free(qk); free(hcode); free(hcnt); free(hpos);
            free(qpos); free(tpos);
            return -1;
        }
        int64_t maxbin = 0;
        for (int64_t p = 0; p < npairs; p++) {
            int64_t b = (tpos[p] - (int64_t)qpos[p] + nq) / band;
            bincnt[b]++;
            if (b > maxbin) maxbin = b;
        }
        int64_t best_bin = 0;
        for (int64_t b = 1; b <= maxbin; b++)  /* first max wins (np.argmax) */
            if (bincnt[b] > bincnt[best_bin]) best_bin = b;
        free(bincnt);

        int64_t n_in = 0;
        int64_t q_st = 0, q_en = 0, r_st = 0, r_en = 0;
        for (int64_t p = 0; p < npairs; p++) {
            int64_t b = (tpos[p] - (int64_t)qpos[p] + nq) / band;
            int64_t d = b - best_bin;
            if (d < -1 || d > 1) continue;
            if (n_in == 0) {
                q_st = q_en = qpos[p];
                r_st = r_en = tpos[p];
            } else {
                if (qpos[p] < q_st) q_st = qpos[p];
                if (qpos[p] > q_en) q_en = qpos[p];
                if (tpos[p] < r_st) r_st = tpos[p];
                if (tpos[p] > r_en) r_en = tpos[p];
            }
            n_in++;
        }
        if (n_in >= min_matches) {
            q_en += k;
            r_en += k;
            int64_t shift_left = q_st < r_st ? q_st : r_st;
            q_st -= shift_left;
            r_st -= shift_left;
            int64_t sr_q = nq - q_en, sr_r = nt - r_en;
            int64_t shift_right = sr_q < sr_r ? sr_q : sr_r;
            q_en += shift_right;
            r_en += shift_right;
            out4[0] = r_st; out4[1] = r_en; out4[2] = q_st; out4[3] = q_en;
            found = 1;
        }
    }
    free(tk); free(qk); free(hcode); free(hcnt); free(hpos);
    free(qpos); free(tpos);
    return found;
}
