/* The postprocess demux of a read group in one call, for
 * c3poa_tpu_torch/pipeline/postprocess.py (its spec, byte for byte:
 * extract_hits, _process_read and match_index, the reference's
 * C3POa_postprocessing.py:252-384).
 *
 * From the adapter kernel's six (B, C) outputs it takes each read's hits
 * (s1 > score_min, a second hit s2 > score_min counted twice), applies
 * the rules (exactly one '+' and one '-' hit, minus after plus, the
 * direction from whether the '+' hit's adapter is 5Prime_adapter), cuts
 * the two 20-base junction windows, matches them against the index file
 * with c3_sliding_min_dist_multi (overlap.c) and writes every record's
 * text.  Every slice follows Python's rules: a negative bound counts from
 * the end of the read, then both bounds clamp to [0, len].
 *
 * The output is one byte range a destination file, in input order:
 * for each destination d the full-length, left-splint and right-splint
 * FASTA (files 3d, 3d + 1, 3d + 2), then the 10x file and the mux TSV.
 * A first pass decides every read and sizes the files, a second writes
 * them.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

void c3_sliding_min_dist_multi(const uint8_t *seq, const int64_t *n_eff,
                               const uint8_t *idx_blob,
                               const int64_t *idx_off, int32_t n_idx,
                               int32_t *out);

enum { WRITTEN, NO_ADAPTER, WRONG_ORDER, NO_DIRECTION, NO_INDEX };
enum { TRIM = 1, UNDIRECTIONAL = 2, BARCODED = 4 };

/* Python's bound of a slice of a sequence of n bytes. */
static int64_t py_bound(int64_t i, int64_t n) {
    if (i < 0) {
        i += n;
        return i < 0 ? 0 : i;
    }
    return i > n ? n : i;
}

/* A file being written; with buf NULL only its size is counted. */
typedef struct {
    uint8_t *buf;
    int64_t n;
} Out;

static void put(Out *o, const uint8_t *s, int64_t len) {
    if (o->buf && len > 0) memcpy(o->buf + o->n, s, (size_t)len);
    o->n += len;
}

static void put_c(Out *o, uint8_t c) {
    if (o->buf) o->buf[o->n] = c;
    o->n++;
}

/* s[a:e] as Python slices it. */
static void put_slice(Out *o, const uint8_t *s, int64_t n, int64_t a,
                      int64_t e) {
    a = py_bound(a, n);
    e = py_bound(e, n);
    if (e > a) put(o, s + a, e - a);
}

/* The reverse complement of s[a:e] as Python slices it. */
static void put_slice_rc(Out *o, const uint8_t *s, int64_t n, int64_t a,
                         int64_t e, const uint8_t *comp) {
    a = py_bound(a, n);
    e = py_bound(e, n);
    if (e <= a) return;
    if (o->buf) {
        uint8_t *d = o->buf + o->n;
        for (int64_t i = e - 1; i >= a; i--) *d++ = comp[s[i]];
    }
    o->n += e - a;
}

static void put_int(Out *o, int64_t v) {
    uint8_t digits[24];
    int k = 0;
    do {
        digits[k++] = (uint8_t)('0' + v % 10);
        v /= 10;
    } while (v);
    while (k) put_c(o, digits[--k]);
}

/* The index a window matches (its number in file order), or -1: the
 * best distance under 2 and the second best more than 1 above it, the
 * first index in file order winning a tie; -2 when an index is wider
 * than the DP row of c3_sliding_min_dist_multi. */
static int32_t match_index(const uint8_t *win, int64_t wlen, int32_t n_idx,
                           const uint8_t *idx_blob, const int64_t *idx_off,
                           const int64_t *maxpref, const int64_t *idx_len,
                           int64_t *n_eff, int32_t *dist) {
    for (int32_t x = 0; x < n_idx; x++)
        n_eff[x] = wlen - maxpref[x] + idx_len[x];
    c3_sliding_min_dist_multi(win, n_eff, idx_blob, idx_off, n_idx, dist);
    int32_t best = 0;
    for (int32_t x = 0; x < n_idx; x++) {
        if (dist[x] < 0) return -2;
        if (dist[x] < dist[best]) best = x;
    }
    int64_t second = INT64_MAX;
    for (int32_t x = 0; x < n_idx; x++)
        if (x != best && dist[x] < second) second = dist[x];
    if (dist[best] < 2 && second - dist[best] > 1) return best;
    return -1;
}

/* A written read's records in its destination's three files and the
 * 10x file, as _process_read writes them. */
static void put_records(Out *files, int32_t dest, int32_t n_dest,
                        const uint8_t *name, int64_t name_len,
                        const uint8_t *s, int64_t n, int64_t plus,
                        int64_t minus, int plus_dir, int32_t flags,
                        const uint8_t *comp) {
    Out *flc = &files[3 * dest], *left = flc + 1, *right = flc + 2;
    Out *tenx = &files[3 * n_dest];
    int64_t a = py_bound(plus, n), e = py_bound(minus, n);
    int64_t ada = plus - 40 > 0 ? plus - 40 : 0;
    Out *all[4] = {flc, left, right, tenx};
    int n_out = flags & BARCODED ? 4 : 3;
    for (int k = 0; k < n_out; k++) {
        put_c(all[k], '>');
        put(all[k], name, name_len);
        put_c(all[k], '_');
        put_int(all[k], e > a ? e - a : 0);
        put_c(all[k], '\n');
    }
    if (plus_dir) {
        if (flags & TRIM) put_slice(flc, s, n, plus, minus);
        else put_slice(flc, s, n, ada, minus + 40);
        put_slice_rc(right, s, n, 0, plus, comp);
        put_slice(left, s, n, minus, n);
        if (flags & BARCODED) {
            put_slice_rc(tenx, s, n, minus - 40, minus, comp);
            put(tenx, (const uint8_t *)"plus", 4);
        }
    } else {
        if (flags & TRIM) put_slice_rc(flc, s, n, plus, minus, comp);
        else put_slice_rc(flc, s, n, ada, minus + 40, comp);
        put_slice_rc(left, s, n, 0, plus + 40, comp);
        put_slice(right, s, n, minus, n);
        if (flags & BARCODED) {
            put_slice(tenx, s, n, plus, plus + 40);
            put(tenx, (const uint8_t *)"minus", 5);
        }
    }
    for (int k = 0; k < n_out; k++) put_c(all[k], '\n');
}

/* The junction windows' mux row: name, rc(s[minus-16:minus+4]),
 * s[plus-4:plus+16]. */
static void put_mux(Out *mux, const uint8_t *name, int64_t name_len,
                    const uint8_t *s, int64_t n, int64_t plus,
                    int64_t minus, const uint8_t *comp) {
    put(mux, name, name_len);
    put_c(mux, '\t');
    put_slice_rc(mux, s, n, minus - 16, minus + 4, comp);
    put_c(mux, '\t');
    put_slice(mux, s, n, plus - 4, plus + 16);
    put_c(mux, '\n');
}

/* Demux the B reads of a group.
 *
 * names, seqs: the reads' UTF-8 names and ASCII sequences, read b at
 * [name_off[b], name_off[b + 1]) and [seq_off[b], seq_off[b + 1]).
 * s1 .. s2: the adapter kernel's (B, C) outputs, row-major.  Combo c
 * is on the '+' strand when combo_plus[c], its adapter combo_len[c]
 * bases long and named combo_name[c] (names as numbers; five_name is
 * 5Prime_adapter's, -1 when no adapter has that name).  flags: TRIM,
 * UNDIRECTIONAL, BARCODED.  The n_idx indexes in file order:
 * idx_blob[idx_off[x], idx_off[x + 1]), maxpref[x] the longest of
 * indexes 0..x, idx_len[x] its length; a read matched to index x goes
 * to destination dest_of_idx[x], an unmatched one to dest_noindex.
 * Without indexes every written read goes to destination 0 and no mux
 * row is written.  comp: the 256-byte complement table.
 *
 * Out: outcome[b] (WRITTEN .. NO_INDEX), chosen[b] (the index a
 * written read was filed under, or -1), the files' text in out and
 * file f at [file_off[f], file_off[f + 1]), 3 * n_dest + 2 files.
 * Returns the bytes written; -1 when they would pass cap or memory
 * runs out, -2 when an index is wider than the DP row (the caller then
 * runs the Python path). */
int64_t c3_post_demux(int64_t B, const uint8_t *names,
                      const int64_t *name_off, const uint8_t *seqs,
                      const int64_t *seq_off, int32_t C, const int64_t *s1,
                      const int64_t *j1, const int64_t *qe1,
                      const int64_t *ts1, const int64_t *qs1,
                      const int64_t *s2, const int8_t *combo_plus,
                      const int64_t *combo_len, const int32_t *combo_name,
                      int32_t five_name, int64_t score_min, int32_t flags,
                      int32_t n_idx, const uint8_t *idx_blob,
                      const int64_t *idx_off, const int64_t *maxpref,
                      const int64_t *idx_len, const int32_t *dest_of_idx,
                      int32_t dest_noindex, int32_t n_dest,
                      const uint8_t *comp, int8_t *outcome, int32_t *chosen,
                      uint8_t *out, int64_t cap, int64_t *file_off) {
    int32_t n_files = 3 * n_dest + 2;
    Out *files = calloc((size_t)n_files, sizeof(Out));
    int64_t *pos = malloc((size_t)(2 * B + 1) * sizeof(int64_t));
    int8_t *plus_dir = malloc((size_t)B + 1);
    int32_t *dest = malloc((size_t)(B + 1) * sizeof(int32_t));
    int64_t *n_eff = malloc((size_t)(n_idx + 1) * sizeof(int64_t));
    int32_t *dist = malloc((size_t)(n_idx + 1) * sizeof(int32_t));
    int64_t total = -1;
    if (!files || !pos || !plus_dir || !dest || !n_eff || !dist) goto done;
    Out *mux = &files[3 * n_dest + 1];

    for (int64_t b = 0; b < B; b++) {
        const int64_t *h1 = s1 + b * C, *h2 = s2 + b * C;
        int n_plus = 0, n_minus = 0;
        int64_t plus = 0, minus = 0;
        int32_t plus_name = -1, minus_name = -1;
        for (int32_t c = 0; c < C; c++) {
            if (h1[c] <= score_min) continue;
            int k = 1 + (h2[c] > score_min);
            int64_t i = b * C + c;
            if (combo_plus[c]) {
                n_plus += k;
                plus = j1[i] + 1 + (combo_len[c] - 1 - qe1[i]);
                plus_name = combo_name[c];
            } else {
                n_minus += k;
                minus = ts1[i] - qs1[i];
                minus_name = combo_name[c];
            }
        }
        chosen[b] = -1;
        if (n_plus != 1 || n_minus != 1) {
            outcome[b] = NO_ADAPTER;
            continue;
        }
        if (minus <= plus) {
            outcome[b] = WRONG_ORDER;
            continue;
        }
        int dir;
        if (flags & UNDIRECTIONAL) dir = 1;
        else if (plus_name != minus_name) dir = plus_name == five_name;
        else {
            outcome[b] = NO_DIRECTION;
            continue;
        }
        const uint8_t *s = seqs + seq_off[b];
        int64_t n = seq_off[b + 1] - seq_off[b];
        int32_t d = 0;
        outcome[b] = WRITTEN;
        if (n_idx > 0) {
            uint8_t rev[32];
            Out w = {rev, 0};
            put_slice_rc(&w, s, n, minus - 16, minus + 4, comp);
            int64_t fa = py_bound(plus - 4, n), fe = py_bound(plus + 16, n);
            int32_t fwd_x = match_index(s + fa, fe > fa ? fe - fa : 0, n_idx,
                                        idx_blob, idx_off, maxpref, idx_len,
                                        n_eff, dist);
            int32_t rev_x = match_index(rev, w.n, n_idx, idx_blob, idx_off,
                                        maxpref, idx_len, n_eff, dist);
            if (fwd_x == -2 || rev_x == -2) {
                total = -2;
                goto done;
            }
            if (fwd_x >= 0 && rev_x < 0) {
                dir = 0;
                chosen[b] = fwd_x;
            } else if (rev_x >= 0 && fwd_x < 0) {
                dir = 1;
                chosen[b] = rev_x;
            } else {
                outcome[b] = NO_INDEX;
            }
            d = chosen[b] >= 0 ? dest_of_idx[chosen[b]] : dest_noindex;
            put_mux(mux, names + name_off[b], name_off[b + 1] - name_off[b],
                    s, n, plus, minus, comp);
        }
        pos[2 * b] = plus;
        pos[2 * b + 1] = minus;
        plus_dir[b] = (int8_t)dir;
        dest[b] = d;
        put_records(files, d, n_dest, names + name_off[b],
                    name_off[b + 1] - name_off[b], s, n, plus, minus, dir,
                    flags, comp);
    }

    file_off[0] = 0;
    for (int32_t f = 0; f < n_files; f++)
        file_off[f + 1] = file_off[f] + files[f].n;
    if (file_off[n_files] > cap) goto done;
    for (int32_t f = 0; f < n_files; f++) {
        files[f].buf = out + file_off[f];
        files[f].n = 0;
    }
    for (int64_t b = 0; b < B; b++) {
        if (outcome[b] != WRITTEN && outcome[b] != NO_INDEX) continue;
        const uint8_t *s = seqs + seq_off[b];
        int64_t n = seq_off[b + 1] - seq_off[b];
        const uint8_t *name = names + name_off[b];
        int64_t name_len = name_off[b + 1] - name_off[b];
        if (n_idx > 0)
            put_mux(mux, name, name_len, s, n, pos[2 * b], pos[2 * b + 1],
                    comp);
        put_records(files, dest[b], n_dest, name, name_len, s, n,
                    pos[2 * b], pos[2 * b + 1], plus_dir[b], flags, comp);
    }
    total = file_off[n_files];
done:
    free(files);
    free(pos);
    free(plus_dir);
    free(dest);
    free(n_eff);
    free(dist);
    return total;
}
