/* Native hot-path host routines for c3poa_tpu.
 *
 * Implements, bit-for-bit, the Python reference semantics of:
 *  - band-local traceback of aligner move bytes
 *    (c3poa_tpu/kernels/banded.py:traceback_banded)
 *  - homopolymer indel left-normalization
 *    (c3poa_tpu/ref/banded.py:normalize_record)
 *  - column/insertion voting consensus
 *    (c3poa_tpu/consensus/vote.py:vote_consensus)
 *
 * Replaces the role native code plays in the reference pipeline (conk /
 * abPOA / racon C internals, SURVEY.md §2.2) on the host side of the TPU
 * design; the DP itself runs on the TPU.
 *
 * Plain C99, no Python.h: bound via ctypes (see c3poa_tpu/native.py).
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>

#define SRC_DIAG 0
#define SRC_E 1
#define SRC_F 2
#define BIT_EEXT 4
#define BIT_FEXT 8

/* lo(i) band starts: must match kernels/banded.py band_starts_np (float32
 * arithmetic, round-half-even). */
static int32_t band_lo(int32_t i, int32_t nq, int32_t nt, int32_t W) {
    float x = (float)i * (float)nt / (float)(nq > 0 ? nq : 1);
    /* round half to even, like np.round on float32 */
    float r = __builtin_roundevenf(x);
    int32_t ctr = (int32_t)r;
    int32_t hi = nt + 1 - W;
    if (hi < 0) hi = 0;
    int32_t lo = ctr - W / 2;
    if (lo < 0) lo = 0;
    if (lo > hi) lo = hi;
    return lo;
}

/* Traceback of band-local move bytes; fills the AlignRecord arrays.
 * moves: (nq_max, W) row-major, row r = DP row r+1.
 * edge_out (nullable): set to 1 if the path visited band-local column
 * 0 or W-1 — the fast-band escalation signal (same accumulation rule
 * as the device walks in kernels/banded.py).
 * Returns j_start. */
int32_t c3_traceback_edge(
    const uint8_t *moves, int32_t nq_max, int32_t W,
    const int8_t *q, int32_t nq, int32_t nt, int32_t j_end,
    int8_t *cover,        /* [nt]  out, zeroed by caller or here */
    int8_t *base,         /* [nt]  out */
    int32_t *qpos,        /* [nt]  out */
    int32_t *ins_len,     /* [nt+1] out */
    int32_t *ins_qstart,  /* [nt+1] out */
    int32_t *edge_out
) {
    memset(cover, 0, (size_t)nt);
    memset(base, 4, (size_t)nt);
    for (int32_t j = 0; j < nt; j++) qpos[j] = -1;
    memset(ins_len, 0, sizeof(int32_t) * (size_t)(nt + 1));
    for (int32_t j = 0; j <= nt; j++) ins_qstart[j] = -1;
    if (edge_out) *edge_out = 0;

    int32_t i = nq, j = j_end, state = 0;
    while (i > 0) {
        int32_t k = j - band_lo(i, nq, nt, W);
        if (k < 0 || k >= W || j < 0) {
            /* a path can only get here on corrupt move input (the
             * band-edge F clip guarantees real paths stay in band):
             * stop rather than walk outside the buffers */
            break;
        }
        if (edge_out) {
            /* interior band edges only: j=0 starts and j=nt ends are
             * not band-limited (kernels/banded.py walks share the rule) */
            int32_t lo_i = j - k;
            if ((k == 0 && lo_i > 0) || (k == W - 1 && lo_i + W <= nt))
                *edge_out = 1;
        }
        uint8_t mv = moves[(size_t)(i - 1) * W + k];
        if (state == 0) {
            int src = mv & 3;
            if (src == SRC_DIAG) {
                if (j < 1) break;            /* corrupt input guard */
                cover[j - 1] = 1;
                base[j - 1] = q[i - 1];
                qpos[j - 1] = i - 1;
                i--; j--;
            } else if (src == SRC_E) {
                state = 1;
            } else {
                state = 2;
            }
        } else if (state == 1) {
            ins_len[j] += 1;
            ins_qstart[j] = i - 1;
            int ext = mv & BIT_EEXT;
            i--;
            if (!ext) state = 0;
        } else {
            if (j < 1) break;                /* corrupt input guard */
            cover[j - 1] = 2;
            int ext = mv & BIT_FEXT;
            j--;
            if (!ext) state = 0;
        }
    }
    return j;
}

/* Back-compatible entry (no edge flag). */
int32_t c3_traceback(
    const uint8_t *moves, int32_t nq_max, int32_t W,
    const int8_t *q, int32_t nq, int32_t nt, int32_t j_end,
    int8_t *cover, int8_t *base, int32_t *qpos,
    int32_t *ins_len, int32_t *ins_qstart
) {
    return c3_traceback_edge(moves, nq_max, W, q, nq, nt, j_end,
                             cover, base, qpos, ins_len, ins_qstart, 0);
}

/* Rebuild an alignment record from on-device traceback ops
 * (kernels/banded.py banded_align_trace_batch: 1=diag 2=ins 3=del 0=done).
 * Returns j_start. */
int32_t c3_ops_record(
    const uint8_t *ops, int32_t n_ops,
    const int8_t *q, int32_t nq, int32_t nt, int32_t j_end,
    int8_t *cover, int8_t *base, int32_t *qpos,
    int32_t *ins_len, int32_t *ins_qstart
) {
    memset(cover, 0, (size_t)nt);
    memset(base, 4, (size_t)nt);
    for (int32_t j = 0; j < nt; j++) qpos[j] = -1;
    memset(ins_len, 0, sizeof(int32_t) * (size_t)(nt + 1));
    for (int32_t j = 0; j <= nt; j++) ins_qstart[j] = -1;

    int32_t i = nq, j = j_end;
    /* i > 0 / j > 0 guards make the walk-termination invariant local:
     * an unfinished or garbage-padded ops row (callers normally filter
     * i_rem > 0 rows) must not drive i/j negative into OOB accesses */
    for (int32_t s = 0; s < n_ops && i > 0; s++) {
        uint8_t op = ops[s];
        if (op == 0) break;
        if (op == 1) {
            if (j <= 0) break;
            cover[j - 1] = 1;
            base[j - 1] = q[i - 1];
            qpos[j - 1] = i - 1;
            i--; j--;
        } else if (op == 2) {
            ins_len[j] += 1;
            ins_qstart[j] = i - 1;
            i--;
        } else {
            if (j <= 0) break;
            cover[j - 1] = 2;
            j--;
        }
    }
    return j;
}

/* Same record rebuild for the word-cached device walk
 * (kernels/banded.py walk_ops_cached): ops arrive 2-bit packed, four per
 * byte, and may contain 0 (=none) gaps where a walk substep missed its
 * cached move word — skip gaps, stop once the whole query is consumed
 * (i == 0).  Returns j_start. */
int32_t c3_ops_record_packed(
    const uint8_t *ops, int32_t n_bytes,
    const int8_t *q, int32_t nq, int32_t nt, int32_t j_end,
    int8_t *cover, int8_t *base, int32_t *qpos,
    int32_t *ins_len, int32_t *ins_qstart
) {
    memset(cover, 0, (size_t)nt);
    memset(base, 4, (size_t)nt);
    for (int32_t j = 0; j < nt; j++) qpos[j] = -1;
    memset(ins_len, 0, sizeof(int32_t) * (size_t)(nt + 1));
    for (int32_t j = 0; j <= nt; j++) ins_qstart[j] = -1;

    int32_t i = nq, j = j_end;
    for (int32_t s = 0; s < n_bytes && i > 0; s++) {
        uint8_t b = ops[s];
        if (!b) continue;
        for (int32_t u = 0; u < 4 && i > 0; u++) {
            uint8_t op = (b >> (2 * u)) & 3;
            if (op == 0) continue;
            if (op == 1) {
                if (j <= 0) { i = 0; break; }
                cover[j - 1] = 1;
                base[j - 1] = q[i - 1];
                qpos[j - 1] = i - 1;
                i--; j--;
            } else if (op == 2) {
                ins_len[j] += 1;
                ins_qstart[j] = i - 1;
                i--;
            } else {
                if (j <= 0) { i = 0; break; }
                cover[j - 1] = 2;
                j--;
            }
        }
    }
    return j;
}

/* Left-normalize indels within homopolymer runs (ref/banded.py
 * normalize_record semantics, in place). */
void c3_normalize(
    const int8_t *q, const int8_t *t, int32_t nt,
    int8_t *cover, int8_t *base, int32_t *qpos,
    int32_t *ins_len, int32_t *ins_qstart
) {
    /* deletions shift left past matched equal-base draft columns */
    for (int32_t j = 0; j < nt; j++) {
        if (cover[j] != 2) continue;
        int32_t jj = j;
        while (jj > 0 && cover[jj - 1] == 1 && t[jj - 1] == t[jj] &&
               ins_len[jj] == 0) {
            cover[jj - 1] = 2;
            cover[jj] = 1;
            base[jj] = base[jj - 1];
            qpos[jj] = qpos[jj - 1];
            base[jj - 1] = 4;
            qpos[jj - 1] = -1;
            jj--;
        }
    }
    /* single-base insertions shift left past equal aligned query bases */
    for (int32_t j = 1; j <= nt; j++) {
        if (ins_len[j] != 1) continue;
        int8_t b = q[ins_qstart[j]];
        int32_t jj = j;
        while (jj > 0 && cover[jj - 1] == 1 && base[jj - 1] == b &&
               ins_len[jj - 1] == 0) {
            ins_len[jj - 1] = 1;
            ins_qstart[jj - 1] = qpos[jj - 1];
            qpos[jj - 1] = ins_qstart[jj];
            ins_len[jj] = 0;
            ins_qstart[jj] = -1;
            jj--;
        }
    }
}

/* ---------------- voting ----------------
 *
 * Records are passed as stacked arrays over N alignments:
 *   cover  (N, nt) int8; base (N, nt) int8; qpos (N, nt) int32;
 *   ins_len/ins_qstart (N, nt+1) int32;
 *   j_span (N, 2) int32 (j_start, j_end);
 *   queries: concatenated int8 with offsets q_off (N+1);
 *   quals: same layout.
 * Output: consensus codes+quals appended to out buffers (capacity cap),
 * returns emitted length or -1 on overflow.
 */

#define MAX_INS 30

static inline int64_t colkey(int64_t cnt, int64_t qs, int32_t pref) {
    if (qs > ((int64_t)1 << 39) - 1) qs = ((int64_t)1 << 39) - 1;
    return (cnt << 40) + (qs << 3) + pref;
}

/* Core vote over N stacked records plus an optional implicit draft
 * voter (draft != NULL): the draft participates as a trivially aligned
 * record — cover 1 everywhere, no insertions, span [0, nt] — exactly
 * consensus/vote.record_for_draft without materializing its arrays. */
static int32_t vote_one(
    int32_t N, int32_t nt,
    const int8_t *cover, const int8_t *base, const int32_t *qpos,
    const int32_t *ins_len, const int32_t *ins_qstart,
    const int32_t *j_span,
    const int8_t *queries, const int8_t *quals, const int64_t *q_off,
    const int8_t *draft, const int8_t *draft_q,
    int32_t qmin,
    int8_t *out_codes, int8_t *out_quals, int32_t cap
) {
    int32_t out = 0;
    /* column accumulators, rebuilt per column on the fly would be O(N*nt);
     * do one pass over records per column block instead: simple O(N*nt)
     * loops — N and nt are small (N<=~40, nt<=~5000). */
    for (int32_t j = 0; j <= nt; j++) {
        /* ---- insertion slot j ---- */
        int ins_any = 0;
        for (int32_t a = 0; a < N; a++) {
            if (ins_len[(size_t)a * (nt + 1) + j] > 0) { ins_any = 1; break; }
        }
        if (ins_any) {
            int32_t len_cnt[MAX_INS + 1];
            memset(len_cnt, 0, sizeof(len_cnt));
            if (draft) len_cnt[0]++;  /* the draft spans every slot, L=0 */
            for (int32_t a = 0; a < N; a++) {
                int32_t js = j_span[a * 2], je = j_span[a * 2 + 1];
                if (js <= j && j <= je) {
                    int32_t L = ins_len[(size_t)a * (nt + 1) + j];
                    if (L > MAX_INS) L = MAX_INS;
                    len_cnt[L]++;
                }
            }
            int32_t Lwin = 0;
            for (int32_t L = 1; L <= MAX_INS; L++)
                if (len_cnt[L] > len_cnt[Lwin]) Lwin = L;
            for (int32_t o = 0; o < Lwin; o++) {
                int64_t cnt[4] = {0, 0, 0, 0}, cnt_all[4] = {0, 0, 0, 0},
                        qs[4] = {0, 0, 0, 0};
                for (int32_t a = 0; a < N; a++) {
                    int32_t js = j_span[a * 2], je = j_span[a * 2 + 1];
                    if (!(js <= j && j <= je)) continue;
                    int32_t L = ins_len[(size_t)a * (nt + 1) + j];
                    if (L > MAX_INS) L = MAX_INS;
                    if (L <= o) continue;
                    int64_t qi = q_off[a] + ins_qstart[(size_t)a * (nt + 1) + j] + o;
                    int8_t b = queries[qi];
                    if (b >= 4) continue;
                    int32_t qv = quals[qi];
                    if (qv >= qmin) cnt[b]++;
                    cnt_all[b]++;
                    qs[b] += qv;
                }
                int64_t tot = cnt[0] + cnt[1] + cnt[2] + cnt[3];
                if (tot == 0) {
                    for (int k = 0; k < 4; k++) cnt[k] = cnt_all[k];
                    tot = cnt[0] + cnt[1] + cnt[2] + cnt[3];
                }
                if (out >= cap) return -1;
                if (tot == 0) {
                    out_codes[out] = 4;
                    out_quals[out] = 0;
                    out++;
                    continue;
                }
                int bestb = 0;
                int64_t bestkey = -1;
                for (int b = 0; b < 4; b++) {
                    int64_t key = colkey(cnt[b], qs[b], 3 - b);
                    if (key > bestkey) { bestkey = key; bestb = b; }
                }
                out_codes[out] = (int8_t)bestb;
                int64_t c = cnt[bestb] ? cnt[bestb] : 1;
                int64_t qv = qs[bestb] / c;
                out_quals[out] = (int8_t)(qv > 93 ? 93 : qv);
                out++;
            }
        }
        /* ---- column j ---- */
        if (j >= nt) break;
        int64_t cnt[5] = {0}, cnt_all[5] = {0}, qs[5] = {0};
        if (draft) {
            int8_t b = draft[j];
            if (b < 4) {
                int32_t qv = draft_q[j];
                if (qv >= qmin) cnt[b]++;
                cnt_all[b]++;
                qs[b] += qv;
            }
        }
        for (int32_t a = 0; a < N; a++) {
            int8_t cv = cover[(size_t)a * nt + j];
            if (cv == 1) {
                int8_t b = base[(size_t)a * nt + j];
                int64_t qi = q_off[a] + qpos[(size_t)a * nt + j];
                int32_t qv = quals[qi];
                if (b < 4) {
                    if (qv >= qmin) cnt[b]++;
                    cnt_all[b]++;
                    qs[b] += qv;
                }
            } else if (cv == 2) {
                cnt[4]++;
                cnt_all[4]++;
            }
        }
        int64_t tot = 0;
        for (int k = 0; k < 5; k++) tot += cnt[k];
        if (tot == 0) {
            int64_t tot_all = 0;
            for (int k = 0; k < 5; k++) { cnt[k] = cnt_all[k]; tot_all += cnt[k]; }
            tot = tot_all;
        }
        if (tot == 0) continue; /* uncovered column: emit nothing */
        int bestb = 0;
        int64_t bestkey = -1;
        static const int pref[5] = {4, 3, 2, 1, 0};
        for (int b = 0; b < 5; b++) {
            int64_t key = colkey(cnt[b], qs[b], pref[b]);
            if (key > bestkey) { bestkey = key; bestb = b; }
        }
        if (bestb == 4) continue; /* deletion wins */
        if (out >= cap) return -1;
        out_codes[out] = (int8_t)bestb;
        int64_t c = cnt[bestb] ? cnt[bestb] : 1;
        int64_t qv = qs[bestb] / c;
        out_quals[out] = (int8_t)(qv > 93 ? 93 : qv);
        out++;
    }
    return out;
}

int32_t c3_vote(
    int32_t N, int32_t nt,
    const int8_t *cover, const int8_t *base, const int32_t *qpos,
    const int32_t *ins_len, const int32_t *ins_qstart,
    const int32_t *j_span,
    const int8_t *queries, const int8_t *quals, const int64_t *q_off,
    int32_t qmin,
    int8_t *out_codes, int8_t *out_quals, int32_t cap
) {
    return vote_one(N, nt, cover, base, qpos, ins_len, ins_qstart, j_span,
                    queries, quals, q_off, NULL, NULL, qmin,
                    out_codes, out_quals, cap);
}

/* ---------------- batched per-group voting ----------------
 *
 * One call votes every job of a read group (the per-job Python->C round
 * trips and (N, nt) re-marshalling dominated the vote stage).  All
 * voters arrive concatenated job-major:
 *   jv_off (n_jobs+1): voter index range of job j;
 *   vnt_off (total_voters+1): offset of voter v's nt-wide arrays in the
 *     cover/base/qpos blobs (nt1 arrays use vnt_off[v] + v);
 *   q_off (total_voters+1): offset of voter v's query/qual;
 *   dr_off (n_jobs+1): offset of job j's draft codes/quals (the draft is
 *     the implicit extra voter); nt_job[j] = dr_off[j+1] - dr_off[j];
 *   out_off (n_jobs+1): output slice per job (capacity out_off[j+1]-out_off[j]).
 * out_lens[j] = emitted length, or -1 on per-job overflow (caller
 * re-votes that job with a bigger buffer).  Jobs fan out over nthreads
 * POSIX threads (voting is embarrassingly parallel across jobs).
 */

typedef struct {
    int32_t n_jobs;
    const int64_t *jv_off;
    const int64_t *vnt_off;
    const int64_t *q_off;
    const int64_t *dr_off;
    const int64_t *out_off;
    const int8_t *cover; const int8_t *base; const int32_t *qpos;
    const int32_t *ins_len; const int32_t *ins_qstart;
    const int32_t *j_span;
    const int8_t *queries; const int8_t *quals;
    const int8_t *drafts; const int8_t *draft_qs;
    int32_t qmin;
    int8_t *out_codes; int8_t *out_quals;
    int32_t *out_lens;
    int32_t tid, nthreads;
} vote_jobs_ctx;

static void *vote_jobs_worker(void *arg) {
    vote_jobs_ctx *c = (vote_jobs_ctx *)arg;
    for (int32_t j = c->tid; j < c->n_jobs; j += c->nthreads) {
        int64_t v0 = c->jv_off[j], v1 = c->jv_off[j + 1];
        int32_t N = (int32_t)(v1 - v0);
        int32_t nt = (int32_t)(c->dr_off[j + 1] - c->dr_off[j]);
        int64_t base_nt = c->vnt_off[v0];
        /* q_off entries are absolute into the global query/qual blobs,
         * so the blob pointers pass through unrebased */
        c->out_lens[j] = vote_one(
            N, nt,
            c->cover + base_nt, c->base + base_nt, c->qpos + base_nt,
            c->ins_len + base_nt + v0, c->ins_qstart + base_nt + v0,
            c->j_span + v0 * 2,
            c->queries, c->quals, c->q_off + v0,
            c->drafts + c->dr_off[j], c->draft_qs + c->dr_off[j],
            c->qmin,
            c->out_codes + c->out_off[j], c->out_quals + c->out_off[j],
            (int32_t)(c->out_off[j + 1] - c->out_off[j]));
    }
    return NULL;
}

#include <pthread.h>

void c3_vote_jobs(
    int32_t n_jobs,
    const int64_t *jv_off, const int64_t *vnt_off, const int64_t *q_off,
    const int64_t *dr_off, const int64_t *out_off,
    const int8_t *cover, const int8_t *base, const int32_t *qpos,
    const int32_t *ins_len, const int32_t *ins_qstart,
    const int32_t *j_span,
    const int8_t *queries, const int8_t *quals,
    const int8_t *drafts, const int8_t *draft_qs,
    int32_t qmin,
    int8_t *out_codes, int8_t *out_quals, int32_t *out_lens,
    int32_t nthreads
) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    vote_jobs_ctx ctxs[16];
    pthread_t tids[16];
    int created[16] = {0};
    for (int32_t t = 0; t < nthreads; t++) {
        ctxs[t] = (vote_jobs_ctx){
            n_jobs, jv_off, vnt_off, q_off, dr_off, out_off,
            cover, base, qpos, ins_len, ins_qstart, j_span,
            queries, quals, drafts, draft_qs, qmin,
            out_codes, out_quals, out_lens, t, nthreads};
        if (t < nthreads - 1 &&
            pthread_create(&tids[t], NULL, vote_jobs_worker, &ctxs[t]) == 0) {
            created[t] = 1;
        } else {
            /* last slot (or create failure) runs inline; the tid/stride
             * layout stays intact so every job is still covered */
            vote_jobs_worker(&ctxs[t]);
        }
    }
    for (int32_t t = 0; t < nthreads; t++)
        if (created[t]) pthread_join(tids[t], NULL);
}

/* Batched record building: one call per device launch instead of one
 * Python->C round trip per alignment (the per-record Python marshalling
 * dominated align_host_records).  Queries/targets arrive as concatenated
 * blobs with offsets; outputs land in caller-allocated arenas sliced by
 * per-record nt offsets. */
void c3_ops_records_batch(
    const uint8_t *ops, int64_t ops_stride, int32_t n,
    const int8_t *q_blob, const int64_t *q_off,
    const int8_t *t_blob, const int64_t *t_off,
    const int32_t *j_ends,
    int8_t *cover, int8_t *base, int32_t *qpos,
    int32_t *ins_len, int32_t *ins_qstart,
    const int64_t *nt_off, const int64_t *nt1_off,
    int32_t *j_starts, int32_t packed
) {
    for (int32_t r = 0; r < n; r++) {
        const int8_t *q = q_blob + q_off[r];
        const int8_t *t = t_blob + t_off[r];
        int32_t nq = (int32_t)(q_off[r + 1] - q_off[r]);
        int32_t nt = (int32_t)(t_off[r + 1] - t_off[r]);
        int8_t *cv = cover + nt_off[r];
        int8_t *bs = base + nt_off[r];
        int32_t *qp = qpos + nt_off[r];
        int32_t *il = ins_len + nt1_off[r];
        int32_t *iq = ins_qstart + nt1_off[r];
        j_starts[r] = (packed ? c3_ops_record_packed : c3_ops_record)(
            ops + (int64_t)r * ops_stride, (int32_t)ops_stride, q, nq, nt,
            j_ends[r], cv, bs, qp, il, iq);
        c3_normalize(q, t, nt, cv, bs, qp, il, iq);
    }
}
