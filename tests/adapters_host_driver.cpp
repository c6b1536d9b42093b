// Host driver of the adapter-hits kernel's arithmetic, for the CPU tests
// (tests/test_torch_adapters.py builds it with g++).
//
// It runs the control flow of c3poa_tpu_torch/kernels/csrc/adapters.cu
// serially over the functions of adapters.cuh: tiles of nt * ADP_K
// columns, per row each thread's strip prefix, a Hillis-Steele scan of
// the strip totals within warps of ``warp`` threads (the order of the
// kernel's __shfl_up_sync steps), the carry chain over the tile
// boundary, earlier warps and earlier lanes, and the epilogue's best hit
// and second hit.  Small ``nt`` and ``warp`` put tile and warp seams
// inside short reads.
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "adapters.cuh"

namespace {

struct Strip {
    int rc[ADP_K];
    int32_t H[ADP_K], cm[ADP_K], qe[ADP_K], A[ADP_K];
    uint32_t P[ADP_K], cp[ADP_K], Q[ADP_K];
    int32_t hl;
    uint32_t pl;
};

void one_block(const int8_t* rrow, int len, int L, const int8_t* q, int mc,
               int match, int mismatch, int gap, int tol, int nt, int warp,
               int32_t* res) {
    const int tw = nt * ADP_K;
    std::vector<int32_t> bA(mc, -gap);
    std::vector<uint32_t> bP(mc, 0);
    std::vector<int32_t> scr_cm(len > 0 ? len : 1), scr_ts(len > 0 ? len : 1);
    std::vector<Strip> th(nt);
    std::vector<int32_t> bs(nt, -1), bj(nt, 0), bq(nt, 0);
    std::vector<uint32_t> bp(nt, 0);
    std::vector<int32_t> sA(nt), eA(nt), oA(nt), wA(nt / warp);
    std::vector<uint32_t> sP(nt), eP(nt), oP(nt), wP(nt / warp);

    for (int t0 = 0; t0 < len; t0 += tw) {
        for (int t = 0; t < nt; ++t) {
            Strip& s = th[t];
            const int j0 = t0 + t * ADP_K;
            for (int k = 0; k < ADP_K; ++k) {
                s.rc[k] = j0 + k < L ? rrow[j0 + k] : 4;
                s.H[k] = 0; s.P[k] = adp_pack(j0 + k + 1, 0);
                s.cm[k] = 0; s.qe[k] = 0; s.cp[k] = 0;
            }
            s.hl = 0; s.pl = 0;
        }
        for (int i = 0; i < mc; ++i) {
            for (int t = 0; t < nt; ++t) {
                Strip& s = th[t];
                adp_strip_prefix(s.rc, q[i], t0 + t * ADP_K, i, match,
                                 mismatch, gap, s.hl, s.pl, s.H, s.P, s.A,
                                 s.Q);
                sA[t] = s.A[ADP_K - 1];
                sP[t] = s.Q[ADP_K - 1];
            }
            for (int d = 1; d < warp; d <<= 1) {
                oA = sA; oP = sP;
                for (int t = 0; t < nt; ++t)
                    if (t % warp >= d)
                        adp_join(oA[t - d], oP[t - d], &sA[t], &sP[t]);
            }
            for (int t = 0; t < nt; ++t) {
                eA[t] = t % warp ? sA[t - 1] : sA[t];
                eP[t] = t % warp ? sP[t - 1] : sP[t];
                if (t % warp == warp - 1) { wA[t / warp] = sA[t]; wP[t / warp] = sP[t]; }
            }
            for (int t = 0; t < nt; ++t) {
                Strip& s = th[t];
                int32_t cA = bA[i];
                uint32_t cP = bP[i];
                for (int w = 0; w < t / warp; ++w) {
                    int32_t a = wA[w];
                    uint32_t p = wP[w];
                    adp_join(cA, cP, &a, &p);
                    cA = a; cP = p;
                }
                if (t % warp) {
                    int32_t a = eA[t];
                    uint32_t p = eP[t];
                    adp_join(cA, cP, &a, &p);
                    cA = a; cP = p;
                }
                const int j0 = t0 + t * ADP_K;
                adp_strip_finish(cA, cP, j0, i, gap, len, s.A, s.Q, s.H, s.P,
                                 s.cm, s.qe, s.cp);
                s.hl = cA - gap * (j0 - 1);
                s.pl = cP;
            }
            bA[i] = th[nt - 1].A[ADP_K - 1];
            bP[i] = th[nt - 1].Q[ADP_K - 1];
        }
        for (int t = 0; t < nt; ++t) {
            const Strip& s = th[t];
            for (int k = 0; k < ADP_K; ++k) {
                const int j = t0 + t * ADP_K + k;
                if (j >= len) continue;
                scr_cm[j] = s.cm[k];
                scr_ts[j] = adp_ts(s.cp[k]);
                if (s.cm[k] > bs[t]) {
                    bs[t] = s.cm[k]; bj[t] = j; bq[t] = s.qe[k]; bp[t] = s.cp[k];
                }
            }
        }
    }
    int32_t s1 = bs[0], j1 = bj[0], qe1 = bq[0];
    uint32_t p1 = bp[0];
    for (int t = 1; t < nt; ++t)
        if (adp_better(bs[t], bj[t], s1, j1)) {
            s1 = bs[t]; j1 = bj[t]; qe1 = bq[t]; p1 = bp[t];
        }
    if (s1 < 0) { s1 = 0; j1 = 0; qe1 = 0; p1 = 0; }
    const int32_t ts1 = adp_ts(p1);
    int32_t s2 = ADP_NEG;
    for (int j = 0; j < len; ++j) {
        const int32_t v = adp_second(scr_cm[j], scr_ts[j], j, j1, ts1, tol);
        if (v > s2) s2 = v;
    }
    res[0] = s1; res[1] = j1; res[2] = qe1; res[3] = ts1;
    res[4] = adp_qs(p1); res[5] = s2;
}

}  // namespace

extern "C" int adp_hits_host(const int8_t* reads, const int32_t* lens, int B,
                             int L, const int8_t* adapters,
                             const int32_t* alens, int C, int m, int match,
                             int mismatch, int gap, int tol, int nt, int warp,
                             int32_t* out) {
    if (nt <= 0 || warp <= 0 || nt % warp) return 1;
    for (int b = 0; b < B; ++b)
        for (int c = 0; c < C; ++c) {
            int32_t res[6];
            one_block(reads + (size_t)b * L, lens[b], L,
                      adapters + (size_t)c * m, alens[c], match, mismatch,
                      gap, tol, nt, warp, res);
            for (int k = 0; k < 6; ++k)
                out[((size_t)k * B + b) * C + c] = res[k];
        }
    return 0;
}
