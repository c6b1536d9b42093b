// Host driver of the adapter-hits kernel's arithmetic, for the CPU tests
// (tests/test_torch_adapters.py builds it with g++).
//
// It runs the control flow of c3poa_tpu_torch/kernels/csrc/adapters.cu
// serially over the functions of adapters.cuh: whole (read, combo)
// sweeps, lane by lane, each step taking the lane above's output of the
// step before (the kernel's __shfl_up_sync as an array shift), passes of
// ``warp`` lanes with the carry row between them, the last lane's scratch
// words and best hit, and the second-hit reduction.  A warp narrower than
// 32 lanes puts pass seams inside short combos.  The packed path (one
// word a cell, adapters.cuh) runs as the kernel runs it: 32 lanes, one
// pass.
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "adapters.cuh"

namespace {

struct Best {
    int32_t s = -1, j = 0, k = ADP_CM0;
    uint32_t p = 0;
};

template <int R>
void sweep_pass(const int8_t* rrow, int len, const int8_t* q, int mc,
                int first_row, int match, int mismatch, int gap, int warp,
                bool carry_in, std::vector<AdpFlow>& carry,
                std::vector<uint32_t>& scr, bool final, Best& best) {
    const int rows = (warp * R < mc - first_row) ? warp * R : mc - first_row;
    const int last = (rows + R - 1) / R - 1;
    std::vector<AdpLane<R>> st(warp);
    std::vector<AdpFlow> out(warp), up(warp);
    std::vector<int32_t> dhg(warp, -gap);
    std::vector<uint32_t> dp(warp, adp_edge(first_row - 1, gap).p);
    for (int l = 0; l < warp; ++l) {
        adp_lane_init<R>(st[l], q, mc, first_row + l * R, match, mismatch,
                         gap);
        out[l] = adp_edge(first_row + l * R + R - 1, gap);
    }
    for (int s = 0; s < len + last; ++s) {
        for (int l = 0; l < warp; ++l) {
            const int j = s - l;
            if (l > 0)
                up[l] = out[l - 1];
            else if (carry_in && j < len)
                up[l] = carry[j];
            else
                up[l] = adp_top(j, gap);
        }
        for (int l = 0; l < warp; ++l) {
            const int j = s - l;
            const int code = (unsigned)j < (unsigned)len ? rrow[j] : 4;
            out[l] = adp_lane_step<R>(st[l], code, j, dhg[l], dp[l], up[l],
                                      gap);
            dhg[l] = up[l].hg;
            dp[l] = up[l].p;
        }
        const int j = s - last;
        if (j < 0) continue;
        const AdpFlow& f = out[last];
        if (final) {
            scr[j] = adp_word(f.key, f.kp);
            if (adp_colmax(f.key) > best.s) {
                best.s = adp_colmax(f.key); best.j = j; best.k = f.key;
                best.p = f.kp;
            }
        } else {
            carry[j] = f;
        }
    }
}

template <int R>
void sweep(const int8_t* rrow, int len, const int8_t* q, int mc, int match,
           int mismatch, int gap, int warp, std::vector<uint32_t>& scr,
           Best& best) {
    std::vector<AdpFlow> carry(len > 0 ? len : 1);
    for (int first = 0; first < mc; first += warp * R)
        sweep_pass<R>(rrow, len, q, mc, first, match, mismatch, gap, warp,
                      first > 0, carry, scr, first + warp * R >= mc, best);
}

void one_warp(const int8_t* rrow, int len, const int8_t* q, int mc,
              int match, int mismatch, int gap, int tol, int warp,
              int32_t* res) {
    std::vector<uint32_t> scr(len > 0 ? len : 1, 0u);
    Best best;
    if (mc > 0 && adp_rows_per_lane(mc, warp) == 1)
        sweep<1>(rrow, len, q, mc, match, mismatch, gap, warp, scr, best);
    else if (mc > 0)
        sweep<ADP_MAX_R>(rrow, len, q, mc, match, mismatch, gap, warp, scr,
                         best);
    if (mc <= 0 && len > 0) best.s = 0;
    if (best.s < 0) best = Best{0, 0, ADP_CM0, 0u};
    const int32_t ts1 = adp_ts(best.p);
    int32_t s2 = ADP_NEG;
    for (int j = 0; j < len; ++j) {
        const int32_t v = adp_second(scr[j], j, best.j, ts1, tol);
        if (v > s2) s2 = v;
    }
    res[0] = best.s; res[1] = best.j; res[2] = adp_qe(best.k);
    res[3] = ts1; res[4] = adp_qs(best.p); res[5] = s2;
}

// the packed path: one pass of 32 lanes, the last lane's keys into the
// scratch row, then the outputs from it
template <int R>
void packed_sweep(const int8_t* rrow, int len, const int8_t* q, int mc,
                  int match, int mismatch, int gap,
                  std::vector<int32_t>& scr) {
    const int warp = 32, last = (mc + R - 1) / R - 1;
    std::vector<AdpkLane<R>> st(warp);
    std::vector<AdpkFlow> out(warp), up(warp);
    std::vector<int32_t> dup(warp, adpk_edge(-1, gap).up);
    for (int l = 0; l < warp; ++l) {
        adpk_lane_init<R>(st[l], q, mc, l * R, match, mismatch, gap);
        out[l] = adpk_edge(l * R + R - 1, gap);
    }
    for (int s = 0; s < len + last; ++s) {
        for (int l = 0; l < warp; ++l)
            up[l] = l ? out[l - 1] : adpk_top(s, gap);
        for (int l = 0; l < warp; ++l) {
            const int j = s - l;
            const int code = (unsigned)j < (unsigned)len ? rrow[j] : 4;
            out[l] = adpk_lane_step<R>(st[l], code, j, dup[l], up[l], gap);
            dup[l] = up[l].up;
        }
        if (s - last >= 0) scr[s - last] = out[last].key;
    }
}

void packed_one(const int8_t* rrow, int len, const int8_t* q, int mc,
                int match, int mismatch, int gap, int tol, int32_t* res) {
    std::vector<int32_t> scr(len > 0 ? len : 1);
    if (adp_rows_per_lane(mc, 32) == 1)
        packed_sweep<1>(rrow, len, q, mc, match, mismatch, gap, scr);
    else
        packed_sweep<ADP_MAX_R>(rrow, len, q, mc, match, mismatch, gap, scr);
    int32_t best = -1;
    for (int j = 0; j < len; ++j) {
        const int32_t b = adpk_best(scr[j], j);
        if (b > best) best = b;
    }
    int32_t s2 = ADP_NEG;
    if (best < 0) {
        res[0] = res[1] = res[2] = res[3] = res[4] = 0;
    } else {
        const int32_t j1 = adpk_best_column(best), k1 = scr[j1];
        res[0] = adpk_colmax(k1); res[1] = j1; res[2] = adpk_qe(k1);
        res[3] = adpk_ts(k1); res[4] = adpk_qs(k1);
        for (int j = 0; j < len; ++j) {
            const int32_t v = adpk_second(scr[j], j, j1, res[3], tol);
            if (v > s2) s2 = v;
        }
    }
    res[5] = s2;
}

}  // namespace

// warp 0: the kernel's own choice, read by read: the packed path where
// adpk_fits, else the general path with warps of 32 lanes; otherwise the
// general path with warps of ``warp`` lanes
extern "C" int adp_hits_host(const int8_t* reads, const int32_t* lens, int B,
                             int L, const int8_t* adapters,
                             const int32_t* alens, int C, int m, int match,
                             int mismatch, int gap, int tol, int warp,
                             int32_t* out) {
    if (warp < 0 || warp > 32) return 1;
    for (int b = 0; b < B; ++b)
        for (int c = 0; c < C; ++c) {
            int32_t res[6];
            if (warp == 0 && alens[c] > 0 &&
                adpk_fits(lens[b], m, match, mismatch, gap))
                packed_one(reads + (size_t)b * L, lens[b],
                           adapters + (size_t)c * m, alens[c], match,
                           mismatch, gap, tol, res);
            else
                one_warp(reads + (size_t)b * L, lens[b],
                         adapters + (size_t)c * m, alens[c], match, mismatch,
                         gap, tol, warp ? warp : 32, res);
            for (int k = 0; k < 6; ++k)
                out[((size_t)k * B + b) * C + c] = res[k];
        }
    return 0;
}
