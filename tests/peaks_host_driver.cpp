// Host driver of the peak-candidates kernel's arithmetic and cluster
// schedule, for the CPU tests (tests/test_torch_peaks_cuh.py builds it with
// g++, -ffp-contract=off).
//
// It runs the control flow of c3poa_tpu_torch/kernels/csrc/peaks.cu
// serially over the functions of peaks.cuh, a read's R ranks one after
// another: each rank's share of S columns (the kernel's pk_share_width, or
// any power of two >= 4096 with R * S >= L) as keys in shared memory's order
// (pk_key_at), with the keys either side, and its max key; each warp's
// latest run start over its segment; the median's passes (each rank's
// sweep of the chunks that hold the read's columns, chunk q counted by
// thread q % 512 into the 32 lane copies of its histogram, folded by
// thread t for bin t, the ranks' histograms merged, every rank's pick
// over the merged one lane by lane, the second rank from the last
// histogram or from the ranks' least keys above the first); the carry
// into each share from the latest starts of the ranks below it; each
// warp's segment from its run, a step of 256 columns (8 a lane) at a
// time, the step's skip test, and for a tile wider than 8 columns the
// shuffle butterfly over its lanes; and the OR of the ranks' flags.
#include <stdint.h>

#include <algorithm>
#include <vector>

#include "peaks.cuh"

namespace {

// a warp's pick over a merged histogram, lane by lane: each of 32 lanes
// takes 8 bins and the count below them; the number of lanes that found
// rank k
int pick_lanes(const uint32_t* hist, uint32_t k, int* d, uint32_t* below) {
    int found = 0;
    uint32_t prefix = 0;
    for (int lane = 0; lane < 32; ++lane) {
        int dl;
        uint32_t bl;
        if (pk_pick(hist + 8 * lane, 8, prefix, k, &dl, &bl)) {
            *d = 8 * lane + dl;
            *below = bl;
            ++found;
        }
        for (int i = 0; i < 8; ++i)
            prefix += hist[8 * lane + i];
    }
    return found;
}

struct Rank {
    int c0, w, wn;
    // the share's keys in shared memory's order (pk_key_at), NEG_F's past
    // the read, and the keys either side of the share
    std::vector<uint32_t> xs;
    uint32_t left, right;
    std::vector<uint32_t> rep;
    uint32_t hl[2][PK_BINS];
    uint32_t kmax;
    std::vector<int> own;  // each warp's latest run start
    uint32_t least;
    int flags;
};

// a warp's latest run start among the rank's columns [seg0, seg0 + segw):
// pk_start_at_n, else steps of 32 columns from the right, the lowest lane
// (the highest column) that finds a start giving it
int warp_latest(const Rank& k, int seg0, int segw, int n) {
    int lat = pk_start_at_n(k.c0 + seg0, segw, n);
    for (int e = seg0 + pk_valid_cols(k.c0 + seg0, segw, n);
         e > seg0 && lat < 0; e -= 32)
        for (int lane = 0; lane < 32 && lat < 0; ++lane) {
            const int i = e - 1 - lane;
            if (i >= seg0)
                lat = pk_start(k.c0 + i, pk_share_key(k.xs.data(), k.left, i),
                               pk_share_key(k.xs.data(), k.left, i - 1));
        }
    return lat;
}

// the rank's histogram of pass p into hl[p & 1]: the sweep of the chunks
// that hold the read's columns (chunk q by thread q % PK_THREADS) into the
// lane copies, then their fold by the block's threads (and the copies
// cleared)
void rank_histogram(Rank& k, uint32_t prefix, int p) {
    const uint32_t kneg = pk_key(PK_NEG_F);
    for (int q = 0; q < pk_sweep_chunks(k.wn); ++q)
        for (int e = 0; e < 4; ++e) {
            const uint32_t key = k.xs[4 * q + e];
            if (!pk_counted(key, prefix, p, kneg))
                continue;
            const int d = pk_digit(key, p);
            const int lane = (q % PK_THREADS) % 32;
            k.rep[pk_rep_word(d, lane)] += 1;
        }
    for (int t = 0; t < PK_BINS; ++t) {
        k.hl[p & 1][t] = 0;
        for (int q = 0; q < 32; ++q) {
            uint32_t& word = k.rep[t * 32 + pk_rep_lane(t, q)];
            k.hl[p & 1][t] += word;
            word = 0;
        }
    }
}

// every rank's pick over the merged histogram of pass p (the same sum in
// each); false when some pick was found by more than one lane, or by
// none, or two ranks disagree
bool cluster_pick(const std::vector<Rank>& ranks, int p, uint32_t k,
                  bool two, int* d, uint32_t* below, bool* found2, int* d2) {
    const int R = (int)ranks.size();
    for (int r = 0; r < R; ++r) {
        uint32_t hg[PK_BINS];
        for (int t = 0; t < PK_BINS; ++t) {
            hg[t] = 0;
            for (int q = 0; q < R; ++q)
                if (pk_merges(q, R))
                    hg[t] += ranks[q].hl[p & 1][t];
        }
        int dr = 0, d2r = 0;
        uint32_t br = 0, b2;
        if (pick_lanes(hg, k, &dr, &br) != 1)
            return false;
        const int lanes2 = two ? pick_lanes(hg, k + 1, &d2r, &b2) : 0;
        if (lanes2 > 1)
            return false;
        if (r > 0 && (dr != *d || br != *below || (lanes2 == 1) != *found2 ||
                      (lanes2 == 1 && d2r != *d2)))
            return false;
        *d = dr;
        *below = br;
        *found2 = lanes2 == 1;
        *d2 = d2r;
    }
    return true;
}

// a rank's candidates: each warp's segment from its run (the carry, the
// warps before it), a step of 256 columns at a time, the lanes' latest
// starts scanned in order, the step's skip test, and for a tile wider than
// 8 columns the shuffle butterfly over its lanes
void candidates_host(const Rank& k, int S, int carry, int n,
                     const PkRead& rd, int tile, int M, int32_t* pos,
                     float* hs, bool* third, bool* marg) {
    const int wseg = S / PK_WARPS;
    const auto key = [&](int i) {
        return i >= S ? k.right : pk_share_key(k.xs.data(), k.left, i);
    };
    int before = carry;
    for (int warp = 0; warp < PK_WARPS; ++warp) {
        for (int base = warp * wseg; base < (warp + 1) * wseg;
             base += PK_STEP) {
            uint32_t v[32][PK_WINDOW];
            int run[32];
            bool slow = false;
            for (int l = 0; l < 32; ++l) {
                const int i0 = base + PK_COLS * l;
                for (int q = 0; q < PK_WINDOW; ++q)
                    v[l][q] = key(i0 - PK_LEFT + q);
                run[l] = before;
                before = pk_latest(before,
                                   pk_thread_latest(v[l], k.c0 + i0,
                                                    k.w - i0));
                slow = slow || pk_thread_may(v[l], k.w - i0, rd.cut);
            }
            PkTop3 top[32];
            for (int l = 0; l < 32; ++l) {
                const int i0 = base + PK_COLS * l;
                if (!slow) {
                    pk_thread_empty(k.c0 + i0, k.w - i0, tile, M, pos, hs);
                    continue;
                }
                const PkThread o = pk_thread(v[l], k.c0 + i0, k.w - i0, n,
                                             run[l], rd, tile, M, pos, hs);
                top[l] = o.top;
                *third = *third || o.third;
                *marg = *marg || o.margin;
            }
            if (!slow || tile <= PK_COLS)
                continue;
            const int lanes = tile / PK_COLS;
            for (int off = 1; off < lanes; off <<= 1) {
                PkTop3 next[32];
                for (int l = 0; l < 32; ++l)
                    next[l] = pk_top3_merge(top[l], top[l ^ off]);
                std::copy(next, next + 32, top);
            }
            for (int l = 0; l < 32; l += lanes)
                if (base + PK_COLS * l < k.w) {
                    pk_write_tile(pos, hs, M, (k.c0 + base + PK_COLS * l) /
                                  tile, top[l]);
                    *third = *third || top[l].c != 0;
                }
        }
    }
}

// one read as a cluster of R ranks of S columns; false on a failed pick
bool read_host(const float* row, int n, int L, int tile, int R, int S,
               int32_t* pos, float* hs, float* med, float* height,
               uint8_t* gated, uint8_t* deep, uint8_t* margin) {
    const uint32_t kneg = pk_key(PK_NEG_F);
    const int wseg = S / PK_WARPS;
    std::vector<Rank> ranks(R);
    for (int r = 0; r < R; ++r) {
        Rank& k = ranks[r];
        k.c0 = r * S;
        k.w = pk_share_cols(L, S, r);
        k.wn = pk_valid_cols(k.c0, k.w, n);
        k.xs.assign(S, 0);
        k.kmax = 0;
        for (int i = 0; i < S; ++i) {
            const uint32_t key = i < k.wn ? pk_key(row[k.c0 + i]) : kneg;
            k.xs[pk_key_at(i)] = key;
            k.kmax = std::max(k.kmax, key);
        }
        k.left = pk_key(pk_xm(row, k.c0 - 1, n));
        k.right = pk_key(pk_xm(row, k.c0 + S, n));
        k.rep.assign(PK_REP_WORDS, 0);
        k.own.resize(PK_WARPS);
        for (int warp = 0; warp < PK_WARPS; ++warp)
            k.own[warp] = warp_latest(k, warp * wseg,
                                      pk_share_cols(k.w, wseg, warp), n);
    }
    uint32_t xmax_key = 0;
    for (const Rank& k : ranks)
        xmax_key = std::max(xmax_key, k.kmax);
    uint32_t klo = PK_EMPTY_KEY, khi = PK_EMPTY_KEY;
    if (n > 0) {
        uint32_t k = pk_rank_lo(n);
        const bool two = pk_rank_hi(n) != pk_rank_lo(n);
        uint32_t prefix = 0;
        bool found2 = false;
        int d = 0, d2 = 0;
        for (int p = 0; p < PK_PASSES; ++p) {
            for (Rank& rk : ranks)
                rank_histogram(rk, prefix, p);
            uint32_t below = 0;
            if (!cluster_pick(ranks, p, k, two && p == PK_PASSES - 1, &d,
                              &below, &found2, &d2))
                return false;
            prefix = (prefix << PK_DIGIT) | (uint32_t)d;
            k -= below;
        }
        klo = khi = prefix;
        if (two && found2) {
            khi = ((prefix >> PK_DIGIT) << PK_DIGIT) | (uint32_t)d2;
        } else if (two) {
            khi = 0xffffffffu;
            for (Rank& rk : ranks) {
                rk.least = 0xffffffffu;
                for (int q = 0; q < 4 * pk_sweep_chunks(rk.wn); ++q)
                    if (rk.xs[q] > klo && rk.xs[q] < rk.least)
                        rk.least = rk.xs[q];
                khi = std::min(khi, rk.least);
            }
        }
    }
    const float m = pk_median(klo, khi);
    const PkGate g = pk_gate(pk_unkey(xmax_key), m);
    const PkRead rd = pk_read(g);
    const int M = L / tile;
    for (int r = 0; r < R; ++r) {
        Rank& k = ranks[r];
        int carry = -1;
        for (int q = 0; q < R; ++q)
            if (pk_carries(q, r))
                for (int warp = 0; warp < PK_WARPS; ++warp)
                    carry = pk_latest(carry, ranks[q].own[warp]);
        bool third = false, marg = false;
        candidates_host(k, S, carry, n, rd, tile, M, pos, hs, &third, &marg);
        k.flags = (third ? 1 : 0) | (marg ? 2 : 0);
    }
    int all = 0;
    for (const Rank& k : ranks)
        all |= k.flags;
    *med = m;
    *height = g.height;
    *gated = g.gated;
    *deep = (all & 1) != 0;
    *margin = g.near_gate || (all & 2) != 0;
    return true;
}

}  // namespace

extern "C" {

// the kernel's outputs for sm (B, L) float32 and lens (B,) int32, a read
// as R ranks of S columns (S = 0: the kernel's pk_share_width(L, R)); -1
// (nothing written) for a tile that is no power of two <= 64 or does not
// divide L, R < 1, or S no power of two >= PK_SHARE_ALIGN with R * S >=
// L; -2
// when a pick of the median was found by more than one lane, or by none,
// or two ranks picked differently
int pk_host(const float* sm, const int32_t* lens, int B, int L, int tile,
            int R, int S, int32_t* cand_pos, float* cand_h, float* med,
            float* height, uint8_t* gated, uint8_t* deep, uint8_t* margin) {
    if (R >= 1 && S == 0 && L >= 1)
        S = pk_share_width(L, R);
    if (tile < 1 || tile > PK_MAX_TILE || (tile & (tile - 1)) || L < 1 ||
        L % tile || R < 1 || S < PK_SHARE_ALIGN || (S & (S - 1)) ||
        (long long)R * S < L)
        return -1;
    const int M = L / tile;
    for (int b = 0; b < B; ++b) {
        int n = lens[b];
        n = n < 0 ? 0 : (n > L ? L : n);
        if (!read_host(sm + (size_t)b * L, n, L, tile, R, S,
                       cand_pos + (size_t)b * 2 * M,
                       cand_h + (size_t)b * 2 * M, &med[b], &height[b],
                       &gated[b], &deep[b], &margin[b]))
            return -2;
    }
    return 0;
}

// the kernel's default cluster: R for B rows of L columns on a card of
// `sms` SMs, S for L columns over R ranks, the widest row it takes, and a
// CTA's dynamic shared memory for a share of S columns of R ranks
int pk_kernel_ranks(int L, int B, int sms) {
    return pk_default_ranks(L, B, sms);
}
int pk_kernel_share(int L, int R) { return pk_share_width(L, R); }
int pk_kernel_max_l() { return PK_MAX_L; }
int pk_kernel_smem(int S, int R) { return pk_smem_bytes(S, R); }
// the skip test's floor for a read's height
float pk_kernel_floor(float height) { return pk_matter_floor(height); }

}  // extern "C"
